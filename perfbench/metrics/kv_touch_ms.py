"""kv_touch_ms (ms): host time a step spends in ``engine.touch``, the touch of
each page the batch reads (the paper's GET accounting and the LRU);
``lib/program_spans.py`` says over what steps."""

from perfbench.lib.program_spans import span_ms


def read(rec):
    return span_ms(rec, "engine.touch")
