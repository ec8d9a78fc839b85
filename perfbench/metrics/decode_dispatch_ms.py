"""decode_dispatch_ms (ms): host time a step spends in ``decode.dispatch``,
``paged_decode_step`` from entry to return: every launch enqueued, no wait;
``lib/program_spans.py`` says over what steps."""

from perfbench.lib.program_spans import span_ms


def read(rec):
    return span_ms(rec, "decode.dispatch")
