"""block_table_ms (ms): host time a step spends in ``engine.tables``: the batch's
block tables (``hot_tables``, a copy of each row's own table), lengths and
input tokens, and their copies to the device; ``lib/program_spans.py`` says
over what steps."""

from perfbench.lib.program_spans import span_ms


def read(rec):
    return span_ms(rec, "engine.tables")
