"""table_entries_step (entries): page entries ``hot_table`` visits to build a
step's block tables (``entries`` on ``engine.tables``: the pool's held pages,
once a row); ``lib/program_spans.py`` says over what steps."""

from perfbench.lib.program_spans import per_step


def read(rec):
    return per_step(rec, lambda root, kids: sum(
        k["attrs"].get("entries", 0) for k in kids if k["name"] == "engine.tables"))
