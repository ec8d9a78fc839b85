"""table_entries_step (entries): the pages the step's batch holds, in either
tier (``entries`` on ``engine.tables``: ``hot_tables`` counts each row's
pages once a table); ``lib/program_spans.py`` says over what steps."""

from perfbench.lib.program_spans import per_step


def read(rec):
    return per_step(rec, lambda root, kids: sum(
        k["attrs"].get("entries", 0) for k in kids if k["name"] == "engine.tables"))
