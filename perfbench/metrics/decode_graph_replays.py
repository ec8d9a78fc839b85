"""decode_graph_replays (replays): CUDA graph replays a step (``graph_replays``
on ``decode.dispatch``: 1 where the step replayed the decode graph of its
batch width, 0 where it ran eagerly or captured one); ``lib/program_spans.py``
says over what steps. None where no ``decode.dispatch`` of the slice counts
graph captures or replays: a program without the decode graphs."""

from perfbench.lib.program_spans import per_step

COUNTS = ("graph_replays", "graph_captures")


def read(rec):
    counted = []

    def replays(root, kids):
        dispatch = [k["attrs"] for k in kids if k["name"] == "decode.dispatch"]
        counted.extend(a for a in dispatch if any(c in a for c in COUNTS))
        return sum(a.get("graph_replays", 0) for a in dispatch)

    value = per_step(rec, replays)
    return value if counted else None
