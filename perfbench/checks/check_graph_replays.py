"""The reader of the decode step's CUDA graph counts (``graph_captures`` and
``graph_replays`` on ``decode.dispatch``, ``repro_torch.spans``): the median
replays a step over the traced slice, and None where no step of the slice
counted a graph (a program without the graph cache, or pools on the CPU)."""

from types import SimpleNamespace

from perfbench.lib import files
from repro_torch import spans

MS = 1_000_000


def slice_of(t0_ms, t1_ms):
    """A record whose traced slice runs from `t0_ms` to `t1_ms` on the spans'
    clock, in ``time.perf_counter`` seconds as the profiler keeps it."""
    off = spans.RECORDER.offset_ns
    return SimpleNamespace(profile={"t0": (t0_ms * MS - off) / 1e9,
                                    "t1": (t1_ms * MS - off) / 1e9})


def test_the_reader_is_the_serving_cells():
    (entry,) = [m for m in files.benchmark()["per_layer"]
                if m["name"] == "decode_graph_replays"]
    assert entry["workloads"] == ["olmoe-serve-wide"]
    assert entry["moves"] == "gen_tokens_per_s"


def test_decode_graph_replays_reads_the_counts(monkeypatch):
    recs = []
    for step, attrs in enumerate([{"graph_captures": 1}, {"graph_replays": 1},
                                  {"graph_replays": 1}, {}], 1):
        t0 = 1000 * step * MS
        recs.append({"name": "decode.dispatch", "id": 2 * step + 1, "parent": 2 * step,
                     "step": step, "start_ns": t0, "end_ns": t0 + MS, "attrs": attrs})
        recs.append({"name": "engine.step", "id": 2 * step, "parent": None, "step": step,
                     "start_ns": t0, "end_ns": t0 + 2 * MS, "attrs": dict(attrs)})
    monkeypatch.setattr(spans, "records", lambda: recs)
    reader = files.load_module("metrics", "decode_graph_replays")
    assert reader.read(slice_of(500, 3500)) == 1
    assert reader.read(slice_of(500, 2500)) == 0.5
    assert reader.read(slice_of(3500, 4500)) is None      # a step that counted no graph
    assert reader.read(slice_of(5000, 6000)) is None
    assert reader.read(SimpleNamespace(profile=None)) is None
