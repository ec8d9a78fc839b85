"""The readers of the program's own spans (``repro_torch.spans``): a tiny
traced serving run gives each of them a number from the traced slice alone,
and they read None where the program recorded nothing there or has no
recorder."""

import sys
from types import SimpleNamespace

import pytest

from perfbench.checks.tiny import tiny_cell
from perfbench.lib import files
from perfbench.run import measure
from repro_torch import spans

READERS = ["admit_ms", "block_table_ms", "table_entries_step", "kv_touch_ms",
           "decode_dispatch_ms", "kv_moved_mb_step"]


def read(name, rec):
    return files.load_module("metrics", name).read(rec)


def slice_of(t0_ms, t1_ms):
    """A record whose traced slice runs from `t0_ms` to `t1_ms` on the spans'
    clock, in ``time.perf_counter`` seconds as the profiler keeps it."""
    off = spans.RECORDER.offset_ns
    return SimpleNamespace(profile={"t0": (t0_ms * 1e6 - off) / 1e9,
                                    "t1": (t1_ms * 1e6 - off) / 1e9})


def test_the_readers_are_the_serving_cells():
    bench = files.benchmark()
    for name in READERS:
        (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert entry["workloads"] == ["olmoe-serve-wide"]


def test_a_tiny_traced_run_gives_every_reader_a_number():
    spans.clear()
    spans.enable()          # a step before the run, outside its slice
    try:
        with spans.span("engine.step"):
            pass
    finally:
        spans.disable()
    rec, metrics = measure(tiny_cell("olmoe-serve-wide", seconds=1.0, trace=True), True)
    assert rec.correct
    for name in READERS:
        assert isinstance(metrics[name]["value"], float | int), name
    # the window ran without a profiler: the step above and the slice's
    roots = spans.steps(spans.records(), "engine.step")
    assert len(roots) == 1 + files.load_json("traffic", "sharegpt160")["profile_steps"]
    assert metrics["block_table_ms"]["value"] > 0 and metrics["kv_touch_ms"]["value"] > 0
    assert metrics["table_entries_step"]["value"] > 0
    assert metrics["kv_moved_mb_step"]["value"] == 0      # the pool holds every request


def _step(step, t0, parts, **attrs):
    """A root ``engine.step`` at `t0` ms and its children, `parts` of
    (name, ms, attrs), laid end to end."""
    ms = 1_000_000
    recs, t = [], t0 * ms
    for i, (name, dur, kid_attrs) in enumerate(parts):
        recs.append({"name": name, "id": step * 100 + i + 1, "parent": step * 100,
                     "step": step, "start_ns": t, "end_ns": t + dur * ms, "attrs": kid_attrs})
        t += dur * ms
    recs.append({"name": "engine.step", "id": step * 100, "parent": None, "step": step,
                 "start_ns": t0 * ms, "end_ns": t, "attrs": attrs})
    return recs


def test_the_readers_arithmetic(monkeypatch):
    recs = []
    for step, (admit, tables, entries, moved) in enumerate(
            [(1, 30, 900, 0), (2, 40, 1000, 4_000_000), (4, 50, 1100, 6_000_000)], 1):
        recs += _step(step, 1000 * step, [
            ("engine.admit", admit, {}), ("engine.tables", tables, {"entries": entries}),
            ("engine.touch", 3, {}), ("decode.dispatch", 40 + step, {}),
            ("engine.sample", 1, {}), ("engine.update", 1, {})],
            kv_d2h_bytes=moved // 2, kv_h2d_bytes=moved - moved // 2)
    recs.append({"name": "decode.dispatch", "id": 9, "parent": None, "step": 9,
                 "start_ns": 0, "end_ns": 10**12, "attrs": {}})   # a root of its own
    monkeypatch.setattr(spans, "records", lambda: recs)
    rec = slice_of(500, 5000)
    assert read("admit_ms", rec) == pytest.approx(2.0)
    assert read("block_table_ms", rec) == pytest.approx(40.0)
    assert read("table_entries_step", rec) == 1000
    assert read("kv_touch_ms", rec) == pytest.approx(3.0)
    assert read("decode_dispatch_ms", rec) == pytest.approx(42.0)
    assert read("kv_moved_mb_step", rec) == pytest.approx(4.0)
    # a slice that holds the first two steps alone, then none of them
    rec = slice_of(500, 2500)
    assert read("admit_ms", rec) == pytest.approx(1.5)
    assert read("table_entries_step", rec) == 950
    assert [read(name, slice_of(5000, 6000)) for name in READERS] == [None] * len(READERS)


def test_no_records_and_no_recorder_read_none(monkeypatch):
    """Nothing recorded, no traced slice, and an older program without the
    recorder (the parent side of a comparison) all read None."""
    spans.clear()
    rec = slice_of(0, 10**18)
    assert [read(name, rec) for name in READERS] == [None] * len(READERS)
    spans.enable()
    try:
        with spans.span("engine.step"):
            pass
    finally:
        spans.disable()
    assert [read(name, None) for name in READERS] == [None] * len(READERS)
    assert [read(name, SimpleNamespace(profile=None)) for name in READERS] == \
        [None] * len(READERS)
    assert read("admit_ms", rec) == 0.0
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)    # the import fails
    assert [read(name, rec) for name in READERS] == [None] * len(READERS)
