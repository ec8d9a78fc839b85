"""Per-step readings of the program's own spans (``repro_torch.spans``) in
the traced slice: the median over the ``engine.step`` roots that lie inside
the slice ``rec.profile`` bounds (``t0``, ``t1`` on ``time.perf_counter``,
moved onto the spans' clock by the recorder's offset), so spans recorded
outside the slice never count.

A reader returns None where the slice holds no ``engine.step``, and where the
program has no recorder: the benchmark's files also run over an older
program, as the parent side of a comparison, which must report the older
metrics alone."""

import statistics


def per_step(rec, value):
    """The median of `value(root, kids)` over the slice's steps, or None."""
    try:
        from repro_torch.spans import RECORDER, records, steps
    except ImportError:
        return None
    if rec is None or rec.profile is None:
        return None
    offset = RECORDER.offset_ns
    lo, hi = rec.profile["t0"] * 1e9 + offset, rec.profile["t1"] * 1e9 + offset
    values = [value(root, kids) for root, kids in steps(records(), "engine.step")
              if lo <= root["start_ns"] and root["end_ns"] <= hi]
    return statistics.median(values) if values else None


def span_ms(rec, name: str):
    """Milliseconds a step spends in the spans named `name`."""
    return per_step(rec, lambda root, kids: sum(
        k["end_ns"] - k["start_ns"] for k in kids if k["name"] == name) / 1e6)
