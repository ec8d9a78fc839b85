"""Per-call readings of the program's own ``forward`` spans
(``repro_torch.spans``: one root a ``transformer.forward`` call, its
``forward.*`` children and its counts) in the traced slice: the median over
the ``forward`` roots that lie inside the slice ``rec.profile`` bounds (``t0``,
``t1`` on ``time.perf_counter``, moved onto the spans' clock by the
recorder's offset), so spans recorded outside the slice never count.

A reader returns None where the slice holds no ``forward`` root: a program
whose forward records no such span (the parent side of a comparison) reports
nothing."""

import statistics


def per_call(rec, value):
    """The median of `value(root, kids)` over the slice's forward calls, or None."""
    from repro_torch.spans import RECORDER, records, steps

    if rec is None or rec.profile is None:
        return None
    offset = RECORDER.offset_ns
    lo, hi = rec.profile["t0"] * 1e9 + offset, rec.profile["t1"] * 1e9 + offset
    values = [value(root, kids) for root, kids in steps(records(), "forward")
              if lo <= root["start_ns"] and root["end_ns"] <= hi]
    return statistics.median(values) if values else None


def span_ms(rec, name: str):
    """Milliseconds a forward call spends in the spans named `name`."""
    return per_call(rec, lambda root, kids: sum(
        k["end_ns"] - k["start_ns"] for k in kids if k["name"] == name) / 1e6)
