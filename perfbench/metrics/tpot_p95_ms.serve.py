"""tpot_p95_ms.serve (ms): 95th percentile of the gaps between a request's
consecutive generated tokens, over every gap that ends in the window. A
preemption stall is one long gap."""

from perfbench.lib.stats import percentile


def read(rec):
    if rec.data.get("kind") != "serve":
        return None
    t0, t1 = rec.data["t0"], rec.data["t1"]
    gaps = [(b - a) * 1e3 for _, times in rec.data["requests"]
            for a, b in zip(times, times[1:]) if t0 < b <= t1]
    return percentile(gaps, 95)
