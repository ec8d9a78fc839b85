"""prefill_p90_ms (ms): 90th percentile over every call in the window of the
host time from the call's start to its logits and caches being ready."""

from perfbench.lib.stats import percentile


def read(rec):
    if rec.data.get("kind") != "prefill":
        return None
    return percentile([(t1 - t0) * 1e3 for _, t0, t1 in rec.data["units"]], 90)
