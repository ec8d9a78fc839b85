"""ttft_p90_ms.serve (ms): 90th percentile, over every request whose first
token came in the window, of the time from its arrival (its client's send)
to the end of the step that generated its first token."""

from perfbench.lib.stats import percentile


def read(rec):
    if rec.data.get("kind") != "serve":
        return None
    t0, t1 = rec.data["t0"], rec.data["t1"]
    ttft = [(times[0] - arrival) * 1e3 for arrival, times in rec.data["requests"]
            if times and t0 <= times[0] <= t1]
    return percentile(ttft, 90)
