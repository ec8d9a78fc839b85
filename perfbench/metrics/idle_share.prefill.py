"""idle_share.prefill (%): 1 - device busy over wall, over the profiled slice
of a prefill window (busy: the union of the device's kernels and copies)."""


def read(rec):
    prof = rec.profile
    if not prof or rec.data.get("kind") != "prefill" or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
