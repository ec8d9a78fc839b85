"""prefill_tokens_per_s (tokens/s): prompt tokens of every call in the window
over the window's seconds (host clock; the window ends with the call that
crosses ``--seconds``)."""


def read(rec):
    if rec.data.get("kind") != "prefill" or rec.window_s <= 0:
        return None
    B = rec.data["batch"]
    return sum(S * B for S, _, _ in rec.data["units"]) / rec.window_s
