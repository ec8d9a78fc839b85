"""gen_tokens_per_s (tokens/s): tokens the engine generated in the window's
steps over the window's seconds (host clock; the window ends after the step
that crosses ``--seconds``)."""


def read(rec):
    if rec.data.get("kind") != "serve" or rec.window_s <= 0:
        return None
    return rec.data["tokens"] / rec.window_s
