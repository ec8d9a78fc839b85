"""prefill_mfu (%): the work the window's prefill calls need (2 x the weights a
token multiplies through x the tokens, the last position's unembedding, and
attention's 4 x hd flops a head for each causal pair) over the window's
seconds and the bf16 peak."""

from perfbench.lib import flops


def read(rec):
    if rec.data.get("kind") != "prefill" or rec.window_s <= 0:
        return None
    model, B = rec.data["model"], rec.data["batch"]
    work = sum(B * flops.prefill_flops(model, S) for S, _, _ in rec.data["units"])
    return 100.0 * work / rec.window_s / flops.BF16_FLOPS
