"""decode_mfu (%): the work the window's decode steps need (2 x the weights a
token multiplies through, the routed experts only, x the tokens stepped, plus
attention's 4 x hd flops a head for each key each token attends) over the
window's seconds and the bf16 peak."""

from perfbench.lib import flops


def read(rec):
    spans = rec.data.get("spans")
    if not spans or not spans["decodes"] or rec.window_s <= 0:
        return None
    model = rec.data["model"]
    work = sum(flops.decode_flops(model, ctx) for _, _, ctx in spans["decodes"])
    return 100.0 * work / rec.window_s / flops.BF16_FLOPS
