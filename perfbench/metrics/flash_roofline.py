"""flash_roofline (%): the least time of the traced slice's flash calls (one
a layer that runs attention a prefill; attention's 4 x hd flops a causal pair
and head over the bf16 peak, not the kernel's P-split 6 x hd) over the device
time of the bf16 flash kernel."""

from perfbench.lib import flops
from perfbench.lib.profile import kernel_seconds


def read(rec):
    prof = rec.profile
    if not prof or rec.data.get("kind") != "prefill":
        return None
    secs = kernel_seconds(prof, "flash_attention_wgmma_kernel")[0]
    model, B = rec.data["model"], rec.data["batch"]
    L = flops.attention_layer_count(model)
    need = sum(L * flops.flash_seconds(model, B, S)
               for S, _, _ in rec.data["slice_units"])
    if secs <= 0 or need <= 0:
        return None
    return 100.0 * need / secs
