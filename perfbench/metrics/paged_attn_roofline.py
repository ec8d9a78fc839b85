"""paged_attn_roofline (%): the least time of the traced slice's
paged-attention calls (one a layer that runs attention a decode step; each
sequence's K and V up to its length at the pool's fp32, its table, q and the
output, over 3.35 TB/s) over the device time of the paged kernels (partition
and combine)."""

from perfbench.lib import flops
from perfbench.lib.profile import kernel_seconds


def read(rec):
    prof, spans = rec.profile, rec.data.get("slice")
    if not prof or not spans:
        return None
    secs = kernel_seconds(prof, "paged_partition_kernel")[0] + \
        kernel_seconds(prof, "paged_combine_kernel")[0]
    model = rec.data["model"]
    L = flops.attention_layer_count(model)
    need = sum(L * flops.paged_seconds(model, ctx, rec.data["page"])
               for _, _, ctx in spans["decodes"])
    if secs <= 0 or need <= 0:
        return None
    return 100.0 * need / secs
