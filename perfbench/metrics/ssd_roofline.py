"""ssd_roofline (%): the least time of the traced slice's SSD calls (one a
Mamba2 layer a prefill) over the device time of the SSD kernel's three passes
(``ssd_chunk_kernel``, ``ssd_state_kernel``, ``ssd_output_kernel``). A call's
least time is the larger of its fp32 operations over the fp32 peak (the
kernel runs its products on the CUDA cores) and the bytes the function needs
over the HBM rate: a frozen copy of ``chip_smoke.py``'s ``ssd_bounds_ms``,
counted at chunk 32 whatever chunk the program runs, so that the yardstick
stays put. None where the trace holds no SSD kernel, or where the
architecture has no Mamba2 layers."""

from perfbench.lib import files
from perfbench.lib.flops import FP32_FLOPS, HBM_BYTES
from perfbench.lib.profile import kernel_seconds

KERNELS = ("ssd_chunk_kernel", "ssd_state_kernel", "ssd_output_kernel")
CHUNK = 32


def ssd_seconds(B: int, T: int, H: int, P: int, N: int, elem_bytes: int = 2) -> float:
    """Least time of one call: fp32 operations, counting the c(c+1)/2 causal
    pairs of a chunk, C B^T once per (b, chunk) (one group of B and C), per
    (b, head, chunk) the scores against x and 4cPN for C H^T and the state
    update; bytes, x, dt, B, C, A, D and the state read once, y and the state
    written once (x, B, C in `elem_bytes`)."""
    c = CHUNK
    nc = -(-T // c)
    flops = B * nc * c * (c + 1) * N + B * H * nc * (c * (c + 1) * P + 4 * c * P * N)
    bytes_ = (B * T * H * P * elem_bytes + B * T * H * 4 + 2 * B * T * N * elem_bytes
              + 2 * H * 4 + 2 * B * H * P * N * 4 + B * T * H * P * 4)
    return max(flops / FP32_FLOPS, bytes_ / HBM_BYTES)


def read(rec):
    prof = rec.profile
    if not prof or rec.data.get("kind") != "prefill":
        return None
    secs = sum(kernel_seconds(prof, name)[0] for name in KERNELS)
    arch = files.architecture(rec.data["model"])
    if secs <= 0 or not hasattr(arch, "mamba_layers"):
        return None
    model, B = rec.data["model"], rec.data["batch"]
    d = arch.dims(model)
    need = sum(len(arch.mamba_layers(model)) * ssd_seconds(B, S, d["H"], d["P"], d["Ns"])
               for S, _, _ in rec.data["slice_units"])
    return 100.0 * need / secs if need > 0 else None
