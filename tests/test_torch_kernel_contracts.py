"""What every CUDA kernel wrapper promises besides its arithmetic.

* It refuses to run under grad with an input that requires grad
  (``kernels/_grad.py``): its output would silently drop that gradient. The
  helper is tested here on CPU tensors; each wrapper on the card.
* Its shape checks take every published config of the repository that
  reaches it: paged attention every attention model that
  ``paged_decode_step`` serves, flash attention every model with attention.

No JAX here: the ``cuda`` cases run on a machine with a card and no JAX.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels._grad import refuse_grad  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.mamba2_ssd import mamba2_ssd as ssd_mod  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wkv_mod  # noqa: E402


def test_refuse_grad_raises_only_under_grad_with_an_input_that_requires_it():
    x, w = torch.ones(3), torch.ones(3, requires_grad=True)
    refuse_grad("k", x, x)
    with pytest.raises(NotImplementedError, match="k: .*no backward, as the reference's"):
        refuse_grad("k", x, w)
    with torch.no_grad():
        refuse_grad("k", x, w)
    with torch.inference_mode():
        refuse_grad("k", x, torch.ones(3))


def test_plain_versions_keep_their_gradients():
    """CPU tensors take the plain versions, which stay differentiable."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q = torch.randn((1, 8, 2, 32), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    flash_attention(q, q.detach(), q.detach(), window=1 << 30, scale=0.2).sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


def _paged_configs():
    """Published configs paged_decode_step serves: attention stacks, no
    leading dense layers (the reference's refusals)."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.family not in ("ssm", "hybrid") and not (cfg.moe and cfg.moe_first_dense):
            yield cfg


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if get_config(a).family != "ssm"])
def test_wrappers_take_every_published_config_that_reaches_them(arch):
    """Every published config with attention (rwkv6 has none)."""
    cfg = get_config(arch)
    hd, G = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
    assert cfg.num_heads % cfg.num_kv_heads == 0
    assert hd in flash_mod.HEAD_DIMS
    if cfg in list(_paged_configs()):
        assert hd in paged_mod.HEAD_DIMS and G in paged_mod.GROUPS


def test_paged_kernel_takes_every_group_up_to_16():
    assert paged_mod.GROUPS == tuple(range(1, 17))
    assert {80, 192} <= set(paged_mod.HEAD_DIMS) and {80, 192} <= set(flash_mod.HEAD_DIMS)


def _grad_cases(dev):
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    table = torch.arange(4, dtype=torch.int32, device=dev).reshape(2, 2)
    lengths = torch.tensor([5, 12], dtype=torch.int32, device=dev)
    B, T, H = 1, 20, 2
    return {
        "flash_attention": (lambda q: flash_mod.flash_attention(
            q, rn(1, 16, 2, 64), rn(1, 16, 2, 64), window=1 << 30, scale=0.125),
            rn(1, 16, 2, 64)),
        "paged_attention": (lambda q: paged_mod.paged_attention(
            q, rn(4, 8, 2, 64), rn(4, 8, 2, 64), table, lengths, 1 << 30, scale=0.125),
            rn(2, 2, 64)),
        "ssd_pallas": (lambda x: ssd_mod.ssd_pallas(
            x, rn(B, T, H).abs(), -rn(H).abs(), rn(B, T, 8), rn(B, T, 8), rn(H),
            rn(B, H, 8, 8)), rn(B, T, H, 8)),
        "wkv6_pallas": (lambda r: wkv_mod.wkv6_pallas(
            r, rn(B, T, H, 16), rn(B, T, H, 16), torch.rand((B, T, H, 16), device=dev),
            rn(H, 16), rn(B, H, 16, 16)), rn(B, T, H, 16)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "paged_attention", "ssd_pallas",
                                    "wkv6_pallas"])
def test_cuda_wrappers_refuse_grad(kernel):
    """Each wrapper raises before it launches when grad mode is on and an
    input requires grad; under no_grad the same call launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    call, x = _grad_cases("cuda")[kernel]
    mod = {"flash_attention": flash_mod, "paged_attention": paged_mod,
           "ssd_pallas": ssd_mod, "wkv6_pallas": wkv_mod}[kernel]
    before = mod.launches
    with pytest.raises(NotImplementedError, match="attn_impl='xla'"):
        call(x.requires_grad_())
    assert mod.launches == before
    with torch.no_grad():
        call(x)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
