"""WKV6: the port's oracle scan, plain chunked form and decode step against the
reference's, the CUDA kernel's three-pass split rehearsed in plain torch, and
the CUDA kernel against the plain version.

Tolerance 3e-4, the reference's own (tests/test_kernels.py:77): the chunked
form sums in another order than the step-by-step scan. The two oracle scans do
the same sums in the same order and are held at 1e-5.

JAX is imported only by the reference comparisons, so the CUDA cases also run
on a machine with a card and no JAX (see README, "PyTorch / H100 port").
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rwkv6_scan import rwkv6_scan as kernel_mod  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import _wkv6_chunked, wkv6, wkv6_decode_step  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref  # noqa: E402

SWEEP = [(2, 64, 2, 16, 16), (1, 50, 4, 32, 32)]   # (B, T, H, K, V): tests/test_kernels.py:77
ATOL = 3e-4


def make_inputs(B, T, H, K, V, seed, w_low=1e-5, w_high=0.999):
    """r, k, v, w, u, s0 as fp32 numpy arrays, drawn as the reference's sweep draws them."""
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((B, T, H, K)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, T, H, K)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, T, H, V)) * 0.5).astype(np.float32)
    w = rng.uniform(w_low, w_high, (B, T, H, K)).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, K, V)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _shape_id(s):
    return "B{}T{}H{}K{}V{}".format(*s)


@pytest.fixture(scope="module")
def reference():
    jnp = pytest.importorskip("jax.numpy")
    ops = pytest.importorskip("repro.kernels.rwkv6_scan.ops")
    pallas = pytest.importorskip("repro.kernels.rwkv6_scan.rwkv6_scan")
    ref = pytest.importorskip("repro.kernels.rwkv6_scan.ref")
    return jnp, ops, pallas.wkv6_pallas, ref.wkv6_ref


@pytest.mark.parametrize("shape", SWEEP, ids=_shape_id)
@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
def test_matches_reference(reference, shape, impl):
    """wkv6_ref vs wkv6_ref (1e-5), wkv6(impl="chunked") vs the reference's
    chunked form, and the CPU path of impl="pallas" (the plain chunked form)
    vs wkv6_pallas in interpret mode (3e-4)."""
    jnp, r_ops, r_pallas, r_ref = reference
    arrays = make_inputs(*shape, seed=sum(shape))
    jargs = [jnp.asarray(a) for a in arrays]
    atol = ATOL
    if impl == "ref":
        y_ref, s_ref = r_ref(*jargs)
        y, s = wkv6_ref(*_torch(arrays))
        atol = 1e-5
    elif impl == "chunked":
        y_ref, s_ref = r_ops.wkv6(*jargs, impl="chunked")
        y, s = wkv6(*_torch(arrays), impl="chunked")
    else:
        y_ref, s_ref = r_pallas(*jargs, chunk=16, interpret=True)
        y, s = wkv6(*_torch(arrays), impl="pallas", chunk=16)
    assert y.dtype == s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=atol, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=atol, rtol=0)


@pytest.mark.parametrize("chunk", [16, 32, 5])
def test_chunked_matches_scan_in_the_port(chunk):
    """tests/test_kernels.py:77 in the port alone: T = 50 is no multiple of
    any of these chunks, the initial state is nonzero, decays reach 1e-5."""
    arrays = _torch(make_inputs(1, 50, 4, 32, 32, seed=2))
    y_ref, s_ref = wkv6_ref(*arrays)
    y, s = wkv6(*arrays, chunk=chunk)
    torch.testing.assert_close(y, y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(s, s_ref, atol=ATOL, rtol=0)


def test_chunked_keeps_hard_decay_resets_finite():
    """Decays down to 1e-30 and exact zeros: log w is floored at 1e-38 and
    every exponent clamped <= 0, so nothing overflows and the state resets."""
    r, k, v, w, u, s0 = make_inputs(1, 40, 2, 16, 16, seed=3, w_low=0.0, w_high=1e-30)
    w[:, ::7] = 0.0
    arrays = _torch((r, k, v, w, u, s0))
    y, s = wkv6(*arrays)
    y_ref, s_ref = wkv6_ref(*arrays)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    torch.testing.assert_close(y, y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(s, s_ref, atol=ATOL, rtol=0)


def test_decode_step_matches_reference_and_scan(reference):
    """tests/test_kernels.py:94: the step against the reference's step (1e-5),
    and a loop of steps against the scan."""
    jnp, r_ops, _, _ = reference
    r, k, v, w, u, s0 = make_inputs(2, 8, 2, 8, 8, seed=9, w_low=0.3, w_high=0.99)
    state_t, state_r = torch.from_numpy(s0), jnp.asarray(s0)
    ys = []
    for t in range(8):
        step = (r[:, t], k[:, t], v[:, t], w[:, t], u)
        y_r, state_r = r_ops.wkv6_decode_step(*(jnp.asarray(a) for a in step), state_r)
        y_t, state_t = wkv6_decode_step(*_torch(step), state_t)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), atol=1e-5, rtol=0)
        ys.append(y_t)
    np.testing.assert_allclose(state_t.numpy(), np.asarray(state_r), atol=1e-5, rtol=0)
    y_scan, s_scan = wkv6_ref(*_torch((r, k, v, w, u, s0)))
    torch.testing.assert_close(torch.stack(ys, 1), y_scan, atol=1e-5, rtol=0)
    torch.testing.assert_close(state_t, s_scan, atol=1e-5, rtol=0)


def _hi_lo(x):
    """x as bf16 hi = bf16(x) and lo = bf16(x - hi), each back in fp32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _product(eq, a, b, exact_b, lo=True):
    """einsum(eq, a, b) as the kernel's tensor cores form it: a split into
    bf16 hi and lo, b too unless it is bf16 already; a_lo b_lo is dropped.
    Without `lo`, each operand is rounded to bf16 once."""
    a_hi, a_lo = _hi_lo(a)
    if not lo:
        return torch.einsum(eq, a_hi, b if exact_b else _hi_lo(b)[0])
    if exact_b:
        return torch.einsum(eq, a_hi, b) + torch.einsum(eq, a_lo, b)
    b_hi, b_lo = _hi_lo(b)
    return (torch.einsum(eq, a_hi, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_lo, b_hi))


def wkv6_step_split(r, k, v, w, u, state, chunk, step=64, operands="fp32", sub_block=None):
    """The CUDA kernel's split in plain torch, in its arithmetic (fp32, base-2
    decays, w floored at 1e-38, every exponent <= 0). With operands="hi_lo",
    pass 3's products are formed from bf16 hi and lo parts as the kernel's
    mma.sync forms them (v is exact when it came in as bf16); "hi" rounds
    each operand to bf16 once instead. With `sub_block`, a pair (t, s) whose
    positions lie in different sub-blocks of that many positions takes its
    decay as the kernel does, 2^min(cp_t - cum_e, 0) 2^min(cum_e - cum_s, 0),
    e the end of s's sub-block:
      pass 1: per step of 64 positions, all steps at once, its own state
              contribution dS = (k 2^(cum_last - cum))^T v and decay
              2^cum_last, cum taken over the step;
      pass 2: S_n = 2^cum_last,n S_{n-1} + dS_n, keeping the state each step
              starts from;
      pass 3: per step, all steps at once, its chunks in order from that
              state as the reference computes a chunk, y written once."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    exact_v = v.dtype == torch.bfloat16
    r, k, v, w = (t.float() for t in (r, k, v, w))

    def product(eq, a, b, exact_b=False):
        if operands == "fp32":
            return torch.einsum(eq, a, b)
        return _product(eq, a, b, exact_b, lo=operands == "hi_lo")

    pad = -T % step
    r, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
    w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    ns = r.shape[1] // step
    rs, ks, vs = (t.reshape(B, ns, step, H, t.shape[-1]) for t in (r, k, v))
    lg = torch.log2(torch.clamp(w, min=1e-38)).reshape(B, ns, step, H, K)
    # pass 1
    cum = torch.cumsum(lg, dim=2)
    d_s = torch.einsum("bnshk,bnshv->bnhkv", ks * torch.exp2(cum[:, :, -1:] - cum), vs)
    a_step = torch.exp2(cum[:, :, -1])                                 # (B,ns,H,K)
    # pass 2
    S, starts = state.float(), []
    for n in range(ns):
        starts.append(S)
        S = a_step[:, n, :, :, None] * S + d_s[:, n]
    S_run = torch.stack(starts, dim=1)                                 # (B,ns,H,K,V)
    # pass 3
    ys = []
    for c0 in range(0, step, chunk):
        rc, kc, vc = (t[:, :, c0:c0 + chunk] for t in (rs, ks, vs))
        cc = torch.cumsum(lg[:, :, c0:c0 + chunk], dim=2)              # (B,ns,c,H,K)
        cp = cc - lg[:, :, c0:c0 + chunk]
        dec = torch.exp2(torch.clamp(cp[:, :, :, None] - cc[:, :, None], max=0.0))
        if sub_block:   # across sub-blocks, factored at the end e of s's sub-block
            sub = torch.arange(chunk) // sub_block
            end = cc[:, :, sub * sub_block + sub_block - 1]                # (B,ns,s,H,K)
            fact = (torch.exp2(torch.clamp(cp[:, :, :, None] - end[:, :, None], max=0.0))
                    * torch.exp2(torch.clamp(end - cc, max=0.0))[:, :, None])
            same = (sub[:, None] == sub[None, :])[None, None, :, :, None, None]
            dec = torch.where(same, dec, fact)
        sc = (rc[:, :, :, None] * kc[:, :, None] * dec).sum(-1)       # (B,ns,t,s,H)
        sc = sc * torch.tril(torch.ones((chunk, chunk)), -1)[:, :, None]
        diag = torch.einsum("bnthk,hk,bnthk->bnth", rc, u.float(), kc)
        sc = sc + torch.diag_embed(diag.transpose(-1, -2)).permute(0, 1, 3, 4, 2)
        y = product("bntsh,bnshv->bnthv", sc, vc, exact_v)
        y = y + product("bnthk,bnhkv->bnthv", rc * torch.exp2(cp), S_run)
        ys.append(y)
        S_run = (torch.exp2(cc[:, :, -1])[..., None] * S_run
                 + product("bnshk,bnshv->bnhkv", kc * torch.exp2(cc[:, :, -1:] - cc), vc, exact_v))
    y = torch.cat(ys, dim=2).reshape(B, ns * step, H, V)[:, :T]
    return y, S


REHEARSAL = [((2, 64, 2, 16, 16), 16), ((1, 50, 4, 32, 32), 16), ((1, 50, 4, 32, 32), 32),
             ((1, 7, 2, 16, 8), 16), ((2, 130, 3, 64, 24), 32), ((1, 200, 2, 16, 40), 16)]


@pytest.mark.parametrize("shape,chunk", REHEARSAL,
                         ids=lambda v: _shape_id(v) if isinstance(v, tuple) else f"c{v}")
def test_step_split_matches_reference(reference, shape, chunk):
    """The kernel's three passes against the reference's Pallas kernel in
    interpret mode (3e-4): T within one step, ragged and shorter than a
    chunk, several steps, both chunks, V other than K."""
    jnp, _, r_pallas, _ = reference
    arrays = make_inputs(*shape, seed=sum(shape) + chunk)
    y_ref, s_ref = r_pallas(*(jnp.asarray(a) for a in arrays), chunk=chunk, interpret=True)
    y, s = wkv6_step_split(*_torch(arrays), chunk=chunk, operands="hi_lo",
                           sub_block=chunk * shape[3] // 256)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("chunk", [16, 32])
def test_step_split_keeps_hard_decay_resets_finite(chunk):
    """Decays down to 1e-30 and exact zeros over three steps: the step's cum
    reaches ~-6000, every exponent stays <= 0 and nothing overflows."""
    r, k, v, w, u, s0 = make_inputs(1, 150, 2, 16, 16, seed=3, w_low=0.0, w_high=1e-30)
    w[:, ::7] = 0.0
    arrays = _torch((r, k, v, w, u, s0))
    y, s = wkv6_step_split(*arrays, chunk=chunk, operands="hi_lo", sub_block=chunk * 16 // 256)
    y_ref, s_ref = wkv6_ref(*arrays)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    torch.testing.assert_close(y, y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(s, s_ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_core_hi_lo_split_stays_far_inside_the_tolerance(reference, dtype):
    """Pass 3's products formed from bf16 hi and lo parts (r exp(cum_prev) and
    the state for y, the scores against v, the decayed k against v), with the
    scores across sub-blocks factored as the kernel forms them: within
    1e-5 of the largest |value| of the fp32 split, a tenth of the path's 1e-4
    bound, and within the sweep's 3e-4 of the Pallas kernel. Rounding those
    operands to bf16 once, with no lo part, is off by more than the bound."""
    jnp, _, r_pallas, _ = reference
    arrays = _torch(make_inputs(2, 150, 2, 64, 64, seed=12, w_low=0.3, w_high=0.999))
    if dtype == "bfloat16":
        arrays[:3] = [t.bfloat16() for t in arrays[:3]]
    y32, s32 = wkv6_step_split(*arrays, chunk=16)
    y, s = wkv6_step_split(*arrays, chunk=16, operands="hi_lo", sub_block=4)
    assert _max_rel(y, y32) <= 1e-5 and _max_rel(s, s32) <= 1e-5
    y_ref, s_ref = r_pallas(*(jnp.asarray(t.float().numpy()) for t in arrays), chunk=16,
                            interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=ATOL, rtol=0)
    y_hi, s_hi = wkv6_step_split(*arrays, chunk=16, operands="hi")
    assert _max_rel(y_hi, y32) > 1e-4


def test_cpu_tensors_take_the_plain_version():
    arrays = _torch(make_inputs(1, 50, 4, 32, 32, seed=4))
    before = kernel_mod.launches
    y, s = wkv6(*arrays, impl="pallas")
    y_plain, s_plain = _wkv6_chunked(*arrays, chunk=16)
    assert torch.equal(y, y_plain) and torch.equal(s, s_plain)
    assert kernel_mod.launches == before


def test_kernel_wrapper_rejects_what_it_cannot_take():
    arrays = _torch(make_inputs(1, 50, 4, 32, 32, seed=5))
    with pytest.raises(ValueError, match="CUDA"):
        kernel_mod.wkv6_pallas(*arrays)
    with pytest.raises(ValueError, match="unknown wkv6 impl"):
        wkv6(*arrays, impl="xla")


# ------------------------------------------------------------------ on the card
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _max_rel(out, ref):
    """Largest |out - ref| over the largest |ref|: no floor at 1, because the
    model's y and states sit near 1e-2."""
    return ((out.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SWEEP, ids=_shape_id)
@pytest.mark.parametrize("chunk", [16, 32])
def test_cuda_kernel_matches_plain(shape, chunk):
    """The reference's sweep in fp32: nonzero initial state, decays down to 1e-5."""
    _needs_card()
    arrays = _torch(make_inputs(*shape, seed=6), "cuda")
    before = kernel_mod.launches
    y, s = wkv6(*arrays, impl="pallas", chunk=chunk)
    torch.cuda.synchronize()
    assert kernel_mod.launches == before + 1
    y_ref, s_ref = wkv6_ref(*arrays)
    torch.testing.assert_close(y, y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(s, s_ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 37, 200], ids=lambda t: f"T{t}")
def test_cuda_kernel_matches_plain_at_the_path_dtypes(T):
    """rwkv6-3b's heads (H 40, K = V = 64), bf16 r/k/v and fp32 w/u/state, T
    cut from 2048 and no multiple of 16 but for 1; held within 1e-4 of the
    plain chunked form's largest |value| on the same (bf16-rounded) inputs."""
    _needs_card()
    r, k, v, w, u, s0 = _torch(make_inputs(2, T, 40, 64, 64, seed=7, w_low=0.3, w_high=0.99),
                               "cuda")
    r, k, v = (t.to(torch.bfloat16) for t in (r, k, v))
    y, s = wkv6(r, k, v, w, u, s0, impl="pallas")
    y_ref, s_ref = _wkv6_chunked(r, k, v, w, u, s0, chunk=16)
    assert tuple(y.shape) == (2, T, 40, 64) and y.dtype == torch.float32
    assert _max_rel(y, y_ref) <= 1e-4 and _max_rel(s, s_ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("K,V", [(64, 24), (32, 80), (16, 40)], ids=lambda x: str(x))
def test_cuda_kernel_matches_plain_at_other_widths(K, V):
    """V not a multiple of the kernel's 16-column slice, K other than V."""
    _needs_card()
    arrays = _torch(make_inputs(1, 45, 3, K, V, seed=K + V), "cuda")
    y, s = wkv6(*arrays, impl="pallas")
    y_ref, s_ref = wkv6_ref(*arrays)
    torch.testing.assert_close(y, y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(s, s_ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_keeps_hard_decay_resets_finite():
    _needs_card()
    r, k, v, w, u, s0 = make_inputs(2, 64, 2, 16, 16, seed=8, w_low=0.0, w_high=1e-5)
    w[:, ::5] = 0.0
    arrays = _torch((r, k, v, w, u, s0), "cuda")
    y, s = wkv6(*arrays, impl="pallas")
    y_ref, s_ref = wkv6_ref(*arrays)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    torch.testing.assert_close(y, y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(s, s_ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_wrapper_rejects_what_it_cannot_take():
    _needs_card()
    r, k, v, w, u, s0 = _torch(make_inputs(1, 20, 2, 16, 16, seed=9), "cuda")
    with pytest.raises(ValueError, match="chunk"):
        kernel_mod.wkv6_pallas(r, k, v, w, u, s0, chunk=8)
    shifted = torch.zeros(r.numel() + 1, device="cuda")[1:].view(r.shape)
    with pytest.raises(ValueError, match="16-byte"):
        kernel_mod.wkv6_pallas(shifted, k, v, w, u, s0)
    wide = torch.zeros((1, 20, 2, 80), device="cuda")
    with pytest.raises(ValueError, match="K=80"):
        kernel_mod.wkv6_pallas(wide, wide, v, wide, torch.zeros((2, 80), device="cuda"),
                               torch.zeros((1, 2, 80, 16), device="cuda"))
    with pytest.raises(ValueError, match="float32"):
        kernel_mod.wkv6_pallas(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="dtypes"):
        kernel_mod.wkv6_pallas(r.bfloat16(), k, v, w, u, s0)


EDGES = [((1, 1, 2, 16, 16), 16), ((1, 1, 2, 64, 64), 32), ((1, 16, 2, 32, 32), 16),
         ((2, 63, 3, 64, 64), 32), ((1, 64, 2, 64, 64), 16), ((1, 65, 2, 16, 8), 32),
         ((2, 129, 2, 32, 8), 16), ((1, 300, 2, 64, 128), 32), ((1, 100, 3, 16, 80), 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,chunk", EDGES,
                         ids=lambda v: _shape_id(v) if isinstance(v, tuple) else f"c{v}")
def test_cuda_kernel_matches_plain_at_its_edges(shape, chunk, dtype):
    """The three passes' edges: T = 1, one chunk, one step of 64 and a
    position either side of it, several steps with a ragged last one; both
    chunks; every key head dim; V from 8 to 128. Against the step-by-step
    oracle on the same (rounded) inputs, at 3e-4."""
    _needs_card()
    r, k, v, w, u, s0 = _torch(make_inputs(*shape, seed=sum(shape)), "cuda")
    r, k, v = (t.to(getattr(torch, dtype)) for t in (r, k, v))
    before = kernel_mod.launches
    y, s = wkv6(r, k, v, w, u, s0, impl="pallas", chunk=chunk)
    torch.cuda.synchronize()
    assert kernel_mod.launches == before + 1
    y_ref, s_ref = wkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(s, s_ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_wrapper_rejects_widths_it_does_not_take():
    _needs_card()
    r, k, v, w, u, s0 = _torch(make_inputs(1, 20, 2, 16, 16, seed=10), "cuda")
    for V in (4, 12, 136):
        vv = torch.zeros((1, 20, 2, V), device="cuda")
        with pytest.raises(ValueError, match=f"V={V}"):
            kernel_mod.wkv6_pallas(r, k, vv, w, u, torch.zeros((1, 2, 16, V), device="cuda"))
    shifted = torch.zeros(s0.numel() + 1, device="cuda")[1:].view(s0.shape)
    with pytest.raises(ValueError, match="16-byte"):
        kernel_mod.wkv6_pallas(r, k, v, w, u, shifted)
