"""Flash attention: the port's plain version against the reference's oracle and
its Pallas kernel (interpret mode), and the CUDA kernel against the plain version.

Tolerances: 2e-5 in fp32 and 2e-2 in bf16, the reference's own sweep
(tests/test_kernels.py:27); the bf16 output's 8-bit mantissa rounds at ~4e-3.
At the main path's shapes the kernel is held at 2e-5 in fp32 and, in bf16,
within one bf16 ulp of the plain output (8e-3 of |plain| + 1e-4): outputs
there are ~0.01-0.02, so a flat 2e-2 would not tell a lost k tile from rounding.

The CUDA kernel computes P·V on the tensor cores from bf16 operands, with P
split into two bf16 parts; its numerics are rehearsed here in plain torch
against the reference's oracle at the one-ulp bound.

JAX is imported only by the reference comparisons, so the CUDA cases also run
on a machine with a card and no JAX (see README, "PyTorch / H100 port").
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention as kernel_mod  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref  # noqa: E402

SWEEP = [  # (B, S, N, K, hd): tests/test_kernels.py:27
    (1, 128, 4, 4, 64),
    (2, 256, 8, 2, 64),
    (1, 384, 4, 1, 128),     # S not a block multiple
    (2, 200, 2, 2, 32),
]
WINDOWS = [1 << 30, 64]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PATH_TOL = {"float32": dict(atol=2e-5, rtol=0.0), "bfloat16": dict(atol=1e-4, rtol=8e-3)}
# The main path's shapes: gemma3-1b (GQA 4:1, hd 256, sliding window 512 and
# global) and zamba2-1.2b's shared attention (hd 64, no GQA), B=2 x 2048.
PATH = [((2, 2048, 4, 1, 256), 512), ((2, 2048, 4, 1, 256), 1 << 30),
        ((2, 2048, 32, 32, 64), 1 << 30)]


def make_inputs(B, S, N, K, hd, seed, T=None):
    rng = np.random.default_rng(seed)
    T = T or S
    q = (rng.standard_normal((B, S, N, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, T, K, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, T, K, hd)) * 0.5).astype(np.float32)
    return q, k, v


@pytest.fixture(scope="module")
def reference():
    """The JAX package's attention oracle and flash kernel, and the jnp/ml_dtypes modules."""
    jnp = pytest.importorskip("jax.numpy")
    ml_dtypes = pytest.importorskip("ml_dtypes")
    ref = pytest.importorskip("repro.kernels.flash_attention.ref")
    ops = pytest.importorskip("repro.kernels.flash_attention.ops")
    return jnp, ml_dtypes, ref.attention_ref, ops.flash_attention


def _cast(arrays, dtype, ml_dtypes):
    if dtype == "float32":
        return arrays
    return tuple(a.astype(ml_dtypes.bfloat16) for a in arrays)


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("shape", SWEEP, ids=lambda s: "B{}S{}N{}K{}hd{}".format(*s))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle(reference, shape, window, dtype):
    jnp, ml_dtypes, jax_ref, _ = reference
    q, k, v = _cast(make_inputs(*shape, seed=sum(shape) + window % 97), dtype, ml_dtypes)
    hd = shape[-1]
    ref = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(window),
                  scale=hd ** -0.5)
    out = flash_attention(_torch(q), _torch(k), _torch(v), window=window, scale=hd ** -0.5)
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_plain_matches_reference_oracle_non_causal(reference):
    jnp, _, jax_ref, _ = reference
    q, k, v = make_inputs(2, 128, 4, 4, 64, seed=11)
    ref = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(1 << 30),
                  causal=False, scale=0.125)
    out = flash_attention(_torch(q), _torch(k), _torch(v), window=1 << 30, scale=0.125,
                          causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape,window,dtype", [((2, 200, 4, 2, 32), 64, "float32"),
                                                ((1, 160, 4, 1, 128), 1 << 30, "bfloat16")],
                         ids=["gqa-window-fp32", "gqa4-global-bf16"])
def test_plain_matches_reference_kernel(reference, shape, window, dtype):
    """Against the Pallas kernel itself, run in interpret mode."""
    jnp, ml_dtypes, _, jax_flash = reference
    q, k, v = _cast(make_inputs(*shape, seed=3), dtype, ml_dtypes)
    hd = shape[-1]
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=jnp.int32(window),
                    scale=hd ** -0.5, interpret=True)
    out = flash_attention(_torch(q), _torch(k), _torch(v), window=window, scale=hd ** -0.5)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _bf16(x):
    """x rounded to bf16 (to nearest even), kept in fp32."""
    return x.to(torch.bfloat16).float()


def tensor_core_attention(q, k, v, window, *, scale, causal=True, block_k=64, split_p=True):
    """The bf16 CUDA kernel's arithmetic in plain torch: fp32 scores of bf16
    inputs (exact products, fp32 sums), an online softmax in base 2 over
    tiles of `block_k` keys, and P·V with P rounded as the kernel rounds it:
    P_hi = bf16(P) and P_lo = bf16(P - P_hi) into one fp32 accumulator (or P_hi
    alone with split_p=False). Computing tiles the kernel skips adds exact
    zeros, so every tile is computed here."""
    B, S, N, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    kk = k.float().repeat_interleave(N // K, 2).permute(0, 2, 3, 1)    # (B, N, hd, T)
    vv = v.float().repeat_interleave(N // K, 2).transpose(1, 2)         # (B, N, T, hd)
    qq = q.float().transpose(1, 2)                                       # (B, N, S, hd)
    qpos = torch.arange(S)[:, None]
    m = torch.full((B, N, S, 1), NEG_INF)
    l = torch.zeros((B, N, S, 1))
    acc = torch.zeros((B, N, S, hd))
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(1.4426950408889634,
                                                                           dtype=torch.float32)
    for k0 in range(0, T, block_k):
        kpos = torch.arange(k0, min(k0 + block_k, T))[None, :]
        s = qq @ kk[..., k0:k0 + block_k]
        keep = qpos - kpos < window
        if causal:
            keep = keep & (qpos >= kpos)
        s = torch.where(keep, s * scale_log2, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = _bf16(p)
        pv = p_hi @ vv[:, :, k0:k0 + block_k]
        if split_p:
            pv = pv + _bf16(p - p_hi) @ vv[:, :, k0:k0 + block_k]
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-20)).transpose(1, 2).to(q.dtype)


# Rows shaped like the path's: gemma3-1b's 4 query heads over 1 kv head at hd
# 256 (the first rows of a causal sequence, where few keys share the weight,
# and long rows under the sliding window and global), zamba2-1.2b's hd 64.
EMULATED = [((1, 128, 4, 1, 256), 1 << 30, 32), ((1, 1024, 4, 1, 256), 512, 32),
            ((1, 1024, 4, 1, 256), 1 << 30, 32), ((1, 512, 8, 8, 64), 1 << 30, 64),
            ((1, 200, 4, 1, 128), 63, 64)]


@pytest.mark.parametrize("case", EMULATED,
                         ids=lambda c: "B{}S{}N{}K{}hd{}".format(*c[0]) + f"-w{c[1]}")
def test_tensor_core_numerics_hold_one_bf16_ulp(reference, case):
    """The kernel's P·V numerics (P split into two bf16 parts, fp32
    accumulation) against the reference's oracle, element by element within
    one bf16 ulp: 8e-3 |ref| + 1e-4, the bound the card's checks use."""
    jnp, ml_dtypes, jax_ref, _ = reference
    shape, window, block_k = case
    q, k, v = _cast(make_inputs(*shape, seed=shape[1] + window % 101), "bfloat16", ml_dtypes)
    scale = shape[-1] ** -0.5
    ref = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.int32(window), scale=scale), np.float32)
    out = tensor_core_attention(_torch(q), _torch(k), _torch(v), window, scale=scale,
                                block_k=block_k).float().numpy()
    bound = PATH_TOL["bfloat16"]["atol"] + PATH_TOL["bfloat16"]["rtol"] * np.abs(ref)
    assert np.all(np.abs(out - ref) <= bound), float(np.max(np.abs(out - ref) / bound))


def test_splitting_p_removes_its_rounding():
    """P·V with P split into two bf16 parts is as close to the fp32 product as
    fp32 sums allow; one bf16 rounding of P is off by ~2^-9 of each term."""
    q, k, v = (_torch(a).to(torch.bfloat16) for a in make_inputs(1, 256, 4, 1, 256, seed=8))
    exact = attention_ref(q.float(), k.float(), v.float(), 1 << 30, scale=1 / 16)
    split = tensor_core_attention(q.float(), k.float(), v.float(), 1 << 30, scale=1 / 16,
                                  block_k=32)
    single = tensor_core_attention(q.float(), k.float(), v.float(), 1 << 30, scale=1 / 16,
                                   block_k=32, split_p=False)
    err_split = (split - exact).abs().max().item()
    err_single = (single - exact).abs().max().item()
    assert err_split <= 1e-5 and err_single > 100 * err_split, (err_split, err_single)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in make_inputs(1, 40, 4, 2, 32, seed=4))
    before = kernel_mod.launches
    out = flash_attention(q, k, v, window=16, scale=0.2)
    assert torch.equal(out, attention_ref(q, k, v, 16, scale=0.2))
    assert kernel_mod.launches == before


def test_kernel_wrapper_rejects_what_it_cannot_take():
    q, k, v = (torch.from_numpy(a) for a in make_inputs(1, 40, 4, 2, 32, seed=5))
    with pytest.raises(ValueError, match="CUDA"):
        kernel_mod.flash_attention(q, k, v, window=16, scale=0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SWEEP, ids=lambda s: "B{}S{}N{}K{}hd{}".format(*s))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(shape, window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (_torch(a).cuda().to(getattr(torch, dtype))
               for a in make_inputs(*shape, seed=6))
    scale = shape[-1] ** -0.5
    before = kernel_mod.launches
    out = flash_attention(q, k, v, window=window, scale=scale)
    torch.cuda.synchronize()
    assert kernel_mod.launches == before + 1
    ref = attention_ref(q, k, v, window, scale=scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("case", PATH, ids=["gemma3-sliding", "gemma3-global", "zamba2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_on_path_shapes(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape, window = case
    q, k, v = (_torch(a).cuda().to(getattr(torch, dtype)) for a in make_inputs(*shape, seed=7))
    scale = shape[-1] ** -0.5
    out = flash_attention(q, k, v, window=window, scale=scale)
    ref = attention_ref(q, k, v, window, scale=scale)
    torch.testing.assert_close(out.float(), ref.float(), **PATH_TOL[dtype])


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_non_causal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (_torch(a).cuda() for a in make_inputs(2, 128, 4, 4, 64, seed=7))
    out = flash_attention(q, k, v, window=1 << 30, scale=0.125, causal=False)
    ref = attention_ref(q, k, v, 1 << 30, scale=0.125, causal=False)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


# The tensor-core kernel's edges, bf16 only (fp32 takes the CUDA-core kernel):
# every head dim, ragged S, windows about a 64-key tile, non-causal, and
# queries and keys of different lengths. (shape, T, window, causal)
TC_CASES = ([((1, 1000, 4, 2, hd), 1000, w, True) for hd in HEAD_DIMS
             for w in (1, 63, 64, 65, 1 << 30)]
            + [((2, 200, 4, 1, hd), 200, 1 << 30, True) for hd in HEAD_DIMS]
            + [((2, 200, 4, 4, hd), 200, 1 << 30, False) for hd in HEAD_DIMS]
            + [((2, 200, 4, 2, hd), 1000, 1 << 30, False) for hd in HEAD_DIMS]
            + [((2, 1000, 4, 2, hd), 200, 1 << 30, True) for hd in HEAD_DIMS])


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: "B{}S{}N{}K{}hd{}".format(*c[0]) +
                         f"-T{c[1]}-w{c[2]}" + ("" if c[3] else "-noncausal"))
def test_cuda_tensor_core_kernel_within_one_bf16_ulp(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape, T, window, causal = case
    q, k, v = (_torch(a).cuda().to(torch.bfloat16) for a in make_inputs(*shape, seed=9, T=T))
    scale = shape[-1] ** -0.5
    out = flash_attention(q, k, v, window=window, scale=scale, causal=causal)
    ref = attention_ref(q, k, v, window, scale=scale, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), **PATH_TOL["bfloat16"])


# hd 80 (hubert-xlarge, non-causal) and hd 192 (nemotron-4-340b, causal and
# sliding): fp32 at 2e-5, bf16 within one bf16 ulp, ragged S and T.
WIDE = [((2, 300, 16, 16, 80), 300, 1 << 30, False), ((1, 200, 4, 2, 80), 330, 1 << 30, True),
        ((1, 130, 4, 1, 80), 130, 65, True), ((2, 300, 12, 1, 192), 300, 1 << 30, True),
        ((1, 257, 4, 2, 192), 257, 64, True), ((1, 200, 4, 4, 192), 120, 1 << 30, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE, ids=lambda c: "B{}S{}N{}K{}hd{}".format(*c[0]) +
                         f"-T{c[1]}-w{c[2]}" + ("" if c[3] else "-noncausal"))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_at_head_dims_80_and_192(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape, T, window, causal = case
    q, k, v = (_torch(a).cuda().to(getattr(torch, dtype))
               for a in make_inputs(*shape, seed=10, T=T))
    scale = shape[-1] ** -0.5
    out = flash_attention(q, k, v, window=window, scale=scale, causal=causal)
    ref = attention_ref(q, k, v, window, scale=scale, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), **PATH_TOL[dtype])
