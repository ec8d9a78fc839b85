"""Flash attention: the port's plain version against the reference's oracle and
its Pallas kernel (interpret mode), and the CUDA kernel against the plain version.

Tolerances: 2e-5 in fp32 and 2e-2 in bf16, the reference's own sweep
(tests/test_kernels.py:27); the bf16 output's 8-bit mantissa rounds at ~4e-3.
At the main path's shapes the kernel is held at 2e-5 in fp32 and, in bf16,
within one bf16 ulp of the plain output (8e-3 of |plain| + 1e-4): outputs
there are ~0.01-0.02, so a flat 2e-2 would not tell a lost k tile from rounding.

The CUDA kernel computes P·V on the tensor cores (wgmma) from bf16 operands,
with P split into two bf16 parts; its numerics, and its walk over its own
tiles, are rehearsed here in plain torch against the reference's oracle at
the one-ulp bound, beside the case that shows why P stays split.

JAX is imported only by the reference comparisons, so the CUDA cases also run
on a machine with a card and no JAX (see README, "PyTorch / H100 port").
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention as kernel_mod  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    BF16_BLOCK_K, BF16_BLOCK_Q, BF16_WG_ROWS as WG_ROWS, HEAD_DIMS)
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


def tensor_core_attention(q, k, v, window, *, scale, causal=True, block_k=64, split_p=True,
                          block_q=None):
    """The bf16 CUDA kernel's arithmetic in plain torch: fp32 scores of bf16
    inputs (exact products, fp32 sums), an online softmax in base 2 over
    tiles of `block_k` keys, and P·V with P rounded as the kernel rounds it:
    P_hi = bf16(P) and P_lo = bf16(P - P_hi) into one fp32 accumulator (or P_hi
    alone with split_p=False).

    With block_q=None every row walks every tile, masked: a tile the kernel
    skips adds exact zeros. With block_q, the walk is the kernel's own:
    blocks of `block_q` rows, warpgroups of WG_ROWS rows within them, each
    over all the block's reachable k tiles, keys past T read as zeros, and
    masks only on tiles that cross the warpgroup's diagonal, its window's
    first key or T."""
    B, S, N, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(1.4426950408889634,
                                                                           dtype=torch.float32)
    if block_q is None:
        rows = [(0, S, range(0, -(-T // block_k)), True)]
    else:
        rows = []
        n_tiles = -(-T // block_k)
        for q_start in range(0, S, block_q):
            q_end = min(q_start + block_q, S) - 1
            lo = q_start - window + 1
            first = 0 if lo <= 0 else lo // block_k
            stop = min(n_tiles, q_end // block_k + 1) if causal else n_tiles
            for q0 in range(q_start, min(q_start + block_q, S), WG_ROWS):
                rows.append((q0, min(q0 + WG_ROWS, S), range(first, stop), False))
    pad = -T % block_k   # the kernel's tiles read keys past T as zeros
    kk = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vv = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kk = kk.repeat_interleave(N // K, 2).permute(0, 2, 3, 1)             # (B, N, hd, T + pad)
    vv = vv.repeat_interleave(N // K, 2).transpose(1, 2)                 # (B, N, T + pad, hd)
    out = torch.zeros((B, N, S, hd))
    for r0, r1, tiles, always_mask in rows:
        qq = q[:, r0:r1].float().transpose(1, 2)                         # (B, N, rows, hd)
        qpos = torch.arange(r0, r1)[:, None]
        m = torch.full((B, N, r1 - r0, 1), NEG_INF)
        l = torch.zeros((B, N, r1 - r0, 1))
        acc = torch.zeros((B, N, r1 - r0, hd))
        for kt in tiles:
            k0 = kt * block_k
            kpos = torch.arange(k0, k0 + block_k)[None, :]
            s = qq @ kk[..., k0:k0 + block_k]
            edge = (always_mask or k0 + block_k > T or (causal and k0 + block_k - 1 > r0)
                    or r0 + WG_ROWS - 1 - k0 >= window)
            if edge:
                keep = (kpos < T) & (qpos - kpos < window)
                if causal:
                    keep = keep & (qpos >= kpos)
                s = torch.where(keep, s * scale_log2, NEG_INF)
            else:
                s = s * scale_log2
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
        out[:, :, r0:r1] = acc / torch.clamp(l, min=1e-20)
    return out.transpose(1, 2).to(q.dtype)


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


# The bf16 kernel's own walk at each head dim (blocks of BF16_BLOCK_Q rows,
# warpgroups of 64, BF16_BLOCK_K keys): causal under the global window and
# under a window one key past a key tile, and non-causal with ragged S and T.
# (shape, T, window, causal)
WGMMA_EMULATED = [case for hd in HEAD_DIMS for case in (
    ((1, 1000, 4, 2, hd), 1000, 1 << 30, True),
    ((1, 1000, 4, 2, hd), 1000, BF16_BLOCK_K[hd] + 1, True),
    ((2, 200, 4, 4, hd), 330, 1 << 30, False))]


def _case_id(c):
    return "B{}S{}N{}K{}hd{}".format(*c[0]) + f"-T{c[1]}-w{c[2]}" + ("" if c[3] else "-noncausal")


def _wgmma_emulation_error(reference, case, split_p):
    """max |emulation - oracle| over the one-ulp bound, at the kernel's tiles."""
    jnp, ml_dtypes, jax_ref, _ = reference
    shape, T, window, causal = case
    q, k, v = _cast(make_inputs(*shape, seed=shape[-1] + window % 89, T=T), "bfloat16",
                    ml_dtypes)
    scale = shape[-1] ** -0.5
    ref = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.int32(window), causal=causal, scale=scale), np.float32)
    out = tensor_core_attention(_torch(q), _torch(k), _torch(v), window, scale=scale,
                                causal=causal, block_k=BF16_BLOCK_K[shape[-1]],
                                block_q=BF16_BLOCK_Q, split_p=split_p).float().numpy()
    bound = PATH_TOL["bfloat16"]["atol"] + PATH_TOL["bfloat16"]["rtol"] * np.abs(ref)
    return float(np.max(np.abs(out - ref) / bound))


@pytest.mark.parametrize("case", WGMMA_EMULATED, ids=_case_id)
def test_wgmma_tiles_hold_one_bf16_ulp(reference, case):
    """The kernel's walk (the block's reachable tiles for both warpgroups,
    edge-only masks, keys past T as zeros) and its split P·V against the
    reference's oracle, element by element within one bf16 ulp."""
    assert _wgmma_emulation_error(reference, case, split_p=True) <= 1.0


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_one_rounding_of_p_breaks_the_bound_at_wgmma_tiles(reference, hd):
    """Why P stays split: at the kernel's tiles, one bf16 rounding of P puts
    some output past the one-ulp bound that the split holds."""
    case = ((1, 1000, 4, 2, hd), 1000, 1 << 30, True)
    assert _wgmma_emulation_error(reference, case, split_p=True) <= 1.0
    assert _wgmma_emulation_error(reference, case, split_p=False) > 1.0


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


# The bf16 kernel's edges, bf16 only (fp32 takes the CUDA-core kernel):
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


# The wgmma kernel's tiles: blocks of 128 query rows in warpgroups of 64,
# key tiles of BF16_BLOCK_K[hd] (128, 96, 64 or 48). Windows about the
# warpgroup, the block and the key tile at every head dim; S ragged against
# the block and the warpgroup (S 64 and 65: the second warpgroup has no row
# or one); non-causal with T ragged against the key tile.
# (shape, T, window, causal)
WGMMA_CASES = ([((1, 1000, 4, 2, hd), 1000, w, True) for hd in HEAD_DIMS
                for w in sorted({1, 63, 64, 65, 127, 128, 129, BF16_BLOCK_K[hd] - 1,
                                 BF16_BLOCK_K[hd], BF16_BLOCK_K[hd] + 1})]
               + [((2, S, 4, 2, hd), S, 1 << 30, True) for hd in HEAD_DIMS
                  for S in (1, 64, 65, 127, 129, 300)]
               + [((2, 129, 4, 4, hd), 65, 1 << 30, False) for hd in HEAD_DIMS]
               + [((2, 64, 4, 2, hd), 300, 1 << 30, False) for hd in HEAD_DIMS])


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES, ids=_case_id)
def test_cuda_wgmma_kernel_edges_within_one_bf16_ulp(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape, T, window, causal = case
    q, k, v = (_torch(a).cuda().to(torch.bfloat16) for a in make_inputs(*shape, seed=15, T=T))
    scale = shape[-1] ** -0.5
    out = flash_attention(q, k, v, window=window, scale=scale, causal=causal)
    ref = attention_ref(q, k, v, window, scale=scale, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), **PATH_TOL["bfloat16"])


# Every shape the prefill paths give the kernel (chip_smoke.py's FLASH_PATH,
# FLASH_ONE_CARD and FLASH_WIDE): gemma3-1b global and sliding 512,
# zamba2-1.2b, olmoe-1b-7b, deepseek-coder-33b, gemma3-12b global and
# sliding 1024, internvl2-1b, hubert-xlarge (hd 80, non-causal) and
# nemotron-4-340b's hd 192. (shape, window, causal)
FLASH_SHAPES = [((2, 2048, 4, 1, 256), 1 << 30, True), ((2, 2048, 4, 1, 256), 512, True),
                ((2, 2048, 32, 32, 64), 1 << 30, True), ((2, 2048, 16, 16, 128), 1 << 30, True),
                ((2, 2048, 56, 8, 128), 1 << 30, True), ((2, 2048, 16, 8, 256), 1 << 30, True),
                ((2, 2048, 16, 8, 256), 1024, True), ((2, 2048, 14, 2, 64), 1 << 30, True),
                ((2, 2048, 16, 16, 80), 1 << 30, False), ((1, 2048, 96, 8, 192), 1 << 30, True)]
FLASH_SHAPE_IDS = ["gemma3-global", "gemma3-sliding", "zamba2", "olmoe", "deepseek",
                   "gemma3-12b-global", "gemma3-12b-sliding", "internvl2", "hubert-hd80",
                   "nemotron-hd192"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_SHAPES, ids=FLASH_SHAPE_IDS)
def test_cuda_wgmma_kernel_at_every_path_shape(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (B, S, N, K, hd), window, causal = case
    g = torch.Generator(device="cuda").manual_seed(16)
    q, k, v = ((torch.randn(s, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
               for s in ((B, S, N, hd), (B, S, K, hd), (B, S, K, hd)))
    scale = hd ** -0.5
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


# ``flash_attention_bnh``, the reference's entry point over flattened
# batch x heads with K/V already broadcast: (BN, S, hd, T), window, causal.
BNH = [((6, 160, 32, 160), 1 << 30, True), ((6, 160, 32, 160), 48, True),
       ((4, 130, 64, 130), 1 << 30, False), ((3, 100, 80, 140), 1 << 30, False)]
BNH_IDS = ["global", "window48", "noncausal", "hd80-T140-noncausal"]


def bnh_inputs(BN, S, hd, T, seed):
    q, k, v = make_inputs(BN, S, 1, 1, hd, seed, T=T)
    return q[:, :, 0], k[:, :, 0], v[:, :, 0]


@pytest.mark.parametrize("case", BNH, ids=BNH_IDS)
def test_bnh_matches_reference_kernel(reference, case):
    """CPU tensors take the plain version, held at 2e-5 (fp32) against the
    reference's ``flash_attention_bnh`` with its Pallas kernel in interpret
    mode; the window may come as an int or a one-element tensor."""
    jnp = reference[0]
    r_fa = pytest.importorskip("repro.kernels.flash_attention.flash_attention")
    (BN, S, hd, T), window, causal = case
    q, k, v = bnh_inputs(BN, S, hd, T, seed=12)
    scale = hd ** -0.5
    ref = r_fa.flash_attention_bnh(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.int32(window), causal=causal, scale=scale,
                                   interpret=True)
    before = kernel_mod.launches
    for w in (window, torch.tensor([window], dtype=torch.int32)):
        out = kernel_mod.flash_attention_bnh(_torch(q), _torch(k), _torch(v), w,
                                             causal=causal, scale=scale)
        assert out.shape == (BN, S, hd)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    assert kernel_mod.launches == before


def test_bnh_names_and_arguments_match_the_reference(reference):
    r_fa = pytest.importorskip("repro.kernels.flash_attention.flash_attention")
    r_pa = pytest.importorskip("repro.kernels.paged_attention.paged_attention")
    from repro_torch.kernels.paged_attention import paged_attention as t_pa

    assert (kernel_mod.DEFAULT_BLOCK_Q, kernel_mod.DEFAULT_BLOCK_K, kernel_mod.NEG_INF) == \
        (r_fa.DEFAULT_BLOCK_Q, r_fa.DEFAULT_BLOCK_K, r_fa.NEG_INF)
    assert t_pa.NEG_INF == r_pa.NEG_INF
    q, k, v = (_torch(a) for a in bnh_inputs(2, 40, 32, 40, seed=13))
    # The CUDA kernel picks its own tiles: the block arguments change nothing.
    base = kernel_mod.flash_attention_bnh(q, k, v, 16, scale=0.2)
    assert torch.equal(base, kernel_mod.flash_attention_bnh(q, k, v, 16, scale=0.2,
                                                            block_q=32, block_k=256))
    with pytest.raises(ValueError, match="block_q"):
        kernel_mod.flash_attention_bnh(q, k, v, 16, scale=0.2, block_q=0)
    with pytest.raises(ValueError, match="window"):
        kernel_mod.flash_attention_bnh(q, k, v, torch.tensor([16, 16]), scale=0.2)
    with pytest.raises(ValueError, match="shapes"):
        kernel_mod.flash_attention_bnh(q[None], k, v, 16, scale=0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BNH, ids=BNH_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bnh_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (BN, S, hd, T), window, causal = case
    q, k, v = (_torch(a).cuda().to(getattr(torch, dtype))
               for a in bnh_inputs(BN, S, hd, T, seed=14))
    scale = hd ** -0.5
    before = kernel_mod.launches
    out = kernel_mod.flash_attention_bnh(q, k, v, window, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert kernel_mod.launches == before + 1
    ref = attention_ref(q[:, :, None], k[:, :, None], v[:, :, None], window, scale=scale,
                        causal=causal)[:, :, 0]
    torch.testing.assert_close(out.float(), ref.float(), **PATH_TOL[dtype])
