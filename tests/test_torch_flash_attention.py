"""Flash attention: the port's plain version against the reference's oracle and
its Pallas kernel (interpret mode), and the CUDA kernel against the plain version.

Tolerances: 2e-5 in fp32 and 2e-2 in bf16, the reference's own sweep
(tests/test_kernels.py:27); the bf16 output's 8-bit mantissa rounds at ~4e-3.
At the main path's shapes the kernel is held at 2e-5 in fp32 and, in bf16,
within one bf16 ulp of the plain output (8e-3 of |plain| + 1e-4): outputs
there are ~0.01-0.02, so a flat 2e-2 would not tell a lost k tile from rounding.

JAX is imported only by the reference comparisons, so the CUDA cases also run
on a machine with a card and no JAX (see README, "PyTorch / H100 port").
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention as kernel_mod  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

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
