"""Paged decode attention: the port's plain version against the reference's
Pallas kernel (interpret mode), and the CUDA kernel against the plain version.

Tolerances: 2e-5 in fp32 (the reference's own sweep, tests/test_kernels.py);
2e-2 where q and the output are bf16, whose 8-bit mantissa rounds at ~4e-3.

JAX is imported only by the reference comparison, so the CUDA cases also run
on a machine with a card and no JAX (see README, "PyTorch / H100 port").
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_attention import paged_attention as kernel_mod  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402

SWEEP = [  # (B, N, K, hd, page, max_pages): tests/test_kernels.py:54 plus the serving shape
    (2, 4, 2, 64, 16, 4),
    (3, 8, 8, 32, 8, 6),
    (1, 8, 1, 128, 32, 2),
    (4, 4, 1, 256, 8, 5),
]
WINDOWS = [1 << 30, 24]


def make_inputs(B, N, K, hd, page, maxp, seed):
    rng = np.random.default_rng(seed)
    P = B * maxp + 2
    q = (rng.standard_normal((B, N, hd)) * 0.5).astype(np.float32)
    kp = (rng.standard_normal((P, page, K, hd)) * 0.5).astype(np.float32)
    vp = (rng.standard_normal((P, page, K, hd)) * 0.5).astype(np.float32)
    table = rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = rng.integers(1, page * maxp, (B,)).astype(np.int32)
    lengths[0] = page * maxp          # a full sequence: the last page's edge
    return q, kp, vp, table, lengths


@pytest.fixture(scope="module")
def reference():
    """The JAX package's paged attention, and the JAX and ml_dtypes modules."""
    jnp = pytest.importorskip("jax.numpy")
    ml_dtypes = pytest.importorskip("ml_dtypes")
    ops = pytest.importorskip("repro.kernels.paged_attention.ops")
    return jnp, ml_dtypes, ops.paged_attention


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np32(t):
    return t.float().numpy()


@pytest.mark.parametrize("shape", SWEEP, ids=lambda s: "B{}N{}K{}hd{}p{}m{}".format(*s))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(reference, shape, window, q_dtype):
    jnp, ml_dtypes, jax_paged_attention = reference
    q, kp, vp, table, lengths = make_inputs(*shape, seed=sum(shape) + window % 97)
    if q_dtype == "bfloat16":
        q = q.astype(ml_dtypes.bfloat16)
    hd = shape[3]
    ref = jax_paged_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(table), jnp.asarray(lengths), jnp.int32(window),
                              scale=hd ** -0.5, interpret=True)
    out = paged_attention(_torch(q), _torch(kp), _torch(vp), _torch(table), _torch(lengths),
                          window, scale=hd ** -0.5)
    assert out.dtype == (torch.float32 if q_dtype == "float32" else torch.bfloat16)
    tol = 2e-5 if q_dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np32(out), np.asarray(ref, np.float32), atol=tol, rtol=tol)


def test_cpu_tensors_take_the_plain_version():
    q, kp, vp, table, lengths = (_torch(a) for a in make_inputs(*SWEEP[0], seed=3))
    before = kernel_mod.launches
    out = paged_attention(q, kp, vp, table, lengths, 1 << 30, scale=0.125)
    ref = paged_attention_ref(q, kp, vp, table, lengths, 1 << 30, scale=0.125)
    assert torch.equal(out, ref) and kernel_mod.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    q, kp, vp, table, lengths = (_torch(a) for a in make_inputs(*SWEEP[0], seed=4))
    with pytest.raises(ValueError, match="CUDA"):
        kernel_mod.paged_attention(q, kp, vp, table, lengths, 1 << 30, scale=0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SWEEP, ids=lambda s: "B{}N{}K{}hd{}p{}m{}".format(*s))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(shape, window, q_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, kp, vp, table, lengths = (_torch(a).cuda() for a in make_inputs(*shape, seed=5))
    if q_dtype == "bfloat16":
        q = q.to(torch.bfloat16)
    scale = shape[3] ** -0.5
    before = kernel_mod.launches
    out = paged_attention(q, kp, vp, table, lengths, window, scale=scale)
    torch.cuda.synchronize()
    assert kernel_mod.launches == before + 1
    ref = paged_attention_ref(q, kp, vp, table, lengths, window, scale=scale)
    tol = 2e-5 if q_dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
