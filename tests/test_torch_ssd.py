"""Mamba2 SSD: the port's oracle scan, plain chunked form and decode step against
the reference's, and the CUDA kernel against the plain version.

Tolerance 5e-4, the reference's own (tests/test_kernels.py:109): the chunked
form sums in another order than the step-by-step scan.

JAX is imported only by the reference comparisons, so the CUDA cases also run
on a machine with a card and no JAX (see README, "PyTorch / H100 port").
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mamba2_ssd import mamba2_ssd as kernel_mod  # noqa: E402
from repro_torch.kernels.mamba2_ssd.ops import _ssd_chunked, ssd, ssd_decode_step  # noqa: E402
from repro_torch.kernels.mamba2_ssd.ref import ssd_ref  # noqa: E402

SWEEP = [(2, 64, 2, 16, 8), (1, 45, 4, 8, 16)]   # (B, T, H, P, N): tests/test_kernels.py:109
ATOL = 5e-4


def make_inputs(B, T, H, P, N, seed):
    """x, dt, A, Bm, C, D, h0 as fp32 numpy arrays, drawn as the reference's sweep draws them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, H, P)) * 0.5).astype(np.float32)
    dt = rng.uniform(1e-3, 2.0, (B, T, H)).astype(np.float32)
    A = (-rng.uniform(0.5, 8.0, (H,))).astype(np.float32)
    Bm = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    D = (rng.standard_normal((H,)) * 0.05).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.05).astype(np.float32)
    return x, dt, A, Bm, C, D, h0


@pytest.fixture(scope="module")
def reference():
    jnp = pytest.importorskip("jax.numpy")
    ops = pytest.importorskip("repro.kernels.mamba2_ssd.ops")
    pallas = pytest.importorskip("repro.kernels.mamba2_ssd.mamba2_ssd")
    ref = pytest.importorskip("repro.kernels.mamba2_ssd.ref")
    return jnp, ops, pallas.ssd_pallas, ref.ssd_ref


def _both(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", SWEEP, ids=lambda s: "B{}T{}H{}P{}N{}".format(*s))
@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
def test_matches_reference(reference, shape, impl):
    """ssd_ref vs ssd_ref, _ssd_chunked vs ssd(impl="chunked"), and the CPU path
    of impl="pallas" (the plain chunked form) vs ssd_pallas in interpret mode."""
    jnp, r_ops, r_pallas, r_ref = reference
    arrays = make_inputs(*shape, seed=sum(shape))
    jargs = [jnp.asarray(a) for a in arrays]
    if impl == "ref":
        y_ref, h_ref = r_ref(*jargs)
        y, h = ssd_ref(*_both(arrays))
    elif impl == "chunked":
        y_ref, h_ref = r_ops.ssd(*jargs, impl="chunked", chunk=16)
        y, h = _ssd_chunked(*_both(arrays), chunk=16)
    else:
        y_ref, h_ref = r_pallas(*jargs, chunk=16, interpret=True)
        y, h = ssd(*_both(arrays), impl="pallas", chunk=16)
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)


def test_chunked_matches_scan_in_the_port():
    """tests/test_kernels.py:109 in the port alone, at the default chunk."""
    arrays = _both(make_inputs(1, 45, 4, 8, 16, seed=2))
    y_ref, h_ref = ssd_ref(*arrays)
    y, h = ssd(*arrays)
    torch.testing.assert_close(y, y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(h, h_ref, atol=ATOL, rtol=0)


def test_chunked_runs_in_float64_when_every_input_is_float64():
    """The fp64 yardstick: chunk sizes agree to fp64 rounding, and the fp32
    form stays within the sweep's tolerance of it."""
    arrays = _both(make_inputs(1, 45, 4, 8, 16, seed=3))
    y64, h64 = _ssd_chunked(*(t.double() for t in arrays), chunk=16)
    y64b, h64b = _ssd_chunked(*(t.double() for t in arrays), chunk=5)
    assert y64.dtype == h64.dtype == torch.float64
    torch.testing.assert_close(y64, y64b, atol=1e-10, rtol=0)
    torch.testing.assert_close(h64, h64b, atol=1e-10, rtol=0)
    y32, h32 = _ssd_chunked(*arrays, chunk=16)
    assert y32.dtype == torch.float32
    torch.testing.assert_close(y32.double(), y64, atol=ATOL, rtol=0)
    torch.testing.assert_close(h32.double(), h64, atol=ATOL, rtol=0)


def test_decode_step_matches_reference_and_scan(reference):
    jnp, r_ops, _, _ = reference
    x, dt, A, Bm, C, D, h0 = make_inputs(2, 6, 4, 8, 16, seed=9)
    state_t, state_r = torch.from_numpy(h0), jnp.asarray(h0)
    ys = []
    for t in range(6):
        step = (x[:, t], dt[:, t], A, Bm[:, t], C[:, t], D)
        y_r, state_r = r_ops.ssd_decode_step(*(jnp.asarray(a) for a in step), state_r)
        y_t, state_t = ssd_decode_step(*_both(step), state_t)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), atol=1e-5)
        ys.append(y_t)
    np.testing.assert_allclose(state_t.numpy(), np.asarray(state_r), atol=1e-5)
    y_scan, h_scan = ssd_ref(*_both((x, dt, A, Bm, C, D, h0)))
    torch.testing.assert_close(torch.stack(ys, 1), y_scan, atol=1e-5, rtol=0)
    torch.testing.assert_close(state_t, h_scan, atol=1e-5, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    arrays = _both(make_inputs(1, 45, 4, 8, 16, seed=4))
    before = kernel_mod.launches
    y, h = ssd(*arrays, impl="pallas", chunk=16)
    y_plain, h_plain = _ssd_chunked(*arrays, chunk=16)
    assert torch.equal(y, y_plain) and torch.equal(h, h_plain)
    assert kernel_mod.launches == before


def test_kernel_wrapper_rejects_what_it_cannot_take():
    arrays = _both(make_inputs(1, 45, 4, 8, 16, seed=5))
    with pytest.raises(ValueError, match="CUDA"):
        kernel_mod.ssd_pallas(*arrays, chunk=16)
    with pytest.raises(ValueError, match="unknown ssd impl"):
        ssd(*arrays, impl="xla")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SWEEP, ids=lambda s: "B{}T{}H{}P{}N{}".format(*s))
def test_cuda_kernel_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arrays = [t.cuda() for t in _both(make_inputs(*shape, seed=6))]
    before = kernel_mod.launches
    y, h = ssd(*arrays, impl="pallas", chunk=16)
    torch.cuda.synchronize()
    assert kernel_mod.launches == before + 1
    y_ref, h_ref = ssd_ref(*arrays)
    torch.testing.assert_close(y, y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(h, h_ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_keeps_large_decays_accurate():
    """dt up to ~500, as a model's activations give it: |L| reaches ~1e5 in a
    chunk, where fp32 differences of L lose digits. The kernel scans L in
    fp64 and stays within 5e-4 (relative to the largest |value|) of the fp64
    evaluation of the same algorithm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, dt, A, Bm, C, D, h0 = (t.cuda() for t in _both(make_inputs(2, 256, 8, 64, 64, seed=10)))
    dt = dt * torch.rand(dt.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(0)) ** 4 * 250
    A = A * 2
    y, h = ssd(x, dt, A, Bm, C, D, h0, impl="pallas")
    y64, h64 = _ssd_chunked(*(t.double() for t in (x, dt, A, Bm, C, D, h0)), chunk=32)
    for out, ref in ((y, y64), (h, h64)):
        assert (out.double() - ref).abs().max() <= ATOL * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_the_path_shape():
    """zamba2-1.2b's heads (H 64, P 64, N 64) at chunk 32, bf16 x/B/C, T cut to 200."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, dt, A, Bm, C, D, h0 = (t.cuda() for t in _both(make_inputs(2, 200, 64, 64, 64, seed=8)))
    x, Bm, C = (t.to(torch.bfloat16) for t in (x, Bm, C))
    y, h = ssd(x, dt, A, Bm, C, D, h0, impl="pallas")
    y_ref, h_ref = _ssd_chunked(x, dt, A, Bm, C, D, h0, chunk=32)
    torch.testing.assert_close(y, y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(h, h_ref, atol=ATOL, rtol=0)
