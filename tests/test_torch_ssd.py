"""Mamba2 SSD: the port's oracle scan, plain chunked form and decode step against
the reference's, the CUDA kernel's three-pass split rehearsed in plain torch,
and the CUDA kernel against the plain version.

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


def ssd_state_passing(x, dt, A, Bm, C, D, state, chunk):
    """The CUDA kernel's split in plain torch, in its arithmetic: fp32 products,
    L = A * cumsum(dt) scanned and differenced in fp64.
      pass 1: C B^T once per (b, chunk); each chunk's own state contribution
              dH_c = (x dt exp(L_last - L))^T B and exp(L_last), for all chunks
              at once;
      pass 2: H_c = exp(L_last,c) H_{c-1} + dH_c, keeping the state each chunk
              starts from;
      pass 3: y = masked scores . x + exp(L_t) (C_t . H_{c-1}) + D x, all
              chunks at once."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    x, Bm, C = (t.float() for t in (x, Bm, C))
    pad = -T % chunk
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    dt = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    Bm, C = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (Bm, C))
    nc = x.shape[1] // chunk
    xc = x.reshape(B, nc, chunk, H, P)
    dtc = dt.reshape(B, nc, chunk, H)
    Bc, Cc = Bm.reshape(B, nc, chunk, N), C.reshape(B, nc, chunk, N)
    L = A.double() * torch.cumsum(dtc.double(), dim=2)                    # (B,nc,c,H)
    # pass 1
    cb = torch.einsum("bntk,bnsk->bnts", Cc, Bc)                         # (B,nc,c,c)
    w = dtc * torch.exp((L[:, :, -1:] - L).float())
    d_h = torch.einsum("bnshp,bnsk->bnhpk", xc * w[..., None], Bc)        # (B,nc,H,P,N)
    a_last = torch.exp(L[:, :, -1].float())                              # (B,nc,H)
    # pass 2
    h, starts = state.float(), []
    for n in range(nc):
        starts.append(h)
        h = a_last[:, n, :, None, None] * h + d_h[:, n]
    h_prev = torch.stack(starts, dim=1)                                  # (B,nc,H,P,N)
    # pass 3
    decay = torch.exp(torch.clamp((L[:, :, :, None] - L[:, :, None, :]).float(), max=0.0))
    mask = torch.tril(torch.ones((chunk, chunk)))[None, None, :, :, None]
    scores = cb[..., None] * decay * dtc[:, :, None] * mask              # (B,nc,t,s,H)
    intra = torch.einsum("bntsh,bnshp->bnthp", scores, xc)
    cross = torch.einsum("bntk,bnhpk->bnthp", Cc, h_prev)
    y = intra + torch.exp(L.float())[..., None] * cross + D.float()[:, None] * xc
    return y.reshape(B, nc * chunk, H, P)[:, :T], h


REHEARSAL = [((2, 64, 2, 16, 8), 16), ((1, 45, 4, 8, 16), 16), ((1, 45, 4, 8, 16), 32),
             ((2, 7, 3, 8, 8), 32), ((1, 100, 2, 24, 12), 32)]


@pytest.mark.parametrize("shape,chunk", REHEARSAL,
                         ids=lambda v: "B{}T{}H{}P{}N{}".format(*v) if isinstance(v, tuple) else f"c{v}")
def test_state_passing_split_matches_reference(reference, shape, chunk):
    """The kernel's three passes against the reference's Pallas kernel in
    interpret mode (5e-4): T a chunk multiple, ragged, and shorter than one
    chunk; widths that are multiples of 4 but not of 8."""
    jnp, _, r_pallas, _ = reference
    arrays = make_inputs(*shape, seed=sum(shape) + chunk)
    y_ref, h_ref = r_pallas(*(jnp.asarray(a) for a in arrays), chunk=chunk, interpret=True)
    y, h = ssd_state_passing(*_both(arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)


@pytest.mark.parametrize("chunk", [16, 32])
def test_state_passing_split_keeps_large_decays_accurate(chunk):
    """dt up to ~500, as zamba2-1.2b's activations give it: the split with L in
    fp64 stays within 5e-4 of max(1, magnitude) of the fp64 evaluation, where
    the fp32 chunked form (the reference's arithmetic) does not."""
    x, dt, A, Bm, C, D, h0 = _both(make_inputs(1, 96, 4, 16, 16, seed=11))
    g = torch.Generator().manual_seed(0)
    dt = dt * torch.rand(dt.shape, generator=g) ** 4 * 250
    A = A * 2
    args = (x, dt, A, Bm, C, D, h0)
    y, h = ssd_state_passing(*args, chunk=chunk)
    y64, h64 = _ssd_chunked(*(t.double() for t in args), chunk=chunk)
    y32, h32 = _ssd_chunked(*args, chunk=chunk)

    def rel(out, ref):
        return (out.double() - ref).abs().max().item() / max(1.0, ref.abs().max().item())

    assert dt.max() > 100
    assert rel(y, y64) <= ATOL and rel(h, h64) <= ATOL
    assert max(rel(y32, y64), rel(h32, h64)) > rel(y, y64)


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


def test_kernel_widths():
    """Head dims P up to 64 and states N up to 128, multiples of 4: granite-4.0-h's
    P 64, N 128 and zamba2's 64, 64 pass; P 80, N 132 and widths no multiple
    of 4 are refused before any launch."""
    for P, N in ((64, 128), (64, 64), (4, 4), (8, 124)):
        kernel_mod.check_widths(P, N)
    for P, N, what in ((80, 16, "P=80"), (64, 132, "N=132"), (6, 16, "P=6"), (8, 130, "N=130"),
                       (128, 64, "P=128")):
        with pytest.raises(ValueError, match=what):
            kernel_mod.check_widths(P, N)


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


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_granites_shape():
    """granite-4.0-h-small's heads (H 128, P 64, N 128) at chunk 32, bf16 x/B/C,
    one prompt of 4096 tokens: the kernel built for states up to 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, dt, A, Bm, C, D, h0 = (t.cuda() for t in _both(make_inputs(1, 4096, 128, 64, 128, seed=9)))
    x, Bm, C = (t.to(torch.bfloat16) for t in (x, Bm, C))
    y, h = ssd(x, dt, A, Bm, C, D, h0, impl="pallas")
    y_ref, h_ref = _ssd_chunked(x, dt, A, Bm, C, D, h0, chunk=32)
    torch.testing.assert_close(y, y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(h, h_ref, atol=ATOL, rtol=0)


EDGES = [((1, 1, 2, 8, 8), 16), ((1, 1, 2, 8, 8), 32), ((2, 16, 3, 16, 8), 16),
         ((2, 32, 3, 8, 16), 32), ((1, 33, 2, 64, 64), 32), ((2, 45, 2, 24, 40), 16),
         ((1, 77, 5, 64, 8), 32), ((1, 70, 2, 8, 64), 16), ((2, 130, 4, 32, 32), 32),
         # states past 64: the instantiation for N <= 128, its tiles half idle
         # (N 68, 100), whole (128), with P from 8 to 64 and ragged T
         ((1, 1, 2, 8, 128), 32), ((1, 33, 3, 64, 128), 32), ((2, 45, 2, 24, 100), 16),
         ((1, 77, 5, 64, 68), 32), ((2, 130, 4, 16, 128), 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,chunk", EDGES,
                         ids=lambda v: "B{}T{}H{}P{}N{}".format(*v) if isinstance(v, tuple) else f"c{v}")
def test_cuda_kernel_matches_plain_at_its_edges(shape, chunk, dtype):
    """The three passes' edges: T = 1, one whole chunk, one chunk and a
    position, ragged T; both compiled chunks; P from 8 to 64 and N from 8 to
    128, both instantiations (N <= 64, N <= 128), tiles of pass 1 and 3 left
    idle and widths no multiple of 8. Against
    the step-by-step oracle on the same (rounded) inputs, at 5e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, dt, A, Bm, C, D, h0 = (t.cuda() for t in _both(make_inputs(*shape, seed=sum(shape))))
    x, Bm, C = (t.to(getattr(torch, dtype)) for t in (x, Bm, C))
    before = kernel_mod.launches
    y, h = ssd(x, dt, A, Bm, C, D, h0, impl="pallas", chunk=chunk)
    torch.cuda.synchronize()
    assert kernel_mod.launches == before + 1
    assert tuple(y.shape) == tuple(x.shape) and y.dtype == torch.float32
    y_ref, h_ref = ssd_ref(x, dt, A, Bm, C, D, h0)
    torch.testing.assert_close(y, y_ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(h, h_ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_wrapper_rejects_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, dt, A, Bm, C, D, h0 = (t.cuda() for t in _both(make_inputs(1, 20, 2, 8, 16, seed=12)))
    with pytest.raises(ValueError, match="chunk"):
        kernel_mod.ssd_pallas(x, dt, A, Bm, C, D, h0, chunk=8)
    wide = torch.zeros((1, 20, 2, 80), device="cuda")
    with pytest.raises(ValueError, match="P=80"):
        kernel_mod.ssd_pallas(wide, dt, A, Bm, C, D, torch.zeros((1, 2, 80, 16), device="cuda"))
    deep = torch.zeros((1, 20, 132), device="cuda")
    with pytest.raises(ValueError, match="N=132"):
        kernel_mod.ssd_pallas(x, dt, A, deep, deep, D, torch.zeros((1, 2, 8, 132), device="cuda"))
    odd = torch.zeros((1, 20, 2, 6), device="cuda")
    with pytest.raises(ValueError, match="P=6"):
        kernel_mod.ssd_pallas(odd, dt, A, Bm, C, D, torch.zeros((1, 2, 6, 16), device="cuda"))
    shifted = torch.zeros(h0.numel() + 1, device="cuda")[1:].view(h0.shape)
    with pytest.raises(ValueError, match="16-byte"):
        kernel_mod.ssd_pallas(x, dt, A, Bm, C, D, shifted)
    with pytest.raises(ValueError, match="dtypes"):
        kernel_mod.ssd_pallas(x.bfloat16(), dt, A, Bm, C, D, h0)
    with pytest.raises(ValueError, match="float32"):
        kernel_mod.ssd_pallas(x, dt.bfloat16(), A, Bm, C, D, h0)
    with pytest.raises(ValueError, match="contiguous"):
        kernel_mod.ssd_pallas(x.transpose(2, 3), dt, A, Bm, C, D, h0)
