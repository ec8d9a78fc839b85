"""Paged decode attention: the port's plain version against the reference's
Pallas kernel (interpret mode), the CUDA kernel's split over partitions
rehearsed in plain torch against the same kernel, and the CUDA kernel against
the plain version.

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
from repro_torch.kernels.paged_attention.ref import NEG_INF, paged_attention_ref  # noqa: E402

SWEEP = [  # (B, N, K, hd, page, max_pages): tests/test_kernels.py:54 plus the serving shape
    (2, 4, 2, 64, 16, 4),
    (3, 8, 8, 32, 8, 6),
    (1, 8, 1, 128, 32, 2),
    (4, 4, 1, 256, 8, 5),
    # and published groups and head dims past the first four: G 7 (internvl2-1b),
    # G 12 at hd 192 (nemotron-4-340b), hd 80 (hubert-xlarge)
    (2, 14, 2, 64, 8, 4),
    (1, 24, 2, 192, 8, 3),
    (2, 4, 4, 80, 8, 3),
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


def make_split_inputs(B, N, K, hd, page, maxp, lengths, seed):
    """Like make_inputs, with the lengths given."""
    q, kp, vp, table, _ = make_inputs(B, N, K, hd, page, maxp, seed)
    return q, kp, vp, table, np.asarray(lengths, np.int32)


# The split's edges: (B, N, K, hd, page, max_pages), lengths, window, partition.
# Windows that cut a page and a partition in the middle, lengths 1 and the
# partition +- 1, mixed lengths in one batch, lengths 100x apart, partitions
# wholly before the window's first page and wholly past the length.
SPLIT_CASES = [
    ((5, 4, 1, 64, 8, 10), [1, 31, 32, 33, 80], 20, 32),
    ((5, 4, 1, 64, 8, 10), [1, 31, 32, 33, 80], 1 << 30, 32),
    ((4, 8, 2, 32, 16, 8), [1, 63, 64, 65], 40, 64),
    ((5, 4, 1, 256, 8, 40), [1, 63, 64, 65, 320], 24, 64),
    ((5, 4, 1, 256, 8, 40), [1, 127, 128, 129, 320], 1 << 30, 128),
    ((2, 8, 1, 128, 32, 32), [3, 300], 100, 128),
    ((3, 2, 2, 64, 8, 24), [7, 100, 192], 1, 32),
]


def split_paged_attention(q, k_pages, v_pages, block_table, lengths, window, *, scale,
                          partition):
    """The CUDA kernel's algebra in plain torch. Per (sequence, kv head,
    partition of `partition` tokens): the tokens from the first page the
    window reaches to `length`, within the table; a partial (m, l, acc) of an
    fp32 softmax, or the empty partial (-1e30, 0, 0) when none; then the
    combine: sum_p e^(m_p - M) acc_p / max(sum_p e^(m_p - M) l_p, 1e-20)."""
    B, N, hd = q.shape
    _, page, K, _ = k_pages.shape
    G = N // K
    max_pages = block_table.shape[1]
    parts = -(-max_pages * page // partition)
    out = torch.empty((B, N, hd), dtype=torch.float32)
    for b in range(B):
        length = int(lengths[b])
        q_pos = length - 1
        edge = q_pos - window - page + 1
        first_page = 0 if edge < 0 else edge // page + 1
        for kv in range(K):
            qg = q[b, kv * G:(kv + 1) * G].float()
            ms, ls, accs = [], [], []
            for part in range(parts):
                start = max(part * partition, first_page * page)
                end = min(part * partition + partition, length, max_pages * page)
                if end <= start:
                    ms.append(torch.full((G,), NEG_INF))
                    ls.append(torch.zeros(G))
                    accs.append(torch.zeros(G, hd))
                    continue
                pos = torch.arange(start, end)
                slots = block_table[b, pos // page].long()
                s = (qg @ k_pages[slots, pos % page, kv].T) * scale
                s = torch.where((q_pos - pos < window)[None], s, NEG_INF)
                m = s.max(dim=1).values
                assert bool((m > NEG_INF).all()), "a partition with pages has a real max"
                p = torch.exp(s - m[:, None])
                ms.append(m)
                ls.append(p.sum(1))
                accs.append(p @ v_pages[slots, pos % page, kv])
            m = torch.stack(ms)
            w = torch.exp(m - m.max(0).values)
            l = (w * torch.stack(ls)).sum(0)
            acc = (w[:, :, None] * torch.stack(accs)).sum(0)
            out[b, kv * G:(kv + 1) * G] = acc / torch.clamp(l, min=1e-20)[:, None]
    return out.to(q.dtype)


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


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "B{}N{}K{}hd{}p{}m{}".format(*c[0]) +
                         f"-w{c[2]}-part{c[3]}")
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_split_over_partitions_matches_reference_kernel(reference, case, q_dtype):
    """The partition-and-combine algebra of the CUDA kernel, rehearsed on the
    CPU, against the Pallas kernel at the reference's tolerances."""
    jnp, ml_dtypes, jax_paged_attention = reference
    shape, lengths, window, partition = case
    q, kp, vp, table, lens = make_split_inputs(*shape, lengths, seed=len(lengths) + window % 89)
    if q_dtype == "bfloat16":
        q = q.astype(ml_dtypes.bfloat16)
    scale = shape[3] ** -0.5
    ref = jax_paged_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(table), jnp.asarray(lens), jnp.int32(window),
                              scale=scale, interpret=True)
    out = split_paged_attention(_torch(q), _torch(kp), _torch(vp), _torch(table),
                                _torch(lens), window, scale=scale, partition=partition)
    tol = 2e-5 if q_dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np32(out), np.asarray(ref, np.float32), atol=tol, rtol=tol)


def test_partitions_come_from_the_table_width():
    """The serving path (contexts of at most 40 tokens, page 8) takes one
    partition, so the combine does not launch; the long shape takes 64."""
    assert kernel_mod.PARTITION_TOKENS == 64
    assert kernel_mod.num_partitions(5, 8) == 1
    assert kernel_mod.num_partitions(8, 8) == 1
    assert kernel_mod.num_partitions(9, 8) == 2
    assert kernel_mod.num_partitions(512, 8) == 64
    assert kernel_mod.num_partitions(2, 32) == 1


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


# The CUDA kernel's own edges: lengths about its partition (64 tokens),
# windows that cut a page and a partition, and a batch 100x apart.
CUDA_SPLIT_CASES = [
    ((7, 4, 1, 256, 8, 40), [1, 63, 64, 65, 127, 128, 129], 1 << 30),
    ((7, 4, 1, 256, 8, 40), [1, 63, 64, 65, 127, 128, 129], 100),
    ((4, 8, 2, 64, 16, 24), [1, 200, 300, 384], 130),
    ((2, 4, 1, 256, 8, 512), [40, 4000], 1 << 30),
    ((2, 8, 1, 128, 32, 128), [40, 4000], 512),
    ((3, 8, 8, 32, 8, 64), [5, 300, 500], 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_SPLIT_CASES,
                         ids=lambda c: "B{}N{}K{}hd{}p{}m{}".format(*c[0]) + f"-w{c[2]}")
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_at_partition_edges(case, q_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape, lengths, window = case
    q, kp, vp, table, lens = (_torch(a).cuda() for a in
                              make_split_inputs(*shape, lengths, seed=len(lengths)))
    if q_dtype == "bfloat16":
        q = q.to(torch.bfloat16)
    scale = shape[3] ** -0.5
    out = paged_attention(q, kp, vp, table, lens, window, scale=scale)
    ref = paged_attention_ref(q, kp, vp, table, lens, window, scale=scale)
    tol = 2e-5 if q_dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


# Group sizes that are no power of two and past 8, and head dims 80 and 192:
# deepseek-coder-33b (G 7, hd 128), internvl2-1b (G 7, hd 64), nemotron-4-340b
# (G 12, hd 192), hubert-xlarge (G 1, hd 80), with one and several partitions.
WIDE_CASES = [((2, 3 * K, K, hd, 8, 20), [37, 150], w)
              for K, hd in ((1, 64), (2, 128)) for w in (1 << 30, 50)] + [
    ((2, G * 2, 2, hd, 16, 12), [40, 190], 1 << 30)
    for G in (3, 5, 6, 7, 12, 16) for hd in (64, 128)] + [
    ((2, 7 * 2, 2, 64, 8, 5), [24, 40], 1 << 30),
    ((2, 12 * 8, 8, 192, 8, 5), [24, 40], 1 << 30),
    ((3, 12 * 2, 2, 192, 16, 20), [1, 64, 300], 100),
    ((2, 16, 1, 192, 8, 40), [65, 320], 1 << 30),
    ((2, 16, 16, 80, 8, 5), [24, 40], 1 << 30),
    ((3, 4, 1, 80, 8, 40), [1, 64, 300], 1 << 30),
    ((2, 16 * 2, 2, 80, 8, 20), [30, 150], 24),
    ((2, 16, 1, 32, 8, 20), [30, 150], 1 << 30),
    ((2, 16, 1, 256, 8, 20), [30, 150], 1 << 30),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_CASES,
                         ids=lambda c: "B{}N{}K{}hd{}p{}m{}".format(*c[0]) + f"-w{c[2]}")
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_at_every_group_and_head_dim(case, q_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape, lengths, window = case
    q, kp, vp, table, lens = (_torch(a).cuda() for a in
                              make_split_inputs(*shape, lengths, seed=sum(lengths)))
    if q_dtype == "bfloat16":
        q = q.to(torch.bfloat16)
    scale = shape[3] ** -0.5
    out = paged_attention(q, kp, vp, table, lens, window, scale=scale)
    ref = paged_attention_ref(q, kp, vp, table, lens, window, scale=scale)
    tol = 2e-5 if q_dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
