"""Parity of the port's emucxl core with the reference.

Each program drives one package's public surface (v1 library, v2 session,
async queue, coherent segments, topologies, the v1 facade) and returns what it
observed plus the session's modeled state. The same program runs through
``repro`` and ``repro_torch`` (on the CPU) and the two results must agree
exactly: modeled statistics with ``==``, bytes with ``array_equal``.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.api as r_api  # noqa: E402
import repro.core.emucxl as r_emucxl  # noqa: E402
import repro.core.fabric as r_fabric  # noqa: E402
import repro.core.policy as r_policy  # noqa: E402
import repro.core.queue as r_queue  # noqa: E402
import repro.core.topology as r_topology  # noqa: E402
import repro_torch.core.api as t_api  # noqa: E402
import repro_torch.core.emucxl as t_emucxl  # noqa: E402
import repro_torch.core.fabric as t_fabric  # noqa: E402
import repro_torch.core.policy as t_policy  # noqa: E402
import repro_torch.core.queue as t_queue  # noqa: E402
import repro_torch.core.topology as t_topology  # noqa: E402

REF = types.SimpleNamespace(api=r_api, ecxl=r_emucxl, fabric=r_fabric, policy=r_policy,
                            queue=r_queue, topology=r_topology, kw={})
PORT = types.SimpleNamespace(api=t_api, ecxl=t_emucxl, fabric=t_fabric, policy=t_policy,
                             queue=t_queue, topology=t_topology, kw={"device": "cpu"})
LOCAL, REMOTE = 0, 1


def _payload(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def snapshot(sess):
    hosts = [None, *range(sess.num_hosts)]
    return {
        "stats": {(n, h): sess.stats(n, h) for n in (LOCAL, REMOTE) for h in hosts},
        "pool_stats": sess.pool_stats(),
        "fabric_stats": sess.fabric_stats(),
        "modeled_time": dict(sess.modeled_time),
        "coherence_stats": sess.coherence_stats(),
        "fabric_clock": None if sess.fabric is None else sess.fabric.clock,
    }


def assert_same(a, b, path="result"):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


# --------------------------------------------------------------------- programs
def prog_v1_library(P):
    """test_emucxl_api.py: tiers, read/write, migrate, resize, memset/memcpy."""
    lib = P.ecxl.EmuCXL()
    lib.init(local_capacity=1 << 20, remote_capacity=1 << 22, **P.kw)
    obs = []
    a = lib.alloc(4096, LOCAL)
    b = lib.alloc(8192, REMOTE)
    lib.write(_payload(4096, 1), 0, a)
    obs.append(lib.read(a, 100, 64))
    a = lib.migrate(a, REMOTE)
    obs += [lib.read(a, 0, 4096), lib.stats(LOCAL), lib.stats(REMOTE)]
    a = lib.resize(a, 6000)
    obs.append(lib.read(a, 0, 6000))
    lib.memset(b, 0xAB, 1000)
    lib.memcpy(b, a, 3000)
    lib.memmove(a, b, 10)
    obs += [lib.read(b, 0, 4096), lib.read(a, 0, 32)]
    c = lib.alloc_array((8, 4), np.float32, LOCAL)
    lib.write_array(np.arange(32, dtype=np.float32).reshape(8, 4), c)
    obs.append(lib.read_array(c, (8, 4), np.float32))
    lib.free(c)
    obs += [dict(lib.modeled_time), lib.stats(LOCAL), lib.stats(REMOTE)]
    lib.exit()
    return obs


def prog_fabric_session(P):
    """test_api_v2.py: two hosts on a two-port fabric with quotas; cross-host
    memcpy, remote memset, resize through the fabric, migrate_batch."""
    fab = P.fabric.Fabric(num_hosts=2, pool_ports=2)
    with P.api.CXLSession(1 << 20, 1 << 22, num_hosts=2, fabric=fab, host_quota=1 << 21,
                          placement=P.policy.CongestionAwarePlacement(), **P.kw) as sess:
        obs = []
        src = sess.alloc(4096, LOCAL, host=0)
        dst = sess.alloc(4096, LOCAL, host=1)
        src.write(_payload(4096, 2))
        sess.memcpy(dst, src, 4096)
        obs.append(dst.read(0, 4096))
        rem = sess.alloc(8192, REMOTE, host=1)
        sess.memset(rem, 7, 5000)
        rem = rem.resize(12000)
        obs.append(rem.read(0, 12000))
        bufs = [sess.alloc(4096, LOCAL, host=h % 2) for h in range(4)]
        for i, buf in enumerate(bufs):
            buf.write(_payload(4096, 10 + i))
        obs.append(sess.migrate_batch([(buf, REMOTE) for buf in bufs]))
        obs += [buf.read(0, 4096) for buf in bufs]
        obs.append([(buf.node, buf.host) for buf in bufs])
        obs.append(snapshot(sess))
    return obs


def prog_async_batch(P):
    """test_api_v2.py: one overlapped batch of every op kind, then a batch that
    fails mid-way on a quota and rolls back."""
    q = P.queue
    fab = P.fabric.Fabric(num_hosts=2, pool_ports=1)
    with P.api.CXLSession(1 << 20, 1 << 22, num_hosts=2, fabric=fab,
                          host_quota={0: 6000, 1: 1 << 21}, **P.kw) as sess:
        obs = []
        a = sess.alloc(4096, LOCAL, host=0)
        b = sess.alloc(4096, REMOTE, host=1)
        c = sess.alloc(4096, LOCAL, host=1)
        tickets = sess.submit(q.WriteOp(a, _payload(4096, 3)), q.ReadOp(a, 0, 64),
                              q.MemcpyOp(c, a, 2048), q.MemsetOp(b, 9, 100),
                              q.MigrateOp(c, REMOTE, 1), q.ReadOp(b, 0, 256))
        obs.append(sess.flush())
        for t in tickets:
            v = t.result()
            obs.append((v if isinstance(v, (np.ndarray, bool)) else "buffer", t.modeled_time))
        obs.append(snapshot(sess))
        d = sess.alloc(4096, LOCAL, host=0)
        e = sess.alloc(4096, LOCAL, host=0)
        sess.submit(q.MigrateOp(d, REMOTE), q.MigrateOp(e, REMOTE))
        with pytest.raises(P.ecxl.QuotaExceeded) as err:
            sess.flush()
        obs += [str(err.value), fab.idle(), d.is_local, e.is_local]
        obs.append(snapshot(sess))
    return obs


def prog_coherence_eager(P):
    """test_coherence.py: M/S/I transitions, dirty-read forwards, invalidations."""
    fab = P.fabric.Fabric(num_hosts=3, pool_ports=1)
    with P.api.CXLSession(1 << 22, 1 << 24, num_hosts=3, fabric=fab, **P.kw) as sess:
        seg = sess.share(8192, host=0, page_bytes=4096)
        a, b, c = (sess.attach(seg, host=h) for h in range(3))
        a.write(np.ones(64, np.uint8))
        obs = [b.read(0, 64)]
        c.write(_payload(4096, 4), offset=4096)
        obs += [a.read(4096, 4096), b.read(0, 128), sorted(seg.directory.holders(0).items())]
        a.write(np.full(16, 5, np.uint8), offset=10)
        obs.append(c.read(0, 64))
        obs.append(snapshot(sess))
        b.detach()
        obs.append(snapshot(sess))
    return obs


def prog_coherence_release(P):
    """test_coherence.py / test_acquire.py: write-combined stores published by a
    fence, acquired by a peer; the async FenceOp/AcquireOp pair in one batch."""
    q = P.queue
    fab = P.fabric.Fabric(num_hosts=2, pool_ports=2)
    with P.api.CXLSession(1 << 22, 1 << 24, num_hosts=2, fabric=fab,
                          placement=P.policy.SharingAwarePlacement(), **P.kw) as sess:
        seg = sess.share(16384, host=0, page_bytes=4096, consistency="release",
                         writers=[0], wc_capacity=2)
        w, r = sess.attach(seg, host=0), sess.attach(seg, host=1)
        for p in range(4):                      # overflows wc_capacity: forced drains
            w.write(_payload(128, 20 + p), offset=p * 4096)
        obs = [w.fence(), r.acquire(), r.read(0, 16384)]
        tickets = sess.submit(q.WriteOp(w, _payload(256, 30), 4096), q.FenceOp(w),
                              q.AcquireOp(r), q.ReadOp(r, 4096, 256))
        obs.append(sess.flush())
        obs += [(t.result() if isinstance(t.result(), np.ndarray) else True, t.modeled_time)
                for t in tickets]
        obs.append(snapshot(sess))
        w.detach()
        r.detach()
        sess.destroy(seg)
        obs.append(snapshot(sess))
    return obs


def prog_sync_async_parity(P):
    """test_sync_async_parity.py: the same ops sync on one session and as one
    flushed batch per op on another charge identical modeled time."""
    q = P.queue
    obs = []
    for mode in ("sync", "async"):
        fab = P.fabric.Fabric(num_hosts=2, pool_ports=1)
        with P.api.CXLSession(1 << 22, 1 << 24, num_hosts=2, fabric=fab, **P.kw) as sess:
            loc = sess.alloc(8192, LOCAL, host=0)
            rem = sess.alloc(8192, REMOTE, host=1)
            data = _payload(8192, 5)
            if mode == "sync":
                loc.write(data)
                rem.write(data, 0, 4096)
                sess.memcpy(rem, loc, 8192)
                sess.memset(loc, 3, 1000)
                got = rem.read(0, 8192)
                loc.migrate(REMOTE, 1)
            else:
                for op in (q.WriteOp(loc, data), q.WriteOp(rem, data, 0, 4096),
                           q.MemcpyOp(rem, loc, 8192), q.MemsetOp(loc, 3, 1000)):
                    sess.submit(op)
                    sess.flush()
                got = sess.submit(q.ReadOp(rem, 0, 8192)).result()
                sess.submit(q.MigrateOp(loc, REMOTE, 1))
                sess.flush()
            obs += [got, loc.read(0, 2000), snapshot(sess)]
    return obs


def prog_spine_leaf(P):
    """test_topology.py: a spine-leaf fabric with a striped directory home."""
    topo = P.topology.spine_leaf(leaves=2, spines=2, hosts_per_leaf=2)
    with P.api.CXLSession(1 << 22, 1 << 24, topology=topo, **P.kw) as sess:
        seg = sess.share(4 * 4096, host=0, page_bytes=4096,
                         home=P.policy.StripedHome())
        maps = [sess.attach(seg, host=h) for h in range(sess.num_hosts)]
        for h, m in enumerate(maps):
            m.write(_payload(512, 40 + h), offset=h * 4096)
        obs = [m.read(0, 4 * 4096) for m in maps]
        bufs = [sess.alloc(65536, LOCAL, host=h) for h in range(sess.num_hosts)]
        obs.append(sess.migrate_batch([(b, REMOTE) for b in bufs]))
        obs.append(snapshot(sess))
    return obs


def prog_v1_facade(P):
    """test_v1_shim.py: the Table II free functions over the default session.

    The default instance lives for the whole process, so earlier users shift
    its addresses and have charged its modeled time. The program observes
    addresses relative to its first allocation, and counts modeled time from
    zero (restoring the earlier total afterwards)."""
    e = P.ecxl
    inst = e.default_instance()
    earlier = dict(inst.modeled_time)
    inst.modeled_time.update(dict.fromkeys(earlier, 0.0))
    e.emucxl_init(1 << 20, 1 << 22, **P.kw)
    try:
        a = e.emucxl_alloc(4096, LOCAL)
        e.emucxl_write(_payload(4096, 6), 0, a)
        b = e.emucxl_migrate(a, REMOTE)
        obs = [b - a, e.emucxl_read(b, 0, 4096), e.emucxl_is_local(b), e.emucxl_stats(REMOTE)]
        with pytest.raises(e.EmuCXLError) as stale:
            e.emucxl_read(a, 0, 4)
        obs.append(str(stale.value).replace(f"{a:#x}", "<a>").replace(f"{b:#x}", "<b>"))
        c = e.emucxl_resize(b, 100)
        e.emucxl_memset(c, 1, 50)
        obs += [c - a, e.emucxl_read(c, 0, 100), dict(inst.modeled_time)]
        e.emucxl_free(c)
        obs.append(e.emucxl_pool_stats())
    finally:
        e.emucxl_exit()
        for node, t in earlier.items():
            inst.modeled_time[node] += t
    return obs


PROGRAMS = [prog_v1_library, prog_fabric_session, prog_async_batch, prog_coherence_eager,
            prog_coherence_release, prog_sync_async_parity, prog_spine_leaf, prog_v1_facade]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda f: f.__name__[5:])
def test_program_parity(program):
    assert_same(program(REF), program(PORT))


# --------------------------------------------------------------- port-only semantics
@pytest.fixture()
def sess():
    with t_api.CXLSession(1 << 20, 1 << 22, num_hosts=2, device="cpu") as s:
        yield s


@pytest.mark.parametrize("node", [LOCAL, REMOTE])
def test_read_returns_a_copy(sess, node):
    buf = sess.alloc(64, node)
    buf.write(np.arange(64, dtype=np.uint8))
    sync = buf.read(0, 64)
    ticket = sess.submit(t_queue.ReadOp(buf, 0, 64))
    sess.flush()
    buf.write(np.zeros(64, np.uint8))           # later write must not reach earlier reads
    expect = np.arange(64, dtype=np.uint8)
    assert np.array_equal(sync, expect) and np.array_equal(ticket.result(), expect)
    sync[:] = 1                                 # nor may the caller's copy reach the store
    assert np.array_equal(buf.read(0, 64), np.zeros(64, np.uint8))


def test_write_copies_its_input(sess):
    buf = sess.alloc(32, REMOTE)
    src = np.arange(32, dtype=np.uint8)
    buf.write(src)
    src[:] = 0
    assert np.array_equal(buf.read(0, 32), np.arange(32, dtype=np.uint8))


def test_attachments_alias_the_one_pooled_copy(sess):
    seg = sess.share(8192, host=0)
    a, b = sess.attach(seg, host=0), sess.attach(seg, host=1)
    allocs = sess.lib.allocations()
    backing = allocs[seg.backing_addr].data
    assert allocs[a.address].data is backing and allocs[b.address].data is backing
    a.write(np.full(100, 7, np.uint8), offset=4000)
    assert np.all(b.read(4000, 100) == 7)
    assert np.all(backing[4000:4100].numpy() == 7)


def test_tiers_report_the_memory_they_use(sess):
    lib = sess.lib
    assert lib.memory_kind(LOCAL) == lib.memory_kind(REMOTE) == "unpinned_host"
    buf = sess.alloc(16, REMOTE)
    data = lib.allocations()[buf.address].data
    assert data.dtype == torch.uint8 and data.device.type == "cpu" and not data.is_pinned()


def test_h100_model_is_offered_beside_v5e():
    """ROADMAP A.12: an H100 hardware model from the card's data sheet. V5E
    stays the default, so a session built without one models the reference's
    times; H100 changes only what it is passed to."""
    import repro.core.hw as r_hw
    import repro_torch.core.hw as t_hw

    assert t_hw.V5E == t_hw.HardwareModel() and \
        dataclasses.asdict(t_hw.V5E) == dataclasses.asdict(r_hw.V5E)
    h = t_hw.H100
    assert (h.hbm_bandwidth, h.peak_flops_bf16, h.hbm_capacity) == (3.35e12, 989e12, 80 * 2**30)
    assert h.host_link_bandwidth == 64e9 and h.ici_link_bandwidth * h.ici_links_per_chip == 450e9
    assert t_emucxl.EmuCXL().hw is t_hw.V5E
    assert t_emucxl.EmuCXL(hw=h).hw is h
    n = 1 << 20
    assert t_hw.V5E.transfer_time(n, 1) == r_hw.V5E.transfer_time(n, 1)
    assert h.transfer_time(n, 0) < t_hw.V5E.transfer_time(n, 0)
    assert h.migrate_time(n) < t_hw.V5E.migrate_time(n)
