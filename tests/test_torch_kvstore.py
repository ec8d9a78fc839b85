"""The KV-store middleware and the offload manifest in both packages.

tests/test_middleware.py's KVStore cases and tests/test_api_v2.py's policy
injection and ``stage_manifest`` cases replayed through ``repro`` and
``repro_torch`` (on the CPU): what each returns, the modeled statistics and
every key's tier compare with ``==``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.core.api as r_api
import repro.core.emucxl as r_ecxl
import repro.core.kvstore as r_kvstore
import repro.core.offload as r_offload
import repro.core.policy as r_policy
import repro_torch.core.api as t_api
import repro_torch.core.emucxl as t_ecxl
import repro_torch.core.kvstore as t_kvstore
import repro_torch.core.offload as t_offload
import repro_torch.core.policy as t_policy

REF = types.SimpleNamespace(api=r_api, ecxl=r_ecxl, kv=r_kvstore, offload=r_offload,
                            policy=r_policy, kw={})
PORT = types.SimpleNamespace(api=t_api, ecxl=t_ecxl, kv=t_kvstore, offload=t_offload,
                             policy=t_policy, kw={"device": "cpu"})


def _lib(P, local=1 << 22, remote=1 << 24):
    lib = P.ecxl.EmuCXL()
    lib.init(local_capacity=local, remote_capacity=remote, **P.kw)
    return lib


def _model(lib, kv, keys):
    """What a caller can observe: hit statistics, every key's tier, tier
    usage and the modeled tier times."""
    return {"stats": dataclasses.asdict(kv.stats), "tiers": {k: kv.tier_of(k) for k in keys},
            "local": kv.local_count(), "remote": kv.remote_count(), "len": len(kv),
            "used": (lib.stats(0), lib.stats(1)), "modeled_time": dict(lib.modeled_time)}


def _put_get_delete(P):
    """tests/test_middleware.py:48."""
    lib = _lib(P)
    kv = P.kv.KVStore(lib=lib, local_capacity_objects=2)
    kv.put("x", b"1")
    kv.put("y", b"2")
    kv.put("z", b"3")
    seen = [kv.tier_of("x"), kv.get("y"), kv.get("x"), kv.tier_of("x"),
            kv.delete("z"), kv.delete("z"), kv.get("missing")]
    out = {"seen": seen, **_model(lib, kv, ["x", "y", "z"])}
    lib.exit()
    return out


def _policy2_never_moves(P):
    """tests/test_middleware.py:63."""
    lib = _lib(P)
    kv = P.kv.KVStore(lib=lib, local_capacity_objects=1, policy=P.policy.Policy2())
    kv.put("a", b"a")
    kv.put("b", b"b")
    seen = [kv.get("a") for _ in range(5)]
    out = {"seen": seen, **_model(lib, kv, ["a", "b"])}
    lib.exit()
    return out


def _policy_experiment(P, policy_name, hot_frac, n_objects=200, local_cap=60,
                       n_gets=3000, seed=0):
    """tests/test_middleware.py:78's scaled-down paper §IV-B experiment."""
    lib = _lib(P)
    kv = P.kv.KVStore(lib=lib, local_capacity_objects=local_cap,
                      policy=getattr(P.policy, policy_name)())
    keys = [f"k{i}" for i in range(n_objects)]
    for i, k in enumerate(keys):
        kv.put(k, f"v{i}".encode())
    g = np.random.default_rng(seed)
    hot = max(int(hot_frac * n_objects), 1)
    values = []
    for _ in range(n_gets):
        i = int(g.integers(0, hot)) if g.random() < 0.9 else int(g.integers(0, n_objects))
        values.append(kv.get(f"k{i}"))
    out = {"percent_local": kv.stats.percent_local, "values": values,
           **_model(lib, kv, keys)}
    lib.exit()
    return out


def _policy_injected(P):
    """tests/test_api_v2.py:141."""
    with P.api.CXLSession(1 << 22, 1 << 24, promotion=P.policy.Policy2(), **P.kw) as sess:
        kv = P.kv.KVStore(sess, local_capacity_objects=1)
        kv.put("a", b"a")
        kv.put("b", b"b")
        seen = [kv.get("a") for _ in range(3)]
        return {"seen": seen, **_model(sess.lib, kv, ["a", "b"])}


def _stage_manifest(P):
    """tests/test_api_v2.py:422."""
    man = P.offload.OffloadManifest()
    man.entries.append(P.offload.OffloadEntry("moments", 4096, "resident"))
    man.entries.append(P.offload.OffloadEntry("master", 2048, "oneway"))
    with P.api.CXLSession(1 << 22, 1 << 24, **P.kw) as sess:
        staged = man.stage(sess)
        return {"names": sorted(staged), "local": {k: b.is_local for k, b in staged.items()},
                "sizes": {k: b.size for k, b in staged.items()},
                "pool": sess.pool_stats(), "remote": sess.stats(1),
                "dma": man.dma_bytes_per_step(), "summary": man.summary(),
                "modeled_time": dict(sess.modeled_time)}


def test_kvstore_put_get_delete_matches_reference():
    ref, port = _put_get_delete(REF), _put_get_delete(PORT)
    assert port == ref
    assert port["seen"] == [t_ecxl.REMOTE_MEMORY, b"2", b"1", t_ecxl.LOCAL_MEMORY,
                            True, False, None]
    assert port["stats"] == {"local_hits": 1, "remote_hits": 1, "misses": 1}


def test_kvstore_policy2_matches_reference():
    ref, port = _policy2_never_moves(REF), _policy2_never_moves(PORT)
    assert port == ref
    assert port["tiers"]["a"] == t_ecxl.REMOTE_MEMORY and port["seen"] == [b"a"] * 5


@pytest.mark.parametrize("policy_name", ["Policy1", "Policy2"])
@pytest.mark.parametrize("hot_frac", [0.1, 0.9])
def test_policy_experiment_matches_reference(policy_name, hot_frac):
    ref = _policy_experiment(REF, policy_name, hot_frac)
    port = _policy_experiment(PORT, policy_name, hot_frac)
    assert port == ref


def test_promotion_policy_injection_matches_reference():
    ref, port = _policy_injected(REF), _policy_injected(PORT)
    assert port == ref
    assert port["tiers"]["a"] == t_ecxl.REMOTE_MEMORY


def test_stage_manifest_matches_reference():
    ref, port = _stage_manifest(REF), _stage_manifest(PORT)
    assert port == ref
    assert port["pool"]["used"] == 4096 + 2048
    assert not any(port["local"].values())


def test_manifest_counts_tensor_trees():
    """add_tree counts a tree's bytes as the reference's does for arrays."""
    tree = {"a": np.zeros((3, 5), np.float32), "b": [np.zeros(7, np.int8)]}
    ref, port = r_offload.OffloadManifest(), t_offload.OffloadManifest()
    ref.add_tree("state", tree)
    port.add_tree("state", {"a": torch.zeros((3, 5)), "b": [torch.zeros(7, dtype=torch.int8)]})
    port.add_tree("empty", {})
    assert port.summary() == ref.summary() == {"state": 67}
    assert port.dma_bytes_per_step() == ref.dma_bytes_per_step() == 134


def test_memory_kinds_on_the_cpu():
    """A CPU run has one memory space: host placement is ordinary host memory,
    reported as the emulator reports it (ROADMAP C.6)."""
    assert not t_offload.backend_supports_memory_spaces("cpu")
    assert t_offload.resolve_memory_kind(t_offload.HOST, "cpu") == "unpinned_host"
    assert t_offload.resolve_memory_kind(t_offload.DEVICE, "cpu") == "device"
    lib = _lib(PORT)
    assert lib.memory_kind(t_ecxl.REMOTE_MEMORY) == "unpinned_host"
    lib.exit()
    t = t_offload.to_tier(torch.arange(4.0), t_offload.HOST, "cpu")
    assert t.device.type == "cpu" and not t.is_pinned()
