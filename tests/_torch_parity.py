"""Shared set-up for the serving parity tests (tests/test_torch_serving*.py).

One reduced parameter tree (gemma3-1b unless a scenario names another arch),
drawn by the reference's ``init_params``, runs in both packages: as it is in ``repro`` and, converted through numpy with
``repro_torch.interop.from_reference``, on the CPU in ``repro_torch``. The
engine scenarios mirror tests/test_serving.py and return what a caller sees:
the generated token ids, ``tier_stats()`` and the modeled tier times.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as r_configs
import repro.core.api as r_api
import repro.core.emucxl as r_emucxl
import repro.core.fabric as r_fabric
import repro.core.policy as r_policy
import repro.models.transformer as r_tf
import repro.serving.engine as r_engine
import repro.serving.kv_manager as r_kv
import repro_torch.configs as t_configs
import repro_torch.core.api as t_api
import repro_torch.core.emucxl as t_emucxl
import repro_torch.core.fabric as t_fabric
import repro_torch.core.policy as t_policy
import repro_torch.serving.engine as t_engine
import repro_torch.serving.kv_manager as t_kv
from repro_torch.interop import from_reference

REF = types.SimpleNamespace(api=r_api, ecxl=r_emucxl, fabric=r_fabric, policy=r_policy,
                            engine=r_engine, kv=r_kv, lib_kw={}, dev_kw={},
                            asarray=jnp.asarray)
PORT = types.SimpleNamespace(api=t_api, ecxl=t_emucxl, fabric=t_fabric, policy=t_policy,
                             engine=t_engine, kv=t_kv, lib_kw={"device": "cpu"},
                             dev_kw={"device": "cpu"}, asarray=torch.from_numpy)


def models(arch="gemma3-1b"):
    """(reference cfg, reference params, port cfg, port params) of reduced `arch`."""
    cfg_r = r_configs.get_config(arch).reduced()
    params_r = r_tf.init_params(jax.random.PRNGKey(0), cfg_r)
    cfg_t = t_configs.get_config(arch).reduced()
    params_t = from_reference(jax.tree.map(np.asarray, params_r), cfg_t, device="cpu")
    return cfg_r, params_r, cfg_t, params_t


def _v1_engine_run(P, params, cfg, *, max_batch, policy, seed, max_new):
    """tests/test_serving.py:82 and :151: 4 hot slots, 3 requests of 2 pages."""
    lib = P.ecxl.EmuCXL()
    lib.init(local_capacity=1 << 26, remote_capacity=1 << 28, **P.lib_kw)
    eng = P.engine.ServingEngine(params, cfg, num_slots=4, page_size=8, max_batch=max_batch,
                                 max_pages_per_seq=2, policy=policy, **P.dev_kw)
    eng.pool.lib = lib
    eng.pool.slab.lib = lib
    rng = np.random.default_rng(seed)
    for _ in range(3):
        eng.submit(list(rng.integers(0, cfg.vocab_size, 5)), max_new_tokens=max_new)
    out = eng.run(max_steps=200)
    result = {"tokens": out, "tier_stats": eng.tier_stats(),
              "modeled_time": dict(lib.modeled_time)}
    lib.exit()
    return result


def preemption_run(P, params, cfg):
    return _v1_engine_run(P, params, cfg, max_batch=2, policy=P.policy.Policy1(), seed=5,
                          max_new=6)


def policy_run(P, params, cfg, policy_name):
    policy = getattr(P.policy, policy_name)()
    return _v1_engine_run(P, params, cfg, max_batch=1, policy=policy, seed=7, max_new=5)


def shared_prefix_run(P, params, cfg):
    """tests/test_serving.py:101: two hosts' engines import one coherent prefix."""
    page = 8
    result = {}
    with P.api.CXLSession(1 << 26, 1 << 28, num_hosts=2,
                          fabric=P.fabric.Fabric(num_hosts=2, pool_ports=1),
                          **P.lib_kw) as sess:
        shared = P.kv.SharedPrefixKV(
            sess, num_layers=cfg.num_layers, num_pages=1, page_size=page,
            kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim, home_host=0)
        engines = [
            P.engine.ServingEngine(params, cfg, num_slots=6, page_size=page, max_batch=1,
                                   max_pages_per_seq=3, policy=P.policy.Policy1(), host=h,
                                   session=sess, shared_prefix=shared, **P.dev_kw)
            for h in range(2)
        ]
        rng = np.random.default_rng(3)
        prefix = list(rng.integers(0, cfg.vocab_size, page))
        pub_pool = engines[0].pool
        pub_pool.alloc_page(99, 0)
        shared.publish(pub_pool, seq_id=99, token_ids=prefix)
        pub_pool.free_sequence(99)
        for h, eng in enumerate(engines):
            eng.submit(prefix + list(rng.integers(0, cfg.vocab_size, 3)), max_new_tokens=4)
            result[f"tokens{h}"] = eng.run(max_steps=50)
        other = [(t + 1) % cfg.vocab_size for t in prefix]
        engines[1].submit([*other, 1, 2], max_new_tokens=2)
        result["tokens_other"] = engines[1].run(max_steps=50)
        result["tier_stats"] = [e.tier_stats() for e in engines]
        result["positions"] = [r.position for e in engines for r in e.requests.values()]
        result["coherence"] = sess.coherence_stats()["total"]
        result["fabric_stats"] = sess.fabric_stats()
        result["modeled_time"] = dict(sess.modeled_time)
    return result
