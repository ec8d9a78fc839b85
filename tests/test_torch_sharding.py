"""The port's logical sharding rules and specs against the reference's.

The rule logic is pure Python in both packages, so its answers compare with
``==``: every rule set, every leaf of ``param_axes``/``decode_state_axes``/
``prefill_cache_axes`` of every arch at the reference's shapes, on the
production meshes and on (2, 4), the cases of tests/test_sharding.py, and
the cell plans of ``launch/dryrun.py``. Per-device bytes come from the
port's placement on a fake 256-rank group (a subprocess: the group is
process-global) and from the reference's specs.
"""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
from torch.distributed.tensor import Replicate, Shard

import repro.configs as r_configs
import repro.launch.dryrun as r_dryrun
import repro.launch.specs as r_sp
import repro.models.transformer as r_tf
from repro.distributed.sharding import RULE_SETS as R_RULE_SETS
from repro.distributed.sharding import logical_to_spec as r_spec
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed.sharding import RULE_SETS, logical_to_spec, spec_to_placements
from repro_torch.launch import dryrun, specs as sp
from repro_torch.models import transformer as tf
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parent.parent


class FakeMesh:
    """Duck-typed mesh: axis_names + shape dict (tests/test_sharding.py:15)."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh(data=16, model=16)
MESH3 = FakeMesh(pod=2, data=16, model=16)
MESHES = {"16x16": MESH, "2x16x16": MESH3, "2x4": FakeMesh(data=2, model=4)}


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def test_rule_sets_equal_the_reference():
    assert RULE_SETS == R_RULE_SETS


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    """The reference's param and decode-state shapes (eval_shape only)."""
    cfg = r_configs.get_config(arch)
    params = r_sp.params_specs(cfg)
    state = {ring: r_sp.decode_state_specs(cfg, r_configs.SHAPES["decode_32k"],
                                           sliding_ring=ring) for ring in (False, True)}
    return params, state


def _pairs(axes_tree, shapes_tree):
    """(axes, shape) for every leaf of an axes tree over a shapes tree."""
    axes = leaves(axes_tree, is_leaf=_is_axes)
    shapes = [tuple(s.shape) for s in jax.tree.leaves(shapes_tree)]
    assert len(axes) == len(shapes)
    return list(zip(axes, shapes))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_resolves_as_the_reference(arch, mesh):
    cfg_t, cfg_r = get_config(arch), r_configs.get_config(arch)
    assert tf.param_axes(cfg_t) == r_tf.param_axes(cfg_r)
    assert tf.prefill_cache_axes(cfg_t) == r_tf.prefill_cache_axes(cfg_r)
    params, states = _ref_shapes(arch)
    pairs = _pairs(tf.param_axes(cfg_t), params)
    for ring, state in states.items():
        assert tf.decode_state_axes(cfg_t, ring) == r_tf.decode_state_axes(cfg_r, ring)
        pairs += _pairs(tf.decode_state_axes(cfg_t, ring), state)
    # prefill caches share the decode state's layouts, key for key
    cache_ax = tf.prefill_cache_axes(cfg_t)
    pairs += _pairs(cache_ax, {k: states[False][k] for k in cache_ax})
    m = MESHES[mesh]
    for rules in RULE_SETS:
        for axes, shape in pairs:
            want = tuple(r_spec(axes, R_RULE_SETS[rules], m, shape))
            assert tuple(logical_to_spec(axes, RULE_SETS[rules], m, shape)) == want
            assert tuple(logical_to_spec(axes, RULE_SETS[rules], m)) == \
                tuple(r_spec(axes, R_RULE_SETS[rules], m))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_have_the_reference_shapes(arch):
    cfg_t = get_config(arch)
    params, states = _ref_shapes(arch)
    ours = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in leaves(sp.params_specs(cfg_t))]
    assert ours == [(tuple(s.shape), s.dtype.name) for s in jax.tree.leaves(params)]
    assert all(t.is_meta for t in leaves(sp.params_specs(cfg_t)))
    for ring, state in states.items():
        got = sp.decode_state_specs(cfg_t, SHAPES["decode_32k"], sliding_ring=ring)
        assert [tuple(t.shape) for t in leaves(got)] == \
            [tuple(s.shape) for s in jax.tree.leaves(state)]


# tests/test_sharding.py:31-87: (logical, rules, mesh, shape, expected)
CASES = [
    (("batch", "seq", "embed"), "train_fsdp", "16x16", None, ("data",)),
    (("layers", "fsdp", "heads", None), "train_fsdp", "16x16", (16, 1024, 32, 128),
     (None, "data", "model")),
    (("batch",), "train_fsdp", "16x16", None, ("data",)),
    (("batch",), "train_fsdp", "2x16x16", (256,), (("pod", "data"),)),
    (("layers", "fsdp", "kv_heads", None), "train_fsdp", "16x16", (60, 1024, 8, 128),
     (None, "data")),
    (("batch", None, "heads", None), "train_fsdp", "16x16", (16, 4096, 56, 128), ("data",)),
    (("batch", "seq_attn", "heads", None), "train_fsdp", "16x16", (16, 4096, 32, 128),
     ("data", None, "model")),
    (("batch", "seq_attn", "heads", None), "train_fsdp", "16x16", (16, 4096, 56, 128),
     ("data", "model")),
    (("layers", "batch", "cache_seq", "kv_heads", "head_dim"), "serve_tp", "16x16",
     (16, 128, 32768, 16, 64), (None, "data", None, "model")),
    (("layers", "batch", "cache_seq", "kv_heads", "head_dim"), "serve_tp", "16x16",
     (60, 128, 32768, 8, 128), (None, "data", "model")),
    (("batch", "fsdp", "heads"), "train_fsdp", "16x16", (256, 4096, 16), None),
    (("fsdp", None), "train_zero1", "2x16x16", (1024, 64), (("pod", "data", "model"),)),
]


@pytest.mark.parametrize("logical,rules,mesh,shape,want", CASES)
def test_reference_sharding_cases(logical, rules, mesh, shape, want):
    m = MESHES[mesh]
    got = tuple(logical_to_spec(logical, RULE_SETS[rules], m, shape))
    assert got == tuple(r_spec(logical, R_RULE_SETS[rules], m, shape))
    if want is not None:
        assert got == want
    flat = [a for e in got for a in ((e,) if isinstance(e, str) else (e or ()))]
    assert len(flat) == len(set(flat))         # no mesh axis used twice


def test_placements_follow_the_spec():
    assert spec_to_placements(("data", None, "model"), MESH, 3) == [Shard(0), Shard(2)]
    assert spec_to_placements((("pod", "data"),), MESH3, 2) == \
        [Shard(0), Shard(0), Replicate()]
    assert spec_to_placements((), MESH, 2) == [Replicate(), Replicate()]
    # DTensor splits in mesh order; a joint entry in another order would not
    # lay the tensor out as JAX does
    with pytest.raises(ValueError, match="mesh's axis order"):
        spec_to_placements((("data", "pod"),), MESH3, 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_plans_equal_the_reference(arch):
    """rules_for, opt_rules_for, default_hp, default_train_plan and
    default_options for every shape of `arch`."""
    cfg_t, cfg_r = get_config(arch), r_configs.get_config(arch)
    assert sp.is_small_arch(cfg_t) == r_sp.is_small_arch(cfg_r)
    assert dataclasses.asdict(dryrun.default_hp(cfg_t)) == \
        dataclasses.asdict(r_dryrun.default_hp(cfg_r))
    for name in SHAPES:
        shp_t, shp_r = SHAPES[name], r_configs.SHAPES[name]
        rules = sp.rules_for(cfg_t, shp_t)
        assert rules == r_sp.rules_for(cfg_r, shp_r)
        assert sp.opt_rules_for(rules) == r_sp.opt_rules_for(rules)
        for multi_pod in (False, True):
            assert dryrun.default_train_plan(cfg_t, shp_t, multi_pod) == \
                r_dryrun.default_train_plan(cfg_r, shp_r, multi_pod)
        for unroll in (False, True):
            assert dataclasses.asdict(dryrun.default_options(cfg_t, shp_t, unroll)) == \
                dataclasses.asdict(r_dryrun.default_options(cfg_r, shp_r, unroll))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_offload_manifest_equals_the_reference(arch):
    """tests/test_elastic_launch.py:66 for every arch."""
    cfg_t, cfg_r = get_config(arch), r_configs.get_config(arch)
    man_t = sp.offload_manifest(cfg_t, dryrun.default_hp(cfg_t))
    man_r = r_sp.offload_manifest(cfg_r, r_dryrun.default_hp(cfg_r))
    assert man_t.resident_bytes == man_r.resident_bytes
    assert man_t.dma_bytes_per_step() == man_r.dma_bytes_per_step()
    if dryrun.default_hp(cfg_t).offload_state:
        assert abs(man_t.resident_bytes - 12 * cfg_t.param_count()) < \
            0.01 * 12 * cfg_t.param_count()


# ------------------------------------------------------------------ per-device bytes
BYTES_ARCHS = ["gemma3-1b", "olmoe-1b-7b", "kimi-k2-1t-a32b", "nemotron-4-340b",
               "zamba2-1.2b", "rwkv6-3b"]


def _reckoned(tree_axes, shapes, rules):
    """Per-device bytes of a tree from the reference's specs on 16x16."""
    total = 0
    for (axes, shape), s in zip(_pairs(tree_axes, shapes), jax.tree.leaves(shapes)):
        spec = r_spec(axes, R_RULE_SETS[rules], MESH, shape)
        split = math.prod(MESH.shape[a] for e in spec if e
                          for a in ((e,) if isinstance(e, str) else e))
        total += math.prod(shape) // split * s.dtype.itemsize
    return total


@pytest.fixture(scope="module")
def placed_bytes(tmp_path_factory):
    out = tmp_path_factory.mktemp("bytes")
    (out / "bytes_in.json").write_text(json.dumps(BYTES_ARCHS))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_mesh_runs.py"),
                           "bytes", str(out)], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    return json.loads((out / "bytes.json").read_text())


@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_per_device_bytes_equal_the_reference_specs(placed_bytes, arch):
    """The local shards the port places on a fake 256-rank 16x16 mesh hold
    the bytes the reference's specs give each device: parameters under the
    arch's train rules, AdamW state under its optimizer rules."""
    cfg = r_configs.get_config(arch)
    rules = r_sp.rules_for(cfg, r_configs.SHAPES["train_4k"])
    hp = r_dryrun.default_hp(cfg)
    pax = r_tf.param_axes(cfg)
    got = placed_bytes[arch]
    assert got["rules"] == rules
    assert got["params"] == _reckoned(pax, r_sp.params_specs(cfg), rules)
    o = r_sp.opt_state_specs(cfg, hp)
    orules = r_sp.opt_rules_for(rules)
    want = 4 + sum(_reckoned(pax, o[k], orules) for k in ("m", "v", "master"))
    assert got["opt"] == want


# ------------------------------------------------------------------ memory tiers of sharding trees
def _sharding_trees(device_type):
    """The same nested tree of shardings in both packages: dicts, a list, a
    tuple and an empty (None) subtree."""
    from jax.sharding import NamedSharding as RNamedSharding
    from jax.sharding import PartitionSpec as RP

    from repro_torch.distributed.sharding import NamedSharding, P

    specs = {"embed": ("data", None), "stack": {"wq": [(None, "model"), ()],
                                                "norm": ((),)}, "none": None}
    mesh_r = jax.make_mesh((1, 1), ("data", "model"))
    mesh_t = FakeMesh(data=1, model=1)
    mesh_t.device_type = device_type

    def build(tree, leaf):
        if isinstance(tree, dict):
            return {k: build(v, leaf) for k, v in tree.items()}
        if isinstance(tree, list) or (isinstance(tree, tuple) and tree and
                                      isinstance(tree[0], tuple)):
            return type(tree)(build(v, leaf) for v in tree)
        return None if tree is None else leaf(tree)

    ref = build(specs, lambda s: RNamedSharding(mesh_r, RP(*s)))
    port = build(specs, lambda s: NamedSharding(mesh_t, P(*s)))
    return ref, port


def _kinds_and_specs(ref, port):
    ref_leaves = jax.tree.leaves(ref)
    port_leaves = [x for x in leaves(port) if x is not None]
    assert len(ref_leaves) == len(port_leaves) == 4
    for r, t in zip(ref_leaves, port_leaves, strict=True):
        assert tuple(r.spec) == tuple(t.spec)
    return ([r.memory_kind for r in ref_leaves], [t.memory_kind for t in port_leaves])


@pytest.mark.parametrize("tier", ["host", "device"])
def test_sharding_tree_tiers_equal_the_reference(monkeypatch, tier):
    """On a backend with memory spaces (both packages' answer patched so on
    the CPU), every leaf's memory kind `==` the reference's; the layout and
    the empty subtree are kept."""
    import repro.core.offload as r_off
    from repro_torch.core import offload as t_off

    monkeypatch.setattr(r_off, "backend_supports_memory_spaces", lambda: True)
    monkeypatch.setattr(t_off, "backend_supports_memory_spaces", lambda device="cuda": True)
    ref, port = _sharding_trees("cuda")
    fn = f"{tier}_sharding_tree"
    new_ref, new_port = getattr(r_off, fn)(ref), getattr(t_off, fn)(port)
    assert new_port["none"] is None and new_ref["none"] is None
    kinds_r, kinds_t = _kinds_and_specs(new_ref, new_port)
    assert kinds_t == kinds_r == [{"host": "pinned_host", "device": "device"}[tier]] * 4
    one = t_off.with_memory_kind(port["embed"], t_off.HOST)
    assert one == dataclasses.replace(port["embed"], memory_kind="pinned_host")
    assert port["embed"].memory_kind is None          # the input is not changed


def test_sharding_tree_tiers_on_the_cpu():
    """As the CPU backends answer: the device tier `==` the reference's; the
    host tier is the reference's "device" (XLA's CPU backend places nothing
    inside a computation) and the port's "unpinned_host" (ROADMAP C.6)."""
    import repro.core.offload as r_off
    from repro_torch.core import offload as t_off

    ref, port = _sharding_trees("cpu")
    kinds_r, kinds_t = _kinds_and_specs(r_off.device_sharding_tree(ref),
                                        t_off.device_sharding_tree(port))
    assert kinds_t == kinds_r == ["device"] * 4
    kinds_r, kinds_t = _kinds_and_specs(r_off.host_sharding_tree(ref),
                                        t_off.host_sharding_tree(port))
    assert kinds_r == ["device"] * 4 and kinds_t == ["unpinned_host"] * 4
