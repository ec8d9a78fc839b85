"""Elastic restart in the port: ``replan`` against the reference's, and a
1-process checkpoint restored onto a (2, 4) mesh of 8 gloo processes.

The restore run (``tests/_torch_mesh_runs.py restore``) places every leaf
with ``restore(shardings=...)`` from ``launch/specs.py``'s shardings; each
leaf's ``full_tensor()`` must equal the 1-process restore bitwise, and a save
from the mesh must write the same files byte for byte.
"""

import dataclasses
import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import types

import jax
import pytest

import _torch_mesh_runs as runs
import repro.configs as r_configs
import repro.distributed.sharding as r_sh
import repro.launch.specs as r_specs
from repro.runtime.elastic import replan as r_replan
from repro_torch.configs import SHAPES, get_config
from repro_torch.runtime.elastic import replan
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 300


class FakeMesh:
    """Duck-typed mesh: axis_names + shape dict (tests/test_sharding.py:15)."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _same_plan(port, ref):
    assert (port.old_mesh, port.new_mesh, port.feasible, port.issues,
            port.batch_per_device) == (ref.old_mesh, ref.new_mesh, ref.feasible,
                                       ref.issues, ref.batch_per_device)
    specs_r = [tuple(s.spec) for s in jax.tree.leaves(ref.param_shardings)]
    specs_t = [tuple(s.spec) for s in leaves(port.param_shardings)]
    assert specs_t == specs_r and len(specs_t) > 3


@pytest.fixture
def spec_only_reference(monkeypatch):
    """The reference's replan builds NamedShardings, which need a JAX mesh of
    real devices; on a duck-typed mesh its named_sharding gives the spec
    alone (logical_to_spec reads only the mesh's axes)."""
    def named(logical, mesh=None, rules=None, memory_kind=None, shape=None):
        if isinstance(rules, str):
            rules = r_sh.RULE_SETS[rules]
        return types.SimpleNamespace(spec=r_sh.logical_to_spec(logical, rules, mesh, shape))

    monkeypatch.setattr(r_specs, "named_sharding", named)


# tests/test_elastic_launch.py:14-35's cases, then larger meshes
CASES = [
    ("gemma3-1b", True, "train_4k", None, "train_dp_all", {"data": 1}),
    ("gemma3-1b", True, "train_4k", 7, "train_dp_all", {"data": 1}),
    ("nemotron-4-340b", False, "train_4k", None, "train_fsdp", {"data": 1}),
    ("olmoe-1b-7b", True, "train_4k", None, "train_fsdp", {"data": 2, "model": 4}),
    ("kimi-k2-1t-a32b", False, "train_4k", 6, "train_fsdp", {"data": 16, "model": 16}),
    ("nemotron-4-340b", False, "train_4k", None, "train_fsdp",
     {"pod": 2, "data": 16, "model": 16}),
]


@pytest.mark.parametrize("arch,reduced,shape,batch,rules,mesh", CASES)
def test_replan_matches_the_reference(spec_only_reference, arch, reduced, shape, batch,
                                      rules, mesh):
    cfg_t, cfg_r = get_config(arch), r_configs.get_config(arch)
    if reduced:
        cfg_t, cfg_r = cfg_t.reduced(), cfg_r.reduced()
    shp_t, shp_r = SHAPES[shape], r_configs.SHAPES[shape]
    if batch is not None:
        shp_t = dataclasses.replace(shp_t, global_batch=batch)
        shp_r = dataclasses.replace(shp_r, global_batch=batch)
    ref = r_replan(cfg_r, shp_r, FakeMesh(**mesh), rules)
    _same_plan(replan(cfg_t, shp_t, FakeMesh(**mesh), rules), ref)


# ------------------------------------------------------------------ restore
@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic")
    runs.write_checkpoint(out / "ckpt")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_mesh_runs.py"),
                           "restore", str(out)], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=TIMEOUT)
    errors = "".join(p.read_text() for p in sorted(out.glob("error_*.txt")))
    assert proc.returncode == 0, (errors or proc.stdout + proc.stderr)[-4000:]
    return out


def test_restore_onto_a_mesh_is_bitwise(restored):
    res = json.loads((restored / "restore.json").read_text())
    assert res["restored_equal"]
    assert res["sharded_leaves"] > 10          # train_fsdp shards most leaves


def test_save_from_the_mesh_writes_the_same_files(restored):
    a, b = restored / "ckpt" / "step_000000001", restored / "ckpt_mesh" / "step_000000001"
    names = sorted(p.name for p in a.glob("*.npy"))
    assert names == sorted(p.name for p in b.glob("*.npy")) and len(names) > 20
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors
