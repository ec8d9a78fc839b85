"""The port's multi-device layer across 8 gloo processes on a (2, 4) mesh.

Each run spawns its ranks in a subprocess (``tests/_torch_mesh_runs.py``,
file rendezvous, one thread a rank) with its own timeout:

  * the EP MoE layer (``ep``, ``ep_ff``, ``ep_exact``, ``ep_ff_exact``)
    against the reference's ``shard_map`` on 8 emulated JAX devices
    (tests/test_sharding.py:90), on the reference's parameters and inputs;
  * the train step on the mesh against the port's 1-process step (a
    port-only mirror of tests/test_sharding.py:135): ``dense`` under
    ``train_fsdp`` for the loss and every gradient leaf, ``ep`` against
    ``dense`` and learning over 30 steps, and ZeRO-1 state in the host tier;
  * ``psum_compressed`` against its arithmetic done serially;
  * ``launch.train --mesh 2x4 --device cpu`` as 8 processes.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.configs as r_configs
import repro.models.transformer as r_tf
from repro_torch.distributed import compression

ROOT = Path(__file__).resolve().parent.parent
RUNS = ROOT / "tests" / "_torch_mesh_runs.py"
TIMEOUT = 300
MOE_ATOL, AUX_ATOL = 1e-5, 1e-6           # tests/test_torch_moe.py's
IMPLS = ("ep", "ep_ff", "ep_exact", "ep_ff_exact")


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
            "JAX_PLATFORMS": "cpu"}


def _scenario(name: str, out: Path) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(RUNS), name, str(out)], env=_env(),
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(proc: subprocess.Popen, out: Path) -> None:
    log, _ = proc.communicate(timeout=TIMEOUT)
    errors = "".join(p.read_text() for p in sorted(out.glob("error_*.txt")))
    assert proc.returncode == 0, (errors or log)[-4000:]


# ------------------------------------------------------------------ train
@pytest.fixture(scope="module")
def train(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    _finish(_scenario("train", out), out)
    return json.loads((out / "train.json").read_text())


def test_mesh_step_matches_the_one_process_step(train):
    """dense MoE on both sides, so only the sharding differs: the loss and
    every gradient leaf within 1e-5."""
    d = train["dense"]
    assert abs(d["loss_mesh"] - d["loss_one"]) < 1e-5
    assert abs(d["step_loss_mesh"] - d["step_loss_one"]) < 1e-5
    assert d["grad_err"] < 1e-5


def test_mesh_gradients_are_placed_like_the_parameters(train):
    assert train["dense"]["grads_placed_like_params"]
    assert any("Shard" in p for p in train["dense"]["placements"])


def test_mesh_step_parameters_within_the_adamw_bound(train):
    """Within 5e-5, or lr·|dg|/eps where AdamW's first step amplifies a
    near-zero gradient's difference."""
    assert train["dense"]["param_excess_over_bound"] <= 0.0


@pytest.mark.parametrize("case", ["grad_accum", "remat"])
def test_grad_accum_and_remat_on_the_mesh(train, case):
    """grad_accum=2 (microbatches of the global batch) and remat="full" keep
    working on the mesh: the loss and the parameters after a step as the
    same step on one process."""
    r = train[case]
    assert abs(r["loss_mesh"] - r["loss_one"]) < 1e-5
    assert r["param_err"] < 5e-5


def test_ep_on_the_mesh_matches_dense_and_learns(train):
    """tests/test_sharding.py:135's bars: ep within 0.05 of dense (capacity
    per local shard), and the 30-step window means fall by 0.1."""
    losses = train["ep"]["losses"]
    assert all(np.isfinite(losses))
    assert abs(losses[0] - train["ep"]["l_dense"]) < 0.05
    assert sum(losses[-5:]) / 5 < sum(losses[:5]) / 5 - 0.1


def test_zero1_offloaded_state_step_matches(train):
    """train_dp_all: replicated parameters, state sharded over all 8 ranks
    (train_zero1) in the host tier; the step equals the 1-process one."""
    z = train["zero1"]
    assert "Shard" in z["state_placements"] and "Shard" not in z["param_placements"]
    assert abs(z["loss_mesh"] - z["loss_one"]) < 1e-5
    assert z["param_err"] < 5e-5


# ------------------------------------------------------------------ moe
_JAX_MOE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.distributed import axis_rules
    from repro.launch.mesh import make_mesh
    from repro.models import moe
    cfg = get_config("olmoe-1b-7b").reduced()
    d = np.load(sys.argv[1] + "/moe_in.npz")
    p = {k: jnp.asarray(d[k]) for k in d.files if k != "x"}
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    with mesh, axis_rules(mesh, "train_fsdp"):
        for impl in ("ep", "ep_ff", "ep_exact", "ep_ff_exact"):
            y, aux = moe.moe_layer(p, jnp.asarray(d["x"]), cfg, impl=impl)
            out[impl + "_out"], out[impl + "_aux"] = np.asarray(y), np.asarray(aux)
    assert jax.device_count() == 8
    np.savez(sys.argv[1] + "/moe_ref.npz", **out)
""")


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe")
    cfg = r_configs.get_config("olmoe-1b-7b").reduced()
    params = r_tf.init_params(jax.random.PRNGKey(0), cfg)
    layer = {k: np.asarray(v[0]) for k, v in params["stack"]["moe"].items()}
    x = np.random.default_rng(12).standard_normal((8, 64, cfg.d_model)).astype(np.float32)
    np.savez(out / "moe_in.npz", x=x, **layer)
    ref = subprocess.Popen([sys.executable, "-c", _JAX_MOE, str(out)], env=_env(), cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = _scenario("moe", out)
    _finish(port, out)
    _finish(ref, out)
    return np.load(out / "moe.npz"), np.load(out / "moe_ref.npz")


@pytest.mark.parametrize("impl", IMPLS)
def test_ep_moe_layer_matches_the_reference_shard_map(moe, impl):
    port, ref = moe
    np.testing.assert_allclose(port[f"{impl}_out"], ref[f"{impl}_out"], atol=MOE_ATOL, rtol=0)
    assert abs(float(port[f"{impl}_aux"]) - float(ref[f"{impl}_aux"])) <= AUX_ATOL


# ------------------------------------------------------------------ psum_compressed
@pytest.fixture(scope="module")
def psum_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("psum")
    _finish(_scenario("psum", out), out)
    return out


@pytest.mark.parametrize("name,groups", [
    ("all8", [list(range(8))]),
    ("model4", [[0, 1, 2, 3], [4, 5, 6, 7]]),
])
def test_psum_compressed_equals_the_serial_arithmetic(psum_run, name, groups):
    """int8 values widened to int32 and summed, scales maxed, / n ranks."""
    import torch

    for group in groups:
        grads = [dict(np.load(psum_run / f"grad_{r}.npz")) for r in group]
        qs = [compression.compress_tree({k: torch.from_numpy(v) for k, v in g.items()})[0]
              for g in grads]
        for k in grads[0]:
            summed = sum(q[k][0].to(torch.int32) for q in qs)
            s_max = torch.stack([q[k][1] for q in qs]).max()
            want = (summed.to(torch.float32) * s_max / float(len(group))).numpy()
            for r in group:
                got = np.load(psum_run / f"psum_{name}_{r}.npz")
                assert np.array_equal(got[k], want)
                err = compression.compress_tree(
                    {k: torch.from_numpy(grads[group.index(r)][k])})[1][k]
                assert np.array_equal(got[f"err_{k}"], err.numpy())


# ------------------------------------------------------------------ launcher
def test_train_launcher_runs_a_2x4_mesh(tmp_path):
    """``launch.train --mesh 2x4 --device cpu`` as 8 processes (RANK,
    WORLD_SIZE, LOCAL_RANK and a file rendezvous) takes 3 steps."""
    procs = []
    for r in range(8):
        env = {**_env(), "RANK": str(r), "WORLD_SIZE": "8", "LOCAL_RANK": str(r)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmoe-1b-7b",
             "--reduced", "--device", "cpu", "--mesh", "2x4", "--steps", "3",
             "--batch", "8", "--seq", "32", "--ckpt-dir", str(tmp_path / "ckpt"),
             "--dist-init", f"file://{tmp_path / 'rdv'}"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:]
    assert "done: 3 steps, restarts=0" in logs[0]
    assert (tmp_path / "ckpt" / "step_000000003" / "manifest.json").exists()


def test_train_100m_runs_with_zero1_state(tmp_path):
    """``launch/train_100m.py`` (examples/train_100m.py's counterpart) on two
    ranks: replicated parameters, AdamW state sharded over both; 3 steps, the
    loss falls and the last step is checkpointed."""
    procs = []
    for r in range(2):
        env = {**_env(), "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train_100m", "--steps", "3",
             "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
             "--dist-init", f"file://{tmp_path / 'rdv'}"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:]
    assert "M params (6L d=512)" in logs[0] and "over 3 steps (0 restarts)" in logs[0]
    assert (tmp_path / "ckpt" / "step_000000003" / "manifest.json").exists()
