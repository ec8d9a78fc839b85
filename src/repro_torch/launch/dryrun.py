"""Production-mesh dry run: one step of a full config on meta DTensors.

The port of ``repro/launch/dryrun.py``. The reference lowers and compiles
every (arch x shape x mesh) cell on 256 or 512 emulated XLA devices and
reads XLA's memory and cost analyses and the collectives of the compiled
HLO. The port has no compiler to ask, so it runs the step itself, on
shapes alone:

  * a fake process group of the production size (``backend="fake"``; its
    collectives return at once), made inside ``fake_group`` — the only
    place that imports ``torch.testing._internal``, at call time;
  * parameters, optimizer state, batch and decode state as DTensors on the
    meta device, placed by ``launch/specs.py``'s shardings, so the full
    kimi-k2-1t or nemotron-4-340b trees allocate nothing;
  * one train, prefill or decode step under ``CommDebugMode``, which counts
    the collectives by kind.

It reports per-device argument bytes (the local shards of params, state and
batch, or decode state), the host-tier bytes of offloaded state, and the
collective counts. ``parse_collectives`` and ``_bf16_origin`` read XLA HLO
text and have no counterpart here; ``CommDebugMode``'s counts take their
place. Meta tensors carry no routing, so the MoE layer runs its flop-exact
variant (``ep`` -> ``ep_exact``): the same shapes and collectives. Results
go to ``build/dryrun/`` (git-ignored).

    python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k --mesh single
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Any, Dict, Optional

import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import axis_rules
from repro_torch.distributed.sharding import device_put
from repro_torch.launch import specs as sp
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str
    rules: str = ""
    seconds: float = 0.0
    skip_reason: str = ""
    memory: Optional[Dict[str, float]] = None
    cost: Optional[Dict[str, float]] = None
    collectives: Optional[Dict[str, Any]] = None
    params: int = 0
    active_params: int = 0
    offload_bytes: int = 0
    grad_accum: int = 1
    error: str = ""


def default_options(cfg: ArchConfig, shape: ShapeConfig,
                    unroll: bool = False) -> tf.ModelOptions:
    # blocked attention once full scores would exceed ~VMEM-scale working sets;
    # the Pallas flash kernel replaces this on real TPUs (hillclimb knob).
    chunked = shape.kind != "decode" and shape.seq_len >= 8192
    return tf.ModelOptions(
        attn_impl="xla_chunked" if chunked else "xla",
        # analysis lowers use the flops-exact MoE variant (see models/moe.py:
        # CPU ragged_dot lowering overcounts FLOPs by the group count)
        moe_impl="ep_exact" if unroll else "ep",
        wkv_impl="chunked",
        ssd_impl="chunked",
        remat="full" if shape.kind == "train" else "none",
        unroll_scans=unroll,
    )


def default_hp(cfg: ArchConfig) -> adamw.OptimizerConfig:
    # offload optimizer state (the paper's technique) for archs whose fp32 state
    # cannot fit in HBM: >= ~2 GB/chip of moments+master on the 512-chip mesh.
    state_bytes = cfg.param_count() * 12
    offload = state_bytes / 512 > 2 * 2**30
    return adamw.OptimizerConfig(offload_state=offload)


_ACT_BUDGET = 4 * 2**30  # target bytes/device for remat-saved residuals


def default_train_plan(cfg: ArchConfig, shape: ShapeConfig, multi_pod: bool):
    """(rules, grad_accum): sequence-parallel + microbatching heuristics.

    Saved-residual bytes under scanned remat ~= L * S * D * 2 per sequence. When one
    sequence alone exceeds the budget, shard the sequence over the model axis
    (train_fsdp_sp); then accumulate gradients so live microbatch residuals fit.
    """
    rules = sp.rules_for(cfg, shape)
    per_seq = cfg.num_layers * shape.seq_len * cfg.d_model * 2
    # recurrent families: the inner chunk scan saves per-chunk residuals for the
    # backward on top of the layer carry (~2x measured)
    if cfg.family in ("ssm", "hybrid"):
        per_seq *= 2
    if rules == "train_fsdp" and per_seq > _ACT_BUDGET:
        rules = "train_fsdp_sp"
        per_seq //= 16
    # fp32 logits: replicated vocab under dp_all, model-sharded otherwise
    vocab_shard = 1 if rules == "train_dp_all" else 16
    per_seq += shape.seq_len * cfg.padded_vocab * 4 // vocab_shard
    # actual batch sharding: greedy prefix of (pod, data[, model]) that divides
    axes = [2, 16] if multi_pod else [16]
    if rules == "train_dp_all":
        axes.append(16)  # model axis carries batch too when divisible
    dp = 1
    for a in axes:
        if shape.global_batch % (dp * a) == 0:
            dp *= a
    b_loc = max(shape.global_batch // dp, 1)
    ga = 1
    while b_loc // ga > 1 and b_loc % (ga * 2) == 0 and (b_loc // ga) * per_seq > _ACT_BUDGET:
        ga *= 2
    return rules, ga


# --------------------------------------------------------------------- fake group
def fake_group(world_size: int) -> None:
    """Make the process-global group a fake one of `world_size` ranks (this
    process is rank 0); any group before it is destroyed."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               for t in leaves(tree) if isinstance(t, DTensor))


def _counts(mode) -> Dict[str, int]:
    return {str(k).split(".")[-1]: int(v) for k, v in mode.get_comm_counts().items()}


# --------------------------------------------------------------------- cells
def build_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    num_layers: Optional[int] = None,
    seq_len: Optional[int] = None,
    rules_override: Optional[str] = None,
    grad_accum: Optional[int] = None,   # None = auto from the train plan
):
    """Place one cell on the production mesh of a fake group. Returns
    (run, meta): ``run()`` takes the step and returns the collective counts."""
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = cfg.supports_shape(shape)
    if not ok:
        return None, {"skip_reason": reason}
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers,
                                  moe_first_dense=min(cfg.moe_first_dense, 1))
    if seq_len is not None:
        shape = dataclasses.replace(shape, seq_len=seq_len)

    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    if shape.kind == "train":
        plan_rules, plan_ga = default_train_plan(cfg, shape, multi_pod)
        if grad_accum is None:
            grad_accum = plan_ga
    else:
        plan_rules = sp.rules_for(cfg, shape)
    grad_accum = grad_accum or 1
    rules = rules_override or plan_rules
    opts = default_options(cfg, shape)
    exact = {"ep": "ep_exact", "ep_ff": "ep_ff_exact"}
    opts = dataclasses.replace(opts, moe_impl=exact.get(opts.moe_impl, opts.moe_impl))
    hp = default_hp(cfg)

    p = tree_map(device_put, sp.params_specs(cfg), sp.param_shardings(cfg, mesh, rules))
    b_sh = sp.batch_shardings(cfg, shape, mesh, rules)
    b = {k: device_put(v, b_sh[k]) for k, v in sp.batch_specs(cfg, shape).items()}
    host_bytes = 0
    if shape.kind == "train":
        o_sh = sp.opt_state_shardings(cfg, hp, mesh, rules)
        o = tree_map(device_put, sp.opt_state_specs(cfg, hp), o_sh)
        host_bytes = sum(_local_bytes(o[k]) for k in ("m", "v", "master")
                         if k in o and hp.offload_state)
        step = st.make_train_step(cfg, opts, hp, grad_accum=grad_accum)
        args = (p, o, b)
        arg_bytes = _local_bytes(p) + _local_bytes(o) + _local_bytes(b) - host_bytes
    elif shape.kind == "prefill":
        step = st.make_prefill_step(cfg, opts)
        args = (p, b["inputs"])
        arg_bytes = _local_bytes(p) + _local_bytes(b)
    else:
        s_sh = sp.decode_state_shardings(cfg, shape, mesh, rules)
        s = tree_map(device_put, sp.decode_state_specs(cfg, shape), s_sh)
        step = st.make_serve_step(cfg, opts)
        args = (p, s, b["inputs"])
        arg_bytes = _local_bytes(p) + _local_bytes(s) + _local_bytes(b)

    def run():
        with CommDebugMode() as mode, axis_rules(mesh, rules):
            step(*args)
        return _counts(mode)

    man = sp.offload_manifest(cfg, hp)
    meta = {
        "rules": rules,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        # optimizer state exists only in train steps
        "offload_bytes": man.resident_bytes if shape.kind == "train" else 0,
        "grad_accum": grad_accum,
        "param_bytes": _local_bytes(p),
        "argument_bytes": arg_bytes,
        "host_argument_bytes": host_bytes,
        "cfg": cfg,
        "shape": shape,
    }
    return run, meta


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> CellResult:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.time()
    try:
        run, meta = build_cell(arch, shape_name, multi_pod)
        if run is None:
            return CellResult(arch, shape_name, mesh_name, "skip",
                              skip_reason=meta["skip_reason"])
        counts = run()
        mem = {"argument_bytes": float(meta["argument_bytes"]),
               "param_bytes": float(meta["param_bytes"]),
               "host_argument_bytes": float(meta["host_argument_bytes"])}
        res = CellResult(
            arch, shape_name, mesh_name, "ok",
            rules=meta["rules"], seconds=time.time() - t0,
            memory=mem, collectives={"counts": counts},
            params=meta["params"], active_params=meta["active_params"],
            offload_bytes=meta["offload_bytes"], grad_accum=meta["grad_accum"],
        )
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"({res.seconds:.1f}s) args/dev={mem['argument_bytes']/2**30:.2f}GiB "
              f"host/dev={mem['host_argument_bytes']/2**30:.2f}GiB")
        print(f"  collectives: {counts}")
        return res
    except Exception as e:  # record failure in the matrix
        traceback.print_exc()
        return CellResult(arch, shape_name, mesh_name, "fail",
                          seconds=time.time() - t0, error=f"{type(e).__name__}: {e}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def cell_path(arch: str, shape_name: str, mesh_name: str) -> pathlib.Path:
    return OUT_DIR / f"{arch}__{shape_name}__{mesh_name}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="production-mesh dry run (meta tensors)")
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    args = ap.parse_args(argv)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                mesh_name = "2x16x16" if multi_pod else "16x16"
                path = cell_path(arch, shape_name, mesh_name)
                if path.exists() and not args.force:
                    prev = json.loads(path.read_text())
                    if prev.get("status") in ("ok", "skip"):
                        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: cached "
                              f"{prev['status']}")
                        n_ok += prev["status"] == "ok"
                        n_skip += prev["status"] == "skip"
                        continue
                res = run_cell(arch, shape_name, multi_pod)
                path.write_text(json.dumps(dataclasses.asdict(res), indent=1))
                n_ok += res.status == "ok"
                n_skip += res.status == "skip"
                n_fail += res.status == "fail"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} documented skips, {n_fail} failures")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
