"""Training runtime: step loop with checkpoint/restart, straggler + fault handling.

Fault-tolerance model (designed for 1000+ nodes, exercised here at 1 process):
  * periodic ATOMIC checkpoints (async; data-iterator state included) — a failed
    node means restart-from-latest, losing at most `ckpt_every` steps;
  * per-step deadline monitoring — a step exceeding `straggler_factor` x the rolling
    median is logged as a straggler event; at scale the deployment reacts by
    excluding/replacing the slow host at the next restart boundary (elastic.py
    computes the re-sharding), since in SPMD one slow chip stalls the collective;
  * injectable faults (`fault_hook`) so tests can prove the restart path end-to-end;
  * NaN/overflow step skipping (the loss-scale-free bf16 guard).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.ckpt import CheckpointManager


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    max_restarts: int = 3


@dataclasses.dataclass
class StepEvent:
    step: int
    seconds: float
    loss: float
    straggler: bool = False
    skipped_nonfinite: bool = False


class SimulatedFault(RuntimeError):
    pass


def run(
    train_step: Callable,
    params: Any,
    opt_state: Any,
    loader,
    cfg: TrainLoopConfig,
    fault_hook: Optional[Callable[[int], None]] = None,
    metrics_cb: Optional[Callable[[int, Dict], None]] = None,
) -> Dict[str, Any]:
    """Run to total_steps with restart-on-fault. Returns final state + history."""
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
    history: List[StepEvent] = []
    restarts = 0

    # resume if a checkpoint exists
    start_step = 0
    latest = mgr.latest_step()
    if latest is not None:
        state = mgr.restore(latest, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start_step = latest
        loader.step = mgr.extra(latest).get("data_step", latest)

    step = start_step
    durations: List[float] = []
    while step < cfg.total_steps:
        try:
            batch = loader.get()
            if fault_hook is not None:
                fault_hook(step)
            t0 = time.time()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            durations.append(dt)

            straggler = False
            if len(durations) >= 5:
                med = float(np.median(durations[-20:]))
                if dt > cfg.straggler_factor * med:
                    straggler = True

            skipped = not np.isfinite(loss)
            history.append(StepEvent(step, dt, loss, straggler, skipped))
            step += 1

            if metrics_cb and step % cfg.log_every == 0:
                metrics_cb(step, {k: float(v) for k, v in metrics.items()})
            if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                mgr.save(step, {"params": params, "opt": opt_state},
                         extra={"data_step": loader.state()["step"]})
        except SimulatedFault:
            restarts += 1
            if restarts > cfg.max_restarts:
                raise
            latest = mgr.latest_step()
            if latest is not None:
                state = mgr.restore(latest, {"params": params, "opt": opt_state})
                params, opt_state = state["params"], state["opt"]
                step = latest
                loader.step = mgr.extra(latest).get("data_step", latest)
            else:
                step = 0
    mgr.wait()
    return {
        "params": params,
        "opt_state": opt_state,
        "history": history,
        "restarts": restarts,
        "straggler_events": sum(1 for e in history if e.straggler),
    }
