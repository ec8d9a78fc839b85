"""Cells at a size the CPU holds, for the checks: the cell's own files with
every width cut to a few dozen, the traffic shortened, the program and the
reference on the CPU in float32. The driver, the engine, the reference and
the comparison are the ones a run on the card uses."""

from __future__ import annotations

import copy
import dataclasses
import time

from perfbench.lib.cell import Cell

TINY = {"hidden_size": 64, "num_attention_heads": 4, "head_dim": 16,
        "num_hidden_layers": 2, "intermediate_size": 96, "vocab_size": 256,
        "torch_dtype": "float32"}
TINY_MOE = {"num_experts": 8, "num_experts_per_tok": 2}


def tiny_model(model: dict, **sizes) -> dict:
    m = copy.deepcopy(model)
    m.update(TINY, **sizes)
    m["num_key_value_heads"] = 2 if model["num_key_value_heads"] < model["num_attention_heads"] \
        else TINY["num_attention_heads"]
    if "num_experts" in m:
        m.update(TINY_MOE)
    m["assumed"]["weights"]["std"] = 0.2
    return m


def tiny_arch(model: dict):
    """The port's registry config cut to `model`'s tiny widths."""
    from repro_torch.configs import get_config

    cfg = get_config(model["registry"])
    kw = dict(num_layers=model["num_hidden_layers"], d_model=model["hidden_size"],
              num_heads=model["num_attention_heads"], num_kv_heads=model["num_key_value_heads"],
              head_dim=model["head_dim"], d_ff=model["intermediate_size"],
              vocab_size=model["vocab_size"], dtype="float32", param_dtype="float32")
    if cfg.moe:
        kw.update(moe_d_ff=model["intermediate_size"], num_experts=model["num_experts"],
                  experts_per_token=model["num_experts_per_tok"])
    return dataclasses.replace(cfg, **kw)


def tiny_cell(name: str, seed: int = 11, seconds: float = 0.5, trace: bool = False,
              **sizes) -> Cell:
    """`name` at the tiny size; `sizes` override TINY's keys."""
    cell = Cell.load(name, seed, seconds, trace, "cpu", time.perf_counter())
    cell.model = tiny_model(cell.model, **sizes)
    cell.arch = tiny_arch(cell.model)
    mix = cell.traffic
    if mix["kind"] == "serve_closed":
        mix.update(clients=6, shapes=8, warm_steps=6,
                   prompt_tokens={"log_uniform": [3, 20]},
                   output_tokens={"log_uniform": [2, 10]})
        # every client's largest request fits, as in the cell
        cell.workload.update(page=4, max_batch=4, check={"tokens": 40}, hot_slots=6 * 8)
    else:
        mix.update(shapes=4, prompt_tokens={"log_uniform": [8, 40]})
        cell.workload["check"] = {"calls": 2, "from_first": 2}
    return cell
