"""Cells at a size the CPU holds, for the checks: the cell's own files with
every width cut to a few dozen (by the configuration's architecture module),
the traffic shortened, the program and the reference on the CPU in float32.
The driver, the engine, the reference and the comparison are the ones a run
on the card uses."""

from __future__ import annotations

import dataclasses
import time

from perfbench.lib import files
from perfbench.lib.cell import Cell


def tiny_model(model: dict, **sizes) -> dict:
    """`model` cut to the tiny size by its architecture's ``tiny_model``."""
    return files.architecture(model).tiny_model(model, **sizes)


def tiny_arch(model: dict):
    """The port's registry config cut to `model`'s tiny widths (the fields
    its architecture's ``tiny_port`` names)."""
    from repro_torch.configs import get_config

    cfg = get_config(model["registry"])
    return dataclasses.replace(cfg, **files.architecture(model).tiny_port(model, cfg))


def tiny_cell(name: str, seed: int = 11, seconds: float = 0.5, trace: bool = False,
              **sizes) -> Cell:
    """`name` at the tiny size; `sizes` override the architecture's tiny
    widths (the decoder's ``TINY``)."""
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
