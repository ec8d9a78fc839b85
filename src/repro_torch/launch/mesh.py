"""Mesh construction: a ``DeviceMesh`` with the axis view the rules read.

The port of ``repro/launch/mesh.py``. A JAX ``Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, wrapped in ``Mesh`` so that ``.shape`` is an ordered
``{axis: size}`` dict and ``.axis_names`` a tuple, as on a JAX mesh:
``logical_to_spec``, ``moe_ep`` and ``replan`` read ``mesh.shape["model"]``.

Every constructor needs an initialised process group and raises without one;
the launcher makes the group (NCCL for ``cuda``, gloo for ``cpu``), and the
dry run a fake group of the production size (``launch/dryrun.py``).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


class Mesh:
    """A ``DeviceMesh`` seen as a JAX mesh: ``shape``, ``axis_names``, and each
    axis's process group and this rank's coordinate along it."""

    def __init__(self, device_mesh: DeviceMesh):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, device_mesh.mesh.shape,
                                              strict=True))
        self.device_type: str = device_mesh.device_type

    def get_group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def get_local_rank(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device_type={self.device_type!r})"


def _device_type(device_type: str) -> str:
    return "cpu" if device_type == "cpu" else resolve_device(device_type).type


def _need_group(n: int) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {n} devices needs an initialised process group "
            f"(torch.distributed.init_process_group); the launcher makes it")
    return dist.get_world_size()


def init_group(device: torch.device, init_method: str) -> torch.device:
    """The process group a launcher makes from ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` (as ``torchrun`` or a spawned group sets them; one rank
    where they are unset): NCCL on the card, each rank on its ``LOCAL_RANK``
    card, gloo on the CPU. Returns the rank's device."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method,
                            rank=int(os.environ.get("RANK", "0")),
                            world_size=int(os.environ.get("WORLD_SIZE", "1")))
    return device


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> Mesh:
    shape: Tuple[int, ...] = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    _device_type(device_type)
    found = _need_group(n)
    if found < n:
        raise RuntimeError(
            f"production mesh needs {n} devices, found {found} — the dry-run "
            f"must give the process group {n} ranks (a fake group of that size)"
        )
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda") -> Mesh:
    """A mesh of `shape` named `axes` over every rank of the process group,
    whose world size must be ``prod(shape)``."""
    dev_type = _device_type(device_type)      # raises where CUDA is absent
    n = math.prod(shape)
    found = _need_group(n)
    if found != n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks; the process group "
                           f"has {found}")
    return Mesh(init_device_mesh(dev_type, tuple(shape), mesh_dim_names=tuple(axes)))


def single_device_mesh(device_type: str = "cuda") -> Mesh:
    return make_mesh((1,), ("data",), device_type=device_type)
