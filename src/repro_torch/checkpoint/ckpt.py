"""Fault-tolerant checkpointing: atomic step dirs, async save, resume.

The port of ``repro/checkpoint/ckpt.py``, with its layout byte for byte:
<dir>/step_<n>/<flat__param__path>.npy + manifest.json, keys joined with
``"__"`` from dict keys and sequence indices. Writes go to a tmp dir renamed
into place (atomic on POSIX), so a preempted save never corrupts the latest
checkpoint; ``latest_step`` simply picks the highest complete step. Saves can
run on a background thread (training continues; the next save joins the
previous).

bf16 leaves are stored as the reference's numpy stores them: raw two-byte
records (descr ``'<V2'``), written here from the bits' ``uint16`` view, and
read back as bf16 — so a checkpoint written by either package restores in
the other. ``save`` snapshots with copies: the optimizer updates its state in
place, and a view of a pinned master would change under the writer thread.
Restore places each leaf like the template's (device, pinned host memory).

On a mesh the files are the same: ``save`` gathers each DTensor leaf whole
(``full_tensor()``, a collective every rank joins) and rank 0 writes.
``restore(shardings=...)`` places each full leaf on the given shardings,
which may describe another mesh than the one that saved (the elastic
restart); a DTensor template places each leaf as the template is.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import device_put, full_tensor, place_like
from repro_torch.tree import leaves_with_path, unflatten_like

_SEP = "__"
_BF16_DESCR = "<V2"


def _flatten(tree: Any) -> Dict[str, Any]:
    return {_SEP.join(str(p) for p in path): leaf for path, leaf in leaves_with_path(tree)}


def _snapshot(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if isinstance(x, DTensor):
        x = full_tensor(x.detach())
    t = x.detach().cpu().clone()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)   # marked by _save
    return t.numpy()


def _save(path: pathlib.Path, arr: np.ndarray, bf16: bool) -> None:
    if not bf16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr, dtype="<u2").tobytes())


def _load(path: pathlib.Path, template, sharding=None) -> Any:
    arr = np.load(path)
    if not isinstance(template, torch.Tensor):
        return arr.astype(np.asarray(template).dtype)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    t = t.to(template.dtype)
    if sharding is not None:
        return device_put(t.to(sharding.mesh.device_type), sharding)
    if isinstance(template, DTensor):
        return place_like(t.to(template.device_mesh.device_type), template)
    if template.is_cuda:
        return t.to(template.device)
    return t.pin_memory() if template.is_pinned() else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any], extra: Optional[Dict] = None,
             block: bool = False) -> None:
        """Snapshot to host (copies) then persist atomically (optionally async)."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()      # pending non_blocking writes into pinned state
        flat = _flatten(state)
        bf16 = {k for k, x in flat.items()
                if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16}
        host_state = {k: _snapshot(x) for k, x in flat.items()}
        if dist.is_initialized() and dist.get_rank() != 0:
            return                        # rank 0 writes the gathered arrays
        self.wait()
        args = (step, host_state, bf16, extra or {})
        if self.async_save and not block:
            self._thread = threading.Thread(target=self._write, args=args, daemon=True)
            self._thread.start()
        else:
            self._write(*args)

    def _write(self, step: int, flat: Dict[str, np.ndarray], bf16, extra: Dict) -> None:
        final = self.dir / f"step_{step:09d}"
        tmp = self.dir / f".tmp_step_{step:09d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra, "keys": sorted(flat),
                    "time": time.time()}
        for key, arr in flat.items():
            _save(tmp / f"{key}.npy", arr, key in bf16)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)          # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ------------------------------------------------------------------ restore
    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any, shardings: Optional[Any] = None) -> Any:
        """Load into the structure of `template`, each leaf typed like the
        template's and placed per `shardings` if given (which may describe a
        different mesh than the one that saved — elastic), else like the
        template's leaf (device, pinned host memory, DTensor placements)."""
        src = self.dir / f"step_{step:09d}"
        flat_s = _flatten(shardings) if shardings is not None else {}
        flat = [_load(src / f"{key}.npy", leaf, flat_s.get(key))
                for key, leaf in _flatten(template).items()]
        return unflatten_like(template, flat)

    def extra(self, step: int) -> Dict:
        src = self.dir / f"step_{step:09d}" / "manifest.json"
        return json.loads(src.read_text()).get("extra", {})
