"""Double-buffered host->device pipeline staged through the remote tier.

The port of ``repro/data/loader.py``. The paper's *direct access* usage model
applied to input data: staging buffers are emucxl allocations in the remote
tier (pinned host memory on the card); the loader writes the next batch into
the inactive buffer while the device consumes the current one, then DMAs it
across. The consumer gets tensors on the loader's ``device``; with the
reference's ``sharding`` (a ``NamedSharding``, or a dict of them by batch
key) each rank builds its DTensor batch from its own block of the staged
batch (``DTensor.from_local``, no collective).

On a card the DMA is a ``non_blocking`` copy out of the pinned staging
buffer on the current stream; before the producer rewrites a buffer it waits
for the copy that last read it. On the CPU the batch is read back through the
emulator, as the reference's ``read_array``.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import emucxl as ecxl
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import device_put


class PrefetchLoader:
    """Wraps a batch source with remote-tier staging + background prefetch."""

    def __init__(
        self,
        source: SyntheticTokens,
        lib: Optional[ecxl.EmuCXL] = None,
        prefetch: int = 2,
        device="cuda",
        start_step: int = 0,
        sharding=None,
    ):
        self.source = source
        self.lib = lib
        self.device = resolve_device(device)
        self.sharding = sharding
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._stage_addrs: Dict[str, int] = {}
        self._copied: Dict[str, torch.cuda.Event] = {}   # key -> last DMA out of it
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ producer
    def _stage(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """Write through an emucxl remote-tier staging buffer (double-buffered)
        and hand back the batch on the loader's device."""
        on_card = self.device.type == "cuda"
        if self.lib is None:
            t = torch.from_numpy(arr)
            return t.pin_memory().to(self.device, non_blocking=True) if on_card else t
        key = f"{name}:{self.step % 2}"
        nbytes = arr.nbytes
        if key not in self._stage_addrs:
            self._stage_addrs[key] = self.lib.alloc(nbytes, ecxl.REMOTE_MEMORY)
        addr = self._stage_addrs[key]
        if self.lib.get_size(addr) < nbytes:
            self.lib.free(addr)
            self._stage_addrs[key] = addr = self.lib.alloc(nbytes, ecxl.REMOTE_MEMORY)
        if key in self._copied:
            self._copied.pop(key).synchronize()     # the DMA that last read it is done
        self.lib.write_array(arr, addr)
        if not on_card:
            return torch.from_numpy(self.lib.read_array(addr, arr.shape, arr.dtype))
        staging = self.lib.allocations()[addr].data[:nbytes]
        dtype = torch.from_numpy(arr[:0]).dtype
        out = staging.view(dtype).view(arr.shape).to(self.device, non_blocking=True)
        self._copied[key] = torch.cuda.Event()
        self._copied[key].record()
        return out

    def _producer(self) -> None:
        while not self._stop.is_set():
            batch = self.source.batch_at(self.step)
            staged = {k: self._stage(k, v) for k, v in batch.items()}
            if self.sharding is not None:
                staged = {k: device_put(v, self.sharding[k] if isinstance(self.sharding, dict)
                                        else self.sharding)
                          for k, v in staged.items()}
            try:
                self._q.put((self.step, staged), timeout=1.0)
                self.step += 1
            except queue.Full:
                continue

    # ------------------------------------------------------------------ consumer
    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.get()

    def get(self):
        step, batch = self._q.get()
        return batch

    def state(self) -> Dict[str, int]:
        """Checkpointable iterator state."""
        return {"step": self.step - self._q.qsize()}

    def close(self) -> None:
        self._stop.set()
        while not self._q.empty():
            self._q.get_nowait()
        self._thread.join(timeout=10.0)
