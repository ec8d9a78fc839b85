"""Device resolution shared by the port's entry points.

Every entry point takes ``device="cuda"`` by default and runs on the card.
Asking for CUDA on a machine without it raises here; nothing falls back to
the CPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent card."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev
