"""The CUDA kernels compute forwards only: a wrapper refuses to run under grad.

Each ctypes wrapper fills a ``torch.empty`` output through ``data_ptr()``, so
its output has no ``grad_fn``. Called with an input that requires grad while
grad mode is on, it would hand back a result that silently drops that
gradient. The reference refuses the same call (its Pallas kernels have no
``custom_vjp``, so ``jax.grad`` through them raises), and so does the port:
every wrapper calls ``refuse_grad`` before it launches. The plain versions,
which CPU tensors take, stay differentiable. Kernel backwards come with the
training stack (ROADMAP A.9).
"""

from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise NotImplementedError if grad mode is on and any of `tensors`
    requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: the CUDA kernel has no backward, and an input requires grad; "
            f"run it under torch.no_grad() or take the plain version (kernel "
            f"backwards: ROADMAP A.9)")
