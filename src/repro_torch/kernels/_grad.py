"""The CUDA kernels compute forwards only: a wrapper refuses to run under grad.

Each ctypes wrapper fills a ``torch.empty`` output through ``data_ptr()``, so
its output has no ``grad_fn``. Called with an input that requires grad while
grad mode is on, it would hand back a result that silently drops that
gradient. The reference refuses the same call (its Pallas kernels have no
``custom_vjp``, so ``jax.grad`` through them raises), and so does the port:
every wrapper calls ``refuse_grad`` before it launches. The plain versions,
which CPU tensors take, stay differentiable. Training takes the plain paths,
as the reference's defaults do (``attn_impl="xla"``, ``ssd_impl`` and
``wkv_impl="chunked"``).
"""

from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise NotImplementedError if grad mode is on and any of `tensors`
    requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: the CUDA kernel has no backward, as the reference's Pallas "
            f"kernel has none, and an input requires grad; run it under "
            f"torch.no_grad(), or train through the plain path (attn_impl='xla', "
            f"ssd_impl/wkv_impl='chunked')")
