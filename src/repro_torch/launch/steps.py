"""Step functions: train (grad + AdamW), prefill, and decode.

The port of ``repro/launch/steps.py``. The reference's jit roots become plain
functions over the port's eager model: autograd takes the reference's
``jax.value_and_grad``, and a Python loop over microbatches its ``lax.scan``.
Training runs the plain paths (``attn_impl="xla"``, ``ssd_impl`` and
``wkv_impl="chunked"``), as the reference's defaults: no CUDA kernel has a
backward (``kernels/_grad.py``).

On a mesh the steps take DTensor parameters, optimizer state and batch and
run inside ``axis_rules(mesh, rules)``, as the reference's jitted steps run
under its mesh; the gradients come out placed like the parameters (a
``Partial`` gradient is reduced onto its parameter's placements).
"""

from __future__ import annotations

from typing import Callable

import torch

from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map, unflatten_like


def _value_and_grad(loss_of, params, batch):
    """(loss, metrics), grads of `loss_of` at `params`. The parameters are
    differentiated through detached aliases, so the caller's tensors keep
    their ``requires_grad``."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_of(live, batch)
        flat = leaves(live)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _placed_like(g, p)
             for p, g in zip(flat, grads, strict=True)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), unflatten_like(params, grads)


def _placed_like(g, p):
    """Gradient `g` on its parameter's placements."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _microbatches(x, n: int):
    """Global batch `x` as `n` microbatches of consecutive rows, the
    reference's reshape. A DTensor batch is gathered, cut, and each
    microbatch laid out again as the batch was."""
    if not isinstance(x, DTensor):
        return x.reshape((n, x.shape[0] // n, *x.shape[1:]))
    mesh = x.device_mesh
    whole = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    cut = whole.reshape((n, x.shape[0] // n, *x.shape[1:]))
    return [cut[i].redistribute(mesh, x.placements) for i in range(n)]


def make_train_step(
    cfg: ArchConfig,
    opts: tf.ModelOptions,
    hp: adamw.OptimizerConfig,
    grad_accum: int = 1,
    accum_dtype: torch.dtype = torch.float32,
) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    grad_accum > 1 splits the global batch into microbatches run one after
    another — the activation-memory knob for the big archs (each
    microbatch's activations die before the next starts). accum_dtype=bf16
    halves the persistent accumulator (update precision is preserved by the
    fp32 master + moments). The update is in place (``adamw.apply_update``).
    """

    def loss_of(params, batch):
        return tf.loss_fn(params, cfg, batch, opts)

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            (loss, metrics), grads = _value_and_grad(loss_of, params, batch)
        else:
            mbatches = {k: _microbatches(x, grad_accum) for k, x in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=accum_dtype), params)
            losses, metrics_all = [], []
            for i in range(grad_accum):
                (l, m), g = _value_and_grad(loss_of, params,
                                            {k: x[i] for k, x in mbatches.items()})
                for a, b in zip(leaves(grads), leaves(g), strict=True):
                    a.add_(b.to(accum_dtype))
                losses.append(l)
                metrics_all.append(m)
                del g
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in metrics_all]))
                       for k in metrics_all[0]}

        new_params, new_opt, om = adamw.apply_update(params, grads, opt_state, hp)
        out_metrics = {"loss": loss, **metrics, **om}
        return new_params, new_opt, out_metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, opts: tf.ModelOptions,
                      collect_kv: bool = True) -> Callable:
    """(params, inputs) -> (last-position logits, caches): the serving prefill pass.

    Returns the populated decode caches (what prefill is *for*) and only the final
    position's logits — the (B, S, V) logit tensor never exists."""

    def prefill_step(params, inputs):
        with torch.no_grad():
            logits, _aux, caches = tf.forward(
                params, cfg, inputs, opts, collect_kv=collect_kv, last_only=True
            )
        return logits[:, 0], caches

    return prefill_step


def make_serve_step(cfg: ArchConfig, opts: tf.ModelOptions) -> Callable:
    """(params, state, inputs) -> (next_tokens, new_state): one decode step."""

    def serve_step(params, state, inputs):
        with torch.no_grad():
            logits, new_state = tf.decode_step(params, cfg, state, inputs, opts)
            # on a mesh the vocab is gathered first: the argmax of one token a row
            logits = constrain(logits, ("batch", None))
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, new_state

    return serve_step
