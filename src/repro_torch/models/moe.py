"""Mixture-of-Experts: top-k token-choice routing with two implementations.

The port of ``repro/models/moe.py`` on one device:

``dense`` — the oracle: every expert computes every token, combined with the
            routing weights. O(E / top-k) wasted flops; the correctness oracle.
``ep``    — the production path with one expert-parallel shard (ep = 1, no
            mesh), the reference's single-shard code path: sort the token
            assignments by expert (stable, as ``jnp.argsort``), keep the first
            ``capacity`` (GShard-style drops), run the grouped product over the
            expert groups, and scatter-add the weighted outputs.

``jax.lax.ragged_dot`` becomes ``_grouped_ffn``: the group offsets come to the
host once a layer (one device-to-host copy of E integers) and a loop over the
experts runs each expert's rows through ``torch.matmul``. Rows past the groups
(assignments dropped by the capacity cut or owned by another shard) stay zero,
as ``ragged_dot`` leaves them. It is a library product, as the reference left
it to XLA: ``ragged_dot`` is no Pallas kernel.

``ep_ff`` and the ``*_exact`` roofline variants need a mesh or the roofline
harness and raise (ROADMAP A.10). The auxiliary load-balance loss
(Switch-style) is returned beside the output.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import trunc_normal

# The reference's moe_layer variants that need a mesh or the roofline harness.
_UNPORTED_IMPLS = ("ep_ff", "ep_exact", "ep_ff_exact")


def init_moe(gen: torch.Generator, L: int, cfg: ArchConfig, dtype,
             device="cuda") -> Dict[str, torch.Tensor]:
    """The router in fp32; the experts and the shared expert in `dtype`."""
    D, E, Fm = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": trunc_normal(gen, (L, D, E), 1.0, torch.float32, device),
        "w_gate": trunc_normal(gen, (L, E, D, Fm), 1.0, dtype, device),
        "w_up": trunc_normal(gen, (L, E, D, Fm), 1.0, dtype, device),
        "w_down": trunc_normal(gen, (L, E, Fm, D), 1.0, dtype, device),
    }
    if cfg.num_shared_experts:
        Fs = Fm * cfg.num_shared_experts
        p["s_gate"] = trunc_normal(gen, (L, D, Fs), 1.0, dtype, device)
        p["s_up"] = trunc_normal(gen, (L, D, Fs), 1.0, dtype, device)
        p["s_down"] = trunc_normal(gen, (L, Fs, D), 1.0, dtype, device)
    return p


def _route(router_w: torch.Tensor, x: torch.Tensor, cfg: ArchConfig):
    """Router in fp32. Returns (weights (T,k), experts (T,k), probs (T,E)).

    ``jax.lax.top_k`` puts the lower index first among equal values; a stable
    descending sort does the same (``torch.topk`` leaves ties unordered)."""
    logits = x.float() @ router_w                               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    if cfg.moe_renormalize:
        top_p = top_p / (top_p.sum(dim=-1, keepdim=True) + 1e-9)
    return top_p, top_e, probs


def _aux_loss(probs: torch.Tensor, top_e: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-transformer load-balance loss: E * sum_e f_e * p_e."""
    T, k = top_e.shape
    f = torch.bincount(top_e.reshape(-1), minlength=E).float() / (T * k)
    p = probs.mean(dim=0)
    return E * torch.sum(f * p)


def _shared_expert(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["s_gate"]) * (x @ p["s_up"])
    return h @ p["s_down"]


def _expert_ffn_dense(w_gate, w_up, w_down, x):
    """All-experts oracle: x (T, D) -> (T, E, D). The reference's einsums as
    products batched over the experts, which read each expert's weights in
    place (an einsum with the experts inside the product copies them)."""
    h = F.silu(x @ w_gate) * (x @ w_up)                         # (E, T, F)
    return (h @ w_down).transpose(0, 1)                         # (T, E, D)


def moe_dense(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle implementation."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    top_p, top_e, probs = _route(p["router"], xt, cfg)
    ted = _expert_ffn_dense(p["w_gate"], p["w_up"], p["w_down"], xt)   # (T, E, D)
    # The reference's einsum("tk,tke->te", top_p, one_hot(top_e)): a token's k
    # experts are distinct, so each (t, e) takes at most one weight.
    w = torch.zeros((xt.shape[0], cfg.num_experts), dtype=torch.float32, device=x.device)
    w = w.scatter_add_(1, top_e, top_p).to(ted.dtype)
    out = torch.einsum("te,ted->td", w, ted)
    if cfg.num_shared_experts:
        out = out + _shared_expert(p, xt)
    aux = _aux_loss(probs, top_e, cfg.num_experts)
    return out.reshape(B, S, D), aux


def _dispatch(top_p, top_e, cfg: ArchConfig, e_lo: int, e_local: int, capacity: int):
    """The assignments this shard computes, grouped by expert: returns their
    tokens (C,), weights (C,) fp32 (0 where invalid) and the group sizes
    (e_local,). The sort is stable, as the reference's ``jnp.argsort``: its
    order decides which assignments the capacity cut drops."""
    T, k = top_e.shape
    flat_e = top_e.reshape(-1)                                  # (T*k,)
    flat_p = top_p.reshape(-1)
    tok = torch.arange(T, device=top_e.device).repeat_interleave(k)
    mine = (flat_e >= e_lo) & (flat_e < e_lo + e_local)
    # Sort my assignments to the front, ordered by expert id (the grouping);
    # assignments beyond `capacity` are dropped (GShard capacity-factor semantics).
    order = torch.argsort(torch.where(mine, flat_e, cfg.num_experts + 1), stable=True)
    sel = order[:capacity]
    sel_valid = mine[sel]
    sel_e = torch.where(sel_valid, flat_e[sel] - e_lo, e_local)
    sel_t = tok[sel]
    sel_p = torch.where(sel_valid, flat_p[sel], 0.0)
    group_sizes = torch.bincount(sel_e, minlength=e_local + 1)[:e_local]
    return sel_t, sel_p, group_sizes


def _grouped_ffn(xe, w_gate, w_up, w_down, group_sizes):
    """The expert FFN over grouped rows: rows [o_e, o_e + n_e) of xe (C, D)
    through expert e, as the reference's three ``ragged_dot``s. Rows past the
    groups give zeros. One device-to-host copy of the group sizes a call."""
    ye = torch.zeros((xe.shape[0], w_down.shape[-1]), dtype=xe.dtype, device=xe.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            xs = xe[start:start + n]
            h = F.silu(xs @ w_gate[e]) * (xs @ w_up[e])
            ye[start:start + n] = h @ w_down[e]
            start += n
    return ye


def _local_expert_pass(xl, router_w, w_gate, w_up, w_down, cfg: ArchConfig,
                       e_lo: int, e_local: int, capacity: int):
    """Tokens xl (T, D) against the local expert group [e_lo, e_lo + e_local)."""
    T, D = xl.shape
    top_p, top_e, probs = _route(router_w, xl, cfg)
    sel_t, sel_p, group_sizes = _dispatch(top_p, top_e, cfg, e_lo, e_local, capacity)
    ye = _grouped_ffn(xl[sel_t], w_gate, w_up, w_down, group_sizes)      # (C, D)
    out = torch.zeros((T, D), dtype=ye.dtype, device=ye.device)
    out.index_add_(0, sel_t, ye * sel_p[:, None].to(ye.dtype))
    aux = _aux_loss(probs, top_e, cfg.num_experts)
    return out, aux


def _capacity(tokens: int, cfg: ArchConfig, ep: int) -> int:
    c = int(tokens * cfg.experts_per_token * cfg.moe_capacity_factor / ep)
    c = -(-c // 128) * 128
    return min(max(c, 128), tokens * cfg.experts_per_token)


def moe_ep(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel implementation with one shard: the reference's path
    without a mesh (ep = 1)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    out, aux = _local_expert_pass(
        xt, p["router"], p["w_gate"], p["w_up"], p["w_down"], cfg,
        0, cfg.num_experts, _capacity(xt.shape[0], cfg, 1),
    )
    if cfg.num_shared_experts:
        out = out + _shared_expert(p, xt)
    return out.reshape(B, S, D), aux


def moe_layer(p, x, cfg: ArchConfig, impl: str = "ep"):
    if impl == "dense":
        return moe_dense(p, x, cfg)
    if impl in _UNPORTED_IMPLS:
        raise NotImplementedError(
            f"moe_impl={impl!r} needs a device mesh or the roofline harness, "
            f"which are not ported yet (ROADMAP A.10)")
    return moe_ep(p, x, cfg)
