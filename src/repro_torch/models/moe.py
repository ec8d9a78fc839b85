"""Mixture-of-Experts: top-k token-choice routing with two implementations.

The port of ``repro/models/moe.py``:

``dense`` — the oracle: every expert computes every token, combined with the
            routing weights. O(E / top-k) wasted flops; the correctness oracle.
``ep``    — the production path; with one expert-parallel shard (ep = 1, no
            mesh) the reference's single-shard code path: sort the token
            assignments by expert (stable, as ``jnp.argsort``), keep the first
            ``capacity`` (GShard-style drops), run the grouped product over the
            expert groups, and scatter-add the weighted outputs.

``jax.lax.ragged_dot`` becomes ``_grouped_ffn``: for bf16 on the card,
``torch._grouped_mm`` with the group offsets on the device; otherwise the
group offsets come to the host once a layer (one device-to-host copy of E
integers) and a loop over the experts runs each expert's rows through
``torch.matmul``. Rows past the groups (assignments dropped by the capacity
cut or owned by another shard) are zero, as ``ragged_dot`` leaves them. It is
a library product, as the reference left it to XLA: ``ragged_dot`` is no
Pallas kernel.

Under a mesh (an ``axis_rules`` context whose ``model`` extent ``ep > 1``
divides the expert count) ``ep`` runs the reference's ``shard_map`` body on
each rank's local shards: the batch over the batch axes, the experts over
``model``; ``out`` is summed and ``aux`` averaged over the ranks, through
DTensor's ``Partial -> Replicate`` so the gradient flows through the
all-reduce. ``ep_ff`` shards each expert's ff dim over the data axes too.
``*_exact`` is the reference's roofline stand-in for ``ragged_dot``
(``a @ w[0]``): flop-exact shapes, not the same function. The auxiliary
load-balance loss (Switch-style) is returned beside the output.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (constrain, current_mesh, current_rules,
                                              global_out, local_in, shard_dims)
from repro_torch.models.layers import trunc_normal


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
    # the reference's zeros(E).at[top_e].add(1.0): a count per expert, summed
    # over the (possibly batch-sharded) assignments
    experts = torch.arange(E, device=top_e.device)
    f = (top_e.reshape(-1)[:, None] == experts).float().sum(dim=0) / (T * k)
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
    """Oracle implementation. On a mesh each rank runs it on its batch rows
    (``_moe_dense_local``)."""
    if isinstance(x, DTensor):
        return _moe_dense_local(p, x, cfg)
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    top_p, top_e, probs = _route(p["router"], xt, cfg)
    out = _combine_dense(p, xt, top_p, top_e, cfg)
    aux = _aux_loss(probs, top_e, cfg.num_experts)
    return out.reshape(B, S, D), aux


def _combine_dense(p, xt, top_p, top_e, cfg: ArchConfig):
    ted = _expert_ffn_dense(p["w_gate"], p["w_up"], p["w_down"], xt)   # (T, E, D)
    # The reference's einsum("tk,tke->te", top_p, one_hot(top_e)): a token's k
    # experts are distinct, so each (t, e) takes exactly one weight or none.
    experts = torch.arange(cfg.num_experts, device=xt.device)
    onehot = (top_e[..., None] == experts).to(torch.float32)            # (T, k, E)
    w = torch.einsum("tk,tke->te", top_p, onehot).to(ted.dtype)
    out = torch.einsum("te,ted->td", w, ted)
    if cfg.num_shared_experts:
        out = out + _shared_expert(p, xt)
    return out


def _moe_dense_local(p, x: DTensor, cfg: ArchConfig):
    """The oracle on each rank's batch rows, every expert gathered: a
    ``local_map`` of the reference's per-token arithmetic. Its balance loss
    is the reference's over every token: the counts and router
    probabilities are summed over the batch shards before they meet."""
    mesh = current_mesh()
    B, S, D = x.shape
    rows = {a: 0 for a, d in shard_dims(x, mesh).items() if d == 0}
    red = tuple(rows)
    xl = local_in(x, mesh, rows)
    pl = {k: local_in(v, mesh, {}, grad_partial=red) for k, v in p.items()
          if k in ("router", "w_gate", "w_up", "w_down", "s_gate", "s_up", "s_down")}
    xt = xl.reshape(-1, D)
    top_p, top_e, probs = _route(pl["router"], xt, cfg)
    out = _combine_dense(pl, xt, top_p, top_e, cfg)
    E, k = cfg.num_experts, cfg.experts_per_token
    experts = torch.arange(E, device=xt.device)
    counts = global_out((top_e.reshape(-1)[:, None] == experts).float().sum(dim=0),
                        mesh, {}, red)
    prob_sums = global_out(probs.sum(dim=0), mesh, {}, red)
    T = B * S
    aux = E * torch.sum((counts / (T * k)) * (prob_sums / T))
    return global_out(out.reshape(-1, S, D), mesh, rows), aux


def _dispatch(top_p, top_e, cfg: ArchConfig, e_lo: int, e_local: int, capacity: int,
              sizes: bool = True):
    """The assignments this shard computes, grouped by expert: returns their
    tokens (C,), weights (C,) fp32 (0 where invalid) and the group sizes
    (e_local,), None without `sizes` (the flop-exact stand-in needs none).
    The sort is stable, as the reference's ``jnp.argsort``: its order decides
    which assignments the capacity cut drops."""
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
    if not sizes:
        return sel_t, sel_p, None
    group_sizes = torch.bincount(sel_e, minlength=e_local + 1)[:e_local]
    return sel_t, sel_p, group_sizes


def _grouped_ffn(xe, w_gate, w_up, w_down, group_sizes, every_row: bool = False):
    """The expert FFN over grouped rows: rows [o_e, o_e + n_e) of xe (C, D)
    through expert e, as the reference's three ``ragged_dot``s. Rows past the
    groups give zeros; ``every_row`` says the groups cover all C rows (one
    shard, every assignment kept), so none is left to zero. bf16 CUDA tensors
    take one grouped product a weight, ``torch._grouped_mm`` with the group
    offsets on the device: no copy to the host and a few launches a layer,
    where the loop takes six an expert, so the card sets the pace. The rest
    (the CPU, fp32) take ``_looped_ffn``."""
    if not (xe.is_cuda and xe.dtype == torch.bfloat16):
        return _looped_ffn(xe, w_gate, w_up, w_down, group_sizes)
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    h = F.silu(torch._grouped_mm(xe, w_gate, offs=offs)) * torch._grouped_mm(
        xe, w_up, offs=offs)
    ye = torch._grouped_mm(h, w_down, offs=offs)
    if every_row:
        return ye
    past = torch.arange(xe.shape[0], device=xe.device) >= offs[-1]
    return ye.masked_fill_(past[:, None], 0)         # rows past the groups are not written


def _looped_ffn(xe, w_gate, w_up, w_down, group_sizes):
    """``_grouped_ffn`` as a loop over the experts through ``torch.matmul``,
    with one device-to-host copy of the group sizes a call, counted as a
    ``host_syncs`` on the open spans."""
    ye = torch.zeros((xe.shape[0], w_down.shape[-1]), dtype=xe.dtype, device=xe.device)
    start = 0
    spans.count("host_syncs")
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            xs = xe[start:start + n]
            h = F.silu(xs @ w_gate[e]) * (xs @ w_up[e])
            ye[start:start + n] = h @ w_down[e]
            start += n
    return ye


def _exact_ffn(xe, w_gate, w_up, w_down):
    """The reference's ``exact_flops`` stand-in for ``ragged_dot`` (``a @ w[0]``):
    the grouped product's operand and result shapes and its true flops, for the
    roofline; numerically not the grouped product."""
    h = F.silu(xe @ w_gate[0]) * (xe @ w_up[0])
    return h @ w_down[0]


def _local_expert_pass(xl, router_w, w_gate, w_up, w_down, cfg: ArchConfig,
                       e_lo: int, e_local: int, capacity: int,
                       exact_flops: bool = False):
    """Tokens xl (T, D) against the local expert group [e_lo, e_lo + e_local)."""
    T, D = xl.shape
    top_p, top_e, probs = _route(router_w, xl, cfg)
    sel_t, sel_p, group_sizes = _dispatch(top_p, top_e, cfg, e_lo, e_local, capacity,
                                          sizes=not exact_flops)
    if exact_flops:
        ye = _exact_ffn(xl[sel_t], w_gate, w_up, w_down)                 # (C, D)
    else:
        # every assignment is this shard's, and the first `capacity` of them are kept
        every_row = e_local == cfg.num_experts and capacity <= T * cfg.experts_per_token
        ye = _grouped_ffn(xl[sel_t], w_gate, w_up, w_down, group_sizes,   # (C, D)
                          every_row=every_row)
    out = torch.zeros((T, D), dtype=ye.dtype, device=ye.device)
    out.index_add_(0, sel_t, ye * sel_p[:, None].to(ye.dtype))
    aux = _aux_loss(probs, top_e, cfg.num_experts)
    return out, aux


def _capacity(tokens: int, cfg: ArchConfig, ep: int) -> int:
    c = int(tokens * cfg.experts_per_token * cfg.moe_capacity_factor / ep)
    c = -(-c // 128) * 128
    return min(max(c, 128), tokens * cfg.experts_per_token)


def _moe_single_shard(p, x, cfg: ArchConfig, exact_flops: bool):
    """The reference's single-shard path (ep = 1)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    out, aux = _local_expert_pass(
        xt, p["router"], p["w_gate"], p["w_up"], p["w_down"], cfg,
        0, cfg.num_experts, _capacity(xt.shape[0], cfg, 1),
        exact_flops=exact_flops,
    )
    if cfg.num_shared_experts:
        out = out + _shared_expert(p, xt)
    return out.reshape(B, S, D), aux


def moe_ep_ff(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
              exact_flops: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """EP over `model` + TP-within-expert over `data` (decode/serving variant).

    Under serve_fsdp_tp the expert weights are data-sharded, so the plain EP path
    must ALL-GATHER gigabytes of expert weights every layer to process a few hundred
    decode tokens. Here weights stay sharded on their ff dim; the (tiny) token
    activations replicate over `data` instead, each data shard computes its ff
    slice, and one small (C, D) psum over data+model combines — GBs of weight
    traffic become MBs of activation traffic.
    """
    B, S, D = x.shape
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.shape:
        return moe_ep(p, x, cfg, exact_flops)
    ep = mesh.shape["model"]
    Fm = cfg.moe_d_ff
    data_axes: tuple = ()
    prod = 1
    for a in ("pod", "data"):
        if a in mesh.shape and Fm % (prod * mesh.shape[a]) == 0:
            data_axes += (a,)
            prod *= mesh.shape[a]
    if not data_axes or cfg.num_experts % ep != 0:
        return moe_ep(p, x, cfg, exact_flops)

    e_local = cfg.num_experts // ep
    tokens = B * S
    capacity = _capacity(tokens, cfg, ep)
    red = ("model",) + data_axes
    # in_specs: x and the router replicated; w_gate/w_up experts x D x ff-shard;
    # w_down experts x ff-shard x D
    xl = local_in(x, mesh, {}, grad_partial=red)
    router_w = local_in(p["router"], mesh, {}, grad_partial=red)
    w_gate = local_in(p["w_gate"], mesh, {"model": 0, **{a: 2 for a in data_axes}})
    w_up = local_in(p["w_up"], mesh, {"model": 0, **{a: 2 for a in data_axes}})
    w_down = local_in(p["w_down"], mesh, {"model": 0, **{a: 1 for a in data_axes}})

    xt = xl.reshape(-1, D)
    j = mesh.get_local_rank("model")
    top_p, top_e, probs = _route(router_w, xt, cfg)
    sel_t, sel_p, gs = _dispatch(top_p, top_e, cfg, j * e_local, e_local, capacity,
                                 sizes=not exact_flops)
    xe = xt[sel_t]
    if exact_flops:
        ye = _exact_ffn(xe, w_gate, w_up, w_down)                        # partial (C, D)
    else:
        ye = _grouped_ffn(xe, w_gate, w_up, w_down, gs)
    out = torch.zeros((xt.shape[0], D), dtype=ye.dtype, device=ye.device)
    out.index_add_(0, sel_t, ye * sel_p[:, None].to(ye.dtype))
    out = global_out(out.reshape(B, S, D), mesh, {}, red)
    aux = global_out(_aux_loss(probs, top_e, cfg.num_experts), mesh, {}, red, mean=True)
    if cfg.num_shared_experts:
        xt = x.reshape(-1, D)
        out = out + _shared_expert(p, xt).reshape(B, S, D)
    return constrain(out, ("batch", "seq", "embed")), aux


def moe_ep(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
           exact_flops: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel implementation (EP over the ``model`` axis when meshed).

    On a mesh where EP does not apply (``model`` extent 1, or one that does
    not divide the expert count) the single-shard path runs on the whole
    batch, as GSPMD runs the reference's: its capacity counts every token,
    so a DTensor batch is gathered first."""
    B, S, D = x.shape
    mesh = current_mesh()
    ep = mesh.shape.get("model", 1) if mesh is not None else 1

    if mesh is None or ep == 1 or cfg.num_experts % ep != 0:
        if mesh is None or not isinstance(x, DTensor):
            return _moe_single_shard(p, x, cfg, exact_flops)
        names = ("router", "w_gate", "w_up", "w_down", "s_gate", "s_up", "s_down")
        pl = {k: local_in(v, mesh, {}) for k, v in p.items() if k in names}
        out, aux = _moe_single_shard(pl, local_in(x, mesh, {}), cfg, exact_flops)
        return global_out(out, mesh, {}, ()), global_out(aux, mesh, {}, ())

    rules = current_rules() or {}
    batch_rule = rules.get("batch", ("pod", "data"))
    if isinstance(batch_rule, str):
        batch_rule = (batch_rule,)
    batch_axes: tuple = ()
    dp = 1
    for a in batch_rule or ():
        # "model" is owned by expert parallelism inside this layer
        if a != "model" and a in mesh.shape and B % (dp * mesh.shape[a]) == 0:
            batch_axes += (a,)
            dp *= mesh.shape[a]
    tokens_local = max((B // dp) * S, 1)
    e_local = cfg.num_experts // ep
    capacity = _capacity(tokens_local, cfg, ep)

    # in_specs: x batch-sharded, the router replicated, the experts over model;
    # the gradients of the replicated operands are summed over the ranks that
    # share them with other tokens or other experts
    x_dims = {a: 0 for a in batch_axes}
    xl = local_in(x, mesh, x_dims, grad_partial=("model",))
    router_w = local_in(p["router"], mesh, {}, grad_partial=("model",) + batch_axes)
    w = {k: local_in(p[k], mesh, {"model": 0}, grad_partial=batch_axes)
         for k in ("w_gate", "w_up", "w_down")}
    Bl, Sl, _ = xl.shape
    j = mesh.get_local_rank("model")
    out, aux = _local_expert_pass(
        xl.reshape(-1, D), router_w, w["w_gate"], w["w_up"], w["w_down"], cfg,
        j * e_local, e_local, capacity, exact_flops=exact_flops,
    )
    out = global_out(out.reshape(Bl, Sl, D), mesh, x_dims, ("model",))
    aux = global_out(aux, mesh, {}, ("model",) + batch_axes, mean=True)
    if cfg.num_shared_experts:
        xt = x.reshape(-1, D)
        out = out + _shared_expert(p, xt).reshape(B, S, D)
    return constrain(out, ("batch", "seq", "embed")), aux


def moe_layer(p, x, cfg: ArchConfig, impl: str = "ep"):
    if impl == "dense":
        return moe_dense(p, x, cfg)
    if impl == "ep_exact":
        return moe_ep(p, x, cfg, exact_flops=True)
    if impl == "ep_ff":
        return moe_ep_ff(p, x, cfg)
    if impl == "ep_ff_exact":
        return moe_ep_ff(p, x, cfg, exact_flops=True)
    return moe_ep(p, x, cfg)
