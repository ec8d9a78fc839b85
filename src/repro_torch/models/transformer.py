"""Model assembly: init, embedding, full-sequence forward, and cached decode.

The port of ``repro/models/transformer.py`` for three kinds of model:

  * attention families (dense / moe / vlm / audio): pre-norm blocks with GQA
    attention (full / sliding_global / bidirectional) and an MLP or an MoE
    feed-forward; MoE models may carry leading dense layers as a separate
    stack (kimi-k2's ``dense_stack``);
  * hybrid (zamba2): Mamba2 layers with a SHARED attention+MLP block invoked
    every ``ssm_attn_every`` layers (weights shared across invocations, one KV
    cache per invocation);
  * ssm (rwkv6): RWKV6 blocks, attention-free, with an O(1) recurrent state
    per layer;
  * hybrid_moe (granite-4.0-h): a mixer a layer, Mamba2 or NoPE GQA attention
    (``cfg.attention_layers``), each followed by a MoE with a shared expert,
    granite's multipliers on the embeddings, residual branches and logits.

Parameters keep the reference's tree and its layer-stacked ``(L, ...)``
layout, so ``repro_torch.interop.from_reference`` maps one tree onto the
other key for key. The reference's ``lax.scan`` over layers becomes a Python
loop over per-layer views of the stacked parameters, and its
``jax.checkpoint`` of the scan body (``remat``) a per-layer
``torch.utils.checkpoint`` (``core/offload.py::remat``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.core.offload import offload_checkpoint_policy, remat
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (constrain, current_mesh, current_rules,
                                              gather_fsdp, global_out, local_in,
                                              shard_dims)
from repro_torch.models import attention as attn
from repro_torch.models import layers as ll
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6 as rk
from repro_torch.models.layers import dtype_of

BIG_WINDOW = np.int32(2**30)


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Implementation knobs, field for field the reference's."""

    attn_impl: str = "xla"          # xla | flash
    moe_impl: str = "ep"            # ep | dense
    wkv_impl: str = "chunked"       # chunked | ref | pallas
    ssd_impl: str = "chunked"
    remat: str = "none"             # none | full | offload
    offload_names: Tuple[str, ...] = ("residual",)
    scan_layers: bool = True
    sliding_ring: bool = False
    decode_flash_layout: bool = False
    unroll_scans: bool = False


# ------------------------------------------------------------------------- windows
def layer_windows(cfg: ArchConfig, stack_size: int, offset: int = 0) -> np.ndarray:
    """Per-layer attention windows (int32); BIG_WINDOW means full attention."""
    if cfg.attention_kind == "sliding_global" and cfg.global_every:
        idx = np.arange(offset, offset + stack_size)
        return np.where(
            (idx + 1) % cfg.global_every == 0, BIG_WINDOW, np.int32(cfg.sliding_window)
        ).astype(np.int32)
    if cfg.attention_kind == "full" or cfg.family in ("vlm", "audio"):
        return np.full((stack_size,), BIG_WINDOW, np.int32)
    if cfg.sliding_window:
        return np.full((stack_size,), cfg.sliding_window, np.int32)
    return np.full((stack_size,), BIG_WINDOW, np.int32)


# ------------------------------------------------------------------------- init
def _init_attn_stack(gen, cfg: ArchConfig, L: int, use_moe: bool, dtype, device):
    D, F = cfg.d_model, cfg.d_ff
    N, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p: Dict[str, Any] = {
        "ln1": ll.zeros((L, D), dtype, device),
        "ln2": ll.zeros((L, D), dtype, device),
        "attn": attn.init_attention(gen, L, D, N, K, hd, cfg.qk_norm, dtype, device),
    }
    if cfg.post_norms:
        p["post_ln1"] = ll.zeros((L, D), dtype, device)
        p["post_ln2"] = ll.zeros((L, D), dtype, device)
    if use_moe:
        p["moe"] = moe_lib.init_moe(gen, L, cfg, dtype, device)
    else:
        p["mlp"] = ll.init_mlp(gen, L, D, F, cfg.mlp_activation, dtype, device)
    return p


def _tied(cfg: ArchConfig) -> bool:
    return cfg.tie_embeddings and cfg.input_mode == "tokens"


def _first_dense(cfg: ArchConfig) -> int:
    """Leading dense layers of an MoE model (kimi-k2: 1), 0 otherwise."""
    return cfg.moe_first_dense if cfg.moe else 0


def init_params(gen: torch.Generator, cfg: ArchConfig, device="cuda") -> Dict[str, Any]:
    """Random parameters for `cfg`, drawn from `gen` on `device`.

    `gen` must live on `device` (``torch.Generator(device=...)``). The draws
    differ from the reference's ``jax.random`` streams; parity tests carry the
    reference's parameters across with ``repro_torch.interop`` instead. On
    ``device="meta"`` the tree holds shapes only and `gen` may be None (the
    specs' route, ``launch/specs.py``)."""
    dev = resolve_device(device, shapes_only=True)
    dtype = dtype_of(cfg.param_dtype)
    D, V, L = cfg.d_model, cfg.padded_vocab, cfg.num_layers
    params: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        # std 1/sqrt(D): keeps tied logits O(1) and scale_embedding outputs ~N(0,1)
        params["embed"] = ll.trunc_normal(gen, (V, D), math.sqrt(V / D), dtype, dev)
    if cfg.family == "ssm":
        params["blocks"] = rk.init_rwkv6(gen, L, cfg, dtype, dev)
    elif cfg.family == "hybrid":
        params["blocks"] = m2.init_mamba2(gen, L, cfg, dtype, dev)
        params["shared_attn"] = _init_attn_stack(gen, cfg, 1, False, dtype, dev)
    elif cfg.family == "hybrid_moe":
        n_attn = len(cfg.attention_layers)
        params["stack"] = {"ln1": ll.zeros((L, D), dtype, dev),
                           "ln2": ll.zeros((L, D), dtype, dev),
                           "moe": moe_lib.init_moe(gen, L, cfg, dtype, dev)}
        params["mamba"] = m2.init_mamba2(gen, L - n_attn, cfg, dtype, dev)
        params["attn"] = attn.init_attention(gen, n_attn, D, cfg.num_heads, cfg.num_kv_heads,
                                             cfg.resolved_head_dim, cfg.qk_norm, dtype, dev)
    else:
        L1 = _first_dense(cfg)
        if L1:
            params["dense_stack"] = _init_attn_stack(gen, cfg, L1, False, dtype, dev)
        params["stack"] = _init_attn_stack(gen, cfg, L - L1, cfg.moe, dtype, dev)
    params["final_norm"] = ll.zeros((D,), dtype, dev)
    if not _tied(cfg):
        params["unembed"] = ll.trunc_normal(gen, (D, V), 1.0, dtype, dev)
    return params


# ------------------------------------------------------------------------- axes
def _attn_stack_axes(cfg: ArchConfig, use_moe: bool):
    ax: Dict[str, Any] = {
        "ln1": ("layers", None),
        "ln2": ("layers", None),
        "attn": {
            "wq": ("layers", "fsdp", "heads", None),
            "wk": ("layers", "fsdp", "kv_heads", None),
            "wv": ("layers", "fsdp", "kv_heads", None),
            "wo": ("layers", "heads", None, "fsdp"),
        },
    }
    if cfg.qk_norm:
        ax["attn"]["q_norm"] = ("layers", None)
        ax["attn"]["k_norm"] = ("layers", None)
    if cfg.post_norms:
        ax["post_ln1"] = ("layers", None)
        ax["post_ln2"] = ("layers", None)
    if use_moe:
        ax["moe"] = {
            "router": ("layers", None, None),
            "w_gate": ("layers", "experts", "fsdp", "expert_ff"),
            "w_up": ("layers", "experts", "fsdp", "expert_ff"),
            "w_down": ("layers", "experts", "expert_ff", "fsdp"),
        }
        if cfg.num_shared_experts:
            ax["moe"]["s_gate"] = ("layers", "fsdp", "ff")
            ax["moe"]["s_up"] = ("layers", "fsdp", "ff")
            ax["moe"]["s_down"] = ("layers", "ff", "fsdp")
    else:
        mats = (
            {"w_gate", "w_up", "w_down"}
            if cfg.mlp_activation in ("swiglu", "gelu_glu")
            else {"w_up", "w_down"}
        )
        ax["mlp"] = {
            m: (("layers", "ff", "fsdp") if m == "w_down" else ("layers", "fsdp", "ff"))
            for m in mats
        }
    return ax


def param_axes(cfg: ArchConfig) -> Dict[str, Any]:
    """Pytree of logical-axis tuples mirroring init_params' structure."""
    axes: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        axes["embed"] = ("vocab", "fsdp")
    if cfg.family == "ssm":
        axes["blocks"] = {
            "mu": ("layers", None, None),
            "wr": ("layers", "fsdp", "heads_merged"),
            "wk": ("layers", "fsdp", "heads_merged"),
            "wv": ("layers", "fsdp", "heads_merged"),
            "wg": ("layers", "fsdp", "heads_merged"),
            "wo": ("layers", "heads_merged", "fsdp"),
            "w0": ("layers", None),
            "wA": ("layers", "fsdp", None),
            "wB": ("layers", None, None),
            "u": ("layers", "heads", None),
            "ln_x": ("layers", None),
            "cmu": ("layers", None, None),
            "ck": ("layers", "fsdp", "ff"),
            "cv": ("layers", "ff", "fsdp"),
            "cr": ("layers", "fsdp", "heads_merged"),
        }
    elif cfg.family in ("hybrid", "hybrid_moe"):
        mamba = {
            "in_proj": ("layers", "fsdp", "heads_merged"),
            "conv_w": ("layers", None, "heads_merged"),
            "conv_b": ("layers", "heads_merged"),
            "A_log": ("layers", None),
            "D": ("layers", None),
            "dt_bias": ("layers", None),
            "norm": ("layers", "heads_merged"),
            "out_proj": ("layers", "heads_merged", "fsdp"),
        }
        if cfg.family == "hybrid":
            axes["blocks"] = mamba
            axes["shared_attn"] = _attn_stack_axes(cfg, use_moe=False)
        else:
            stack = _attn_stack_axes(cfg, use_moe=True)
            axes["attn"] = stack.pop("attn")
            axes["stack"] = stack
            axes["mamba"] = mamba
    else:
        if cfg.moe and cfg.moe_first_dense:
            axes["dense_stack"] = _attn_stack_axes(cfg, use_moe=False)
        axes["stack"] = _attn_stack_axes(cfg, cfg.moe)
    axes["final_norm"] = (None,)
    if not (cfg.tie_embeddings and cfg.input_mode == "tokens"):
        axes["unembed"] = ("fsdp", "vocab")
    return axes


# ------------------------------------------------------------------------- embed
def embed_inputs(params, cfg: ArchConfig, inputs: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S), or embeddings (B, S, D) for the vlm/audio frontend
    stubs, -> activations (B, S, D) in the config's dtype."""
    dtype = dtype_of(cfg.dtype)
    if cfg.input_mode == "tokens":
        rules = current_rules() or {}
        if current_mesh() is not None and rules.get("vocab") is not None:
            # one-hot matmul lookup: a gather against a 2D-sharded table would
            # all-gather the whole embedding; the one-hot product stays
            # vocab-sharded and reduces with one small all-reduce. It gives the
            # gathered rows exactly (one nonzero product a sum).
            V = params["embed"].shape[0]
            vocab = torch.arange(V, device=inputs.device)
            oh = (inputs[..., None] == vocab).to(params["embed"].dtype)
            oh = constrain(oh, ("batch", None, "vocab"))
            h = (oh @ gather_fsdp(params["embed"])).to(dtype)
        elif isinstance(inputs, DTensor):
            # each rank looks its own tokens up in the replicated table
            mesh = current_mesh()
            dims = shard_dims(inputs, mesh)
            table = local_in(params["embed"], mesh, {}, grad_partial=tuple(dims))
            h = global_out(table[inputs.to_local()], mesh, dims).to(dtype)
        else:
            h = params["embed"][inputs].to(dtype)
    else:
        h = inputs.to(dtype)
    if cfg.scale_embedding:
        # The reference rounds sqrt(d_model) to the activation dtype before
        # multiplying (sqrt(1152) = 33.94 becomes 34.0 in bf16); so does this.
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype).item()
    if cfg.embedding_multiplier != 1.0:
        h = h * cfg.embedding_multiplier
    return constrain(h, ("batch", "seq", "embed"))


def unembed(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + vocab projection (over ``logits_scaling``); padded vocab
    entries are masked to -1e30."""
    h = ll.rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    w = gather_fsdp(params["embed"]).T if _tied(cfg) else gather_fsdp(params["unembed"])
    logits = (h @ w.to(h.dtype)).float()
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad_mask, -1e30)
    return constrain(logits, ("batch", None, "vocab"))


# ------------------------------------------------------------------------- blocks
def _layer(tree, i: int):
    """Layer `i`'s view of a layer-stacked parameter (or state) tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _layers(tree, n: int):
    """Every layer's view of a layer-stacked parameter tree, cut with one
    ``unbind`` a leaf: its backward stacks the layers' gradients once, where
    indexing each layer (``_layer``) builds a zero gradient of the whole
    stack for every layer and sums them."""
    cut = {k: _layers(v, n) if isinstance(v, dict) else torch.unbind(v, 0)
           for k, v in tree.items()}
    return [{k: v[i] for k, v in cut.items()} for i in range(n)]


def _finish_block(p, h, a_out, cfg: ArchConfig, moe_impl: str = "ep"):
    """The rest of a pre-norm block after attention: residual, norm, and the
    MLP, or the MoE layer where the block has one. Returns (h, aux), aux the
    MoE balance loss, None for an MLP (no zero tensor made on the card)."""
    if cfg.post_norms:
        a_out = ll.rms_norm(a_out, p["post_ln1"])
    h = h + a_out
    x = ll.rms_norm(h, p["ln2"])
    aux = None
    if "moe" in p:
        f_out, aux = moe_lib.moe_layer(p["moe"], x, cfg, impl=moe_impl)
    else:
        f_out = ll.mlp(p["mlp"], x, cfg.mlp_activation)
    if cfg.post_norms:
        f_out = ll.rms_norm(f_out, p["post_ln2"])
    return h + f_out, aux


def _attn_block_body(p, h, window: int, cfg: ArchConfig, opts: ModelOptions):
    """One pre-norm block over the full sequence. Returns (h, aux, (k, v)),
    aux as ``_finish_block`` gives it."""
    p = gather_fsdp(p)
    a_out, kv = attn.full_attention(
        p["attn"], ll.rms_norm(h, p["ln1"]),
        window=window, causal=cfg.causal, theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm, attn_impl=opts.attn_impl,
    )
    h, aux = _finish_block(p, h, a_out, cfg, opts.moe_impl)
    return h, aux, kv


def _layer_runner(opts: ModelOptions, device, offload: bool = True):
    """How a layer body runs: directly, or checkpointed per layer as the
    reference's ``jax.checkpoint`` of its scan body. With ``remat="offload"``
    the checkpoint keeps each layer's input, the reference's ``"residual"``,
    in the host tier; `offload` False keeps it on the device, as the
    reference's hybrid body, which it checkpoints with no policy."""
    if opts.remat == "none":
        return lambda fn, *args: fn(*args)
    if opts.remat not in ("full", "offload"):
        raise ValueError(f"unknown remat {opts.remat!r}")
    policy = None
    if opts.remat == "offload" and offload:
        policy = offload_checkpoint_policy(opts.offload_names, device)
    return lambda fn, *args: remat(fn, policy=policy)(*args)


def _use_attn(cfg: ArchConfig):
    """Hybrid: whether layer i is followed by the shared attention block."""
    return [(i + 1) % cfg.ssm_attn_every == 0 for i in range(cfg.num_layers)]


# ------------------------------------------------------------------------- forward
def forward(params, cfg: ArchConfig, inputs: torch.Tensor,
            opts: ModelOptions = ModelOptions(), collect_kv: bool = False,
            last_only: bool = False):
    """Full-sequence forward. Returns (logits, aux_loss, caches) — caches is a dict
    of per-family prefill state when collect_kv (decode bootstrap). ``last_only``
    computes logits for the final position only (serving prefill: avoids the
    (B, S, V) logit tensor entirely). aux_loss is the MoE balance loss summed
    over the MoE layers (0 for the other families). ``opts.remat`` "full"
    or "offload" checkpoints each layer body, as the reference does. The call
    is one ``forward`` span (``repro_torch.spans``; a null context while
    nothing records)."""
    with spans.span("forward"):
        return _forward(params, cfg, inputs, opts, collect_kv, last_only)


def _forward(params, cfg: ArchConfig, inputs, opts: ModelOptions, collect_kv: bool,
             last_only: bool):
    h = embed_inputs(params, cfg, inputs)
    caches: Dict[str, Any] = {}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "ssm":
        h, caches = _ssm_forward(params, cfg, h, opts, collect_kv)
    elif cfg.family == "hybrid":
        h, caches = _hybrid_forward(params, cfg, h, opts, collect_kv)
    elif cfg.family == "hybrid_moe":
        h, aux, caches = _hybrid_moe_forward(params, cfg, h, opts, collect_kv)
    else:
        run = _layer_runner(opts, h.device)
        L1 = _first_dense(cfg)
        stacks = [("dense_stack", "dense_kv", layer_windows(cfg, L1, 0))] if L1 else []
        stacks.append(("stack", "kv", layer_windows(cfg, cfg.num_layers - L1, L1)))
        for name, cache_key, windows in stacks:
            ks, vs = [], []
            layers = _layers(params[name], len(windows))
            for p, window in zip(layers, windows, strict=True):
                h, a, (k, v) = run(
                    lambda hh, p=p, w=int(window): _attn_block_body(p, hh, w, cfg, opts), h)
                if a is not None:
                    aux = aux + a
                if collect_kv:
                    ks.append(k)
                    vs.append(v)
            if collect_kv:
                caches[cache_key] = (torch.stack(ks), torch.stack(vs))
    if last_only:
        h = h[:, -1:]
    logits = unembed(params, cfg, h)
    return logits, aux, caches


def _stack_states(states):
    """Per-layer state dicts -> one dict of (L, ...) tensors."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _ssm_forward(params, cfg: ArchConfig, h, opts: ModelOptions, collect_kv: bool):
    """RWKV6: every layer starts from a zero state; caches {"rwkv": {"tm_x",
    "cm_x", "wkv"}} stacked over L when collect_kv."""
    state = rk.rwkv6_init_state(cfg, h.shape[0], h.dtype, h.device)
    run = _layer_runner(opts, h.device)
    states = []
    for p in _layers(params["blocks"], cfg.num_layers):
        h, st = run(lambda hh, p=p: rk.rwkv6_block(gather_fsdp(p), hh, state, cfg,
                                                        impl=opts.wkv_impl), h)
        if collect_kv:
            states.append(st)
    return h, ({"rwkv": _stack_states(states)} if collect_kv else {})


def _hybrid_forward(params, cfg: ArchConfig, h, opts: ModelOptions, collect_kv: bool):
    """Zamba2: Mamba2 layers; the shared attention block every ssm_attn_every."""
    state = m2.mamba2_init_state(cfg, h.shape[0], h.dtype, h.device)
    shared = _layer(params["shared_attn"], 0)                    # strip L=1
    run = _layer_runner(opts, h.device, offload=False)

    def body(p, attn_here, hh):
        out, st = m2.mamba2_block(gather_fsdp(p), hh, state, cfg, impl=opts.ssd_impl)
        hh = hh + out
        kv = None
        if attn_here:
            hh, _, kv = _attn_block_body(shared, hh, int(BIG_WINDOW), cfg, opts)
        return hh, st, kv

    states, ks, vs = [], [], []
    layers = _layers(params["blocks"], cfg.num_layers)
    for p, attn_here in zip(layers, _use_attn(cfg), strict=True):
        h, st, kv = run(lambda hh, p=p, a=attn_here: body(p, a, hh), h)
        if collect_kv:
            states.append(st)
            if attn_here:
                ks.append(kv[0])
                vs.append(kv[1])
    caches: Dict[str, Any] = {}
    if collect_kv:
        caches = {"mamba": _stack_states(states),
                  "shared_kv": (torch.stack(ks), torch.stack(vs))}
    return h, caches


def _hybrid_moe_forward(params, cfg: ArchConfig, h, opts: ModelOptions, collect_kv: bool):
    """Granite-4.0-H: in each layer ``h += r * mixer(norm(h))``, the mixer Mamba2
    or, in ``cfg.attention_layers``, causal GQA attention (no RoPE where
    ``use_rope`` is off, scores times ``attention_multiplier``); then
    ``h += r * (moe(x) + shared(x))`` with ``x = norm(h)``, r the
    ``residual_multiplier``. Spans ``forward.mamba``, ``forward.attention`` and
    ``forward.moe``. Returns (h, aux, caches): caches {"kv": the attention
    layers' (K, V) stacked in order, "mamba": {"conv", "ssd"} stacked over the
    Mamba2 layers} when collect_kv."""
    L, attn_at = cfg.num_layers, set(cfg.attention_layers)
    n_attn = len(attn_at)
    mamba_layers = iter(_layers(params["mamba"], L - n_attn))
    attn_layers = iter(_layers(params["attn"], n_attn))
    state = m2.mamba2_init_state(cfg, h.shape[0], h.dtype, h.device)
    run = _layer_runner(opts, h.device)
    r, eps = cfg.residual_multiplier, cfg.rms_norm_eps
    theta = cfg.rope_theta if cfg.use_rope else None
    scale = cfg.attention_multiplier or None

    def body(p, mixer, is_attn, hh):
        p, mixer = gather_fsdp(p), gather_fsdp(mixer)
        x = ll.rms_norm(hh, p["ln1"], eps)
        kv = st = None
        if is_attn:
            with spans.span("forward.attention"):
                out, kv = attn.full_attention(mixer, x, window=int(BIG_WINDOW), causal=True,
                                              theta=theta, qk_norm=cfg.qk_norm,
                                              attn_impl=opts.attn_impl, scale=scale)
        else:
            with spans.span("forward.mamba"):
                out, st = m2.mamba2_block(mixer, x, state, cfg, impl=opts.ssd_impl, eps=eps)
        hh = hh + out * r
        with spans.span("forward.moe"):
            f_out, a = moe_lib.moe_layer(p["moe"], ll.rms_norm(hh, p["ln2"], eps), cfg,
                                         impl=opts.moe_impl)
        return hh + f_out * r, a, kv, st

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    states, ks, vs = [], [], []
    for i, p in enumerate(_layers(params["stack"], L)):
        is_attn = i in attn_at
        mixer = next(attn_layers if is_attn else mamba_layers)
        h, a, kv, st = run(lambda hh, p=p, m=mixer, a=is_attn: body(p, m, a, hh), h)
        aux = aux + a
        if collect_kv:
            if is_attn:
                ks.append(kv[0])
                vs.append(kv[1])
            else:
                states.append(st)
    caches: Dict[str, Any] = {}
    if collect_kv:
        caches = {"kv": (torch.stack(ks), torch.stack(vs)), "mamba": _stack_states(states)}
    return h, aux, caches


# ------------------------------------------------------------------------- loss
def loss_fn(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            opts: ModelOptions = ModelOptions()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token (decoder) or frame-target (encoder) cross entropy + MoE aux.

    The reference's arithmetic: the normalizer over ``logits - max`` with the
    max held constant (``.detach()`` for its ``stop_gradient``), the optional
    ``weights``, the z-loss ``1e-4 * mean(lse^2)``, and the aux loss times
    ``moe_aux_loss_coef``. Without a mesh the label logit is a gather where
    the reference sums an iota mask (its way of keeping vocab-sharded logits
    sharded): the same value, without a second (B, S, V) tensor. Under a
    mesh it is the reference's mask."""
    logits, aux, _ = forward(params, cfg, batch["inputs"], opts)
    labels = batch["targets"].long()
    weights = batch.get("weights")
    mx = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - mx), dim=-1)) + mx[..., 0]
    if current_mesh() is None:
        label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        # the reference's iota mask keeps vocab-sharded logits sharded
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        label_logit = torch.sum(
            torch.where(vocab == labels[..., None], logits, 0.0), dim=-1)
    nll = lse - label_logit
    if weights is None:
        weights = torch.ones_like(nll)
    ce = torch.sum(nll * weights) / torch.clamp(torch.sum(weights), min=1.0)
    # z-loss stabilizes the softmax normalizer at scale (reuses lse)
    zl = 1e-4 * torch.mean(torch.square(lse))
    # on a mesh the terms are partial sums and means over the batch shards:
    # replicate each (a scalar's logical axes are ()) before they meet
    ce, zl = constrain(ce, ()), constrain(zl, ())
    total = ce + zl + cfg.moe_aux_loss_coef * aux
    return total, {"ce": ce, "aux": aux, "z_loss": zl}


# ------------------------------------------------------------------------- decode
def _refuse_hybrid_moe_decode(cfg: ArchConfig) -> None:
    if cfg.family == "hybrid_moe":
        raise NotImplementedError(f"{cfg.name}: cached decode of the hybrid_moe stack is "
                                  "not built; forward() prefills it")


def init_decode_state(params, cfg: ArchConfig, batch: int, max_len: int,
                      dtype=None, sliding_ring: bool = False) -> Dict[str, Any]:
    """Empty caches for decode-from-scratch, on the parameters' device."""
    _refuse_hybrid_moe_decode(cfg)
    dev = params["final_norm"].device
    dtype = dtype or dtype_of(cfg.dtype)
    K, hd, L = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers

    def kv(n: int, T: int):
        return (torch.zeros((n, batch, T, K, hd), dtype=dtype, device=dev),
                torch.zeros((n, batch, T, K, hd), dtype=dtype, device=dev))

    state: Dict[str, Any] = {"lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if sliding_ring and cfg.attention_kind == "sliding_global":
        n_global = int((layer_windows(cfg, L) >= BIG_WINDOW).sum())
        state["kv_ring"] = kv(L, cfg.sliding_window)
        state["kv_global"] = kv(max(n_global, 1), max_len)
        return state
    if cfg.family == "ssm":
        one = rk.rwkv6_init_state(cfg, batch, dtype, dev)
        state["rwkv"] = {k: torch.zeros((L, *v.shape), dtype=v.dtype, device=dev)
                         for k, v in one.items()}
    elif cfg.family == "hybrid":
        one = m2.mamba2_init_state(cfg, batch, dtype, dev)
        state["mamba"] = {k: torch.zeros((L, *v.shape), dtype=v.dtype, device=dev)
                          for k, v in one.items()}
        state["shared_kv"] = kv(cfg.num_layers // cfg.ssm_attn_every, max_len)
    else:
        L1 = _first_dense(cfg)
        if L1:
            state["dense_kv"] = kv(L1, max_len)
        state["kv"] = kv(L - L1, max_len)
    return state


def decode_step(params, cfg: ArchConfig, state: Dict[str, Any], inputs: torch.Tensor,
                opts: ModelOptions = ModelOptions()):
    """One decode step. inputs: (B,1) tokens or (B,1,D) embeddings.

    Returns (logits (B, V), new_state). The new token's K/V is written into
    the caches of `state` in place, and `new_state` holds those same cache
    tensors (the reference returns new ones); lengths and the Mamba2 and
    RWKV6 states are new tensors."""
    _refuse_hybrid_moe_decode(cfg)
    h = embed_inputs(params, cfg, inputs)
    lengths = state["lengths"]
    new_state: Dict[str, Any] = {"lengths": lengths + 1}

    if cfg.family == "ssm":
        states = []
        for i in range(cfg.num_layers):
            h, st = rk.rwkv6_decode(gather_fsdp(_layer(params["blocks"], i)), h,
                                    _layer(state["rwkv"], i), cfg)
            states.append(st)
        new_state["rwkv"] = _stack_states(states)
    elif cfg.family == "hybrid":
        h = _hybrid_decode(params, cfg, state, h, new_state, opts)
    elif opts.sliding_ring and "kv_ring" in state:
        h = _sliding_ring_decode(params, cfg, state, h, new_state, opts)
    else:
        windows = layer_windows(cfg, cfg.num_layers)
        L1 = _first_dense(cfg)
        stacks = [("dense_stack", "dense_kv", windows[:L1])] if L1 else []
        stacks.append(("stack", "kv", windows[L1:]))
        for name, cache_key, wins in stacks:
            kc, vc = state[cache_key]
            for i, window in enumerate(wins):
                p = gather_fsdp(_layer(params[name], i))
                a_out, _, _ = attn.decode_attention(
                    p["attn"], ll.rms_norm(h, p["ln1"]), kc[i], vc[i], lengths,
                    window=int(window), theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                    flash_layout=opts.decode_flash_layout,
                )
                h, _ = _finish_block(p, h, a_out, cfg, opts.moe_impl)
            new_state[cache_key] = (kc, vc)

    logits = unembed(params, cfg, h)[:, 0]
    return logits, new_state


def _sliding_ring_decode(params, cfg: ArchConfig, state, h, new_state,
                         opts: ModelOptions):
    """Decode for sliding_global archs with ring caches on sliding layers and a
    COMPACT full-context cache holding only the global layers (counter-indexed,
    like zamba's shared-attention cache)."""
    lengths = state["lengths"]
    windows = layer_windows(cfg, cfg.num_layers)
    rk, rv = state["kv_ring"]
    gk, gv = state["kv_global"]
    g = 0
    for i in range(cfg.num_layers):
        p = gather_fsdp(_layer(params["stack"], i))
        x = ll.rms_norm(h, p["ln1"])
        if windows[i] >= BIG_WINDOW:
            a_out, _, _ = attn.decode_attention(
                p["attn"], x, gk[g], gv[g], lengths,
                window=int(BIG_WINDOW), theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                flash_layout=opts.decode_flash_layout,
            )
            g += 1
        else:
            a_out, _, _ = attn.decode_attention_ring(
                p["attn"], x, rk[i], rv[i], lengths, theta=cfg.rope_theta,
                qk_norm=cfg.qk_norm,
            )
        h, _ = _finish_block(p, h, a_out, cfg)
    new_state["kv_ring"] = (rk, rv)
    new_state["kv_global"] = (gk, gv)
    return h


def _hybrid_decode(params, cfg: ArchConfig, state, h, new_state, opts: ModelOptions):
    lengths = state["lengths"]
    shared = gather_fsdp(_layer(params["shared_attn"], 0))
    kbuf, vbuf = state["shared_kv"]
    states = []
    inv = 0
    for i, attn_here in enumerate(_use_attn(cfg)):
        out, st = m2.mamba2_decode(gather_fsdp(_layer(params["blocks"], i)), h,
                                   _layer(state["mamba"], i), cfg)
        h = h + out
        if attn_here:
            a_out, _, _ = attn.decode_attention(
                shared["attn"], ll.rms_norm(h, shared["ln1"]), kbuf[inv], vbuf[inv],
                lengths, window=int(BIG_WINDOW), theta=cfg.rope_theta,
                qk_norm=cfg.qk_norm, flash_layout=opts.decode_flash_layout,
            )
            h = h + a_out
            h = h + ll.mlp(shared["mlp"], ll.rms_norm(h, shared["ln2"]), cfg.mlp_activation)
            inv += 1
        states.append(st)
    new_state["mamba"] = _stack_states(states)
    new_state["shared_kv"] = (kbuf, vbuf)
    return h


# ------------------------------------------------------------------------- axes
def prefill_cache_axes(cfg: ArchConfig) -> Dict[str, Any]:
    """Logical axes for the caches returned by forward(collect_kv=True)."""
    kv_ax = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    if cfg.family == "ssm":
        return {
            "rwkv": {
                "tm_x": ("layers", "batch", None),
                "cm_x": ("layers", "batch", None),
                "wkv": ("layers", "batch", "heads", None, None),
            }
        }
    if cfg.family in ("hybrid", "hybrid_moe"):
        mamba = {"conv": ("layers", "batch", None, "heads_merged"),
                 "ssd": ("layers", "batch", "heads", None, "state")}
        key = "shared_kv" if cfg.family == "hybrid" else "kv"
        return {"mamba": mamba, key: (kv_ax, kv_ax)}
    ax: Dict[str, Any] = {"kv": (kv_ax, kv_ax)}
    if cfg.moe and cfg.moe_first_dense:
        ax["dense_kv"] = (kv_ax, kv_ax)
    return ax


def decode_state_axes(cfg: ArchConfig, sliding_ring: bool = False) -> Dict[str, Any]:
    """Logical axes for the decode state pytree (mirrors init_decode_state)."""
    kv_ax = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    ax: Dict[str, Any] = {"lengths": ("batch",)}
    if sliding_ring and cfg.attention_kind == "sliding_global":
        ring_ax = ("layers", "batch", None, "kv_heads", "head_dim")
        ax["kv_ring"] = (ring_ax, ring_ax)
        ax["kv_global"] = (kv_ax, kv_ax)
        return ax
    if cfg.family == "ssm":
        ax["rwkv"] = {
            "tm_x": ("layers", "batch", None),
            "cm_x": ("layers", "batch", None),
            "wkv": ("layers", "batch", "heads", None, None),
        }
    elif cfg.family == "hybrid":
        ax["mamba"] = {
            "conv": ("layers", "batch", None, "heads_merged"),
            "ssd": ("layers", "batch", "heads", None, "state"),
        }
        ax["shared_kv"] = (kv_ax, kv_ax)
    else:
        if cfg.moe and cfg.moe_first_dense:
            ax["dense_kv"] = (kv_ax, kv_ax)
        ax["kv"] = (kv_ax, kv_ax)
    return ax


# ------------------------------------------------------------------------- flops
def model_flops(cfg: ArchConfig, tokens: int, mode: str = "train") -> float:
    """MODEL_FLOPS: 6*N*D train / 2*N*D inference (N = active params)."""
    n = cfg.active_param_count()
    return (6.0 if mode == "train" else 2.0) * n * tokens
