"""Model assembly: init, embedding, full-sequence forward, and cached decode.

The port of ``repro/models/transformer.py`` for three kinds of model:

  * attention families (dense / vlm / audio): pre-norm blocks with GQA
    attention (full / sliding_global / bidirectional) and an MLP;
  * hybrid (zamba2): Mamba2 layers with a SHARED attention+MLP block invoked
    every ``ssm_attn_every`` layers (weights shared across invocations, one KV
    cache per invocation);
  * ssm (rwkv6): RWKV6 blocks, attention-free, with an O(1) recurrent state
    per layer.

Parameters keep the reference's tree and its layer-stacked ``(L, ...)``
layout, so ``repro_torch.interop.from_reference`` maps one tree onto the
other key for key. The reference's ``lax.scan`` over layers becomes a Python
loop over per-layer views of the stacked parameters. MoE raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as ll
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rk
from repro_torch.models.layers import dtype_of

BIG_WINDOW = np.int32(2**30)

# What is not ported yet, and the ROADMAP item that ports each.
_UNPORTED = {
    "moe": "ROADMAP A.7 (MoE)",
}


def require_ported(cfg: ArchConfig) -> None:
    """Raise unless the port runs `cfg`: every family but MoE."""
    item = _UNPORTED["moe"] if cfg.moe else _UNPORTED.get(cfg.family)
    if item is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet ({item})")


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
def _init_attn_stack(gen, cfg: ArchConfig, L: int, dtype, device):
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
    p["mlp"] = ll.init_mlp(gen, L, D, F, cfg.mlp_activation, dtype, device)
    return p


def _tied(cfg: ArchConfig) -> bool:
    return cfg.tie_embeddings and cfg.input_mode == "tokens"


def init_params(gen: torch.Generator, cfg: ArchConfig, device="cuda") -> Dict[str, Any]:
    """Random parameters for `cfg`, drawn from `gen` on `device`.

    `gen` must live on `device` (``torch.Generator(device=...)``). The draws
    differ from the reference's ``jax.random`` streams; parity tests carry the
    reference's parameters across with ``repro_torch.interop`` instead."""
    dev = resolve_device(device)
    require_ported(cfg)
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
        params["shared_attn"] = _init_attn_stack(gen, cfg, 1, dtype, dev)
    else:
        params["stack"] = _init_attn_stack(gen, cfg, L, dtype, dev)
    params["final_norm"] = ll.zeros((D,), dtype, dev)
    if not _tied(cfg):
        params["unembed"] = ll.trunc_normal(gen, (D, V), 1.0, dtype, dev)
    return params


# ------------------------------------------------------------------------- embed
def embed_inputs(params, cfg: ArchConfig, inputs: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S), or embeddings (B, S, D) for the vlm/audio frontend
    stubs, -> activations (B, S, D) in the config's dtype."""
    dtype = dtype_of(cfg.dtype)
    if cfg.input_mode == "tokens":
        h = params["embed"][inputs].to(dtype)
    else:
        h = inputs.to(dtype)
    if cfg.scale_embedding:
        # The reference rounds sqrt(d_model) to the activation dtype before
        # multiplying (sqrt(1152) = 33.94 becomes 34.0 in bf16); so does this.
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype).item()
    return h


def unembed(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + vocab projection; padded vocab entries are masked to -1e30."""
    h = ll.rms_norm(h, params["final_norm"])
    w = params["embed"].T if _tied(cfg) else params["unembed"]
    logits = (h @ w.to(h.dtype)).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad_mask, -1e30)
    return logits


# ------------------------------------------------------------------------- blocks
def _layer(tree, i: int):
    """Layer `i`'s view of a layer-stacked parameter (or state) tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _finish_block(p, h, a_out, cfg: ArchConfig):
    """The rest of a pre-norm block after attention: residual, norm, MLP."""
    if cfg.post_norms:
        a_out = ll.rms_norm(a_out, p["post_ln1"])
    h = h + a_out
    f_out = ll.mlp(p["mlp"], ll.rms_norm(h, p["ln2"]), cfg.mlp_activation)
    if cfg.post_norms:
        f_out = ll.rms_norm(f_out, p["post_ln2"])
    return h + f_out


def _attn_block_body(p, h, window: int, cfg: ArchConfig, opts: ModelOptions):
    """One pre-norm block over the full sequence. Returns (h, (k, v))."""
    a_out, kv = attn.full_attention(
        p["attn"], ll.rms_norm(h, p["ln1"]),
        window=window, causal=cfg.causal, theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm, attn_impl=opts.attn_impl,
    )
    return _finish_block(p, h, a_out, cfg), kv


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
    (B, S, V) logit tensor entirely). aux_loss is 0: it is the MoE balance
    loss, and MoE is not ported yet."""
    require_ported(cfg)
    if opts.remat != "none":
        raise NotImplementedError(
            f"remat={opts.remat!r} changes only the backward pass, which is not "
            f"ported yet (ROADMAP A.9)")
    h = embed_inputs(params, cfg, inputs)
    caches: Dict[str, Any] = {}
    if cfg.family == "ssm":
        h, caches = _ssm_forward(params, cfg, h, opts, collect_kv)
    elif cfg.family == "hybrid":
        h, caches = _hybrid_forward(params, cfg, h, opts, collect_kv)
    else:
        windows = layer_windows(cfg, cfg.num_layers)
        ks, vs = [], []
        for i in range(cfg.num_layers):
            h, (k, v) = _attn_block_body(_layer(params["stack"], i), h, int(windows[i]),
                                         cfg, opts)
            if collect_kv:
                ks.append(k)
                vs.append(v)
        if collect_kv:
            caches["kv"] = (torch.stack(ks), torch.stack(vs))
    if last_only:
        h = h[:, -1:]
    logits = unembed(params, cfg, h)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device), caches


def _stack_states(states):
    """Per-layer state dicts -> one dict of (L, ...) tensors."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _ssm_forward(params, cfg: ArchConfig, h, opts: ModelOptions, collect_kv: bool):
    """RWKV6: every layer starts from a zero state; caches {"rwkv": {"tm_x",
    "cm_x", "wkv"}} stacked over L when collect_kv."""
    state = rk.rwkv6_init_state(cfg, h.shape[0], h.dtype, h.device)
    states = []
    for i in range(cfg.num_layers):
        h, st = rk.rwkv6_block(_layer(params["blocks"], i), h, state, cfg, impl=opts.wkv_impl)
        if collect_kv:
            states.append(st)
    return h, ({"rwkv": _stack_states(states)} if collect_kv else {})


def _hybrid_forward(params, cfg: ArchConfig, h, opts: ModelOptions, collect_kv: bool):
    """Zamba2: Mamba2 layers; the shared attention block every ssm_attn_every."""
    state = m2.mamba2_init_state(cfg, h.shape[0], h.dtype, h.device)
    shared = _layer(params["shared_attn"], 0)                    # strip L=1
    states, ks, vs = [], [], []
    for i, attn_here in enumerate(_use_attn(cfg)):
        out, st = m2.mamba2_block(_layer(params["blocks"], i), h, state, cfg,
                                  impl=opts.ssd_impl)
        h = h + out
        if attn_here:
            h, (k, v) = _attn_block_body(shared, h, int(BIG_WINDOW), cfg, opts)
            if collect_kv:
                ks.append(k)
                vs.append(v)
        if collect_kv:
            states.append(st)
    caches: Dict[str, Any] = {}
    if collect_kv:
        caches = {"mamba": _stack_states(states),
                  "shared_kv": (torch.stack(ks), torch.stack(vs))}
    return h, caches


# ------------------------------------------------------------------------- decode
def init_decode_state(params, cfg: ArchConfig, batch: int, max_len: int,
                      dtype=None, sliding_ring: bool = False) -> Dict[str, Any]:
    """Empty caches for decode-from-scratch, on the parameters' device."""
    require_ported(cfg)
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
        state["kv"] = kv(L, max_len)
    return state


def decode_step(params, cfg: ArchConfig, state: Dict[str, Any], inputs: torch.Tensor,
                opts: ModelOptions = ModelOptions()):
    """One decode step. inputs: (B,1) tokens or (B,1,D) embeddings.

    Returns (logits (B, V), new_state). The new token's K/V is written into
    the caches of `state` in place, and `new_state` holds those same cache
    tensors (the reference returns new ones); lengths and the Mamba2 and
    RWKV6 states are new tensors."""
    require_ported(cfg)
    h = embed_inputs(params, cfg, inputs)
    lengths = state["lengths"]
    new_state: Dict[str, Any] = {"lengths": lengths + 1}

    if cfg.family == "ssm":
        states = []
        for i in range(cfg.num_layers):
            h, st = rk.rwkv6_decode(_layer(params["blocks"], i), h, _layer(state["rwkv"], i), cfg)
            states.append(st)
        new_state["rwkv"] = _stack_states(states)
    elif cfg.family == "hybrid":
        h = _hybrid_decode(params, cfg, state, h, new_state, opts)
    elif opts.sliding_ring and "kv_ring" in state:
        h = _sliding_ring_decode(params, cfg, state, h, new_state, opts)
    else:
        windows = layer_windows(cfg, cfg.num_layers)
        kc, vc = state["kv"]
        for i in range(cfg.num_layers):
            p = _layer(params["stack"], i)
            a_out, _, _ = attn.decode_attention(
                p["attn"], ll.rms_norm(h, p["ln1"]), kc[i], vc[i], lengths,
                window=int(windows[i]), theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                flash_layout=opts.decode_flash_layout,
            )
            h = _finish_block(p, h, a_out, cfg)
        new_state["kv"] = (kc, vc)

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
        p = _layer(params["stack"], i)
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
        h = _finish_block(p, h, a_out, cfg)
    new_state["kv_ring"] = (rk, rv)
    new_state["kv_global"] = (gk, gv)
    return h


def _hybrid_decode(params, cfg: ArchConfig, state, h, new_state, opts: ModelOptions):
    lengths = state["lengths"]
    shared = _layer(params["shared_attn"], 0)
    kbuf, vbuf = state["shared_kv"]
    states = []
    inv = 0
    for i, attn_here in enumerate(_use_attn(cfg)):
        out, st = m2.mamba2_decode(_layer(params["blocks"], i), h,
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
