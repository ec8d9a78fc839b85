"""Granite-4.0-H (``granitemoehybrid``): the reference of the hybrid stack and
everything else the harness asks of this architecture. ``files.architecture``
returns this module for a configuration file whose ``"architecture"`` is
``"granite"``.

The reference reads the configuration file (its published keys) and the
benchmark's own weight tree (``layout`` below), never anything of the
program, and computes one layer at a time: each layer's weights are raised
from their served dtype to the compute precision, used by every sequence,
and dropped (an expert's at a time), so the reference fits beside the served
weights on the card. Its precisions are ``common.Precision``'s.

The architecture (the published config, with the port's weight layout):

  * embeddings times ``embedding_multiplier``;
  * in each layer ``h += residual_multiplier * mixer(rmsnorm(h))``, the mixer
    given by ``layer_types``: causal grouped-query attention with no position
    embedding (``position_embedding_type`` "nope"), scores times
    ``attention_multiplier``; or Mamba2: one projection to
    ``[x | z | B | C | dt]``, a causal depthwise convolution with bias and
    SiLU over ``[x | B | C]``, ``dt = softplus(dt + dt_bias)``, the SSD
    recurrence with one decay ``exp(-exp(A_log) dt)`` a head and one group
    of B and C, ``y + D x``, RMSNorm of ``y * silu(z)`` over the whole inner
    width (one group), the out projection;
  * then ``h += residual_multiplier * (moe(x) + shared(x))``, x =
    rmsnorm(h): the router's top ``num_experts_per_tok`` logits, a softmax
    over those, SwiGLU experts of ``intermediate_size``; a shared SwiGLU
    expert of ``shared_intermediate_size``;
  * a final RMSNorm, logits through the tied embedding over
    ``logits_scaling``.

RMSNorm is ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` (the port's gain
parameterisation; a zero scale is the published unit gain) at the published
``rms_norm_eps``. The SSD is computed in plain chunks of the published
``mamba_chunk_size`` (256): within a chunk the causal pairs, across chunks
the carried state, a different decomposition from the program's kernel.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.common import DTYPES, Precision, _rms, _swiglu, exact_fp32

ATTN_BLOCK = 128        # query rows a block of the reference's attention
# Rows a block of the reference's Mamba2 mixer, a multiple of every chunk it
# is run at, so that the blocks leave the chunks and every row's arithmetic
# as they were: a 32k-token prompt's projections in fp32 would take ~10 GB
# beside the program's weights, a block of 4096 rows an eighth of that.
ROW_BLOCK = 4096


def dims(model: dict) -> dict:
    """The sizes the layout and the counts need, from a configuration file."""
    D, N = model["hidden_size"], model["num_attention_heads"]
    V = model["vocab_size"]
    d_in = model["mamba_expand"] * D
    Ns = model["mamba_d_state"]
    return {
        "L": model["num_hidden_layers"], "D": D, "N": N, "K": model["num_key_value_heads"],
        "hd": model.get("head_dim", D // N), "V": V, "Vp": -(-V // 256) * 256,
        "F": model["intermediate_size"], "Fs": model["shared_intermediate_size"],
        "E": model["num_local_experts"], "k": model["num_experts_per_tok"],
        "d_in": d_in, "H": model["mamba_n_heads"], "P": model["mamba_d_head"], "Ns": Ns,
        "conv": model["mamba_d_conv"], "conv_dim": d_in + 2 * model["mamba_n_groups"] * Ns,
    }


def attention_layers(model: dict) -> List[int]:
    """The layers whose mixer is attention, in order; the n-th of them is the
    program's ``caches["kv"][n]``."""
    return [i for i, kind in enumerate(model["layer_types"]) if kind == "attention"]


def mamba_layers(model: dict) -> List[int]:
    """The layers whose mixer is Mamba2, in order; the m-th of them is the
    program's ``caches["mamba"][...][m]``."""
    return [i for i, kind in enumerate(model["layer_types"]) if kind == "mamba"]


def layout(model: dict) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Dotted leaf name -> (shape, dtype), in draw order: the tree that
    ``repro_torch.models.transformer`` reads for the ``hybrid_moe`` family."""
    d = dims(model)
    L, D, E, F_, Fs = d["L"], d["D"], d["E"], d["F"], d["Fs"]
    La, Lm = len(attention_layers(model)), len(mamba_layers(model))
    dt = DTYPES[model["torch_dtype"]]
    f32 = torch.float32
    return {
        "embed": ((d["Vp"], D), dt),
        "stack.ln1": ((L, D), dt),
        "stack.ln2": ((L, D), dt),
        "stack.moe.router": ((L, D, E), f32),
        "stack.moe.w_gate": ((L, E, D, F_), dt),
        "stack.moe.w_up": ((L, E, D, F_), dt),
        "stack.moe.w_down": ((L, E, F_, D), dt),
        "stack.moe.s_gate": ((L, D, Fs), dt),
        "stack.moe.s_up": ((L, D, Fs), dt),
        "stack.moe.s_down": ((L, Fs, D), dt),
        "mamba.in_proj": ((Lm, D, 2 * d["d_in"] + 2 * d["Ns"] + d["H"]), dt),
        "mamba.conv_w": ((Lm, d["conv"], d["conv_dim"]), dt),
        "mamba.conv_b": ((Lm, d["conv_dim"]), dt),
        "mamba.A_log": ((Lm, d["H"]), f32),
        "mamba.D": ((Lm, d["H"]), f32),
        "mamba.dt_bias": ((Lm, d["H"]), f32),
        "mamba.norm": ((Lm, d["d_in"]), dt),
        "mamba.out_proj": ((Lm, d["d_in"], D), dt),
        "attn.wq": ((La, D, d["N"], d["hd"]), dt),
        "attn.wk": ((La, D, d["K"], d["hd"]), dt),
        "attn.wv": ((La, D, d["K"], d["hd"]), dt),
        "attn.wo": ((La, d["N"], d["hd"], D), dt),
        "final_norm": ((D,), dt),
    }


def is_norm(name: str) -> bool:
    """A norm's scale, drawn as zero: the port's ``1 + scale`` gain of 1."""
    return name.rsplit(".", 1)[-1] in ("ln1", "ln2", "norm", "final_norm")


def ssd(x, dt, A, Bm, C, D, chunk: int, state=None):
    """The SSD over one sequence in plain chunks: x (S, H, P), dt (S, H), A and
    D (H,), Bm and C (S, N), from `state` (H, P, N; zero where None). Within a
    chunk, ``y_t = sum_{s<=t} (C_t . B_s) exp(L_t - L_s) dt_s x_s + exp(L_t)
    C_t . H0``, L the inclusive cumulative sum of ``A dt`` in the chunk; the
    state carried out of the chunk is ``exp(L_last) H0 + sum_s exp(L_last -
    L_s) dt_s x_s (x) B_s``. Returns y (S, H, P), with ``D x`` added, and the
    final state (H, P, N)."""
    S, H, P = x.shape
    if state is None:
        state = x.new_zeros((H, P, Bm.shape[-1]))
    ys = []
    for a in range(0, S, chunk):
        b = min(S, a + chunk)
        xs, dts, Bs, Cs = x[a:b], dt[a:b], Bm[a:b], C[a:b]
        Lc = torch.cumsum(dts * A, dim=0)                              # (c, H)
        causal = torch.ones((b - a, b - a), dtype=torch.bool, device=x.device).tril()
        gap = (Lc[:, None, :] - Lc[None, :, :]).masked_fill(~causal[..., None], float("-inf"))
        w = (Cs @ Bs.T)[..., None] * torch.exp(gap) * dts[None]          # (t, s, H)
        y = torch.einsum("tsh,shp->thp", w, xs)
        y = y + torch.exp(Lc)[..., None] * torch.einsum("tn,hpn->thp", Cs, state)
        to_end = torch.exp(Lc[-1] - Lc) * dts                           # (c, H)
        state = (torch.exp(Lc[-1])[:, None, None] * state
                 + torch.einsum("shp,sn->hpn", xs * to_end[..., None], Bs))
        ys.append(y + D[:, None] * xs)
    return torch.cat(ys), state


def _attention(q, k, v, scale: float):
    """Causal GQA over one sequence, q (S, N, hd), k and v (S, K, hd), scores
    times `scale`; query blocks of ATTN_BLOCK rows against their keys."""
    S, N, hd = q.shape
    K = k.shape[1]
    qg = q.reshape(S, K, N // K, hd).permute(1, 2, 0, 3)          # (K, G, S, hd)
    kt, vt = k.permute(1, 2, 0), v.permute(1, 0, 2)               # (K, hd, S), (K, S, hd)
    out = torch.empty_like(qg)
    keys = torch.arange(S, device=q.device)
    for a in range(0, S, ATTN_BLOCK):
        b = min(S, a + ATTN_BLOCK)
        s = (qg[:, :, a:b] @ kt[:, None, :, :b]) * scale            # (K, G, rows, b)
        s = s.masked_fill(keys[None, :b] > keys[a:b, None], float("-inf"))
        out[:, :, a:b] = torch.softmax(s, dim=-1) @ vt[:, None, :b]
    return out.permute(2, 0, 1, 3).reshape(S, N * hd)


def _mamba(x, mw, model, prec: Precision, eps: float):
    """One Mamba2 mixer over one sequence x (S, D) in compute precision, in
    blocks of ROW_BLOCK rows that hand on the convolution's last inputs and
    the SSD's state. Returns its output (S, D) and its states: the
    convolution's last ``mamba_d_conv - 1`` inputs (k - 1, conv_dim) and the
    SSD's (H, P, N)."""
    d = dims(model)
    d_in, Ns, H, P, k = d["d_in"], d["Ns"], d["H"], d["P"], d["conv"]
    chunk = model["mamba_chunk_size"]
    A = -torch.exp(mw["A_log"])
    rows = max(chunk, ROW_BLOCK // chunk * chunk)
    tail, state = x.new_zeros((k - 1, d["conv_dim"])), None
    outs = []
    for a in range(0, x.shape[0], rows):
        xb = x[a:a + rows]
        n = xb.shape[0]
        proj = prec.act(xb) @ mw["in_proj"]
        xi, z, Bm, C, dt = torch.split(proj, [d_in, d_in, Ns, Ns, H], dim=-1)
        padded = torch.cat([tail, torch.cat([xi, Bm, C], dim=-1)])     # (k - 1 + n, conv_dim)
        conv = sum(padded[i:i + n] * mw["conv_w"][i] for i in range(k)) + mw["conv_b"]
        tail = padded[n:].clone()
        xi, Bm, C = torch.split(F.silu(conv), [d_in, Ns, Ns], dim=-1)
        dt = F.softplus(dt + mw["dt_bias"])
        y, state = ssd(xi.reshape(n, H, P), dt, A, Bm, C, mw["D"], chunk, state)
        y = _rms(y.reshape(n, d_in) * F.silu(z), mw["norm"], eps)
        outs.append(prec.act(y) @ mw["out_proj"])
    return torch.cat(outs), (tail, state)


def _moe(x, lw, model, prec: Precision):
    """The router's top-k logits, a softmax over them, the experts' SwiGLU
    outputs weighted by it; then the shared expert."""
    logits = x @ lw["router"].to(prec.dtype)
    top_l, top_e = torch.topk(logits, model["num_experts_per_tok"], dim=-1)
    top_p = torch.softmax(top_l, dim=-1)
    out = torch.zeros_like(x)
    for e in range(model["num_local_experts"]):
        rows, slot = torch.nonzero(top_e == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = _swiglu(x[rows], prec.weight(lw["w_gate"][e]), prec.weight(lw["w_up"][e]),
                    prec.weight(lw["w_down"][e]), prec)
        out.index_add_(0, rows, y * top_p[rows, slot, None])
    shared = [prec.weight(lw[n]) for n in ("s_gate", "s_up", "s_down")]
    return out + _swiglu(x, *shared, prec)


def forward(weights: dict, model: dict, seqs: Sequence[torch.Tensor], *,
            mode: str = "fp32",
            logits_at: Optional[Sequence[Optional[torch.Tensor]]] = None,
            on_kv: Optional[Callable[[int, int, torch.Tensor, torch.Tensor], None]] = None,
            on_state: Optional[Callable[[int, int, torch.Tensor, torch.Tensor], None]] = None
            ) -> List[torch.Tensor]:
    """Logits of each token sequence in `seqs` (1-D int tensors), at the
    positions ``logits_at[i]`` (all where None), over the published vocab.
    ``on_kv(layer, i, k, v)`` sees sequence i's keys and values of each
    attention layer, (S, K, hd); ``on_state(layer, i, conv, ssd)`` its
    convolution and SSD states after each Mamba2 layer; both in the compute
    precision."""
    prec = Precision(mode)
    d = dims(model)
    D, N, K, hd, V = d["D"], d["N"], d["K"], d["hd"], d["V"]
    eps = float(model["rms_norm_eps"])
    r = float(model["residual_multiplier"])
    scale = float(model["attention_multiplier"])
    stack, mamba, attn = weights["stack"], weights["mamba"], weights["attn"]
    slot = {i: n for n, i in enumerate(attention_layers(model))}
    slot.update({i: m for m, i in enumerate(mamba_layers(model))})
    ctx = exact_fp32() if prec.dtype == torch.float32 else contextlib.nullcontext()
    with ctx, torch.no_grad():
        hs = [weights["embed"][s.long()].to(prec.dtype) * float(model["embedding_multiplier"])
              for s in seqs]
        for i, kind in enumerate(model["layer_types"]):
            n = slot[i]
            lw = {name: leaf[i] for name, leaf in stack["moe"].items()}
            ln1, ln2 = stack["ln1"][i], stack["ln2"][i]
            if kind == "attention":
                wq, wk, wv = (prec.weight(attn[w][n].reshape(D, -1)) for w in ("wq", "wk", "wv"))
                wo = prec.weight(attn["wo"][n].reshape(N * hd, D))
            else:
                mw = {name: (prec.weight(leaf[n]) if name.endswith("_proj")
                             else leaf[n].to(prec.dtype)) for name, leaf in mamba.items()}
            for j, h in enumerate(hs):
                S = h.shape[0]
                x = _rms(h, ln1, eps)
                if kind == "attention":
                    x = prec.act(x)
                    q = (x @ wq).reshape(S, N, hd)
                    k = (x @ wk).reshape(S, K, hd)
                    v = (x @ wv).reshape(S, K, hd)
                    if on_kv is not None:
                        on_kv(i, j, k, v)
                    out = prec.act(_attention(q, k, v, scale)) @ wo
                else:
                    out, (conv, state) = _mamba(x, mw, model, prec, eps)
                    if on_state is not None:
                        on_state(i, j, conv, state)
                h = h + r * out
                h = h + r * _moe(_rms(h, ln2, eps), lw, model, prec)
                hs[j] = h
            del lw
            if kind == "attention":
                del wq, wk, wv, wo
            else:
                del mw
        emb = prec.weight(weights["embed"][:V].T)
        out = []
        for j, h in enumerate(hs):
            rows = None if logits_at is None else logits_at[j]
            h = h if rows is None else h[rows]
            logits = prec.act(_rms(h, weights["final_norm"], eps)) @ emb
            out.append(logits / float(model["logits_scaling"]))
        return out


def matmul_params(model: dict) -> int:
    """Weights a token multiplies through in the layers, per token: each
    mixer's projections (Mamba2's in and out, attention's q, k, v, o), the
    routed experts, the shared expert and the router."""
    d = dims(model)
    D = d["D"]
    mamba = D * (2 * d["d_in"] + 2 * d["Ns"] + d["H"]) + d["d_in"] * D
    attn = D * d["N"] * d["hd"] + 2 * D * d["K"] * d["hd"] + d["N"] * d["hd"] * D
    ffn = d["k"] * 3 * D * d["F"] + 3 * D * d["Fs"] + D * d["E"]
    return (len(mamba_layers(model)) * mamba + len(attention_layers(model)) * attn
            + d["L"] * ffn)


def attention_pair_flops(model: dict) -> int:
    """Flops of one (query, key) pair over every head of the attention
    layers: q.k and p.v, 2 * hd each a head."""
    d = dims(model)
    return len(attention_layers(model)) * 4 * d["N"] * d["hd"]


def mixer_token_flops(model: dict) -> int:
    """Flops a token needs in the Mamba2 mixers beyond their projections: the
    SSD's state update and readout, 4 H P N, and the depthwise convolution,
    2 conv conv_dim, a layer."""
    d = dims(model)
    return len(mamba_layers(model)) * (4 * d["H"] * d["P"] * d["Ns"]
                                       + 2 * d["conv"] * d["conv_dim"])


def port_check(model: dict, cfg) -> None:
    """Hold the port's registry config `cfg` to the file's published widths
    and multipliers: a run refuses a registry entry that differs."""
    d = dims(model)
    have = {"L": cfg.num_layers, "D": cfg.d_model, "N": cfg.num_heads,
            "K": cfg.num_kv_heads, "hd": cfg.resolved_head_dim, "V": cfg.vocab_size,
            "F": cfg.moe_d_ff, "Fs": cfg.moe_d_ff * cfg.num_shared_experts,
            "E": cfg.num_experts, "k": cfg.experts_per_token,
            "d_in": cfg.ssm_expand * cfg.d_model,
            "H": cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, "P": cfg.ssm_head_dim,
            "Ns": cfg.ssm_state, "conv": cfg.ssm_conv,
            "conv_dim": cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state}
    want = {key: d[key] for key in have}
    if cfg.family != "hybrid_moe" or have != want:
        raise SystemExit(f"{cfg.name}: the port's {cfg.family} config {have} differs from "
                         f"the configuration file's {want}")
    published = {
        "attention_layers": tuple(attention_layers(model)),
        "embedding_multiplier": float(model["embedding_multiplier"]),
        "residual_multiplier": float(model["residual_multiplier"]),
        "attention_multiplier": float(model["attention_multiplier"]),
        "logits_scaling": float(model["logits_scaling"]),
        "rms_norm_eps": float(model["rms_norm_eps"]),
        "use_rope": model["position_embedding_type"] != "nope",
        "tie_embeddings": bool(model["tie_word_embeddings"]),
        "moe_renormalize": True,          # the softmax over the top-k logits
        "qk_norm": False,
    }
    ported = {key: getattr(cfg, key) for key in published}
    if ported != published or model["mamba_n_groups"] != 1:
        raise SystemExit(f"{cfg.name}: the port's {ported} differs from the file's {published}")


# Many narrow Mamba2 heads, so that the per-head leaves (A_log, dt_bias, D)
# hold enough draws for the weight checks' spread.
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 24, "vocab_size": 256,
        "mamba_d_head": 2, "mamba_d_state": 8, "mamba_chunk_size": 8,
        "num_local_experts": 8, "num_experts_per_tok": 2, "torch_dtype": "float32"}
TINY_LAYERS = ["mamba", "attention", "mamba", "mamba"]


def tiny_model(model: dict, **sizes) -> dict:
    """`model` cut to a few dozen wide and 4 layers (three Mamba2, one
    attention), for the CPU checks. `sizes` override: ``hidden_size``,
    ``num_hidden_layers`` (the layer types repeat), ``head_dim`` (attention's;
    the Mamba2 heads keep the inner width), ``intermediate_size``, or any
    TINY key."""
    m = copy.deepcopy(model)
    m.update(TINY)
    m.pop("head_dim", None)
    m.update(sizes)
    if "shared_intermediate_size" not in sizes:     # two experts' width, as published
        m["shared_intermediate_size"] = 2 * m["intermediate_size"]
    L = m.get("num_hidden_layers") if "num_hidden_layers" in sizes else len(TINY_LAYERS)
    m["num_hidden_layers"] = L
    m["layer_types"] = [TINY_LAYERS[i % len(TINY_LAYERS)] for i in range(L)]
    m["mamba_n_heads"] = m["mamba_expand"] * m["hidden_size"] // m["mamba_d_head"]
    if "head_dim" not in m:
        m["head_dim"] = m["hidden_size"] // m["num_attention_heads"]
    m["assumed"]["weights"]["std"] = 0.2
    return m


def tiny_port(model: dict, cfg) -> dict:
    """The fields of the port's registry config `cfg` to replace so that it
    runs `model`'s tiny widths (``dataclasses.replace(cfg, **tiny_port(...))``)."""
    d = dims(model)
    if d["Fs"] % d["F"]:
        raise ValueError("the shared expert's width must be a multiple of the experts'")
    return dict(num_layers=d["L"], d_model=d["D"], num_heads=d["N"], num_kv_heads=d["K"],
                head_dim=d["hd"], d_ff=d["F"], moe_d_ff=d["F"], vocab_size=d["V"],
                num_experts=d["E"], experts_per_token=d["k"],
                num_shared_experts=d["Fs"] // d["F"], ssm_state=d["Ns"],
                ssm_head_dim=d["P"], attention_layers=tuple(attention_layers(model)),
                dtype="float32", param_dtype="float32")
