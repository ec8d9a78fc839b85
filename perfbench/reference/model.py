"""The decoder: the reference of the served decoders (dense, and MoE with
top-k of the router's softmax), and everything else the harness asks of
this architecture. ``files.architecture`` returns this module for a
configuration file without an ``"architecture"`` key.

The reference reads the configuration file and the benchmark's own weight
tree (``layout`` below), never anything of the program, and computes one
layer at a time: each layer's weights are raised from their served dtype to
the compute precision, used by every sequence, and dropped, so the reference
fits beside the served weights on the card. Its precisions are
``common.Precision``'s.

The architecture as the port runs it (``as_run`` in the configuration file):
pre-norm blocks, RMSNorm as ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``,
RoPE rotating the two halves of a head, optional RMSNorm of each head of q
and k before RoPE, causal grouped-query attention, a SwiGLU MLP or a MoE of
SwiGLU experts, final norm, an untied unembedding over the published vocab.
Every layer runs attention.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from perfbench.reference.common import (DTYPES, Precision, _attention, _rms, _rope, _swiglu,
                                       exact_fp32)


def dims(model: dict) -> dict:
    """The sizes the layout and the counts need, from a configuration file."""
    D, N = model["hidden_size"], model["num_attention_heads"]
    V = model["vocab_size"]
    return {
        "L": model["num_hidden_layers"], "D": D, "N": N,
        "K": model["num_key_value_heads"], "hd": model.get("head_dim", D // N),
        "F": model["intermediate_size"], "V": V, "Vp": -(-V // 256) * 256,
        "E": model.get("num_experts", 0), "k": model.get("num_experts_per_tok", 0),
        "qk_norm": bool(model.get("qk_norm", False)),
    }


def attention_layers(model: dict) -> List[int]:
    """The layers that run attention, in order: every one. The n-th of them
    is the program's ``caches["kv"][n]``."""
    return list(range(model["num_hidden_layers"]))


def layout(model: dict) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Dotted leaf name -> (shape, dtype), in draw order: the tree that
    ``repro_torch.models.transformer`` reads."""
    d = dims(model)
    L, D, N, K, hd, F, E = d["L"], d["D"], d["N"], d["K"], d["hd"], d["F"], d["E"]
    dt = DTYPES[model["torch_dtype"]]
    out = {
        "embed": ((d["Vp"], D), dt),
        "stack.ln1": ((L, D), dt),
        "stack.ln2": ((L, D), dt),
        "stack.attn.wq": ((L, D, N, hd), dt),
        "stack.attn.wk": ((L, D, K, hd), dt),
        "stack.attn.wv": ((L, D, K, hd), dt),
        "stack.attn.wo": ((L, N, hd, D), dt),
    }
    if d["qk_norm"]:
        out["stack.attn.q_norm"] = ((L, hd), dt)
        out["stack.attn.k_norm"] = ((L, hd), dt)
    if E:
        out["stack.moe.router"] = ((L, D, E), torch.float32)
        out["stack.moe.w_gate"] = ((L, E, D, F), dt)
        out["stack.moe.w_up"] = ((L, E, D, F), dt)
        out["stack.moe.w_down"] = ((L, E, F, D), dt)
    else:
        out["stack.mlp.w_gate"] = ((L, D, F), dt)
        out["stack.mlp.w_up"] = ((L, D, F), dt)
        out["stack.mlp.w_down"] = ((L, F, D), dt)
    out["final_norm"] = ((D,), dt)
    out["unembed"] = ((D, d["Vp"]), dt)
    return out


def is_norm(name: str) -> bool:
    """A norm's scale, drawn as zero: the port's ``1 + scale`` gain of 1."""
    return name.rsplit(".", 1)[-1] in ("ln1", "ln2", "q_norm", "k_norm", "final_norm")


def _moe(x, lw, model, prec: Precision):
    """Softmax over the router's logits, the top-k experts each token, their
    outputs weighted by the softmax (renormalised only where the config says)."""
    E, k = model["num_experts"], model["num_experts_per_tok"]
    logits = x @ lw["router"].to(prec.dtype)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    if model.get("norm_topk_prob", False):
        top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(E):
        rows, slot = torch.nonzero(top_e == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = _swiglu(x[rows], prec.weight(lw["w_gate"][e]), prec.weight(lw["w_up"][e]),
                    prec.weight(lw["w_down"][e]), prec)
        out.index_add_(0, rows, y * top_p[rows, slot, None])
    return out


def _layer_weights(stack: dict, i: int) -> dict:
    flat = {}
    for group in ("attn", "mlp", "moe"):
        for name, leaf in stack.get(group, {}).items():
            flat[name] = leaf[i]
    flat["ln1"], flat["ln2"] = stack["ln1"][i], stack["ln2"][i]
    return flat


def forward(weights: dict, model: dict, seqs: Sequence[torch.Tensor], *,
            mode: str = "fp32",
            logits_at: Optional[Sequence[Optional[torch.Tensor]]] = None,
            on_kv: Optional[Callable[[int, int, torch.Tensor, torch.Tensor], None]] = None
            ) -> List[torch.Tensor]:
    """Logits of each token sequence in `seqs` (1-D int tensors), at the
    positions ``logits_at[i]`` (all where None), over the published vocab.
    ``on_kv(layer, i, k, v)`` sees sequence i's keys (after RoPE) and values
    of each layer, (S, K, hd) in the compute precision."""
    prec = Precision(mode)
    run_as = {**model, **model.get("as_run", {})}
    eps = float(run_as["rms_norm_eps"])
    theta = float(run_as["rope_theta"])
    D, N = model["hidden_size"], model["num_attention_heads"]
    K = model["num_key_value_heads"]
    hd = model.get("head_dim", D // N)
    L, V = model["num_hidden_layers"], model["vocab_size"]
    stack = weights["stack"]
    ctx = exact_fp32() if prec.dtype == torch.float32 else contextlib.nullcontext()
    with ctx, torch.no_grad():
        hs = [weights["embed"][s.long()].to(prec.dtype) for s in seqs]
        for i in range(L):
            lw = _layer_weights(stack, i)
            wq = prec.weight(lw["wq"].reshape(D, N * hd))
            wk = prec.weight(lw["wk"].reshape(D, K * hd))
            wv = prec.weight(lw["wv"].reshape(D, K * hd))
            wo = prec.weight(lw["wo"].reshape(N * hd, D))
            if "router" not in lw:
                mlp = [prec.weight(lw[n]) for n in ("w_gate", "w_up", "w_down")]
            for j, h in enumerate(hs):
                S = h.shape[0]
                x = prec.act(_rms(h, lw["ln1"], eps))
                q = (x @ wq).reshape(S, N, hd)
                k = (x @ wk).reshape(S, K, hd)
                v = (x @ wv).reshape(S, K, hd)
                if "q_norm" in lw:
                    q, k = _rms(q, lw["q_norm"], eps), _rms(k, lw["k_norm"], eps)
                q, k = _rope(q, theta), _rope(k, theta)
                if on_kv is not None:
                    on_kv(i, j, k, v)
                h = h + prec.act(_attention(q, k, v)) @ wo
                x = _rms(h, lw["ln2"], eps)
                if "router" in lw:
                    h = h + _moe(x, lw, model, prec)
                else:
                    h = h + _swiglu(x, *mlp, prec)
                hs[j] = h
            del lw
        wu = prec.weight(weights["unembed"][:, :V])
        out = []
        for j, h in enumerate(hs):
            rows = None if logits_at is None else logits_at[j]
            h = h if rows is None else h[rows]
            out.append(prec.act(_rms(h, weights["final_norm"], eps)) @ wu)
        return out


def matmul_params(model: dict) -> int:
    """Weights a token multiplies through in the layers, per token: the
    attention projections, the MLP or the routed experts and the router."""
    d = dims(model)
    D, N, K, hd, F = d["D"], d["N"], d["K"], d["hd"], d["F"]
    attn = D * N * hd + 2 * D * K * hd + N * hd * D
    ffn = d["k"] * 3 * D * F + D * d["E"] if d["E"] else 3 * D * F
    return d["L"] * (attn + ffn)


def attention_pair_flops(model: dict) -> int:
    """Flops of one (query, key) pair over every head and layer: q.k and p.v,
    2 * hd each a head."""
    d = dims(model)
    return d["L"] * 4 * d["N"] * d["hd"]


def port_check(model: dict, cfg) -> None:
    """Hold the port's registry config `cfg` to the file's published widths:
    a run refuses a registry entry that differs from what the file states."""
    d = dims(model)
    have = {"L": cfg.num_layers, "D": cfg.d_model, "N": cfg.num_heads,
            "K": cfg.num_kv_heads, "hd": cfg.resolved_head_dim,
            "F": cfg.moe_d_ff if cfg.moe else cfg.d_ff, "V": cfg.vocab_size,
            "E": cfg.num_experts if cfg.moe else 0,
            "k": cfg.experts_per_token if cfg.moe else 0, "qk_norm": cfg.qk_norm}
    want = {key: d[key] for key in have}
    if have != want:
        raise SystemExit(f"{cfg.name}: the port's config {have} differs from "
                         f"the configuration file's {want}")
    if cfg.moe and cfg.moe_renormalize != bool(model.get("norm_topk_prob")):
        raise SystemExit(f"{cfg.name}: the port renormalises top-k differently")
    if float(cfg.rope_theta) != float(model["rope_theta"]):
        raise SystemExit(f"{cfg.name}: rope_theta differs from the file")


TINY = {"hidden_size": 64, "num_attention_heads": 4, "head_dim": 16,
        "num_hidden_layers": 2, "intermediate_size": 96, "vocab_size": 256,
        "torch_dtype": "float32"}
TINY_MOE = {"num_experts": 8, "num_experts_per_tok": 2}


def tiny_model(model: dict, **sizes) -> dict:
    """`model` with every width cut to a few dozen, for the CPU checks;
    `sizes` override TINY's keys."""
    m = copy.deepcopy(model)
    m.update(TINY, **sizes)
    m["num_key_value_heads"] = 2 if model["num_key_value_heads"] < model["num_attention_heads"] \
        else TINY["num_attention_heads"]
    if "num_experts" in m:
        m.update(TINY_MOE)
    m["assumed"]["weights"]["std"] = 0.2
    return m


def tiny_port(model: dict, cfg) -> dict:
    """The fields of the port's registry config `cfg` to replace so that it
    runs `model`'s tiny widths (``dataclasses.replace(cfg, **tiny_port(...))``)."""
    kw = dict(num_layers=model["num_hidden_layers"], d_model=model["hidden_size"],
              num_heads=model["num_attention_heads"], num_kv_heads=model["num_key_value_heads"],
              head_dim=model["head_dim"], d_ff=model["intermediate_size"],
              vocab_size=model["vocab_size"], dtype="float32", param_dtype="float32")
    if cfg.moe:
        kw.update(moe_d_ff=model["intermediate_size"], num_experts=model["num_experts"],
                  experts_per_token=model["num_experts_per_tok"])
    return kw
