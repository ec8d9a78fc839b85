"""A stand-in architecture for ``check_architecture.py``: the decoder with
attention in its even layers only, each odd layer an MLP block alone.

It is no published model and the port has no entry for it. It lives here,
not under ``perfbench/reference/``, and the check registers it as
``perfbench.reference.alternating`` for a test's length, as a file there
would be found. It provides what ``perfbench/README.md`` asks of an
architecture module, so that a new architecture is shown to reach every
caller of the harness through ``files.architecture`` with no edit to them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from perfbench.reference.common import (DTYPES, Precision, _attention, _rms, _rope, _swiglu,
                                       exact_fp32)

MLP = ("w_gate", "w_up", "w_down")


def dims(model: dict) -> dict:
    D, N, V = model["hidden_size"], model["num_attention_heads"], model["vocab_size"]
    L = model["num_hidden_layers"]
    return {"L": L, "La": len(attention_layers(model)), "D": D, "N": N,
            "K": model["num_key_value_heads"], "hd": model["head_dim"],
            "F": model["intermediate_size"], "V": V, "Vp": -(-V // 256) * 256}


def attention_layers(model: dict) -> List[int]:
    return list(range(0, model["num_hidden_layers"], 2))


def layout(model: dict) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Every layer's MLP stacked over L; attention stacked over its layers."""
    d = dims(model)
    L, La, D, N, K, hd, F = d["L"], d["La"], d["D"], d["N"], d["K"], d["hd"], d["F"]
    dt = DTYPES[model["torch_dtype"]]
    return {
        "embed": ((d["Vp"], D), dt),
        "attn.ln": ((La, D), dt),
        "attn.wq": ((La, D, N, hd), dt),
        "attn.wk": ((La, D, K, hd), dt),
        "attn.wv": ((La, D, K, hd), dt),
        "attn.wo": ((La, N, hd, D), dt),
        "mlp.ln": ((L, D), dt),
        "mlp.w_gate": ((L, D, F), dt),
        "mlp.w_up": ((L, D, F), dt),
        "mlp.w_down": ((L, F, D), dt),
        "final_norm": ((D,), dt),
        "unembed": ((D, d["Vp"]), dt),
    }


def is_norm(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("ln", "final_norm")


def forward(weights: dict, model: dict, seqs: Sequence[torch.Tensor], *,
            mode: str = "fp32",
            logits_at: Optional[Sequence[Optional[torch.Tensor]]] = None,
            on_kv: Optional[Callable[[int, int, torch.Tensor, torch.Tensor], None]] = None
            ) -> List[torch.Tensor]:
    """As the decoder's ``forward``; ``on_kv`` sees the even layers alone."""
    prec = Precision(mode)
    d = dims(model)
    D, N, K, hd, V = d["D"], d["N"], d["K"], d["hd"], d["V"]
    eps, theta = float(model["rms_norm_eps"]), float(model["rope_theta"])
    attn, mlp = weights["attn"], weights["mlp"]
    ctx = exact_fp32() if prec.dtype == torch.float32 else contextlib.nullcontext()
    with ctx, torch.no_grad():
        hs = [weights["embed"][s.long()].to(prec.dtype) for s in seqs]
        for i in range(d["L"]):
            ffn = [prec.weight(mlp[n][i]) for n in MLP]
            for j, h in enumerate(hs):
                if i % 2 == 0:
                    a, S = i // 2, h.shape[0]
                    x = prec.act(_rms(h, attn["ln"][a], eps))
                    q = (x @ prec.weight(attn["wq"][a].reshape(D, N * hd))).reshape(S, N, hd)
                    k = (x @ prec.weight(attn["wk"][a].reshape(D, K * hd))).reshape(S, K, hd)
                    v = (x @ prec.weight(attn["wv"][a].reshape(D, K * hd))).reshape(S, K, hd)
                    q, k = _rope(q, theta), _rope(k, theta)
                    if on_kv is not None:
                        on_kv(i, j, k, v)
                    h = h + prec.act(_attention(q, k, v)) @ prec.weight(
                        attn["wo"][a].reshape(N * hd, D))
                hs[j] = h + _swiglu(_rms(h, mlp["ln"][i], eps), *ffn, prec)
        wu = prec.weight(weights["unembed"][:, :V])
        out = []
        for j, h in enumerate(hs):
            rows = None if logits_at is None else logits_at[j]
            h = h if rows is None else h[rows]
            out.append(prec.act(_rms(h, weights["final_norm"], eps)) @ wu)
        return out


def matmul_params(model: dict) -> int:
    d = dims(model)
    D, N, K, hd = d["D"], d["N"], d["K"], d["hd"]
    return d["La"] * (2 * D * N * hd + 2 * D * K * hd) + d["L"] * 3 * D * d["F"]


def attention_pair_flops(model: dict) -> int:
    d = dims(model)
    return d["La"] * 4 * d["N"] * d["hd"]


def port_check(model: dict, cfg) -> None:
    d = dims(model)
    have = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.attention_every)
    want = (d["L"], d["D"], d["N"], d["K"], d["hd"], d["F"], d["V"], 2)
    if have != want:
        raise SystemExit(f"{cfg.name}: the port's config {have} differs from the file's {want}")


def tiny_model(model: dict, **sizes) -> dict:
    return {**model, "hidden_size": 32, "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 8, "num_hidden_layers": 3, "intermediate_size": 48, "vocab_size": 128,
            "torch_dtype": "float32", **sizes,
            "assumed": {**model["assumed"], "weights": {**model["assumed"]["weights"],
                                                        "std": 0.2}}}


def tiny_port(model: dict, cfg) -> dict:
    return dict(num_layers=model["num_hidden_layers"], d_model=model["hidden_size"],
                num_heads=model["num_attention_heads"], num_kv_heads=model["num_key_value_heads"],
                head_dim=model["head_dim"], d_ff=model["intermediate_size"],
                vocab_size=model["vocab_size"])
