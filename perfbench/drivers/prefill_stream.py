"""Driver ``prefill_stream``: back-to-back prefill calls of the port's
``transformer.forward(collect_kv=True, last_only=True)``, one after another,
each timed from its start to its logits and caches being ready.

The mix gives the batch and the prompt lengths; the cell gives the model
options (``attn_impl``). Token ids are drawn on the device from the seed. A
seeded sample of the window's calls, with a call of the longest length in it,
keeps its last-position logits and caches; after the window the reference
recomputes them in fp32 and the run compares the two. Traced, after the
window, ``profile_calls`` more calls run under the profiler (the traced
slice).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.lib import files, traffic, weights
from perfbench.lib.cell import Cell, Check, Record
from perfbench.lib.profile import span, traced_slice
from perfbench.reference.common import gaps, relative

TOKEN_STREAM = 0x70C5


def run(cell: Cell) -> Record:
    from repro_torch.models import transformer as tf

    rec = Record()
    cfg = cell.arch or cell.port_config()
    mix, work = cell.traffic, cell.workload
    B = int(mix.get("batch", 1))
    V = cell.model["vocab_size"]
    cell.log("drawing the weights")
    params = weights.draw(cell.model, cell.seed, cell.device)
    cell.sync()
    cell.log("weights drawn")
    opts = tf.ModelOptions(**work.get("model_options", {}))
    table = [p for p, _ in traffic.shapes(mix)]
    gen = torch.Generator(device=cell.device).manual_seed(int(cell.seed) ^ TOKEN_STREAM)
    pool = torch.randint(0, V, (len(table), B, max(table)), generator=gen,
                         device=cell.device)

    def call(i: int, S: int):
        return tf.forward(params, cfg, pool[i % len(table), :, :S], opts,
                          collect_kv=True, last_only=True)

    # warm-up: the longest shape first, so the allocator holds its blocks
    for i, S in enumerate((max(table), min(table))):
        call(i, S)
    cell.sync()
    cell.log("warm-up calls done")

    pick = np.random.default_rng(int(cell.seed)).choice(
        int(work["check"]["from_first"]), size=int(work["check"]["calls"]), replace=False)
    keep = {int(i) for i in pick}
    kept, units = {}, []
    longest_kept = False
    lengths = traffic.order(mix)
    t0w = cell.window_started(rec)
    i = 0
    while True:
        S = next(lengths)
        t0 = time.perf_counter()
        with span("forward", cell.trace):
            logits, _, caches = call(i, S)
        cell.sync()
        t1 = time.perf_counter()
        units.append((S, t0, t1))
        if not bool(torch.isfinite(logits).all()):
            rec.failed += 1
        if i in keep or (S == max(table) and not longest_kept):
            longest_kept = longest_kept or S == max(table)
            kept[i] = (pool[i % len(table), :, :S], logits[:, -1, :V], caches["kv"])
        del logits, caches
        i += 1
        if t1 - t0w >= cell.seconds:
            break
    cell.window_closed(rec)
    slice_units = []
    if cell.trace:
        def traced_call():
            S = next(lengths)
            with span("forward", True):
                call(len(units) + len(slice_units), S)
            slice_units.append((S, 0.0, 0.0))

        rec.profile = traced_slice(int(mix["profile_calls"]), traced_call)
    rec.attempted = len(units)
    rec.data = {"kind": "prefill", "units": units, "slice_units": slice_units, "batch": B,
                "model": cell.model}
    cell.log(f"window: {len(units)} calls in {rec.window_s:.2f}s")
    rec.checks = compare(cell, params, kept)
    cell.log(f"reference over {len(kept)} calls")
    rec.inputs = {"params": params, "kept": kept}
    return rec


CHECKS = ("logits_rel", "kv_rel", "top_gap")


def kv_slots(model: dict) -> dict:
    """The model's layer -> the index of its K and V in the program's
    ``caches["kv"]``, which stacks the layers that run attention in order."""
    layers = files.architecture(model).attention_layers(model)
    return {layer: n for n, layer in enumerate(layers)}


def compare(cell: Cell, params: dict, kept: dict) -> list:
    """The kept calls' last logits and caches against the fp32 reference:
    the worst relative error of the logits, and of any attention layer's K
    or V, and how far the program's next token (its best logit) lies below
    the reference's best, over the kept calls and their batch rows."""
    limits = cell.workload["limits"]
    if not kept:
        return [Check(name, float("nan"), float(limits[name])) for name in CHECKS]
    arch = files.architecture(cell.model)
    slot = kv_slots(cell.model)
    worst_logits = worst_kv = worst_gap = 0.0
    for toks, logits, (ks, vs) in kept.values():
        for b in range(toks.shape[0]):
            def on_kv(layer, _j, k, v, b=b, ks=ks, vs=vs):
                nonlocal worst_kv
                n = slot[layer]
                worst_kv = max(worst_kv, relative(ks[n, b].to(k.device), k),
                               relative(vs[n, b].to(v.device), v))

            S = toks.shape[1]
            (out,) = arch.forward(params, cell.model, [toks[b]], mode="fp32",
                                  logits_at=[torch.tensor([S - 1], device=toks.device)],
                                  on_kv=on_kv)
            worst_logits = max(worst_logits, relative(logits[b], out[0]))
            worst_gap = max(worst_gap, float(gaps(out, logits[b].argmax()[None])[0]))
    return [Check(name, value, float(limits[name]))
            for name, value in zip(CHECKS, (worst_logits, worst_kv, worst_gap), strict=True)]


def control(cell: Cell, rec: Record) -> list:
    """The control through the same comparison: on the kept calls' tokens, the
    fp8 reference's last logits and caches, judged as the program's are (a
    call at a time, its fp32 caches held in host memory: beside the served
    weights the card has no room for them)."""
    params = rec.inputs["params"]
    arch = files.architecture(cell.model)
    slot = kv_slots(cell.model)
    worst: dict = {}
    for i, (toks, _, _) in rec.inputs["kept"].items():
        last = [torch.tensor([toks.shape[1] - 1], device=toks.device)]
        rows, ks, vs = [], [], []
        for b in range(toks.shape[0]):
            kv: dict = {}

            def keep(layer, _j, k, v, kv=kv):
                kv[slot[layer]] = (k.cpu(), v.cpu())

            (l8,) = arch.forward(params, cell.model, [toks[b]], mode="fp8", logits_at=last,
                                 on_kv=keep)
            rows.append(l8[0])
            ks.append(torch.stack([kv[n][0] for n in range(len(slot))]))
            vs.append(torch.stack([kv[n][1] for n in range(len(slot))]))
        outputs = (toks, torch.stack(rows), (torch.stack(ks, 1), torch.stack(vs, 1)))
        for c in compare(cell, params, {i: outputs}):
            if c.name not in worst or not c.value <= worst[c.name].value:
                worst[c.name] = c
    return list(worst.values())
