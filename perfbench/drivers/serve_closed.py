"""Driver ``serve_closed``: closed-loop clients into the port's ``ServingEngine``.

Each client holds one request at a time and sends its next one as soon as the
last finishes (after the engine step that finished it). The mix gives the
clients, the request shapes and the steps that bring the clients to steady
state before the window; the cell gives the engine (hot slots, page,
``max_batch``, promotion policy, model options). The REMOTE tier is pinned
host memory. Every token the engine emits is timed at the end of its step.

Untraced, the window runs the engine alone. Traced, wrappers around the
engine's step, admission and decode call record host spans, and
the decode call synchronises so that its span holds the device's work; after
the window, ``profile_steps`` more steps run under the profiler (the traced
slice), so that reading the trace never stalls the window.

After the window, a seeded sample of the requests it finished, with the
longest and (where there was any) a preempted one in it, is run through the
fp32 reference with its served tokens; the run compares how far each served
token's logit lies below the reference's best at its position.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import numpy as np
import torch

from perfbench.lib import files, traffic, weights
from perfbench.lib.cell import Cell, Check, Record
from perfbench.lib.profile import span, traced_slice
from perfbench.reference.common import gaps


class ClosedLoop:
    """Clients, their requests in flight, and the requests they finished."""

    def __init__(self, eng, requests, clients: int):
        self.eng, self.requests = eng, requests
        self.live: dict = {}
        self.done: list = []
        now = time.perf_counter()
        for _ in range(clients):
            self.submit(now)

    def submit(self, now: float) -> None:
        prompt, out = next(self.requests)
        rid = self.eng.submit(prompt, max_new_tokens=out)
        self.live[rid] = {"arrival": now, "times": [], "max_new": out,
                          "preempted": False, "finished": None}

    def step(self) -> int:
        """One engine step; returns the tokens it generated."""
        self.eng.step()
        now = time.perf_counter()
        new = 0
        for rid, info in list(self.live.items()):
            r = self.eng.requests[rid]
            while len(info["times"]) < len(r.generated):
                info["times"].append(now)
                new += 1
            if r.state == "preempted":
                info["preempted"] = True
            elif r.state == "finished":
                info["finished"] = now
                self.done.append((rid, info))
                del self.live[rid]
                self.submit(now)
        return new


class Spans:
    """Traced runs: host spans around the engine's layers."""

    def __init__(self, cell: Cell, eng, engine_mod):
        self.cell, self.eng, self.mod = cell, eng, engine_mod
        self.steps, self.decodes = [], []
        self._orig = engine_mod.paged_decode_step
        orig_step, orig_admit = eng.step, eng._admit

        def step():
            t0 = time.perf_counter()
            with span("step", True):
                orig_step()
            self.steps.append((t0, time.perf_counter()))

        def admit():
            with span("admit", True):
                orig_admit()

        def decode(*args, **kwargs):
            t0 = time.perf_counter()
            with span("decode", True):
                out = self._orig(*args, **kwargs)
                cell.sync()
            t1 = time.perf_counter()
            lengths = args[5]
            self.decodes.append((t0, t1, [int(n) + 1 for n in lengths.tolist()]))
            return out

        eng.step, eng._admit = step, admit
        engine_mod.paged_decode_step = decode

    def take(self) -> dict:
        """The spans recorded so far; recording starts afresh."""
        out = {"steps": self.steps, "decodes": self.decodes}
        self.steps, self.decodes = [], []
        return out

    def close(self) -> None:
        self.mod.paged_decode_step = self._orig


def run(cell: Cell) -> Record:
    from repro_torch.core import emucxl as ecxl
    from repro_torch.core.policy import make_policy
    from repro_torch.models import transformer as tf
    from repro_torch.serving import engine as engine_mod

    rec = Record()
    cfg = cell.arch or cell.port_config()
    mix, work = cell.traffic, cell.workload
    cell.log("drawing the weights")
    params = weights.draw(cell.model, cell.seed, cell.device)
    cell.sync()
    cell.log("weights drawn")
    lib = ecxl.default_instance()
    if lib._initialized:
        lib.exit()
    lib.init(device=cell.device)
    page = int(work["page"])
    longest = max(p + o for p, o in traffic.shapes(mix))
    eng = engine_mod.ServingEngine(
        params, cfg, num_slots=int(work["hot_slots"]), page_size=page,
        max_batch=int(work["max_batch"]), max_pages_per_seq=-(-longest // page),
        policy=make_policy(work["policy"]), opts=tf.ModelOptions(**work["model_options"]),
        device=cell.device)
    loop = ClosedLoop(eng, traffic.stream(mix, cell.seed, cell.model["vocab_size"]),
                      int(mix["clients"]))
    for _ in range(int(mix["warm_steps"])):
        loop.step()
    cell.log(f"{mix['warm_steps']} warm steps, {eng.preemptions} preemptions")

    spans = Spans(cell, eng, engine_mod) if cell.trace else None
    held = [_held(eng)]
    pre0 = eng.preemptions
    in_flight0 = set(loop.live)
    tokens, steps, marks = 0, 0, []
    try:
        t0w = cell.window_started(rec)
        while True:
            tokens += loop.step()
            steps += 1
            now = time.perf_counter()
            marks.append((now, tokens))
            if now - t0w >= cell.seconds:
                break
        cell.window_closed(rec)
        held.append(_held(eng))
        if spans is not None:
            window_spans = spans.take()
            rec.profile = traced_slice(int(mix["profile_steps"]), loop.step)
            slice_spans = spans.take()
    finally:
        if spans is not None:
            spans.close()
    t1w = t0w + rec.window_s
    finished = [(rid, info) for rid, info in loop.done if t0w <= info["finished"] <= t1w]
    live_ids = in_flight0 | {rid for rid, _ in finished} | {
        rid for rid, info in loop.live.items() if info["arrival"] <= t1w}
    rec.attempted = len(live_ids)
    rec.failed = sum(1 for rid, info in finished
                     if len(eng.requests[rid].generated) != info["max_new"])
    infos = [info for _, info in loop.done] + list(loop.live.values())
    rec.data = {
        "kind": "serve", "model": cell.model, "page": page,
        "max_batch": int(work["max_batch"]), "tokens": tokens, "steps": steps,
        "t0": t0w, "t1": t1w,
        "requests": [(info["arrival"], info["times"]) for info in infos],
        "preemptions": eng.preemptions - pre0,
        "spans": window_spans if spans is not None else None,
        "slice": slice_spans if spans is not None else None,
    }
    cell.log(f"window: {steps} steps, {tokens} tokens, {len(finished)} requests finished, "
             f"{rec.data['preemptions']} preemptions in {rec.window_s:.2f}s; tokens/s by "
             f"fifths: {_fifths(t0w, marks, rec.window_s)}")
    cell.log("KV at the window's start and close (pages held of the pool's "
             f"{work['hot_slots']}, tokens written, pages the decode batch holds): {held}")
    # the program's state goes before the reference runs
    served = sample(cell, eng, finished)
    del eng, loop, spans
    lib.exit()
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    rec.data["checked_tokens"] = sum(len(g) for _, g in served)
    rec.checks = compare(cell, params, served)
    cell.log(f"reference over {len(served)} requests, {rec.data['checked_tokens']} tokens")
    rec.inputs = {"params": params, "served": served}
    return rec


def _held(eng) -> tuple:
    """Pages the admitted requests hold, tokens written into them, and pages
    of the requests the next step decodes (those first in line)."""
    running = [r for r in eng.requests.values() if r.state == "running"]
    return (eng.pool.num_slots - eng.pool.free_slots(), sum(r.position for r in running),
            sum(eng._pages_needed(r) for r in running[:eng.max_batch]))


def _fifths(t0: float, marks: list, window_s: float) -> list:
    """Tokens a second in each fifth of the window (a progress line's)."""
    out, last_t, last_n, k = [], t0, 0, 1
    for i, (t, n) in enumerate(marks):
        if t - t0 >= k * window_s / 5 or i == len(marks) - 1:
            out.append(round((n - last_n) / max(t - last_t, 1e-9), 1))
            last_t, last_n, k = t, n, k + 1
    return out


def sample(cell: Cell, eng, finished) -> list:
    """(prompt, served tokens) of a seeded sample of the finished requests:
    the one with the most served tokens, a preempted one where there is any,
    then others in a seeded order until ``check.tokens`` served tokens."""
    if not finished:
        return []
    want = int(cell.workload["check"]["tokens"])
    reqs = [eng.requests[rid] for rid, _ in finished]
    order = list(np.random.default_rng(int(cell.seed)).permutation(len(reqs)))
    first = [max(range(len(reqs)), key=lambda i: (len(reqs[i].generated), -i))]
    pre = [i for i in order if finished[i][1]["preempted"]]
    picked, total = [], 0
    for i in first + pre[:1] + order:
        if i in picked:
            continue
        picked.append(i)
        total += len(reqs[i].generated)
        if total >= want:
            break
    return [(list(reqs[i].prompt), list(reqs[i].generated)) for i in picked]


def compare(cell: Cell, params: dict, served: list, chosen: Optional[list] = None) -> list:
    """The widest gap by which a served token's logit lies below the fp32
    reference's best at its position, over every sampled token. `chosen`, where
    given, puts other tokens in the served ones' places (one tensor a request);
    the positions and what precedes them stay the served ones."""
    limit = float(cell.workload["limits"]["max_gap"])
    if not served:
        return [Check("max_gap", float("nan"), limit)]
    seqs, rows, toks = _teacher_forced(served, cell.device)
    if chosen is not None:
        toks = chosen
    arch = files.architecture(cell.model)
    logits = arch.forward(params, cell.model, seqs, mode="fp32", logits_at=rows)
    worst = max(float(gaps(lg, t).max()) for lg, t in zip(logits, toks, strict=True))
    return [Check("max_gap", worst, limit)]


def _teacher_forced(served: list, dev):
    """Each request's prompt and served tokens as one sequence (the last
    served token is fed to nothing), the rows whose logits chose a served
    token, and those tokens."""
    seqs, rows, toks = [], [], []
    for prompt, gen in served:
        P, M = len(prompt), len(gen)
        seqs.append(torch.tensor(prompt + gen[:-1], device=dev))
        rows.append(torch.arange(P - 1, P + M - 1, device=dev))
        toks.append(torch.tensor(gen, device=dev))
    return seqs, rows, toks


def control(cell: Cell, rec: Record) -> list:
    """The control through the same comparison: at each sampled row of the same
    prompts and served tokens, the token the fp8 reference puts first, judged
    as a served token is."""
    params, served = rec.inputs["params"], rec.inputs["served"]
    seqs, rows, _ = _teacher_forced(served, cell.device)
    ref8 = files.architecture(cell.model).forward(params, cell.model, seqs, mode="fp8",
                                                  logits_at=rows)
    return compare(cell, params, served, chosen=[lg.argmax(-1) for lg in ref8])
