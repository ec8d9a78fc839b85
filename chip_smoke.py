"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each of which raises (and so exits non-zero) on failure:
  1. card: name and power limit, torch/CUDA versions, kernel build time;
  2. every CUDA kernel against its plain PyTorch version on the card, at the
     reference's sweep shapes and at the serving shapes;
  3. times (median of CUDA-event-timed runs, L2 flushed before each) of each
     kernel, its plain version and a library yardstick, beside the byte bound;
  4. the main path at full width: ``repro_torch.launch.serve`` serving
     gemma3-1b (26 layers, d_model 1152) with random bf16 weights, KV pages
     preempted into pinned host memory and promoted back; the kernel's launch
     count must equal decode steps x layers; a torch.profiler breakdown of 20
     more steps of the same request mix; then decode steps with the kernel and
     with the plain version from the same pools.
The last two lines are a JSON ``kernels`` record and a JSON result line.

Float32 matmuls run in full precision (TF32 off), so fp32 comparisons on the
card mean what they say.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, fp32 outside the tensor cores
WINDOW_GLOBAL = 2**30


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ----------------------------------------------------------------------------- inputs
def paged_inputs(B, N, K, hd, page, lengths, q_dtype, seed):
    """q, pages, a block table of distinct random pages, and lengths, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    max_pages = -(-max(lengths) // page)
    P = B * max_pages + 2
    q = (torch.randn((B, N, hd), generator=g, device="cuda") * 0.5).to(q_dtype)
    kp = torch.randn((P, page, K, hd), generator=g, device="cuda") * 0.5
    vp = torch.randn((P, page, K, hd), generator=g, device="cuda") * 0.5
    perm = torch.randperm(P, generator=g, device="cuda")[: B * max_pages]
    table = perm.reshape(B, max_pages).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, table, lens


def byte_flop_bound_ms(B, N, K, hd, page, lengths, window, q_bytes):
    """Least time for one call: live K/V rows read once, table entries read,
    q read and out written once; flops 4 per (query head, live element)."""
    live = [min(n, window) for n in lengths]
    kv_bytes = sum(2 * n * K * hd * 4 for n in live)
    table_bytes = sum(-(-n // page) * 4 for n in lengths) + B * 4
    io_bytes = 2 * B * N * hd * q_bytes
    flops = sum(4 * N * hd * n for n in live)
    t_bytes = (kv_bytes + table_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, flush: torch.Tensor, runs: int = 30, warmup: int = 5) -> float:
    """Median over `runs` of one call's CUDA-event time, L2 flushed before each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(runs):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# ----------------------------------------------------------------------------- phases
def card(pa):
    phase("card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    path, log = pa.build()
    print(f"built {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return smi


def kernel_vs_plain(ops, ref):
    """Max |kernel - plain| over the reference sweep and the serving shapes."""
    phase("kernel vs plain version")
    worst = 0.0
    cases = []
    # tests/test_kernels.py:54 sweep, fp32, both windows: atol 2e-5 (the reference's).
    for (B, N, K, hd, page, maxp) in [(2, 4, 2, 64, 16, 4), (3, 8, 8, 32, 8, 6),
                                      (1, 8, 1, 128, 32, 2)]:
        lengths = [page * maxp - 1 - 5 * i for i in range(B)]
        for window in (WINDOW_GLOBAL, 24):
            cases.append(((B, N, K, hd, page), lengths, window, torch.float32, 2e-5))
    # Serving shapes: gemma3-1b (N=4, K=1, hd=256), page 8, q bf16 over fp32 pages.
    # The output is rounded to bf16 (8-bit mantissa, ~4e-3 relative at |x| ~ 1),
    # and the two versions sum in different orders: 1e-2 absolute.
    # The last pair is the main path's own: max_batch 2, contexts up to 40 tokens.
    for B, lengths in ((4, [1, 8, 9, 513]), (4, [16, 511, 512, 700]), (2, [24, 40])):
        for window in (512, WINDOW_GLOBAL):
            cases.append(((B, 4, 1, 256, 8), lengths, window, torch.bfloat16, 1e-2))
            cases.append(((B, 4, 1, 256, 8), lengths, window, torch.float32, 2e-5))
    for i, ((B, N, K, hd, page), lengths, window, q_dtype, tol) in enumerate(cases):
        q, kp, vp, table, lens = paged_inputs(B, N, K, hd, page, lengths, q_dtype, seed=i)
        out = ops.paged_attention(q, kp, vp, table, lens, window, scale=hd ** -0.5)
        torch.cuda.synchronize()
        expect = ref.paged_attention_ref(q, kp, vp, table, lens, window, scale=hd ** -0.5)
        err = (out.float() - expect.float()).abs().max().item()
        dtype_name = str(q_dtype).removeprefix("torch.")
        print(f"  B{B} N{N} K{K} hd{hd} page{page} lengths {lengths} window {window} "
              f"{dtype_name}: max abs err {err:.3e} (tol {tol:g})")
        check(err <= tol, f"paged_attention disagrees with its plain version: {err} > {tol}")
        worst = max(worst, err)
    print(f"kernels: paged_attention max abs err {worst:.3e}")
    return worst


def timings(ops, ref, flush):
    """Kernel, plain version and SDPA yardstick at the serving and long shapes."""
    phase("times")
    rows = {}
    for label, (B, N, K, hd, page), length in [("serving", (4, 4, 1, 256, 8), 128),
                                               ("long", (8, 4, 1, 256, 8), 4096)]:
        lengths = [length] * B
        q, kp, vp, table, lens = paged_inputs(B, N, K, hd, page, lengths, torch.bfloat16,
                                              seed=100)
        scale = hd ** -0.5
        # The yardstick: one library call on pages gathered (untimed) into (B, N, T, hd).
        kg = kp[table.long()].reshape(B, -1, K, hd).repeat_interleave(N // K, 2)
        vg = vp[table.long()].reshape(B, -1, K, hd).repeat_interleave(N // K, 2)
        kg, vg = kg.transpose(1, 2).contiguous(), vg.transpose(1, 2).contiguous()
        q4 = q.float()[:, :, None]
        args = (q, kp, vp, table, lens, WINDOW_GLOBAL)
        ms = time_ms(functools.partial(ops.paged_attention, *args, scale=scale), flush)
        plain = time_ms(functools.partial(ref.paged_attention_ref, *args, scale=scale), flush)
        lib = time_ms(functools.partial(torch.nn.functional.scaled_dot_product_attention,
                                        q4, kg, vg, scale=scale), flush)
        bound, bound_by = byte_flop_bound_ms(B, N, K, hd, page, lengths, WINDOW_GLOBAL, 2)
        rows[label] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                       "bound_by": bound_by}
        print(f"  {label}: B{B} N{N} K{K} hd{hd} page{page} length {length} q bf16: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
              f"{bound_by} bound {bound:.4f} ms at 3.35 TB/s")
    return rows


def profile_steps(eng, args, n_steps: int = 20) -> None:
    """Where a serving step's time goes: the same request mix again, the first
    `n_steps` steps under torch.profiler; device busy time by kernel name and
    the device's idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(args.seed + 1)
    for _ in range(args.requests):
        prompt = torch.randint(0, eng.cfg.vocab_size, (args.prompt_len,), generator=g)
        eng.submit(prompt.tolist(), max_new_tokens=args.max_new)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            total, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (total + e.device_time_total, count + 1)
    busy_us = sum(t for t, _ in by_name.values())
    if busy_us == 0:
        print(f"profile of {n_steps} steps: the profiler recorded no device time")
        return
    print(f"profile of {n_steps} steps: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, device idle share {1 - busy_us / wall_us:.3f}")
    for name, (t, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t / 1e3:9.3f} ms {t / busy_us:6.1%} x{count:5d}  {name[:90]}")


def main_path(ops, ref):
    phase("main path: gemma3-1b full width, tiered paged KV")
    from repro_torch.core import emucxl
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.launch import serve
    import repro_torch.serving.engine as engine_mod
    import repro_torch.serving.paged_decode as pd_mod

    args = serve.parse_args(["--no-reduced", "--requests", "3", "--prompt-len", "24",
                             "--max-new", "16", "--page-size", "8", "--max-batch", "2",
                             "--slots", "10", "--max-steps", "400", "--device", "cuda"])
    t0 = time.perf_counter()
    eng = serve.build(args)
    torch.cuda.synchronize()
    cfg = eng.cfg
    print(f"built engine in {time.perf_counter() - t0:.2f} s: {cfg.name} "
          f"L{cfg.num_layers} D{cfg.d_model} N{cfg.num_heads} K{cfg.num_kv_heads} "
          f"hd{cfg.resolved_head_dim} F{cfg.d_ff} V{cfg.vocab_size}")
    lib = eng.pool.session.lib
    # Observe (not alter) each step's logits for finiteness, without a host sync.
    finite = []
    decode = engine_mod.paged_decode_step

    def observed(*a, **kw):
        logits, kp, vp = decode(*a, **kw)
        finite.append(torch.isfinite(logits).all())
        return logits, kp, vp

    engine_mod.paged_decode_step = observed
    peak_remote, remote_recs, step_ms = 0, 0, []
    pa.launches = 0
    t_run = time.perf_counter()
    try:
        steps = 0
        while steps < args.max_steps and any(r.state != "finished"
                                             for r in eng.requests.values()):
            ts = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
            steps += 1
            peak_remote = max(peak_remote, lib.stats(emucxl.REMOTE_MEMORY))
            for rec in lib.allocations().values():
                if rec.node == emucxl.REMOTE_MEMORY:
                    remote_recs += 1
                    check(rec.data.is_pinned(), "a REMOTE allocation is not pinned")
    finally:
        engine_mod.paged_decode_step = decode
    wall = time.perf_counter() - t_run
    launches = pa.launches
    stats = eng.tier_stats()
    generated = sum(len(r.generated) for r in eng.requests.values())
    print(f"steps {steps}, decode batches {eng.decode_batches}, kernel launches {launches}, "
          f"preemptions {eng.preemptions}, peak remote bytes {peak_remote}, "
          f"pinned REMOTE records seen {remote_recs}")
    print(f"tier stats: {stats}")
    check(all(len(r.generated) == args.max_new for r in eng.requests.values()),
          "a request did not generate all its tokens")
    check(eng.preemptions > 0, "no preemption: the hot pool was never under pressure")
    check(peak_remote > 0 and remote_recs > 0, "no bytes reached the REMOTE tier")
    check(launches > 0, "the main path never launched the paged_attention kernel")
    check(launches == eng.decode_batches * cfg.num_layers,
          f"kernel launches {launches} != decode batches x layers")
    check(all(bool(f) for f in finite), "non-finite logits on the main path")
    print(f"serving: {steps / wall:.2f} steps/s, {generated / wall:.2f} generated tokens/s, "
          f"median step {statistics.median(step_ms):.2f} ms, wall {wall:.2f} s")
    profile_steps(eng, args)

    # The same decode steps with the kernel and with the plain version, from the same pools.
    B, page, maxp, n_steps = 2, 8, 4, 12
    shape = (cfg.num_layers, B * maxp, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    table = torch.arange(B * maxp, dtype=torch.int32, device="cuda").reshape(B, maxp)
    toks = torch.randint(0, cfg.vocab_size, (B, n_steps), dtype=torch.int32, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    logits = {}
    for name, attention in (("kernel", ops.paged_attention), ("plain", ref.paged_attention_ref)):
        k_pool = torch.zeros(shape, device="cuda")
        v_pool = torch.zeros(shape, device="cuda")
        pd_mod.paged_attention = attention
        try:
            logits[name] = [
                pd_mod.paged_decode_step(eng.params, cfg, k_pool, v_pool, table,
                                         torch.full((B,), t, dtype=torch.int32, device="cuda"),
                                         toks[:, t : t + 1])[0]
                for t in range(n_steps)]
        finally:
            pd_mod.paged_attention = ops.paged_attention
    diff = max((a - b).abs().max().item() for a, b in zip(logits["kernel"], logits["plain"],
                                                          strict=True))
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum()) for a, b in
                zip(logits["kernel"], logits["plain"], strict=True)) / (B * n_steps)
    check(all(bool(torch.isfinite(x).all()) for x in logits["kernel"]), "non-finite logits")
    print(f"decode {n_steps} steps x B{B}, kernel vs plain attention: max |logit diff| "
          f"{diff:.4e}, argmax agreement {agree:.3f}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.kernels.paged_attention import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card(pa)
    worst = kernel_vs_plain(ops, ref)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")   # > 50 MB L2
    rows = timings(ops, ref, flush)
    del flush
    launches = main_path(ops, ref)
    serving = rows["serving"]
    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/paged_attention.py:93",
        "launches": launches, "max_abs_err": worst, "ms": serving["ms"],
        "plain_ms": serving["plain_ms"], "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"], "library_ms": serving["library_ms"],
        "long_context": rows["long"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
