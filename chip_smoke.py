"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each of which raises (and so exits non-zero) on failure, each
printed with the wall time of the phase before it:
  1. card: name and power limit, torch/CUDA versions; the four CUDA kernels
     built together, one nvcc per source, each in its own thread, with
     ptxas's registers and spills for every instantiation, and 0 spill bytes
     checked for the scans' instantiations on the prefill paths; then each
     kernel's wrapper called under grad with an input that requires grad,
     which must raise before it launches;
  2. the paged-attention kernel against its plain PyTorch version on the card,
     at the reference's sweep shapes, the serving shapes, the edges of its
     64-token partitions, and the published group sizes and head dims past
     the first four (G 7 at hd 128, G 12 at hd 192, hd 80) and olmoe-1b-7b's
     serving shape;
  3. times (median of CUDA-event-timed runs, L2 flushed before each) of that
     kernel, its plain version and a library yardstick, beside the byte bound
     and the bytes a second the kernel reached: at the serving path's shape
     (one partition), a table of two partitions and a long context, with the
     wrapper's host time a call and a profile of flushed calls; then at
     olmoe-1b-7b's serving shape and at G 7 and G 12;
  4. the serving path at full width: ``repro_torch.launch.serve`` serving
     gemma3-1b (26 layers, d_model 1152) with random bf16 weights, KV pages
     preempted into pinned host memory and promoted back; the kernel's launch
     count must equal decode steps x layers; a torch.profiler breakdown of 20
     more steps of the same request mix; then decode steps with the kernel and
     with the plain version from the same pools;
  5. the flash-attention kernel against its plain version: the reference's
     sweep (fp32 and bf16, causal and not), the bf16 tensor-core kernel's
     edges (every head dim, ragged S, windows about a tile, non-causal), hd
     80 (non-causal) and 192 (causal and sliding), and the prefill shapes of
     gemma3-1b, zamba2-1.2b and olmoe-1b-7b, in fp32 and in bf16;
  6. the Mamba2 SSD kernel against its plain versions: the reference's sweep
     and zamba2-1.2b's shape;
  7. the WKV6 kernel against its plain versions: the reference's sweep and
     rwkv6-3b's shape;
  8. times of the three prefill kernels, their plain versions and, for
     attention, SDPA as a yardstick, beside the bound at the path shapes and
     at hd 80 and 192 (for the scans both the operations and the bytes
     bound), the flops a second flash attention reached, and a profile of
     flushed calls of each scan that gives each of its passes' own device
     time;
  9. the prefill path at full width for gemma3-1b, zamba2-1.2b, rwkv6-3b and
     then olmoe-1b-7b (MoE, moe_impl="ep"), each model freed before the next
     is built:
     ``forward(collect_kv=True, last_only=True)`` at B=2 x 2048 tokens with
     the kernels, checked launch counts per forward, then 16 ``decode_step``s
     from the prefill's caches; a torch.profiler breakdown of one forward;
     every kernel call of one more prefill held against its plain version on
     the same inputs; the same prefill with the plain versions swapped in,
     compared (for zamba2 also plain against plain at another SSD chunk; for
     rwkv6-3b within stated bounds on the logits and the WKV states). For
     olmoe-1b-7b also every MoE call of a prefill held against the dense
     oracle on the same activations, one layer in fp32 against it, the
     device time of the expert products and of the routing, sort and scatter
     around them, and the host time of the group sizes' copy;
 10. the serving path at full width again, for olmoe-1b-7b (16 layers, 64
     experts top-8) through the same engine set-up as phase 4.
The last two lines are a JSON ``kernels`` record and a JSON result line.

Float32 matmuls run in full precision (TF32 off), so fp32 comparisons on the
card mean what they say.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
from concurrent.futures import ThreadPoolExecutor
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM data sheet, bf16 dense on the tensor cores
WINDOW_GLOBAL = 2**30
# A bf16 output is held at |kernel - plain| <= BF16_RTOL * |plain| + BF16_ATOL:
# both sides compute in fp32 and round once to bf16 (8-bit significand), so
# they differ by at most one bf16 ulp, 2^-7 = 7.8e-3 of |plain|.
BF16_RTOL, BF16_ATOL = 8e-3, 1e-4
# WKV6 kernel against its plain chunked form on the same inputs, relative to
# the plain output's largest |value| with no floor at 1 (rwkv6-3b's y and
# states sit near 1e-2): both do fp32 arithmetic on the same fp32 values,
# summed in other orders (~1e-6 of the magnitude); a lost chunk is O(1).
WKV_RTOL = 1e-4
# rwkv6-3b's whole prefill in fp32, kernels against plain versions: the last
# logits (|logit| ~ 5) absolutely, the WKV states relative to their largest
# |value|. In bf16 a one-ulp rounding flip grows to O(1) over 32 layers of
# random weights, so the bf16 comparison is printed beside the plain forms'
# own spread and not bounded.
RWKV_FP32_LOGIT_ATOL, RWKV_FP32_STATE_RTOL = 5e-3, 1e-3
# An MoE call of a bf16 prefill (moe_impl="ep") against the dense oracle on
# the same activations, element by element: |ep - dense| <= (k + 4) u S, u =
# 2^-8 the bf16 unit roundoff and S = sum_e w_e |y_e| the sum of the k
# weighted expert outputs' magnitudes. The oracle sums its terms in fp32 and
# rounds once (u S); ep rounds each product w_e y_e (u S in all) and each of
# the k adds of its bf16 scatter-add (k u S); an expert output rounded to the
# other side of a bf16 boundary by another summation order adds 2 u S. A
# dropped assignment or a wrong expert moves an element by a whole term.
MOE_BF16_ROUNDINGS = 4
# One full-width MoE layer in fp32, ep against dense: 1e-4 of max |dense|
# (fp32 sums in other orders; nothing is rounded to bf16).
MOE_FP32_RTOL = 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


_CLOCK = {"start": time.perf_counter(), "phase": time.perf_counter()}


def phase(name: str) -> None:
    """Start phase `name`, printing the wall time of the one before it."""
    now = time.perf_counter()
    print(f"   [{now - _CLOCK['phase']:.1f} s; {now - _CLOCK['start']:.1f} s in all]")
    _CLOCK["phase"] = now
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


def paged_bytes(B, N, K, hd, page, lengths, window, q_bytes):
    """Bytes one call must move: live K/V rows read once, table entries read,
    q read and out written once."""
    live = [min(n, window) for n in lengths]
    kv_bytes = sum(2 * n * K * hd * 4 for n in live)
    table_bytes = sum(-(-n // page) * 4 for n in lengths) + B * 4
    return kv_bytes + table_bytes + 2 * B * N * hd * q_bytes


def byte_flop_bound_ms(B, N, K, hd, page, lengths, window, q_bytes):
    """Least time for one call: `paged_bytes` over the memory rate, or the
    flops, 4 per (query head, live element), over the fp32 rate."""
    flops = sum(4 * N * hd * min(n, window) for n in lengths)
    t_bytes = paged_bytes(B, N, K, hd, page, lengths, window, q_bytes) / HBM_BYTES_PER_S * 1e3
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


def kernel_modules() -> dict:
    """Each kernel's wrapper module, which holds its `launches` count."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd as sm
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk

    return {"paged_attention": pa, "flash_attention": fa, "mamba2_ssd": sm, "wkv6": wk}


def zero_counts() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in kernel_modules().items()}


# ----------------------------------------------------------------------------- phases
def card():
    phase("card")
    from repro_torch.kernels import _nvcc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    sources = [mod.SOURCE for mod in kernel_modules().values()]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_nvcc.build, sources))
    print(f"built {', '.join(path.name for path, _ in built)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for path, log in built:
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {path.stem}: {line.strip()}")
    check_path_spills({src.stem: log for src, (_, log) in zip(sources, built, strict=True)})
    return smi


# The instantiations the prefill paths launch (bf16, zamba2's chunk 32 and
# P = N = 64; rwkv6-3b's chunk 16 and K = V = 64), by their mangled names.
PATH_ENTRIES = {
    "mamba2_ssd": ("ssd_chunk_kernelILi32E13__nv_bfloat16", "ssd_state_kernel",
                   "ssd_output_kernelILi32E13__nv_bfloat16"),
    "rwkv6_scan": ("wkv6_step_kernelILi64E13__nv_bfloat16", "wkv6_state_kernel",
                   "wkv6_output_kernelILi16ELi64ELi1E13__nv_bfloat16"),
}


def spills(log: str) -> dict:
    """Spill bytes (stores + loads) by entry name, from nvcc's -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[name] = nums[1] + nums[2]   # stack frame, spill stores, spill loads
    return out


def check_path_spills(logs: dict) -> None:
    """Every instantiation the prefill paths launch spills 0 bytes."""
    for stem, entries in PATH_ENTRIES.items():
        if not logs.get(stem):
            print(f"  ptxas {stem}: cached build, no log to check")
            continue
        found = spills(logs[stem])
        for entry in entries:
            hits = [n for n in found if entry in n]
            check(len(hits) == 1, f"ptxas reported no single entry matching {entry}")
            print(f"  path entry {entry}: {found[hits[0]]} spill bytes")
            check(found[hits[0]] == 0, f"{entry} spills {found[hits[0]]} bytes")


def grad_refusal() -> None:
    """Each CUDA wrapper, called under grad with an input that requires grad,
    raises NotImplementedError before it launches; under no_grad it runs."""
    phase("grad refusal: each kernel under grad")
    mods = kernel_modules()
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    table = torch.arange(4, dtype=torch.int32, device="cuda").reshape(2, 2)
    lengths = torch.tensor([5, 12], dtype=torch.int32, device="cuda")
    calls = {
        "flash_attention": (lambda q: mods["flash_attention"].flash_attention(
            q, rn(1, 16, 2, 64), rn(1, 16, 2, 64), window=WINDOW_GLOBAL, scale=0.125),
            rn(1, 16, 2, 64)),
        "paged_attention": (lambda q: mods["paged_attention"].paged_attention(
            q, rn(4, 8, 2, 64), rn(4, 8, 2, 64), table, lengths, WINDOW_GLOBAL, scale=0.125),
            rn(2, 2, 64)),
        "mamba2_ssd": (lambda x: mods["mamba2_ssd"].ssd_pallas(
            x, rn(1, 20, 2).abs(), -rn(2).abs(), rn(1, 20, 8), rn(1, 20, 8), rn(2),
            rn(1, 2, 8, 8)), rn(1, 20, 2, 8)),
        "wkv6": (lambda r: mods["wkv6"].wkv6_pallas(
            r, rn(1, 20, 2, 16), rn(1, 20, 2, 16), torch.rand((1, 20, 2, 16), device="cuda"),
            rn(2, 16), rn(1, 2, 16, 16)), rn(1, 20, 2, 16)),
    }
    for name, (call, x) in calls.items():
        before = mods[name].launches
        try:
            call(x.requires_grad_())
        except NotImplementedError as e:
            check("ROADMAP A.9" in str(e), f"{name}: the refusal does not name A.9: {e}")
        else:
            raise RuntimeError(f"chip_smoke: {name} ran under grad with an input "
                               f"that requires grad")
        check(mods[name].launches == before, f"{name} launched before refusing")
        with torch.no_grad():
            call(x)
        torch.cuda.synchronize()
        check(mods[name].launches == before + 1, f"{name} did not launch under no_grad")
        print(f"  {name}: raises NotImplementedError under grad, launches under no_grad")


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
    # The kernel's 64-token partitions: lengths 1 and about one and two
    # partitions, windows that cut a page and a partition, lengths 100x apart.
    for B, lengths, windows in ((7, [1, 63, 64, 65, 127, 128, 129], (100, WINDOW_GLOBAL)),
                                (2, [40, 4000], (512, WINDOW_GLOBAL)),
                                (3, [130, 300, 1000], (1, 130))):
        for window in windows:
            cases.append(((B, 4, 1, 256, 8), lengths, window, torch.bfloat16, 1e-2))
            cases.append(((B, 4, 1, 256, 8), lengths, window, torch.float32, 2e-5))
    cases.append(((3, 8, 2, 64, 16), [1, 200, 2000], 130, torch.float32, 2e-5))
    # Published groups and head dims past {1, 2, 4, 8} x {32, 64, 128, 256}:
    # deepseek-coder-33b's G 7 at hd 128, nemotron-4-340b's G 12 at hd 192 and
    # hubert-xlarge's hd 80, each with one partition and with several; and
    # olmoe-1b-7b's serving shape (N16 K16 hd128, page 8, contexts to 40).
    for (B, N, K, hd), lengths in (((2, 56, 8, 128), [24, 40]), ((2, 56, 8, 128), [40, 700]),
                                   ((2, 96, 8, 192), [24, 40]), ((2, 96, 8, 192), [130, 1000]),
                                   ((2, 16, 16, 80), [24, 40]), ((3, 16, 16, 80), [1, 65, 300]),
                                   ((2, 16, 16, 128), [24, 40])):
        for window in (WINDOW_GLOBAL, 100):
            cases.append(((B, N, K, hd, 8), lengths, window, torch.bfloat16, 1e-2))
            cases.append(((B, N, K, hd, 8), lengths, window, torch.float32, 2e-5))
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


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call in us: `calls` calls enqueued back to back, with
    no sync between them, so the device's time is not counted."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def timings(ops, ref, flush):
    """Kernel, plain version and SDPA yardstick at three shapes: the serving
    path's own (a 5-page table, one partition, no combine), a 16-page table
    (two partitions and the combine) and a long context; then olmoe-1b-7b's
    serving shape, and G 7 (deepseek-coder-33b) and G 12 at hd 192
    (nemotron-4-340b) at a 1024-token context, without the profiles."""
    from repro_torch.kernels.paged_attention.paged_attention import num_partitions

    phase("times")
    rows = {}
    for label, (B, N, K, hd, page), length in [("serving", (2, 4, 1, 256, 8), 40),
                                               ("two_partitions", (4, 4, 1, 256, 8), 128),
                                               ("long", (8, 4, 1, 256, 8), 4096),
                                               ("olmoe_serving", (2, 16, 16, 128, 8), 40),
                                               ("g7_hd128", (2, 56, 8, 128, 8), 1024),
                                               ("g12_hd192", (2, 96, 8, 192, 8), 1024)]:
        lengths = [length] * B
        parts = num_partitions(-(-length // page), page)
        q, kp, vp, table, lens = paged_inputs(B, N, K, hd, page, lengths, torch.bfloat16,
                                              seed=100)
        scale = hd ** -0.5
        # The yardstick: one library call on pages gathered (untimed) into (B, N, T, hd).
        kg = kp[table.long()].reshape(B, -1, K, hd).repeat_interleave(N // K, 2)
        vg = vp[table.long()].reshape(B, -1, K, hd).repeat_interleave(N // K, 2)
        kg, vg = kg.transpose(1, 2).contiguous(), vg.transpose(1, 2).contiguous()
        q4 = q.float()[:, :, None]
        args = (q, kp, vp, table, lens, WINDOW_GLOBAL)
        kernel = functools.partial(ops.paged_attention, *args, scale=scale)
        ms = time_ms(kernel, flush)
        plain = time_ms(functools.partial(ref.paged_attention_ref, *args, scale=scale), flush)
        lib = time_ms(functools.partial(torch.nn.functional.scaled_dot_product_attention,
                                        q4, kg, vg, scale=scale), flush)
        bound, bound_by = byte_flop_bound_ms(B, N, K, hd, page, lengths, WINDOW_GLOBAL, 2)
        moved = paged_bytes(B, N, K, hd, page, lengths, WINDOW_GLOBAL, 2)
        rows[label] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                       "bound_by": bound_by}
        print(f"  {label}: B{B} N{N} K{K} hd{hd} page{page} length {length} q bf16, "
              f"{parts} partition(s){' + combine' if parts > 1 else ''}: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
              f"{bound_by} bound {bound:.4f} ms at 3.35 TB/s; kernel "
              f"{moved / ms / 1e6:.1f} GB/s ({moved / 1e6:.2f} MB)")
        # Whether `ms` holds host time: the wrapper's enqueue against the
        # flush's device time, and the kernels' own device time after a flush.
        print(f"  {label}: wrapper enqueue {host_us(kernel):.1f} us a call on the host")
        if label not in ("serving", "two_partitions", "long"):
            continue

        def flushed_calls():
            for _ in range(20):
                flush.zero_()
                kernel()

        profiled(flushed_calls, f"20 x (L2 flush, kernel) at the {label} shape")
    return rows


def print_profile(prof, wall_us: float, what: str) -> None:
    """Device busy time by kernel name and the device's idle share of `wall_us`."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            total, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (total + e.device_time_total, count + 1)
    busy_us = sum(t for t, _ in by_name.values())
    if busy_us == 0:
        print(f"profile of {what}: the profiler recorded no device time")
        return 0.0, by_name
    print(f"profile of {what}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, device idle share {1 - busy_us / wall_us:.3f}")
    for name, (t, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t / 1e3:9.3f} ms {t / busy_us:6.1%} x{count:5d}  {name[:90]}")
    return busy_us, by_name


def profiled(fn, what: str):
    """Run `fn` once under torch.profiler and print where the device time went.
    Returns the device's busy time in us and {kernel name: (us, count)}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return print_profile(prof, wall_us, what)


def profile_steps(eng, args, n_steps: int = 20) -> None:
    """Where a serving step's time goes: the same request mix again, the first
    `n_steps` steps under torch.profiler."""
    g = torch.Generator().manual_seed(args.seed + 1)
    for _ in range(args.requests):
        prompt = torch.randint(0, eng.cfg.vocab_size, (args.prompt_len,), generator=g)
        eng.submit(prompt.tolist(), max_new_tokens=args.max_new)

    def steps():
        for _ in range(n_steps):
            eng.step()

    profiled(steps, f"{n_steps} steps")


def main_path(ops, ref, arch: str = "gemma3-1b"):
    """Serve `arch` at full width through ``repro_torch.launch.serve``: 3
    requests of 24 + 16 tokens, page 8, 10 hot slots, max_batch 2, Policy1.
    Returns the paged kernel's launches."""
    phase(f"main path: {arch} full width, tiered paged KV")
    from repro_torch.core import emucxl
    from repro_torch.launch import serve
    import repro_torch.serving.engine as engine_mod
    import repro_torch.serving.paged_decode as pd_mod

    gc.collect()
    torch.cuda.empty_cache()
    if emucxl.default_instance()._initialized:   # a fresh pool for each served model
        emucxl.default_instance().exit()
    args = serve.parse_args(["--arch", arch, "--no-reduced", "--requests", "3",
                             "--prompt-len", "24", "--max-new", "16", "--page-size", "8",
                             "--max-batch", "2", "--slots", "10", "--max-steps", "400",
                             "--device", "cuda"])
    t0 = time.perf_counter()
    eng = serve.build(args)
    torch.cuda.synchronize()
    cfg = eng.cfg
    moe = (f" experts {cfg.num_experts} top-{cfg.experts_per_token} expert F{cfg.moe_d_ff}, "
           f"moe_impl {eng.opts.moe_impl!r}" if cfg.moe else "")
    print(f"built engine in {time.perf_counter() - t0:.2f} s: {cfg.name} "
          f"L{cfg.num_layers} D{cfg.d_model} N{cfg.num_heads} K{cfg.num_kv_heads} "
          f"hd{cfg.resolved_head_dim} F{cfg.d_ff} V{cfg.vocab_size}{moe}")
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
    zero_counts()
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
    counts = read_counts()
    launches = counts["paged_attention"]
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
    check(all(n == 0 for name, n in counts.items() if name != "paged_attention"),
          f"the serving path launched a prefill kernel: {counts}")
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
                                         toks[:, t : t + 1], eng.opts)[0]
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
    del eng
    return launches


# ------------------------------------------------------------------ prefill kernels
def flash_inputs(B, S, N, K, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn((B, S, N, hd), generator=g, device="cuda") * 0.5).to(dtype)
    k = (torch.randn((B, S, K, hd), generator=g, device="cuda") * 0.5).to(dtype)
    v = (torch.randn((B, S, K, hd), generator=g, device="cuda") * 0.5).to(dtype)
    return q, k, v


def ssd_inputs(B, T, H, P, N, dtype, seed):
    """The reference sweep's draws (tests/test_kernels.py:109), x/B/C in `dtype`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((B, T, H, P), generator=g, device="cuda") * 0.5).to(dtype)
    dt = torch.rand((B, T, H), generator=g, device="cuda") * (2.0 - 1e-3) + 1e-3
    A = -(torch.rand((H,), generator=g, device="cuda") * 7.5 + 0.5)
    Bm = (torch.randn((B, T, N), generator=g, device="cuda") * 0.5).to(dtype)
    C = (torch.randn((B, T, N), generator=g, device="cuda") * 0.5).to(dtype)
    D = torch.randn((H,), generator=g, device="cuda") * 0.05
    h0 = torch.randn((B, H, P, N), generator=g, device="cuda") * 0.05
    return x, dt, A, Bm, C, D, h0


def wkv6_inputs(B, T, H, K, V, dtype, seed):
    """The reference sweep's draws (tests/test_kernels.py:77), r/k/v in `dtype`;
    w in [1e-5, 0.999], u and the initial state nonzero, all fp32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = (torch.randn((B, T, H, K), generator=g, device="cuda") * 0.5).to(dtype)
    k = (torch.randn((B, T, H, K), generator=g, device="cuda") * 0.5).to(dtype)
    v = (torch.randn((B, T, H, V), generator=g, device="cuda") * 0.5).to(dtype)
    w = torch.rand((B, T, H, K), generator=g, device="cuda") * (0.999 - 1e-5) + 1e-5
    u = torch.randn((H, K), generator=g, device="cuda") * 0.1
    s0 = torch.randn((B, H, K, V), generator=g, device="cuda") * 0.1
    return r, k, v, w, u, s0


def max_rel(out, ref) -> float:
    """Largest |out - ref| over the largest |ref|, with no floor."""
    return ((out.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


# gemma3-1b: 4 query heads over 1 KV head at hd 256, sliding 512 and global;
# zamba2-1.2b's shared attention: 32 heads at hd 64; olmoe-1b-7b: 16 heads
# over 16 at hd 128. B=2 x 2048 as on the path.
FLASH_PATH = {"gemma3_global": ((2, 2048, 4, 1, 256), WINDOW_GLOBAL),
              "gemma3_sliding": ((2, 2048, 4, 1, 256), 512),
              "zamba2": ((2, 2048, 32, 32, 64), WINDOW_GLOBAL),
              "olmoe": ((2, 2048, 16, 16, 128), WINDOW_GLOBAL)}
# Head dims past {32, 64, 128, 256} at their published configs' widths, on no
# path yet: hubert-xlarge (16 heads of 80, non-causal) and nemotron-4-340b (96
# query heads over 8 KV heads of 192, causal). (shape, window, causal)
FLASH_WIDE = {"hubert_hd80": ((2, 2048, 16, 16, 80), WINDOW_GLOBAL, False),
              "nemotron_hd192": ((1, 2048, 96, 8, 192), WINDOW_GLOBAL, True)}
SSD_PATH = (2, 2048, 64, 64, 64)     # zamba2-1.2b: B, T, H, P, N at chunk 32
WKV_PATH = (2, 2048, 40, 64, 64)     # rwkv6-3b: B, T, H, K, V at chunk 16


def flash_vs_plain():
    """Max |kernel - plain| over the reference sweep and the path shapes."""
    phase("flash attention: kernel vs plain version")
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    cases = []   # (shape, window, causal, dtype, atol, rtol)
    # tests/test_kernels.py:27: fp32 at 2e-5, bf16 at 2e-2 (the reference's).
    for shape in [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 384, 4, 1, 128),
                  (2, 200, 2, 2, 32)]:
        for window in (WINDOW_GLOBAL, 64):
            cases.append((shape, window, True, torch.float32, 2e-5, 0.0))
            cases.append((shape, window, True, torch.bfloat16, 2e-2, 0.0))
    cases.append(((2, 128, 4, 4, 64), WINDOW_GLOBAL, False, torch.float32, 2e-5, 0.0))
    # hd 80 (non-causal, hubert's case; rows padded to 128 in shared memory)
    # and hd 192 (causal and sliding): fp32 at 2e-5, bf16 within one bf16 ulp.
    for shape, window, causal in (((2, 1000, 16, 16, 80), WINDOW_GLOBAL, False),
                                  ((1, 1000, 4, 2, 80), 100, True),
                                  ((1, 1000, 12, 1, 192), WINDOW_GLOBAL, True),
                                  ((1, 1000, 12, 1, 192), 100, True)):
        cases.append((shape, window, causal, torch.float32, 2e-5, 0.0))
        cases.append((shape, window, causal, torch.bfloat16, BF16_ATOL, BF16_RTOL))
    # The bf16 tensor-core kernel's edges within one bf16 ulp: every head dim,
    # S not a multiple of its tiles, windows about a 64-key tile, non-causal.
    for hd in (32, 64, 128, 256):
        for window in (1, 63, 64, 65):
            cases.append(((1, 1000, 4, 2, hd), window, True, torch.bfloat16, BF16_ATOL,
                          BF16_RTOL))
        cases.append(((2, 200, 4, 1, hd), WINDOW_GLOBAL, True, torch.bfloat16, BF16_ATOL,
                      BF16_RTOL))
        cases.append(((2, 200, 4, 4, hd), WINDOW_GLOBAL, False, torch.bfloat16, BF16_ATOL,
                      BF16_RTOL))
    # The path's shapes, each template instantiation it runs: fp32 at 2e-5, and
    # bf16 within one bf16 ulp of |plain|. Outputs there are ~0.01-0.02, so a
    # flat 2e-2 would not tell a dropped k tile from rounding.
    for shape, window in FLASH_PATH.values():
        cases.append((shape, window, True, torch.float32, 2e-5, 0.0))
        cases.append((shape, window, True, torch.bfloat16, BF16_ATOL, BF16_RTOL))
    worst = 0.0
    for i, (shape, window, causal, dtype, atol, rtol) in enumerate(cases):
        q, k, v = flash_inputs(*shape, dtype, seed=i)
        scale = shape[-1] ** -0.5
        out = flash_attention(q, k, v, window=window, scale=scale, causal=causal)
        torch.cuda.synchronize()
        expect = attention_ref(q, k, v, window, scale=scale, causal=causal).float()
        diff = (out.float() - expect).abs()
        err = diff.max().item()
        within = bool((diff <= atol + rtol * expect.abs()).all())
        tol = f"{atol:g}" + (f" + {rtol:g} |plain|" if rtol else "")
        print("  B{} S{} N{} K{} hd{}".format(*shape) + f" window {window} causal {causal} "
              f"{str(dtype).removeprefix('torch.')}: max abs err {err:.3e}, max |plain| "
              f"{expect.abs().max().item():.3e} (tol {tol})")
        check(within, f"flash_attention disagrees with its plain version beyond {tol}")
        worst = max(worst, err)
        del q, k, v, out, expect, diff
    print(f"kernels: flash_attention max abs err {worst:.3e}")
    return worst


def ssd_vs_plain():
    """Max |kernel - plain| of y and the final state: the reference's sweep
    against the step-by-step oracle, the path shape against the plain chunked
    form (both fp32 arithmetic; atol 5e-4, the reference's)."""
    phase("mamba2 ssd: kernel vs plain version")
    from repro_torch.kernels.mamba2_ssd.ops import _ssd_chunked, ssd
    from repro_torch.kernels.mamba2_ssd.ref import ssd_ref

    cases = [((2, 64, 2, 16, 8), 16, torch.float32, ssd_ref),
             ((1, 45, 4, 8, 16), 16, torch.float32, ssd_ref),
             ((1, 45, 4, 8, 16), 16, torch.bfloat16, ssd_ref),
             (SSD_PATH, 32, torch.bfloat16,
              lambda *a: _ssd_chunked(*a, chunk=32))]
    worst = 0.0
    for i, (shape, chunk, dtype, plain) in enumerate(cases):
        args = ssd_inputs(*shape, dtype, seed=100 + i)
        y, h = ssd(*args, impl="pallas", chunk=chunk)
        torch.cuda.synchronize()
        y_ref, h_ref = plain(*args)
        err = max((y - y_ref).abs().max().item(), (h - h_ref).abs().max().item())
        print("  B{} T{} H{} P{} N{}".format(*shape) + f" chunk {chunk} "
              f"{str(dtype).removeprefix('torch.')}: max abs err {err:.3e} (tol 5e-4)")
        check(err <= 5e-4, f"ssd kernel disagrees with its plain version: {err} > 5e-4")
        worst = max(worst, err)
    print(f"kernels: mamba2_ssd max abs err {worst:.3e}")
    return worst


def wkv6_vs_plain():
    """The reference's sweep against the step-by-step oracle at its 3e-4, in
    fp32 and with bf16 r/k/v, at both chunks the kernel has; the path's shape
    (bf16 r/k/v) against the plain chunked form, at WKV_RTOL of its largest
    |value|. Returns the largest |kernel - plain| of y and the state."""
    phase("wkv6: kernel vs plain version")
    from repro_torch.kernels.rwkv6_scan.ops import _wkv6_chunked, wkv6
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

    worst = 0.0
    cases = [(shape, chunk, dtype) for shape in [(2, 64, 2, 16, 16), (1, 50, 4, 32, 32)]
             for chunk in (16, 32) for dtype in (torch.float32, torch.bfloat16)]
    for i, (shape, chunk, dtype) in enumerate(cases):
        args = wkv6_inputs(*shape, dtype, seed=300 + i)
        y, s = wkv6(*args, impl="pallas", chunk=chunk)
        torch.cuda.synchronize()
        y_ref, s_ref = wkv6_ref(*args)
        err = max((y - y_ref).abs().max().item(), (s - s_ref).abs().max().item())
        print("  B{} T{} H{} K{} V{}".format(*shape) + f" chunk {chunk} "
              f"{str(dtype).removeprefix('torch.')}: max abs err {err:.3e} (tol 3e-4)")
        check(err <= 3e-4, f"wkv6 kernel disagrees with its oracle: {err} > 3e-4")
        worst = max(worst, err)
    args = wkv6_inputs(*WKV_PATH, torch.bfloat16, seed=310)
    y, s = wkv6(*args, impl="pallas")
    torch.cuda.synchronize()
    y_ref, s_ref = _wkv6_chunked(*args, chunk=16)
    err = max(max_rel(y, y_ref), max_rel(s, s_ref))
    print("  B{} T{} H{} K{} V{}".format(*WKV_PATH) + f" chunk 16 r/k/v bf16: max |diff| / "
          f"max |plain| {err:.3e} (tol {WKV_RTOL:g}); max |y| {y_ref.abs().max().item():.3e}, "
          f"max |state| {s_ref.abs().max().item():.3e}")
    check(err <= WKV_RTOL, f"wkv6 kernel disagrees with its plain version: {err} > {WKV_RTOL}")
    worst = max(worst, (y - y_ref).abs().max().item(), (s - s_ref).abs().max().item())
    print(f"kernels: wkv6 max abs err {worst:.3e}")
    return worst


def flash_flops(B, S, N, hd, window, causal=True):
    """Flops the function needs: 4 * hd per unmasked (q, k) pair and head
    (T = S; every pair when not causal)."""
    pairs = sum(q - max(0, q - window + 1) + 1 for q in range(S)) if causal else S * S
    return 4 * B * N * hd * pairs


def flash_bound_ms(B, S, N, K, hd, window, elem_bytes, peak, causal=True):
    """Least time: `flash_flops` over the dtype's peak; bytes q, k, v read and
    the output written once."""
    t_ops = flash_flops(B, S, N, hd, window, causal) / peak * 1e3
    t_bytes = (2 * B * S * N * hd + 2 * B * S * K * hd) * elem_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ssd_bounds_ms(B, T, H, P, N, chunk, elem_bytes):
    """The operations and the bytes bound of one call, in ms. Operations: the
    chunked algorithm's fp32 flops over the fp32 peak (the kernel runs them on
    the CUDA cores), counting only the c(c+1)/2 causal pairs s <= t of the
    intra-chunk products: C B^T, c(c+1)N, once per (b, chunk), since B and C
    are one group shared by every head; per (b, head, chunk) the scores
    against x, c(c+1)P, and 4cPN for C H^T and the state update. Bytes: x, dt,
    B, C, A, D and the state read once, y and the state written once."""
    nc = -(-T // chunk)
    flops = (B * nc * chunk * (chunk + 1) * N
             + B * H * nc * (chunk * (chunk + 1) * P + 4 * chunk * P * N))
    bytes_ = (B * T * H * P * elem_bytes + B * T * H * 4 + 2 * B * T * N * elem_bytes
              + 2 * H * 4 + 2 * B * H * P * N * 4 + B * T * H * P * 4)
    return flops / FP32_FLOPS_PER_S * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3


def wkv6_bounds_ms(B, T, H, K, V, chunk, elem_bytes):
    """The operations and the bytes bound of one call, in ms, and the
    operations bound were every flop fp32 on the CUDA cores. The kernel forms
    the pair scores' decays on the CUDA cores (3K fp32 flops for each of the
    c(c-1)/2 strict pairs and the c diagonal u terms) and runs the products
    on the tensor cores: 2V for each score against v, 2cKV for y from the
    state and 2cKV for the state update, counted once at the bf16 peak (the
    bf16 hi and lo parts it splits fp32 operands into are its own extra
    work). Bytes: r, k, v (`elem_bytes`), w, u and the state read once, y and
    the state written once."""
    nc = -(-T // chunk)
    terms = chunk * (chunk - 1) // 2 + chunk
    pair_flops = B * H * nc * terms * 3 * K
    product_flops = B * H * nc * (terms * 2 * V + 4 * chunk * K * V)
    bytes_ = (B * T * H * (2 * K + V) * elem_bytes + B * T * H * K * 4 + H * K * 4
              + 2 * B * H * K * V * 4 + B * T * H * V * 4)
    t_ops = (pair_flops / FP32_FLOPS_PER_S + product_flops / BF16_FLOPS_PER_S) * 1e3
    t_fp32 = (pair_flops + product_flops) / FP32_FLOPS_PER_S * 1e3
    return t_ops, bytes_ / HBM_BYTES_PER_S * 1e3, t_fp32


def larger(t_ops, t_bytes):
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def prefill_timings(flush):
    """The three prefill kernels at the path shapes: kernel, plain version,
    SDPA for attention (on K/V repeated to N heads and laid out (B, N, S, hd),
    untimed), and the bound."""
    phase("prefill kernel times")
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mamba2_ssd.ops import _ssd_chunked, ssd
    from repro_torch.kernels.rwkv6_scan.ops import _wkv6_chunked, wkv6

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    shapes = {**{k: (*v, True) for k, v in FLASH_PATH.items()}, **FLASH_WIDE}
    for label, ((B, S, N, K, hd), window, causal) in shapes.items():
        q, k, v = flash_inputs(B, S, N, K, hd, torch.bfloat16, seed=200)
        scale = hd ** -0.5
        ms = time_ms(lambda: flash_attention(q, k, v, window=window, scale=scale,
                                             causal=causal), flush)
        plain = time_ms(lambda: attention_ref(q, k, v, window, scale=scale, causal=causal),
                        flush)
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(N // K, 2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(N // K, 2).transpose(1, 2).contiguous()
        if window >= S:
            lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal, scale=scale), flush)
        else:
            pos = torch.arange(S, device="cuda")
            mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
            lib = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, scale=scale), flush)
        bound, bound_by = flash_bound_ms(B, S, N, K, hd, window, 2, BF16_FLOPS_PER_S, causal)
        rows[label] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                       "bound_by": bound_by}
        flops = flash_flops(B, S, N, hd, window, causal)
        print(f"  flash {label}: B{B} S{S} N{N} K{K} hd{hd} window {window} "
              f"{'causal' if causal else 'non-causal'} bf16: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
              f"{bound_by} bound {bound:.4f} ms; kernel {flops / ms / 1e9:.1f} TFLOP/s, "
              f"sdpa {flops / lib / 1e9:.1f} TFLOP/s ({flops / 1e9:.2f} GFLOP)")
        del q, k, v, qt, kt, vt

    def flushed(call):
        def run():
            for _ in range(20):
                flush.zero_()
                call()
        return run

    args = ssd_inputs(*SSD_PATH, torch.bfloat16, seed=201)
    ms = time_ms(lambda: ssd(*args, impl="pallas"), flush)
    plain = time_ms(lambda: _ssd_chunked(*args, chunk=32), flush)
    t_ops, t_bytes = ssd_bounds_ms(*SSD_PATH, 32, 2)
    bound, bound_by = larger(t_ops, t_bytes)
    rows["ssd_zamba2"] = {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": bound,
                          "bound_by": bound_by}
    print("  ssd zamba2: B{} T{} H{} P{} N{}".format(*SSD_PATH) + f" chunk 32 x/B/C bf16: "
          f"kernel {ms:.4f} ms, plain chunked {plain:.4f} ms, no single PyTorch call; bounds: "
          f"fp32 operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms")
    # Each pass's own device time: the profile names the kernels of the passes.
    profiled(flushed(lambda: ssd(*args, impl="pallas")),
             "20 x (L2 flush, mamba2_ssd) at zamba2's shape")
    del args
    args = wkv6_inputs(*WKV_PATH, torch.bfloat16, seed=202)
    ms = time_ms(lambda: wkv6(*args, impl="pallas"), flush)
    plain = time_ms(lambda: _wkv6_chunked(*args, chunk=16), flush, runs=10, warmup=2)
    t_ops, t_bytes, t_fp32 = wkv6_bounds_ms(*WKV_PATH, 16, 2)
    bound, bound_by = larger(t_ops, t_bytes)
    rows["wkv6_rwkv6"] = {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": bound,
                          "bound_by": bound_by}
    print("  wkv6 rwkv6-3b: B{} T{} H{} K{} V{}".format(*WKV_PATH) + f" chunk 16 r/k/v bf16: "
          f"kernel {ms:.4f} ms, plain chunked {plain:.4f} ms, no single PyTorch call; bounds: "
          f"operations {t_ops:.4f} ms (pair decays fp32, products on the tensor cores at "
          f"bf16), bytes {t_bytes:.4f} ms; all-fp32 operations {t_fp32:.4f} ms, no floor "
          f"for a kernel with tensor-core products")
    profiled(flushed(lambda: wkv6(*args, impl="pallas")),
             "20 x (L2 flush, wkv6) at rwkv6-3b's shape")
    return rows


# ------------------------------------------------------------------ prefill path
def decode_state_from_prefill(tf, params, cfg, caches, B, S, max_len):
    """A decode state whose caches hold the prefill's: K/V copied into the
    first S positions, the Mamba2 and RWKV6 states taken as they are."""
    state = tf.init_decode_state(params, cfg, B, max_len)
    state["lengths"].fill_(S)
    for key in ("kv", "dense_kv", "shared_kv"):
        if key in caches:
            for dst, src in zip(state[key], caches[key], strict=True):
                dst[:, :, :S] = src
    for key in ("mamba", "rwkv"):
        if key in caches:
            state[key] = caches[key]
    return state


def prefill_path(arch: str, per_forward: dict, n_forwards: int = 4):
    """Prefill B=2 x 2048 tokens at full width, then 16 cached decode steps.
    Returns the launch counts of the kernel run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mamba2_ssd.ops import _ssd_chunked
    from repro_torch.kernels.rwkv6_scan.ops import _wkv6_chunked
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rwkv6 as rk
    from repro_torch.models import transformer as tf

    phase(f"prefill path: {arch} full width, prefill + cached decode")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory allocated before the build: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    cfg = get_config(arch)
    B, S, steps = 2, 2048, 16
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    dims = {"hybrid": f" ssm H{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} "
                      f"P{cfg.ssm_head_dim} N{cfg.ssm_state}",
            "ssm": f" wkv H{cfg.d_model // cfg.rwkv_head_dim} hd{cfg.rwkv_head_dim} "
                   f"decay LoRA {cfg.rwkv_decay_lora}",
            "moe": f" experts {cfg.num_experts} top-{cfg.experts_per_token} expert "
                   f"F{cfg.moe_d_ff}"}.get(cfg.family, "")
    print(f"built {cfg.name} in {time.perf_counter() - t0:.2f} s: L{cfg.num_layers} "
          f"D{cfg.d_model} N{cfg.num_heads} K{cfg.num_kv_heads} hd{cfg.resolved_head_dim} "
          f"F{cfg.d_ff} V{cfg.vocab_size}{dims}, "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B parameters")
    toks = torch.randint(0, cfg.vocab_size, (B, S + steps), dtype=torch.int32, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    prompt = toks[:, :S]
    opts = tf.ModelOptions(attn_impl="flash", ssd_impl="pallas", wkv_impl="pallas",
                           moe_impl="ep")

    def forward(p, c):
        return tf.forward(p, c, prompt, opts, collect_kv=True, last_only=True)

    prefill = functools.partial(forward, params, cfg)

    zero_counts()
    fwd_ms = []
    for _ in range(n_forwards):
        ts = time.perf_counter()
        logits, _, caches = prefill()
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - ts) * 1e3)
    counts = read_counts()
    print(f"{n_forwards} forwards: launches {counts}, forward ms {[round(t, 2) for t in fwd_ms]}")
    for name, n in per_forward.items():
        check(counts[name] == n * n_forwards,
              f"{name} launches {counts[name]} != {n} per forward x {n_forwards}")
    for name in counts.keys() - per_forward.keys():
        check(counts[name] == 0, f"the prefill path launched {name}: {counts}")
    check(tuple(logits.shape) == (B, 1, cfg.padded_vocab), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()), "non-finite prefill logits")
    median_fwd = statistics.median(fwd_ms[1:])
    print(f"prefill B{B} x {S}: median forward {median_fwd:.2f} ms (first {fwd_ms[0]:.2f} ms), "
          f"{B * S / median_fwd * 1e3:.0f} prompt tokens/s")

    state = decode_state_from_prefill(tf, params, cfg, caches, B, S, S + steps)
    step_ms, finite = [], []
    for t in range(S, S + steps):
        ts = time.perf_counter()
        step_logits, state = tf.decode_step(params, cfg, state, toks[:, t:t + 1], opts)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        finite.append(bool(torch.isfinite(step_logits[:, :cfg.vocab_size]).all()))
    check(all(finite), "non-finite decode logits")
    check(int(state["lengths"][0]) == S + steps, "decode did not advance the lengths")
    print(f"decode {steps} steps x B{B} from the prefill caches: median step "
          f"{statistics.median(step_ms):.2f} ms (first {step_ms[0]:.2f} ms), logits finite")
    del state, step_logits
    busy_us, by_name = profiled(prefill, f"one {arch} prefill forward")

    # Each kernel is reached through a module attribute; the checks and the
    # plain prefills put other functions there and restore the kernels after.
    # The MoE layer (no kernel) is reached the same way, for its check.
    hooks = {"flash_attention": (attn_mod, "flash_attention"), "mamba2_ssd": (m2, "ssd"),
             "wkv6": (rk, "wkv6"), "moe": (moe_mod, "moe_layer")}
    kernels = {name: getattr(mod, attr) for name, (mod, attr) in hooks.items()}

    def run_with(fns, run=prefill):
        for name, fn in fns.items():
            setattr(*hooks[name], fn)
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            for name, (mod, attr) in hooks.items():
                setattr(mod, attr, kernels[name])
        return out

    # Each kernel call of one more prefill, held against its plain version on
    # the same inputs, the model's own activations. Flash: element by element
    # within one bf16 ulp, BF16_RTOL |plain| + BF16_ATOL max(1, max |plain|).
    # The SSD: at phase 6's tolerance taken relative to max(1, the largest
    # |value| of the plain output) (the zamba2 states reach ~1e7 with random
    # weights). Its plain chunked form evaluated in fp64: the model's dt
    # reaches ~500, where fp32 differences of L = A * cumsum(dt) lose digits,
    # so the fp32 plain form is itself off by ~1e-3 (printed beside). WKV6:
    # y and the state each within WKV_RTOL of the plain output's own largest
    # |value|, with no floor (they sit near 1e-2).
    # MoE: each call (moe_impl="ep") within MOE_BF16_ROUNDINGS of the dense
    # oracle on the same activations, and its aux loss equal to the oracle's.
    worst = {"flash_attention": 0.0, "flash share of tol": 0.0, "mamba2_ssd": 0.0,
             "plain fp32 ssd": 0.0, "max dt": 0.0, "wkv6": 0.0, "max |wkv y|": 0.0,
             "max |wkv state|": 0.0, "moe": 0.0, "moe share of tol": 0.0,
             "moe aux diff": 0.0}

    def rel_err(out, ref):
        return (out.double() - ref.double()).abs().max().item() / max(
            1.0, ref.double().abs().max().item())

    def flash_checked(q, k, v, *, window, scale, causal=True):
        out = kernels["flash_attention"](q, k, v, window=window, scale=scale, causal=causal)
        ref = attention_ref(q, k, v, window, scale=scale, causal=causal).float()
        tol = BF16_RTOL * ref.abs() + BF16_ATOL * max(1.0, ref.abs().max().item())
        worst["flash share of tol"] = max(worst["flash share of tol"],
                                          ((out.float() - ref).abs() / tol).max().item())
        worst["flash_attention"] = max(worst["flash_attention"], rel_err(out, ref))
        return out

    def ssd_checked(*args, impl="chunked", chunk=32):
        y, h = kernels["mamba2_ssd"](*args, impl=impl, chunk=chunk)
        y64, h64 = _ssd_chunked(*(t.double() for t in args), chunk)
        y32, h32 = _ssd_chunked(*args, chunk)
        worst["mamba2_ssd"] = max(worst["mamba2_ssd"], rel_err(y, y64), rel_err(h, h64))
        worst["plain fp32 ssd"] = max(worst["plain fp32 ssd"], rel_err(y32, y64),
                                      rel_err(h32, h64))
        worst["max dt"] = max(worst["max dt"], args[1].max().item())
        return y, h

    def wkv6_checked(*args, impl="chunked", chunk=16):
        y, s = kernels["wkv6"](*args, impl=impl, chunk=chunk)
        y_ref, s_ref = _wkv6_chunked(*args, chunk)
        worst["wkv6"] = max(worst["wkv6"], max_rel(y, y_ref), max_rel(s, s_ref))
        worst["max |wkv y|"] = max(worst["max |wkv y|"], y_ref.abs().max().item())
        worst["max |wkv state|"] = max(worst["max |wkv state|"], s_ref.abs().max().item())
        return y, s

    def moe_checked(p, x, cfg_, impl="ep"):
        out, aux = kernels["moe"](p, x, cfg_, impl=impl)
        dense, aux_dense = moe_mod.moe_dense(p, x, cfg_)
        # S = sum_e w_e |y_e|, from the oracle's own pieces, in fp32.
        xt = x.reshape(-1, x.shape[-1])
        top_p, top_e, _ = moe_mod._route(p["router"], xt, cfg_)
        w = torch.zeros((xt.shape[0], cfg_.num_experts), device=x.device)
        w = w.scatter_add_(1, top_e, top_p).to(x.dtype).float()
        ted = moe_mod._expert_ffn_dense(p["w_gate"], p["w_up"], p["w_down"], xt)
        mag = torch.einsum("te,ted->td", w, ted.float().abs_())
        del ted
        tol = (cfg_.experts_per_token + MOE_BF16_ROUNDINGS) * 2.0 ** -8 * mag
        diff = (out.float() - dense.float()).reshape(mag.shape).abs()
        worst["moe share of tol"] = max(worst["moe share of tol"],
                                        (diff / tol.clamp_min(1e-30)).max().item())
        worst["moe"] = max(worst["moe"], rel_err(out, dense))
        worst["moe aux diff"] = max(worst["moe aux diff"], abs(aux.item() - aux_dense.item()))
        return out, aux

    run_with({"flash_attention": flash_checked, "mamba2_ssd": ssd_checked,
              "wkv6": wkv6_checked, **({"moe": moe_checked} if cfg.moe else {})})
    shown = [name for name in worst if name in per_forward or
             (name == "flash share of tol" and "flash_attention" in per_forward) or
             (name in ("plain fp32 ssd", "max dt") and "mamba2_ssd" in per_forward) or
             (name.startswith("max |wkv") and "wkv6" in per_forward) or
             (name.startswith("moe") and cfg.moe)]
    print("every kernel call of a prefill vs its plain version on the same inputs, max "
          "|diff| / max(1, max |plain|) (wkv6: / max |plain|), and flash's largest "
          "|diff| / tol: " + ", ".join(f"{n} {worst[n]:.3e}" for n in shown))
    check(worst["flash share of tol"] <= 1.0, "flash_attention disagrees on the path's inputs")
    check(worst["mamba2_ssd"] <= 5e-4, "mamba2_ssd disagrees on the path's inputs")
    check(worst["wkv6"] <= WKV_RTOL, "wkv6 disagrees on the path's inputs")
    check(worst["moe share of tol"] <= 1.0, "moe_impl='ep' disagrees with the dense oracle")
    check(worst["moe aux diff"] <= 1e-6, "the MoE aux loss differs from the dense oracle's")
    if cfg.moe:
        moe_breakdown(tf, moe_mod, params, cfg, prefill, busy_us, by_name)

    # The whole prefill with the plain versions in place of the kernels. The
    # recurrent models are compared a second time, plain against plain with
    # the scan summed in other chunks: with random weights they amplify any
    # rounding difference (zamba2 through SSD states that grow to ~1e7, rwkv6
    # through 32 layers of bf16 activations), and this shows how much.
    def plain_prefill(ssd_chunk=32, wkv_chunk=16, run=prefill):
        before = read_counts()
        out = run_with({
            "flash_attention": lambda q, k, v, *, window, scale, causal=True:
                attention_ref(q, k, v, window, scale=scale, causal=causal),
            "mamba2_ssd": lambda *a, impl="chunked", chunk=32: _ssd_chunked(*a, ssd_chunk),
            "wkv6": lambda *a, impl="chunked", chunk=16: _wkv6_chunked(*a, wkv_chunk),
        }, run)
        check(read_counts() == before, "the plain prefill launched a kernel")
        return out

    def compare(what, one, other):
        """Print how far two prefills are apart; returns the largest |logit
        diff| and the largest WKV state difference over the largest |state|."""
        (a, _, ca), (b, _, cb) = one, other
        a, b = a[..., :cfg.vocab_size], b[..., :cfg.vocab_size]
        check(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()),
              f"non-finite logits: {what}")
        logit_diff = (a - b).abs().max().item()
        line = (f"prefill {what}: max |logit diff| {logit_diff:.4e} of max |logit| "
                f"{b.abs().max().item():.4e}, argmax agreement "
                f"{(a.argmax(-1) == b.argmax(-1)).float().mean().item():.3f}")
        for key in ("kv", "dense_kv", "shared_kv"):
            if key in ca:
                kv_diff = max((x.float() - y.float()).abs().max().item()
                              for x, y in zip(ca[key], cb[key], strict=True))
                line += f", max |K/V cache diff| {kv_diff:.4e}"
        if "mamba" in ca:
            ssd_diff = (ca["mamba"]["ssd"] - cb["mamba"]["ssd"]).abs().max().item()
            line += (f", max |SSD state diff| {ssd_diff:.4e} of max |SSD state| "
                     f"{cb['mamba']['ssd'].abs().max().item():.4e}")
        wkv_rel = 0.0
        if "rwkv" in ca:
            wa, wb = ca["rwkv"]["wkv"], cb["rwkv"]["wkv"]
            wkv_rel = max_rel(wa, wb)
            shift = max((ca["rwkv"][k].float() - cb["rwkv"][k].float()).abs().max().item()
                        for k in ("tm_x", "cm_x"))
            line += (f", max |WKV state diff| {(wa - wb).abs().max().item():.4e} of max |WKV "
                     f"state| {wb.abs().max().item():.4e}, max |token-shift carry diff| "
                     f"{shift:.4e}")
        print(line)
        return logit_diff, wkv_rel

    plain = plain_prefill()
    compare("kernels vs plain versions", (logits, None, caches), plain)
    if cfg.family == "hybrid":
        compare("plain vs plain with SSD chunk 16", plain, plain_prefill(ssd_chunk=16))
    if cfg.family == "ssm":
        compare("plain vs plain with WKV chunk 32", plain, plain_prefill(wkv_chunk=32))
        # The same model with every weight and activation in fp32, where
        # rounding is not amplified to the bf16 spread: kernels against plain
        # versions within stated bounds.
        del plain, caches
        cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        params32 = _tree_map(lambda t: t.float(), params)
        run32 = functools.partial(forward, params32, cfg32)
        kernel32 = run_with({}, run32)
        logit_diff, wkv_rel = compare("in fp32, kernels vs plain versions", kernel32,
                                      plain_prefill(run=run32))
        check(logit_diff <= RWKV_FP32_LOGIT_ATOL,
              f"fp32 prefill logits, kernels vs plain: {logit_diff} > {RWKV_FP32_LOGIT_ATOL}")
        check(wkv_rel <= RWKV_FP32_STATE_RTOL,
              f"fp32 prefill WKV states, kernels vs plain: {wkv_rel} > {RWKV_FP32_STATE_RTOL}")
    return counts


def moe_breakdown(tf, moe_mod, params, cfg, prefill, busy_us, by_name) -> None:
    """Where an MoE prefill's device time goes, and one layer held in fp32.

    One more prefill records each layer's ``_local_expert_pass`` inputs. Each
    part then runs alone on them under torch.profiler: the grouped expert
    products (``_grouped_ffn``) and the whole routed pass, whose difference
    is the routing, the sort and the scatter-add around the products. Flash
    attention's share is its kernel's device time in the forward's profile."""
    captured = []
    local_pass = moe_mod._local_expert_pass

    def capture(*args):
        captured.append(args)
        return local_pass(*args)

    moe_mod._local_expert_pass = capture
    try:
        prefill()
        torch.cuda.synchronize()
    finally:
        moe_mod._local_expert_pass = local_pass
    groups = []
    for xl, router_w, w_gate, w_up, w_down, cfg_, e_lo, e_local, capacity in captured:
        top_p, top_e, _ = moe_mod._route(router_w, xl, cfg_)
        sel_t, _, sizes = moe_mod._dispatch(top_p, top_e, cfg_, e_lo, e_local, capacity)
        groups.append((xl[sel_t], w_gate, w_up, w_down, sizes))
    layers = len(captured)

    def products():
        for g in groups:
            moe_mod._grouped_ffn(*g)

    def passes():
        for args in captured:
            local_pass(*args)

    products()
    passes()
    prod_us, _ = profiled(products, f"{layers} x the grouped expert products, alone")
    pass_us, _ = profiled(passes, f"{layers} x the routed MoE pass, alone")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    products()
    torch.cuda.synchronize()
    prod_wall = (time.perf_counter() - t0) * 1e3
    sizes = groups[0][4]
    copy_us = host_us(lambda: sizes.tolist())
    matmuls = sum(3 * int((g[4] > 0).sum()) for g in groups)
    flash_us = sum(t for name, (t, _) in by_name.items() if "flash_attention" in name)
    print(f"moe: grouped expert products {prod_us / layers / 1e3:.4f} ms of device time a "
          f"layer ({matmuls} torch.matmul launches a forward, {prod_wall / layers:.4f} ms "
          f"of wall time a layer run alone); routing, sort and scatter "
          f"{(pass_us - prod_us) / layers / 1e3:.4f} ms a layer; group sizes' "
          f"device-to-host copy {copy_us:.1f} us on the host, once a layer")
    if busy_us:
        print(f"moe: shares of one forward's {busy_us / 1e3:.2f} ms of device time: expert "
              f"products {prod_us / busy_us:.1%}, routing/sort/scatter "
              f"{(pass_us - prod_us) / busy_us:.1%}, flash attention {flash_us / busy_us:.1%}")
    # One full-width layer in fp32, ep against the dense oracle.
    xl = captured[0][0].float()[None]
    p32 = {k: v.float() for k, v in tf._layer(params["stack"], 0)["moe"].items()}
    del captured, groups
    ep, _ = moe_mod.moe_layer(p32, xl, cfg, impl="ep")
    dense, _ = moe_mod.moe_layer(p32, xl, cfg, impl="dense")
    rel = ((ep - dense).abs().max() / dense.abs().max()).item()
    print(f"moe: one layer in fp32 ({xl.shape[1]} tokens), ep vs dense: max |diff| / max "
          f"|dense| {rel:.3e} (tol {MOE_FP32_RTOL:g})")
    check(rel <= MOE_FP32_RTOL, f"fp32 MoE layer, ep vs dense: {rel} > {MOE_FP32_RTOL}")


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def kernel_record(name, source, replaces, launches, worst, row, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": worst, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.paged_attention import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    grad_refusal()
    worst = kernel_vs_plain(ops, ref)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")   # > 50 MB L2
    rows = timings(ops, ref, flush)
    launches = main_path(ops, ref)
    worst_flash = flash_vs_plain()
    worst_ssd = ssd_vs_plain()
    worst_wkv = wkv6_vs_plain()
    prefill_rows = prefill_timings(flush)
    del flush
    gemma = prefill_path("gemma3-1b", {"flash_attention": 26})
    zamba = prefill_path("zamba2-1.2b", {"flash_attention": 6, "mamba2_ssd": 38})
    rwkv = prefill_path("rwkv6-3b", {"wkv6": 32})
    olmoe = prefill_path("olmoe-1b-7b", {"flash_attention": 16})
    olmoe_launches = main_path(ops, ref, "olmoe-1b-7b")
    phase("results")
    print(json.dumps({"kernels": [
        kernel_record("paged_attention",
                      "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
                      "src/repro/kernels/paged_attention/paged_attention.py:93",
                      launches + olmoe_launches, worst, rows["serving"],
                      launches_by_model={"gemma3-1b": launches, "olmoe-1b-7b": olmoe_launches},
                      two_partitions=rows["two_partitions"], long_context=rows["long"],
                      olmoe_serving=rows["olmoe_serving"], g7_hd128=rows["g7_hd128"],
                      g12_hd192=rows["g12_hd192"]),
        kernel_record("flash_attention",
                      "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention/flash_attention.py:107",
                      gemma["flash_attention"] + zamba["flash_attention"]
                      + olmoe["flash_attention"], worst_flash,
                      prefill_rows["gemma3_global"],
                      launches_by_model={"gemma3-1b": gemma["flash_attention"],
                                         "zamba2-1.2b": zamba["flash_attention"],
                                         "olmoe-1b-7b": olmoe["flash_attention"]},
                      shapes={k: prefill_rows[k] for k in (*FLASH_PATH, *FLASH_WIDE)}),
        kernel_record("mamba2_ssd",
                      "src/repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd.cu",
                      "src/repro/kernels/mamba2_ssd/mamba2_ssd.py:82",
                      zamba["mamba2_ssd"], worst_ssd, prefill_rows["ssd_zamba2"]),
        kernel_record("wkv6",
                      "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
                      "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:80",
                      rwkv["wkv6"], worst_wkv, prefill_rows["wkv6_rwkv6"]),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
