"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each of which raises (and so exits non-zero) on failure, each
printed with the wall time of the phase before it:
  1. card: name and power limit, torch/CUDA versions; the four CUDA kernels
     built together, one nvcc per source, each in its own thread and timed,
     with ptxas's registers, spills and warnings for every instantiation, and
     0 spill bytes checked for the scans' instantiations on the prefill paths
     and for flash attention's six bf16 (wgmma) instantiations; then each
     kernel's wrapper called under grad with an input that requires grad,
     which must raise before it launches;
  2. the paged-attention kernel against its plain PyTorch version on the card,
     at the reference's sweep shapes, the serving shapes, the edges of its
     64-token partitions, and the published group sizes and head dims past
     the first four (G 7 at hd 128, G 12 at hd 192, hd 80), olmoe-1b-7b's
     serving shape and phase 13's decode shapes (gemma3-12b's G 2 at hd 256
     with window 1024, internvl2-1b's G 7 at hd 64 over pages of 16);
  3. times (median of CUDA-event-timed runs, L2 flushed before each) of that
     kernel, its plain version and a library yardstick, beside the byte bound
     and the bytes a second the kernel reached: at the serving path's shape
     (one partition), a table of two partitions and a long context, with the
     wrapper's host time a call and a profile of flushed calls; then at
     olmoe-1b-7b's serving shape, at G 7 and G 12, and at phase 13's decode
     shapes;
  4. the serving path at full width: ``repro_torch.launch.serve`` serving
     gemma3-1b (26 layers, d_model 1152) with random bf16 weights, KV pages
     preempted into pinned host memory and promoted back; the kernel's launch
     count must equal decode steps x layers; a torch.profiler breakdown of 20
     more steps of the same request mix; then decode steps with the kernel and
     with the plain version from the same pools;
  5. the flash-attention kernel against its plain version: the reference's
     sweep (fp32 and bf16, causal and not), the bf16 wgmma kernel's edges
     (every head dim, ragged S against its 128-row blocks and 64-row
     warpgroups, windows about them and its key tiles, non-causal with T
     ragged), hd 80 (non-causal) and 192 (causal and sliding), and the
     prefill shapes of gemma3-1b, zamba2-1.2b, olmoe-1b-7b and phase 13's
     causal models, in fp32 and in bf16;
  6. the Mamba2 SSD kernel against its plain versions: the reference's sweep
     and zamba2-1.2b's shape;
  7. the WKV6 kernel against its plain versions: the reference's sweep and
     rwkv6-3b's shape;
  8. times of the three prefill kernels, their plain versions and, for
     attention, SDPA as a yardstick, beside the bound at the path shapes
     (phase 13's too) and at hd 80 and 192 (for the scans both the
     operations and the bytes bound), the flops a second flash attention
     reached (attention flops, and tensor-core flops with the P split
     counted), SDPA's largest error over the one-ulp bound against the plain
     version (printed, not checked), and a profile of
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
     experts top-8) through the same engine set-up as phase 4;
 11. training at full width: gemma3-1b (26 layers, d_model 1152, vocab
     262144; random bf16 weights from seed 0), B=2 x 2048 synthetic tokens a
     step through ``PrefetchLoader``, ``attn_impl="xla"``, AdamW at lr 1e-3.
     8 steps with the optimizer state on the device and 8 from the same
     start with it in pinned host memory, the losses agreeing within 1e-5;
     the median step time, tokens/s and the forward, backward and optimizer
     split of a step for both, the optimizer's host<->device bytes, and the
     device idle share of one profiled step; the loss falling over 8 steps
     on one repeated batch; one step each with remat none, full and offload,
     loss and gradient norm within 1e-5, with each one's peak device memory
     and the bytes offload sent to the host; a train step with
     ``attn_impl="flash"`` refused before any launch; a checkpoint restart
     (save at step 4, 2 steps, restore, the same 2 steps) bitwise under
     ``torch.use_deterministic_algorithms``; grad_accum=2 against the full
     batch in fp32, parameters within 5e-5. No kernel runs in training.
 12. the multi-device layer on the card: an NCCL process group of one rank
     (an in-memory store, no network) and a (1, 1) ("data", "model")
     DeviceMesh. Full-width gemma3-1b takes 3 steps each under
     ``train_fsdp`` and ``train_dp_all`` from phase 11's start (the same
     seed-0 weights, batches and hyperparameters), with parameters, AdamW
     state and batches as DTensors placed by ``launch/specs.py``; each
     step's loss and gradient norm within 1e-5 of phase 11's mesh-less
     steps (the largest relative difference printed), the median step
     against phase 11's, the device idle share of one profiled step and the
     peak device memory; one ``train_fsdp`` step with the state's shards in
     pinned host memory, its loss equal to the on-card step's; phase 11's
     mesh-less checkpoint restored with ``shardings=`` onto the mesh, every
     leaf's ``full_tensor()`` bitwise equal to the file; ``psum_compressed``
     over the one-rank group bitwise equal to compress -> decompress; no
     kernel launched. Beside it, in a CPU subprocess, ``launch.dryrun`` for
     gemma3-1b x train_4k and kimi-k2-1t-a32b x decode_32k on the 16x16
     mesh of a fake 256-rank group, each cell's placed parameter bytes a
     device equal to those reckoned from the specs. It prints a
     ``multi_device: {...}`` JSON line with every number and the card's
     name and power limit.
 13. every published config that one card holds and no phase above runs,
     each built at full width with random bf16 weights (seed 0) and freed
     before the next: deepseek-coder-33b (62 layers, d_model 7168, 56 heads
     over 8; 62.1 GiB of weights) and gemma3-12b (48 layers, d_model 3840,
     16 heads over 8 at hd 256, window 1024) through phase 9's prefill path
     (flash 62 and 48 launches a forward, 16 cached decode steps, every
     kernel call held against its plain version) and then phase 4's serving
     path (paged launches = decode steps x layers, pages preempted into
     pinned host memory and promoted back); internvl2-1b (24 layers, 14
     heads over 2 at hd 64) prefilled from seeded (B, S, D) bf16
     embeddings, 16 ``decode_step``s, and 16 ``paged_decode_step``s over
     pools filled from the prefill's K/V with the kernel and with its
     plain version (each call within one bf16 ulp; on an fp32 copy each
     call against fp64, the logits printed); hubert-xlarge (48 layers of
     16 heads of 80, the encoder) through its non-causal forward with
     flash (48 a forward), no decode.
     For each: build time, peak device memory of the build and of the
     prefill, median forward, the device idle share of one profiled forward
     and ``prefill_mfu`` (``model_flops(cfg, B*S, "inference")`` over the
     median forward over 989 TFLOP/s), in a ``one_card: {...}`` JSON line
     with the card's name and power limit.
The last two lines are a JSON ``kernels`` record and a JSON result line.

Float32 matmuls run in full precision (TF32 off), so fp32 comparisons on the
card mean what they say.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import os
from concurrent.futures import ThreadPoolExecutor
import statistics
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS is deterministic only with a fixed workspace, set before CUDA starts
# (phase 11's bitwise checkpoint restart runs under deterministic algorithms).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

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

    def timed_build(source):
        start = time.perf_counter()
        path, log = _nvcc.build(source)
        return path, log, time.perf_counter() - start

    with ThreadPoolExecutor(len(sources)) as pool:
        timed = list(pool.map(timed_build, sources))
    built = [(path, log) for path, log, _ in timed]
    print(f"built {', '.join(f'{path.name} ({sec:.2f} s)' for path, _, sec in timed)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for path, log in built:
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "warning")):
                print(f"  ptxas {path.stem}: {line.strip()}")
    check_path_spills({src.stem: log for src, (_, log) in zip(sources, built, strict=True)})
    return smi


# The instantiations the prefill paths launch (bf16; zamba2's chunk 32 and
# P = N = 64, granite-4.0-h's N 128; rwkv6-3b's chunk 16 and K = V = 64; flash
# attention's wgmma kernel at each head dim), by their mangled names.
PATH_ENTRIES = {
    "flash_attention": tuple(f"flash_attention_wgmma_kernelILi{hd}E"
                             for hd in (32, 64, 80, 128, 192, 256)),
    "mamba2_ssd": (*(f"ssd_{p}_kernelILi32E13__nv_bfloat16Li{n}E"
                     for p in ("chunk", "output") for n in (64, 128)), "ssd_state_kernel"),
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
            check("reference's Pallas kernel has none" in str(e),
                  f"{name}: the refusal does not name the plain path: {e}")
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
    # Phase 13's decode shapes: gemma3-12b's G 2 at hd 256 (window 1024) over
    # the serving path's page 8, internvl2-1b's G 7 at hd 64 over the
    # prefill's pages of 16 (2048 tokens and up to 16 more).
    for (B, N, K, hd, page), lengths, windows in (
            ((2, 16, 8, 256, 8), [24, 40], (WINDOW_GLOBAL, 1024)),
            ((2, 16, 8, 256, 8), [700, 1500], (WINDOW_GLOBAL, 1024)),
            ((2, 14, 2, 64, 16), [2049, 2064], (WINDOW_GLOBAL, 100))):
        for window in windows:
            cases.append(((B, N, K, hd, page), lengths, window, torch.bfloat16, 1e-2))
            cases.append(((B, N, K, hd, page), lengths, window, torch.float32, 2e-5))
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
    (nemotron-4-340b) at a 1024-token context, and phase 13's decode shapes
    (deepseek-coder-33b and gemma3-12b serving, internvl2-1b's decode after
    its 2048-token prefill), without the profiles."""
    from repro_torch.kernels.paged_attention.paged_attention import num_partitions

    phase("times")
    rows = {}
    for label, (B, N, K, hd, page), length in [("serving", (2, 4, 1, 256, 8), 40),
                                               ("two_partitions", (4, 4, 1, 256, 8), 128),
                                               ("long", (8, 4, 1, 256, 8), 4096),
                                               ("olmoe_serving", (2, 16, 16, 128, 8), 40),
                                               ("g7_hd128", (2, 56, 8, 128, 8), 1024),
                                               ("g12_hd192", (2, 96, 8, 192, 8), 1024),
                                               ("deepseek_serving", (2, 56, 8, 128, 8), 40),
                                               ("gemma3_12b_serving", (2, 16, 8, 256, 8), 40),
                                               ("internvl2_decode", (2, 14, 2, 64, 16), 2064)]:
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
    Returns the device's busy time in us, {kernel name: (us, count)} and the
    wall time in us."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return (*print_profile(prof, wall_us, what), wall_us)


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


def main_path(ops, ref, arch: str = "gemma3-1b", widths: int = 0):
    """Serve `arch` at full width through ``repro_torch.launch.serve``: 3
    requests of 24 + 16 tokens, page 8, 10 hot slots, max_batch 2, Policy1,
    under the profiler. Returns the paged kernel's runs on the card that the
    profiler counted (a graph replay runs it without a host launch). With
    `widths`, then ``decode_graph_widths`` up to that batch width."""
    phase(f"main path: {arch} full width, tiered paged KV")
    from repro_torch.core import emucxl
    from repro_torch.launch import serve
    import repro_torch.serving.engine as engine_mod
    import repro_torch.serving.paged_decode as pd_mod
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
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
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
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
        prof.stop()
    wall = time.perf_counter() - t_run
    counts = read_counts()
    launches = counts["paged_attention"]
    runs = sum(e.device_type == DeviceType.CUDA and "paged_partition_kernel" in e.name
               for e in prof.events())
    del prof
    stats = eng.tier_stats()
    generated = sum(len(r.generated) for r in eng.requests.values())
    graphs = eng.graphs
    print(f"steps {steps}, decode batches {eng.decode_batches}, host launches of the kernel "
          f"{launches}, its runs on the card {runs} (profiler), "
          f"decode graph captures {graphs.captures}, replays {graphs.replays}, "
          f"preemptions {eng.preemptions}, peak remote bytes {peak_remote}, "
          f"pinned REMOTE records seen {remote_recs}, "
          f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"tier stats: {stats}")
    check(all(len(r.generated) == args.max_new for r in eng.requests.values()),
          "a request did not generate all its tokens")
    check(eng.preemptions > 0, "no preemption: the hot pool was never under pressure")
    check(stats["remote_hits"] > 0, "no page was promoted back from the REMOTE tier")
    check(peak_remote > 0 and remote_recs > 0, "no bytes reached the REMOTE tier")
    check(launches > 0, "the main path never launched the paged_attention kernel")
    # a step replays its width's graph, or runs eagerly and captures it (one
    # host launch a layer each); a replay launches nothing from the host
    check(graphs.captures + graphs.replays == eng.decode_batches,
          "a decode step neither captured nor replayed its graph")
    check(launches == 2 * graphs.captures * cfg.num_layers,
          f"kernel launches {launches} != 2 x captures x layers")
    # the profiler sees each run: the warm-up before a capture, and a replay's
    check(runs == eng.decode_batches * cfg.num_layers,
          f"the kernel ran {runs} times on the card, not decode batches x layers")
    check(all(n == 0 for name, n in counts.items() if name != "paged_attention"),
          f"the serving path launched a prefill kernel: {counts}")
    check(all(bool(f) for f in finite), "non-finite logits on the main path")
    print(f"serving (under the profiler): {steps / wall:.2f} steps/s, "
          f"{generated / wall:.2f} generated tokens/s, "
          f"median step {statistics.median(step_ms):.2f} ms, wall {wall:.2f} s")
    profile_steps(eng, args)

    # The same decode steps with the kernel, with the kernel replayed from a
    # graph (one capture, then replays) and with the plain version, each from
    # pools of its own.
    B, page, maxp, n_steps = 2, 8, 4, 12
    shape = (cfg.num_layers, B * maxp, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    table = torch.arange(B * maxp, dtype=torch.int32, device="cuda").reshape(B, maxp)
    toks = torch.randint(0, cfg.vocab_size, (B, n_steps), dtype=torch.int32, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    logits, cache = {}, pd_mod.DecodeGraphs()
    arms = (("kernel", ops.paged_attention, None), ("graph", ops.paged_attention, cache),
            ("plain", ref.paged_attention_ref, None))
    for name, attention, arm_graphs in arms:
        k_pool = torch.zeros(shape, device="cuda")
        v_pool = torch.zeros(shape, device="cuda")
        pd_mod.paged_attention = attention
        try:   # a replay's logits are the graph's buffer: copied before the next step
            logits[name] = [
                pd_mod.paged_decode_step(eng.params, cfg, k_pool, v_pool, table,
                                         torch.full((B,), t, dtype=torch.int32, device="cuda"),
                                         toks[:, t : t + 1], eng.opts, graphs=arm_graphs)[0].clone()
                for t in range(n_steps)]
        finally:
            pd_mod.paged_attention = ops.paged_attention

    def gap(a, b):
        diff = max((x - y).abs().max().item() for x, y in zip(logits[a], logits[b], strict=True))
        agree = sum(int((x.argmax(-1) == y.argmax(-1)).sum()) for x, y in
                    zip(logits[a], logits[b], strict=True)) / (B * n_steps)
        return diff, agree

    check(all(bool(torch.isfinite(x).all()) for x in logits["kernel"]), "non-finite logits")
    check((cache.captures, cache.replays) == (1, n_steps - 1),
          f"the graph arm captured {cache.captures} and replayed {cache.replays}")
    for a, b in (("kernel", "plain"), ("graph", "plain"), ("graph", "kernel")):
        diff, agree = gap(a, b)
        print(f"decode {n_steps} steps x B{B}, {a} vs {b} attention: max |logit diff| "
              f"{diff:.4e}, argmax agreement {agree:.3f}")
    diff, agree = gap("graph", "kernel")
    top = max(x.abs().max().item() for x in logits["kernel"])
    check(diff <= 1e-5 * top and agree == 1.0,
          f"the replayed step's logits differ from the eager step's by {diff:.4e}")
    print(f"graph arm: {cache.captures} capture, {cache.replays} replays")
    if widths:
        decode_graph_widths(eng, widths)
    del eng
    return runs


def decode_graph_widths(eng, widths: int, page: int = 16, max_pages: int = 118) -> None:
    """What the decode graphs cost where the batch width varies: one
    ``DecodeGraphs`` over `eng`'s weights takes every width from 1 to
    `widths` (a table of `max_pages` pages of `page` tokens, as the serving
    cell's; one page a row, 8 tokens long), then replays each. Prints the
    host time of each first call (the eager step and the capture), of a
    replay, and the device memory the graphs hold."""
    phase(f"decode graphs: widths 1..{widths}, {eng.cfg.name}")
    import repro_torch.serving.paged_decode as pd_mod

    cfg = eng.cfg
    shape = (cfg.num_layers, widths + 1, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    k_pool = torch.zeros(shape, device="cuda")
    v_pool = torch.zeros(shape, device="cuda")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    cache, first_ms, replay_ms = pd_mod.DecodeGraphs(), [], []

    def call(B):
        table = torch.zeros((B, max_pages), dtype=torch.int32, device="cuda")
        table[:, 0] = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")
        lengths = torch.full((B,), 8, dtype=torch.int32, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (B, 1), dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pd_mod.paged_decode_step(eng.params, cfg, k_pool, v_pool, table, lengths, toks,
                                 eng.opts, graphs=cache)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for B in range(1, widths + 1):
        first_ms.append(call(B))
    held = torch.cuda.memory_allocated() - base[0], torch.cuda.memory_reserved() - base[1]
    for B in range(1, widths + 1):
        replay_ms.append(call(B))
    check((cache.captures, cache.replays) == (widths, widths),
          f"{cache.captures} captures and {cache.replays} replays over {widths} widths")
    print(f"{widths} widths: first call (eager step + capture) median "
          f"{statistics.median(first_ms):.1f} ms, max {max(first_ms):.1f} ms, total "
          f"{sum(first_ms) / 1e3:.2f} s; replay (synchronized) median "
          f"{statistics.median(replay_ms):.2f} ms, B1 {replay_ms[0]:.2f} ms, "
          f"B{widths} {replay_ms[-1]:.2f} ms")
    print(f"graphs hold {held[0] / 2**20:.1f} MiB allocated, {held[1] / 2**20:.1f} MiB "
          f"reserved ({held[1] / widths / 2**20:.1f} MiB reserved a width); "
          f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for B in (1, 2, 8, 32, 64, widths):
        if B <= widths:
            print(f"  B{B}: first call {first_ms[B - 1]:.1f} ms, replay {replay_ms[B - 1]:.2f} ms")
    del cache, k_pool, v_pool


# ------------------------------------------------------------------ prefill kernels
def flash_inputs(B, S, N, K, hd, dtype, seed, T=None):
    """q (B, S, N, hd); k, v (B, T, K, hd), T = S unless given."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T = T or S
    q = (torch.randn((B, S, N, hd), generator=g, device="cuda") * 0.5).to(dtype)
    k = (torch.randn((B, T, K, hd), generator=g, device="cuda") * 0.5).to(dtype)
    v = (torch.randn((B, T, K, hd), generator=g, device="cuda") * 0.5).to(dtype)
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
# Phase 13's prefill shapes, causal: deepseek-coder-33b (56 heads over 8 at
# hd 128), gemma3-12b (16 over 8 at hd 256, global and sliding 1024) and
# internvl2-1b (14 over 2 at hd 64).
FLASH_ONE_CARD = {"deepseek": ((2, 2048, 56, 8, 128), WINDOW_GLOBAL),
                  "gemma3_12b_global": ((2, 2048, 16, 8, 256), WINDOW_GLOBAL),
                  "gemma3_12b_sliding": ((2, 2048, 16, 8, 256), 1024),
                  "internvl2": ((2, 2048, 14, 2, 64), WINDOW_GLOBAL)}
# Head dims past {32, 64, 128, 256} at their published configs' widths:
# hubert-xlarge (16 heads of 80, non-causal; on phase 13's path) and
# nemotron-4-340b (96 query heads over 8 KV heads of 192, causal; on no path,
# it does not fit one card). (shape, window, causal)
FLASH_WIDE = {"hubert_hd80": ((2, 2048, 16, 16, 80), WINDOW_GLOBAL, False),
              "nemotron_hd192": ((1, 2048, 96, 8, 192), WINDOW_GLOBAL, True)}
SSD_PATH = (2, 2048, 64, 64, 64)     # zamba2-1.2b: B, T, H, P, N at chunk 32
SSD_GRANITE = (1, 4096, 128, 64, 128)   # granite-4.0-h-small's prefill cell, chunk 32
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
    # hd 80 (non-causal, hubert's case; rows of five 16-column TMA boxes)
    # and hd 192 (causal and sliding): fp32 at 2e-5, bf16 within one bf16 ulp.
    for shape, window, causal in (((2, 1000, 16, 16, 80), WINDOW_GLOBAL, False),
                                  ((1, 1000, 4, 2, 80), 100, True),
                                  ((1, 1000, 12, 1, 192), WINDOW_GLOBAL, True),
                                  ((1, 1000, 12, 1, 192), 100, True)):
        cases.append((shape, window, causal, torch.float32, 2e-5, 0.0))
        cases.append((shape, window, causal, torch.bfloat16, BF16_ATOL, BF16_RTOL))
    # The bf16 kernel's edges within one bf16 ulp: every head dim, S not a
    # multiple of its tiles, windows about a 64-key tile, non-causal.
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
    for shape, window in (*FLASH_PATH.values(), *FLASH_ONE_CARD.values()):
        cases.append((shape, window, True, torch.float32, 2e-5, 0.0))
        cases.append((shape, window, True, torch.bfloat16, BF16_ATOL, BF16_RTOL))
    # The wgmma kernel's own tiles within one bf16 ulp: windows about its
    # 128-row blocks and its key tiles (128 keys; 96 at hd 128, 48 at hd 256);
    # rows against the block and its two 64-row warpgroups (S 64: the second
    # has no row; S 65: one) at every head dim; non-causal with T ragged
    # against the key tile (flash_attention's k and v take their own T).
    for hd in (32, 64, 128, 256):
        for window in (127, 128, 129, *{128: (95, 96, 97), 256: (47, 48, 49)}.get(hd, ())):
            cases.append(((1, 1000, 4, 2, hd), window, True, torch.bfloat16, BF16_ATOL,
                          BF16_RTOL))
    for hd in (32, 64, 80, 128, 192, 256):
        for S in (1, 64, 65, 129):
            cases.append(((2, S, 4, 2, hd), WINDOW_GLOBAL, True, torch.bfloat16, BF16_ATOL,
                          BF16_RTOL))
        cases.append(((2, 129, 4, 4, hd, 65), WINDOW_GLOBAL, False, torch.bfloat16,
                      BF16_ATOL, BF16_RTOL))
    worst = 0.0
    for i, (shape, window, causal, dtype, atol, rtol) in enumerate(cases):
        q, k, v = flash_inputs(*shape[:5], dtype, seed=i, T=shape[5] if len(shape) > 5 else None)
        scale = shape[4] ** -0.5
        out = flash_attention(q, k, v, window=window, scale=scale, causal=causal)
        torch.cuda.synchronize()
        expect = attention_ref(q, k, v, window, scale=scale, causal=causal).float()
        diff = (out.float() - expect).abs()
        err = diff.max().item()
        within = bool((diff <= atol + rtol * expect.abs()).all())
        tol = f"{atol:g}" + (f" + {rtol:g} |plain|" if rtol else "")
        print("  B{} S{} N{} K{} hd{}".format(*shape) + (f" T{shape[5]}" if len(shape) > 5
                                                        else "") +
              f" window {window} causal {causal} "
              f"{str(dtype).removeprefix('torch.')}: max abs err {err:.3e}, max |plain| "
              f"{expect.abs().max().item():.3e} (tol {tol})")
        check(within, f"flash_attention disagrees with its plain version beyond {tol}")
        worst = max(worst, err)
        del q, k, v, out, expect, diff
    print(f"kernels: flash_attention max abs err {worst:.3e}")
    return worst


def ssd_vs_plain():
    """Max |kernel - plain| of y and the final state: the reference's sweep
    and an edge of the instantiation for states up to 128 (ragged T, N 128)
    against the step-by-step oracle, zamba2's and granite's path shapes
    against the plain chunked form (both fp32 arithmetic; atol 5e-4, the
    reference's)."""
    phase("mamba2 ssd: kernel vs plain version")
    from repro_torch.kernels.mamba2_ssd.ops import _ssd_chunked, ssd
    from repro_torch.kernels.mamba2_ssd.ref import ssd_ref

    cases = [((2, 64, 2, 16, 8), 16, torch.float32, ssd_ref),
             ((1, 45, 4, 8, 16), 16, torch.float32, ssd_ref),
             ((1, 45, 4, 8, 16), 16, torch.bfloat16, ssd_ref),
             ((1, 77, 3, 64, 128), 32, torch.bfloat16, ssd_ref),
             *((shape, 32, torch.bfloat16, lambda *a: _ssd_chunked(*a, chunk=32))
               for shape in (SSD_PATH, SSD_GRANITE))]
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
    shapes = {**{k: (*v, True) for k, v in {**FLASH_PATH, **FLASH_ONE_CARD}.items()},
              **FLASH_WIDE}
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
        # Each output's distance from the plain version over the one-ulp bound
        # (1 is the bound): the kernel's, and SDPA's, which rounds P once.
        expect = attention_ref(q, k, v, window, scale=scale, causal=causal).float()
        bound_of = BF16_ATOL + BF16_RTOL * expect.abs()
        share = ((flash_attention(q, k, v, window=window, scale=scale, causal=causal).float()
                  - expect).abs() / bound_of).max().item()
        sd = (sdpa(qt, kt, vt, is_causal=causal, scale=scale) if window >= S
              else sdpa(qt, kt, vt, attn_mask=mask, scale=scale))
        sdpa_share = ((sd.transpose(1, 2).float() - expect).abs() / bound_of).max().item()
        flops = flash_flops(B, S, N, hd, window, causal)
        tc_flops = flops * 3 // 2   # Q K^T 2 hd a pair, P V 2 hd twice (P_hi and P_lo)
        rows[label] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                       "bound_by": bound_by, "tflops": flops / ms / 1e9,
                       "tc_tflops": tc_flops / ms / 1e9, "sdpa_tflops": flops / lib / 1e9,
                       "share_of_ulp_bound": share, "sdpa_share_of_ulp_bound": sdpa_share}
        print(f"  flash {label}: B{B} S{S} N{N} K{K} hd{hd} window {window} "
              f"{'causal' if causal else 'non-causal'} bf16: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
              f"{bound_by} bound {bound:.4f} ms; kernel {flops / ms / 1e9:.1f} TFLOP/s of "
              f"attention, {tc_flops / ms / 1e9:.1f} of tensor-core work with the P split, "
              f"sdpa {flops / lib / 1e9:.1f} TFLOP/s ({flops / 1e9:.2f} GFLOP); over the "
              f"one-ulp bound against plain: kernel {share:.3f}, sdpa {sdpa_share:.3f}")
        del q, k, v, qt, kt, vt, expect, bound_of, sd

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
    """Prefill B=2 x 2048 tokens (or (B, S, D) embeddings for the vlm and
    audio frontend stubs) at full width, then 16 cached decode steps (none
    for an encoder). Returns the launch counts of the kernel run
    (``launches``) and the build, memory and forward numbers."""
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak_build = torch.cuda.max_memory_allocated() / 2**30
    dims = {"hybrid": f" ssm H{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} "
                      f"P{cfg.ssm_head_dim} N{cfg.ssm_state}",
            "ssm": f" wkv H{cfg.d_model // cfg.rwkv_head_dim} hd{cfg.rwkv_head_dim} "
                   f"decay LoRA {cfg.rwkv_decay_lora}",
            "moe": f" experts {cfg.num_experts} top-{cfg.experts_per_token} expert "
                   f"F{cfg.moe_d_ff}"}.get(cfg.family, "")
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"built {cfg.name} in {build_s:.2f} s: L{cfg.num_layers} "
          f"D{cfg.d_model} N{cfg.num_heads} K{cfg.num_kv_heads} hd{cfg.resolved_head_dim} "
          f"F{cfg.d_ff} V{cfg.vocab_size}{dims}, causal {cfg.causal}, inputs "
          f"{cfg.input_mode}, {n_params / 1e9:.3f} B parameters; peak device memory of the "
          f"build {peak_build:.2f} GiB")
    gen = torch.Generator(device="cuda").manual_seed(1)
    if cfg.input_mode == "tokens":
        toks = torch.randint(0, cfg.vocab_size, (B, S + steps), dtype=torch.int32,
                             device="cuda", generator=gen)
    else:   # the frontend stubs' (B, S, D) embeddings, in the model's dtype
        toks = torch.randn((B, S + steps, cfg.d_model), generator=gen,
                           device="cuda").to(params["final_norm"].dtype)
    prompt = toks[:, :S]
    opts = tf.ModelOptions(attn_impl="flash", ssd_impl="pallas", wkv_impl="pallas",
                           moe_impl="ep")

    def forward(p, c):
        return tf.forward(p, c, prompt, opts, collect_kv=True, last_only=True)

    prefill = functools.partial(forward, params, cfg)

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = []
    for _ in range(n_forwards):
        ts = time.perf_counter()
        logits, _, caches = prefill()
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - ts) * 1e3)
    counts = read_counts()
    peak_prefill = torch.cuda.max_memory_allocated() / 2**30
    print(f"{n_forwards} forwards: launches {counts}, forward ms {[round(t, 2) for t in fwd_ms]}, "
          f"peak device memory {peak_prefill:.2f} GiB")
    for name, n in per_forward.items():
        check(counts[name] == n * n_forwards,
              f"{name} launches {counts[name]} != {n} per forward x {n_forwards}")
    for name in counts.keys() - per_forward.keys():
        check(counts[name] == 0, f"the prefill path launched {name}: {counts}")
    check(tuple(logits.shape) == (B, 1, cfg.padded_vocab), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()), "non-finite prefill logits")
    median_fwd = statistics.median(fwd_ms[1:])
    flops = tf.model_flops(cfg, B * S, "inference")
    record = {"launches": counts, "parameters": n_params, "build_s": build_s,
              "peak_build_gib": peak_build, "peak_prefill_gib": peak_prefill,
              "median_forward_ms": median_fwd, "first_forward_ms": fwd_ms[0],
              "model_tflop": flops / 1e12,
              "prefill_mfu": flops / (median_fwd / 1e3) / BF16_FLOPS_PER_S}
    print(f"prefill B{B} x {S}: median forward {median_fwd:.2f} ms (first {fwd_ms[0]:.2f} ms), "
          f"{B * S / median_fwd * 1e3:.0f} prompt tokens/s; model_flops {flops / 1e12:.2f} "
          f"TFLOP a forward, prefill_mfu {record['prefill_mfu']:.4f} of 989 TFLOP/s (bf16 dense)")

    decode_argmax = []
    if cfg.causal:
        state = decode_state_from_prefill(tf, params, cfg, caches, B, S, S + steps)
        step_ms, finite = [], []
        for t in range(S, S + steps):
            ts = time.perf_counter()
            step_logits, state = tf.decode_step(params, cfg, state, toks[:, t:t + 1], opts)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
            finite.append(bool(torch.isfinite(step_logits[:, :cfg.vocab_size]).all()))
            decode_argmax.append(step_logits[:, :cfg.vocab_size].argmax(-1))
        check(all(finite), "non-finite decode logits")
        check(int(state["lengths"][0]) == S + steps, "decode did not advance the lengths")
        record["decode_median_ms"] = statistics.median(step_ms)
        print(f"decode {steps} steps x B{B} from the prefill caches: median step "
              f"{statistics.median(step_ms):.2f} ms (first {step_ms[0]:.2f} ms), logits finite")
        del state, step_logits
    else:
        print("encoder (causal=False): no decode step, the reference's documented skip "
              "(tests/test_arch_smoke.py:62)")
    busy_us, by_name, wall_us = profiled(prefill, f"one {arch} prefill forward")
    record["idle_share"] = 1 - busy_us / wall_us if busy_us else None

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
    if cfg.input_mode == "embeddings" and cfg.causal:
        del plain
        record["paged_launches"] = paged_from_prefill(tf, params, cfg, caches, toks, S,
                                                      decode_argmax)
    return record


def paged_exact(q, k_pages, v_pages, block_table, lengths, window, *, scale):
    """Paged attention evaluated in fp64 (the plain version's arithmetic)."""
    B, N, hd = q.shape
    _, page, K, _ = k_pages.shape
    T = block_table.shape[1] * page
    idx = block_table.long()
    k = k_pages[idx].reshape(B, T, K, hd).double().repeat_interleave(N // K, 2)
    v = v_pages[idx].reshape(B, T, K, hd).double().repeat_interleave(N // K, 2)
    scores = torch.einsum("bnh,btnh->bnt", q.double(), k) * scale
    pos = torch.arange(T, device=q.device)[None, :]
    mask = (pos < lengths[:, None]) & ((lengths - 1)[:, None] - pos < window)
    probs = torch.softmax(scores.masked_fill(~mask[:, None, :], -1e300), dim=-1)
    return torch.einsum("bnt,btnh->bnh", probs, v)


def paged_from_prefill(tf, params, cfg, caches, inputs, S, decode_argmax, page=16):
    """The cached decode of an embeddings model (the reference's engine takes
    token prompts only) through ``paged_decode_step``: the prefill's K/V in
    fp32 pools of `page`-token pages, then one step for each of `inputs`'
    positions past S, on (B, 1, D) embeddings, with the kernel and with its
    plain version, each from its own copy of the same pools. In the model's
    bf16, every kernel call is held against its plain version on the same
    inputs within one bf16 ulp (phase 9's flash tolerance), and the argmax
    is printed beside ``decode_step``'s from the same caches. On an fp32
    copy of the model, every kernel call is held against the same attention
    evaluated in fp64: within phase 2's 2e-5 max(1, max |exact|), or within
    twice the fp32 plain version's own distance from it where that is
    larger. Without qk-norm, the random weights' fan-in rule (the head
    count, as the reference's) puts scores in the hundreds, so a softmax is
    near one-hot and an fp32 rounding of one score moves its output by
    ~1e-3 of max |v|; the same rounding flips near ties, which 24 layers
    carry into the logits, so the logits are printed, not bounded (phase 4
    prints them too). Returns the kernel's launches in the bf16 run."""
    import repro_torch.serving.paged_decode as pd_mod
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    B, steps = inputs.shape[0], inputs.shape[1] - S
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    maxp = -(-(S + steps) // page)
    table = torch.arange(B * maxp, dtype=torch.int32, device="cuda").reshape(B, maxp)
    pools = []
    for cache in caches["kv"]:                       # (L, B, S, K, hd)
        pool = torch.zeros((L, B * maxp, page, K, hd), device="cuda")
        pool.view(L, B, maxp * page, K, hd)[:, :, :S] = cache.float()
        pools.append(pool)
    worst = {"bf16": 0.0, "fp32": 0.0, "fp32 kernel err": 0.0, "fp32 plain err": 0.0}

    def bf16_checked(q, kp, vp, table_, lengths, window, *, scale):
        out = pa_ops.paged_attention(q, kp, vp, table_, lengths, window, scale=scale)
        ref = paged_attention_ref(q, kp, vp, table_, lengths, window, scale=scale).float()
        tol = BF16_RTOL * ref.abs() + BF16_ATOL * max(1.0, ref.abs().max().item())
        worst["bf16"] = max(worst["bf16"], ((out.float() - ref).abs() / tol).max().item())
        return out

    def fp32_checked(q, kp, vp, table_, lengths, window, *, scale):
        out = pa_ops.paged_attention(q, kp, vp, table_, lengths, window, scale=scale)
        exact = paged_exact(q, kp, vp, table_, lengths, window, scale=scale)
        plain = paged_attention_ref(q, kp, vp, table_, lengths, window, scale=scale)
        err_k = (out.double() - exact).abs().max().item()
        err_p = (plain.double() - exact).abs().max().item()
        tol = max(2e-5 * max(1.0, exact.abs().max().item()), 2 * err_p)
        worst["fp32"] = max(worst["fp32"], err_k / tol)
        worst["fp32 kernel err"] = max(worst["fp32 kernel err"], err_k)
        worst["fp32 plain err"] = max(worst["fp32 plain err"], err_p)
        return out

    def run(params_, cfg_, x, attention):
        k_pool, v_pool = (p.clone() for p in pools)
        pd_mod.paged_attention = attention
        try:
            out = []
            for t in range(S, S + steps):
                lengths = torch.full((B,), t, dtype=torch.int32, device="cuda")
                logits, _, _ = pd_mod.paged_decode_step(params_, cfg_, k_pool, v_pool, table,
                                                        lengths, x[:, t:t + 1])
                out.append(logits[:, :cfg.vocab_size])
            torch.cuda.synchronize()
        finally:
            pd_mod.paged_attention = pa_ops.paged_attention
        return out

    def agree(a, b):
        return sum(int((x.argmax(-1) == y).sum()) for x, y in zip(a, b, strict=True)) / (
            B * steps)

    def apart(kernel, plain):
        diff = max((a - b).abs().max().item() for a, b in zip(kernel, plain, strict=True))
        return (f"kernel vs plain max |logit diff| {diff:.4e} of max |logit| "
                f"{max(p.abs().max().item() for p in plain):.4e}, argmax agreement "
                f"{agree(kernel, [p.argmax(-1) for p in plain]):.3f}")

    zero_counts()
    kernel = run(params, cfg, inputs, bf16_checked)
    launches = read_counts()["paged_attention"]
    before = read_counts()
    plain = run(params, cfg, inputs, paged_attention_ref)
    check(read_counts() == before, "the plain paged decode launched a kernel")
    check(launches == steps * L, f"paged launches {launches} != {steps} steps x {L} layers")
    check(all(bool(torch.isfinite(x).all()) for x in kernel), "non-finite paged logits")
    print(f"paged decode {steps} steps x B{B} on (B, 1, D) embeddings from the prefill's "
          f"K/V (fp32 pools, page {page}), bf16: launches {launches}; {apart(kernel, plain)}; "
          f"argmax agreement with decode_step from the same caches: kernel "
          f"{agree(kernel, decode_argmax):.3f}, plain {agree(plain, decode_argmax):.3f}; "
          f"every kernel call's largest |diff| / tol {worst['bf16']:.3f} (one bf16 ulp)")
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = _tree_map(lambda t: t.float(), params)
    x32 = inputs.float()
    kernel = run(params32, cfg32, x32, fp32_checked)
    plain = run(params32, cfg32, x32, paged_attention_ref)
    print(f"paged decode in fp32: {apart(kernel, plain)}; every kernel call against fp64: "
          f"largest |diff| {worst['fp32 kernel err']:.3e} (the fp32 plain version's "
          f"{worst['fp32 plain err']:.3e}), largest share of tol {worst['fp32']:.3f}")
    check(worst["bf16"] <= 1.0, "paged_attention disagrees with its plain version in bf16")
    check(worst["fp32"] <= 1.0, "paged_attention is further from fp64 than its tolerance")
    return launches


def moe_breakdown(tf, moe_mod, params, cfg, prefill, busy_us, by_name) -> None:
    """Where an MoE prefill's device time goes, and one layer held in fp32.

    One more prefill records each layer's ``_local_expert_pass`` inputs. Each
    part then runs alone on them under torch.profiler: the grouped expert
    products (``_grouped_ffn``) and the whole routed pass, whose difference
    is the routing, the sort and the scatter-add around the products. Flash
    attention's share is its kernel's device time in the forward's profile."""
    captured = []
    local_pass = moe_mod._local_expert_pass

    def capture(*args, **kwargs):
        captured.append(args)
        return local_pass(*args, **kwargs)

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
        every_row = (e_local == cfg_.num_experts
                     and capacity <= xl.shape[0] * cfg_.experts_per_token)
        groups.append(((xl[sel_t], w_gate, w_up, w_down, sizes), every_row))
    layers = len(captured)

    def products():
        for g, every_row in groups:
            moe_mod._grouped_ffn(*g, every_row=every_row)

    def passes():
        for args in captured:
            local_pass(*args)

    products()
    passes()
    prod_us, prod_by_name, _ = profiled(products, f"{layers} x the grouped expert products, "
                                                  "alone")
    pass_us, _, _ = profiled(passes, f"{layers} x the routed MoE pass, alone")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    products()
    torch.cuda.synchronize()
    prod_wall = (time.perf_counter() - t0) * 1e3
    launches = sum(count for _, count in prod_by_name.values())
    flash_us = sum(t for name, (t, _) in by_name.items() if "flash_attention" in name)
    print(f"moe: grouped expert products {prod_us / layers / 1e3:.4f} ms of device time a "
          f"layer ({launches} kernel launches a forward, as profiled, "
          f"{prod_wall / layers:.4f} ms of wall time a layer run alone); routing, sort and "
          f"scatter {(pass_us - prod_us) / layers / 1e3:.4f} ms a layer")
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


# ------------------------------------------------------------------ training path
TRAIN_HP = dict(learning_rate=1e-3, warmup_steps=1, decay_steps=1000)
# Two runs of the same steps from the same start, optimizer state on the
# device or in pinned host memory: the same fp32 arithmetic on the same
# values, so the losses agree to rounding.
TRAIN_LOSS_RTOL = 1e-5
# grad_accum=2 against the full batch, on an fp32 copy of the model. The
# accumulated gradients are held within TRAIN_ACCUM_GRAD_RTOL of each leaf's
# largest |value| (fp32 sums in another order), and the parameters after one
# step within 5e-5, as tests/test_training.py:53, except where AdamW's first
# step amplifies that gradient difference: it maps the clipped gradient g to
# lr * g / (|g| + eps), whose slope is at most 1/eps = 1e8, so an element
# whose g is near 0 moves by up to lr * |dg| / eps (1.7e-4 on the card for
# a gradient difference of 2.2e-9). Each element is held to the larger of
# the two, from its own gradient difference.
TRAIN_ACCUM_ATOL = 5e-5
TRAIN_ACCUM_GRAD_RTOL = 1e-5
# If an op has no deterministic CUDA version, the restart check is held to 4
# bf16 ulps (4 * 2^-8) of each parameter leaf's largest |value| instead.
TRAIN_NONDET_RTOL = 4 * 2.0 ** -8


def _split_step(tf, adamw, tree, params, opt, batch, cfg, opts, hp):
    """One train step timed in three parts (device-synced): the loss
    (forward), the gradients (backward) and the AdamW update."""
    leaves = tree.leaves
    live = tree.tree_map(lambda p: p.detach().requires_grad_(), params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss, _ = tf.loss_fn(live, cfg, batch, opts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves(live))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    adamw.apply_update(params, tree.unflatten_like(params, list(grads)), opt, hp)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return {"forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
            "optimizer_ms": (t3 - t2) * 1e3}


def train_path() -> dict:
    """Phase 11: train full-width gemma3-1b on the card (see the module's
    docstring). Returns the numbers it printed."""
    import tempfile
    import warnings

    from repro_torch import tree
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.emucxl import EmuCXL
    from repro_torch.core.offload import OffloadPolicy
    from repro_torch.data.loader import PrefetchLoader
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    phase("training path: gemma3-1b full width, 2 x 2048 tokens a step")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma3-1b")
    B, S, n_steps = 2, 2048, 8
    opts = tf.ModelOptions(attn_impl="xla")
    params0 = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    n_params = sum(p.numel() for p in tree.leaves(params0))
    print(f"gemma3-1b: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads "
          f"over {cfg.num_kv_heads} KV head of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, tied; {n_params / 1e9:.4f} B parameters, {cfg.param_dtype}; "
          f"lr {TRAIN_HP['learning_rate']}, attn_impl={opts.attn_impl!r}, remat={opts.remat!r}")
    src = SyntheticTokens(cfg, B, S, seed=0)
    out: dict = {"params": n_params, "tokens_per_step": B * S}

    def fresh(hp):
        params = tree.tree_map(torch.clone, params0)
        return params, adamw.init_state(params, hp)

    def device_batch(i):
        return {k: torch.from_numpy(v).cuda() for k, v in src.batch_at(i).items()}

    def run_steps(offload_state: bool, repeat: bool = False):
        """8 steps through the loader, staging through the port's EmuCXL."""
        hp = adamw.OptimizerConfig(offload_state=offload_state, **TRAIN_HP)
        params, opt = fresh(hp)
        step = make_train_step(cfg, opts, hp)
        lib = EmuCXL()
        lib.init(local_capacity=1 << 26, remote_capacity=1 << 28, device="cuda")
        loader = PrefetchLoader(src, lib=lib, device="cuda")
        losses, gnorms, secs, first = [], [], [], None
        try:
            for _ in range(n_steps):
                batch = loader.get()
                if repeat:
                    first = batch if first is None else first
                    batch = first
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batch)
                losses.append(float(metrics["loss"]))
                gnorms.append(float(metrics["grad_norm"]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            staged = loader.state()["step"]
        finally:
            loader.close()
            lib.exit()
        check(all(l == l and abs(l) < float("inf") for l in losses), f"non-finite loss {losses}")
        return hp, params, opt, step, losses, gnorms, secs, staged

    runs = {}
    for offload_state in (False, True):
        hp, params, opt, step, losses, gnorms, secs, staged = run_steps(offload_state)
        state_leaves = [t for k in ("m", "v", "master") for t in tree.leaves(opt[k])]
        if offload_state:
            check(all(t.is_pinned() for t in state_leaves),
                  "offload_state=True left optimizer state off pinned host memory")
        else:
            check(all(t.is_cuda for t in state_leaves), "optimizer state is not on the card")
        state_bytes = sum(t.numel() * t.element_size() for t in state_leaves)
        med = statistics.median(secs[1:])
        split = _split_step(tf, adamw, tree, params, opt, device_batch(n_steps), cfg, opts, hp)
        busy_us, _, _ = profiled(lambda: step(params, opt, device_batch(n_steps + 1)),
                                 f"one train step, optimizer state "
                                 f"{'in pinned host memory' if offload_state else 'on the card'}")
        torch.cuda.synchronize()
        where = "host" if offload_state else "device"
        print(f"state on the {where}: losses {[round(l, 5) for l in losses]}; steps "
              f"{[round(t * 1e3, 1) for t in secs]} ms (first includes warm-up); median "
              f"{med * 1e3:.1f} ms, {B * S / med:.0f} tokens/s; split {split}; "
              f"optimizer state {state_bytes / 1e9:.3f} GB; {staged} batches staged")
        print(f"the profiled step's device busy time is {busy_us / 1e3 / (med * 1e3):.3f} of "
              f"the unprofiled median step (the profiler slows the host)")
        row = {"losses": losses, "grad_norms": gnorms,
               "step_ms": [t * 1e3 for t in secs], "median_ms": med * 1e3,
               "tokens_per_s": B * S / med, **split, "state_bytes": state_bytes,
               "device_busy_ms": busy_us / 1e3}
        if offload_state:
            moved = 2 * state_bytes
            row["optimizer_host_device_bytes"] = moved
            print(f"optimizer with offloaded state: {moved / 1e9:.3f} GB across the host link "
                  f"a step (fetch + write-back of m, v, master), "
                  f"{split['optimizer_ms']:.1f} ms, {moved / split['optimizer_ms'] / 1e6:.1f} GB/s")
        runs[where] = row
        del params, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    worst = max(abs(a - b) / abs(a) for a, b in zip(runs["device"]["losses"],
                                                      runs["host"]["losses"], strict=True))
    print(f"losses, state on the device vs in pinned host memory: max relative difference "
          f"{worst:.3e} (limit {TRAIN_LOSS_RTOL})")
    check(worst <= TRAIN_LOSS_RTOL, f"offloaded optimizer state changes the losses by {worst}")
    out.update(runs=runs, offload_loss_rel_diff=worst)

    # -- the loss falls on one repeated batch
    _, params, opt, step, losses, _, _, _ = run_steps(False, repeat=True)
    print(f"one repeated batch, {n_steps} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({[round(l, 4) for l in losses]})")
    check(losses[-1] < losses[0] - 0.5, f"the loss does not fall: {losses}")
    out["repeated_batch_losses"] = losses
    del params, opt, step

    # -- remat: one step each, same start, same batch
    batch = device_batch(0)
    remat_rows = {}
    for remat in ("none", "full", "offload"):
        hp = adamw.OptimizerConfig(**TRAIN_HP)
        params, opt = fresh(hp)
        step = make_train_step(cfg, dataclasses.replace(opts, remat=remat), hp)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = OffloadPolicy.total_bytes
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        remat_rows[remat] = {"loss": loss, "grad_norm": gnorm, "step_ms": ms,
                             "peak_bytes": peak, "peak_over_start_bytes": peak - base,
                             "offloaded_bytes": OffloadPolicy.total_bytes - before}
        print(f"remat={remat!r}: loss {loss:.6f}, grad norm {gnorm:.6f}, step {ms:.1f} ms "
              f"(first of its kind), peak device memory {peak / 2**30:.2f} GiB "
              f"({(peak - base) / 2**30:.2f} GiB over the {base / 2**30:.2f} GiB held "
              f"before the step), saved inputs sent to the host "
              f"{remat_rows[remat]['offloaded_bytes'] / 2**20:.1f} MiB")
        del params, opt, step, metrics
    for remat in ("full", "offload"):
        for key in ("loss", "grad_norm"):
            a, b = remat_rows["none"][key], remat_rows[remat][key]
            check(abs(a - b) <= TRAIN_LOSS_RTOL * abs(a),
                  f"remat={remat!r} changes the {key}: {a} vs {b}")
    check(remat_rows["offload"]["offloaded_bytes"] > 0, "remat='offload' sent nothing to the host")
    out["remat"] = remat_rows

    # -- the CUDA kernels refuse grad: a flash train step raises before launching
    mods = kernel_modules()
    hp = adamw.OptimizerConfig(**TRAIN_HP)
    before = mods["flash_attention"].launches
    try:
        make_train_step(cfg, dataclasses.replace(opts, attn_impl="flash"), hp)(
            params0, None, batch)
    except NotImplementedError as e:
        print(f"attn_impl='flash' train step refused: {str(e)[:100]}...")
    else:
        raise RuntimeError("chip_smoke: a train step ran the flash kernel under grad")
    check(mods["flash_attention"].launches == before, "flash launched before refusing")

    # -- checkpoint restart, bitwise under deterministic algorithms
    hp = adamw.OptimizerConfig(offload_state=True, **TRAIN_HP)
    params, opt = fresh(hp)
    step = make_train_step(cfg, opts, hp)
    torch.use_deterministic_algorithms(True, warn_only=True)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")    # phase 12 restores it, then removes it
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(4):
                params, opt, _ = step(params, opt, device_batch(i))
            mgr = CheckpointManager(ckdir, keep=1, async_save=False)
            t0 = time.perf_counter()
            mgr.save(4, {"params": params, "opt": opt}, block=True)
            save_s = time.perf_counter() - t0
            for i in (4, 5):
                params, opt, _ = step(params, opt, device_batch(i))
            first_run = tree.tree_map(torch.clone, params)
            t0 = time.perf_counter()
            restored = mgr.restore(4, {"params": params, "opt": opt})
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            ck_bytes = sum(p.stat().st_size for p in Path(ckdir).rglob("*.npy"))
            del params, opt
            params, opt = restored["params"], restored["opt"]
            check(all(t.is_pinned() for t in tree.leaves(opt["m"])),
                  "restored optimizer state is not in pinned host memory")
            for i in (4, 5):
                params, opt, _ = step(params, opt, device_batch(i))
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split("\n")[0] for w in caught
                     if "deterministic" in str(w.message)})
    diffs = [float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))
             for a, b in zip(tree.leaves(params), tree.leaves(first_run), strict=True)]
    equal = all(torch.equal(a, b) for a, b in zip(tree.leaves(params), tree.leaves(first_run)))
    print(f"checkpoint: {ck_bytes / 1e9:.3f} GB of step files, save "
          f"{save_s:.1f} s, restore {restore_s:.1f} s; resumed run bitwise equal: {equal}; "
          f"largest leaf difference {max(diffs):.3e} of its max")
    if nondet:
        print(f"ops without a deterministic CUDA version: {nondet}; held to "
              f"{TRAIN_NONDET_RTOL:.4f} of each leaf's largest |value|")
        check(max(diffs) <= TRAIN_NONDET_RTOL, f"restart differs by {max(diffs)}")
    else:
        check(equal, "the resumed run is not bitwise equal to the uninterrupted one")
    out["checkpoint"] = {"bytes": ck_bytes, "save_s": save_s, "restore_s": restore_s,
                         "bitwise": equal, "nondeterministic_ops": nondet}
    del params, opt, restored, first_run, step

    # -- grad accumulation, fp32 copy of the model, remat full to fit
    from repro_torch.launch.steps import _value_and_grad

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    hp = adamw.OptimizerConfig(**TRAIN_HP)
    opts32 = dataclasses.replace(opts, remat="full")
    base = tree.tree_map(lambda p: p.to(torch.float32, copy=True), params0)
    del params0
    results = []
    for accum in (1, 2):
        gc.collect()
        torch.cuda.empty_cache()
        params = tree.tree_map(torch.clone, base)
        opt = adamw.init_state(params, hp)
        params, opt, metrics = make_train_step(cfg32, opts32, hp, grad_accum=accum)(
            params, opt, batch)
        results.append((params, float(metrics["loss"]), float(metrics["lr"])))
        del opt
    (p1, l1, lr1), (p2, l2, _) = results
    del results
    # the gradients each run took, as make_train_step forms them
    loss_of = lambda p, b: tf.loss_fn(p, cfg32, b, opts32)
    _, g1 = _value_and_grad(loss_of, base, batch)
    g2 = None
    for i in range(2):
        _, g = _value_and_grad(loss_of, base, {k: v[i:i + 1] for k, v in batch.items()})
        g2 = g if g2 is None else tree.tree_map(torch.add, g2, g)
    g2 = tree.tree_map(lambda g: g / 2, g2)
    del base, g
    s1 = min(1.0, hp.grad_clip_norm / (float(adamw.global_norm(g1)) + 1e-9))
    s2 = min(1.0, hp.grad_clip_norm / (float(adamw.global_norm(g2)) + 1e-9))
    grad_rel, param_diff, over, over_bound = 0.0, 0.0, 0, 0.0
    for a, b, pa, pb in zip(tree.leaves(g1), tree.leaves(g2), tree.leaves(p1),
                            tree.leaves(p2), strict=True):
        grad_rel = max(grad_rel, float((a - b).abs().max() / a.abs().max()))
        dp = (pa - pb).abs()
        bound = torch.clamp(lr1 * (a * s1 - b * s2).abs() / hp.eps * 1.01 + 1e-7,
                            min=TRAIN_ACCUM_ATOL)
        param_diff = max(param_diff, float(dp.max()))
        over += int((dp > TRAIN_ACCUM_ATOL).sum())
        over_bound = max(over_bound, float((dp / bound).max()))
    print(f"fp32, grad_accum=2 vs full batch: gradients within {grad_rel:.3e} of each leaf's "
          f"largest |value| (limit {TRAIN_ACCUM_GRAD_RTOL}); parameters within "
          f"{param_diff:.3e}, {over} of {n_params} elements past {TRAIN_ACCUM_ATOL}, each within "
          f"{over_bound:.3f} of its bound max({TRAIN_ACCUM_ATOL}, lr |dg| / eps); loss "
          f"{l1:.6f} vs {l2:.6f}")
    check(grad_rel <= TRAIN_ACCUM_GRAD_RTOL, f"accumulated gradients differ by {grad_rel}")
    check(over_bound <= 1.0, f"grad accumulation moves a parameter past its bound ({over_bound})")
    check(abs(l1 - l2) < 1e-3, f"grad accumulation changes the loss: {l1} vs {l2}")
    out["grad_accum"] = {"grad_max_rel_diff": grad_rel, "param_max_abs_diff": param_diff,
                         "params_past_5e-5": over, "worst_over_bound": over_bound,
                         "loss_full": l1, "loss_accum": l2}
    del p1, p2, g1, g2
    torch.cuda.synchronize()
    print("training: " + json.dumps(out))
    return out, ckdir


# ------------------------------------------------------------------ multi-device layer
MESH_RULES = ("train_fsdp", "train_dp_all")
MESH_STEPS = 3
DRYRUN_CELLS = (("gemma3-1b", "train_4k"), ("kimi-k2-1t-a32b", "decode_32k"))
# The dry run: each cell on the 16x16 mesh of a fake 256-rank group, meta
# tensors only, on the CPU, beside the card's work; its per-device parameter
# bytes are held against those reckoned from the port's specs alone.
DRYRUN_SCRIPT = """
import json, math, sys
sys.path.insert(0, "src")
from repro_torch.launch import dryrun, specs as sp
from repro_torch.tree import leaves

class Grid:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")

out = {}
for arch, shape in %r:
    run, meta = dryrun.build_cell(arch, shape)
    counts = run()
    cfg, rules = meta["cfg"], meta["rules"]
    reckoned = 0
    for sh, t in zip(leaves(sp.param_shardings(cfg, Grid, rules)), leaves(sp.params_specs(cfg))):
        split = math.prod(Grid.shape[a] for e in sh.spec if e
                          for a in ((e,) if isinstance(e, str) else e))
        reckoned += t.numel() // split * t.element_size()
    out[arch + " x " + shape] = {
        "rules": rules, "param_bytes": meta["param_bytes"], "reckoned_param_bytes": reckoned,
        "argument_bytes": meta["argument_bytes"], "host_argument_bytes": meta["host_argument_bytes"],
        "collectives": counts}
print(json.dumps(out))
""" % (DRYRUN_CELLS,)


def multi_device_path(training: dict, ckdir: str, smi: str) -> dict:
    """Phase 12: the multi-device layer on one card (see the module's
    docstring). Returns the numbers it printed."""
    import shutil

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.distributed import axis_rules, compression, named_sharding
    from repro_torch.distributed.sharding import device_put, full_tensor
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from torch.distributed.tensor import DTensor

    phase("multi-device layer: gemma3-1b full width on a 1x1 NCCL mesh")
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    dry = subprocess.Popen([sys.executable, "-c", DRYRUN_SCRIPT], cwd=root, text=True,
                           env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    zero_counts()
    out: dict = {"card": smi, "mesh": "1x1 (data, model), NCCL, world size 1"}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        cfg = get_config("gemma3-1b")
        B, S = 2, 2048
        opts = tf.ModelOptions(attn_impl="xla")
        params0 = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                 device="cuda")
        src = SyntheticTokens(cfg, B, S, seed=0)
        one = training["runs"]["device"]
        scalar = lambda x: float(x.full_tensor() if isinstance(x, DTensor) else x)  # noqa: E731

        def placed(rules, hp):
            params = tree.tree_map(device_put, params0, sp.param_shardings(cfg, mesh, rules))
            opt = tree.tree_map(device_put, adamw.init_state(params, hp),
                                sp.opt_state_shardings(cfg, hp, mesh, rules))
            return params, opt

        def batch(i, rules):
            b_sh = named_sharding(("batch", "seq"), mesh, rules, shape=(B, S))
            return {k: device_put(torch.from_numpy(v).cuda(), b_sh)
                    for k, v in src.batch_at(i).items()}

        rows = {}
        for rules in MESH_RULES:
            hp = adamw.OptimizerConfig(**TRAIN_HP)
            params, opt = placed(rules, hp)
            step = make_train_step(cfg, opts, hp)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, gnorms, secs = [], [], []
            for i in range(MESH_STEPS):
                b = batch(i, rules)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with axis_rules(mesh, rules):
                    params, opt, metrics = step(params, opt, b)
                losses.append(scalar(metrics["loss"]))
                gnorms.append(scalar(metrics["grad_norm"]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            d_loss = max(abs(a - b) / abs(b) for a, b in zip(losses, one["losses"]))
            d_gnorm = max(abs(a - b) / abs(b) for a, b in zip(gnorms, one["grad_norms"]))
            b = batch(MESH_STEPS, rules)
            with axis_rules(mesh, rules):
                step(params, opt, b)                     # warm, then profile one step
                torch.cuda.synchronize()
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    step(params, opt, b)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
            busy_us, _ = print_profile(prof, wall_us, f"one train step on the mesh, {rules}")
            med = statistics.median(secs[1:])
            print(f"{rules}: losses {[round(x, 6) for x in losses]} vs phase 11 "
                  f"{[round(x, 6) for x in one['losses'][:MESH_STEPS]]}; grad norms "
                  f"{[round(x, 6) for x in gnorms]} vs "
                  f"{[round(x, 6) for x in one['grad_norms'][:MESH_STEPS]]}; largest relative "
                  f"difference loss {d_loss:.3e}, grad norm {d_gnorm:.3e} (limit "
                  f"{TRAIN_LOSS_RTOL}); steps {[round(t * 1e3, 1) for t in secs]} ms, median "
                  f"{med * 1e3:.1f} ms against phase 11's {one['median_ms']:.1f} ms; peak device "
                  f"memory {peak / 2**30:.2f} GiB [{smi}]")
            check(d_loss <= TRAIN_LOSS_RTOL, f"{rules}: mesh losses differ by {d_loss}")
            check(d_gnorm <= TRAIN_LOSS_RTOL, f"{rules}: mesh grad norms differ by {d_gnorm}")
            rows[rules] = {"losses": losses, "grad_norms": gnorms, "loss_rel_diff": d_loss,
                           "grad_norm_rel_diff": d_gnorm, "step_ms": [t * 1e3 for t in secs],
                           "median_ms": med * 1e3, "phase11_median_ms": one["median_ms"],
                           "peak_bytes": peak, "profiled_wall_ms": wall_us / 1e3,
                           "device_busy_ms": busy_us / 1e3,
                           "idle_share": 1 - busy_us / wall_us if busy_us else None}
            del params, opt, step
            gc.collect()
            torch.cuda.empty_cache()
        out["rules"] = rows

        # -- one train_fsdp step with the AdamW state's shards in pinned host memory
        hp = adamw.OptimizerConfig(offload_state=True, **TRAIN_HP)
        params, opt = placed("train_fsdp", hp)
        shards = [t.to_local() for k in ("m", "v", "master") for t in tree.leaves(opt[k])]
        check(all(t.is_pinned() for t in shards), "offloaded state shards are not pinned")
        with axis_rules(mesh, "train_fsdp"):
            _, opt, metrics = make_train_step(cfg, opts, hp)(params, opt, batch(0, "train_fsdp"))
        loss = scalar(metrics["loss"])
        on_card = rows["train_fsdp"]["losses"][0]
        print(f"train_fsdp with the state's shards in pinned host memory: loss {loss:.6f} "
              f"(on the card {on_card:.6f}); {sum(t.numel() * t.element_size() for t in shards) / 1e9:.3f} "
              f"GB of pinned shards")
        check(loss == on_card, f"offloaded state changes the loss: {loss} vs {on_card}")
        check(all(t.to_local().is_pinned() for t in tree.leaves(opt["m"])),
              "the update moved the state off pinned host memory")
        out["offload"] = {"loss": loss, "on_card_loss": on_card}
        del params, opt, shards
        gc.collect()
        torch.cuda.empty_cache()

        # -- elastic restore of phase 11's mesh-less checkpoint onto the mesh
        template = {"params": sp.params_specs(cfg), "opt": sp.opt_state_specs(cfg, hp)}
        shardings = {"params": sp.param_shardings(cfg, mesh, "train_fsdp"),
                     "opt": sp.opt_state_shardings(cfg, hp, mesh, "train_fsdp")}
        mgr = ckpt.CheckpointManager(ckdir, keep=1, async_save=False)
        step_no = mgr.latest_step()
        t0 = time.perf_counter()
        restored = mgr.restore(step_no, template, shardings=shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        src_dir = Path(ckdir) / f"step_{step_no:09d}"
        flat = ckpt._flatten(restored)
        equal = all(torch.equal(full_tensor(leaf).cpu(),
                                ckpt._load(src_dir / f"{key}.npy", torch.empty(0, dtype=leaf.dtype)))
                    for key, leaf in flat.items())
        pinned = all(leaf.to_local().is_pinned() for key, leaf in flat.items()
                     if key.startswith(("opt__m__", "opt__v__", "opt__master__")))
        print(f"elastic restore of phase 11's step-{step_no} checkpoint onto the mesh: "
              f"{len(flat)} leaves in {restore_s:.1f} s, every full_tensor() bitwise equal: "
              f"{equal}; state shards pinned: {pinned}")
        check(equal, "a restored leaf differs from the checkpoint")
        check(pinned, "restored state shards are not in pinned host memory")
        out["restore"] = {"leaves": len(flat), "seconds": restore_s, "bitwise": equal}
        del restored, flat

        # -- psum_compressed over the one-rank group
        gen = torch.Generator(device="cuda").manual_seed(5)
        g = {"w": torch.randn((1152, 6912), generator=gen, device="cuda") * 1e-2,
             "b": torch.randn((1152,), generator=gen, device="cuda")}
        with axis_rules(mesh, "train_fsdp"):
            red, err = compression.psum_compressed(g, "data")
        qs, err2 = compression.compress_tree(g)
        deq = compression.decompress_tree(qs)
        same = all(torch.equal(red[k], deq[k]) and torch.equal(err[k], err2[k]) for k in g)
        print(f"psum_compressed over the one-rank group equals compress -> decompress "
              f"bitwise: {same}")
        check(same, "psum_compressed over one rank differs from compress -> decompress")
        out["compression_bitwise"] = same
        counts = read_counts()
        check(not any(counts.values()), f"a kernel ran in training on the mesh: {counts}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(ckdir, ignore_errors=True)
        try:
            dry_out, dry_err = dry.communicate(timeout=300)
        finally:
            if dry.poll() is None:
                dry.kill()
    check(dry.returncode == 0, f"the dry run failed: {dry_err[-2000:]}")
    cells = json.loads(dry_out.strip().splitlines()[-1])
    for name, cell in cells.items():
        print(f"dry run {name} on a fake 16x16 mesh ({cell['rules']}): parameters "
              f"{cell['param_bytes'] / 2**30:.3f} GiB a device (from the specs "
              f"{cell['reckoned_param_bytes'] / 2**30:.3f} GiB), arguments "
              f"{cell['argument_bytes'] / 2**30:.3f} GiB, host tier "
              f"{cell['host_argument_bytes'] / 2**30:.3f} GiB; collectives {cell['collectives']}")
        check(cell["param_bytes"] == cell["reckoned_param_bytes"],
              f"dry run {name}: placed parameter bytes differ from the specs'")
    out["dryrun"] = cells
    print("multi_device: " + json.dumps(out))
    return out


# ------------------------------------------------------------------ every config one card holds
# The published configs that fit one 80 GB card and that no phase above runs,
# the largest first (deepseek-coder-33b's 62.1 GiB of bf16 weights leave the
# least room), each with the flash launches a forward must make; the two
# token models are also served through the tiered paged engine.
ONE_CARD = (("deepseek-coder-33b", 62), ("gemma3-12b", 48), ("internvl2-1b", 24),
            ("hubert-xlarge", 48))
ONE_CARD_SERVED = ("deepseek-coder-33b", "gemma3-12b")


def every_config_one_card_holds(ops, ref, smi: str) -> dict:
    """Phase 13: each model of ONE_CARD built at full width with random bf16
    weights, freed before the next: its prefill path (phase 9's checks; the
    embeddings models from (B, S, D) inputs, internvl2-1b's decode also
    through ``paged_decode_step``, hubert-xlarge's encoder without decode),
    then the serving path for the token models. Prints a ``one_card: {...}``
    JSON line with each model's numbers and the card's name and power limit."""
    out = {}
    for arch, flash_per_forward in ONE_CARD:
        out[arch] = prefill_path(arch, {"flash_attention": flash_per_forward})
        if arch in ONE_CARD_SERVED:
            out[arch]["serving_launches"] = main_path(ops, ref, arch)
    print("one_card: " + json.dumps({"card": smi, "models": out}))
    return out


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
    gemma = prefill_path("gemma3-1b", {"flash_attention": 26})["launches"]
    zamba = prefill_path("zamba2-1.2b", {"flash_attention": 6, "mamba2_ssd": 38})["launches"]
    rwkv = prefill_path("rwkv6-3b", {"wkv6": 32})["launches"]
    olmoe = prefill_path("olmoe-1b-7b", {"flash_attention": 16})["launches"]
    olmoe_launches = main_path(ops, ref, "olmoe-1b-7b", widths=128)
    training, ckdir = train_path()
    multi_device_path(training, ckdir, smi)
    one_card = every_config_one_card_holds(ops, ref, smi)
    served = {arch: rec["serving_launches"] for arch, rec in one_card.items()
              if "serving_launches" in rec}
    paged_by_model = {"gemma3-1b": launches, "olmoe-1b-7b": olmoe_launches, **served,
                      "internvl2-1b": one_card["internvl2-1b"]["paged_launches"]}
    flash_by_model = {"gemma3-1b": gemma["flash_attention"],
                      "zamba2-1.2b": zamba["flash_attention"],
                      "olmoe-1b-7b": olmoe["flash_attention"],
                      **{arch: rec["launches"]["flash_attention"]
                         for arch, rec in one_card.items()}}
    phase("results")
    print(json.dumps({"kernels": [
        kernel_record("paged_attention",
                      "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
                      "src/repro/kernels/paged_attention/paged_attention.py:93",
                      sum(paged_by_model.values()), worst, rows["serving"],
                      launches_by_model=paged_by_model,
                      shapes={k: v for k, v in rows.items() if k != "serving"}),
        kernel_record("flash_attention",
                      "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention/flash_attention.py:107",
                      sum(flash_by_model.values()), worst_flash,
                      prefill_rows["gemma3_global"], launches_by_model=flash_by_model,
                      shapes={k: v for k, v in prefill_rows.items()
                              if k not in ("ssd_zamba2", "wkv6_rwkv6")}),
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
