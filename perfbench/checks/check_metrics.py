"""The metric arithmetic on hand-made records: counts, percentiles over the
window, the rooflines and the idle share read from a trace."""

import types

import pytest
import torch

from perfbench.lib import files, flops, profile, stats
from perfbench.lib.cell import Check, Record

MODEL = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4,
         "num_hidden_layers": 3, "intermediate_size": 16, "vocab_size": 300,
         "torch_dtype": "bfloat16"}
MOE = {**MODEL, "num_experts": 4, "num_experts_per_tok": 2}


def read(name, rec):
    return files.load_module("metrics", name).read(rec)


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = files.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(files.load_module("metrics", m["name"]).read), m["name"]
    names = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        work = files.load_json("workloads", w["name"])
        assert (work["config"], work["traffic"], work["chips"]) == (w["config"], w["traffic"],
                                                                    w["chips"])
        files.load_module("drivers", files.load_json("traffic", w["traffic"])["kind"])
        reported = {m["name"] for m in files.cell_metrics(bench, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert files.cell_metrics(bench, w["name"], True)
    for m in bench["per_layer"]:
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", names)), m["name"]


def test_percentile():
    assert stats.percentile([], 90) is None
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile(list(range(11)), 90) == pytest.approx(9.0)
    assert stats.percentile([1.0, 2.0], 50) == pytest.approx(1.5)


def test_step_counts():
    # per layer: q 8x2x4, k and v 8x1x4 each, o 2x4x8, MLP 3x8x16
    per_layer = 64 + 64 + 64 + 384
    assert flops.matmul_params(MODEL) == 3 * per_layer
    # MoE: the routed experts only (2 of 4) and the router
    assert flops.matmul_params(MOE) == 3 * (192 + 2 * 384 + 8 * 4)
    assert flops.attention_pair_flops(MODEL) == 3 * 4 * 2 * 4
    assert flops.decode_flops(MODEL, [5, 7]) == 2 * 2 * (3 * per_layer + 8 * 300) + 96 * 12
    assert flops.prefill_flops(MODEL, 4) == 2 * 3 * per_layer * 4 + 2 * 8 * 300 + 96 * 10


BF16, FP32 = torch.bfloat16, torch.float32
FROZEN = {
    # matmul_params, attention_pair_flops, prefill_flops(S=1448),
    # decode_flops([100, 200]), layers that run attention; then the layout
    "deepseek-coder-33b": (32_879_673_344, 1_777_664, 9.7084901064704e13, 1.32976836608e11, 62, [
        ("embed", (32256, 7168), BF16),
        ("stack.ln1", (62, 7168), BF16),
        ("stack.ln2", (62, 7168), BF16),
        ("stack.attn.wq", (62, 7168, 56, 128), BF16),
        ("stack.attn.wk", (62, 7168, 8, 128), BF16),
        ("stack.attn.wv", (62, 7168, 8, 128), BF16),
        ("stack.attn.wo", (62, 56, 128, 7168), BF16),
        ("stack.mlp.w_gate", (62, 7168, 19200), BF16),
        ("stack.mlp.w_up", (62, 7168, 19200), BF16),
        ("stack.mlp.w_down", (62, 19200, 7168), BF16),
        ("final_norm", (7168,), BF16),
        ("unembed", (7168, 32256), BF16),
    ]),
    "olmoe-1b-7b": (1_075_838_976, 131_072, 3.253340209152e12, 4.754767872e9, 16, [
        ("embed", (50432, 2048), BF16),
        ("stack.ln1", (16, 2048), BF16),
        ("stack.ln2", (16, 2048), BF16),
        ("stack.attn.wq", (16, 2048, 16, 128), BF16),
        ("stack.attn.wk", (16, 2048, 16, 128), BF16),
        ("stack.attn.wv", (16, 2048, 16, 128), BF16),
        ("stack.attn.wo", (16, 16, 128, 2048), BF16),
        ("stack.attn.q_norm", (16, 128), BF16),
        ("stack.attn.k_norm", (16, 128), BF16),
        ("stack.moe.router", (16, 2048, 64), FP32),
        ("stack.moe.w_gate", (16, 64, 2048, 1024), BF16),
        ("stack.moe.w_up", (16, 64, 2048, 1024), BF16),
        ("stack.moe.w_down", (16, 64, 1024, 2048), BF16),
        ("final_norm", (2048,), BF16),
        ("unembed", (2048, 50432), BF16),
    ]),
}


@pytest.mark.parametrize("config", sorted(FROZEN))
def test_published_counts_and_layouts_are_frozen(config):
    """The counts the cells' metrics divide by, and the leaves the seed draws
    in order, for the published configurations: a change to either moves
    every reading of the cells."""
    params, pair, prefill, decode, attn_layers, leaves = FROZEN[config]
    model = files.load_json("configs", config)
    assert flops.matmul_params(model) == params
    assert flops.attention_pair_flops(model) == pair
    assert flops.prefill_flops(model, 1448) == prefill
    assert flops.decode_flops(model, [100, 200]) == decode
    assert flops.mixer_token_flops(model) == 0
    assert flops.attention_layer_count(model) == attn_layers
    layout = files.architecture(model).layout(model)
    assert [(name, tuple(shape), dtype) for name, (shape, dtype) in layout.items()] == leaves


def test_kernel_bounds():
    # two sequences of 20 and 3 keys, page 16, fp32 pages, bf16 q and output
    b = flops.paged_bytes(MODEL, [20, 3], 16)
    assert b == 2 * 23 * 1 * 4 * 4 + (2 + 1) * 4 + 2 * 4 + 2 * 2 * 2 * 4 * 2
    assert flops.paged_seconds(MODEL, [20, 3], 16) == pytest.approx(
        max(b / flops.HBM_BYTES, 4 * 2 * 4 * 23 / flops.FP32_FLOPS))
    S = 4096
    t = flops.flash_seconds({**MODEL, "num_attention_heads": 56, "num_key_value_heads": 8,
                             "head_dim": 128}, 1, S)
    assert t == pytest.approx(4 * 56 * 128 * S * (S + 1) / 2 / flops.BF16_FLOPS)


def _serve_record():
    rec = Record(window_s=2.0)
    rec.data = {
        "kind": "serve", "model": MODEL, "page": 16, "max_batch": 4, "tokens": 30, "steps": 3,
        "t0": 10.0, "t1": 12.0,
        # (arrival, token times): the first token before the window is left out
        "requests": [(9.0, [9.5, 10.5, 11.0]), (10.0, [10.4, 11.9]), (11.5, [])],
        "spans": {"steps": [(10.0, 10.5), (10.5, 11.0)],
                  "decodes": [(10.1, 10.4, [5, 7]), (10.6, 10.9, [6, 8, 2, 2])]},
        "slice": {"decodes": [(0.0, 0.0, [20, 3])]},
    }
    return rec


def test_serving_readers():
    rec = _serve_record()
    assert read("gen_tokens_per_s", rec) == pytest.approx(15.0)
    assert read("ttft_p90_ms.serve", rec) == pytest.approx(400.0)
    # gaps ending in the window: 1.0, 0.5, 1.5 s
    assert read("tpot_p95_ms.serve", rec) == pytest.approx(
        stats.percentile([1000.0, 500.0, 1500.0], 95))
    assert read("engine_host_ms", rec) == pytest.approx(200.0)
    assert read("batch_fill", rec) == pytest.approx(75.0)
    work = flops.decode_flops(MODEL, [5, 7]) + flops.decode_flops(MODEL, [6, 8, 2, 2])
    assert read("decode_mfu", rec) == pytest.approx(100 * work / 2.0 / flops.BF16_FLOPS)
    assert read("prefill_tokens_per_s", rec) is None
    assert read("paged_attn_roofline", rec) is None        # untraced: nothing to read


def _fake_prof(events):
    from torch.autograd import DeviceType

    evs = []
    for name, dev, a, b in events:
        evs.append(types.SimpleNamespace(
            name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
            time_range=types.SimpleNamespace(start=a, end=b), device_time_total=b - a))
    return types.SimpleNamespace(events=lambda: evs)


def test_trace_summary_busy_gaps_and_rooflines():
    prof = _fake_prof([
        ("pb.step", False, 0, 100), ("pb.decode", False, 10, 60),
        ("pb.step", True, 0, 100),                          # the span's device copy
        ("paged_partition_kernel<128, 1>", True, 20, 30),
        ("paged_combine_kernel", True, 25, 35),             # overlaps: union 20..35
        ("nvjet_gemm", True, 70, 80),                       # gap 35..70 at 52.5: decode
        ("flash_attention_wgmma_kernel<128>", True, 90, 95),  # gap 80..90 at 85: step
    ])
    s = profile.summarize(prof, 100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["idle_by_span"] == pytest.approx({"decode": 35e-6, "step": 10e-6})
    assert "pb.step" not in s["by_name"]
    assert profile.kernel_seconds(s, "paged_") == (pytest.approx(20e-6), 2)
    bd = profile.breakdown(s)
    assert bd["idle_gaps"][0] == ["decode", pytest.approx(35e-6)]

    rec = _serve_record()
    rec.profile = s
    need = 3 * flops.paged_seconds(MODEL, [20, 3], 16)
    assert read("paged_attn_roofline", rec) == pytest.approx(100 * need / 20e-6)
    assert read("idle_share.serve", rec) == pytest.approx(70.0)
    assert read("idle_share.prefill", rec) is None

    pre = Record(window_s=4.0, profile=s)
    pre.data = {"kind": "prefill", "batch": 1, "model": MODEL,
                "units": [(100, 0.0, 0.5), (200, 1.0, 1.9), (300, 2.0, 2.2)],
                "slice_units": [(64, 0.0, 0.0)]}
    assert read("prefill_tokens_per_s", pre) == pytest.approx(150.0)
    assert read("prefill_p90_ms", pre) == pytest.approx(stats.percentile([500, 900, 200], 90))
    assert read("prefill_mfu", pre) == pytest.approx(
        100 * sum(flops.prefill_flops(MODEL, S) for S in (100, 200, 300)) / 4.0
        / flops.BF16_FLOPS)
    assert read("flash_roofline", pre) == pytest.approx(
        100 * 3 * flops.flash_seconds(MODEL, 1, 64) / 5e-6)
    assert read("idle_share.prefill", pre) == pytest.approx(70.0)


def test_a_check_without_a_number_is_not_correct():
    assert not Record(checks=[Check("max_gap", float("nan"), 1.0)]).correct
    assert not Record().correct
    assert Record(checks=[Check("max_gap", 0.5, 1.0)]).correct
