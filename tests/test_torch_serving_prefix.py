"""Serving parity, shared-prefix import (tests/test_serving.py:101): two hosts'
engines import one coherent prefix segment. The port on the CPU generates the
reference's token ids and reproduces its tier, coherence and fabric statistics.
"""

import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402


@pytest.fixture(scope="module")
def runs():
    cfg_r, params_r, cfg_t, params_t = tp.models()
    return tp.shared_prefix_run(tp.REF, params_r, cfg_r), \
        tp.shared_prefix_run(tp.PORT, params_t, cfg_t)


def test_prefix_tokens_equal(runs):
    ref, out = runs
    for key in ("tokens0", "tokens1", "tokens_other"):
        assert out[key] == ref[key], key
    assert out["positions"] == ref["positions"]


def test_prefix_tier_stats_equal(runs):
    ref, out = runs
    assert [s["prefix_imports"] for s in out["tier_stats"]] == [1, 1]
    assert out["tier_stats"] == ref["tier_stats"]


def test_prefix_coherence_and_fabric_equal(runs):
    ref, out = runs
    assert out["coherence"]["read_misses"] >= 1
    assert out["coherence"] == ref["coherence"]
    assert out["fabric_stats"] == ref["fabric_stats"]
    assert out["modeled_time"] == ref["modeled_time"]
