"""Serving parity on an MoE model (tests/test_serving.py:82's preemption
scenario on reduced olmoe-1b-7b, both engines at their default
moe_impl="dense"): the port's engine on the CPU generates the reference's
token ids and reproduces its tier statistics and modeled times exactly.
"""

import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402


@pytest.fixture(scope="module")
def runs():
    cfg_r, params_r, cfg_t, params_t = tp.models("olmoe-1b-7b")
    assert cfg_t.moe and "moe" in params_t["stack"]
    return (tp.preemption_run(tp.REF, params_r, cfg_r),
            tp.preemption_run(tp.PORT, params_t, cfg_t))


def test_engine_moe_tokens_equal(runs):
    ref, out = runs
    assert all(len(v) == 6 for v in out["tokens"].values())
    assert out["tokens"] == ref["tokens"]


def test_engine_moe_tier_stats_equal(runs):
    ref, out = runs
    assert out["tier_stats"]["remote_hits"] > 0
    assert out["tier_stats"] == ref["tier_stats"]
    assert out["modeled_time"] == ref["modeled_time"]
