"""Serving parity under Policy1 (tests/test_serving.py:151, one request per
batch): the port's engine on the CPU generates the reference's token ids and
reproduces its tier statistics and modeled times exactly.
"""

import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402


@pytest.fixture(scope="module")
def runs():
    cfg_r, params_r, cfg_t, params_t = tp.models()
    return (tp.policy_run(tp.REF, params_r, cfg_r, "Policy1"),
            tp.policy_run(tp.PORT, params_t, cfg_t, "Policy1"))


def test_engine_policy1_tokens_equal(runs):
    ref, out = runs
    assert all(len(v) == 5 for v in out["tokens"].values())
    assert out["tokens"] == ref["tokens"]


def test_engine_policy1_tier_stats_equal(runs):
    ref, out = runs
    assert out["tier_stats"]["remote_hits"] > 0
    assert out["tier_stats"] == ref["tier_stats"]
    assert out["modeled_time"] == ref["modeled_time"]
