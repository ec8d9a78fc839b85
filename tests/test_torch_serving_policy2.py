"""Serving parity under Policy2 (tests/test_serving.py:151, one request per
batch): the port's engine on the CPU generates the reference's token ids and
reproduces its tier statistics and modeled times exactly.
"""

import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402


@pytest.fixture(scope="module")
def runs():
    cfg_r, params_r, cfg_t, params_t = tp.models()
    return (tp.policy_run(tp.REF, params_r, cfg_r, "Policy2"),
            tp.policy_run(tp.PORT, params_t, cfg_t, "Policy2"))


def test_engine_policy2_tokens_equal(runs):
    ref, out = runs
    assert all(len(v) == 5 for v in out["tokens"].values())
    assert out["tokens"] == ref["tokens"]


def test_engine_policy2_tier_stats_equal(runs):
    ref, out = runs
    assert out["tier_stats"]["remote_hits"] > 0
    assert out["tier_stats"] == ref["tier_stats"]
    assert out["modeled_time"] == ref["modeled_time"]


def test_engine_policy2_read_through_demotes_under_update(runs):
    """Policy2's read-through: each re-admission promotes the request's pages
    under ``engine.admit`` and each step gives them back under
    ``engine.update``; the profiled run serves the reference's tokens."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans

    ref, _ = runs
    _, _, cfg_t, params_t = tp.models()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = tp.policy_run(tp.PORT, params_t, cfg_t, "Policy2")
    assert out["tokens"] == ref["tokens"]
    assert out["tier_stats"] == ref["tier_stats"]
    recs = spans.records()
    by_id = {r["id"]: r for r in recs}
    causes = {(r["name"], by_id[r["parent"]]["name"]) for r in recs
              if r["name"].startswith("kv.")}
    assert ("kv.demote", "engine.update") in causes
    assert ("kv.promote", "engine.admit") in causes
    # each move counts its page's bytes on itself and on every span above it
    own = [r["attrs"]["kv_d2h_bytes" if r["name"] == "kv.demote" else "kv_h2d_bytes"]
           for r in recs if r["name"].startswith("kv.")]
    assert len(set(own)) == 1
    roots = [root for root, _ in spans.steps(recs, "engine.step")]
    assert sum(r["attrs"].get("kv_d2h_bytes", 0) + r["attrs"].get("kv_h2d_bytes", 0)
               for r in roots) == sum(own)
