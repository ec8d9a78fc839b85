"""The comparison that decides ``correct`` fails what it must.

* The control: the fp8 reference put in the program's place comes out not
  correct under each cell's limits, at a size the CPU holds (16 layers of
  128; on the card the cells' readings are in PERF.md).
* The faults: a whole run at the tiny size, the look for a card skipped, with
  the timed path broken underneath, comes out not correct, once for each
  fault the cell can have. Neither cell runs on more than one chip, so no
  exchange between chips can be left out; the prefill cell's batch is one
  prompt, so there is no half of it to leave out.
"""

import pytest
import torch

from perfbench.checks.tiny import tiny_cell
from perfbench.lib import files
from perfbench.lib.cell import Record
from perfbench.run import measure

CELLS = [w["name"] for w in files.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = tiny_cell(cell, seed=5, seconds=3.0, num_hidden_layers=16, hidden_size=128,
                  head_dim=32, intermediate_size=343)
    driver = files.load_module("drivers", c.traffic["kind"])
    rec = driver.run(c)
    assert rec.correct, [(k.name, k.value, k.limit) for k in rec.checks]
    control = Record(checks=driver.control(c, rec))
    assert {k.name for k in control.checks} == {k.name for k in rec.checks}
    assert not control.correct, [(k.name, k.value, k.limit) for k in control.checks]


def _state_unchanged(orig):
    """A decode step that writes no K/V: the pools come back as they were."""
    def step(params, cfg, k_pool, v_pool, *rest, **kw):
        logits, _, _ = orig(params, cfg, k_pool.clone(), v_pool.clone(), *rest, **kw)
        return logits, k_pool, v_pool
    return step


def _half_batch(orig):
    """Only the first half of the batch is stepped; the rest get its logits."""
    def step(params, cfg, k_pool, v_pool, tables, lengths, tokens, *rest, **kw):
        B = tables.shape[0]
        h = (B + 1) // 2
        logits, k_pool, v_pool = orig(params, cfg, k_pool, v_pool, tables[:h], lengths[:h],
                                      tokens[:h], *rest, **kw)
        return logits[torch.arange(B) % h], k_pool, v_pool
    return step


def _token_altered(orig):
    """Every second step, each row's token is another than its best logit's."""
    calls = [0]

    def step(*args, **kw):
        logits, k_pool, v_pool = orig(*args, **kw)
        calls[0] += 1
        if calls[0] % 2 == 0:
            rows = torch.arange(logits.shape[0])
            other = (logits.argmax(-1) + args[1].vocab_size // 2) % args[1].vocab_size
            logits = logits.clone()
            logits[rows, other] = logits.max(-1).values + 10.0
        return logits, k_pool, v_pool
    return step


def _caches_unchanged(orig):
    """A prefill whose collected caches are left as they were made: empty."""
    def forward(*args, **kw):
        logits, aux, caches = orig(*args, **kw)
        ks, vs = caches["kv"]
        return logits, aux, {"kv": (torch.zeros_like(ks), torch.zeros_like(vs))}
    return forward


def _answer_altered(orig):
    """A prefill whose next token is another than its best logit's."""
    def forward(*args, **kw):
        logits, aux, caches = orig(*args, **kw)
        logits = logits.clone()
        V = args[1].vocab_size
        other = (int(logits[0, -1, :V].argmax()) + V // 2) % V
        logits[0, -1, other] = logits[0, -1, :V].max() + 10.0
        return logits, aux, caches
    return forward


SERVE = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
         "token_altered": _token_altered}
PREFILL = {"state_unchanged": _caches_unchanged, "answer_altered": _answer_altered}
FAULTS = [(c, f) for c in CELLS
          for f in (SERVE if files.load_json("traffic", files.load_json(
              "workloads", c)["traffic"])["kind"] == "serve_closed" else PREFILL)]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault, monkeypatch):
    c = tiny_cell(cell, seed=9, seconds=1.0)
    if c.traffic["kind"] == "serve_closed":
        from repro_torch.serving import engine as mod
        name, make = "paged_decode_step", SERVE[fault]
    else:
        from repro_torch.models import transformer as mod
        name, make = "forward", PREFILL[fault]
    sound, _ = measure(tiny_cell(cell, seed=9, seconds=1.0), False)
    assert sound.correct
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    rec, _ = measure(c, False)
    assert not rec.correct, [(k.name, k.value, k.limit) for k in rec.checks]
