"""Serving parity: layer functions, paged decode, the paged KV pool and the
preemption scenario, the port (on the CPU) against the reference.

Tolerances: layer functions agree to 1e-5 in fp32; decode logits to 1e-3 over
12 steps, as tests/test_serving.py:41 holds paged against dense decode.
Generated token ids, tier statistics and modeled times must be equal.
The preemption scenario also runs under the CPU profiler, where the port's
spans (``repro_torch.spans``) record each step's layers and tier moves.

The decode step's CUDA graphs (``paged_decode.DecodeGraphs``): on the CPU the
cache stays off and the step is the eager one bit for bit; on the card
(``cuda`` marker) an engine that replays them serves what the eager step
serves. JAX is imported only for the reference comparisons, so the card's
machine, which has no JAX, runs the ``cuda`` cases of this file.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the reference side; absent on the card's machine
    import jax
    import jax.numpy as jnp

    import _torch_parity as tp
    import repro.models.layers as r_layers
    import repro.models.transformer as r_tf
    import repro.serving.paged_decode as r_pd
except ImportError:
    jax = None

import repro_torch.configs as t_configs  # noqa: E402
import repro_torch.core.emucxl as t_emucxl  # noqa: E402
import repro_torch.core.policy as t_policy  # noqa: E402
import repro_torch.models.layers as t_layers  # noqa: E402
import repro_torch.models.transformer as t_tf  # noqa: E402
import repro_torch.serving.engine as t_engine  # noqa: E402
import repro_torch.serving.kv_manager as t_kv  # noqa: E402
import repro_torch.serving.paged_decode as t_pd  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as paged_mod  # noqa: E402


@pytest.fixture(scope="module")
def model():
    return tp.models()


@pytest.fixture(scope="module")
def preemption(model):
    cfg_r, params_r, cfg_t, params_t = model
    return (tp.preemption_run(tp.REF, params_r, cfg_r),
            tp.preemption_run(tp.PORT, params_t, cfg_t))


@pytest.fixture(scope="module")
def traced(model):
    """The port's preemption run under the CPU profiler: its result, the
    records, the profiler, and at each ``hot_tables`` call the pages the pool
    holds for the batch's sequences, beside every page it holds."""
    from torch.profiler import ProfilerActivity, profile

    walked = []
    orig = t_kv.PagedKVPool.hot_tables

    def hot_tables(self, seq_ids, max_pages):
        pages = _held_pages(self)
        walked.append((sum(1 for s in seq_ids for k in pages if k[0] == s), len(pages)))
        return orig(self, seq_ids, max_pages)

    spans.clear()
    t_kv.PagedKVPool.hot_tables = hot_tables
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = tp.preemption_run(tp.PORT, model[3], model[2])
    finally:
        t_kv.PagedKVPool.hot_tables = orig
    return out, spans.records(), prof, walked


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ layers
def test_rms_norm_matches():
    x, s = _np((3, 5, 64), 0), _np((64,), 1, 0.1)
    ref = r_layers.rms_norm(jnp.asarray(x), jnp.asarray(s))
    out = t_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_apply_rope_matches():
    x = _np((2, 3, 4, 32), 2)
    pos = np.array([[0, 7, 300], [5, 6, 100000]], np.int32)
    ref = r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    out = t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_gelu_glu_mlp_matches():
    p = {k: _np(s, i, 0.1) for i, (k, s) in
         enumerate([("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64))])}
    x = _np((2, 1, 64), 9)
    ref = r_layers.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), "gelu_glu")
    out = t_layers.mlp({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                       "gelu_glu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_bf16_embedding_scale_rounds_like_the_reference(model):
    """sqrt(1152) = 33.94 rounds to 34.0 in bf16 before the multiply."""
    cfg_r = dataclasses.replace(model[0], d_model=1152, dtype="bfloat16",
                                param_dtype="bfloat16")
    cfg_t = dataclasses.replace(model[2], d_model=1152, dtype="bfloat16",
                                param_dtype="bfloat16")
    params_r = r_tf.init_params(jax.random.PRNGKey(1), cfg_r)
    params_t = from_reference(jax.tree.map(np.asarray, params_r), cfg_t, device="cpu")
    toks = np.array([[3], [400]], np.int32)
    ref = r_tf.embed_inputs(params_r, cfg_r, jnp.asarray(toks))
    out = t_tf.embed_inputs(params_t, cfg_t, torch.from_numpy(toks))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
    ref_logits = r_tf.unembed(params_r, cfg_r, ref)
    out_logits = t_tf.unembed(params_t, cfg_t, out)
    np.testing.assert_allclose(out_logits.numpy(), np.asarray(ref_logits), atol=2e-2, rtol=2e-2)


# ------------------------------------------------------------------ paged decode
def test_paged_decode_matches_reference(model):
    cfg_r, params_r, cfg_t, params_t = model
    B, page, maxp = 2, 8, 4
    shape = (cfg_r.num_layers, 16, page, cfg_r.num_kv_heads, cfg_r.resolved_head_dim)
    k_r = v_r = jnp.zeros(shape, jnp.float32)
    k_t, v_t = torch.zeros(shape), torch.zeros(shape)
    table = np.stack([np.arange(maxp), np.arange(maxp) + maxp]).astype(np.int32)
    toks = np.random.default_rng(0).integers(0, cfg_r.vocab_size, (B, 12)).astype(np.int32)
    for t in range(12):
        tok = toks[:, t : t + 1]
        lengths = np.full((B,), t, np.int32)
        ref, k_r, v_r = r_pd.paged_decode_step(params_r, cfg_r, k_r, v_r, jnp.asarray(table),
                                               jnp.asarray(lengths), jnp.asarray(tok))
        out, k_t, v_t = t_pd.paged_decode_step(params_t, cfg_t, k_t, v_t,
                                               torch.from_numpy(table),
                                               torch.from_numpy(lengths), torch.from_numpy(tok))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_r), atol=1e-4)


# ------------------------------------------------------------------ decode graphs
def _port_model(arch, device):
    """A reduced `arch` drawn by the port itself (no reference needed)."""
    cfg = t_configs.get_config(arch).reduced()
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, t_tf.init_params(gen, cfg, device=device)


def _record_decodes(monkeypatch, eager):
    """Wrap the engine's decode call as the benchmark's traced runs do
    (reading ``args[5]``); each call's lengths, batch width, keywords and a copy of its
    logits. `eager` drops ``graphs=``, so the step is ``_decode_body``'s."""
    calls = []
    decode = t_engine.paged_decode_step

    def wrapper(*args, **kw):
        seen = dict(kw)
        if eager:
            kw.pop("graphs")
        logits, k_pool, v_pool = decode(*args, **kw)
        calls.append({"lengths": args[5].tolist(), "width": args[6].shape[0], "kw": seen,
                      "logits": logits.clone()})
        return logits, k_pool, v_pool

    monkeypatch.setattr(t_engine, "paged_decode_step", wrapper)
    return calls


def _serve(monkeypatch, arch, device, *, eager=False, policy="Policy1", max_batch=2,
           slots=4, prompts=((5, 6),) * 3, params=None):
    """tests/test_serving.py's engine scenario on `device`: page 8, 2 pages a
    sequence, requests of (prompt length, new tokens) drawn from seed 5,
    recorded with spans on. Returns the engine, its tokens and decode calls,
    and the records."""
    cfg, drawn = _port_model(arch, device)
    lib = t_emucxl.EmuCXL()
    lib.init(local_capacity=1 << 26, remote_capacity=1 << 28, device=device)
    eng = t_engine.ServingEngine(params or drawn, cfg, num_slots=slots, page_size=8,
                                 max_batch=max_batch, max_pages_per_seq=2,
                                 policy=getattr(t_policy, policy)(), device=device)
    eng.pool.lib = lib
    eng.pool.slab.lib = lib
    rng = np.random.default_rng(5)
    for n, new in prompts:
        eng.submit(list(rng.integers(0, cfg.vocab_size, n)), max_new_tokens=new)
    calls = _record_decodes(monkeypatch, eager)
    spans.clear()
    spans.enable()
    try:
        tokens = eng.run(max_steps=200)
    finally:
        spans.disable()
        monkeypatch.undo()
    stats = eng.tier_stats()
    lib.exit()
    return SimpleNamespace(eng=eng, tokens=tokens, stats=stats, calls=calls,
                           records=spans.records())


def _graph_counts(records, name):
    """graph_captures and graph_replays summed over the spans named `name`."""
    return [sum(r["attrs"].get(k, 0) for r in records if r["name"] == name)
            for k in ("graph_captures", "graph_replays")]


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b"])
def test_decode_graphs_stay_off_for_cpu_pools(arch):
    """CPU pools: the cache never captures or replays, counts nothing on the
    spans, and the step's logits and pools are bitwise the eager step's; for
    olmoe with its dense MoE, as the engine serves it."""
    cfg, params = _port_model(arch, "cpu")
    opts = t_tf.ModelOptions(moe_impl="dense")
    B, page, maxp = 2, 8, 4
    shape = (cfg.num_layers, 2 * B * maxp, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    pools = {name: (torch.zeros(shape), torch.zeros(shape)) for name in ("graphs", "eager")}
    table = torch.arange(B * maxp, dtype=torch.int32).reshape(B, maxp)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 12))
                            .astype(np.int32))
    cache = t_pd.DecodeGraphs()
    spans.clear()
    spans.enable()
    try:
        for t in range(12):
            lengths = torch.full((B,), t, dtype=torch.int32)
            out = {name: t_pd.paged_decode_step(params, cfg, *pools[name], table, lengths,
                                                toks[:, t:t + 1], opts,
                                                graphs=cache if name == "graphs" else None)[0]
                   for name in pools}
            assert torch.equal(out["graphs"], out["eager"])
    finally:
        spans.disable()
    assert all(torch.equal(a, b) for a, b in zip(pools["graphs"], pools["eager"]))
    assert (cache.captures, cache.replays) == (0, 0)
    recs = spans.records()
    assert sum(r["name"] == "decode.dispatch" for r in recs) == 24
    assert _graph_counts(recs, "decode.dispatch") == [0, 0]


def test_a_wrapper_of_the_engines_decode_call_reads_its_arguments(monkeypatch):
    """The benchmark's traced runs and chip_smoke wrap the module-level
    ``paged_decode_step`` and read the lengths as ``args[5]``: the engine
    still passes them there, and its graph cache by keyword. On the CPU the
    engine's cache stays off."""
    run = _serve(monkeypatch, "gemma3-1b", "cpu", max_batch=2, slots=8,
                 prompts=((3, 4), (3, 4)))
    assert [c["lengths"] for c in run.calls] == [[t, t] for t in range(6)]
    assert all(c["kw"] == {"graphs": run.eng.graphs} for c in run.calls)
    assert (run.eng.graphs.captures, run.eng.graphs.replays) == (0, 0)
    assert all(len(v) == 4 for v in run.tokens.values())


GRAPH_RUNS = {  # the scenario, and the widths' count it must capture
    # olmoe's MoE stack, dense as the engine serves it; two widths
    "widths": (dict(arch="olmoe-1b-7b", max_batch=2, slots=8, prompts=((5, 3), (5, 9))), 2),
    # a sliding window (8) in layer 0; preemptions, demotes and promotes between replays
    "eviction": (dict(arch="gemma3-1b", max_batch=2, slots=4, prompts=((5, 6),) * 3), 2),
    # Policy2's read-through: every page promoted for one step and demoted after it
    "policy2": (dict(arch="gemma3-1b", policy="Policy2", max_batch=1, slots=4,
                     prompts=((5, 5),) * 3), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", sorted(GRAPH_RUNS))
def test_engine_graph_replays_serve_the_eager_steps(scenario, monkeypatch):
    """On the card, the same engine run with the decode graphs and through
    ``_decode_body`` alone: equal token ids and tier statistics, logits equal
    within 1e-5 of each step's largest with the same argmax; one capture a
    width, a replay every other step, counted on ``decode.dispatch`` and up to
    ``engine.step``; the paged kernel launched from the host only to warm up
    and capture (its replays run inside the graph)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw, widths = GRAPH_RUNS[scenario]
    before = paged_mod.launches
    graphs = _serve(monkeypatch, device="cuda", **kw)
    launched = paged_mod.launches - before
    eager = _serve(monkeypatch, device="cuda", eager=True, params=graphs.eng.params, **kw)
    assert graphs.tokens == eager.tokens
    assert graphs.stats == eager.stats
    if scenario != "widths":
        assert graphs.stats["preemptions"] > 0 and graphs.stats["remote_hits"] > 0
    assert [c["lengths"] for c in graphs.calls] == [c["lengths"] for c in eager.calls]
    for a, b in zip(graphs.calls, eager.calls, strict=True):
        gap = (a["logits"] - b["logits"]).abs().max().item()
        assert gap <= 1e-5 * b["logits"].abs().max().item()
        assert torch.equal(a["logits"].argmax(-1), b["logits"].argmax(-1))
    cache, steps = graphs.eng.graphs, len(graphs.calls)
    assert len({c["width"] for c in graphs.calls}) == widths
    assert (cache.captures, cache.replays) == (widths, steps - widths)
    for name in ("decode.dispatch", "engine.step"):
        assert _graph_counts(graphs.records, name) == [widths, steps - widths]
    assert _graph_counts(eager.records, "decode.dispatch") == [0, 0]
    cfg = graphs.eng.cfg
    assert launched == 2 * widths * cfg.num_layers


@pytest.mark.cuda
def test_decode_graphs_capture_anew_for_other_pools():
    """On the card a graph reads the pools in place: a step whose pools lie
    at other addresses captures its width's graph again, in place of the old
    one, and its replays serve those pools as the eager step does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, params = _port_model("gemma3-1b", "cuda")
    B, page, maxp, steps = 2, 8, 4, 4
    shape = (cfg.num_layers, B * maxp, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    table = torch.arange(B * maxp, dtype=torch.int32, device="cuda").reshape(B, maxp)
    toks = torch.randint(0, cfg.vocab_size, (B, steps), dtype=torch.int32, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(3))

    def run(graphs):
        pools = [torch.zeros(shape, device="cuda") for _ in range(2)]
        logits = [t_pd.paged_decode_step(params, cfg, *pools, table,
                                         torch.full((B,), t, dtype=torch.int32, device="cuda"),
                                         toks[:, t:t + 1], graphs=graphs)[0].clone()
                  for t in range(steps)]
        return logits, pools

    cache = t_pd.DecodeGraphs()
    first = run(cache)
    assert (cache.captures, cache.replays) == (1, steps - 1)
    second = run(cache)       # the first pools still held: the second lie elsewhere
    assert (cache.captures, cache.replays) == (2, 2 * (steps - 1))
    assert len(cache._graphs) == 1
    eager = run(None)
    for got in (first, second):
        for a, b in zip(got[0], eager[0], strict=True):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
            assert torch.equal(a.argmax(-1), b.argmax(-1))
        for a, b in zip(got[1], eager[1], strict=True):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


# ------------------------------------------------------------------ paged KV pool
def _held_pages(pool):
    """The pool's held pages, (sequence, page) -> ``PageRef``, in key order:
    the reference keeps them in one map, the port in one map a sequence."""
    if isinstance(pool, t_kv.PagedKVPool):
        return {(s, p): ref for s, seq in sorted(pool._seqs.items())
                for p, ref in sorted(seq.refs.items())}
    return dict(sorted(pool._refs.items()))


def _pool_program(P, scenario):
    lib = P.ecxl.EmuCXL()
    lib.init(local_capacity=1 << 24, remote_capacity=1 << 26, **P.lib_kw)
    obs = []
    if scenario == "roundtrip":
        pool = P.kv.PagedKVPool(2, 4, 8, 2, 16, lib=lib, **P.dev_kw)
        pool.alloc_page(0, 0)
        payload = np.random.default_rng(0).standard_normal((2, 8, 2, 16)).astype(np.float32)
        pool.write_token(0, (P.asarray(payload[:, 3]), P.asarray(payload[:, 3] * 2)), 3)
        pool.demote(0, 0)
        obs += [pool.residency(0), lib.stats(1)]
        pool.promote(0, 0)
        slot = int(pool.hot_table(0, 1)[0])
        obs += [pool.residency(0), np.asarray(pool.k_pool[:, slot, 3]),
                np.asarray(pool.v_pool[:, slot, 3])]
    elif scenario == "policy2":
        pool = P.kv.PagedKVPool(1, 4, 8, 2, 16, lib=lib, policy=P.policy.Policy2(),
                                **P.dev_kw)
        pool.alloc_page(0, 0)
        pool.demote(0, 0)
        obs += [pool.touch(0, 0) for _ in range(3)]
        obs += [pool.stats.remote_hits, pool.residency(0)]
    elif scenario == "eviction":  # under promote pressure: 2 hot slots
        pool = P.kv.PagedKVPool(1, 2, 8, 2, 16, lib=lib, **P.dev_kw)
        pool.alloc_page(0, 0)
        pool.alloc_page(1, 0)
        pool.demote(0, 0)
        pool.alloc_page(2, 0)
        pool.promote(0, 0)
        obs += [pool.residency(s) for s in (0, 1, 2)]
    elif scenario == "interleave":
        # a seeded mix of every mutating call over 4 sequences of up to 6
        # pages and 4 hot slots, so promotes evict; tables of 2 pages cut the
        # longer sequences. After each call, every sequence's table and
        # residency.
        pool = P.kv.PagedKVPool(1, 4, 4, 2, 8, lib=lib, policy=P.policy.Policy1(),
                                **P.dev_kw)
        rng = np.random.default_rng(26)
        for _ in range(240):
            op = INTERLEAVED[int(rng.integers(len(INTERLEAVED)))]
            s, p = int(rng.integers(4)), int(rng.integers(6))
            held = _held_pages(pool)
            cold = [k for k, ref in held.items() if ref.cold_ptr is not None]
            if op in ("demote", "free_page", "write_token") and held:
                s, p = list(held)[int(rng.integers(len(held)))]
            elif op == "promote" and cold:
                s, p = cold[int(rng.integers(len(cold)))]
            ref = held.get((s, p))
            if op == "alloc_page" and ref is None and pool.free_slots():
                pool.alloc_page(s, p)
            elif op == "demote" and ref is not None:
                pool.demote(s, p)
            elif op == "promote" and ref is not None and ref.cold_ptr is not None:
                obs.append(("free_slots", pool.free_slots()))
                pool.promote(s, p)
            elif op == "touch":
                obs.append(pool.touch(s, p))
            elif op == "free_page" and ref is not None:
                pool.free_page(s, p)
            elif op == "free_sequence":
                pool.free_sequence(s)
            elif op == "write_token" and ref is not None:
                obs.append(("cold", ref.hot_slot is None))
                kv = rng.standard_normal((2, 1, 2, 8)).astype(np.float32)
                pool.write_token(s, (P.asarray(kv[0]), P.asarray(kv[1])),
                                 p * 4 + int(rng.integers(4)))
            else:
                continue
            obs.append((op, s, p))
            obs += [pool.hot_table(q, 2) for q in range(4)]
            obs += [pool.residency(q) for q in range(4)]
        obs += [np.asarray(pool.k_pool), np.asarray(pool.v_pool)]
    obs += [pool.stats.local_hits, pool.stats.remote_hits, lib.stats(0), lib.stats(1),
            dict(lib.modeled_time)]
    lib.exit()
    return obs


INTERLEAVED = ["alloc_page"] * 4 + ["demote", "promote", "touch", "write_token"] * 2 + [
    "free_page", "free_sequence"]


@pytest.mark.parametrize("scenario", ["roundtrip", "policy2", "eviction", "interleave"])
def test_paged_kv_pool_matches(scenario):
    ref, out = _pool_program(tp.REF, scenario), _pool_program(tp.PORT, scenario)
    assert len(ref) == len(out)
    for r, o in zip(ref, out, strict=True):
        if isinstance(r, np.ndarray):
            assert o.dtype == r.dtype
            np.testing.assert_array_equal(o, r)
        else:
            assert o == r
    if scenario == "interleave":
        marks = [o for o in out if isinstance(o, tuple) and isinstance(o[0], str)]
        assert {o[0] for o in marks if o[0] in INTERLEAVED} == set(INTERLEAVED)
        assert ("free_slots", 0) in marks and ("cold", True) in marks   # evicting promotes
        assert any(o.any() for o in out if isinstance(o, np.ndarray) and o.shape == (2,))
        assert max(sum(o) for o in out if isinstance(o, tuple) and isinstance(o[0], int)) > 2


@pytest.mark.parametrize("run", ["preemption", "policy2"])
def test_page_index_follows_the_refs(model, monkeypatch, run):
    """After every step of the port's preemption run (allocations, demotes,
    promotes, releases) and of its Policy2 run (read-through requests demoted
    after each step), each held sequence's block-table row is its own pages'
    hot slots, 0 where cold; no sequence without a page keeps an entry; and
    the engine's unfinished requests are those of ``requests`` not finished,
    in rid order. After ``free_sequence`` of every request nothing is held."""
    engines = []
    step = t_engine.ServingEngine.step

    def checked_step(self):
        step(self)
        engines[:] = [self]
        for s, seq in self.pool._seqs.items():
            assert seq.refs
            assert all(r.seq_id == s and r.layer_page == p for p, r in seq.refs.items())
            row = np.zeros_like(seq.slots)
            for p, ref in seq.refs.items():
                row[p] = ref.hot_slot or 0
            np.testing.assert_array_equal(seq.slots, row)
        live = [r for r in self.requests.values() if r.state != "finished"]
        assert list(self._live.values()) == live
        assert list(self._live) == sorted(self._live)

    monkeypatch.setattr(t_engine.ServingEngine, "step", checked_step)
    if run == "preemption":
        out = tp.preemption_run(tp.PORT, model[3], model[2])
        assert out["tier_stats"]["preemptions"] > 0
    else:
        out = tp.policy_run(tp.PORT, model[3], model[2], "Policy2")
        assert out["tier_stats"]["remote_hits"] > 0
    (eng,) = engines
    assert eng._live == {}
    for rid in eng.requests:
        eng.pool.free_sequence(rid)
    assert eng.pool._seqs == {}


def test_pool_refuses_a_negative_page_index():
    pool = t_kv.PagedKVPool(1, 2, 4, 1, 8, device="cpu")
    with pytest.raises(t_kv.ecxl.EmuCXLError):
        pool.alloc_page(0, -1)
    assert pool.free_slots() == 2 and pool._seqs == {}


# ------------------------------------------------------------------ engine
def test_engine_preemption_tokens_equal(preemption):
    ref, out = preemption
    assert all(len(v) == 6 for v in out["tokens"].values())
    assert out["tokens"] == ref["tokens"]


def test_engine_preemption_tier_stats_equal(preemption):
    ref, out = preemption
    assert out["tier_stats"]["preemptions"] > 0
    assert out["tier_stats"] == ref["tier_stats"]
    assert out["modeled_time"] == ref["modeled_time"]


# ------------------------------------------------------------------ spans
STEP_LAYERS = ["engine.admit", "engine.tables", "engine.touch", "decode.dispatch",
               "engine.sample", "engine.update"]


def test_engine_spans_follow_the_steps(preemption, traced):
    ref, _ = preemption
    out, recs, _, _ = traced
    assert out["tokens"] == ref["tokens"]
    assert out["tier_stats"] == ref["tier_stats"]
    steps = spans.steps(recs, "engine.step")
    assert len(recs) == len(steps) + sum(len(kids) for _, kids in steps)
    assert [root["step"] for root, _ in steps] == sorted({r["step"] for r in recs})
    for root, kids in steps:
        assert root["attrs"]["batch"] > 0
        children = sorted((k for k in kids if k["parent"] == root["id"]),
                          key=lambda k: k["start_ns"])
        assert [k["name"] for k in children] == STEP_LAYERS
        for a, b in zip(children, children[1:]):
            assert root["start_ns"] <= a["start_ns"] < a["end_ns"] <= b["start_ns"]
        assert children[-1]["end_ns"] <= root["end_ns"]
    assert sum(root["attrs"]["tokens"] for root, _ in steps) == sum(
        len(t) for t in out["tokens"].values())


def test_tier_moves_sit_under_the_span_that_caused_them(model, traced):
    cfg = model[2]
    _, recs, _, _ = traced
    page_bytes = 2 * cfg.num_layers * 8 * cfg.num_kv_heads * cfg.resolved_head_dim * 4
    by_id = {r["id"]: r for r in recs}
    moves = [r for r in recs if r["name"] in ("kv.demote", "kv.promote")]
    assert {r["name"] for r in moves} == {"kv.demote", "kv.promote"}
    for r in moves:
        own = "kv_d2h_bytes" if r["name"] == "kv.demote" else "kv_h2d_bytes"
        assert r["attrs"][own] == page_bytes
        cause = by_id[r["parent"]]
        while cause["name"].startswith("kv."):       # a promote's eviction
            cause = by_id[cause["parent"]]
        # eviction and re-admission (Policy1 promotes on the touch) both admit
        assert (cause["name"], cause["step"]) == ("engine.admit", r["step"])
    for root, kids in spans.steps(recs, "engine.step"):
        demoted = sum(k["name"] == "kv.demote" for k in kids)
        promoted = sum(k["name"] == "kv.promote" for k in kids)
        assert root["attrs"].get("kv_d2h_bytes", 0) == page_bytes * demoted
        assert root["attrs"].get("kv_h2d_bytes", 0) == page_bytes * promoted


def test_table_entries_count_the_walk(traced):
    """``entries`` on a step's ``engine.tables`` is the pages the pool holds
    for the batch's sequences, counted once a table: at most every held page."""
    _, recs, _, walked = traced
    calls = iter(walked)
    for root, kids in spans.steps(recs, "engine.step"):
        (tables,) = [k for k in kids if k["name"] == "engine.tables"]
        held, every = next(calls)
        assert tables["attrs"]["entries"] == held <= every
        assert held >= root["attrs"]["batch"]
    assert next(calls, None) is None


def test_spans_share_the_profilers_clock(model, traced):
    """Each profiler event, on the trace's clock, lies inside the span that
    issued it: argmax in its step's ``engine.sample``, the projections (the
    same einsums each step) in its step's ``decode.dispatch``, and every aten
    op after the engine's construction inside a step. Times in microseconds
    after the trace's start, the unit of the events' ``time_range``."""
    _, recs, prof, _ = traced
    names = {r["name"] for r in recs}
    assert not any(e.name in names for e in prof.events())      # no annotation
    start = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events() if e.name.startswith("aten::"))

    def spans_named(name):
        return [((r["start_ns"] - start) / 1e3, (r["end_ns"] - start) / 1e3)
                for r in sorted(recs, key=lambda r: r["start_ns"]) if r["name"] == name]

    def within(ev, sp):
        return sp[0] <= ev[0] and ev[1] <= sp[1]

    L = model[2].num_layers
    dispatch, sample = spans_named("decode.dispatch"), spans_named("engine.sample")
    einsums = [e for e in events if e[2] == "aten::einsum"]
    argmaxes = [e for e in events if e[2] == "aten::argmax"]
    per = len(einsums) // len(dispatch)
    assert per >= L and per * len(dispatch) == len(einsums) and len(argmaxes) == len(sample)
    assert all(within(e, dispatch[i // per]) for i, e in enumerate(einsums))
    assert all(within(e, sample[i]) for i, e in enumerate(argmaxes))
    for name in ("engine.tables", "engine.touch"):
        assert not any(within(e, sp) for e in einsums for sp in spans_named(name))
    steps = spans_named("engine.step")
    outside = [e for e in events if not any(within(e, sp) for sp in steps)]
    assert all(e[1] <= steps[0][0] for e in outside)


def test_spans_record_nothing_outside_a_profiler(model, traced):
    spans.clear()
    out = tp.preemption_run(tp.PORT, model[3], model[2])
    assert spans.records() == []
    assert out["tokens"] == traced[0]["tokens"]


def test_span_ring_drops_beyond_its_bound():
    rec = spans.Recorder(capacity=4)
    with rec.span("off") as s:
        s.set(a=1)
        rec.count("k")
    assert rec.records() == []
    rec.enable()
    try:
        with rec.span("root"):
            with rec.span("child"):
                rec.count("k", 3)
        for i in range(4):
            with rec.span("s", i=i):
                rec.count("k", 2)
    finally:
        rec.disable()
    kept = rec.records()
    assert [r["attrs"].get("i") for r in kept] == [0, 1, 2, 3]
    assert rec.dropped == 2 and [r["attrs"]["k"] for r in kept] == [2] * 4
    assert len({r["step"] for r in kept}) == 4 and all(r["parent"] is None for r in kept)
    rec.clear()
    assert rec.records() == [] and rec.dropped == 0
    with rec.span("off"):
        pass
    assert rec.records() == []
