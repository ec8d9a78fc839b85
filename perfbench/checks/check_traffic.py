"""The traffic generator: the same seed gives the same requests, another seed
other token ids over the same schedule of sizes."""

import itertools

import pytest

from perfbench.lib import files, traffic

MIXES = sorted({w["traffic"] for w in files.benchmark()["workloads"]})
SERVE = [m for m in MIXES if files.load_json("traffic", m)["kind"] == "serve_closed"]


def test_lengths_are_log_spaced_with_both_ends():
    got = traffic.lengths({"log_uniform": [32, 256]}, 4)
    assert got == [32, 64, 128, 256]
    assert traffic.lengths({"log_uniform": [512, 4096]}, 1) == [4096]


@pytest.mark.parametrize("mix", MIXES)
def test_each_mix_names_its_published_source(mix):
    m = files.load_json("traffic", mix)
    assert "arXiv" in m["source"] or "http" in m["source"], m["source"]


@pytest.mark.parametrize("mix", MIXES)
def test_each_pass_holds_the_whole_set(mix):
    m = files.load_json("traffic", mix)
    table = traffic.shapes(m)
    assert len(table) == m["shapes"]
    if m["kind"] == "serve_closed":
        got = [(len(p), o) for p, o in itertools.islice(traffic.stream(m, 3, 1000), 2 * len(table))]
    else:
        got = [(p, 0) for p in itertools.islice(traffic.order(m), 2 * len(table))]
    for half in (got[: len(table)], got[len(table):]):
        assert sorted(half) == sorted(table)
    assert got[: len(table)] != got[len(table):]


@pytest.mark.parametrize("mix", SERVE)
def test_stream_repeats_per_seed_and_differs_across_seeds(mix):
    m = files.load_json("traffic", mix)
    a = list(itertools.islice(traffic.stream(m, 2**31 + 7, 50304), 20))
    b = list(itertools.islice(traffic.stream(m, 2**31 + 7, 50304), 20))
    c = list(itertools.islice(traffic.stream(m, 2**31 + 8, 50304), 20))
    assert a == b
    assert [(len(p), o) for p, o in a] == [(len(p), o) for p, o in c]
    assert [p for p, _ in a] != [p for p, _ in c]
    assert all(0 <= t < 50304 for p, _ in a for t in p)


def test_prefill_tokens_repeat_per_seed_and_differ_across_seeds():
    import torch

    from perfbench.checks.tiny import tiny_cell
    from perfbench.drivers import prefill_stream

    def tokens(seed):
        cell = tiny_cell("dsc33b-prefill-code", seed=seed)
        gen = torch.Generator().manual_seed(seed ^ prefill_stream.TOKEN_STREAM)
        return torch.randint(0, cell.model["vocab_size"], (4, 1, 40), generator=gen)

    assert torch.equal(tokens(2**32 + 1), tokens(2**32 + 1))
    assert not torch.equal(tokens(2**32 + 1), tokens(2**32 + 2))
