"""The one generator every traffic mix is read by.

A mix file names its driver kind and that kind's parameters. Lengths are
given as ``{"log_uniform": [lo, hi]}`` with a number of ``shapes``: the mix's
requests take a fixed set of that many lengths, log-spaced from lo to hi,
both ends included. Where a mix has prompt and output lengths, the two sets
are paired by a fixed permutation, and the set is walked in a fixed order, a
fresh permutation for each pass over it. The seed draws the token ids (and,
in the drivers, the weights). So every seed gives the same sizes at the same
places in the schedule, and so the same work, on other inputs: a window that
covers part of a pass measures the same part on every seed.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

PAIRING_SEED = 0x5EED
ORDER_SEED = 0x0DE5


def lengths(spec: dict, n: int) -> List[int]:
    """`n` lengths log-spaced over ``spec["log_uniform"]``, ends included."""
    lo, hi = spec["log_uniform"]
    if n == 1:
        return [int(hi)]
    return [int(round(lo * (hi / lo) ** (i / (n - 1)))) for i in range(n)]


def shapes(mix: dict) -> List[Tuple[int, int]]:
    """The mix's fixed set of (prompt tokens, output tokens); output 0 for a
    mix with no outputs."""
    n = mix["shapes"]
    prompts = lengths(mix["prompt_tokens"], n)
    if "output_tokens" not in mix:
        return [(p, 0) for p in prompts]
    outputs = lengths(mix["output_tokens"], n)
    pair = np.random.default_rng(PAIRING_SEED).permutation(n)
    return [(prompts[i], outputs[pair[i]]) for i in range(n)]


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed))


def stream(mix: dict, seed: int, vocab: int) -> Iterator[Tuple[List[int], int]]:
    """Requests without end: (prompt token ids, output tokens), the set of
    shapes in the mix's fixed order, token ids drawn from `seed`."""
    gen, walk = rng(seed), rng(ORDER_SEED)
    table = shapes(mix)
    while True:
        for i in walk.permutation(len(table)):
            p, o = table[i]
            yield gen.integers(0, vocab, p).tolist(), o


def order(mix: dict) -> Iterator[int]:
    """Lengths without end for a mix of prompts alone, in the mix's fixed
    order (the driver draws the token ids from the seed, on the device)."""
    walk = rng(ORDER_SEED)
    table = [p for p, _ in shapes(mix)]
    while True:
        for i in walk.permutation(len(table)):
            yield table[i]
