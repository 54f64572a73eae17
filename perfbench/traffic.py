"""The one traffic generator: reads a mix's parameters, draws from the seed.

Every seed gets the same sizes in the same order; the seed draws the
token ids. Lengths come in blocks of ``block`` requests: a block holds the
distribution's ``block`` evenly spaced quantiles (``(i + 0.5) / block``)
in an order drawn from the mix's own ``order_seed``, prompt and output
lengths shuffled independently. The order is the mix's, not the run's: in
a closed loop which requests share a step follows from the order alone,
and a step that admits several long prompts sets the tail, so an order
drawn from each run's seed moves ``ttft_p95_ms`` and ``itl_p95_ms`` by
10–15% from seed to seed with no change in the program. Token ids are
uniform over the vocabulary.

A length distribution is ``{"dist": "loguniform" | "uniform", "low": a,
"high": b}`` (whole numbers, both ends included) or ``{"dist": "fixed",
"value": n}``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

_MASK64 = (1 << 64) - 1


def seed_words(seed: int, *more: int) -> List[int]:
    """Entropy words for numpy's SeedSequence: any whole number, negative
    or above 64 bits included, maps to non-negative words."""
    return [int(seed) & _MASK64, (int(seed) >> 64) & _MASK64,
            *(int(m) & _MASK64 for m in more)]


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(seed_words(seed, *stream))


def quantile(dist: dict, u: float) -> int:
    """The ``u`` quantile (0 < u < 1) of a length distribution."""
    kind = dist["dist"]
    if kind == "fixed":
        return int(dist["value"])
    lo, hi = int(dist["low"]), int(dist["high"])
    if kind == "uniform":
        return min(hi, lo + int(math.floor(u * (hi - lo + 1))))
    if kind == "loguniform":
        # continuous log-uniform on [lo, hi + 1), floored: every whole
        # length in [lo, hi] is reachable
        return min(hi, int(math.floor(lo * ((hi + 1) / lo) ** u)))
    raise ValueError(f"unknown length distribution {kind!r}")


def block_lengths(dist: dict, block: int, order_seed: int, index: int,
                  stream: int) -> List[int]:
    """Block ``index`` of lengths: the ``block`` quantiles, shuffled."""
    values = [quantile(dist, (i + 0.5) / block) for i in range(block)]
    order = rng(order_seed, stream, index).permutation(block)
    return [values[i] for i in order]


@dataclass
class Request:
    index: int
    prompt: List[int]
    max_new_tokens: int


def requests(mix: dict, seed: int, vocab: int) -> Iterator[Request]:
    """The mix's requests in the order clients send them, without end:
    lengths in the mix's order, token ids from ``seed``."""
    block, order = int(mix["block"]), int(mix["order_seed"])
    b = 0
    while True:
        prompts = block_lengths(mix["prompt_tokens"], block, order, b, 1)
        outputs = block_lengths(mix["output_tokens"], block, order, b, 2)
        for i, (n_in, n_out) in enumerate(zip(prompts, outputs)):
            index = b * block + i
            ids = rng(seed, 3, index).integers(0, vocab, n_in)
            yield Request(index, ids.tolist(), int(n_out))
        b += 1


def longest_request(mix: dict, seed: int, vocab: int) -> Request:
    """A request at the mix's longest prompt and output."""
    n_in = quantile(mix["prompt_tokens"], 1 - 1e-12)
    n_out = quantile(mix["output_tokens"], 1 - 1e-12)
    ids = rng(seed, 4).integers(0, vocab, n_in)
    return Request(-1, ids.tolist(), n_out)


def train_batch(mix: dict, seed: int, step: int, vocab: int, device):
    """Step ``step``'s batch: ``batch`` rows of ``seq + 1`` uniform token
    ids made on ``device`` in one call from a generator seeded by (seed,
    step); tokens are the first ``seq``, labels the last ``seq``."""
    import torch

    words = seed_words(seed, 5, step)
    gen_seed = int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> 1)
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    B, S = int(mix["batch"]), int(mix["seq"])
    rows = torch.randint(0, vocab, (B, S + 1), generator=gen, device=device)
    return {"tokens": rows[:, :-1].to(torch.int32),
            "labels": rows[:, 1:].to(torch.int32)}
