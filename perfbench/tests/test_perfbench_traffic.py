"""Each mix is deterministic for a seed and draws the lengths it states;
every seed gets the same set of lengths in another order."""
import itertools
import math

import pytest
import torch

from perfbench import registry, traffic

LONGDOC = registry.mix("longdoc")
TRAIN = registry.mix("pretrain_s2048_b8")
SEEDS = [0, 7, 2 ** 31 + 5, 3 * 2 ** 40, -12]


def first(mix, seed, n, vocab=1000):
    return list(itertools.islice(traffic.requests(mix, seed, vocab), n))


def test_longdoc_states_the_issue_lengths():
    assert LONGDOC["driver"] == "serve" and LONGDOC["arrival"] == "closed"
    assert LONGDOC["clients"] == LONGDOC["lanes"] == 32
    assert LONGDOC["max_len"] == 8256
    assert LONGDOC["prompt_tokens"] == {"dist": "loguniform", "low": 1024,
                                        "high": 8192}
    assert LONGDOC["output_tokens"] == {"dist": "uniform", "low": 8,
                                        "high": 32}
    assert LONGDOC["max_len"] > 8192 + 32


@pytest.mark.parametrize("seed", SEEDS)
def test_requests_are_deterministic(seed):
    a, b = first(LONGDOC, seed, 70), first(LONGDOC, seed, 70)
    assert [(r.prompt, r.max_new_tokens) for r in a] == \
        [(r.prompt, r.max_new_tokens) for r in b]


def test_seeds_share_lengths_and_order_and_differ_in_tokens():
    block = LONGDOC["block"]
    runs = {s: first(LONGDOC, s, 2 * block) for s in SEEDS}
    lengths = {tuple((len(r.prompt), r.max_new_tokens) for r in reqs)
               for reqs in runs.values()}
    assert len(lengths) == 1
    toks = {tuple(runs[s][0].prompt[:8]) for s in SEEDS}
    assert len(toks) == len(SEEDS)
    # another order seed: the same lengths in each block, in another order
    other = first(dict(LONGDOC, order_seed=1), SEEDS[0], 2 * block)
    mine = runs[SEEDS[0]]
    for b in range(2):
        part = slice(b * block, (b + 1) * block)
        assert sorted(len(r.prompt) for r in other[part]) == \
            sorted(len(r.prompt) for r in mine[part])
    assert [len(r.prompt) for r in other] != [len(r.prompt) for r in mine]


def test_lengths_follow_their_distributions():
    block = LONGDOC["block"]
    reqs = first(LONGDOC, 3, block)
    prompts = sorted(len(r.prompt) for r in reqs)
    outs = sorted(r.max_new_tokens for r in reqs)
    assert 1024 <= prompts[0] and prompts[-1] <= 8192
    assert 8 <= outs[0] and outs[-1] <= 32
    # log-uniform: the median near the geometric mean of the ends; the
    # quantiles evenly spaced in log
    med = (prompts[block // 2 - 1] + prompts[block // 2]) / 2
    assert abs(math.log(med) - 0.5 * math.log(1024 * 8193)) < 0.05
    logs = [math.log(p) for p in prompts]
    steps = [b - a for a, b in zip(logs, logs[1:])]
    assert max(steps) - min(steps) < 0.01
    # uniform outputs: every length from 8 to 32, two or three times
    counts = {n: outs.count(n) for n in range(8, 33)}
    assert set(counts.values()) <= {2, 3}
    assert all(0 <= t < 1000 for r in reqs for t in r.prompt)


def test_quantiles_reach_both_ends():
    d = {"dist": "loguniform", "low": 1024, "high": 8192}
    assert traffic.quantile(d, 1e-12) == 1024
    assert traffic.quantile(d, 1 - 1e-12) == 8192
    u = {"dist": "uniform", "low": 8, "high": 32}
    assert traffic.quantile(u, 0.0) == 8 and traffic.quantile(u, 0.999) == 32
    assert traffic.quantile({"dist": "fixed", "value": 5}, 0.3) == 5
    w = traffic.longest_request(LONGDOC, 1, 100)
    assert len(w.prompt) == 8192 and w.max_new_tokens == 32


def test_train_mix_states_its_shape():
    assert TRAIN["driver"] == "train"
    assert (TRAIN["batch"], TRAIN["seq"]) == (8, 2048)
    assert TRAIN["learning_rate"] == 3e-4 and TRAIN["check_steps"] == 3


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_are_deterministic_and_rows_differ(seed):
    mix = dict(TRAIN, batch=4, seq=32)
    a = traffic.train_batch(mix, seed, 1, 97, "cpu")
    b = traffic.train_batch(mix, seed, 1, 97, "cpu")
    c = traffic.train_batch(mix, seed, 2, 97, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == a["labels"].shape == (4, 32)
    assert a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not torch.equal(a["tokens"], c["tokens"])
    rows = {tuple(r.tolist()) for r in a["tokens"]}
    assert len(rows) == 4
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 97
