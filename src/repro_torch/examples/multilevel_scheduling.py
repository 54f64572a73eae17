"""LLMapReduce example: a map-reduce analytics job (a histogram over seeded
shards) executed through the port's scheduler with multilevel aggregation:
real PyTorch payloads on the device, one DAG.

  PYTHONPATH=src python -m repro_torch.examples.multilevel_scheduling
  PYTHONPATH=src python -m repro_torch.examples.multilevel_scheduling \\
      --device cpu

The shards are the reference example's (``examples/multilevel_scheduling
.py``: numpy seed 0, 256 shards of 2,000 values in [0, 100)), copied to
the device once. Each mapper is ``torch.bincount`` of one shard; the
256 mappers run as ``SLOTS`` bundles (``mimo`` mode), each bundle one task
of ``TorchDispatchExecutor``, which waits for the device when a bundle
returns. The reducer sums the mappers' histograms on the device once every
bundle has completed (a DAG dependency). The result must equal numpy's
histogram of all shards. Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (FAMILIES, JobState, ResourceManager, Scheduler,
                              map_reduce)
from repro_torch.core.executor import TorchDispatchExecutor
from repro_torch.core.multilevel import MultilevelConfig

N_SHARDS = 256
SHARD_LEN = 2000
BINS = 100
SLOTS = 16


def make_shards():
    """The reference example's shards (numpy seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, BINS, size=SHARD_LEN) for _ in range(N_SHARDS)]


def make_payloads(shards, dev: torch.device):
    """(mapper payloads, the dict they write their histograms into)."""
    on_dev = [torch.from_numpy(s).to(dev) for s in shards]
    results = {}

    def mapper(i):
        def work():
            h = torch.bincount(on_dev[i], minlength=BINS)
            results[i] = h
            return h
        return work

    return [mapper(i) for i in range(N_SHARDS)], results


def run(device="cuda") -> dict:
    """Submit the bundled mappers and the reducer, run them to the end and
    check the histogram against numpy's; raises on any difference."""
    dev = resolve_device(device)
    shards = make_shards()
    expected = np.sum([np.bincount(s, minlength=BINS) for s in shards],
                      axis=0)
    payloads, results = make_payloads(shards, dev)
    rm = ResourceManager()
    rm.add_nodes(SLOTS, slots=1)
    executor = TorchDispatchExecutor()
    sched = Scheduler(rm, profile=FAMILIES["inproc"], executor=executor)
    final = {}

    def reducer():
        final["hist"] = torch.stack(
            [results[i] for i in range(N_SHARDS)]).sum(0)
        return final["hist"]

    jobs = map_reduce(
        n_tasks=N_SHARDS, task_duration=0.0, slots=SLOTS,
        payloads=payloads, reduce_payload=reducer, reduce_duration=0.0,
        cfg=MultilevelConfig(mode="mimo"))
    t0 = time.perf_counter()
    for j in jobs:
        sched.submit(j)
    sched.run()
    wall = time.perf_counter() - t0
    mappers, red = jobs
    if executor.errors:
        raise AssertionError(f"payloads raised: {executor.errors}")
    if not (mappers.state is red.state is JobState.COMPLETED):
        raise AssertionError(f"jobs ended {mappers.state}, {red.state}")
    hist = final["hist"]
    if hist.device.type != dev.type:
        raise AssertionError(f"histogram on {hist.device}, not {dev}")
    if not np.array_equal(hist.cpu().numpy(), expected):
        raise AssertionError("histogram differs from numpy's")
    if red.tasks[0].start_time < max(t.end_time for t in mappers.tasks):
        raise AssertionError("the reducer started before a mapper ended")
    return {"device": str(hist.device), "shards": N_SHARDS, "slots": SLOTS,
            "bundles": mappers.n_tasks, "completed": sched.completed,
            "total": int(hist.sum()), "wall_s": wall}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    print(f"map-reduce over {N_SHARDS} shards on {SLOTS} slots "
          f"({res['device']}): {res['bundles']} bundled mappers + 1 "
          f"reducer, {res['wall_s']:.3f}s wall")
    print(f"  histogram total = {res['total']} (verified against numpy)")
    print("  DAG dependency held: reducer ran after all mappers")
    return res


if __name__ == "__main__":
    main()
