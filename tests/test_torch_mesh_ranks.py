"""The sharded step on real values: gloo process groups of 2 and 4 ranks.

Each mesh's ranks run in processes of their own (``torch.multiprocessing``)
with the environment torchrun gives a rank (the group's store on a free
localhost port), so ``make_mesh`` sets up the gloo group as under
torchrun. They compare, for
phi4, Gemma (one kv head: repeated where the heads are split), Granite-MoE,
xLSTM and Jamba in float32:

- one train step on the mesh against the meshless step from the same
  state and batch: loss and grad_norm, every parameter and both moments;
- a prefill's last logits and a 3-step decode's logits on the mesh
  against the meshless builders'.

On meshes (2, 1), (1, 2) and (2, 2) the batch, the heads or head_dim, the
vocabulary, the experts, the SSM's inner width and AdamW's moments are
split for real, so DTensor's partial sums, the port's DTensor handlers
(``distributed/sharding.py``), the repeated kv heads' backward, the
gathered embedding lookup, the global norm's reduction and ZeRO-1's
copy-back all meet values. Sums split over ranks round otherwise than the
meshless ones (1.2e-6 measured at most, Jamba's grad_norm on (2, 2)), so
each tree is held at ``TOL`` of its largest element; a mislaid shard or a
wrong partial sum is off by the size of the values.

The trainer on a (2, 1) host mesh: the meshless run's losses, rank 0 alone
writes each checkpoint, and both ranks resume from it.
"""
import dataclasses
import json
import math
import os
import socket
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ARCHS = ("phi4_mini_3_8b", "gemma_2b", "granite_moe_1b_a400m", "xlstm_1_3b",
         "jamba_v01_52b")
MESHES = ((2, 1), (1, 2), (2, 2))
B, S = 4, 16
TOL = 1e-5


def _torchrun_env(rank, world, port):
    """The variables torchrun sets for a rank; one thread a rank."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _full(t):
    return t.full_tensor() if hasattr(t, "placements") else t


def _worst(want, got) -> float:
    """Largest |difference| over the leaves of two trees, over the largest
    |element| of ``want`` (every rank gathers ``got``'s shards)."""
    from repro_torch import tree as tree_lib

    a = [x.detach() for x in tree_lib.leaves(want)]
    b = [_full(y).detach() for y in tree_lib.leaves(got)]
    scale = max(float(x.abs().max()) for x in a)
    return max(float((x - y).abs().max()) for x, y in zip(a, b)) / scale


def _sharded(tree) -> int:
    from repro_torch import tree as tree_lib

    return sum(any(p.is_shard() for p in t.placements)
               for t in tree_lib.leaves(tree) if hasattr(t, "placements"))


def _steps_rank(rank, world, port, shape, out_dir):
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step,
                                          build_train_step, init_train_state)
    from repro_torch.models import build_model

    _torchrun_env(rank, world, port)
    mesh = mesh_lib.make_mesh(shape, ("data", "model"), "cpu")
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        run = RunConfig(model=cfg, seq_len=S, global_batch=B,
                        learning_rate=1e-4, warmup_steps=1, total_steps=10)
        plain = init_train_state(cfg, run, "cpu")
        meshed = tree_lib.map_tree(lambda t: t.detach().clone(), plain)
        batch = SyntheticTokens(cfg.vocab_size, S, B, seed=0).batch_at(0)
        plain, pm = build_train_step(cfg, run=run, device="cpu")(plain, batch)
        meshed, mm = build_train_step(cfg, run=run, device="cpu",
                                      mesh=mesh)(meshed, batch)
        rec = {k: abs(float(pm[k]) - float(mm[k])) / abs(float(pm[k]))
               for k in ("loss", "grad_norm")}
        rec["params"] = _worst(plain["params"], meshed["params"])
        rec["m"] = _worst(plain["opt"].m, meshed["opt"].m)
        rec["v"] = _worst(plain["opt"].v, meshed["opt"].v)
        rec["sharded_leaves"] = (_sharded(meshed["params"])
                                 + _sharded(meshed["opt"].m))

        params = build_model(cfg).init(1, device="cpu")
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
        V = cfg.vocab_size
        want, _ = build_prefill_step(cfg, device="cpu")(params,
                                                        {"tokens": toks})
        got, _ = build_prefill_step(
            cfg, device="cpu", mesh=mesh,
            shape=ShapeConfig("p", "prefill", S, B))(params, {"tokens": toks})
        rec["prefill"] = _worst(want[:, :V], _full(got)[:, :V])

        prompt = {"tokens": toks[:, :8]}
        token = torch.as_tensor(toks[:, 8:9])
        _, caches = build_prefill_step(cfg, device="cpu")(params, prompt)
        want, _ = build_decode_step(cfg, steps_per_dispatch=3)(
            params, token, caches, 8)
        _, caches = build_prefill_step(
            cfg, device="cpu", mesh=mesh,
            shape=ShapeConfig("p", "prefill", 8, B))(params, prompt)
        got, _ = build_decode_step(
            cfg, steps_per_dispatch=3, mesh=mesh,
            shape=ShapeConfig("d", "decode", S, B))(params, token, caches, 8)
        rec["decode"] = _worst(want[:, :V], _full(got)[:, :V])
        out[arch] = rec
    if rank == 0:
        (Path(out_dir) / "result.json").write_text(json.dumps(out))
    mesh_lib.destroy_group()


def _spawn(fn, world, *args):
    import torch.multiprocessing as mp

    mp.spawn(fn, args=(world, _free_port()) + args, nprocs=world)


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    done = {}

    def get(shape):
        if shape not in done:
            out = tmp_path_factory.mktemp("ranks")
            _spawn(_steps_rank, math.prod(shape), shape, str(out))
            done[shape] = json.loads((out / "result.json").read_text())
        return done[shape]

    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_steps_match_the_meshless_steps(shape, arch, mesh_results):
    rec = mesh_results(shape)[arch]
    assert rec["sharded_leaves"] > 0
    for key in ("loss", "grad_norm", "params", "m", "v", "prefill",
                "decode"):
        assert rec[key] <= TOL, (key, rec[key])


def _trainer_rank(rank, world, port, out_dir):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.train import train

    _torchrun_env(rank, world, port)
    saves = []
    save = CheckpointManager.save

    def counted(self, step, tree, extra=None):
        saves.append(step)
        return save(self, step, tree, extra)

    CheckpointManager.save = counted
    mesh = mesh_lib.make_host_mesh("cpu")
    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"),
                              dtype="float32")
    run = RunConfig(model=cfg, seq_len=S, global_batch=B)
    ckpt = str(Path(out_dir) / "ckpt")
    _, first = train(cfg, run, 2, device="cpu", ckpt_dir=ckpt, ckpt_every=1,
                     log_every=100, mesh=mesh)
    _, resumed = train(cfg, run, 3, device="cpu", ckpt_dir=ckpt,
                       log_every=100, mesh=mesh)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(
        {"losses": first + resumed, "saves": saves}))
    mesh_lib.destroy_group()


def test_trainer_on_two_ranks(tmp_path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.train import train

    _spawn(_trainer_rank, 2, str(tmp_path))
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    assert ranks[0]["saves"] == [1, 2, 2, 3] and ranks[1]["saves"] == []
    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"),
                              dtype="float32")
    _, want = train(cfg, RunConfig(model=cfg, seq_len=S, global_batch=B), 3,
                    device="cpu", log_every=100)
    for r in ranks:
        assert len(r["losses"]) == 3
        np.testing.assert_allclose(r["losses"], want, rtol=TOL)


def test_whole_state_check():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.train import check_whole_state_fits

    cfg = get_config("arctic_480b")
    with pytest.raises(RuntimeError, match="whole train state"):
        check_whole_state_fits(cfg, RunConfig(model=cfg), 80 * 10**9)
    cfg = get_config("gemma_2b")
    check_whole_state_fits(cfg, RunConfig(model=cfg), 80 * 10**9)
