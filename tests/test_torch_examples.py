"""The port's example and measurement scripts against the reference's:
serve_batched (outputs equal the reference engine's, serial equals
batched), serving_replay (the trace bit for bit, the replay's counts at
lanes 4 and 16) and train_lm (run on the CPU with its asserts)."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402

import numpy as np  # noqa: E402

from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bench import serving_replay  # noqa: E402
from repro_torch.examples import serve_batched, train_lm  # noqa: E402
from torch_parity import models  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which are no
    faster on more threads, and the other test workers need the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_batched_matches_the_reference_engine():
    """The example's requests on the gemma smoke config (float32, the
    reference's weights): the port's 1-lane and 8-lane outputs equal each
    other and the reference engine's."""
    ref = _reference("examples/serve_batched.py", "ref_serve_batched")
    assert (ref.N_REQ, ref.PROMPT, ref.NEW) == (
        serve_batched.N_REQ, serve_batched.PROMPT, serve_batched.NEW)
    jm, jp, pm, pp = models("gemma_2b", "float32")
    vocab = pm.cfg.vocab_size
    rng = np.random.default_rng(0)   # the reference example's prompts
    prompts = [list(rng.integers(0, vocab, ref.PROMPT))
               for _ in range(ref.N_REQ)]
    assert serve_batched.make_prompts(vocab) == prompts
    res = serve_batched.compare(pm.cfg, pp)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=ref.NEW) for p in prompts]
    jstats = JaxEngine(jm.cfg, jp, lanes=8,
                       max_len=serve_batched.MAX_LEN).run(jreqs)
    assert res["outputs"] == [r.output for r in jreqs]
    for key in ("decode_steps", "decode_tokens", "tokens_per_dispatch"):
        assert res["batched"][key] == jstats[key], key
    assert res["serial"]["decode_steps"] == ref.N_REQ * (ref.NEW - 1)
    assert res["dispatch_reduction"] == 8.0


def test_serve_batched_main_on_the_cpu(capsys):
    res = serve_batched.main(["--device", "cpu"])
    assert len(res["outputs"]) == serve_batched.N_REQ
    assert all(len(o) == serve_batched.NEW for o in res["outputs"])
    assert "outputs identical" in capsys.readouterr().out


@pytest.mark.parametrize("n,vocab,seed", [(120, 509, 0), (1000, 200064, 0),
                                          (50, 7, 3)])
def test_serving_replay_trace_equals_the_reference(n, vocab, seed):
    ref = _reference("benchmarks/serving_replay.py", "ref_serving_replay")
    assert (ref.PROMPT_LEN, ref.MAX_LEN) == (serving_replay.PROMPT_LEN,
                                             serving_replay.MAX_LEN)
    assert serving_replay.build_trace(n, vocab, seed=seed) == \
        ref.build_trace(n, vocab, seed=seed)


def test_serving_replay_counts_equal_the_reference():
    """The quick replay (120 requests, lanes 4 and 16) on the phi4 smoke
    config with the reference's weights: the same requests, decode steps,
    decode tokens and tokens per dispatch as the reference's replay."""
    ref = _reference("benchmarks/serving_replay.py", "ref_serving_replay")
    jm, jp, pm, pp = models("phi4_mini_3_8b", "float32")
    trace = serving_replay.build_trace(120, pm.cfg.vocab_size)
    rows = []
    for lanes in (4, 16):
        got = serving_replay.replay(trace, pm.cfg, pp, lanes)
        want = ref.replay(trace, jm.cfg, jp, lanes)
        for key in ("lanes", "requests", "decode_steps", "decode_tokens",
                    "tokens_per_dispatch"):
            assert got[key] == want[key], (lanes, key)
        assert set(want) < set(got)
        assert not any(got["launches"].values())   # CPU: no kernel
        rows.append(got)
    assert serving_replay.smoke_invariant(rows)


def test_serving_replay_writes_only_to_out(tmp_path):
    committed = ROOT / "experiments" / "serving_replay_10k.json"
    before = committed.read_bytes() if committed.exists() else None
    out = tmp_path / "replay.json"
    rows = serving_replay.main(["--quick", "--device", "cpu",
                                "--out", str(out)])
    assert [r["lanes"] for r in rows] == [4, 16]
    assert json.loads(out.read_text())["rows"] == rows
    after = committed.read_bytes() if committed.exists() else None
    assert after == before


def test_train_lm_on_the_cpu():
    """The example as it stands: 200 steps, slice 1 failing at step 120;
    it raises unless the loss fell and one restore happened."""
    res = train_lm.main(["--device", "cpu"])
    report = res["report"]
    assert (report.failures, report.restores, report.final_step) == (
        1, 1, train_lm.STEPS)
    assert report.remeshes == [(100, 3)]
    assert report.steps_run == train_lm.STEPS + 20   # steps 100-119 again
    assert res["last"] < res["first"]
    assert int(res["state"]["opt"].step) == train_lm.STEPS
