"""The port's continuous-batching engine against the JAX engine, token for
token in float32, on every scenario of test_serving.py, on xLSTM (the
recurrent caches), on Jamba (Mamba states, attention caches and MoE
capacity shared by the lanes) and on Granite-MoE (an MoE on every layer);
and the trimmed scheduler copies it admits
through."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.job import Job as JaxJob  # noqa: E402
from repro.core.resources import ResourceManager as JaxRM  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.core import Job, ResourceManager  # noqa: E402
from repro_torch.serving import ServeRequest, ServingEngine  # noqa: E402
from torch_parity import models  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    jm, jp, pm, pp = models("phi4_mini_3_8b", "float32")
    return jm, jp, pm, pp


@pytest.fixture(scope="module")
def xlstm_setup():
    return models("xlstm_1_3b", "float32")


@pytest.fixture(scope="module")
def jamba_setup():
    return models("jamba_v01_52b", "float32")


@pytest.fixture(scope="module")
def granite_setup():
    return models("granite_moe_1b_a400m", "float32")


def _greedy_ref(model, params, prompt, n_new, max_len, use_kernel=False):
    """Single-stream greedy decoding with the port's model."""
    last, caches = model.prefill(params, torch.tensor([prompt]),
                                 max_len=max_len, use_kernel=use_kernel)
    toks = [int(last[0].argmax())]
    for i in range(n_new - 1):
        lg, caches = model.decode_step(params, torch.tensor([[toks[-1]]]),
                                       caches, len(prompt) + i)
        toks.append(int(lg[0].argmax()))
    return toks


def _serve_both(setup, prompts, lanes, max_len, use_kernel=True, **req_kw):
    jm, jp, pm, pp = setup
    jreqs = [JaxRequest(prompt=list(p), **req_kw) for p in prompts]
    treqs = [ServeRequest(prompt=list(p), **req_kw) for p in prompts]
    jstats = JaxEngine(jm.cfg, jp, lanes=lanes, max_len=max_len).run(jreqs)
    tstats = ServingEngine(pm.cfg, pp, lanes=lanes, max_len=max_len,
                           use_kernel=use_kernel).run(treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.output == jr.output, (tr.prompt, tr.output, jr.output)
    for key in ("requests", "decode_steps", "decode_tokens",
                "tokens_per_dispatch"):
        assert tstats[key] == jstats[key], key
    return treqs, tstats


@pytest.mark.parametrize("use_kernel", [False, True])
def test_continuous_batching_matches_reference_and_single_stream(
        setup, use_kernel):
    _, _, pm, pp = setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, pm.cfg.vocab_size, 7).tolist()
               for _ in range(7)]
    reqs, _ = _serve_both(setup, prompts, lanes=3, max_len=48,
                          use_kernel=use_kernel, max_new_tokens=5)
    for r in reqs:
        assert r.output == _greedy_ref(pm, pp, r.prompt, 5, 48)


def test_lane_reuse_and_stats(setup):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 509, 4).tolist() for _ in range(6)]
    _, stats = _serve_both(setup, prompts, lanes=2, max_len=32,
                           max_new_tokens=3)
    assert stats["requests"] == 6
    assert stats["decode_tokens"] == 6 * 2  # 1 prefill + 2 decode tokens
    assert stats["decode_steps"] < 6 * 2
    assert stats["tokens_per_dispatch"] > 1.0


def test_mixed_prompt_lengths(setup):
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 509, n).tolist() for n in (3, 11, 5, 17, 2)]
    _serve_both(setup, prompts, lanes=3, max_len=40, max_new_tokens=6)


def test_eos_stops_early(setup):
    _, _, pm, pp = setup
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, pm.cfg.vocab_size, 6).tolist()
    ref = _greedy_ref(pm, pp, prompt, 8, 32)
    # an EOS value that does not occur earlier in the stream
    k = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
    reqs, _ = _serve_both(setup, [prompt], lanes=1, max_len=32,
                          max_new_tokens=8, eos_token=ref[k])
    assert reqs[0].output == ref[:k + 1]


def test_eos_at_prefill_emits_no_extra_token(setup):
    _, _, pm, pp = setup
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, pm.cfg.vocab_size, 6).tolist()
    ref = _greedy_ref(pm, pp, prompt, 1, 32)
    reqs, stats = _serve_both(setup, [prompt], lanes=1, max_len=32,
                              max_new_tokens=8, eos_token=ref[0])
    assert reqs[0].output == [ref[0]]
    assert stats["decode_steps"] == 0


def test_engine_releases_every_lane(setup):
    _, _, pm, pp = setup
    eng = ServingEngine(pm.cfg, pp, lanes=2, max_len=16)
    eng.run([ServeRequest(prompt=[1, 2, 3], max_new_tokens=2)
             for _ in range(3)])
    assert all(n.free_slots == 1 and not n.running
               for n in eng.rm.nodes.values())
    assert not eng.active_mask.any() and not eng._lane_jobs


@pytest.mark.parametrize("side", ["port", "reference"])
def test_lane_allocation_refuses_a_full_lane(side):
    rm, job = ((ResourceManager(), Job) if side == "port"
               else (JaxRM(), JaxJob))
    rm.add_nodes(2, slots=1)
    a = job.array(1, name="a").tasks[0]
    b = job.array(1, name="b").tasks[0]
    rm.allocate(a, 0)
    with pytest.raises(RuntimeError if side == "port" else AssertionError):
        rm.allocate(b, 0)
    rm.allocate(b, 1)
    assert [rm.nodes[i].free_slots for i in (0, 1)] == [0, 0]


@pytest.mark.parametrize("side", ["port", "reference"])
def test_double_release_is_a_no_op(side):
    rm, job = ((ResourceManager(), Job) if side == "port"
               else (JaxRM(), JaxJob))
    rm.add_nodes(1, slots=1)
    t = job.array(1, name="req").tasks[0]
    rm.allocate(t, 0)
    rm.release(t)
    rm.release(t)
    assert rm.nodes[0].free_slots == 1
    u = job.array(1, name="next").tasks[0]
    rm.allocate(u, 0)
    assert rm.nodes[0].free_slots == 0


def test_port_prefill_matches_reference_engine_prefill(setup):
    """The first token of each request is the reference's."""
    jm, jp, pm, pp = setup
    prompt = np.random.default_rng(8).integers(0, 509, 9)
    lj, _ = jm.prefill(jp, jnp.asarray(prompt)[None], max_len=16)
    lt, _ = pm.prefill(pp, torch.from_numpy(prompt)[None], max_len=16,
                       use_kernel=True)
    assert int(lt[0].argmax()) == int(jnp.argmax(lj[0]))


XLSTM_PROMPT_LENS = (3, 11, 1, 17, 5)


def test_xlstm_engine_matches_reference_engine(xlstm_setup):
    """use_kernel=False (the in-loop float32 sLSTM path, the only one the
    reference engine takes) token for token against the JAX engine, over
    ragged prompts (one of a single token: a recurrent-step prefill), lane
    reuse and every state leaf copied into its lane; and against
    single-stream greedy decoding."""
    _, _, pm, pp = xlstm_setup
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, pm.cfg.vocab_size, n).tolist()
               for n in XLSTM_PROMPT_LENS]
    reqs, _ = _serve_both(xlstm_setup, prompts, lanes=2, max_len=40,
                          use_kernel=False, max_new_tokens=5)
    for r in reqs:
        assert r.output == _greedy_ref(pm, pp, r.prompt, 5, 40)


def test_xlstm_kernel_path_matches_reference_prefill(xlstm_setup):
    """use_kernel=True (bf16 preactivations, the sLSTM scan's plain version
    on the CPU): each request's first token is the argmax of the JAX
    model.prefill(..., use_pallas=True), and the engine's tokens equal
    single-stream greedy decoding through the same path."""
    jm, jp, pm, pp = xlstm_setup
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, pm.cfg.vocab_size, n).tolist()
               for n in XLSTM_PROMPT_LENS]
    reqs = [ServeRequest(prompt=p, max_new_tokens=4) for p in prompts]
    stats = ServingEngine(pm.cfg, pp, lanes=2, max_len=32,
                          use_kernel=True).run(reqs)
    assert stats["slstm_scan_launches"] == 0   # CPU: the plain version
    for r in reqs:
        lj, _ = jm.prefill(jp, jnp.asarray(r.prompt)[None], max_len=32,
                           use_pallas=True)
        assert r.output[0] == int(jnp.argmax(lj[0]))
        assert r.output == _greedy_ref(pm, pp, r.prompt, 4, 32,
                                       use_kernel=True)


JAMBA_PROMPT_LENS = (5, 64, 1, 23, 40, 9)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_jamba_engine_matches_reference_engine(jamba_setup, use_kernel):
    """Jamba at the stock capacity factor, 4 lanes, ragged prompts of 1 to
    64 tokens: the port's engine equals the JAX engine token for token.
    Both batch the same lanes (idle lanes decode token 0), so the MoE
    layers of a decode step route the same tokens and drop the same slots;
    a prefill's group is its prompt. With use_kernel the Mamba prefills go
    through ops.ssm_scan (the plain version on the CPU) and attention
    through ops.flash_attention."""
    _, _, pm, _ = jamba_setup
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, pm.cfg.vocab_size, n).tolist()
               for n in JAMBA_PROMPT_LENS]
    _, stats = _serve_both(jamba_setup, prompts, lanes=4, max_len=80,
                           use_kernel=use_kernel, max_new_tokens=6)
    assert stats["ssm_scan_launches"] == 0     # CPU: the plain version
    assert stats["decode_steps"] > 0
    assert stats["expert_gemm_launches"] == 0  # CPU: the plain version


GRANITE_PROMPT_LENS = (7, 30, 1, 64, 12)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_granite_engine_matches_reference_engine(granite_setup, use_kernel):
    """Granite-MoE (top-4 of 8 experts on every layer of the smoke config)
    at the stock capacity factor, 3 lanes, ragged prompts: the port's
    engine equals the JAX engine token for token, with the prefill's expert
    products through ops.expert_gemm (its plain version on the CPU) or the
    einsums, and equals single-stream greedy decoding."""
    _, _, pm, pp = granite_setup
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, pm.cfg.vocab_size, n).tolist()
               for n in GRANITE_PROMPT_LENS]
    reqs, stats = _serve_both(granite_setup, prompts, lanes=3, max_len=80,
                              use_kernel=use_kernel, max_new_tokens=5)
    assert stats["expert_gemm_launches"] == 0  # CPU: the plain version
    assert stats["flash_attention_launches"] == 0
    for r in reqs:
        assert r.output == _greedy_ref(pm, pp, r.prompt, 5, 80,
                                       use_kernel=use_kernel)
