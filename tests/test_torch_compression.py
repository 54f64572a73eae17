"""The port's gradient compression against the reference's, bit for bit:
int8 with error feedback over trees that mix compressible float32 and
bf16 leaves with small passthrough leaves, across 20 rounds; top-k with
ties at the threshold and with k cut to 1; and the reference's two
property tests (error feedback keeps the running sum, top-k keeps its
share)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import compression as ref  # noqa: E402
from repro_torch.distributed import compression as port  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which are no
    faster on more threads, and the other test workers need the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x) -> np.ndarray:
    """A leaf as its float32 bit pattern (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        a = x.detach().float().numpy()
    else:
        a = np.asarray(jnp.asarray(x, jnp.float32))
    return a.view(np.uint32)


def _tree(seed: int, scale: float = 1.0):
    """(reference tree, port tree) from the same numpy draws: compressible
    float32 and bf16 leaves, a vector, and a matrix under 4,096 elements."""
    rng = np.random.default_rng(seed)
    arrays = {"w": rng.standard_normal((64, 128)) * scale,
              "emb": rng.standard_normal((300, 32)) * scale,
              "stack": {"w_up": rng.standard_normal((2, 32, 96)) * scale},
              "norm": rng.standard_normal((128,)) * scale,
              "small": rng.standard_normal((32, 64)) * scale}
    dtypes = {"w": "float32", "emb": "bfloat16", "w_up": "bfloat16",
              "norm": "float32", "small": "bfloat16"}

    def build(node, make):
        return {k: build(v, make) if isinstance(v, dict)
                else make(v.astype(np.float32), dtypes[k])
                for k, v in node.items()}

    jax_tree = build(arrays, lambda a, dt: jnp.asarray(a, getattr(jnp, dt)))
    port_tree = build(arrays, lambda a, dt: torch.from_numpy(a).to(
        getattr(torch, dt)))
    return jax_tree, port_tree


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_bit_equal(port_tree, ref_tree):
    port_leaves, ref_leaves = dict(_flat(port_tree)), dict(_flat(ref_tree))
    assert port_leaves.keys() == ref_leaves.keys()
    for name, p in port_leaves.items():
        r = ref_leaves[name]
        assert (p is None) == (r is None), name
        if p is not None:
            np.testing.assert_array_equal(_bits(p), _bits(r), err_msg=name)


def test_inputs_round_to_the_same_bf16():
    jt, pt = _tree(0)
    _assert_bit_equal(pt, jt)


@pytest.mark.parametrize("scale", [1.0, 3e-5])
def test_int8_bit_equal_over_20_rounds(scale):
    err_r = err_p = None
    for i in range(20):
        jt, pt = _tree(100 + i, scale)
        dq_r, err_r = ref.int8_compress(jt, err_r)
        dq_p, err_p = port.int8_compress(pt, err_p)
        _assert_bit_equal(dq_p, dq_r)
        _assert_bit_equal(err_p, err_r)
    # passthrough leaves: unchanged, no error
    assert dq_p["norm"].dtype == torch.float32 and err_p["norm"] is None
    assert dq_p["small"].dtype == torch.bfloat16 and err_p["small"] is None
    assert torch.equal(dq_p["small"], pt["small"])
    assert dq_p["emb"].dtype == torch.float32


def test_int8_scale_is_a_true_division():
    """The scale is max|g| / 127 correctly rounded, not max|g| * (1/127):
    the two differ in the last bit for some maxima."""
    amax = np.float32(1.0) + np.arange(1, 4000, dtype=np.float32) * 2 ** -23
    true = amax / np.float32(127.0)
    recip = amax * (np.float32(1.0) / np.float32(127.0))
    q_max = np.float32(127)
    i = int(np.nonzero(q_max * true != q_max * recip)[0][0])
    g = np.zeros((64, 64), np.float32)
    g[3, 5] = amax[i]
    dq, _ = port.int8_compress({"g": torch.from_numpy(g)})
    assert dq["g"][3, 5].item() == float(q_max * true[i])
    dq_r, _ = ref.int8_compress({"g": jnp.asarray(g)})
    np.testing.assert_array_equal(_bits(dq["g"]), _bits(dq_r["g"]))


@pytest.mark.parametrize("k_fraction", [0.05, 0.3, 1e-5])
def test_topk_bit_equal_over_rounds(k_fraction):
    err_r = err_p = None
    for i in range(5):
        jt, pt = _tree(200 + i)
        kept_r, err_r = ref.topk_compress(jt, k_fraction, err_r)
        kept_p, err_p = port.topk_compress(pt, k_fraction, err_p)
        _assert_bit_equal(kept_p, kept_r)
        _assert_bit_equal(err_p, err_r)
    if k_fraction == 1e-5:   # int(8192 * 1e-5) == 0: k is 1
        assert int((kept_p["w"] != 0).sum()) == 1


def test_topk_keeps_every_tie_at_the_threshold():
    """Magnitudes with ties at the k-th largest: every tied element is
    kept, on both sides, so more than k survive."""
    g = np.tile(np.array([4.0, -3.0, 3.0, 2.0, -2.0, 1.0, 0.5, -0.5],
                         np.float32), 1024).reshape(128, 64)
    k = int(g.size * 0.3)    # the k-th largest magnitude is 3.0
    kept_p, err_p = port.topk_compress({"g": torch.from_numpy(g)}, 0.3)
    kept_r, err_r = ref.topk_compress({"g": jnp.asarray(g)}, 0.3)
    _assert_bit_equal(kept_p, kept_r)
    _assert_bit_equal(err_p, err_r)
    n_kept = int((kept_p["g"] != 0).sum())
    assert n_kept == 3 * 1024 > k


def test_init_error_state_matches_reference():
    jt, pt = _tree(7)
    e_r, e_p = ref.init_error_state(jt), port.init_error_state(pt)
    _assert_bit_equal(e_p, e_r)
    assert e_p["emb"].dtype == torch.float32 and e_p["small"] is None
    assert set(port.COMPRESSORS) == set(ref.COMPRESSORS) == {"int8", "topk"}


def test_gradient_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((64, 128)).astype(
        np.float32))}
    err = port.init_error_state(g)
    true_sum = np.zeros((64, 128), np.float32)
    comp_sum = np.zeros((64, 128), np.float32)
    for _ in range(20):
        gi = {"w": torch.from_numpy(rng.standard_normal((64, 128)).astype(
            np.float32))}
        true_sum += gi["w"].numpy()
        dq, err = port.int8_compress(gi, err)
        comp_sum += dq["w"].numpy()
    resid = np.abs(true_sum - comp_sum).max()
    scale = np.abs(true_sum).max()
    assert resid < 0.05 * scale + 0.1


def test_topk_compression_sparsity():
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        (128, 64)).astype(np.float32))}
    kept, _ = port.topk_compress(g, k_fraction=0.1)
    assert float((kept["w"] != 0).float().mean()) <= 0.11
