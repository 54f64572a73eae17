"""The port's AdamW and cosine schedule against the reference's, on trees
with bf16 and float32 leaves of 1, 2 and 3 dimensions."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import adamw as ref  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

SHAPES = {"w3": ((3, 5, 7), "bfloat16"), "norm": ((11,), "float32"),
          "w2": ((6, 4), "float32"), "g2": ((2, 9), "bfloat16"),
          "b1": ((4,), "bfloat16"), "nested": {"s": ((2, 3), "float32")}}
# float32 schedule values: XLA's cos and torch's differ in the last bit at
# 49 of 1,200 steps; near the end of the decay 1 + cos cancels, so that bit
# weighs up to 3 ulps of the result there (1.1e-11 at 3.6e-5): 2 ulps
# relative, plus 2e-11 absolute (7e-8 of the base lr, 3e-4)
SCHEDULE_RTOL, SCHEDULE_ATOL = 2.5e-7, 2e-11


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(*v)
            for k, v in shapes.items()}


def _values(rng, dyadic: bool, scale=0.1):
    """numpy float32 values; dyadic ones (multiples of 2^-10, small) have
    exact squares and sums in float32, so the global norm cannot depend on
    the summation order."""
    def make(shape, _):
        if dyadic:
            return (rng.integers(-64, 64, shape) / 1024).astype(np.float32)
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return _tree(make)


def _pair(values):
    """The same values as a reference tree and a port tree, in each leaf's
    dtype."""
    dtypes = _tree(lambda shape, dt: dt)
    j = jax.tree_util.tree_map(lambda v, dt: jnp.asarray(v, dt), values,
                               dtypes)
    t = jax.tree_util.tree_map(
        lambda a, dt: torch.from_numpy(np.array(a, np.float32)).to(
            getattr(torch, dt)), j, dtypes)
    return j, t


def _assert_equal(j, t):
    for a, b in zip(jax.tree_util.tree_leaves(j), tree_lib.leaves(t)):
        assert str(a.dtype) == str(b.dtype).split(".")[1]
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))


def _run(lr_ref, lr_port, clip, dyadic, steps=5, seed=0):
    rng = np.random.default_rng(seed)
    jp, tp = _pair(_values(rng, False))
    jo = ref.AdamW(learning_rate=lr_ref, grad_clip=clip)
    to = adamw.AdamW(learning_rate=lr_port, grad_clip=clip)
    js, ts = jo.init(jp), to.init(tp)
    update = jax.jit(jo.update)
    for i in range(steps):
        jg, tg = _pair(_values(rng, dyadic, scale=10.0 ** -i))
        jp, js, jm = update(jg, js, jp)
        tp, ts, tm = to.update(tg, ts, tp)
    return (jp, js, jm), (tp, ts, tm)


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "no_clip"])
def test_update_matches_reference_bit_for_bit(clip):
    """Constant lr, gradients with an order-free global norm: parameters,
    m, v, step and grad norm equal the reference's exactly after 5 steps
    (clipping active at the first steps: norms from ~2 down)."""
    (jp, js, jm), (tp, ts, tm) = _run(1e-2, 1e-2, clip, dyadic=True)
    _assert_equal(jp, tp)
    _assert_equal(js.m, ts.m)
    _assert_equal(js.v, ts.v)
    assert int(js.step) == int(ts.step) == 5
    assert float(jm["grad_norm"]) == float(tm["grad_norm"])


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "no_clip"])
def test_update_with_schedule_matches_reference(clip):
    """Random gradients and the cosine schedule: the global norm sums in
    another order and the schedule may differ in its last bit, so float32
    leaves and moments agree to a few ulps; bf16 leaves round those away."""
    (jp, js, jm), (tp, ts, tm) = _run(
        ref.cosine_schedule(1e-2, 2, 10), adamw.cosine_schedule(1e-2, 2, 10),
        clip, dyadic=False)
    for j, t in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
        for a, b in zip(jax.tree_util.tree_leaves(j), tree_lib.leaves(t)):
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32),
                                       rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                               rtol=SCHEDULE_RTOL, atol=SCHEDULE_ATOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(100, 1000), (0, 50), (10, 10)])
def test_schedule_matches_reference(warmup, total):
    steps = np.arange(0, total + 200)
    a = np.asarray(jax.jit(jax.vmap(ref.cosine_schedule(3e-4, warmup, total)))(
        jnp.asarray(steps, jnp.int32)))
    b = adamw.cosine_schedule(3e-4, warmup, total)(
        torch.tensor(steps, dtype=torch.int32))
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a, rtol=SCHEDULE_RTOL,
                               atol=SCHEDULE_ATOL)
    assert (b.numpy() == a).mean() > 0.95
    assert float(b[0]) == 0.0 or warmup == 0
    np.testing.assert_allclose(float(b[-1]), 3e-5, rtol=1e-6)


def test_weight_decay_on_every_leaf_of_two_or_more_dims():
    """Zero gradients: only weight decay moves a parameter, and it moves
    each leaf of ndim >= 2 (a stacked norm scale [G, d] included) and no
    leaf of ndim 1."""
    params = {"scale_1d": torch.ones(8), "scale_stacked": torch.ones(2, 8),
              "w": torch.ones(3, 4, 5, dtype=torch.bfloat16) * 4}
    opt = adamw.AdamW(learning_rate=0.5, weight_decay=0.1)
    state = opt.init(params)
    grads = tree_lib.map_tree(torch.zeros_like, params)
    opt.update(grads, state, params)
    assert torch.equal(params["scale_1d"], torch.ones(8))
    assert torch.equal(params["scale_stacked"], torch.full((2, 8), 0.95))
    assert torch.equal(params["w"].float(), torch.full((3, 4, 5), 3.796875))


def test_update_is_in_place():
    """params, m, v and step keep their storage: a step holds no second
    copy of the state."""
    rng = np.random.default_rng(3)
    _, params = _pair(_values(rng, False))
    opt = adamw.AdamW()
    state = opt.init(params)
    ptrs = [t.data_ptr() for t in tree_lib.leaves((params, state))]
    grads = tree_lib.map_tree(torch.ones_like, params)
    new_params, new_state, _ = opt.update(grads, state, params)
    assert [t.data_ptr() for t in tree_lib.leaves((new_params, new_state))
            ] == ptrs
    assert new_params is params and int(state.step) == 1


def test_update_in_pieces_equals_whole(monkeypatch):
    """A leaf updated in flat pieces equals the leaf updated whole."""
    rng = np.random.default_rng(4)
    out = []
    for chunk in (adamw.CHUNK, 7):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        _, params = _pair(_values(np.random.default_rng(5), False))
        opt = adamw.AdamW(learning_rate=1e-2)
        state = opt.init(params)
        for _ in range(3):
            _, grads = _pair(_values(rng, False))
            opt.update(grads, state, params)
        out.append(tree_lib.leaves((params, state)))
        rng = np.random.default_rng(4)
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(6)
    j, t = _pair(_values(rng, False))
    np.testing.assert_allclose(float(adamw.global_norm(t)),
                               float(ref.global_norm(j)), rtol=1e-6)
