"""The port's data pipeline: SyntheticTokens against the reference's, bit
for bit, and TokenPipeline's order, restart and shutdown."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data.pipeline import SyntheticTokens as RefTokens  # noqa: E402
from repro_torch.data import SyntheticTokens, TokenPipeline  # noqa: E402


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 1), (0, 977), (3, 5),
                                       (12345, 2 ** 20)])
@pytest.mark.parametrize("frontend", [0, 16])
def test_synthetic_tokens_bit_equal_to_reference(seed, step, frontend):
    kw = dict(vocab_size=509, seq_len=33, global_batch=3, seed=seed,
              frontend_dim=frontend, frontend_tokens=4 if frontend else 0)
    a, b = RefTokens(**kw).batch_at(step), SyntheticTokens(**kw).batch_at(step)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    assert (b["tokens"][:, 1:] == b["labels"][:, :-1]).all()
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 509


@pytest.mark.parametrize("start", [0, 7])
def test_pipeline_resumes_at_start_step(start):
    src = SyntheticTokens(100, 8, 2, seed=4, frontend_dim=6,
                          frontend_tokens=2)
    pipe = TokenPipeline(src, device="cpu", start_step=start)
    try:
        for want in range(start, start + 4):
            step, batch = next(pipe)
            assert step == want and pipe.step == want + 1
            ref = src.batch_at(want)
            for k, v in ref.items():
                assert isinstance(batch[k], torch.Tensor)
                assert batch[k].device.type == "cpu"
                assert np.array_equal(batch[k].numpy(), v), k
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()


def test_pipeline_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TokenPipeline(SyntheticTokens(10, 4, 1), device="cuda")


def test_pipeline_raises_the_producer_error():
    class Broken(SyntheticTokens):
        def batch_at(self, step):
            if step == 2:
                raise ValueError("no batch 2")
            return super().batch_at(step)

    pipe = TokenPipeline(Broken(100, 8, 2), device="cpu")
    try:
        assert [next(pipe)[0] for _ in range(2)] == [0, 1]
        with pytest.raises(ValueError, match="no batch 2"):
            next(pipe)
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()
