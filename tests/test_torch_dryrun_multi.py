"""The dry run on a fake (2, 2, 2) mesh (pod, data, model): every smoke
architecture at every assigned shape is ok, long_500k skipped exactly
where the reference skips it, collectives above 0 (model = 2), and one
device's argument bytes are the local shard bytes that the reference's
specs imply (tests/test_torch_dryrun_cells.py has the (4, 2) sweep). The
first five architectures here, the other five in
tests/test_torch_dryrun_multi2.py, so that two workers share the sweep.
run_cell sets up and tears down its own fake group."""
import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from test_torch_dryrun import SHAPES, _ref_local_bytes  # noqa: E402


def check_cell_2x2x2(arch, shape, tmp_path):
    from repro.configs import SHAPES_BY_NAME
    from repro.configs import get_smoke_config as ref_smoke
    from repro.configs import supports_shape as ref_supports

    rec = dryrun.run_cell(arch, shape, "2x2x2", tmp_path, smoke=True)
    if not ref_supports(ref_smoke(arch), SHAPES_BY_NAME[shape]):
        assert rec["status"] == "skipped"
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh_shape"] == {"pod": 2, "data": 2, "model": 2}
    assert rec["op_detail"]["collective_bytes"] > 0
    assert rec["memory"]["argument_bytes"] == _ref_local_bytes(
        arch, shape, (2, 2, 2), ("pod", "data", "model"))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS[:5])
def test_run_cell_2x2x2(arch, shape, tmp_path):
    check_cell_2x2x2(arch, shape, tmp_path)
