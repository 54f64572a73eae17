"""The dry run on a fake (4, 2) mesh (data, model): every smoke
architecture at every assigned shape is ok, long_500k skipped exactly
where the reference skips it, collectives above 0 (model = 2), and one
device's argument bytes are the local shard bytes that the reference's
specs imply. run_cell sets up and tears down its own fake group."""
import json

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from test_torch_dryrun import SHAPES, _ref_local_bytes  # noqa: E402


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_4x2(arch, shape, tmp_path):
    from repro.configs import SHAPES_BY_NAME
    from repro.configs import get_smoke_config as ref_smoke
    from repro.configs import supports_shape as ref_supports

    rec = dryrun.run_cell(arch, shape, "4x2", tmp_path, smoke=True)
    assert json.loads((tmp_path / f"{arch}__{shape}__4x2.json").read_text()
                      )["status"] == rec["status"]
    if not ref_supports(ref_smoke(arch), SHAPES_BY_NAME[shape]):
        assert rec["status"] == "skipped"
        assert rec["reason"] == dryrun.SKIP_REASON
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["op_detail"]["collective_bytes"] > 0
    assert rec["roofline"]["collective_s"] > 0
    assert rec["op_flops_per_device"] > 0 and rec["op_bytes_per_device"] > 0
    assert rec["dominant"] in rec["roofline"]
    assert rec["memory"]["argument_bytes"] == _ref_local_bytes(
        arch, shape, (4, 2), ("data", "model"))
