"""The (2, 2, 2) dry-run sweep of tests/test_torch_dryrun_multi.py for
the last five architectures."""
import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from test_torch_dryrun import SHAPES  # noqa: E402
from test_torch_dryrun_multi import check_cell_2x2x2  # noqa: E402


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS[5:])
def test_run_cell_2x2x2(arch, shape, tmp_path):
    check_cell_2x2x2(arch, shape, tmp_path)
