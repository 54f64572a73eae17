"""The pure helpers of chip_smoke.py, on the CPU: the ptxas report parser
its build check reads for spills, and the bounds it prints beside each
kernel's time (the selective scan's with the exp unit)."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z4fastPf' for 'sm_90a'
ptxas info    : Function properties for _Z4fastPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 123 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z5spillPf' for 'sm_90a'
ptxas info    : Function properties for _Z5spillPf
    16 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes cumulative \
stack size
"""


def test_ptxas_report_is_read_per_function():
    funcs = chip_smoke.ptxas_functions(REPORT)
    assert funcs == {
        "_Z4fastPf": {"spill_stores": 0, "spill_loads": 0, "registers": 123},
        "_Z5spillPf": {"spill_stores": 16, "spill_loads": 24,
                       "registers": 128}}


@pytest.mark.parametrize("clock_hz,term", [(1.98e9, "exp"), (1e12, "bytes")])
def test_selective_scan_bound_counts_the_exp_unit(clock_hz, term):
    """At Jamba's prefill shape, 67,108,864 exps at 16 a clock on 132 SMs
    and 1.98 GHz (16.05 us) lie above the 10.5 us byte bound; on a clock
    fast enough the bytes bind again."""
    ms, by, nbytes, flops, exps = chip_smoke.ssm_bound(
        1, 512, 8192, 16, torch.bfloat16, torch.float32, 132, clock_hz)
    assert exps == 512 * 8192 * 16 and flops == 6 * exps
    # u and y bf16, dt float32, B and C bf16, A and D, h0 and h_last
    assert nbytes == (2 * 2 * 512 * 8192 + 4 * 512 * 8192 + 2 * 2 * 512 * 16
                      + 4 * (8192 * 16 + 8192) + 4 * 2 * 8192 * 16)
    assert by == term
    if term == "exp":
        assert ms == pytest.approx(exps / (16 * 132 * 1.98e9) * 1e3)
        assert ms > nbytes / chip_smoke.PEAK_BYTES_S * 1e3
    else:
        assert ms == pytest.approx(nbytes / chip_smoke.PEAK_BYTES_S * 1e3)


def test_slstm_bound_is_bound_by_operations_at_xlstm_width():
    ms, by = chip_smoke.slstm_bound(1, 512, 4, 512, torch.bfloat16)
    assert by == "operations"
    assert ms == pytest.approx(2 * 512 * 4 * 2048 * 512 / 67e12 * 1e3)
