"""Small sizes for running the harness on the CPU: the port's smoke
configurations and mixes cut to match, with limits of their own.

The limits at these sizes are set as the cells' are, from readings of
``calibrate.py --device cpu`` at the same overrides: serving (bf16, fp8
control), the widest gap over seeds 1-12 0.00237, the control's over
seeds 10-12 0.0204 or more: limit 0.007. Training runs the configuration
in float32 here, with its control in bf16: the CPU's bf16 matmuls do not
sum in float32 as the card's do, and at this size the bf16 program's
gradients read as far from the reference as the fp8 control's (0.021
against 0.018). In float32, over seeds 1-12: grad_gap 2.0e-7 at most,
change_gap 2.7e-6; the bf16 control over seeds 21-23: 0.0021 and 0.0016
or more, the half-batch fault 0.054 and 0.030: limits 2e-5 and 6e-5."""
import dataclasses

import pytest

SERVE = "phi4-serve-longdoc"
TRAIN = "granite-train-moe"


def overrides(cell: str) -> dict:
    from repro_torch.configs.base import get_smoke_config

    if cell == SERVE:
        return {"model": dataclasses.asdict(
                    get_smoke_config("phi4_mini_3_8b")),
                "mix": {"lanes": 4, "clients": 4, "max_len": 160,
                        "prompt_tokens": {"low": 16, "high": 128},
                        "output_tokens": {"low": 2, "high": 6}, "block": 8,
                        "warmup_steps": 6, "check": {"served_tokens": 20}},
                "limits": {"served_gap": {"limit": 0.007}}}
    return {"model": dict(dataclasses.asdict(
                get_smoke_config("granite_moe_1b_a400m")), dtype="float32"),
            "mix": {"batch": 4, "seq": 64, "reference_block_rows": 4},
            "limits": {"grad_gap": {"limit": 2e-5},
                       "change_gap": {"limit": 6e-5}}}


@pytest.fixture
def small():
    return overrides
