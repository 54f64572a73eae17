"""The pure helpers of chip_smoke.py, on the CPU: the ptxas report parser
its build check reads for spills, the bounds it prints beside each
kernel's time (the selective scan's with the exp unit), the model FLOPs of
a train step, and the training, fault-tolerance, compression, dispatch
and example phases at smoke size."""
import importlib.util
import json
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


def test_train_flops_of_phi4_at_run_config_defaults():
    """6 N T for the weight matmuls plus 12 L B S^2 Hq hd for the scores."""
    from repro_torch.configs import get_config

    cfg = get_config("phi4_mini_3_8b")
    f = chip_smoke.train_flops(cfg, 8, 512, 3_836_414_976)
    assert f["tokens"] == 4096
    assert f["active_params"] == 3_836_414_976
    assert f["weight_flops"] == 6 * 3_836_414_976 * 4096
    assert f["attention_flops"] == 12 * 32 * 8 * 512 ** 2 * 24 * 128
    assert f["flops"] == f["weight_flops"] + f["attention_flops"]


def test_train_flops_count_the_active_experts():
    """Granite-MoE 1B-A400M: 24 layers of 32 experts, top 8 of them active;
    the 1.33 B parameters hold 429 M active ones."""
    from repro_torch.configs import get_config

    cfg = get_config("granite_moe_1b_a400m")
    f = chip_smoke.train_flops(cfg, 8, 512, 1_334_887_424)
    idle = 24 * 3 * 1024 * 512 * (32 - 8)
    assert f["active_params"] == 1_334_887_424 - idle == 428_917_760
    assert f["weight_flops"] == 6 * 428_917_760 * 4096


def test_train_flops_count_attention_layers_only():
    from repro_torch.configs import get_config

    jamba = get_config("jamba_v01_52b")   # 1 attention layer in 8
    xlstm = get_config("xlstm_1_3b")      # none
    assert chip_smoke.train_flops(jamba, 1, 64, 10)["attention_flops"] == (
        12 * 4 * 64 ** 2 * 32 * 128)
    assert chip_smoke.train_flops(xlstm, 1, 64, 10)["attention_flops"] == 0


def _smoke_cfg(arch):
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(arch)


def test_train_phases_run_on_the_cpu(capsys):
    """The train_check, train and checkpoint phases, driven on the CPU at
    smoke size (on the card they run the published widths)."""
    import dataclasses

    from repro_torch.configs import RunConfig

    cfg = dataclasses.replace(_smoke_cfg("phi4_mini_3_8b"), dtype="float32")
    chip_smoke.phase_train_check(cfg, 0, device="cpu")
    granite = _smoke_cfg("granite_moe_1b_a400m")
    run = RunConfig(model=granite, seq_len=32, global_batch=2)
    rec = chip_smoke.phase_train(granite, 0, 3, device="cpu", run=run)
    assert [r["step"] for r in rec["steps"]] == [1, 2, 3]
    assert all(r["aux"] > 0 for r in rec["steps"])
    assert rec["changed_share_by_dtype"]["float32"] > 0
    assert not any(rec["launches"].values())
    ranges = rec["breakdown"]["ranges"]
    assert set(ranges) == {"forward", "backward", "optimizer"}
    assert all(r["host_ms"] > 0 for r in ranges.values())
    chip_smoke.phase_checkpoint(_smoke_cfg("phi4_mini_3_8b"), 0,
                                device="cpu")
    out = capsys.readouterr().out
    for phase in ("train_check", "train", "checkpoint"):
        assert f'"phase": "{phase}"' in out


@pytest.fixture
def one_thread():
    """One intra-op thread for the phases' many small ops: no slower, and
    the other test workers need the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("one_thread")
def test_fault_and_compress_phases_run_on_the_cpu(capsys):
    """The fault, compress and train_lm phases, driven on the CPU at smoke
    size (on the card: Phi-4-mini at full width and 2 layers)."""
    cfg = _smoke_cfg("phi4_mini_3_8b")
    state, batch = chip_smoke.phase_fault(cfg, 0, device="cpu", batch=2,
                                          seq=32)
    chip_smoke.phase_compress(cfg, state["params"], batch, 0, device="cpu",
                              leaf_shape=(64, 128))
    chip_smoke.phase_train_lm(device="cpu")
    out = capsys.readouterr().out
    recs = {r["phase"]: r for r in map(json.loads, (
        line for line in out.splitlines() if line.startswith('{"phase"')))}
    fault = recs["fault"]
    assert fault["report"]["remeshes"] == [[4, 3]]   # (step, dp) in JSON
    assert fault["mismatched_leaves"] == []
    assert [s["step"] for s in fault["saves"]] == [4, 8, 8]
    assert all(s["write_s"] > 0 and s["host_copy_s"] > 0
               for s in fault["saves"])
    assert fault["kept"] == ["step_00000004", "step_00000008"]
    assert [r["step"] for r in fault["restores"]] == [4]
    comp = recs["compress"]
    assert comp["compressors"]["int8"]["leaves_differing_from_cpu"] == []
    assert comp["compressors"]["topk"]["nonzero_share"] <= 0.06
    assert comp["bytes"] > 0 and comp["topk_leaf_ties"] == 0
    assert comp["topk_kept_share"] == int(64 * 128 * 0.05) / (64 * 128)
    assert recs["train_lm"]["report"]["restores"] == 1


@pytest.mark.usefixtures("one_thread")
def test_dispatch_and_serving_phases_run_on_the_cpu(capsys):
    """The dispatch, serve_batched and serving_replay phases on the CPU
    (smoke configs; no kernel launches there)."""
    chip_smoke.phase_dispatch(device="cpu")
    counts, _ = chip_smoke.phase_serve_batched(device="cpu", full=False)
    assert not any(counts.values())
    counts, _ = chip_smoke.phase_serving_replay(device="cpu", full=False)
    assert not any(counts.values())
    out = capsys.readouterr().out
    recs = {r["phase"]: r for r in map(json.loads, (
        line for line in out.splitlines() if line.startswith('{"phase"')))}
    assert recs["dispatch"]["raising_payload_recorded"]
    assert recs["dispatch"]["executor"]["ok"] == 300
    assert recs["serve_batched"]["dispatch_reduction"] == 8.0
    assert recs["serving_replay"]["smoke_invariant"]
    assert [r["lanes"] for r in recs["serving_replay"]["rows"]] == [4, 16]


def test_compress_bytes_count_compressible_leaves_only():
    g = {"w": torch.zeros(64, 128, dtype=torch.bfloat16),
         "b": torch.zeros(128), "m": torch.zeros(32, 64)}
    assert chip_smoke.compress_bytes(g) == 64 * 128 * (2 + 12)


def test_mesh_phase_at_smoke_size():
    """Phase 21 on the CPU (gloo, one device): the mesh's train steps are
    bit-equal to the meshless ones, its float32 decode tokens equal, the
    no-op constrain calls of a decode step counted; no kernel launches on
    the CPU."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("phi4_mini_3_8b")
    counts, _ = chip_smoke.phase_mesh(cfg, 0, device="cpu")
    rec = json.loads(chip_smoke.OUT_LINES[-1])
    assert rec["phase"] == "mesh" and rec["backend"] == "gloo"
    assert rec["mesh"] == {"data": 1, "model": 1}
    assert not any(counts.values())
    assert rec["train"]["mismatched_leaves"] == []
    assert rec["train"]["losses"]["plain"] == rec["train"]["losses"]["mesh"]
    assert rec["decode_float32"]["tokens_equal"]
    assert rec["decode_full"]["tokens_equal"]
    assert rec["prefill"]["max_abs_logit_diff"] == 0.0
    # embed, logits, and q, k, v, out, ffn up and down a layer
    assert rec["constrain"]["calls_per_decode_step"] == 2 + 6 * cfg.n_layers
    assert rec["constrain"]["noop_call_us"] > 0
    assert not torch.distributed.is_initialized()


def test_dryrun_phase_at_smoke_size():
    """Phase 22's subprocess and record at smoke size on a fake (4, 2)
    mesh: every cell ok or skipped as the reference skips it."""
    rec = chip_smoke.phase_dryrun(
        timeout=600, smoke=True, mesh="4x2",
        archs=("phi4_mini_3_8b", "jamba_v01_52b"),
        shapes=("decode_32k", "long_500k"))
    got = {(c["arch"], c["shape"]): c["status"] for c in rec["cells"]}
    assert got == {("phi4_mini_3_8b", "decode_32k"): "ok",
                   ("phi4_mini_3_8b", "long_500k"): "skipped",
                   ("jamba_v01_52b", "decode_32k"): "ok",
                   ("jamba_v01_52b", "long_500k"): "ok"}
    assert rec["returncode"] == 0
    for c in rec["cells"]:
        if c["status"] == "ok":
            assert c["dominant"] in c["roofline"]
            assert 0 < c["argument_share_of_80GB"] < 1
