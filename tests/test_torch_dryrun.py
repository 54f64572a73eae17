"""The port's dry run (launch/dryrun.py, launch/op_analysis.py) against the
reference's (launch/dryrun.py, launch/hlo_analysis.py).

- ``op_analysis``'s dot FLOPs equal the reference's loop-aware HLO count
  for smoke phi4, Granite, Jamba and xLSTM × train, prefill and decode on
  the host mesh, within 0.1%;
- rolled loops count what every iteration counts (above the smoke depth
  and length), and the collectives
  ``op_analysis`` counts are the ones ``CommDebugMode`` sees dispatched;
- the roofline table parses; a kernel on a sharded mesh input raises.

The sweeps of every smoke architecture × shape are in
tests/test_torch_dryrun_cells.py (fake (4, 2) mesh) and
tests/test_torch_dryrun_multi*.py (fake (2, 2, 2)). Every test sets up its
own fake group (run_cell does, and tears it down).
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import ShapeConfig, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun, mesh as mesh_lib  # noqa: E402
from repro_torch.launch.op_analysis import OpAnalysis  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from torch_parity import port_config  # noqa: E402

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
STEP_SHAPES = {"train": (32, 4), "prefill": (32, 2), "decode": (32, 2)}


@pytest.fixture
def fake_group():
    def make(world):
        mesh_lib.init_group("fake", world)
    yield make
    mesh_lib.destroy_group()


def _ref_dot_flops(arch, kind):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch import hlo_analysis
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_step as ref_build_step

    S, B = STEP_SHAPES[kind]
    built = ref_build_step(ref_smoke(arch), make_host_mesh(),
                           RefShape("s", kind, S, B))
    hlo = built.lower().compile().as_text()
    return hlo_analysis.analyze(hlo).dot_flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "granite_moe_1b_a400m",
                                  "jamba_v01_52b", "xlstm_1_3b"])
def test_dot_flops_match_hlo_analysis(arch, kind, fake_group):
    fake_group(1)
    mesh = mesh_lib.make_host_mesh("cpu")
    S, B = STEP_SHAPES[kind]
    built = build_step(get_smoke_config(arch), mesh,
                       ShapeConfig("s", kind, S, B))
    with OpAnalysis() as a:
        built.fn(*built.args())
    theirs = _ref_dot_flops(arch, kind)
    assert theirs > 0
    assert a.cost.dot_flops == pytest.approx(theirs, rel=1e-3)


@pytest.mark.parametrize("arch,shape", [
    ("xlstm_1_3b", ("prefill", 640, 4)), ("jamba_v01_52b", ("prefill", 320, 4)),
    ("phi4_mini_3_8b", ("train", 5120, 4)),
    ("granite_moe_1b_a400m", ("decode", 64, 4)),
    ("xlstm_1_3b", ("train", 128, 4))])
def test_rolled_loops_count_every_iteration(arch, shape, fake_group):
    """Rolled and unrolled runs of one step (five groups, five or more
    iterations of every loop kind: mLSTM and SSM chunks, attention blocks,
    the sLSTM's 128 and 640 steps) count the same collectives and dot
    FLOPs, and elementwise FLOPs and traffic within 0.5%, both ways.
    Unrolled, op_analysis's collectives are CommDebugMode's. A train
    step's gradient sums across iterations count n - 1 times; a rolled
    group loop adds the zero gradients that autograd makes for the stacked
    leaves' slices of the groups it skips (xLSTM train: +0.34% elementwise
    FLOPs, +0.10% traffic)."""
    import dataclasses

    from torch.distributed.tensor.debug import CommDebugMode

    fake_group(8)
    mesh = mesh_lib.make_mesh((4, 2), ("data", "model"), device="cpu")
    kind, S, B = shape
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=5 * cfg.resolved_scan_period)
    built = build_step(cfg, mesh, ShapeConfig("s", kind, S, B))
    costs = {}
    for roll in (False, True):
        with OpAnalysis(roll=roll, device="meta") as a, \
                CommDebugMode() as comm:
            built.fn(*built.args())
        costs[roll] = a.cost
        if not roll:
            counts = {str(k).split(".")[-1]: v
                      for k, v in comm.get_comm_counts().items() if v}
    full, rolled = costs[False], costs[True]
    assert rolled.trip_counts and rolled.ops < full.ops
    assert {k: v["count"] for k, v in rolled.collectives.items()} == \
        {k: v["count"] for k, v in full.collectives.items()}
    names = {"all_reduce": "all-reduce", "all_gather_into_tensor":
             "all-gather", "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all"}
    assert {names[k]: v for k, v in counts.items()} == \
        {k: v["count"] for k, v in full.collectives.items()}
    for field in ("dot_flops", "collective_bytes"):
        assert getattr(rolled, field) == getattr(full, field), field
    for field in ("elementwise_flops", "traffic_bytes"):
        got, want = getattr(rolled, field), getattr(full, field)
        assert got == pytest.approx(want, rel=5e-3), field


def _ref_local_bytes(arch, shape_name, mesh_shape, axes):
    """Bytes of one device's argument shards by the reference's specs: the
    parameters, for a train step m and v (ZeRO-1), the step counter and
    the batch, for a prefill the batch, for decode the token and caches
    (the cache index is a Python int in the port)."""
    from repro.configs import SHAPES_BY_NAME
    from repro.configs import get_smoke_config as ref_smoke
    from repro.distributed import sharding as ref_shd
    from repro.launch import steps as ref_steps
    from repro.models import build_model as ref_build

    class Stub:
        axis_names = axes
        devices = np.empty(mesh_shape)

    mesh, sizes = Stub(), dict(zip(axes, mesh_shape))
    shape = SHAPES_BY_NAME[shape_name]
    cfg = ref_smoke(arch)
    if shape.kind != "train":
        cfg = ref_steps.pad_heads_for_tp(cfg, mesh)
    model = ref_build(cfg)
    rules = ref_steps.rules_for(mesh, cfg, shape)
    pspecs = model.param_specs()
    inputs = model.input_specs(shape)
    pairs = [(ref_shd.param_specs(pspecs, rules, mesh), pspecs)]
    if shape.kind == "train":
        m = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, np.float32), pspecs)
        z = ref_shd.zero1_specs(m, rules, mesh)
        pairs += [(z, m), (z, m), (jax.sharding.PartitionSpec(),
                                   jax.ShapeDtypeStruct((), np.int32))]
    if shape.kind == "decode":
        pairs += [(ref_steps.cache_specs(inputs["caches"], rules, mesh),
                   inputs["caches"]),
                  (rules.spec(("batch", None), shape=(shape.global_batch, 1),
                              axis_sizes=sizes), inputs["token"])]
    else:
        pairs += [(ref_steps.batch_specs(inputs, mesh, rules), inputs)]
    total = 0
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    for specs, structs in pairs:
        specs = jax.tree_util.tree_leaves(specs, is_leaf=is_spec)
        structs = jax.tree_util.tree_leaves(structs)
        assert len(specs) == len(structs)
        for spec, st in zip(specs, structs):
            local = list(st.shape)
            for d, entry in enumerate(spec):
                for ax in ((entry,) if isinstance(entry, str)
                           else entry or ()):
                    local[d] //= sizes[ax]
            total += int(np.prod(local)) * np.dtype(st.dtype).itemsize
    return total


def test_roofline_table_parses(tmp_path, capsys):
    from repro_torch.bench import roofline

    for arch, shape in (("gemma_2b", "train_4k"), ("gemma_2b", "long_500k"),
                        ("jamba_v01_52b", "decode_32k")):
        dryrun.run_cell(arch, shape, "4x2", tmp_path, smoke=True)
    rows = roofline.run(root=str(tmp_path))
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l and not l.startswith("#")]
    assert lines[0] == roofline.HEADER
    cols = len(roofline.HEADER.split(","))
    assert all(len(l.split(",")) == cols for l in lines[1:])
    assert len(rows) == 2 and len(lines) == 4
    for row in rows:
        assert 0 < roofline._roofline_fraction(row)


def test_cli_writes_records(tmp_path):
    assert dryrun.main(["--arch", "gemma_2b", "--shape", "decode_32k",
                        "--mesh", "4x2", "--smoke", "--out",
                        str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "gemma_2b__decode_32k__4x2.json").read_text())
    assert rec["status"] == "ok" and rec["peaks"]["flops"] == 989.4e12


def test_kernel_on_a_sharded_mesh_raises(fake_group):
    """use_kernel=True on a fake (4, 2) mesh: the kernels are not
    partitioned, so the entry point raises (the reference's dry run runs
    use_pallas=False)."""
    fake_group(8)
    mesh = mesh_lib.make_mesh((4, 2), ("data", "model"), device="cpu")
    built = build_step(get_smoke_config("phi4_mini_3_8b"), mesh,
                       ShapeConfig("p", "prefill", 32, 4), use_kernel=True)
    with pytest.raises(NotImplementedError, match="not partitioned"):
        built.fn(*built.args())


def test_config_copies_match():
    from repro.configs import get_smoke_config as ref_smoke

    for arch in ARCH_IDS:
        assert port_config(ref_smoke(arch)) == get_smoke_config(arch)
