"""The port's config copy and weight/cache conversion against the reference."""
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro.models.transformer import init_caches  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from torch_parity import (models, port_config, reference_view,  # noqa: E402
                          to_numpy)

PORT_CONFIG_DIR = (Path(__file__).resolve().parents[1]
                   / "src" / "repro_torch" / "configs")
# configurations of the port alone: the reference has no latent attention
PORT_ONLY = ("moonlight_16b_a3b",)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "gemma_2b", "xlstm_1_3b",
                                  "jamba_v01_52b", "arctic_480b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_param_round_trip_is_exact(arch, dtype):
    """Same keys, shapes, dtypes (the float32 leaves of a bf16 model stay
    float32: Jamba's router, a_log, dt_bias and ssm_d among them) and
    values after the round trip."""
    _, jp, _, pp = models(arch, dtype)
    ref = dict(_leaves(to_numpy(jp)))
    got = dict(_leaves(pp))
    assert ref.keys() == got.keys()
    back = dict(_leaves(convert.to_numpy(pp)))
    for key, a in ref.items():
        t = got[key]
        assert t.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[a.dtype.name], key
        assert tuple(t.shape) == a.shape, key
        np.testing.assert_array_equal(back[key], a.astype(np.float32),
                                      err_msg=key)


def test_cache_round_trip_is_exact():
    cfg = get_smoke_config("phi4_mini_3_8b")
    rng = np.random.default_rng(0)
    caches = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        init_caches(cfg, 2, 16))
    ref = dict(_leaves(to_numpy(caches)))
    got = dict(_leaves(convert.to_numpy(convert.to_torch(to_numpy(caches), device="cpu"))))
    assert ref.keys() == got.keys() == {"pos00/k", "pos00/v"}
    for key, a in ref.items():
        assert a.shape == (cfg.n_groups, 2, 16, cfg.n_kv_heads,
                           cfg.resolved_head_dim)
        np.testing.assert_array_equal(got[key], a.astype(np.float32))


def test_xlstm_state_round_trip_is_exact():
    """The recurrent caches: {posNN: {C, n, m, conv} | {c, n, m, h}}, float32
    states and a bf16 conv state."""
    cfg = get_smoke_config("xlstm_1_3b")
    rng = np.random.default_rng(1)
    caches = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        init_caches(cfg, 2, 16))
    ref = dict(_leaves(to_numpy(caches)))
    tree = convert.to_torch(to_numpy(caches), device="cpu")
    got = dict(_leaves(convert.to_numpy(tree)))
    assert ref.keys() == got.keys() == {
        "pos00/C", "pos00/n", "pos00/m", "pos00/conv",
        "pos01/c", "pos01/n", "pos01/m", "pos01/h"}
    assert tree["pos00"]["conv"].dtype == torch.bfloat16
    assert tree["pos01"]["c"].dtype == torch.float32
    for key, a in ref.items():
        assert a.shape[:2] == (cfg.n_groups, 2), key
        np.testing.assert_array_equal(got[key], a.astype(np.float32))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_copy_matches_reference(arch, size):
    ref = (get_config if size == "full" else get_smoke_config)(arch)
    cfg = port_config(ref)
    assert reference_view(cfg, ref) == dataclasses.asdict(ref)
    assert cfg.resolved_head_dim == ref.resolved_head_dim
    assert cfg.padded_vocab == ref.padded_vocab
    assert cfg.resolved_scan_period == ref.resolved_scan_period
    assert cfg.n_groups == ref.n_groups
    assert cfg.moe.enabled == ref.moe.enabled
    for i in range(ref.n_layers):
        assert cfg.layer_kind(i) == ref.layer_kind(i)
        assert cfg.layer_is_moe(i) == ref.layer_is_moe(i)


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "phi4-mini-3.8b",
                                  "gemma_2b", "gemma-2b", "chatglm3_6b",
                                  "codeqwen15_7b", "internvl2_2b",
                                  "musicgen_large", "xlstm_1_3b",
                                  "jamba_v01_52b", "granite-moe-1b-a400m",
                                  "granite_moe_1b_a400m", "arctic_480b"])
def test_ported_config_files_match_reference(arch):
    for get, port_get in ((get_config, port_configs.get_config),
                          (get_smoke_config, port_configs.get_smoke_config)):
        assert (reference_view(port_get(arch), get(arch))
                == dataclasses.asdict(get(arch)))


def test_every_port_config_file_matches_reference():
    """Each config file under repro_torch/configs/ is a copy of the
    reference's, CONFIG and SMOKE_CONFIG field for field, but for the
    port's own configurations (``PORT_ONLY``: models the reference cannot
    build)."""
    names = sorted(p.stem for p in PORT_CONFIG_DIR.glob("*.py")
                   if p.stem not in ("__init__", "base") + PORT_ONLY)
    assert len(names) == 10, names
    for arch in names:
        assert arch in ARCH_IDS, arch
        for get, port_get in ((get_config, port_configs.get_config),
                              (get_smoke_config,
                               port_configs.get_smoke_config)):
            assert (reference_view(port_get(arch), get(arch))
                    == dataclasses.asdict(get(arch))), arch


def test_phi4_full_size_counts():
    cfg = port_configs.get_config("phi4_mini_3_8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff) == (32, 3072, 24, 8, 128, 8192)
    assert cfg.padded_vocab == 200192 and cfg.n_groups == 32


def test_jamba_float32_leaves_of_a_bf16_model():
    """The MoE router and Mamba's a_log, dt_bias and ssm_d stay float32
    in a bf16 Jamba, on both sides and after the round trip."""
    _, jp, _, pp = models("jamba_v01_52b", "bfloat16")
    got = dict(_leaves(pp))
    f32_leaves = {k for k, t in got.items() if t.dtype == torch.float32}
    for key in ("stack/pos01/moe/router", "stack/pos00/mixer/a_log",
                "stack/pos00/mixer/dt_bias", "stack/pos00/mixer/ssm_d"):
        assert key in f32_leaves, key
    assert got["stack/pos01/moe/experts/w_up"].dtype == torch.bfloat16
    assert got["stack/pos00/mixer/in_proj"].dtype == torch.bfloat16


def test_jamba_state_round_trip_is_exact():
    """Jamba's caches: {conv, h} for Mamba positions (bf16 conv, float32
    h), {k, v} at the attention position."""
    cfg = get_smoke_config("jamba_v01_52b")
    rng = np.random.default_rng(2)
    caches = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        init_caches(cfg, 2, 16))
    ref = dict(_leaves(to_numpy(caches)))
    tree = convert.to_torch(to_numpy(caches), device="cpu")
    got = dict(_leaves(convert.to_numpy(tree)))
    assert ref.keys() == got.keys()
    assert set(tree["pos00"]) == {"conv", "h"}
    assert set(tree["pos04"]) == {"k", "v"}
    assert tree["pos00"]["conv"].dtype == torch.bfloat16
    assert tree["pos00"]["h"].dtype == torch.float32
    for key, a in ref.items():
        np.testing.assert_array_equal(got[key], a.astype(np.float32))


def test_to_torch_runs_on_the_card_unless_asked_for_the_cpu():
    """Like the port's other entry points: CUDA by default, which raises
    where there is none; ``device="cpu"`` always works."""
    tree = {"a": np.ones((2, 3), np.float32),
            "b": {"c": np.arange(4, dtype=np.float32)}}
    if torch.cuda.is_available():
        got = convert.to_torch(tree)
        assert got["a"].is_cuda and got["b"]["c"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            convert.to_torch(tree)
    got = convert.to_torch(tree, device="cpu")
    assert got["a"].device.type == "cpu" and got["b"]["c"].device.type == "cpu"
    np.testing.assert_array_equal(got["b"]["c"].numpy(), tree["b"]["c"])
