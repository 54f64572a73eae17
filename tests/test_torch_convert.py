"""The port's config copy and weight/cache conversion against the reference."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro.models.transformer import init_caches  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from torch_parity import models, port_config, to_numpy  # noqa: E402


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "gemma_2b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_param_round_trip_is_exact(arch, dtype):
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
    got = dict(_leaves(convert.to_numpy(convert.to_torch(to_numpy(caches)))))
    assert ref.keys() == got.keys() == {"pos00/k", "pos00/v"}
    for key, a in ref.items():
        assert a.shape == (cfg.n_groups, 2, 16, cfg.n_kv_heads,
                           cfg.resolved_head_dim)
        np.testing.assert_array_equal(got[key], a.astype(np.float32))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_copy_matches_reference(arch, size):
    ref = (get_config if size == "full" else get_smoke_config)(arch)
    cfg = port_config(ref)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.resolved_head_dim == ref.resolved_head_dim
    assert cfg.padded_vocab == ref.padded_vocab
    assert cfg.resolved_scan_period == ref.resolved_scan_period
    assert cfg.n_groups == ref.n_groups
    assert cfg.moe.enabled == ref.moe.enabled
    for i in range(ref.n_layers):
        assert cfg.layer_kind(i) == ref.layer_kind(i)
        assert cfg.layer_is_moe(i) == ref.layer_is_moe(i)


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "phi4-mini-3.8b",
                                  "gemma_2b", "gemma-2b"])
def test_ported_config_files_match_reference(arch):
    for get, port_get in ((get_config, port_configs.get_config),
                          (get_smoke_config, port_configs.get_smoke_config)):
        assert (dataclasses.asdict(port_get(arch))
                == dataclasses.asdict(get(arch)))


def test_phi4_full_size_counts():
    cfg = port_configs.get_config("phi4_mini_3_8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff) == (32, 3072, 24, 8, 128, 8192)
    assert cfg.padded_vocab == 200192 and cfg.n_groups == 32
