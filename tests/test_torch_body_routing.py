"""Which hand-written body each kernel launch takes, and the build's
staleness check. Pure functions of dtype, shape, strides and alignment
(``flash_attention._body_for``, ``expert_gemm._body_for``), checked on the
CPU with meta tensors where the main path's shapes would be large; the
launches themselves are held against the plain versions on the card
(test_torch_flash_attention_gpu.py, test_torch_expert_gemm_gpu.py). Also:
the scan kernels' timing variants still patch their sources."""
import os
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    expert_gemm, flash_attention, slstm_scan, ssm_scan, variants)
from repro_torch.kernels.build import KernelLibrary  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _attn(B, S, Hq, Hkv, hd, dtype=BF16, L=None):
    """q [B,S,Hq,hd] and k, v as views [:, :S] of a cache [B,L,Hkv,hd],
    as the serving path hands them over."""
    L = S if L is None else L
    q = _meta(B, S, Hq, hd, dtype=dtype)
    k = _meta(B, L, Hkv, hd, dtype=dtype)[:, :S]
    v = _meta(B, L, Hkv, hd, dtype=dtype)[:, :S]
    return q, k, v


@pytest.mark.parametrize("label,shape,body", [
    ("phi4 prefill", (1, 512, 24, 8, 128), "wgmma"),
    ("phi4 ragged", (1, 37, 24, 8, 128), "wgmma"),
    ("granite prefill", (1, 512, 16, 8, 64), "wgmma"),
    ("jamba prefill", (1, 481, 32, 8, 128), "wgmma"),
    ("phi4 smoke hd 16", (1, 100, 4, 2, 16), "mma_sync"),
    ("gemma smoke hd 32", (2, 130, 4, 1, 32), "mma_sync"),
    ("gemma hd 256", (1, 300, 8, 1, 256), "mma_sync"),
])
def test_flash_body_by_head_dim(label, shape, body):
    """bf16 at head dims 64 and 128 takes the TMA + wgmma body, other head
    dims the mma_sync body, with k/v as views into a longer cache."""
    B, S, Hq, Hkv, hd = shape
    assert flash_attention._body_for(*_attn(B, S, Hq, Hkv, hd,
                                            L=S + 64)) == body


@pytest.mark.parametrize("hd", [16, 64, 128, 256])
def test_flash_float32_takes_the_fma_body(hd):
    assert flash_attention._body_for(*_attn(1, 64, 4, 2, hd,
                                            dtype=F32)) == "fma"


def test_flash_strides_tma_cannot_take_keep_mma_sync():
    """TMA wants every stride a positive multiple of 16 bytes and 16-byte
    aligned bases; anything else stays on the mma_sync body."""
    q, k, v = _attn(1, 64, 4, 2, 64)
    assert flash_attention._body_for(q, k, v) == "wgmma"
    # rows of 68 elements: the sequence stride is not a multiple of 8
    padded = _meta(1, 64, 2, 68)[..., :64]
    assert flash_attention._body_for(q, padded, v) == "mma_sync"
    # a broadcast head (stride 0)
    shared = _meta(1, 64, 1, 64).expand(1, 64, 2, 64)
    assert flash_attention._body_for(q, k, shared) == "mma_sync"
    # no keys at all: a tensor map needs a nonzero extent
    assert flash_attention._body_for(q, k[:, :0], v[:, :0]) == "mma_sync"
    # a base 2 bytes past a 16-byte boundary (real memory for the address)
    buf = torch.zeros(1 + 64 * 4 * 64, dtype=BF16)
    assert buf.data_ptr() % 16 == 0
    q_off = buf[1:].view(1, 64, 4, 64)
    assert flash_attention._body_for(q_off, k, v) == "mma_sync"
    assert flash_attention._body_for(buf[:-1].view(1, 64, 4, 64), k,
                                     v) == "wgmma"


@pytest.mark.parametrize("label,E,M,K,N,body", [
    ("jamba up/gate", 16, 80, 4096, 14336, "wgmma"),
    ("jamba down", 16, 80, 14336, 4096, "wgmma"),
    ("jamba decode", 16, 4, 4096, 14336, "wgmma"),
    ("jamba 2048 tokens", 16, 320, 4096, 14336, "wgmma"),
    ("granite up/gate", 32, 160, 1024, 512, "wgmma"),
    ("granite down", 32, 160, 512, 1024, "wgmma"),
    ("M = 1", 4, 1, 256, 384, "wgmma"),
    ("ragged K", 3, 70, 100, 48, "mma_sync"),
    ("ragged N", 2, 17, 64, 33, "mma_sync"),
    ("ragged K and N", 2, 33, 77, 130, "mma_sync"),
])
def test_expert_gemm_body_by_shape(label, E, M, K, N, body):
    """bf16 where K and N are multiples of 8 (rows of whole 16-byte
    chunks) takes the TMA + wgmma body, whatever M; other shapes the
    mma_sync body."""
    assert expert_gemm._body_for(_meta(E, M, K), _meta(E, K, N)) == body


def test_expert_gemm_float32_and_misaligned_bases():
    assert expert_gemm._body_for(_meta(2, 8, 64, dtype=F32),
                                 _meta(2, 64, 64, dtype=F32)) == "fma"
    buf = torch.zeros(1 + 2 * 8 * 64, dtype=BF16)
    x_off = buf[1:].view(2, 8, 64)
    assert x_off.is_contiguous() and x_off.data_ptr() % 16 == 2
    assert expert_gemm._body_for(x_off, _meta(2, 64, 64)) == "mma_sync"
    assert expert_gemm._body_for(buf[:-1].view(2, 8, 64),
                                 _meta(2, 64, 64)) == "wgmma"


@pytest.mark.parametrize("kernel,table", [
    (slstm_scan.SlstmScanKernel, variants.SLSTM_VARIANTS),
    (ssm_scan.SsmScanKernel, variants.SSM_VARIANTS),
])
def test_timing_variants_patch_the_sources(kernel, table):
    """Every timing variant's replacements match its kernel's source
    exactly once, and a replacement that does not match is refused."""
    for label, _, patches in table:
        text = variants.patched(kernel.source, patches)
        assert all(new in text for _, new in patches), label
    with pytest.raises(ValueError):
        variants.patched(kernel.source, [("no such line", "")])


def test_launch_counts_split_by_body():
    """``launches_by_body`` counts the body each launch took, ``launches``
    is their sum; ``reset_counts`` zeroes both."""

    class Fake(KernelLibrary):
        name = "fake"

    lib = Fake()
    assert lib.launches == 0 and lib.launches_by_body == {}
    for body in ("wgmma", "wgmma", "mma_sync"):
        lib._count(body)
    assert lib.launches == 3
    assert lib.launches_by_body == {"wgmma": 2, "mma_sync": 1}
    lib.reset_counts()
    assert lib.launches == 0 and lib.launches_by_body == {}


def test_kernel_sources_list_the_shared_header():
    """K1 and K2 include hopper.cuh, so a change to it rebuilds both."""
    for module in (flash_attention, expert_gemm):
        names = [p.name for p in build.source_files(module.SOURCE)]
        assert names[0] == module.SOURCE.name and "hopper.cuh" in names


def _touch(path, t):
    os.utime(path, (t, t))


def test_staleness_counts_included_headers(tmp_path):
    """A library is stale when it is missing or older than its source or
    any header the source includes with quotes, directly or through
    another header; system headers and missing files are ignored."""
    src = tmp_path / "k.cu"
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\n")
    src.write_text('#include <cuda.h>\n#include "a.cuh"\n'
                   '  #  include "missing.cuh"\n')
    assert sorted(p.name for p in build.source_files(src)) == [
        "a.cuh", "b.cuh", "k.cu"]
    out = tmp_path / "k.so"
    assert build.is_stale(out, src)
    now = time.time()
    for name in ("k.cu", "a.cuh", "b.cuh"):
        _touch(tmp_path / name, now - 100)
    out.write_bytes(b"")
    _touch(out, now - 50)
    assert not build.is_stale(out, src)
    _touch(tmp_path / "b.cuh", now)          # an indirect header changed
    assert build.is_stale(out, src)
    _touch(tmp_path / "b.cuh", now - 100)
    _touch(src, now)                          # the source itself changed
    assert build.is_stale(out, src)
