"""Dispatch for the port's kernels.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version. Nothing falls back
from the kernel to the plain version. ``plain_versions`` is a switch for
checks only: inside it, CUDA tensors take the plain versions too.

On a mesh (DTensor inputs), a kernel runs on each input's local shard
when that is the whole computation: on a mesh of one device, or with
every input replicated; its results are wrapped back as replicated. On
a larger mesh with a sharded input the entry points raise: the
reference does not partition its Pallas calls either, and its dry run
runs ``use_pallas=False``. A DTensor never reaches a
kernel's ``data_ptr()``; meta tensors (``is_cuda`` False) take the plain
versions.

Forward-only by design, as in the reference: the kernels have no backward,
and a kernel bound through ctypes returns outputs with no ``grad_fn``, so
the parameters upstream of it would get no gradient and no error. Each
entry point therefore refuses, on either device, an input that requires
grad while grad mode is on; training runs the models' plain paths.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  decode_kernel)
from repro_torch.kernels.expert_gemm import expert_gemm_ref, expert_kernel
from repro_torch.kernels.flash_attention import flash_attention_ref, flash_kernel
from repro_torch.kernels.slstm_scan import slstm_kernel, slstm_scan_ref
from repro_torch.kernels.ssm_scan import ssm_kernel, ssm_scan_ref

KERNELS = {"flash_attention": flash_kernel, "slstm_scan": slstm_kernel,
           "ssm_scan": ssm_kernel, "expert_gemm": expert_kernel,
           "decode_attention": decode_kernel}
_plain = {"on": False}


@contextlib.contextmanager
def plain_versions():
    """Run the plain versions on CUDA tensors as well, inside the block.

    For checks that hold a path through the kernels against the same path
    through their plain versions on the card; serving never enters it.
    """
    before = _plain["on"]
    _plain["on"] = True
    try:
        yield
    finally:
        _plain["on"] = before


def launch_counts() -> dict:
    """{kernel name: launches so far}."""
    return {name: k.launches for name, k in KERNELS.items()}


def launches_by_body() -> dict:
    """{kernel name: {body: launches so far}}."""
    return {name: dict(k.launches_by_body) for name, k in KERNELS.items()}


def launches_since(before: dict) -> dict:
    """{kernel name: {body: launches}} counted since ``before`` (a
    ``launches_by_body()``), kernels and bodies with none left out."""
    out = {}
    for name, by_body in launches_by_body().items():
        diff = {body: n - before[name].get(body, 0)
                for body, n in by_body.items()
                if n != before[name].get(body, 0)}
        if diff:
            out[name] = diff
    return out


def graph_launches(graph: int) -> dict:
    """{kernel name: {body: launches}} that the captured CUDA graph
    ``graph`` (a cudaGraph_t) holds, read from its kernel nodes; kernels
    it does not launch are left out."""
    found = {name: k.graph_launches(graph) for name, k in KERNELS.items()}
    return {name: by_body for name, by_body in found.items() if by_body}


def count_launches(launches: dict, times: int = 1) -> None:
    """Add ``launches`` ({kernel name: {body: launches}}) ``times`` times
    to the kernels' counts: a graph's replay launches what it holds
    without the wrappers that count (``times`` -1 takes them back)."""
    for name, by_body in launches.items():
        for body, n in by_body.items():
            KERNELS[name]._count(body, n * times)


def _forward_only(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"ops.{name} is forward-only: an input requires grad under grad "
            "mode, and the kernel would pass no gradient back; training "
            "takes the plain paths (use_kernel=False)")


def _on_shards(name: str, fn, *tensors):
    """``fn`` over the local shards of DTensor inputs, its results wrapped
    back as replicated (each shard is then its whole tensor); None if no
    input is a DTensor. Raises where the shards are not the whole
    computation."""
    from torch.distributed.tensor import DTensor, Replicate

    dts = [t for t in tensors if isinstance(t, DTensor)]
    if not dts:
        return None
    mesh = dts[0].device_mesh
    sharded = any(not p.is_replicate() for t in dts for p in t.placements)
    if mesh.size() > 1 and sharded:
        raise NotImplementedError(
            f"ops.{name} on a mesh of {mesh.size()} devices with a sharded "
            "input: the kernel is not partitioned (the reference's Pallas "
            "calls are not either); run the plain path (use_kernel=False)")
    out = fn(*(t.to_local() if isinstance(t, DTensor) else t
               for t in tensors))
    pl = [Replicate()] * mesh.ndim     # each shard is its whole tensor

    def wrap(x):
        if isinstance(x, tuple):
            return tuple(wrap(y) for y in x)
        return DTensor.from_local(x, mesh, pl, run_check=False)
    return wrap(out)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float = None):
    """q: [B,S,Hq,hd]; k,v: [B,T,Hkv,hd] -> [B,S,Hq,hd] in q's dtype; the
    scores scaled by ``scale``, by default hd^-0.5."""
    _forward_only("flash_attention", q, k, v)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    out = _on_shards("flash_attention",
                     lambda *t: flash_attention(*t, **kw), q, k, v)
    if out is not None:
        return out
    if q.is_cuda and not _plain["on"]:
        return flash_kernel(q, k, v, **kw)
    return flash_attention_ref(q, k, v, **kw)


def decode_attention(q, ck, cv, cache_index, window: int = 0,
                     softcap: float = 0.0):
    """q: [B,1,Hq,hd]; ck, cv: [B,L,Hkv,hd], a layer's cache (the kernel
    reads it in place); cache_index: an int or a [B] tensor, the last
    position each lane attends -> [B,1,Hq,hd] in q's dtype."""
    _forward_only("decode_attention", q, ck, cv)
    out = _on_shards("decode_attention", lambda *t: decode_attention(
        *t, window=window, softcap=softcap), q, ck, cv, cache_index)
    if out is not None:
        return out
    if q.is_cuda and not _plain["on"]:
        return decode_kernel(q, ck, cv, cache_index, window=window,
                             softcap=softcap)
    return decode_attention_ref(q, ck, cv, cache_index, window=window,
                                softcap=softcap)


def slstm_scan(pre, r_all, c0, n0, m0, h0):
    """pre: [B,S,4,d]; r_all: [4,H,dh,dh]; c0/n0/m0/h0: [B,H,dh] float32.
    Returns (hs [B,S,d] in pre's dtype, (cT, nT, mT, hT) [B,H,dh])."""
    _forward_only("slstm_scan", pre, r_all, c0, n0, m0, h0)
    out = _on_shards("slstm_scan", slstm_scan, pre, r_all, c0, n0, m0, h0)
    if out is not None:
        return out
    if pre.is_cuda and not _plain["on"]:
        return slstm_kernel(pre, r_all, c0, n0, m0, h0)
    return slstm_scan_ref(pre, r_all, c0, n0, m0, h0)


def ssm_scan(u, dt, A, B, C, D, h0=None):
    """u, dt: [Bb,S,d]; A: [d,N]; B,C: [Bb,S,N]; D: [d]; h0: [Bb,d,N] or
    None. Returns (y [Bb,S,d] in u's dtype, h_last [Bb,d,N] float32)."""
    _forward_only("ssm_scan", u, dt, A, B, C, D, h0)
    out = _on_shards("ssm_scan", lambda *t: ssm_scan(*t[:6], h0=t[6]),
                     u, dt, A, B, C, D, h0)
    if out is not None:
        return out
    if u.is_cuda and not _plain["on"]:
        return ssm_kernel(u, dt, A, B, C, D, h0=h0)
    return ssm_scan_ref(u, dt, A, B, C, D, h0=h0)


def expert_gemm(x, w):
    """x: [E,M,K]; w: [E,K,N] -> [E,M,N] in x's dtype, summed in float32."""
    _forward_only("expert_gemm", x, w)
    out = _on_shards("expert_gemm", expert_gemm, x, w)
    if out is not None:
        return out
    if x.is_cuda and not _plain["on"]:
        return expert_kernel(x, w)
    return expert_gemm_ref(x, w)
