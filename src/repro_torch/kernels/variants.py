"""Timing variants of the scan kernels on the card: where a step's time goes.

  PYTHONPATH=src python -m repro_torch.kernels.variants [--rounds 3]
      [--baseline DIR] [--out results.jsonl]

Each variant is a copy of a kernel's source with a few lines replaced (each
replacement must match the source exactly once), built with ``nvcc`` under
``build/variants/`` and timed at the main path's shape: the sLSTM scan (K4)
at xLSTM 1.3B's sLSTM layer (B=1 S=512 H=4 dh=512, bf16 preactivations),
the selective scan (K3) at Jamba's Mamba layer (Bb=1 S=512 d=8192 N=16,
u/B/C bf16, dt float32, an initial state). ``--baseline DIR`` adds the
earlier designs of both kernels, from the sources ``DIR/slstm_scan.cu`` and
``DIR/ssm_scan.cu`` of a previous commit (``git show
<commit>:src/repro_torch/kernels/csrc/slstm_scan.cu``): the sLSTM scan
with R in shared memory and a per-head barrier (``smem``) with its
variants, and the selective scan that walks its chunks in sequence
(``serial_chunks``), each called through its own C signature. All
variants are
timed in turns, ``--rounds`` times, in one process on one card; each line
gives every reading and their median. Both sLSTM designs are also timed
at S = 1 and 64, which splits their time into a fixed set-up and a time
per step. A variant that still computes the
function (``exact``) is also held against the plain version; the others
leave something out and are for timing only. Prints one JSON line per
variant and exits nonzero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import slstm_scan, ssm_scan
from repro_torch.kernels.build import BUILD_DIR, KernelLibrary

VARIANT_DIR = BUILD_DIR.parent / "variants"

_REGS_NO_EXCHANGE = [
    ("        *q = __uint_as_float(static_cast<unsigned>(v));",
     "        *q = 0.5f;"),
    ("             static_cast<int>((v = load_word(p)) >> 32) != t;) {",
     "             false;) {")]
_NO_CELL = [
    ("      const float zt = tanhf(pc[2] + gs[2 * COLS]);\n", ""),
    ("      const float ot = 1.f / (1.f + expf(-(pc[3] + gs[3 * COLS])));\n",
     ""),
    ("      const float lf = log_sigmoid(ft);\n", ""),
    ("      const float lm = lf + m;\n", ""),
    ("      const float e = expf(-fabsf(lm - it));\n", ""),
    ("      const float fs = lm >= it ? 1.f : e;\n", ""),
    ("      const float is = lm >= it ? e : 1.f;\n", ""),
    ("      c = c * fs + is * zt;\n      n = n * fs + is;\n"
     "      m = fmaxf(lm, it);\n      h = ot * c / fmaxf(n, 1e-6f);",
     "      h = 0.25f * (it + ft + pc[2] + gs[2 * COLS] + pc[3] + "
     "gs[3 * COLS]);")]
_REGS_NO_DOT = ("    for (int b = 0; b < B; ++b) {\n      const float4* hrow",
                "    for (int b = 0; b < 0; ++b) {\n      const float4* hrow")
_REGS_NO_H_READS = [("for (int j = 0; j < NJ; ++j) hv[j] = hrow[KJ / 4 * j];",
                     "for (int j = 0; j < NJ; ++j)\n        hv[j] = "
                     "make_float4(0.5f, 0.5f, 0.5f, 0.5f);")]

# (label, exact, [(old, new), ...]): K4 and what each variant leaves out of
# a step
SLSTM_VARIANTS = [
    ("regs", True, []),
    ("regs_no_wait", False, [
        ("static_cast<int>((v = load_word(p)) >> 32) != t;",
         "(v = load_word(p)), false;")]),
    ("regs_poll_backoff", True, [
        ("          if (++spins > SPIN_LIMIT) __trap();\n        }\n        *q",
         "          if (++spins > SPIN_LIMIT) __trap();\n"
         "          __nanosleep(32);\n        }\n        *q")]),
    ("regs_poll_backoff_long", True, [
        ("          if (++spins > SPIN_LIMIT) __trap();\n        }\n        *q",
         "          if (++spins > SPIN_LIMIT) __trap();\n"
         "          __nanosleep(128);\n        }\n        *q")]),
    ("regs_no_exchange", False, _REGS_NO_EXCHANGE),
    ("regs_no_h_reads", False, _REGS_NO_H_READS),
    ("regs_no_exchange_no_h_reads", False,
     _REGS_NO_EXCHANGE + _REGS_NO_H_READS),
    ("regs_no_dot", False, [_REGS_NO_DOT]),
    ("regs_no_pre_loads", False, [
        ("      for (int g = 0; g < 4; ++g) pn[g] = load_in(pre_t + g * d);\n"
         "    }\n    __syncthreads();",
         "      for (int g = 0; g < 4; ++g) pn[g] = 0.5f;\n"
         "    }\n    __syncthreads();")]),
    ("regs_skeleton", False, _REGS_NO_EXCHANGE + [_REGS_NO_DOT] + _NO_CELL),
    ("regs_no_cell", False, _NO_CELL),
    ("regs_fast_cell", False, [
        ("  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));",
         "  return fminf(x, 0.f) - __logf(1.f + __expf(-fabsf(x)));"),
        ("      const float e = expf(-fabsf(lm - it));",
         "      const float e = __expf(-fabsf(lm - it));"),
        ("      h = ot * c / fmaxf(n, 1e-6f);",
         "      h = __fdividef(ot * c, fmaxf(n, 1e-6f));")]),
]

# the earlier sLSTM design (R in shared memory, a per-head barrier in
# global memory) and what each variant leaves out of its step
_SMEM_BARRIER = ("    if (t + 1 < S) {\n      // barrier of the P blocks",
                 "    if (false) {\n      // barrier of the P blocks")
SMEM_SLSTM_VARIANTS = [
    ("smem", True, []),
    ("smem_no_barrier", False, [_SMEM_BARRIER]),
    ("smem_no_r_reads", False, [
        ("const float w = rs[k * RSTRIDE + o];", "const float w = 1.f;")]),
    ("smem_no_exchange", False, [
        _SMEM_BARRIER,
        ("      hsm[i] = __ldcg(hprev + (static_cast<size_t>(b) * H + head) "
         "* dh + k);", "      hsm[i] = 0.5f;"),
        ("      __stcg(hbuf + static_cast<size_t>(t & 1) * B * d + sidx, h);",
         "")]),
]

# K3 and what each variant changes
SSM_VARIANTS = [
    ("ring", True, []),
    ("ring_lanes4", True, [
        ("    return launch<8, 2, TU, TD>(", "    return launch<4, 4, TU, TD>(")]),
    ("ring_lanes16", True, [
        ("    return launch<8, 2, TU, TD>(", "    return launch<16, 1, TU, TD>(")]),
    # the lane's own sums added in place of the shuffles
    ("ring_no_reduce", False, [
        ("      transpose_reduce<L, L / 2>(acc, lane);  // lane i: step g0 + i\n",
         "      for (int i = 1; i < L; ++i) acc[0] += acc[i];\n")]),
    ("ring_no_exp", False, [
        ("dA[i][j] = exp2_approx(dtv[i] * a2[j]);",
         "dA[i][j] = fmaf(dtv[i], a2[j], 1.f);")]),
    ("ring_no_loads", False, [
        ("    if (k + 1 < chunks) fetch(t0 + TC);\n", ""),
        ("    if (k + 1 < chunks) stash(buf ^ 1);\n", "")]),
    # S < 0 never holds, but the compiler cannot drop y_s and the sums
    # behind it as dead
    ("ring_no_y_store", False, [
        ("      if (kin && tu + r * RU < nt)",
         "      if (kin && tu + r * RU < nt && S < 0)")]),
]
SERIAL_SSM_VARIANTS = [("serial_chunks", True, [])]
SWEEP_S = (1, 64, 512)  # prompt lengths of the sLSTM bodies' S sweep


class SmemSlstmScan(KernelLibrary):
    """The earlier sLSTM scan, called through its C signature (an h buffer
    and per-head barrier counters as scratch)."""

    name = "smem_slstm_scan"

    def _bind(self, lib) -> None:
        fn = lib.slstm_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def __call__(self, pre, r, c0, n0, m0, h0):
        lib = self.build()
        B, S, _, d = pre.shape
        H, dh = r.shape[1], r.shape[2]
        dev = pre.device
        hs = torch.empty((B, S, d), dtype=pre.dtype, device=dev)
        states = [torch.empty((B, H, dh), device=dev) for _ in range(4)]
        hbuf = torch.empty((2, B, H, dh), device=dev)
        bar = torch.zeros((H,), dtype=torch.int32, device=dev)
        info = (ctypes.c_int * 3)()
        err = lib.slstm_scan_fwd(
            *(t.data_ptr() for t in (pre, r, c0, n0, m0, h0, hs, *states,
                                     hbuf, bar)),
            int(pre.dtype == torch.bfloat16), B, S, H, dh, info,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"earlier slstm_scan_fwd failed: {err}")
        self._count("smem")
        return hs, tuple(states)


class SerialSsmScan(KernelLibrary):
    """The earlier selective scan, called through its C signature (a bf16
    flag for each of u, dt, B and C)."""

    name = "serial_ssm_scan"

    def _bind(self, lib) -> None:
        fn = lib.ssm_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def __call__(self, u, dt, A, B, C, D, h0=None):
        lib = self.build()
        Bb, S, d = u.shape
        N = A.shape[1]
        y = torch.empty_like(u)
        h_last = torch.empty((Bb, d, N), device=u.device)
        flags = (ctypes.c_int * 4)(*(int(t.dtype == torch.bfloat16)
                                     for t in (u, dt, B, C)))
        err = lib.ssm_scan_fwd(
            *(t.data_ptr() for t in (u, dt, A, B, C, D)),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), Bb, S, d, N, flags,
            torch.cuda.current_stream(u.device).cuda_stream)
        if err:
            raise RuntimeError(f"earlier ssm_scan_fwd failed: {err}")
        self._count("serial_chunks")
        return y, h_last


def patched(source: Path, patches) -> str:
    """``source``'s text with each (old, new) applied; raises unless each
    ``old`` occurs exactly once."""
    text = source.read_text()
    for old, new in patches:
        count = text.count(old)
        if count != 1:
            raise ValueError(f"{source.name}: {old!r} occurs {count} times")
        text = text.replace(old, new)
    return text


def variant_kernel(cls, source: Path, label: str, patches):
    """A kernel object of class ``cls`` built from ``source`` patched into
    ``build/variants/<label>.cu``."""
    kernel = cls()
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    path = VARIANT_DIR / f"{label}.cu"
    text = patched(source, patches)
    if not path.exists() or path.read_text() != text:
        path.write_text(text)
    kernel.source = path
    kernel.name = f"variant_{label}"
    return kernel


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms, by CUDA events over ``iters`` calls
    queued behind a spin kernel (so the host's launch rate does not pace
    them)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def slstm_inputs(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, S, H, dh = 1, 512, 4, 512
    pre = torch.randn((B, S, 4, H * dh), generator=gen,
                      device="cuda").to(torch.bfloat16)
    r = torch.randn((4, H, dh, dh), generator=gen, device="cuda") * dh ** -0.5
    zeros = torch.zeros((B, H, dh), device="cuda")
    m0 = torch.full((B, H, dh), -1e30, device="cuda")
    return pre, r, zeros, zeros, m0, zeros


def ssm_inputs(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    Bb, S, d, N = 1, 512, 8192, 16

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    u = randn(Bb, S, d).to(torch.bfloat16)
    dt = rand(Bb, S, d) * 0.099 + 1e-3
    A = -(rand(d, N) * 1.5 + 0.5)
    Bm, Cm = (randn(Bb, S, N).to(torch.bfloat16) for _ in range(2))
    return u, dt, A, Bm, Cm, randn(d), randn(Bb, d, N)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _flat(out):
    """(hs, (c, n, m, h)) or (y, h) as one tuple of tensors."""
    first, rest = out
    return (first, *rest) if isinstance(rest, tuple) else (first, rest)


def run(rounds: int, seed: int, baseline: Path | None):
    """Build every variant, check the exact ones, time all in turns;
    returns one record per variant."""
    s_args, m_args = slstm_inputs(seed), ssm_inputs(seed)
    tables = [("slstm_scan", slstm_scan.SlstmScanKernel,
               slstm_scan.SOURCE, SLSTM_VARIANTS),
              ("ssm_scan", ssm_scan.SsmScanKernel, ssm_scan.SOURCE,
               SSM_VARIANTS)]
    if baseline is not None:
        tables += [("slstm_scan", SmemSlstmScan, baseline / "slstm_scan.cu",
                    SMEM_SLSTM_VARIANTS),
                   ("ssm_scan", SerialSsmScan, baseline / "ssm_scan.cu",
                    SERIAL_SSM_VARIANTS)]
    calls = []  # (kernel name, label, exact, kernel object)
    for kname, cls, source, table in tables:
        for label, exact, patches in table:
            calls.append((kname, label, exact,
                          variant_kernel(cls, source, label, patches)))
    with ThreadPoolExecutor(len(calls)) as pool:
        list(pool.map(lambda c: c[3].build(), calls))

    def caller(kname, k):
        if kname == "slstm_scan":
            return lambda: k(*s_args)
        return lambda: k(*m_args[:6], h0=m_args[6])

    refs = {"slstm_scan": _flat(slstm_scan.slstm_scan_ref(*s_args)),
            "ssm_scan": _flat(ssm_scan.ssm_scan_ref(*m_args[:6],
                                                    h0=m_args[6]))}
    records = {}
    for kname, label, exact, k in calls:
        got = _flat(caller(kname, k)())
        torch.cuda.synchronize()
        ptxas = (BUILD_DIR / f"{k.name}.ptxas.txt").read_text()
        records[label] = {
            "kernel": kname, "variant": label, "exact": exact,
            "max_abs_err": [(a.float() - b.float()).abs().max().item()
                            for a, b in zip(got, refs[kname])]
            if exact else None,
            "ptxas": [ln.strip() for ln in ptxas.splitlines()
                      if "registers" in ln or "spill" in ln],
            "ms": []}
    for _ in range(rounds):
        for kname, label, exact, k in calls:
            records[label]["ms"].append(device_ms(caller(kname, k)))
    for rec in records.values():
        rec["ms_median"] = statistics.median(rec["ms"])
        if rec["kernel"] == "slstm_scan":
            rec["ms_per_step_median"] = rec["ms_median"] / 512
    # the sLSTM bodies at shorter prompts: a fixed set-up (R into the SMs)
    # and a time per step
    for kname, label, exact, k in calls:
        if kname == "slstm_scan" and label in ("regs", "smem"):
            by_s = {S: statistics.median(
                device_ms(lambda: k(s_args[0][:, :S], *s_args[1:]))
                for _ in range(rounds)) for S in SWEEP_S}
            records[label]["ms_by_S"] = by_s
            records[label]["ms_per_step_fit"] = (
                (by_s[SWEEP_S[-1]] - by_s[SWEEP_S[-2]])
                / (SWEEP_S[-1] - SWEEP_S[-2]))
    return list(records.values())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", type=Path, default=None,
                    help="directory with an earlier commit's slstm_scan.cu "
                         "and ssm_scan.cu")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    name = card()
    lines = [json.dumps({"card": name})]
    for rec in run(args.rounds, args.seed, args.baseline):
        lines.append(json.dumps({"card": name, **rec}))
    print("\n".join(lines), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
