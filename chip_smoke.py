#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

  python3 chip_smoke.py [--seed 0] [--out results.jsonl]

Phases, each printing one JSON line (and failing the run on any error):
  1. environment: torch/CUDA versions, card name and power limit;
  2. build the kernels from src/repro_torch/kernels/csrc, one nvcc each,
     all started together: flash attention (K1), the sLSTM scan (K4), the
     selective scan (K3), the grouped expert GEMM (K2) and decode
     attention (no TPU kernel: added for the decode step); count each
     kernel function's HGMMA (wgmma) and UTMALDG (TMA load) instructions
     in the built code, and fail unless K1's and K2's wgmma bodies have
     both; record ptxas's registers and spills for each kernel function
     and fail if any K4 body spills;
  3. hold K1 against its plain PyTorch version on the card over head dims
     16..256, MHA/GQA/MQA, ragged S, window and softcap (each case records
     the body it took), and time it at Phi-4-mini's prefill shapes (S = 37,
     512, 1000), Granite's (S = 512, hd 64) and Jamba's (S = 481, 32 q
     heads, 8 kv heads, hd 128) beside its plain version,
     torch's scaled_dot_product_attention (the default call, and under
     each backend that takes the call, with the one the default picks) and
     the card's bound;
  4. hold K4 against its plain version over the reference test's shapes,
     ragged S, S = 1, B up to 4, head dims 16 to 512, float32 and bf16
     preactivations, m0 = -1e30 and -inf, a nonzero initial state and
     xLSTM 1.3B's full width, and time it there;
  5. hold K3 against its plain version over the reference test's shapes,
     an initial state, ragged S (1, 37, 100, 513), a d that no block
     divides, the model's mixed dtypes (dt float32) and Jamba's full
     width, each in float32 and in bf16, and time it at full width beside
     a bound that counts bytes, fp32 operations and the exp unit (at the
     card's maximum SM clock, read by nvidia-smi);
  5a. hold K2 against its plain version over the reference test's shapes,
     ragged M, N and K, M = 1, 4, 300 and 320, Granite's and Jamba's
     prefill shapes and Jamba's decode shape, in float32 and bf16, and time
     it at
     Jamba's prefill and decode shapes and Granite's beside its plain
     version, torch.bmm and the card's bound;
  5b. hold the decode-attention kernel against its plain version over head
     dims 16..256, GQA/MQA, G up to 40, window and softcap, in float32 and
     bf16, with NaN in the cache past each lane's position and outside its
     window, and time it at phi4-serve-longdoc's decode shapes (32 lanes,
     L 8,256, positions log-uniform over 1,024-8,192) beside its byte
     bound, its plain version and torch's scaled_dot_product_attention,
     at each bf16 split size;
  6. serve full-width Phi-4-mini 3.8B (seeded random bf16 weights) through
     the continuous-batching engine, check that every prefill went through
     K1's wgmma body and every decode step through the decode kernel's mma
     body once a layer, the steps replayed as CUDA graphs after one
     capture (the launches a replay adds are read from the graphs' nodes;
     one replay under the profiler must launch the decode kernel's body
     once a layer too), and break a prefill and a decode step down;
  7. token check: Phi-4-mini at full width and 2 layers in float32, the
     engine's tokens equal single-stream greedy decoding;
  8. the same serving run and breakdown for full-width xLSTM 1.3B (every
     sLSTM prefill through K4);
  9. the xLSTM token check (one mLSTM and one sLSTM layer at full width,
     float32; the single stream runs K4's plain version);
  9a. the same serving run and breakdown for Granite-MoE 1B-A400M at full
     width and all 24 layers (every MoE prefill product through K2, every
     attention prefill through K1), then its token check at all 24 layers
     in float32 against single-stream greedy decoding through the plain
     path;
 10. the same serving run and breakdown for Jamba at every published width,
     cut to 16 of its 32 layers (every Mamba prefill through K3, every
     attention prefill through K1, every MoE prefill product through K2);
 11. the Jamba token check: one group of 8 layers (7 Mamba, 1 attention,
     4 MoE) at full width in float32, 3 lanes, against single-stream greedy
     decoding through the plain path;
 12. train_check: two float32 train steps of Phi-4-mini at full width and
     2 layers on the card and on the CPU from the same weights and
     batches: loss, grad norm and parameters agree;
 13. train: full-width, full-depth Phi-4-mini 3.8B in bf16 for 5 steps
     and Granite-MoE 1B-A400M for 3, at RunConfig's defaults (seq 512,
     batch 8) through launch/train.py's loop and TokenPipeline: loss, grad
     norm, lr and ms a step, tokens/s, peak memory and the model-FLOP
     share of the card's bf16 peak, then a breakdown of one more step
     (forward, backward, AdamW; the device's busy share). Fails on a
     non-finite loss, a grad norm <= 0, parameters no step changed, a
     Granite aux loss that is not finite and > 0, or any kernel launch
     (the kernels are forward-only; training takes the plain paths);
 14. checkpoint: a train state of the Phi-4-mini smoke config saved from
     the card by CheckpointManager and restored into a fresh state on the
     card, every leaf bit-equal and every digest matching;
 15. fault: Phi-4-mini at full width and 2 layers (bf16, B=8 S=512)
     trained 8 steps through TrainSupervisor, a synchronous checkpoint
     (~8.2 GB) every 4 steps, slice 2 of 4 failing at step 6: 1 failure,
     1 restore, a re-mesh to 3 data shards, and a final state bit-equal to
     8 uninterrupted steps (deterministic algorithms, this phase only);
     free disk, checkpoint bytes, each save's host copy and write, the
     restore, ms a step;
 16. compress: int8 and top-k (5%) compression with error feedback over
     that model's bf16 gradient tree (816 M elements), on the card and on
     the CPU, bit-equal, the card's ms beside the bytes bound; the
     error-feedback property over 20 rounds on one 3072 x 8192 leaf;
 17. train_lm: the port's examples/train_lm.py (loss falls, 1 restore);
 18. dispatch: the port's dispatch benchmark (t_s, U against task time,
     kernels a task launches), the near-zero-work task 300 times through
     TorchDispatchExecutor, and a raising payload recorded as failed;
 18a. scheduler: the port's scheduler core (repro_torch.core). (a) The
     quickstart's direct and bundled T_total and U, its latency-model fit
     and the table9_rapid_slurm makespan, each equal to its constant; (b)
     the control plane's tasks/s in bench/sched_throughput.py's quick
     regimes on this host; (c) real dispatch through Scheduler +
     TorchDispatchExecutor, direct against aggregate(job, 16): 4,096
     dispatch tasks at scales 1 and 16 (wall s, tasks/s, the scheduler's
     host us a task, U against 1 / (1 + t_s / t), outputs bit-equal
     between the runs), 256 tasks of one K1 call each at Phi-4-mini's
     prefill shape (one wgmma launch a task a run, outputs bit-equal to K1
     called alone) and a raising payload through the retry lifecycle;
     (d) the map-reduce example on the card (its histogram equals
     numpy's); (b) runs each quick suite (fifo, policy_path) with
     --check-baseline against the committed BENCH_sched_throughput.json;
 18b. workloads: the workload subsystem and the paper's benchmark drivers
     (repro_torch.workloads, repro_torch.bench) on the host, at the sizes
     of the reference's committed runs: the P = 1,408 Table-9 grid direct
     and multilevel over 3 trials (the 15 rows of
     experiments/bench_cache.json equal, trials equal), the Table-10 fits
     and the rows of Figs. 4-7; the four-family grid at P = 102,400
     streamed in waves of P under 8 active jobs (24,576,000 tasks in its
     largest set) and the scaled one-family grid, equal to
     table9_grid_P102400.json and table9_scale_P102400.json; the
     1,000,000-task Poisson stream (250,000 jobs x 4, P = 1,024, at most
     2,048 active jobs) equal to workload_stream_1M.json; the fault sweep
     equal to fault_replay_P1408.json; both replay drivers' --quick. Rows
     compare exactly (host-clock fields aside), fits within 1e-12; each
     run's wall seconds on a line of its own;
 18c. runtime: the rest of repro_torch.obs and the wall-clock runtime
     repro_torch.rt. (a) bench/self_latency.py's full sweep on this host
     (wave, per-event, many-jobs arena and object; P = 1,408, 3 trials),
     its gate (wave r2 >= 0.99), its profiled pass and --quick, each fit
     beside the committed reference run's (experiments/self_latency.json,
     another host); (b) phase 18a's direct dispatch runs (2,048 tasks at
     scales 1 and 16, TorchDispatchExecutor) once more under SelfProfiler,
     untimed: each phase's self us a task and share, beside the same job
     on the wave path with no executor; (c) AsyncRuntime with 4 workers x
     8 slots: (t_s, alpha_s) on the wall clock over bench/rt_replay.py's
     sizes on InMemoryTransport and loopback SocketTransport, with
     zero-work tasks and with the dispatch task run on each slot thread's
     own stream (outputs bit-equal to the task alone); 256 K1 tasks at
     Phi-4-mini's prefill shape leased over InMemoryTransport (outputs
     bit-equal to K1 alone, exactly 256 wgmma launches); the chaos soak
     with the dispatch task (every task once or quarantined); one socket
     run under a FlightRecorder, its Chrome trace written beside --out's
     file (else under build/)
     and its longest complete-to-dispatch gaps; (d) rt_replay --quick
     --check-baseline and self_latency --quick. No thread it starts
     outlives the phase;
 19. serve_batched: the port's example at Gemma 2B's published widths in
     float32, 1 lane against 8 lanes, identical outputs;
 20. serving_replay: the port's replay --quick (120 requests, lanes 4
     and 16) at Phi-4-mini's published widths in bf16, its smoke
     invariant, every prefill attention through K1's wgmma body;
 21. mesh: the step builders on a one-device DeviceMesh over NCCL
     (make_host_mesh) with full-width Phi-4-mini: a 32-layer bf16 prefill
     through K1 (32 wgmma launches), k-step decode (k = 4) at 2 layers in
     float32 with the meshless builder's greedy tokens and at full depth
     in bf16 beside it, two bf16 train steps at 2 layers bit-equal to the
     meshless ones (deterministic algorithms), host ms of a decode step
     and a train step on and off the mesh, and the host cost of the no-op
     constrain calls of a meshless decode step;
 22. dryrun: python -m repro_torch.launch.dryrun in two subprocesses (no
     card, a fake process group of 256) for Phi-4-mini, Granite-MoE,
     Jamba and xLSTM at full size × the four assigned shapes on the
     (16, 16) mesh: no failed cell, each cell's dominant roofline term and
     argument bytes a device against the card's 80 GB.
Phases 15-18 and 18b launch no kernel of the port, and fail if one does;
18c launches K1 in its K1 job only.
Every serving phase also checks that each launch took its main-path body
(``launches_by_body``): wgmma for K1 and K2, regs for K4, ring for K3, mma
for the decode kernel (fma in serve_batched's float32).
Each phase runs under a deadline: a phase that hangs ends the run with an
error. Then a line with the count of timings taken again after a host
stall, a line with the kernel table, and last the device line. Exits
nonzero without a CUDA device or without the repo's sources beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by dtype
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# exponentials a clock per SM (MUFU.EX2; CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0)
EXP_PER_CLOCK_PER_SM = 16
# allclose tolerances (atol = rtol). bf16 at 2e-2, the reference kernel
# tests' tolerance: K1 rounds P to bf16 for the tensor cores and both round
# the output to bf16, so they differ by about one bf16 ulp of the output
# (2^-8 relative); K4 computes in float32 and rounds hs to bf16 once, one
# ulp at most. float32 at 1e-5: both kernels keep float32 from load to
# store, so they differ from the plain versions only in summation order,
# ~1e-6 at these lengths.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
LSTM_LIBRARY_NOTE = ("no single PyTorch call computes the sLSTM scan: "
                     "torch.nn.LSTM has other gates and no stabiliser")
SSM_LIBRARY_NOTE = ("no single PyTorch call computes the selective scan: "
                    "its decay depends on the input at every step")
# K2's tolerances. bf16: both sum the exact bf16 x bf16 products in
# float32 and round the sum to bf16 once, so they differ by at most one
# bf16 ulp (2^-8 relative) where the two float32 sums straddle a rounding
# boundary: 2e-2. float32: sums of up to 14,336 products of N(0,1) x
# N(0, K^-1/2) terms, O(1) results, in another order: 1e-4.
GEMM_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
GEMM_LIBRARY = "torch.bmm(x, w) at the same shape and dtype"
# weights are rotated over copies of at least this many bytes in all when
# timing, so that every call reads them from HBM, as a model's layers do
L2_FLUSH_BYTES = 128 << 20

OUT_LINES = []
# cuda_ms readings taken again because the host had not queued every call
# before the spin ran out
CUDA_MS_RETAKES = [0]


def emit(obj) -> None:
    line = json.dumps(obj)
    OUT_LINES.append(line)
    print(line, flush=True)


@contextlib.contextmanager
def deadline(seconds: float, what: str):
    """Ends the process with exit code 3 if the block runs longer than
    ``seconds``: a kernel that deadlocks fails the run instead of hanging
    it."""
    def expire():
        print(f"chip_smoke: {what} passed its deadline of {seconds} s",
              file=sys.stderr, flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def cuda_ms(fn, iters: int = 20, warmup: int = 3, tries: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls.

    A spin kernel goes first, so the host has queued every call before the
    start event fires: the events then time the device's work, not the
    host's launch rate (which is slower than short kernels). If the start
    event has already fired when the host has queued the last call (a host
    stall outlasted the spin), the reading is taken again with a spin four
    times longer. A function whose host time exceeds the last spin (a plain
    version's Python loop) is read as it is, host-paced.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin = 200_000_000  # cycles, ~0.1 s
    for _ in range(tries):
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            break
        CUDA_MS_RETAKES[0] += 1
        spin *= 4
    return start.elapsed_time(end) / iters


def attention_bound(B, S, T, Hq, Hkv, hd, dtype, causal=True):
    """Least time (ms) for the function: bytes over HBM rate vs FLOPs over
    the dtype's peak; each input read once, the output written once."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * (2 * B * S * Hq * hd + 2 * B * T * Hkv * hd)
    i = np.arange(S)
    pairs = int(np.minimum(i + 1, T).sum()) if causal else S * T
    flops = 4 * B * Hq * hd * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_env() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "card": card, "device_count": torch.cuda.device_count()})


def sass_counts(library: Path) -> dict:
    """{kernel function: {"HGMMA": n, "UTMALDG": n}} from the library's
    SASS (cuobjdump): the wgmma and TMA-load instructions that were built.
    Functions are named by cu++filt, without their parameters."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(library)],
        capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), {"HGMMA": 0, "UTMALDG": 0})
        elif cur is not None:
            for op in cur:
                cur[op] += op in line
    return dict(zip(demangle(counts), counts.values()))


def ptxas_functions(report: str) -> dict:
    """{kernel function (mangled): {"registers": n, "spill_stores": bytes,
    "spill_loads": bytes}} from ptxas's -v report."""
    funcs, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^'\s]+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return funcs


def demangle(names) -> list:
    """Kernel function names by cu++filt, without their parameters."""
    from torch.utils.cpp_extension import CUDA_HOME

    return subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cu++filt"), "-p"],
        input="\n".join(names), capture_output=True, text=True,
        check=True).stdout.splitlines()


def phase_build(kernels):
    """Build every kernel, one nvcc process each, all started together;
    count the wgmma and TMA instructions of each kernel function; fail if
    a body of K4 spills (R would then sit in local memory)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.build import BUILD_DIR

    def build(item):
        name, kernel = item
        t0 = time.time()
        kernel.build()
        return name, time.time() - t0

    t0 = time.time()
    with ThreadPoolExecutor(len(kernels)) as pool:
        seconds = dict(pool.map(build, kernels.items()))
    for name in kernels:
        ptxas = BUILD_DIR / f"{name}.ptxas.txt"
        funcs = ptxas_functions(ptxas.read_text()) if ptxas.exists() else {}
        funcs = dict(zip(demangle(funcs), funcs.values()))
        sass = sass_counts(BUILD_DIR / f"{name}.so")
        emit({"phase": "build", "kernel": name, "seconds": seconds[name],
              "ptxas": funcs, "sass": sass})
        if name == "slstm_scan" and not (funcs and all(
                r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                for r in funcs.values())):
            raise AssertionError(f"slstm_scan: a body spills (R would sit "
                                 f"in local memory) or none was built: "
                                 f"{funcs}")
        wgmma = {f: c for f, c in sass.items() if "wgmma" in f}
        if name in ("flash_attention", "expert_gemm") and not (
                wgmma and all(c["HGMMA"] and c["UTMALDG"]
                              for c in wgmma.values())):
            raise AssertionError(f"{name}: no wgmma body with HGMMA and "
                                 f"UTMALDG instructions: {sass}")
    emit({"phase": "build", "all_seconds": time.time() - t0})


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def _device_kernels(fn) -> set:
    """The device kernels one call of fn() launches, by the first 40
    characters of their names (a tuning variant's suffix varies between
    calls), memsets left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:40] for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and not e.key.startswith("Memset")}


def sdpa_yardstick(qt, kt, vt) -> dict:
    """torch's scaled_dot_product_attention on [B,H,S,hd] inputs: the
    default call's time, the time under each backend that takes the call
    (or why it refused), and which backend the default call ran (by the
    device kernels it launches)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def under(backend):
        def run():
            with sdpa_kernel(backend):
                return call()
        return run

    rec = {"library_ms": cuda_ms(call), "sdpa_backends": {}}
    default = _device_kernels(call)
    rec["sdpa_default_kernels"] = sorted(default)
    rec["sdpa_default_backend"] = None
    for name in SDPA_BACKENDS:
        run = under(getattr(SDPBackend, name))
        try:  # a backend refuses shapes or flags it does not take
            run()
        except RuntimeError as err:
            rec["sdpa_backends"][name] = f"refused: {str(err)[:160]}"
            continue
        rec["sdpa_backends"][name] = cuda_ms(run)
        if _device_kernels(run) == default:
            rec["sdpa_default_backend"] = name
    return rec


def phase_kernel_check(flash_kernel, flash_attention_ref, body_for,
                       seed: int):
    """Kernel vs plain version on the card; times at the phi4, Granite and
    Jamba prefill shapes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # (label, B, S, Hq, Hkv, hd, causal, window, softcap)
    cases = [(f"phi4_S{S}", 1, S, 24, 8, 128, True, 0, 0.0)
             for S in (37, 512, 1000)]
    cases += [("granite_S512", 1, 512, 16, 8, 64, True, 0, 0.0),
              # Jamba's attention shape at its longest prompt of the run
              ("jamba_S481", 1, 481, 32, 8, 128, True, 0, 0.0),
              ("mha_hd64", 1, 256, 4, 4, 64, True, 0, 0.0),
              ("gqa_hd64_b2", 2, 256, 4, 2, 64, True, 0, 0.0),
              ("mqa_hd128", 1, 128, 4, 1, 128, True, 0, 0.0),
              ("gqa_hd16_ragged", 1, 100, 4, 2, 16, True, 0, 0.0),
              ("mqa_hd32_ragged", 1, 130, 4, 1, 32, True, 0, 0.0),
              ("gemma_mqa_hd256", 1, 300, 8, 1, 256, True, 0, 0.0),
              ("window64", 1, 300, 4, 2, 64, True, 64, 0.0),
              ("softcap20", 1, 200, 4, 2, 128, True, 0, 20.0),
              ("noncausal", 1, 150, 4, 2, 64, False, 0, 0.0)]
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, S, Hq, Hkv, hd, causal, window, softcap in cases:
            q = torch.randn((B, S, Hq, hd), generator=gen, device="cuda",
                            dtype=dtype)
            # k/v are views into a longer cache, as on the serving path
            L = S + 64
            ck = torch.randn((B, L, Hkv, hd), generator=gen, device="cuda",
                             dtype=dtype)
            cv = torch.randn((B, L, Hkv, hd), generator=gen, device="cuda",
                             dtype=dtype)
            k, v = ck[:, :S], cv[:, :S]
            kw = dict(causal=causal, window=window, softcap=softcap)
            out = flash_kernel(q, k, v, **kw)
            torch.cuda.synchronize()
            exp = flash_attention_ref(q, k, v, **kw)
            err = (out.float() - exp.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and torch.allclose(
                out.float(), exp.float(), atol=TOL[dtype], rtol=TOL[dtype])
            rec = {"phase": "kernel_check", "case": label,
                   "dtype": str(dtype).split(".")[1], "B": B, "S": S,
                   "Hq": Hq, "Hkv": Hkv, "hd": hd, "causal": causal,
                   "window": window, "softcap": softcap,
                   "body": body_for(q, k, v), "max_abs_err": err,
                   "tol": TOL[dtype], "ok": ok}
            if label.startswith(("phi4", "granite", "jamba")):
                rec["kernel_ms"] = cuda_ms(lambda: flash_kernel(q, k, v, **kw))
                rec["plain_ms"] = cuda_ms(
                    lambda: flash_attention_ref(q, k, v, **kw))
                rec.update(sdpa_yardstick(*(t.transpose(1, 2).contiguous()
                                            for t in (q, k, v))))
                rec["bound_ms"], rec["bound_by"] = attention_bound(
                    B, S, S, Hq, Hkv, hd, dtype)
                timed[(label, dtype)] = rec
            rec["launches_so_far"] = flash_kernel.launches
            emit(rec)
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version: {rec}")
    return timed


def slstm_bound(B, S, H, dh, dtype):
    """Least time (ms) of the sLSTM scan: bytes (pre and R read once, hs
    and the states in and out once) over HBM rate vs the recurrent dot
    products' FLOPs (2 S 4 d dh per batch row) over the fp32 FMA peak."""
    d = H * dh
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (B * S * 4 * d + B * S * d) + 4 * 4 * dh * dh * H
              + 4 * 8 * B * d)
    flops = 2 * B * S * 4 * d * dh
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_slstm_check(slstm_kernel, slstm_scan_ref, seed: int):
    """K4 vs its plain version on the card; times at xLSTM 1.3B's width."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # (label, B, S, H, dh, m0, nonzero initial state)
    cases = [("ref_1x32_h2_dh16", 1, 32, 2, 16, -1e30, False),
             ("ref_2x64_h2_dh32", 2, 64, 2, 32, -1e30, False),
             ("ref_2x48_h4_dh16", 2, 48, 4, 16, -1e30, False),
             ("ragged_S37_minf", 1, 37, 2, 32, -math.inf, False),
             ("ragged_S300", 2, 300, 4, 16, -1e30, False),
             ("state_dh24", 3, 50, 2, 24, 0.0, True),
             ("b4_dh128_S1_minf", 4, 1, 4, 128, -math.inf, False),
             ("b2_dh64_S37_state", 2, 37, 2, 64, 0.0, True),
             ("xlstm_full", 1, 512, 4, 512, -1e30, False)]
    timed = None
    for dtype in (torch.float32, torch.bfloat16):
        for label, B, S, H, dh, m0, nonzero in cases:
            d = H * dh

            def randn(*shape):
                return torch.randn(shape, generator=gen, device="cuda")

            pre = randn(B, S, 4, d).to(dtype)
            r = randn(4, H, dh, dh) * dh ** -0.5
            c0 = n0 = h0 = torch.zeros((B, H, dh), device="cuda")
            m = torch.full((B, H, dh), m0, device="cuda")
            if nonzero:
                c0, n0 = randn(B, H, dh), randn(B, H, dh).abs() + 0.5
                m, h0 = randn(B, H, dh), torch.tanh(randn(B, H, dh))
            args = (pre, r, c0, n0, m, h0)
            hs, state = slstm_kernel(*args)
            torch.cuda.synchronize()
            hs_ref, state_ref = slstm_scan_ref(*args)
            err = (hs.float() - hs_ref.float()).abs().max().item()
            state_err = max((a - b).abs().max().item()
                            for a, b in zip(state, state_ref))
            ok = (bool(torch.isfinite(hs).all()) and torch.allclose(
                hs.float(), hs_ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
                and all(torch.allclose(a, b, atol=1e-5, rtol=1e-5)
                        for a, b in zip(state, state_ref)))
            rec = {"phase": "slstm_check", "case": label,
                   "dtype": str(dtype).split(".")[1], "B": B, "S": S,
                   "H": H, "dh": dh, "m0": str(m0), "nonzero_state": nonzero,
                   "body": "regs", "max_abs_err": err, "tol": TOL[dtype],
                   "state_max_abs_err": state_err, "state_tol": 1e-5,
                   "ok": ok}
            if label == "xlstm_full":
                rec["tol_reason"] = (
                    "float32 math on both sides, summed in other orders; "
                    "bf16 pre: hs rounded to bf16 once, one ulp (2^-8) "
                    "apart at most; states float32 at 1e-5")
            if label == "xlstm_full" and dtype == torch.bfloat16:
                rec["kernel_ms"] = cuda_ms(lambda: slstm_kernel(*args))
                rec["ms_per_step"] = rec["kernel_ms"] / S
                rec["plain_ms"] = cuda_ms(lambda: slstm_scan_ref(*args),
                                          iters=3, warmup=1)
                rec["bound_ms"], rec["bound_by"] = slstm_bound(
                    B, S, H, dh, dtype)
                rec["library_ms"] = None
                rec["library_note"] = LSTM_LIBRARY_NOTE
                timed = rec
            rec["launches_so_far"] = slstm_kernel.launches
            emit(rec)
            if not ok:
                raise AssertionError(f"sLSTM kernel disagrees with its plain "
                                     f"version: {rec}")
    return timed


def sm_clock_max_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def ssm_bound(Bb, S, d, N, u_dtype, dt_dtype, sms, clock_hz):
    """Least time (ms) of the selective scan: the largest of bytes (u, dt,
    B, C, A, D and h0 read once, y and h_last written once) over HBM rate,
    ~6 fp32 operations per (t, channel, n) over the fp32 peak, and one
    exponential per (t, channel, n) over the exp unit's rate (MUFU: 16 a
    clock per SM, CUDA C++ Programming Guide, arithmetic instructions, cc
    9.0) at ``sms`` SMs and the maximum SM clock. Also returns which term
    binds ("bytes", "fp32" or "exp"), the bytes, FLOPs and exps."""
    eu = torch.finfo(u_dtype).bits // 8
    edt = torch.finfo(dt_dtype).bits // 8
    nbytes = (eu * 2 * Bb * S * d + edt * Bb * S * d + eu * 2 * Bb * S * N
              + 4 * (d * N + d) + 4 * 2 * Bb * d * N)
    exps = Bb * S * d * N
    flops = 6 * exps
    terms = {"bytes": nbytes / PEAK_BYTES_S,
             "fp32": flops / PEAK_FLOPS[torch.float32],
             "exp": exps / (EXP_PER_CLOCK_PER_SM * sms * clock_hz)}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, term, nbytes, flops, exps


def phase_ssm_check(ssm_kernel, ssm_scan_ref, seed: int):
    """K3 vs its plain version on the card; times at Jamba's full width."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # (label, Bb, S, d, N, initial state, dt float32 whatever the dtype)
    cases = [("ref_1x32_d64_n8", 1, 32, 64, 8, False, False),
             ("ref_2x64_d128_n16", 2, 64, 128, 16, False, False),
             ("ref_1x48_d256_n4", 1, 48, 256, 4, False, False),
             ("state_1x32_d64_n8", 1, 32, 64, 8, True, False),
             ("ragged_S37", 1, 37, 64, 8, False, False),
             ("ragged_S100", 2, 100, 128, 16, True, False),
             ("d200", 1, 20, 200, 16, True, False),
             ("model_dtypes", 2, 64, 256, 16, True, True),
             ("S1_n4", 2, 1, 100, 4, True, True),
             ("S513_d1000", 1, 513, 1000, 16, True, True),
             ("jamba_full", 1, 512, 8192, 16, True, True)]
    timed = None
    for dtype in (torch.float32, torch.bfloat16):
        for label, Bb, S, d, N, with_h0, dt_f32 in cases:

            def rand(*shape):
                return torch.rand(shape, generator=gen, device="cuda")

            def randn(*shape):
                return torch.randn(shape, generator=gen, device="cuda")

            dt_dtype = torch.float32 if dt_f32 else dtype
            u = randn(Bb, S, d).to(dtype)
            dt = (rand(Bb, S, d) * 0.099 + 1e-3).to(dt_dtype)
            A = -(rand(d, N) * 1.5 + 0.5)
            Bm, Cm = randn(Bb, S, N).to(dtype), randn(Bb, S, N).to(dtype)
            D = randn(d)
            h0 = randn(Bb, d, N) if with_h0 else None
            args = (u, dt, A, Bm, Cm, D, h0)
            y, h = ssm_kernel(*args)
            torch.cuda.synchronize()
            y_ref, h_ref = ssm_scan_ref(*args)
            err = (y.float() - y_ref.float()).abs().max().item()
            h_err = (h - h_ref).abs().max().item()
            ok = (bool(torch.isfinite(y).all()) and torch.allclose(
                y.float(), y_ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
                and torch.allclose(h, h_ref, atol=1e-5, rtol=1e-5))
            rec = {"phase": "ssm_check", "case": label,
                   "dtype": str(dtype).split(".")[1],
                   "dt_dtype": str(dt_dtype).split(".")[1], "Bb": Bb,
                   "S": S, "d": d, "N": N, "initial_state": with_h0,
                   "body": "ring",
                   "max_abs_err": err, "tol": TOL[dtype],
                   "state_max_abs_err": h_err, "state_tol": 1e-5, "ok": ok}
            if label == "jamba_full":
                rec["tol_reason"] = (
                    "float32 math on both sides, the sum over n in another "
                    "order; bf16 u/B/C: y rounded to bf16 once, one ulp "
                    "(2^-8) apart at most; h_last float32 at 1e-5")
            if label == "jamba_full" and dtype == torch.bfloat16:
                rec["kernel_ms"] = cuda_ms(lambda: ssm_kernel(*args))
                rec["plain_ms"] = cuda_ms(lambda: ssm_scan_ref(*args),
                                          iters=3, warmup=1)
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                clock = sm_clock_max_hz()
                rec["sms"], rec["sm_clock_max_mhz"] = sms, clock / 1e6
                (rec["bound_ms"], rec["bound_by"], rec["bound_bytes"],
                 rec["bound_flops"], rec["exps"]) = ssm_bound(
                    Bb, S, d, N, dtype, dt_dtype, sms, clock)
                rec["library_ms"] = None
                rec["library_note"] = SSM_LIBRARY_NOTE
                timed = rec
            rec["launches_so_far"] = ssm_kernel.launches
            emit(rec)
            if not ok:
                raise AssertionError(f"selective-scan kernel disagrees with "
                                     f"its plain version: {rec}")
    return timed


def gemm_bound(E, M, K, N, dtype):
    """Least time (ms) of x [E,M,K] @ w [E,K,N]: bytes (x, w and out once
    each) over HBM rate vs 2 E M K N operations over the dtype's peak."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * (E * M * K + E * K * N + E * M * N)
    flops = 2 * E * M * K * N
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_gemm_check(expert_kernel, expert_gemm_ref, body_for, seed: int):
    """K2 vs its plain version on the card; times at the main path's
    shapes (Jamba's prefill and decode, Granite's prefill) beside
    torch.bmm."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # (label, E, M, K, N); the model's capacity is round(G k 1.25 / E):
    # Jamba 80 and Granite 160 for a 512-token prompt, 4 for an 8-lane
    # decode step
    cases = [("ref_2x64x128x64", 2, 64, 128, 64),
             ("ref_4x128x256x128", 4, 128, 256, 128),
             ("ref_8x64x64x192", 8, 64, 64, 192),
             ("ragged_m70_k100_n50", 3, 70, 100, 50),
             ("ragged_m33_k77_n130", 2, 33, 77, 130),
             ("ragged_n33", 2, 17, 64, 33),
             ("m1", 4, 1, 256, 384),
             ("m4", 4, 4, 512, 256),
             ("m300", 4, 300, 512, 1024),
             ("m320", 4, 320, 1024, 512),
             ("granite_up", 32, 160, 1024, 512),
             ("granite_down", 32, 160, 512, 1024),
             ("jamba_up", 16, 80, 4096, 14336),
             ("jamba_down", 16, 80, 14336, 4096),
             ("jamba_decode_up", 16, 4, 4096, 14336)]
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, E, M, K, N in cases:
            x = torch.randn((E, M, K), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((E, K, N), generator=gen, device="cuda")
                 * K ** -0.5).to(dtype)
            out = expert_kernel(x, w)
            torch.cuda.synchronize()
            exp = expert_gemm_ref(x, w)
            err = (out.float() - exp.float()).abs().max().item()
            tol = GEMM_TOL[dtype]
            ok = (out.dtype == dtype and out.shape == (E, M, N)
                  and bool(torch.isfinite(out).all())
                  and torch.allclose(out.float(), exp.float(), atol=tol,
                                     rtol=tol))
            rec = {"phase": "gemm_check", "case": label,
                   "dtype": str(dtype).split(".")[1], "E": E, "M": M, "K": K,
                   "N": N, "body": body_for(x, w), "max_abs_err": err,
                   "tol": tol, "ok": ok}
            if label.startswith("jamba_up"):
                rec["tol_reason"] = (
                    "bf16: the same exact products summed in float32 in "
                    "another order, rounded to bf16 once, one ulp (2^-8) "
                    "apart at most; float32: another summation order over "
                    "K terms")
            if dtype == torch.bfloat16 and label in (
                    "jamba_up", "jamba_down", "jamba_decode_up",
                    "granite_up", "granite_down"):
                del out, exp
                copies = max(1, -(-L2_FLUSH_BYTES
                                  // (w.numel() * w.element_size())))
                ws = itertools.cycle([w] + [w.clone()
                                            for _ in range(copies - 1)])
                rec["weight_copies"] = copies
                rec["kernel_ms"] = cuda_ms(lambda: expert_kernel(x, next(ws)))
                rec["plain_ms"] = cuda_ms(
                    lambda: expert_gemm_ref(x, next(ws)), iters=5, warmup=1)
                rec["library_ms"] = cuda_ms(lambda: torch.bmm(x, next(ws)))
                (rec["bound_ms"], rec["bound_by"], rec["bound_bytes"],
                 rec["bound_flops"]) = gemm_bound(E, M, K, N, dtype)
                rec["kernel_bytes_per_s"] = rec["bound_bytes"] / (
                    rec["kernel_ms"] * 1e-3)
                timed[label] = rec
                del ws
            rec["launches_so_far"] = expert_kernel.launches
            emit(rec)
            if not ok:
                raise AssertionError(f"expert GEMM kernel disagrees with its "
                                     f"plain version: {rec}")
            del x, w
    torch.cuda.empty_cache()
    return timed


def decode_bound(index, Hq, Hkv, hd, dtype):
    """Least time (ms) of decode attention over lanes at positions
    ``index``: bytes (each lane's k and v up to its position, q and the
    output once) over HBM rate vs 4 Hq hd FLOP a position over the dtype's
    peak. Returns (ms, what bounds it, bytes, FLOPs)."""
    esize = torch.finfo(dtype).bits // 8
    positions = int(sum(int(i) + 1 for i in index))
    nbytes = esize * (2 * positions * Hkv * hd + 2 * len(index) * Hq * hd)
    flops = 4 * Hq * hd * positions
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


DECODE_LIBRARY = ("torch scaled_dot_product_attention, default backend, "
                  "one query a lane over the whole cache with a boolean "
                  "mask of each lane's positions (enable_gqa)")


def phase_decode_check(decode_kernel, decode_attention_ref, seed: int):
    """The decode kernel vs its plain version on the card (every head
    dim, both dtypes, GQA/MQA, window, softcap, a poisoned cache past each
    lane's position); then timed at phi4-serve-longdoc's shapes (32 lanes,
    L 8,256, 24 heads over 8, hd 128, bf16, positions log-uniform over
    1,024-8,192 as its prompts) beside its byte bound, the plain version
    and SDPA, with each bf16 split size."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import MMA_SPLITS

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    # (label, B, L, Hq, Hkv, hd, window, softcap)
    cases = [("phi4_smoke_hd16", 3, 100, 6, 2, 16, 0, 0.0),
             ("gemma_smoke_mqa_hd32", 2, 130, 4, 1, 32, 0, 0.0),
             ("gemma_mqa_hd256", 2, 300, 8, 1, 256, 0, 0.0),
             ("granite_hd64", 4, 700, 16, 8, 64, 0, 0.0),
             ("window64", 3, 300, 4, 2, 64, 64, 0.0),
             ("softcap20", 2, 200, 6, 2, 128, 0, 20.0),
             ("window_softcap", 3, 1200, 6, 2, 128, 100, 30.0),
             ("g20_two_row_tiles", 2, 300, 40, 2, 64, 0, 0.0),
             ("phi4_L8256", 4, 8256, 24, 8, 128, 0, 0.0)]
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, L, Hq, Hkv, hd, window, softcap in cases:
            q = 2 * torch.randn((B, 1, Hq, hd), generator=gen, device="cuda")
            ck, cv = (torch.randn((B, L, Hkv, hd), generator=gen,
                                  device="cuda") for _ in range(2))
            q, ck, cv = q.to(dtype), ck.to(dtype), cv.to(dtype)
            idx = rng.integers(0, L, B)
            idx[:2] = [0, L - 1]
            index = torch.as_tensor(idx, device="cuda")
            # NaN wherever a lane may not look: a read of it shows
            pos = torch.arange(L, device="cuda")[None, :]
            outside = pos > index[:, None]
            if window:
                outside |= pos <= index[:, None] - window
            pk, pv = ck.clone(), cv.clone()
            pk[outside] = float("nan")
            pv[outside] = float("nan")
            kw = dict(window=window, softcap=softcap)
            out = decode_kernel(q, pk, pv, index, **kw)
            torch.cuda.synchronize()
            exp = decode_attention_ref(q, ck, cv, index, **kw)
            err = (out.float() - exp.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and torch.allclose(
                out.float(), exp.float(), atol=TOL[dtype], rtol=TOL[dtype])
            rec = {"phase": "decode_check", "case": label,
                   "dtype": str(dtype).split(".")[1], "B": B, "L": L,
                   "Hq": Hq, "Hkv": Hkv, "hd": hd, "window": window,
                   "softcap": softcap, "max_abs_err": err,
                   "tol": TOL[dtype], "ok": ok}
            emit(rec)
            del pk, pv
            if not ok:
                raise AssertionError(f"decode kernel disagrees with its "
                                     f"plain version: {rec}")

    # the serving cell's shapes
    B, L, Hq, Hkv, hd, dtype = 32, 8256, 24, 8, 128, torch.bfloat16
    q = 2 * torch.randn((B, 1, Hq, hd), generator=gen, device="cuda")
    ck, cv = (torch.randn((B, L, Hkv, hd), generator=gen, device="cuda")
              for _ in range(2))
    q, ck, cv = q.to(dtype), ck.to(dtype), cv.to(dtype)
    idx = np.exp(rng.uniform(np.log(1024), np.log(8192), B)).astype(np.int64)
    index = torch.as_tensor(idx, device="cuda")
    out = decode_kernel(q, ck, cv, index)
    exp = decode_attention_ref(q, ck, cv, index)
    rec = {"phase": "decode_check", "case": "phi4_serve_longdoc",
           "dtype": "bfloat16", "B": B, "L": L, "Hq": Hq, "Hkv": Hkv,
           "hd": hd, "positions_mean": float(idx.mean() + 1),
           "max_abs_err": (out.float() - exp.float()).abs().max().item()}
    rec["bound_ms"], rec["bound_by"], rec["bytes"], rec["flops"] = \
        decode_bound(idx, Hq, Hkv, hd, dtype)
    rec["kernel_ms"] = cuda_ms(lambda: decode_kernel(q, ck, cv, index))
    rec["split_ms"] = {split: cuda_ms(lambda: decode_kernel(
        q, ck, cv, index, split=split)) for split in MMA_SPLITS}
    rec["kernel_gb_s"] = rec["bytes"] / rec["kernel_ms"] / 1e6
    rec["roofline_pct"] = 100.0 * rec["bound_ms"] / rec["kernel_ms"]
    rec["plain_ms"] = cuda_ms(
        lambda: decode_attention_ref(q, ck, cv, index), iters=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, ck, cv))
    mask = (torch.arange(L, device="cuda")[None, :]
            <= index[:, None])[:, None, None, :]
    rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=5)
    rec["library_note"] = DECODE_LIBRARY
    rec["ok"] = bool(torch.isfinite(out).all()) and torch.allclose(
        out.float(), exp.float(), atol=TOL[dtype], rtol=TOL[dtype])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"decode kernel at the serving shapes: {rec}")
    del q, ck, cv, qt, kt, vt, out, exp
    torch.cuda.empty_cache()
    return rec


# the body every launch of a kernel takes on the serving paths
SERVE_BODY = {"flash_attention": "wgmma", "expert_gemm": "wgmma",
              "slstm_scan": "regs", "ssm_scan": "ring",
              "decode_attention": "mma"}


def phase_serve(cfg, seed: int, lens_range, per_request: dict,
                plain_iters: int = 3):
    """Serve 16 requests of the full-width model ``cfg`` on 8 lanes; every
    prefill must launch each kernel ``per_request[name]`` times, every
    decode step the decode kernel once an attention layer (and any other
    kernel never), each always in its main-path body (``SERVE_BODY``).
    The decode steps replay CUDA graphs after one capture, whose eager
    warm-up step launches too (``decode_replay_check``). Then the
    breakdown of one prefill and one decode step. Returns the launch
    counts and the counts by body."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import ServeRequest, ServingEngine

    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = model.init(seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    lanes, max_len, n_req, max_new = 8, 1024, 16, 32

    # one full-width prefill checked on its own: finite logits, padded
    # vocab masked
    rng = np.random.default_rng(seed)
    probe = torch.as_tensor(rng.integers(0, cfg.vocab_size, 64),
                            device="cuda")[None]
    last, _ = model.prefill(params, probe, max_len=64, use_kernel=True)
    if last.shape != (1, cfg.padded_vocab):
        raise AssertionError(f"prefill logits shape {tuple(last.shape)}")
    if not bool(torch.isfinite(last[:, :cfg.vocab_size]).all()):
        raise AssertionError("non-finite prefill logits")
    if int(last.argmax()) >= cfg.vocab_size:
        raise AssertionError("argmax fell in the padded vocab")
    # warm-up: one short request through its own engine
    warm = ServingEngine(cfg, params, lanes=1, max_len=64)
    warm.run([ServeRequest(prompt=probe[0, :32].tolist(), max_new_tokens=2)])
    del warm

    lens = rng.integers(lens_range[0], lens_range[1] + 1, n_req)
    reqs = [ServeRequest(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                         max_new_tokens=max_new) for n in lens]
    engine = ServingEngine(cfg, params, lanes=lanes, max_len=max_len)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(engine.caches))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in ops.KERNELS.values():
        kernel.reset_counts()
    stats = engine.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    by_body = {name: dict(k.launches_by_body)
               for name, k in ops.KERNELS.items()}
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    expected = {name: per_request.get(name, 0) * n_req for name in counts}
    expected["decode_attention"] = (stats["decode_steps"]
                                    + stats["decode_captures"]) * attn
    want_body = {name: {body: expected[name]} if expected[name] else {}
                 for name, body in SERVE_BODY.items()}
    replay = decode_replay_check(engine, attn, SERVE_BODY["decode_attention"])
    toks = [t for r in reqs for t in r.output]
    emit({"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": n_params,
          "param_bytes": param_bytes, "dtype": cfg.dtype,
          "init_s": init_s, "init_max_memory_allocated": init_peak,
          "lanes": lanes, "max_len": max_len,
          "cache_bytes": cache_bytes, "requests": n_req,
          "prompt_len_min": int(lens.min()), "prompt_len_max": int(lens.max()),
          "prompt_tokens": int(lens.sum()), "max_new_tokens": max_new,
          **stats, "launches": counts, "launches_expected": expected,
          "launches_by_body": by_body, "decode_replay": replay,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if (stats["decode_captures"], stats["decode_replays"]) != (
            1, stats["decode_steps"]):
        raise AssertionError(
            f"{stats['decode_captures']} captures and "
            f"{stats['decode_replays']} replays of "
            f"{stats['decode_steps']} decode steps, want 1 and all")
    if counts != expected:
        raise AssertionError(f"launches {counts}, want {expected}")
    for name, want in want_body.items():
        if by_body[name] != want:
            raise AssertionError(f"{name} launches by body {by_body[name]}, "
                                 f"want {want}")
    if any(len(r.output) != max_new for r in reqs):
        raise AssertionError("a request stopped short of max_new_tokens")
    if not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError("a token outside the vocabulary")
    phase_breakdown(model, params, engine, rng, plain_iters)
    del engine, params
    torch.cuda.empty_cache()
    return counts, by_body


def decode_replay_check(engine, attn: int, body: str) -> dict:
    """One more decode step of ``engine`` (its own model, parameters and
    caches: a replay of its captured graphs) under the profiler. The
    decode kernel's launches that the replay added to its count, read from
    the graphs' nodes, and its body kernels that the profile names must
    each be ``attn``, all in ``body``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    graphs = engine.model.graphs
    captures = graphs.captures
    token = torch.zeros((engine.lanes, 1), dtype=torch.long, device="cuda")
    index = torch.as_tensor(engine.positions, device="cuda")
    before = ops.launches_by_body()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.model.decode_step(engine.params, token, engine.caches, index)
        torch.cuda.synchronize()
    counted = ops.launches_since(before).get("decode_attention", {})
    named: dict = {}
    for e in prof.events():
        m = re.search(r"decode_attn_(mma|fma)<", e.name)
        if m and e.device_type == torch.autograd.DeviceType.CUDA:
            named[m.group(1)] = named.get(m.group(1), 0) + 1
    want = {body: attn} if attn else {}
    rec = {"counted": counted, "profiled": named, "expected": want,
           "recaptured": graphs.captures != captures,
           "graph_launches": graphs.chain.launches}
    if counted != want or named != want or rec["recaptured"]:
        raise AssertionError(f"a replayed decode step: {rec}")
    return rec


def _host_ms(fn, iters: int) -> float:
    """Mean host wall time of fn() in ms, each call ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_breakdown(model, params, engine, rng, plain_iters: int):
    """Where a request's time goes: one 512-token prefill (with the kernels
    and with the model's plain paths) and one 8-lane decode step (through
    the decode kernel, as the engine runs it, and on the plain paths), on
    the host clock; the device's busy share of a kernel decode step from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, 512),
                             device="cuda")[None]
    rec = {"phase": "breakdown", "arch": cfg.name, "prefill_S": 512}
    for kernel, iters in ((True, 3), (False, plain_iters)):
        rec[f"prefill_ms_{'kernel' if kernel else 'plain'}"] = _host_ms(
            lambda: model.prefill(params, prompt, max_len=engine.max_len,
                                  use_kernel=kernel), iters)
    tokens = torch.zeros((engine.lanes, 1), dtype=torch.long, device="cuda")
    positions = torch.full((engine.lanes,), 600, device="cuda")
    # one model each, so that each captures its step once
    models = {k: dataclasses.replace(model, decode_kernel=k)
              for k in (True, False)}

    def decode(use_kernel=True):
        logits, _ = models[use_kernel].decode_step(params, tokens,
                                                   engine.caches, positions)
        return logits.argmax(dim=-1).cpu()

    rec["decode_lanes"] = engine.lanes
    rec["decode_step_ms"] = _host_ms(decode, 5)
    rec["decode_step_ms_plain"] = _host_ms(lambda: decode(False), 5)
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            decode()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    moe_block_times(model, params, rec)
    rec["profiled_steps"] = steps
    rec["profiled_wall_ms"] = wall_ms
    rec["device_busy_ms"] = device_ms
    rec["device_busy_share"] = device_ms / wall_ms if device_ms else None
    rec["device_kernels_per_step"] = sum(e.count for e in events) / steps
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    rec["top_device_kernels"] = [
        {"name": e.key[:80], "ms_per_step":
         e.self_device_time_total / 1e3 / steps, "calls_per_step":
         e.count / steps} for e in top]
    emit(rec)


def moe_block_times(model, params, rec) -> None:
    """Device time of one MoE block on a 512-token prefill's input, its
    expert products through K2 and through the einsums (the path before
    K2), and the difference over all the model's MoE layers."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import _index, _pos_name

    cfg = model.cfg
    moe_layers = [i for i in range(cfg.n_layers) if cfg.layer_is_moe(i)]
    if not moe_layers:
        return
    block = _index(params["stack"][_pos_name(moe_layers[0])], 0)["moe"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, rec["prefill_S"], cfg.d_model), generator=gen,
                    device="cuda").to(block["experts"]["w_up"].dtype)
    for kernel, name in ((True, "kernel"), (False, "einsum")):
        rec[f"moe_block_ms_{name}"] = cuda_ms(
            lambda: moe_lib.moe_apply(block, x, cfg, use_kernel=kernel),
            iters=10)
    rec["moe_layers"] = len(moe_layers)
    rec["prefill_k2_minus_einsum_ms"] = len(moe_layers) * (
        rec["moe_block_ms_kernel"] - rec["moe_block_ms_einsum"])


def phase_tokens(cfg, seed: int, plain_kernel_path: bool):
    """Engine (kernel prefill, 3 lanes) == single-stream greedy decoding of
    the model ``cfg`` (full width, cut in depth, float32). The single
    stream prefills through the plain paths (``plain_kernel_path`` False)
    or through the kernel path with the kernels' plain versions (True: the
    sLSTM preactivations are rounded to bf16 at the same point on both
    sides)."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import ServeRequest, ServingEngine

    model = build_model(cfg)
    params = model.init(seed + 1, device="cuda")
    rng = np.random.default_rng(seed + 1)
    max_len, n_new = 128, 6
    reqs = [ServeRequest(prompt=rng.integers(0, cfg.vocab_size,
                                             int(n)).tolist(),
                         max_new_tokens=n_new)
            for n in rng.integers(8, 65, 7)]
    stats = ServingEngine(cfg, params, lanes=3, max_len=max_len).run(reqs)
    mismatches = 0
    for r in reqs:
        prompt = torch.as_tensor(r.prompt, device="cuda")[None]
        if plain_kernel_path:
            with ops.plain_versions():
                last, caches = model.prefill(params, prompt, max_len=max_len,
                                             use_kernel=True)
        else:
            last, caches = model.prefill(params, prompt, max_len=max_len)
        ref = [int(last[0].argmax())]
        for i in range(n_new - 1):
            lg, caches = model.decode_step(
                params, torch.as_tensor([[ref[-1]]], device="cuda"), caches,
                len(r.prompt) + i)
            ref.append(int(lg[0].argmax()))
        mismatches += r.output != ref
    emit({"phase": "tokens", "arch": cfg.name, "n_layers": cfg.n_layers,
          "layer_kinds": [cfg.layer_kind(i) for i in range(cfg.n_layers)],
          "moe_layers": [i for i in range(cfg.n_layers)
                         if cfg.layer_is_moe(i)],
          "params": sum(t.numel() for t in _leaves(params)),
          "dtype": cfg.dtype, "requests": len(reqs),
          "tokens_each": n_new, "engine_launches": {
              k: v for k, v in stats.items() if k.endswith("_launches")},
          "mismatched_requests": mismatches})
    del params
    torch.cuda.empty_cache()
    if mismatches:
        raise AssertionError(f"{mismatches} requests differ from "
                             "single-stream greedy decoding")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# the card's dense bf16 peak (H100 SXM data sheet), the model-FLOP share's
# yardstick
TRAIN_PEAK = ("H100 SXM dense bf16", PEAK_FLOPS[torch.bfloat16])
# train_check: the card's and the CPU's float32 steps agree in loss and grad
# norm to 1e-4 relative (matmuls sum in another order: 7.5e-8 measured on
# the H100), and in every parameter to 5e-5. Two steps at lr 1e-4 move a
# parameter by up to 2e-4; Adam's normalised update is ~±1 wherever the
# gradient is not tiny, but an element whose gradient is near the rounding
# noise of its sums may move differently on the two devices (9.2e-6
# measured, full-width phi4 at 2 layers)
TRAIN_CHECK_RTOL, TRAIN_CHECK_PARAM_TOL = 1e-4, 5e-5


def train_flops(cfg, batch: int, seq: int, n_params: int) -> dict:
    """Model FLOPs of one train step: 6 x active parameters x tokens for
    the weight matmuls (forward and backward; an MoE layer's active experts
    are its top-k, not every expert over its capacity as the einsum path
    computes them), plus the attention score products QK^T and PV over
    every (query, key) pair the plain path computes, three times over for
    forward and backward (12 L B S^2 Hq hd, PaLM's count). Recomputation
    under remat is not counted."""
    tokens = batch * seq
    m, d = cfg.moe, cfg.d_model
    nmat = 3 if cfg.act in ("swiglu", "geglu") else 2
    idle_experts = sum(nmat * d * m.d_expert * (m.n_experts - m.top_k)
                       for i in range(cfg.n_layers) if cfg.layer_is_moe(i))
    attn_layers = sum(cfg.layer_kind(i) == "attn"
                      for i in range(cfg.n_layers))
    active = n_params - idle_experts
    dense = 6 * active * tokens
    attn = 12 * attn_layers * batch * seq * seq * cfg.n_heads * (
        cfg.resolved_head_dim)
    return {"tokens": tokens, "active_params": active,
            "weight_flops": dense, "attention_flops": attn,
            "flops": dense + attn}


def _samples(params, n: int = 1 << 20) -> list:
    """Up to n evenly spaced elements of every leaf, copied: enough to see
    which leaves a step changed without a second copy of the model."""
    out = []
    for t in _leaves(params):
        flat = t.detach().reshape(-1)
        out.append(flat[::max(1, flat.numel() // n)].clone())
    return out


def _changed(params, before) -> dict:
    """Share of the sampled elements that changed, by leaf dtype."""
    moved, total = {}, {}
    for t, b in zip(_leaves(params), before):
        flat = t.detach().reshape(-1)
        now = flat[::max(1, flat.numel() // (1 << 20))]
        key = str(t.dtype).split(".")[1]
        moved[key] = moved.get(key, 0) + int((now != b).sum())
        total[key] = total.get(key, 0) + b.numel()
    return {k: moved[k] / total[k] for k in total}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_train_check(cfg, seed: int, device="cuda"):
    """Two float32 train steps of ``cfg`` on ``device`` (the card) and on
    the CPU from the same weights and batches: loss, grad norm and every
    parameter agree."""
    from repro_torch.configs import RunConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.steps import build_train_step, init_train_state

    run = RunConfig(model=cfg, seq_len=128, global_batch=2, seed=seed,
                    learning_rate=1e-4, warmup_steps=1, total_steps=10)
    source = SyntheticTokens(cfg.vocab_size, run.seq_len, run.global_batch,
                             seed=seed)
    gpu = init_train_state(cfg, run, device)
    cpu = {"params": {k: _to_cpu(v) for k, v in gpu["params"].items()}}
    cpu["opt"] = type(gpu["opt"])(*(_to_cpu(x) for x in gpu["opt"]))
    steps = {"device": build_train_step(cfg, run=run, device=device),
             "cpu": build_train_step(cfg, run=run, device="cpu")}
    rec = {"phase": "train_check", "arch": cfg.name,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "B": run.global_batch, "S": run.seq_len, "steps": []}
    for i in range(2):
        batch = source.batch_at(i)
        t0 = time.perf_counter()
        gpu, mg = steps["device"](gpu, batch)
        _sync(device)
        t1 = time.perf_counter()
        cpu, mc = steps["cpu"](cpu, batch)
        t2 = time.perf_counter()
        rec["steps"].append({k: (float(mg[k]), float(mc[k])) for k in (
            "loss", "grad_norm", "lr")} | {"device_s": t1 - t0,
                                           "cpu_s": t2 - t1})
    param_err = max(float((a.detach().float().cpu() - b.detach().float())
                          .abs().max())
                    for a, b in zip(_leaves(gpu["params"]),
                                    _leaves(cpu["params"])))
    rel = max(abs(g - c) / abs(c) for st in rec["steps"]
              for g, c in (st["loss"], st["grad_norm"]))
    ok = rel <= TRAIN_CHECK_RTOL and param_err <= TRAIN_CHECK_PARAM_TOL
    rec.update({"max_rel_err_loss_grad_norm": rel, "rtol": TRAIN_CHECK_RTOL,
                "max_abs_param_err": param_err,
                "param_tol": TRAIN_CHECK_PARAM_TOL, "ok": ok})
    emit(rec)
    del gpu, cpu
    _empty_cache(device)
    if not ok:
        raise AssertionError(f"train step on the card disagrees with the "
                             f"CPU: {rec}")


def _empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def phase_train(cfg, seed: int, steps: int, device="cuda", run=None):
    """Train ``cfg`` for ``steps`` steps at RunConfig's defaults (seq 512,
    batch 8, lr 3e-4 with 100 warmup steps) through launch/train.py's loop,
    batches from TokenPipeline over SyntheticTokens. Fails on a non-finite
    loss, a grad norm <= 0, a parameter dtype none of whose sampled
    elements changed, or any kernel launch (training is forward-only for
    the kernels: plain paths)."""
    from repro_torch.configs import RunConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_train_state
    from repro_torch.launch.train import train

    run = run or RunConfig(model=cfg, seed=seed)
    cuda = torch.device(device).type == "cuda"
    t0 = time.time()
    state = init_train_state(cfg, run, device)
    _sync(device)
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(state["params"]))
    moment_bytes = 2 * sum(t.numel() * t.element_size()
                           for t in _leaves(state["opt"].m))
    before = _samples(state["params"])
    flops = train_flops(cfg, run.global_batch, run.seq_len, n_params)
    records = []

    def on_step(step, metrics, ms):
        rec = {"step": step + 1, "ms": ms, **{
            k: float(metrics[k]) for k in ("loss", "ce", "aux", "grad_norm",
                                           "lr")}}
        rec["tokens_per_s"] = flops["tokens"] / (ms / 1e3)
        rec["model_flop_share"] = flops["flops"] / (ms / 1e3) / TRAIN_PEAK[1]
        records.append(rec)

    for kernel in ops.KERNELS.values():
        kernel.reset_counts()
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state, losses = train(cfg, run, steps, device=device,
                          log_every=steps + 1, on_step=on_step, state=state)
    _sync(device)
    launches = ops.launch_counts()
    changed = _changed(state["params"], before)
    source_batch = SyntheticTokens(cfg.vocab_size, run.seq_len,
                                   run.global_batch,
                                   seed=run.seed).batch_at(steps)
    breakdown = train_breakdown(cfg, run, state, source_batch, device)
    later = records[1:]
    rec = {"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": n_params, "dtype": cfg.dtype,
           "remat": cfg.remat, "batch": run.global_batch,
           "seq_len": run.seq_len, "init_s": init_s,
           "param_bytes": param_bytes, "grad_bytes": param_bytes,
           "moment_bytes": moment_bytes, "steps": records,
           "ms_after_first": (sum(r["ms"] for r in later) / len(later)
                              if later else None),
           "tokens_per_s_after_first": (
               sum(r["tokens_per_s"] for r in later) / len(later)
               if later else None),
           **flops, "peak_flops_name": TRAIN_PEAK[0],
           "peak_flops": TRAIN_PEAK[1],
           "model_flop_share_after_first": (
               sum(r["model_flop_share"] for r in later) / len(later)
               if later else None),
           "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                    if cuda else None),
           "changed_share_by_dtype": changed, "launches": launches,
           "breakdown": breakdown}
    emit(rec)
    del state
    _empty_cache(device)
    bad = [r for r in records if not (math.isfinite(r["loss"])
                                      and r["grad_norm"] > 0
                                      and math.isfinite(r["grad_norm"]))]
    if bad or len(records) != steps:
        raise AssertionError(f"train steps {bad or records}")
    if not changed or not all(share > 0 for share in changed.values()):
        raise AssertionError(f"parameters of some dtype unchanged: "
                             f"{changed}")
    if any(launches.values()):
        raise AssertionError(f"kernel launches while training: {launches}")
    return rec


def train_breakdown(cfg, run, state, batch, device) -> dict:
    """One more step of ``build_train_step`` under torch.profiler, split by
    the step's own ranges (``STEP_RANGES``: forward with the loss, backward,
    AdamW): each range's host interval and, on the card, the device time of
    the kernels launched inside it. A kernel is placed by its launch, the
    runtime call (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) that shares
    its correlation id: the backward's launches come from autograd's own
    thread, inside the main thread's backward range. (The op that encloses
    a launch is no guide: ops of the two threads can share an id, and a
    kernel is then listed under both.) Also the whole step's wall time, the
    device's busy time and share, and its largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import (STEP_RANGES, batch_to,
                                          build_train_step)

    cuda = torch.device(device).type == "cuda"
    step = build_train_step(cfg, run=run, device=device)
    batch = batch_to(batch, device)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = {e.name.split(".")[-1]: e.time_range for e in host
             if e.name in STEP_RANGES}
    rec = {"ranges": {name: {"host_ms": span.elapsed_us() / 1e3}
                      for name, span in spans.items()},
           "profiled_wall_ms": wall_ms}
    if not cuda:
        return rec
    launched_at = {e.id: e.time_range.start for e in host
                   if e.name.startswith("cu")}
    kernels = [e for e in events if e.device_type != DeviceType.CPU
               and not e.is_user_annotation]
    by_range, by_name = {}, {}
    for k in kernels:
        t = launched_at.get(k.id)
        where = next((name for name, span in spans.items()
                      if t is not None and span.start <= t <= span.end),
                     "outside")
        ms = k.time_range.elapsed_us() / 1e3
        by_range[where] = by_range.get(where, 0.0) + ms
        calls, total = by_name.get(k.name, (0, 0.0))
        by_name[k.name] = (calls + 1, total + ms)
    for name in spans:
        rec["ranges"][name]["device_ms"] = by_range.get(name, 0.0)
    device_ms = sum(by_range.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    rec.update({
        "device_ms_outside_ranges": by_range.get("outside", 0.0),
        "device_busy_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if device_ms else None,
        "device_kernels": len(kernels),
        "top_device_kernels": [{"name": name[:80], "ms": ms, "calls": calls}
                               for name, (calls, ms) in top]})
    return rec


def phase_checkpoint(cfg, seed: int, device="cuda"):
    """Save a train state of ``cfg`` (after one step: nonzero moments) from
    the card with CheckpointManager, wait, restore into a fresh state on
    the card: every leaf bit-equal, every manifest digest the leaf's."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.checkpoint import _digest, _to_host
    from repro_torch.configs import RunConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.tree import leaves

    run = RunConfig(model=cfg, seq_len=64, global_batch=2, seed=seed)
    state = init_train_state(cfg, run, device)
    state, _ = build_train_step(cfg, run=run, device=device)(
        state, SyntheticTokens(cfg.vocab_size, 64, 2, seed=seed).batch_at(0))
    fresh = init_train_state(cfg, RunConfig(model=cfg, seed=seed + 1), device)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        mgr = CheckpointManager(d)
        t0 = time.perf_counter()
        mgr.save(1, state, extra={"step": 1})
        save_s = time.perf_counter() - t0
        mgr.wait()
        restored, extra = mgr.restore(fresh)
        manifest = json.loads((Path(d) / "step_00000001" / "MANIFEST.json")
                              .read_text())
    mismatched = sum(not torch.equal(a, b) or a.dtype != b.dtype
                     for a, b in zip(leaves(state), leaves(restored)))
    bad_digests = sum(_digest(_to_host(t)[0]) != m["digest"]
                      for t, m in zip(leaves(restored), manifest["leaves"]))
    on_device = all(t.device.type == torch.device(device).type
                    for t in leaves(restored))
    rec = {"phase": "checkpoint", "arch": cfg.name,
           "leaves": len(manifest["leaves"]),
           "bytes": sum(t.numel() * t.element_size() for t in leaves(state)),
           "dtypes": sorted({m["dtype"] for m in manifest["leaves"]}),
           "save_call_s": save_s, "extra": extra,
           "mismatched_leaves": mismatched, "bad_digests": bad_digests,
           "restored_on_device": on_device}
    emit(rec)
    if mismatched or bad_digests or not on_device or extra != {"step": 1}:
        raise AssertionError(f"checkpoint round trip: {rec}")



def _reset_launches() -> None:
    from repro_torch.kernels import ops

    for kernel in ops.KERNELS.values():
        kernel.reset_counts()


def _launches() -> tuple:
    """({kernel: launches since the reset}, {kernel: {body: launches}})."""
    from repro_torch.kernels import ops

    return ops.launch_counts(), {name: dict(k.launches_by_body)
                                 for name, k in ops.KERNELS.items()}


def _check_no_launches(phase: str) -> dict:
    counts, _ = _launches()
    if any(counts.values()):
        raise AssertionError(f"{phase}: kernel launches {counts}; the path "
                             "runs no kernel")
    return counts


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bits (NaNs and signed zeros included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a.cpu(), b.cpu())


@contextlib.contextmanager
def _timed_checkpoint_io(into: dict):
    """Sum the seconds checkpoint.py spends copying leaves to the host and
    writing step directories, into ``into["host_copy_s"]`` and
    ``into["write_s"]`` (the write includes the digests)."""
    from repro_torch.checkpoint import checkpoint as mod

    originals = {"host_copy_s": ("_to_host", mod._to_host),
                 "write_s": ("_write", mod._write)}

    def timed(key, fn):
        def wrapper(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                into[key] = into.get(key, 0.0) + time.perf_counter() - t0
        return wrapper

    for key, (attr, fn) in originals.items():
        setattr(mod, attr, timed(key, fn))
    try:
        yield into
    finally:
        for attr, fn in originals.values():
            setattr(mod, attr, fn)


# fault: steps, checkpoint period, and the slice that fails at which step
FAULT_STEPS, FAULT_EVERY, FAULT_AT, FAULT_SLICE = 8, 4, 6, 2


def phase_fault(cfg, seed: int, device="cuda", batch: int = 8,
                seq: int = 512):
    """TrainSupervisor around build_train_step: FAULT_STEPS steps with a
    checkpoint every FAULT_EVERY (synchronous writes, keep 2, into a
    temporary directory under build/ that is removed after), slice
    FAULT_SLICE of 4 failing at step FAULT_AT. The supervised run must
    report 1 failure, 1 restore, remeshes [(FAULT_EVERY, 3)] and final
    step FAULT_STEPS, and end bit-equal to FAULT_STEPS uninterrupted steps
    from the same state. Both runs under torch.use_deterministic_algorithms
    (this phase only; CUBLAS_WORKSPACE_CONFIG is set before CUDA starts).
    Returns the supervised run's final state and a batch for compress."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import RunConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                         TrainSupervisor)
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.tree import leaves, map_tree

    t_phase = time.perf_counter()
    run = RunConfig(model=cfg, seq_len=seq, global_batch=batch, seed=seed,
                    learning_rate=1e-3, warmup_steps=2,
                    total_steps=FAULT_STEPS)
    source = SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed)
    _reset_launches()
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    io = {}
    try:
        step_fn = build_train_step(cfg, run=run, device=device)
        state = init_train_state(cfg, run, device)
        ref = map_tree(lambda t: t.detach().clone(), state)
        step_ms = []
        for s in range(FAULT_STEPS):
            _sync(device)
            t0 = time.perf_counter()
            ref, _ = step_fn(ref, source.batch_at(s))
            _sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)

        def train_fn(st, step):
            return step_fn(st, source.batch_at(step))[0]

        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            free = shutil.disk_usage(d).free
            mgr = CheckpointManager(d, keep=2, async_write=False)
            saves, restores = [], []
            save, restore = mgr.save, mgr.restore

            def timed_save(step, tree, extra=None):
                part = {}
                with _timed_checkpoint_io(part):
                    t0 = time.perf_counter()
                    save(step, tree, extra)
                saves.append({"step": step,
                              "s": time.perf_counter() - t0, **part})

            def timed_restore(tree_like, step=None):
                t0 = time.perf_counter()
                out = restore(tree_like, step)
                _sync(device)
                restores.append({"step": out[1].get("step"),
                                 "s": time.perf_counter() - t0})
                return out

            mgr.save, mgr.restore = timed_save, timed_restore
            mon = HeartbeatMonitor(n_slices=4)
            for i in range(4):
                mon.beat(i)
            sup = TrainSupervisor(mgr, mon, global_batch=batch,
                                  checkpoint_every=FAULT_EVERY)
            fails = {FAULT_AT: FAULT_SLICE}
            state, report = sup.run(
                state, train_fn, 0, FAULT_STEPS,
                failure_injector=lambda s: fails.pop(s, None))
            kept = sorted(p.name for p in Path(d).glob("step_*"))
            disk_bytes = sum(f.stat().st_size for f in
                             (Path(d) / kept[-1]).iterdir())
    finally:
        torch.use_deterministic_algorithms(deterministic)
    launches = _check_no_launches("fault")
    pairs = list(zip(leaves(state), leaves(ref)))
    mismatched = [i for i, (a, b) in enumerate(pairs) if not _bit_equal(a, b)]
    n_params = sum(t.numel() for t in leaves(state["params"]))
    rec = {"phase": "fault", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": n_params, "dtype": cfg.dtype, "batch": batch,
           "seq_len": seq, "steps": FAULT_STEPS,
           "checkpoint_every": FAULT_EVERY, "fail_slice": FAULT_SLICE,
           "fail_at": FAULT_AT, "deterministic": True,
           "cublas_workspace_config": os.environ.get(
               "CUBLAS_WORKSPACE_CONFIG"),
           "free_disk_bytes_before": free,
           "checkpoint_bytes": sum(t.numel() * t.element_size()
                                   for t in leaves(state)),
           "checkpoint_disk_bytes": disk_bytes, "kept": kept,
           "saves": saves, "restores": restores,
           "uninterrupted_step_ms": step_ms,
           "report": dataclasses.asdict(report),
           "leaves": len(pairs), "mismatched_leaves": mismatched,
           "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    emit(rec)
    del ref
    _empty_cache(device)
    want = (1, 1, [(FAULT_EVERY, 3)], FAULT_STEPS)
    got = (report.failures, report.restores, report.remeshes,
           report.final_step)
    if got != want or mismatched:
        raise AssertionError(f"fault: report {got}, want {want}; "
                             f"{len(mismatched)} leaves differ from the "
                             "uninterrupted run")
    return state, source.batch_at(FAULT_STEPS)


def compress_bytes(grads) -> int:
    """Bytes one compression call must move: each compressible leaf's
    gradient and float32 error read once, its float32 output and new
    error written once (passthrough leaves move nothing)."""
    from repro_torch.distributed.compression import _is_compressible
    from repro_torch.tree import leaves

    return sum(g.numel() * (g.element_size() + 12)
               for g in leaves(grads) if _is_compressible(g))


def phase_compress(cfg, params, batch, seed: int, device="cuda",
                   k_fraction: float = 0.05, rounds: int = 20,
                   leaf_shape=(3072, 8192)):
    """int8_compress and topk_compress (k_fraction) with error feedback
    over the gradient tree of ``params`` (one loss and backward on
    ``batch``): a second round (carrying the first round's error) on the
    card and on the CPU from the same tensors, bit-equal, error state
    too; the card's ms a call beside the bytes bound. Then the reference
    test's error-feedback property over ``rounds`` rounds on one leaf of
    ``leaf_shape`` (Phi-4-mini's w_up), and top-k's kept share on a leaf
    of that shape with no ties."""
    from repro_torch.distributed.compression import (init_error_state,
                                                     int8_compress,
                                                     topk_compress)
    from repro_torch.launch.steps import batch_to
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, map_tree, unflatten

    t_phase = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    _reset_launches()
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, _ = build_model(cfg).loss(params, batch_to(batch, device))
    grads = torch.autograd.grad(loss, ps)
    for p in ps:
        p.requires_grad_(False)
    del loss
    grads = unflatten(params, [g.detach() for g in grads])
    host = map_tree(lambda g: g.to("cpu"), grads)
    nbytes = compress_bytes(grads)
    rec = {"phase": "compress", "arch": cfg.name, "n_layers": cfg.n_layers,
           "elements": sum(g.numel() for g in leaves(grads)),
           "grad_dtypes": sorted({str(g.dtype).split(".")[1]
                                  for g in leaves(grads)}),
           "k_fraction": k_fraction, "bytes": nbytes,
           "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
           "compressors": {}}
    ok = True
    for name, fn in (("int8", int8_compress),
                     ("topk", lambda g, e: topk_compress(g, k_fraction, e))):
        _, err1 = fn(grads, None)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        out, err = fn(grads, err1)
        _sync(device)
        peak = torch.cuda.max_memory_allocated() - base if cuda else None
        ms = (cuda_ms(lambda: fn(grads, err1), iters=5, warmup=1) if cuda
              else None)
        # the CPU's second round from the same gradients and carried error
        cerr1 = map_tree(lambda e: None if e is None else e.to("cpu"), err1)
        t0 = time.perf_counter()
        cout, cerr = fn(host, cerr1)
        cpu_s = time.perf_counter() - t0
        diff = [i for i, (a, b) in enumerate(zip(
            leaves(out) + leaves(err), leaves(cout) + leaves(cerr)))
            if (a is None) != (b is None)
            or (a is not None and not _bit_equal(a, b))]
        kept = sum(int((o != 0).sum()) for o, e in zip(leaves(out),
                                                       leaves(err))
                   if e is not None)
        rec["compressors"][name] = {
            "ms": ms, "peak_extra_bytes": peak, "cpu_s": cpu_s,
            "leaves_differing_from_cpu": diff,
            "nonzero_share": kept / sum(g.numel() for g, e in zip(
                leaves(grads), leaves(err)) if e is not None)}
        ok = ok and not diff
        del out, err, err1, cout, cerr, cerr1
        _empty_cache(device)
    # the reference's error-feedback property on one full-width leaf
    gen = torch.Generator(device=device).manual_seed(seed)
    err = init_error_state({"w_up": torch.zeros(leaf_shape, device=device)})
    true_sum = torch.zeros(leaf_shape, device=device)
    comp_sum = torch.zeros(leaf_shape, device=device)
    for _ in range(rounds):
        g = torch.randn(leaf_shape, generator=gen, device=device)
        true_sum += g
        dq, err = int8_compress({"w_up": g}, err)
        comp_sum += dq["w_up"]
    resid = float((true_sum - comp_sum).abs().max())
    scale = float(true_sum.abs().max())
    # top-k's kept share on a leaf with no ties: distinct magnitudes (the
    # float32 bit patterns from 1.0 upward, permuted), random signs
    n = true_sum.numel()
    mag = (torch.randperm(n, generator=gen, device=device, dtype=torch.int32)
           + 0x3F800000).view(torch.float32)
    sign = torch.randint(0, 2, (n,), generator=gen, device=device) * 2 - 1
    leaf = (mag * sign).reshape(leaf_shape)
    kept, _ = topk_compress({"w_up": leaf}, k_fraction)
    share = float((kept["w_up"] != 0).float().mean())
    ties = n - int(torch.unique(leaf.abs()).numel())
    rec.update({"feedback_leaf": list(leaf_shape), "rounds": rounds,
                "feedback_resid": resid, "feedback_scale": scale,
                "feedback_limit": 0.05 * scale + 0.1,
                "topk_kept_share": share, "topk_leaf_ties": ties,
                "launches": _check_no_launches("compress"),
                "phase_s": time.perf_counter() - t_phase})
    emit(rec)
    if not ok:
        raise AssertionError("compress: the card and the CPU differ")
    if not resid < 0.05 * scale + 0.1:
        raise AssertionError(f"compress: error feedback lost the sum "
                             f"({resid} against {scale})")
    if not share <= k_fraction + 0.01:
        raise AssertionError(f"compress: top-k kept {share}")


def phase_train_lm(device="cuda"):
    """The port's examples/train_lm.py (200 steps of the phi4 smoke
    config, slice 1 failing at step 120); it raises unless the loss fell
    and one restore happened."""
    from repro_torch.examples import train_lm

    _reset_launches()
    res = train_lm.main(["--device", str(device)])
    report = res["report"]
    emit({"phase": "train_lm", "steps": train_lm.STEPS,
          "loss_first10": res["first"], "loss_last10": res["last"],
          "seconds": res["seconds"], "report": dataclasses.asdict(report),
          "launches": _check_no_launches("train_lm")})


def phase_dispatch(device="cuda"):
    """The port's dispatch benchmark: t_s, the utilisation rows with the
    kernels a task launches, the fit over queued dispatches; the
    near-zero-work task through TorchDispatchExecutor 300 times; and one
    raising payload, which must land in ``errors`` with ok=False."""
    from repro_torch.bench import dispatch_latency as dl
    from repro_torch.core.executor import TorchDispatchExecutor
    from repro_torch.core.job import Task

    dev = torch.device(device)
    _reset_launches()
    fit = dl.fit_dispatch_latency(dev)
    ex = dl.executor_latency(dev, 300)
    t_s, rows = dl.run(dev, quiet=True)   # last: it ends in profiling
    zero = dl.launches_per_task(*dl._work_fn(0, dev), dev)

    def boom():
        raise RuntimeError("payload fails")

    executor, outcomes = TorchDispatchExecutor(), []
    executor.run(Task(0, 0, payload=boom), outcomes.append)
    raised = outcomes == [False] and isinstance(executor.errors.get((0, 0)),
                                                RuntimeError)
    emit({"phase": "dispatch", "t_s_us": t_s * 1e6,
          "zero_work_kernel": "torch.neg over 128 x 128 float32",
          "zero_work_launches": zero, "rows": rows,
          "fit": {"t_s_us": fit.t_s * 1e6, "alpha_s": fit.alpha_s,
                  "r2": fit.r2, "n": fit.n_values},
          "executor": {**ex, "mean_us": ex["mean_s"] * 1e6},
          "raising_payload_recorded": raised,
          "launches": _check_no_launches("dispatch")})
    if ex["ok"] != ex["tasks"] or ex["errors"] or not raised:
        raise AssertionError(f"dispatch executor: {ex}, raised {raised}")
    if dev.type == "cuda" and (zero != 1 or any(
            r["launches_per_task"] != 2 * r["flops_scale"] for r in rows)):
        raise AssertionError(f"dispatch: launches per task {zero}, "
                             f"{[r['launches_per_task'] for r in rows]}")


# scheduler: the port's scheduler core, on the host and dispatching to the
# card. Golden virtual-time numbers of the reference's scheduler (its
# examples/quickstart.py and the table9_rapid_slurm regime of its
# benchmarks/sched_throughput.py); tests/test_torch_scheduler.py holds
# each against the reference's own output.
SCHED_GOLDEN = {
    "quickstart_direct": (3604.2362706283807, 0.06658830941683998),
    "quickstart_bundled": (253.40171463872, 0.9471127704963359),
    "fit_n": [4, 8, 48, 240],
    "fit_dt": [19.252352955080767, 27.486208159201112, 315.33694064652695,
               3364.2362706283807],
    "fit": (2.418318915347401, 1.296159686055292, 0.9892134518297224),
    "table9_rapid_slurm_makespan_s": 3603.806870628357,
}
# the fit goes through LAPACK's least squares, whose last bits may differ
# between builds; every other golden number is plain float arithmetic
SCHED_FIT_RTOL = 1e-12
SCHED_SLOTS = 16
SCHED_SCALES = (1, 16)          # the dispatch benchmark's task, x1 and x16
SCHED_TASKS = 2048
SCHED_K1_TASKS = 256
# phi4's prefill attention: B, S, Hq, Hkv, hd (bf16, causal)
SCHED_K1_SHAPE = (1, 512, 24, 8, 128)


def _timed_executor():
    """A ``TorchDispatchExecutor`` that records, in ``lat``, the host
    seconds from each task's start to its completion callback (payload,
    dispatch and the device wait), so the rest of a run's wall time is the
    scheduler's."""
    from repro_torch.core.executor import TorchDispatchExecutor

    class Timed(TorchDispatchExecutor):
        def __init__(self):
            super().__init__()
            self.lat = []

        def run(self, task, done):
            t0 = time.perf_counter()

            def timed_done(ok):
                self.lat.append(time.perf_counter() - t0)
                done(ok)
            super().run(task, timed_done)
    return Timed()


def _schedule(payloads, bundled: bool, max_restarts: int = 0,
              attach=None):
    """One job of ``payloads`` through the port's Scheduler on
    ``SCHED_SLOTS`` one-slot nodes, direct or ``aggregate``d into at most
    one bundle a slot: (executor, job, scheduler, wall seconds).
    ``attach(scheduler)`` installs an observer before the submit."""
    from repro_torch.core import (FAMILIES, Job, ResourceManager, Scheduler,
                                  aggregate)

    rm = ResourceManager()
    rm.add_nodes(SCHED_SLOTS, slots=1)
    ex = _timed_executor()
    sched = Scheduler(rm, profile=FAMILIES["inproc"], executor=ex)
    if attach is not None:
        attach(sched)
    job = Job.array(len(payloads), payloads=payloads)
    job.max_restarts = max_restarts
    if bundled:
        job = aggregate(job, slots=SCHED_SLOTS)
    t0 = time.perf_counter()
    sched.submit(job)
    sched.run()
    return ex, job, sched, time.perf_counter() - t0


def _task_outputs(ex, job, bundled: bool) -> list:
    """Every original task's output in task order (a bundle's result is
    the list of its tasks' outputs); raises unless every task completed."""
    states = {t.state.value for t in job.tasks}
    if states != {"completed"} or ex.errors:
        raise AssertionError(f"scheduler: task states {states}, errors "
                             f"{ex.errors}")
    outs = [ex.results[t.key] for t in job.tasks]
    return [o for b in outs for o in b] if bundled else outs


def _on(dev, outs) -> bool:
    return all(isinstance(o, torch.Tensor) and o.device.type == dev.type
               for o in outs)


def sched_golden() -> dict:
    """The quickstart's direct and bundled T_total and U, its model fit and
    the table9_rapid_slurm makespan, on this host; raises unless each
    equals its constant."""
    from repro_torch.bench import sched_throughput
    from repro_torch.examples import quickstart

    g = SCHED_GOLDEN
    regime = next(r for r in sched_throughput.FIFO_REGIMES
                  if r[0] == "table9_rapid_slurm")
    t0 = time.perf_counter()
    ns, dts, fit = quickstart.model_fit()
    got = {"quickstart_direct": quickstart.run(False),
           "quickstart_bundled": quickstart.run(True),
           "fit_n": ns, "fit_dt": dts,
           "fit": (fit.t_s, fit.alpha_s, fit.r2),
           "table9_rapid_slurm_makespan_s": sched_throughput.run_regime(
               *regime)["virtual_makespan_s"]}
    equal = {k: got[k] == g[k] for k in g if k != "fit"}
    equal["fit"] = all(abs(a - b) <= SCHED_FIT_RTOL * abs(b)
                       for a, b in zip(got["fit"], g["fit"]))
    if not all(equal.values()):
        raise AssertionError(f"scheduler golden numbers: {got} against "
                             f"{g}")
    return {**got, "equal": equal, "seconds": time.perf_counter() - t0}


def _sched_runs(dev, payloads, modes, want=None, rounds: int = 2):
    """Each of ``modes`` ("aggregated": the payloads queued back to back
    outside the scheduler, one wait; "direct" and "bundled" through
    ``_schedule``), ``rounds`` times in turns, the order reversed every
    other round, so a drift of the host's speed falls on all alike; the
    hooks ``before(mode)``/``after(mode, rec)`` of ``modes`` frame each
    run. The first payload runs once before, untimed. Each run's outputs
    are held against ``want`` (by default the first run's) bit for bit and
    then dropped, so later runs allocate no new device memory. Returns
    {mode: [one record a run]}."""
    recs = {m: [] for m in modes}
    payloads[0]()           # first call at these shapes: not timed
    for r in range(rounds):
        for mode in (list(modes) if r % 2 == 0 else list(modes)[::-1]):
            before, after = modes[mode]
            before()
            if mode == "aggregated":
                t0 = time.perf_counter()
                res = [p() for p in payloads]
                _sync(dev)
                rec = {"wall_s": time.perf_counter() - t0}
            else:
                ex, job, sched, wall = _schedule(payloads,
                                                 mode == "bundled")
                res = _task_outputs(ex, job, mode == "bundled")
                lat = sorted(ex.lat)
                rec = {"wall_s": wall, "scheduled_tasks": sched.dispatched,
                       "executor_s": sum(lat),
                       "host_us_a_task":
                           (wall - sum(lat)) / sched.dispatched * 1e6,
                       "task_ms_p50": lat[len(lat) // 2] * 1e3,
                       "task_ms_max": lat[-1] * 1e3}
            after(mode, rec)
            want = res if want is None else want
            rec["on_device"] = _on(dev, res)
            rec["bit_equal"] = len(res) == len(want) == len(payloads) and \
                all(_bit_equal(a, b) for a, b in zip(res, want))
            recs[mode].append(rec)
            del res
    return recs


def _mean(recs, key):
    return sum(r[key] for r in recs) / len(recs)


def _none(*_):
    pass


def sched_dispatch(dev, scale: int, n_tasks: int, t_s: float,
                   seed: int) -> dict:
    """``n_tasks`` dispatch tasks (the dispatch benchmark's task at
    ``scale``, each on its own seeded 128 x 128 input) queued back to back
    (t, the task's time), and through the Scheduler and
    TorchDispatchExecutor direct and bundled, in turns: wall s, tasks/s,
    the scheduler's host us a scheduled task, U = n t / T against the
    paper's 1 / (1 + t_s / t); every output bit-equal across the runs."""
    from repro_torch.bench import dispatch_latency as dl

    step, _ = dl._work_fn(scale, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn((n_tasks, dl.D, dl.D), generator=gen, device=dev) \
        * dl.D ** -0.5
    payloads = [lambda i=i: step(xs[i]) for i in range(n_tasks)]
    modes = {m: (_none, _none) for m in ("aggregated", "direct", "bundled")}
    recs = _sched_runs(dev, payloads, modes)
    t_task = _mean(recs["aggregated"], "wall_s") / n_tasks
    rec = {"scale": scale, "tasks": n_tasks, "slots": SCHED_SLOTS,
           "rounds": len(recs["direct"]),
           "t_task_aggregated_us": t_task * 1e6,
           "runs": recs}
    for mode in ("direct", "bundled"):
        wall = _mean(recs[mode], "wall_s")
        rec[mode] = {"wall_s": wall, "tasks_per_s": n_tasks / wall,
                     "host_us_a_task": _mean(recs[mode], "host_us_a_task"),
                     "U": n_tasks * t_task / wall}
    # the paper's law with t_s = eager dispatch's, and with the
    # scheduler's host time a task added to it
    rec["model_U_dispatch"] = 1.0 / (1.0 + t_s / t_task)
    rec["model_U_scheduler"] = 1.0 / (
        1.0 + (t_s + rec["direct"]["host_us_a_task"] * 1e-6) / t_task)
    runs = [r for m in recs.values() for r in m]
    rec["outputs_on_device"] = all(r["on_device"] for r in runs)
    rec["bit_equal"] = all(r["bit_equal"] for r in runs)
    if not (rec["outputs_on_device"] and rec["bit_equal"]):
        raise AssertionError(f"scheduler dispatch: {rec}")
    return rec


def sched_k1(dev, n_tasks: int, shape, seed: int) -> dict:
    """One job of ``n_tasks`` tasks, each one ``ops.flash_attention`` call
    (K1) on its own seeded bf16 inputs, through the Scheduler direct and
    bundled, in turns: K1 launched once a task a run (on the card, each in
    its ``wgmma`` body), outputs bit-equal to K1 called outside the
    scheduler."""
    from repro_torch.kernels import flash_attention, ops

    B, S, Hq, Hkv, hd = shape
    inputs = []
    for i in range(n_tasks):
        gen = torch.Generator(device=dev).manual_seed(seed * 100_003 + i)
        inputs.append(tuple(
            torch.randn((B, S, h, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv)))
    payloads = [lambda qkv=qkv: ops.flash_attention(*qkv, causal=True)
                for qkv in inputs]
    cuda = dev.type == "cuda"
    want = {"wgmma": n_tasks} if cuda else {}

    def after(mode, rec):
        _sync(dev)
        counts, by_body = _launches()
        rec["launches"] = counts["flash_attention"]
        rec["launches_by_body"] = by_body["flash_attention"]
        if (counts["flash_attention"] != (n_tasks if cuda else 0)
                or by_body["flash_attention"] != want or any(
                    n for k, n in counts.items() if k != "flash_attention")):
            raise AssertionError(f"scheduler K1 launches {counts}, "
                                 f"{by_body}, want {want}")

    # K1 called outside the scheduler (each run resets the counts)
    alone = [(flash_attention.flash_kernel if cuda
              else flash_attention.flash_attention_ref)(*qkv, causal=True)
             for qkv in inputs]
    recs = _sched_runs(dev, payloads, {
        m: (_reset_launches, after) for m in ("direct", "bundled")},
        want=alone)
    runs = [r for m in recs.values() for r in m]
    rec = {"tasks": n_tasks, "shape": dict(zip(
        ("B", "S", "Hq", "Hkv", "hd"), shape)), "dtype": "bfloat16",
        "runs": recs,
        "launches": sum(r["launches"] for r in runs),
        "outputs_on_device": all(r["on_device"] for r in runs),
        "equal_to_k1_alone": all(r["bit_equal"] for r in runs),
        "finite": all(bool(torch.isfinite(o).all()) for o in alone)}
    for mode in ("direct", "bundled"):
        wall = _mean(recs[mode], "wall_s")
        rec[mode] = {"wall_s": wall, "tasks_per_s": n_tasks / wall,
                     "host_us_a_task": _mean(recs[mode], "host_us_a_task")}
    if not (rec["outputs_on_device"] and rec["equal_to_k1_alone"]
            and rec["finite"]):
        raise AssertionError(f"scheduler K1 outputs: {rec}")
    return rec


def sched_raising(dev) -> dict:
    """A job of 8 dispatch tasks whose task 3 raises, with one restart:
    the raise is recorded as a failed attempt, retried once, and fails
    the task and the job for good, as in the reference's lifecycle; the
    other tasks complete with their outputs on the device."""
    from repro_torch.bench import dispatch_latency as dl

    step, x = dl._work_fn(1, dev)

    def make(i):
        def work():
            if i == 3:
                raise RuntimeError("payload 3 fails")
            return step(x * (i + 1))
        return work

    ex, job, sched, _ = _schedule([make(i) for i in range(8)], False,
                                  max_restarts=1)
    tasks = [(t.state.value, t.attempts) for t in job.tasks]
    rec = {"tasks": tasks, "job": job.state.value,
           "errors": {k[1]: repr(e) for k, e in ex.errors.items()},
           "completed_events": sched.completed,
           "outputs_on_device": _on(dev, ex.results.values())}
    want = [("completed", 1)] * 8
    want[3] = ("failed", 2)
    if (tasks != want or job.state.value != "failed"
            or list(ex.errors) != [job.tasks[3].key]
            or not isinstance(ex.errors[job.tasks[3].key], RuntimeError)
            or len(ex.results) != 7 or sched.completed != 9
            or not rec["outputs_on_device"]):
        raise AssertionError(f"scheduler raising payload: {rec}")
    return rec


def phase_scheduler(device="cuda", seed: int = 0, tasks: int = SCHED_TASKS,
                    k1_tasks: int = SCHED_K1_TASKS, k1_shape=SCHED_K1_SHAPE,
                    trials: int = 3, check_baseline: bool = True) -> dict:
    """The port's scheduler core: (a) golden virtual-time numbers on the
    host; (b) the control plane's tasks/s in the quick regimes of
    bench/sched_throughput.py, suite by suite, each held by
    ``--check-baseline`` to a third of the committed anchor's tasks/s
    (``check_baseline``); (c) real dispatch through the Scheduler
    and TorchDispatchExecutor, direct against ``aggregate``d — the
    dispatch task at scales 1 and 16, a job of K1 calls, a raising
    payload; (d) the map-reduce example on the device. Returns K1's
    launches through the scheduler."""
    from repro_torch import resolve_device
    from repro_torch.bench import dispatch_latency as dl
    from repro_torch.bench import sched_throughput
    from repro_torch.examples import multilevel_scheduling

    dev = resolve_device(device)
    t0 = time.perf_counter()
    golden = sched_golden()
    gate = ["--check-baseline"] if check_baseline else []
    bench = [r for suite in ("fifo", "policy_path")
             for r in sched_throughput.main(
                 ["--quick", "--trials", str(trials), "--suite", suite]
                 + gate)["regimes"]]
    t_s = dl.measure_dispatch_ts(dev)
    rows = [sched_dispatch(dev, scale, tasks, t_s, seed)
            for scale in SCHED_SCALES]
    k1 = sched_k1(dev, k1_tasks, k1_shape, seed)
    raising = sched_raising(dev)
    _reset_launches()
    mapreduce = multilevel_scheduling.run(dev)
    counts = _check_no_launches("scheduler map-reduce")
    seconds = time.perf_counter() - t0
    emit({"phase": "scheduler", "seconds": seconds, "golden": golden,
          "control_plane": [{k: r[k] for k in (
              "name", "policy", "jobs", "tasks_per_job", "slots_total",
              "total_tasks", "tasks_per_s", "wall_s")}
              for r in bench],
          "control_plane_trials": trials,
          "control_plane_check_baseline": check_baseline, "t_s_us": t_s * 1e6,
          "dispatch": rows, "k1": k1, "raising_payload": raising,
          "map_reduce": {**mapreduce, "launches": counts}})
    by_body = {}
    for runs in k1["runs"].values():
        for r in runs:
            for body, n in r["launches_by_body"].items():
                by_body[body] = by_body.get(body, 0) + n
    return {"flash_attention": k1["launches"], "by_body": by_body}

# workloads: the paper's measurement method (Table-9 task sets streamed
# through StreamingInjector, the Table-10 fit, Figs. 4-7, the million-task
# stream, the fault sweep) on the port's scheduler, at the sizes of the
# reference's committed runs under experiments/, which the phase reads
WORKLOAD_P = 102_400            # slots of the streamed grid
WORKLOAD_STREAM = {"jobs": 250_000, "tasks_per_job": 4, "P": 1024,
                   "max_active": 2048}
# Python 3.12's sum() of floats is compensated (Neumaier); the committed
# fault sweep was written under an earlier Python's plain left fold, so one
# of its means differs from today's by 2 ulp: (artifact's, today's).
# tests/test_torch_chip_smoke.py holds today's against the reference's
# own output and the artifact's against the left fold of the same values.
FAULT_SUM_312 = {("medium", "silent_mtbf8000"): {
    ("detection_latency_s", "mean"): (30.590150365523264, 30.59015036552327)}}


def _artifact(name: str) -> dict:
    return json.loads((ROOT / "experiments" / name).read_text())


def _fits_equal(got: dict, want: dict) -> bool:
    """A (t_s, alpha_s, r2) fit against the artifact's: the fit goes through
    LAPACK's least squares, whose last bits may differ between builds."""
    return all(abs(got[k] - want[k]) <= SCHED_FIT_RTOL * abs(want[k])
               for k in ("t_s", "alpha_s", "r2"))


def grid_mismatches(got: dict, want: dict) -> list:
    """Where a streamed-grid result differs from the artifact: every row
    exactly (the host clock's fields aside), each family's fit within
    ``SCHED_FIT_RTOL``."""
    from repro_torch.bench.common import without_wall

    bad = []
    if without_wall({k: v for k, v in got.items() if k != "families"}) != \
            without_wall({k: v for k, v in want.items() if k != "families"}):
        bad.append("header")
    if list(got["families"]) != list(want["families"]):
        bad.append("families")
    for fam, data in got["families"].items():
        ref = want["families"].get(fam, {"rows": [], "fit": None})
        if without_wall(data["rows"]) != without_wall(ref["rows"]):
            bad.append(f"{fam} rows")
        if ref["fit"] is None or not _fits_equal(data["fit"], ref["fit"]):
            bad.append(f"{fam} fit")
    return bad


def fault_mismatches(got: dict, want: dict) -> list:
    """Where a fault sweep differs from the artifact, the host clock's
    fields aside and ``FAULT_SUM_312``'s fields read as today's Python
    computes them."""
    from repro_torch.bench.common import without_wall

    got, want = without_wall(got), without_wall(want)
    bad = []
    for row in want["rows"]:
        for (a, b), (was, now) in FAULT_SUM_312.get(
                (row["set"], row["fault_profile"]), {}).items():
            if row[a][b] != was:
                bad.append(f"artifact {row['set']} {row['fault_profile']} "
                           f"{a}.{b} is {row[a][b]!r}, not {was!r}")
            row[a][b] = now
    for i, (g, w) in enumerate(zip(got["rows"], want["rows"])):
        if g != w:
            bad.append(f"row {i} ({w['set']} {w['fault_profile']}): "
                       + ", ".join(k for k in w if g.get(k) != w[k]))
    if len(got["rows"]) != len(want["rows"]):
        bad.append(f"{len(got['rows'])} rows, not {len(want['rows'])}")
    if {k: v for k, v in got.items() if k != "rows"} != \
            {k: v for k, v in want.items() if k != "rows"}:
        bad.append("header")
    return bad


def _wall(rec: dict, name: str, fn):
    """``fn()``, its host seconds in ``rec["wall_s"][name]`` and on a line
    of their own."""
    t0 = time.perf_counter()
    out = fn()
    rec["wall_s"][name] = time.perf_counter() - t0
    print(f"{rec['phase']} {name}: wall_s {rec['wall_s'][name]}",
          flush=True)
    return out


def phase_workloads() -> None:
    """(a) The P = 1,408 grid, direct and multilevel, 3 trials: each row
    the committed bench_cache.json holds equal to it, trials equal to each
    other, the Table-10 fits beside the paper's targets, the rows of Figs.
    4-7; (b) the four-family grid at P = 102,400 streamed in waves of P
    under 8 active jobs (24,576,000 tasks in the largest set) and the
    one-family scaled grid, against table9_grid_P102400.json and
    table9_scale_P102400.json; (c) the 1,000,000-task Poisson stream at
    P = 1,024 under 2,048 active jobs against workload_stream_1M.json;
    (d) the fault sweep at P = 1,408 against fault_replay_P1408.json;
    (e) the replay drivers' --quick smokes. Launches no kernel."""
    from repro_torch.bench import (common, fault_replay,
                                   fig4_latency_scaling, fig5_utilization,
                                   fig6_multilevel_latency,
                                   fig7_multilevel_utilization,
                                   table9_tasksets, table10_model_fit,
                                   workload_replay)
    from repro_torch.core import FAMILIES
    from repro_torch.workloads.synthetic import poisson_family

    t_phase = time.perf_counter()
    _reset_launches()
    rec = {"phase": "workloads", "wall_s": {}}
    bad = []
    # (a) the paper's grid; all_results raises on a committed row that
    # differs, and the figure drivers reuse its rows
    rows = _wall(rec, "grid_P1408", lambda: [
        r for ml in (False, True)
        for r in common.all_results(multilevel=ml, trials=3)])
    committed = common.load_committed_cache()
    rec["committed_rows_equal"] = sum(
        1 for r in rows
        if common._key(r["family"], r["n"], r["t"], r["multilevel"],
                       r["trial"]) in committed)
    if rec["committed_rows_equal"] != len(committed):
        bad.append(f"{rec['committed_rows_equal']} of {len(committed)} "
                   "committed rows compared")
    by_cell = {}
    for r in rows:
        cell = (r["family"], r["n"], r["t"], r["multilevel"])
        by_cell.setdefault(cell, []).append(
            json.dumps({k: v for k, v in r.items() if k != "trial"}))
    rec["grid_rows"] = len(rows)
    rec["trials_equal"] = all(len(set(v)) == 1 and len(v) == 3
                              for v in by_cell.values())
    if not rec["trials_equal"]:
        bad.append("trials differ")
    fits = table10_model_fit.run()
    rec["table10"] = {fam: {"t_s": f.t_s, "alpha_s": f.alpha_s, "r2": f.r2,
                            "paper_ts": FAMILIES[fam].target_ts,
                            "paper_alpha": FAMILIES[fam].target_alpha}
                      for fam, f in fits.items()}
    fig4 = fig4_latency_scaling.run()
    rec["fig4"] = {fam: {"n": ns, "delta_t": dts}
                   for fam, (ns, dts, _) in fig4.items()}
    rec["fig5"] = fig5_utilization.run()
    rec["fig6"] = [[*k, *v] for k, v in fig6_multilevel_latency.run().items()]
    rec["fig7"] = [[*k, *v] for k, v in
                   fig7_multilevel_utilization.run().items()]
    # (b) the streamed grid at 102,400 slots and the one-family scaled grid
    grid = _wall(rec, f"grid_P{WORKLOAD_P}",
                 lambda: table9_tasksets.run_grid(WORKLOAD_P))
    art = common.load_grid_artifact(WORKLOAD_P)
    rec["grid_P102400_mismatches"] = grid_mismatches(grid, art)
    rec["grid_P102400_wall_s"] = {
        f"{fam} {r['set']}": [r["wall_s"], a["wall_s"]]
        for fam, data in grid["families"].items()
        for r, a in zip(data["rows"], art["families"][fam]["rows"])}
    for cell, (now, then) in rec["grid_P102400_wall_s"].items():
        print(f"workloads grid_P{WORKLOAD_P} {cell}: wall_s {now} "
              f"(artifact {then})", flush=True)
    rec["grid_P102400_tasks"] = sum(r["stream"]["tasks"]
                                    for d in grid["families"].values()
                                    for r in d["rows"])
    bad += [f"grid_P{WORKLOAD_P} {m}" for m in
            rec["grid_P102400_mismatches"]]
    scale = _wall(rec, f"scale_P{WORKLOAD_P}",
                  lambda: table9_tasksets.run_scaled(WORKLOAD_P))
    art = _artifact(f"table9_scale_P{WORKLOAD_P}.json")
    rec["scale_P102400_equal"] = (
        common.without_wall({k: v for k, v in scale.items() if k != "fit"})
        == common.without_wall({k: v for k, v in art.items() if k != "fit"})
        and _fits_equal(scale["fit"], art["fit"]))
    if not rec["scale_P102400_equal"]:
        bad.append(f"scale_P{WORKLOAD_P}")
    # (c) the million-task stream
    st = WORKLOAD_STREAM
    stream = _wall(rec, "stream_1M", lambda: workload_replay.replay(
        poisson_family(0, st["jobs"], st["P"],
                       tasks_per_job=st["tasks_per_job"]),
        P=st["P"], max_active=st["max_active"], label="family:poisson"))
    art = _artifact("workload_stream_1M.json")
    rec["stream_1M"] = {k: stream[k] for k in (
        "jobs", "tasks", "peak_active_jobs", "virtual_makespan_s",
        "utilization", "dispatch_latency_p50_s", "dispatch_latency_p99_s",
        "wall_s", "tasks_per_s")}
    rec["stream_1M"]["artifact_wall_s"] = art["wall_s"]
    print(f"workloads stream_1M: tasks_per_s {stream['tasks_per_s']}",
          flush=True)
    rec["stream_1M_mismatches"] = [
        k for k in art if k not in ("wall_s", "tasks_per_s")
        and common.without_wall(stream[k]) != common.without_wall(art[k])]
    bad += [f"stream_1M {k}" for k in rec["stream_1M_mismatches"]]
    # (d) the fault sweep at the paper's P
    sweep = _wall(rec, "fault_sweep", lambda: fault_replay.main([]))
    rec["fault_mismatches"] = fault_mismatches(
        sweep, _artifact("fault_replay_P1408.json"))
    bad += [f"fault {m}" for m in rec["fault_mismatches"]]
    rec["fault_rows"] = len(sweep["rows"])
    # (e) the drivers' smokes
    _wall(rec, "workload_replay_quick",
          lambda: workload_replay.main(["--quick"]))
    _wall(rec, "fault_replay_quick", lambda: fault_replay.main(["--quick"]))
    rec["launches"] = _check_no_launches("workloads")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"workloads: phase seconds {rec['seconds']}", flush=True)
    emit(rec)
    if bad:
        raise AssertionError(f"workloads: {bad}")


# runtime: the rest of the port's obs (flight recorder, self-profiler) and
# its wall-clock runtime rt, with tasks leased to worker threads that run
# them on the card. The committed reference run of self_latency (its host,
# not this one) is printed beside this host's fits.
RT_SELF_LATENCY_ARTIFACT = "self_latency.json"
RT_REPLAY_ARTIFACT = "rt_replay.json"
RT_K1_TASKS = 256
# the traced socket run's Chrome trace: beside --out's file, else in build/
RT_TRACE = ROOT / "build" / "rt_socket_trace.json"
RT_TRACE_N = 512                # tasks of the traced socket run
RT_GAPS = 5                     # longest complete -> next dispatch gaps
RT_MEMORY_SLACK = 64 << 20      # bytes the phase may leave allocated


def _memory(dev) -> dict:
    """The caching allocator's allocated and reserved bytes now."""
    if dev.type != "cuda":
        return {}
    return {"allocated": torch.cuda.memory_allocated(dev),
            "reserved": torch.cuda.memory_reserved(dev)}


def _release_workspaces(dev, start: dict) -> dict:
    """Frees what the slot threads left on the card: cuBLAS keeps a
    workspace for each (handle, stream) pair a thread met, for the life
    of the process (32 MB each under ``:4096:8``; hundreds over the
    runtime's fleets of fresh threads). Returns the memory before and
    after; raises unless allocated bytes are back within
    ``RT_MEMORY_SLACK`` of ``start``'s."""
    if dev.type != "cuda":
        return {}
    held = _memory(dev)
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    rec = {"held": held, "released": _memory(dev)}
    if rec["released"]["allocated"] > start["allocated"] + RT_MEMORY_SLACK:
        raise AssertionError(f"runtime: memory not released: start "
                             f"{start}, {rec}")
    return rec


def _threads_settle(before: set, timeout: float = 10.0) -> list:
    """Names of the threads started since ``before`` that are still alive
    after ``timeout`` seconds (worker slots end within one 0.2 s poll)."""
    end = time.monotonic() + timeout
    while True:
        left = [t.name for t in threading.enumerate()
                if t.ident not in before and t.is_alive()]
        if not left or time.monotonic() > end:
            return left
        time.sleep(0.05)


def rt_self_latency(procs: int, trials: int) -> dict:
    """bench/self_latency.py on this host: the full sweep (wave, per-event,
    many-jobs arena and object) with the profiled pass at the largest n,
    held to the driver's gate (wave r2 >= 0.99), each fit beside the
    committed reference run's; then the driver's --quick with its trace
    round-trip. A miss of the gate, a property of the host's timing noise
    and not of the schedule (every run's tasks are counted), is reported
    as a failure in ``gate`` and printed; the phase goes on."""
    from repro_torch.bench import self_latency

    res = self_latency.run(procs, trials)
    gate = {"min_r2": 0.99, "wave_r2": res["engine"]["wave"]["r2"],
            "passed": True}
    try:
        self_latency.gate(res)
    except SystemExit as e:
        gate.update(passed=False, failure=str(e))
        print(f"runtime self_latency: FAILED the gate: {e}", flush=True)
    committed = _artifact(RT_SELF_LATENCY_ARTIFACT)["engine"]
    fits = {}
    for path, fit in res["engine"].items():
        ref = committed[path]
        fits[path] = {"t_s_us": fit["t_s"] * 1e6, "alpha_s": fit["alpha_s"],
                      "r2": fit["r2"],
                      "committed_t_s_us": ref["t_s"] * 1e6,
                      "committed_alpha_s": ref["alpha_s"],
                      "committed_r2": ref["r2"]}
        print(f"runtime self_latency {path}: t_s {fits[path]['t_s_us']} us "
              f"alpha {fit['alpha_s']} r2 {fit['r2']} (this host); "
              f"committed {fits[path]['committed_t_s_us']} us alpha "
              f"{ref['alpha_s']} (the reference's host)", flush=True)
    quick = self_latency.quick()
    return {"P": procs, "trials": trials, "gate": gate, "fits": fits,
            "points": {k: v["points"] for k, v in res["engine"].items()},
            "phases": res["phases"], "quick_trace": quick["trace"],
            "committed_host": "the reference author's host "
                              "(experiments/self_latency.json)"}


def _phase_split(report: dict, n: int) -> dict:
    """Each profiled phase's self us a task and share of the profiled
    time. Under an executor the payload runs from its own loop event
    (``Scheduler._run_payload``), outside every profiled phase."""
    total = sum(r["self_s"] for r in report.values())
    out = {phase: {"calls": r["calls"], "self_us_a_task": r["self_s"] / n
                   * 1e6, "share": r["self_s"] / total if total else 0.0}
           for phase, r in report.items()}
    out["profiled_us_a_task"] = total / n * 1e6
    return out


def rt_profile_dispatch(dev, scales, n_tasks: int, seed: int) -> list:
    """Phase 18a's direct runs once more, untimed, under SelfProfiler: the
    dispatch task at each scale, ``n_tasks`` tasks through the Scheduler
    and TorchDispatchExecutor (the per-event path); beside each, the same
    job of zero-work virtual tasks on the wave path with no executor."""
    from repro_torch.bench import dispatch_latency as dl
    from repro_torch.core import (FAMILIES, Job, ResourceManager, Scheduler,
                                  SchedulerConfig)
    from repro_torch.obs import SelfProfiler

    rows = []
    for scale in scales:
        step, _ = dl._work_fn(scale, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        xs = torch.randn((n_tasks, dl.D, dl.D), generator=gen, device=dev) \
            * dl.D ** -0.5
        payloads = [lambda i=i: step(xs[i]) for i in range(n_tasks)]
        payloads[0]()
        prof = SelfProfiler()
        ex, job, sched, wall = _schedule(payloads, False, attach=prof.attach)
        _task_outputs(ex, job, False)        # raises unless all completed
        executor_s = sum(ex.lat)
        direct = _phase_split(prof.report(), n_tasks)
        direct.update(wall_s=wall, executor_us_a_task=executor_s / n_tasks
                      * 1e6, host_us_a_task=(wall - executor_s)
                      / sched.dispatched * 1e6,
                      task_ms_max=max(ex.lat) * 1e3)
        # the event loop, the payload's event and the executor's wrapper
        direct["unprofiled_us_a_task"] = (direct["host_us_a_task"]
                                          - direct["profiled_us_a_task"])
        rm = ResourceManager()
        rm.add_nodes(SCHED_SLOTS, slots=1)
        virt = Scheduler(rm, profile=FAMILIES["inproc"],
                         config=SchedulerConfig(wave_batching=True))
        vprof = SelfProfiler().attach(virt)
        t0 = time.perf_counter()
        virt.submit(Job.array(n_tasks, durations=[0.0] * n_tasks))
        virt.run()
        vwall = time.perf_counter() - t0
        wave = _phase_split(vprof.report(), n_tasks)
        wave.update(wall_s=vwall, host_us_a_task=vwall / n_tasks * 1e6)
        wave["unprofiled_us_a_task"] = (wave["host_us_a_task"]
                                        - wave["profiled_us_a_task"])
        rows.append({"scale": scale, "tasks": n_tasks, "direct": direct,
                     "wave_no_executor": wave})
        print(f"runtime profile x{scale}: direct {direct['host_us_a_task']} "
              f"host us a task, wave {wave['host_us_a_task']}", flush=True)
        del xs, payloads, ex
    return rows


def _trace_gaps(events, k: int) -> dict:
    """From a flight record (times in seconds since the runtime started):
    the longest wall gaps from a ``complete`` to the first ``dispatch``
    recorded after it and their median, and each task's span from its
    dispatch to its completion (the lease's round trip: the grant waits
    for a claim, the worker runs the payload, the result comes back)."""
    gaps, pending, spans = [], [], []
    for t, kind, _job, _task, _node, aux in events:
        if kind == "complete":
            pending.append(t)
            spans.append(t - aux)           # aux: the dispatch time
        elif kind == "dispatch" and pending:
            gaps += [(t - tc, tc) for tc in pending]
            pending = []
    gaps.sort(reverse=True)
    spans.sort()

    def at(v, q):
        return v[min(int(len(v) * q), len(v) - 1)] * 1e3 if v else 0.0

    return {"complete_to_next_dispatch": {
                "longest_ms": [g * 1e3 for g, _ in gaps[:k]],
                "at_s": [t for _, t in gaps[:k]],
                "median_ms": at(sorted(g for g, _ in gaps), 0.5),
                "gaps": len(gaps)},
            "dispatch_to_complete": {"p50_ms": at(spans, 0.5),
                                     "p99_ms": at(spans, 0.99),
                                     "max_ms": at(spans, 1.0),
                                     "tasks": len(spans)}}


def rt_wall_fits(dev, mem_sizes, sock_sizes, trials: int,
                 seed: int) -> dict:
    """bench/rt_replay.py's sweep (4 workers x 8 slots) on both
    transports, with the zero-work payload and with the dispatch task (128
    x 128 float32 tanh(x @ x) at scale 1, run on the slot thread's own
    stream, waiting on its event); every dispatch run's outputs held bit
    for bit against the task run alone; the zero-work fits beside the
    committed reference run's (experiments/rt_replay.json, another host).
    Then one socket run of ``RT_TRACE_N`` dispatch tasks under a
    FlightRecorder, its Chrome trace exported."""
    from repro_torch.bench import dispatch_latency as dl
    from repro_torch.bench import rt_replay
    from repro_torch.core import Job
    from repro_torch.obs import FlightRecorder
    from repro_torch.rt import (FnPayload, InMemoryTransport,
                                SocketTransport, register_payload)
    from repro_torch.rt.streams import on_thread_stream

    step, _ = dl._work_fn(1, dev)
    n_max = max(max(mem_sizes), max(sock_sizes), RT_TRACE_N)
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn((n_max, dl.D, dl.D), generator=gen, device=dev) \
        * dl.D ** -0.5
    want = [step(xs[i]) for i in range(n_max)]
    _sync(dev)
    outs = {}

    def task(i):
        outs[i] = on_thread_stream(lambda: step(xs[i]), dev, (xs[i],))

    register_payload("chip_smoke_dispatch", task)

    def gpu_job(n):
        outs.clear()
        return Job.array(n, payloads=[FnPayload("chip_smoke_dispatch", i)
                                      for i in range(n)])

    bad = []

    def check(n):
        if sorted(outs) != list(range(n)) or not all(
                _bit_equal(outs[i], want[i]) for i in range(n)):
            bad.append(n)

    rec = {}
    for label, make, sizes in (("in_memory", InMemoryTransport, mem_sizes),
                               ("socket", SocketTransport, sock_sizes)):
        zero = rt_replay.sweep(label, make, sizes, trials)
        gpu = rt_replay.sweep(f"{label}+gpu", make, sizes, trials,
                              make_job=gpu_job, check=check)
        ref = _artifact(RT_REPLAY_ARTIFACT)["transports"][label]
        rec[label] = {"zero_work": zero, "dispatch_task": gpu,
                      "committed_zero_work": {k: ref[k] for k in (
                          "t_s", "alpha_s", "r2")},
                      "added_us_a_task": [
                          (g["dt_s"] - z["dt_s"]) / g["n"] * 1e6
                          for z, g in zip(zero["points"], gpu["points"])]}
    if bad:
        raise AssertionError(f"runtime: dispatch outputs differ at n {bad}")
    recorder = FlightRecorder()
    wall = rt_replay.measure_once(SocketTransport, RT_TRACE_N, gpu_job,
                                  attach=lambda rt: recorder.attach(rt.sch))
    check(RT_TRACE_N)
    if bad:
        raise AssertionError("runtime: traced socket run's outputs differ")
    RT_TRACE.parent.mkdir(parents=True, exist_ok=True)
    written = recorder.export_chrome(str(RT_TRACE))
    counts = recorder.counts()
    if counts.get("complete") != RT_TRACE_N or \
            counts.get("dispatch") != RT_TRACE_N:
        raise AssertionError(f"runtime trace counts {counts}")
    rec["socket_trace"] = {"tasks": RT_TRACE_N, "wall_s": wall,
                           "events": len(recorder.events),
                           "chrome_records": written, "counts": counts,
                           "file": str(RT_TRACE),
                           **_trace_gaps(recorder.events, RT_GAPS)}
    gaps = rec["socket_trace"]
    print(f"runtime socket trace: {written} records, complete -> next "
          f"dispatch {gaps['complete_to_next_dispatch']}, dispatch -> "
          f"complete {gaps['dispatch_to_complete']}", flush=True)
    del xs, want
    outs.clear()
    return rec


def rt_k1(dev, n_tasks: int, shape, seed: int) -> dict:
    """A job of ``n_tasks`` K1 calls (each on its own seeded bf16 inputs)
    leased over InMemoryTransport to 4 workers x 8 slots, each on its slot
    thread's stream: every output bit-equal to K1 called alone, and K1
    launched exactly once a task, each in its ``wgmma`` body on the
    card."""
    from repro_torch.bench import rt_replay
    from repro_torch.core import Job
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.rt import FnPayload, InMemoryTransport, register_payload
    from repro_torch.rt.streams import on_thread_stream

    B, S, Hq, Hkv, hd = shape
    inputs = []
    for i in range(n_tasks):
        gen = torch.Generator(device=dev).manual_seed(seed * 100_003 + i)
        inputs.append(tuple(
            torch.randn((B, S, h, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv)))
    cuda = dev.type == "cuda"
    alone = [(flash_attention.flash_kernel if cuda
              else flash_attention.flash_attention_ref)(*qkv, causal=True)
             for qkv in inputs]
    _sync(dev)
    outs = {}

    def task(i):
        outs[i] = on_thread_stream(
            lambda: ops.flash_attention(*inputs[i], causal=True), dev,
            inputs[i])

    register_payload("chip_smoke_k1", task)
    job = Job.array(n_tasks, payloads=[FnPayload("chip_smoke_k1", i)
                                       for i in range(n_tasks)])
    _reset_launches()
    _, rt, pool = rt_replay._fleet(InMemoryTransport, lease_ttl=30.0,
                                   heartbeat_interval=0.2,
                                   heartbeat_timeout=2.0)
    try:
        t0 = time.perf_counter()
        rt.submit(job)
        idle = rt.run_until_idle(timeout=rt_replay.POINT_TIMEOUT)
        wall = time.perf_counter() - t0
    finally:
        pool.stop()
        rt.close()
    counts, by_body = _launches()
    rec = {"tasks": n_tasks, "shape": dict(zip(
        ("B", "S", "Hq", "Hkv", "hd"), shape)), "dtype": "bfloat16",
        "wall_s": wall, "tasks_per_s": n_tasks / wall,
        "summary": rt.summary(),
        "states": sorted({t.state.value for t in job.tasks}),
        "launches": counts["flash_attention"],
        "launches_by_body": by_body["flash_attention"],
        "equal_to_k1_alone": sorted(outs) == list(range(n_tasks)) and all(
            _bit_equal(outs[i], alone[i]) for i in range(n_tasks)),
        "finite": all(bool(torch.isfinite(o).all()) for o in alone)}
    want = {"wgmma": n_tasks} if cuda else {}
    if not (idle and rec["states"] == ["completed"]
            and rec["equal_to_k1_alone"] and rec["finite"]
            and by_body["flash_attention"] == want
            and counts["flash_attention"] == (n_tasks if cuda else 0)
            and not any(n for k, n in counts.items()
                        if k != "flash_attention")):
        raise AssertionError(f"runtime K1: {rec}, launches {counts}")
    del inputs, alone
    outs.clear()
    return rec


def rt_chaos(dev, seed: int) -> dict:
    """bench/rt_replay.py's chaos soak (drop, dup and delay on the
    transport; a worker killed, one hung and thawed, one restarted) with
    the dispatch task as every task's payload: every task completed
    exactly once or quarantined (the driver asserts it); only the planted
    faults may cost a task, so no payload raised and every task completed;
    and every completed task's output bit-equal to the task run alone."""
    from repro_torch.bench import dispatch_latency as dl
    from repro_torch.bench import rt_replay
    from repro_torch.core.job import TaskState
    from repro_torch.rt import FnPayload, register_payload
    from repro_torch.rt.streams import on_thread_stream

    jobs, tasks = 2, 40
    step, _ = dl._work_fn(1, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    xs = torch.randn((jobs * tasks, dl.D, dl.D), generator=gen, device=dev) \
        * dl.D ** -0.5
    want = [step(x) for x in xs]
    _sync(dev)
    outs, errors = {}, []

    def task(k):
        try:
            outs[k] = on_thread_stream(lambda: step(xs[k]), dev, (xs[k],))
        except Exception as e:
            errors.append(f"task {k}: {e!r}")
            raise

    register_payload("chip_smoke_chaos", task)
    batch = []
    try:
        soak = rt_replay.chaos_soak(
            seed=seed, jobs=jobs, tasks=tasks,
            payload=lambda j, i: FnPayload("chip_smoke_chaos",
                                           j * tasks + i),
            jobs_into=batch)
    finally:
        if errors:      # the soak's own checks may fail first
            print(f"runtime chaos soak: {len(errors)} payloads raised, "
                  f"first {errors[:3]}", flush=True)
    done = [j * tasks + t.index for j, job in enumerate(batch)
            for t in job.tasks if t.state is TaskState.COMPLETED]
    soak["completed_outputs_equal"] = all(
        k in outs and _bit_equal(outs[k], want[k]) for k in done)
    soak["completed_tasks"] = len(done)
    soak["payload_errors"] = errors[:5]
    if errors or len(done) != jobs * tasks \
            or not soak["completed_outputs_equal"]:
        raise AssertionError(f"runtime chaos soak: {len(errors)} payloads "
                             f"raised; {soak}")
    del xs, want
    outs.clear()
    return soak


def phase_runtime(device="cuda", seed: int = 0, sl_procs: int = None,
                  sl_trials: int = None, profile_tasks: int = SCHED_TASKS,
                  mem_sizes=None, sock_sizes=None, trials: int = None,
                  k1_tasks: int = RT_K1_TASKS, k1_shape=SCHED_K1_SHAPE,
                  check_baseline: bool = True) -> dict:
    """(a) bench/self_latency.py on this host: the full sweep, its gate
    and --quick; (b) phase 18a's direct dispatch runs under SelfProfiler,
    the host us a task split by phase, beside the wave path with no
    executor; (c) the wall-clock runtime (AsyncRuntime, 4 workers x 8
    slots) with zero-work and dispatch tasks on both transports, (t_s,
    alpha_s) fitted; a job of K1 tasks; the chaos soak with the dispatch
    task; a flight record of one socket run; (d) rt_replay --quick
    (--check-baseline unless ``check_baseline`` is False) and
    self_latency --quick. No thread the phase starts outlives it. Returns
    K1's launches through the runtime."""
    from repro_torch import resolve_device
    from repro_torch.bench import rt_replay, self_latency

    dev = resolve_device(device)
    t_phase = time.perf_counter()
    before = {t.ident for t in threading.enumerate()}
    rec = {"phase": "runtime", "wall_s": {}}
    rec["self_latency"] = _wall(rec, "self_latency", lambda: rt_self_latency(
        sl_procs or self_latency.P, sl_trials or self_latency.TRIALS))
    _reset_launches()
    rec["memory_start"] = _memory(dev)
    try:
        rec["profile"] = _wall(rec, "profile", lambda: rt_profile_dispatch(
            dev, SCHED_SCALES, profile_tasks, seed))
        rec["wall"] = _wall(rec, "wall_fits", lambda: rt_wall_fits(
            dev, mem_sizes or rt_replay.N_MEM,
            sock_sizes or rt_replay.N_SOCK, trials or rt_replay.TRIALS,
            seed))
        rec["chaos"] = _wall(rec, "chaos", lambda: rt_chaos(dev, seed))
        _check_no_launches("runtime")
        rec["k1"] = _wall(rec, "k1", lambda: rt_k1(dev, k1_tasks, k1_shape,
                                                   seed))
        _reset_launches()
        _wall(rec, "rt_replay_quick", lambda: rt_replay.main(
            ["--quick"] + (["--check-baseline"] if check_baseline else [])))
        _wall(rec, "self_latency_quick",
              lambda: self_latency.main(["--quick"]))
        rec["launches"] = _check_no_launches("runtime smokes")
        rec["leaked_threads"] = _threads_settle(before)
    finally:
        rec["memory"] = _release_workspaces(dev, rec["memory_start"])
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"runtime: phase seconds {rec['seconds']}", flush=True)
    emit(rec)
    if rec["leaked_threads"]:
        raise AssertionError(f"runtime: threads outlived the phase: "
                             f"{rec['leaked_threads']}")
    return {"flash_attention": rec["k1"]["launches"],
            "by_body": rec["k1"]["launches_by_body"]}


def phase_serve_batched(device="cuda", full: bool = True):
    """The port's examples/serve_batched.py on Gemma 2B (published widths
    with ``full``) in float32: 1 lane and 8 lanes must give identical
    outputs. Every prefill attention goes through K1 on the card, every
    decode step's through the decode kernel."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.examples import serve_batched

    cfg = (get_config if full else get_smoke_config)("gemma_2b")
    argv = ["--device", str(device), "--dtype", "float32"] + (
        ["--full"] if full else [])
    _reset_launches()
    res = serve_batched.main(argv)
    _sync(device)
    counts, by_body = _launches()
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    cuda = torch.device(device).type == "cuda"
    # each engine's decode steps replay graphs after one eager step
    expected = {"flash_attention": 2 * serve_batched.N_REQ * attn,
                "decode_attention": attn * sum(
                    res[k]["decode_steps"] + res[k]["decode_captures"]
                    for k in ("serial", "batched"))}
    if not cuda:
        expected = {name: 0 for name in expected}
    keys = ("decode_steps", "decode_tokens", "tokens_per_dispatch",
            "throughput_tok_s", "wall_s")
    emit({"phase": "serve_batched", "arch": cfg.name, "dtype": "float32",
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "serial": {k: res["serial"][k] for k in keys},
          "batched": {k: res["batched"][k] for k in keys},
          "dispatch_reduction": res["dispatch_reduction"],
          "outputs_identical": True, "launches": counts,
          "launches_expected": expected, "launches_by_body": by_body})
    if counts != {name: expected.get(name, 0) for name in counts}:
        raise AssertionError(f"serve_batched launches {counts}, want "
                             f"{expected}")
    return counts, by_body


def phase_serving_replay(device="cuda", full: bool = True):
    """The port's serving replay --quick (120 requests, lanes 4 and 16;
    Phi-4-mini at its published widths with ``full``, bf16); its smoke
    invariant must hold, and on the card every prefill attention of the
    warm-up and the replay goes through K1's wgmma body."""
    from repro_torch.bench import serving_replay
    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_config if full else get_smoke_config)("phi4_mini_3_8b")
    argv = ["--quick", "--device", str(device)] + (["--full"] if full
                                                     else [])
    _reset_launches()
    rows = serving_replay.main(argv)
    _sync(device)
    counts, by_body = _launches()
    cuda = torch.device(device).type == "cuda"
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    expected = (len(rows) * (120 + 1) * attn) if cuda else 0
    emit({"phase": "serving_replay", "arch": cfg.name, "dtype": cfg.dtype,
          "n_layers": cfg.n_layers, "rows": rows,
          "smoke_invariant": serving_replay.smoke_invariant(rows),
          "launches": counts,
          "launches_expected": {"flash_attention": expected},
          "launches_by_body": by_body})
    want_body = {SERVE_BODY["flash_attention"]: expected} if expected else {}
    if counts["flash_attention"] != expected or (
            by_body["flash_attention"] != want_body):
        raise AssertionError(f"serving_replay launches {by_body}, want "
                             f"{want_body}")
    return counts, by_body


# mesh: the step builders on a one-device DeviceMesh
MESH_PROMPT, MESH_DECODE_K, MESH_LANES, MESH_MAX_LEN = 64, 4, 8, 1024
MESH_DISPATCHES = 3


def _constrain_counter():
    """(counts, undo): every model module's ``constrain`` wrapped to count
    its calls in ``counts["calls"]``."""
    from repro_torch.models import attention, layers, moe, ssm, xlstm

    counts = {"calls": 0}
    mods = (attention, layers, moe, ssm, xlstm)
    orig = [m.constrain for m in mods]

    def counted(x, *names):
        counts["calls"] += 1
        return orig[0](x, *names)

    for m in mods:
        m.constrain = counted

    def undo():
        for m, f in zip(mods, orig):
            m.constrain = f
    return counts, undo


def _greedy(step, params, token, caches, index, dispatches, k):
    """Tokens of ``dispatches`` k-step decode calls, fed back."""
    out = []
    for i in range(dispatches):
        logits, caches = step(params, token, caches, index + i * k)
        logits = logits.to_local() if hasattr(logits, "to_local") else logits
        token = logits.argmax(dim=-1, keepdim=True)
        out.append(token[:, 0].tolist())
    return out, logits


def _host_ms_on(dev, fn, iters: int) -> float:
    """``_host_ms`` on any device: host wall ms of fn() with a sync."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_mesh(cfg, seed: int, device="cuda", full_layers=None):
    """The step builders on ``make_host_mesh()`` (one device, NCCL on the
    card, gloo on the CPU) beside the meshless ones, with ``cfg`` at its
    full width:

    - prefill of ``full_layers`` layers (all of them by default) in bf16
      with ``use_kernel=True``: K1 launches one a layer, in its wgmma
      body on the card; logits equal to the meshless kernel prefill's;
    - k-step decode (k = MESH_DECODE_K) at 2 layers in float32: greedy
      tokens equal to the meshless builder's; at full depth in bf16: the
      largest logit difference from the meshless builder;
    - two bf16 train steps at 2 layers, on and off the mesh, bit-equal
      under deterministic algorithms;
    - host ms of a decode step and a train step on and off the mesh, and
      the host cost of the no-op ``constrain`` calls of a meshless decode
      step (calls in a step × the time of one, timed in a loop)."""
    from repro_torch.configs import RunConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.distributed.sharding import constrain, param_shardings
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step,
                                          build_train_step, init_train_state,
                                          rules_for)
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, map_tree

    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    full = dataclasses.replace(cfg, n_layers=full_layers or cfg.n_layers)
    two32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    two16 = dataclasses.replace(cfg, n_layers=2)
    rng = np.random.default_rng(seed)
    rec = {"phase": "mesh", "arch": cfg.name, "d_model": cfg.d_model,
           "n_layers": full.n_layers, "device": str(dev)}
    mesh_lib.init_group("nccl" if cuda else "gloo", 1)
    try:
        mesh = mesh_lib.make_host_mesh(dev.type)
        rec["mesh"] = dict(mesh_lib.axis_sizes(mesh))
        rec["backend"] = torch.distributed.get_backend()

        # prefill through K1 on the mesh, full depth, bf16
        model = build_model(full)
        params = model.init(seed, device=dev)
        # laid out once, as a mesh run keeps them
        mparams = param_shardings(params, mesh, rules_for(mesh, full))
        prompt = rng.integers(0, cfg.vocab_size, (1, 512))
        plain_pre = build_prefill_step(full, use_kernel=True, device=dev)
        mesh_pre = build_prefill_step(full, use_kernel=True, device=dev,
                                      mesh=mesh)
        want, _ = plain_pre(params, {"tokens": prompt})
        _reset_launches()
        got, _ = mesh_pre(mparams, {"tokens": prompt})
        _sync(dev)
        counts, by_body = _launches()
        attn = sum(full.layer_kind(i) == "attn" for i in range(full.n_layers))
        expected = attn if cuda else 0
        rec["prefill"] = {
            "S": 512, "launches": counts, "launches_by_body": by_body,
            "launches_expected": {"flash_attention": expected},
            "max_abs_logit_diff": float((got.to_local().float()
                                         - want.float()).abs().max())}
        body_ok = (by_body["flash_attention"] == (
            {SERVE_BODY["flash_attention"]: expected} if expected else {}))
        if counts["flash_attention"] != expected or not body_ok or any(
                n for name, n in counts.items() if name != "flash_attention"):
            raise AssertionError(f"mesh prefill launches {by_body}, want "
                                 f"{expected} wgmma")

        # k-step decode, full depth bf16: logits beside the meshless path
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (MESH_LANES, MESH_PROMPT)),
                               device=dev)
        _, caches = model.prefill(params, toks, max_len=MESH_MAX_LEN)
        mcaches = map_tree(lambda t: t.clone(), caches)
        plain_dec = build_decode_step(full, steps_per_dispatch=MESH_DECODE_K)
        mesh_dec = build_decode_step(full, steps_per_dispatch=MESH_DECODE_K,
                                     mesh=mesh)
        last = toks[:, -1:]
        ptoks, plog = _greedy(plain_dec, params, last, caches, MESH_PROMPT,
                              1, MESH_DECODE_K)
        mtoks, mlog = _greedy(mesh_dec, mparams, last, mcaches, MESH_PROMPT,
                              1, MESH_DECODE_K)
        rec["decode_full"] = {
            "dtype": full.dtype, "k": MESH_DECODE_K, "lanes": MESH_LANES,
            "max_abs_logit_diff": float((mlog.float() - plog.float())
                                        .abs().max()),
            "tokens_equal": ptoks == mtoks}

        # host ms of a decode step (one token, 8 lanes) on and off the mesh
        one_plain = build_decode_step(full)
        one_mesh = build_decode_step(full, mesh=mesh)
        for name, fn, p, c in (("plain", one_plain, params, caches),
                               ("mesh", one_mesh, mparams, mcaches)):
            rec[f"decode_step_host_ms_{name}"] = _host_ms_on(
                dev, lambda: fn(p, last, c, MESH_PROMPT + MESH_DECODE_K),
                5 if cuda else 2)
        # the no-op constrain calls of a meshless decode step
        counter, undo = _constrain_counter()
        try:
            one_plain(params, last, caches, MESH_PROMPT + MESH_DECODE_K)
        finally:
            undo()
        x = torch.zeros(1, device=dev)
        n = 200_000
        t0 = time.perf_counter()
        for _ in range(n):
            constrain(x, "batch", "seq", "embed")
        per_call_us = (time.perf_counter() - t0) / n * 1e6
        rec["constrain"] = {
            "calls_per_decode_step": counter["calls"],
            "noop_call_us": per_call_us,
            "ms_per_decode_step": counter["calls"] * per_call_us / 1e3,
            "share_of_decode_step": counter["calls"] * per_call_us / 1e3
            / rec["decode_step_host_ms_plain"]}
        del caches, mcaches, params, mparams, model
        _empty_cache(dev)

        # 2 layers float32: the mesh's greedy tokens are the meshless ones
        m32 = build_model(two32)
        p32 = m32.init(seed, device=dev)
        toks32 = toks[:3]
        _, c32 = m32.prefill(p32, toks32, max_len=MESH_MAX_LEN)
        mc32 = map_tree(lambda t: t.clone(), c32)
        want_t, _ = _greedy(build_decode_step(
            two32, steps_per_dispatch=MESH_DECODE_K), p32, toks32[:, -1:],
            c32, MESH_PROMPT, MESH_DISPATCHES, MESH_DECODE_K)
        got_t, _ = _greedy(build_decode_step(
            two32, steps_per_dispatch=MESH_DECODE_K, mesh=mesh), p32,
            toks32[:, -1:], mc32, MESH_PROMPT, MESH_DISPATCHES,
            MESH_DECODE_K)
        rec["decode_float32"] = {"n_layers": 2, "lanes": 3,
                                 "dispatches": MESH_DISPATCHES,
                                 "tokens": got_t, "tokens_equal":
                                 got_t == want_t}
        del p32, c32, mc32, m32
        _empty_cache(dev)

        # two bf16 train steps at 2 layers, deterministic: bit-equal
        batch, seq = (8, 512) if cuda else (2, 32)
        run = RunConfig(model=two16, seq_len=seq, global_batch=batch,
                        seed=seed, learning_rate=1e-3, warmup_steps=2,
                        total_steps=10)
        source = SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed)
        deterministic = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            plain = init_train_state(two16, run, dev)
            meshed = map_tree(lambda t: t.detach().clone(), plain)
            steps = {"plain": build_train_step(two16, run=run, device=dev),
                     "mesh": build_train_step(two16, run=run, device=dev,
                                              mesh=mesh)}
            states = {"plain": plain, "mesh": meshed}
            ms = {"plain": [], "mesh": []}
            losses = {"plain": [], "mesh": []}
            for i in range(2):
                for name in ("plain", "mesh"):
                    _sync(dev)
                    t0 = time.perf_counter()
                    states[name], met = steps[name](states[name],
                                                    source.batch_at(i))
                    losses[name].append(float(met["loss"]))
                    _sync(dev)
                    ms[name].append((time.perf_counter() - t0) * 1e3)
        finally:
            torch.use_deterministic_algorithms(deterministic)
        pairs = list(zip(leaves(states["plain"]), leaves(states["mesh"])))
        bad = [i for i, (a, b) in enumerate(pairs) if not _bit_equal(
            a, b.to_local() if hasattr(b, "to_local") else b)]
        rec["train"] = {"n_layers": 2, "dtype": two16.dtype, "B": batch,
                        "S": seq, "steps": 2, "losses": losses,
                        "step_host_ms": ms, "leaves": len(pairs),
                        "mismatched_leaves": bad}
        del states, plain, meshed, pairs
        _empty_cache(dev)
    finally:
        mesh_lib.destroy_group()
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    if rec["train"]["mismatched_leaves"]:
        raise AssertionError(f"mesh train steps differ from the meshless "
                             f"ones in {len(bad)} leaves")
    if not rec["decode_float32"]["tokens_equal"]:
        raise AssertionError("mesh float32 decode tokens differ")
    if rec["prefill"]["max_abs_logit_diff"] != 0.0:
        raise AssertionError(f"mesh prefill logits differ from the meshless "
                             f"ones by {rec['prefill']['max_abs_logit_diff']}")
    return counts, by_body


DRYRUN_ARCHS = ("phi4_mini_3_8b", "granite_moe_1b_a400m", "jamba_v01_52b",
                "xlstm_1_3b")
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def phase_dryrun(timeout: float, smoke: bool = False, mesh: str = "single",
                 archs=DRYRUN_ARCHS, shapes=DRYRUN_SHAPES):
    """``python -m repro_torch.launch.dryrun`` in two subprocesses at once
    (their fake process groups never meet this process's), each for half
    of DRYRUN_ARCHS, at every assigned shape on the (16, 16) mesh, full
    size unless ``smoke``; no card in the subprocesses. Fails on a failed
    cell or a missing one; prints each cell's dominant term and argument
    bytes a device against the card's 80 GB."""
    import shutil

    out = ROOT / "build" / ("dryrun_smoke" if smoke else "dryrun")
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    procs, logs = [], []
    try:
        for i, part in enumerate(p for p in (archs[0::2], archs[1::2]) if p):
            logs.append(open(out / f"log{i}.txt", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 ",".join(part), "--shape", ",".join(shapes), "--mesh",
                 mesh, "--out", str(out)] + (["--smoke"] if smoke else []),
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT,
                cwd=ROOT))
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    stderr = "".join((out / f"log{i}.txt").read_text()
                     for i in range(len(logs)))
    returncode = max(p.returncode for p in procs)
    wall = time.perf_counter() - t0
    cells = []
    for arch in archs:
        for shape in shapes:
            path = out / f"{arch}__{shape}__{mesh}.json"
            if not path.exists():
                raise AssertionError(f"dryrun wrote no record for {arch} "
                                     f"{shape}: {stderr[-2000:]}")
            r = json.loads(path.read_text())
            cell = {"arch": arch, "shape": shape, "status": r["status"]}
            if r["status"] == "ok":
                cell.update({
                    "dominant": r["dominant"], "roofline": r["roofline"],
                    "argument_bytes": r["memory"]["argument_bytes"],
                    "argument_share_of_80GB":
                        r["memory"]["argument_share_of_hbm"],
                    "useful_flops_ratio": r["useful_flops_ratio"],
                    "collectives": r["op_detail"]["collectives"],
                    "run_s": r["run_s"], "build_s": r["build_s"]})
            else:
                cell["reason"] = r.get("reason", r.get("error"))
            cells.append(cell)
            print(f"  dryrun {arch:22s} {shape:12s} {r['status']:7s} "
                  f"dom={cell.get('dominant', '-')} args/device="
                  f"{cell.get('argument_bytes', 0) / 1e9:.2f} GB of 80",
                  flush=True)
    rec = {"phase": "dryrun", "mesh": mesh, "smoke": smoke,
           "torch": torch.__version__, "returncode": returncode,
           "wall_s": wall, "cells": cells}
    emit(rec)
    failed = [c for c in cells if c["status"] == "failed"]
    if failed or returncode != 0:
        raise AssertionError(f"dryrun: {len(failed)} failed cells, rc "
                             f"{returncode}: {failed[:2]}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="",
                    help="also write the JSON lines to this file")
    args = ap.parse_args()
    if args.out:
        global RT_TRACE
        RT_TRACE = Path(args.out).parent / RT_TRACE.name
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # deterministic cuBLAS for the fault phase: read when cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import (decode_attention, expert_gemm,
                                     flash_attention, ops, slstm_scan,
                                     ssm_scan)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_env()
    with deadline(300, "build"):
        phase_build(ops.KERNELS)
    with deadline(240, "kernel_check"):
        flash_timed = phase_kernel_check(
            flash_attention.flash_kernel, flash_attention.flash_attention_ref,
            flash_attention._body_for, args.seed)
    with deadline(180, "slstm_check"):
        slstm_timed = phase_slstm_check(
            slstm_scan.slstm_kernel, slstm_scan.slstm_scan_ref, args.seed)
    with deadline(180, "ssm_check"):
        ssm_timed = phase_ssm_check(
            ssm_scan.ssm_kernel, ssm_scan.ssm_scan_ref, args.seed)
    with deadline(300, "gemm_check"):
        gemm_timed = phase_gemm_check(
            expert_gemm.expert_kernel, expert_gemm.expert_gemm_ref,
            expert_gemm._body_for, args.seed)
    with deadline(300, "decode_check"):
        decode_timed = phase_decode_check(
            decode_attention.decode_kernel,
            decode_attention.decode_attention_ref, args.seed)

    def two_layers(arch):
        return dataclasses.replace(get_config(arch), n_layers=2,
                                   dtype="float32")

    def serve(name, *a, **kw):
        with deadline(400, f"serve {name}"):
            return phase_serve(*a, **kw)

    def tokens(name, *a, **kw):
        with deadline(400, f"tokens {name}"):
            phase_tokens(*a, **kw)

    phi4, phi4_body = serve("phi4", get_config("phi4_mini_3_8b"), args.seed,
                            (32, 768), {"flash_attention": 32})
    tokens("phi4", two_layers("phi4_mini_3_8b"), args.seed,
           plain_kernel_path=False)
    xlstm, xlstm_body = serve("xlstm", get_config("xlstm_1_3b"), args.seed,
                              (32, 512), {"slstm_scan": 24}, plain_iters=1)
    tokens("xlstm", two_layers("xlstm_1_3b"), args.seed,
           plain_kernel_path=True)
    # Granite-MoE at full width and depth: every layer attention + MoE
    granite_cfg = get_config("granite_moe_1b_a400m")
    granite, granite_body = serve(
        "granite", granite_cfg, args.seed, (32, 512),
        {"expert_gemm": 72, "flash_attention": 24})
    tokens("granite", dataclasses.replace(granite_cfg, dtype="float32"),
           args.seed, plain_kernel_path=False)
    # Jamba at every published width: 16 of 32 layers (two groups of 8)
    # fit one 80 GB card in bf16; each group has 7 Mamba and 1 attention
    # layers
    jamba_cfg = get_config("jamba_v01_52b")
    jamba, jamba_body = serve(
        "jamba", dataclasses.replace(jamba_cfg, n_layers=16), args.seed,
        (32, 512), {"ssm_scan": 14, "flash_attention": 2, "expert_gemm": 24},
        plain_iters=1)
    tokens("jamba", dataclasses.replace(jamba_cfg, n_layers=8,
                                        dtype="float32"),
           args.seed, plain_kernel_path=False)

    # training: the plain paths on the card (no kernel launches), after the
    # Jamba phases have freed the card
    torch.cuda.empty_cache()
    emit({"phase": "train_setup",
          "memory_allocated": torch.cuda.memory_allocated()})
    with deadline(240, "train_check"):
        phase_train_check(two_layers("phi4_mini_3_8b"), args.seed)
    with deadline(300, "train phi4"):
        phase_train(get_config("phi4_mini_3_8b"), args.seed, steps=5)
    with deadline(240, "train granite"):
        granite_train = phase_train(granite_cfg, args.seed, steps=3)
    if not all(0 < r["aux"] < float("inf") for r in granite_train["steps"]):
        raise AssertionError("Granite's MoE aux loss is not finite and > 0")
    with deadline(120, "checkpoint"):
        phase_checkpoint(get_smoke_config("phi4_mini_3_8b"), args.seed)

    # fault-tolerant training and compression: Phi-4-mini at full width,
    # 2 of its 32 layers, bf16
    fault_cfg = dataclasses.replace(get_config("phi4_mini_3_8b"), n_layers=2)
    with deadline(300, "fault"):
        fault_state, fault_batch = phase_fault(fault_cfg, args.seed)
    with deadline(240, "compress"):
        phase_compress(fault_cfg, fault_state["params"], fault_batch,
                       args.seed)
    del fault_state
    torch.cuda.empty_cache()
    with deadline(180, "train_lm"):
        phase_train_lm()
    # the scheduler's real-dispatch path
    with deadline(120, "dispatch"):
        phase_dispatch()
    # the port's scheduler core, dispatching real tasks (K1 among them)
    with deadline(120, "scheduler"):
        sched = phase_scheduler(seed=args.seed)
    # the workload subsystem and the paper's benchmark drivers, on the host
    with deadline(300, "workloads"):
        phase_workloads()
    # the rest of obs and the wall-clock runtime rt: tasks (K1 among them)
    # leased to worker threads that run them on the card
    with deadline(240, "runtime"):
        rt_counts = phase_runtime(seed=args.seed)
    with deadline(240, "serve_batched"):
        batched, batched_body = phase_serve_batched()
    with deadline(300, "serving_replay"):
        replay, replay_body = phase_serving_replay()
    # the mesh layer: a one-device DeviceMesh over NCCL, then the dry run
    with deadline(300, "mesh"):
        mesh_counts, mesh_body = phase_mesh(get_config("phi4_mini_3_8b"),
                                            args.seed)
    with deadline(420, "dryrun"):
        phase_dryrun(timeout=400)

    emit({"phase": "timing", "cuda_ms_retakes": CUDA_MS_RETAKES[0]})
    rec = flash_timed[("phi4_S512", torch.bfloat16)]
    flash_keys = ("B", "S", "Hq", "Hkv", "hd", "max_abs_err", "kernel_ms",
                  "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "sdpa_backends", "sdpa_default_backend")
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": str(flash_attention.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "launches": phi4["flash_attention"],
        "launches_granite": granite["flash_attention"],
        "launches_jamba": jamba["flash_attention"],
        "launches_serve_batched": batched["flash_attention"],
        "launches_serving_replay": replay["flash_attention"],
        "launches_mesh_prefill": mesh_counts["flash_attention"],
        "launches_scheduler": sched["flash_attention"],
        "launches_rt": rt_counts["flash_attention"],
        "launches_by_body": {"phi4": phi4_body["flash_attention"],
                             "granite": granite_body["flash_attention"],
                             "jamba": jamba_body["flash_attention"],
                             "serve_batched": batched_body["flash_attention"],
                             "serving_replay": replay_body[
                                 "flash_attention"],
                             "mesh_prefill": mesh_body["flash_attention"],
                             "scheduler": sched["by_body"],
                             "rt": rt_counts["by_body"]},
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
        "library_note": "torch scaled_dot_product_attention, default "
                        "backend, at the same shape and dtype",
        "sdpa_backends": rec["sdpa_backends"],
        "sdpa_default_backend": rec["sdpa_default_backend"],
        "shape": "B=1 S=T=512 Hq=24 Hkv=8 hd=128 bf16 causal",
        "other_shapes": {label: {key: flash_timed[(label, torch.bfloat16)][key]
                                 for key in flash_keys}
                         for label in ("phi4_S37", "phi4_S1000",
                                       "granite_S512", "jamba_S481")}}, {
        "name": "slstm_scan", "route": "cuda",
        "source": str(slstm_scan.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/slstm_scan.py:76",
        "launches": xlstm["slstm_scan"],
        "launches_by_body": {"xlstm": xlstm_body["slstm_scan"]},
        "max_abs_err": slstm_timed["max_abs_err"],
        "ms": slstm_timed["kernel_ms"],
        "ms_per_step": slstm_timed["ms_per_step"],
        "plain_ms": slstm_timed["plain_ms"],
        "bound_ms": slstm_timed["bound_ms"],
        "bound_by": slstm_timed["bound_by"], "library_ms": None,
        "library_note": LSTM_LIBRARY_NOTE,
        "shape": "B=1 S=512 H=4 dh=512 bf16 pre (xLSTM 1.3B)"}, {
        "name": "ssm_scan", "route": "cuda",
        "source": str(ssm_scan.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/ssm_scan.py:46",
        "launches": jamba["ssm_scan"],
        "launches_by_body": {"jamba": jamba_body["ssm_scan"]},
        "max_abs_err": ssm_timed["max_abs_err"],
        "ms": ssm_timed["kernel_ms"], "plain_ms": ssm_timed["plain_ms"],
        "bound_ms": ssm_timed["bound_ms"],
        "bound_by": ("bytes" if ssm_timed["bound_by"] == "bytes"
                     else "operations"),
        "bound_term": ssm_timed["bound_by"],
        "sm_clock_max_mhz": ssm_timed["sm_clock_max_mhz"],
        "library_ms": None,
        "library_note": SSM_LIBRARY_NOTE,
        "shape": "Bb=1 S=512 d=8192 N=16, u/B/C bf16, dt fp32 (Jamba)"}, {
        "name": "expert_gemm", "route": "cuda",
        "source": str(expert_gemm.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/moe_gemm.py:38",
        "launches": granite["expert_gemm"],
        "launches_jamba": jamba["expert_gemm"],
        "launches_by_body": {"granite": granite_body["expert_gemm"],
                             "jamba": jamba_body["expert_gemm"]},
        "max_abs_err": gemm_timed["jamba_up"]["max_abs_err"],
        "ms": gemm_timed["jamba_up"]["kernel_ms"],
        "plain_ms": gemm_timed["jamba_up"]["plain_ms"],
        "bound_ms": gemm_timed["jamba_up"]["bound_ms"],
        "bound_by": gemm_timed["jamba_up"]["bound_by"],
        "library_ms": gemm_timed["jamba_up"]["library_ms"],
        "library_note": GEMM_LIBRARY,
        "shape": "E=16 M=80 K=4096 N=14336 bf16 (Jamba 512-token prefill, "
                 "up/gate)",
        "other_shapes": {label: {key: gemm_timed[label][key] for key in (
            "E", "M", "K", "N", "max_abs_err", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}
            for label in ("jamba_down", "jamba_decode_up", "granite_up",
                          "granite_down")}}, {
        "name": "decode_attention", "route": "cuda",
        "source": str(decode_attention.SOURCE.relative_to(ROOT)),
        "replaces": None,
        "replaces_note": "no TPU kernel: the reference's decode attention "
                         "is plain jnp; added for the port's decode step",
        "launches": phi4["decode_attention"],
        "launches_granite": granite["decode_attention"],
        "launches_jamba": jamba["decode_attention"],
        "launches_serve_batched": batched["decode_attention"],
        "launches_serving_replay": replay["decode_attention"],
        "launches_by_body": {"phi4": phi4_body["decode_attention"],
                             "granite": granite_body["decode_attention"],
                             "jamba": jamba_body["decode_attention"],
                             "serve_batched": batched_body[
                                 "decode_attention"],
                             "serving_replay": replay_body[
                                 "decode_attention"]},
        "max_abs_err": decode_timed["max_abs_err"],
        "ms": decode_timed["kernel_ms"],
        "split_ms": decode_timed["split_ms"],
        "plain_ms": decode_timed["plain_ms"],
        "bound_ms": decode_timed["bound_ms"],
        "bound_by": decode_timed["bound_by"],
        "library_ms": decode_timed["library_ms"],
        "library_note": DECODE_LIBRARY,
        "shape": "B=32 L=8256 Hq=24 Hkv=8 hd=128 bf16, positions "
                 "log-uniform 1,024-8,192 (phi4-serve-longdoc's decode)"}]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(OUT_LINES) + "\n")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
