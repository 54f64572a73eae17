"""Continuous-batching serving engine — multilevel scheduling for inference.

The paper's result: aggregating many short tasks into one scheduler-visible
job recovers utilisation. For serving, a "task" is one decode step of one
request, and one batched decode dispatch bundles the steps of every active
lane. Admission goes through the scheduler's resource manager: each decode
lane is a node with one slot, and each request is a one-task job placed on
the first free lane. Lanes run at their own cache positions, so a finished
request frees its lane for the next admission at once.

Prefill runs one request at a time into a fresh one-lane cache that is then
copied into the lane: k/v for attention layers, the recurrent states for
Mamba and xLSTM layers. With ``use_kernel`` (the default) prefill attention
goes through ``kernels.ops.flash_attention``, the sLSTM recurrence through
``kernels.ops.slstm_scan``, the Mamba recurrence through
``kernels.ops.ssm_scan`` and the MoE expert products through
``kernels.ops.expert_gemm``, and each decode step's attention through
``kernels.ops.decode_attention``, which reads every lane's cache in place up
to the lane's position: the hand-written kernels on CUDA tensors, their
plain versions on CPU tensors. The rest of a decode step takes the plain
paths. On the card the first decode step is captured as CUDA graphs and
every step replays them (``models/decode_graph.py``). ``use_kernel=False``
runs the model's plain paths, as the reference engine does.

Each step runs in the spans ``engine.step``, ``engine.admit``,
``engine.prefill``, ``engine.scatter``, ``engine.decode`` and
``engine.sample`` (``obs.spans``), which a profiled run records and an
unprofiled one skips.

Idle lanes decode token 0 at their last position, as in the reference
engine; their results are dropped. In MoE layers those tokens take part in
routing and compete for expert capacity, so both engines drop the same
slots.
"""
from __future__ import annotations

import collections
import itertools
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.job import Job, Task
from repro_torch.core.resources import ResourceManager
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.obs.spans import span

_req_ids = itertools.count(1)


@dataclass
class ServeRequest:
    prompt: List[int]
    max_new_tokens: int = 16
    eos_token: int = -1
    request_id: int = field(default_factory=lambda: next(_req_ids))
    # filled by the engine
    output: List[int] = field(default_factory=list)
    submit_time: float = 0.0
    done_time: float = 0.0

    @property
    def done(self) -> bool:
        return (len(self.output) >= self.max_new_tokens
                or (self.eos_token >= 0 and bool(self.output)
                    and self.output[-1] == self.eos_token))


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, lanes: int = 8,
                 max_len: int = 512, use_kernel: bool = True):
        self.cfg = cfg
        self.model = build_model(cfg, decode_kernel=use_kernel)
        self.params = params
        self.device = params["embed"]["tok_embed"].device
        self.lanes = lanes
        self.max_len = max_len
        self.use_kernel = use_kernel
        # lane state
        self.caches = self.model.init_caches(lanes, max_len, self.device)
        self.positions = np.zeros((lanes,), np.int64)   # next write index
        self.lane_req: List[Optional[ServeRequest]] = [None] * lanes
        self.active_mask = np.zeros((lanes,), bool)
        self.pending: Deque[ServeRequest] = collections.deque()
        # admission control via the scheduler's resource manager
        self.rm = ResourceManager()
        self.rm.add_nodes(lanes, slots=1)
        self._lane_jobs: Dict[int, Task] = {}   # lane -> admitted task
        self.steps = 0
        self.decode_tokens = 0

    # ------------------------------------------------------------ admit
    def submit(self, req: ServeRequest) -> None:
        req.submit_time = time.time()
        self.pending.append(req)

    def _admit(self) -> None:
        with span("engine.admit"):
            while self.pending:
                free = [i for i in range(self.lanes)
                        if not self.active_mask[i]]
                if not free:
                    return
                lane = free[0]
                req = self.pending.popleft()
                task = Job.array(1, name=f"req{req.request_id}").tasks[0]
                self.rm.allocate(task, lane)
                self._lane_jobs[lane] = task
                # prefill into this lane
                with span("engine.prefill"):
                    prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                             device=self.device)[None]
                    last, new_caches = self.model.prefill(
                        self.params, prompt, max_len=self.max_len,
                        use_kernel=self.use_kernel)
                self._scatter_lane(lane, new_caches)
                with span("engine.sample"):
                    req.output.append(int(last[0].argmax()))
                    if req.done:
                        # generation stops at the step that produces EOS:
                        # when the prefill token is already terminal (EOS,
                        # or max_new_tokens == 1), activating the lane
                        # would spend a decode dispatch and emit one token
                        # after EOS
                        req.done_time = time.time()
                        self.rm.release(self._lane_jobs.pop(lane))
                        continue
                    self.positions[lane] = len(req.prompt)
                    self.lane_req[lane] = req
                    self.active_mask[lane] = True

    def _scatter_lane(self, lane: int, src_caches) -> None:
        """Copy a one-lane cache tree into lane ``lane`` of the engine cache:
        every leaf, k/v and recurrent states alike (lanes are axis 1)."""
        with span("engine.scatter"):
            for name, tree in self.caches.items():
                for key, dst in tree.items():
                    dst[:, lane] = src_caches[name][key][:, 0]

    # ------------------------------------------------------------- step
    def step(self) -> int:
        """Admit, then one batched decode step; returns #active lanes."""
        with span("engine.step"):
            self._admit()
            active = np.nonzero(self.active_mask)[0]
            if len(active) == 0:
                return 0
            with span("engine.decode"):
                tokens = np.zeros((self.lanes, 1), np.int64)
                for i in range(self.lanes):
                    r = self.lane_req[i]
                    if r is not None:
                        tokens[i, 0] = r.output[-1]
                logits, self.caches = self.model.decode_step(
                    self.params, torch.as_tensor(tokens, device=self.device),
                    self.caches,
                    torch.as_tensor(self.positions, device=self.device))
            with span("engine.sample"):
                next_np = logits.argmax(dim=-1).cpu().numpy()
                self.steps += 1
                self.decode_tokens += len(active)
                for lane in active:
                    req = self.lane_req[lane]
                    req.output.append(int(next_np[lane]))
                    self.positions[lane] += 1
                    if req.done or self.positions[lane] >= self.max_len - 1:
                        req.done_time = time.time()
                        self.active_mask[lane] = False
                        self.lane_req[lane] = None
                        task = self._lane_jobs.pop(lane, None)
                        if task is not None:
                            self.rm.release(task)
            return len(active)

    def run(self, requests: Sequence[ServeRequest]) -> Dict:
        """Serve requests to completion; returns summary stats, among them
        the kernels' launches and the decode steps captured and replayed
        as CUDA graphs (``decode_captures``, ``decode_replays``)."""
        launches0 = ops.launch_counts()
        graphs = self.model.graphs
        captures0, replays0 = graphs.captures, graphs.replays
        t0 = time.time()
        for r in requests:
            self.submit(r)
        while self.pending or self.active_mask.any():
            self.step()
        wall = time.time() - t0
        lat = [r.done_time - r.submit_time for r in requests]
        launches = {f"{name}_launches": n - launches0[name]
                    for name, n in ops.launch_counts().items()}
        return {
            "wall_s": wall,
            "requests": len(requests),
            "decode_steps": self.steps,
            "decode_tokens": self.decode_tokens,
            "tokens_per_dispatch": self.decode_tokens / max(self.steps, 1),
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            "p99_latency_s": float(np.percentile(lat, 99)) if lat else 0.0,
            "throughput_tok_s": self.decode_tokens / max(wall, 1e-9),
            "decode_captures": graphs.captures - captures0,
            "decode_replays": graphs.replays - replays0,
            **launches,
        }
