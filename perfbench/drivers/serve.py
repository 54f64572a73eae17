"""Serving driver: clients of ``repro_torch.serving.ServingEngine``.

The program under test is the engine, driven through ``submit`` and
``step`` with the benchmark's weights. Clients stand on the benchmark's
side: ``arrival: "closed"`` keeps ``clients`` clients, each sending its
next request (the traffic generator's next) as soon as its last one
completes. A token is delivered when the ``step()`` that produced it
returns: that moment is its time on the client's side.

Set-up: the weights, the engine, a warm-up request at the mix's longest
prompt (its prefill and one decode step), then ``warmup_steps`` steps of
the clients' loop, so that the window opens on a loop in its steady
state. The window opens at
a step boundary and closes at the first one after ``seconds``; a request
sent in it and still without its first token is followed to it.

Traced runs (``--trace 1``) wrap the engine's model in a proxy that
times each prefill to its end on the device, and name the engine's calls
``bench.step``, ``bench.prefill`` and ``bench.decode`` for the trace.

Afterwards the check: a sample of the requests finished in the window,
drawn from the seed, with the longest among them, of at least
``check.served_tokens`` served tokens; the reference's logits over each
prompt and its served tokens; the widest gap by which a served token's
logit lies below the reference's best at its position.
"""
from __future__ import annotations

import contextlib
import gc
import json
import resource
import time
from types import SimpleNamespace

import torch
from torch.profiler import record_function

from perfbench import traffic
from perfbench.trace import profiled


class _TimedModel:
    """The engine's model with each prefill timed to its end on the device
    and the calls named for the profiler."""

    def __init__(self, model, prefills: list, cuda: bool):
        self._model, self._prefills, self._cuda = model, prefills, cuda

    def prefill(self, params, tokens, *args, **kw):
        with record_function("bench.prefill"):
            t0 = time.perf_counter()
            out = self._model.prefill(params, tokens, *args, **kw)
            if self._cuda:
                torch.cuda.synchronize()
            self._prefills.append((t0, time.perf_counter(),
                                   int(tokens.shape[1])))
        return out

    def decode_step(self, *args, **kw):
        with record_function("bench.decode"):
            return self._model.decode_step(*args, **kw)

    def __getattr__(self, name):
        return getattr(self._model, name)


class _Clients:
    """Closed-loop clients and what they saw."""

    def __init__(self, engine, stream, n: int):
        from repro_torch.serving import ServeRequest

        self._make = ServeRequest
        self.engine, self.stream, self.n = engine, stream, n
        self.open = {}            # client -> record of its outstanding request
        self.records = []

    def send(self, now: float, in_window: bool) -> None:
        for c in range(self.n):
            if c not in self.open:
                spec = next(self.stream)
                req = self._make(prompt=spec.prompt,
                                 max_new_tokens=spec.max_new_tokens)
                rec = SimpleNamespace(req=req, index=spec.index, send=now,
                                      times=[], in_window=in_window,
                                      prompt_len=len(spec.prompt),
                                      n_out=spec.max_new_tokens, done=None)
                self.records.append(rec)
                self.open[c] = rec
                self.engine.submit(req)

    def seen(self, now: float) -> int:
        """Record the tokens the last step delivered; free the clients
        whose request completed. Returns the tokens delivered."""
        delivered = 0
        for c, rec in list(self.open.items()):
            new = len(rec.req.output) - len(rec.times)
            if new > 0:
                rec.times.extend([now] * new)
                delivered += new
            if rec.req.done:
                rec.done = now
                del self.open[c]
        return delivered


def run(ctx) -> SimpleNamespace:
    from repro_torch.kernels import ops
    from repro_torch.serving import ServeRequest, ServingEngine

    mix, cfg, dev = ctx.mix, ctx.model_cfg, ctx.device
    cuda = torch.device(dev).type == "cuda"
    vocab = ctx.cfg["vocab_size"]
    marks = {"start": time.perf_counter() - ctx.t_start}
    params = ctx.ref.make_params(ctx.cfg, ctx.seed, dev)
    engine = ServingEngine(cfg, params, lanes=mix["lanes"],
                           max_len=mix["max_len"],
                           use_kernel=mix["use_kernel"])
    if cuda:
        torch.cuda.synchronize()
    marks["engine"] = time.perf_counter() - ctx.t_start
    prefills: list = []
    if ctx.trace:
        engine.model = _TimedModel(engine.model, prefills, cuda)

    # warm-up: the longest prompt alone, then the clients' loop
    w = traffic.longest_request(mix, ctx.seed, vocab)
    engine.submit(ServeRequest(prompt=w.prompt, max_new_tokens=2))
    while engine.pending or engine.active_mask.any():
        engine.step()
    marks["longest"] = time.perf_counter() - ctx.t_start
    clients = _Clients(engine, traffic.requests(mix, ctx.seed, vocab),
                       mix["clients"])
    for _ in range(mix["warmup_steps"]):
        clients.send(time.perf_counter(), in_window=False)
        engine.step()
        clients.seen(time.perf_counter())
    if cuda:
        torch.cuda.synchronize()
    launches0 = {k: dict(v.launches_by_body) for k, v in ops.KERNELS.items()}
    prefills.clear()

    seconds = min(ctx.seconds, mix.get("trace_seconds", ctx.seconds)) \
        if ctx.trace else ctx.seconds
    out = {}
    steps = []
    admits = []                   # per step: (prompts admitted, their tokens)
    tokens = 0
    marks["warm"] = time.perf_counter() - ctx.t_start
    gc0 = [g["collections"] for g in gc.get_stats()]
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    with (profiled(ctx.trace_path, out, cuda) if ctx.trace
          else contextlib.nullcontext()):
        t0 = time.perf_counter()       # after the profiler has started
        setup_s = t0 - ctx.t_start
        while True:
            clients.send(time.perf_counter(), in_window=True)
            queued = list(engine.pending)
            a = time.perf_counter()
            with (record_function("bench.step") if ctx.trace
                  else contextlib.nullcontext()):
                engine.step()
            t = time.perf_counter()
            steps.append((a, t))
            taken = queued[:len(queued) - len(engine.pending)]
            admits.append((len(taken), sum(len(r.prompt) for r in taken)))
            tokens += clients.seen(t)
            if t - t0 >= seconds:
                break
    t1 = t
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    host = {"cpu_s": (ru1.ru_utime + ru1.ru_stime)
            - (ru0.ru_utime + ru0.ru_stime),
            "voluntary_switches": ru1.ru_nvcsw - ru0.ru_nvcsw,
            "involuntary_switches": ru1.ru_nivcsw - ru0.ru_nivcsw,
            "gc_collections": [g["collections"] - c for g, c in
                               zip(gc.get_stats(), gc0)]}
    _write_steps(ctx, steps, admits, t0)
    # follow the window's requests to their first token, sending no more,
    # for at most follow_s past the close: one still without it has failed
    while any(r.in_window and not r.times for r in clients.records):
        if time.perf_counter() - t1 > mix["follow_s"] or not (
                engine.pending or engine.active_mask.any()):
            break
        engine.step()
        clients.seen(time.perf_counter())
    counters = {k: {b: n - launches0[k].get(b, 0)
                    for b, n in v.launches_by_body.items()
                    if n - launches0[k].get(b, 0)}
                for k, v in ops.KERNELS.items()}
    memory_peak = (torch.cuda.max_memory_allocated() if cuda else 0)

    window_reqs = [r for r in clients.records if r.in_window]
    finished = [r for r in clients.records
                if r.done is not None and t0 <= r.done <= t1]
    sample = _sample(finished, ctx.seed, mix["check"]["served_tokens"])
    checked = [(list(r.req.prompt), list(r.req.output)) for r in sample]
    clients_records = clients.records

    del engine, params, clients
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    gaps = served_gaps(ctx, checked, quant=ctx.control)
    return SimpleNamespace(
        kind="serve", cfg=ctx.cfg, mix=mix, setup_s=setup_s,
        window=(t0, t1), steps=steps, tokens=tokens, requests=window_reqs,
        token_times=[r.times for r in clients_records],
        prefills=prefills, counters=counters, memory_peak=memory_peak,
        attempted=len(window_reqs),
        failed=sum(1 for r in window_reqs if not r.times),
        checks={"served_gap": gaps["gap"]},
        control={"served_gap": gaps["control_gap"]} if ctx.control else None,
        check_notes={"requests": len(checked),
                     "tokens": sum(len(o) for _, o in checked),
                     "setup_marks_s": marks, "steps": len(steps),
                     "step_ms_mean": 1e3 * sum(b - a for a, b in steps)
                     / max(len(steps), 1),
                     "window_host": host,
                     "window_steps": _step_summary(steps, admits),
                     "served_tokens": tokens},
        trace=out.get("trace"))


def _step_summary(steps, admits) -> dict:
    """The window's steps split by whether they admitted a prompt: count
    and seconds of each kind, prompt tokens admitted, the slowest step."""
    pre = [(b - a, n, k) for (a, b), (n, k) in zip(steps, admits) if n]
    dec = [b - a for (a, b), (n, _) in zip(steps, admits) if not n]
    return {"prefill_steps": len(pre),
            "prefill_steps_s": sum(d for d, _, _ in pre),
            "prompts": sum(n for _, n, _ in pre),
            "prompt_tokens": sum(k for _, _, k in pre),
            "decode_steps": len(dec), "decode_steps_s": sum(dec),
            "slowest_step_s": max((b - a for a, b in steps), default=0.0)}


def _write_steps(ctx, steps, admits, t0) -> None:
    """Every step of the window, for a look at where a run lost time:
    [start from the window's open (s), length (s), prompts admitted, their
    tokens], under the checkout's ``build/perfbench/``."""
    path = ctx.trace_path.parent / f"{ctx.workload}.steps.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps([[a - t0, b - a, n, k] for (a, b), (n, k)
                                in zip(steps, admits)]))


def _sample(finished, seed: int, want_tokens: int):
    """Requests drawn from the seed, the longest first, until they hold
    ``want_tokens`` served tokens (or all of them)."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (r.prompt_len + r.n_out, r.index))
    rest = [r for r in finished if r is not longest]
    order = traffic.rng(seed, 6).permutation(len(rest))
    out, n = [longest], len(longest.req.output)
    for i in order:
        if n >= want_tokens:
            break
        out.append(rest[i])
        n += len(rest[i].req.output)
    return out


def served_gaps(ctx, checked, quant=None) -> dict:
    """The reference's judgement of served tokens: over each (prompt,
    served) pair, the gap max(logits) − logits[served token] at every
    position that produced one. Returns {"gap": widest gap (inf where a
    token is outside the vocabulary, or no request was checked),
    "control_gap": with ``quant``, the widest gap of the token the
    reference computed at ``quant`` puts first}."""
    dev = ctx.device
    params = ctx.ref.make_params(ctx.cfg, ctx.seed, dev)
    vocab = ctx.cfg["vocab_size"]
    worst, control = (float("inf") if not checked else 0.0), 0.0
    for prompt, served in checked:
        if not served or any(not 0 <= t < vocab for t in served):
            worst = float("inf")
            continue
        seq = prompt + served[:-1]
        logits = ctx.ref.served_logits(ctx.cfg, params, seq, len(prompt) - 1,
                                       dev)
        best = logits.max(dim=-1).values
        got = logits.gather(-1, torch.as_tensor(served, device=logits.device)
                            [:, None])[:, 0]
        worst = max(worst, float((best - got).max()))
        if quant is not None:
            low = ctx.ref.served_logits(ctx.cfg, params, seq, len(prompt) - 1,
                                        dev, quant=quant)
            first = low.argmax(dim=-1)
            control = max(control, float(
                (best - logits.gather(-1, first[:, None])[:, 0]).max()))
        del logits
    del params
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return {"gap": worst, "control_gap": control}
