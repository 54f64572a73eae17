"""A serving decode step replayed as CUDA graphs, split at the model's spans.

Every decode step on plain CUDA tensors with a position for each lane
(``replayed``) is served this way (``Model.decode_step``), unless the
configuration turns it off (``decode_graph``); a DTensor's mesh path and
CPU tensors stay eager. The first step with a parameter tree, a cache tree
and a batch captures the step's own eager code (``Model.forward``), in the
span ``model.capture``, as a chain of graphs that end where the spans of
``SPLIT`` begin and end: one graph for each layer's mixer
(``model.<kind>``), one for each FFN or MoE block (``model.ffn``,
``model.moe``), one for the head (``model.head``), and one for the work
between them (the embedding, the norms and residual adds). Every later step
copies its tokens and positions into the captured inputs and replays the
graphs in order, each inside the span its work runs in eagerly, so a
profiled step records the same spans around the same device work; the
spans nested in them (``mla.*``, ``moe.*``) are not recorded again. The
device work is the eager step's; the host launches one graph where the
eager step launches some thirty kernels, so a step no longer waits on the
host's pace.

A graph replays kernels without their wrappers, which count launches
(``ops.KERNELS``). So each graph is kept after its capture and its kernel
nodes are read (``ops.graph_launches``): that count must equal what the
wrappers counted while the step was captured, which launched nothing and is
taken back, and each replay adds it to the kernels' counts.

The graphs read the parameters and write the caches where they lie: the
trees must be written in place (the engine's are), and a step with another
tree or batch captures anew. A host read inside the step cannot be
captured, and raises. The graphs share one memory pool and replay in the
order they were captured, as that requires. The head ends the step: no
work follows it in ``Model.forward``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.obs import spans

SPLIT = frozenset({"model.attn", "model.mla", "model.ffn", "model.moe",
                   "model.head"})
LAST = "model.head"


class Graphs:
    """A model's captured decode step (``chain``, None before the first),
    and the captures and replays so far: a serving run captures once, in
    its warm-up, and replays every later step."""

    def __init__(self):
        self.chain = None
        self.captures = 0
        self.replays = 0


class DecodeGraphs:
    """The captured chain of one model, parameter tree, cache tree and
    batch; called with a step's tokens [B, 1] and positions [B], it
    replays the chain and returns the logits [B, padded_vocab].
    ``launches`` is what one replay launches of ``ops.KERNELS``, read from
    the graphs' nodes ({kernel name: {body: launches}})."""

    split = SPLIT

    def __init__(self, model, params, token, caches, cache_index):
        self.params, self.caches = params, caches
        self.shape = (tuple(token.shape), token.device)
        self.token, self.index = token.clone(), cache_index.clone()
        self.graphs = []                 # [(span name or None, graph)]
        self._pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())

        def forward():
            return model.forward(params, self.token, caches=caches,
                                 cache_index=self.index,
                                 use_kernel=model.decode_kernel)[0]
        with torch.cuda.stream(stream):
            forward()          # the warm-up: writes what the replay rewrites
            before = ops.launches_by_body()
            self._open(None)
            spans._capture = self
            try:
                logits = forward()
            finally:
                spans._capture = None
                if self._graph is not None:
                    self._graph.capture_end()
                # the wrappers counted the capture, which launched nothing
                counted = ops.launches_since(before)
                ops.count_launches(counted, -1)
        torch.cuda.current_stream().wait_stream(stream)
        self.logits = logits[:, -1]
        self.launches = {}
        for _, graph in self.graphs:
            for name, by_body in ops.graph_launches(
                    graph.raw_cuda_graph()).items():
                into = self.launches.setdefault(name, {})
                for body, n in by_body.items():
                    into[body] = into.get(body, 0) + n
        if self.launches != counted:
            raise RuntimeError(
                f"{model.cfg.name}: the captured decode step's kernel nodes "
                f"hold {self.launches} launches, its wrappers counted "
                f"{counted}")
        for _, graph in self.graphs:
            graph.instantiate()

    def fits(self, params, token, caches) -> bool:
        return (params is self.params and caches is self.caches
                and self.shape == (tuple(token.shape), token.device))

    def __call__(self, token, cache_index):
        self.token.copy_(token)
        self.index.copy_(cache_index)
        for name, graph in self.graphs:
            if name is None:
                graph.replay()
            else:
                with spans.span(name):
                    graph.replay()
        ops.count_launches(self.launches)
        # the caller's own tensor, as an eager step's: the next replay
        # rewrites the captured one
        return self.logits.clone()

    # the capture's edges, entered through ``spans.span``
    def _open(self, name):
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)
        self._graph.capture_begin(pool=self._pool)
        self.graphs.append((name, self._graph))

    def _close(self):
        self._graph.capture_end()
        self._graph = None

    def region(self, name: str):
        return _Region(self, name)


class _Region:
    """A span of ``SPLIT`` met while capturing: its work in a graph of its
    own, the work after it (but after the head) in the next."""

    def __init__(self, chain: DecodeGraphs, name: str):
        self.chain, self.name = chain, name

    def __enter__(self):
        if self.chain._graph is None:
            raise RuntimeError(f"{self.name}: work after {LAST} in a "
                               "captured decode step")
        self.chain._close()
        self.chain._open(self.name)

    def __exit__(self, *exc):
        self.chain._close()
        if self.name != LAST and exc[0] is None:
            self.chain._open(None)
        return False


def replayed(token, cache_index) -> bool:
    """Whether a decode step on these inputs replays graphs: plain CUDA
    tensors (a DTensor, on a mesh, stays eager) with a position for each
    lane."""
    return (type(token) is torch.Tensor and token.is_cuda
            and type(cache_index) is torch.Tensor and cache_index.dim() == 1)


def decode(model, params, token, caches, cache_index):
    """The logits [B, padded_vocab] of a decode step, replayed from the
    model's captured chain (captured first where none fits, in the span
    ``model.capture``)."""
    graphs = model.graphs
    chain = graphs.chain
    if chain is None or not chain.fits(params, token, caches):
        chain = graphs.chain = None      # the old chain's pool goes first
        with spans.span("model.capture"):
            chain = graphs.chain = DecodeGraphs(model, params, token, caches,
                                                cache_index)
        graphs.captures += 1
    graphs.replays += 1
    return chain(token, cache_index)
