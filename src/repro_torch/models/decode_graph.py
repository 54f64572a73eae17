"""A serving decode step replayed as CUDA graphs, split at the model's spans.

A configuration with ``decode_graph`` serves its decode steps this way on
CUDA tensors with per-lane positions (``Model.decode_step``). The first
step with a parameter tree, a cache tree and a batch captures the step's
own eager code (``Model.forward``) as a chain of graphs that end where the
spans of ``SPLIT`` begin and end: one graph for each layer's mixer
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

The graphs read the parameters and write the caches where they lie: the
trees must be written in place (the engine's are), and a step with another
tree or batch captures anew. A graph replays kernels without their
wrappers, which count launches (``ops.KERNELS``), so a step that launches a
counted kernel is refused; so is a host read inside the step, which a
capture cannot hold. The graphs share one memory pool and replay in the
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


class DecodeGraphs:
    """The captured chain of one model, parameter tree, cache tree and
    batch; called with a step's tokens [B, 1] and positions [B], it
    replays the chain and returns the logits [B, padded_vocab]."""

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
        counts = ops.launch_counts()

        def forward():
            return model.forward(params, self.token, caches=caches,
                                 cache_index=self.index,
                                 use_kernel=model.decode_kernel)[0]
        with torch.cuda.stream(stream):
            forward()          # the warm-up: writes what the replay rewrites
            if ops.launch_counts() != counts:
                raise ValueError(
                    f"{model.cfg.name}: a decode step that launches a "
                    "counted kernel cannot be replayed as graphs (its "
                    "launches would go uncounted)")
            self._open(None)
            spans._capture = self
            try:
                logits = forward()
            finally:
                spans._capture = None
                if self._graph is not None:
                    self._graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        self.logits = logits[:, -1]

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
        # the caller's own tensor, as an eager step's: the next replay
        # rewrites the captured one
        return self.logits.clone()

    # the capture's edges, entered through ``spans.span``
    def _open(self, name):
        self._graph = torch.cuda.CUDAGraph()
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


def decode(model, params, token, caches, cache_index):
    """The logits [B, padded_vocab] of a decode step, replayed from the
    model's captured chain (captured first where none fits)."""
    chain = model.graphs.get("decode")
    if chain is None or not chain.fits(params, token, caches):
        model.graphs.pop("decode", None)
        chain = model.graphs["decode"] = DecodeGraphs(
            model, params, token, caches, cache_index)
    return chain(token, cache_index)
