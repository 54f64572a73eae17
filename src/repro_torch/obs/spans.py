"""Named host ranges on the profiler's clock: the port's one range mechanism.

``span(name)`` is a context manager. While ``torch.profiler`` records
(``torch.autograd._profiler_enabled()``), it enters
``torch.profiler.record_function(name)``, so the range lands in the same
trace as the device's kernels, on the same clock, and a kernel can be
placed by its launch. Otherwise it returns one shared null context and
enters nothing: an unprofiled call costs one check.

Every name the program emits is in ``SPANS``, which the tests hold every
call to. A range inside a block that ``torch.utils.checkpoint``
recomputes is recorded twice a step: in the forward pass and in the
recompute.
"""
from __future__ import annotations

import contextlib

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

SPANS = (
    # launch/steps.py::build_train_step: the train step's three parts
    "train_step.forward", "train_step.backward", "train_step.optimizer",
    # serving/engine.py::ServingEngine
    "engine.step",       # the whole step
    "engine.admit",      # the admission loop
    "engine.prefill",    # one request's prompt on the device and its prefill
    "engine.scatter",    # one lane's cache copy
    "engine.decode",     # the decode inputs and the batched decode step
    "engine.sample",     # an argmax, its readback and the token bookkeeping
    # models/model.py::Model: the model's serving calls, and its head
    "model.prefill", "model.decode", "model.head",
    # models/decode_graph.py::decode: a decode step captured as graphs
    "model.capture",
    # models/transformer.py::block_apply: a layer's mixer, by layer kind
    "model.attn", "model.mla", "model.ssm", "model.mlstm", "model.slstm",
    # models/mla.py::mla_apply: the projections of q and the latent, its
    # norm, RoPE and the cache write; the attention (prefill: the
    # expansion and K1; decode: the absorption products over the latent)
    "mla.latent", "mla.attend",
    # ... and its dense FFN or MoE block
    "model.ffn", "model.moe",
    # models/moe.py::moe_apply: router and aux loss; capacity one-hots,
    # dispatch and the experts' inputs; the expert products; the output
    "moe.route", "moe.dispatch", "moe.experts", "moe.combine",
    # bench/dispatch_latency.py::launches_per_task: one profiled task
    "dispatch_latency.task",
)

_OFF = contextlib.nullcontext()
# the decode step being captured as graphs (models/decode_graph.py), if
# any: a span it splits at is an edge of its graphs
_capture = None


def span(name: str):
    """A ``record_function`` range named ``name`` while the profiler
    records; a shared null context otherwise. While a decode step is
    captured, a span it splits at (``decode_graph.SPLIT``) ends one graph
    and begins the next at each of its edges."""
    if _capture is not None and name in _capture.split:
        return _capture.region(name)
    if not _profiler_enabled():
        return _OFF
    return record_function(name)
