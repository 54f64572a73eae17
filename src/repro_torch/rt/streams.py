"""CUDA streams for payloads that run on worker slot threads.

A ``Worker`` runs its ``slots`` payloads on threads of one process. Each
thread starts on the device's shared default stream, so a payload that
waited there would wait for every slot's work, and the slots would run one
after another. ``on_thread_stream`` runs a payload on a stream of its own
thread and waits on an event recorded there after the payload's work: the
task ends when its own work has ended. The wait blocks the thread (the
event is made with ``blocking=True``) rather than spin on a core. Kernels that launch on
``torch.cuda.current_stream`` (K1 among them) follow the stream.

Tensors made on another stream and read by the payload are passed as
``inputs``: ``record_stream`` tells the caching allocator that this stream
uses them, so their memory is not handed out again while it still reads
them. The caller makes them ready (a synchronize) before the run; tensors
the payload allocates itself need nothing.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable

import torch

__all__ = ["thread_stream", "on_thread_stream"]

_LOCAL = threading.local()


def thread_stream(device: torch.device):
    """This thread's own stream on ``device`` and the event its payloads
    wait on, made at their first use. The event blocks the waiting thread
    instead of spinning: a worker runs up to ``slots`` waits at once, and
    spinning threads would take the host's cores from the driver's pump."""
    streams = getattr(_LOCAL, "streams", None)
    if streams is None:
        streams = _LOCAL.streams = {}
    pair = streams.get(device)
    if pair is None:
        pair = streams[device] = (torch.cuda.Stream(device),
                                  torch.cuda.Event(blocking=True))
    return pair


def on_thread_stream(fn: Callable, device,
                     inputs: Iterable[torch.Tensor] = ()):
    """``fn()`` on this thread's stream of ``device``, returned once the
    device has finished it; on the CPU, ``fn()``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return fn()
    stream, done = thread_stream(dev)
    for x in inputs:
        x.record_stream(stream)
    with torch.cuda.stream(stream):
        out = fn()
    done.record(stream)
    done.synchronize()
    return out
