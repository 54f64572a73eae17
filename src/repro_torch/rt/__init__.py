"""Wall-clock async runtime: lease-based workers over pluggable transports.

The virtual-time engine (``repro_torch.core``) measures modeled
control-plane latency; this package runs the *same* engine against real
workers over real transports, so the paper's (t_s, alpha_s) can be measured
on the wall clock (``repro_torch.bench.rt_replay``) and the fault lifecycle
can be exercised end-to-end under injected worker death, message loss and
lease expiry. See README.md in this directory.

A copy of the reference's ``repro/rt`` with imports rewritten, plus
``streams.py``: the stream rule for payloads that launch on the card.
"""
from repro_torch.rt.comm import (ChaosTransport, Comm, CommClosed,
                                 InMemoryTransport, Listener, Message,
                                 SocketTransport, Transport)
from repro_torch.rt.runtime import WALL, AsyncRuntime, Lease
from repro_torch.rt.worker import (FnPayload, SleepPayload, Worker,
                                   WorkerPool, register_payload)

__all__ = [
    "Message", "CommClosed", "Comm", "Listener", "Transport",
    "InMemoryTransport", "SocketTransport", "ChaosTransport",
    "SleepPayload", "FnPayload", "register_payload",
    "Worker", "WorkerPool",
    "WALL", "Lease", "AsyncRuntime",
]
