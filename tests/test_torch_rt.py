"""The port's wall-clock runtime (``repro_torch.rt``) and its drivers
against the reference's ``repro.rt``, ``benchmarks/rt_replay.py`` and
``benchmarks/self_latency.py``.

Wall-clock results cannot compare bit for bit; what is deterministic does:
the chaos transport's seeded decisions, the socket framing's bytes, the
virtual-time counts of the self-latency driver (profiler calls, trace
records) and the schema of each driver's results. The reference's scripts
are loaded with ``importlib`` from ``benchmarks/``. Also here: leased
tasks that compute torch tensors, every result checked, and the kernels'
launch counter under concurrent launches."""
import importlib.util
import json
import pickle
import socket
import struct
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.rt as ref_rt  # noqa: E402
import repro.rt.comm as ref_comm  # noqa: E402
import repro_torch.rt as port_rt  # noqa: E402
import repro_torch.rt.comm as port_comm  # noqa: E402
from repro_torch.bench import rt_replay, self_latency  # noqa: E402
from repro_torch.core import Job  # noqa: E402
from repro_torch.core.job import TaskState  # noqa: E402
from repro_torch.kernels.build import KernelLibrary  # noqa: E402
from repro_torch.obs import FlightRecorder  # noqa: E402
from repro_torch.rt.streams import on_thread_stream  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"reference": ref_comm, "port": port_comm}


def _script(name):
    """The reference's ``benchmarks/<name>.py``, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------- chaos
MESSAGES = [("heartbeat", {"worker": f"w{i % 3}", "leases": [str(i)],
                           "free": i % 4}) for i in range(300)]


def _chaos_decisions(comm_mod, monkeypatch, **cfg):
    """Every message the chaos wrapper lets through with the delay it drew,
    its stats, and whether a reset closed the pipe (and after how many
    messages)."""
    released = []
    monkeypatch.setattr(comm_mod.ChaosComm, "_release",
                        lambda self, msg, delay: released.append(
                            (msg, delay)))
    inner = comm_mod.InMemoryTransport()
    got = []
    inner.listen("driver", lambda c: c.set_receiver(
        lambda _c, m: got.append(m)))
    transport = comm_mod.ChaosTransport(inner, seed=7, **cfg)
    comm = transport.connect("driver")
    sent = 0
    for msg in MESSAGES:
        try:
            comm.send(msg)
        except comm_mod.CommClosed:
            break
        sent += 1
    return released, dict(transport.stats), sent, comm.closed, got


@pytest.mark.parametrize("cfg", [
    dict(drop=0.2), dict(dup=0.15), dict(delay=0.05),
    dict(drop=0.12, dup=0.08, delay=0.01), dict(reset=0.02, drop=0.1)],
    ids=["drop", "dup", "delay", "mixed", "reset"])
def test_chaos_decisions_equal_the_references(cfg, monkeypatch):
    ref = _chaos_decisions(ref_comm, monkeypatch, **cfg)
    port = _chaos_decisions(port_comm, monkeypatch, **cfg)
    assert port == ref
    released, stats, sent, closed, got = port
    assert not got                           # every release was captured
    assert stats["sent"] == sent + (1 if closed else 0)
    if "reset" in cfg:
        assert closed and stats["resets"] == 1 and sent < len(MESSAGES)
    else:
        assert not closed and sent == len(MESSAGES)
        assert len(released) == (sent + stats["duplicated"]
                                 - stats["dropped"])


def test_chaos_partition_eats_both_directions(monkeypatch):
    for comm_mod in SIDES.values():
        inner = comm_mod.InMemoryTransport()
        got = []
        inner.listen("d", lambda c: c.set_receiver(
            lambda _c, m: got.append(m)))
        transport = comm_mod.ChaosTransport(inner, seed=1)
        comm = transport.connect("d")
        transport.partition(True)
        comm.send(("claim", {}))
        transport.partition(False)
        comm.send(("bye", {}))
        assert got == [("bye", {})]
        assert transport.stats["partition_dropped"] == 1


# -------------------------------------------------------------- framing
FRAMED = [("lease", {"lease": "1.0.0", "payload": None, "duration": 0.5}),
          ("result", {"worker": "w0", "lease": "1.0.0", "ok": True,
                      "error": None}),
          ("heartbeat", {"worker": "w1", "leases": [str(i) for i in
                                                    range(20_000)]}),
          ("claim", {"worker": "w2", "slots": 8, "free": 0, "x": b"\0" * 70_000})]


def _frames(comm_mod):
    """The bytes a comm writes for ``FRAMED``, read raw off a socket pair,
    and the messages its peer comm decodes from them."""
    a, b = socket.socketpair()
    sender = comm_mod._SocketComm(a, "sender")
    for msg in FRAMED:
        sender.send(msg)
    want = sum(4 + len(pickle.dumps(m, protocol=pickle.HIGHEST_PROTOCOL))
               for m in FRAMED)
    raw = b""
    while len(raw) < want:
        raw += b.recv(want - len(raw))
    sender.close()
    c, d = socket.socketpair()
    receiver = comm_mod._SocketComm(d, "receiver")
    c.sendall(raw)
    decoded = [receiver.recv(timeout=10.0) for _ in FRAMED]
    c.close()
    receiver.close()
    b.close()
    return raw, decoded


def test_socket_framing_equals_the_references():
    ref_raw, ref_msgs = _frames(ref_comm)
    raw, msgs = _frames(port_comm)
    assert raw == ref_raw
    assert msgs == ref_msgs == FRAMED
    # the frame: a 4-byte big-endian length, then the pickle
    (n,) = struct.unpack("!I", raw[:4])
    assert pickle.loads(raw[4:4 + n]) == FRAMED[0]


def test_socket_listener_close_ends_its_accept_thread():
    """The port's listener wakes and joins its accept thread on close
    (the reference leaves it blocked in accept())."""
    transport = port_comm.SocketTransport()
    listener = transport.listen("127.0.0.1:0", lambda comm: None)
    comm = transport.connect(listener.address)
    listener.close()
    comm.close()
    assert not listener._thread.is_alive()


# ------------------------------------------------------------ payloads
RESULTS = {}
INPUTS = [torch.randn(32, 32, generator=torch.Generator().manual_seed(i))
          for i in range(64)]


def _tanh_square(i):
    """A leased task's payload: tanh(x @ x) of the i-th input, on this
    thread's stream (the CPU here), kept for the check."""
    x = INPUTS[i]
    RESULTS[i] = on_thread_stream(lambda: torch.tanh(x @ x), x.device, (x,))


port_rt.register_payload("torch_tanh_square", _tanh_square)


@pytest.mark.parametrize("transport", ["memory", "socket"])
def test_leased_torch_tasks_are_all_computed(transport):
    RESULTS.clear()
    if transport == "socket":
        t = port_rt.SocketTransport()
        address = "127.0.0.1:0"
    else:
        t = port_rt.InMemoryTransport()
        address = "driver"
    rt = port_rt.AsyncRuntime(t, address=address, lease_ttl=30.0,
                              heartbeat_interval=0.2, heartbeat_timeout=2.0)
    rec = FlightRecorder().attach(rt.sch)
    pool = port_rt.WorkerPool(t, rt.address, 4, slots=2,
                              hb_every=0.05).start()
    try:
        job = Job.array(len(INPUTS), payloads=[
            port_rt.FnPayload("torch_tanh_square", i)
            for i in range(len(INPUTS))])
        rt.submit(job)
        assert rt.run_until_idle(timeout=60.0), rt.summary()
    finally:
        pool.stop()
        rt.close()
    assert all(t.state is TaskState.COMPLETED for t in job.tasks)
    assert rt.accepted_results == len(INPUTS) and not rt.errors
    assert rec.counts()["complete"] == len(INPUTS)
    assert sorted(RESULTS) == list(range(len(INPUTS)))
    for i, x in enumerate(INPUTS):
        assert torch.equal(RESULTS[i], torch.tanh(x @ x))


def test_a_raising_payload_fails_its_task():
    port_rt.register_payload("torch_raises", lambda: 1 / 0)
    t = port_rt.InMemoryTransport()
    rt = port_rt.AsyncRuntime(t, lease_ttl=30.0, heartbeat_interval=0.2,
                              heartbeat_timeout=2.0)
    pool = port_rt.WorkerPool(t, rt.address, 1, hb_every=0.05).start()
    try:
        job = Job.array(1, payloads=[port_rt.FnPayload("torch_raises")])
        rt.submit(job)
        assert rt.run_until_idle(timeout=30.0), rt.summary()
    finally:
        pool.stop()
        rt.close()
    assert job.tasks[0].state is TaskState.FAILED
    assert "ZeroDivisionError" in rt.errors[job.tasks[0].key]


def _submitted_before_register(rt_mod, core_mod, timeout):
    """A job the pump has taken before any worker registered (the order a
    socket's reader thread can produce under load), then one worker."""
    t = rt_mod.InMemoryTransport()
    rt = rt_mod.AsyncRuntime(t, lease_ttl=30.0, heartbeat_interval=0.05,
                             heartbeat_timeout=2.0)
    job = core_mod.Job.array(4, duration=0.0)
    rt.submit(job)
    rt.step()
    pool = rt_mod.WorkerPool(t, rt.address, 1, hb_every=0.02).start()
    try:
        idle = rt.run_until_idle(timeout=timeout)
    finally:
        pool.stop()
        rt.close()
    return idle, rt.leases_granted, rt.up_workers


def test_a_job_submitted_before_the_first_register_runs():
    """The port's repair (ROADMAP Queue 3): a worker's first registration
    wakes the scheduler. The reference's runtime leaves the job waiting
    with the worker's node UP and free, no lease granted: the cause of
    tests/test_rt.py's socket failures under load."""
    import repro.core as ref_core
    import repro_torch.core as port_core

    assert _submitted_before_register(port_rt, port_core, 30.0) == \
        (True, 4, 1)
    assert _submitted_before_register(ref_rt, ref_core, 1.0) == (False, 0, 1)


def test_rt_exports_the_references_names():
    assert port_rt.__all__ == ref_rt.__all__
    assert port_rt.WALL.cycle_interval == ref_rt.WALL.cycle_interval == 0.0
    assert port_rt.worker.PAYLOADS is not ref_rt.worker.PAYLOADS


# ------------------------------------------------------------- drivers
def _schema(x):
    if isinstance(x, dict):
        return {k: _schema(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_schema(v) for v in x[:1]]
    return type(x).__name__


def test_self_latency_counts_and_schema_equal_the_references(tmp_path,
                                                             capsys):
    """--quick's parts on both (the reference's own --quick writes its
    trace under experiments/, so its functions run here with tmp_path)."""
    ref = _script("self_latency")
    for wave in (True, False):
        a = ref.profile_phases(4096, 256, wave)
        b = self_latency.profile_phases(4096, 256, wave)
        assert {p: (r["calls"], r["sampled"]) for p, r in b.items()
                if not p.startswith("_")} == \
            {p: (r["calls"], r["sampled"]) for p, r in a.items()
             if not p.startswith("_")}
        assert _schema(b) == _schema(a)
    assert self_latency.trace_roundtrip(tmp_path) == \
        ref.trace_roundtrip(tmp_path)
    pts = self_latency.sweep((1024, 2048), 64, True, 1, verbose=False)
    ref_pts = ref.sweep((1024, 2048), 64, True, 1, verbose=False)
    assert _schema(self_latency.fit_points(pts)) == \
        _schema(ref.fit_points(ref_pts))
    jobs = self_latency.sweep_jobs((64, 128), 4, 64, True, 1, verbose=False)
    assert [n for n, _ in jobs] == [n for n, _ in ref.sweep_jobs(
        (64, 128), 4, 64, True, 1, verbose=False)] == [256, 512]
    for name in ("P", "TRIALS", "N_SWEEP", "N_QUICK", "J_WIDTH", "J_SWEEP",
                 "J_QUICK"):
        assert getattr(self_latency, name) == getattr(ref, name), name
    assert vars(self_latency.ZERO) == vars(ref.ZERO)
    assert self_latency.main(["--quick"]) == 0
    assert "self-latency smoke OK" in capsys.readouterr().out


def _steady_fits(monkeypatch, mod, r2=None):
    """Small sweeps in ``mod``; with ``r2``, every fit reports it (wall
    points this small on a loaded CPU need not fit a power law)."""
    monkeypatch.setattr(mod, "N_SWEEP", (4096, 8192, 16384))
    monkeypatch.setattr(mod, "J_SWEEP", (256, 512))
    if r2 is not None:
        fit_points = mod.fit_points
        monkeypatch.setattr(mod, "fit_points", lambda pts: {
            **fit_points(pts), "r2": r2})


def test_self_latency_writes_only_its_out(tmp_path, monkeypatch, capsys):
    """The full run at small sizes: the artifact's schema equals the
    reference's at the same sizes, and the JSON goes only to --out."""
    ref = _script("self_latency")
    for mod in (ref, self_latency):
        _steady_fits(monkeypatch, mod, r2=1.0)
    out = tmp_path / "sl.json"
    assert self_latency.main(["--P", "256", "--trials", "1", "--out",
                              str(out)]) == 0
    got = json.loads(out.read_text())
    want = ref.main(["--P", "256", "--trials", "1", "--out",
                     str(tmp_path / "ref.json")])
    assert want == 0
    assert _schema(got) == _schema(json.loads(
        (tmp_path / "ref.json").read_text()))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ref.json",
                                                          "sl.json"]
    capsys.readouterr()


def test_self_latency_gate_fails_a_wave_fit_below_r2_0_99(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    _steady_fits(monkeypatch, self_latency, r2=0.98)
    with pytest.raises(SystemExit, match="r2=0.9800 < 0.99"):
        self_latency.main(["--P", "256", "--trials", "1", "--out",
                           str(tmp_path / "sl.json")])
    assert not list(tmp_path.iterdir())
    capsys.readouterr()


def test_rt_replay_quick_counts_and_schema_equal_the_references(capsys):
    ref = _script("rt_replay")
    for name in ("WORKERS", "SLOTS", "TRIALS", "N_MEM", "N_SOCK", "N_QUICK",
                 "POINT_TIMEOUT"):
        assert getattr(rt_replay, name) == getattr(ref, name), name
    fit = rt_replay.sweep("in_memory", port_rt.InMemoryTransport,
                          rt_replay.N_QUICK, 1)
    ref_fit = ref.sweep("in_memory", ref_rt.InMemoryTransport, ref.N_QUICK, 1)
    assert _schema(fit) == _schema(ref_fit)
    assert [p["n"] for p in fit["points"]] == \
        [p["n"] for p in ref_fit["points"]] == list(rt_replay.N_QUICK)
    jobs = []
    soak = rt_replay.chaos_soak(seed=0, jobs_into=jobs)
    ref_soak = ref.chaos_soak(seed=0)
    assert _schema(soak) == _schema(ref_soak)
    for s in (soak, ref_soak):
        assert s["jobs_expected"] == s["jobs_retired"] == 2
        assert s["leases_outstanding"] == 0
        assert s["sch_completed"] + s["sch_quarantined"] >= 80
    assert all(t.state in (TaskState.COMPLETED, TaskState.QUARANTINED)
               for j in jobs for t in j.tasks)
    assert rt_replay.main(["--quick", "--check-baseline"]) == 0
    out = capsys.readouterr().out
    assert "virtual-clock anchor OK" in out and "rt-replay smoke OK" in out


def test_rt_replay_times_its_anchor_once_its_threads_end(monkeypatch,
                                                       capsys):
    """``--check-baseline`` times the virtual-clock anchor only after the
    worker, heartbeat and chaos-delivery threads of the smoke have ended."""
    before = {t.ident for t in threading.enumerate()}
    alive = []
    monkeypatch.setattr(rt_replay, "check_baseline", lambda: alive.append(
        [t.name for t in threading.enumerate() if t.ident not in before]))
    assert rt_replay.main(["--quick", "--check-baseline"]) == 0
    assert alive == [[]]
    capsys.readouterr()


def test_rt_replay_sweeps_a_given_job():
    """``make_job`` puts real payloads behind the sweep; each n runs its
    job once a trial."""
    made = []

    def make(n):
        made.append(n)
        return Job.array(n, payloads=[port_rt.FnPayload(
            "torch_tanh_square", i % len(INPUTS)) for i in range(n)])

    fit = rt_replay.sweep("in_memory", port_rt.InMemoryTransport, (16, 32),
                          2, make_job=make)
    assert made == [16, 16, 32, 32]
    assert [p["n"] for p in fit["points"]] == [16, 32]


# ------------------------------------------------------ launch counter
class _Counted(KernelLibrary):
    source = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
    name = "counted"


@pytest.mark.parametrize("round_", range(3))
def test_launch_counter_is_exact_under_threads(round_):
    """8 threads count 10,000 launches each, switching threads every
    microsecond: not one is lost (worker slot threads launch kernels at
    once; an unlocked count loses thousands in most rounds)."""
    lib = _Counted()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda b=b: [
            lib._count(b) for _ in range(10_000)])
            for b in ("wgmma", "fma") * 4]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sys.setswitchinterval(old)
    assert lib.launches_by_body == {"wgmma": 40_000, "fma": 40_000}
    assert lib.launches == 80_000

