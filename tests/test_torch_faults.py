"""The port's fault plane against the reference's, on the CPU: the same
seeded FaultProfile (node crashes, silent deaths found by heartbeat
sweeps, a rack outage, flaps, mutes, degraded nodes) over the same job
stream gives equal JobStats, equal tasks (node, times, attempts, state),
equal counters and an equal plane summary, with 0 tolerance, on the wave
and the per-event path. The profiles are built from ``FaultProfile``
directly, as in the reference's ``tests/test_faultplane.py``."""
import random

import pytest

pytest.importorskip("torch")

from torch_sched_parity import PORT, REF, both, fast_profile, signature  # noqa: E402,E501

PROFILES = {
    "crash": dict(mtbf=30.0, mttr=3.0),
    "silent": dict(mtbf=60.0, mttr=8.0, silent_fraction=1.0),
    "rack": dict(domain_size=8, domain_mtbf=60.0, domain_mttr=6.0),
    "sink": dict(mtbf=60.0, mttr=5.0, silent_fraction=0.3, flap_mtbf=50.0,
                 flap_mttr=1.0, domain_size=8, domain_mtbf=120.0,
                 domain_mttr=6.0, mute_mtbf=80.0, mute_mttr=5.0,
                 degrade_mtbf=60.0, degrade_mttr=10.0, degrade_factor=4.0),
}
SWEEPS = {"silent", "sink"}


def chaos(m, name, fseed, *, wave, backoff=0.0, quarantine=0, nodes=24,
          n_jobs=60, wseed=5):
    rng = random.Random(wseed)
    rm = m.ResourceManager(heartbeat_timeout=4.0)
    rm.add_nodes(nodes, slots=1)
    cfg = m.SchedulerConfig(wave_batching=wave,
                            heartbeat_interval=1.0 if name in SWEEPS else 0.0,
                            retry_backoff=backoff,
                            quarantine_after=quarantine)
    s = m.Scheduler(rm, profile=fast_profile(m), config=cfg)
    plane = m.FaultPlane(s, m.FaultProfile(name=name, **PROFILES[name]),
                         seed=fseed)
    jobs = []
    for _ in range(n_jobs):
        n = rng.randint(1, 6)
        j = m.Job.array(n, durations=[rng.random() * 4 for _ in range(n)])
        j.max_restarts = 5
        jobs.append(j)
        s.submit(j)
    s.run()
    return {**signature(s, jobs), "plane": plane.summary(),
            "down": sorted(n.node_id for n in rm.nodes.values()
                           if n.state.value != "up")}


@pytest.mark.parametrize("wave", [True, False])
@pytest.mark.parametrize("name,fseed", [("crash", 1), ("crash", 2),
                                        ("silent", 1), ("rack", 3),
                                        ("sink", 2)])
def test_fault_plane_matches(name, fseed, wave):
    ref, port = both(chaos, name, fseed, wave=wave)
    assert port == ref
    injected = port["plane"]["injected"]
    want = {"crash": "crash", "silent": "silent", "rack": "domain_outage",
            "sink": "crash"}[name]
    assert injected[want] > 0
    assert port["counters"][2] > 0           # requeues happened


def test_backoff_and_quarantine_match():
    ref, port = both(chaos, "crash", 4, wave=True, backoff=0.5,
                     quarantine=2)
    assert port == ref


def test_silent_faults_need_sweeps_on_both_sides():
    for m in (REF, PORT):
        rm = m.ResourceManager()
        rm.add_nodes(2, slots=1)
        s = m.Scheduler(rm)
        with pytest.raises(ValueError):
            m.FaultPlane(s, m.FaultProfile(mtbf=10.0, silent_fraction=0.5))


class _Pool:
    n = 4

    def __init__(self):
        self.calls = []

    def __getattr__(self, kind):
        return lambda i: self.calls.append((kind, i))


class _Transport:
    def __init__(self):
        self.calls = []

    def partition(self, on):
        self.calls.append(on)


def test_wall_fault_arm_matches():
    """The wall-clock arm's seeded schedule, delivered on an EventLoop."""
    def run(m):
        runtime = type("Runtime", (), {"loop": m.EventLoop()})()
        pool, transport = _Pool(), _Transport()
        arm = m.WallFaultArm(runtime, pool, transport=transport, seed=9)
        arm.schedule_random(5.0, kills=3, hangs=2, restarts=1, partitions=2)
        arm.at(6.0, "kill", 1)
        with pytest.raises(ValueError):
            arm.at(1.0, "melt")
        runtime.loop.run()
        return arm.fired, arm.summary(), pool.calls, transport.calls
    ref, port = both(run)
    assert port == ref
    assert port[1] == {"kill": 4, "hang": 2, "thaw": 2, "restart": 1,
                       "partition": 2, "heal": 2}
