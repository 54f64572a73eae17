"""Shared pieces of the scheduler parity tests: the two packages' core
modules side by side, and the signature of a finished run that both must
produce bit for bit.

Job ids come from one module-global counter in each package, so a
signature names jobs by submission order, never by id; enums are compared
by value (each package has its own enum classes)."""
from types import SimpleNamespace

import repro.core as ref_core
import repro.core.executor as ref_executor
import repro.core.multilevel as ref_multilevel
import repro.core.policies as ref_policies
import repro_torch.core as port_core
import repro_torch.core.executor as port_executor
import repro_torch.core.multilevel as port_multilevel
import repro_torch.core.policies as port_policies


def _side(core, executor, multilevel, policies):
    ns = SimpleNamespace(**{name: getattr(core, name)
                            for name in core.__all__})
    ns.executor = executor
    ns.multilevel = multilevel
    ns.policies = policies
    return ns


REF = _side(ref_core, ref_executor, ref_multilevel, ref_policies)
PORT = _side(port_core, port_executor, port_multilevel, port_policies)
SIDES = {"reference": REF, "port": PORT}

FAST = {"central_cost": 1e-4, "queue_coeff": 1e-9, "completion_cost": 1e-5,
        "startup_cost": 1e-3, "cycle_interval": 1e-3}


def fast_profile(m):
    """The reference tests' FAST profile, in package ``m``."""
    return m.LatencyProfile(name="fast", **FAST)


def signature(s, jobs):
    """Every JobStats in submission order, every task's node, times,
    attempts and state, each job's state and counts, and the engine's
    counters and clocks."""
    return {
        "stats": [(st.submit_time, st.first_dispatch, st.last_end,
                   st.task_seconds, st.n_tasks)
                  for st in (s.stats[j.job_id] for j in jobs)],
        "tasks": [[(t.index, t.node_id, t.submit_time, t.dispatch_time,
                    t.start_time, t.end_time, t.attempts, t.state.value,
                    t.speculative_of) for t in j.tasks] for j in jobs],
        "jobs": [(j.state.value, j.completed_tasks, j.failed_tasks,
                  j.n_tasks) for j in jobs],
        "counters": (s.dispatched, s.completed, s.requeues, s.quarantined,
                     s.lost_work_s, s.sched_clock, s.loop.now,
                     s.rm.free_slots(), s.rm.total_slots()),
    }


def both(scenario, *args, **kwargs):
    """``scenario(m, ...)`` on the reference and on the port."""
    return (scenario(REF, *args, **kwargs), scenario(PORT, *args, **kwargs))
