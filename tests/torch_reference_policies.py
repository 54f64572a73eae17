"""The seed reference policies of ``tests/reference_policies.py``, on the
port's core, for the policy-equivalence tests run against the port.

The file is loaded through ``torch_ref_suite`` (its ``repro.core`` imports
rewritten to ``repro_torch.core``), so each reference policy subclasses the
port's ``Policy``. One deliberate difference: the port's ``LocalityPolicy``
counts the licenses it has placed earlier in a cycle, as the backfill and
bin-packing policies do (``src/repro_torch/core/policies.py``, ROADMAP
Queue 3); the seed's locality policy does not, over-assigns licensed tasks,
and then trips ``ResourceManager.allocate``. ``ReferenceLocalityPolicy`` here
is the seed's with that count added and nothing else changed.
"""
from __future__ import annotations

from typing import List

from torch_ref_suite import load

_seed = load("reference_policies")

Assignment = _seed.Assignment
LocalityHint = _seed.LocalityHint
ReferencePolicy = _seed.ReferencePolicy
ReferenceFIFOPolicy = _seed.ReferenceFIFOPolicy
ReferenceBackfillPolicy = _seed.ReferenceBackfillPolicy
ReferenceBinPackingPolicy = _seed.ReferenceBinPackingPolicy


class ReferenceLocalityPolicy(_seed.ReferenceLocalityPolicy):
    """Seed locality, counting licenses within a cycle."""

    def assign(self, jobs, rm, now):
        out: List[Assignment] = []
        pool = rm.free_nodes()
        free = {n.node_id: n.free_slots for n in pool}
        nodes = {n.node_id: n for n in pool}
        lic = dict(rm.licenses)
        for job in jobs:
            hint = self.hints.get(job.job_id, LocalityHint())
            for t in job.pending_tasks():
                if any(lic.get(l, 0) <= 0 for l in t.request.licenses):
                    continue
                if t.request.slots <= 0:
                    cands = [n.node_id for n in rm.up_nodes()
                             if n.fits(t.request)]
                else:
                    cands = [nid for nid, s in free.items()
                             if s >= t.request.slots
                             and nodes[nid].fits(t.request)]
                if not cands:
                    continue
                nid = max(cands, key=lambda n: hint.scores.get(n, 0.0))
                free[nid] = free.get(nid, 0) - t.request.slots
                for l in t.request.licenses:
                    lic[l] -= 1
                out.append((t, nid))
        return out
