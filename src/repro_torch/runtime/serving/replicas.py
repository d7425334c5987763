"""Data-parallel replicas behind a router, each on its own clock
(``repro.runtime.serving.replicas``).

N replicas, each a ``ServingScheduler`` over its own client, behind a
least-loaded router that breaks ties by the warm prefill bucket. Replicas
never synchronise: each runs to drain on its own clock, so a slow replica
slows only its own users. The merged metrics divide by the fleet's GPUs
and the slowest replica's horizon.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.runtime.metrics import ServingMetrics


class ReplicaRouter:
    """Least loaded, then a warm prefill bucket, then the lower index."""

    def pick(self, schedulers, req) -> int:
        def key(i):
            s = schedulers[i]
            return (s.load(), not s.client.has_bucket(req.prompt_len), i)

        return min(range(len(schedulers)), key=key)


class MultiReplicaEngine:
    def __init__(self, schedulers, router: Optional[ReplicaRouter] = None):
        if not schedulers:
            raise ValueError("MultiReplicaEngine needs >= 1 replica")
        self.schedulers = list(schedulers)
        self.router = router if router is not None else ReplicaRouter()
        self.assignments: dict[int, int] = {}  # req_id -> replica

    def submit(self, reqs) -> None:
        """Route requests, in arrival order, by each replica's current
        backlog."""
        for req in sorted(reqs, key=lambda r: (r.arrival, r.req_id)):
            i = self.router.pick(self.schedulers, req)
            self.assignments[req.req_id] = i
            self.schedulers[i].submit([req])

    def run(self, max_steps: Optional[int] = None) -> ServingMetrics:
        """Run every replica to drain, one after another, each on its own
        clock, then merge."""
        for s in self.schedulers:
            s.run(max_steps)
        return self.merged_metrics()

    def horizon(self) -> float:
        return max(s.t for s in self.schedulers)

    def kill_rank(self, replica_idx: int, dead_rank: int) -> dict:
        """Fail-stop one generation rank of one replica: the owner
        quarantines it (``ServingScheduler.quarantine_rank``); each migrated
        request goes to the least-loaded replica whose client can restore
        its snapshot's plan (``client.can_resume``), or back to the owner,
        whose admission then replays it from the prompt. Requeued requests
        stay at the head of the owner's queue."""
        src = self.schedulers[replica_idx]
        moved = src.quarantine_rank(dead_rank)
        for req, rec, outputs in moved:
            plan = (req.resume or {}).get("plan")
            cands = [i for i, s in enumerate(self.schedulers)
                     if getattr(s.client, "can_resume", lambda p: True)(plan)]
            i = min(cands, key=lambda j: self.schedulers[j].load()) if cands else replica_idx
            self.schedulers[i].adopt(req, rec, outputs)
            self.assignments[req.req_id] = i
        return {"migrated": len(moved), "requeued": int(src.metrics.recovery.get("requeued", 0))}

    def merged_metrics(self) -> ServingMetrics:
        out = ServingMetrics(num_gpus=sum(s.metrics.num_gpus for s in self.schedulers))
        for s in self.schedulers:
            out.records.extend(s.metrics.records)
            for k, v in s.metrics.admission.items():
                out.record_admission(k, v)
            for k, v in s.metrics.recovery.items():
                out.recovery[k] = out.recovery.get(k, 0) + v
            out.recovery_times.extend(s.metrics.recovery_times)
        return out
