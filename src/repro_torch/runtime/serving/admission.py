"""SLO-aware admission control (``repro.runtime.serving.admission``).

Every admission is gated on the projected per-user decode rate: a batch
of ``active + 1`` slots gives each user ``1 / step_time(active + 1)``
tokens/s (one token per user per decode step), so an admission that would
take the replica below ``target_tps_user`` keeps the request queued. A
queued request whose wait has already exceeded the TTFT budget is shed,
as is anything beyond ``max_queue``. ``evict_after`` consecutive decode
steps measured below the target evict the youngest slot back to the
queue, shrinking the batch until the others meet the target again.

``step_time_fn(batch) -> seconds`` is the projection; the live client
passes an EMA of its measured step times per batch size.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

ADMIT = "admit"
QUEUE = "queue"
REJECT = "reject"


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    target_tps_user: float = 0.0   # tokens/s/user floor (0 = no gate)
    ttft_budget_s: float = 0.0     # longest queue wait before shedding (0 = never)
    max_queue: int = 0             # queued requests before shedding (0 = unbounded)
    evict_after: int = 8           # consecutive violating steps before an eviction

    def __post_init__(self):
        if self.target_tps_user < 0 or self.ttft_budget_s < 0:
            raise ValueError("SLO targets must be >= 0")
        if self.evict_after < 1:
            raise ValueError(f"evict_after must be >= 1, got {self.evict_after}")


class AdmissionController:
    """One replica's admission gate and sustained-violation detector."""

    def __init__(self, slo: SLOConfig, step_time_fn: Callable[[int], float]):
        self.slo = slo
        self.step_time_fn = step_time_fn
        self._violations = 0
        self.counters = {"admitted": 0, "queued": 0, "rejected": 0, "evicted": 0, "resumed": 0}

    def projected_tps_user(self, batch: int) -> float:
        t = self.step_time_fn(max(1, batch))
        return 1.0 / t if t > 0 else float("inf")

    def decide(self, *, active: int, queue_len: int, queued_for: float) -> str:
        """ADMIT / QUEUE / REJECT for the head of the queue, which has
        waited ``queued_for`` seconds."""
        slo = self.slo
        # its queue wait alone has blown the TTFT budget: shed it
        if slo.ttft_budget_s and queued_for > slo.ttft_budget_s:
            return REJECT
        rate_ok = (not slo.target_tps_user
                   or self.projected_tps_user(active + 1) >= slo.target_tps_user)
        # an idle replica always admits: batch 1 is the best rate it offers
        if rate_ok or active == 0:
            return ADMIT
        if slo.max_queue and queue_len >= slo.max_queue:
            return REJECT
        return QUEUE

    def observe_step(self, step_time: float, active: int) -> bool:
        """Feed one measured decode step; True when the sustained-violation
        eviction should fire (the streak then starts again)."""
        slo = self.slo
        if not slo.target_tps_user or active < 2 or step_time <= 0:
            self._violations = 0
            return False
        if 1.0 / step_time < slo.target_tps_user:
            self._violations += 1
        else:
            self._violations = 0
        if self._violations >= slo.evict_after:
            self._violations = 0
            return True
        return False

    def count(self, kind: str, n: int = 1) -> None:
        self.counters[kind] = self.counters.get(kind, 0) + n
