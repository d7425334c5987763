"""Continuous-batching scheduler of one replica
(``repro.runtime.serving.scheduler``).

Drives one replica client, admitting queued requests into decode slots as
they free (no fixed-slot epochs), with an optional SLO admission
controller that gates every admission and evicts to the queue on a
sustained violation. ``epoch_mode=True`` keeps the fixed-slot behaviour
(admit only when every slot is free, the engine loop before continuous
batching) for the bitwise comparisons.

The client's surface::

    num_slots: int                  # decode slots
    num_gpus: int                   # for ServingMetrics
    admit(slot, req)  -> (first_token | None, seconds)
    step(active)      -> (tokens | None, seconds)   # a token per slot
    release(slot)
    evict(slot)       -> dict       # snapshot payload; the slot is freed
    step_time(batch)  -> seconds    # the admission projection
    has_bucket(len)   -> bool       # warm prefill bucket (the router's hint)
    kill_rank(rank, active_slots) -> report   # fail-stop (quarantine_rank)

The scheduler owns the slot table and the request records; the client
owns the tensors. Time is the sum of the durations the client reports,
so each replica runs on its own clock.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.runtime.metrics import RequestRecord, ServingMetrics
from repro_torch.runtime.serving.admission import ADMIT, QUEUE, REJECT, AdmissionController
from repro_torch.runtime.serving.workload import ServedRequest


class ServingScheduler:
    def __init__(self, client, *, admission: Optional[AdmissionController] = None,
                 epoch_mode: bool = False, metrics: Optional[ServingMetrics] = None,
                 on_step=None):
        self.client = client
        self.admission = admission
        self.epoch_mode = epoch_mode
        self.metrics = metrics if metrics is not None else ServingMetrics(
            num_gpus=getattr(client, "num_gpus", 1))
        self.on_step = on_step      # e.g. a RoutedTraceRecorder
        self.t = 0.0
        self.queue: list[ServedRequest] = []
        self._pending: list[ServedRequest] = []  # future arrivals, in order
        self.slots: list[Optional[ServedRequest]] = [None] * client.num_slots
        self.remaining = [0] * client.num_slots
        self.records: dict[int, RequestRecord] = {}
        self.outputs: dict[int, list[int]] = {}
        self.steps = 0

    # -- load (the router's signal) -----------------------------------------

    def active_count(self) -> int:
        return sum(r is not None for r in self.slots)

    def load(self) -> float:
        """Active, queued and future requests per slot."""
        backlog = self.active_count() + len(self.queue) + len(self._pending)
        return backlog / max(1, self.client.num_slots)

    # -- intake ---------------------------------------------------------------

    def submit(self, reqs) -> None:
        for req in reqs:
            self.records[req.req_id] = RequestRecord(
                req_id=req.req_id, arrival=req.arrival,
                prompt_len=req.prompt_len, target_len=req.target_len,
            )
            self.outputs[req.req_id] = []
            self._pending.append(req)
        self._pending.sort(key=lambda r: (r.arrival, r.req_id))
        self._release_arrivals()

    def _release_arrivals(self) -> None:
        while self._pending and self._pending[0].arrival <= self.t:
            self.queue.append(self._pending.pop(0))

    # -- admission --------------------------------------------------------------

    def _count(self, kind: str) -> None:
        self.metrics.record_admission(kind)
        if self.admission is not None:
            self.admission.count(kind)

    def _admit_into(self, slot: int, req: ServedRequest) -> None:
        rec = self.records[req.req_id]
        try:
            first, dur = self.client.admit(slot, req)
        except ValueError:
            if req.resume is None:
                raise
            # the destination's active plan differs from the snapshot's
            # (engine.validate_restore_plan): replay from the prompt, with
            # a fresh TTFT and the emitted stream restarted
            req.resume = None
            rec.tokens_out = 0
            rec.first_token_time = None
            self.outputs[req.req_id] = []
            self._count("requeued")
            first, dur = self.client.admit(slot, req)
        self.t += dur
        if req.resume is not None:
            self._count("resumed")
            req.resume = None
        else:
            rec.first_token_time = self.t
            rec.tokens_out = 1
            req.remaining = req.target_len - 1
            if first is not None:
                self.outputs[req.req_id].append(int(first))
            attr = getattr(self.client, "attribute_admit", None)
            if attr is not None:
                attr(rec)
        self.slots[slot] = req
        self.remaining[slot] = int(req.remaining)
        self._count("admitted")

    def _admit_phase(self) -> None:
        free = [i for i, r in enumerate(self.slots) if r is None]
        if self.epoch_mode and len(free) < len(self.slots):
            return  # fixed-slot epochs: drain the whole batch first
        for slot in free:
            if not self.queue:
                break
            req = self.queue[0]
            if self.admission is None or req.resume is not None:
                decision = ADMIT
            else:
                decision = self.admission.decide(
                    active=self.active_count(), queue_len=len(self.queue) - 1,
                    queued_for=self.t - req.arrival,
                )
            if decision == QUEUE:
                self._count("queued")
                break
            self.queue.pop(0)
            if decision == REJECT:
                self._count("rejected")
                continue
            self._admit_into(slot, req)

    # -- the decode tick ----------------------------------------------------------

    def step(self) -> bool:
        """One tick: release arrivals, admit, decode once. False when
        nothing is active, queued or pending."""
        self._release_arrivals()
        self._admit_phase()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            if self._pending:
                self.t = max(self.t, self._pending[0].arrival)  # idle until the next arrival
                return True
            return bool(self.queue)
        toks, dur = self.client.step(active)
        self.t += dur
        self.steps += 1
        recs = [self.records[self.slots[i].req_id] for i in active]
        attr = getattr(self.client, "attribute_step", None)
        if attr is not None:
            attr(recs)
        for slot in active:
            req = self.slots[slot]
            rec = self.records[req.req_id]
            if toks is not None:
                self.outputs[req.req_id].append(int(toks[slot]))
            rec.tokens_out += 1
            self.remaining[slot] -= 1
            req.remaining = self.remaining[slot]
            if self.remaining[slot] <= 0:
                rec.done_time = self.t
                self.metrics.records.append(rec)
                self.slots[slot] = None
                self.client.release(slot)
        if self.on_step is not None:
            self.on_step(self.client)
        self._maybe_evict(dur)
        return True

    def _maybe_evict(self, dur: float) -> None:
        if self.admission is None:
            return
        if not self.admission.observe_step(dur, self.active_count()):
            return
        live = [i for i, r in enumerate(self.slots) if r is not None]
        if len(live) < 2:
            return
        # evict the youngest slot (the most work left): it has the least
        # decode time sunk and the most to gain from a later, faster batch
        slot = max(live, key=lambda i: (self.remaining[i], self.slots[i].req_id))
        req = self.slots[slot]
        req.resume = self.client.evict(slot)
        req.remaining = self.remaining[slot]
        self.slots[slot] = None
        self.queue.insert(0, req)  # it already waited: head of the queue
        self._count("evicted")

    # -- fail-stop recovery ----------------------------------------------------------

    def quarantine_rank(self, dead_rank: int) -> list:
        """Fail-stop one generation rank of this replica's client
        (``client.kill_rank``) and sort the active slots by its report:
        migrated slots leave with their snapshot and are returned as
        ``(req, record, outputs)`` for the fleet to :meth:`adopt` elsewhere
        (record and stream travel with the request, so its TTFT stands);
        requeued slots, whose KV shard died, go back to the head of this
        queue and replay from the prompt. No accepted request is dropped."""
        active = [i for i, r in enumerate(self.slots) if r is not None]
        report = self.client.kill_rank(dead_rank, active)
        self.t += float(report.get("seconds", 0.0))
        migrated = []
        for slot, snap in sorted(report.get("migrate", {}).items()):
            req = self.slots[slot]
            req.resume = snap
            req.remaining = self.remaining[slot]
            self.slots[slot] = None
            self.remaining[slot] = 0
            migrated.append((req, self.records.pop(req.req_id), self.outputs.pop(req.req_id)))
        requeued = sorted(report.get("requeue", ()), reverse=True)
        for slot in requeued:
            req = self.slots[slot]
            rec = self.records[req.req_id]
            req.resume = None
            rec.tokens_out = 0
            rec.first_token_time = None
            self.outputs[req.req_id] = []
            self.slots[slot] = None
            self.remaining[slot] = 0
            self.queue.insert(0, req)
            self._count("requeued")
        self.metrics.record_rank_death(migrated=len(migrated), requeued=len(requeued),
                                       seconds=float(report.get("seconds", 0.0)))
        return migrated

    def adopt(self, req: ServedRequest, rec: RequestRecord, outputs: list) -> None:
        """Take over a migrated request from another replica: its record and
        stream move with it, and it resumes from its snapshot at the head of
        this queue (resumes bypass admission)."""
        self.records[req.req_id] = rec
        self.outputs[req.req_id] = list(outputs)
        self.queue.insert(0, req)

    def run(self, max_steps: Optional[int] = None) -> ServingMetrics:
        """Tick until drained (or ``max_steps`` decode steps)."""
        while self.step():
            if max_steps is not None and self.steps >= max_steps:
                break
        return self.metrics
