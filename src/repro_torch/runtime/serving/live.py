"""Replica client over a live context and generation server
(``repro.runtime.serving.live``).

Wraps one (params, ContextServer, GenerationServer) trio, usually a
``DisaggregatedEngine``'s, behind the scheduler's client surface: an
admission runs a bucketed prefill (its captured graph on the card), a
decode tick the generation server's step, an eviction snapshots the
slot's decode state to the host (``GenerationServer.snapshot_slot``) and
a resume writes it back into a slot in place, so the captured graphs keep
reading the same tensors. Each request is attributed the gathered wire
bytes and predictive counters as ``DisaggregatedEngine.run`` attributes
them (a decode step's bytes over the active slots of each request's data
replica, ``GenerationServer.step_shares``). Durations are host seconds read after the device has finished; the
admission projection is an EMA of the measured step times per batch size.

``num_gpus`` defaults to 1: the port runs a replica's logical ranks (G' on
``(1, G')``, all eight on ``(2, 4)``) on one card, so a summary's
``tps_per_gpu`` is per card.

``RoutedTraceRecorder`` is a scheduler ``on_step`` hook that collects each
decode step's per-rank routed-expert bitmaps
(``GenerationServer.routed_bitmaps``).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.runtime.engine import validate_restore_plan


class LiveReplicaClient:
    def __init__(self, params, ctx, gen, *, num_gpus: int = 1):
        self.params = params
        self.ctx = ctx
        self.gen = gen
        self.num_slots = gen.max_batch
        self.num_gpus = num_gpus
        self._step_ema: dict[int, float] = {}
        self._active: list = []

    @classmethod
    def from_engine(cls, engine, *, num_gpus: int = 1):
        return cls(engine.params, engine.ctx, engine.gen, num_gpus=num_gpus)

    def _now(self) -> float:
        """The host clock after the device has finished the work queued so
        far."""
        device = self.gen.model.device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def warmup(self, tables=()) -> int:
        """Capture every prefill bucket and the decode variant of each table
        (and the installed one) off the serving path; returns the decode
        captures made."""
        self.ctx.warmup(self.params)
        made = self.gen.warmup(self.params, tables)
        self._now()
        return made

    def admit(self, slot: int, req) -> tuple:
        t0 = self._now()
        if req.resume is not None:
            self.gen.admit(slot, req.req_id, req.resume["token"], req.resume)
            return None, self._now() - t0
        first, state = self.ctx.prefill(self.params, req.tokens)
        self.gen.admit(slot, req.req_id, first, state)
        return first, self._now() - t0

    def attribute_admit(self, rec) -> None:
        rec.add_gather_share(self.ctx.gather_bytes)

    def step(self, active: list) -> tuple:
        self._active = list(active)
        t0 = self._now()
        toks = self.gen.decode_step(self.params)
        dur = self._now() - t0
        b = len(active)
        ema = self._step_ema.get(b)
        self._step_ema[b] = dur if ema is None else 0.7 * ema + 0.3 * dur
        return toks, dur

    def attribute_step(self, recs) -> None:
        """``recs``: the records of the last step's active slots, in order."""
        share = 1.0 / max(1, len(recs))
        shares = self.gen.step_shares(self._active)
        for rec, gather_share in zip(recs, shares, strict=True):
            rec.add_gather_share(self.gen.gather_bytes, gather_share)
            if self.gen.last_pred_stats is not None:
                rec.add_predict_share(self.gen.last_pred_stats, self.gen.expert_bytes, share)

    def step_time(self, batch: int) -> float:
        b = max(1, int(batch))
        if b in self._step_ema:
            return self._step_ema[b]
        if self._step_ema:
            # the nearest measured batch: decode steps vary slowly with it
            return self._step_ema[min(self._step_ema, key=lambda k: abs(k - b))]
        return 0.0  # nothing measured yet: admission never blocks on it

    def release(self, slot: int) -> None:
        self.gen.release(slot)

    def evict(self, slot: int) -> dict:
        snap = self.gen.snapshot_slot(slot)
        self.gen.release(slot)
        return snap

    def kill_rank(self, dead_rank: int, active_slots=()) -> dict:
        """Fail-stop one generation rank (the JAX package swaps in a standby
        engine re-sharded onto the survivors and prices the stall with
        ``roofline.rank_death_recovery``). Not ported yet."""
        raise NotImplementedError(
            "kill_rank needs a standby engine re-sharded onto the surviving ranks "
            "(prefetch.reshard_split_bank, the faults slice) and "
            "roofline.rank_death_recovery (the cost-model slice); neither is ported yet")

    def can_resume(self, plan) -> bool:
        """True when a snapshot stamped with ``plan`` restores on this
        replica's active plan."""
        try:
            validate_restore_plan(plan, self.gen.restore_plan())
        except ValueError:
            return False
        return True

    def has_bucket(self, prompt_len: int) -> bool:
        return prompt_len in self.ctx.prefill_lens


class RoutedTraceRecorder:
    """Scheduler ``on_step`` hook collecting each decode step's routed
    bitmaps."""

    def __init__(self, group: Optional[str] = None):
        self.group = group
        self.bitmaps: list = []

    def __call__(self, client) -> None:
        bm = client.gen.routed_bitmaps(self.group)
        if bm is not None:
            self.bitmaps.append(bm)

    def as_array(self) -> np.ndarray:
        """(steps, ranks, num_experts) bool."""
        return np.stack(self.bitmaps)
