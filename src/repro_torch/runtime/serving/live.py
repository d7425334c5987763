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

Fail-stop (:meth:`LiveReplicaClient.kill_rank`): a generation rank dies and
the client swaps in a ``standby`` engine on the survivors' mesh (the model
axis one smaller), as the JAX package does. Where the JAX package takes a
pre-built engine, the port also takes a callable ``standby(dead_rank) ->
engine`` that ``kill_rank`` calls after releasing the dying engine's
graphs: one card does not hold two DeepSeek-R1 weight sets beside a running
engine, so the standby re-shards the weights in place
(``checkpoint.convert.reshard_params``) and captures its steps inside the
recovery.

``RoutedTraceRecorder`` is a scheduler ``on_step`` hook that collects each
decode step's per-rank routed-expert bitmaps
(``GenerationServer.routed_bitmaps``).
"""
from __future__ import annotations

import gc
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import roofline
from repro_torch.runtime.engine import validate_restore_plan


def _check_slots(standby, max_batch: int) -> None:
    if standby.gen.max_batch != max_batch:
        raise ValueError("the standby engine must keep the decode slot count: "
                         f"{standby.gen.max_batch} != {max_batch}")


class LiveReplicaClient:
    """``standby``: the engine :meth:`kill_rank` swaps in, built on the
    survivors' mesh (pre-warmed, it captures nothing at the swap), or a
    callable ``standby(dead_rank) -> engine`` that builds it."""

    def __init__(self, params, ctx, gen, *, num_gpus: int = 1, standby=None):
        self.params = params
        self.ctx = ctx
        self.gen = gen
        self.num_slots = gen.max_batch
        self.num_gpus = num_gpus
        self.standby = standby
        self._step_ema: dict[int, float] = {}
        self._active: list = []

    @classmethod
    def from_engine(cls, engine, *, num_gpus: int = 1, standby=None):
        return cls(engine.params, engine.ctx, engine.gen, num_gpus=num_gpus, standby=standby)

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
        """Fail-stop one generation rank and swap in the ``standby`` engine
        on the survivors' mesh (``repro.runtime.serving.live``).

        The decode batch is sharded over ``data``, so a slot's KV lives on
        its data row (flat ranks data-major, ``max_batch // data`` slots a
        row): the slots of the dead rank's row lost their KV and requeue from
        the prompt; every other active slot is snapshotted
        (``snapshot_slot``) before the swap and migrates. A callable standby
        is called with ``dead_rank`` after the dying engine's graphs are
        released and its servers dropped (their memory back on the card), so
        its build and captures count in the recovery. Returns ``{"migrate":
        {slot: snapshot}, "requeue": [slots], "seconds", "wire_bytes"}``:
        the measured swap's seconds floored by the modeled re-shard stall
        (``roofline.rank_death_recovery``), and its modeled wire and
        checkpoint bytes. ``ValueError`` without a standby, or where a
        pre-built standby keeps another slot count (nothing is swapped).
        Where a callable standby raises or returns another slot count, the
        dying engine is gone already: ``RuntimeError``, and the client holds
        no engine (``params``, ``ctx`` and ``gen`` are ``None``)."""
        if self.standby is None:
            raise ValueError("kill_rank needs a standby engine on the surviving ranks "
                             "(LiveReplicaClient(..., standby=engine or callable))")
        t0 = self._now()
        gen = self.gen
        sizes = dict(gen._mesh_sizes)
        data = int(sizes.get("data", 1))
        model_size = max(1, math.prod(v for a, v in sizes.items() if a != "data"))
        g = data * model_size
        dead_row = int(dead_rank) % g // model_size
        rows_per = max(1, gen.max_batch // max(1, data))
        migrate, requeue = {}, []
        for slot in active_slots:
            if slot // rows_per == dead_row:
                requeue.append(int(slot))
            else:
                migrate[int(slot)] = gen.snapshot_slot(slot)
        max_batch, cfg, device = gen.max_batch, gen.model.cfg, gen.model.device
        standby = self.standby
        if hasattr(standby, "gen"):
            _check_slots(standby, max_batch)
        else:
            self.ctx.variants.release()
            gen.variants.release()
            # no engine from here until the standby lands
            self.params = self.ctx = self.gen = gen = None
            if device.type == "cuda":
                gc.collect()
                torch.cuda.empty_cache()
            try:
                standby = standby(dead_rank)
                _check_slots(standby, max_batch)
            except Exception as exc:
                raise RuntimeError(
                    f"the standby for dead rank {dead_rank} failed after the dying engine was "
                    "released: this replica holds no engine") from exc
        self.params, self.ctx, self.gen = standby.params, standby.ctx, standby.gen
        self.standby = None
        self.num_gpus = max(1, self.num_gpus - 1)
        self._step_ema.clear()
        rec = roofline.rank_death_recovery(cfg, group=g)
        return {"migrate": migrate, "requeue": requeue,
                "seconds": max(self._now() - t0, rec["seconds"]),
                "wire_bytes": rec["wire_bytes"] + rec["source_bytes"]}

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
