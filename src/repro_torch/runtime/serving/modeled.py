"""Replica client priced by the cluster simulator's model
(``repro.runtime.serving.modeled``).

One :class:`ModeledReplicaClient` prices a replica (a context pool and a
generation group) with ``runtime.simulator.ClusterSimulator``'s service
times, the §3 roofline the resolver and ``pareto_sweep`` use, so the
serving scheduler sweeps load at cluster scale with no tensors. A straggler
replica is a ``SimConfig`` with ``straggler_ranks`` / ``straggler_slowdown``
set: each of its fetch rounds completes at its slowest peer.

Prefill is charged at admission (as the live engine's loop runs it);
decode steps price the active batch, so a draining replica speeds up as
slots free.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import roofline
from repro_torch.runtime.simulator import ClusterSimulator, SimConfig


class ModeledReplicaClient:
    def __init__(self, sim_cfg: SimConfig, num_slots: Optional[int] = None):
        self.sim_cfg = sim_cfg
        self.sim = ClusterSimulator(sim_cfg)
        self.num_slots = int(num_slots if num_slots is not None else sim_cfg.gen_batch)
        self.num_gpus = sim_cfg.ctx_gpus + sim_cfg.gen_gpus
        self._step_time: dict[int, float] = {}
        self._ctx_time: dict[int, float] = {}

    def admit(self, slot: int, req) -> tuple:
        if req.resume is not None:
            return None, 0.0
        n = int(req.prompt_len)
        if n not in self._ctx_time:
            self._ctx_time[n] = self.sim.ctx_time([n])
        return None, self._ctx_time[n]

    def step(self, active: list) -> tuple:
        return None, self.step_time(len(active))

    def step_time(self, batch: int) -> float:
        b = max(1, int(batch))
        if b not in self._step_time:
            self._step_time[b] = self.sim.gen_step_time(b)
        return self._step_time[b]

    def release(self, slot: int) -> None:
        pass

    def evict(self, slot: int) -> dict:
        # a modeled slot holds no tensors: the scheduler's bookkeeping of
        # the remaining tokens is all a resume needs
        return {}

    def kill_rank(self, dead_rank: int, active_slots=()) -> dict:
        """Fail-stop one generation rank: the group shrinks to its ``G - 1``
        survivors and every service time is priced again there. Decode
        slots are batch-sharded over the group, so the dead rank's slots
        (``slot % G == dead``) lose their KV shard and requeue from their
        prompt; every other active slot migrates with an empty snapshot.
        Returns the scheduler's recovery report, ``{"migrate": {slot:
        snapshot}, "requeue": [slots], "seconds", "wire_bytes"}``, the
        re-shard's stall and bytes priced by ``roofline.rank_death_recovery``."""
        g = self.sim_cfg.gen_gpus
        if g < 2:
            raise ValueError(f"cannot kill a rank of a {g}-GPU generation group")
        dead = int(dead_rank) % g
        rec = roofline.rank_death_recovery(self.sim_cfg.cfg, group=g, hw=self.sim_cfg.hw)
        migrate = {int(s): {} for s in active_slots if s % g != dead}
        requeue = [int(s) for s in active_slots if s % g == dead]
        self.sim_cfg = dataclasses.replace(self.sim_cfg, gen_gpus=g - 1)
        self.sim = ClusterSimulator(self.sim_cfg)
        self._step_time.clear()
        self._ctx_time.clear()
        self.num_gpus = self.sim_cfg.ctx_gpus + self.sim_cfg.gen_gpus
        return {"migrate": migrate, "requeue": requeue, "seconds": rec["seconds"],
                "wire_bytes": rec["wire_bytes"] + rec["source_bytes"]}

    def can_resume(self, plan) -> bool:
        return True  # a modeled slot holds no tensors: any snapshot restores

    def has_bucket(self, prompt_len: int) -> bool:
        return True
