"""Discrete-event cluster simulator of disaggregated serving (paper §5.3).

The port's own copy of ``repro.runtime.simulator``. Service times come from
the §3 roofline model (``core.roofline``): a context server of
``ctx_gpus`` runs DWDP or DEP prefill at a per-layer latency of ``T_DWDP =
max(T_compute, T_prefetch)`` or ``T_DEP = T_compute + T_all2all`` (plus a
synchronization penalty proportional to the per-rank imbalance under DEP,
the paper's Fig. 1b); generation servers run a batch-latency decode model.
It gives the shape of the paper's end-to-end results: the frontier of
TPS/user against TPS/GPU (Table 5, Fig. 5) and the TTFT trade-off (Table
6). Host code: it draws from one ``random.Random(seed)`` in the reference's
order, so a run's summary is the JAX package's, key for key.

Scenario replay: ``validate_fetch`` prices the checksum-validated fetch,
``fault_rate`` blends in the full-gather fallback of detected payload
faults, ``straggler_ranks`` stretches every fetch round, and
``fault_trace`` (a ``core.faults.FaultTrace`` or the path of one) replays
recorded events: a payload fault prices its step's fallback, a
``rank_death`` shrinks the generation group to the survivors mid-run (the
re-shard stall of ``roofline.rank_death_recovery``, the dead rank's slots
requeued from their prompt).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import random
from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core import roofline
from repro_torch.core.strategy import GatherPolicy, PolicyTable, degradation_ladder
from repro_torch.runtime.metrics import RequestRecord, ServingMetrics

STEP_OVERHEAD_S = 2e-4  # fixed per decode step (also the re-shard's plan swap)


@dataclasses.dataclass
class SimConfig:
    cfg: ArchConfig
    ctx_gpus: int = 4
    gen_gpus: int = 8
    ctx_mode: str = "dwdp"              # dwdp | dep
    policies: Optional[PolicyTable] = None
    # per-family gather policies of every DWDP phase; None: a uniform table
    # from the flat fields below
    gen_policies: Optional[PolicyTable] = None
    # the generation servers' own table (a phase-aware scheduler's split);
    # None: ``policies``
    weight_layout: str = "split"        # the DWDP context phase's landing
    attn_gathered: bool = False         # price gathered attention's landing
    expert_fetch: str = "all"           # all | demand | predictive | sync_free
    cache_budget: int = 0               # predictive residency-cache rows per layer
    cache_hit_rate: Optional[float] = None    # a measured cache hit rate
    predict_hit_rate: Optional[float] = None  # a measured predictor hit rate
    gen_mode: str = "local"             # local: weights resident per group;
                                        # dwdp: sharded, an expert gather per
                                        # layer on the decode critical path
    gen_batch: int = 64
    validate_fetch: bool = False        # a checksum table on each index round
    fault_rate: float = 0.0             # share of decode steps that take the
                                        # full-gather fallback of a detected fault
    straggler_ranks: int = 0            # persistently slow peers of the gen group
    straggler_slowdown: float = 1.0     # their link's degradation factor (>= 1)
    fault_trace: object = None          # a faults.FaultTrace or the path of one
    isl_max: int = 8192
    isl_ratio: float = 0.8              # prompt lengths U[ratio * max, max]
    osl: int = 1024
    arrival_rate: float = 1.0           # requests / s
    max_num_tokens: int = 32768         # the context phase's token budget
    hw: roofline.Hardware = roofline.GB200
    imbalance_sync_frac: float = 0.12   # Fig. 1b: DEP's sync overhead at cv ~20 %
    seed: int = 0
    horizon_s: float = 300.0

    def __post_init__(self):
        if not 0.0 <= self.fault_rate <= 1.0:
            raise ValueError(f"fault_rate must lie in [0, 1]; got {self.fault_rate}")
        if self.straggler_slowdown < 1.0:
            raise ValueError("straggler_slowdown is a degradation factor (>= 1); "
                             f"got {self.straggler_slowdown}")
        if self.straggler_ranks < 0:
            raise ValueError(f"straggler_ranks must be >= 0; got {self.straggler_ranks}")
        if isinstance(self.fault_trace, str):
            from repro_torch.core.faults import FaultTrace

            self.fault_trace = FaultTrace.load(self.fault_trace)

    def table(self) -> PolicyTable:
        """The policy table: ``policies``, or the one the flat fields spell
        (the expert family split under a route-before-gather fetch, every
        other family in ``weight_layout``)."""
        if self.policies is not None:
            return self.policies
        fams = ()
        if self.expert_fetch in ("demand", "predictive", "sync_free"):
            cache = self.cache_budget if self.expert_fetch in ("predictive", "sync_free") else 0
            fams = (("moe_experts", GatherPolicy(layout="split", fetch=self.expert_fetch,
                                                 cache_budget=cache)),)
        return PolicyTable(default=GatherPolicy(layout=self.weight_layout), families=fams)

    def gen_table(self) -> PolicyTable:
        """The generation servers' table: ``gen_policies``, else :meth:`table`."""
        return self.gen_policies if self.gen_policies is not None else self.table()


def _moe_terms(cfg: ArchConfig) -> tuple[float, int]:
    """One expert's bytes at 1-byte weights and the number of MoE layers."""
    per_expert = 3 * cfg.d_model * cfg.moe.d_ff * 1.0
    return per_expert, sum(cfg.is_moe_layer(l) for l in range(cfg.num_layers))


class ClusterSimulator:
    def __init__(self, sc: SimConfig):
        self.sc = sc
        self.rng = random.Random(sc.seed)

    # ---- service-time models ---------------------------------------------
    def ctx_time(self, batch_isls: list[int]) -> float:
        """One context-server forward over a packed batch of prompts."""
        sc = self.sc
        lt = roofline.layer_times(
            sc.cfg, tokens=sum(batch_isls), group=sc.ctx_gpus, hw=sc.hw,
            layer=sc.cfg.moe.first_dense if sc.cfg.moe else 0, policies=sc.table(),
            attn_gathered=sc.attn_gathered, validate=sc.validate_fetch)
        if sc.ctx_mode == "dwdp":
            # the landing write is HBM work on DWDP's critical path
            per_layer = max(lt.compute + lt.land_time, lt.prefetch)
        else:
            # DEP pays the all-to-all and the imbalance's sync (Fig. 1)
            sync = lt.compute * sc.imbalance_sync_frac * min(1.0, _cv(batch_isls) / 0.2)
            per_layer = lt.t_dep + sync
        return per_layer * sc.cfg.num_layers

    def _fetch_terms(self, batch: int) -> tuple[float, float]:
        """Per-GPU ``(total, serial)`` wire bytes of one DWDP decode step's
        expert gathers over the MoE layers: the whole remote bank under
        ``all`` (nothing serial), the budget-padded demand payload (all
        serial), the speculative and correction rounds (the correction
        serial)."""
        sc, cfg = self.sc, self.sc.cfg
        if cfg.moe is None or sc.gen_gpus <= 1:
            return 0.0, 0.0
        moe, g = cfg.moe, sc.gen_gpus
        per_expert, n_moe = _moe_terms(cfg)
        pol = sc.gen_table().family("moe_experts")
        if pol.fetch in ("predictive", "sync_free"):
            total, serial = roofline.predictive_fetch_terms(
                batch, moe.top_k, moe.num_experts, g, per_expert, budget=pol.budget,
                cache_rows=pol.cache_budget, cache_hit=sc.cache_hit_rate,
                predict_hit=sc.predict_hit_rate, validate=sc.validate_fetch,
                sync_free=pol.fetch == "sync_free")
            return n_moe * total, n_moe * serial
        if pol.fetch == "demand":
            total = n_moe * roofline.demand_prefetch_bytes(
                batch, moe.top_k, moe.num_experts, g, per_expert, budget=pol.budget,
                validate=sc.validate_fetch)
            return total, total
        return n_moe * (moe.num_experts * per_expert * (g - 1) / g), 0.0

    def decode_wire_bytes(self, batch: int) -> float:
        """Per-GPU wire bytes of one DWDP decode step (``gen_mode="dwdp"``):
        the expert gathers of every MoE layer."""
        return self._fetch_terms(batch)[0]

    def decode_serial_wire_bytes(self, batch: int) -> float:
        """The part of :meth:`decode_wire_bytes` on the decode critical
        path: the demand round, the predictive correction round, nothing
        of the layer-ahead all-fetch prefetch."""
        return self._fetch_terms(batch)[1]

    def gen_step_time(self, batch: int, fault_rate: Optional[float] = None) -> float:
        """One decode iteration on a generation server (memory-bound). The
        weight traffic counts every routed expert (``1 - (1 - k/E)^B`` of
        them per layer); under ``gen_mode="dwdp"`` the overlappable gather
        joins the max and the serial part adds. ``fault_rate`` overrides the
        config's blend: 0.0 prices a clean step, 1.0 the full-gather
        fallback step of a payload fault."""
        sc, cfg = self.sc, self.sc.cfg
        fr = sc.fault_rate if fault_rate is None else fault_rate
        w_params = cfg.active_param_count()
        if cfg.moe is not None:
            e, k = cfg.moe.num_experts, cfg.moe.top_k
            frac = 1.0 - (1.0 - k / e) ** batch
            w_params = cfg.active_param_count() + frac * (
                cfg.param_count() - cfg.active_param_count()) * (k and 1.0)
            w_params = min(w_params, cfg.param_count())
        w_bytes = w_params * 1.0  # 1-byte weights
        kv_bytes = batch * sc.isl_max * cfg.kv_dim * 2 * cfg.num_layers * 1.0
        t_mem = (w_bytes + kv_bytes) / (sc.hw.hbm_bw * sc.gen_gpus)
        t_flops = 2 * cfg.active_param_count() * batch / (sc.hw.flops * sc.gen_gpus)
        t = max(t_mem, t_flops)
        if sc.gen_mode == "dwdp":
            total, serial = self._fetch_terms(batch)
            wire, serial = total / sc.hw.link_bw, serial / sc.hw.link_bw
            # a fetch round completes at its slowest peer
            straggle = min(sc.straggler_ranks, sc.gen_gpus - 1) > 0
            if straggle:
                wire *= sc.straggler_slowdown
                serial *= sc.straggler_slowdown
            t = max(t, wire - serial) + serial
            if fr > 0.0 and cfg.moe is not None:
                # the fallback ships the whole remote bank behind routing
                per_expert, n_moe = _moe_terms(cfg)
                full_wire = (n_moe * cfg.moe.num_experts * per_expert
                             * (sc.gen_gpus - 1) / sc.gen_gpus / sc.hw.link_bw)
                if straggle:
                    full_wire *= sc.straggler_slowdown
                t = (1.0 - fr) * t + fr * (max(t_mem, t_flops) + full_wire)
        return t + STEP_OVERHEAD_S

    def degraded_table(self, peer_badness=None) -> list[dict]:
        """Every rung of the degradation ladder at this deployment's decode
        shape: ``roofline.degraded_step_times`` over the generation table,
        and each rung's ``t_scenario_us``, the full generation step of
        :meth:`gen_step_time` with this scenario's validation, straggler and
        fault-rate replay on the rung's table (``reshard``: the survivors'
        group). ``peer_badness``: per-peer fault pressure in [0, 1] (a
        ``HealthMonitor.ema``); the peers above 0.5 form the ``+excl``
        rung's exclusion set (the hottest one when none crosses it, never
        every peer), listed as ``excluded_peers``."""
        sc = self.sc
        bad: tuple = ()
        if peer_badness is not None:
            arr = [float(x) for x in peer_badness]
            order = sorted(range(len(arr)), key=lambda i: (-arr[i], i))
            bad = tuple(i for i in order if arr[i] > 0.5)
            if not bad and any(a > 0.0 for a in arr):
                bad = (order[0],)
            bad = bad[: max(1, len(arr) - 1)]
        rows = roofline.degraded_step_times(
            sc.cfg, sc.gen_table(), tokens=sc.gen_batch, group=sc.gen_gpus, hw=sc.hw,
            validate=sc.validate_fetch or sc.fault_rate > 0, excluded_peers=max(1, len(bad)))
        ladder = degradation_ladder(sc.gen_table())
        assert len(rows) == len(ladder)
        for row, (label, rung_table, rung_excl) in zip(rows, ladder):
            sub = dataclasses.replace(sc, gen_policies=rung_table)
            if label == "reshard":
                sub = dataclasses.replace(sub, gen_gpus=max(1, sc.gen_gpus - 1),
                                          straggler_ranks=max(0, sc.straggler_ranks - 1))
            elif rung_excl is None or rung_excl:
                row["excluded_peers"] = list(bad)
                ph = sc.predict_hit_rate
                if ph is None and sc.cfg.moe is not None:
                    moe = sc.cfg.moe
                    ph = 1.0 - (1.0 - 1.0 / max(1, moe.num_experts)) ** (sc.gen_batch * moe.top_k)
                if ph is not None:
                    scale = max(0, sc.gen_gpus - 1 - max(1, len(bad))) / max(1, sc.gen_gpus - 1)
                    sub = dataclasses.replace(sub, predict_hit_rate=ph * scale)
            row["t_scenario_us"] = round(ClusterSimulator(sub).gen_step_time(sc.gen_batch) * 1e6, 3)
        return rows

    # ---- simulation --------------------------------------------------------
    def run(self) -> dict:
        sc = self.sc
        t = 0.0
        req_id = 0
        queue: list[RequestRecord] = []
        metrics = ServingMetrics(num_gpus=sc.ctx_gpus + sc.gen_gpus)
        gen_active: list[Optional[RequestRecord]] = [None] * sc.gen_batch
        gen_remaining = [0] * sc.gen_batch
        events: list[tuple[float, str]] = [(self.rng.expovariate(sc.arrival_rate), "arrival")]
        ctx_free_at = 0.0
        ready: list[RequestRecord] = []  # prefilled, waiting for a slot
        in_ctx: dict[int, RequestRecord] = {}
        t_gen = 0.0
        tr = sc.fault_trace
        steps_done = 0  # decode steps taken: the trace's clock

        while events and t < sc.horizon_s:
            t, kind = heapq.heappop(events)
            if kind == "arrival":
                queue.append(RequestRecord(
                    req_id=req_id, arrival=t,
                    prompt_len=int(self.rng.uniform(sc.isl_ratio, 1.0) * sc.isl_max),
                    target_len=sc.osl))
                req_id += 1
                heapq.heappush(events, (t + self.rng.expovariate(sc.arrival_rate), "arrival"))
                if ctx_free_at <= t:
                    heapq.heappush(events, (t, "ctx_start"))
            elif kind == "ctx_start":
                if not queue or ctx_free_at > t:
                    continue
                # pack prompts up to the token budget
                batch, total = [], 0
                while queue and total + queue[0].prompt_len <= sc.max_num_tokens:
                    batch.append(queue.pop(0))
                    total += batch[-1].prompt_len
                if not batch:
                    batch = [queue.pop(0)]
                ctx_free_at = t + self.ctx_time([r.prompt_len for r in batch])
                for r in batch:
                    r.first_token_time = ctx_free_at
                    r.tokens_out = 1
                    in_ctx[r.req_id] = r
                heapq.heappush(events, (ctx_free_at, "ctx_done:" + ",".join(
                    str(r.req_id) for r in batch)))
            elif kind.startswith("ctx_done"):
                ready.extend(in_ctx.pop(int(x)) for x in kind.split(":")[1].split(","))
                if queue:
                    heapq.heappush(events, (t, "ctx_start"))
                heapq.heappush(events, (t, "gen_step"))
            elif kind == "gen_step":
                if t < t_gen:
                    continue
                for i in range(sc.gen_batch):
                    if gen_active[i] is None and ready:
                        gen_active[i] = ready.pop(0)
                        gen_remaining[i] = gen_active[i].target_len - 1
                active_idx = [i for i in range(sc.gen_batch) if gen_active[i] is not None]
                if not active_idx:
                    continue
                # with nothing waiting to join, jump to the next completion
                # (at most 64 decode steps)
                n = 1
                if not ready:
                    n = max(1, min(64, min(gen_remaining[i] for i in active_idx)))
                if tr is None:
                    dur = self.gen_step_time(len(active_idx)) * n
                else:
                    # clamp the advance to the trace's next event and price
                    # the window's leading step by what the trace recorded
                    nxt = tr.next_event_step(steps_done + 1)
                    if nxt is not None:
                        n = max(1, min(n, nxt - steps_done))
                    stall = 0.0
                    vec = tr.stat_vector(steps_done, self.sc.gen_gpus)
                    k_fault = 0
                    if vec is not None:
                        metrics.record_fault_stats(vec)
                        k_fault = 1
                    for kind_ev, rank_ev in tr.events_at(steps_done):
                        if kind_ev != "rank_death" or self.sc.gen_gpus < 2:
                            continue
                        g = self.sc.gen_gpus
                        dead = int(rank_ev) % g
                        rec = roofline.rank_death_recovery(self.sc.cfg, group=g, hw=self.sc.hw)
                        stall += rec["seconds"]
                        # the dead rank's KV shard is gone: its slots go back
                        # through the context phase; the others ride through
                        migrated = requeued = 0
                        for i in active_idx:
                            if i % g == dead:
                                r = gen_active[i]
                                r.tokens_out = 0
                                r.first_token_time = None
                                gen_active[i] = None
                                gen_remaining[i] = 0
                                queue.append(r)
                                requeued += 1
                            else:
                                migrated += 1
                        self.sc = dataclasses.replace(self.sc, gen_gpus=g - 1)
                        metrics.record_rank_death(migrated=migrated, requeued=requeued,
                                                  seconds=rec["seconds"])
                        if ctx_free_at <= t and queue:
                            heapq.heappush(events, (t, "ctx_start"))
                        active_idx = [i for i in active_idx if gen_active[i] is not None]
                    if not active_idx:
                        steps_done += n
                        t_gen = t + stall
                        if ready:
                            heapq.heappush(events, (t_gen, "gen_step"))
                        continue
                    t_clean = self.gen_step_time(len(active_idx), fault_rate=0.0)
                    t_fault = self.gen_step_time(len(active_idx), fault_rate=1.0)
                    dur = t_fault * k_fault + t_clean * (n - k_fault) + stall
                steps_done += n
                t_gen = t + dur
                for i in active_idx:
                    gen_active[i].tokens_out += n
                    gen_remaining[i] -= n
                    if gen_remaining[i] <= 0:
                        gen_active[i].done_time = t_gen
                        metrics.records.append(gen_active[i])
                        gen_active[i] = None
                if any(x is not None for x in gen_active) or ready:
                    heapq.heappush(events, (t_gen, "gen_step"))
        return metrics.summary(max(t, 1e-9))


def _cv(xs: list[int]) -> float:
    if len(xs) < 2:
        return 0.0
    m = sum(xs) / len(xs)
    var = sum((x - m) ** 2 for x in xs) / len(xs)
    return math.sqrt(var) / m if m else 0.0


def pareto_sweep(cfg: ArchConfig, *, ctx_mode: str, ctx_gpu_options=(2, 3, 4, 6, 8),
                 rate_options=(0.5, 1.0, 2.0, 4.0, 8.0), **kw) -> list[dict]:
    """Sweep deployment points: one :meth:`ClusterSimulator.run` summary per
    (context GPUs, arrival rate), with ``ctx_gpus``, ``rate`` and
    ``ctx_mode`` added."""
    rows = []
    for ctx_gpus in ctx_gpu_options:
        for rate in rate_options:
            sc = SimConfig(cfg=cfg, ctx_gpus=ctx_gpus, ctx_mode=ctx_mode, arrival_rate=rate, **kw)
            out = ClusterSimulator(sc).run()
            out.update(ctx_gpus=ctx_gpus, rate=rate, ctx_mode=ctx_mode)
            rows.append(out)
    return rows
