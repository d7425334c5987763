"""The paper's §3 layer-wise roofline model: DWDP against DEP, and the cost
of each gather policy.

The port's own copy of ``repro.core.roofline`` (its hardware entries, the
per-layer terms, the modeled step time the ``policy="auto"`` resolver
minimises, and Figure 3's sweep), over the port's configs and layer plan.
The budget closed forms live in ``core.budget`` (one copy, shared with the
engine) and are imported here. Model::

    T_op      = max(F / P_peak, B / BW_mem)            per operator
    T_compute = sum of attention + MoE operator times
    T_DWDP    = max(T_compute, T_prefetch)
    T_DEP     = T_compute + T_all2all

Hardware entries: ``GB200`` (the paper's card, the resolver's default),
``H100`` (one card of a multi-card H100 mesh) and :func:`card_view`, the
per-logical-rank view of one card that holds every rank of a group — the
view the servers resolve against on a CUDA device. The JAX package's
``TPU_V5E`` entry is not ported: it is a TPU figure, read only by that
package's paper-table benchmark. The fault pricing (:func:`reshard_plan_rows`,
:func:`rank_death_recovery`, :func:`degraded_step_times`) prices the
degradation ladder of ``core.strategy`` and a rank death's re-shard, the
data movement ``prefetch.reshard_split_bank`` performs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.budget import (  # noqa: F401  (the cost model's budget forms)
    demand_budget_rows,
    predictive_budget_rows,
    predictive_budget_rungs,
)


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    flops: float        # peak FLOP/s (dense bf16/fp8 as configured)
    hbm_bw: float       # bytes/s
    link_bw: float      # bytes/s per-direction interconnect per chip
    hbm_bytes: float


# GB200 (the paper): ~2.25 PFLOP/s dense FP8 per GPU in practice for these
# kernels (NVFP4 MoE weights), 8 TB/s HBM3e, ~900 GB/s/dir NVLink5.
GB200 = Hardware("GB200", flops=2.25e15, hbm_bw=8e12, link_bw=900e9, hbm_bytes=186e9)
# NVIDIA H100 80GB HBM3 SXM at 700 W: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
# 450 GB/s per direction over NVLink 4 — what one card of an H100 mesh sees.
H100 = Hardware("H100", flops=989e12, hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80e9)
# One H100's device-to-device copy rate: 73.283 GB of landing copies in 48.62
# ms (the R1 1024 all-fetch decode step, chip_smoke.py, NVIDIA H100 80GB
# HBM3 at 700 W), ~1.507 TB/s.
H100_COPY_BW = 73.283e9 / 48.62e-3


def card_view(ranks: int, hw: Hardware = H100, copy_bw: float = H100_COPY_BW) -> Hardware:
    """The per-logical-rank view of one card that holds ``ranks`` logical
    ranks: they share its memory (``hbm_bytes / ranks`` each), run back to
    back at its full rates, and each pull from a peer is a device-to-device
    copy at ``copy_bw``. A step of the whole group takes ``ranks`` x the
    modeled per-rank time."""
    return dataclasses.replace(hw, name=f"{hw.name}/{ranks}", link_bw=copy_bw,
                               hbm_bytes=hw.hbm_bytes / ranks)


def serving_target(model) -> tuple[Hardware, int]:
    """``(hw, weight_bytes)`` a server resolves ``"auto"`` against: on a
    CUDA device the card it runs on (:func:`card_view` over the model's
    logical ranks) and the model's own weight bytes; elsewhere the JAX
    package's defaults (``GB200``, 1-byte weights), so the CPU resolves as
    the reference does. On one H100 the defaults would size a residency
    cache of the whole remote bank (R1: 67.6 GB beside 28.19 GB of
    weights)."""
    if model.device.type != "cuda":
        return GB200, 1
    return card_view(model.n_ranks), model.dtype.itemsize


def op_time(flops: float, bytes_: float, hw: Hardware) -> float:
    return max(flops / hw.flops, bytes_ / hw.hbm_bw)


def expected_distinct_experts(n_draws: int, num_experts: int) -> float:
    """E[distinct experts hit] by ``n_draws`` (= rows * top_k) uniform
    routing draws over ``num_experts``: ``E * (1 - (1 - 1/E)^n)``."""
    e = float(num_experts)
    if e <= 0:
        return 0.0
    return e * (1.0 - (1.0 - 1.0 / e) ** n_draws)


def predictive_fetch_terms(
    tokens: int,
    top_k: int,
    num_experts: int,
    group: int,
    bytes_per_expert: float,
    *,
    redundancy: int = 1,
    budget: int = 0,
    cache_rows: int = 0,
    cache_hit: Optional[float] = None,
    predict_hit: Optional[float] = None,
    validate: bool = False,
    sync_free: bool = False,
) -> tuple[float, float]:
    """Per-rank wire terms of the predictive expert fetch, ``(total,
    serial)`` bytes: the speculative and correction rounds (each a padded
    payload and its bitmap index round, capped at the full remote gather),
    and the correction round alone, the part on the critical path.
    ``cache_hit`` scales both rounds, ``predict_hit`` the correction round;
    ``None`` takes the closed forms (the cached share of the remote bank;
    the re-activation probability ``1 - (1 - 1/E)^n``). ``sync_free`` drops
    the speculative round's index exchange; ``validate`` prices a checksum
    table (f32 per expert per peer) on each index round."""
    sub = max(1, group // redundancy)
    if sub <= 1:
        return 0.0, 0.0
    local = -(-num_experts // sub)
    full = (sub - 1) * local * bytes_per_expert
    if budget > 0:
        spec = corr = min(budget, local)
    else:
        spec, corr = predictive_budget_rows(tokens * top_k, num_experts, local)
    if cache_hit is None:
        remote_rows = (sub - 1) * local
        cache_hit = min(1.0, cache_rows / max(1, remote_rows)) if cache_rows else 0.0
    if predict_hit is None:
        predict_hit = 1.0 - (1.0 - 1.0 / max(1, num_experts)) ** (tokens * top_k)
    index_round = (sub - 1) * num_experts * (5 if validate else 1)
    spec_index = 0.0 if sync_free else index_round
    spec_b = ((sub - 1) * spec * bytes_per_expert + spec_index) * (1.0 - cache_hit)
    corr_b = ((sub - 1) * corr * bytes_per_expert + index_round) * (
        1.0 - cache_hit) * (1.0 - predict_hit)
    total = min(full, spec_b + corr_b)
    return total, min(total, corr_b)


def demand_prefetch_bytes(
    tokens: int,
    top_k: int,
    num_experts: int,
    group: int,
    bytes_per_expert: float,
    *,
    redundancy: int = 1,
    budget: int = 0,
    validate: bool = False,
) -> float:
    """Per-rank wire bytes of the demand fetch: ``(G'-1) * budget`` padded
    expert rows (the budget from :func:`demand_budget_rows` unless given)
    plus the index round (one bitmap byte per expert per peer, 5 with
    checksums), never more than the full remote gather."""
    sub = max(1, group // redundancy)
    if sub <= 1:
        return 0.0
    local = -(-num_experts // sub)
    full = (sub - 1) * local * bytes_per_expert
    if budget <= 0:
        budget = demand_budget_rows(tokens * top_k, num_experts, local)
    budget = min(budget, local)
    index_round = (sub - 1) * num_experts * (5 if validate else 1)
    return min(full, (sub - 1) * budget * bytes_per_expert + index_round)


@dataclasses.dataclass(frozen=True)
class LayerTimes:
    compute: float
    prefetch: float
    all2all: float
    land_bytes: float = 0.0    # HBM write of the gathered landing (merged: the
                               # whole layer set; split: the remote part)
    land_time: float = 0.0     # the same as HBM time, not folded into compute
    serial_fetch: float = 0.0  # the part of prefetch on the critical path: 0
                               # for the all-fetch prefetch, the whole demand
                               # round, the predictive correction round

    @property
    def t_dwdp(self) -> float:
        return max(self.compute, self.prefetch)

    @property
    def t_dep(self) -> float:
        return self.compute + self.all2all

    @property
    def speedup(self) -> float:
        return self.t_dep / self.t_dwdp

    @property
    def compute_to_prefetch(self) -> float:
        return self.compute / max(self.prefetch, 1e-30)


def layer_times(
    cfg: ArchConfig,
    *,
    tokens: int,
    group: int,
    hw: Hardware = GB200,
    weight_bytes: int = 1,
    act_bytes: int = 2,
    kv_len: Optional[int] = None,
    layer: int = 0,
    redundancy: int = 1,
    weight_layout: Optional[str] = None,
    attn_gathered: bool = False,
    expert_fetch: str = "all",
    moe_ffn: str = "merged",
    policies=None,
    cache_hit: Optional[float] = None,
    predict_hit: Optional[float] = None,
    validate: bool = False,
    layer_group: Optional[str] = None,
) -> LayerTimes:
    """Per-layer roofline terms of a batch of ``tokens``: compute (attention
    and FFN / MoE operator times), the prefetch of the peers' shards over
    the link (``(G'-1)/G'`` of the layer's expert bytes; the demand and
    predictive fetches' padded payloads at partial coverage), DEP's
    all-to-all, the landing write and the serial part of the fetch.
    ``policies`` (a ``strategy.PolicyTable``, scoped to ``layer_group``)
    prices each family under its own policy; without it the flat
    ``weight_layout`` (or ``moe_ffn``) and ``expert_fetch`` apply to every
    family. ``attn_gathered`` adds the attention projections' wire and
    landing bytes."""
    budget = 0
    cache_rows = 0
    if policies is not None:
        moe_pol = policies.family("moe_experts", layer_group)
        moe_layout = moe_pol.layout
        expert_fetch = moe_pol.fetch
        budget = moe_pol.budget
        cache_rows = moe_pol.cache_budget
        dense_layout = policies.family("dense_ffn", layer_group).layout
        qkv_layout = policies.family("attn_qkv", layer_group).layout
        out_layout = policies.family("attn_out", layer_group).layout
    else:
        flat = weight_layout if weight_layout is not None else moe_ffn
        moe_layout = dense_layout = qkv_layout = out_layout = flat
    layout = moe_layout
    d = cfg.d_model
    kv_len = kv_len or tokens
    # --- attention ---------------------------------------------------------
    qkv_flops = 2 * tokens * d * (cfg.q_dim + 2 * cfg.kv_dim) + 2 * tokens * cfg.q_dim * d
    attn_flops = 2 * 2 * cfg.num_heads * cfg.head_dim * tokens * kv_len // 2
    attn_w_bytes = (d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d) * weight_bytes
    attn_act_bytes = 3 * tokens * d * act_bytes + 2 * tokens * cfg.kv_dim * act_bytes
    t_attn = op_time(qkv_flops + attn_flops, attn_w_bytes + attn_act_bytes, hw)

    # --- FFN / MoE ----------------------------------------------------------
    if cfg.moe is not None and cfg.is_moe_layer(layer):
        moe = cfg.moe
        e, k, f = moe.num_experts, moe.top_k, moe.d_ff
        ffn_flops = 2 * 3 * tokens * k * d * f
        if moe.shared_d_ff:
            ffn_flops += 2 * 3 * tokens * d * moe.shared_d_ff
        # active expert weights read once each (at most every expert)
        w_bytes = min(e, tokens * k) * 3 * d * f * weight_bytes
        sub = max(1, group // redundancy)
        layer_expert_bytes = e * 3 * d * f * weight_bytes
        prefetch_bytes = layer_expert_bytes * (sub - 1) / sub
        serial_bytes = 0.0
        partial = tokens * k < e * (sub - 1) / sub
        if expert_fetch == "demand" and layout == "split" and partial:
            # route-before-gather: the whole round waits on routing
            prefetch_bytes = demand_prefetch_bytes(
                tokens, k, e, group, 3 * d * f * weight_bytes,
                redundancy=redundancy, budget=budget, validate=validate,
            )
            serial_bytes = prefetch_bytes
        elif expert_fetch in ("predictive", "sync_free") and layout == "split" and partial:
            # the speculative round overlaps a layer ahead, the correction
            # round (the hit-rate-scaled misses) is serial
            prefetch_bytes, serial_bytes = predictive_fetch_terms(
                tokens, k, e, group, 3 * d * f * weight_bytes,
                redundancy=redundancy, budget=budget, cache_rows=cache_rows,
                cache_hit=cache_hit, predict_hit=predict_hit, validate=validate,
                sync_free=expert_fetch == "sync_free",
            )
        land_bytes = 0.0
        if sub > 1:
            land_bytes = layer_expert_bytes if layout == "merged" else prefetch_bytes
        a2a_bytes = 2 * tokens * k * d * act_bytes * (sub - 1) / sub
    else:
        f = cfg.ffn_dim(layer) or cfg.d_ff
        ffn_flops = 2 * 3 * tokens * d * f
        w_bytes = 3 * d * f * weight_bytes
        layer_bytes = 3 * d * f * weight_bytes
        prefetch_bytes = layer_bytes * (group - 1) / group
        serial_bytes = 0.0
        land_bytes = 0.0
        if group > 1:
            land_bytes = layer_bytes if dense_layout == "merged" else prefetch_bytes
        # the dense DEP analogue: gather + reduce-scatter of activations
        a2a_bytes = 2 * tokens * d * act_bytes * (group - 1) / group
    t_ffn = op_time(ffn_flops, w_bytes + 2 * tokens * d * act_bytes, hw)

    # gathered attention projections: each under its own family's layout
    if attn_gathered and group > 1:
        qkv_w = d * (cfg.q_dim + 2 * cfg.kv_dim) * weight_bytes
        out_w = cfg.q_dim * d * weight_bytes
        for w, fam_layout in ((qkv_w, qkv_layout), (out_w, out_layout)):
            fam_prefetch = w * (group - 1) / group
            prefetch_bytes += fam_prefetch
            land_bytes += w if fam_layout == "merged" else fam_prefetch

    compute = t_attn + t_ffn
    return LayerTimes(
        compute=compute,
        prefetch=prefetch_bytes / hw.link_bw,
        all2all=a2a_bytes / hw.link_bw,
        land_bytes=land_bytes,
        land_time=land_bytes / hw.hbm_bw,
        serial_fetch=serial_bytes / hw.link_bw,
    )


def layer_step_time(lt: LayerTimes) -> float:
    """One layer's modeled DWDP critical path: ``max(compute + landing,
    overlapped prefetch) + serial fetch``."""
    return max(lt.compute + lt.land_time, lt.prefetch - lt.serial_fetch) + lt.serial_fetch


@functools.lru_cache(maxsize=64)
def layer_group_names(cfg: ArchConfig) -> tuple[str, ...]:
    """Each layer's execution-plan group (``prefix`` / ``body`` /
    ``suffix``, ``models.transformer.make_layer_plan``): the key space of
    per-layer-group policy overrides. Cached per config: the online
    scheduler resolves between decode steps."""
    from repro_torch.models.transformer import make_layer_plan

    names = [""] * cfg.num_layers
    for g in make_layer_plan(cfg):
        span = g.n_cycles * len(g.sigs)
        for layer in range(g.first_layer, g.first_layer + span):
            names[layer] = g.name
    return tuple(names)


def _rate_for(rate, group_name: Optional[str]):
    """A replayed hit rate: a scalar applies everywhere, a mapping keys by
    layer-group name."""
    if rate is None or isinstance(rate, (int, float)):
        return rate
    return rate.get(group_name)


def modeled_step_time(
    cfg: ArchConfig,
    *,
    tokens: int,
    group: int,
    hw: Hardware = GB200,
    policies=None,
    weight_layout: Optional[str] = None,
    expert_fetch: str = "all",
    attn_gathered: bool = False,
    kv_len: Optional[int] = None,
    redundancy: int = 1,
    weight_bytes: int = 1,
    act_bytes: int = 2,
    cache_hit=None,
    predict_hit=None,
    validate: bool = False,
) -> float:
    """Modeled time of one DWDP forward under a policy table: the sum over
    layers of :func:`layer_step_time`, each layer priced under its own
    group's policies (per-group overrides, and ``cache_hit`` /
    ``predict_hit`` given as ``{group: rate}``), plus the one per-step
    mirror all-gather where a layer runs ``fetch="sync_free"``. The
    ``policy="auto"`` resolver's objective."""
    groups = None
    if policies is not None and (
        getattr(policies, "overrides", ())
        or not isinstance(cache_hit, (int, float, type(None)))
        or not isinstance(predict_hit, (int, float, type(None)))
    ):
        groups = layer_group_names(cfg)
    total = 0.0
    sync_free_used = False
    for layer in range(cfg.num_layers):
        gname = groups[layer] if groups else None
        lt = layer_times(
            cfg, tokens=tokens, group=group, hw=hw, layer=layer,
            policies=policies, weight_layout=weight_layout,
            expert_fetch=expert_fetch, attn_gathered=attn_gathered,
            kv_len=kv_len, redundancy=redundancy,
            weight_bytes=weight_bytes, act_bytes=act_bytes,
            cache_hit=_rate_for(cache_hit, gname),
            predict_hit=_rate_for(predict_hit, gname),
            validate=validate, layer_group=gname,
        )
        total += layer_step_time(lt)
        if cfg.moe is not None and cfg.is_moe_layer(layer):
            fetch = (policies.family("moe_experts", gname).fetch
                     if policies is not None else expert_fetch)
            sync_free_used = sync_free_used or fetch == "sync_free"
    sub = max(1, group // redundancy)
    if sync_free_used and cfg.moe is not None and sub > 1:
        moe = cfg.moe
        if tokens * moe.top_k < moe.num_experts * (sub - 1) / sub:
            from repro_torch.core import prefetch
            from repro_torch.core.placement import make_placement

            pl = make_placement(moe.num_experts, sub)
            total += prefetch.sync_free_mirror_bytes(pl, tokens) / hw.link_bw
    return total


def reshard_plan_rows(num_experts: int, group: int, dead: int) -> dict:
    """Row accounting of the fail-stop re-shard ``G -> G-1`` of the split
    banks (old owner of row ``r``: ``r // ceil(E/G)``): per surviving new
    owner, how many of its new rows it already holds (``local``), receives
    from a surviving peer (``wire``) or takes from the checkpoint copy
    because the dead rank held them (``source``); rows never come from the
    dead peer. ``(group-1,)`` arrays by new owner, and ``new_local``, the
    shrunk layout's rows per rank."""
    e, g = int(num_experts), int(group)
    if g < 2:
        raise ValueError(f"reshard needs group >= 2, got {g}")
    dead = int(dead) % g
    old_l = -(-e // g)
    new_l = -(-e // (g - 1))
    survivors = [r for r in range(g) if r != dead]
    local = np.zeros(g - 1, np.int64)
    wire = np.zeros(g - 1, np.int64)
    source = np.zeros(g - 1, np.int64)
    for s, old_rank in enumerate(survivors):
        for r in range(s * new_l, min((s + 1) * new_l, e)):
            owner = min(r // old_l, g - 1)
            if owner == dead:
                source[s] += 1
            elif owner == old_rank:
                local[s] += 1
            else:
                wire[s] += 1
    return {"local": local, "wire": wire, "source": source, "new_local": new_l}


def rank_death_recovery(cfg: ArchConfig, *, group: int, hw: Hardware = GB200,
                        weight_bytes: int = 1) -> dict:
    """Price a generation rank's fail-stop recovery: the ``G -> G-1``
    re-shard's wire bytes and the stall before the first decode step after
    it. The expert banks re-shard by :func:`reshard_plan_rows` (the last
    rank dead); the survivors exchange their rows point to point in
    parallel (time: the largest incoming share of one survivor) and the
    dead rank's rows come from the checkpoint copy over the same fabric.
    Other families are not priced. The stall adds one fixed plan-swap
    overhead (the simulator's per-step overhead); a pre-warmed ``G-1``
    variant compiles nothing."""
    g = int(group)
    out = {"wire_bytes": 0.0, "source_bytes": 0.0, "seconds": 2e-4,
           "per_survivor_wire_bytes": 0.0}
    if cfg.moe is None or g < 2:
        return out
    moe = cfg.moe
    per_expert = 3 * cfg.d_model * moe.d_ff * float(weight_bytes)
    n_moe = sum(cfg.is_moe_layer(l) for l in range(cfg.num_layers))
    plan = reshard_plan_rows(moe.num_experts, g, dead=g - 1)
    worst_in = float((plan["wire"] + plan["source"]).max())
    out["wire_bytes"] = n_moe * float(plan["wire"].sum()) * per_expert
    out["source_bytes"] = n_moe * float(plan["source"].sum()) * per_expert
    out["per_survivor_wire_bytes"] = n_moe * worst_in * per_expert
    out["seconds"] += out["per_survivor_wire_bytes"] / hw.link_bw
    return out


def degraded_step_times(cfg: ArchConfig, policies, *, tokens: int, group: int,
                        hw: Hardware = GB200, validate: bool = True,
                        excluded_peers: int = 1, **kw) -> list[dict]:
    """Price every level of the degradation ladder
    (``strategy.degradation_ladder``): per level, the modeled step time
    under its table with payload validation priced in, and its ratio to the
    healthy (unvalidated) top level. The ``+excl`` rung drops
    ``excluded_peers`` peers' share of the remote bank from the speculative
    schedule (a predictor hit-rate haircut). The ``"reshard"`` rung is
    priced at the shrunk group ``group - 1`` and carries the one-time
    re-shard (:func:`rank_death_recovery`): ``reshard_wire_mb`` and
    ``recovery_stall_us``."""
    from repro_torch.core.strategy import degradation_ladder

    n_excl = max(1, min(int(excluded_peers), max(1, group - 1)))
    rows = []
    base = modeled_step_time(cfg, tokens=tokens, group=group, hw=hw, policies=policies,
                             validate=False, **kw)
    for level, (label, table, excl) in enumerate(degradation_ladder(policies)):
        sub_kw = dict(kw)
        if label == "reshard":
            t = modeled_step_time(cfg, tokens=tokens, group=max(1, group - 1), hw=hw,
                                  policies=table, validate=validate, **sub_kw)
            rec = rank_death_recovery(cfg, group=group, hw=hw)
            rows.append({
                "level": level, "fetch": label, "t_step_us": t * 1e6,
                "vs_healthy": t / max(base, 1e-30),
                "reshard_wire_mb": round((rec["wire_bytes"] + rec["source_bytes"]) / 1e6, 3),
                "recovery_stall_us": round(rec["seconds"] * 1e6, 3),
            })
            continue
        if excl is None or excl:
            ph = sub_kw.get("predict_hit")
            if ph is None and cfg.moe is not None:
                ph = 1.0 - (1.0 - 1.0 / max(1, cfg.moe.num_experts)) ** (tokens * cfg.moe.top_k)
            if ph is not None:
                sub_kw["predict_hit"] = ph * max(0, group - 1 - n_excl) / max(1, group - 1)
        t = modeled_step_time(cfg, tokens=tokens, group=group, hw=hw, policies=table,
                              validate=validate, **sub_kw)
        rows.append({"level": level, "fetch": label, "t_step_us": t * 1e6,
                     "vs_healthy": t / max(base, 1e-30)})
    return rows


def figure3_sweep(
    cfg: ArchConfig,
    *,
    group: int = 4,
    hw: Hardware = GB200,
    isls: tuple[int, ...] = (1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072),
    batch: int = 1,
    weight_layout: Optional[str] = None,
    attn_gathered: bool = False,
    expert_fetch: str = "all",
    moe_ffn: str = "merged",
) -> list[dict]:
    """Figure 3: the compute/prefetch ratio and the DEP/DWDP speedup of the
    first MoE layer against the input length."""
    rows = []
    moe_layer = cfg.moe.first_dense if cfg.moe else 0
    layout = weight_layout if weight_layout is not None else moe_ffn
    for isl in isls:
        lt = layer_times(cfg, tokens=batch * isl, group=group, hw=hw, layer=moe_layer,
                         weight_layout=layout, attn_gathered=attn_gathered,
                         expert_fetch=expert_fetch)
        rows.append({
            "isl": isl,
            "compute_to_prefetch": lt.compute_to_prefetch,
            "dep_to_dwdp": lt.speedup,
            "t_compute_us": lt.compute * 1e6,
            "t_prefetch_us": lt.prefetch * 1e6,
            "t_all2all_us": lt.all2all * 1e6,
            "land_mb": lt.land_bytes / 1e6,
            "t_land_us": lt.land_time * 1e6,
        })
    return rows


def crossover_isl(cfg: ArchConfig, *, group: int = 4, hw: Hardware = GB200,
                  batch: int = 1) -> Optional[int]:
    """The smallest input length (a multiple of 1024) at which the first
    MoE layer's compute hides its prefetch (ratio >= 1); the paper reports
    ~16K for DeepSeek-R1's context phase at batch 1 on GB200."""
    moe_layer = cfg.moe.first_dense if cfg.moe else 0
    for isl in range(1024, 1 << 20, 1024):
        lt = layer_times(cfg, tokens=batch * isl, group=group, hw=hw, layer=moe_layer)
        if lt.compute_to_prefetch >= 1.0:
            return isl
    return None
