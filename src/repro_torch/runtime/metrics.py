"""Serving metrics of the port (the JAX package's ``runtime.metrics``):
per-request records, TTFT / TPOT percentiles, TPS/user and TPS/GPU, and
per-request gathered-weight wire-byte counters — totals (full against
fetched), the per-family breakdown (moe_experts / attn_qkv / attn_out /
dense_ffn) and the per-round split — plus the measured predictive-fetch
counters. Times are seconds on the host clock.

The fault counters of the validated fetch (``record_fault_stats`` and
the ``faults`` / ``detected_by_peer`` summary keys) come with the fault
slice: the port has no validated fetch yet.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Optional


def _pct(xs: list, q: float) -> float:
    """Nearest-rank percentile (q in (0, 1]); 0.0 on an empty sample —
    the zero-denominator contract every summary ratio follows."""
    if not xs:
        return 0.0
    s = sorted(xs)
    i = max(0, min(len(s) - 1, int(math.ceil(q * len(s))) - 1))
    return float(s[i])


@dataclasses.dataclass
class RequestRecord:
    req_id: int
    arrival: float
    prompt_len: int
    target_len: int
    first_token_time: Optional[float] = None
    done_time: Optional[float] = None
    tokens_out: int = 0
    # gathered-weight wire bytes attributed to this request (its share of
    # every prefill and decode step it took part in): what the step's plan
    # ships against the all-fetch counterfactual
    gathered_fetch_bytes: float = 0.0
    gathered_full_bytes: float = 0.0
    # the same per gathered-weight family
    # (execution.gathered_wire_bytes_per_step's "families")
    family_fetch_bytes: dict = dataclasses.field(default_factory=dict)
    family_full_bytes: dict = dataclasses.field(default_factory=dict)
    # predictive-fetch counters, measured per decode step: bytes of expert
    # rows prefetched speculatively, served by the speculative round or
    # the residency cache (hits), fetched by the correction round
    # (misses), and evicted from the residency cache
    predicted_bytes: float = 0.0
    spec_hit_bytes: float = 0.0
    cache_hit_bytes: float = 0.0
    miss_bytes: float = 0.0
    evicted_bytes: float = 0.0
    # per-round split of the gathered traffic ("rounds" of
    # execution.gathered_wire_bytes_per_step): the overlappable
    # speculative round against the correction round on the critical path
    round_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def hit_bytes(self) -> float:
        """Speculative and cache hit bytes together."""
        return self.spec_hit_bytes + self.cache_hit_bytes

    def add_gather_share(self, gather_bytes: dict, share: float = 1.0) -> None:
        """Attribute ``share`` of one step's gathered-weight traffic (an
        ``execution.gathered_wire_bytes_per_step`` dict) to this request:
        totals, families and rounds together."""
        self.gathered_fetch_bytes += gather_bytes["fetched"] * share
        self.gathered_full_bytes += gather_bytes["full"] * share
        for fam, b in gather_bytes.get("families", {}).items():
            self.family_fetch_bytes[fam] = self.family_fetch_bytes.get(fam, 0.0) + b["fetched"] * share
            self.family_full_bytes[fam] = self.family_full_bytes.get(fam, 0.0) + b["full"] * share
        for rnd, b in gather_bytes.get("rounds", {}).items():
            self.round_bytes[rnd] = self.round_bytes.get(rnd, 0.0) + b * share

    def add_predict_share(self, stats, expert_bytes: float, share: float = 1.0) -> None:
        """Attribute ``share`` of one decode step's measured predictive
        counters (``[predicted, spec_hit, cache_hit, corr, evicted]``
        expert rows, the generation server's ``last_pred_stats``) to this
        request, in bytes."""
        pred, spec_hit, cache_hit, miss, evicted = (float(s) for s in stats)
        self.predicted_bytes += pred * expert_bytes * share
        self.spec_hit_bytes += spec_hit * expert_bytes * share
        self.cache_hit_bytes += cache_hit * expert_bytes * share
        self.miss_bytes += miss * expert_bytes * share
        self.evicted_bytes += evicted * expert_bytes * share

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    @property
    def tps_user(self) -> Optional[float]:
        """Decode tokens per second this user saw (after the first token)."""
        if self.done_time is None or self.first_token_time is None:
            return None
        dur = self.done_time - self.first_token_time
        if dur <= 0:
            return None
        return (self.tokens_out - 1) / dur

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token over the decode phase (excludes the
        prefill-emitted first token); None until the request is done or
        when it produced a single token."""
        if self.done_time is None or self.first_token_time is None or self.tokens_out < 2:
            return None
        return (self.done_time - self.first_token_time) / (self.tokens_out - 1)


@dataclasses.dataclass
class ServingMetrics:
    records: list = dataclasses.field(default_factory=list)
    num_gpus: int = 1
    # policy switches: {"step", "kind", "level", "fetch"}
    policy_transitions: list = dataclasses.field(default_factory=list)
    # SLO-admission outcomes (admitted / queued / rejected / evicted /
    # resumed / requeued)
    admission: dict = dataclasses.field(default_factory=dict)
    # fail-stop recovery: cumulative counters and each event's stall (s)
    recovery: dict = dataclasses.field(default_factory=dict)
    recovery_times: list = dataclasses.field(default_factory=list)

    def record_admission(self, kind: str, n: int = 1) -> None:
        self.admission[kind] = self.admission.get(kind, 0) + int(n)

    def record_rank_death(self, *, migrated: int = 0, requeued: int = 0,
                          seconds: float = 0.0) -> None:
        """Account one generation-rank fail-stop recovery: slots migrated
        with their state, slots requeued from the prompt, and the time from
        the kill to the first decode step after it."""
        for k, v in (("rank_deaths", 1), ("migrated", int(migrated)),
                     ("requeued", int(requeued))):
            self.recovery[k] = self.recovery.get(k, 0) + v
        self.recovery_times.append(float(seconds))

    def record_transition(self, step: int, kind: str, level: int, fetch: str) -> None:
        self.policy_transitions.append({"step": step, "kind": kind, "level": level, "fetch": fetch})

    def summary(self, horizon: float) -> dict:
        """The serving summary over ``horizon`` seconds: ``tps_per_gpu`` is
        the completed requests' output tokens / horizon / ``num_gpus``. The
        percentile, recovery, ratio and hit-rate keys are always present
        and 0 on an empty sample or a zero denominator."""
        done = [r for r in self.records if r.done_time is not None]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        tps_users = [t for t in (r.tps_user for r in done) if t]
        total_tokens = sum(r.tokens_out for r in done)
        fetch_b = sum(r.gathered_fetch_bytes for r in done)
        full_b = sum(r.gathered_full_bytes for r in done)
        out = {
            "completed": len(done),
            "median_ttft_s": statistics.median(ttfts) if ttfts else None,
            "mean_tps_user": sum(tps_users) / len(tps_users) if tps_users else None,
            "tps_per_gpu": total_tokens / horizon / self.num_gpus,
            "total_output_tokens": total_tokens,
        }
        tpots = [t for t in (r.tpot for r in done) if t is not None]
        for stat, xs in (("ttft", ttfts), ("tpot", tpots)):
            for q in (0.50, 0.95, 0.99):
                out[f"{stat}_p{int(q * 100)}_s"] = round(_pct(xs, q), 6)
        for key in ("rank_deaths", "migrated", "requeued"):
            out[key] = int(self.recovery.get(key, 0))
        for q in (0.50, 0.95):
            out[f"time_to_recover_p{int(q * 100)}_s"] = round(_pct(self.recovery_times, q), 6)
        if self.admission:
            out["admission"] = dict(sorted(self.admission.items()))
        out["gather_fetch_ratio"] = round(fetch_b / full_b, 4) if full_b else 0.0
        if full_b:
            out["gathered_mb_fetched"] = round(fetch_b / 1e6, 3)
            out["gathered_mb_full"] = round(full_b / 1e6, 3)
            by_fam: dict = {}
            for r in done:
                for fam, b in r.family_fetch_bytes.items():
                    by_fam.setdefault(fam, [0.0, 0.0])[0] += b
                for fam, b in r.family_full_bytes.items():
                    by_fam.setdefault(fam, [0.0, 0.0])[1] += b
            if by_fam:
                out["gathered_mb_by_family"] = {
                    fam: {"fetched": round(fb / 1e6, 3), "full": round(fl / 1e6, 3)}
                    for fam, (fb, fl) in sorted(by_fam.items()) if fl > 0
                }
        pred_b = sum(r.predicted_bytes for r in done)
        spec_b = sum(r.spec_hit_bytes for r in done)
        cache_b = sum(r.cache_hit_bytes for r in done)
        hit_b = spec_b + cache_b
        miss_b = sum(r.miss_bytes for r in done)
        evic_b = sum(r.evicted_bytes for r in done)
        # share of the wanted remote rows served without the correction
        # round (speculative and cache hits), split between the two
        denom = hit_b + miss_b
        out["predict_hit_rate"] = round(hit_b / denom, 4) if denom else 0.0
        out["spec_hit_rate"] = round(spec_b / denom, 4) if denom else 0.0
        out["cache_hit_rate"] = round(cache_b / denom, 4) if denom else 0.0
        if pred_b or hit_b or miss_b:
            out["predict_mb_predicted"] = round(pred_b / 1e6, 3)
            out["predict_mb_hit"] = round(hit_b / 1e6, 3)
            out["predict_mb_spec_hit"] = round(spec_b / 1e6, 3)
            out["predict_mb_cache_hit"] = round(cache_b / 1e6, 3)
            out["predict_mb_miss"] = round(miss_b / 1e6, 3)
            out["predict_mb_evicted"] = round(evic_b / 1e6, 3)
        rounds: dict = {}
        for r in done:
            for rnd, b in r.round_bytes.items():
                rounds[rnd] = rounds.get(rnd, 0.0) + b
        if rounds:
            out["gathered_mb_by_round"] = {rnd: round(b / 1e6, 3) for rnd, b in sorted(rounds.items())}
        if self.policy_transitions:
            out["policy_transitions"] = list(self.policy_transitions)
            for kind, field in (("switch", "policy_switches"), ("resize", "budget_resizes"),
                                ("demote", "ladder_demotions"), ("promote", "ladder_promotions")):
                n = sum(1 for t in self.policy_transitions if t["kind"] == kind)
                if n:
                    out[field] = n
        return out
