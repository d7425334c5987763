"""Closed-form row budgets of the route-before-gather expert fetch.

The port's one copy of ``repro.core.roofline.demand_budget_rows``,
``predictive_budget_rows`` and ``predictive_budget_rungs``: the engine
(``core.execution``) sizes each demand, speculative and correction round
with them, so the payload the port lands is the payload the JAX package
ships; the cost model (``core.roofline``) prices the same rows, and the
online scheduler's budget tuner (``runtime.engine.BudgetTuner``) steps
over the rungs.
"""
from __future__ import annotations

import math


def _coverage(n_draws: int, num_experts: int, local: int) -> float:
    """Expected distinct experts of one peer's ``local`` slice hit by
    ``n_draws`` uniform routing draws: ``local * (1 - (1 - 1/E)^n)``."""
    e = max(1, num_experts)
    return local * (1.0 - (1.0 - 1.0 / e) ** n_draws)


def _align8(v: float) -> int:
    return -(-math.ceil(v) // 8) * 8


def demand_budget_rows(n_draws: int, num_experts: int, local: int) -> int:
    """Per-peer demand-fetch rows: 2x the expected per-peer coverage,
    rounded up to a multiple of 8, at least 8, clamped to ``local``."""
    if local <= 0:
        return 0
    budget = _align8(2.0 * _coverage(n_draws, num_experts, local))
    return max(1, min(max(8, budget), local))


def predictive_budget_rows(n_draws: int, num_experts: int, local: int) -> tuple[int, int]:
    """Per-peer ``(speculative, correction)`` rows of the predictive
    fetch: 1x and 0.5x the expected per-peer coverage, each 8-aligned, at
    least 8, clamped to ``local``."""
    if local <= 0:
        return 0, 0
    expected = _coverage(n_draws, num_experts, local)
    spec = min(local, max(8, _align8(expected)))
    corr = min(local, max(8, _align8(expected / 2.0)))
    return spec, corr


def predictive_budget_rungs(n_draws: int, num_experts: int, local: int,
                            factors: tuple = (0.5, 1.0, 1.5, 2.0)) -> tuple:
    """The speculative-budget ladder: per-peer rows at ``factors`` x the
    expected per-peer coverage, each 8-aligned, at least 8, clamped to
    ``local``, deduplicated in ascending order. Each rung is a
    ``GatherPolicy.budget`` a server can capture ahead of serving."""
    if local <= 0:
        return (0,)
    expected = _coverage(n_draws, num_experts, local)
    rungs: list[int] = []
    for f in sorted(factors):
        spec = min(local, max(8, _align8(f * expected)))
        if spec not in rungs:
            rungs.append(spec)
    return tuple(rungs)
