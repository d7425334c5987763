"""Seeded routing traces and the predictor's replay harness.

The port's own copy of ``repro.core.traces``. Real MoE decode routing is
skewed: a small hot set of experts takes most of the traffic (Zipf-like
popularity), each sequence keeps re-routing to its own experts (affinity),
and the hot set drifts slowly with depth. The sync-free fetch's acceptance
(a speculative hit rate >= 0.9 at a budget far below the expert count) is a
statement about routing with that structure, not about uniform draws, which
no budget-bounded predictor can beat.

- :func:`zipf_routing_trace` draws such traces from a seed with numpy, in
  the reference's order: the arrays are bitwise the JAX package's;
- :func:`from_served_trace` turns the routed bitmaps a serve recorded
  (``runtime.serving.RoutedTraceRecorder``) into the same trace format;
- :func:`predictor_hit_rate` replays one rank's mirrored predictor (the
  port's ``core.prefetch`` arithmetic) over a trace, on the card unless the
  caller asks for the CPU;
- :func:`trace_skew` is a scalar check that a trace is skewed.
"""
from __future__ import annotations

import numpy as np
import torch


def zipf_scores(num_experts: int, alpha: float = 1.2) -> np.ndarray:
    """Unnormalized Zipf popularity by rank: ``1 / rank^alpha``."""
    if num_experts < 1:
        raise ValueError(f"num_experts must be >= 1, got {num_experts}")
    return 1.0 / np.arange(1, num_experts + 1, dtype=np.float64) ** alpha


def zipf_routing_trace(steps: int, rows: int, num_experts: int, top_k: int, *,
                       alpha: float = 1.2, affinity: float = 0.6, drift_every: int = 0,
                       seed: int = 0) -> np.ndarray:
    """Seeded skewed routing trace ``(steps, rows, top_k)`` int32.

    ``alpha``: Zipf exponent of the global popularity ranking (0: uniform
    routing, the floor for any predictor). ``affinity``: probability mass of
    each row's own hot set (its seeded permutation of the globally hottest
    ``4 * top_k`` experts). ``drift_every``: if > 0, the global ranking
    rotates by one position every that many steps. Each row's ``top_k`` ids
    of a step are drawn without replacement, as a router's distinct top-k."""
    if top_k > num_experts:
        raise ValueError(f"top_k {top_k} > num_experts {num_experts}")
    if not 0.0 <= affinity <= 1.0:
        raise ValueError(f"affinity must be in [0, 1], got {affinity}")
    rng = np.random.default_rng(seed)
    base = zipf_scores(num_experts, alpha)
    global_rank = rng.permutation(num_experts)
    hot_n = min(num_experts, 4 * top_k)
    row_hot = np.stack([rng.permutation(hot_n) for _ in range(rows)])
    hot_mass = affinity * (base[:hot_n] / base[:hot_n].sum())
    out = np.empty((steps, rows, top_k), np.int32)
    for s in range(steps):
        if drift_every and s and s % drift_every == 0:
            global_rank = np.roll(global_rank, 1)
        p_global = np.empty(num_experts, np.float64)
        p_global[global_rank] = base
        p_global /= p_global.sum()
        for r in range(rows):
            p = (1.0 - affinity) * p_global
            p[global_rank[row_hot[r]]] += hot_mass
            p /= p.sum()
            out[s, r] = rng.choice(num_experts, size=top_k, replace=False, p=p).astype(np.int32)
    return out


def from_served_trace(bitmaps: np.ndarray, top_k: int) -> np.ndarray:
    """Served routed-expert bitmaps ``(steps, ranks, E)`` (or ``(steps, E)``
    for one rank) as a ``(steps, rows, top_k)`` trace. Each rank's active set
    of a step splits into rows of ``top_k`` distinct ids; every rank keeps a
    fixed span of rows across steps (sized by its busiest step), so a row's
    identity, which the affinity signal learns, survives. Short rows are
    padded with the rank's trace-hottest ids not already in the row (the
    trace's hottest as fallback)."""
    bm = np.asarray(bitmaps).astype(bool)
    if bm.ndim == 2:
        bm = bm[:, None, :]
    if bm.ndim != 3:
        raise ValueError(f"bitmaps must be (steps, ranks, E) or (steps, E); got shape {bm.shape}")
    steps, ranks, e = bm.shape
    if top_k < 1 or top_k > e:
        raise ValueError(f"top_k must be in [1, {e}], got {top_k}")
    rank_counts = bm.sum(axis=0)                      # (ranks, E)
    global_hot = np.argsort(-rank_counts.sum(axis=0), kind="stable")
    per_rank_rows = np.maximum(1, -(-bm.sum(axis=2).max(axis=0) // top_k))
    offsets = np.concatenate([[0], np.cumsum(per_rank_rows)])
    out = np.empty((steps, int(offsets[-1]), top_k), np.int32)
    for r in range(ranks):
        hot_r = np.argsort(-rank_counts[r], kind="stable")
        pad_order = list(dict.fromkeys([*hot_r.tolist(), *global_hot.tolist()]))
        for s in range(steps):
            active = np.flatnonzero(bm[s, r]).tolist()
            for c in range(int(per_rank_rows[r])):
                ids = active[c * top_k:(c + 1) * top_k]
                if len(ids) < top_k:
                    have = set(ids)
                    for x in pad_order:
                        if len(ids) == top_k:
                            break
                        if x not in have:
                            ids.append(int(x))
                            have.add(x)
                out[s, offsets[r] + c] = ids
    return out


def predictor_hit_rate(trace: np.ndarray, num_experts: int, subgroup_size: int, *,
                       budget: int, rich: bool = True, device="cuda") -> float:
    """Replay one rank's mirrored predictor over a routing trace and return
    the speculative hit rate. Before each step it predicts from the state
    folded over the steps so far (``prefetch.predict_bitmap``, with the
    affinity and position signals when ``rich``), scores the hits against
    the step's remote wanted set seen from subgroup position 0, and skips
    the cold first step. ``device`` defaults to the card; the hit counts
    stay there and are read back once, at the end."""
    from repro_torch.core import prefetch
    from repro_torch.core.placement import make_placement

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the replay runs on the card by default; pass "
                           'device="cpu" to run on the CPU')
    trace = np.asarray(trace)
    if trace.ndim != 3:
        raise ValueError(f"trace must be (steps, rows, top_k), got {trace.shape}")
    pl = make_placement(num_experts, subgroup_size)
    e = pl.num_padded
    steps, rows, _ = trace.shape
    routes = torch.as_tensor(trace.astype(np.int64), device=device)
    own = torch.arange(e, device=device) // pl.local_count == 0
    ema = torch.zeros(e, device=device)
    prev = torch.zeros(e, dtype=torch.bool, device=device)
    posb = torch.zeros(prefetch.N_POS_BUCKETS, e, device=device)
    aff = torch.zeros(rows, e, device=device)
    sigw = torch.zeros(2, device=device)
    sig = torch.zeros(2, e, device=device)
    counts = torch.zeros(2, dtype=torch.int64, device=device)  # hits, wanted
    for s in range(steps):
        extra = prefetch.predict_extra_score(sig, sigw) if rich else None
        spec = prefetch.predict_bitmap(prev, ema, pl, budget=budget, extra_score=extra)
        routed = prefetch.routed_bitmaps(routes[s], e)
        buckets = prefetch.position_buckets(torch.full((rows,), s, device=device))
        wanted_remote = routed.any(dim=0) & ~own
        if s > 0:
            counts += torch.stack([(wanted_remote & spec).sum(), wanted_remote.sum()])
        prev, ema, aff, posb, sig, sigw = prefetch.update_predictor(
            ema, aff, posb, sigw, routed, buckets)
    hit, want = (float(x) for x in counts.tolist())
    return hit / max(want, 1.0)


def trace_skew(trace: np.ndarray, num_experts: int) -> float:
    """Share of all draws that land in the trace's own ``top_k`` hottest
    experts: 1.0 for a frozen hot set, about ``top_k / num_experts`` for
    uniform routing."""
    k = trace.shape[-1]
    counts = np.bincount(trace.reshape(-1), minlength=num_experts)
    top = np.sort(counts)[::-1][:k].sum()
    return float(top) / float(trace.size)
