"""The paper's many-to-one source contention model and its TDM mitigation
(§4.3).

The port's own copy of ``repro.core.contention``, host code only:

1. :func:`contention_probabilities`: Table 2's exact Binomial(N-2, 1/(N-1))
   model of how many concurrent pulls target one source rank under random
   asynchronous execution;
2. :func:`build_copy_plan`: Listing 1, the slice-round-robin copy plan;
3. :class:`CopyEngineSim`: a discrete-event model of per-source copy
   engines serving pull requests, with and without TDM slicing
   (:func:`tdm_speedup`), the mechanism behind Table 4's trends.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Iterable


def _binom_pmf(n: int, p: float, k: int) -> float:
    return math.comb(n, k) * p**k * (1 - p) ** (n - k)


def contention_probabilities(group_size: int) -> dict[int, float]:
    """Pr[C = c] for c = 1..N-1: C = X + 1, X ~ Binom(N-2, 1/(N-1))."""
    n = group_size
    if n < 2:
        return {1: 1.0}
    p = 1.0 / (n - 1)
    return {x + 1: _binom_pmf(n - 2, p, x) for x in range(n - 1)}


def expected_contention(group_size: int) -> float:
    return sum(c * pr for c, pr in contention_probabilities(group_size).items())


def build_copy_plan(prefetch_sizes: dict[str, int], remote_peers: list[int],
                    slice_bytes: int) -> list[tuple[str, int, int, int]]:
    """Listing 1: ``[(param, peer, offset, chunk)]`` in round-robin slice
    order, slices of different source ranks interleaved so that no
    destination monopolizes one source."""
    plan: list[tuple[str, int, int, int]] = []
    for name, m in prefetch_sizes.items():
        offset = 0
        rr = list(remote_peers)
        while offset < m:
            chunk = min(slice_bytes, m - offset)
            for peer in rr:
                plan.append((name, peer, offset, chunk))
            rr = rr[1:] + rr[:1]  # rotate the round-robin order
            offset += chunk
    return plan


@dataclasses.dataclass
class PullRequest:
    dst: int
    src: int
    bytes: int
    issue_time: float = 0.0


class CopyEngineSim:
    """Discrete-event model of source-side copy engines.

    Each source engine has ``inflight`` pipelined service slots. Every
    transfer draws a path multiplier J (``jitter_mult`` with probability
    ``jitter_p``, else 1) for its whole duration, so a monolithic pull is
    hostage to one bad episode, while TDM slices draw J per slice and let
    the other in-flight slice keep the engine busy. Destinations issue pulls
    serially (the DWDP rule), a pull's slices serially too; each source
    serves its queue first in, first out."""

    def __init__(self, group_size: int, bw: float, slice_bytes: int | None,
                 inflight: int = 2, jitter_p: float = 0.2, jitter_mult: float = 3.0):
        self.n = group_size
        self.bw = bw
        self.slice_bytes = slice_bytes
        self.inflight = max(1, inflight)
        self.jitter_p = jitter_p
        self.jitter_mult = jitter_mult

    def run(self, pull_bytes: int, order_seed: int = 0) -> float:
        """One round, every rank pulling ``pull_bytes`` from each of the
        other N-1 ranks: the makespan."""
        return max(self.run_per_dst(pull_bytes, order_seed))

    def run_per_dst(self, pull_bytes: int, order_seed: int = 0,
                    offsets: list[float] | None = None) -> list[float]:
        """Each destination's pull latency (completion - start) over one
        layer's prefetch round."""
        rng = _lcg(order_seed)
        orders = []
        for d in range(self.n):
            peers = [s for s in range(self.n) if s != d]
            for i in range(len(peers) - 1, 0, -1):
                j = next(rng) % (i + 1)
                peers[i], peers[j] = peers[j], peers[i]
            orders.append(peers)

        if self.slice_bytes:
            nsl = max(1, math.ceil(pull_bytes / self.slice_bytes))
            sizes = [self.slice_bytes] * (nsl - 1) + [pull_bytes - self.slice_bytes * (nsl - 1)]
        else:
            sizes = [pull_bytes]

        def jitter() -> float:
            u = next(rng) / float(1 << 31)
            return self.jitter_mult if u < self.jitter_p else 1.0

        src_queue: list[list[tuple[int, int, int]]] = [[] for _ in range(self.n)]
        src_slots = [0] * self.n          # busy service slots per source
        events: list[tuple[float, int, int, int, int]] = []
        dst_done = [0.0] * self.n
        starts = offsets or [0.0] * self.n

        def start_service(t: float, s: int, d: int, pi: int, si: int):
            src_slots[s] += 1
            heapq.heappush(events, (t + sizes[si] / self.bw * jitter(), s, d, pi, si))

        def issue(t: float, d: int, pi: int, si: int):
            s = orders[d][pi]
            if src_slots[s] >= self.inflight:
                src_queue[s].append((d, pi, si))
            else:
                start_service(t, s, d, pi, si)

        for d in range(self.n):
            issue(starts[d], d, 0, 0)
        while events:
            t, s, d, pi, si = heapq.heappop(events)
            src_slots[s] -= 1
            dst_done[d] = max(dst_done[d], t)
            if src_queue[s]:
                nd, npi, nsi = src_queue[s].pop(0)
                start_service(t, s, nd, npi, nsi)
            if si + 1 < len(sizes):
                issue(t, d, pi, si + 1)
            elif pi + 1 < len(orders[d]):
                issue(t, d, pi + 1, 0)
        return [dst_done[d] - starts[d] for d in range(self.n)]


def _lcg(seed: int):
    x = seed * 6364136223846793005 + 1442695040888963407
    while True:
        x = (x * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        yield x >> 33


def tdm_speedup(group_size: int, pull_bytes: int, bw: float, slice_bytes: int = 1 << 20,
                seeds: Iterable[int] = range(16)) -> dict[str, float]:
    """Mean makespan with and without TDM slicing (Table 4's mechanism):
    monolithic pulls cannot pipeline (``inflight=1``), slices can."""
    seeds = list(seeds)
    mono = CopyEngineSim(group_size, bw, None, inflight=1)
    tdm = CopyEngineSim(group_size, bw, slice_bytes, inflight=2)
    t_mono = sum(mono.run(pull_bytes, s) for s in seeds) / len(seeds)
    t_tdm = sum(tdm.run(pull_bytes, s) for s in seeds) / len(seeds)
    return {"monolithic_s": t_mono, "tdm_s": t_tdm, "speedup": t_mono / t_tdm}
