"""Deterministic fault injection for the remote-weight fetch: the port of
``repro.core.faults``.

The route-before-gather fetch (the demand payload round, the predictive
speculative round, the residency cache) trusts every peer and every
fetched expert row. :class:`FaultInjector` is the adversary of that
trust, a seeded generator of per-row masks that tamper fetched rows as a
misbehaving peer or link would:

- ``drop``: the row never arrives (zero-filled), also the model of a
  peer too slow for the transfer window;
- ``zero``: the row arrives zeroed;
- ``corrupt``: the row arrives wrong, ``w -> 1 - w`` (every element
  changes, so the checksum moves far beyond its tolerance);
- ``cache_corrupt``: a residency-cache row rots in place between steps;
- ``bad_peers``: subgroup positions whose served rows always drop, the
  persistent storm that walks the engine's ``HealthMonitor`` down the
  degradation ladder;
- ``mirror``: one rank's mirrored predictor drifts for a step (sync_free):
  its speculative schedule differs from its peers' and the per-step
  schedule digest must catch it.

Detection and repair live in ``prefetch.verify_rows`` and the validated
branches of ``execution._moe_demand_layer``. Fail-stop faults
(``rank_death``) are a :class:`FaultTrace` event kind replayed by host
code, never injected into a step.

**The draws.** The JAX package draws its masks with ``jax.random`` from
the key chain ``seed -> crc32 site salt -> flat rank -> step``. Threefry's
bits cannot be reproduced in PyTorch (and differ between JAX releases),
so the port draws each uniform from its own counter-based hash of
``(seed, site salt, flat rank, step, row, column)``: 32-bit integer
mixing done with int64 tensor ops whose products stay below 2**63, so the
CPU and CUDA give the same bits. The step comes from the device (the
decode positions' maximum, a 0-d tensor): a CUDA graph replayed at step
``s`` draws step ``s``'s masks, and a step's masks are the same eagerly
and in a graph. Rates compare as integers (24-bit draws against
``ceil(rate * 2**24)``). The port's masks therefore differ from the JAX
package's; the structure around them (which rows, which sites, mutual
exclusion, the bad peers) is the same, and the CPU tests feed the
reference's own masks through the port's tampering and accounting.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.placement import Placement

#: Layout of the per-step fault-stats vector of the validated fetch
#: (length ``FAULT_STAT_BASE + subgroup_size``): ``[injected_drop,
#: injected_zero, injected_corrupt, injected_cache, detected,
#: fault_fallbacks, mirror_divergence, detected_by_src_position...]``.
#: ``fault_fallbacks`` counts the layers whose checksum failures forced
#: the full-gather fallback, ``mirror_divergence`` the sync-free layers
#: whose schedule digests disagreed; the tail attributes each detected row
#: to the subgroup position that served it (cache rows to the position
#: owning the expert id), the per-peer signal the ``HealthMonitor`` reads.
FAULT_STAT_BASE = 7
FAULT_STAT_NAMES = (
    "injected_drop", "injected_zero", "injected_corrupt",
    "injected_cache", "detected", "fault_fallbacks",
    "mirror_divergence",
)

#: Event kinds a :class:`FaultTrace` may carry: the payload kinds above
#: (a replayed event prices a forced full-gather fallback on its step,
#: attributed to its peer) and ``rank_death``, the fail-stop kind.
TRACE_KINDS = ("drop", "zero", "corrupt", "cache", "mirror", "rank_death")
RANK_DEATH = "rank_death"

#: payload kind -> index into the FAULT_STAT_NAMES prefix (rank_death is
#: accounted on the host, never in the stats vector)
_TRACE_STAT_INDEX = {"drop": 0, "zero": 1, "corrupt": 2, "cache": 3, "mirror": 6}


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """A timestamped fault-event trace, replayed in place of Bernoulli
    draws: ``steps`` decode-step indices (sorted, ties allowed), ``kinds``
    each event's :data:`TRACE_KINDS` entry, ``ranks`` the subgroup position
    that served the faulty rows (payload kinds) or the flat rank that died
    (``rank_death``)."""

    steps: np.ndarray
    kinds: tuple
    ranks: np.ndarray

    def __post_init__(self):
        steps = np.asarray(self.steps, np.int64)
        ranks = np.asarray(self.ranks, np.int64)
        kinds = tuple(str(k) for k in self.kinds)
        if not (len(steps) == len(kinds) == len(ranks)):
            raise ValueError(f"FaultTrace arrays disagree: {len(steps)} steps, "
                             f"{len(kinds)} kinds, {len(ranks)} ranks")
        if np.any(steps[1:] < steps[:-1]):
            raise ValueError("FaultTrace steps must be sorted ascending")
        if np.any(steps < 0) or np.any(ranks < 0):
            raise ValueError("FaultTrace steps/ranks must be >= 0")
        bad = sorted(set(kinds) - set(TRACE_KINDS))
        if bad:
            raise ValueError(f"unknown FaultTrace kinds {bad}; expected {TRACE_KINDS}")
        object.__setattr__(self, "steps", steps)
        object.__setattr__(self, "ranks", ranks)
        object.__setattr__(self, "kinds", kinds)

    def __len__(self) -> int:
        return len(self.steps)

    @classmethod
    def from_events(cls, events) -> "FaultTrace":
        """From ``(step, kind, rank)`` tuples in any order."""
        ev = sorted((int(s), str(k), int(r)) for s, k, r in events)
        return cls(steps=np.asarray([e[0] for e in ev], np.int64),
                   kinds=tuple(e[1] for e in ev),
                   ranks=np.asarray([e[2] for e in ev], np.int64))

    def events_in(self, start: int, stop: int) -> list:
        """``(step, kind, rank)`` events with ``start <= step < stop``."""
        lo = int(np.searchsorted(self.steps, start, side="left"))
        hi = int(np.searchsorted(self.steps, stop, side="left"))
        return [(int(self.steps[i]), self.kinds[i], int(self.ranks[i])) for i in range(lo, hi)]

    def events_at(self, step: int) -> list:
        """``(kind, rank)`` events at one decode step."""
        return [(k, r) for _, k, r in self.events_in(step, step + 1)]

    def next_event_step(self, step: int) -> Optional[int]:
        """The first event step ``>= step`` (None past the end)."""
        i = int(np.searchsorted(self.steps, step, side="left"))
        return int(self.steps[i]) if i < len(self.steps) else None

    def fallback_rate(self, horizon_steps: Optional[int] = None) -> float:
        """Share of decode steps carrying at least one payload event;
        ``horizon_steps`` defaults to the last event step + 1."""
        payload = [int(s) for s, k in zip(self.steps, self.kinds) if k != RANK_DEATH]
        if not payload:
            return 0.0
        horizon = int(horizon_steps) if horizon_steps else payload[-1] + 1
        fault_steps = {s for s in payload if s < horizon}
        return len(fault_steps) / max(1, horizon)

    def peer_pressure(self, n_peers: int) -> np.ndarray:
        """Payload events per subgroup position, normalized to [0, 1]."""
        counts = np.zeros(max(1, int(n_peers)), np.float64)
        for k, r in zip(self.kinds, self.ranks):
            if k != RANK_DEATH:
                counts[int(r) % len(counts)] += 1.0
        top = counts.max()
        return counts / top if top > 0 else counts

    def stat_vector(self, step: int, n_peers: int) -> Optional[np.ndarray]:
        """This step's payload events as a fault-stats vector (None when the
        step carries none): what a replay feeds the metrics and the
        ``HealthMonitor``."""
        vec = np.zeros(FAULT_STAT_BASE + max(1, int(n_peers)), np.float64)
        any_payload = False
        for kind, rank in self.events_at(step):
            if kind == RANK_DEATH:
                continue
            any_payload = True
            vec[_TRACE_STAT_INDEX[kind]] += 1.0
            vec[4] += 1.0  # detected
            vec[5] += 1.0  # fault_fallbacks
            vec[FAULT_STAT_BASE + int(rank) % max(1, int(n_peers))] += 1.0
        return vec if any_payload else None

    def save(self, path: str) -> None:
        np.savez_compressed(path, steps=self.steps, kinds=np.asarray(self.kinds, dtype="U16"),
                            ranks=self.ranks)

    @classmethod
    def load(cls, path: str) -> "FaultTrace":
        with np.load(path) as z:
            return cls(steps=z["steps"], kinds=tuple(str(k) for k in z["kinds"]),
                       ranks=z["ranks"])


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """The fault environment to inject: per-fetched-row Bernoulli rates in
    [0, 1], ``bad_peers`` (subgroup positions whose served rows always
    drop), ``mirror_rate`` (per-step probability that one rank's mirrored
    predictor drifts, sync_free only: the target rank is drawn alike on
    every rank and only it drifts) and ``trace`` (a recorded
    :class:`FaultTrace` for host-side replay; the injector ignores it).
    All zero = a healthy run whose validation still runs."""

    seed: int = 0
    drop_rate: float = 0.0
    zero_rate: float = 0.0
    corrupt_rate: float = 0.0
    cache_corrupt_rate: float = 0.0
    bad_peers: tuple = ()
    mirror_rate: float = 0.0
    trace: Optional[str] = None

    def __post_init__(self):
        for name in ("drop_rate", "zero_rate", "corrupt_rate", "cache_corrupt_rate",
                     "mirror_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultSpec.{name} must be in [0, 1], got {v}")
        object.__setattr__(self, "bad_peers", tuple(int(p) for p in self.bad_peers))
        if any(p < 0 for p in self.bad_peers):
            raise ValueError(f"FaultSpec.bad_peers must be non-negative subgroup positions, "
                             f"got {self.bad_peers}")

    @property
    def any_faults(self) -> bool:
        return bool(self.drop_rate or self.zero_rate or self.corrupt_rate
                    or self.cache_corrupt_rate or self.bad_peers or self.mirror_rate)

    def load_trace(self) -> Optional[FaultTrace]:
        """The :class:`FaultTrace` named by ``trace=`` (None without one)."""
        return None if self.trace is None else FaultTrace.load(self.trace)

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """The ``--fault-spec`` syntax: comma-separated ``key=value`` pairs,
        e.g. ``"seed=3,drop=0.1,corrupt=0.05,peers=2|5"``. Keys: seed, drop,
        zero, corrupt, cache, mirror, peers (``|``-separated subgroup
        positions), trace (a recorded FaultTrace .npz)."""
        kw: dict = {}
        names = {"seed": "seed", "drop": "drop_rate", "zero": "zero_rate",
                 "corrupt": "corrupt_rate", "cache": "cache_corrupt_rate",
                 "mirror": "mirror_rate"}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"fault-spec entry {part!r} is not key=value")
            k, v = (s.strip() for s in part.split("=", 1))
            if k == "peers":
                kw["bad_peers"] = tuple(int(p) for p in v.split("|") if p != "")
            elif k == "seed":
                kw["seed"] = int(v)
            elif k == "trace":
                kw["trace"] = v
            elif k in names:
                kw[names[k]] = float(v)
            else:
                raise ValueError(f"unknown fault-spec key {k!r} (expected seed/drop/zero/"
                                 "corrupt/cache/mirror/peers/trace)")
        return cls(**kw)

    def describe(self) -> str:
        parts = [f"seed={self.seed}"]
        for key, name in (("drop", "drop_rate"), ("zero", "zero_rate"),
                          ("corrupt", "corrupt_rate"), ("cache", "cache_corrupt_rate"),
                          ("mirror", "mirror_rate")):
            v = getattr(self, name)
            if v:
                parts.append(f"{key}={v}")
        if self.bad_peers:
            parts.append("peers=" + "|".join(str(p) for p in self.bad_peers))
        if self.trace is not None:
            parts.append(f"trace={self.trace}")
        return ",".join(parts)


def _salt(tag: str) -> int:
    # stable across processes (unlike hash())
    return zlib.crc32(tag.encode()) & 0x7FFFFFFF


# --------------------------------------------------------------------------
# The counter-based hash: 32-bit values held in int64, every product below
# 2**63, so CPU and CUDA tensors (and Python ints) give the same bits.
# --------------------------------------------------------------------------
_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_DRAW_BITS = 24


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for ``x < 2**32`` (int or int64 tensor), in
    16-bit halves of ``c``."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK


def _fmix(h):
    """MurmurHash3's 32-bit finalizer (a bijection with full avalanche)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fold(h, v):
    """One link of the key chain: ``fmix(h ^ fmix(v + golden))``."""
    return _fmix(h ^ _fmix((v + _GOLDEN) & _MASK))


def _threshold(rate: float) -> int:
    """``u < rate`` for a 24-bit draw ``u * 2**-24``, as an integer bound."""
    return math.ceil(rate * (1 << _DRAW_BITS))


class FaultInjector:
    """Fault masks and row tampering for the validated fetch of one plan.

    Every method is a pure function of its arguments and runs on the
    device of its ``step`` tensor with no host read, so it captures into a
    CUDA graph. The tamper site (``prefetch.gather_demand_payload``, the
    cache rot of the demand layer) and the counting site
    (``execution._injected_counts``) recompute the same masks from the
    same :meth:`site_key`."""

    def __init__(self, spec: FaultSpec, placement: Placement, mesh_sizes: dict):
        self.spec = spec
        self.pl = placement
        self.mesh_sizes = dict(mesh_sizes)
        self.n_ranks = math.prod(self.mesh_sizes.values())

    @staticmethod
    def step_tensor(step, device=None) -> torch.Tensor:
        """``step`` as a 0-d int64 tensor (a tensor keeps its device)."""
        if isinstance(step, torch.Tensor):
            return step.to(torch.int64).reshape(())
        return torch.full((), int(step), dtype=torch.int64, device=device)

    def site_key(self, tag: str, step, rank: int) -> torch.Tensor:
        """The key chain ``seed -> site salt -> flat rank -> step`` as a 0-d
        int64 tensor on ``step``'s device (``rank``: the flat logical rank,
        ``d * model + m``)."""
        h = _fold(_fold(self.spec.seed & _MASK, _salt(tag)), rank)
        return _fold(h, self.step_tensor(step) & _MASK)

    @staticmethod
    def draws(key: torch.Tensor, n: int) -> torch.Tensor:
        """``n`` 24-bit integer draws ``(n,)`` int64 from ``key``."""
        idx = torch.arange(n, dtype=torch.int64, device=key.device)
        return _fold(key, idx) >> (32 - _DRAW_BITS)

    def _below(self, key, n: int, rate: float) -> torch.Tensor:
        return self.draws(key, n) < _threshold(rate)

    def mirror_flag(self, step, rank: int) -> torch.Tensor:
        """The mirrored-predictor drift of one step (sync_free): every rank
        draws the same (fired, target rank) pair from ``seed -> "mirror" ->
        step`` with no rank fold, and only the target drifts. Returns a 0-d
        bool: "``rank``'s mirror drifts this step"."""
        step = self.step_tensor(step)
        if not self.spec.mirror_rate:
            return torch.zeros((), dtype=torch.bool, device=step.device)
        k = _fold(_fold(self.spec.seed & _MASK, _salt("mirror")), step & _MASK)
        d = self.draws(k, 2)
        fired = d[0] < _threshold(self.spec.mirror_rate)
        target = d[1] % self.n_ranks
        return fired & (target == rank)

    def payload_masks(self, key: torch.Tensor, budget: int, position: int):
        """Per-row ``(drop, zero, corrupt)`` masks of one payload of ``(G' -
        1) * budget`` peer-major rows (chunk ``t`` served by subgroup
        position ``(position + 1 + t) % G'``), mutually exclusive; rows a
        ``bad_peers`` position serves always drop."""
        g, local = self.pl.subgroup_size, self.pl.local_count
        budget = min(budget, local)
        rows = (g - 1) * budget
        if rows == 0:
            empty = torch.zeros(0, dtype=torch.bool, device=key.device)
            return empty, empty, empty
        u = self.draws(key, rows * 3).reshape(rows, 3)
        drop = u[:, 0] < _threshold(self.spec.drop_rate)
        if self.spec.bad_peers:
            src = (position + 1 + torch.arange(rows, device=key.device) // budget) % g
            for bp in self.spec.bad_peers:
                drop = drop | (src == bp % g)
        zero = (u[:, 1] < _threshold(self.spec.zero_rate)) & ~drop
        corrupt = (u[:, 2] < _threshold(self.spec.corrupt_rate)) & ~drop & ~zero
        return drop, zero, corrupt

    def cache_mask(self, key: torch.Tensor, rows: int) -> torch.Tensor:
        """Per-slot corruption mask of the residency cache."""
        if rows == 0:
            return torch.zeros(0, dtype=torch.bool, device=key.device)
        return self._below(key, rows, self.spec.cache_corrupt_rate)

    @staticmethod
    def tamper_rows(tree, drop: torch.Tensor, corrupt: torch.Tensor):
        """Apply row faults to a tree of ``(rows, ...)`` leaves, in place
        (no copy of the payload): dropped or zeroed rows are zero-filled,
        corrupted rows become ``1 - w``, computed in fp32 and rounded to the
        leaf's dtype as PyTorch's low-precision arithmetic does (the JAX
        package's ``(1 - w.astype(f32)).astype(dtype)``). Returns the
        tree."""
        if isinstance(tree, dict):
            for v in tree.values():
                FaultInjector.tamper_rows(v, drop, corrupt)
            return tree
        w = tree
        if w.shape[0] == 0:
            return w
        shape = (-1,) + (1,) * (w.dim() - 1)
        w.masked_fill_(drop.reshape(shape), 0)
        cm = corrupt.reshape(shape).to(w.dtype)
        # corrupt rows: -w + 1 (the negation is exact); others: w * 1 + 0
        w.mul_(1 - 2 * cm).add_(cm)
        return w
