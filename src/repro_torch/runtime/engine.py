"""Disaggregated serving on the port: context server (prefill + KV
capture), slot-based continuous-batching generation server, and the
engine that moves requests between them.

The port of ``repro.runtime.engine`` (``validate_restore_plan``,
``variant_key``, ``CountingStep``, ``PolicyVariantCache``, ``BudgetTuner``,
``OnlinePolicyScheduler``, ``Request``, ``HealthMonitor``, ``ContextServer``,
``GenerationServer``, ``DisaggregatedEngine``) for the ``dwdp``, ``dep``
and ``hybrid`` modes, under any gather-policy table (``policy=``: per
family and per layer group, split or merged, over any transport; the
uniform knobs ``weight_layout``, ``prefetch`` and ``expert_fetch``,
resolved as the JAX package's ``_resolve_policy``; or ``"auto"`` /
``"auto-online"``, resolved by the roofline model for ``hw`` at
``weight_bytes``: by default the card the server runs on, the JAX
package's defaults on the CPU, ``roofline.serving_target``),
with the all-fetch and the route-before-gather expert fetches (demand /
predictive / sync_free, which engage under dwdp only; the generation server carries
the predictive state across decode steps and keeps each step's
``pred_stats``), and the slot snapshots the serving layer's
evict-to-queue takes (``GenerationServer.snapshot_slot``). The
reference's default serving configuration, a DWDP context server feeding
a DEP generation server, hands the prefill's KV state over at one
``cache_len``. On a ``(data, model)`` mesh the context server shards its
one row's sequence over every rank while the generation server shards its
slots over ``data`` and their rings over ``model``: ``GenerationServer.
admit`` moves the ring between the two layouts itself
(``models.cache.read_row`` / ``write_row``), where the JAX package writes
one global array. A DEP context server is refused: DEP's tensor-parallel
prefill attention captures no KV state, in the JAX package as here.

Every step a server runs is one variant of a :class:`PolicyVariantCache`
keyed as the JAX package keys its jit variants: the policy table, the
shape bucket (the context server's pow2 prefill lengths) and the peer
exclusion set. Where the JAX package compiles a variant once, the port
captures it once: on a CUDA device each variant's step is a CUDA graph
(:class:`CountingStep`), replayed with no host work inside the step, and
``warmup`` captures every variant the server will run, so serving takes
no new capture (``variants.captures()`` stays flat). The steps run
deferred (``execution.Ctx.deferred``): a route-before-gather overflow is
read once per step together with the tokens, and such a step is run
again eagerly with per-layer host decisions (counted in ``fallbacks``).
On the CPU, which the tests ask for explicitly, the same deferred steps
run eagerly. Under ``"auto-online"`` an :class:`OnlinePolicyScheduler`
re-resolves the decode table before each decode step (active-row bucket,
measured hit rates, budget rungs); ``warmup`` captures every table it can
emit. The validated fetch (``fault_spec`` / ``validate_fetch``, keyed into
every variant) reports each decode step's fault counters with the step's
one host read; a :class:`HealthMonitor` on the engine reads their
per-peer tail and walks the generation server down its degradation
ladder (``strategy.degradation_ladder``: the root fetch, the per-peer
exclusion rung, demand, all) and back, every rung captured in
``warmup``; the terminal ``"reshard"`` rung (the all-gather table) is
stepped onto only explicitly, where a rank death swaps in a standby
engine on the survivors (``serving.live.LiveReplicaClient.kill_rank``).
Times are seconds on the host clock, read after the device
has finished (``torch.cuda.synchronize``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import counters
from repro_torch.configs.base import InputShape
from repro_torch.core import execution, roofline
from repro_torch.core.faults import FAULT_STAT_BASE, FaultSpec
from repro_torch.core.placement import subgroup_positions
from repro_torch.core.strategy import (
    PolicyLike,
    PolicyTable,
    degradation_ladder,
    make_execution_plan,
    plan_activation_sharding,
    resolve_policies,
    resolve_policy,
)
from repro_torch.models.cache import RingLayout, init_decode_state, read_row, write_row
from repro_torch.models.transformer import AXIS_MODEL, Model
from repro_torch.runtime.metrics import RequestRecord, ServingMetrics


def validate_restore_plan(snapshot_plan: Optional[dict], current_plan: dict) -> None:
    """Refuse to restore a ``snapshot_slot`` payload into a server whose
    active plan (``GenerationServer.restore_plan``) differs from the one
    the snapshot was taken under: its KV and position layout is valid only
    for the same model, mesh sizes, cache length, policy table and
    exclusion set. Raises ``ValueError`` naming every mismatched field (the
    serving scheduler turns it into a requeue from the prompt); ``None``
    passes."""
    if snapshot_plan is None:
        return
    bad = [
        f"{k}: snapshot {snapshot_plan.get(k)!r} != active {current_plan.get(k)!r}"
        for k in sorted(set(snapshot_plan) | set(current_plan))
        if snapshot_plan.get(k) != current_plan.get(k)
    ]
    if bad:
        raise ValueError(
            "snapshot_slot resume rejected — the destination's active plan differs from "
            "the snapshot's (" + "; ".join(bad) + "); requeue the request from its prompt instead"
        )


def variant_key(table: PolicyTable, shape: InputShape, excl: tuple = ()) -> tuple:
    """The forward-variant cache key: the canonical policy table
    (``describe()``), the shape bucket and the peer-exclusion set — the JAX
    package's key, per-layer-group overrides included. Model, mesh and
    mode are fixed per cache."""
    return (
        table.describe(),
        (shape.phase, shape.seq_len, shape.global_batch),
        tuple(int(p) for p in excl),
    )


# --------------------------------------------------------------------------
# Captured steps and the variant cache.
# --------------------------------------------------------------------------
def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []  # None fields of a PredictState


def _copy_into(dst, src) -> None:
    """Copy a tree of tensors into a tree of the same structure, in place
    (a leaf that is already the destination is left alone)."""
    if isinstance(dst, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
    elif isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"state trees differ: {sorted(dst)} vs {sorted(src)}")
        for key in dst:
            _copy_into(dst[key], src[key])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src, strict=True):
            _copy_into(d, s)
    elif dst is not None or src is not None:
        raise ValueError(f"state trees differ: {type(dst)} vs {type(src)}")


class GraphSpace:
    """Where one engine's CUDA graphs live: one memory pool that every graph
    of the engine (both servers, every variant) is captured into and that
    its eager warm-ups and overflow re-runs allocate from, and one stream
    that captures and eager work in the pool run on (the caching allocator
    reuses a free block only for work on the stream that freed it). Steps
    never overlap, so the graphs share one pool the size of the largest
    step's transient memory rather than their sum. The price: a graph's
    outputs, and an eager tensor allocated in the pool, are valid only
    until the next step that uses the pool — the servers copy what they
    keep (decode state, admitted KV) at once."""

    def __init__(self, device: torch.device):
        if device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        self.device = device
        self.pool = torch.cuda.MemPool()
        self.stream = torch.cuda.Stream(device)

    @contextlib.contextmanager
    def eager(self):
        """Eager work in the pool, on the space's stream, ordered after the
        caller's stream and before what the caller does next (a context)."""
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.use_mem_pool(self.pool, self.device), torch.cuda.stream(self.stream):
            yield
        caller.wait_stream(self.stream)


def _eager(space: Optional[GraphSpace]):
    return space.eager() if space is not None else contextlib.nullcontext()


class CountingStep:
    """One forward variant's step, ``fn(params, inputs) -> outputs``, with a
    capture count: ``captures()`` stands where the JAX package's
    ``cache_size()`` counts jit executables.

    ``inputs`` is the step's tree of static input tensors; a call copies the
    new values it is given into them. With a :class:`GraphSpace` the first
    call (or :meth:`warm`) runs ``fn`` once eagerly on the capture stream —
    module loading, kernel builds and library handles happen there, not in
    the capture — then captures it into a ``torch.cuda.CUDAGraph`` from the
    space's pool, and every call replays the graph and returns the same
    output tensors. A capture that fails raises. What the capture counted
    on the host (``counters``: launches, paths, landed bytes, demand
    layers) is taken back out of the counters and kept as ``record``, and
    each replay adds it, so the counters count what the card ran;
    ``replays`` counts the replays. Without a space (the CPU, or
    ``graphs=False``) every call runs ``fn`` eagerly. ``on_capture``, when
    set, is called at each capture (the variant cache counts them)."""

    def __init__(self, fn: Callable, inputs: dict, space: Optional[GraphSpace] = None):
        self._fn = fn
        self.inputs = inputs
        self.space = space
        self.n_captures = 0
        self.replays = 0
        self.on_capture: Optional[Callable[[], None]] = None
        self.graph = None
        self.outputs = None
        self.record = None
        self._params = None

    def __call__(self, params, **new_inputs) -> dict:
        for key, value in new_inputs.items():
            _copy_into(self.inputs[key], value)
        if self.space is None:
            return self._fn(params, self.inputs)
        if self.graph is None:
            self._capture(params)
        elif params is not self._params:
            raise ValueError("a captured step replays the weights it was captured with")
        self.graph.replay()
        self.replays += 1
        counters.add(self.record)
        return self.outputs

    def eager(self, params) -> dict:
        """One eager run of the step on its current inputs (in the space's
        pool, on its stream, where there is a space); the outputs are valid
        until the next step in the space."""
        with _eager(self.space):
            return self._fn(params, self.inputs)

    def warm(self, params) -> int:
        """Capture the step off the serving path; returns the number of
        captures made. Without a space there is nothing to capture: on the
        card one eager call, its outputs dropped, pays the step's first-use
        costs here; on the host the step runs first when served."""
        if self.space is None:
            first = next(iter(self.inputs.values()))
            if first.device.type != "cpu":
                self.eager(params)
            return 0
        if self.graph is not None:
            return 0
        self._capture(params)
        return 1

    def _capture(self, params) -> None:
        self.eager(params)
        graph = torch.cuda.CUDAGraph()
        # Collect dropped engines now, and not inside the capture: freeing a
        # graph there invalidates the capture.
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with counters.recording() as record, torch.cuda.graph(
                    graph, pool=self.space.pool.id, stream=self.space.stream):
                outputs = self._fn(params, self.inputs)
        finally:
            if enabled:
                gc.enable()
        self.graph, self.outputs, self.record, self._params = graph, outputs, record, params
        self.n_captures += 1
        if self.on_capture is not None:
            self.on_capture()

    def captures(self) -> int:
        """CUDA graphs this step has captured (0 where it runs eagerly)."""
        return self.n_captures

    def release(self) -> None:
        """Drop the graph and its outputs (their memory returns to the pool);
        the next call captures again."""
        self.graph = self.outputs = self.record = self._params = None


def _as_fault_spec(fault_spec) -> Optional[FaultSpec]:
    return FaultSpec.parse(fault_spec) if isinstance(fault_spec, str) else fault_spec


class PolicyVariantCache:
    """Forward-variant cache of one server: :func:`variant_key` -> ``(plan,
    CountingStep)``, built on a miss by ``build(plan)`` and kept LRU up to
    ``max_entries``; an eviction frees the variant's graph. ``stats``
    counts hits, misses and evictions; ``captures()`` counts every capture
    of a step the cache built, evicted ones included, and stays flat after
    warmup iff serving never captures. The plans carry the cache's fault
    environment (``fault_spec``, ``validate_fetch``; :meth:`set_faults`
    changes it) and each entry's peer-exclusion set, and the key carries
    all three."""

    def __init__(self, model: Model, mesh_sizes: dict, shape: InputShape,
                 build: Callable, *, mode: str = "dwdp", capacity_from: str = "local",
                 fault_spec=None, validate_fetch: bool = False, max_entries: int = 16):
        self.model = model
        self._mesh_sizes = mesh_sizes
        self.shape = shape
        self._build = build
        self._mode = mode
        self._capacity_from = capacity_from
        self.fault_spec = _as_fault_spec(fault_spec)
        self.validate_fetch = bool(validate_fetch)
        self.max_entries = max(1, int(max_entries))
        self._entries: dict = {}
        self.stats = {"hits": 0, "misses": 0, "evictions": 0}
        self.n_captures = 0

    def __len__(self) -> int:
        return len(self._entries)

    def steps(self) -> list[CountingStep]:
        """The cached variants' steps, least recently used first."""
        return [step for _, step in self._entries.values()]

    def captures(self) -> int:
        """Captures of the steps this cache built; an eviction does not
        lower it (a compile count)."""
        return self.n_captures

    def _captured(self) -> None:
        self.n_captures += 1

    def set_faults(self, fault_spec=None, validate_fetch: bool = False) -> None:
        """The fault environment of the variants :meth:`get` returns from
        now on (each one an entry of its own; earlier ones stay cached)."""
        self.fault_spec = _as_fault_spec(fault_spec)
        self.validate_fetch = bool(validate_fetch)

    def _key(self, table: PolicyTable, excl: tuple, shape: Optional[InputShape]) -> tuple:
        """The entry key: the cache's mode and fault environment, then
        :func:`variant_key`."""
        faults = (None if self.fault_spec is None else self.fault_spec.describe(),
                  self.validate_fetch)
        return (self._mode, faults,
                *variant_key(table, shape if shape is not None else self.shape, excl))

    def get(self, table: PolicyTable, excl: tuple = (), shape: Optional[InputShape] = None):
        """The (plan, step) variant of a policy table and peer-exclusion set
        under the cache's fault environment, built on a miss. ``shape``
        overrides the home shape bucket (the context server's prefill
        lengths key in through here)."""
        key = self._key(table, excl, shape)
        if key in self._entries:
            self.stats["hits"] += 1
            self._entries[key] = self._entries.pop(key)  # refresh the LRU position
            return self._entries[key]
        self.stats["misses"] += 1
        xp = make_execution_plan(self.model, shape if shape is not None else self.shape,
                                 self._mesh_sizes, mode=self._mode, policy=table,
                                 capacity_from=self._capacity_from, fault_spec=self.fault_spec,
                                 validate_fetch=self.validate_fetch,
                                 exclude_peers=tuple(int(p) for p in excl))
        entry = (xp, self._build(xp))
        entry[1].on_capture = self._captured
        while len(self._entries) >= self.max_entries:
            self._entries.pop(next(iter(self._entries)))[1].release()
            self.stats["evictions"] += 1
        self._entries[key] = entry
        return entry

    def release(self) -> None:
        """Drop every cached variant's graph and outputs (their memory goes
        back to the pool); a later call captures again."""
        for step in self.steps():
            step.release()

    def adopt(self, table: PolicyTable, excl: tuple, entry,
              shape: Optional[InputShape] = None) -> None:
        """Seed the cache with an already-built variant without a miss."""
        self._entries.setdefault(self._key(table, excl, shape), entry)


# --------------------------------------------------------------------------
# Online policy switching (``policy="auto-online"``).
# --------------------------------------------------------------------------
class BudgetTuner:
    """Online speculative-budget resizing over captured rungs.

    Watches each decode step's ``pred_stats`` (``[predicted, spec_hit,
    cache_hit, miss, evicted]`` expert rows) and moves the speculative /
    correction row budget one rung of ``rungs``
    (``budget.predictive_budget_rungs``) up when the miss share exceeds
    ``raise_miss_frac``, or down when misses are rare (below
    ``lower_miss_frac``) and the speculative round's use (``spec_hit /
    predicted``) is below ``lower_util``; ``min_dwell`` observed steps pass
    between moves. Every budget it emits is a rung, so a server that
    captured one variant per rung resizes with no capture."""

    def __init__(self, rungs, *, start: Optional[int] = None,
                 raise_miss_frac: float = 0.25, lower_util: float = 0.5,
                 lower_miss_frac: float = 0.1, min_dwell: int = 4):
        rungs = tuple(sorted(int(r) for r in rungs))
        if not rungs:
            raise ValueError("BudgetTuner needs at least one rung")
        self.rungs = rungs
        if start is None:
            self.idx = min(len(rungs) - 1, 1)
        else:
            self.idx = min(range(len(rungs)), key=lambda i: abs(rungs[i] - start))
        self.raise_miss_frac = raise_miss_frac
        self.lower_util = lower_util
        self.lower_miss_frac = lower_miss_frac
        self.min_dwell = min_dwell
        self._since = min_dwell  # free to act on the first signal

    @property
    def budget(self) -> int:
        return self.rungs[self.idx]

    def observe(self, pred_stats) -> Optional[int]:
        """One decode step's counters; the new rung budget when it moves,
        else None."""
        if pred_stats is None:
            return None
        pred, spec_hit, cache_hit, miss, _ = (float(s) for s in pred_stats)
        denom = spec_hit + cache_hit + miss
        self._since += 1
        if denom <= 0 or self._since <= self.min_dwell:
            return None
        miss_frac = miss / denom
        util = spec_hit / pred if pred > 0 else 1.0
        if miss_frac > self.raise_miss_frac and self.idx + 1 < len(self.rungs):
            self.idx += 1
            self._since = 0
            return self.rungs[self.idx]
        if miss_frac < self.lower_miss_frac and util < self.lower_util and self.idx > 0:
            self.idx -= 1
            self._since = 0
            return self.rungs[self.idx]
        return None


def _with_spec_budget(table: PolicyTable, budget: int) -> PolicyTable:
    """``table`` with every predictive / sync-free ``moe_experts`` entry
    (family and per-group overrides) pinned to ``budget`` rows: one rung's
    table."""

    def upd(name, pol):
        if name == "moe_experts" and pol.fetch in ("predictive", "sync_free"):
            return dataclasses.replace(pol, budget=int(budget))
        return pol

    return dataclasses.replace(
        table,
        families=tuple((n, upd(n, p)) for n, p in table.families),
        overrides=tuple((g, n, upd(n, p)) for g, n, p in table.overrides),
    )


class OnlinePolicyScheduler:
    """Online policy switching between captured decode variants
    (``policy="auto-online"``): before each decode step it re-resolves the
    table (``strategy.resolve_policies`` on ``hw`` at ``weight_bytes``)
    from three signals and moves the generation server with ``set_policy``:

    - the active rows, bucketed to powers of two (at most the server's
      batch): a new bucket re-resolves at once, at that bucket's rows;
    - the measured hit rates, an EMA of each step's ``pred_stats`` split
      into ``(predict_hit, cache_hit)`` on a 0.05 grid, replayed into the
      resolver (``hit_rates=``) every ``interval`` decode steps;
    - a :class:`BudgetTuner` over the speculative budget's rungs.

    Resolutions are cached by (bucket, quantized rates), so a revisited
    operating point gives the same table and the same captured variant;
    :meth:`candidate_tables` lists what ``DisaggregatedEngine.warmup``
    captures. It moves the server only at ladder level 0
    (``GenerationServer.set_policy``): a health-degraded server keeps its
    rung until the monitor promotes it back, as in the JAX package."""

    def __init__(self, model: Model, mesh_sizes, shape: InputShape, *,
                 interval: int = 8, ema_decay: float = 0.8, hw=None, weight_bytes: int = 1,
                 tuner: Optional[BudgetTuner] = None):
        self.model = model
        self.mesh_sizes = dict(mesh_sizes)
        self.shape = shape
        self.interval = max(1, int(interval))
        self.ema_decay = ema_decay
        self.hw = hw
        self.weight_bytes = weight_bytes
        self.tuner = tuner
        self._tuner_resolved = tuner is not None
        self._hit_ema: Optional[tuple] = None  # (predict_hit, cache_hit)
        self._bucket: Optional[int] = None
        self._steps = 0
        self._resolved: dict = {}  # (bucket, quantized rates) -> table

    def _bucket_of(self, active_rows: int) -> int:
        b = 1
        while b < active_rows:
            b *= 2
        return min(b, self.shape.global_batch)

    def _observe_rates(self, pred_stats) -> None:
        if pred_stats is None:
            return
        _, spec_hit, cache_hit, miss, _ = (float(s) for s in pred_stats)
        denom = spec_hit + cache_hit + miss
        if denom <= 0:
            return
        # the roofline's factoring: (1 - cache_hit) * (1 - predict_hit) is
        # the correction round's share
        cache = cache_hit / denom
        non_cache = spec_hit + miss
        predict = spec_hit / non_cache if non_cache > 0 else 1.0
        rates = (predict, cache)
        if self._hit_ema is None:
            self._hit_ema = rates
        else:
            d = self.ema_decay
            self._hit_ema = tuple(d * e + (1.0 - d) * r for e, r in zip(self._hit_ema, rates))

    def _quantized_rates(self) -> Optional[tuple]:
        """The EMA rates on a 0.05 grid: the resolution cache's key."""
        if self._hit_ema is None:
            return None
        return tuple(round(r * 20) / 20 for r in self._hit_ema)

    def _resolve(self, bucket: int) -> PolicyTable:
        q = self._quantized_rates()
        key = (bucket, q)
        if key not in self._resolved:
            shape = dataclasses.replace(self.shape, global_batch=bucket)
            hit_rates = None
            if q is not None:
                predict, cache = q
                hit_rates = {g: {"predict_hit": predict, "cache_hit": cache}
                             for g in set(roofline.layer_group_names(self.model.cfg))}
            self._resolved[key] = resolve_policies(
                self.model, shape, self.mesh_sizes, "auto", hw=self.hw,
                weight_bytes=self.weight_bytes, hit_rates=hit_rates)
        return self._resolved[key]

    def _ensure_tuner(self, gen: "GenerationServer") -> None:
        if self._tuner_resolved:
            return
        self._tuner_resolved = True
        cfg, pl = self.model.cfg, self.model.geom.moe_placement
        if cfg.moe is None or pl is None or pl.subgroup_size <= 1:
            return
        rows = max(1, gen.xp.local_batch)
        rungs = roofline.predictive_budget_rungs(rows * cfg.moe.top_k, cfg.moe.num_experts,
                                                 pl.local_count)
        start = gen.xp.policies.family("moe_experts").budget or None
        self.tuner = BudgetTuner(rungs, start=start)

    def _snap_budget(self, table: PolicyTable) -> PolicyTable:
        if self.tuner is None:
            return table
        return _with_spec_budget(table, self.tuner.budget)

    def step(self, gen: "GenerationServer", active_rows: int) -> Optional[str]:
        """One decision before a decode step: ``"switch"``, ``"resize"`` or
        None (what the server moved to, if anything)."""
        self._ensure_tuner(gen)
        self._steps += 1
        self._observe_rates(gen.last_pred_stats)
        resized = (self.tuner.observe(gen.last_pred_stats) is not None
                   if self.tuner is not None else False)
        bucket = self._bucket_of(max(1, active_rows))
        boundary = bucket != self._bucket
        if boundary or self._steps % self.interval == 0 or resized:
            self._bucket = bucket
            table = self._snap_budget(self._resolve(bucket))
            if gen.set_policy(table):
                return "resize" if resized and not boundary else "switch"
        return None

    def candidate_tables(self, gen: "GenerationServer") -> list:
        """The tables to capture before serving: the resolved table of each
        bucket (at the closed-form rates) x the budget rungs, deduplicated,
        at most the variant cache's size (warming never evicts what it just
        captured)."""
        self._ensure_tuner(gen)
        out, seen = [], set()
        budgets: tuple = (None,)
        if self.tuner is not None:
            budgets = (None, *self.tuner.rungs)
        bucket, buckets = 1, []
        while bucket <= self.shape.global_batch:
            buckets.append(bucket)
            bucket *= 2
        for b in buckets:
            base = self._resolve(b)
            for budget in budgets:
                t = base if budget is None else _with_spec_budget(base, budget)
                d = t.describe()
                if d not in seen:
                    seen.add(d)
                    out.append(t)
        return out[: gen.variants.max_entries]


def _resolve_policy_table(model: Model, shape: InputShape, mesh_sizes: dict, policy, *,
                          hw=None, weight_bytes: int = 1) -> PolicyTable:
    """A concrete table for the variant cache's key: a table passes through;
    mappings, specs, ``"auto"`` and ``"auto-online"`` go through
    ``strategy.resolve_policies`` (what ``make_execution_plan`` resolves
    too)."""
    if isinstance(policy, PolicyTable):
        return policy
    return resolve_policies(model, shape, mesh_sizes, policy, hw=hw, weight_bytes=weight_bytes)


def _target(model: Model, hw, weight_bytes) -> tuple:
    """A server's ``(hw, weight_bytes)``: the given ones, each ``None``
    taken from ``roofline.serving_target``."""
    default_hw, default_wb = roofline.serving_target(model)
    return (hw if hw is not None else default_hw,
            weight_bytes if weight_bytes is not None else default_wb)


# --------------------------------------------------------------------------
# Servers.
# --------------------------------------------------------------------------
def decode_axes(cfg, mesh_sizes: dict, max_batch: int, cache_len: int) -> tuple:
    """The ``(batch_axes, seq_axes)`` of a generation server's decode plan;
    ``ValueError`` where they would shard the batch over ``model``: decode
    keeps its rows replicated over the vocab-sharded model axis (the JAX
    package asserts it), so ``max_batch`` may divide over ``data`` but not
    over ``data * model``."""
    batch_axes, seq_axes = plan_activation_sharding(
        cfg, InputShape("gen", cache_len, max_batch, "decode"), mesh_sizes)
    if AXIS_MODEL in batch_axes:
        raise ValueError(
            f"max_batch {max_batch} on the mesh {dict(mesh_sizes)} would shard the decode "
            f"batch over {batch_axes}: decode keeps its rows replicated over the model axis; "
            f"pick a max_batch that {math.prod(mesh_sizes.values())} does not divide")
    return batch_axes, seq_axes


@dataclasses.dataclass
class Request:
    req_id: int
    tokens: np.ndarray        # (prompt_len,)
    target_len: int           # output tokens to generate
    arrival: float = 0.0

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens)
        if self.tokens.ndim != 1 or self.tokens.size == 0:
            raise ValueError(
                f"Request {self.req_id}: tokens must be a non-empty 1-d "
                f"prompt, got shape {self.tokens.shape}"
            )
        if int(self.target_len) < 1:
            raise ValueError(
                f"Request {self.req_id}: target_len must be >= 1 "
                f"(the prefill emits the first token), got {self.target_len}"
            )


class HealthMonitor:
    """Per-peer fault pressure with hysteresis (the JAX package's, on
    numpy). Each decode step's per-source detected counts (the tail of the
    fault-stats vector) feed an EMA of "this peer served a bad row this
    step" per peer. A peer above ``demote_threshold`` asks for a demotion
    down the degradation ladder; once every peer is below
    ``promote_threshold`` the monitor asks for a promotion; ``min_dwell``
    steps pass between moves, so one bad step cannot flap the policy."""

    def __init__(self, *, decay: float = 0.7, demote_threshold: float = 0.5,
                 promote_threshold: float = 0.1, min_dwell: int = 2):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        if promote_threshold >= demote_threshold:
            raise ValueError("promote_threshold must sit below demote_threshold (hysteresis), "
                             f"got {promote_threshold} >= {demote_threshold}")
        self.decay = decay
        self.demote_threshold = demote_threshold
        self.promote_threshold = promote_threshold
        self.min_dwell = min_dwell
        self.ema = np.zeros(0)
        self._since_move = min_dwell  # free to act at once

    def observe(self, detected_by_peer) -> Optional[str]:
        """One step's per-peer detected counts: "demote", "promote" or
        None."""
        ev = (np.asarray(detected_by_peer, np.float64) > 0).astype(np.float64)
        if self.ema.shape != ev.shape:
            self.ema = np.zeros_like(ev)
        self.ema = self.decay * self.ema + (1.0 - self.decay) * ev
        self._since_move += 1
        if self._since_move <= self.min_dwell or self.ema.size == 0:
            return None
        if np.max(self.ema) > self.demote_threshold:
            self._since_move = 0
            return "demote"
        if np.max(self.ema) < self.promote_threshold:
            self._since_move = 0
            return "promote"
        return None

    def worst_peer(self) -> Optional[int]:
        """The subgroup position under the most pressure (None before any
        observation)."""
        if self.ema.size == 0:
            return None
        return int(np.argmax(self.ema))

    def bad_peers(self) -> tuple:
        """The peers the exclusion rung leaves out: every position above
        ``demote_threshold``, hottest first, or the single worst one where a
        demotion fired on a step whose decay already brought every EMA under
        it; never every position (at least one peer stays speculated)."""
        if self.ema.size == 0:
            return ()
        order = np.argsort(-self.ema, kind="stable")
        hot = [int(p) for p in order if self.ema[p] > self.demote_threshold]
        if not hot:
            hot = [int(order[0])]
        return tuple(hot[: max(1, self.ema.size - 1)])


class ContextServer:
    """Prefill worker: returns (first_token, captured decode state).
    ``ContextServer`` prefills one request at a time (global batch 1), so
    the mesh shards the prompt's sequence (on ``(2, 4)`` over both axes:
    eight slices).

    Prompt lengths are served from pow2 buckets: ``prefill_len`` is the
    home bucket and ``prefill_buckets`` adds lengths, each a power of two;
    each length is one variant of the prefill step, and :meth:`warmup`
    captures every one. ``gather_bytes`` is the installed bucket's static
    wire-byte model (``execution.gathered_wire_bytes_per_step``), the one
    the serving metrics attribute per request. ``fallbacks`` counts
    prefills run again eagerly after a deferred overflow,
    ``overflow_layers`` the route-before-gather layers that overflowed in
    them. ``"auto"`` resolves once, at ``prefill_len``, for ``hw`` at
    ``weight_bytes`` (each ``None``: ``roofline.serving_target``), and every
    bucket runs that table, as in the JAX package. ``fault_spec`` /
    ``validate_fetch`` validate (and inject faults into) the prefill's
    route-before-gather layers, where they engage; a detected row re-runs
    the prefill eagerly as an overflow does."""

    def __init__(self, model: Model, mesh_sizes: dict, *, mode: str = "dwdp",
                 prefill_len: int, cache_len: int,
                 capacity_from: str = "local", expert_fetch: str = "all",
                 demand_budget: int = 0, cache_budget: int = 0,
                 policy: PolicyLike = None, weight_layout: Optional[str] = None,
                 prefetch: str = "allgather", hw=None, weight_bytes: Optional[int] = None,
                 prefill_buckets: tuple = (), fault_spec=None, validate_fetch: bool = False,
                 space: Optional[GraphSpace] = None):
        self.model = model
        self.prefill_len = prefill_len
        self.cache_len = cache_len
        for b in prefill_buckets:
            b = int(b)
            if b < 1 or b & (b - 1):
                raise ValueError(f"prefill_buckets must be powers of two, got {b}")
        self.prefill_lens = tuple(sorted({int(prefill_len), *(int(b) for b in prefill_buckets)}))
        self.space = space
        self.fallbacks = self.overflow_layers = 0
        self.hw, self.weight_bytes = _target(model, hw, weight_bytes)
        shape = InputShape("ctx", prefill_len, 1, "prefill")
        self._table = _resolve_policy_table(
            model, shape, mesh_sizes,
            resolve_policy(policy, prefetch=prefetch, weight_layout=weight_layout,
                           expert_fetch=expert_fetch, demand_budget=demand_budget,
                           cache_budget=cache_budget),
            hw=self.hw, weight_bytes=self.weight_bytes)
        if not execution.captures_kv(model.geom, make_execution_plan(
                model, shape, mesh_sizes, mode=mode, policy=self._table)):
            raise ValueError(
                f"ContextServer(mode={mode!r}): DEP's tensor-parallel prefill attention "
                "captures no KV state (nor does the JAX package's: its DEP context server "
                "fails at the first prefill), so there is no decode state to hand over; "
                "serve the context phase with mode 'dwdp' (the default) or 'hybrid'")
        self.variants = PolicyVariantCache(
            model, mesh_sizes, shape, self._build,
            mode=mode, capacity_from=capacity_from, fault_spec=fault_spec,
            validate_fetch=validate_fetch, max_entries=max(16, len(self.prefill_lens)),
        )
        self._install(prefill_len)

    def _install(self, length: int) -> None:
        """Make one bucket's variant the server's current plan and step."""
        self.xp, self.step = self._bucket(length)
        self.gather_bytes = execution.gathered_wire_bytes_per_step(self.model, self.xp)

    def _build(self, xp) -> CountingStep:
        tokens = torch.zeros((1, xp.seq_len), dtype=torch.int64, device=self.model.device)

        def fn(params, inputs):
            ctx = execution.Ctx(model=self.model, xp=xp, capture_len=self.cache_len,
                                deferred=True)
            return execution.forward_prefill(params, inputs["tokens"], ctx)

        return CountingStep(fn, {"tokens": tokens}, self.space)

    def _bucket(self, length: int):
        """The (plan, step) variant of one prefill-length bucket."""
        return self.variants.get(self._table, shape=InputShape("ctx", int(length), 1, "prefill"))

    def _check_length(self, length: int) -> None:
        if length not in self.prefill_lens:
            raise ValueError(f"prompt length {length} matches no prefill bucket "
                             f"(prefill_lens={self.prefill_lens})")

    def warmup(self, params) -> int:
        """Capture the prefill step of every bucket off the serving path;
        returns the captures made."""
        return sum(self._bucket(length)[1].warm(params) for length in self.prefill_lens)

    def forward(self, params, tokens: np.ndarray, *, impl: Optional[str] = None) -> dict:
        """One eager prefill of ``tokens`` (prompt_len,) with per-layer host
        decisions -> the forward's outputs (``last_logits`` (1, vocab_pad)
        f32 and the captured ``state``), valid until the server's next
        step. ``impl="torch"`` runs the plain version of every kernel."""
        self._check_length(len(tokens))
        xp = self._bucket(len(tokens))[0]
        row = torch.as_tensor(np.asarray(tokens)[None, :], dtype=torch.int64,
                              device=self.model.device)
        ctx = execution.Ctx(model=self.model, xp=xp, capture_len=self.cache_len, impl=impl)
        with _eager(self.space):
            return execution.forward_prefill(params, row, ctx)

    def prefill(self, params, tokens: np.ndarray):
        """tokens: (prompt_len,) -> (first_token, state); the state is valid
        until the server's next step (``GenerationServer.admit`` copies
        it)."""
        self._check_length(len(tokens))
        self._install(len(tokens))
        out = self.step(params, tokens=torch.as_tensor(np.asarray(tokens)[None, :],
                                                        dtype=torch.int64))
        first, overflow, layers = torch.stack([
            out["last_logits"][0].argmax(), out["overflow"].long(),
            out["overflow_layers"].long()]).tolist()
        if overflow:
            self.fallbacks += 1
            self.overflow_layers += layers
            out = self.forward(params, tokens)
            first = int(out["last_logits"][0].argmax())
        return first, out["state"]


class GenerationServer:
    """Slot-based continuous-batching decode worker.

    The server owns the decode state buffers (KV ring and positions, shared
    by every decode variant, and each variant's predictive state) and the
    token row; they are the steps' static inputs. A step's outputs are read
    once (the tokens with the overflow flag and ``pred_stats``) and copied
    into the buffers. Under the predictive and sync-free fetch the state
    carries the per-rank predictor and residency cache (``state["pred"]``);
    it is per rank, not per slot, so admitting a request leaves it as it
    is. ``pred_stats`` keeps each decode step's ``[predicted, spec_hit,
    cache_hit, corr_rows, evicted]`` expert rows (summed over layers and
    ranks), the last of them also as ``last_pred_stats`` (None under a
    plan without the predictive fetch), and ``expert_bytes`` converts
    those rows to bytes. ``gather_bytes`` is the installed variant's static
    wire-byte model (``execution.gathered_wire_bytes_per_step``).
    ``fallbacks`` counts steps run again eagerly after a deferred overflow,
    ``overflow_layers`` the route-before-gather layers that overflowed in
    them.

    On a ``(data, model)`` mesh the slots are sharded over ``data`` (slot
    ``i`` lives in data replica ``i // (max_batch / data)``) and their KV
    rings over ``model``; a decode batch that the mesh would shard over
    ``model`` is refused at construction (``ValueError``), as the JAX
    package's decode asserts.

    Evict-to-queue: :meth:`snapshot_slot` copies one slot's decode state to
    the host in the context-transfer layout, stamped with
    :meth:`restore_plan`; :meth:`admit` takes such a snapshot back into any
    slot, in place, after :func:`validate_restore_plan`.

    ``"auto"`` / ``"auto-online"`` resolve at ``max_batch`` rows for ``hw``
    at ``weight_bytes`` (each ``None``: ``roofline.serving_target``); an
    :class:`OnlinePolicyScheduler` moves an ``"auto-online"`` server
    between tables with :meth:`set_policy`.

    Faults: ``fault_spec`` / ``validate_fetch`` (:meth:`set_faults`) run
    the validated fetch; each decode step's counters (the vector of
    ``faults.FAULT_STAT_NAMES`` and the per-source tail) come back with the
    step's one host read, as ``last_fault_stats``;
    ``fault_fallbacks`` counts the steps run again eagerly because a
    checksum failed. ``ladder`` is the degradation ladder of the installed
    table (``strategy.degradation_ladder``), ``level`` the rung in use
    (``fetch_label``); :meth:`set_level` moves between rungs, each one a
    variant keyed by its table and peer-exclusion set, and :meth:`warmup`
    captures them all when asked (``ladder=True``)."""

    def __init__(self, model: Model, mesh_sizes: dict, *, mode: str = "dwdp",
                 max_batch: int, cache_len: int,
                 capacity_from: str = "local", expert_fetch: str = "all",
                 demand_budget: int = 0, cache_budget: int = 0,
                 policy: PolicyLike = None, weight_layout: Optional[str] = None,
                 prefetch: str = "allgather", hw=None, weight_bytes: Optional[int] = None,
                 fault_spec=None, validate_fetch: bool = False,
                 variant_cache_size: int = 16, space: Optional[GraphSpace] = None):
        self.model = model
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.space = space
        self._mesh_sizes = dict(mesh_sizes)
        self._shape = InputShape("gen", cache_len, max_batch, "decode")
        batch_axes, seq_axes = decode_axes(model.cfg, mesh_sizes, max_batch, cache_len)
        self.variants = PolicyVariantCache(
            model, mesh_sizes, self._shape, self._build, mode=mode,
            capacity_from=capacity_from, fault_spec=fault_spec, validate_fetch=validate_fetch,
            max_entries=variant_cache_size,
        )
        # predictive-state buffers by layout, shared by the variants of one
        # layout: only the installed variant's state is live (a switch
        # starts cold), and a warm-up step never writes its inputs
        self._pred_buffers: dict = {}
        batch_shards = math.prod(mesh_sizes[a] for a in batch_axes)
        self._kv = init_decode_state(model, max_batch, cache_len, batch_shards=batch_shards,
                                     seq_shards=math.prod(mesh_sizes[a] for a in seq_axes))
        self.slot_rows = max_batch // batch_shards  # slots per data replica
        self.cur_token = torch.zeros((max_batch, 1), dtype=torch.int64, device=model.device)
        self.pred_stats: list[np.ndarray] = []
        self.last_pred_stats: Optional[np.ndarray] = None
        self.last_fault_stats: Optional[np.ndarray] = None
        self.fault_fallbacks = 0
        self.excl: tuple = ()
        self.level = 0
        cfg = model.cfg
        self.expert_bytes = (3 * cfg.d_model * cfg.moe.d_ff * model.dtype.itemsize
                             if cfg.moe is not None else 0)
        self.fallbacks = self.overflow_layers = 0
        self.slot_req: list[Optional[int]] = [None] * max_batch
        self.slot_remaining = np.zeros(max_batch, np.int64)
        self.hw, self.weight_bytes = _target(model, hw, weight_bytes)
        table = self._resolve(resolve_policy(
            policy, prefetch=prefetch, weight_layout=weight_layout, expert_fetch=expert_fetch,
            demand_budget=demand_budget, cache_budget=cache_budget))
        self.ladder = degradation_ladder(table)
        self._swap(table, ())

    def _build(self, xp) -> CountingStep:
        state = {"pos": self._kv["pos"], "layers": self._kv["layers"]}
        pred = execution.init_predict_state(self.model, xp)
        if pred:
            layout = tuple((tuple(t.shape), t.dtype) for t in _leaves(pred))
            state["pred"] = self._pred_buffers.setdefault(layout, pred)

        def fn(params, inputs):
            ctx = execution.Ctx(model=self.model, xp=xp, deferred=True)
            return execution.forward_decode(params, inputs["token"], inputs["state"], ctx)

        return CountingStep(fn, {"token": self.cur_token, "state": state}, self.space)

    def _resolve(self, policy: PolicyLike) -> PolicyTable:
        """``policy`` as a concrete table at the server's decode shape."""
        return _resolve_policy_table(self.model, self._shape, self._mesh_sizes, policy,
                                     hw=self.hw, weight_bytes=self.weight_bytes)

    def _swap(self, table: PolicyTable, excl: tuple) -> None:
        """Install the (table, exclusion set) variant with a cold predictive
        state: its buffers zeroed in place (the predictor and the residency
        cache do not survive a policy change; their budgets differ)."""
        self.xp, self.step = self.variants.get(table, excl)
        self.excl = excl
        self.gather_bytes = execution.gathered_wire_bytes_per_step(self.model, self.xp)
        self.state = self.step.inputs["state"]
        for t in _leaves(self.state.get("pred")):
            t.zero_()
        self.last_pred_stats = None
        self.last_fault_stats = None

    @property
    def fetch_label(self) -> str:
        """The ladder rung in use: "sync_free" / "predictive" / "<root>+excl"
        / "demand" / "all"."""
        return self.ladder[self.level][0]

    @property
    def max_silent_level(self) -> int:
        """The deepest rung fail-silent demotions reach, the all-gather
        floor: the terminal ``"reshard"`` rung answers a rank death."""
        top = len(self.ladder) - 1
        return max(0, top - 1) if self.ladder[top][0] == "reshard" else top

    @staticmethod
    def _excl(bad_peers) -> tuple:
        """An exclusion set's key: the positions, sorted (the order the
        monitor names them in changes nothing)."""
        return tuple(sorted({int(p) for p in bad_peers}))

    def _rung(self, level: int, bad_peers=()) -> tuple:
        """The (table, exclusion set) of a ladder level. The ``"reshard"``
        rung is the ladder's own entry, the all-gather table with no
        exclusion (``degrade_policy_table(table, "all")``): the variant the
        all-gather floor captured already."""
        _, table, excl = self.ladder[level]
        return table, self._excl(bad_peers if excl is None else excl)

    def set_level(self, level: int, bad_peers: tuple = ()) -> bool:
        """Move to a ladder level (clamped); returns whether the level
        changed. The level's variant is installed (captured already when
        warmed) with a cold predictive state, the KV slots carried over; an
        exclusion rung leaves out ``bad_peers`` (the monitor's
        :meth:`HealthMonitor.bad_peers`), one variant per set. Only an
        explicit call steps onto the terminal ``"reshard"`` rung
        (:attr:`max_silent_level` keeps a monitor above it); the shrunk mesh
        itself is the standby engine ``LiveReplicaClient.kill_rank`` swaps
        in."""
        level = max(0, min(int(level), len(self.ladder) - 1))
        if level == self.level:
            return False
        self._swap(*self._rung(level, bad_peers))
        self.level = level
        return True

    def set_policy(self, table: PolicyLike) -> bool:
        """Online policy switch: move the decode step to another policy
        table's variant (any layout, transport, fetch or per-group mix) —
        captured already when warmed, built and captured on first use
        otherwise — with a cold predictive state, and rebase the ladder on
        it; KV slots carry over and no tensor the graphs read is rebound.
        Only at level 0 (a degraded server keeps its rung until the monitor
        promotes it back). Returns whether anything changed."""
        if self.level != 0:
            return False
        table = self._resolve(table)
        if table.describe() == self.xp.policies.describe() and not self.excl:
            return False
        self._swap(table, ())
        self.ladder = degradation_ladder(table)
        return True

    def set_faults(self, fault_spec=None, validate_fetch: bool = False) -> None:
        """Decode under another fault environment: the installed rung's
        variant for it (captured when warmed), with a cold predictive
        state."""
        self.variants.set_faults(fault_spec, validate_fetch)
        self._swap(self.xp.policies, self.excl)

    def _ladder_variants(self, table: Optional[PolicyTable] = None, exclusions=None) -> list:
        """The (table, exclusion set) of every rung of ``table``'s ladder
        (default: the installed one's), the ``"reshard"`` rung's included:
        an exclusion rung once per set of ``exclusions`` (default: each
        single subgroup position)."""
        ladder = self.ladder if table is None else degradation_ladder(table)
        if exclusions is None:
            g = self.model.geom.moe_placement.subgroup_size if self.model.geom.moe_placement else 1
            exclusions = [(q,) for q in range(g)]
        out = []
        for _, t, excl in ladder:
            sets = [self._excl(e) for e in exclusions] if excl is None else [excl]
            out += [(t, e) for e in sets]
        return out

    def warmup(self, params, tables=(), ladder: bool = False, exclusions=None) -> int:
        """Capture the decode variant of each table (and of the installed
        one) off the serving path — with ``ladder``, of every rung of their
        ladders too (:meth:`_ladder_variants`, ``exclusions``
        naming the exclusion rung's peer sets); slot and predictive state
        are left as they were (a step never writes its inputs). Returns
        the captures made."""
        tables = [self._resolve(t) for t in tables]
        pairs = [(self.xp.policies, self.excl)] + [(t, ()) for t in tables]
        if ladder:
            pairs += self._ladder_variants(None, exclusions)
            for t in tables:
                pairs += self._ladder_variants(t, exclusions)
        made, seen = 0, set()
        for table, excl in pairs:
            key = variant_key(table, self._shape, excl)
            if key not in seen:
                seen.add(key)
                made += self.variants.get(table, excl)[1].warm(params)
        return made

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def restore_plan(self) -> dict:
        """The active plan stamped into every :meth:`snapshot_slot` payload
        and checked on its re-admission (the JAX package's fields)."""
        return {
            "model": self.model.cfg.name,
            "mesh": tuple(sorted((str(a), int(s)) for a, s in self._mesh_sizes.items())),
            "cache_len": int(self.cache_len),
            "policies": self.xp.policies.describe(),
            "excl": tuple(int(p) for p in self.excl),
        }

    def layout(self) -> RingLayout:
        """Which rows and ring slice each rank's state entry holds."""
        return RingLayout.of_plan(self.xp)

    def admit(self, slot: int, req_id: int, first_token: int, ctx_state: dict) -> None:
        """Install a context-server state, or a :meth:`snapshot_slot`
        payload, into one batch slot, in place: the captured steps read the
        server's state tensors, so they are written and never rebound. The
        source's row 0 is read whole from its own layout (its
        ``"layout"``, which every state carries) and written, ring slot by
        ring slot, into every rank that holds ``slot`` here, each its own
        slice (``models.cache.read_row`` / ``write_row``). A snapshot is validated
        against the active plan before anything is written. The predictive
        state (``state["pred"]``) is per rank and shared by the slots, so it
        is left as it is."""
        if "plan" in ctx_state:
            validate_restore_plan(ctx_state["plan"], self.restore_plan())
        src_layers = ctx_state["layers"]
        if "layout" not in ctx_state:
            raise ValueError("admit needs the state's 'layout' (a RingLayout), as "
                             "forward_prefill and snapshot_slot set it")
        ring = read_row(self.model, src_layers, ctx_state["layout"], 0)
        write_row(self.model, self.state["layers"], self.layout(), slot, ring)
        self.state["pos"][slot] = ctx_state["pos"][0].to(self.state["pos"].device)
        self.cur_token[slot, 0] = first_token
        self.slot_req[slot] = req_id

    def _read(self, out: dict):
        """The step's one host read: (tokens, overflow, overflowed layers,
        pred_stats or None, fault_stats or None)."""
        parts = [out["next_token"][:, 0].double(), out["overflow"].double()[None],
                 out["overflow_layers"].double()[None]]
        sizes = []
        for name in ("pred_stats", "fault_stats"):
            if name in out:
                parts.append(out[name].double().reshape(-1))
                sizes.append(parts[-1].shape[0])
            else:
                sizes.append(0)
        host = torch.cat(parts).cpu().numpy()
        b = self.max_batch
        pred = host[b + 2:b + 2 + sizes[0]].astype(np.float32) if "pred_stats" in out else None
        fault = host[b + 2 + sizes[0]:].astype(np.float64) if "fault_stats" in out else None
        return host[:b].astype(np.int64), bool(host[b]), int(host[b + 1]), pred, fault

    def step_outputs(self, params):
        """One decode step from the server's state, committing nothing:
        ``(outputs, tokens, pred_stats)``; its fault counters land in
        ``last_fault_stats``. A deferred overflow — a budget overflow, a
        mirror divergence or a failed checksum — runs the step again
        eagerly (counted in ``fallbacks``, the checksum ones also in
        ``fault_fallbacks``). The outputs are valid until the server's next
        step."""
        out = self.step(params)
        tokens, overflow, layers, stats, fstats = self._read(out)
        if overflow:
            self.fallbacks += 1
            self.overflow_layers += layers
            self.fault_fallbacks += bool(fstats is not None and fstats[5] > 0)
            ctx = execution.Ctx(model=self.model, xp=self.xp)
            with _eager(self.space):
                out = execution.forward_decode(params, self.cur_token, self.state, ctx)
            tokens, _, _, stats, fstats = self._read(out)
        self.last_fault_stats = fstats
        return out, tokens, stats

    def decode_step(self, params) -> np.ndarray:
        out, tokens, stats = self.step_outputs(params)
        _copy_into(self.state, out["state"])
        self.cur_token.copy_(out["next_token"])
        if stats is not None:
            self.pred_stats.append(stats)
            self.last_pred_stats = stats
        return tokens

    def release(self, slot: int) -> None:
        self.slot_req[slot] = None

    def snapshot_slot(self, slot: int) -> dict:
        """Host copy of one slot's decode state in the context-transfer
        layout (batch dim 1; the whole ring as one entry, ``"layout"``
        ``RingLayout.sequence(1)``), re-admittable through :meth:`admit`
        into any slot of a server with the same :meth:`restore_plan`:
        ``pos``, ``layers``, ``layout``, ``token`` (the slot's pending input
        token, the last one it emitted) and ``plan``. The predictive state is
        per rank, not per slot, and is not captured."""
        ring = read_row(self.model, self.state["layers"], self.layout(), slot)
        layers = {}
        for group in self.model.plan:
            bax = 1 if group.scan else 0
            layers[group.name] = {
                key: [{f: t.unsqueeze(bax).to("cpu", copy=True) for f, t in fields.items()}]
                for key, fields in ring[group.name].items()
            }
        return {
            "pos": self.state["pos"][slot:slot + 1].to("cpu", copy=True),
            "layers": layers,
            "layout": RingLayout.sequence(1),
            "token": int(self.cur_token[slot, 0]),
            "plan": self.restore_plan(),
        }

    def replica(self, slot: int) -> int:
        """The data replica whose ranks hold ``slot``."""
        return slot // self.slot_rows

    def step_shares(self, slots) -> list:
        """Each active slot's share of a decode step's per-rank gathered
        bytes: one over the active slots of its own data replica, whose
        ranks pull the weights for those rows alone."""
        count = collections.Counter(self.replica(s) for s in slots)
        return [1.0 / count[self.replica(s)] for s in slots]

    def routed_bitmaps(self, group: Optional[str] = None) -> Optional[np.ndarray]:
        """The last decode step's routed-expert bitmap of every rank,
        ``(n_ranks, num_experts)`` bool, read from the predictive state's
        ``prev`` (None when the installed plan runs no predictive layer).
        ``group`` picks the layer group (the first predictive one by
        default), whose first predictive layer and first cycle are read;
        under sync-free each rank's own row of its mirror is taken."""
        pred = self.state.get("pred")
        if not pred:
            return None
        if group is None:
            group = next(g.name for g in self.model.plan if g.name in pred)
        gdict = pred[group]
        ranks = gdict[sorted(gdict)[0]][0]
        prev = torch.stack([ps.prev for ps in ranks]).cpu().numpy()
        if prev.ndim == 3:  # mirrored: (n_ranks, G', e_pad) -> each rank's own row
            geom = self.model.geom
            pos = subgroup_positions(self._mesh_sizes, geom.expert_axes, geom.moe_placement)
            prev = prev[np.arange(prev.shape[0]), pos]
        return prev[:, :self.model.cfg.moe.num_experts].astype(bool)


class DisaggregatedEngine:
    """Queues + rate matching between the context and generation servers;
    with a ``scheduler`` (``policy="auto-online"``) it re-resolves the
    generation server's table before each decode step, and with a
    ``health`` monitor it feeds each step's per-peer fault counters to it
    and moves the generation server down or up its degradation ladder
    (fail-silent demotions stop at the all-gather floor); every step's
    fault counters and each move go into ``metrics``
    (``record_fault_stats``, ``record_transition``)."""

    def __init__(self, params, ctx: ContextServer, gen: GenerationServer,
                 scheduler: Optional[OnlinePolicyScheduler] = None,
                 health: Optional[HealthMonitor] = None):
        if ctx.cache_len != gen.cache_len:
            raise ValueError(
                "the context server's KV state does not fit the generation server's ring: "
                f"cache_len {ctx.cache_len} != {gen.cache_len}")
        self.params = params
        self.ctx = ctx
        self.gen = gen
        self.scheduler = scheduler
        self.health = health
        self.decode_steps = 0
        self.queue: list[Request] = []
        self.records: dict[int, RequestRecord] = {}
        self.outputs: dict[int, list[int]] = {}
        self.metrics = ServingMetrics(num_gpus=1)
        self._t0 = time.perf_counter()

    def now(self) -> float:
        """Seconds since the engine started, after the device finished."""
        if self.gen.model.device.type == "cuda":
            torch.cuda.synchronize(self.gen.model.device)
        return time.perf_counter() - self._t0

    def horizon(self) -> float:
        """Seconds from the first request's arrival to now: the span a
        summary's ``tps_per_gpu`` divides by."""
        return self.now() - min(r.arrival for r in self.records.values())

    def warmup(self, tables=(), exclusions=None) -> int:
        """Capture the serving variants off the serving path: the prefill
        step of every bucket and the decode variant of each table in
        ``tables``, of every table the scheduler can emit
        (``OnlinePolicyScheduler.candidate_tables``) and of the installed
        one; with a health monitor also every rung of their
        degradation ladders, the exclusion rung once per peer set of
        ``exclusions`` (default: each single subgroup position;
        ``GenerationServer._ladder_variants``). After this, serving — mixed
        bucket lengths, the scheduler's moves, the monitor's demotions and
        promotions and ``gen.set_policy`` to a warmed table included —
        captures nothing (``variants.captures()`` stays flat on both
        servers). Returns the decode variants captured."""
        self.ctx.warmup(self.params)
        if self.scheduler is not None:
            tables = (*tables, *self.scheduler.candidate_tables(self.gen))
        made = self.gen.warmup(self.params, tables, ladder=self.health is not None,
                               exclusions=exclusions)
        self.now()
        return made

    def _observe_health(self) -> None:
        """Feed the step's fault counters to the metrics and the monitor,
        and move the ladder as it asks."""
        fs = self.gen.last_fault_stats
        if fs is not None:
            self.metrics.record_fault_stats(fs)
        if self.health is None:
            return
        if fs is not None:
            tail = fs[FAULT_STAT_BASE:]
        elif self.health.ema.size:
            # the all-gather floor runs no per-peer payload round, so it
            # reports nothing: a clean observation lets the EMAs decay
            tail = np.zeros_like(self.health.ema)
        else:
            return
        move = self.health.observe(tail)
        if move == "demote":
            level = min(self.gen.level + 1, self.gen.max_silent_level)
        elif move == "promote" and self.gen.level > 0:
            level = self.gen.level - 1
        else:
            return
        if self.gen.set_level(level, bad_peers=self.health.bad_peers()):
            self.metrics.record_transition(self.decode_steps, move, self.gen.level,
                                           self.gen.fetch_label)

    def submit(self, req: Request) -> None:
        if len(req.tokens) not in self.ctx.prefill_lens:
            raise ValueError(
                f"Request {req.req_id}: prompt length {len(req.tokens)} matches no "
                f"context-server bucket (prefill_lens={self.ctx.prefill_lens})"
            )
        if len(req.tokens) + req.target_len - 1 > self.gen.cache_len:
            raise ValueError(
                f"Request {req.req_id}: prompt ({len(req.tokens)}) + output "
                f"({req.target_len}) tokens exceed the decode ring capacity "
                f"cache_len={self.gen.cache_len}"
            )
        self.queue.append(req)
        self.records[req.req_id] = RequestRecord(
            req_id=req.req_id, arrival=self.now(),
            prompt_len=len(req.tokens), target_len=req.target_len,
        )
        self.outputs[req.req_id] = []

    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.gen.slot_req)

    def run(self, steps: int) -> ServingMetrics:
        """Each step = one decode iteration; free slots pull queued
        requests through the context server first. Each request is
        attributed its prefill's gathered wire bytes, its share of every
        decode step's (``GenerationServer.step_shares``: over the active
        slots of its data replica) and an equal share of the step's measured
        predictive counters over the step's active slots, as the live
        serving client attributes them."""
        for _ in range(steps):
            for slot in self.gen.free_slots():
                if not self.queue:
                    break
                req = self.queue.pop(0)
                first, state = self.ctx.prefill(self.params, req.tokens)
                rec = self.records[req.req_id]
                rec.first_token_time = self.now()
                rec.tokens_out = 1
                rec.add_gather_share(self.ctx.gather_bytes)
                self.outputs[req.req_id].append(first)
                self.gen.admit(slot, req.req_id, first, state)
                self.gen.slot_remaining[slot] = req.target_len - 1
            if self.scheduler is not None:
                # before the step, at the rows about to decode; the hit rates
                # are the previous step's
                moved = self.scheduler.step(
                    self.gen, sum(r is not None for r in self.gen.slot_req))
                if moved:
                    self.metrics.record_transition(self.decode_steps, moved, self.gen.level,
                                                   self.gen.fetch_label)
            toks = self.gen.decode_step(self.params)
            self.decode_steps += 1
            self._observe_health()
            t = self.now()
            active = [s for s, r in enumerate(self.gen.slot_req) if r is not None]
            share = 1.0 / max(1, len(active))
            shares = dict(zip(active, self.gen.step_shares(active)))
            for slot, rid in enumerate(self.gen.slot_req):
                if rid is None:
                    continue
                rec = self.records[rid]
                rec.add_gather_share(self.gen.gather_bytes, shares[slot])
                if self.gen.last_pred_stats is not None:
                    rec.add_predict_share(self.gen.last_pred_stats, self.gen.expert_bytes, share)
                self.outputs[rid].append(int(toks[slot]))
                rec.tokens_out += 1
                self.gen.slot_remaining[slot] -= 1
                if self.gen.slot_remaining[slot] <= 0:
                    rec.done_time = t
                    self.metrics.records.append(rec)
                    self.gen.release(slot)
        return self.metrics
