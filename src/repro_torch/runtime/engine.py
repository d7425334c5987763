"""Disaggregated serving on the port: context server (prefill + KV
capture), slot-based continuous-batching generation server, and the
engine that moves requests between them.

The port of ``repro.runtime.engine`` (``validate_restore_plan``,
``variant_key``, ``CountingStep``, ``PolicyVariantCache``, ``Request``,
``ContextServer``, ``GenerationServer``, ``DisaggregatedEngine``) for the
``dwdp``, ``dep`` and ``hybrid`` modes, with the all-fetch and the
route-before-gather expert fetches (``expert_fetch`` demand / predictive
/ sync_free, which engage under dwdp only; the generation server carries
the predictive state across decode steps and keeps each step's
``pred_stats``), and the slot snapshots the serving layer's
evict-to-queue takes (``GenerationServer.snapshot_slot``). The
reference's default serving configuration, a DWDP context server feeding
a DEP generation server, hands the prefill's KV state over unchanged: both
servers keep the ring sequence-sharded at one ``cache_len``. A DEP context
server is refused: DEP's tensor-parallel prefill attention captures no KV
state, in the JAX package as here.

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
run eagerly. The health monitor, the degradation ladder and the online
scheduler come later. Times are seconds on the host clock, read after
the device has finished (``torch.cuda.synchronize``).
"""
from __future__ import annotations

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
from repro_torch.core import execution
from repro_torch.core.strategy import (
    PolicyTable,
    make_execution_plan,
    plan_activation_sharding,
)
from repro_torch.models.cache import init_decode_state
from repro_torch.models.transformer import Model
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
    package's key. Model, mesh and mode are fixed per cache."""
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
        """Capture the step off the serving path (one eager call without a
        space, its outputs dropped); returns the number of captures made."""
        if self.space is None:
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


class PolicyVariantCache:
    """Forward-variant cache of one server: :func:`variant_key` -> ``(plan,
    CountingStep)``, built on a miss by ``build(plan)`` and kept LRU up to
    ``max_entries``; an eviction frees the variant's graph. ``stats``
    counts hits, misses and evictions; ``captures()`` counts every capture
    of a step the cache built, evicted ones included, and stays flat after
    warmup iff serving never captures."""

    def __init__(self, model: Model, mesh_sizes: dict, shape: InputShape,
                 build: Callable, *, mode: str = "dwdp", capacity_from: str = "local",
                 max_entries: int = 16):
        self.model = model
        self._mesh_sizes = mesh_sizes
        self.shape = shape
        self._build = build
        self._mode = mode
        self._capacity_from = capacity_from
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

    def _key(self, table: PolicyTable, excl: tuple, shape: Optional[InputShape]) -> tuple:
        """The entry key: the cache's mode, then :func:`variant_key`."""
        return (self._mode, *variant_key(table, shape if shape is not None else self.shape, excl))

    def get(self, table: PolicyTable, excl: tuple = (), shape: Optional[InputShape] = None):
        """The (plan, step) variant of a policy table, built on a miss.
        ``shape`` overrides the home shape bucket (the context server's
        prefill lengths key in through here)."""
        if excl:
            raise NotImplementedError(
                "peer exclusion (the degradation ladder's rungs) is not ported yet")
        key = self._key(table, excl, shape)
        if key in self._entries:
            self.stats["hits"] += 1
            self._entries[key] = self._entries.pop(key)  # refresh the LRU position
            return self._entries[key]
        self.stats["misses"] += 1
        xp = make_execution_plan(self.model, shape if shape is not None else self.shape,
                                 self._mesh_sizes, mode=self._mode, policy=table,
                                 capacity_from=self._capacity_from)
        entry = (xp, self._build(xp))
        entry[1].on_capture = self._captured
        while len(self._entries) >= self.max_entries:
            self._entries.pop(next(iter(self._entries)))[1].release()
            self.stats["evictions"] += 1
        self._entries[key] = entry
        return entry

    def adopt(self, table: PolicyTable, excl: tuple, entry,
              shape: Optional[InputShape] = None) -> None:
        """Seed the cache with an already-built variant without a miss."""
        self._entries.setdefault(self._key(table, excl, shape), entry)


# --------------------------------------------------------------------------
# Servers.
# --------------------------------------------------------------------------
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


class ContextServer:
    """Prefill worker: returns (first_token, captured decode state).
    ``ContextServer`` prefills one request at a time (global batch 1), so
    the model axis shards the prompt's sequence.

    Prompt lengths are served from pow2 buckets: ``prefill_len`` is the
    home bucket and ``prefill_buckets`` adds lengths, each a power of two;
    each length is one variant of the prefill step, and :meth:`warmup`
    captures every one. ``gather_bytes`` is the installed bucket's static
    wire-byte model (``execution.gathered_wire_bytes_per_step``), the one
    the serving metrics attribute per request. ``fallbacks`` counts
    prefills run again eagerly after a deferred overflow,
    ``overflow_layers`` the route-before-gather layers that overflowed in
    them."""

    def __init__(self, model: Model, mesh_sizes: dict, *, mode: str = "dwdp",
                 prefill_len: int, cache_len: int,
                 capacity_from: str = "local", expert_fetch: str = "all",
                 demand_budget: int = 0, cache_budget: int = 0,
                 prefill_buckets: tuple = (), space: Optional[GraphSpace] = None):
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
        self._table = PolicyTable.uniform(fetch=expert_fetch, budget=demand_budget,
                                          cache_budget=cache_budget)
        shape = InputShape("ctx", prefill_len, 1, "prefill")
        if not execution.captures_kv(model.geom, make_execution_plan(
                model, shape, mesh_sizes, mode=mode, policy=self._table)):
            raise ValueError(
                f"ContextServer(mode={mode!r}): DEP's tensor-parallel prefill attention "
                "captures no KV state (nor does the JAX package's: its DEP context server "
                "fails at the first prefill), so there is no decode state to hand over; "
                "serve the context phase with mode 'dwdp' (the default) or 'hybrid'")
        self.variants = PolicyVariantCache(
            model, mesh_sizes, shape, self._build,
            mode=mode, capacity_from=capacity_from,
            max_entries=max(16, len(self.prefill_lens)),
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

    Evict-to-queue: :meth:`snapshot_slot` copies one slot's decode state to
    the host in the context-transfer layout, stamped with
    :meth:`restore_plan`; :meth:`admit` takes such a snapshot back into any
    slot, in place, after :func:`validate_restore_plan`."""

    def __init__(self, model: Model, mesh_sizes: dict, *, mode: str = "dwdp",
                 max_batch: int, cache_len: int,
                 capacity_from: str = "local", expert_fetch: str = "all",
                 demand_budget: int = 0, cache_budget: int = 0,
                 variant_cache_size: int = 16, space: Optional[GraphSpace] = None):
        self.model = model
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.space = space
        self._mesh_sizes = dict(mesh_sizes)
        self._shape = InputShape("gen", cache_len, max_batch, "decode")
        self.variants = PolicyVariantCache(
            model, mesh_sizes, self._shape, self._build, mode=mode,
            capacity_from=capacity_from, max_entries=variant_cache_size,
        )
        _, seq_axes = plan_activation_sharding(model.cfg, self._shape, mesh_sizes)
        seq_shards = math.prod(mesh_sizes[a] for a in seq_axes)
        self._kv = init_decode_state(model, max_batch, cache_len, seq_shards=seq_shards)
        self.cur_token = torch.zeros((max_batch, 1), dtype=torch.int64, device=model.device)
        self.pred_stats: list[np.ndarray] = []
        self.last_pred_stats: Optional[np.ndarray] = None
        cfg = model.cfg
        self.expert_bytes = (3 * cfg.d_model * cfg.moe.d_ff * model.dtype.itemsize
                             if cfg.moe is not None else 0)
        self.fallbacks = self.overflow_layers = 0
        self.slot_req: list[Optional[int]] = [None] * max_batch
        self.slot_remaining = np.zeros(max_batch, np.int64)
        self._swap(PolicyTable.uniform(fetch=expert_fetch, budget=demand_budget,
                                       cache_budget=cache_budget))

    def _build(self, xp) -> CountingStep:
        state = {"pos": self._kv["pos"], "layers": self._kv["layers"]}
        pred = execution.init_predict_state(self.model, xp)
        if pred:
            state["pred"] = pred

        def fn(params, inputs):
            ctx = execution.Ctx(model=self.model, xp=xp, deferred=True)
            return execution.forward_decode(params, inputs["token"], inputs["state"], ctx)

        return CountingStep(fn, {"token": self.cur_token, "state": state}, self.space)

    def _swap(self, table: PolicyTable) -> None:
        """Install the table's variant with a cold predictive state: its own
        buffers zeroed in place (the predictor and the residency cache do
        not survive a policy change; their budgets differ)."""
        self.xp, self.step = self.variants.get(table)
        self.gather_bytes = execution.gathered_wire_bytes_per_step(self.model, self.xp)
        self.state = self.step.inputs["state"]
        for t in _leaves(self.state.get("pred")):
            t.zero_()
        self.last_pred_stats = None

    def set_policy(self, table: PolicyTable) -> bool:
        """Online policy switch: move the decode step to another policy
        table's variant — captured already when warmed, built and captured
        on first use otherwise — with a cold predictive state; KV slots
        carry over. Returns whether anything changed. (The degradation
        ladder, whose level 0 the JAX package rebases here, is not ported
        yet, so there is no ladder to rebase.)"""
        if table.describe() == self.xp.policies.describe():
            return False
        self._swap(table)
        return True

    def warmup(self, params, tables=()) -> int:
        """Capture the decode variant of each table (and of the installed
        one) off the serving path; slot and predictive state are left as
        they were (a step never writes its inputs). Returns the captures
        made."""
        made, seen = 0, set()
        for table in (self.xp.policies, *tables):
            key = variant_key(table, self._shape)
            if key not in seen:
                seen.add(key)
                made += self.variants.get(table)[1].warm(params)
        return made

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def restore_plan(self) -> dict:
        """The active plan stamped into every :meth:`snapshot_slot` payload
        and checked on its re-admission (the JAX package's fields; the port
        has no peer exclusion, so ``excl`` is empty)."""
        return {
            "model": self.model.cfg.name,
            "mesh": tuple(sorted((str(a), int(s)) for a, s in self._mesh_sizes.items())),
            "cache_len": int(self.cache_len),
            "policies": self.xp.policies.describe(),
            "excl": (),
        }

    def admit(self, slot: int, req_id: int, first_token: int, ctx_state: dict) -> None:
        """Install a context-server state, or a :meth:`snapshot_slot`
        payload, into one batch slot, in place: the captured steps read the
        server's state tensors, so they are written and never rebound. A
        snapshot is validated against the active plan before anything is
        written. The predictive state (``state["pred"]``) is per rank and
        shared by the slots, so it is left as it is. Scan groups carry a
        leading cycle axis, so the batch axis is 1 there."""
        if "plan" in ctx_state:
            validate_restore_plan(ctx_state["plan"], self.restore_plan())
        for group in self.model.plan:
            bax = 1 if group.scan else 0
            for key, ranks in self.state["layers"][group.name].items():
                src_ranks = ctx_state["layers"][group.name][key]
                for dst, src in zip(ranks, src_ranks):
                    for f in dst:
                        idx = (slice(None),) * bax + (slot,)
                        sidx = (slice(None),) * bax + (0,)
                        dst[f][idx] = src[f][sidx].to(dst[f].device, dst[f].dtype)
        self.state["pos"][slot] = ctx_state["pos"][0].to(self.state["pos"].device)
        self.cur_token[slot, 0] = first_token
        self.slot_req[slot] = req_id

    def _read(self, out: dict):
        """The step's one host read: (tokens, overflow, overflowed layers,
        pred_stats or None)."""
        parts = [out["next_token"][:, 0].double(), out["overflow"].double()[None],
                 out["overflow_layers"].double()[None]]
        if "pred_stats" in out:
            parts.append(out["pred_stats"].double())
        host = torch.cat(parts).cpu().numpy()
        b = self.max_batch
        stats = host[b + 2:].astype(np.float32) if "pred_stats" in out else None
        return host[:b].astype(np.int64), bool(host[b]), int(host[b + 1]), stats

    def step_outputs(self, params):
        """One decode step from the server's state, committing nothing:
        ``(outputs, tokens, pred_stats)``. A deferred overflow runs the step
        again eagerly (counted in ``fallbacks``). The outputs are valid
        until the server's next step."""
        out = self.step(params)
        tokens, overflow, layers, stats = self._read(out)
        if overflow:
            self.fallbacks += 1
            self.overflow_layers += layers
            ctx = execution.Ctx(model=self.model, xp=self.xp)
            with _eager(self.space):
                out = execution.forward_decode(params, self.cur_token, self.state, ctx)
            tokens, _, _, stats = self._read(out)
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
        layout (batch dim 1), re-admittable through :meth:`admit` into any
        slot of a server with the same :meth:`restore_plan`: ``pos``,
        ``layers``, ``token`` (the slot's pending input token, the last one
        it emitted) and ``plan``. The predictive state is per rank, not per
        slot, and is not captured."""
        layers = {}
        for group in self.model.plan:
            idx = (slice(None),) * (1 if group.scan else 0) + (slice(slot, slot + 1),)
            layers[group.name] = {
                key: [{f: t[idx].to("cpu", copy=True) for f, t in rank.items()} for rank in ranks]
                for key, ranks in self.state["layers"][group.name].items()
            }
        return {
            "pos": self.state["pos"][slot:slot + 1].to("cpu", copy=True),
            "layers": layers,
            "token": int(self.cur_token[slot, 0]),
            "plan": self.restore_plan(),
        }

    def _subgroup_positions(self) -> np.ndarray:
        """Each flat rank's position within its expert-gather subgroup, in
        rank order (the index the mirrored predictor keeps per peer)."""
        sizes = self._mesh_sizes
        n = math.prod(sizes.values())
        rem, coords = np.arange(n), {}
        for ax in reversed(list(sizes)):
            coords[ax] = rem % sizes[ax]
            rem = rem // sizes[ax]
        idx = np.zeros(n, np.int64)
        for ax in self.model.geom.expert_axes:
            idx = idx * sizes[ax] + coords[ax]
        return idx % self.model.geom.moe_placement.subgroup_size

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
            prev = prev[np.arange(prev.shape[0]), self._subgroup_positions()]
        return prev[:, :self.model.cfg.moe.num_experts].astype(bool)


class DisaggregatedEngine:
    """Queues + rate matching between the context and generation servers."""

    def __init__(self, params, ctx: ContextServer, gen: GenerationServer):
        kv = {name: (srv.cache_len, srv.xp.seq_axes) for name, srv in
              (("context", ctx), ("generation", gen))}
        if kv["context"] != kv["generation"]:
            raise ValueError(
                "the context server's KV state does not fit the generation server's ring "
                f"(cache_len, sequence axes): {kv}")
        self.params = params
        self.ctx = ctx
        self.gen = gen
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

    def warmup(self, tables=()) -> int:
        """Capture the serving variants off the serving path: the prefill
        step of every bucket and the decode variant of each table in
        ``tables`` (and of the installed one). After this, serving — mixed
        bucket lengths and ``gen.set_policy`` to a warmed table included —
        captures nothing (``variants.captures()`` stays flat on both
        servers). Returns the decode variants captured."""
        self.ctx.warmup(self.params)
        made = self.gen.warmup(self.params, tables)
        self.now()
        return made

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
        attributed its prefill's gathered wire bytes and an equal share of
        every decode step's (and of its measured predictive counters) over
        the step's active slots, as the live serving client attributes
        them."""
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
            toks = self.gen.decode_step(self.params)
            t = self.now()
            share = 1.0 / max(1, sum(r is not None for r in self.gen.slot_req))
            for slot, rid in enumerate(self.gen.slot_req):
                if rid is None:
                    continue
                rec = self.records[rid]
                rec.add_gather_share(self.gen.gather_bytes, share)
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
