"""DWDP, DEP and hybrid execution on logical ranks: the port of
``repro.core.execution``.

The JAX package runs one SPMD program per rank inside ``shard_map``. The
port runs the same per-rank program for every logical rank of the
``model`` axis in one process, rank by rank, and implements each
cross-rank operation in process (``core.collectives``):

- an all-gather is a ``torch.cat`` in rank order;
- a psum is a sum in fixed rank order (deterministic), a psum_scatter that
  sum cut into the ranks' slices;
- an all-to-all gives each rank its block of every peer's tensor (device
  copies between the ranks' buffers);
- a remote pull of a split bank copies the peers' shards into the rank's
  landing buffer (``core.prefetch``), on a side CUDA stream, one unit of
  work ahead (:class:`BankPipeline` — the stand-in for the layer-ahead
  prefetch of ``_run_unrolled`` / ``_run_scan_group``), ordered with CUDA
  events.

Modes (``ExecutionPlan.mode``). **dwdp**: weights move, activations do
not: each rank serves its own tokens (its sequence shard in prefill, the
replicated rows in decode) end to end, running the split kernels straight
off its (resident, remote) bank pair. **dep**, the paper's baseline:
activations move and weights stay put. Prefill attention is
tensor-parallel (the tokens all-gathered, the rank's heads, a
psum_scatter back; no KV capture, as in the JAX package), the dense FFN
and the shared expert are tensor-parallel (decode: partial F and a psum),
and the experts stay with their owners: each rank dispatches its tokens,
an all-to-all sends expert block ``j`` to its owner, the owner runs the
grouped FFN over its resident experts and a second all-to-all returns the
results. Decode attention gathers the weights in the merged layout (every
shard into one canonical buffer per rank), or with ``decode_attn=
"qgather"`` keeps them sharded and all-gathers q/k/v instead. **hybrid**:
attention and the dense FFN move as split banks, as in dwdp, the experts
take DEP's all-to-all. Prefill attention runs the flash kernel over the
gathered K/V (causal, or sliding-window on local layers), or over the
whole sequence under DEP's tensor-parallel attention; decode attention is
plain PyTorch, as the JAX package computes it in jnp; DEP's grouped
expert FFN is ``torch.bmm``, as the JAX package computes it in jnp.

Meshes. On a ``(data, model)`` mesh the logical ranks are ``r = d * G +
m``; the weights are sharded over ``model`` (a data replica's ranks hold
the same tensors), so every weight gather, all-to-all and tensor-parallel
collective runs inside the model group of one data index, while the
activations follow the plan's ``batch_axes`` and ``seq_axes`` over both
axes (``ExecutionPlan.batch_index`` / ``seq_index`` / ``group``): a rank
runs its block of rows and its slice of the sequence, the prefill K/V
all-gather, the KV ring and the decode LSE combine span its sequence group
(on ``(2, 4)`` at one row: all eight ranks), and a batch-sharded prefill
(``model`` in ``batch_axes``) runs whole sequences per rank with the
gathered head. A decode batch sharded over ``model`` is refused, as the
JAX package asserts.

Gather policies. Every family lands under its own policy
(``ExecutionPlan.policy(family, group)``, per-layer-group overrides
included, the group passed down with each layer's id): a **split** family
lands a remote-only :class:`prefetch.SplitBank` and runs the split kernels
straight off the (resident, remote) pair; a **merged** family lands every
shard, the resident one included, in one canonical buffer
(``prefetch.gather_shards``, the §4.2 baseline) and runs plain PyTorch
products over it, as the JAX package runs jnp — the experts a
``torch.bmm`` grouped FFN in canonical dispatch order, the dense FFN and
the attention projections one product per shard, k/v de-duplicated; the
attention's ``qkv`` and ``out`` parts may differ (an
:class:`prefetch.AttnBank` of one split and one merged part). Each
family's transport (``allgather``, ``ring``, ``ring_sliced``) sets only
the landing copies' schedule; the banks' content is the same.

Ported under dwdp: split or merged ``attn_qkv`` / ``attn_out`` /
``dense_ffn`` / ``moe_experts`` banks over every transport, prefill with
sequence or batch sharding and KV capture, decode over a sequence-sharded
KV cache with an LSE combine, the vocab-sharded head with a cross-shard
argmax, and the route-before-gather expert fetch (``moe_experts`` fetch
``demand``, ``predictive`` and ``sync_free``): routing runs before the
expert gather, the activated remote rows are fetched by a planned
payload round, and the demand kernel runs over the compact (resident,
fetched) bank; predictive decode adds a layer-ahead speculative round
and a residency cache, sync-free mirrors the predictor on every rank.
Where the JAX package branches on the device (the overflow
``lax.cond``), the port has two modes (``Ctx.deferred``). The eager mode
reads each route-before-gather MoE layer's agreed flag on the host and
takes the full-gather fallback at once. The deferred mode reads nothing:
every layer takes the no-fallback branch, its flag is ORed into one
device flag that ``forward_prefill`` / ``forward_decode`` return
(``overflow``, with ``overflow_layers``), and the caller reads it once
per step and runs the step again in the eager mode when it is set — the
step free of host reads that a CUDA graph captures
(``runtime.engine.CountingStep``). The validated fetch
(``ExecutionPlan.validated``: a ``fault_spec`` to inject, or
``validate_fetch``) checksums every fetched and cached expert row against
the table built once per weight set, repairs bad rows through the
correction round or the full gather (its flag joins the overflow flag)
and reports ``fault_stats``. Not ported yet: the ``replicated`` mode,
rotate execution, training.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import counters
from repro_torch.configs.base import BlockKind
from repro_torch.core import collectives, faults, prefetch
from repro_torch.core.budget import demand_budget_rows, predictive_budget_rows
from repro_torch.core.placement import make_placement
from repro_torch.core.strategy import ExecutionPlan
from repro_torch.kernels import flash_attention as flash_lib
from repro_torch.kernels import split_gemm as split_gemm_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.cache import RingLayout
from repro_torch.models.layers import apply_rope, rms_norm, softcap
from repro_torch.models.transformer import AXIS_MODEL, Geometry, LayerSig, Model

PyTree = Any


@dataclasses.dataclass
class Ctx:
    model: Model
    xp: ExecutionPlan
    capture_len: int = 0       # prefill: also emit a decode state of this len
    impl: Optional[str] = None  # None: the per-device default; "torch": plain versions
    pos: Any = None            # decode: (B,) per-row positions
    q_offsets: tuple = ()      # prefill: global offset of each rank's seq slice
    # speculative-round plans of the current step, by layer (filled on use)
    spec_plans: dict = dataclasses.field(default_factory=dict)
    # True: route-before-gather layers never fall back inside the step;
    # the forward returns the ORed overflow flag for the caller to act on
    deferred: bool = False
    overflow: Any = None        # this forward's ORed overflow flag (0-d bool)
    overflow_layers: Any = None  # and its count of overflowed layers (0-d int32)
    # this forward's fault-stats vector, summed over the validated layers
    # and ranks (``faults.FAULT_STAT_NAMES`` + the per-source tail)
    fault_stats: Any = None
    # when a list: every injection site appends {"site", "rank", "step",
    # "budget", "masks", "valid", "bad"} (to check the counters against the
    # masks)
    fault_log: Optional[list] = None
    _groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def cfg(self):
        return self.model.cfg

    @property
    def geom(self) -> Geometry:
        return self.model.geom

    @property
    def decode(self) -> bool:
        return self.xp.phase == "decode"

    @property
    def dense_impl(self) -> str:
        return self.impl or split_gemm_lib.default_dense_impl(self.xp.phase, self.model.device)

    @property
    def moe_impl(self) -> str:
        return self.impl or "kernel"

    @property
    def attn_impl(self) -> str:
        """Prefill attention's impl: an alias of ``dense_impl`` (the flash
        kernel on the card, the plain version on the CPU and in training),
        named for its call site."""
        return self.dense_impl

    def group(self, rank: int, axes: tuple[str, ...]) -> list[int]:
        """The members of ``rank``'s collective over ``axes``, in shard
        order (``ExecutionPlan.group``; cached for the forward)."""
        key = (rank, axes)
        members = self._groups.get(key)
        if members is None:
            members = self._groups[key] = self.xp.group(rank, axes)
        return members

    def groups(self, axes: tuple[str, ...]) -> list[tuple]:
        """Every collective over ``axes``: the distinct groups, each in shard
        order."""
        return list(dict.fromkeys(tuple(self.group(r, axes)) for r in range(self.model.n_ranks)))

    @property
    def model_axes(self) -> tuple[str, ...]:
        return (AXIS_MODEL,) if AXIS_MODEL in self.xp.mesh_sizes else ()

    def model_groups(self) -> list[tuple]:
        """The ranks of each data replica, in model order: the members of
        every weight gather and tensor-parallel collective."""
        return self.groups(self.model_axes)

    def seq_groups(self) -> list[tuple]:
        """The ranks holding the sequence slices of one block of rows, in
        sequence order (the K/V all-gather and the LSE combine)."""
        return self.groups(self.xp.seq_axes)

    def rows(self, rank: int, batch: int) -> slice:
        """``rank``'s block of a ``batch``-row global batch."""
        local = batch // self.xp.batch_shards
        j = self.xp.batch_index(rank)
        return slice(j * local, (j + 1) * local)

    def rank_pos(self, rank: int):
        """Decode: the positions of ``rank``'s rows."""
        return self.pos[self.rows(rank, self.pos.shape[0])]

    def begin(self, device) -> None:
        """Reset the step's overflow flag and count (start of a forward)."""
        self.spec_plans = {}
        self.fault_stats = None
        self.overflow = torch.zeros((), dtype=torch.bool, device=device)
        self.overflow_layers = torch.zeros((), dtype=torch.int32, device=device)

    def overflowed(self, flag: torch.Tensor) -> bool:
        """Record one route-before-gather layer's agreed overflow flag (0-d
        bool) and say whether the layer takes the full-gather fallback now:
        in the deferred mode never (the flag joins ``overflow``, read by
        the caller once per step), in the eager mode after one host read."""
        self.overflow = self.overflow | flag
        self.overflow_layers = self.overflow_layers + flag.to(torch.int32)
        DEMAND.layers += 1
        if self.deferred:
            return False
        fallback = bool(flag)
        DEMAND.fallbacks += fallback
        return fallback


# ==========================================================================
# Gather set + gather.
# ==========================================================================
def _axes_size(xp: ExecutionPlan, axes: tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        size *= xp.mesh_sizes.get(a, 1)
    return size


def _require_single_axis(geom: Geometry, xp: ExecutionPlan, axes, what: str) -> None:
    """The port gathers only over the model axis (split banks, or DEP's
    merged landing)."""
    if len(axes) != 1 or _axes_size(xp, axes) <= 1:
        raise NotImplementedError(
            f"{what} gathered over {axes}: only single-axis gathers are ported"
        )


class DemandCounters:
    """Route-before-gather layer runs and how many took the full-gather
    fallback at once (overflow or mirror divergence; the eager mode — a
    deferred step returns its flag instead); plain integers a caller may
    read and reset. A replayed CUDA graph adds the layer runs its capture
    counted (``runtime.engine.CountingStep``)."""

    def __init__(self):
        self.layers = 0
        self.fallbacks = 0


DEMAND = DemandCounters()
counters.register("demand", DEMAND, ("layers", "fallbacks"))


# ==========================================================================
# Layout predicates, route-before-gather gates and budgets
# (``execution.py:151-400`` of the JAX package). ``group`` scopes the
# per-layer-group policy overrides.
# ==========================================================================
def _routed_tokens(xp: ExecutionPlan) -> int:
    """Per-rank routed token count."""
    if xp.phase == "decode":
        return max(1, xp.local_batch)
    return max(1, xp.local_batch) * max(1, xp.local_seq)


def _dep_tp_ok(geom: Geometry, xp: ExecutionPlan, what: str) -> bool:
    """Does DEP run this weight family tensor-parallel instead of gathering
    it? The dense FFN over the model axis always; attention where the
    heads divide the axis, outside decode."""
    if what == "ffn":
        return geom.ffn_axes == (AXIS_MODEL,)
    if what == "attn":
        return geom.attn_tp_ok and xp.phase != "decode" and geom.model_size > 1
    return False


def _qgather_ok(geom: Geometry, xp: ExecutionPlan) -> bool:
    """Does decode attention keep its weights sharded and all-gather q/k/v
    instead (``decode_attn="qgather"``; tokens replicated over the axis)?"""
    return (
        xp.phase == "decode"
        and xp.decode_attn == "qgather"
        and geom.attn_axes == (AXIS_MODEL,)
        and AXIS_MODEL not in xp.batch_axes
        and geom.model_size > 1
    )


def dense_split_active(xp: ExecutionPlan, axes, family: str, group: Optional[str] = None) -> bool:
    """Does a gathered dense family (``attn_qkv`` / ``attn_out`` /
    ``dense_ffn``) land as a split bank? Where its policy says so, in the
    modes where weights move (dwdp, hybrid); DEP's gathers keep the merged
    landing."""
    return (
        xp.policy(family, group).layout == "split"
        and xp.mode in ("dwdp", "hybrid")
        and len(axes) == 1
        and _axes_size(xp, axes) > 1
    )


def _attn_tp_active(geom: Geometry, xp: ExecutionPlan) -> bool:
    """Does attention run DEP's tensor-parallel path (prefill)?"""
    return (xp.mode == "dep" and bool(geom.attn_axes) and not _qgather_ok(geom, xp)
            and _dep_tp_ok(geom, xp, "attn"))


def _ffn_tp_active(geom: Geometry, xp: ExecutionPlan) -> bool:
    """Do the dense FFN and the shared expert run DEP's tensor-parallel
    path?"""
    return xp.mode == "dep" and _dep_tp_ok(geom, xp, "ffn")


def captures_kv(geom: Geometry, xp: ExecutionPlan) -> bool:
    """Can a prefill under ``xp`` capture a decode state? Not where DEP runs
    attention tensor-parallel: the JAX package's ``_attn_tp`` returns no
    layer state (its DEP context server fails at the first prefill), and
    the port builds no capture the reference lacks."""
    return not _attn_tp_active(geom, xp)


def _experts_all_to_all(geom: Geometry, xp: ExecutionPlan) -> bool:
    """Do the experts stay with their owners behind DEP's all-to-all (dep
    and hybrid over a sharded placement)?"""
    pl = geom.moe_placement
    return xp.mode in ("dep", "hybrid") and pl is not None and pl.group_size > 1


def moe_split_active(geom: Geometry, xp: ExecutionPlan, group: Optional[str] = None) -> bool:
    """Does the DWDP expert gather land a split bank (else merged)?"""
    pl = geom.moe_placement
    return (
        xp.policy("moe_experts", group).layout == "split"
        and xp.mode == "dwdp"
        and geom.moe_exec == "gather"
        and pl is not None
        and pl.subgroup_size > 1
    )


def demand_fetch_active(cfg, geom: Geometry, xp: ExecutionPlan,
                        group: Optional[str] = None) -> bool:
    """Does the MoE layer run the route-before-gather path (``fetch`` in
    demand / predictive / sync_free)? Only over a single-axis split
    placement, and only at partial coverage — ``rows * top_k < remote
    experts`` — where the activated set can be a strict subset of the
    remote bank; elsewhere the all-fetch gather is kept."""
    if xp.policy("moe_experts", group).fetch not in ("demand", "predictive", "sync_free"):
        return False
    if cfg.moe is None or not moe_split_active(geom, xp, group) or len(geom.expert_axes) != 1:
        return False
    pl = geom.moe_placement
    num_remote = (pl.subgroup_size - 1) * pl.local_count
    return _routed_tokens(xp) * cfg.moe.top_k < num_remote


def predictive_fetch_active(cfg, geom: Geometry, xp: ExecutionPlan,
                            group: Optional[str] = None) -> bool:
    """Does the demand path also run the predictive engine (speculative
    round + residency cache + correction round)? Decode only: the
    ``PredictState`` lives in the decode state. Elsewhere ``predictive``
    and ``sync_free`` run exactly as ``demand``."""
    return (
        xp.phase == "decode"
        and xp.policy("moe_experts", group).fetch in ("predictive", "sync_free")
        and demand_fetch_active(cfg, geom, xp, group)
    )


def sync_free_active(cfg, geom: Geometry, xp: ExecutionPlan, group: Optional[str] = None) -> bool:
    """Does the predictive decode run the sync-free variant (mirrored
    predictor, no index exchange in the speculative round)?"""
    return (
        xp.policy("moe_experts", group).fetch == "sync_free"
        and predictive_fetch_active(cfg, geom, xp, group)
    )


def resolve_demand_budget(cfg, geom: Geometry, xp: ExecutionPlan,
                          group: Optional[str] = None) -> int:
    """Per-peer row budget of the demand round — of the correction round
    where the predictive engine runs. A policy ``budget`` > 0 is honoured
    (clamped to the per-rank expert count); auto (0) applies the closed
    forms of ``core.budget``. Overflow falls back to the full gather, so
    the budget tunes bytes, never results."""
    pl = geom.moe_placement
    local = pl.local_count
    user = xp.policy("moe_experts", group).budget
    if user > 0:
        return min(user, local)
    draws = _routed_tokens(xp) * cfg.moe.top_k
    if predictive_fetch_active(cfg, geom, xp, group):
        return predictive_budget_rows(draws, cfg.moe.num_experts, local)[1]
    return demand_budget_rows(draws, cfg.moe.num_experts, local)


def resolve_spec_budget(cfg, geom: Geometry, xp: ExecutionPlan,
                        group: Optional[str] = None) -> int:
    """Per-peer row budget of the speculative round: the policy
    ``budget`` if set, else the speculative half of
    ``predictive_budget_rows``. The predictor never asks for more, so
    this round cannot overflow."""
    pl = geom.moe_placement
    local = pl.local_count
    user = xp.policy("moe_experts", group).budget
    if user > 0:
        return min(user, local)
    return predictive_budget_rows(
        _routed_tokens(xp) * cfg.moe.top_k, cfg.moe.num_experts, local
    )[0]


def resolve_cache_rows(cfg, geom: Geometry, xp: ExecutionPlan,
                       group: Optional[str] = None) -> int:
    """Rows of the per-layer residency cache: the policy's
    ``cache_budget``, capped at the remote bank. 0 = cache off."""
    pl = geom.moe_placement
    remote = (pl.subgroup_size - 1) * pl.local_count
    return min(xp.policy("moe_experts", group).cache_budget, remote)


# ==========================================================================
# The validated fetch (``execution.py:340-407`` of the JAX package).
# ==========================================================================
def fault_stats_active(model: Model, xp: ExecutionPlan) -> bool:
    """Does this plan's decode step return ``out["fault_stats"]``? Where the
    fetch is validated (``xp.validated``) and some MoE layer runs the
    route-before-gather path; and wherever a layer runs sync-free, whose
    schedule digest always runs, so its ``mirror_divergence`` counter
    reaches the ``HealthMonitor`` unvalidated too (the other counters are
    zero then). The vector: :data:`faults.FAULT_STAT_NAMES`, then the
    detected rows by source subgroup position, summed over layers and
    ranks."""
    cfg, geom = model.cfg, model.geom
    if cfg.moe is None:
        return False
    moe_groups = [g.name for g in model.plan if any(sig.is_moe for sig in g.sigs)]
    if any(sync_free_active(cfg, geom, xp, g) for g in moe_groups):
        return True
    return xp.validated and any(demand_fetch_active(cfg, geom, xp, g) for g in moe_groups)


def _fault_injector(ctx: Ctx) -> Optional[faults.FaultInjector]:
    if ctx.xp.fault_spec is None:
        return None
    return faults.FaultInjector(ctx.xp.fault_spec, ctx.geom.moe_placement, ctx.xp.mesh_sizes)


def _fault_step(ctx: Ctx, rank: int):
    """The decode step that keys ``rank``'s fault draws, read on the device:
    the maximum of its rows' positions (0 outside decode). A replayed graph
    draws its step's masks; no host read."""
    if ctx.pos is None:
        return torch.zeros((), dtype=torch.int64, device=ctx.model.device)
    return ctx.rank_pos(rank).max()


def _injected_counts(inj: faults.FaultInjector, key, budget: int, valid, position: int,
                     log=None, **where):
    """The counting site's recomputation of one payload round's injected
    rows ``[drop, zero, corrupt]``: the tamper site's masks from the same
    key, counted where the plan marked the row valid (tampering padding
    consumes nothing). With a ``log`` (``Ctx.fault_log``) the masks go there
    beside ``where`` (site, rank, step)."""
    masks = inj.payload_masks(key, budget, position)
    if log is not None:
        log.append(dict(where, budget=budget, masks=masks, valid=valid))
    return torch.stack([(m & valid).sum() for m in masks]).float()


def _per_src_detected(bad: torch.Tensor, budget: int, g: int, p: int) -> torch.Tensor:
    """Each detected payload row by the subgroup position that served it
    (rows are peer-major: chunk ``t`` from position ``(p + 1 + t) % g``)."""
    out = torch.zeros(g, dtype=torch.float32, device=bad.device)
    if bad.shape[0] == 0:
        return out
    src = (p + 1 + torch.arange(bad.shape[0], device=bad.device) // budget) % g
    return out.index_add_(0, src, bad.float())


def _checksum_table(mp: dict) -> torch.Tensor:
    table = mp.get("checksums")
    if table is None:
        raise ValueError(
            "the validated fetch reads the experts' checksum table, which this weight set "
            "lacks: attach it once with prefetch.attach_checksum_tables(params, model)")
    return table


def _add_fault_stats(ctx: Ctx, vec: torch.Tensor) -> None:
    ctx.fault_stats = vec if ctx.fault_stats is None else ctx.fault_stats + vec


def gather_set(sig: LayerSig, geom: Geometry, xp: ExecutionPlan, cfg,
               group: Optional[str] = None) -> tuple[str, ...]:
    """Keys of a layer's param tree that the prefetch pipeline gathers
    (``execution.gather_set`` of the JAX package), by mode. Where weights
    move (dwdp, hybrid) attention and the dense FFN are gathered as split
    banks; DEP gathers attention (merged) only where it cannot run it
    tensor-parallel — in decode, unless ``decode_attn="qgather"`` — and
    never the dense FFN. The expert bank is gathered under dwdp only; a
    demand-active MoE layer leaves it out — it is fetched inside the
    layer, after routing — unless the predictive engine runs, whose
    speculative round rides the pipeline. ``group`` is the layer's
    group."""
    out: list[str] = []
    if sig.kind not in (BlockKind.GLOBAL_ATTN, BlockKind.LOCAL_ATTN):
        raise NotImplementedError(f"block kind {sig.kind} is not ported yet")
    weights_move = xp.mode in ("dwdp", "hybrid")
    if geom.attn_axes and not _qgather_ok(geom, xp):
        if weights_move or not _dep_tp_ok(geom, xp, "attn"):
            _require_single_axis(geom, xp, geom.attn_axes, "attention")
            out.append("attn")
    if sig.is_moe:
        pl = geom.moe_placement
        assert pl is not None
        if pl.subgroup_size > 1 and xp.mode == "dwdp":
            if geom.moe_exec != "gather":
                raise NotImplementedError(f"moe_exec={geom.moe_exec!r} is not ported yet")
            _require_single_axis(geom, xp, geom.expert_axes, "experts")
            if not (
                demand_fetch_active(cfg, geom, xp, group)
                and not predictive_fetch_active(cfg, geom, xp, group)
            ):
                out.append("moe/experts")
        if sig.shared_d_ff and geom.ffn_axes:
            if weights_move or not _dep_tp_ok(geom, xp, "ffn"):
                _require_single_axis(geom, xp, geom.ffn_axes, "shared expert")
                out.append("moe/shared")
    elif sig.ffn_dim and geom.ffn_axes:
        if weights_move or not _dep_tp_ok(geom, xp, "ffn"):
            _require_single_axis(geom, xp, geom.ffn_axes, "dense FFN")
            out.append("ffn")
    return tuple(out)


def gathered_wire_bytes_per_step(model: Model, xp: ExecutionPlan) -> dict:
    """Static per-rank gathered-weight wire bytes of one forward step under
    ``xp`` (``execution.gathered_wire_bytes_per_step`` of the JAX package):
    ``{"full", "fetched", "families": {family: {"full", "fetched"}}[,
    "rounds"]}``.

    ``fetched`` is what the plan ships (a route-before-gather expert layer
    pays its budget-padded payload and index round); ``full`` is the same
    step under the all-fetch expert policy, the counterfactual the serving
    metrics report against. ``families`` splits both into ``moe_experts``,
    ``attn_qkv``, ``attn_out`` and ``dense_ffn``. Route-before-gather plans
    add ``rounds``: the layer-ahead speculative round (``spec``), the
    post-routing round (``corr``; plain demand's one round counts here),
    and under sync-free the per-step mirror all-gather (``mirror``, once
    per step). Each layer counts under its group's policies; the bytes do
    not depend on the layout or the transport (``prefetch.gather_bytes``).
    A model, not a measurement: the landing copies' bytes are
    ``prefetch.LANDED`` (the merged layout's also count its resident-shard
    copies, ``LANDED.merge_bytes``)."""
    cfg, geom = model.cfg, model.geom
    ws = model.dtype.itemsize
    d = cfg.d_model
    fams = {f: {"full": 0.0, "fetched": 0.0}
            for f in ("moe_experts", "attn_qkv", "attn_out", "dense_ffn")}
    rounds = {"spec": 0.0, "corr": 0.0}
    any_rounds = any_sync = False

    def add(fam: str, n_cycles: int, full_b: float, fetched_b=None) -> None:
        fams[fam]["full"] += full_b * n_cycles
        fams[fam]["fetched"] += (full_b if fetched_b is None else fetched_b) * n_cycles

    for group in model.plan:
        gname = group.name
        demand = cfg.moe is not None and demand_fetch_active(cfg, geom, xp, gname)
        predictive = demand and predictive_fetch_active(cfg, geom, xp, gname)
        for sig in group.sigs:
            for key in gather_set(sig, geom, xp, cfg, gname):
                if key == "moe/experts":
                    pl = geom.moe_placement
                    pe = 3 * d * cfg.moe.d_ff * ws
                    full_b = prefetch.gather_bytes(pl, pe)
                    if predictive:
                        # the speculative round (layer-ahead) and the
                        # correction round replace the full gather
                        spec_b = resolve_spec_budget(cfg, geom, xp, gname)
                        corr_b = resolve_demand_budget(cfg, geom, xp, gname)
                        if sync_free_active(cfg, geom, xp, gname):
                            any_sync = True
                            by_round = prefetch.sync_free_fetch_bytes(
                                pl, spec_b, corr_b, _routed_tokens(xp), pe,
                                validate=xp.validated)
                        else:
                            by_round = {
                                "spec": prefetch.demand_fetch_bytes(pl, spec_b, pe,
                                                                    validate=xp.validated),
                                "corr": prefetch.demand_fetch_bytes(pl, corr_b, pe,
                                                                    validate=xp.validated)}
                        any_rounds = True
                        for rnd in ("spec", "corr"):
                            rounds[rnd] += by_round[rnd] * group.n_cycles
                        add("moe_experts", group.n_cycles, full_b,
                            min(full_b, by_round["spec"] + by_round["corr"]))
                    else:
                        add("moe_experts", group.n_cycles, full_b)
                elif key == "attn":
                    a = _axes_size(xp, geom.attn_axes)
                    qkv = d * (cfg.q_dim + 2 * cfg.kv_dim) * ws
                    out = cfg.q_dim * d * ws
                    add("attn_qkv", group.n_cycles, qkv * (a - 1) / max(1, a))
                    add("attn_out", group.n_cycles, out * (a - 1) / max(1, a))
                elif key in ("ffn", "moe/shared"):
                    s = _axes_size(xp, geom.ffn_axes)
                    f = sig.shared_d_ff if key == "moe/shared" else sig.ffn_dim
                    add("dense_ffn", group.n_cycles, 3 * d * (f or 0) * ws * (s - 1) / max(1, s))
            if sig.is_moe and demand and not predictive:
                # route-before-gather: gather_set left the expert bank out,
                # the layer fetches its activated remote rows after routing
                pl = geom.moe_placement
                pe = 3 * d * cfg.moe.d_ff * ws
                fetched = prefetch.demand_fetch_bytes(
                    pl, resolve_demand_budget(cfg, geom, xp, gname), pe, validate=xp.validated)
                any_rounds = True
                rounds["corr"] += fetched * group.n_cycles
                add("moe_experts", group.n_cycles, prefetch.gather_bytes(pl, pe), fetched)
    if any_sync:
        mb = float(prefetch.sync_free_mirror_bytes(geom.moe_placement, _routed_tokens(xp)))
        rounds["mirror"] = mb
        fams["moe_experts"]["fetched"] += mb
    out = {
        "full": sum(v["full"] for v in fams.values()),
        "fetched": sum(v["fetched"] for v in fams.values()),
        "families": fams,
    }
    if any_rounds:
        out["rounds"] = rounds
    return out


def _leading_placement(shards: int):
    """One slice per rank (subgroup = the whole axis, local_count 1)."""
    return make_placement(shards, shards)


_ATTN_PARTS = (("attn_qkv", ("wq", "wk", "wv")), ("attn_out", ("wo",)))


def _gather_family(shards: list, rank: int, pl, split: bool, pol, copy_stream):
    """One family's bank of ``rank`` under its policy: a SplitBank, or the
    merged landing of every shard."""
    kw = dict(mode=pol.transport, num_slices=pol.num_slices, copy_stream=copy_stream)
    if split:
        return prefetch.gather_split_bank(shards, rank, pl, **kw)
    return prefetch.gather_shards(shards, rank, pl, **kw)


def gather_attn(lps: list[dict], ctx: Ctx, copy_stream=None, group: Optional[str] = None) -> list:
    """Every rank's gathered attention as two policy families
    (``_gather_attn`` of the JAX package), ``attn_qkv`` (wq/wk/wv) and
    ``attn_out`` (wo), each under its own layout and transport in layer
    group ``group``: a plain dict of full weights where both are merged
    (DEP's decode always), else a :class:`prefetch.AttnBank` whose parts
    are each a SplitBank or a merged dict."""
    geom, xp = ctx.geom, ctx.xp
    pl = _leading_placement(geom.attn_shards)
    parts = {}
    for fam, keys in _ATTN_PARTS:
        shards = [{k: lp["attn"][k] for k in keys} for lp in lps]
        split = dense_split_active(xp, geom.attn_axes, fam, group)
        parts[fam] = [_gather_family(shards, r, pl, split, xp.policy(fam, group), copy_stream)
                      for r in range(len(lps))]
    qkv, out = parts["attn_qkv"], parts["attn_out"]
    if not any(isinstance(b, prefetch.SplitBank) for b in (qkv[0], out[0])):
        return [{**q, **o} for q, o in zip(qkv, out)]
    return [prefetch.AttnBank(qkv=q, out=o) for q, o in zip(qkv, out)]


def gather_ffn(keys: tuple[str, ...], lps: list[dict], rank: int, ctx: Ctx,
               copy_stream=None, preds=None, lid=None) -> dict:
    """One rank's FFN-side banks of layer ``lid`` (``(group, cycle,
    position)``): ``ffn`` / ``moe/shared`` (family ``dense_ffn``) and
    ``moe/experts``, each a split bank or a merged landing under its
    family's policy in the layer's group; for a predictive decode layer
    the expert entry is the speculative round's :class:`SpecBank`, driven
    by the layer's incoming ``preds``."""
    geom, xp = ctx.geom, ctx.xp
    group = lid[0] if lid is not None else None
    out = {}
    for key in keys:
        if key == "ffn":
            shards, pl = [lp["ffn"] for lp in lps], _leading_placement(geom.ffn_shards)
        elif key == "moe/shared":
            shards, pl = [lp["moe"]["shared"] for lp in lps], _leading_placement(geom.ffn_shards)
        elif key == "moe/experts":
            shards, pl = [lp["moe"]["experts"] for lp in lps], geom.moe_placement
            if predictive_fetch_active(ctx.cfg, geom, xp, group):
                out[key] = _speculative_expert_gather(shards, rank, ctx, preds, lid, copy_stream)
                continue
        else:
            continue
        if key == "moe/experts":
            fam, split = "moe_experts", moe_split_active(geom, xp, group)
        else:
            fam, split = "dense_ffn", dense_split_active(xp, geom.ffn_axes, "dense_ffn", group)
        out[key] = _gather_family(shards, rank, pl, split, xp.policy(fam, group), copy_stream)
    return out


# ==========================================================================
# The predictive fetch's speculative round (``_mirror_spec_masks`` /
# ``_speculative_expert_gather`` of the JAX package).
# ==========================================================================
class SpecBank(NamedTuple):
    """One rank's speculative round. ``bank``: the speculative rows as a
    :class:`prefetch.DemandBank`. ``landing``: the rank's whole fetched
    bank ``[cache | speculative | correction]`` per leaf — the head holds a
    copy of the residency cache, ``bank.fetched`` views the middle and the
    correction round lands into the tail — so the demand kernel reads one
    bank and no concatenation is copied (the JAX package concatenates)."""

    bank: prefetch.DemandBank
    landing: dict


def _mirror_spec_masks(pred: prefetch.PredictState, pl, sbudget: int, ctx: Ctx,
                       rank: int) -> torch.Tensor:
    """Sync-free: the ``(G', E)`` speculative bitmaps of every subgroup
    position, derived from ``rank``'s mirrored ``PredictState`` alone.
    Deterministic in the mirror, so every rank derives the same schedule
    and the speculative round needs no index exchange. The ``mirror`` fault
    perturbs the drifting rank's view of its own EMA row here, for this
    step only, so that rank derives another schedule for the digest to
    catch."""
    ema = pred.ema
    inj = _fault_injector(ctx)
    if inj is not None and inj.spec.mirror_rate:
        p = rank % pl.subgroup_size
        flag = inj.mirror_flag(_fault_step(ctx, rank), rank)
        bump = (torch.arange(pl.num_padded, device=ema.device) % 3 == 0).float() * 10.0
        ema = ema.clone()
        ema[p] += flag.float() * bump
    extra = prefetch.predict_extra_score(pred.sig, pred.sigw)
    return torch.stack([
        prefetch.predict_bitmap(
            pred.prev[q], ema[q], pl, budget=sbudget,
            exclude_ids=pred.cache_ids[q], exclude_valid=pred.cache_valid[q],
            extra_score=extra[q], exclude_peers=ctx.xp.exclude_peers,
        )
        for q in range(pl.subgroup_size)
    ])


def _spec_plans(ctx: Ctx, lid, preds: list) -> list:
    """Every rank's speculative-round plan of layer ``lid`` this step,
    computed once (by the layer's first pipeline unit or by the layer).
    Plain predictive exchanges each rank's predicted bitmap
    (``plan_demand_fetch``); sync-free derives every position's bitmap
    from the rank's own mirror. The predictor asks for at most the budget
    per peer, so the round never overflows."""
    plans = ctx.spec_plans.get(lid)
    if plans is not None:
        return plans
    if preds is None:
        raise ValueError(
            "predictive fetch needs the layer's PredictState in the decode state: "
            "attach it with execution.attach_predict_state(state, model, xp)"
        )
    cfg, geom, xp = ctx.cfg, ctx.geom, ctx.xp
    pl = geom.moe_placement
    g, local = pl.subgroup_size, pl.local_count
    sbudget = min(resolve_spec_budget(cfg, geom, xp, lid[0]), local)
    if sync_free_active(cfg, geom, xp, lid[0]):
        plans = []
        for r, pred in enumerate(preds):
            masks = _mirror_spec_masks(pred, pl, sbudget, ctx, r)
            ids, valid, _ = prefetch.plan_from_bitmap(masks[r % g], r % g, g, local, sbudget)
            no = torch.zeros((), dtype=torch.bool, device=ids.device)
            plans.append(prefetch.DemandPlan(masks=masks, fetched_ids=ids, valid=valid, overflow=no))
    else:
        wanted = [
            prefetch.predict_bitmap(pred.prev, pred.ema, pl, budget=sbudget,
                                    exclude_ids=pred.cache_ids, exclude_valid=pred.cache_valid,
                                    exclude_peers=xp.exclude_peers)
            for pred in preds
        ]
        plans = prefetch.plan_demand_fetch(wanted, pl, budget=sbudget)
    ctx.spec_plans[lid] = plans
    return plans


def _speculative_expert_gather(shards: list, rank: int, ctx: Ctx, preds: list, lid,
                               copy_stream=None) -> SpecBank:
    """The layer-ahead speculative round of ``rank``: the predicted hot
    set, fetched from the previous step's ``PredictState`` alone (no
    dependence on this step's routing), so it rides the bank pipeline
    under the previous unit's compute. Allocates the rank's whole fetched
    bank and copies the residency cache into its head."""
    cfg, geom, xp = ctx.cfg, ctx.geom, ctx.xp
    pl = geom.moe_placement
    g, local = pl.subgroup_size, pl.local_count
    group = lid[0]
    pol = xp.policy("moe_experts", group)
    sbudget = min(resolve_spec_budget(cfg, geom, xp, group), local)
    cbudget = min(resolve_demand_budget(cfg, geom, xp, group), local)
    plan = _spec_plans(ctx, lid, preds)[rank]
    pred = preds[rank]
    n_cache = pred.cache_ids.shape[-1]
    n_spec = (g - 1) * sbudget
    rows = n_cache + n_spec + (g - 1) * cbudget
    landing = prefetch.tree_map(
        lambda lo: torch.empty((rows,) + tuple(lo.shape[1:]), dtype=lo.dtype, device=lo.device),
        shards[rank],
    )
    inj = _fault_injector(ctx)
    bank = prefetch.gather_demand_payload(
        shards, plan, rank, pl, budget=sbudget, mode=pol.transport,
        num_slices=pol.num_slices, copy_stream=copy_stream,
        out=prefetch.tree_map(lambda b: b[n_cache:n_cache + n_spec], landing),
        injector=inj,
        fault_key=inj.site_key("spec", _fault_step(ctx, rank), rank) if inj is not None else None,
    )
    on_side = torch.cuda.stream(copy_stream) if copy_stream is not None else contextlib.nullcontext()
    with on_side:
        prefetch.tree_map(lambda b, c: b[:n_cache].copy_(c, non_blocking=True), landing, pred.cache)
    return SpecBank(bank=bank, landing=landing)


class BankPipeline:
    """Issues each unit's remote pulls one unit ahead on a side stream.

    ``units`` is the ordered list of ``(key, thunk)`` a forward consumes;
    ``get(key)`` returns the unit's banks, first issuing the next unit so
    its copies overlap this unit's compute. Landing buffers are allocated
    on the consuming (current) stream, so the allocator reuses a dropped
    unit's memory in stream order; the side stream waits for an event
    recorded at allocation time before it writes, and the consumer waits
    for the side stream's event before it reads. At most two units are
    alive: the one in use and the one landing (callers drop a unit
    before asking for the next)."""

    def __init__(self, units: list, device: torch.device):
        self.units = units
        self.index = {key: i for i, (key, _) in enumerate(units)}
        self.device = device
        self.side = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.pending: dict[int, tuple] = {}

    def _issue(self, i: int) -> None:
        if i >= len(self.units) or i in self.pending:
            return
        thunk = self.units[i][1]
        if self.side is None:
            self.pending[i] = (thunk(None), None)
            return
        self.side.wait_stream(torch.cuda.current_stream(self.device))
        banks = thunk(self.side)
        landed = torch.cuda.Event()
        landed.record(self.side)
        self.pending[i] = (banks, landed)

    def get(self, key):
        i = self.index[key]
        self._issue(i)
        banks, landed = self.pending.pop(i)
        self._issue(i + 1)
        if landed is not None:
            torch.cuda.current_stream(self.device).wait_event(landed)
        return banks


# ==========================================================================
# Embedding / head.
# ==========================================================================
def _embed(params: list[dict], tokens: torch.Tensor, model: Model) -> torch.Tensor:
    """Row lookup over the vocab-sharded table (the model ranks' shards):
    each token's row comes from the shard that owns it; the other shards
    add exact zeros (the JAX package's masked lookup + psum, summed in
    rank order)."""
    x = None
    for r, p in enumerate(params[:model.geom.model_size]):
        emb = p["embed"]
        v_l = emb.shape[0]
        idx = tokens - r * v_l
        valid = (idx >= 0) & (idx < v_l)
        part = emb[idx.clamp(0, v_l - 1)].to(model.dtype) * valid[..., None].to(model.dtype)
        x = part if x is None else x + part
    return x


def _head(p: dict, cfg) -> torch.Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


def _rank_logits(h: torch.Tensor, p: dict, m: int, ctx: Ctx) -> torch.Tensor:
    """The logits of vocab shard ``m`` (model rank ``m``'s slice of the
    head), padded vocab columns masked."""
    logits = (h @ _head(p, ctx.cfg)).float()
    logits = softcap(logits, ctx.cfg.logit_softcap)
    n = logits.shape[-1]
    cols = m * n + torch.arange(n, device=logits.device)
    return torch.where(cols < ctx.cfg.vocab_size, logits, torch.full_like(logits, -1e30))


# ==========================================================================
# Attention.
# ==========================================================================
def _project_heads(h, w, heads, head_dim):
    """h: (B,S,D); w: (A, D, dim/A) stacked -> (B,S,heads,head_dim): one
    product per shard, straight off the stacked weights (no copy of w)."""
    b, s, d = h.shape
    out = torch.matmul(h.reshape(1, b * s, d), w.to(h.dtype))  # (A, T, dim/A)
    return out.permute(1, 0, 2).reshape(b, s, heads, head_dim)


def _project_out(out, wo):
    """out: (B,S,...) with the A * g head features in shard order; wo:
    (A, g, D) stacked -> (B,S,D): one product over the flattened shards."""
    b, s = out.shape[:2]
    y = out.reshape(b * s, -1) @ wo.reshape(-1, wo.shape[-1]).to(out.dtype)
    return y.reshape(b, s, -1)


def _attn_split_qkv(h, bank: prefetch.SplitBank, rank: int, ctx: Ctx):
    """q/k/v straight off a SplitBank. The kernel emits slices in rotated
    bank order; the roll back to canonical head order happens on the
    projected activations. KV slices are projected for all A positions
    and de-duplicated afterwards (``execution._attn_split_qkv``)."""
    cfg, geom = ctx.cfg, ctx.geom
    a = geom.attn_shards
    p = rank % a
    b, s, dm = h.shape
    h2d = h.reshape(b * s, dm).contiguous()
    canon = (torch.arange(a, device=h.device) - p) % a

    def stack(name):
        out = split_gemm_lib.split_stack_matmul(
            h2d, bank.local[name], bank.remote[name], impl=ctx.dense_impl
        )  # (A, T, fs) rotated
        return out.movedim(0, 1)[:, canon]  # (T, A, fs) canonical

    hd = cfg.head_dim
    q = stack("wq").reshape(b, s, cfg.num_heads, hd)
    dup = a // geom.kv_shard
    k = stack("wk")[:, ::dup].reshape(b, s, cfg.num_kv_heads, hd)
    v = stack("wv")[:, ::dup].reshape(b, s, cfg.num_kv_heads, hd)
    return q, k, v


def _attn_split_out(out, bank: prefetch.SplitBank, rank: int, ctx: Ctx):
    """Output projection off a SplitBank: roll the head slices into
    rotated bank order (activation side), then the reduce kernel sums the
    per-slice contributions."""
    a = ctx.geom.attn_shards
    p = rank % a
    b, s = out.shape[:2]
    rot = (torch.arange(a, device=out.device) + p) % a
    out = out.reshape(b, s, a, -1)[:, :, rot]
    out = out.reshape(b * s, a, -1).movedim(1, 0).contiguous()  # (A, T, fs)
    y = split_gemm_lib.split_reduce_matmul(
        out, bank.local["wo"], bank.remote["wo"], impl=ctx.dense_impl
    )
    return y.reshape(b, s, -1)


def _capture_kv_state(k, v, sig: LayerSig, ctx: Ctx, rank: int) -> dict:
    """Prefill K/V (already gathered over the sequence shards) -> the
    ring-buffer decode state slice owned by ``rank``
    (``execution._capture_kv_state``)."""
    xp = ctx.xp
    b, s = k.shape[0], k.shape[1]
    length = min(sig.window, ctx.capture_len) if sig.window else ctx.capture_len
    n_sh = xp.seq_shards if xp.seq_axes else 1
    if length % n_sh:
        raise ValueError(
            f"KV capture ring length {length} must divide over the {n_sh} "
            "sequence shards — pick a cache_len divisible by the shard count"
        )
    l_local = length // n_sh
    mine = xp.seq_index(rank)
    l_idx = mine * l_local + torch.arange(l_local, device=k.device)
    pos_l = (s - 1) - ((s - 1 - l_idx) % length)
    valid = pos_l >= 0
    take = pos_l.clamp(0, s - 1)
    vmask = valid[None, :, None, None].to(k.dtype)
    return {
        "k": k[:, take] * vmask,
        "v": v[:, take] * vmask,
        "slot_pos": torch.where(valid, pos_l, torch.full_like(pos_l, -1))[None, :]
        .expand(b, l_local).to(torch.int32).contiguous(),
    }


def _attn_decode_partial(q, k_new, v_new, sig: LayerSig, ctx: Ctx, lstate: dict, rank: int):
    """Write each of the rank's rows' new token into its slice of the ring,
    then attend over the slice: returns ((out, lse), new_state)."""
    xp = ctx.xp
    pos = ctx.rank_pos(rank)
    l_local = lstate["k"].shape[1]
    n_sh = xp.seq_shards if xp.seq_axes else 1
    slot = pos % (l_local * n_sh)
    owner = slot // l_local
    li = slot % l_local
    mine = xp.seq_index(rank)
    onehot = (torch.arange(l_local, device=pos.device)[None, :] == li[:, None]) & (
        owner == mine
    )[:, None]
    ck = torch.where(onehot[:, :, None, None], k_new.to(lstate["k"].dtype), lstate["k"])
    cv = torch.where(onehot[:, :, None, None], v_new.to(lstate["v"].dtype), lstate["v"])
    sp = torch.where(onehot, pos[:, None].to(torch.int32), lstate["slot_pos"])
    partial = attn_lib.mha_decode_partial(
        q[:, 0], ck.to(q.dtype), cv.to(q.dtype), sp, pos, window=sig.window
    )
    return partial, {"k": ck, "v": cv, "slot_pos": sp}


def _combine_over_seq(partials: list, ctx: Ctx) -> list:
    """Each rank's decode attention output: the LSE combine of its sequence
    group's ``(out, lse)`` partials in sequence order, computed once per
    group (a rank's own partial where the ring is not sharded)."""
    outs = [out for out, _ in partials]
    for grp in ctx.seq_groups():
        if len(grp) > 1:
            out = attn_lib.combine_partials([partials[j][0] for j in grp],
                                            [partials[j][1] for j in grp])
            for j in grp:
                outs[j] = out
    return outs


def _merged_qkv(h, aw: dict, ctx: Ctx):
    """q/k/v off full (merged or replicated) weights ``(A, D, dim/A)``, the
    duplicated kv groups dropped (``_dedupe_kv``)."""
    cfg, hd = ctx.cfg, ctx.cfg.head_dim
    dup = max(1, aw["wk"].shape[0] // ctx.geom.kv_shard)
    return (
        _project_heads(h, aw["wq"], cfg.num_heads, hd),
        _project_heads(h, aw["wk"][::dup], cfg.num_kv_heads, hd),
        _project_heads(h, aw["wv"][::dup], cfg.num_kv_heads, hd),
    )


def _attn_layer(hs, lps, sig: LayerSig, ctx: Ctx, lstates, banks):
    """Attention for every rank: per-rank projections off the rank's
    banks (``gather_attn``: split banks, merged landings or a mix of the
    two, per part; with ``banks`` None the replicated weights), the
    cross-rank step (K/V all-gather in prefill, LSE combine in decode),
    per-rank output projections. The split QKV path rolls its outputs back
    to canonical head order, the order the merged output consumes."""
    cfg = ctx.cfg
    if banks is None:
        banks = [lp["attn"] for lp in lps]
    parts = [(b.qkv, b.out) if isinstance(b, prefetch.AttnBank) else (b, b) for b in banks]
    qkv = []
    for r, h in enumerate(hs):
        w = parts[r][0]
        if isinstance(w, prefetch.SplitBank):
            qkv.append(_attn_split_qkv(h, w, r, ctx))
        else:
            qkv.append(_merged_qkv(h, w, ctx))
    new_states = lstates
    if ctx.decode:
        partials, new_states = [], []
        for r, (q, k, v) in enumerate(qkv):
            pos = ctx.rank_pos(r)
            q = apply_rope(q, pos[:, None], cfg.rope_theta, ctx.model.rope_freqs)
            k = apply_rope(k, pos[:, None], cfg.rope_theta, ctx.model.rope_freqs)
            part, st = _attn_decode_partial(q, k, v, sig, ctx, lstates[r], r)
            partials.append(part)
            new_states.append(st)
        outs = [o[:, None] for o in _combine_over_seq(partials, ctx)]
    else:
        qs, ks, vs = [], [], []
        for r, (q, k, v) in enumerate(qkv):
            b, s = q.shape[:2]
            posb = (ctx.q_offsets[r] + torch.arange(s, device=q.device)).expand(b, s)
            qs.append(apply_rope(q, posb, cfg.rope_theta, ctx.model.rope_freqs))
            ks.append(apply_rope(k, posb, cfg.rope_theta, ctx.model.rope_freqs))
            vs.append(v)
        outs = [None] * len(qs)
        captured = [None] * len(qs)
        for grp in ctx.seq_groups():  # the K/V all-gather over each sequence group
            k_all = torch.cat([ks[j] for j in grp], dim=1)
            v_all = torch.cat([vs[j] for j in grp], dim=1)
            for j in grp:
                outs[j] = flash_lib.flash_attention(qs[j], k_all, v_all, window=sig.window,
                                                    q_offset=ctx.q_offsets[j], impl=ctx.attn_impl)
                if ctx.capture_len:
                    captured[j] = _capture_kv_state(k_all, v_all, sig, ctx, j)
            del k_all, v_all
        if ctx.capture_len:
            new_states = captured
    ys = []
    for r, out in enumerate(outs):
        w = parts[r][1]
        if isinstance(w, prefetch.SplitBank):
            ys.append(_attn_split_out(out, w, r, ctx))
        else:
            ys.append(_project_out(out, w["wo"]))
    return ys, new_states


def _attn_tp_layer(hs, lps, sig: LayerSig, ctx: Ctx) -> list:
    """DEP's tensor-parallel prefill attention (``_attn_tp`` of the JAX
    package): the tokens all-gathered (the rows over the model group where
    the batch is sharded over ``model``, else the sequence over the
    rank's sequence group), each rank's own heads projected off its
    resident shard, RoPE at the gathered positions and attention over the
    whole sequence (the flash kernel), the rank's slice of ``wo``, then a
    psum_scatter over the model group back to the rank's tokens. Returns
    no layer state: the JAX package captures none here. (The JAX package
    gathers the sequence over ``model`` alone: where the sequence is also
    sharded over ``data`` its attention would see one data replica's
    slices; the port gathers the whole sequence group.)"""
    cfg, geom, xp = ctx.cfg, ctx.geom, ctx.xp
    hd = cfg.head_dim
    heads_l = cfg.num_heads // geom.attn_shards
    kv_l = cfg.num_kv_heads // geom.kv_shard
    by_rows = AXIS_MODEL in xp.batch_axes
    dim = 0 if by_rows else 1
    parts = [None] * len(hs)
    for grp in ctx.model_groups() if by_rows else ctx.seq_groups():
        hg = torch.cat([hs[j] for j in grp], dim=dim)
        b, s, _ = hg.shape
        posb = torch.arange(s, device=hg.device).expand(b, s)
        for j in grp:
            aw = lps[j]["attn"]
            q = apply_rope(_project_heads(hg, aw["wq"], heads_l, hd), posb, cfg.rope_theta,
                           ctx.model.rope_freqs)
            k = apply_rope(_project_heads(hg, aw["wk"], kv_l, hd), posb, cfg.rope_theta,
                           ctx.model.rope_freqs)
            v = _project_heads(hg, aw["wv"], kv_l, hd)
            out = flash_lib.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                            window=sig.window, q_offset=0, impl=ctx.attn_impl)
            parts[j] = _project_out(out, aw["wo"])
        del hg
    ys = [None] * len(hs)
    for grp in ctx.model_groups():
        for m, r in enumerate(grp):
            # the rank's tokens: its block of the gathered rows or sequence
            idx = m if by_rows else xp.seq_index(r)
            n = hs[r].shape[dim]
            ys[r] = collectives.psum([parts[j].narrow(dim, idx * n, n) for j in grp])
    return ys


def _attn_qgather_layer(hs, lps, sig: LayerSig, ctx: Ctx, lstates):
    """Decode attention with the weights left sharded
    (``_attn_decode_qgather`` of the JAX package): each rank projects its
    own q/k/v feature slices, the slices are all-gathered (the duplicated
    kv groups dropped), every rank attends over its slice of the KV ring
    with the LSE combine, applies its slice of ``wo`` to its own features
    of the output, and a psum adds the ranks' products."""
    cfg, geom = ctx.cfg, ctx.geom
    b, hd, g = hs[0].shape[0], cfg.head_dim, geom.attn_shards
    dup = g // geom.kv_shard
    kvd_l = cfg.kv_dim // geom.kv_shard
    partials, new_states = [None] * len(hs), [None] * len(hs)
    for grp in ctx.model_groups():
        def proj(name):
            # each rank's own feature slice, all-gathered over the group
            return torch.cat([_project_heads(hs[j], lps[j]["attn"][name], 1, -1).flatten(2)
                              for j in grp], dim=2)

        pos = ctx.rank_pos(grp[0])
        q = proj("wq").reshape(b, 1, cfg.num_heads, hd)
        k = proj("wk").reshape(b, 1, g, kvd_l)[:, :, ::dup].reshape(b, 1, cfg.num_kv_heads, hd)
        v = proj("wv").reshape(b, 1, g, kvd_l)[:, :, ::dup].reshape(b, 1, cfg.num_kv_heads, hd)
        q = apply_rope(q, pos[:, None], cfg.rope_theta, ctx.model.rope_freqs)
        k = apply_rope(k, pos[:, None], cfg.rope_theta, ctx.model.rope_freqs)
        for j in grp:
            partials[j], new_states[j] = _attn_decode_partial(q, k, v, sig, ctx, lstates[j], j)
    outs = _combine_over_seq(partials, ctx)
    qd_l = cfg.q_dim // g
    ys = [None] * len(hs)
    for grp in ctx.model_groups():
        flat = outs[grp[0]].reshape(b, 1, cfg.q_dim)
        y = collectives.psum([_project_out(flat[:, :, m * qd_l:(m + 1) * qd_l],
                                           lps[j]["attn"]["wo"]) for m, j in enumerate(grp)])
        for j in grp:
            ys[j] = y
    return ys, new_states


# ==========================================================================
# FFN (dense "virtual experts") + MoE.
# ==========================================================================
def _ffn_full(x2d, fp):
    """x2d: (T,D); fp stacked (S,D,F/S) / (S,F/S,D), full content (the
    replicated layout or a merged landing): one product per shard straight
    off the stacked weights (no copy of them), the shards summed."""
    w = {k: v.to(x2d.dtype) for k, v in fp.items()}
    x = x2d[None]
    h = torch.nn.functional.silu(torch.matmul(x, w["w_gate"])) * torch.matmul(x, w["w_up"])
    return torch.matmul(h, w["w_down"]).sum(dim=0)


def _ffn_apply(x2d, fp, ctx: Ctx, gathered=None):
    if not ctx.geom.ffn_axes:
        return _ffn_full(x2d, fp)
    assert gathered is not None, "DWDP FFN weights must be prefetched"
    if not isinstance(gathered, prefetch.SplitBank):
        return _ffn_full(x2d, gathered)  # the merged landing
    # y = sum_s swiglu_s(x) over (resident, remote) slice banks: the sum is
    # order-independent, so the rotated bank order needs no fix-up.
    lo, re = gathered.local, gathered.remote
    return split_gemm_lib.split_dense_ffn(
        x2d.contiguous(),
        lo["w_gate"], lo["w_up"], lo["w_down"],
        re["w_gate"], re["w_up"], re["w_down"],
        impl=ctx.dense_impl,
    )


def _swiglu_slice(x2d, fp):
    """One rank's partial-F SwiGLU off its resident slice (leading dim 1)."""
    h = torch.nn.functional.silu(x2d @ fp["w_gate"][0].to(x2d.dtype)) * (
        x2d @ fp["w_up"][0].to(x2d.dtype))
    return h @ fp["w_down"][0].to(x2d.dtype)


def _ffn_tp_apply(x2ds: list, fps: list, ctx: Ctx) -> list:
    """DEP's tensor-parallel FFN (the DEP branches of ``_ffn_apply`` in the
    JAX package) for every rank, over the model group of its data replica:
    in decode the rows are replicated over the group, so each rank computes
    its F slice and a psum adds them; in prefill the group's tokens are
    all-gathered, each rank computes its F slice of all of them, and a
    psum_scatter returns each rank's rows."""
    out = [None] * len(x2ds)
    for grp in ctx.model_groups():
        if ctx.decode:
            ys = [collectives.psum([_swiglu_slice(x2ds[j], fps[j]) for j in grp])] * len(grp)
        else:
            xg = torch.cat([x2ds[j] for j in grp], dim=0)
            ys = collectives.psum_scatter([_swiglu_slice(xg, fps[j]) for j in grp],
                                          [x2ds[j].shape[0] for j in grp])
        for j, y in zip(grp, ys):
            out[j] = y
    return out


def _rolled_dispatch(d: moe_lib.Dispatch, roll: int, e_pad: int, capacity: int):
    """Rotate the dispatch's expert coordinate by ``-roll`` so the rank's
    resident experts occupy positions [0, local) — the split banks'
    order. Only ``flat_slot`` moves."""
    exp = d.flat_slot // capacity
    slot = d.flat_slot - exp * capacity
    exp = (exp - roll) % e_pad
    return d._replace(flat_slot=exp * capacity + slot)


def _route(x2d, mp, ctx: Ctx, rows: int):
    """The rank's routing of its own tokens: ``(dispatch, capacity)``."""
    moe, xp = ctx.cfg.moe, ctx.xp
    if xp.capacity_from == "global":
        row_tokens = 1 if ctx.decode else xp.seq_len
        cap_row = moe_lib.capacity_for(row_tokens, moe.num_experts, moe.top_k, xp.capacity_factor)
        if not ctx.decode and xp.seq_shards > 1:
            cap_row = -(-cap_row // xp.seq_shards)
        d = moe_lib.route_topk_rows(
            x2d.reshape(rows, -1, x2d.shape[-1]), mp["router"], moe.top_k,
            cap_row, num_real=moe.num_experts,
        )
        return d, rows * cap_row
    cap = moe_lib.capacity_for(x2d.shape[0], moe.num_experts, moe.top_k, xp.capacity_factor)
    return moe_lib.route_topk(x2d, mp["router"], moe.top_k, cap, num_real=moe.num_experts), cap


def _split_moe(x2d, d, cap: int, bank: prefetch.SplitBank, rank: int, ctx: Ctx):
    """§4.2 split path: tokens dispatch in rotated canonical order
    (resident experts first); the kernel reads both banks by pointer."""
    pl = ctx.geom.moe_placement
    e_pad = pl.num_padded
    d = _rolled_dispatch(d, (rank % pl.subgroup_size) * pl.local_count, e_pad, cap)
    xe = moe_lib.dispatch_tokens(x2d, d, e_pad, cap)
    lo, re = bank.local, bank.remote
    ye = split_gemm_lib.split_swiglu(
        xe,
        lo["w_gate"], lo["w_up"], lo["w_down"],
        re["w_gate"], re["w_up"], re["w_down"],
        impl=ctx.moe_impl,
    )
    return moe_lib.combine_tokens(ye, d, x2d.shape[0])


def _shared_out(x2d, mp, ctx: Ctx, banks: dict):
    """The shared expert's output of one rank (None without one)."""
    if "shared" not in mp:
        return None
    return _ffn_apply(x2d, mp["shared"], ctx, banks.get("moe/shared"))


def _with_shared(y, shared):
    return y if shared is None else y + shared


def _add_shared(y, x2d, mp, ctx: Ctx, banks: dict):
    return _with_shared(y, _shared_out(x2d, mp, ctx, banks))


def _moe_apply(x2d, mp, ctx: Ctx, banks: dict, rows: int, rank: int, group: str):
    """The DWDP gather-mode MoE of one rank: the split path off its
    SplitBank, or — replicated experts, or the merged layout's canonical
    ``(E_pad, D, F)`` landing — a canonical-order dispatch and the grouped
    FFN (``torch.bmm``, as the JAX package runs jnp there). ``group`` is
    the layer's group, which scopes its policy."""
    pl = ctx.geom.moe_placement
    assert ctx.cfg.moe is not None and pl is not None
    d, cap = _route(x2d, mp, ctx, rows)
    if pl.group_size > 1 and moe_split_active(ctx.geom, ctx.xp, group):
        y = _split_moe(x2d, d, cap, banks["moe/experts"], rank, ctx)
    else:
        ex = mp["experts"] if pl.group_size == 1 else banks["moe/experts"]
        xe = moe_lib.dispatch_tokens(x2d, d, pl.num_padded, cap)
        ye = moe_lib.grouped_ffn(xe, ex["w_gate"], ex["w_up"], ex["w_down"])
        y = moe_lib.combine_tokens(ye, d, x2d.shape[0])
    return _add_shared(y, x2d, mp, ctx, banks)


def _moe_dep_layer(h2fs: list, lps: list, ctx: Ctx, pipe: BankPipeline, lid, rows: int,
                   has_unit: bool) -> list:
    """DEP's (and hybrid's) expert path for every rank at once (the
    ``else`` branch of ``_moe_apply`` in the JAX package): each rank routes
    its tokens and dispatches them to ``(E_pad, C, D)``; an all-to-all over
    the expert subgroup gives the owner of expert block ``j`` that block of
    every rank, ``(local, G' * C, D)`` in source-rank order; each owner
    runs the grouped FFN over its resident experts; a second all-to-all
    returns the results and each rank combines its tokens. The shared
    expert runs tensor-parallel (dep) or off its split bank (hybrid)."""
    pl = ctx.geom.moe_placement
    routes = [_route(x, lp["moe"], ctx, rows) for x, lp in zip(h2fs, lps)]
    xes = [moe_lib.dispatch_tokens(x, d, pl.num_padded, cap) for x, (d, cap) in zip(h2fs, routes)]
    xrs = collectives.all_to_all(xes, pl, split_dim=0, concat_dim=1)
    del xes
    yrs = []
    for xr, lp in zip(xrs, lps):
        ex = lp["moe"]["experts"]
        yrs.append(moe_lib.grouped_ffn(xr, ex["w_gate"], ex["w_up"], ex["w_down"]))
    del xrs
    yes = collectives.all_to_all(yrs, pl, split_dim=1, concat_dim=0)
    del yrs
    ys = [moe_lib.combine_tokens(ye, d, x.shape[0]) for ye, (d, _), x in zip(yes, routes, h2fs)]
    del yes
    if "shared" not in lps[0]["moe"]:
        return ys
    if _ffn_tp_active(ctx.geom, ctx.xp):
        shared = _ffn_tp_apply(h2fs, [lp["moe"]["shared"] for lp in lps], ctx)
        return [y + s for y, s in zip(ys, shared)]
    out = []
    for r, (y, x2d, lp) in enumerate(zip(ys, h2fs, lps)):
        banks = pipe.get(("ffn", lid, r)) if has_unit else {}
        out.append(_add_shared(y, x2d, lp["moe"], ctx, banks))
        del banks
    return out


# --------------------------------------------------------------------------
# Route-before-gather MoE (``_moe_demand_apply`` of the JAX package).
# --------------------------------------------------------------------------
def _wanted_bitmap(d: moe_lib.Dispatch, e_pad: int) -> torch.Tensor:
    """Activated-expert bitmap of the kept tokens (dropped tokens carry
    zero combine weight, so their experts need no fetch)."""
    hits = torch.zeros(e_pad, dtype=torch.int32, device=d.keep.device)
    hits.index_add_(0, d.top_experts.reshape(-1), d.keep.to(torch.int32))
    return hits > 0


def _remap_and_run(x2d, d, cap: int, local_tree: dict, fetched: dict, ids, valid, p: int,
                   ctx: Ctx):
    """Dispatch through the compact bank — resident experts at ``[0,
    local)``, fetched rows after them — and run the demand kernel. Experts
    neither resident nor fetched receive only zero-weight traffic, so they
    map to position 0."""
    pl = ctx.geom.moe_placement
    local, e_pad = pl.local_count, pl.num_padded
    rows = valid.shape[0]
    dev = x2d.device
    pos = torch.zeros(e_pad + 1, dtype=torch.int64, device=dev)
    pos[p * local + torch.arange(local, device=dev)] = torch.arange(local, device=dev)
    pos[torch.where(valid, ids, e_pad)] = local + torch.arange(rows, device=dev)
    exp = d.flat_slot // cap
    slot = d.flat_slot - exp * cap
    d2 = d._replace(flat_slot=pos[exp] * cap + slot)
    xe = moe_lib.dispatch_tokens(x2d, d2, local + rows, cap)
    lo, fe = local_tree, fetched
    ye = split_gemm_lib.split_swiglu_demand(
        xe,
        lo["w_gate"], lo["w_up"], lo["w_down"],
        fe["w_gate"], fe["w_up"], fe["w_down"],
        valid,
        impl=ctx.moe_impl,
    )
    return moe_lib.combine_tokens(ye, d2, x2d.shape[0])


def _full_gather_moe(x2d, d, cap: int, shards: list, rank: int, ctx: Ctx, group: str):
    """The overflow fallback: the full remote bank, landed now over the
    family's transport in the layer's ``group``, and the split path — exact
    for any routing."""
    pol = ctx.xp.policy("moe_experts", group)
    bank = prefetch.gather_split_bank(shards, rank, ctx.geom.moe_placement, mode=pol.transport,
                                      num_slices=pol.num_slices)
    return _split_moe(x2d, d, cap, bank, rank, ctx)


def _moe_demand_layer(h2fs: list, lps: list, ctx: Ctx, pipe: BankPipeline, lid, rows: int,
                      preds, has_unit: bool):
    """Route-before-gather MoE of one layer for every rank.

    1. Every rank routes its tokens on its own router weights; the kept
       tokens' experts form its wanted bitmap.
    2. The cross-rank index round: the bitmaps are exchanged and each
       rank's fetch schedule is compacted per peer to the budget; the
       overflow flag is agreed over every rank (:meth:`Ctx.overflowed`:
       read on the host in the eager mode — the layer's one sync, where
       the JAX package branches on the device — or left on the device for
       the step's caller in the deferred mode).
    3. Per rank: the payload lands the requested rows (budget-padded) and
       the demand kernel runs over the compact (resident, fetched) bank;
       on an eager overflow the full remote bank lands and the split path
       runs.

    Predictive decode (``preds``: the layer's incoming per-rank
    ``PredictState``) serves the wanted set first from the residency cache
    and the layer-ahead speculative round (the pipeline unit's
    :class:`SpecBank`); only the misses ride the correction round, whose
    payload and the compact kernel run unconditionally — the full gather
    replaces the result on fallback, as in the JAX package. The kernel
    reads (cache | speculative | correction) as one fetched bank, so the
    result is the all-fetch path's for any predictor state and budget.
    Sync-free layers also cross-check the mirrored schedule with a digest
    and replay every mirror's cache bookkeeping.

    The validated fetch (``xp.validated``) checks every fetched and cached
    row against the owners' checksum table (``lp["moe"]["checksums"]``,
    built once per weight set): cache rows may rot (the injector's cache
    mask) and payload rows arrive tampered (its payload masks); cached and
    speculative rows are verified before the correction round is planned,
    so bad ones are fetched again there, and a bad row in the last round
    raises the agreed flag that takes the exact full gather, ORed into the
    overflow flag (one host read per step in the deferred mode). Each such
    layer adds its counters to ``ctx.fault_stats``. Returns ``(outputs,
    new per-rank PredictState or None)``."""
    cfg, geom, xp = ctx.cfg, ctx.geom, ctx.xp
    pl = geom.moe_placement
    g, local, e_pad = pl.subgroup_size, pl.local_count, pl.num_padded
    n = len(h2fs)
    shards = [lp["moe"]["experts"] for lp in lps]
    group = lid[0]
    pol = xp.policy("moe_experts", group)
    wire = dict(mode=pol.transport, num_slices=pol.num_slices)
    budget = resolve_demand_budget(cfg, geom, xp, group)
    validate = xp.validated
    inj = _fault_injector(ctx)
    log = ctx.fault_log
    tables = [_checksum_table(lp["moe"]) for lp in lps] if validate else None
    routes = [_route(x, lp["moe"], ctx, rows) for x, lp in zip(h2fs, lps)]
    wanted = [_wanted_bitmap(d, e_pad) for d, _ in routes]
    dev = h2fs[0].device
    zero = torch.zeros((), device=dev)

    def site_key(tag: str, r: int):
        return inj.site_key(tag, _fault_step(ctx, r), r) if inj is not None else None

    def full_gather(r: int):
        (d, cap), x2d = routes[r], h2fs[r]
        return _full_gather_moe(x2d, d, cap, shards, r, ctx, group)

    if not predictive_fetch_active(cfg, geom, xp, group):
        plans = prefetch.plan_demand_fetch(wanted, pl, budget=budget)
        if not validate:
            fallback = ctx.overflowed(plans[0].overflow)
            ys = []
            for r in range(n):
                banks = pipe.get(("ffn", lid, r)) if has_unit else {}
                (d, cap), x2d = routes[r], h2fs[r]
                if fallback:
                    y = full_gather(r)
                else:
                    bank = prefetch.gather_demand_payload(shards, plans[r], r, pl,
                                                          budget=budget, **wire)
                    y = _remap_and_run(x2d, d, cap, bank.local, bank.fetched, bank.fetched_ids,
                                       bank.valid, r % g, ctx)
                    del bank
                ys.append(_add_shared(y, x2d, lps[r]["moe"], ctx, banks))
                del banks
            return ys, None
        # validated demand: every rank's payload, verification and compact
        # kernel run; any bad row takes every rank to the full gather
        ys, shared, bads = [], [], []
        stats = torch.zeros(faults.FAULT_STAT_BASE + g, device=dev)
        for r in range(n):
            banks = pipe.get(("ffn", lid, r)) if has_unit else {}
            (d, cap), x2d = routes[r], h2fs[r]
            p = r % g
            key = site_key("corr", r)
            bank = prefetch.gather_demand_payload(shards, plans[r], r, pl, budget=budget, **wire,
                                                  injector=inj, fault_key=key)
            valid_v, bad = prefetch.verify_rows(bank.fetched, bank.fetched_ids, bank.valid,
                                                tables[r])
            ys.append(_remap_and_run(x2d, d, cap, bank.local, bank.fetched, bank.fetched_ids,
                                     valid_v, p, ctx))
            shared.append(_shared_out(x2d, lps[r]["moe"], ctx, banks))
            del bank, banks
            bads.append(bad.sum())
            if inj is not None:
                stats[0:3] += _injected_counts(inj, key, budget, plans[r].valid, p, log,
                                               site="corr", rank=r, step=_fault_step(ctx, r),
                                               bad=bad)
            stats[4] += bads[-1].float()
            stats[faults.FAULT_STAT_BASE:] += _per_src_detected(bad, min(budget, local), g, p)
        fault_fb = torch.stack(bads).sum() > 0
        stats[5] = fault_fb.float()
        _add_fault_stats(ctx, stats)
        if ctx.overflowed(plans[0].overflow | fault_fb):
            ys = [full_gather(r) for r in range(n)]
        return [_with_shared(y, sh) for y, sh in zip(ys, shared)], None

    sync_free = sync_free_active(cfg, geom, xp, group)
    sbudget = min(resolve_spec_budget(cfg, geom, xp, group), local)
    cbudget = min(budget, local)
    spec_plans = _spec_plans(ctx, lid, preds)
    diverged = torch.zeros((), dtype=torch.bool, device=dev)
    if sync_free:
        # mirrored-schedule cross-check: each rank's digest of the
        # speculative schedule it derived, summed over its subgroup; any
        # mismatch voids the speculative rows and forces the full gather
        dgs = [prefetch.schedule_digest(pln.masks) for pln in spec_plans]
        div = []
        for r in range(n):
            tot = sum(dgs[q] for q in prefetch.subgroup_ranks(r, pl))
            div.append(torch.abs(g * dgs[r] - tot) > 0.5)
        diverged = torch.stack(div).any()
        cache_ids = [pred.cache_ids[r % g] for r, pred in enumerate(preds)]
        cache_valid = [pred.cache_valid[r % g] for r, pred in enumerate(preds)]
    else:
        cache_ids = [pred.cache_ids for pred in preds]
        cache_valid = [pred.cache_valid for pred in preds]
    stats = torch.zeros(faults.FAULT_STAT_BASE + g, device=dev) if (
        validate or sync_free) else None
    ys, shared, ovfs, bad_corrs, residuals, news = [], [], [], [], [], []
    for r in range(n):
        banks = pipe.get(("ffn", lid, r))
        spec = banks["moe/experts"]
        assert isinstance(spec, SpecBank), "predictive layers prefetch the speculative bank"
        pred, p = preds[r], r % g
        (d, cap), x2d = routes[r], h2fs[r]
        n_cache = cache_ids[r].shape[0]
        n_head = n_cache + (g - 1) * sbudget
        cache_w = prefetch.tree_map(lambda b: b[:n_cache], spec.landing)
        if inj is not None and n_cache:
            # residency-cache rot: the rows went bad in place between steps
            cache_tamper = inj.cache_mask(site_key("cache", r), n_cache)
            inj.tamper_rows(cache_w, torch.zeros_like(cache_tamper), cache_tamper)
            stats[3] += (cache_tamper & cache_valid[r]).sum().float()
        if validate:
            # cached and speculative rows are verified before the exclusion
            # set is built: bad ones fall out of it and the correction
            # round fetches them again (the in-band repair)
            cache_valid_v, bad_cache = prefetch.verify_rows(
                cache_w, cache_ids[r], cache_valid[r], tables[r])
            spec_valid_v, bad_spec = prefetch.verify_rows(
                spec.bank.fetched, spec.bank.fetched_ids, spec.bank.valid, tables[r])
        else:
            cache_valid_v, spec_valid_v = cache_valid[r], spec.bank.valid
        spec_valid = spec_valid_v & ~diverged
        have_ids = torch.cat([cache_ids[r], spec.bank.fetched_ids])
        have_valid = torch.cat([cache_valid_v, spec_valid])
        residual = wanted[r] & ~prefetch.exclude_bitmap(e_pad, have_ids, have_valid)
        c_ids, c_valid, ovf = prefetch.plan_from_bitmap(residual, p, g, local, cbudget)
        # the payload reads the requester's own row of the exchanged
        # residual bitmaps; the agreed overflow is taken after every rank
        corr_plan = prefetch.DemandPlan(masks=residual[None].expand(g, e_pad), fetched_ids=c_ids,
                                        valid=c_valid, overflow=ovf)
        corr_key = site_key("corr", r)
        corr = prefetch.gather_demand_payload(
            shards, corr_plan, r, pl, budget=cbudget, **wire,
            out=prefetch.tree_map(lambda b: b[n_head:], spec.landing),
            injector=inj, fault_key=corr_key,
        )
        if validate:
            corr_valid_v, bad_corr = prefetch.verify_rows(corr.fetched, corr.fetched_ids,
                                                          corr.valid, tables[r])
            bad_corrs.append(bad_corr.sum())
        else:
            corr_valid_v = corr.valid
        ids_all = torch.cat([cache_ids[r], spec.bank.fetched_ids, corr.fetched_ids])
        # verified validity throughout: a bad or voided row never maps into
        # the compact bank and scores -inf in the cache insert below
        valid_all = torch.cat([cache_valid_v, spec_valid, corr_valid_v])
        ys.append(_remap_and_run(x2d, d, cap, shards[r], spec.landing, ids_all, valid_all, p,
                                 ctx))
        shared.append(_shared_out(x2d, lps[r]["moe"], ctx, banks))
        ovfs.append(ovf)
        residuals.append(residual)

        # ---- residency-cache insert: keep the EMA-hottest rows of (cache |
        # this step's fetches); ids stay unique by the exclusion chain ----
        neg_inf = torch.full((), -math.inf, device=dev)  # a fill: no host copy
        new = {}
        if sync_free:
            # the rank's own position of the mirrored replay (every
            # position's bookkeeping follows once every residual is known):
            # structural validity only, never the local checksum results
            ids_p, valid_p = _replay_ids(pred, spec_plans[r].masks[p], residual, p, g, local,
                                         sbudget, cbudget, diverged, xp.exclude_peers)
            score = torch.where(valid_p, pred.ema[p][ids_p], neg_inf)
            order = torch.argsort(-score, stable=True)[:n_cache]
            nc_valid = valid_p[order]
            new["own"] = (ids_p[order], nc_valid)
        else:
            new_ema = prefetch.EMA_DECAY * pred.ema + (1.0 - prefetch.EMA_DECAY) * wanted[r].float()
            score = torch.where(valid_all, new_ema[ids_all], neg_inf)
            order = torch.argsort(-score, stable=True)[:n_cache]
            nc_valid = valid_all[order]
            new.update(prev=wanted[r], ema=new_ema, cache_ids=ids_all[order], cache_valid=nc_valid)
        new["cache"] = prefetch.tree_map(
            lambda w: prefetch.gather_rows(
                w, order, torch.empty((order.shape[0],) + tuple(w.shape[1:]),
                                      dtype=w.dtype, device=w.device)),
            spec.landing,
        )
        if sync_free and validate:
            # the mirrors keep a row that failed its checksum (their
            # bookkeeping never reads local checks): store it as zeros, which
            # fail every later check, where a corrupted row corrupted again
            # (1 - (1 - w)) could round back to within the tolerance of w
            bad_new = torch.cat([bad_cache, bad_spec, bad_corr])[order]
            prefetch.tree_map(lambda w: w.masked_fill_(bad_new.view((-1,) + (1,) * (w.dim() - 1)), 0),
                              new["cache"])

        # ---- hit/miss accounting over the wanted remote rows ----
        local_mask = torch.zeros(e_pad, dtype=torch.bool, device=dev)
        local_mask[p * local:(p + 1) * local] = True
        wanted_remote = wanted[r] & ~local_mask
        spec_map = prefetch.exclude_bitmap(e_pad, spec.bank.fetched_ids, spec_valid)
        cache_map = prefetch.exclude_bitmap(e_pad, cache_ids[r], cache_valid_v)
        n_new = spec.bank.valid.sum() + corr.valid.sum()
        new["counts"] = (
            spec.bank.valid.sum().float(),
            (wanted_remote & spec_map & ~cache_map).sum().float(),
            (wanted_remote & cache_map).sum().float(),
            corr.valid.sum().float(),
            wanted_remote.sum().float(),
            torch.clamp(cache_valid[r].sum() + n_new - nc_valid.sum(), min=0).float(),
        )
        if sync_free:
            k_top = d.top_experts.shape[-1]
            new["routed"] = prefetch.routed_bitmaps(
                torch.where(d.keep.reshape(-1, k_top), d.top_experts, e_pad), e_pad)
        news.append(new)
        if validate:
            if inj is not None:
                step = _fault_step(ctx, r)
                if log is not None and n_cache:
                    log.append({"site": "cache", "rank": r, "step": step, "budget": n_cache,
                                "masks": (cache_tamper,), "valid": cache_valid[r],
                                "bad": bad_cache})
                stats[0:3] += _injected_counts(inj, site_key("spec", r), sbudget,
                                               spec.bank.valid, p, log, site="spec", rank=r,
                                               step=step, bad=bad_spec)
                stats[0:3] += _injected_counts(inj, corr_key, budget, corr.valid, p, log,
                                               site="corr", rank=r, step=step, bad=bad_corr)
            stats[4] += (bad_cache.sum() + bad_spec.sum() + bad_corr.sum()).float()
            # payload rows by the peer-major layout, cache rows by the
            # position owning the expert id
            stats[faults.FAULT_STAT_BASE:] += (
                _per_src_detected(bad_spec, sbudget, g, p)
                + _per_src_detected(bad_corr, cbudget, g, p)
                + torch.zeros(g, device=dev).index_add_(0, cache_ids[r] // local,
                                                        bad_cache.float()))
        del banks, spec, corr, cache_w

    flag = torch.stack(ovfs).any() | diverged
    if validate:
        # a bad correction row has no later round to fall to: the agreed
        # flag takes the full gather, as an overflow does
        fault_fb = torch.stack(bad_corrs).sum() > 0
        stats[5] = fault_fb.float()
        flag = flag | fault_fb
    if stats is not None:
        stats[6] = diverged.float()
        _add_fault_stats(ctx, stats)
    fallback = ctx.overflowed(flag)
    if fallback:
        ys = [full_gather(r) for r in range(n)]
    ys = [_with_shared(y, sh) for y, sh in zip(ys, shared)]

    new_preds = []
    for r in range(n):
        pred, p, new = preds[r], r % g, news[r]
        n_pred, n_spec, n_cache_hit, n_corr, n_want, evicted = new["counts"]
        if fallback:
            # the full gather served every wanted remote row: no hits
            stats_r = torch.stack([n_pred, zero, zero, n_want, evicted])
        else:
            stats_r = torch.stack([n_pred, n_spec, n_cache_hit, n_corr, evicted])
        if sync_free:
            # every rank replays every mirror's bookkeeping from the
            # exchanged schedules and residuals and the pre-step mirror EMA
            members = prefetch.subgroup_ranks(r, pl)
            rep_ids, rep_valid = [], []
            n_cache = cache_ids[r].shape[0]
            neg_inf = torch.full((), -math.inf, device=dev)
            for q in range(g):
                if q == p:
                    rep_ids.append(new["own"][0])
                    rep_valid.append(new["own"][1])
                    continue
                ids_q, valid_q = _replay_ids(pred, spec_plans[r].masks[q], residuals[members[q]],
                                             q, g, local, sbudget, cbudget, diverged,
                                             xp.exclude_peers)
                score = torch.where(valid_q, pred.ema[q][ids_q], neg_inf)
                order_q = torch.argsort(-score, stable=True)[:n_cache]
                rep_ids.append(ids_q[order_q])
                rep_valid.append(valid_q[order_q])
            new_preds.append(pred._replace(
                cache_ids=torch.stack(rep_ids), cache_valid=torch.stack(rep_valid),
                cache=new["cache"], stats=stats_r, routed=new["routed"],
            ))
        else:
            new_preds.append(pred._replace(
                prev=new["prev"], ema=new["ema"], cache_ids=new["cache_ids"],
                cache_valid=new["cache_valid"], cache=new["cache"], stats=stats_r,
            ))
    return ys, new_preds


def _replay_ids(pred, mask_q, resid_q, q: int, g: int, local: int, sbudget: int, cbudget: int,
                diverged, exclude_peers: tuple):
    """Sync-free: position ``q``'s candidate cache rows (ids and structural
    validity, ``[cache | speculative | correction]``) from the mirror, the
    derived speculative schedule and the exchanged residual bitmap; an
    excluded peer's rows are never cached (they would go stale while the
    peer is distrusted)."""
    s_ids, s_valid, _ = prefetch.plan_from_bitmap(mask_q, q, g, local, sbudget)
    c_ids, c_valid, _ = prefetch.plan_from_bitmap(resid_q, q, g, local, cbudget)
    ids_q = torch.cat([pred.cache_ids[q], s_ids, c_ids])
    valid_q = torch.cat([pred.cache_valid[q], s_valid & ~diverged, c_valid])
    for peer in exclude_peers:
        valid_q = valid_q & (ids_q // local != int(peer) % g)
    return ids_q, valid_q


# ==========================================================================
# One layer, the stack.
# ==========================================================================
def apply_layer(xs, lps, sig: LayerSig, ctx: Ctx, lstates, pipe: BankPipeline, lid,
                lpreds=None):
    """One layer for every rank. ``lid`` names the layer's pipeline units;
    ``lpreds`` is the layer's incoming per-rank ``PredictState`` (predictive
    decode). Returns ``(xs, new_states, new_preds)``."""
    cfg, eps = ctx.cfg, ctx.cfg.norm_eps
    geom, xp = ctx.geom, ctx.xp
    group = lid[0]
    keys = gather_set(sig, geom, xp, cfg, group)
    hs = [rms_norm(x, lp["norm1"], eps) for x, lp in zip(xs, lps)]
    if "attn" in keys:
        attn_banks = pipe.get(("attn", lid))
        outs, new_states = _attn_layer(hs, lps, sig, ctx, lstates, attn_banks)
        del attn_banks
    elif geom.attn_axes and _qgather_ok(geom, xp):
        outs, new_states = _attn_qgather_layer(hs, lps, sig, ctx, lstates)
    elif geom.attn_axes:
        outs, new_states = _attn_tp_layer(hs, lps, sig, ctx), lstates
    else:
        outs, new_states = _attn_layer(hs, lps, sig, ctx, lstates, None)
    xs = [x + o for x, o in zip(xs, outs)]
    new_preds = None
    if "norm2" in lps[0]:
        ffn_keys = tuple(k for k in keys if k != "attn")
        h2s = [rms_norm(x, lp["norm2"], eps) for x, lp in zip(xs, lps)]
        b, s, dm = h2s[0].shape
        h2fs = [h.reshape(b * s, dm) for h in h2s]
        if sig.is_moe and demand_fetch_active(cfg, geom, xp, group):
            ys, new_preds = _moe_demand_layer(h2fs, lps, ctx, pipe, lid, b, lpreds,
                                              bool(ffn_keys))
        elif sig.is_moe and _experts_all_to_all(geom, xp):
            ys = _moe_dep_layer(h2fs, lps, ctx, pipe, lid, b, bool(ffn_keys))
        elif not sig.is_moe and _ffn_tp_active(geom, xp):
            ys = _ffn_tp_apply(h2fs, [lp["ffn"] for lp in lps], ctx)
        else:
            ys = []
            for r, lp in enumerate(lps):
                banks = pipe.get(("ffn", lid, r)) if ffn_keys else {}
                if sig.is_moe:
                    ys.append(_moe_apply(h2fs[r], lp["moe"], ctx, banks, rows=b, rank=r,
                                              group=group))
                else:
                    ys.append(_ffn_apply(h2fs[r], lp["ffn"], ctx, banks.get("ffn")))
                del banks  # the next rank's unit lands in this one's place
        xs = [x + y.reshape(b, s, dm) for x, y in zip(xs, ys)]
    return xs, new_states, new_preds


def _index(tree, c):
    return prefetch.tree_map(lambda t: t[c], tree)


def _layer_walk(model: Model):
    """(group, cycle, position, sig) in execution order."""
    for group in model.plan:
        for c in range(group.n_cycles):
            for j, sig in enumerate(group.sigs):
                yield group, c, j, sig


def _layer_params(params, group, c, j) -> list[dict]:
    lps = [p["layers"][group.name][f"pos{j}"] for p in params]
    return [_index(lp, c) for lp in lps] if group.scan else lps


def _layer_preds(preds, group, c, j):
    """The layer's incoming per-rank PredictState list, or None."""
    if not preds or group.name not in preds or f"pos{j}" not in preds[group.name]:
        return None
    return preds[group.name][f"pos{j}"][c]


def _pipeline_units(params, ctx: Ctx, preds=None) -> list:
    units = []
    geom, xp = ctx.geom, ctx.xp
    for group, c, j, sig in _layer_walk(ctx.model):
        keys = gather_set(sig, geom, xp, ctx.cfg, group.name)
        if not keys:
            continue
        lid = (group.name, c, j)
        lps = _layer_params(params, group, c, j)
        if "attn" in keys:
            units.append((("attn", lid),
                          lambda st, lps=lps, g=group.name: gather_attn(lps, ctx, st, g)))
        ffn_keys = tuple(k for k in keys if k != "attn")
        if ffn_keys:
            lpreds = _layer_preds(preds, group, c, j)
            for r in range(len(params)):
                units.append((
                    ("ffn", lid, r),
                    lambda st, lps=lps, r=r, ks=ffn_keys, lpreds=lpreds, lid=lid: gather_ffn(
                        ks, lps, r, ctx, st, lpreds, lid),
                ))
    return units


def _run_stack(params, xs, ctx: Ctx, states):
    """The layer stack (scan groups become a Python loop over cycles).
    Returns ``(xs, new layer states, new predict states)``."""
    model = ctx.model
    preds = states.get("pred") if states is not None else None
    pipe = BankPipeline(_pipeline_units(params, ctx, preds), model.device)
    new_layers: dict = {}
    new_preds: dict = {}
    for group, c, j, sig in _layer_walk(model):
        lps = _layer_params(params, group, c, j)
        lstates = None
        if states is not None:
            lstates = states["layers"][group.name][f"pos{j}"]
            if group.scan:
                lstates = [_index(st, c) for st in lstates]
        xs, ns, npred = apply_layer(xs, lps, sig, ctx, lstates, pipe, (group.name, c, j),
                                    _layer_preds(preds, group, c, j))
        if npred is not None:
            new_preds.setdefault(group.name, {}).setdefault(f"pos{j}", []).append(npred)
        if ns is not None:
            gd = new_layers.setdefault(group.name, {})
            if group.scan:
                gd.setdefault(f"pos{j}", []).append(ns)
            else:
                gd[f"pos{j}"] = ns
    for group in model.plan:
        if group.scan and group.name in new_layers:
            for key, cycles in new_layers[group.name].items():
                new_layers[group.name][key] = [
                    {f: torch.stack([cyc[r][f] for cyc in cycles]) for f in cycles[0][r]}
                    for r in range(len(cycles[0]))
                ]
    return xs, new_layers, new_preds


def _check_mesh(ctx: Ctx) -> None:
    if ctx.xp.n_ranks != ctx.model.n_ranks:
        raise ValueError(f"the plan's mesh {ctx.xp.mesh_sizes} is not the model's "
                         f"{ctx.model.sizes}")


# ==========================================================================
# Phase entry points.
# ==========================================================================
@torch.no_grad()
def forward_prefill(params: list[dict], tokens: torch.Tensor, ctx: Ctx) -> dict:
    """tokens: (B, S) -> {"last_logits": (B, vocab_pad) f32, "overflow",
    "overflow_layers"[, "state"]}.

    Each rank holds its block of rows (``batch_axes``) and its slice of
    the sequence (``seq_axes``, at offset ``seq_index * S / seq_shards``,
    ``_positions_offset`` of the JAX package); a row's last hidden state
    comes from the rank holding its last slice and meets every vocab shard
    (where the batch is sharded over ``model``, the rank's own rows meet
    the gathered head). The captured ``state`` carries its
    ``cache.RingLayout`` under ``"layout"``. ``overflow`` (0-d bool) says a
    route-before-gather layer overflowed its budget and ``overflow_layers``
    (0-d int32) how many did: under ``ctx.deferred`` the outputs are then
    not the exact ones (see :meth:`Ctx.overflowed`)."""
    _check_mesh(ctx)
    xp = ctx.xp
    if ctx.capture_len and not captures_kv(ctx.geom, xp):
        raise ValueError(
            "a DEP prefill runs attention tensor-parallel, which captures no KV "
            "state (as in the JAX package): prefill with mode 'dwdp' or 'hybrid' "
            "to feed a decode state"
        )
    n = ctx.model.n_ranks
    b, s = tokens.shape
    if b % xp.batch_shards or s % xp.seq_shards:
        raise ValueError(f"a ({b}, {s}) prompt batch must divide over the plan's "
                         f"{xp.batch_shards} batch and {xp.seq_shards} sequence shards")
    ctx.begin(tokens.device)
    s_l = s // xp.seq_shards
    ctx.q_offsets = tuple(xp.seq_index(r) * s_l for r in range(n))
    embedded: dict = {}  # ranks holding the same tokens share one embedding
    xs = []
    for r in range(n):
        key = (xp.batch_index(r), xp.seq_index(r))
        if key not in embedded:
            rows, j = ctx.rows(r, b), key[1]
            embedded[key] = _embed(params, tokens[rows, j * s_l:(j + 1) * s_l], ctx.model)
        xs.append(embedded[key])
    del embedded
    xs, new_states, _ = _run_stack(params, xs, ctx, None)
    blocks = []
    for j in range(xp.batch_shards):
        owner = next(r for r in range(n)
                     if xp.batch_index(r) == j and xp.seq_index(r) == xp.seq_shards - 1)
        xl = rms_norm(xs[owner], params[owner]["final_norm"], ctx.cfg.norm_eps)[:, -1]
        blocks.append(torch.cat([_rank_logits(xl, params[m], m, ctx)
                                 for m in range(ctx.geom.model_size)], dim=-1))
    logits = torch.cat(blocks, dim=0)
    out = {"last_logits": logits, "overflow": ctx.overflow,
           "overflow_layers": ctx.overflow_layers}
    if ctx.capture_len:
        out["state"] = {
            "pos": torch.full((b,), s, dtype=torch.int32, device=tokens.device),
            "layers": new_states,
            "layout": RingLayout.of_plan(xp),
        }
    return out


@torch.no_grad()
def forward_decode(params: list[dict], token: torch.Tensor, state: dict, ctx: Ctx) -> dict:
    """token: (B, 1) -> {"next_token": (B, 1), "state", "logits": (B, vocab_pad),
    "overflow", "overflow_layers"[, "pred_stats"][, "fault_stats"]}.

    Each rank holds its block of rows (sharded over ``batch_axes``, the
    data axis; replicated over the model group) and its slice of their KV
    ring (``seq_axes``); it runs the rows through its own banks and
    attends over its slice; the greedy token is the argmax across the
    model group's vocab shards. A batch sharded over ``model`` is refused
    (``ValueError``), as the JAX package asserts. The input state is never
    written (the new state is new tensors), so a step whose deferred
    ``overflow`` is set can run again from the same inputs."""
    _check_mesh(ctx)
    xp = ctx.xp
    if AXIS_MODEL in xp.batch_axes:
        raise ValueError(
            f"a decode batch of {token.shape[0]} rows on the mesh {xp.mesh_sizes} is "
            f"sharded over {xp.batch_axes}: decode keeps its rows replicated over the "
            "vocab-sharded model axis (the JAX package asserts AXIS_MODEL not in "
            "batch_axes), so the batch must not divide over data * model")
    n = ctx.model.n_ranks
    ctx.begin(token.device)
    ctx.pos = state["pos"]
    x = _embed(params, token, ctx.model)
    xs, new_layers, new_preds = _run_stack(
        params, [x[ctx.rows(r, x.shape[0])] for r in range(n)], ctx, state)
    blocks, logit_blocks = [], []
    for j in range(xp.batch_shards):
        first = next(r for r in range(n) if xp.batch_index(r) == j)
        vals, idxs, logits = [], [], []
        for m, r in enumerate(ctx.group(first, ctx.model_axes)):
            h = rms_norm(xs[r], params[r]["final_norm"], ctx.cfg.norm_eps)[:, 0]
            lg = _rank_logits(h, params[r], m, ctx)
            logits.append(lg)
            vals.append(lg.amax(dim=-1))
            idxs.append(lg.argmax(dim=-1) + m * lg.shape[-1])
        best = torch.stack(vals).argmax(dim=0)
        blocks.append(torch.stack(idxs).gather(0, best[None])[0].to(torch.int32))
        logit_blocks.append(torch.cat(logits, dim=-1))
    nxt = torch.cat(blocks)
    new_state = {"pos": state["pos"] + 1, "layers": new_layers}
    out = {"next_token": nxt[:, None], "state": new_state,
           "logits": torch.cat(logit_blocks, dim=0),
           "overflow": ctx.overflow, "overflow_layers": ctx.overflow_layers}
    if fault_stats_active(ctx.model, xp):
        # [injected drop / zero / corrupt / cache, detected, fault
        # fallbacks, mirror divergence, detected by source position...]
        out["fault_stats"] = (ctx.fault_stats if ctx.fault_stats is not None else torch.zeros(
            faults.FAULT_STAT_BASE + ctx.geom.moe_placement.subgroup_size, device=token.device))
    if new_preds:
        new_preds = _fold_mirrors(new_preds, state["pred"], ctx)
        new_state["pred"] = new_preds
        # [predicted, spec_hit, cache_hit, corr_rows, evicted] expert rows
        # this step, summed over layers and ranks
        out["pred_stats"] = sum(
            ps.stats for gd in new_preds.values() for cycles in gd.values()
            for ranks in cycles for ps in ranks
        )
    return out


def _fold_mirrors(new_preds: dict, preds_in: dict, ctx: Ctx) -> dict:
    """The sync-free per-step mirror fold: union every sync-free layer's
    routed bitmaps per rank, exchange them (with the position buckets) in
    one packed all-gather per subgroup, fold each rank's mirror once from
    its pre-step state with :func:`prefetch.update_predictor`, and write
    the folded predictor fields into every sync-free layer's outgoing
    state. No-op when no layer ran sync-free."""
    sf = [
        (gname, pos, c)
        for gname, gd in new_preds.items() for pos, cycles in gd.items()
        for c, ranks in enumerate(cycles) if ranks[0].routed is not None
    ]
    if not sf:
        return new_preds
    pl = ctx.geom.moe_placement
    n = len(new_preds[sf[0][0]][sf[0][1]][sf[0][2]])
    packed = []
    for r in range(n):
        routed = None
        for gname, pos, c in sf:
            rr = new_preds[gname][pos][c][r].routed
            routed = rr if routed is None else routed | rr
        packed.append(prefetch.pack_mirror_payload(
            routed, prefetch.position_buckets(ctx.rank_pos(r))))
    # pre-step mirrors are identical across sync-free layers by
    # construction, so the first layer's incoming state seeds the fold
    g0, p0, c0 = sf[0]
    out = {gname: {pos: [list(r) for r in cycles] for pos, cycles in gd.items()}
           for gname, gd in new_preds.items()}
    for r in range(n):
        gathered = torch.stack([packed[q] for q in prefetch.subgroup_ranks(r, pl)])
        routed_all, buckets_all = prefetch.unpack_mirror_payload(gathered, pl.num_padded)
        m = preds_in[g0][p0][c0][r]
        prev, ema, aff, posb, sig, sigw = prefetch.update_predictor(
            m.ema, m.aff, m.posb, m.sigw, routed_all, buckets_all)
        for gname, pos, c in sf:
            out[gname][pos][c][r] = out[gname][pos][c][r]._replace(
                routed=None, prev=prev, ema=ema, aff=aff, posb=posb, sig=sig, sigw=sigw)
    return out


# ==========================================================================
# Predictive-fetch state lifecycle (decode only).
# ==========================================================================
def init_predict_state(model: Model, xp: ExecutionPlan) -> dict:
    """Cold per-rank :class:`prefetch.PredictState` of every predictive
    MoE layer: ``{group: {posJ: [cycle][rank] PredictState}}``, or ``{}``
    when the plan runs no predictive decode layer (each layer group under
    its own policy). Cold = empty predictor and invalid cache: the first
    step's speculative round fetches nothing and the correction round is
    the plain demand round."""
    cfg, geom = model.cfg, model.geom
    if cfg.moe is None:
        return {}
    pl = geom.moe_placement
    e_pad, gsz = pl.num_padded, pl.subgroup_size
    dm, fe = cfg.d_model, cfg.moe.d_ff
    dev = model.device

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def one_rank(rows: int, sync_free: bool):
        lead = (gsz,) if sync_free else ()
        ps = prefetch.PredictState(
            prev=zeros(*lead, e_pad, dtype=torch.bool),
            ema=zeros(*lead, e_pad),
            cache_ids=zeros(*lead, rows, dtype=torch.int64),
            cache_valid=zeros(*lead, rows, dtype=torch.bool),
            cache={
                "w_gate": zeros(rows, dm, fe, dtype=model.dtype),
                "w_up": zeros(rows, dm, fe, dtype=model.dtype),
                "w_down": zeros(rows, fe, dm, dtype=model.dtype),
            },
            stats=zeros(5),
        )
        if sync_free:
            ps = ps._replace(
                aff=zeros(gsz, max(1, xp.local_batch), e_pad),
                posb=zeros(gsz, prefetch.N_POS_BUCKETS, e_pad),
                sig=zeros(gsz, 2, e_pad),
                sigw=zeros(gsz, 2),
            )
        return ps

    out: dict = {}
    for group in model.plan:
        if not predictive_fetch_active(cfg, geom, xp, group.name):
            continue
        rows = resolve_cache_rows(cfg, geom, xp, group.name)
        sync_free = sync_free_active(cfg, geom, xp, group.name)
        gdict = {
            f"pos{j}": [[one_rank(rows, sync_free) for _ in range(model.n_ranks)]
                        for _ in range(group.n_cycles)]
            for j, sig in enumerate(group.sigs) if sig.is_moe
        }
        if gdict:
            out[group.name] = gdict
    return out


def attach_predict_state(state: dict, model: Model, xp: ExecutionPlan) -> dict:
    """``state`` with a cold ``state["pred"]`` attached when the plan runs
    the predictive fetch (unchanged otherwise)."""
    pred = init_predict_state(model, xp)
    if not pred:
        return state
    return dict(state, pred=pred)
