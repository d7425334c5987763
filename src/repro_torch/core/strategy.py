"""Execution plans: activation sharding and per-family gather policies.

The port of ``repro.core.strategy``: ``GatherPolicy`` / ``PolicyTable``
(the per-family configuration surface — ``moe_experts``, ``attn_qkv``,
``attn_out``, ``dense_ffn`` — with per-layer-group overrides keyed
``"group/family"``), ``ExecutionPlan``, ``plan_activation_sharding``,
``make_execution_plan`` (with the deprecated flat knobs and the fault
arguments: ``fault_spec``, ``validate_fetch``, ``exclude_peers``), the
fault-degradation ladder (:func:`degrade_policy_table`,
:func:`degradation_ladder`), and the roofline-guided resolver of
``policy="auto"`` / ``"auto-online"`` (:func:`resolve_policies`,
:func:`effective_policies`). The port runs the
modes ``dwdp``, ``dep`` and ``hybrid`` (``replicated`` is refused) and every
policy: both layouts (``split``, ``merged``), the three transports
(``allgather``, ``ring``, ``ring_sliced`` with ``num_slices``) and, for
``moe_experts``, the route-before-gather fetches ``demand``,
``predictive`` and ``sync_free`` with their ``budget`` / ``cache_budget``.
Under ``dep`` and ``hybrid`` the experts stay put (an all-to-all moves the
tokens), so an expert fetch other than ``all`` engages nowhere and runs as
the all-to-all, as in the JAX package; DEP's decode gathers attention in
the merged layout whatever the family's layout.

``"auto"`` scores every engine-eligible (layout, fetch) combination of the
families with ``roofline.modeled_step_time`` against a ``Hardware`` entry
(``hw``, default ``roofline.GB200``) at ``weight_bytes`` per weight
(default 1, the paper's), keeps the cheapest, refines ``moe_experts`` per
layer group, sizes a predictive residency cache from the analytic HBM
headroom and picks each family's transport by its remote bank's size
(``ring_sliced`` from :data:`RING_SLICED_MIN_BYTES`) — the JAX package's
rules, on the same inputs the same table.
"""
from __future__ import annotations

import dataclasses
import json
import math
import warnings
from typing import Any, Mapping, Optional, Union

from repro_torch.configs.base import ArchConfig, BlockKind, InputShape

MODES = ("dwdp", "dep", "replicated", "hybrid")
PREFETCH_MODES = ("allgather", "ring", "ring_sliced")
WEIGHT_LAYOUTS = ("merged", "split")
CAPACITY_FROM = ("local", "global")
DECODE_ATTN = ("gather", "qgather")
#: The modes the port runs.
PORTED_MODES = ("dwdp", "dep", "hybrid")
EXPERT_FETCH = ("all", "demand", "predictive", "sync_free")
GATHER_FAMILIES = ("moe_experts", "attn_qkv", "attn_out", "dense_ffn")
#: Mesh axes in rank order, major first.
MESH_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class GatherPolicy:
    """How one gathered-weight family is obtained: ``layout`` (split |
    merged), ``fetch`` (all | demand | predictive | sync_free),
    ``transport`` (allgather | ring | ring_sliced), ``num_slices`` (the
    ring_sliced slice count), ``budget`` and ``cache_budget`` — the JAX
    package's fields and validation."""

    layout: str = "split"
    fetch: str = "all"
    transport: str = "allgather"
    num_slices: int = 4
    budget: int = 0
    cache_budget: int = 0

    def __post_init__(self):
        for value, allowed, what in (
            (self.layout, WEIGHT_LAYOUTS, "layout"),
            (self.fetch, EXPERT_FETCH, "fetch"),
            (self.transport, PREFETCH_MODES, "transport"),
        ):
            if value not in allowed:
                raise ValueError(f"unknown {what} {value!r}; expected one of {allowed}")
        if self.fetch != "all" and self.layout != "split":
            raise ValueError(f'fetch="{self.fetch}" requires the split layout')
        if self.num_slices < 1:
            raise ValueError(f"num_slices must be >= 1, got {self.num_slices}")
        if self.budget < 0 or self.cache_budget < 0:
            raise ValueError("budget and cache_budget must be >= 0")
        if self.cache_budget and self.fetch not in ("predictive", "sync_free"):
            raise ValueError("cache_budget only applies to the predictive/sync_free fetch")

    @classmethod
    def parse(cls, spec: Union[str, "GatherPolicy", Mapping]) -> "GatherPolicy":
        """``"layout[:fetch[:transport[:num_slices[:budget[:cache_budget]]]]]"``
        (the ``--policy`` spec), a kwargs mapping, or a policy passed
        through; unknown values raise ``ValueError``."""
        if isinstance(spec, GatherPolicy):
            return spec
        if isinstance(spec, Mapping):
            extra = set(spec) - {f.name for f in dataclasses.fields(cls)}
            if extra:
                raise ValueError(f"unknown GatherPolicy fields {sorted(extra)}")
            return cls(**spec)
        parts = str(spec).split(":")
        if not 1 <= len(parts) <= 6 or not all(parts):
            raise ValueError(f"bad policy spec {spec!r}; expected layout[:fetch[:transport"
                             "[:num_slices[:budget[:cache_budget]]]]]")
        kw: dict = dict(zip(("layout", "fetch", "transport"), parts[:3]))
        try:
            kw.update(zip(("num_slices", "budget", "cache_budget"), map(int, parts[3:])))
        except ValueError:
            raise ValueError(f"bad policy spec {spec!r}: num_slices/budget/cache_budget "
                             "must be ints") from None
        return cls(**kw)

    def spec(self) -> str:
        """``layout:fetch:transport[:num_slices][:budget][:cache_budget]``
        (``parse(spec()) == self``)."""
        s = f"{self.layout}:{self.fetch}:{self.transport}"
        if self.num_slices != 4 or self.budget != 0 or self.cache_budget != 0:
            s += f":{self.num_slices}"
        if self.budget != 0 or self.cache_budget != 0:
            s += f":{self.budget}"
        if self.cache_budget != 0:
            s += f":{self.cache_budget}"
        return s


def _check_family(name: str, *, allow_default: bool = True) -> None:
    ok = GATHER_FAMILIES + (("default",) if allow_default else ())
    if name not in ok:
        raise ValueError(f"unknown gather family {name!r}; expected one of {ok}")


def _check_fetch_applies(family: str, pol: GatherPolicy) -> None:
    if pol.fetch != "all" and family not in ("moe_experts", "default"):
        raise ValueError(f'fetch="{pol.fetch}" only applies to the moe_experts family; '
                         f"got it for {family!r}")


@dataclasses.dataclass(frozen=True)
class PolicyTable:
    """Per-family, optionally per-layer-group, gather policies. Lookup
    order of ``family(name, group)``: the ``(group, name)`` override, then
    the ``name`` entry, then ``default``."""

    default: GatherPolicy = GatherPolicy()
    families: tuple[tuple[str, GatherPolicy], ...] = ()
    overrides: tuple[tuple[str, str, GatherPolicy], ...] = ()

    def __post_init__(self):
        seen: set = set()
        for name, pol in self.families:
            _check_family(name, allow_default=False)
            _check_fetch_applies(name, pol)
            if name in seen:
                raise ValueError(f"duplicate family entry {name!r}")
            seen.add(name)
        _check_fetch_applies("default", self.default)
        oseen: set = set()
        for group, name, pol in self.overrides:
            _check_family(name, allow_default=False)
            _check_fetch_applies(name, pol)
            if (group, name) in oseen:
                raise ValueError(f"duplicate override {(group, name)!r}")
            oseen.add((group, name))

    def family(self, name: str, group: Optional[str] = None) -> GatherPolicy:
        """The policy of family ``name``, within layer group ``group`` when
        given."""
        _check_family(name)
        if group is not None:
            for g, n, pol in self.overrides:
                if g == group and n == name:
                    return pol
        for n, pol in self.families:
            if n == name:
                return pol
        return self.default

    @classmethod
    def uniform(cls, *, layout: str = "split", fetch: str = "all",
                transport: str = "allgather", num_slices: int = 4,
                budget: int = 0, cache_budget: int = 0) -> "PolicyTable":
        """One policy for every family (an expert fetch applies to
        ``moe_experts`` only): what the deprecated flat knobs express."""
        pol = GatherPolicy(layout=layout, fetch=fetch, transport=transport,
                           num_slices=num_slices, budget=budget,
                           cache_budget=cache_budget)
        if pol.fetch != "all":
            return cls(
                default=dataclasses.replace(pol, fetch="all", budget=0, cache_budget=0),
                families=(("moe_experts", pol),),
            )
        return cls(default=pol)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PolicyTable":
        """A table from ``{family | "default" | "group/family": spec}``, each
        spec a string (:meth:`GatherPolicy.parse`), a kwargs mapping or a
        policy: the ``--policy-file`` JSON shape."""
        default = GatherPolicy()
        fams: list = []
        overrides: list = []
        for key, spec in d.items():
            pol = GatherPolicy.parse(spec)
            if key == "default":
                default = pol
            elif "/" in key:
                group, name = key.split("/", 1)
                overrides.append((group, name, pol))
            else:
                fams.append((key, pol))
        return cls(default=default, families=tuple(fams), overrides=tuple(overrides))

    def to_dict(self) -> dict:
        """JSON-able round-trip form (``from_dict(to_dict()) == self``)."""
        out = {"default": self.default.spec()}
        for name, pol in self.families:
            out[name] = pol.spec()
        for group, name, pol in self.overrides:
            out[f"{group}/{name}"] = pol.spec()
        return out

    def describe(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)


PolicyLike = Union[None, str, Mapping, GatherPolicy, PolicyTable]
#: The policy literals of the roofline resolver: ``"auto-online"`` resolves
#: as ``"auto"`` in a plan; a serving engine's ``OnlinePolicyScheduler``
#: re-resolves it between decode steps.
AUTO_POLICIES = ("auto", "auto-online")

#: The resolver's transport rule: ``ring_sliced`` for a family whose remote
#: bank per layer reaches this many bytes (the §4.3 TDM regime), else
#: ``allgather``.
RING_SLICED_MIN_BYTES = 32 << 20

#: The share of the analytic HBM headroom the predictive fetch's residency
#: cache may take (the rest is left for the allocator).
CACHE_HEADROOM_FRAC = 0.5


def _coerce_policy(policy: PolicyLike) -> Optional[PolicyTable]:
    """A :class:`PolicyTable` from a table, a policy, a per-family mapping or
    a spec string; ``None`` for ``"auto"`` / ``"auto-online"``, which need
    the model, shape and mesh (:func:`resolve_policies`)."""
    if policy is None:
        return PolicyTable()
    if isinstance(policy, PolicyTable):
        return policy
    if isinstance(policy, GatherPolicy):
        return PolicyTable(default=policy)
    if isinstance(policy, Mapping):
        return PolicyTable.from_dict(policy)
    if isinstance(policy, str):
        if policy in AUTO_POLICIES:
            return None
        return PolicyTable(default=GatherPolicy.parse(policy))
    raise TypeError(f"cannot build a PolicyTable from {policy!r}")


def resolve_policy(policy: PolicyLike = None, *, weight_layout: Optional[str] = None,
                   expert_fetch: Optional[str] = None, prefetch: Optional[str] = None,
                   num_slices: Optional[int] = None, demand_budget: Optional[int] = None,
                   cache_budget: Optional[int] = None) -> Union[PolicyTable, str]:
    """One policy table from either spelling (``_resolve_policy`` of the
    JAX package): an explicit ``policy`` wins (:func:`_coerce_policy`; the
    ``"auto"`` / ``"auto-online"`` literals pass through for
    :func:`resolve_policies`); otherwise the flat knobs spell a uniform
    table, each left at ``None`` taking the default (split, all, allgather,
    4 slices, budgets 0). The servers, the command line and
    ``make_execution_plan``'s deprecated knobs all build their uniform
    table here."""
    if policy is not None:
        return _coerce_policy(policy) or policy  # "auto" / "auto-online" pass through
    knobs = dict(layout=weight_layout, fetch=expert_fetch, transport=prefetch,
                 num_slices=num_slices, budget=demand_budget, cache_budget=cache_budget)
    return PolicyTable.uniform(**{k: v for k, v in knobs.items() if v is not None})


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    mode: str                        # dwdp | dep | hybrid
    phase: str                       # prefill | decode
    batch_axes: tuple[str, ...]
    seq_axes: tuple[str, ...]
    mesh_sizes: dict[str, int]
    capacity_factor: float
    global_batch: int
    seq_len: int
    policies: PolicyTable = PolicyTable()
    # decode attention over sharded weights: "gather" the weights each
    # layer, or "qgather": keep them sharded and move q/k/v instead
    decode_attn: str = "gather"
    capacity_from: str = "local"
    # a core.faults.FaultSpec injected into the route-before-gather fetch
    # rounds (None: no injection); it implies validate_fetch
    fault_spec: Optional[Any] = None
    # checksum-validate every fetched and cached expert row (without
    # injection: the production hardening switch); faulty rows are masked
    # invalid and repaired through the correction round or the full-gather
    # fallback, so outputs stay bitwise exact, and each decode step reports
    # its fault counters ("fault_stats")
    validate_fetch: bool = False
    # subgroup positions dropped from the speculative plan and the sync-free
    # cache bookkeeping (the degradation ladder's "+excl" rung): their rows
    # ride the validated correction round
    exclude_peers: tuple = ()

    @property
    def validated(self) -> bool:
        """Does the route-before-gather fetch validate its payloads
        (checksums, verification, repair, fault counters)?"""
        return self.fault_spec is not None or self.validate_fetch

    def policy(self, family: str, group: Optional[str] = None) -> GatherPolicy:
        """The policy of ``family`` (within layer group ``group``)."""
        return self.policies.family(family, group)

    @property
    def batch_shards(self) -> int:
        return math.prod(self.mesh_sizes[a] for a in self.batch_axes)

    @property
    def seq_shards(self) -> int:
        return math.prod(self.mesh_sizes[a] for a in self.seq_axes)

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.batch_shards

    @property
    def local_seq(self) -> int:
        return self.seq_len // self.seq_shards

    # ---- the logical ranks (one per mesh coordinate, ``rank_coords``) ----
    @property
    def n_ranks(self) -> int:
        return math.prod(self.mesh_sizes.values())

    def shard_index(self, axes: tuple[str, ...], rank: int) -> int:
        """``rank``'s shard over ``axes`` (:func:`shard_index`)."""
        return shard_index(self.mesh_sizes, axes, rank)

    def batch_index(self, rank: int) -> int:
        """Which block of ``local_batch`` rows ``rank`` holds."""
        return self.shard_index(self.batch_axes, rank)

    def seq_index(self, rank: int) -> int:
        """Which block of ``local_seq`` positions (and of the KV ring)
        ``rank`` holds."""
        return self.shard_index(self.seq_axes, rank)

    def group(self, rank: int, axes: tuple[str, ...]) -> list[int]:
        """The ranks that differ from ``rank`` only on ``axes``, in shard
        order over ``axes``: the members of a collective over ``axes``
        (the model group of a data replica, the sequence shards of a row
        block)."""
        return rank_group(self.mesh_sizes, rank, axes)


def mesh_axes(mesh_sizes: Mapping[str, int]) -> tuple[str, ...]:
    """The mesh's axes in rank order, major first (``MESH_AXES``)."""
    unknown = set(mesh_sizes) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; expected {MESH_AXES}")
    return tuple(a for a in MESH_AXES if a in mesh_sizes)


def rank_coords(mesh_sizes: Mapping[str, int], rank: int) -> dict[str, int]:
    """Mesh coordinates of logical rank ``rank``: ranks are numbered row-major
    over ``MESH_AXES`` (on a ``(data, model)`` mesh ``rank = d * G + m``),
    the order of the JAX package's device mesh."""
    coords = {}
    for a in reversed(mesh_axes(mesh_sizes)):
        coords[a] = rank % mesh_sizes[a]
        rank //= mesh_sizes[a]
    return coords


def shard_index(mesh_sizes: Mapping[str, int], axes: tuple[str, ...], rank: int) -> int:
    """``rank``'s shard over ``axes`` (``_shard_index`` of the JAX package:
    the axes' coordinates, the first one major)."""
    coords = rank_coords(mesh_sizes, rank)
    idx = 0
    for a in axes:
        idx = idx * mesh_sizes[a] + coords[a]
    return idx


def rank_group(mesh_sizes: Mapping[str, int], rank: int, axes: tuple[str, ...]) -> list[int]:
    """The ranks whose coordinates equal ``rank``'s off ``axes``, ordered by
    their shard index over ``axes`` (the first axis major)."""
    order = mesh_axes(mesh_sizes)
    coords = rank_coords(mesh_sizes, rank)
    members = []
    for idx in range(math.prod(mesh_sizes[a] for a in axes)):
        c = dict(coords)
        for a in reversed(axes):
            c[a] = idx % mesh_sizes[a]
            idx //= mesh_sizes[a]
        r = 0
        for a in order:
            r = r * mesh_sizes[a] + c[a]
        members.append(r)
    return members


def plan_activation_sharding(
    cfg: ArchConfig, shape: InputShape, mesh_sizes: dict[str, int]
) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """Greedy: batch over (pod, data, model) while divisible; remaining
    axes shard the sequence / KV cache if divisible (the JAX package's
    rule, ``strategy.py:538``)."""
    order = [a for a in ("pod", "data", "model") if mesh_sizes.get(a, 1) > 1]
    batch_axes: list[str] = []
    rem = shape.global_batch
    for a in order:
        if rem % mesh_sizes[a] == 0:
            batch_axes.append(a)
            rem //= mesh_sizes[a]
        else:
            break
    left = [a for a in order if a not in batch_axes]
    seq_axes: list[str] = []
    can_seq_shard = not any(
        k in (BlockKind.SLSTM, BlockKind.MLSTM) for k in cfg.block_pattern
    )
    if can_seq_shard:
        s = shape.seq_len
        for a in left:
            if s % mesh_sizes[a] == 0:
                seq_axes.append(a)
                s //= mesh_sizes[a]
            else:
                break
    return tuple(batch_axes), tuple(seq_axes)


# --------------------------------------------------------------------------
# The roofline-guided "auto" resolver.
# --------------------------------------------------------------------------
def _routed_rows(shape: InputShape, batch_shards: int, seq_shards: int) -> int:
    """Per-rank routed token count (``execution._routed_tokens``)."""
    lb = max(1, shape.global_batch // max(1, batch_shards))
    if shape.phase == "decode":
        return lb
    return lb * max(1, shape.seq_len // max(1, seq_shards))


def _family_remote_bank_bytes(cfg: ArchConfig, geom, family: str, fetch: str, budget: int,
                              weight_bytes: int, routed_rows: int = 1) -> float:
    """Per-layer remote-bank bytes of one family: the transport rule's input
    (a representative layer; ``dense_ffn`` takes the largest FFN width).
    The per-step accounting the serving metrics report is
    ``execution.gathered_wire_bytes_per_step``."""
    from repro_torch.core.budget import demand_budget_rows, predictive_budget_rows

    d = cfg.d_model

    def frac(shards: int) -> float:
        return (shards - 1) / shards if shards > 1 else 0.0

    if family == "moe_experts" and cfg.moe is not None and geom.moe_placement:
        pl = geom.moe_placement
        pe = 3 * d * cfg.moe.d_ff * weight_bytes
        rows = (pl.subgroup_size - 1) * pl.local_count
        if fetch == "demand":
            b = budget or demand_budget_rows(routed_rows * cfg.moe.top_k, cfg.moe.num_experts,
                                             pl.local_count)
            rows = (pl.subgroup_size - 1) * min(b, pl.local_count)
        elif fetch in ("predictive", "sync_free"):
            if budget > 0:
                spec = corr = min(budget, pl.local_count)
            else:
                spec, corr = predictive_budget_rows(routed_rows * cfg.moe.top_k,
                                                    cfg.moe.num_experts, pl.local_count)
            rows = (pl.subgroup_size - 1) * (spec + corr)
        return rows * pe
    if family == "attn_qkv":
        return d * (cfg.q_dim + 2 * cfg.kv_dim) * weight_bytes * frac(geom.attn_shards)
    if family == "attn_out":
        return cfg.q_dim * d * weight_bytes * frac(geom.attn_shards)
    if family == "dense_ffn":
        f = cfg.d_ff or 0
        if cfg.moe is not None:
            f = max(f, cfg.moe.shared_d_ff, cfg.moe.dense_d_ff)
        return 3 * d * f * weight_bytes * frac(geom.ffn_shards)
    return 0.0


@dataclasses.dataclass(frozen=True)
class _Eligibility:
    """Which per-family paths the engine can run on a (model, shape, mesh),
    from the engine's own predicates: one computation shared by the
    resolver and :func:`effective_policies`."""

    rows: int            # per-rank routed tokens (the demand gate's input)
    moe_gather: bool     # gather-mode MoE over a real subgroup
    moe_split_ok: bool   # and a single expert axis (split / demand eligible)
    demand_ok: bool      # and partial coverage (rows * top_k < remote experts)
    attn_ok: bool        # the attention families can land split
    ffn_ok: bool         # the dense-FFN family can land split


def _engine_eligibility(model, shape: InputShape, mesh_sizes: dict[str, int]) -> _Eligibility:
    cfg, geom = model.cfg, model.geom
    batch_axes, seq_axes = plan_activation_sharding(cfg, shape, mesh_sizes)
    bsh = math.prod(mesh_sizes[a] for a in batch_axes) if batch_axes else 1
    ssh = math.prod(mesh_sizes[a] for a in seq_axes) if seq_axes else 1
    rows = _routed_rows(shape, bsh, ssh)
    pl = geom.moe_placement
    moe_gather = (cfg.moe is not None and geom.moe_exec == "gather"
                  and pl is not None and pl.subgroup_size > 1)
    moe_split_ok = moe_gather and len(geom.expert_axes) == 1
    demand_ok = (moe_split_ok
                 and rows * cfg.moe.top_k < (pl.subgroup_size - 1) * pl.local_count)
    return _Eligibility(
        rows=rows, moe_gather=moe_gather, moe_split_ok=moe_split_ok, demand_ok=demand_ok,
        attn_ok=len(geom.attn_axes) == 1 and geom.attn_shards > 1,
        ffn_ok=len(geom.ffn_axes) == 1 and geom.ffn_shards > 1,
    )


def _auto_cache_rows(model, shape: InputShape, mesh_sizes: dict[str, int], hw,
                     weight_bytes: int) -> int:
    """The predictive fetch's ``cache_budget``: ``CACHE_HEADROOM_FRAC`` of
    the HBM that ``analysis.residency.analytic_residency_bytes`` leaves free
    on ``hw``, over the MoE layers, in expert rows, 8-aligned, at most the
    remote bank; 0 (cache off) when the plan already fills the device."""
    from repro_torch.analysis.residency import analytic_residency_bytes
    from repro_torch.core import roofline

    cfg, geom = model.cfg, model.geom
    pl = geom.moe_placement
    if cfg.moe is None or pl is None:
        return 0
    hw = hw or roofline.GB200
    batch_axes, seq_axes = plan_activation_sharding(cfg, shape, mesh_sizes)
    xp = ExecutionPlan(
        mode="dwdp", phase=shape.phase, batch_axes=batch_axes, seq_axes=seq_axes,
        mesh_sizes=dict(mesh_sizes), capacity_factor=1.25, global_batch=shape.global_batch,
        seq_len=shape.seq_len, policies=PolicyTable.uniform(fetch="predictive"),
    )
    resident = analytic_residency_bytes(cfg, geom, xp, shape, dtype_bytes=weight_bytes)
    headroom = max(0.0, hw.hbm_bytes - resident) * CACHE_HEADROOM_FRAC
    n_moe = sum(cfg.is_moe_layer(l) for l in range(cfg.num_layers))
    per_expert = 3 * cfg.d_model * cfg.moe.d_ff * weight_bytes
    rows = int(headroom / max(1, n_moe * per_expert))
    remote = (pl.subgroup_size - 1) * pl.local_count
    return min(remote, rows // 8 * 8)


def resolve_policies(model, shape: InputShape, mesh_sizes: dict[str, int],
                     policy: PolicyLike = "auto", *, hw=None, weight_bytes: int = 1,
                     hit_rates: Optional[Mapping] = None) -> PolicyTable:
    """A concrete :class:`PolicyTable` from a ``policy=`` argument. Explicit
    tables, mappings and specs pass through (validated), ``None`` gives the
    uniform default, and ``"auto"`` / ``"auto-online"`` run the roofline
    resolver on ``hw`` (default ``roofline.GB200``) at ``weight_bytes``:

    - it enumerates the engine-eligible ``moe_experts`` (layout, fetch)
      candidates — ``sync_free`` and ``predictive`` at decode, ``demand`` at
      partial coverage, split ``all`` where the split path runs, merged
      ``all`` always, the cheaper first so ties keep them — and ``split`` /
      ``merged`` for ``attn_qkv``, ``attn_out`` and ``dense_ffn``, scores
      every combination with ``roofline.modeled_step_time`` at the per-rank
      routed rows and keeps the cheapest; predictive candidates carry a
      residency cache sized by :func:`_auto_cache_rows`;
    - then, layer group by layer group, it keeps a ``moe_experts`` override
      where the whole table's modeled time strictly drops — with
      ``hit_rates`` (``{group: {"predict_hit": r, "cache_hit": r}}``, the
      measured rates the online scheduler replays) in place of the closed
      forms;
    - and gives each family ``ring_sliced`` where its remote bank reaches
      :data:`RING_SLICED_MIN_BYTES`, else ``allgather``."""
    table = _coerce_policy(policy)
    if table is not None:
        return table

    from repro_torch.core import roofline

    cfg, geom = model.cfg, model.geom
    hw = hw or roofline.GB200
    elig = _engine_eligibility(model, shape, mesh_sizes)
    rows = tokens = elig.rows
    pl = geom.moe_placement
    group = pl.subgroup_size if elig.moe_gather else max(geom.attn_shards, geom.ffn_shards, 1)
    predictive_ok = elig.demand_ok and shape.phase == "decode"
    moe_cands = [("split", "sync_free"), ("split", "predictive")] if predictive_ok else []
    if elig.demand_ok:
        moe_cands.append(("split", "demand"))
    if elig.moe_split_ok:
        moe_cands.append(("split", "all"))
    moe_cands.append(("merged", "all"))
    cache_rows = (_auto_cache_rows(model, shape, mesh_sizes, hw, weight_bytes)
                  if predictive_ok else 0)

    def dense_cands(ok: bool) -> list[str]:
        return (["split"] if ok else []) + ["merged"]

    attn_gathered = bool(geom.attn_axes)
    ph_map = ch_map = None
    if hit_rates:
        ph_map = {g: float(r["predict_hit"]) for g, r in hit_rates.items()
                  if r.get("predict_hit") is not None} or None
        ch_map = {g: float(r["cache_hit"]) for g, r in hit_rates.items()
                  if r.get("cache_hit") is not None} or None

    def score(tab: PolicyTable) -> float:
        return roofline.modeled_step_time(
            cfg, tokens=tokens, group=group, hw=hw, policies=tab, kv_len=shape.seq_len,
            attn_gathered=attn_gathered, weight_bytes=weight_bytes,
            cache_hit=ch_map, predict_hit=ph_map,
        )

    def moe_policy(layout: str, fetch: str) -> GatherPolicy:
        return GatherPolicy(layout=layout, fetch=fetch,
                            cache_budget=cache_rows if fetch in ("predictive", "sync_free") else 0)

    best, best_t = None, float("inf")
    for moe_layout, fetch in moe_cands:
        moe_pol = moe_policy(moe_layout, fetch)
        for qkv_layout in dense_cands(elig.attn_ok):
            for out_layout in dense_cands(elig.attn_ok):
                for ffn_layout in dense_cands(elig.ffn_ok):
                    cand = PolicyTable(
                        default=GatherPolicy(layout=ffn_layout),
                        families=(("moe_experts", moe_pol),
                                  ("attn_qkv", GatherPolicy(layout=qkv_layout)),
                                  ("attn_out", GatherPolicy(layout=out_layout)),
                                  ("dense_ffn", GatherPolicy(layout=ffn_layout))),
                    )
                    t = score(cand)
                    if t < best_t:
                        best, best_t = cand, t

    # per-layer-group moe_experts overrides, kept on a strict improvement
    if cfg.moe is not None and pl is not None and len(moe_cands) > 1:
        gnames = roofline.layer_group_names(cfg)
        moe_groups = sorted({gnames[l] for l in range(cfg.num_layers) if cfg.is_moe_layer(l)})
        overrides: list[tuple[str, str, GatherPolicy]] = []
        for gname in moe_groups:
            chosen = None
            for moe_layout, fetch in moe_cands:
                pol = moe_policy(moe_layout, fetch)
                if pol == best.family("moe_experts"):
                    continue
                cand = dataclasses.replace(
                    best, overrides=tuple(overrides) + ((gname, "moe_experts", pol),))
                t = score(cand)
                if t < best_t:
                    chosen, best_t = (gname, "moe_experts", pol), t
            if chosen is not None:
                overrides.append(chosen)
        if overrides:
            best = dataclasses.replace(best, overrides=tuple(overrides))

    def with_transport(name: str, pol: GatherPolicy) -> GatherPolicy:
        bank = _family_remote_bank_bytes(cfg, geom, name, pol.fetch, pol.budget, weight_bytes,
                                         routed_rows=rows)
        return dataclasses.replace(
            pol, transport="ring_sliced" if bank >= RING_SLICED_MIN_BYTES else "allgather")

    fams = tuple((name, with_transport(name, pol)) for name, pol in best.families)
    ovr = tuple((g, name, with_transport(name, pol)) for g, name, pol in best.overrides)
    return dataclasses.replace(best, families=fams, overrides=ovr)


def effective_policies(model, shape: InputShape, mesh_sizes: dict[str, int],
                       table: PolicyTable) -> PolicyTable:
    """``table`` demoted to what the engine runs on this (model, shape,
    mesh): ``split`` to ``merged`` where a family cannot land split,
    ``predictive`` / ``sync_free`` to ``demand`` outside decode, and any
    expert fetch to ``all`` outside partial coverage — the honest table to
    price a user's policy with. Per-group overrides demote alike."""
    elig = _engine_eligibility(model, shape, mesh_sizes)

    def demote(name: str, pol: GatherPolicy) -> GatherPolicy:
        ok = {"moe_experts": elig.moe_split_ok, "attn_qkv": elig.attn_ok,
              "attn_out": elig.attn_ok, "dense_ffn": elig.ffn_ok}[name]
        layout = pol.layout if (pol.layout == "merged" or ok) else "merged"
        fetch = pol.fetch if name == "moe_experts" else "all"
        if fetch in ("predictive", "sync_free") and shape.phase != "decode":
            fetch = "demand"
        if fetch != "all" and not elig.demand_ok:
            fetch = "all"
        if fetch == "all":
            return GatherPolicy(layout=layout, transport=pol.transport, num_slices=pol.num_slices)
        return dataclasses.replace(
            pol, layout=layout, fetch=fetch,
            cache_budget=pol.cache_budget if fetch in ("predictive", "sync_free") else 0)

    fams = tuple((name, demote(name, table.family(name))) for name in GATHER_FAMILIES)
    ovr = tuple((g, name, demote(name, pol)) for g, name, pol in table.overrides)
    return PolicyTable(default=table.default, families=fams, overrides=ovr)


def make_execution_plan(
    model,
    shape: InputShape,
    mesh_sizes: dict[str, int],
    *,
    mode: str = "dwdp",
    policy: PolicyLike = None,
    capacity_factor: float = 1.25,
    decode_attn: str = "gather",
    capacity_from: str = "local",
    hw=None,
    weight_bytes: int = 1,
    fault_spec=None,
    validate_fetch: bool = False,
    exclude_peers: tuple = (),
    # -- deprecated flat knobs (build a uniform PolicyTable) --------------
    prefetch: Optional[str] = None,
    num_slices: Optional[int] = None,
    weight_layout: Optional[str] = None,
    expert_fetch: Optional[str] = None,
    demand_budget: Optional[int] = None,
    moe_ffn: Optional[str] = None,
) -> ExecutionPlan:
    """The plan of one phase and shape. ``policy`` is a table, a policy, a
    per-family mapping (``"group/family"`` keys scope an override to a
    layer group of the model: ``prefix``, ``body``, ``suffix``), a spec
    string, or ``"auto"`` / ``"auto-online"``, resolved for ``hw`` (default
    ``roofline.GB200``) at ``weight_bytes`` per weight (default 1) by
    :func:`resolve_policies`; the deprecated flat knobs build a uniform
    table instead (a ``DeprecationWarning``; conflicting with ``policy`` or
    with each other is a ``ValueError``), as in the JAX package.
    ``fault_spec`` (a ``faults.FaultSpec`` or its ``--fault-spec`` string)
    injects faults into the fetch rounds and implies ``validate_fetch``;
    ``exclude_peers`` names the subgroup positions of the ladder's
    exclusion rung."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if mode not in PORTED_MODES:
        raise NotImplementedError(f"mode {mode!r} is not ported yet (only {PORTED_MODES})")
    if decode_attn not in DECODE_ATTN:
        raise ValueError(f"decode_attn must be one of {DECODE_ATTN}, got {decode_attn!r}")
    if capacity_from not in CAPACITY_FROM:
        raise ValueError(f"capacity_from must be one of {CAPACITY_FROM}")
    legacy = {k: v for k, v in dict(
        prefetch=prefetch, num_slices=num_slices, weight_layout=weight_layout,
        expert_fetch=expert_fetch, demand_budget=demand_budget, moe_ffn=moe_ffn,
    ).items() if v is not None}
    if legacy:
        warnings.warn(
            f"{', '.join(sorted(legacy))}= are deprecated flat knobs (moe_ffn is the first "
            "spelling of weight_layout) — pass policy= (a PolicyTable / per-family dict / spec "
            "string) instead; building a uniform PolicyTable",
            DeprecationWarning, stacklevel=2)
        if policy is not None:
            raise ValueError(f"conflicting policy= and deprecated flat knobs {sorted(legacy)} "
                             "— pass only policy=")
        if "moe_ffn" in legacy:
            wl = legacy.get("weight_layout")
            if wl is not None and wl != legacy["moe_ffn"]:
                raise ValueError(f"conflicting weight_layout={wl!r} and deprecated "
                                 f"moe_ffn={legacy['moe_ffn']!r} — pass only weight_layout "
                                 "(or better, policy=)")
            legacy.setdefault("weight_layout", legacy.pop("moe_ffn"))
        policy = resolve_policy(None, **legacy)
    table = resolve_policies(model, shape, mesh_sizes, policy, hw=hw, weight_bytes=weight_bytes)
    known_groups = {g.name for g in model.plan}
    for g, fam, _ in table.overrides:
        if g not in known_groups:
            raise ValueError(f"policy override names unknown layer group {g!r} (for family "
                             f"{fam!r}); this model's groups are {sorted(known_groups)}")
    if isinstance(fault_spec, str):
        from repro_torch.core.faults import FaultSpec

        fault_spec = FaultSpec.parse(fault_spec)
    batch_axes, seq_axes = plan_activation_sharding(model.cfg, shape, mesh_sizes)
    xp = ExecutionPlan(
        mode=mode,
        phase=shape.phase,
        batch_axes=batch_axes,
        seq_axes=seq_axes,
        mesh_sizes=dict(mesh_sizes),
        capacity_factor=capacity_factor,
        global_batch=shape.global_batch,
        seq_len=shape.seq_len,
        policies=table,
        decode_attn=decode_attn,
        capacity_from=capacity_from,
        fault_spec=fault_spec,
        validate_fetch=bool(validate_fetch),
        exclude_peers=tuple(int(p) for p in exclude_peers),
    )
    from repro_torch.core.execution import check_fp8_plan  # execution imports this module

    check_fp8_plan(model, xp)
    return xp


# --------------------------------------------------------------------------
# The fault-degradation ladder.
# --------------------------------------------------------------------------
#: Expert fetches from the most aggressive (most per-peer payload rounds,
#: most fetch savings, most exposure to peer faults) to the least. The
#: ``HealthMonitor`` demotes a serving table down this ladder when a peer
#: turns persistently bad and promotes it back on recovery.
_FETCH_RANK = {"sync_free": 0, "predictive": 1, "demand": 2, "all": 3}


def degrade_policy_table(table: PolicyTable, fetch: str) -> PolicyTable:
    """``table`` with every entry whose expert fetch is more aggressive than
    ``fetch`` rewritten down to ``fetch`` (entries at or below it are
    untouched): demotion to ``"demand"`` drops the residency cache,
    demotion to ``"all"`` the demand budget too, keeping layout and
    transport."""
    if fetch not in _FETCH_RANK:
        raise ValueError(f"unknown fetch {fetch!r}; expected one of {tuple(_FETCH_RANK)}")

    def demote(pol: GatherPolicy) -> GatherPolicy:
        if _FETCH_RANK[pol.fetch] >= _FETCH_RANK[fetch]:
            return pol
        if fetch == "all":
            return GatherPolicy(layout=pol.layout, transport=pol.transport,
                                num_slices=pol.num_slices)
        return dataclasses.replace(pol, fetch=fetch, cache_budget=0)

    return PolicyTable(
        default=demote(table.default),
        families=tuple((n, demote(p)) for n, p in table.families),
        overrides=tuple((g, n, demote(p)) for g, n, p in table.overrides),
    )


def degradation_ladder(table: PolicyTable) -> tuple:
    """The fault-degradation ladder of a resolved table: ``((label, table,
    exclude_peers), ...)`` from level 0 (as configured) down to the
    all-gather floor and the terminal ``"reshard"`` rung, no-op levels
    collapsed; labels name the expert fetch each level runs. A predictive
    or sync-free root gets a ``"<fetch>+excl"`` rung right below it: the
    same table with the bad peers left out of the speculative plan and the
    cache bookkeeping (``None``: the engine names the peers, from its
    ``HealthMonitor``, when it steps onto the rung). ``"reshard"`` runs the
    all-gather table over the survivors of a rank death; fail-silent
    demotions stop above it."""
    root_fetch = table.family("moe_experts").fetch
    out: list = [(root_fetch, table, ())]
    if root_fetch in ("predictive", "sync_free"):
        out.append((f"{root_fetch}+excl", table, None))
    for fetch in ("demand", "all"):
        t = degrade_policy_table(table, fetch)
        if t != out[-1][1]:
            out.append((fetch, t, ()))
    out.append(("reshard", degrade_policy_table(table, "all"), ()))
    return tuple(out)
