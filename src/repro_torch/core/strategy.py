"""Execution plans: activation sharding and per-family gather policies.

The port of the parts of ``repro.core.strategy`` the forward reads:
``GatherPolicy`` / ``PolicyTable`` (the per-family configuration surface
— ``moe_experts``, ``attn_qkv``, ``attn_out``, ``dense_ffn`` — with
per-layer-group overrides keyed ``"group/family"``), ``ExecutionPlan``,
``plan_activation_sharding`` and ``make_execution_plan`` (with the
deprecated flat knobs). The port runs the modes ``dwdp``, ``dep`` and
``hybrid`` (``replicated`` is refused) and every explicit policy: both
layouts (``split``, ``merged``), the three transports (``allgather``,
``ring``, ``ring_sliced`` with ``num_slices``) and, for ``moe_experts``,
the route-before-gather fetches ``demand``, ``predictive`` and
``sync_free`` with their ``budget`` / ``cache_budget``. The roofline
``"auto"`` / ``"auto-online"`` resolver is not ported: asking for it
raises ``NotImplementedError``. Under ``dep`` and ``hybrid`` the experts
stay put (an all-to-all moves the tokens), so an expert fetch other than
``all`` engages nowhere and runs as the all-to-all, as in the JAX
package; DEP's decode gathers attention in the merged layout whatever the
family's layout.
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
#: The policy literals of the JAX package's roofline resolver, not ported.
AUTO_POLICIES = ("auto", "auto-online")


def _coerce_policy(policy: PolicyLike) -> PolicyTable:
    """A :class:`PolicyTable` from a table, a policy, a per-family mapping or
    a spec string; ``"auto"`` / ``"auto-online"`` raise
    ``NotImplementedError`` (the roofline cost model is not ported)."""
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
            raise NotImplementedError(
                f"policy {policy!r} needs the JAX package's roofline cost model "
                "(repro.core.roofline: modeled_step_time and the resolver over it), which is "
                "not ported; pass an explicit policy table")
        return PolicyTable(default=GatherPolicy.parse(policy))
    raise TypeError(f"cannot build a PolicyTable from {policy!r}")


def resolve_policy(policy: PolicyLike = None, *, weight_layout: Optional[str] = None,
                   expert_fetch: Optional[str] = None, prefetch: Optional[str] = None,
                   num_slices: Optional[int] = None, demand_budget: Optional[int] = None,
                   cache_budget: Optional[int] = None) -> PolicyTable:
    """One policy table from either spelling (``_resolve_policy`` of the
    JAX package): an explicit ``policy`` wins (:func:`_coerce_policy`);
    otherwise the flat knobs spell a uniform table, each left at ``None``
    taking the default (split, all, allgather, 4 slices, budgets 0). The
    servers, the command line and ``make_execution_plan``'s deprecated
    knobs all build their uniform table here."""
    if policy is not None:
        return _coerce_policy(policy)
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
    layer group of the model: ``prefix``, ``body``, ``suffix``) or a spec
    string; the deprecated flat knobs build a uniform table instead (a
    ``DeprecationWarning``; conflicting with ``policy`` or with each other
    is a ``ValueError``), as in the JAX package."""
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
    table = _coerce_policy(policy)
    known_groups = {g.name for g in model.plan}
    for g, fam, _ in table.overrides:
        if g not in known_groups:
            raise ValueError(f"policy override names unknown layer group {g!r} (for family "
                             f"{fam!r}); this model's groups are {sorted(known_groups)}")
    batch_axes, seq_axes = plan_activation_sharding(model.cfg, shape, mesh_sizes)
    return ExecutionPlan(
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
    )
