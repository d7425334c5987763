"""Execution plans: activation sharding and per-family gather policies.

The port of the parts of ``repro.core.strategy`` the forward reads:
``GatherPolicy`` / ``PolicyTable`` (the per-family configuration surface
— ``moe_experts``, ``attn_qkv``, ``attn_out``, ``dense_ffn``),
``ExecutionPlan``, ``plan_activation_sharding`` and
``make_execution_plan``. The roofline ``auto`` resolver and the
deprecated flat knobs are not ported. The port runs the modes ``dwdp``,
``dep`` and ``hybrid`` (``replicated`` is refused) and executes
``split:all:allgather`` for every family, and for ``moe_experts`` also
the route-before-gather fetches ``demand``, ``predictive`` and
``sync_free`` (with their ``budget`` / ``cache_budget``) over the
``allgather`` transport; other policies validate here and are refused by
``make_execution_plan`` until their slices land. Under ``dep`` and
``hybrid`` the experts stay put (an all-to-all moves the tokens), so an
expert fetch other than ``all`` engages nowhere and runs as the
all-to-all, as in the JAX package; DEP's decode gathers attention in the
merged layout whatever the family's layout.
"""
from __future__ import annotations

import dataclasses
import json
import math
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


@dataclasses.dataclass(frozen=True)
class GatherPolicy:
    """How one gathered-weight family is obtained: ``layout`` (split |
    merged), ``fetch`` (all | demand | predictive | sync_free),
    ``transport`` (allgather | ring | ring_sliced), ``num_slices``,
    ``budget`` and ``cache_budget`` — the JAX package's fields and
    validation."""

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

    def spec(self) -> str:
        """``layout:fetch:transport[:num_slices][:budget][:cache_budget]``."""
        s = f"{self.layout}:{self.fetch}:{self.transport}"
        if self.num_slices != 4 or self.budget != 0 or self.cache_budget != 0:
            s += f":{self.num_slices}"
        if self.budget != 0 or self.cache_budget != 0:
            s += f":{self.budget}"
        if self.cache_budget != 0:
            s += f":{self.cache_budget}"
        return s


@dataclasses.dataclass(frozen=True)
class PolicyTable:
    """Per-family gather policies; ``family(name)`` falls back to
    ``default``. (Per-layer-group overrides are not ported yet.)"""

    default: GatherPolicy = GatherPolicy()
    families: tuple[tuple[str, GatherPolicy], ...] = ()

    def __post_init__(self):
        seen: set = set()
        for name, pol in self.families:
            if name not in GATHER_FAMILIES:
                raise ValueError(f"unknown gather family {name!r}; expected one of {GATHER_FAMILIES}")
            if pol.fetch != "all" and name != "moe_experts":
                raise ValueError(f'fetch="{pol.fetch}" only applies to moe_experts')
            if name in seen:
                raise ValueError(f"duplicate family entry {name!r}")
            seen.add(name)

    def family(self, name: str, group: Optional[str] = None) -> GatherPolicy:
        if name not in GATHER_FAMILIES + ("default",):
            raise ValueError(f"unknown gather family {name!r}")
        for n, pol in self.families:
            if n == name:
                return pol
        return self.default

    @classmethod
    def uniform(cls, *, layout: str = "split", fetch: str = "all",
                transport: str = "allgather", num_slices: int = 4,
                budget: int = 0, cache_budget: int = 0) -> "PolicyTable":
        pol = GatherPolicy(layout=layout, fetch=fetch, transport=transport,
                           num_slices=num_slices, budget=budget,
                           cache_budget=cache_budget)
        if pol.fetch != "all":
            return cls(
                default=dataclasses.replace(pol, fetch="all", budget=0, cache_budget=0),
                families=(("moe_experts", pol),),
            )
        return cls(default=pol)

    def to_dict(self) -> dict:
        out = {"default": self.default.spec()}
        for name, pol in self.families:
            out[name] = pol.spec()
        return out

    def describe(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)


PolicyLike = Union[None, PolicyTable, GatherPolicy]


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


#: The policy the port executes for every family; ``moe_experts`` may
#: also take any fetch of ``PORTED_EXPERT_FETCH`` with its budgets.
PORTED_POLICY = GatherPolicy(layout="split", fetch="all", transport="allgather")
PORTED_EXPERT_FETCH = ("all", "demand", "predictive", "sync_free")


def _ported(family: str, pol: GatherPolicy) -> bool:
    if family == "moe_experts" and pol.fetch in PORTED_EXPERT_FETCH:
        pol = dataclasses.replace(pol, fetch="all", budget=0, cache_budget=0)
    return pol == PORTED_POLICY


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
) -> ExecutionPlan:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if mode not in PORTED_MODES:
        raise NotImplementedError(f"mode {mode!r} is not ported yet (only {PORTED_MODES})")
    if decode_attn not in DECODE_ATTN:
        raise ValueError(f"decode_attn must be one of {DECODE_ATTN}, got {decode_attn!r}")
    if capacity_from not in CAPACITY_FROM:
        raise ValueError(f"capacity_from must be one of {CAPACITY_FROM}")
    if policy is None:
        table = PolicyTable()
    elif isinstance(policy, GatherPolicy):
        table = PolicyTable(default=policy)
    elif isinstance(policy, PolicyTable):
        table = policy
    else:
        raise TypeError(f"cannot build a PolicyTable from {policy!r}")
    for fam in GATHER_FAMILIES:
        if not _ported(fam, table.family(fam)):
            raise NotImplementedError(
                f"policy {table.family(fam).spec()!r} for {fam} is not ported "
                f"yet; the port runs {PORTED_POLICY.spec()!r} (moe_experts also "
                f"with fetch in {PORTED_EXPERT_FETCH[1:]})"
            )
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
