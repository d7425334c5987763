"""Flexible / redundant expert placement (paper §2) — the port's copy of
``repro.core.placement`` (numpy only, identical arithmetic).

DWDP's weak placement constraint: the DWDP group size G need not divide
the expert count E, and redundant placement is allowed. We realize this
as an (R x G') factorization of the group: G = R * G', where G' ranks
form a *subgroup* that collectively stores every expert exactly once
(padding E up to local*G' with dummy experts if needed) and the partition
is tiled R times across the group. Prefetch/all-to-all then run inside
subgroups only — R-fold redundancy cuts remote traffic by (R-1)/R and
lets any G (e.g. DWDP3 for 8 experts) work at single-rank granularity.

The gathered buffer is always in canonical expert order (source-subgroup-
position order == expert-id order), so no post-gather permutation copy is
ever required — the analogue of the paper's §4.2 merge elimination.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.strategy import shard_index


@dataclasses.dataclass(frozen=True)
class Placement:
    """Expert-to-rank placement for one DWDP group."""

    num_experts: int          # E: real experts
    group_size: int           # G: ranks in the DWDP group (mesh "model" axis)
    redundancy: int           # R: copies of the full expert set in the group
    subgroup_size: int        # G' = G // R
    num_padded: int           # E_pad = local_count * G' >= E
    local_count: int          # experts stored per rank

    @property
    def storage_size(self) -> int:
        """Leading dim of the *global* expert array: G ranks x local each."""
        return self.group_size * self.local_count

    @property
    def remote_fraction(self) -> float:
        """Fraction of one layer's expert bytes fetched remotely per rank."""
        return (self.subgroup_size - 1) / self.subgroup_size

    def table(self) -> np.ndarray:
        """(G, local_count) expert ids held by each rank (padded ids >= E)."""
        ranks = np.arange(self.group_size) % self.subgroup_size
        base = ranks[:, None] * self.local_count + np.arange(self.local_count)
        return base  # padded expert ids in [0, num_padded)

    def axis_index_groups(self) -> list[list[int]] | None:
        """Subgroups for all_gather/all_to_all (None = whole axis)."""
        if self.redundancy == 1:
            return None
        g = self.subgroup_size
        return [
            [s * g + i for i in range(g)] for s in range(self.redundancy)
        ]

    def ring_pairs(self) -> list[tuple[int, int]]:
        """ppermute (src, dst) pairs: each subgroup forms its own ring
        (each rank's shard moves one position forward = everyone receives
        from neighbor p-1; equivalently ``shift_pairs(-1)``)."""
        return self.shift_pairs(-1)

    def shift_pairs(self, t: int) -> list[tuple[int, int]]:
        """ppermute (src, dst) pairs delivering subgroup neighbor ``p + t``'s
        data to each rank ``p`` (i.e. every rank's shard travels ``t``
        positions *backwards* around its subgroup ring). ``shift_pairs(1)``
        chained G'-1 times walks the ring; ``shift_pairs(t)`` one-shot pulls
        the t-th neighbor directly (remote-only allgather mode)."""
        pairs = []
        g = self.subgroup_size
        for s in range(self.redundancy):
            for i in range(g):
                pairs.append((s * g + i, s * g + (i - t) % g))
        return pairs


def make_placement(
    num_experts: int, group_size: int, *, redundancy: int | None = None
) -> Placement:
    """Choose a placement. Default redundancy: replicate the expert set as
    many times as fits whole subgroups, i.e. R = max R dividing G with
    G/R >= min(G, E') coverage — in practice R > 1 only when E < G."""
    if redundancy is None:
        redundancy = 1
        if num_experts < group_size:
            # largest R dividing G such that subgroup still covers all experts
            for r in range(group_size // max(1, num_experts), 0, -1):
                if group_size % r == 0:
                    redundancy = r
                    break
    if group_size % redundancy:
        raise ValueError(f"redundancy {redundancy} must divide group {group_size}")
    sub = group_size // redundancy
    local = math.ceil(num_experts / sub)
    return Placement(
        num_experts=num_experts,
        group_size=group_size,
        redundancy=redundancy,
        subgroup_size=sub,
        num_padded=local * sub,
        local_count=local,
    )


def expand_to_storage(experts: np.ndarray, placement: Placement) -> np.ndarray:
    """Expand an (E_pad, ...) expert array to the (G*local, ...) storage
    layout (duplicating across redundant subgroups). Used at init/ckpt."""
    table = placement.table().reshape(-1)  # (G*local,)
    return experts[table]


def subgroup_positions(mesh_sizes: dict, expert_axes: tuple, placement: Placement) -> np.ndarray:
    """Each logical rank's position within its expert-gather subgroup, in
    rank order (``strategy.shard_index`` over ``expert_axes`` mod G', the
    JAX package's ``axis_index % subgroup_size``): on a ``(data, model)``
    mesh rank ``d * G + m`` sits at ``m % G'``."""
    n = math.prod(mesh_sizes.values())
    return np.array([shard_index(mesh_sizes, expert_axes, r) % placement.subgroup_size
                     for r in range(n)], np.int64)
