"""Split-bank prefetch between logical ranks — the port of the first half
of ``repro.core.prefetch`` (paper §4.2/§4.3).

On one card the G' ranks of a DWDP subgroup are logical ranks of one
process, each holding its resident shard as a separate allocation. A
rank's remote pull copies its peers' shards into a landing buffer: the
**remote bank**, in **rotated canonical order** — position ``j * local +
i`` holds slice ``((p + 1 + j) % G') * local + i`` for the caller's
subgroup position ``p``. The resident shard is never copied (it *is* the
local bank), so no buffer of the full layer exists. Consumers compensate
with index arithmetic only, exactly as in the JAX package: MoE rolls its
dispatch by ``p * local``, attention rolls projected activations, the
dense FFN sum needs nothing.

Only the ``allgather`` transport is ported (one copy per peer shard, all
independent); ``ring`` and ``ring_sliced`` are later work. The engine
issues these copies on a side CUDA stream one unit of work ahead
(``core.execution.BankPipeline``).
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch

from repro_torch.core.placement import Placement

PyTree = Any


class SplitBank(NamedTuple):
    """``local``: the rank's resident shard tree, untouched. ``remote``: the
    landed peer shards, leading dim ``(G'-1) * local`` in rotated order."""

    local: PyTree
    remote: PyTree


class AttnBank(NamedTuple):
    """Gathered attention projections as two policy families:
    ``qkv`` (wq/wk/wv) and ``out`` (wo), each a :class:`SplitBank`."""

    qkv: PyTree
    out: PyTree


def tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def peer_ranks(rank: int, placement: Placement) -> list[int]:
    """Ranks whose shards fill ``rank``'s remote bank, in rotated order:
    subgroup neighbour ``p + 1 + j`` for ``j < G' - 1``, within the
    rank's own subgroup."""
    g = placement.subgroup_size
    base, p = (rank // g) * g, rank % g
    return [base + (p + 1 + j) % g for j in range(g - 1)]


def gather_remote_shards(shards: list, rank: int, placement: Placement, *,
                         mode: str = "allgather",
                         copy_stream=None) -> tuple[PyTree, PyTree]:
    """Remote-only prefetch for ``rank``: ``(local_bank, remote_bank)``.

    ``shards`` holds every rank's resident tree (leading dim ``local``).
    The remote bank is a fresh buffer per leaf, allocated on the current
    stream, into which each peer's shard is copied (the in-process
    stand-in for the peer pull) — on ``copy_stream`` when one is given;
    the caller then orders that stream against the current one."""
    if mode != "allgather":
        raise NotImplementedError(
            f"transport {mode!r} is not ported yet (only 'allgather')"
        )
    local = shards[rank]
    peers = [shards[q] for q in peer_ranks(rank, placement)]

    def land(lo, *remote):
        n = lo.shape[0]
        out = torch.empty((n * len(remote),) + tuple(lo.shape[1:]),
                          dtype=lo.dtype, device=lo.device)
        on_side = torch.cuda.stream(copy_stream) if copy_stream is not None else contextlib.nullcontext()
        with on_side:
            for j, src in enumerate(remote):
                out[j * n:(j + 1) * n].copy_(src, non_blocking=True)
        return out

    if not peers:
        return local, tree_map(lambda lo: lo[:0], local)
    return local, tree_map(land, local, *peers)


def gather_split_bank(shards: list, rank: int, placement: Placement, *,
                      mode: str = "allgather", copy_stream=None) -> SplitBank:
    """The :class:`SplitBank` form of :func:`gather_remote_shards`."""
    local, remote = gather_remote_shards(
        shards, rank, placement, mode=mode, copy_stream=copy_stream
    )
    return SplitBank(local=local, remote=remote)


def merge_split_bank(bank: SplitBank, rank: int, placement: Placement) -> PyTree:
    """Explicit merge of a SplitBank into the canonical ``(num_padded,
    ...)`` order — the §4.2 merge copy, performed on purpose (tests and
    fallbacks). ``[local; remote]`` holds slice ``(p + j) % G'`` at block
    ``j``; rolling by ``p * local`` restores canonical order."""
    g = placement.subgroup_size
    if g == 1:
        return bank.local
    shift = (rank % g) * placement.local_count

    def merge(lo, re):
        rot = torch.cat([lo, re], dim=0)
        idx = (torch.arange(placement.num_padded, device=rot.device) - shift) % placement.num_padded
        return rot[idx]

    return tree_map(merge, bank.local, bank.remote)
