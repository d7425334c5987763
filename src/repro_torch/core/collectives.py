"""In-process collectives over the logical ranks of the ``model`` axis.

The JAX package runs one SPMD program per rank and moves activations with
``lax`` collectives; the port runs every rank in one process and keeps one
tensor per rank in a list, in rank order. ``psum`` and ``psum_scatter``
take the tensors of one group's members (on a ``(data, model)`` mesh the
model group of one data replica, ``execution.Ctx.model_groups``);
``all_to_all`` takes every rank's and keeps to the placement's subgroups,
which lie inside a data replica. Each collective here is the
deterministic in-process form of its ``lax`` counterpart:

- ``all_gather`` (tiled) is a ``torch.cat`` in rank order;
- ``psum`` sums the ranks' tensors in fixed rank order, so every rank gets
  the same bits; ``psum_scatter`` (tiled) is that sum cut into the ranks'
  slices along the scattered dimension;
- ``all_to_all`` (tiled) gives every rank the ``j``-th block of each peer
  of its subgroup, concatenated in the peers' order: on the card, device
  copies between the logical ranks' buffers;
- ``shift_forward`` is the ``lax.ppermute`` that sends member ``i`` of a
  sequence group to member ``i + 1`` (member 0 receives zeros), and
  ``gather_stack`` the untiled ``lax.all_gather`` over one: the RG-LRU
  halo and the gather of its shards' last decays and states
  (``execution._rec_layer``). Both are device copies with no host read, so
  a prefill that runs them can be captured as a CUDA graph.
"""
from __future__ import annotations

import torch

from repro_torch.core.placement import Placement


def psum(parts: list) -> torch.Tensor:
    """The sum of the ranks' tensors, taken in rank order."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def psum_scatter(parts: list, sizes: list, dim: int = 0) -> list:
    """``lax.psum_scatter(..., tiled=True)``: rank ``r`` gets its slice of
    the rank-ordered sum, ``sizes[r]`` entries along ``dim``."""
    return list(torch.split(psum(parts), sizes, dim=dim))


def all_to_all(xs: list, placement: Placement, *, split_dim: int, concat_dim: int) -> list:
    """``lax.all_to_all(..., tiled=True)`` within each subgroup of
    ``placement`` (``axis_index_groups``; the whole axis when the
    redundancy is 1): every rank's tensor is cut into G' equal blocks along
    ``split_dim``, and rank ``r`` at subgroup position ``p`` receives block
    ``p`` of every member of its subgroup, concatenated along
    ``concat_dim`` in subgroup order."""
    g = placement.subgroup_size
    out = []
    for r in range(len(xs)):
        base, p = (r // g) * g, r % g
        blocks = [xs[base + q].chunk(g, dim=split_dim)[p] for q in range(g)]
        out.append(torch.cat(blocks, dim=concat_dim))
    return out


def shift_forward(xs: list) -> list:
    """``lax.ppermute`` with the pairs ``(i, i + 1)`` over a group in order:
    member ``i + 1`` receives a copy of member ``i``'s tensor, member 0
    zeros (the last member's tensor goes nowhere)."""
    return [torch.zeros_like(xs[0])] + [x.clone() for x in xs[:-1]]


def gather_stack(xs: list) -> torch.Tensor:
    """``lax.all_gather`` (untiled) over a group: the members' tensors
    stacked along a new leading axis, in group order (one tensor every
    member reads)."""
    return torch.stack(xs)
