"""Weight prefetch between logical ranks — the port of
``repro.core.prefetch`` (paper §4.2/§4.3).

On one card the G' ranks of a DWDP subgroup are logical ranks of one
process, each holding its resident shard as a separate allocation. A
rank's pull copies its peers' shards into a landing buffer, in one of two
layouts:

- **split** (:func:`gather_split_bank`): the **remote bank**, in
  **rotated canonical order** — position ``j * local + i`` holds slice
  ``((p + 1 + j) % G') * local + i`` for the caller's subgroup position
  ``p``. The resident shard is never copied (it *is* the local bank), so
  no buffer of the full layer exists. Consumers compensate with index
  arithmetic only, exactly as in the JAX package: MoE rolls its dispatch
  by ``p * local``, attention rolls projected activations, the dense FFN
  sum needs nothing.
- **merged** (:func:`gather_shards`): every shard of the subgroup, the
  resident one included, copied into one canonical ``(G' * local, ...)``
  buffer — the explicit merge the split layout saves (the §4.2 baseline).
  Its resident-shard copy counts in :data:`LANDED` like the pulls, and on
  its own in ``LANDED.merge_bytes``.

Each layout runs over one of three transports. On one card every pull is
a device copy on the side stream, so the transports differ only in their
copy schedule, and all three land the same bytes at the same positions:
``allgather`` issues one copy per peer shard; ``ring`` issues its G'-1
rounds one after another on one stream; ``ring_sliced`` cuts each round
into ``num_slices`` column slices of the last dimension (stepped down
until it divides it, as the JAX package does) issued step-major and
slice-minor, the TDM round-robin of the paper's Listing 1. For a split
bank, round ``t`` is neighbour ``p + 1 + t``'s shard, which is the order
``allgather`` already issues its per-peer copies in: on one card the
split ``ring`` is the ``allgather`` schedule, copy for copy, and only a
merged landing changes its issue order under ``ring`` (the resident
shard first, then the ring direction). A chained ring's forwarding
through the intermediate ranks is not modelled on one card: every round
copies from the owner's resident shard. The engine issues these copies on a side CUDA
stream one unit of work ahead (``core.execution.BankPipeline``).

The second half ports the route-before-gather primitives of the demand,
predictive and sync-free expert fetch (``DemandBank``, ``PredictState``,
``plan_demand_fetch``, ``gather_demand_payload``, the predictor and the
sync-free mirror helpers). Their cross-rank steps run in process over the
logical ranks: the bitmap all-gather is a ``torch.stack`` in subgroup
order, the axis-agreed overflow flag an ``any`` over every rank, and a
payload a row gather (:func:`gather_rows`) of the requested rows of each
peer's resident shard into the requester's landing buffer. Expert ids
are int64.

The validated fetch (:func:`row_checksums`, :func:`checksum_table`,
:func:`verify_rows`) re-checksums every fetched or cached expert row
against the owners' table; ``gather_demand_payload`` takes a
``faults.FaultInjector`` that tampers the arrived rows.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple

import torch

from repro_torch import counters
from repro_torch.core.placement import Placement
from repro_torch.core.strategy import PREFETCH_MODES

PyTree = Any


class SplitBank(NamedTuple):
    """``local``: the rank's resident shard tree, untouched. ``remote``: the
    landed peer shards, leading dim ``(G'-1) * local`` in rotated order."""

    local: PyTree
    remote: PyTree


class LandingCounter:
    """Bytes copied into landing buffers (split and merged banks, demand
    payloads): the in-process stand-in for the wire bytes of the pulls,
    plus the merged layout's copies of the rank's own resident shard.
    ``merge_bytes`` counts those resident copies alone — the §4.2 merge
    copy the split layout saves — so ``bytes - merge_bytes`` is what
    crossed between ranks. Plain integers a caller may read and reset."""

    def __init__(self):
        self.bytes = 0
        self.merge_bytes = 0


LANDED = LandingCounter()
counters.register("landed", LANDED, ("bytes", "merge_bytes"))


class AttnBank(NamedTuple):
    """Gathered attention projections as two policy families: ``qkv``
    (wq/wk/wv) and ``out`` (wo), each a :class:`SplitBank` or, where the
    family is merged, a plain dict of full weights."""

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


def subgroup_ranks(rank: int, placement: Placement) -> list[int]:
    """The ranks of ``rank``'s subgroup, in subgroup-position order."""
    g = placement.subgroup_size
    base = (rank // g) * g
    return [base + q for q in range(g)]


def num_feature_slices(feat: int, num_slices: int) -> int:
    """``ring_sliced``'s slice count for a last dimension of ``feat``:
    ``num_slices`` stepped down until it divides ``feat``."""
    s = max(1, num_slices)
    while feat % s:
        s -= 1
    return s


def _check_transport(mode: str) -> None:
    if mode not in PREFETCH_MODES:
        raise ValueError(f"unknown transport {mode!r}; expected one of {PREFETCH_MODES}")


def _land(blocks: list, like: torch.Tensor, mode: str, num_slices: int,
          copy_stream) -> torch.Tensor:
    """A fresh buffer of ``sum(rows)`` rows shaped like ``like`` (allocated
    on the current stream), filled by ``blocks`` — ``(row offset, source)``
    in issue order — on ``copy_stream`` when one is given: one copy per
    block, or under ``ring_sliced`` one per column slice of each block,
    block-major."""
    n = sum(src.shape[0] for _, src in blocks)
    out = torch.empty((n,) + tuple(like.shape[1:]), dtype=like.dtype, device=like.device)
    sliced = mode == "ring_sliced" and like.dim() > 1
    s = num_feature_slices(like.shape[-1], num_slices) if sliced else 1
    w = like.shape[-1] // s
    on_side = torch.cuda.stream(copy_stream) if copy_stream is not None else contextlib.nullcontext()
    with on_side:
        for off, src in blocks:
            dst = out[off:off + src.shape[0]]
            if s == 1:
                dst.copy_(src, non_blocking=True)
                continue
            for j in range(s):
                dst[..., j * w:(j + 1) * w].copy_(src[..., j * w:(j + 1) * w], non_blocking=True)
    LANDED.bytes += out.numel() * out.element_size()
    return out


def gather_remote_shards(shards: list, rank: int, placement: Placement, *,
                         mode: str = "allgather", num_slices: int = 4,
                         copy_stream=None) -> tuple[PyTree, PyTree]:
    """Remote-only prefetch for ``rank``: ``(local_bank, remote_bank)``.

    ``shards`` holds every rank's resident tree (leading dim ``local``).
    The remote bank is a fresh buffer per leaf, allocated on the current
    stream, into which each peer's shard is copied over transport
    ``mode`` (the in-process stand-in for the peer pulls; the remote chunk
    of round ``t`` is subgroup neighbour ``p + 1 + t``'s shard under every
    transport, so ``ring`` issues the same copies as ``allgather`` and
    ``ring_sliced`` only slices them) — on ``copy_stream`` when one is
    given; the caller then orders that stream against the current one."""
    _check_transport(mode)
    local = shards[rank]
    peers = [shards[q] for q in peer_ranks(rank, placement)]
    if not peers:
        return local, tree_map(lambda lo: lo[:0], local)

    def land(lo, *remote):
        n = lo.shape[0]
        return _land([(j * n, src) for j, src in enumerate(remote)], lo, mode, num_slices,
                     copy_stream)

    return local, tree_map(land, local, *peers)


def gather_split_bank(shards: list, rank: int, placement: Placement, *,
                      mode: str = "allgather", num_slices: int = 4,
                      copy_stream=None) -> SplitBank:
    """The :class:`SplitBank` form of :func:`gather_remote_shards`."""
    local, remote = gather_remote_shards(shards, rank, placement, mode=mode,
                                         num_slices=num_slices, copy_stream=copy_stream)
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


def gather_shards(shards: list, rank: int, placement: Placement, *, mode: str = "allgather",
                  num_slices: int = 4, copy_stream=None) -> PyTree:
    """The merged landing of ``rank`` (``gather_shards`` /
    ``execution._gather_leading`` of the JAX package; also DEP's
    decode-time attention gather): every shard of the rank's subgroup, its
    own included, copied into one contiguous canonical ``(G' * local,
    ...)`` buffer per leaf — subgroup position ``q``'s shard at rows ``[q *
    local, (q + 1) * local)`` — over transport ``mode``: ``allgather`` in
    position order; ``ring`` and ``ring_sliced`` the resident shard first,
    then round ``t``'s shard of position ``p - 1 - t`` (the JAX package's
    ring direction). Allocated on the current stream and copied on
    ``copy_stream`` when one is given, as :func:`gather_remote_shards`.
    Every landed byte counts in :data:`LANDED`; the resident shard's also
    in ``LANDED.merge_bytes``."""
    _check_transport(mode)
    g = placement.subgroup_size
    p = rank % g
    members = [shards[q] for q in subgroup_ranks(rank, placement)]
    order = list(range(g)) if mode == "allgather" else [p] + [(p - 1 - t) % g for t in range(g - 1)]

    def land(*parts):
        n = parts[0].shape[0]
        LANDED.merge_bytes += parts[p].numel() * parts[p].element_size()
        return _land([(q * n, parts[q]) for q in order], parts[0], mode, num_slices, copy_stream)

    return tree_map(land, *members)


RESHARD_KINDS = ("local", "wire", "source")


def reshard_runs(old: Placement, new: Placement, dead: int) -> list:
    """The copies of the fail-stop re-shard ``G' -> G'-1``: per new
    subgroup position, its contiguous runs of real rows ``(kind, owner,
    first, stop)`` in expert ids, ``kind`` one of :data:`RESHARD_KINDS`
    (already held by the survivor at that position, from a surviving peer,
    from the checkpoint copy because ``owner`` is the dead rank). At most
    one run per old owner a new range overlaps."""
    dead = int(dead) % old.subgroup_size
    e, old_l, new_l = old.num_experts, old.local_count, new.local_count
    survivors = [r for r in range(old.subgroup_size) if r != dead]
    out = []
    for pos, held in enumerate(survivors):
        runs, r, hi = [], pos * new_l, min((pos + 1) * new_l, e)
        while r < hi:
            owner = min(r // old_l, old.subgroup_size - 1)
            stop = min(hi, (owner + 1) * old_l)
            kind = "source" if owner == dead else "local" if owner == held else "wire"
            runs.append((kind, owner, r, stop))
            r = stop
        out.append(runs)
    return out


def reshard_split_bank(shards: list, old: Placement, new: Placement, dead: int,
                       source: PyTree, *, events: dict | None = None) -> list:
    """Fail-stop re-shard of one family's resident shards after a rank
    death, ``G' -> G'-1`` (``repro.core.prefetch.reshard_split_bank``).

    ``shards`` holds each old subgroup position's resident tree (leading dim
    ``old.local_count``, rows in expert order). The survivors' rows move to
    the new placement's ownership ranges; every row the dead rank held comes
    from ``source``, the checkpoint tree with leading dim >=
    ``num_experts`` (it may live on the host), and never from
    ``shards[dead]``, whose memory recovery must not trust. New padding
    rows are zeros, as in a fresh ``make_placement`` shard of ``source``.
    Rows move as the contiguous runs of :func:`reshard_runs`, one copy per
    run and leaf, the survivors' copies first, then the checkpoint's.
    ``events`` (CUDA): filled with a ``(start, end)`` pair of recorded
    events per kind of copy. Returns the ``G'-1`` new trees, on the
    survivors' device."""
    if new.num_experts != old.num_experts:
        raise ValueError(f"reshard must keep the expert set: {old.num_experts} != "
                         f"{new.num_experts}")
    if new.subgroup_size != old.subgroup_size - 1:
        raise ValueError(f"reshard shrinks the subgroup by exactly the dead rank: "
                         f"{old.subgroup_size} -> {new.subgroup_size}")
    dead = int(dead) % old.subgroup_size
    runs = reshard_runs(old, new, dead)
    live = [q for q in range(old.subgroup_size) if q != dead]
    leaves: list = []  # (source leaf, {old position: leaf}, new leaves)

    def alloc(src_leaf, *held):
        like = held[0]
        outs = [torch.zeros((new.local_count,) + tuple(like.shape[1:]), dtype=like.dtype,
                            device=like.device) for _ in range(new.subgroup_size)]
        leaves.append((src_leaf, dict(zip(live, held)), outs))
        return outs

    trees = tree_map(alloc, source, *(shards[q] for q in live))
    for kind in RESHARD_KINDS:
        if events is not None:
            events[kind] = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            events[kind][0].record()
        for src_leaf, held, outs in leaves:
            for pos, pos_runs in enumerate(runs):
                base = pos * new.local_count
                for k, owner, first, stop in pos_runs:
                    if k != kind:
                        continue
                    dst = outs[pos][first - base:stop - base]
                    if k == "source":
                        dst.copy_(torch.as_tensor(src_leaf[first:stop]), non_blocking=True)
                    else:
                        off = owner * old.local_count
                        dst.copy_(held[owner][first - off:stop - off])
        if events is not None:
            events[kind][1].record()
    return [tree_map(lambda outs, pos=pos: outs[pos], trees) for pos in range(new.subgroup_size)]


# --------------------------------------------------------------------------
# On-demand expert fetch: the two-round route-before-gather primitive.
# --------------------------------------------------------------------------
class DemandBank(NamedTuple):
    """Output of the on-demand expert fetch.

    ``local``: the resident shard tree, untouched. ``fetched``: the
    fetched tree, leading dim ``(G' - 1) * budget`` — peer-major (distance
    1 first), each peer's chunk compacted to ascending expert id and padded
    to the per-peer ``budget``. ``fetched_ids``: the padded-canonical
    expert id of each fetched row (undefined where ``valid`` is False).
    ``valid``: False rows are padding (their weights are real rows of the
    peer's shard, never dispatched to)."""

    local: PyTree
    fetched: PyTree
    fetched_ids: torch.Tensor
    valid: torch.Tensor


#: EMA decay of the predictive-fetch hotness tracker.
EMA_DECAY = 0.875
#: Sync-free richer-predictor decays: per-row expert affinity, decode-
#: position bucket histograms, per-layer signal weights.
AFF_DECAY = 0.9
POS_DECAY = 0.96875
SIGW_DECAY = 0.875
#: Decode positions histogrammed into buckets of POS_BUCKET_SIZE steps
#: (the last bucket is open-ended).
N_POS_BUCKETS = 4
POS_BUCKET_SIZE = 64


class PredictState(NamedTuple):
    """One logical rank's predictor + residency-cache state of one MoE
    layer (the JAX package's ``PredictState`` without its leading per-rank
    dim: the port keeps one object per rank).

    ``prev`` (E,) bool: the previous step's activated bitmap. ``ema`` (E,)
    f32: EMA activation frequency (:data:`EMA_DECAY`). ``cache_ids`` /
    ``cache_valid`` (rows,) int64 / bool: the expert id of each cache slot.
    ``cache``: the cached weight rows, ``(rows, ...)`` per leaf.
    ``stats`` (5,) f32: this step's ``[predicted, spec_hit, cache_hit,
    corr_rows, evicted]``.

    Sync-free: ``prev``/``ema`` are ``(G', E)`` and ``cache_ids``/
    ``cache_valid`` ``(G', rows)`` — every rank mirrors the bookkeeping of
    each peer of its subgroup (the cached weights stay its own) — and the
    richer predictor engages: ``aff`` (G', rows_b, E), ``posb`` (G',
    N_POS_BUCKETS, E), ``sig`` (G', 2, E), ``sigw`` (G', 2). ``routed`` is
    a within-step channel (a layer's routed bitmaps for the per-step
    mirror fold), None in the carried state."""

    prev: torch.Tensor
    ema: torch.Tensor
    cache_ids: torch.Tensor
    cache_valid: torch.Tensor
    cache: PyTree
    stats: torch.Tensor
    aff: Any = None
    posb: Any = None
    sig: Any = None
    sigw: Any = None
    routed: Any = None


class DemandPlan(NamedTuple):
    """One rank's view of the index exchange: ``masks`` (G', E) every
    subgroup peer's wanted bitmap; ``fetched_ids`` / ``valid`` the
    requester-side fetch schedule; ``overflow`` the agreed flag (0-d bool
    tensor, the same object on every rank)."""

    masks: torch.Tensor
    fetched_ids: torch.Tensor
    valid: torch.Tensor
    overflow: torch.Tensor


def _compact_requests(mask_slice: torch.Tensor, budget: int):
    """Wanted indices of one peer slice in ascending order, padded to
    ``budget`` with the unwanted ones (real rows, covered by ``valid``).
    Returns ``(idx, valid, count)``."""
    order = torch.argsort((~mask_slice).to(torch.int8), stable=True)
    count = mask_slice.sum()
    idx = order[:budget]
    valid = torch.arange(idx.shape[0], device=mask_slice.device) < torch.clamp(count, max=budget)
    return idx, valid, count


def exclude_bitmap(num_padded: int, exclude_ids: torch.Tensor,
                   exclude_valid: torch.Tensor) -> torch.Tensor:
    """Scatter a (ids, valid) row set into a ``(num_padded,)`` bool bitmap;
    invalid rows are dropped."""
    out = torch.zeros(num_padded + 1, dtype=torch.bool, device=exclude_ids.device)
    out.index_fill_(0, torch.where(exclude_valid, exclude_ids, num_padded), True)
    return out[:num_padded]


def plan_from_bitmap(wanted: torch.Tensor, p: int, g: int, local: int, budget: int):
    """Requester-side fetch schedule of subgroup position ``p`` from its
    ``(num_padded,)`` wanted bitmap: per peer (distance 1 first) the
    ascending-id compaction padded to ``budget``. Returns ``(fetched_ids,
    valid, overflow)`` with a raw (un-agreed) 0-d overflow flag."""
    ids, valids = [], []
    overflow = torch.zeros((), dtype=torch.bool, device=wanted.device)
    for t in range(1, g):
        o = (p + t) % g
        idx, valid_t, cnt = _compact_requests(wanted[o * local:(o + 1) * local], budget)
        ids.append(o * local + idx)
        valids.append(valid_t)
        overflow = overflow | (cnt > budget)
    if not ids:
        return (torch.zeros(0, dtype=torch.int64, device=wanted.device),
                torch.zeros(0, dtype=torch.bool, device=wanted.device), overflow)
    return torch.cat(ids), torch.cat(valids), overflow


def gather_rows(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` for a contiguous stack of rows, copied as
    the widest integer words that divide a row's bytes: the bytes move
    unchanged, and ``index_select`` over 8-byte words runs near copy speed
    where over 2-byte bf16 elements it does not."""
    row = math.prod(src.shape[1:])
    word = next(w for w in (torch.int64, torch.int32, torch.int16, torch.uint8)
                if row * src.element_size() % w.itemsize == 0)
    torch.index_select(src.reshape(src.shape[0], row).view(word), 0, idx,
                       out=out.view(out.shape[0], row).view(word))
    return out


def plan_demand_fetch(wanted: list, placement: Placement, *, budget: int,
                      exclude: Any = None) -> list[DemandPlan]:
    """Round 1 — the index exchange, for every rank at once. ``wanted[r]``
    is rank r's ``(num_padded,)`` activated bitmap; ``exclude[r]``
    (optional) the ``(ids, valid)`` rows rank r already holds, subtracted
    before the exchange. The bitmaps are all-gathered per subgroup and the
    overflow flag is agreed over every rank. Returns one plan per rank."""
    g, local = placement.subgroup_size, placement.local_count
    budget = min(budget, local)
    if exclude is not None:
        wanted = [
            w & ~exclude_bitmap(placement.num_padded, ids, valid)
            for w, (ids, valid) in zip(wanted, exclude)
        ]
    scheds = [plan_from_bitmap(w, r % g, g, local, budget) for r, w in enumerate(wanted)]
    overflow = torch.stack([ovf for _, _, ovf in scheds]).any()
    plans = []
    for r, (ids, valid, _) in enumerate(scheds):
        masks = torch.stack([wanted[q] for q in subgroup_ranks(r, placement)])
        plans.append(DemandPlan(masks=masks, fetched_ids=ids, valid=valid, overflow=overflow))
    return plans


def gather_demand_payload(shards: list, plan: DemandPlan, rank: int, placement: Placement, *,
                          budget: int, mode: str = "allgather", num_slices: int = 4,
                          out: Any = None, copy_stream=None, injector: Any = None,
                          fault_key: Any = None) -> DemandBank:
    """Round 2 — the payload for ``rank``: each subgroup peer serves the
    rows this rank asked it for out of its resident shard (the sender-side
    compaction of ``plan.masks``, which every rank holds identically),
    padded to ``budget``, landed peer-major into the rank's buffer
    (``out``: a preallocated tree of ``(G'-1) * budget`` rows, or fresh
    buffers allocated on the current stream). Copies run on
    ``copy_stream`` when one is given. A payload is point to point, so
    ``ring`` shares ``allgather``'s direct schedule, as in the JAX package;
    ``ring_sliced`` gathers each peer's rows in ``num_slices`` column
    slices of the last dimension.

    ``injector`` / ``fault_key`` (optional): a ``faults.FaultInjector`` and
    the site key it draws from; the landed rows are tampered in place with
    its drop / zero / corrupt masks (after the copies, on their stream),
    the wire faults the caller's checksum verification must catch. The
    caller recomputes the same masks from the same key to count them."""
    _check_transport(mode)
    g, local = placement.subgroup_size, placement.local_count
    budget = min(budget, local)
    own = shards[rank]
    ranks = subgroup_ranks(rank, placement)
    p = rank % g
    idx_by_t = []
    for t in range(1, g):
        o = (p + t) % g
        idx, _, _ = _compact_requests(plan.masks[p, o * local:(o + 1) * local], budget)
        idx_by_t.append((ranks[o], idx))

    n_src = len(idx_by_t)
    if copy_stream is not None:
        # the row indices were computed on the current stream just now
        copy_stream.wait_stream(torch.cuda.current_stream(copy_stream.device))

    def land(lo, *leaves):
        srcs, dst = leaves[:n_src], leaves[n_src:]
        buf = dst[0] if dst else torch.empty(
            ((g - 1) * budget,) + tuple(lo.shape[1:]), dtype=lo.dtype, device=lo.device)
        s = num_feature_slices(lo.shape[-1], num_slices) if mode == "ring_sliced" else 1
        w = lo.shape[-1] // s
        on_side = (torch.cuda.stream(copy_stream) if copy_stream is not None
                   else contextlib.nullcontext())
        with on_side:
            for t, (src, (_, idx)) in enumerate(zip(srcs, idx_by_t)):
                rows = buf[t * budget:(t + 1) * budget]
                if s == 1:
                    gather_rows(src, idx, rows)
                else:
                    for j in range(s):
                        torch.index_select(src[..., j * w:(j + 1) * w], 0, idx,
                                           out=rows[..., j * w:(j + 1) * w])
                if copy_stream is not None:
                    idx.record_stream(copy_stream)
        LANDED.bytes += buf.numel() * buf.element_size()
        return buf

    peers = [shards[r] for r, _ in idx_by_t]
    fetched = tree_map(land, own, *peers, *(() if out is None else (out,)))
    if injector is not None:
        on_side = (torch.cuda.stream(copy_stream) if copy_stream is not None
                   else contextlib.nullcontext())
        with on_side:
            drop, zero, corrupt = injector.payload_masks(fault_key, budget, p)
            injector.tamper_rows(fetched, drop | zero, corrupt)
        if copy_stream is not None:
            # the key was drawn on the current stream: keep its memory until
            # the copy stream has read it
            fault_key.record_stream(copy_stream)
    return DemandBank(local=own, fetched=fetched, fetched_ids=plan.fetched_ids, valid=plan.valid)


def predict_bitmap(prev: torch.Tensor, ema: torch.Tensor, placement: Placement, *,
                   budget: int, exclude_ids: Any = None, exclude_valid: Any = None,
                   extra_score: Any = None, exclude_peers: tuple = ()) -> torch.Tensor:
    """The speculative round's predicted bitmap: per subgroup slice the
    top-``budget`` experts by score — previous-step activation (+2), EMA
    frequency, the optional ``extra_score`` — minus the excluded
    (cache-resident) rows. Cold experts (score 0) are never predicted.
    Ties go to the lower expert id, as XLA's top-k does. ``exclude_peers``:
    subgroup positions whose experts are left out of the speculative
    schedule (the degradation ladder's per-peer exclusion rung: their rows
    ride the validated correction round instead)."""
    e_pad, local, g = placement.num_padded, placement.local_count, placement.subgroup_size
    budget = min(budget, local)
    score = prev.float() * 2.0 + ema
    if extra_score is not None:
        score = score + extra_score
    if exclude_ids is not None:
        score = torch.where(exclude_bitmap(e_pad, exclude_ids, exclude_valid),
                            torch.zeros((), device=score.device), score)
    rows = score.reshape(g, local)
    for peer in exclude_peers:  # ``score`` is this call's own tensor
        rows[int(peer) % g] = 0.0
    top_idx = torch.argsort(-rows, dim=-1, stable=True)[:, :budget]
    top_vals = torch.gather(rows, 1, top_idx)
    ids = (torch.arange(g, device=rows.device)[:, None] * local + top_idx).reshape(-1)
    keep = (top_vals > 0.0).reshape(-1)
    out = torch.zeros(e_pad + 1, dtype=torch.bool, device=rows.device)
    out.index_fill_(0, torch.where(keep, ids, e_pad), True)
    return out[:e_pad]


# --------------------------------------------------------------------------
# Sync-free decode: mirrored-predictor helpers. Every rank derives every
# subgroup peer's speculative schedule from its mirrored PredictState, so
# the speculative round ships no index metadata; the mirrors are folded
# from one exchanged payload per step and cross-checked with a digest.
# --------------------------------------------------------------------------
def routed_bitmaps(top_experts: torch.Tensor, num_padded: int) -> torch.Tensor:
    """``(rows, num_padded)`` per-row activated bitmaps from ``(rows,
    top_k)`` expert ids (ids >= num_padded are dropped)."""
    rows = top_experts.shape[0]
    out = torch.zeros(rows, num_padded + 1, dtype=torch.bool, device=top_experts.device)
    safe = torch.clamp(top_experts, max=num_padded)
    out.scatter_(1, safe, True)
    return out[:, :num_padded]


def position_buckets(pos: torch.Tensor) -> torch.Tensor:
    """``(rows, N_POS_BUCKETS)`` one-hot of each row's decode-position
    bucket."""
    b = torch.clamp(pos // POS_BUCKET_SIZE, 0, N_POS_BUCKETS - 1)
    return b[..., None] == torch.arange(N_POS_BUCKETS, device=pos.device)


def pack_mirror_payload(routed: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """One rank's per-step mirror payload: ``[routed | buckets]`` flat."""
    return torch.cat([routed.reshape(-1), buckets.reshape(-1)])


def unpack_mirror_payload(packed: torch.Tensor, num_padded: int):
    """Inverse of :func:`pack_mirror_payload`; leading dims pass through."""
    rows = packed.shape[-1] // (num_padded + N_POS_BUCKETS)
    r_end = rows * num_padded
    lead = tuple(packed.shape[:-1])
    routed = packed[..., :r_end].reshape(lead + (rows, num_padded))
    buckets = packed[..., r_end:].reshape(lead + (rows, N_POS_BUCKETS))
    return routed, buckets


def predict_extra_score(sig: torch.Tensor, sigw: torch.Tensor) -> torch.Tensor:
    """The richer predictors' additive score: ``(..., 2, E) x (..., 2) ->
    (..., E)``, at most 2.0."""
    return torch.einsum("...s,...se->...e", sigw, sig)


def update_predictor(ema, aff, posb, sigw, routed, buckets):
    """Fold one step of exchanged routing into predictor slots (leading
    dims broadcast, so one call folds every mirror). ``routed`` (..., rows,
    E) bool, ``buckets`` (..., rows, N_POS_BUCKETS) bool. Returns ``(prev,
    ema, aff, posb, sig, sigw)``."""
    union = routed.any(dim=-2)
    uf = union.float()
    new_ema = EMA_DECAY * ema + (1.0 - EMA_DECAY) * uf
    rf = routed.float()
    bf = buckets.float()
    new_aff = AFF_DECAY * aff + (1.0 - AFF_DECAY) * rf
    new_posb = POS_DECAY * posb + (1.0 - POS_DECAY) * torch.einsum("...bn,...be->...ne", bf, rf)
    aff_sig = new_aff.amax(dim=-2)
    pos_sig = (bf @ new_posb).amax(dim=-2)
    sig = torch.stack([aff_sig, pos_sig], dim=-2)
    sig = sig / torch.clamp(sig.amax(dim=-1, keepdim=True), min=1e-6)
    qual = (sig * uf[..., None, :]).sum(dim=-1) / torch.clamp(uf.sum(dim=-1, keepdim=True), min=1.0)
    new_sigw = torch.clamp(SIGW_DECAY * sigw + (1.0 - SIGW_DECAY) * qual, 0.0, 1.0)
    return union, new_ema, new_aff, new_posb, sig, new_sigw


def schedule_digest(masks: torch.Tensor) -> torch.Tensor:
    """Integer-valued f32 digest of a derived schedule: the positionally
    weighted sum of the mask bits (weights ``i % 61 + 1``)."""
    flat = masks.reshape(-1).float()
    w = torch.arange(flat.shape[0], device=flat.device, dtype=torch.float32) % 61.0 + 1.0
    return (flat * w).sum()


# ==========================================================================
# Static wire-byte formulas (per rank): the per-step model the serving
# metrics attribute per request (``core.execution.
# gathered_wire_bytes_per_step``). What the landing copies really moved is
# ``LANDED``.
# ==========================================================================
def gather_bytes(placement: Placement, bytes_per_expert: int) -> int:
    """Remote expert bytes one rank pulls per layer under the full gather
    (the split and merged layouts ship the same wire bytes)."""
    return (placement.subgroup_size - 1) * placement.local_count * bytes_per_expert


def demand_fetch_bytes(placement: Placement, budget: int, bytes_per_expert: int, *,
                       validate: bool = False) -> int:
    """Wire bytes per rank per layer of the demand gather: the payload
    round's ``(G'-1) * budget`` padded expert rows plus the index round's
    bitmap (1 byte per expert from each subgroup peer), capped at the full
    remote gather, so the demand counters never exceed the all-fetch
    counterfactual. ``validate`` adds the f32 checksum table (4 bytes per
    expert from each subgroup peer) riding the index round."""
    g = placement.subgroup_size
    budget = min(budget, placement.local_count)
    meta = placement.num_padded * (5 if validate else 1)
    full = (g - 1) * placement.local_count * bytes_per_expert
    return min(full, (g - 1) * (budget * bytes_per_expert + meta))


def sync_free_fetch_bytes(placement: Placement, spec_budget: int, corr_budget: int, rows: int,
                          bytes_per_expert: int, *, validate: bool = False) -> dict:
    """Per-round wire bytes per rank per layer of the sync-free fetch,
    ``{"spec", "corr"}``: the speculative round is pure payload (both ends
    derive its schedule from the mirrored predictor); the correction round
    carries its payload and the residual bitmap (1 byte per expert from
    each subgroup peer) and, when ``validate``, the f32 checksum table
    that rides the same round. The mirror signals ship once per step
    (:func:`sync_free_mirror_bytes`). ``rows`` is unused, as in the JAX
    package's formula."""
    g = placement.subgroup_size
    e = placement.num_padded
    sb = min(spec_budget, placement.local_count)
    cb = min(corr_budget, placement.local_count)
    meta = e + (4 * e if validate else 0)
    return {
        "spec": (g - 1) * sb * bytes_per_expert,
        "corr": (g - 1) * (cb * bytes_per_expert + meta),
    }


def sync_free_mirror_bytes(placement: Placement, rows: int) -> int:
    """Per-step wire bytes of the one mirror-fold all-gather
    (:func:`pack_mirror_payload`: ``rows`` routed bitmaps and position
    one-hots, 1 byte per bit from each subgroup peer), shared by every
    sync-free layer of the step."""
    g = placement.subgroup_size
    return (g - 1) * (rows * placement.num_padded + rows * N_POS_BUCKETS)


# ==========================================================================
# Payload validation: per-row checksums against the owners' table.
# ==========================================================================
#: Relative / absolute tolerance of the checksum compare. The checksum is a
#: positionally weighted sum of squared elements in f32; its two ends may
#: reduce in different orders, so exact equality is wrong, but every
#: modelled fault (a zeroed, dropped or ``w -> 1 - w`` row) moves it by
#: orders of magnitude more than f32 rounding. Corruption below the
#: tolerance is out of scope, as hash collisions are for real checksums.
CHECKSUM_RTOL = 1e-2
CHECKSUM_ATOL = 1e-6
#: The positional weights' period: weight ``i % 61 + 1`` on flat element i.
_CS_PERIOD = 61
#: Elements of one leaf reduced at once: bounds the f32 temporary where a
#: reduction upcasts by copying (the CPU); on CUDA the bf16 norm reads its
#: input in place and accumulates in f32.
_CS_CHUNK = 1 << 27


def _cs_weights(n: int, device=None) -> torch.Tensor:
    """The positional weights ``i % 61 + 1`` of ``n`` flat elements: an
    exchange of unequal elements within a row moves the checksum too."""
    return torch.arange(n, dtype=torch.float32, device=device) % float(_CS_PERIOD) + 1.0


def _leaf_checksums(w: torch.Tensor) -> torch.Tensor:
    """``(rows,)`` f32 ``sum_i (i % 61 + 1) * w[r, i]**2`` of one leaf. The
    first ``block * m`` elements of a row (``block`` a multiple of 61, up to
    61 x 32 = 1952 contiguous elements), seen as ``(m, block)``, reduce per
    column with an f32 2-norm (its square is the column's sum of squares),
    and column ``j`` takes weight ``j % 61 + 1``; the tail of fewer than
    ``block`` elements is summed directly. Rows go in chunks of at most
    :data:`_CS_CHUNK` elements, so no f32 copy of a whole payload exists."""
    rows = w.shape[0]
    flat = w.reshape(rows, -1)
    n = flat.shape[1]
    block = _CS_PERIOD * max(1, min(32, n // (_CS_PERIOD * 64)))
    main = n - n % block
    k = _cs_weights(block, w.device)
    step = max(1, _CS_CHUNK // max(1, n))
    parts = []
    for i in range(0, rows, step):
        x = flat[i:i + step]
        s = torch.zeros(x.shape[0], dtype=torch.float32, device=w.device)
        if main:
            cols = torch.linalg.vector_norm(x[:, :main].reshape(x.shape[0], main // block, block),
                                            dim=1, dtype=torch.float32)
            s = (cols * cols * k).sum(dim=1)
        if n > main:
            tail = x[:, main:].float()
            s = s + (tail * tail * k[:n - main]).sum(dim=1)
        parts.append(s)
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.float32, device=w.device)


def row_checksums(tree: PyTree) -> torch.Tensor:
    """``(rows,)`` f32 checksum per leading-dim row of a weight tree: over
    its leaves (in key order), the positionally weighted sum of squared
    elements (the JAX package's ``row_checksums``; squares make any nonzero
    row's checksum positive, so zeroed and dropped rows never match)."""
    if isinstance(tree, dict):
        total = None
        for key in sorted(tree):
            s = row_checksums(tree[key])
            total = s if total is None else total + s
        assert total is not None, "row_checksums of an empty tree"
        return total
    return _leaf_checksums(tree)


def checksum_table(shards: list, rank: int, placement: Placement) -> torch.Tensor:
    """The checksum wire format of ``rank``'s subgroup: each member's
    ``(local,)`` checksums of its resident rows, concatenated in position
    order into the canonical ``(num_padded,)`` table (position ``o`` owns
    ids ``[o * local, (o + 1) * local)``) — the JAX package's all-gather of
    the resident checksums. 4 bytes per expert, counted in the index
    round's bytes (``demand_fetch_bytes(validate=True)``)."""
    parts = [row_checksums(shards[q]) for q in subgroup_ranks(rank, placement)]
    return torch.cat(parts)[:placement.num_padded]


def verify_rows(tree: PyTree, ids: torch.Tensor, valid: torch.Tensor,
                table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-checksum arrived or cached rows against the owners' table:
    ``(verified_valid, bad)``, where ``verified_valid`` is ``valid`` with the
    mismatched rows masked out (they go to the correction round or the
    full-gather fallback, the repair) and ``bad`` flags exactly the valid
    but mismatched rows (the detection counters). Padding rows (``valid``
    False) are never flagged."""
    if valid.shape[0] == 0:
        return valid, valid
    got = row_checksums(tree)
    want = table[ids]
    ok = torch.abs(got - want) <= CHECKSUM_RTOL * torch.abs(want) + CHECKSUM_ATOL
    bad = valid & ~ok
    return valid & ok, bad


@torch.no_grad()
def attach_checksum_tables(params: list, model) -> list:
    """Store every MoE layer's checksum table in the weight set, once:
    ``lp["moe"]["checksums"]``, the ``(num_padded,)`` f32 table of the
    rank's subgroup (``(n_cycles, num_padded)`` in a scanned group), on
    the weights' device. The JAX package rebuilds the table from the
    resident rows in every validated layer of every step; no fault it
    models touches a resident row, so the table of a weight set is the same
    bits at every step, and building it once spares each step a read of
    every resident expert (at DeepSeek-R1 width 4 ranks x 64 rows x 88 MB,
    22.5 GB per MoE layer). Returns ``params``; tables already present are
    kept."""
    pl = model.geom.moe_placement
    if model.cfg.moe is None or pl is None:
        return params
    local_cs: dict = {}  # one checksum pass per distinct resident tensor

    def local(tree, c=None) -> torch.Tensor:
        key = (id(tree["w_gate"]), c)  # the params hold the tensors: ids stay unique
        if key not in local_cs:
            local_cs[key] = row_checksums(tree if c is None else {k: v[c] for k, v in tree.items()})
        return local_cs[key]

    for group in model.plan:
        for j, sig in enumerate(group.sigs):
            if not sig.is_moe:
                continue
            lps = [p["layers"][group.name][f"pos{j}"] for p in params]
            if all("checksums" in lp["moe"] for lp in lps):
                continue
            shared: dict = {}  # one table per subgroup, shared like the weights
            for r, lp in enumerate(lps):
                members = [lps[q]["moe"]["experts"] for q in subgroup_ranks(r, pl)]
                key = tuple(id(m["w_gate"]) for m in members)
                if key not in shared:
                    if group.scan:
                        shared[key] = torch.stack([
                            torch.cat([local(m, c) for m in members])[:pl.num_padded]
                            for c in range(group.n_cycles)])
                    else:
                        shared[key] = torch.cat([local(m) for m in members])[:pl.num_padded]
                lp["moe"]["checksums"] = shared[key]
    return params
