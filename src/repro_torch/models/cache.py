"""Decode-time state: per-rank KV caches (ring-buffered) and recurrent
states, structured to mirror the layer plan. The port of
``repro.models.cache``.

A decode state is a plain dict::

    {"pos": (B,) int32, "layers": {group: {posJ: [rank0, rank1, ...]}}}

where each rank entry of an attention layer is ``{"k", "v", "slot_pos"}``
holding that rank's block of rows and slice of the ring: with the rows sharded into ``b``
blocks and the ring into ``n`` shards, the rank at batch index ``j`` and
sequence index ``i`` holds rows ``[j*B/b, (j+1)*B/b)`` and ring slots
``[i*L/n, (i+1)*L/n)`` — the JAX package's ``P(batch, seq)`` layout, one
separate allocation per logical rank. ``RingLayout`` records which block
each entry of a list holds; ``read_row`` and ``write_row`` move one row's
whole ring between two layouts (the context server's KV handed to a
generation server that shards it otherwise), and ``relayout`` a whole
state. The recurrent layers' states (RG-LRU ``{"conv", "h"}``, mLSTM
``{"C", "n", "m"}``, sLSTM ``{"c", "n", "h", "m"}``) are not ring-laid:
every rank of a block of rows holds its rows' whole state (the JAX
package's ``P(batch, None)``), and the three functions carry it whole.
Scan groups carry a leading cycle axis on every leaf.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.models.transformer import LayerSig, Model
from repro_torch.models.xlstm import init_mlstm_state, init_slstm_state


class RingLayout(NamedTuple):
    """Where the entries of a state's per-rank lists sit: ``shards`` holds
    each entry's ``(batch index, sequence index)``, in list order: its block
    of rows (as many rows as the entry holds) and its slice of the ring (one
    of ``seq_shards``). Entries at the same indices are copies (ranks that
    replicate)."""

    seq_shards: int
    shards: tuple

    @classmethod
    def of_plan(cls, xp) -> "RingLayout":
        """The layout of a state made or read under ``xp`` (one entry per
        logical rank)."""
        return cls(xp.seq_shards,
                   tuple((xp.batch_index(r), xp.seq_index(r)) for r in range(xp.n_ranks)))

    @classmethod
    def sequence(cls, n: int) -> "RingLayout":
        """``n`` ring slices of the same rows, in order."""
        return cls(n, tuple((0, i) for i in range(n)))


def _entries(ranks: list, layout: RingLayout, block: int) -> list:
    """One entry per ring slice of row block ``block``, in slice order."""
    by_seq: dict = {}
    for entry, (b, s) in zip(ranks, layout.shards, strict=True):
        if b == block:
            by_seq.setdefault(s, entry)
    if sorted(by_seq) != list(range(layout.seq_shards)):
        raise ValueError(f"layout {layout} misses ring slices of row block {block}")
    return [by_seq[s] for s in range(layout.seq_shards)]


def _rows(entry: dict, bax: int) -> int:
    return next(iter(entry.values())).shape[bax]


def read_row(model: Model, layers: dict, layout: RingLayout, row: int) -> dict:
    """Row ``row``'s whole ring, ``{group: {posJ: {field: (L, ...)}}}``
    (scan groups ``(cycles, L, ...)``), gathered from the ranks that hold it
    in ``layout``; a recurrent layer's state (no ring) is the row's, read
    from the first of them."""
    out = {}
    for group in model.plan:
        bax = 1 if group.scan else 0
        gd = {}
        for key, ranks in layers[group.name].items():
            block, local = divmod(row, _rows(ranks[0], bax))
            parts = _entries(ranks, layout, block)
            idx = (slice(None),) * bax + (local,)
            if "slot_pos" not in parts[0]:
                gd[key] = {f: t[idx] for f, t in parts[0].items()}
                continue
            gd[key] = {f: torch.cat([p[f][idx] for p in parts], dim=bax) for f in parts[0]}
        out[group.name] = gd
    return out


def write_row(model: Model, layers: dict, layout: RingLayout, row: int, ring: dict) -> None:
    """Write one row's whole ring (as :func:`read_row` returns it) into every
    rank that holds row ``row`` in ``layout``, each its own ring slice (a
    recurrent layer's state whole into each), in place (the tensors are
    written, never rebound)."""
    for group in model.plan:
        bax = 1 if group.scan else 0
        for key, ranks in layers[group.name].items():
            block, local = divmod(row, _rows(ranks[0], bax))
            for entry, (b, s) in zip(ranks, layout.shards, strict=True):
                if b != block:
                    continue
                ringed = "slot_pos" in entry
                for f, dst in entry.items():
                    src = ring[group.name][key][f]
                    if ringed:
                        n = dst.shape[bax + 1]
                        src = src[(slice(None),) * bax + (slice(s * n, (s + 1) * n),)]
                    dst[(slice(None),) * bax + (local,)] = src.to(dst.device, dst.dtype)


def relayout(model: Model, state: dict, dst: RingLayout) -> dict:
    """``state``, held in its ``"layout"``, laid out again in ``dst``: each
    row's whole ring read and written into new per-rank entries (the JAX
    package's global state resharded between two plans, say a prefill
    whose prompt does not divide over ``model`` feeding a decode whose ring
    does)."""
    src = state["layout"]
    lengths = [ranks[0]["slot_pos"].shape[-1] * src.seq_shards
               for group in model.plan for ranks in state["layers"][group.name].values()
               if "slot_pos" in ranks[0]]
    batch = state["pos"].shape[0]
    out = init_decode_state(model, batch, max(lengths, default=1), seq_shards=dst.seq_shards,
                            batch_shards=len({b for b, _ in dst.shards}))
    for row in range(batch):
        write_row(model, out["layers"], dst, row, read_row(model, state["layers"], src, row))
    return {**state, "layers": out["layers"], "layout": dst}


def attn_cache_len(sig: LayerSig, seq_len: int) -> int:
    if sig.window:
        return min(sig.window, seq_len)
    return seq_len


def is_ringed(sig: LayerSig) -> bool:
    """An attention layer's state is a KV ring; the recurrent kinds' are not."""
    return sig.kind in (BlockKind.GLOBAL_ATTN, BlockKind.LOCAL_ATTN)


def init_layer_state(cfg: ArchConfig, sig: LayerSig, batch: int, length: int,
                     dtype, device) -> dict:
    """One rank's state of one layer: ``length`` ring slots of an attention
    layer, or a recurrent layer's state (``length`` unused)."""
    if sig.kind == BlockKind.RECURRENT:
        return {
            "conv": torch.zeros(batch, 3, cfg.d_model, dtype=dtype, device=device),
            "h": torch.zeros(batch, cfg.d_model, dtype=dtype, device=device),
        }
    if sig.kind == BlockKind.MLSTM:
        return init_mlstm_state(batch, cfg.num_heads, cfg.d_model // cfg.num_heads, dtype, device)
    if sig.kind == BlockKind.SLSTM:
        return init_slstm_state(batch, cfg.d_model, dtype, device)
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros(batch, length, kh, hd, dtype=dtype, device=device),
        "v": torch.zeros(batch, length, kh, hd, dtype=dtype, device=device),
        "slot_pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }


def init_decode_state(model: Model, batch: int, seq_len: int, *,
                      seq_shards: int = 1, batch_shards: int = 1, prefilled=0) -> dict:
    """One entry per logical rank: ``batch_shards`` blocks of the rows and
    ``seq_shards`` slices of each ring (a plan's ``batch_shards`` and
    ``seq_shards``; which rank holds which is ``RingLayout.of_plan``);
    ``prefilled`` is a scalar or a (batch,) per-row fill depth."""
    cfg, dev = model.cfg, model.device
    if batch % batch_shards:
        raise ValueError(f"batch {batch} must divide over {batch_shards} batch shards")
    layers: dict = {}
    for group in model.plan:
        gdict = {}
        for j, sig in enumerate(group.sigs):
            length = attn_cache_len(sig, seq_len) if is_ringed(sig) else 0
            if length % seq_shards:
                raise ValueError(
                    f"cache length {length} must divide over {seq_shards} "
                    "sequence shards"
                )
            ranks = []
            for _ in range(model.n_ranks):
                st = init_layer_state(
                    cfg, sig, batch // batch_shards, length // seq_shards, model.dtype, dev
                )
                if group.scan:
                    st = {k: v[None].repeat((group.n_cycles,) + (1,) * v.ndim)
                          for k, v in st.items()}
                ranks.append(st)
            gdict[f"pos{j}"] = ranks
        layers[group.name] = gdict
    pos = torch.as_tensor(prefilled, dtype=torch.int32, device=dev)
    pos = torch.broadcast_to(pos, (batch,)).clone()
    return {"pos": pos, "layers": layers}
