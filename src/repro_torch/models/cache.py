"""Decode-time state: per-rank KV caches (ring-buffered), structured to
mirror the layer plan. The port of ``repro.models.cache`` for attention
layers.

A decode state is a plain dict::

    {"pos": (B,) int32, "layers": {group: {posJ: [rank0, rank1, ...]}}}

where each rank entry is ``{"k", "v", "slot_pos"}`` holding that rank's
slice of the ring: with the KV cache sequence-sharded over ``n`` ranks,
rank ``i`` owns ring slots ``[i*L/n, (i+1)*L/n)`` — the JAX package's
``P(batch, seq)`` layout, one separate allocation per logical rank.
Scan groups carry a leading cycle axis on every leaf.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.models.transformer import LayerSig, Model


def attn_cache_len(sig: LayerSig, seq_len: int) -> int:
    if sig.window:
        return min(sig.window, seq_len)
    return seq_len


def init_layer_state(cfg: ArchConfig, sig: LayerSig, batch: int, length: int,
                     dtype, device) -> dict:
    if sig.kind not in (BlockKind.GLOBAL_ATTN, BlockKind.LOCAL_ATTN):
        raise NotImplementedError(f"decode state for {sig.kind} is not ported yet")
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros(batch, length, kh, hd, dtype=dtype, device=device),
        "v": torch.zeros(batch, length, kh, hd, dtype=dtype, device=device),
        "slot_pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }


def init_decode_state(model: Model, batch: int, seq_len: int, *,
                      seq_shards: int = 1, prefilled=0) -> dict:
    """``seq_shards`` ranks split each ring; ``prefilled`` is a scalar or
    a (batch,) per-row fill depth."""
    cfg, dev = model.cfg, model.device
    layers: dict = {}
    for group in model.plan:
        gdict = {}
        for j, sig in enumerate(group.sigs):
            length = attn_cache_len(sig, seq_len)
            if length % seq_shards:
                raise ValueError(
                    f"cache length {length} must divide over {seq_shards} "
                    "sequence shards"
                )
            ranks = []
            for _ in range(seq_shards):
                st = init_layer_state(
                    cfg, sig, batch, length // seq_shards, model.dtype, dev
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
