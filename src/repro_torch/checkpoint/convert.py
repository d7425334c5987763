"""Weights carried across from the JAX package.

``from_jax_params`` takes the JAX ``Model.init_params`` tree (global
arrays with their leading shard axes, as nested dicts of numpy arrays)
and returns the port's per-logical-rank trees, following the JAX
package's partition specs (``transformer.py:332-452``): ``embed`` split
by rows over ``model``, ``lm_head`` by columns, attention / FFN / expert
stacks along their leading shard axis, router and norms replicated,
scan groups keeping their leading cycle axis. On a mesh with data
replicas the JAX tree is the one of the ``(1, G)`` geometry (the weights
are sharded over ``model`` only) and rank ``d * G + m`` shares model rank
``m``'s tensors (``transformer.replicate_over_data``). ``load_npz`` reads the
``save_pytree`` layout (``key@chunkN`` entries plus ``__tree_meta__``)
with numpy alone.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.models.transformer import Model, ffn_pad, replicate_over_data, split_leading

_META = "__tree_meta__"


def _bf16_to_f32(arr: np.ndarray) -> np.ndarray:
    """bfloat16 stored as 2-byte words -> float32 (exact)."""
    return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def _tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        arr = _bf16_to_f32(arr)
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(device=device, dtype=dtype)


def load_npz(path: str) -> dict:
    """Read a ``save_pytree`` checkpoint into nested dicts of numpy arrays
    (bfloat16 leaves come back as float32, which holds them exactly)."""
    out: dict = {}
    with np.load(path) as data:
        meta = json.loads(bytes(data[_META].tobytes()).decode())["meta"]
        for key, info in meta.items():
            if info["chunks"]:
                arr = np.concatenate([data[f"{key}@chunk{i}"] for i in range(info["chunks"])])
            else:
                arr = data[key]
            if info["dtype"] == "bfloat16":
                arr = _bf16_to_f32(arr)
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return out


def from_jax_params(params: dict, model: Model, device=None) -> list[dict]:
    """The port's per-rank parameter list from a JAX parameter tree built
    for the same model axis and geometry overrides as ``model``."""
    cfg, geom = model.cfg, model.geom
    sizes = model.sizes
    dev = torch.device(device) if device is not None else model.device
    dt = model.dtype
    n = geom.model_size

    def t(a):
        return _tensor(a, dt, dev)

    def split(a, axes, scan):
        return split_leading(t(a), axes, sizes, axis=1 if scan else 0)

    embed = np.asarray(params["embed"])
    if embed.shape != (geom.vocab_pad, cfg.d_model):
        raise ValueError(f"embed {embed.shape} != (vocab_pad {geom.vocab_pad}, {cfg.d_model})")
    embeds = [c.contiguous() for c in torch.chunk(t(embed), n, dim=0)]
    heads = None
    if not cfg.tie_embeddings:
        heads = [c.contiguous() for c in torch.chunk(t(params["lm_head"]), n, dim=1)]
    final_norm = t(params["final_norm"])
    ranks = [{"embed": embeds[r], "final_norm": final_norm, "layers": {}} for r in range(n)]
    if heads is not None:
        for r in range(n):
            ranks[r]["lm_head"] = heads[r]

    def ffn_tree(fp, dim, scan):
        s = geom.ffn_shards
        lead = 1 if scan else 0
        wg = np.asarray(fp["w_gate"])
        if wg.shape[lead] != s or wg.shape[lead] * wg.shape[lead + 2] != ffn_pad(dim, s):
            raise ValueError(
                f"FFN stack {wg.shape} disagrees with ffn_shards {s} and padded dim {ffn_pad(dim, s)}"
            )
        per = {k: split(fp[k], geom.ffn_axes, scan) for k in ("w_gate", "w_up", "w_down")}
        return [{k: per[k][r] for k in per} for r in range(n)]

    for group in model.plan:
        scan = group.scan
        for r in range(n):
            ranks[r]["layers"][group.name] = {}
        for j, sig in enumerate(group.sigs):
            lp = params["layers"][group.name][f"pos{j}"]
            trees = [{} for _ in range(n)]
            norm1 = t(lp["norm1"])
            wq = np.asarray(lp["attn"]["wq"])
            if wq.shape[1 if scan else 0] != geom.attn_shards:
                raise ValueError(
                    f"attention stack {wq.shape} != attn_shards {geom.attn_shards}: build "
                    "the JAX model with the same geometry overrides"
                )
            attn = {k: split(lp["attn"][k], geom.attn_axes, scan) for k in ("wq", "wk", "wv", "wo")}
            for r in range(n):
                trees[r]["norm1"] = norm1
                trees[r]["attn"] = {k: attn[k][r] for k in attn}
            if "norm2" in lp:
                norm2 = t(lp["norm2"])
                for r in range(n):
                    trees[r]["norm2"] = norm2
            if sig.is_moe:
                mp = lp["moe"]
                pl = geom.moe_placement
                router = np.asarray(mp["router"])
                if router.shape[-1] != pl.num_padded:
                    raise ValueError(f"router {router.shape} != num_padded {pl.num_padded}")
                lead = 1 if scan else 0
                wg = np.asarray(mp["experts"]["w_gate"])
                if wg.shape[lead] != pl.storage_size:
                    raise ValueError(f"expert stack {wg.shape} != storage {pl.storage_size}")
                ex = {k: split(mp["experts"][k], geom.expert_axes, scan)
                      for k in ("w_gate", "w_up", "w_down")}
                router_t = t(router)
                shared = ffn_tree(mp["shared"], cfg.moe.shared_d_ff, scan) if "shared" in mp else None
                for r in range(n):
                    trees[r]["moe"] = {"router": router_t, "experts": {k: ex[k][r] for k in ex}}
                    if shared is not None:
                        trees[r]["moe"]["shared"] = shared[r]
            elif sig.ffn_dim:
                ff = ffn_tree(lp["ffn"], sig.ffn_dim, scan)
                for r in range(n):
                    trees[r]["ffn"] = ff[r]
            for r in range(n):
                ranks[r]["layers"][group.name][f"pos{j}"] = trees[r]
    return replicate_over_data(ranks, sizes)
