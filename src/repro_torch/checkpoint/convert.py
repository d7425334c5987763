"""Weights carried across from the JAX package.

``from_jax_params`` takes the JAX ``Model.init_params`` tree (global
arrays with their leading shard axes, as nested dicts of numpy arrays)
and returns the port's per-logical-rank trees, following the JAX
package's partition specs (``transformer.py:332-452``): ``embed`` split
by rows over ``model``, ``lm_head`` by columns, attention / FFN / expert
stacks along their leading shard axis, router and norms replicated,
the recurrent (``rec``: RG-LRU) and cell (``cell``: mLSTM / sLSTM) trees
replicated too (``a_param`` kept in float32, as the JAX package keeps it),
scan groups keeping their leading cycle axis. On a mesh with data
replicas the JAX tree is the one of the ``(1, G)`` geometry (the weights
are sharded over ``model`` only) and rank ``d * G + m`` shares model rank
``m``'s tensors (``transformer.replicate_over_data``). ``load_npz`` reads the
``save_pytree`` layout (``key@chunkN`` entries plus ``__tree_meta__``)
with numpy alone.
"""
from __future__ import annotations

import contextlib
import json
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import BlockKind
from repro_torch.core.prefetch import attach_checksum_tables
from repro_torch.kernels._launch import FP8_DTYPES
from repro_torch.models.transformer import Model, ffn_pad, replicate_over_data, split_leading

_META = "__tree_meta__"


def _bf16_to_f32(arr: np.ndarray) -> np.ndarray:
    """bfloat16 stored as 2-byte words -> float32 (exact)."""
    return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


#: ml_dtypes' fp8 types (the JAX package's fp8 leaves), by numpy dtype name
_FP8_LEAVES = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    fp8 = _FP8_LEAVES.get(arr.dtype.name)
    if fp8 is not None:  # torch.from_numpy takes no fp8 array: carry its bytes
        raw = torch.from_numpy(np.array(arr, copy=True, order="C").view(np.uint8))
        return raw.view(fp8).to(device=device, dtype=dtype)
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
    for the same model axis and geometry overrides as ``model`` (a
    ``load_npz`` tree too), with the experts' checksum tables of the
    validated fetch built once (``prefetch.attach_checksum_tables``)."""
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
            for r in range(n):
                trees[r]["norm1"] = norm1
            if "attn" in lp:
                wq = np.asarray(lp["attn"]["wq"])
                if wq.shape[1 if scan else 0] != geom.attn_shards:
                    raise ValueError(
                        f"attention stack {wq.shape} != attn_shards {geom.attn_shards}: build "
                        "the JAX model with the same geometry overrides"
                    )
                attn = {k: split(lp["attn"][k], geom.attn_axes, scan)
                        for k in ("wq", "wk", "wv", "wo")}
                for r in range(n):
                    trees[r]["attn"] = {k: attn[k][r] for k in attn}
            else:  # rec / cell: replicated at serve time, one tree for every rank
                key = "rec" if "rec" in lp else "cell"
                mixer = {k: _tensor(v, torch.float32, dev) if k == "a_param" else t(v)
                         for k, v in lp[key].items()}
                for r in range(n):
                    trees[r][key] = mixer
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
    return attach_checksum_tables(replicate_over_data(ranks, sizes), model)


def to_checkpoint(params: list, model: Model, *, pin_memory: bool = False) -> dict:
    """The inverse of :func:`from_jax_params`: the JAX package's parameter
    tree (global leaves with their leading shard axes, the ``(1, G)``
    geometry's) from the port's per-rank list, in host memory (page-locked
    with ``pin_memory``, where a copy from it to the card runs
    asynchronously). A leaf every model rank shares (replicated, or a family
    the model axis does not split) is copied once; the ranks' blocks of a
    sharded leaf land side by side along its shard axis, each copied
    straight into its slice. The experts' checksum tables are left out: a
    weight set builds its own (``prefetch.attach_checksum_tables``)."""
    ranks = params[:model.geom.model_size]

    def host(leaves: list, axis: int) -> torch.Tensor:
        if all(t is leaves[0] for t in leaves):
            leaves = leaves[:1]
        shape = list(leaves[0].shape)
        shape[axis] = sum(t.shape[axis] for t in leaves)
        out = torch.empty(shape, dtype=leaves[0].dtype, pin_memory=pin_memory)
        offset = 0
        for t in leaves:
            out.narrow(axis, offset, t.shape[axis]).copy_(t)
            offset += t.shape[axis]
        return out

    def walk(trees: list, axis: int):
        if isinstance(trees[0], dict):
            return {k: walk([t[k] for t in trees], axis) for k in trees[0] if k != "checksums"}
        return host(trees, axis)

    tree = {"embed": host([p["embed"] for p in ranks], 0),
            "final_norm": host([ranks[0]["final_norm"]], 0), "layers": {}}
    if "lm_head" in ranks[0]:
        tree["lm_head"] = host([p["lm_head"] for p in ranks], 1)
    for group in model.plan:
        tree["layers"][group.name] = walk([p["layers"][group.name] for p in ranks],
                                          1 if group.scan else 0)
    return tree


def _get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path: tuple, value) -> None:
    _get(tree, path[:-1])[path[-1]] = value


def _specs(model: Model) -> tuple:
    """How each sharded or padded leaf of a per-rank tree splits one
    canonical axis, ``{path: (axis, blocks, block of each model rank, block
    size, real length, source axis, source step)}`` (the axis and size are
    the per-rank leaf's; the real length excludes the geometry's padding;
    the dead position's block in a checkpoint leaf is ``narrow(source axis,
    position * step, step)``), and the paths of the expert banks with their
    expert axis. Leaves in neither are replicated."""
    cfg, geom = model.cfg, model.geom
    n = geom.model_size
    a, ksd = geom.attn_shards, geom.kv_shard
    v_l = geom.vocab_pad // n
    specs = {("embed",): (0, n, list(range(n)), v_l, cfg.vocab_size, 0, v_l)}
    if not cfg.tie_embeddings:
        specs[("lm_head",)] = (1, n, list(range(n)), v_l, cfg.vocab_size, 1, v_l)
    experts = {}

    def blocks_of(count):
        return [r if count > 1 else 0 for r in range(n)]

    kv_table = [r // (a // ksd) if a > 1 else 0 for r in range(n)]
    for group in model.plan:
        lead = 1 if group.scan else 0
        for j, sig in enumerate(group.sigs):
            base = ("layers", group.name, f"pos{j}")
            if sig.kind in (BlockKind.GLOBAL_ATTN, BlockKind.LOCAL_ATTN):
                specs[base + ("attn", "wq")] = (lead + 2, a, blocks_of(a), cfg.q_dim // a,
                                                cfg.q_dim, lead, 1)
                specs[base + ("attn", "wo")] = (lead + 1, a, blocks_of(a), cfg.q_dim // a,
                                                cfg.q_dim, lead, 1)
                for leaf in ("wk", "wv"):
                    specs[base + ("attn", leaf)] = (lead + 2, ksd, kv_table,
                                                    cfg.kv_dim // ksd, cfg.kv_dim, lead, 1)
            ffn = None
            if sig.is_moe:
                pl = geom.moe_placement
                specs[base + ("moe", "router")] = (lead + 1, 1, [0] * n, pl.num_padded,
                                                   cfg.moe.num_experts, None, None)
                experts[base + ("moe", "experts")] = lead
                if cfg.moe.shared_d_ff:
                    ffn = (base + ("moe", "shared"), cfg.moe.shared_d_ff)
            elif sig.ffn_dim:
                ffn = (base + ("ffn",), sig.ffn_dim)
            if ffn is not None:
                s = geom.ffn_shards
                size = ffn_pad(ffn[1], s) // s
                for leaf, axis in (("w_gate", lead + 2), ("w_up", lead + 2),
                                   ("w_down", lead + 1)):
                    specs[ffn[0] + (leaf,)] = (axis, s, blocks_of(s), size, ffn[1], lead, 1)
    return specs, experts


def _resplit(old_blocks: list, axis: int, size: int, blocks: int, real: int,
             like: torch.Tensor) -> list:
    """New blocks of ``size`` along ``axis``, of ``like``'s dtype and device
    (a survivor's leaf), from the old blocks (block ``q`` covering ``[q *
    old size, (q + 1) * old size)`` of the canonical axis): one copy per
    overlap of real indices, padding zeros. One unpadded block that keeps
    its size is kept as it is."""
    old_size = like.shape[axis]
    if blocks == len(old_blocks) == 1 and size == old_size == real:
        return [old_blocks[0]]
    out = []
    for k in range(blocks):
        shape = list(like.shape)
        shape[axis] = size
        t = torch.zeros(shape, dtype=like.dtype, device=like.device)
        i, hi = k * size, min((k + 1) * size, real)
        while i < hi:
            q = i // old_size
            stop = min(hi, (q + 1) * old_size)
            t.narrow(axis, i - k * size, stop - i).copy_(
                old_blocks[q].narrow(axis, i - q * old_size, stop - i), non_blocking=True)
            i = stop
        out.append(t)
    return out


@contextlib.contextmanager
def _timed(pairs: list):
    """A CUDA event pair around the block, appended to ``pairs``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    pairs.append((start, end))


def reshard_params(params: list, old: Model, new: Model, dead: int, source: dict, *,
                   free: bool = False, events: Optional[dict] = None) -> list:
    """The per-rank parameter list of ``new``, the same model on the mesh
    with one ``model`` rank fewer, from ``params`` (``old``'s) after model
    position ``dead`` died: the standby's weights after a rank death.

    ``source`` is the checkpoint in ``old``'s storage layout (the tree
    :func:`from_jax_params` takes or :func:`to_checkpoint` makes; numpy or
    torch, on the host or the card). The expert banks move with
    ``prefetch.reshard_split_bank``: the survivors' rows device to device,
    the dead rank's from ``source``. Every other sharded or padded leaf is
    split again for the new geometry, each new block copied from the
    survivors' blocks and, for the dead position's block, from ``source``:
    an attention that the new model axis does not divide becomes one tensor
    shared by every rank, and the vocabulary, the FFN widths and the
    router's expert columns take the new padding, as zeros. The dead rank's
    leaves are never read; replicated leaves (norms) carry over. ``free``
    drops each old leaf from ``params``' trees as its new one lands (the
    experts first) and, on the card, returns its memory at once, so the old
    weights go as the new arrive and no new leaf is carved out of a freed
    old block (which would keep the rest of that block from any other use):
    on one card this is how a standby fits beside them. ``events`` (CUDA):
    ``{kind: [(start, end), ...]}``, CUDA events around the expert copies by
    kind (``prefetch.RESHARD_KINDS``, per MoE layer) and around each other
    leaf's copies (``"other"``). The experts' checksum tables are built for
    the new weight set."""
    from repro_torch.core.prefetch import reshard_split_bank

    if old.dtype in FP8_DTYPES:
        raise NotImplementedError(f"reshard_params: a rank death of an fp8-stored model "
                                  f"({old.dtype}) is not ported for fp8")
    g_old, g_new = old.geom.model_size, new.geom.model_size
    rest = lambda m: {a: v for a, v in m.sizes.items() if a != "model"}  # noqa: E731
    if new.cfg != old.cfg or g_new != g_old - 1 or rest(new) != rest(old):
        raise ValueError(f"reshard_params takes the model axis from {g_old} to {g_old - 1} "
                         f"ranks of one model, got {old.sizes} -> {new.sizes}")
    dead = int(dead)
    if not 0 <= dead < g_old:
        raise ValueError(f"the dead model position {dead} is not in [0, {g_old})")
    live = [m for m in range(g_old) if m != dead]
    on_card = params[live[0]]["embed"].device.type == "cuda"
    old_specs, old_experts = _specs(old)
    new_specs, _ = _specs(new)

    def skeleton(tree):
        return {k: skeleton(v) for k, v in tree.items() if k != "checksums"} \
            if isinstance(tree, dict) else tree

    ranks = [skeleton(params[live[0]]) for _ in range(g_new)]

    def land(path, fresh, drop=()) -> None:
        for r in range(g_new):
            _put(ranks[r], path, fresh[r])
        if free:
            for tree in params:
                for key in (path[-1], *drop):
                    _get(tree, path[:-1]).pop(key, None)
            if on_card:
                # return the old blocks to the card now: a later leaf carved
                # out of them would pin each one, free but unusable
                torch.cuda.empty_cache()

    for path, axis in old_experts.items():
        kinds: dict = {} if events is not None else None
        out = reshard_split_bank([_get(params[m], path) for m in range(g_old)],
                                 old.geom.moe_placement, new.geom.moe_placement, dead,
                                 _get(source, path), events=kinds, axis=axis)
        for kind, pair in (kinds or {}).items():
            events.setdefault(kind, []).append(pair)
        land(path, out, drop=("checksums",))
        del out
    for path, (axis, blocks, table, _, real, src_axis, step) in old_specs.items():
        old_blocks = []
        for q in range(blocks):
            holder = next((m for m in live if table[m] == q), None)
            if holder is not None:
                old_blocks.append(_get(params[holder], path))
            else:
                src = torch.as_tensor(_get(source, path))
                old_blocks.append(src.narrow(src_axis, dead * step, step))
        _, n_blocks, new_table, size, _, _, _ = new_specs[path]
        with (_timed(events.setdefault("other", [])) if events is not None
              else contextlib.nullcontext()):
            fresh = _resplit(old_blocks, axis, size, n_blocks, real,
                             _get(params[live[0]], path))
        del old_blocks
        land(path, [fresh[new_table[r]] for r in range(g_new)])
        del fresh
    return attach_checksum_tables(replicate_over_data(ranks, new.sizes), new)
