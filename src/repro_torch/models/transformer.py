"""Layer plan, weight geometry and per-rank parameter init for the port.

The port of ``repro.models.transformer``. Every shardable weight carries
an explicit leading *shard axis*, as in the JAX package:

- dense FFN:       (S, D, F/S) / (S, F/S, D)      S = geom.ffn_shards
- MoE experts:     (G*local, D, Fe) / (..., Fe, D) placement-expanded
- attention:       (A, D, qdim/A) etc.             A = geom.attn_shards
- embed/lm_head:   vocab-sharded over "model"
- recurrent / cell (``rec``, ``cell``): replicated at serve time

The port holds the model as one parameter tree per logical rank
(``Model.init_params`` returns a list, rank ``r = d * G + m`` at data
index ``d`` and model index ``m``): each tree is what that rank holds
inside the JAX package's ``shard_map`` — leading shard dims of the local
size, vocab slices of the embedding and head — under the JAX key names.
Replicated leaves (norms, the router, replicated families) are one tensor
shared by every rank's tree. The weights are sharded over ``model`` only:
a data replica's rank ``(d, m)`` holds the same tensors as ``(0, m)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.core.placement import Placement, make_placement
from repro_torch.core.prefetch import attach_checksum_tables
from repro_torch.kernels._launch import FP8_DTYPES
from repro_torch.models.layers import rope_frequencies
from repro_torch.models.recurrent import init_recurrent_params
from repro_torch.models.xlstm import init_mlstm_params, init_slstm_params

AXIS_MODEL = "model"


# --------------------------------------------------------------------------
# Geometry: how weights are laid out for a given mesh (mode-independent).
# --------------------------------------------------------------------------
# The reference sizes its default weight geometry against this device
# memory (the JAX package's constant, kept so both packages pick the same
# geometry); on the H100 the engine passes explicit overrides instead.
HBM_BYTES = 16e9


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Weight storage geometry for one mesh.

    Each weight family gets a tuple of mesh axes it is sharded over
    (empty tuple = replicated — the paper-faithful layout for attention):

    - ``expert_axes``: the MoE expert bank. On a 16 GB device the big banks (grok
      294B, R1 656GB, llama4 383GB of expert weights) bust 16GB HBM when
      sharded over "model" alone, so the planner widens the DWDP group to
      ("data","model"). ``moe_exec`` selects per-layer execution: "gather"
      (paper-faithful full-layer prefetch; needs 2x the layer's expert
      bytes resident) or "rotate" (ring-rotate weight shards through
      ranks, computing each resident shard's contribution; not ported
      yet — the port runs "gather").
    - ``ffn_axes`` / ``attn_axes`` / ``cell_axes``: dense FFN ("virtual
      experts" — the DWDP generalization), attention projections, and
      recurrent-cell weights. Serve mode shards FFN over "model" and
      escalates attention only when replication busts HBM; train mode
      shards everything over ("data","model") (ZeRO-3-style — the gather
      machinery doubles as the train-time weight fetch).
    """

    model_size: int
    expert_axes: tuple[str, ...]
    moe_placement: Optional[Placement]
    moe_exec: str                    # "gather" | "rotate"
    ffn_axes: tuple[str, ...]
    ffn_shards: int
    attn_axes: tuple[str, ...]
    attn_shards: int
    kv_shard: int                    # distinct kv groups when attention sharded
    cell_axes: tuple[str, ...]
    cell_shards: int
    vocab_pad: int
    train: bool
    attn_tp_ok: bool = False   # heads divide the model axis (DEP TP legal)

    @classmethod
    def build(
        cls,
        cfg: ArchConfig,
        mesh_sizes: dict[str, int],
        *,
        dtype_bytes: int = 2,
        train: bool = False,
        shard_ffn: bool = True,
        shard_attention: Optional[bool] = None,
        redundancy: Optional[int] = None,
        moe_exec: Optional[str] = None,
        expert_axes: Optional[tuple[str, ...]] = None,
        ffn_axes_override: Optional[tuple[str, ...]] = None,
        attn_axes_override: Optional[tuple[str, ...]] = None,
    ) -> "Geometry":
        g_model = mesh_sizes.get("model", 1)
        wide = tuple(a for a in ("data", "model") if a in mesh_sizes)
        n_wide = math.prod(mesh_sizes[a] for a in wide)

        def axsize(axes):
            return math.prod(mesh_sizes.get(a, 1) for a in axes)

        # --- per-rank byte pressure estimates (bf16-equivalent) -----------
        bytes_per_param = dtype_bytes + (12 if train else 0)  # + grads/adam
        attn_bytes = sum(
            cfg._mixer_params(l) for l in range(cfg.num_layers)
        ) * bytes_per_param
        dense_ffn_bytes = sum(
            3 * cfg.d_model * cfg.ffn_dim(l)
            for l in range(cfg.num_layers)
            if cfg.ffn_dim(l)
        ) * bytes_per_param

        # --- MoE expert bank ----------------------------------------------
        placement = None
        chosen_exec = "gather"
        if cfg.moe is not None:
            moe_cfg = cfg.moe
            n_moe = sum(cfg.is_moe_layer(l) for l in range(cfg.num_layers))
            per_expert = 3 * cfg.d_model * moe_cfg.d_ff * dtype_bytes
            bank = n_moe * moe_cfg.num_experts * per_expert * (
                bytes_per_param / dtype_bytes
            )
            if expert_axes is None:
                expert_axes = ("model",) if g_model > 1 else wide[-1:] or ("model",)
                if bank / g_model > 0.55 * HBM_BYTES and len(wide) > 1:
                    expert_axes = wide
                if train and len(wide) > 1 and bank / g_model > 0.3 * HBM_BYTES:
                    expert_axes = wide
            placement = make_placement(
                moe_cfg.num_experts, axsize(expert_axes), redundancy=redundancy
            )
            layer_set = placement.num_padded * per_expert
            chosen_exec = moe_exec or (
                "gather" if 2 * layer_set < 0.3 * HBM_BYTES else "rotate"
            )
            if len(expert_axes) > 1 and chosen_exec == "gather" and moe_exec is None:
                # gather mode keeps 2x a full layer resident; multi-axis
                # groups only arise for banks that need rotate anyway.
                chosen_exec = "rotate" if 2 * layer_set > 0.3 * HBM_BYTES else "gather"
        else:
            expert_axes = expert_axes or ("model",)

        # --- dense FFN ("virtual experts") ---------------------------------
        has_dense = any(cfg.ffn_dim(l) for l in range(cfg.num_layers)) or (
            cfg.moe is not None and cfg.moe.shared_d_ff
        )
        if not has_dense or not shard_ffn or g_model == 1:
            ffn_axes: tuple[str, ...] = ()
        elif (train and dense_ffn_bytes / n_wide * len(wide) > 0.3 * HBM_BYTES) or (
            dense_ffn_bytes / g_model > 0.6 * HBM_BYTES
        ):
            ffn_axes = wide
        else:
            ffn_axes = ("model",)
        if train and has_dense and g_model > 1:
            ffn_axes = ffn_axes or ("model",)
        if ffn_axes_override is not None:
            ffn_axes = ffn_axes_override

        # --- attention ------------------------------------------------------
        if shard_attention is None:
            if train:
                shard_attention = attn_bytes > 0.3 * HBM_BYTES * g_model / n_wide
            else:
                shard_attention = attn_bytes > 0.35 * HBM_BYTES
        attn_axes: tuple[str, ...] = ()
        if shard_attention and cfg.has_attention and g_model > 1:
            attn_axes = ("model",)
            if train or attn_bytes / g_model > 0.6 * HBM_BYTES:
                attn_axes = wide
        if attn_axes_override is not None:
            attn_axes = attn_axes_override
        a_sh = axsize(attn_axes)
        if attn_axes and cfg.q_dim % a_sh:
            attn_axes = ()
            a_sh = 1
        kv_shard = math.gcd(a_sh, cfg.num_kv_heads) if attn_axes else 1
        attn_tp_ok = bool(
            attn_axes == ("model",)
            and cfg.num_heads % g_model == 0
            and kv_shard
            and cfg.num_kv_heads % kv_shard == 0
        )

        # --- recurrent cells (train-time ZeRO only) -------------------------
        cell_kinds = {BlockKind.RECURRENT, BlockKind.MLSTM, BlockKind.SLSTM}
        has_cells = any(k in cell_kinds for k in cfg.block_pattern)
        cell_axes: tuple[str, ...] = ()
        if train and has_cells and attn_axes:
            cell_axes = attn_axes

        vocab_pad = -(-cfg.vocab_size // max(g_model, 1)) * max(g_model, 1)
        return cls(
            model_size=g_model,
            expert_axes=tuple(expert_axes),
            moe_placement=placement,
            moe_exec=chosen_exec,
            ffn_axes=ffn_axes,
            ffn_shards=axsize(ffn_axes),
            attn_axes=attn_axes,
            attn_shards=a_sh,
            kv_shard=kv_shard,
            cell_axes=cell_axes,
            cell_shards=axsize(cell_axes),
            vocab_pad=vocab_pad,
            train=train,
            attn_tp_ok=attn_tp_ok,
        )


# --------------------------------------------------------------------------
# Layer plan: group layers into scan-able cycles.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayerSig:
    kind: BlockKind
    window: int          # 0 = full attention
    is_moe: bool
    ffn_dim: int         # dense FFN dim on this layer (0 = none/MoE)
    shared_d_ff: int = 0  # always-on shared expert dim (MoE layers)


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    name: str
    scan: bool
    n_cycles: int                 # 1 for unrolled groups
    sigs: tuple[LayerSig, ...]    # one per position in the cycle
    first_layer: int


def signature(cfg: ArchConfig, layer: int, *, long_variant: bool = False) -> LayerSig:
    kind = cfg.block_kind(layer)
    window = cfg.window if kind == BlockKind.LOCAL_ATTN else 0
    if long_variant and kind == BlockKind.GLOBAL_ATTN:
        kind = BlockKind.LOCAL_ATTN
        window = cfg.long_context_window
    is_moe = cfg.is_moe_layer(layer)
    return LayerSig(
        kind=kind,
        window=window,
        is_moe=is_moe,
        ffn_dim=cfg.ffn_dim(layer),
        shared_d_ff=(cfg.moe.shared_d_ff if (is_moe and cfg.moe) else 0),
    )


def make_layer_plan(cfg: ArchConfig, *, long_variant: bool = False) -> list[LayerGroup]:
    prefix = cfg.moe.first_dense if cfg.moe else 0
    pat = len(cfg.block_pattern)
    if prefix and pat > 1 and prefix % pat:
        raise ValueError(f"{cfg.name}: first_dense must align with block pattern")
    period = pat
    if cfg.moe is not None:
        period = math.lcm(pat, cfg.moe.every)
    groups: list[LayerGroup] = []
    sig = lambda l: signature(cfg, l, long_variant=long_variant)
    if prefix:
        groups.append(
            LayerGroup(
                "prefix", False, 1, tuple(sig(l) for l in range(prefix)), 0
            )
        )
    body = cfg.num_layers - prefix
    n_cycles, rem = divmod(body, period)
    if n_cycles:
        sigs = tuple(sig(prefix + j) for j in range(period))
        # verify periodicity holds across the whole body
        for c in range(n_cycles):
            for j in range(period):
                assert sig(prefix + c * period + j) == sigs[j], (cfg.name, c, j)
        groups.append(LayerGroup("body", n_cycles > 1, n_cycles, sigs, prefix))
    if rem:
        start = prefix + n_cycles * period
        groups.append(
            LayerGroup(
                "suffix",
                False,
                1,
                tuple(sig(l) for l in range(start, cfg.num_layers)),
                start,
            )
        )
    return groups


# --------------------------------------------------------------------------
# Per-rank parameter init (same shapes, scales and padding as the JAX
# package's init; the numbers differ — they come from a torch.Generator).
# --------------------------------------------------------------------------
def shard_axis_size(mesh_sizes: dict, axes: tuple[str, ...]) -> int:
    return math.prod(mesh_sizes.get(a, 1) for a in axes)


def sharded_axes(axes: tuple[str, ...], mesh_sizes: dict) -> tuple[str, ...]:
    """The axes of ``axes`` that split anything (size > 1)."""
    return tuple(a for a in axes if mesh_sizes.get(a, 1) > 1)


def split_leading(t: torch.Tensor, axes: tuple[str, ...], mesh_sizes: dict,
                  axis: int = 0) -> list[torch.Tensor]:
    """One block per rank of the ``model`` axis: the leading shard axis
    split over ``axes`` (a separate allocation per model rank), or the
    whole tensor shared by every rank when ``axes`` is empty. The data
    replicas share these blocks (:func:`replicate_over_data`)."""
    n_ranks = mesh_sizes.get(AXIS_MODEL, 1)
    size = shard_axis_size(mesh_sizes, axes)
    if size == 1:
        return [t] * n_ranks
    if sharded_axes(axes, mesh_sizes) != (AXIS_MODEL,):
        raise NotImplementedError(
            f"a weight family sharded over {tuple(axes)}: the port shards weights "
            "over the model axis only (several axes are rotate execution's work)"
        )
    return [c.contiguous() for c in torch.chunk(t, n_ranks, dim=axis)]


def _share(tree):
    """A new tree of the same structure holding the same tensors."""
    if isinstance(tree, dict):
        return {k: _share(v) for k, v in tree.items()}
    return tree


def replicate_over_data(per_model_rank: list, mesh_sizes: dict) -> list:
    """The per-logical-rank list from the trees of the ``model`` ranks: rank
    ``d * G + m`` gets a tree holding the very tensors of model rank ``m``.
    On one card the data replicas share their read-only weights; the
    paper's replicas are separate GPUs, which computes the same, and two
    copies of DeepSeek-R1's depth-2 weights (2 x 28.19 GB) with the landing
    buffers would not fit the card."""
    data = math.prod(v for a, v in mesh_sizes.items() if a != AXIS_MODEL)
    return list(per_model_rank) + [_share(t) for _ in range(data - 1) for t in per_model_rank]


def _normal(gen, shape, scale, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale


def _dense(gen, shape, dtype, device, scale=None) -> torch.Tensor:
    if scale is None:
        scale = shape[-2] ** -0.5 if len(shape) >= 2 else 1.0
    return _normal(gen, shape, scale, device).to(dtype)


def init_attn_params(gen, cfg: ArchConfig, geom: "Geometry", dtype, device,
                     mesh_sizes: dict) -> list[dict]:
    """Canonical (D, dim) tensors reshaped into the stacked storage layout
    (``transformer.init_attn_params`` of the JAX package), then split."""
    a = geom.attn_shards
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    scale = d**-0.5
    wq_c = _dense(gen, (d, qd), dtype, device, scale)
    wk_c = _dense(gen, (d, kvd), dtype, device, scale)
    wv_c = _dense(gen, (d, kvd), dtype, device, scale)
    wo_c = _dense(gen, (qd, d), dtype, device, qd**-0.5)
    ksd = geom.kv_shard
    table = torch.as_tensor(np.arange(a) // (a // ksd), device=device)
    full = {
        "wq": wq_c.reshape(d, a, qd // a).permute(1, 0, 2),
        "wk": wk_c.reshape(d, ksd, kvd // ksd).permute(1, 0, 2)[table],
        "wv": wv_c.reshape(d, ksd, kvd // ksd).permute(1, 0, 2)[table],
        "wo": wo_c.reshape(a, qd // a, d),
    }
    per = {k: split_leading(v.contiguous(), geom.attn_axes, mesh_sizes)
           for k, v in full.items()}
    return [{k: per[k][r] for k in full} for r in range(geom.model_size)]


def ffn_pad(ffn_dim: int, shards: int) -> int:
    return -(-ffn_dim // shards) * shards


def init_ffn_params(gen, cfg: ArchConfig, geom: "Geometry", ffn_dim: int,
                    dtype, device, mesh_sizes: dict) -> list[dict]:
    s = geom.ffn_shards
    f_pad = ffn_pad(ffn_dim, s)
    d = cfg.d_model
    wg = _dense(gen, (d, f_pad), dtype, device, d**-0.5)
    wu = _dense(gen, (d, f_pad), dtype, device, d**-0.5)
    wd = _dense(gen, (f_pad, d), dtype, device, f_pad**-0.5)
    if f_pad != ffn_dim:  # padded hidden units must not contribute
        wd[ffn_dim:] = 0
    full = {
        "w_gate": wg.reshape(d, s, f_pad // s).permute(1, 0, 2),
        "w_up": wu.reshape(d, s, f_pad // s).permute(1, 0, 2),
        "w_down": wd.reshape(s, f_pad // s, d),
    }
    per = {k: split_leading(v.contiguous(), geom.ffn_axes, mesh_sizes)
           for k, v in full.items()}
    return [{k: per[k][r] for k in full} for r in range(geom.model_size)]


def init_moe_params(gen, cfg: ArchConfig, geom: "Geometry", dtype, device,
                    mesh_sizes: dict) -> list[dict]:
    """Expert banks are drawn one subgroup position at a time (a rank's
    ``local_count`` rows), dummy experts (ids >= E) zeroed, and placed by
    the placement table — never as one canonical (E_pad, D, Fe) fp32
    tensor, which at DeepSeek-R1 width would be 15 GB per matrix."""
    moe, pl = cfg.moe, geom.moe_placement
    assert moe is not None and pl is not None
    d, fe = cfg.d_model, moe.d_ff
    n_ranks = geom.model_size
    if sharded_axes(geom.expert_axes, mesh_sizes) not in ((), (AXIS_MODEL,)):
        raise NotImplementedError(
            f"experts sharded over {geom.expert_axes}: the port shards them over the "
            "model axis only (several axes need rotate execution, not ported yet)")
    router = _dense(gen, (d, pl.num_padded), dtype, device, d**-0.5)

    def position_bank(p, shape_tail, scale):
        ids = p * pl.local_count + torch.arange(pl.local_count, device=device)
        w = _normal(gen, (pl.local_count,) + shape_tail, scale, device)
        w *= (ids < moe.num_experts).to(w.dtype).reshape((-1,) + (1,) * len(shape_tail))
        return w.to(dtype)

    banks = [
        {
            "w_gate": position_bank(p, (d, fe), d**-0.5),
            "w_up": position_bank(p, (d, fe), d**-0.5),
            "w_down": position_bank(p, (fe, d), fe**-0.5),
        }
        for p in range(pl.subgroup_size)
    ]
    table = pl.table()[:, 0] // pl.local_count  # subgroup position per rank
    shared = None
    if moe.shared_d_ff:
        shared = init_ffn_params(gen, cfg, geom, moe.shared_d_ff, dtype, device, mesh_sizes)
    out = []
    for r in range(n_ranks):
        tree = {"router": router, "experts": banks[int(table[r])]}
        if shared is not None:
            tree["shared"] = shared[r]
        out.append(tree)
    return out


def init_layer_params(gen, cfg: ArchConfig, geom: "Geometry", sig: LayerSig,
                      dtype, device, mesh_sizes: dict) -> list[dict]:
    """One layer's trees, one per model rank. The recurrent (``rec``) and
    cell (``cell``) weights are replicated at serve time (``cell_axes`` is
    empty unless training): one tree shared by every rank."""
    n = geom.model_size
    trees = [{"norm1": None} for _ in range(n)]
    norm1 = torch.zeros(cfg.d_model, dtype=dtype, device=device)
    if sig.kind in (BlockKind.GLOBAL_ATTN, BlockKind.LOCAL_ATTN):
        key, mixer = "attn", init_attn_params(gen, cfg, geom, dtype, device, mesh_sizes)
    else:
        if geom.cell_axes:
            raise NotImplementedError(
                f"{sig.kind.value} weights sharded over {geom.cell_axes}: the port serves "
                "them replicated (training's ZeRO sharding is not ported)")
        if sig.kind == BlockKind.RECURRENT:
            key, tree = "rec", init_recurrent_params(gen, cfg.d_model, dtype, device)
        elif sig.kind == BlockKind.MLSTM:
            key, tree = "cell", init_mlstm_params(gen, cfg.d_model, cfg.num_heads, dtype, device)
        else:
            key, tree = "cell", init_slstm_params(gen, cfg.d_model, cfg.num_heads, dtype, device)
        mixer = [tree] * n
    for r in range(n):
        trees[r]["norm1"] = norm1
        trees[r][key] = mixer[r]
    if sig.is_moe or sig.ffn_dim:
        norm2 = torch.zeros(cfg.d_model, dtype=dtype, device=device)
        if sig.is_moe:
            ff, key = init_moe_params(gen, cfg, geom, dtype, device, mesh_sizes), "moe"
        else:
            ff, key = init_ffn_params(gen, cfg, geom, sig.ffn_dim, dtype, device, mesh_sizes), "ffn"
        for r in range(n):
            trees[r]["norm2"] = norm2
            trees[r][key] = ff[r]
    return trees


def stack_cycles(cycle_trees: list[dict], memo: Optional[dict] = None) -> dict:
    """Stack one rank's per-cycle trees along a new leading cycle axis
    (a scan group's storage layout). Leaves the ranks share (replicated
    weights) are stacked once when the ranks pass the same ``memo``."""
    first = cycle_trees[0]
    if isinstance(first, dict):
        return {k: stack_cycles([t[k] for t in cycle_trees], memo) for k in first}
    if memo is None:
        return torch.stack(cycle_trees)
    key = tuple(id(t) for t in cycle_trees)
    if key not in memo:
        memo[key] = torch.stack(cycle_trees)
    return memo[key]


# --------------------------------------------------------------------------
# Whole model.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    geom: Geometry
    plan: tuple[LayerGroup, ...]
    dtype: torch.dtype
    mesh_sizes: tuple[tuple[str, int], ...]
    device: torch.device
    # the RoPE frequencies of cfg.head_dim / cfg.rope_theta on the device
    rope_freqs: torch.Tensor = dataclasses.field(compare=False, repr=False)

    @property
    def sizes(self) -> dict[str, int]:
        return dict(self.mesh_sizes)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The activations' dtype: bfloat16 for weights stored in fp8 (every
        consumer widens a weight on use), else the weights' own (the JAX
        package's ``_compute_dtype``)."""
        return torch.bfloat16 if self.dtype in FP8_DTYPES else self.dtype

    @property
    def n_ranks(self) -> int:
        """Logical ranks: every coordinate of the mesh (``data * model``)."""
        return math.prod(v for _, v in self.mesh_sizes)

    def init_params(self, generator: torch.Generator) -> list[dict]:
        """Random weights for every logical rank, drawn from ``generator``
        (which must live on ``self.device``); the data replicas share the
        model ranks' tensors (:func:`replicate_over_data`). The experts'
        checksum tables of the validated fetch are built here, once
        (``prefetch.attach_checksum_tables``)."""
        cfg, geom, dtype, dev = self.cfg, self.geom, self.dtype, self.device
        sizes = self.sizes
        n = geom.model_size
        v_l = geom.vocab_pad // n
        ranks = [
            {
                "embed": _dense(generator, (v_l, cfg.d_model), dtype, dev, 1.0),
                "final_norm": None,
            }
            for _ in range(n)
        ]
        final_norm = torch.zeros(cfg.d_model, dtype=dtype, device=dev)
        for r in range(n):
            ranks[r]["final_norm"] = final_norm
            if not cfg.tie_embeddings:
                ranks[r]["lm_head"] = _dense(
                    generator, (cfg.d_model, v_l), dtype, dev, cfg.d_model**-0.5
                )
            ranks[r]["layers"] = {}
        for group in self.plan:
            for r in range(n):
                ranks[r]["layers"][group.name] = {}
            for j, sig in enumerate(group.sigs):
                if group.scan:
                    cyc = [
                        init_layer_params(generator, cfg, geom, sig, dtype, dev, sizes)
                        for _ in range(group.n_cycles)
                    ]
                    memo: dict = {}
                    per_rank = [stack_cycles([c[r] for c in cyc], memo) for r in range(n)]
                else:
                    per_rank = init_layer_params(generator, cfg, geom, sig, dtype, dev, sizes)
                for r in range(n):
                    ranks[r]["layers"][group.name][f"pos{j}"] = per_rank[r]
        return attach_checksum_tables(replicate_over_data(ranks, sizes), self)


def build_model(
    cfg: ArchConfig,
    mesh_sizes: dict[str, int],
    *,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    **geom_kwargs,
) -> Model:
    """The port's ``build_model``: one geometry for the mesh, one layer
    plan. ``device`` defaults to the card; pass ``device="cpu"`` to run on
    the CPU. The mesh is ``(data, model)``: its ``data * model`` ranks are
    logical ranks in one process, the weights sharded over ``model`` and
    shared by the data replicas."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            'device="cpu" to run on the CPU'
        )
    if mesh_sizes.get("pod", 1) != 1 or set(mesh_sizes) - {"pod", "data", "model"}:
        raise NotImplementedError(f"the port runs (data, model) meshes, got {mesh_sizes}")
    if min(mesh_sizes.values()) < 1:
        raise ValueError(f"mesh sizes must be positive, got {mesh_sizes}")
    dtype_bytes = torch.empty((), dtype=dtype).element_size()
    geom = Geometry.build(cfg, mesh_sizes, dtype_bytes=dtype_bytes, **geom_kwargs)
    plan = tuple(make_layer_plan(cfg))
    freqs = torch.from_numpy(rope_frequencies(cfg.head_dim, cfg.rope_theta)).to(device)
    return Model(
        cfg=cfg, geom=geom, plan=plan, dtype=dtype,
        mesh_sizes=tuple(mesh_sizes.items()), device=device, rope_freqs=freqs,
    )
