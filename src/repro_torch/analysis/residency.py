"""Analytic per-rank device residency of a plan: what the ``policy="auto"``
resolver sizes the predictive fetch's residency cache against.

The port's copy of ``analytic_residency_bytes`` and ``_moe_layer_groups``
from ``repro.analysis.roofline_report`` (the rest of that module reads a
compiled program's HLO), over the port's own layout predicates
(``core.execution``).
"""
from __future__ import annotations

import math

from repro_torch.core import execution
from repro_torch.core.roofline import layer_group_names


def _moe_layer_groups(cfg) -> list[tuple[str, int]]:
    """``(layer group, MoE layer count)`` per execution-plan layer group, in
    layer order: each group prices its own resolved expert policy."""
    names = layer_group_names(cfg)
    out: dict[str, int] = {}
    for layer in range(cfg.num_layers):
        if cfg.is_moe_layer(layer):
            out[names[layer]] = out.get(names[layer], 0) + 1
    return list(out.items())


def analytic_residency_bytes(cfg, geom, xp, shape, dtype_bytes: int = 2) -> float:
    """Per-rank steady-state residency of a serving plan: the weights at
    their sharded layout, the double-buffered gather window (a split family
    buffers only its remote bank; a route-before-gather expert layer only
    its padded rounds), the predictive fetch's residency cache (per MoE
    layer, under each layer group's own policy), the KV cache at decode and
    the activations (the JAX package's serving terms; the port does not
    train)."""
    n = cfg.param_count()
    shard = max(1, math.prod(
        xp.mesh_sizes.get(a, 1) for a in set(geom.ffn_axes + geom.attn_axes + geom.expert_axes)))
    weights = n * dtype_bytes / shard
    layer_sets = [0.0]
    cache_bytes = 0.0
    if cfg.moe is not None and geom.moe_exec == "gather" and geom.moe_placement:
        pl = geom.moe_placement
        expert_row = 3 * cfg.d_model * cfg.moe.d_ff * dtype_bytes
        for gname, n_moe_g in _moe_layer_groups(cfg):
            window_experts = pl.num_padded
            if execution.demand_fetch_active(cfg, geom, xp, gname):
                budget = execution.resolve_demand_budget(cfg, geom, xp, gname)
                window_experts = (pl.subgroup_size - 1) * min(budget, pl.local_count)
                if execution.predictive_fetch_active(cfg, geom, xp, gname):
                    spec = execution.resolve_spec_budget(cfg, geom, xp, gname)
                    window_experts += (pl.subgroup_size - 1) * min(spec, pl.local_count)
                    cache_bytes += (n_moe_g * execution.resolve_cache_rows(cfg, geom, xp, gname)
                                    * expert_row)
            elif execution.moe_split_active(geom, xp, gname):
                window_experts = pl.num_padded - pl.local_count
            layer_sets.append(window_experts * expert_row)
    if cfg.moe is not None and geom.moe_exec == "rotate" and geom.moe_placement:
        layer_sets.append(geom.moe_placement.local_count * 3 * cfg.d_model * cfg.moe.d_ff
                          * dtype_bytes)
    if geom.ffn_axes and cfg.d_ff:
        ffn_set = 3 * cfg.d_model * cfg.d_ff * dtype_bytes
        if execution.dense_split_active(xp, geom.ffn_axes, "dense_ffn"):
            ffn_set *= 1 - 1 / max(1, geom.ffn_shards)
        layer_sets.append(ffn_set)
    if geom.attn_axes and not execution._qgather_ok(geom, xp):
        attn_set = 0.0
        for fam, part in (("attn_qkv", cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim) * dtype_bytes),
                          ("attn_out", cfg.q_dim * cfg.d_model * dtype_bytes)):
            if execution.dense_split_active(xp, geom.attn_axes, fam):
                part *= 1 - 1 / max(1, geom.attn_shards)
            attn_set += part
        layer_sets.append(attn_set)
    gather_buf = 2 * max(layer_sets)
    kv = 0.0
    if shape.phase == "decode" and cfg.has_attention:
        l_local = shape.seq_len // max(1, xp.seq_shards)
        kv = cfg.num_layers * xp.local_batch * l_local * 2 * cfg.kv_dim * dtype_bytes
    t_local = ((shape.seq_len if shape.phase != "decode" else 1) * max(1, xp.local_batch)
               // max(1, xp.seq_shards if shape.phase != "decode" else 1))
    acts = 2 * t_local * cfg.d_model * 4
    return weights + gather_buf + cache_bytes + kv + acts
