"""Serving entry point of the port: ``build_engine``.

The counterpart of ``repro.launch.serve.build_engine``: a DWDP context
server and generation server over one model whose ``model`` mesh axis
is G logical ranks on one device. Runs on the card unless the caller
passes ``device="cpu"``; on the card every step is a captured CUDA graph
unless the caller passes ``graphs=False``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.transformer import build_model
from repro_torch.runtime.engine import (
    ContextServer,
    DisaggregatedEngine,
    GenerationServer,
    GraphSpace,
)


def build_engine(
    cfg,
    *,
    mesh_shape=(1, 4),
    prefill_len: int = 64,
    prefill_buckets: tuple = (),
    cache_len: int = 128,
    max_batch: int = 2,
    ctx_mode: str = "dwdp",
    gen_mode: str = "dwdp",
    capacity_from: str = "local",
    expert_fetch: str = "all",
    demand_budget: int = 0,
    cache_budget: int = 0,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    seed: int = 0,
    params: Optional[list] = None,
    geom_kwargs: Optional[dict] = None,
    variant_cache_size: int = 16,
    graphs: Optional[bool] = None,
):
    """Returns ``(DisaggregatedEngine, model)``.

    ``params`` is a per-rank parameter list for this model (for instance
    from ``checkpoint.convert.from_jax_params``); by default the weights
    are drawn from a ``torch.Generator`` seeded with ``seed`` on the
    device. ``cache_len`` is rounded up to a multiple of the rank count,
    as the reference does, so the KV ring divides over the shards.
    ``expert_fetch`` (all | demand | predictive | sync_free) with
    ``demand_budget`` (per-peer rows, 0 = auto) and ``cache_budget``
    (residency-cache rows, predictive / sync_free) form the uniform
    policy of both servers. ``prefill_buckets`` adds pow2 prompt lengths
    beside ``prefill_len``, and ``variant_cache_size`` bounds the decode
    server's policy variants (the reference's arguments). ``graphs``
    (default: on a CUDA device) captures every step as a CUDA graph, all
    of the engine's graphs in one memory pool (``runtime.engine.
    GraphSpace``); ``graphs=False`` keeps the eager steps, for comparison."""
    sizes = {"data": mesh_shape[0], "model": mesh_shape[1]}
    n_ranks = max(1, mesh_shape[0] * mesh_shape[1])
    cache_len = -(-cache_len // n_ranks) * n_ranks
    model = build_model(cfg, sizes, dtype=dtype, device=device, **(geom_kwargs or {}))
    if params is None:
        params = model.init_params(torch.Generator(device=model.device).manual_seed(seed))
    elif len(params) != model.n_ranks:
        raise ValueError(f"params hold {len(params)} ranks, the model has {model.n_ranks}")
    if graphs is None:
        graphs = model.device.type == "cuda"
    if graphs and model.device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, the model is on {model.device}")
    space = GraphSpace(model.device) if graphs else None
    fetch = dict(expert_fetch=expert_fetch, demand_budget=demand_budget,
                 cache_budget=cache_budget, capacity_from=capacity_from, space=space)
    ctx = ContextServer(
        model, sizes, mode=ctx_mode, prefill_len=prefill_len, cache_len=cache_len,
        prefill_buckets=prefill_buckets, **fetch,
    )
    gen = GenerationServer(
        model, sizes, mode=gen_mode, max_batch=max_batch, cache_len=cache_len,
        variant_cache_size=variant_cache_size, **fetch,
    )
    return DisaggregatedEngine(params, ctx, gen), model
