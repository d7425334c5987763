"""Serving entry point of the port: ``build_engine``, ``run_serving`` and
the command line.

The counterpart of ``repro.launch.serve``: a context server and a
generation server over one model whose ``model`` mesh axis is G logical
ranks on one device. The command line takes the reference's defaults, a
DWDP context server (``--ctx-mode dwdp``) feeding a DEP generation server
(``--gen-mode dep``); ``build_engine``'s keyword default stays
``gen_mode="dwdp"``. Runs on the card unless the caller passes
``device="cpu"`` (``--device cpu``); on the card every step is a
captured CUDA graph unless the caller passes ``graphs=False``.

    python -m repro_torch.launch.serve --arch deepseek-r1 --requests 4
    python -m repro_torch.launch.serve --arch deepseek-r1 --gen-mode dwdp --requests 4
    python -m repro_torch.launch.serve --arch deepseek-r1 --serving --replicas 2

The first runs the engine's fixed loop; ``--serving`` serves a seeded
workload through ``ServingScheduler`` and ``LiveReplicaClient`` behind
``MultiReplicaEngine``'s router. The configuration is the architecture's
reduced variant unless ``--full`` is given. Each replica counts as one
GPU in ``tps_per_gpu``: its G logical ranks share one card.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced_variant
from repro_torch.models.transformer import build_model
from repro_torch.runtime.engine import (
    ContextServer,
    DisaggregatedEngine,
    GenerationServer,
    GraphSpace,
    Request,
)

# The storage geometry each architecture is served with: the default
# geometry (sized for a 16 GB device) picks rotate execution or replicated
# attention at these depths, which the port does not run.
SERVE_GEOMETRY = {
    "deepseek-r1": dict(shard_attention=True, expert_axes=("model",), moe_exec="gather"),
    "gemma3-27b": dict(shard_attention=True, ffn_axes_override=("model",)),
}


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

    ``ctx_mode`` and ``gen_mode`` (dwdp | dep | hybrid) are the two
    servers' strategies. ``gen_mode`` defaults to ``"dwdp"`` here, where
    the reference's ``build_engine`` and both command lines default to
    ``"dep"``: the callers of this function (tests, ``chip_smoke.py``)
    serve DWDP unless they ask. A DEP context server is refused (its
    tensor-parallel prefill captures no KV state).

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


def _engine(args, cfg, *, prefill_len: int, prefill_buckets: tuple = (), cache_len: int):
    return build_engine(
        cfg, mesh_shape=args.mesh, prefill_len=prefill_len, prefill_buckets=prefill_buckets,
        cache_len=cache_len, max_batch=args.max_batch, ctx_mode=args.ctx_mode,
        gen_mode=args.gen_mode, capacity_from=args.capacity_from,
        expert_fetch=args.expert_fetch, demand_budget=args.demand_budget,
        cache_budget=args.cache_budget, device=args.device,
        geom_kwargs=SERVE_GEOMETRY.get(args.arch),
        variant_cache_size=args.variant_cache_size,
    )


def run_serving(args, cfg) -> dict:
    """The ``--serving`` path: ``--replicas`` live replicas (the same
    weights, independent clocks) behind the least-loaded router, rolling
    admission, and the SLO gate when a target is set. Prints the summary,
    the TTFT / TPOT percentiles and each replica's share; returns the
    summary."""
    from repro_torch.runtime.serving import (
        AdmissionController,
        LiveReplicaClient,
        MultiReplicaEngine,
        ServingScheduler,
        SLOConfig,
        WorkloadConfig,
        synthesize_workload,
    )

    if args.isl_buckets:
        buckets = tuple(sorted({int(b) for b in args.isl_buckets.split(",")}))
    else:
        buckets = (args.prefill_len,)
    slo = SLOConfig(target_tps_user=args.slo_tps_user, ttft_budget_s=args.slo_ttft,
                    max_queue=args.max_queue)
    gated = args.slo_tps_user or args.slo_ttft or args.max_queue
    schedulers = []
    for _ in range(args.replicas):
        engine, _ = _engine(args, cfg, prefill_len=max(buckets), prefill_buckets=buckets,
                            cache_len=max(buckets) + args.output_len)
        client = LiveReplicaClient.from_engine(engine)
        if not args.no_warmup:
            client.warmup()
        admission = AdmissionController(slo, client.step_time) if gated else None
        schedulers.append(ServingScheduler(client, admission=admission))
    if not args.no_warmup:
        print(f"warmup: {args.replicas} replica(s), prefill buckets {list(buckets)} captured")
    fleet = MultiReplicaEngine(schedulers)
    wl = WorkloadConfig(num_requests=args.requests, isl_buckets=buckets, osl=args.output_len,
                        arrival_rate=args.arrival_rate)
    fleet.submit(synthesize_workload(wl, vocab_size=cfg.vocab_size))
    metrics = fleet.run()
    s = metrics.summary(horizon=fleet.horizon())
    print("serving summary (tps_per_gpu counts one card per replica):", s)
    print("ttft p50/p95/p99:", s["ttft_p50_s"], s["ttft_p95_s"], s["ttft_p99_s"])
    print("tpot p50/p95/p99:", s["tpot_p50_s"], s["tpot_p95_s"], s["tpot_p99_s"])
    for i, sched in enumerate(schedulers):
        n = sum(1 for r in fleet.assignments.values() if r == i)
        print(f"replica {i}: {n} request(s), {sched.steps} decode step(s), horizon {sched.t:.3f}s")
    for rid, toks in list(schedulers[0].outputs.items())[:4]:
        print(f"req {rid}: {toks[:10]}{'...' if len(toks) > 10 else ''}")
    return s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prefill-len", type=int, default=64)
    ap.add_argument("--output-len", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=2,
                    help="decode slots (a multiple of the model axis would shard the decode "
                         "batch, which the port does not run yet)")
    ap.add_argument("--ctx-mode", default="dwdp", choices=["dwdp", "hybrid", "dep"],
                    help="context-server strategy (dep is refused: its tensor-parallel "
                         "prefill attention captures no KV state)")
    ap.add_argument("--gen-mode", default="dep", choices=["dep", "dwdp"],
                    help="generation-server strategy: DEP, the paper's baseline (experts "
                         "stay put, tokens move by all-to-all), or DWDP (weights move)")
    ap.add_argument("--capacity-from", default="local", choices=["local", "global"],
                    help="MoE capacity from the local shard's rows or per row")
    ap.add_argument("--expert-fetch", default="all",
                    choices=["all", "demand", "predictive", "sync_free"],
                    help="expert fetch of both servers: the full gather, route-before-gather, "
                         "with a speculative round and residency cache, or mirrored")
    ap.add_argument("--demand-budget", type=int, default=0,
                    help="per-peer row budget of the demand / correction round (0 = auto)")
    ap.add_argument("--cache-budget", type=int, default=0,
                    help="residency-cache rows per MoE layer (predictive, sync_free)")
    ap.add_argument("--variant-cache-size", type=int, default=16,
                    help="decode variants the generation server keeps captured (LRU)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="capture each variant on first use instead of before serving")
    ap.add_argument("--full", action="store_true",
                    help="the full configuration (default: its reduced variant)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="1,4", type=lambda v: tuple(int(x) for x in v.split(",")),
                    help="data,model mesh of logical ranks on the device")
    serving = ap.add_argument_group(
        "serving", "continuous batching: rolling admission into decode slots as they free, "
        "SLO-aware admission, independent replicas behind the least-loaded router")
    serving.add_argument("--serving", action="store_true",
                         help="serve through ServingScheduler / MultiReplicaEngine")
    serving.add_argument("--replicas", type=int, default=1,
                         help="independent engine replicas, served one after another")
    serving.add_argument("--isl-buckets", default=None, metavar="L1,L2,...",
                         help="prompt lengths of the workload, each a pow2 prefill bucket "
                              "(default: --prefill-len)")
    serving.add_argument("--arrival-rate", type=float, default=0.0,
                         help="Poisson arrivals per second (0 = all at t = 0)")
    serving.add_argument("--slo-tps-user", type=float, default=0.0,
                         help="per-user decode-rate floor (0 = off)")
    serving.add_argument("--slo-ttft", type=float, default=0.0,
                         help="longest queue wait in seconds before shedding (0 = off)")
    serving.add_argument("--max-queue", type=int, default=0,
                         help="queued requests beyond which arrivals are shed (0 = unbounded)")
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced_variant(cfg)
    if args.serving:
        return run_serving(args, cfg)
    engine, _ = _engine(args, cfg, prefill_len=args.prefill_len,
                        cache_len=args.prefill_len + args.output_len)
    if not args.no_warmup:
        print(f"warmup: {engine.warmup()} decode variant(s) captured")
    print(f"ctx {engine.ctx.xp.mode} policies:", engine.ctx.xp.policies.describe())
    print(f"gen {engine.gen.xp.mode} policies:", engine.gen.xp.policies.describe())
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        engine.submit(Request(i, rng.integers(0, cfg.vocab_size, args.prefill_len),
                              args.output_len))
    engine.run(args.output_len * (args.requests // args.max_batch + 2))
    s = engine.metrics.summary(horizon=engine.horizon())
    print("summary (tps_per_gpu counts one card):", s)
    for rid, toks in list(engine.outputs.items())[:4]:
        print(f"req {rid}: {toks[:10]}{'...' if len(toks) > 10 else ''}")
    return s


if __name__ == "__main__":
    main()
