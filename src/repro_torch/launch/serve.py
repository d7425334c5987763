"""Serving entry point of the port: ``build_engine``, ``run_serving`` and
the command line.

The counterpart of ``repro.launch.serve``: a context server and a
generation server over one model whose ``(data, model)`` mesh is
``data * model`` logical ranks on one device (``--mesh 2,4``: two data
replicas of a DWDP group of four; the decode slots are sharded over
``data``, so ``--max-batch`` must divide over it and not over ``data *
model``). The command line takes the reference's defaults, a
DWDP context server (``--ctx-mode dwdp``) feeding a DEP generation server
(``--gen-mode dep``); ``build_engine``'s keyword default stays
``gen_mode="dwdp"``. Runs on the card unless the caller passes
``device="cpu"`` (``--device cpu``); on the card every step is a
captured CUDA graph unless the caller passes ``graphs=False``.

    python -m repro_torch.launch.serve --arch deepseek-r1 --requests 4
    python -m repro_torch.launch.serve --arch deepseek-r1 --gen-mode dwdp --requests 4
    python -m repro_torch.launch.serve --arch deepseek-r1 --serving --replicas 2
    python -m repro_torch.launch.serve --arch deepseek-r1 --mesh 2,4 --max-batch 4
    python -m repro_torch.launch.serve --arch deepseek-r1 --gen-mode dwdp \
        --policy moe_experts=split:demand --policy attn_qkv=merged \
        --policy attn_out=merged --policy dense_ffn=split:all:ring
    python -m repro_torch.launch.serve --arch deepseek-r1 --policy-file policies.json
    python -m repro_torch.launch.serve --arch deepseek-r1 --weight-layout merged
    python -m repro_torch.launch.serve --arch deepseek-r1 --gen-mode dwdp --policy auto
    python -m repro_torch.launch.serve --arch deepseek-r1 --gen-mode dwdp \
        --policy auto-online --switch-interval 2
    python -m repro_torch.launch.serve --arch deepseek-r1 --gen-mode dwdp \
        --expert-fetch predictive --fault-spec 'seed=3,drop=0.1,corrupt=0.05,peers=2'
    python -m repro_torch.launch.serve --arch deepseek-r1 --gen-mode dwdp \
        --expert-fetch demand --validate-fetch

Gather policies are set per weight family (``moe_experts``, ``attn_qkv``,
``attn_out``, ``dense_ffn``, ``default``; ``group/family`` for one layer
group: ``prefix``, ``body``, ``suffix``) with the repeatable ``--policy
family=layout[:fetch[:transport[:num_slices[:budget[:cache_budget]]]]]``
or ``--policy-file`` (the ``PolicyTable.to_dict`` JSON; flags override
its entries). The uniform flags ``--weight-layout``, ``--expert-fetch``,
``--demand-budget`` and ``--cache-budget`` spell one policy for every
family and may not be combined with ``--policy``; conflicting flags exit
with status 2 before anything is built. ``--policy auto`` resolves every
family with the roofline model (``strategy.resolve_policies``) once per
server; ``--policy auto-online`` also re-resolves the decode table before
each decode step (``runtime.engine.OnlinePolicyScheduler``: active-row
buckets, and every ``--switch-interval`` steps the measured hit rates).
On the card both resolve for that card (``roofline.card_view`` over the
logical ranks, the model's weight bytes); on the CPU for the JAX
package's default, GB200 with 1-byte weights.

Fault tolerance: ``--fault-spec`` injects seeded faults into the
route-before-gather fetch rounds (outputs stay bitwise exact through the
checksum repair), ``--validate-fetch`` validates without injecting, and
a ``HealthMonitor`` (``--health-decay``, ``--health-demote``,
``--health-promote``, ``--health-dwell``; off with ``--no-health``) walks
the generation server down its degradation ladder and back.

The first runs the engine's fixed loop; ``--serving`` serves a seeded
workload through ``ServingScheduler`` and ``LiveReplicaClient`` behind
``MultiReplicaEngine``'s router. The configuration is the architecture's
reduced variant unless ``--full`` is given. Each replica counts as one
GPU in ``tps_per_gpu``: its logical ranks share one card.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced_variant
from repro_torch.core.faults import FaultSpec
from repro_torch.core.prefetch import attach_checksum_tables
from repro_torch.core.strategy import AUTO_POLICIES, PolicyTable, resolve_policy
from repro_torch.models.transformer import build_model
from repro_torch.runtime.engine import (
    ContextServer,
    DisaggregatedEngine,
    GenerationServer,
    GraphSpace,
    HealthMonitor,
    OnlinePolicyScheduler,
    Request,
    decode_axes,
)

# The storage geometry each architecture is served with: the default
# geometry (sized for a 16 GB device) picks rotate execution or replicated
# attention at these depths, which the port does not run.
SERVE_GEOMETRY = {
    "deepseek-r1": dict(shard_attention=True, expert_axes=("model",), moe_exec="gather"),
    "gemma3-27b": dict(shard_attention=True, ffn_axes_override=("model",)),
}


def check_mesh(cfg, mesh_shape, max_batch: int, cache_len: int) -> None:
    """Refuse a mesh or a decode batch the port cannot serve, before anything
    is built (``ValueError``): the mesh is ``(data, model)`` of positive
    sizes, and the decode batch may divide over ``data`` but not over ``data
    * model`` (``runtime.engine.decode_axes``)."""
    if len(mesh_shape) != 2 or min(mesh_shape) < 1:
        raise ValueError(f"the mesh is (data, model) of positive sizes, got {tuple(mesh_shape)}")
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    decode_axes(cfg, {"data": mesh_shape[0], "model": mesh_shape[1]}, max_batch, cache_len)


def parse_policy_flags(flags, policy_file=None):
    """``--policy`` / ``--policy-file`` -> a PolicyTable, ``"auto"``,
    ``"auto-online"``, or None (nothing given), as the JAX package parses
    them: each ``--policy`` value is a standalone literal or
    ``family=spec``; the file is the PolicyTable JSON dict; flags override
    file entries for the same family. Unknown families or values raise
    ``ValueError``."""
    flags = list(flags or ())
    for lit in AUTO_POLICIES:
        if lit in flags:
            if len(flags) > 1 or policy_file:
                raise ValueError(f"--policy {lit} stands alone (it resolves every family); "
                                 "drop the other --policy/--policy-file arguments")
            return lit
    spec: dict = {}
    if policy_file:
        with open(policy_file) as f:
            loaded = json.load(f)
        if not isinstance(loaded, dict):
            raise ValueError(f"--policy-file {policy_file!r} must hold a JSON object mapping "
                             "families to policy specs")
        spec.update(loaded)
    for flag in flags:
        if "=" not in flag:
            raise ValueError("--policy expects family=layout[:fetch[:transport...]] or the "
                             f"literal 'auto'; got {flag!r}")
        fam, pol = flag.split("=", 1)
        spec[fam] = pol
    if not spec:
        return None
    return PolicyTable.from_dict(spec)


def resolve_cli_policy(args):
    """``--policy`` / ``--policy-file`` parsed, refusing them beside the
    uniform flags (``--weight-layout``, ``--expert-fetch``,
    ``--demand-budget``, ``--cache-budget``): a PolicyTable, ``"auto"`` or
    None; ``ValueError`` on conflicts or bad specs. ``main`` then turns
    the uniform flags into the table when no ``--policy`` is given
    (``strategy.resolve_policy``)."""
    legacy_given = [
        name for name, v in (
            ("--weight-layout", args.weight_layout),
            ("--expert-fetch", args.expert_fetch),
            ("--demand-budget", args.demand_budget),
            ("--cache-budget", getattr(args, "cache_budget", None)),
        ) if v is not None
    ]
    policy = parse_policy_flags(args.policy, args.policy_file)
    if policy is not None and legacy_given:
        raise ValueError(f"conflicting --policy and uniform flags {', '.join(legacy_given)} "
                         "— pass only --policy")
    return policy


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
    policy=None,
    weight_layout: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    seed: int = 0,
    params: Optional[list] = None,
    geom_kwargs: Optional[dict] = None,
    variant_cache_size: int = 16,
    graphs: Optional[bool] = None,
    hw=None,
    weight_bytes: Optional[int] = None,
    switch_interval: int = 8,
    fault_spec=None,
    validate_fetch: bool = False,
    health: Optional[HealthMonitor] = None,
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
    device. ``cache_len`` is rounded up to a multiple of the rank count
    (``data * model``), as the reference does, so the KV ring divides over
    every shard count. ``mesh_shape`` and ``max_batch`` are checked first
    (:func:`check_mesh`): nothing is built for a pair the port refuses.
    ``expert_fetch`` (all | demand | predictive | sync_free) with
    ``demand_budget`` (per-peer rows, 0 = auto) and ``cache_budget``
    (residency-cache rows, predictive / sync_free) and ``weight_layout``
    (split | merged) form the uniform policy of both servers, unless
    ``policy`` (a PolicyTable, a per-family mapping or a spec string; any
    transport; or ``"auto"`` / ``"auto-online"``, resolved for ``hw`` at
    ``weight_bytes``, by default the card's per-logical-rank view and the
    model's weight bytes on a CUDA device and the JAX package's GB200 at 1
    byte on the CPU: ``roofline.serving_target``) is given, which wins
    (``strategy.resolve_policy``). ``"auto-online"`` adds an
    ``OnlinePolicyScheduler`` re-resolving every ``switch_interval`` decode
    steps (and at each new active-row bucket). ``prefill_buckets`` adds pow2 prompt lengths
    beside ``prefill_len``, and ``variant_cache_size`` bounds the decode
    server's policy variants (the reference's arguments). ``graphs``
    (default: on a CUDA device) captures every step as a CUDA graph, all
    of the engine's graphs in one memory pool (``runtime.engine.
    GraphSpace``); ``graphs=False`` keeps the eager steps, for comparison.
    ``fault_spec`` (a ``faults.FaultSpec`` or its ``--fault-spec`` string)
    and ``validate_fetch`` run the validated fetch on both servers, against
    the experts' checksum tables of the weight set (built once here when
    ``params`` lack them); ``health`` puts a ``HealthMonitor`` on the
    engine, which walks the degradation ladder."""
    sizes = {"data": mesh_shape[0], "model": mesh_shape[1]}
    n_ranks = max(1, mesh_shape[0] * mesh_shape[1])
    cache_len = -(-cache_len // n_ranks) * n_ranks
    check_mesh(cfg, mesh_shape, max_batch, cache_len)
    model = build_model(cfg, sizes, dtype=dtype, device=device, **(geom_kwargs or {}))
    if params is None:
        params = model.init_params(torch.Generator(device=model.device).manual_seed(seed))
    elif len(params) != model.n_ranks:
        raise ValueError(f"params hold {len(params)} ranks, the model has {model.n_ranks}")
    else:
        attach_checksum_tables(params, model)
    if graphs is None:
        graphs = model.device.type == "cuda"
    if graphs and model.device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, the model is on {model.device}")
    space = GraphSpace(model.device) if graphs else None
    fetch = dict(expert_fetch=expert_fetch, demand_budget=demand_budget,
                 cache_budget=cache_budget, policy=policy, weight_layout=weight_layout,
                 capacity_from=capacity_from, hw=hw, weight_bytes=weight_bytes,
                 fault_spec=fault_spec, validate_fetch=validate_fetch, space=space)
    ctx = ContextServer(
        model, sizes, mode=ctx_mode, prefill_len=prefill_len, cache_len=cache_len,
        prefill_buckets=prefill_buckets, **fetch,
    )
    gen = GenerationServer(
        model, sizes, mode=gen_mode, max_batch=max_batch, cache_len=cache_len,
        variant_cache_size=variant_cache_size, **fetch,
    )
    scheduler = None
    if isinstance(policy, str) and policy == "auto-online":
        scheduler = OnlinePolicyScheduler(model, sizes, gen._shape, interval=switch_interval,
                                          hw=gen.hw, weight_bytes=gen.weight_bytes)
    return DisaggregatedEngine(params, ctx, gen, scheduler=scheduler, health=health), model


def health_monitor(args) -> Optional[HealthMonitor]:
    """The ``--health-*`` monitor where the fetch is validated (``--fault-spec``
    or ``--validate-fetch``) and ``--no-health`` is not given."""
    if not (args.fault_spec or args.validate_fetch) or args.no_health:
        return None
    return HealthMonitor(decay=args.health_decay, demote_threshold=args.health_demote,
                         promote_threshold=args.health_promote, min_dwell=args.health_dwell)


def _engine(args, cfg, policy, *, prefill_len: int, prefill_buckets: tuple = (),
            cache_len: int):
    return build_engine(
        cfg, mesh_shape=args.mesh, prefill_len=prefill_len, prefill_buckets=prefill_buckets,
        cache_len=cache_len, max_batch=args.max_batch, ctx_mode=args.ctx_mode,
        gen_mode=args.gen_mode, capacity_from=args.capacity_from, policy=policy,
        device=args.device,
        geom_kwargs=SERVE_GEOMETRY.get(args.arch),
        variant_cache_size=args.variant_cache_size, switch_interval=args.switch_interval,
        fault_spec=args.fault_spec, validate_fetch=args.validate_fetch,
        health=health_monitor(args),
    )


def run_serving(args, cfg, policy=None) -> dict:
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
        engine, _ = _engine(args, cfg, policy, prefill_len=max(buckets), prefill_buckets=buckets,
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
                    help="decode slots, sharded over the mesh's data axis (a multiple of "
                         "data * model would shard them over the model axis: refused)")
    ap.add_argument("--ctx-mode", default="dwdp", choices=["dwdp", "hybrid", "dep"],
                    help="context-server strategy (dep is refused: its tensor-parallel "
                         "prefill attention captures no KV state)")
    ap.add_argument("--gen-mode", default="dep", choices=["dep", "dwdp"],
                    help="generation-server strategy: DEP, the paper's baseline (experts "
                         "stay put, tokens move by all-to-all), or DWDP (weights move)")
    ap.add_argument("--capacity-from", default="local", choices=["local", "global"],
                    help="MoE capacity from the local shard's rows or per row")
    ap.add_argument("--policy", action="append", default=None, metavar="FAMILY=SPEC",
                    help="per-family gather policy (repeatable): family=layout[:fetch"
                         "[:transport[:num_slices[:budget[:cache_budget]]]]] with families "
                         "moe_experts, attn_qkv, attn_out, dense_ffn, default, or "
                         "group/family for one layer group (prefix, body, suffix); or alone "
                         "'auto' (the roofline resolver) or 'auto-online' (re-resolved "
                         "between decode steps)")
    ap.add_argument("--policy-file", default=None,
                    help="JSON file mapping families to policy specs (PolicyTable.to_dict); "
                         "--policy flags override its entries")
    ap.add_argument("--weight-layout", default=None, choices=["merged", "split"],
                    help="uniform gathered-weight layout of every family (default split)")
    ap.add_argument("--expert-fetch", default=None,
                    choices=["all", "demand", "predictive", "sync_free"],
                    help="expert fetch of both servers (default all): the full gather, "
                         "route-before-gather, with a speculative round and residency "
                         "cache, or mirrored")
    ap.add_argument("--demand-budget", type=int, default=None,
                    help="per-peer row budget of the demand / correction round (default 0 "
                         "= auto)")
    ap.add_argument("--cache-budget", type=int, default=None,
                    help="residency-cache rows per MoE layer (predictive, sync_free; "
                         "default 0)")
    ap.add_argument("--switch-interval", type=int, default=8,
                    help="decode steps between --policy auto-online's re-resolutions "
                         "against the measured hit rates")
    ap.add_argument("--fault-spec", default=None, metavar="SPEC",
                    help="inject seeded fetch faults, e.g. 'seed=3,drop=0.1,corrupt=0.05,"
                         "peers=2|5' (keys: seed, drop, zero, corrupt, cache, mirror, peers, "
                         "trace); implies --validate-fetch; outputs stay bitwise exact")
    ap.add_argument("--validate-fetch", action="store_true",
                    help="checksum-validate every fetched and cached expert row without "
                         "injecting faults")
    ap.add_argument("--health-decay", type=float, default=0.7,
                    help="HealthMonitor per-peer fault-event EMA decay")
    ap.add_argument("--health-demote", type=float, default=0.5,
                    help="per-peer EMA above which the ladder demotes (predictive -> "
                         "+excl -> demand -> all)")
    ap.add_argument("--health-promote", type=float, default=0.1,
                    help="all-peer EMA below which the ladder promotes")
    ap.add_argument("--health-dwell", type=int, default=2,
                    help="decode steps between ladder moves")
    ap.add_argument("--no-health", action="store_true",
                    help="no HealthMonitor, even with a validated fetch")
    ap.add_argument("--variant-cache-size", type=int, default=16,
                    help="decode variants the generation server keeps captured (LRU)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="capture each variant on first use instead of before serving")
    ap.add_argument("--full", action="store_true",
                    help="the full configuration (default: its reduced variant)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="1,4", type=lambda v: tuple(int(x) for x in v.split(",")),
                    help="data,model mesh of logical ranks on the device (2,4: two data "
                         "replicas of a DWDP group of 4, with --max-batch 4)")
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
    try:
        # One policy for both servers ("auto" is resolved by each server).
        policy = resolve_policy(
            resolve_cli_policy(args), weight_layout=args.weight_layout,
            expert_fetch=args.expert_fetch, demand_budget=args.demand_budget,
            cache_budget=args.cache_budget)
    except ValueError as err:
        ap.error(str(err))
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced_variant(cfg)
    try:
        check_mesh(cfg, args.mesh, args.max_batch, args.prefill_len + args.output_len)
        if args.fault_spec:
            FaultSpec.parse(args.fault_spec)
    except ValueError as err:
        ap.error(str(err))
    if args.serving:
        return run_serving(args, cfg, policy)
    engine, _ = _engine(args, cfg, policy, prefill_len=args.prefill_len,
                        cache_len=args.prefill_len + args.output_len)
    if not args.no_warmup:
        print(f"warmup: {engine.warmup()} decode variant(s) captured")
    print(f"ctx {engine.ctx.xp.mode} policies:", engine.ctx.xp.policies.describe())
    print(f"gen {engine.gen.xp.mode} policies:", engine.gen.xp.policies.describe())
    if engine.gen.xp.validated:
        spec = engine.gen.xp.fault_spec
        print("validated fetch, faults:", spec.describe() if spec is not None else "none",
              "ladder:", [label for label, _, _ in engine.gen.ladder],
              "health monitor:", engine.health is not None)
    if isinstance(policy, str):
        print(f"--policy {policy} resolved for {engine.gen.hw.name} at "
              f"{engine.gen.weight_bytes}-byte weights")
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        engine.submit(Request(i, rng.integers(0, cfg.vocab_size, args.prefill_len),
                              args.output_len))
    engine.run(args.output_len * (args.requests // args.max_batch + 2))
    s = engine.metrics.summary(horizon=engine.horizon())
    print("summary (tps_per_gpu counts one card):", s)
    if engine.gen.xp.validated:
        print(f"fault fallbacks {engine.gen.fault_fallbacks}, ladder level {engine.gen.level} "
              f"({engine.gen.fetch_label})")
    for rid, toks in list(engine.outputs.items())[:4]:
        print(f"req {rid}: {toks[:10]}{'...' if len(toks) > 10 else ''}")
    return s


if __name__ == "__main__":
    main()
