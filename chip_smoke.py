#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each fails loudly; the exit code is non-zero on any error):

1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: every CUDA kernel of the port compiled with ``nvcc`` for sm_90a
   from ``src/repro_torch/kernels/csrc``, one process per source, all at
   once (time and ``-Xptxas -v``);
3. kernels: each kernel at the DeepSeek-R1 main-path shapes (per logical
   rank, G' = 4, bf16) held against its plain PyTorch version (max error
   relative to max|ref| <= 2e-2), and timed with CUDA events (median of 5
   windows of >= 40 ms, with the fastest and slowest) beside its plain
   version, a per-bank torch.matmul/bmm composition (a yardstick the port
   never calls; for flash attention ``scaled_dot_product_attention`` with
   an explicit mask) and its bound. Flash attention is held at R1's 1024-
   and 8192-token prompts and Gemma-3's 4096-token prompt (local and
   global layers), its error also held per query row and head, and its
   bound counting only the visible keys' bytes and the visible query-key
   pairs' operations; each case prints its plan (bf16 at hd 128 must run
   the Hopper path, TMA-fed K/V and wgmma), a second launch must give the
   same bits, and a ragged case (Sq, Sk not multiples of 128, a window and
   an offset) joins the five. The demand kernel is checked at each fetch
   mode's fetched bank; its padding rows must be exact zeros and its real
   experts' blocks bitwise kernel #2's (at C 1, 16 and 88). Kernel #4 is
   also held at the k/v projections' widths (R1 Fs 256 at 2, 256 and 2048
   rows, Gemma-3 Fs 512), #4, #5 and #6 at R1 8192's per-rank prefill
   (2048 rows) and #2 at its expert capacity (C 88). At each case of #2-#6
   the plan of every launch (path, tile, stages, splits) is printed and
   must be, as counted by the wrapper, the Hopper path (TMA, mbarrier
   ring, wgmma) above 2 rows; at 2 rows or fewer split_hopper.cuh's
   few-row path (#4-#6) or its Hopper path at BM 64 (#2, #3); a second
   launch must give the same bits. One 64 x 64 x 64 tile through TMA and
   wgmma is held against an fp32 product;
   Kernel #1 is held at R1's expert shapes at C 1, 16 and 88, with bf16
   and with e4m3-stored banks (bf16 activations; its fp8 bound counts
   1-byte weights, and the bf16 kernel on the widened banks is timed
   beside it, no PyTorch call multiplying bf16 by fp8 as it does); its
   plan is printed and must be the Hopper path at every launch. With e4m3
   and e5m2 banks at C 1, 16 and 88 its result must be bitwise the bf16
   kernel's on the widened banks under the same block tile;
4. ``ops.split_gemm`` (kernel #1's entry point; no engine calls it) at
   R1 expert shapes, C 16 and 1, with bf16 and then e4m3 banks: its
   launches counted, every one on the Hopper path;
5. serve: ``build_engine`` at DeepSeek-R1 width (2 layers, first one
   dense), mesh (data=1, model=4) as 4 logical ranks, random weights from a
   seeded generator, every step a captured CUDA graph; 4 requests at two
   pow2 prefill buckets (1024 and 512 tokens), 16 output tokens each,
   max_batch 2. Warmup captures every bucket and decode variant and the
   serve must capture nothing more. Every kernel of the all-fetch path
   must have launched in the replays, as measured: for each variant that
   replayed, one replay and one eager run of its step on the same inputs
   are traced, the port's device kernels by name and count must be the
   same in both, and the eager run's wrapper launches must equal what
   the capture recorded; a kernel's launches are then that record times
   the variant's replays, which must equal the host counters. One
   prefill's and one decode step's logits are compared with the plain
   versions' (tolerance below); one prefill profiled, replayed and eager;
   the path counts of kernels #2-#6 over the serve are printed, and every
   launch above 2 rows must have run the Hopper path, every one at 2 rows
   or fewer its kernel's path as above, and every flash attention launch
   the Hopper path (its plans are counted and printed per serve). A
   request served alone must give the same tokens as served among the 4,
   and its first decode step's logits beside another request those
   beside an empty slot (row-local capacity, ``capacity_from="global"``);
6. fetch modes: the same requests on the same weights under ``expert_fetch``
   all, demand, predictive and sync_free, each through graphs and eagerly
   (``graphs=False``): every serve's tokens must equal the all-fetch graph
   serve's, and one decode step from the all-fetch serve's final state
   (with the mode's warm predictor) its logits bitwise; the demand kernel
   must launch in the route-before-gather modes (through graphs, launches
   measured through the replays as in 5). The demand graph engine
   also serves the requests again switching demand <-> predictive every 4
   steps (at least 3 switches, both tables warmed: no capture, no variant
   built), and demand with a budget of 1 row per peer must give the
   all-fetch tokens and logits, its overflowed steps run again eagerly and
   counted. Per mode, graph against eager, with the card's name and power
   limit: TPOT p50, the device ms of one replayed decode step (CUDA events)
   and of the eager step (profiled, by kind), TPOT / device time, peak
   memory, landing bytes per decode step and fallbacks;
7. DeepSeek-R1 at the paper's input length: the same weights behind a
   ``prefill_len`` 8192 engine (graphs); 2 requests of 8192 tokens, 16 output tokens
   each, max_batch 2; flash attention must launch; TTFT, TPOT, peak memory,
   one profiled prefill, and one prefill's and one decode step's logits
   against the plain versions;
8. DEP, the paper's baseline, behind the reference's default serving pair:
   on the same weights, a DWDP context server feeding a DEP generation
   server (graphs; experts stay with their owners behind an all-to-all,
   tensor-parallel FFN, decode attention gathered merged) serves the R1
   1024 cell as in 5: warmup captures every variant, the serve none more,
   every all-fetch kernel must launch in the replays (the context server's
   DWDP prefill) and none in the DEP decode step's, prefill and decode
   logits against the plain versions. From the served state: one DEP decode step
   (replay ms, profiled by kind, landed bytes: the merged attention)
   against the DWDP all-fetch step of the same state, and one qgather and
   one hybrid decode step (the hybrid one must launch #4-#6) against their
   plain versions, each within LOGIT_TOL; one DEP ``forward_prefill``
   (tensor-parallel attention) must launch flash attention on its Hopper
   path once per layer and rank and no other kernel (``DEP_KERNELS``), its
   logits within LOGIT_TOL of the plain
   versions'; a rolling ``ServingScheduler`` serve over
   ``LiveReplicaClient``; then an eager DEP engine (``graphs=False``) must
   give the graph serve's tokens bitwise. Printed beside the card's name
   and power limit: TPOT p50, the all-to-all bytes per decode step (from
   the shapes), peak memory (under the limit), and TPS/user and TPS per
   card beside the DWDP all-fetch and demand serves'. Kernel #7 is also
   held at DEP's tensor-parallel prefill shapes in 3, and DEP's grouped
   expert FFN (``torch.bmm``, no kernel of the port) timed at its decode
   shape beside its byte bound;
9. Gemma-3-27B (every width kept, 6 layers: one 5 local : 1 global
   pattern), mesh (1, 4), random weights, graphs: 4 requests of 4096 tokens, 16
   output tokens each, max_batch 2. Every kernel of its path must launch
   (the dense split kernels and flash attention's window branch); prefill
   and decode-step logits against the plain versions; a request alone
   against among the others, tokens and first decode step's logits, as in
   5; TTFT, TPOT, peak, one profiled prefill;
10. the serving layer (``runtime.serving``), each run with the launch counts
   set to 0 just before and read just after, its kernels required: on the
   R1 1024 engine's weights and graph pool, servers with row-local
   capacity serve 4 requests (buckets 1024 and 512, 8 / 16 / 8 / 16 output
   tokens) through ``DisaggregatedEngine.run``, then ``ServingScheduler``
   over ``LiveReplicaClient`` with rolling admission and in
   ``epoch_mode``, then under an SLO (evict_after 2, a target above
   1 / TPOT) that evicts and resumes: every stream bitwise equal, rolling
   in fewer decode steps than epoch, two requests evicted and resumed in
   each other's slot bitwise, no capture after warmup. In 6, the demand
   graph engine switched to predictive serves through the live client
   with a ``RoutedTraceRecorder``: (steps, 4, 256) bitmaps, at most top_k
   x rows experts per rank, the all-fetch tokens. After 9, two Gemma-3
   replicas behind ``MultiReplicaEngine`` serve a workload skewed to the
   4096 bucket: every request completed, the router's assignments
   printed. Each serving summary (TTFT, TPOT, TPS/user, TPS per card,
   ``gather_fetch_ratio``, predictive hit rates) is printed beside the
   landed bytes per decode step, with the card's name and power limit;
11. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Needs a CUDA device and the repository's ``src/`` beside this file.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
KERNEL_TOL = 2e-2             # bf16, relative to max|ref| (tests/test_kernels.py TOL)
# The single wgmma tile: exact bf16 products summed in fp32 in another order.
TILE_TOL = 1e-5
# The kernels whose plan picks a path: split_hopper.cuh's Hopper path above
# 2 rows; at 2 rows or fewer its few-row path (#4-#6) or its Hopper path
# at BM 64 (#1-#3). Kernel -> (launches, path at 2 rows or fewer).
PLANNED = {"split_stack_gemm": (("stack",), "few_row"),
           "split_reduce_gemm": (("reduce",), "few_row"),
           "split_dense_swiglu": (("gate_up", "reduce"), "few_row"),
           "split_grouped_swiglu": (("gate_up", "down"), "hopper"),
           "split_grouped_swiglu_demand": (("gate_up", "down"), "hopper"),
           "split_grouped_gemm": (("gemm",), "hopper")}
GROUPED_KERNELS = ("split_grouped_swiglu", "split_grouped_swiglu_demand", "split_grouped_gemm")
# Kernel #1's bank types: bf16, and fp8 widened to bf16 on the chip (the
# kernel cases and the entry-point path run e4m3; the bitwise check both).
GEMM_WEIGHTS = ("bfloat16", "float8_e4m3fn")
FP8_WEIGHTS = ("float8_e4m3fn", "float8_e5m2")
# End to end through two bf16 layers the kernels and the plain versions
# round at different points (the kernels round h once after silu*mul in
# fp32, the plain versions after every product), and with random weights
# a router near-tie can send a token to another of the 256 experts, which
# moves its output by one expert's share (~1/8). One prefill's logits are
# held to a norm-wise bound: ||kernels - plain|| / ||plain|| <= 0.1.
LOGIT_TOL = 1e-1
# The same comparison in fp32 at the reduced DeepSeek-R1 width, where both
# sides round alike (tests/test_torch_model.py's 1e-4, relative to max|ref|).
FP32_LOGIT_TOL = 1e-4

G = 4                         # DWDP4: the model axis, G' = 4 logical ranks
PROMPT = 1024
OUTPUT = 16
MAX_BATCH = 2
N_REQUESTS = 4
GEOM = dict(shard_attention=True, expert_axes=("model",), moe_exec="gather")
# The kernels the all-fetch serving path launches.
ALL_FETCH_KERNELS = ("split_grouped_swiglu", "split_stack_gemm", "split_reduce_gemm",
                     "split_dense_swiglu", "flash_attention")
# The kernels DEP's own path launches: its tensor-parallel prefill
# attention runs flash attention; its decode runs none of the port's kernels
# (merged attention and the tensor-parallel FFN are jnp in the JAX package,
# its grouped expert FFN ``torch.bmm``). Served behind the reference's
# default pair, a DWDP context server, whose prefill launches every
# all-fetch kernel, the DEP serve must launch all of ALL_FETCH_KERNELS.
DEP_KERNELS = ("flash_attention",)
# The kernels a hybrid decode step runs: attention and the dense FFN as
# split banks (the experts take DEP's all-to-all).
HYBRID_KERNELS = ("split_stack_gemm", "split_reduce_gemm", "split_dense_swiglu")
# DeepSeek-R1 at the paper's input length (it evaluates 8K prompts): the
# same weights, 2 requests.
LONG_PROMPT = 8192
LONG_REQUESTS = 2
# Gemma-3-27B: every width kept, one 5 local : 1 global pattern of its 62
# layers; prompts of 4 windows. Dense: no expert kernels on its path.
GEMMA_LAYERS = 6
GEMMA_PROMPT = 4096
GEMMA_GEOM = dict(shard_attention=True, ffn_axes_override=("model",))
GEMMA_KERNELS = ("split_stack_gemm", "split_reduce_gemm", "split_dense_swiglu",
                 "flash_attention")
# The route-before-gather modes. Residency-cache rows per rank and MoE
# layer (88 MB each at R1 width): 8 keeps the all-fetch prefill's two
# remote banks plus the 4 ranks' caches under the 70 GB limit.
CACHE_BUDGET = 8
FETCH_MODES = (("demand", {}), ("predictive", {"cache_budget": CACHE_BUDGET}),
               ("sync_free", {"cache_budget": CACHE_BUDGET}))
PEAK_LIMIT = 70e9
# The serving layer: output lengths of the R1 1024 cell's 4 requests (unequal,
# so rolling admission refills a freed slot where epoch mode waits), and the
# two-replica Gemma-3 fleet's workload.
SERVING_LENS = (8, 16, 8, 16)
FLEET_REQUESTS = 6
FLEET_OSL = 8
# Kernel timing: TIME_WINDOWS windows of at least WINDOW_MS of back-to-back
# launches each; the median window is reported beside the fastest and the
# slowest.
TIME_WINDOWS = 5
WINDOW_MS = 40.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, warmup: int = 2) -> tuple[float, float, float]:
    """(median, fastest, slowest) ms per call of ``fn`` over TIME_WINDOWS
    windows timed with CUDA events; each window repeats ``fn`` enough
    times to last at least WINDOW_MS."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def window(reps: int) -> float:
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    reps = max(1, math.ceil(WINDOW_MS / max(window(1), 1e-3)))
    per_call = sorted(window(reps) for _ in range(TIME_WINDOWS))
    return per_call[TIME_WINDOWS // 2], per_call[0], per_call[-1]


def profile_step(label: str, fn) -> None:
    """Profile one call of ``fn``: device time by kind (the split kernels,
    the attention kernel, device-to-device copies of the landing banks,
    everything else) beside the host wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3  # includes the profiler's own cost
    kinds = {"split kernels": 0.0, "attention kernel": 0.0, "landing copies": 0.0,
             "other device work": 0.0}
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key
        kinds[kernel_kind(name)] += us / 1e3
        rows.append((us / 1e3, e.count, name[:70]))
    busy = sum(kinds.values())
    print(f"profile {label}: wall_ms_under_profiler {wall_ms:.2f} device_ms_sum {busy:.2f} "
          + " ".join(f"[{k}: {v:.2f} ms]" for k, v in kinds.items()))
    for ms, count, name in sorted(rows, reverse=True)[:8]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name}")
    return dict(kinds, device_ms=busy)


# The demangled names of the port's device kernels (its CUDA namespaces).
PORT_KERNEL = re.compile(r"^(void )?(split_hopper|split_tile|fa|hopper)::")


def kernel_kind(name: str) -> str:
    """A device kernel's kind in a profile, by its demangled name: the
    port's split kernels and its flash attention by their CUDA namespaces
    (a name alone would also match PyTorch's own ``at::native::
    reduce_kernel``), the landing copies (device-to-device copies of split
    banks and merged landings, row gathers of demand payloads), and
    everything else."""
    port = PORT_KERNEL.match(name)
    if port:
        return "attention kernel" if port.group(2) == "fa" else "split kernels"
    if "Memcpy" in name or "memcpy" in name or "indexSelect" in name:
        return "landing copies"
    return "other device work"


def port_kernels(fn) -> collections.Counter:
    """The port's device kernels, by name and count, in a profiler trace of
    one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter({e.key: e.count for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA and PORT_KERNEL.match(e.key)})


def replay_counts(engine) -> dict:
    """The replays so far of every cached step of both servers."""
    return {id(s): s.replays for srv in (engine.ctx, engine.gen) for s in srv.variants.steps()}


def replay_launches(label: str, engine, before: dict, servers=None) -> collections.Counter:
    """Each kernel's launches in the graph replays of ``servers`` (default:
    both) since ``before`` (:func:`replay_counts`), measured. For every step
    that replayed, one replay of its graph and one eager run of the step on
    the same inputs are traced: the port's device kernels, by name and
    count, must be the same in both, and the eager run's wrapper launches
    must equal what the capture recorded (``step.record``). A replay then
    launched each kernel as often as the record says, and the serve that
    record times the step's replays."""
    from repro_torch import counters
    from repro_torch.kernels import registry

    total = collections.Counter({name: 0 for name in registry.KERNELS})
    for server in servers or (engine.ctx, engine.gen):
        for step in server.variants.steps():
            replays = step.replays - before.get(id(step), 0)
            if not replays:
                continue
            replayed = port_kernels(step.graph.replay)
            with counters.recording() as ran:
                eager = port_kernels(lambda: step.eager(engine.params))
            launched = {k[0]: n for k, n in ran.items() if k[0] in registry.KERNELS}
            recorded = {k[0]: n for k, n in step.record.items() if k[0] in registry.KERNELS}
            # DEP's decode is the one step that runs none of the port's kernels
            dep_decode = server.xp.mode == "dep" and server.xp.phase == "decode"
            if replayed != eager or not (replayed or dep_decode):
                fail(f"{label}: a replay ran other device kernels than the eager step: "
                     f"{dict(replayed)} vs {dict(eager)}")
            if launched != recorded:
                fail(f"{label}: the capture recorded {recorded} launches, the eager step "
                     f"made {launched}")
            for name, n in recorded.items():
                total[name] += n * replays
    return total


def check_launches(label: str, engine, measured: dict, counts: dict) -> None:
    """The host counters (each replay adding its capture's record) against
    the launches measured through the replays: equal where no step was
    run again eagerly, no fewer where some were."""
    eager_reruns = engine.ctx.fallbacks + engine.gen.fallbacks
    short = {k: (counts[k], n) for k, n in measured.items()
             if counts[k] < n or (counts[k] != n and not eager_reruns)}
    print(f"{label}: launches measured through the replays {json.dumps(measured)}; "
          f"host counters {json.dumps(counts)}; steps run again eagerly {eager_reruns}")
    if short:
        fail(f"{label}: host launch counters disagree with the replays (host, measured): {short}")


def logit_err(label: str, got, ref) -> float:
    """Norm-wise relative error of two logit rows, held to LOGIT_TOL."""
    import torch

    got, ref = got.float(), ref.float()
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        fail(f"{label}: non-finite logits")
    err = (torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)).item()
    print(f"{label}: norm-wise rel err {err:.3e} (tol {LOGIT_TOL}); argmax "
          f"{got.argmax(-1).tolist()} vs {ref.argmax(-1).tolist()}")
    if err > LOGIT_TOL:
        fail(f"{label}: {err:.3e} > {LOGIT_TOL}")
    return err


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# Per-kernel checks at the main-path shapes.
# --------------------------------------------------------------------------
def library_versions():
    """One per-bank torch.matmul/bmm composition per kernel: timed as a
    yardstick only, never called by the port."""
    import torch
    F = torch.nn.functional

    def stack(x, wl, wr):
        return torch.cat([torch.matmul(x, wl), torch.matmul(x, wr)], dim=0)

    def reduce(x, wl, wr):
        s_l = wl.shape[0]
        return torch.bmm(x[:s_l], wl).sum(0) + torch.bmm(x[s_l:], wr).sum(0)

    def dense(x, gl, ul, dl, gr, ur, dr):
        def part(g, u, d):
            h = F.silu(torch.matmul(x, g)) * torch.matmul(x, u)
            return torch.bmm(h, d).sum(0)
        return part(gl, ul, dl) + part(gr, ur, dr)

    def part(xe, g, u, d):
        return torch.bmm(F.silu(torch.bmm(xe, g)) * torch.bmm(xe, u), d)

    def grouped(x, gl, ul, dl, gr, ur, dr):
        e_l = gl.shape[0]
        return torch.cat([part(x[:e_l], gl, ul, dl), part(x[e_l:], gr, ur, dr)], dim=0)

    def demand(x, gl, ul, dl, gf, uf, df, valid):
        e_l = gl.shape[0]
        y_f = part(x[e_l:], gf, uf, df) * valid[:, None, None].to(x.dtype)
        return torch.cat([part(x[:e_l], gl, ul, dl), y_f], dim=0)

    def gemm(x, wl, wr):
        e_l = wl.shape[0]
        return torch.cat([torch.bmm(x[:e_l], wl), torch.bmm(x[e_l:], wr)], dim=0)

    return {"split_stack_gemm": stack, "split_reduce_gemm": reduce,
            "split_dense_swiglu": dense, "split_grouped_swiglu": grouped,
            "split_grouped_swiglu_demand": demand, "split_grouped_gemm": gemm}


def demand_fetched_rows(cfg) -> dict:
    """Fetched-bank rows the demand kernel gets at R1 decode, by fetch
    mode: demand lands 3 peers x the auto budget; predictive and sync-free
    land [cache | 3 peers x speculative | 3 peers x correction]."""
    from repro_torch.core.budget import demand_budget_rows, predictive_budget_rows

    draws, e = MAX_BATCH * cfg.moe.top_k, cfg.moe.num_experts
    spec, corr = predictive_budget_rows(draws, e, e // G)
    return {"decode": (G - 1) * demand_budget_rows(draws, e, e // G),
            "decode_predictive": CACHE_BUDGET + (G - 1) * (spec + corr)}


def kernel_cases(cfg, gemma):
    """(kernel, phase, shapes) at the per-rank main-path shapes (R1's, and
    Gemma-3's prefill for the dense kernels)."""
    from repro_torch.models.moe import capacity_for

    d, a = cfg.d_model, G
    qd, kvd = cfg.q_dim // a, cfg.kv_dim // a
    fs = cfg.d_ff // G
    e, fe = cfg.moe.num_experts, cfg.moe.d_ff
    cases = []
    for phase, t, c in (("prefill", PROMPT // G, capacity_for(PROMPT // G, e, cfg.moe.top_k, 1.25)),
                        ("decode", MAX_BATCH, capacity_for(MAX_BATCH, e, cfg.moe.top_k, 1.25))):
        cases.append(("split_stack_gemm", phase, dict(t=t, d=d, f=qd, s=a)))
        cases.append(("split_stack_gemm", f"{phase}_kv", dict(t=t, d=d, f=kvd, s=a)))
        cases.append(("split_reduce_gemm", phase, dict(t=t, d=d, f=qd, s=a)))
        cases.append(("split_dense_swiglu", phase, dict(t=t, d=d, f=fs, s=G)))
        cases.append(("split_grouped_swiglu", phase, dict(c=c, d=d, f=fe, e=e, e_l=e // G)))
        cases += gemm_cases(phase, c, d, fe, e)
    # the demand kernel: 64 resident experts + the fetched bank of each
    # mode's decode (C 1, the few-row path), about half its rows valid, and
    # one tensor-core tile shape (C 16)
    rows = demand_fetched_rows(cfg)
    for phase, c, e_f in (("decode", 1, rows["decode"]),
                          ("decode_predictive", 1, rows["decode_predictive"]),
                          ("tile", 16, rows["decode"])):
        cases.append(("split_grouped_swiglu_demand", phase,
                      dict(c=c, d=d, f=fe, e_l=e // G, e_f=e_f)))
    # R1 at the paper's 8K prompt: 2048 rows per rank, the same widths;
    # the expert capacity of a 2048-token shard (88)
    t = LONG_PROMPT // G
    cases.append(("split_stack_gemm", "prefill_8192", dict(t=t, d=d, f=qd, s=a)))
    cases.append(("split_stack_gemm", "prefill_8192_kv", dict(t=t, d=d, f=kvd, s=a)))
    cases.append(("split_reduce_gemm", "prefill_8192", dict(t=t, d=d, f=qd, s=a)))
    cases.append(("split_dense_swiglu", "prefill_8192", dict(t=t, d=d, f=fs, s=G)))
    c = capacity_for(t, e, cfg.moe.top_k, 1.25)
    cases.append(("split_grouped_swiglu", "prefill_8192", dict(c=c, d=d, f=fe, e=e, e_l=e // G)))
    cases += gemm_cases("prefill_8192", c, d, fe, e)
    t, d = GEMMA_PROMPT // G, gemma.d_model
    for name, phase, f in (("split_stack_gemm", "gemma3_prefill", gemma.q_dim // G),
                           ("split_stack_gemm", "gemma3_prefill_kv", gemma.kv_dim // G),
                           ("split_reduce_gemm", "gemma3_prefill", gemma.q_dim // G),
                           ("split_dense_swiglu", "gemma3_prefill", gemma.d_ff // G)):
        cases.append((name, phase, dict(t=t, d=d, f=f, s=G)))
    return cases


def gemm_cases(phase, c, d, f, e) -> list:
    """Kernel #1 at expert capacity ``c`` with each of GEMM_WEIGHTS (the
    fp8 phases named ``<phase>_<type>``)."""
    return [("split_grouped_gemm", phase if w == "bfloat16" else f"{phase}_{w.split('_')[1]}",
             dict(c=c, d=d, f=f, e=e, e_l=e // G, weight=w)) for w in GEMM_WEIGHTS]


def run_kernel_case(name, shp, gen):
    import torch
    from repro_torch.kernels.split_gemm import dense, grouped

    dev, bf = "cuda", torch.bfloat16

    def rnd(*shape, scale=0.05):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    lib = library_versions()[name]
    if name == "split_stack_gemm":
        t, d, f, s = shp["t"], shp["d"], shp["f"], shp["s"]
        args = (rnd(t, d), rnd(1, d, f), rnd(s - 1, d, f))
        kern, plain = dense.split_stack_gemm, dense.split_stack_gemm_torch
        nbytes = 2 * (t * d + s * d * f + s * t * f)
        flops = 2 * s * t * d * f
    elif name == "split_reduce_gemm":
        t, d, f, s = shp["t"], shp["d"], shp["f"], shp["s"]
        args = (rnd(s, t, f), rnd(1, f, d), rnd(s - 1, f, d))
        kern, plain = dense.split_reduce_gemm, dense.split_reduce_gemm_torch
        nbytes = 2 * (s * t * f + s * f * d + t * d)
        flops = 2 * s * t * f * d
    elif name == "split_dense_swiglu":
        t, d, f, s = shp["t"], shp["d"], shp["f"], shp["s"]
        args = (rnd(t, d), rnd(1, d, f), rnd(1, d, f), rnd(1, f, d),
                rnd(s - 1, d, f), rnd(s - 1, d, f), rnd(s - 1, f, d))
        kern, plain = dense.split_dense_swiglu, dense.split_dense_swiglu_torch
        nbytes = 2 * (2 * t * d + 3 * s * d * f)
        flops = 6 * s * t * d * f
    elif name == "split_grouped_swiglu":
        c, d, f, e, e_l = shp["c"], shp["d"], shp["f"], shp["e"], shp["e_l"]
        args = (rnd(e, c, d, scale=1.0), rnd(e_l, d, f), rnd(e_l, d, f), rnd(e_l, f, d),
                rnd(e - e_l, d, f), rnd(e - e_l, d, f), rnd(e - e_l, f, d))
        kern, plain = grouped.split_grouped_swiglu, grouped.split_grouped_swiglu_torch
        nbytes = 2 * (2 * e * c * d + 3 * e * d * f)
        flops = 6 * e * c * d * f
    elif name == "split_grouped_gemm":
        c, d, f, e, e_l = shp["c"], shp["d"], shp["f"], shp["e"], shp["e_l"]
        wdt = getattr(torch, shp["weight"])
        args = (rnd(e, c, d, scale=1.0), rnd(e_l, d, f).to(wdt), rnd(e - e_l, d, f).to(wdt))
        kern, plain = grouped.split_grouped_gemm, grouped.split_grouped_gemm_torch
        # x read and y written in bf16, the banks at their stored width
        nbytes = 2 * (e * c * d + e * c * f) + wdt.itemsize * e * d * f
        flops = 2 * e * c * d * f
        if wdt != bf:
            # no PyTorch call multiplies bf16 by fp8 without quantizing the
            # activations: the bf16 kernel on the widened banks stands beside it
            lib = None
            widened = (args[0], args[1].to(bf), args[2].to(bf))
    else:
        c, d, f, e_l, e_f = shp["c"], shp["d"], shp["f"], shp["e_l"], shp["e_f"]
        valid = torch.arange(e_f, device=dev) % 2 == 0
        args = (rnd(e_l + e_f, c, d, scale=1.0), rnd(e_l, d, f), rnd(e_l, d, f), rnd(e_l, f, d),
                rnd(e_f, d, f), rnd(e_f, d, f), rnd(e_f, f, d), valid)
        kern = grouped.split_grouped_swiglu_demand
        plain = grouped.split_grouped_swiglu_demand_torch
        # this run's data: the real experts' rows and weights are read,
        # every output block is written
        n_real = e_l + int(valid.sum())
        shp = dict(shp, n_valid=int(valid.sum()))
        nbytes = 2 * (n_real * c * d + (e_l + e_f) * c * d + 3 * n_real * d * f)
        flops = 6 * n_real * c * d * f
    plans = None
    if name in PLANNED:
        plans = {"split_stack_gemm": lambda: (dense.stack_plan(*args),),
                 "split_reduce_gemm": lambda: (dense.reduce_plan(*args),),
                 "split_dense_swiglu": lambda: dense.dense_swiglu_plans(*args),
                 "split_grouped_gemm": lambda: (grouped.gemm_plan(*args),),
                 }.get(name, lambda: grouped.grouped_swiglu_plans(*args[:7]))()
        counter = grouped.PATHS if name in GROUPED_KERNELS else dense.PATHS
        before = collections.Counter(counter)
    got = kern(*args)
    ran = None if plans is None else counter - before
    ref = plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    abs_err = (got.float() - ref.float()).abs().max().item()
    rel_err = abs_err / max(ref.float().abs().max().item(), 1e-30)
    row = {"max_abs_err": abs_err, "max_rel_err": rel_err, "tol_rel": KERNEL_TOL}
    if plans is not None:
        row.update(check_plans(name, shp, plans, ran, torch.equal(kern(*args), got)))
    for key, fn in (("ms", kern), ("plain_ms", plain), ("library_ms", lib)):
        if fn is None:
            row[key] = row[f"{key}_range"] = None
            continue
        row[key], lo, hi = time_ms(lambda: fn(*args))
        row[f"{key}_range"] = [lo, hi]
    if name == "split_grouped_gemm" and lib is None:
        row["widened_bf16_ms"], lo, hi = time_ms(lambda: kern(*widened))
        row["widened_bf16_ms_range"] = [lo, hi]
        del widened
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    row["shape"] = shp
    del args, got, ref
    torch.cuda.empty_cache()
    if rel_err > KERNEL_TOL:
        fail(f"{name} {shp}: kernel disagrees with its plain version: rel err {rel_err:.3e} > {KERNEL_TOL}")
    return row


def check_plans(name, shp, plans, ran, bitwise) -> dict:
    """Kernels #2-#6: the plan each launch ran (counted by the wrapper),
    which must be the Hopper path above 2 rows and the kernel's path at 2
    rows or fewer (PLANNED; bf16, every width a multiple of 8 at these
    shapes), and a second launch bitwise equal to the first. ``ran``: the
    wrapper's path counts of the first launch."""
    from repro_torch.kernels.split_gemm import dense

    launches, few = PLANNED[name]
    rows = shp["c"] if "c" in shp else shp["t"]
    want = "hopper" if rows > dense.FEW_ROW_MAXM else few
    tail = (shp["weight"],) if "weight" in shp else ()  # #1 counts its banks' type
    out = {"bitwise_repeat": bitwise}
    for launch, plan in zip(launches, plans):
        n = ran[(name, launch, plan.path, dense.row_class(rows), *tail)]
        out[f"plan_{launch}"] = {"path": plan.path, "tile": list(plan.tile),
                                 "stages": plan.stages, "splits": plan.splits,
                                 "chunk": plan.chunk}
        if plan.path != want or n != 1:
            fail(f"{name} {shp}: {launch} launch ran {plan.path} ({n} counted), not {want}")
    if not bitwise:
        fail(f"{name} {shp}: a second launch gave other bits")
    return out


def path_counts() -> dict:
    """The launches of kernels #2-#6 by (kernel, launch, path, row class)
    and of flash attention by plan, as the wrappers counted them since the
    counters were cleared."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.split_gemm import dense, grouped

    paths = {"/".join(k): v for k, v in sorted((dense.PATHS + grouped.PATHS).items())}
    paths.update({f"flash_attention/{fa.plan_label(p)}": v for p, v in sorted(fa.PATHS.items())})
    return paths


def clear_path_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.split_gemm import dense, grouped

    for counter in (dense.PATHS, grouped.PATHS, fa.PATHS):
        counter.clear()


def check_paths(label: str, paths: dict) -> None:
    """Every launch of #1-#6 above 2 rows ran the Hopper path, every one at
    2 rows or fewer its kernel's path (PLANNED), and every flash attention
    launch (bf16, hd 128 on the serving paths) the Hopper path."""
    bad = {}
    for key, n in paths.items():
        if key.startswith("flash_attention/"):
            if not key.split("/")[1].startswith("wgmma "):
                bad[key] = n
            continue
        name, _, path, rows, *_ = key.split("/")
        if name in PLANNED and path != ("hopper" if rows == "rows>2" else PLANNED[name][1]):
            bad[key] = n
    if bad:
        fail(f"{label}: launches off their planned path: {bad}")


def check_hopper_tile(gen) -> float:
    """The prefill path's building blocks on one tile (one TMA load per
    operand, four wgmma m64n64k16 steps) against a plain fp32 product."""
    import torch
    from repro_torch.kernels.split_gemm import dense

    a = torch.randn(64, 64, generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn(64, 64, generator=gen, device="cuda").to(torch.bfloat16)
    ref = a.float() @ b.float()
    err = ((dense.hopper_tile_check(a, b) - ref).abs().max() / ref.abs().max()).item()
    print(f"hopper single tile (64 x 64 x 64, TMA + wgmma) vs fp32 product: rel err {err:.3e} "
          f"(tol {TILE_TOL})")
    if err > TILE_TOL:
        fail(f"hopper single-tile check: rel err {err:.3e} > {TILE_TOL}")
    return err


def flash_cases(r1, gemma) -> list:
    """(phase, shape) of flash attention per logical rank at G' = 4: the
    prefill shards of R1's 1024-token prompt (first and last rank), R1's
    8192-token prompt (last rank), DEP's tensor-parallel prefill of R1's
    1024- and 8192-token prompts (the whole sequence, 32 of the 128 heads,
    2 of the 8 kv heads) and Gemma-3's 4096-token prompt (last rank, a local
    and a global layer)."""
    def case(cfg, prompt, rank, window):
        sq = prompt // G
        return dict(b=1, sq=sq, sk=prompt, h=cfg.num_heads, kh=cfg.num_kv_heads,
                    hd=cfg.head_dim, q_offset=rank * sq, window=window)

    def dep_tp(cfg, prompt):
        # DEP's tensor-parallel prefill: the whole sequence, the rank's heads
        return dict(b=1, sq=prompt, sk=prompt, h=cfg.num_heads // G,
                    kh=cfg.num_kv_heads // G, hd=cfg.head_dim, q_offset=0, window=0)

    return [("r1_1024_first", case(r1, PROMPT, 0, 0)),
            ("r1_1024_last", case(r1, PROMPT, G - 1, 0)),
            ("r1_8192_last", case(r1, LONG_PROMPT, G - 1, 0)),
            ("r1_1024_dep_tp", dep_tp(r1, PROMPT)),
            ("r1_8192_dep_tp", dep_tp(r1, LONG_PROMPT)),
            ("gemma3_4096_last_local", case(gemma, GEMMA_PROMPT, G - 1, gemma.window)),
            ("gemma3_4096_last_global", case(gemma, GEMMA_PROMPT, G - 1, 0)),
            # ragged: neither Sq nor Sk a multiple of 128, a window, an offset
            ("gemma3_ragged", dict(b=1, sq=1000, sk=3001, h=gemma.num_heads,
                                   kh=gemma.num_kv_heads, hd=gemma.head_dim, q_offset=2001,
                                   window=700))]


def visible_pairs(sq: int, sk: int, q_offset: int, window: int) -> int:
    """Query-key pairs the causal mask (and the window) leave visible."""
    n = 0
    for i in range(sq):
        p = q_offset + i
        lo = max(0, p - window + 1) if window else 0
        n += max(0, min(p, sk - 1) - lo + 1)
    return n


def visible_keys(sq: int, sk: int, q_offset: int, window: int) -> int:
    """Keys some query row sees: [q_offset - window + 1, q_offset + Sq),
    clipped to [0, Sk). The function never needs the others."""
    lo = max(0, q_offset - window + 1) if window else 0
    return max(0, min(q_offset + sq, sk) - lo)


def sdpa_version(q, k, v, window: int, q_offset: int):
    """One ``scaled_dot_product_attention`` call computing flash attention
    on (B, S, heads, hd) inputs (GQA, an explicit boolean mask for the
    offset and the window): a yardstick the port never calls. Returns a
    function of no arguments giving (B, H, Sq, hd)."""
    import torch

    sq, sk = q.shape[1], k.shape[1]
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def run_flash_case(shp, gen) -> dict:
    """Flash attention against its plain version on the same bf16 inputs,
    timed beside the plain version and one ``scaled_dot_product_attention``
    call (``sdpa_version``). The error is held both over the whole output
    (max error over max|ref|) and per query row and head (the worst row's
    max error over that row's max|ref|): rows that see few keys have
    outputs far larger than rows that see many. The plan must be the
    Hopper path (bf16, hd 128), counted by the wrapper, and a second launch
    must give the same bits."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa

    b, sq, sk, h, kh, hd = (shp[k] for k in ("b", "sq", "sk", "h", "kh", "hd"))
    window, q_offset = shp["window"], shp["q_offset"]
    q, k, v = (torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
               for s in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd)))
    plan = fa.flash_plan(q.dtype, hd)

    def kern():
        return fa.flash_attention(q, k, v, window=window, q_offset=q_offset)

    def plain():
        return fa.flash_attention_torch(q, k, v, window=window, q_offset=q_offset)

    library = sdpa_version(q, k, v, window, q_offset)
    before = fa.PATHS[plan]
    got = kern()
    ran = fa.PATHS[plan] - before
    bitwise = torch.equal(kern(), got)
    ref = plain()
    lib = library().transpose(1, 2)
    torch.cuda.synchronize()
    if plan.path != "wgmma" or ran != 1:
        fail(f"flash_attention {shp}: ran {fa.plan_label(plan)} ({ran} counted), not wgmma")
    if not bitwise:
        fail(f"flash_attention {shp}: a second launch gave other bits")
    if not torch.isfinite(got).all():
        fail(f"flash_attention {shp}: non-finite kernel output")
    ref_abs = ref.float().abs()
    scale = max(ref_abs.max().item(), 1e-30)
    row_scale = ref_abs.amax(-1).clamp_min(1e-30)
    diff = (got.float() - ref.float()).abs()
    abs_err = diff.max().item()
    rel_err = abs_err / scale
    row_err = (diff.amax(-1) / row_scale).max().item()
    lib_diff = (lib.float() - ref.float()).abs()
    row = {"max_abs_err": abs_err, "max_rel_err": rel_err, "max_row_rel_err": row_err,
           "tol_rel": KERNEL_TOL, "library_rel_err": lib_diff.max().item() / scale,
           "library_row_rel_err": (lib_diff.amax(-1) / row_scale).max().item(),
           "plan": plan._asdict(), "bitwise_repeat": bitwise}
    del got, ref, lib, ref_abs, row_scale, diff, lib_diff
    for key, fn in (("ms", kern), ("plain_ms", plain), ("library_ms", library)):
        row[key], lo, hi = time_ms(fn)
        row[f"{key}_range"] = [lo, hi]
    # bytes: q read and out written, k and v read over the visible keys only
    pairs = b * visible_pairs(sq, sk, q_offset, window)
    keys = visible_keys(sq, sk, q_offset, window)
    nbytes = 2 * (2 * b * sq * h * hd + 2 * b * keys * kh * hd)
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * hd * h * pairs)
    row["shape"] = dict(shp, visible_pairs=pairs, visible_keys=keys)
    del q, k, v, library
    torch.cuda.empty_cache()
    if max(rel_err, row_err) > KERNEL_TOL:
        fail(f"flash_attention {shp}: kernel disagrees with its plain version: "
             f"rel err {rel_err:.3e}, worst row {row_err:.3e} > {KERNEL_TOL}")
    return row


def grouped_ffn_case(cfg, gen) -> dict:
    """DEP's grouped expert FFN (``models.moe.grouped_ffn``: three
    ``torch.bmm``, as the JAX package computes it in jnp, no kernel of the
    port) at DEP's decode shape on one owner rank: its 64 resident experts,
    each with the G' x C slots the all-to-all brings (2 rows at capacity 1,
    from each of the 4 ranks). A library row, timed beside its bound."""
    import torch
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.moe import capacity_for

    d, fe, e_l = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts // G
    rows = G * capacity_for(MAX_BATCH, cfg.moe.num_experts, cfg.moe.top_k, 1.25)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    x = randn(e_l, rows, d)
    wg, wu, wd = randn(e_l, d, fe, scale=d ** -0.5), randn(e_l, d, fe, scale=d ** -0.5), randn(
        e_l, fe, d, scale=fe ** -0.5)
    y = moe_lib.grouped_ffn(x, wg, wu, wd)
    if not torch.isfinite(y).all():
        fail("grouped_ffn at DEP's decode shape: non-finite output")
    ms, lo, hi = time_ms(lambda: moe_lib.grouped_ffn(x, wg, wu, wd))
    nbytes = 2 * (3 * e_l * d * fe + 2 * e_l * rows * d)
    bound_ms, by = bound(nbytes, 2 * 3 * e_l * rows * d * fe)
    row = {"shape": dict(e_l=e_l, rows=rows, d=d, f=fe), "ms": ms, "ms_range": [lo, hi],
           "bound_ms": bound_ms, "bound_by": by}
    print(f"library grouped_ffn dep_decode {row['shape']}: ms {ms:.4f} [{lo:.4f}, {hi:.4f}] "
          f"bound_ms {bound_ms:.4f} ({by}), {bound_ms / ms:.1%} of the bound")
    del x, wg, wu, wd, y
    torch.cuda.empty_cache()
    return row


def check_demand_matches_grouped(cfg, gen) -> dict:
    """The demand kernel over a fetched bank that is a subset of kernel
    #2's remote bank, on the same rows: its padding rows are exact zeros
    and every real expert's block is bitwise kernel #2's (split_hopper.cuh's
    Hopper path at C 1 with each mode's fetched bank, at C 16 and at R1
    8192's C 88)."""
    import torch
    from repro_torch.kernels.split_gemm import grouped

    dev, bf = "cuda", torch.bfloat16
    d, f, e = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts
    e_l = e // G
    rows = demand_fetched_rows(cfg)

    def rnd(*shape, scale=0.05):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    wl = [rnd(e_l, d, f), rnd(e_l, d, f), rnd(e_l, f, d)]
    wr = [rnd(e - e_l, d, f), rnd(e - e_l, d, f), rnd(e - e_l, f, d)]
    out = {}
    for c, e_f in ((1, rows["decode"]), (16, rows["decode"]), (88, rows["decode"]),
                   (1, rows["decode_predictive"])):
        idx = torch.randperm(e - e_l, generator=gen, device=dev)[:e_f]
        wf = [w.index_select(0, idx) for w in wr]
        valid = torch.arange(e_f, device=dev) % 2 == 0
        x2 = rnd(e, c, d, scale=1.0)
        y2 = grouped.split_grouped_swiglu(x2, *wl, *wr)
        x3 = torch.cat([x2[:e_l], x2[e_l:].index_select(0, idx)])
        y3 = grouped.split_grouped_swiglu_demand(x3, *wl, *wf, valid)
        torch.cuda.synchronize()
        zeros = bool((y3[e_l:][~valid] == 0).all())
        same = torch.equal(y3[:e_l], y2[:e_l]) and torch.equal(
            y3[e_l:][valid], y2[e_l:].index_select(0, idx)[valid])
        print(f"kernel split_grouped_swiglu_demand C {c} E_f {e_f}: padding rows exact zeros {zeros}; "
              f"real experts bitwise split_grouped_swiglu's {same} ({e_l} local + "
              f"{int(valid.sum())} of {e_f} fetched rows)")
        if not (zeros and same):
            fail(f"demand kernel at C {c}, E_f {e_f}: zeros {zeros}, bitwise vs kernel #2 {same}")
        out[f"C{c}_Ef{e_f}"] = {"padding_zero": zeros, "bitwise_vs_split_grouped_swiglu": same}
        del wf
    del wl, wr
    torch.cuda.empty_cache()
    return out


def check_fp8_matches_widened(cfg, gen) -> dict:
    """Kernel #1 with e4m3 and e5m2 banks at R1's expert shapes, C 1, 16
    and 88: its result must be bitwise the bf16 kernel's on the widened
    banks (``w.to(bfloat16)``, exact) under the same block tile, since the
    widening is exact and the same tile bits meet the same wgmma sequence."""
    import torch
    from repro_torch.kernels.split_gemm import grouped

    bf = torch.bfloat16
    d, f, e = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts
    e_l = e // G
    wl = (torch.randn(e_l, d, f, generator=gen, device="cuda") * 0.05).to(bf)
    wr = (torch.randn(e - e_l, d, f, generator=gen, device="cuda") * 0.05).to(bf)
    out = {}
    for wname in FP8_WEIGHTS:
        wdt = getattr(torch, wname)
        ql, qr = wl.to(wdt), wr.to(wdt)
        wide = (ql.to(bf), qr.to(bf))
        for c in (1, 16, 88):
            x = torch.randn(e, c, d, generator=gen, device="cuda").to(bf)
            p8, p16 = grouped.gemm_plan(x, ql, qr), grouped.gemm_plan(x, *wide)
            y8 = grouped.split_grouped_gemm(x, ql, qr)
            y16 = grouped.split_grouped_gemm(x, *wide)
            torch.cuda.synchronize()
            same = torch.equal(y8, y16)
            print(f"kernel split_grouped_gemm {wname} C {c}: bitwise the bf16 kernel on the "
                  f"widened banks {same} (tiles {list(p8.tile)} / {list(p16.tile)}, stages "
                  f"{p8.stages} / {p16.stages})")
            if p8.path != "hopper" or p8.tile != p16.tile:
                fail(f"split_grouped_gemm {wname} C {c}: plans {p8} / {p16}")
            if not same:
                err = (y8.float() - y16.float()).abs().max().item()
                fail(f"split_grouped_gemm {wname} C {c}: not bitwise the bf16 kernel on the "
                     f"widened banks (max diff {err})")
            out[f"{wname}_C{c}"] = same
        del ql, qr, wide
    del wl, wr
    torch.cuda.empty_cache()
    return out


def drive_split_gemm(cfg, gen) -> int:
    """Kernel #1's path: its entry point ``ops.split_gemm`` (no engine
    calls it) at R1 expert shapes, C 16 and C 1, with bf16 banks and then
    with e4m3 banks, with the launch counts set to 0 just before and read
    just after; every launch must have run the Hopper path."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.split_gemm import ops

    d, f, e = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts
    e_l = e // G
    wl = (torch.randn(e_l, d, f, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    wr = (torch.randn(e - e_l, d, f, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    xs = {c: torch.randn(e, c, d, generator=gen, device="cuda").to(torch.bfloat16)
          for c in (16, 1)}
    banks = [(w, wl.to(getattr(torch, w)), wr.to(getattr(torch, w))) for w in GEMM_WEIGHTS]
    del wl, wr
    registry.reset_launch_counts()
    clear_path_counts()
    for wname, bl, br in banks:
        for c, x in xs.items():
            y = ops.split_gemm(x, bl, br)
            if y.shape != (e, c, f) or y.dtype != torch.bfloat16 or not torch.isfinite(y).all():
                fail(f"ops.split_gemm {wname} C {c}: bad output {tuple(y.shape)} {y.dtype}")
    torch.cuda.synchronize()
    counts = registry.launch_counts()
    paths = path_counts()
    print(f"ops.split_gemm path: launch counts {json.dumps(counts)} paths {json.dumps(paths)}")
    if counts["split_grouped_gemm"] <= 0:
        fail("split_grouped_gemm never launched on its entry point")
    check_paths("ops.split_gemm", paths)
    for wname, *_ in banks:
        if not any(k.startswith("split_grouped_gemm/gemm/hopper/") and k.endswith(wname)
                   for k in paths):
            fail(f"ops.split_gemm: no Hopper-path launch with {wname} banks")
    del banks, xs
    torch.cuda.empty_cache()
    return counts["split_grouped_gemm"]


# --------------------------------------------------------------------------
# Serving.
# --------------------------------------------------------------------------
def r1_two_layers():
    from repro_torch.configs import get_arch

    base = get_arch("deepseek-r1")
    return dataclasses.replace(
        base, num_layers=2, moe=dataclasses.replace(base.moe, first_dense=1)
    )


def gemma_six_layers():
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("gemma3-27b"), num_layers=GEMMA_LAYERS)


def free_memory() -> None:
    """Collect dropped engines and return their memory (graph pools
    included) to the card before the next engine."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def in_pool(engine):
    """Eager work in ``engine``'s graph pool (a context): the pool already
    holds the memory of the engine's largest step, which eager work outside
    it would need again. Outputs made there are cloned before the engine's
    next step."""
    import contextlib

    space = engine.gen.space
    return space.eager() if space is not None else contextlib.nullcontext()


def captures(engine) -> tuple:
    return engine.ctx.variants.captures(), engine.gen.variants.captures()


def serve_phase(label: str, cfg, engine, prompts, kernels, tables=()) -> tuple[dict, dict]:
    """Serve ``prompts`` on a fresh engine after its warmup (which captures
    every prefill bucket and decode variant), with the launch counts set to
    0 just before and read just after, and the launches measured through
    the replays (:func:`replay_launches`); every kernel in ``kernels`` must
    have launched, no variant may be captured after warmup, and the peak
    memory stays under the limit. Then one prefill's and one decode step's
    logits against the plain versions, and one profiled prefill, replayed
    and eager. Returns (numbers, outputs)."""
    import torch
    from repro_torch.core import execution
    from repro_torch.kernels import registry

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.warmup(tables)
    warm = captures(engine)
    print(f"{label}: warmup {time.perf_counter() - t0:.2f} s, captures (ctx, gen) {warm}, "
          f"weights and pool {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    registry.reset_launch_counts()
    clear_path_counts()
    replays = replay_counts(engine)
    t0 = time.perf_counter()
    outputs = serve(engine, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # read before the replays are traced: the horizon ends now
    summary = engine.metrics.summary(horizon=engine.horizon())
    counts = registry.launch_counts()
    paths = path_counts()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    launches = replay_launches(label, engine, replays)
    check_launches(label, engine, launches, counts)
    for rec in sorted(engine.metrics.records, key=lambda r: r.req_id):
        print(f"{label} request {rec.req_id} ({rec.prompt_len} tokens): tokens "
              f"{outputs[rec.req_id]} ttft_s {rec.ttft:.4f} tpot_s {rec.tpot:.4f}")
    print(f"{label} serve: {json.dumps(summary)} wall_s {wall:.3f} peak_gb {peak / 1e9:.2f} "
          f"reserved_gb {reserved / 1e9:.2f} captures {captures(engine)} fallbacks (ctx, gen) "
          f"({engine.ctx.fallbacks}, {engine.gen.fallbacks}) overflowed layers "
          f"({engine.ctx.overflow_layers}, {engine.gen.overflow_layers}) launches "
          f"{json.dumps(launches)} paths of #2-#7 {json.dumps(paths)}")
    check_paths(label, paths)
    if captures(engine) != warm:
        fail(f"{label}: serving captured new variants: {warm} after warmup, "
             f"{captures(engine)} after the serve")
    if summary["completed"] != len(prompts):
        fail(f"{label}: {summary['completed']} of {len(prompts)} requests completed")
    for rid, toks in outputs.items():
        if len(toks) != OUTPUT or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{label} request {rid}: bad tokens {toks}")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        fail(f"{label}: kernels never launched on the served path: {missing}")

    def prefill_logits(impl):
        return engine.ctx.forward(engine.params, prompts[0], impl=impl)["last_logits"].clone()

    def decode_logits(impl):
        gen = engine.gen
        ctx = execution.Ctx(model=gen.model, xp=gen.xp, impl=impl)
        with in_pool(engine):
            out = execution.forward_decode(engine.params, gen.cur_token, gen.state, ctx)
        return out["logits"].clone()

    # one prefill, and one decode step from the served state (both rows)
    errs = {}
    for step, run in (("prefill", prefill_logits), ("decode", decode_logits)):
        lk = run(None)[:, :cfg.vocab_size]
        lt = run("torch")[:, :cfg.vocab_size]
        errs[step] = logit_err(f"{label} {step} logits kernels vs plain", lk, lt)
        del lk, lt
    prof = profile_step(f"{label} prefill, graph replay",
                        lambda: engine.ctx.prefill(engine.params, prompts[0]))
    prof_eager = profile_step(f"{label} prefill, eager",
                              lambda: engine.ctx.forward(engine.params, prompts[0]))
    phase_peak = torch.cuda.max_memory_allocated()
    phase_reserved = torch.cuda.max_memory_reserved()
    print(f"{label}: peak over the phase (plain versions and profiles included) "
          f"{phase_peak / 1e9:.2f} GB allocated, {phase_reserved / 1e9:.2f} GB reserved")
    if phase_peak > PEAK_LIMIT:
        fail(f"{label}: peak memory {phase_peak / 1e9:.2f} GB > {PEAK_LIMIT / 1e9:.0f} GB")
    return {"summary": summary, "wall_s": wall, "peak_gb": peak / 1e9,
            "reserved_gb": reserved / 1e9, "fallbacks": engine.gen.fallbacks,
            "overflow_layers": engine.gen.overflow_layers, "phase_peak_gb": phase_peak / 1e9,
            "phase_reserved_gb": phase_reserved / 1e9, "captures": list(warm),
            "launches": launches, "host_launches": counts, "paths": paths,
            "logit_norm_err": errs,
            "profile_prefill_ms": prof, "profile_prefill_eager_ms": prof_eager}, outputs


def serve(engine, prompts) -> dict:
    from repro_torch.runtime.engine import Request

    for i, p in enumerate(prompts):
        engine.submit(Request(i, p, OUTPUT))
    steps = 0
    while engine.busy():
        engine.run(1)
        steps += 1
        if steps > N_REQUESTS * OUTPUT + 8:
            fail("serving did not finish")
    return {rid: list(toks) for rid, toks in engine.outputs.items()}


def check_isolation(label: str, cfg, engine, model, prompts) -> dict:
    """Request 0 served alone against served among the others, on fresh
    servers (captured into the engine's graph pool) with row-local capacity
    (``capacity_from="global"``): its tokens must be equal, and its first
    decode step's logits, beside request 1 or beside an empty slot, within
    LOGIT_TOL norm-wise. (With tied embeddings and random weights greedy
    tokens can repeat the prompt's last token whatever the context; the
    logits still carry it.)"""
    import torch
    from repro_torch.runtime.engine import ContextServer, DisaggregatedEngine, GenerationServer

    sizes = {"data": 1, "model": G}
    kw = dict(capacity_from="global", space=engine.gen.space)
    ctx = ContextServer(model, sizes, prefill_len=engine.ctx.prefill_len,
                        prefill_buckets=engine.ctx.prefill_lens,
                        cache_len=engine.ctx.cache_len, **kw)

    def gen_server():
        return GenerationServer(model, sizes, max_batch=MAX_BATCH,
                                cache_len=engine.gen.cache_len, **kw)

    among = serve(DisaggregatedEngine(engine.params, ctx, gen_server()), prompts)[0]
    alone = serve(DisaggregatedEngine(engine.params, ctx, gen_server()), prompts[:1])[0]

    def first_step_logits(batch):
        gen = gen_server()
        for slot, tokens in enumerate(batch):
            first, state = ctx.prefill(engine.params, tokens)
            gen.admit(slot, slot, first, state)
        out, _, _ = gen.step_outputs(engine.params)
        return out["logits"][0, :cfg.vocab_size].float().clone()

    l_alone, l_among = first_step_logits(prompts[:1]), first_step_logits(prompts[:2])
    bitwise = torch.equal(l_alone, l_among)
    print(f"{label} request 0 among {len(prompts)}: {among}\n{label} request 0 alone: {alone}")
    if among != alone:
        fail(f"{label}: a request served alone gave other tokens than served among the others")
    err = logit_err(f"{label} request 0 first decode step logits, alone vs beside request 1 "
                    f"(bitwise {bitwise})", l_alone, l_among)
    return {"tokens_equal": True, "first_step_logit_norm_err": err, "logits_bitwise": bitwise}


def kv_leaves(gen) -> list:
    """A generation server's position and KV ring tensors, in tree order."""
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    return leaves({"pos": gen.state["pos"], "layers": gen.state["layers"]})


def snapshot(gen) -> dict:
    """A copy of a generation server's KV ring, positions and token row."""
    return {"state": [t.clone() for t in kv_leaves(gen)], "token": gen.cur_token.clone()}


def snapshot_step(label: str, engine, snap) -> dict:
    """One decode step from ``snap`` (the mode's own predictor state kept)
    through the server's step — the graph's replay, or the eager step —
    committing nothing: its logits (cloned), the bytes it landed, its
    device time by kind (profiled) and, for a graph, the replay's CUDA-event
    time (median of TIME_WINDOWS windows)."""
    import torch
    from repro_torch.core import prefetch

    gen = engine.gen
    for dst, src in zip(kv_leaves(gen), snap["state"], strict=True):
        dst.copy_(src)
    gen.cur_token.copy_(snap["token"])
    fallbacks = gen.fallbacks
    prefetch.LANDED.bytes = 0
    out, _, _ = gen.step_outputs(engine.params)
    logits = out["logits"].clone()
    del out
    torch.cuda.synchronize()
    row = {"logits": logits, "landed_gb": prefetch.LANDED.bytes / 1e9,
           "fell_back": gen.fallbacks > fallbacks,
           "profile_ms": profile_step(f"decode step, {label}",
                                      lambda: gen.step_outputs(engine.params))}
    if gen.space is not None:
        row["replay_ms"], lo, hi = time_ms(lambda: gen.step(engine.params))
        row["replay_ms_range"] = [lo, hi]
    return row


def switch_serve(engine, prompts, tables, every: int) -> dict:
    """Serve ``prompts`` again on a warmed engine, switching the decode
    policy to the next of ``tables`` every ``every`` steps."""
    from repro_torch.runtime.engine import Request

    for i, p in enumerate(prompts):
        engine.submit(Request(100 + i, p, OUTPUT))
    steps = switches = 0
    while engine.busy():
        if steps and steps % every == 0:
            switches += engine.gen.set_policy(tables[(steps // every - 1) % len(tables)])
        engine.run(1)
        steps += 1
    outs = {rid - 100: list(engine.outputs[rid]) for rid in range(100, 100 + len(prompts))}
    return {"outputs": outs, "switches": switches}


def serve_fetch_modes(cfg, params, prompts, ref_outputs, r1, snap, ref_step) -> dict:
    """Every fetch mode (all, demand, predictive, sync_free) on the all-fetch
    engine's weights, through graphs and eagerly (``graphs=False``): each
    serve's tokens must equal the all-fetch graph serve's, and one decode
    step from the same state (``snap``, with the mode's warm predictor) its
    logits bitwise. The graph serves take no capture after warmup; the
    demand one also serves the requests again switching demand <->
    predictive every 4 steps (both tables warmed) and must capture nothing
    and miss no variant. Then demand with a budget of 1 row per peer: its
    overflowing steps run again eagerly, counted, with the all-fetch tokens
    and logits. Returns per-mode numbers."""
    import numpy as np
    import torch
    from repro_torch.core import execution
    from repro_torch.core.strategy import PolicyTable
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import build_engine

    ref_logits = ref_step.pop("logits")
    rows = {"all": {"graph": dict(r1_numbers(r1), **ref_step)}}
    predictive = PolicyTable.uniform(fetch="predictive", cache_budget=CACHE_BUDGET)
    demand = PolicyTable.uniform(fetch="demand")
    runs = [("all", {}, False)] + [(m, kw, g) for m, kw in FETCH_MODES for g in (True, False)]
    for mode, kw, graphs in runs + [("demand", {"demand_budget": 1}, True)]:
        forced = kw.get("demand_budget") == 1
        label = f"{mode}{' budget 1' if forced else ''} {'graph' if graphs else 'eager'}"
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        eng, m_model = build_engine(
            cfg, mesh_shape=(1, G), prefill_len=PROMPT, prefill_buckets=(PROMPT // 2,),
            cache_len=PROMPT + OUTPUT, max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda",
            params=params, geom_kwargs=GEOM, expert_fetch=mode, graphs=graphs, **kw,
        )
        if mode != "all" and not execution.demand_fetch_active(cfg, m_model.geom, eng.gen.xp):
            fail(f"expert_fetch={mode}: the decode plan does not run the demand path")
        switching = mode == "demand" and graphs and not forced
        eng.warmup((predictive,) if switching else ())
        warm = captures(eng)
        registry.reset_launch_counts()
        clear_path_counts()
        execution.DEMAND.layers = execution.DEMAND.fallbacks = 0
        replays = replay_counts(eng)
        t0 = time.perf_counter()
        outs = serve(eng, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        summ = eng.metrics.summary(horizon=eng.horizon())  # before any tracing
        counts = registry.launch_counts()
        paths = path_counts()
        demand_measured = None
        if graphs:
            # The demand kernel's launches in the decode replays. (An eager
            # prefill beside this engine's decode graphs does not fit on the
            # card; the R1 serves check the prefill replays.)
            measured = replay_launches(f"expert_fetch={label}", eng, replays, (eng.gen,))
            demand_measured = measured["split_grouped_swiglu_demand"]
            check_launches(f"expert_fetch={label}", eng,
                           {"split_grouped_swiglu_demand": demand_measured}, counts)
        check_paths(f"expert_fetch={label}", paths)
        layers, layer_fallbacks = execution.DEMAND.layers, execution.DEMAND.fallbacks
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        stats = np.sum(eng.gen.pred_stats, axis=0).tolist() if eng.gen.pred_stats else None
        step = snapshot_step(label, eng, snap)
        logits = step.pop("logits")
        budgets = {
            "demand_or_corr": execution.resolve_demand_budget(cfg, m_model.geom, eng.gen.xp),
            "spec": (execution.resolve_spec_budget(cfg, m_model.geom, eng.gen.xp)
                     if execution.predictive_fetch_active(cfg, m_model.geom, eng.gen.xp) else 0),
            "cache_rows": kw.get("cache_budget", 0),
        }
        row = {"budgets": budgets, "tpot_p50_s": summ["tpot_p50_s"],
               "tpot_p95_s": summ["tpot_p95_s"], "ttft_p50_s": summ["ttft_p50_s"],
               "mean_tps_user": summ["mean_tps_user"], "tps_per_gpu": summ["tps_per_gpu"],
               "wall_s": wall, "peak_gb": peak / 1e9, "reserved_gb": reserved / 1e9,
               "captures": list(captures(eng)), "fallbacks": eng.gen.fallbacks,
               "overflow_layers": eng.gen.overflow_layers,
               "ctx_fallbacks": eng.ctx.fallbacks, "demand_layers": layers,
               "layer_fallbacks": layer_fallbacks, "pred_stats_sum": stats,
               "launches": counts, "demand_launches_measured": demand_measured,
               "paths": paths, **step}
        bitwise = torch.equal(logits, ref_logits)
        print(f"fetch {label}: budgets {json.dumps(budgets)} tpot_p50_s {summ['tpot_p50_s']:.4f} "
              f"tpot_p95_s {summ['tpot_p95_s']:.4f} ttft_p50_s {summ['ttft_p50_s']:.4f} "
              f"wall_s {wall:.3f} peak_gb {peak / 1e9:.2f} reserved_gb {reserved / 1e9:.2f} "
              f"landed_gb_per_decode_step {step['landed_gb']:.3f} demand_layers {layers} "
              f"fallbacks (steps run again) {eng.gen.fallbacks} (prefills {eng.ctx.fallbacks}, "
              f"overflowed layers {eng.gen.overflow_layers}) "
              f"captures {captures(eng)} pred_stats_sum {stats} launches {json.dumps(counts)} "
              f"paths {json.dumps(paths)} tokens_equal_all {outs == ref_outputs} "
              f"logits_bitwise_all {bitwise}")
        if outs != ref_outputs:
            fail(f"expert_fetch={label}: tokens differ from the all-fetch tokens: "
                 f"{outs} vs {ref_outputs}")
        if not bitwise:
            err = (logits.float() - ref_logits.float()).abs().max().item()
            fail(f"expert_fetch={label}: decode logits not bitwise the all-fetch ones (max {err})")
        if captures(eng) != warm:
            fail(f"expert_fetch={label}: serving captured new variants ({warm} -> "
                 f"{captures(eng)})")
        if mode != "all" and counts["split_grouped_swiglu_demand"] <= 0:
            fail(f"expert_fetch={label}: split_grouped_swiglu_demand never launched")
        if forced and not (eng.gen.fallbacks > 0 and step["fell_back"]):
            fail(f"expert_fetch={label}: no decode step was run again after an overflow")
        if not forced and eng.gen.fallbacks:
            print(f"fetch {label}: {eng.gen.fallbacks} decode steps overflowed and ran again")
        if peak > PEAK_LIMIT:
            fail(f"expert_fetch={label}: peak memory {peak / 1e9:.2f} GB > "
                 f"{PEAK_LIMIT / 1e9:.0f} GB")
        if switching:
            misses = (eng.ctx.variants.stats["misses"], eng.gen.variants.stats["misses"])
            sw = switch_serve(eng, prompts, (predictive, demand), every=4)
            print(f"fetch {label}: serve switching demand <-> predictive every 4 steps: "
                  f"{sw['switches']} switches, tokens_equal_all {sw['outputs'] == ref_outputs}, "
                  f"captures {captures(eng)} (after warmup {warm}), misses (ctx, gen) "
                  f"{(eng.ctx.variants.stats['misses'], eng.gen.variants.stats['misses'])}")
            if sw["switches"] < 3:
                fail(f"policy switching: {sw['switches']} switches, want at least 3")
            if sw["outputs"] != ref_outputs:
                fail("policy switching: tokens differ from the all-fetch tokens")
            if captures(eng) != warm or misses != (eng.ctx.variants.stats["misses"],
                                                   eng.gen.variants.stats["misses"]):
                fail("policy switching captured or built a variant after warmup")
            row["switching"] = {"switches": sw["switches"], "captures": list(captures(eng))}
            row["predictive_trace"] = predictive_trace(
                "predictive trace (demand engine switched to predictive)", eng, prompts,
                ref_outputs, predictive)
        rows.setdefault(mode if not forced else "demand_budget_1", {})[
            "graph" if graphs else "eager"] = row
        del eng, m_model, logits
    for mode in ("all",) + tuple(m for m, _ in FETCH_MODES):
        g, e = rows[mode]["graph"], rows[mode]["eager"]
        g_dev = g.get("replay_ms") or g["profile_ms"]["device_ms"]
        e_dev = e["profile_ms"]["device_ms"]
        print(f"graph vs eager, fetch {mode} ({card_line()}): tpot_p50_s graph "
              f"{g['tpot_p50_s']:.4f} eager {e['tpot_p50_s']:.4f}; decode step device ms graph "
              f"replay {g_dev:.2f} (events {g.get('replay_ms_range')}) profiled "
              f"{g['profile_ms']['device_ms']:.2f} eager profiled {e_dev:.2f}; by kind graph "
              f"{json.dumps({k: round(v, 2) for k, v in g['profile_ms'].items()})} eager "
              f"{json.dumps({k: round(v, 2) for k, v in e['profile_ms'].items()})}; tpot / device "
              f"graph {g['tpot_p50_s'] * 1e3 / g_dev:.2f} eager "
              f"{e['tpot_p50_s'] * 1e3 / e_dev:.2f}; peak_gb graph {g['peak_gb']:.2f} eager "
              f"{e['peak_gb']:.2f}; reserved_gb graph {g['reserved_gb']:.2f} eager "
              f"{e['reserved_gb']:.2f}; landed_gb per step {g['landed_gb']:.3f} / "
              f"{e['landed_gb']:.3f}; fallbacks {g['fallbacks']} / {e['fallbacks']} (overflowed "
              f"layers {g['overflow_layers']} / {e['overflow_layers']})")
    free_memory()
    brief = {mode: {path: {k: v for k, v in row.items() if k not in ("launches", "paths")}
                    for path, row in by_path.items()} for mode, by_path in rows.items()}
    print(f"fetch modes: {json.dumps(brief)}")
    return rows


# --------------------------------------------------------------------------
# DEP: a DWDP context server feeding a DEP generation server.
# --------------------------------------------------------------------------
def a2a_bytes_per_decode_step(model, xp) -> dict:
    """DEP's all-to-all traffic of one decode step, from the shapes: per MoE
    layer each rank dispatches an ``(E_pad, C, D)`` buffer; the two
    all-to-alls send ``(G' - 1) / G'`` of it out and as much back (``wire``,
    all ranks), and on one card copy every block of it twice (``copied``)."""
    from repro_torch.models.moe import capacity_for

    cfg, pl = model.cfg, model.geom.moe_placement
    cap = capacity_for(xp.global_batch, cfg.moe.num_experts, cfg.moe.top_k, xp.capacity_factor)
    buf = pl.num_padded * cap * cfg.d_model * model.dtype.itemsize
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    g = pl.subgroup_size
    return {"capacity": cap, "wire": n_moe * model.n_ranks * 2 * buf * (g - 1) / g,
            "copied": n_moe * model.n_ranks * 2 * buf}


def dep_phase(cfg, params, prompts) -> dict:
    """The reference's default serving pair on the R1 1024 cell: a DWDP
    context server feeding a DEP generation server (graphs), on the same
    weights. The serve (``serve_phase``: captures flat after warmup, the
    replays' launches measured, flash attention required, prefill and decode
    logits against the plain versions); from the served state one DEP decode
    step (replay time, profile by kind, landed bytes: the merged attention)
    against the DWDP all-fetch step, and one qgather and one hybrid decode
    step against their plain versions; one DEP ``forward_prefill``
    (tensor-parallel attention through flash attention's Hopper path)
    against its plain version; a rolling ``ServingScheduler`` serve over
    ``LiveReplicaClient``; then the same requests on an eager DEP engine
    (``graphs=False``), whose tokens must equal the graph serve's. Returns
    the numbers."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core import execution
    from repro_torch.core.strategy import make_execution_plan
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import build_engine
    from repro_torch.runtime.serving import LiveReplicaClient

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(mesh_shape=(1, G), prefill_len=PROMPT, prefill_buckets=(PROMPT // 2,),
              cache_len=PROMPT + OUTPUT, max_batch=MAX_BATCH, dtype=torch.bfloat16,
              device="cuda", params=params, geom_kwargs=GEOM, ctx_mode="dwdp", gen_mode="dep")
    eng, model = build_engine(cfg, **kw)
    label = f"{cfg.name} {PROMPT} dwdp ctx + dep gen"
    if (eng.ctx.xp.mode, eng.gen.xp.mode) != ("dwdp", "dep") or "pred" in eng.gen.state:
        fail(f"{label}: modes {eng.ctx.xp.mode}/{eng.gen.xp.mode}, a predictive state attached")
    row, outputs = serve_phase(label, cfg, eng, prompts, ALL_FETCH_KERNELS)
    gen, table = eng.gen, eng.gen.xp.policies
    recorded = {k[0]: n for k, n in gen.step.record.items() if k[0] in registry.KERNELS}
    if recorded:
        fail(f"{label}: the DEP decode step's capture recorded kernel launches {recorded}")
    snap = snapshot(gen)
    step = snapshot_step("dep graph", eng, snap)
    dep_logits = step.pop("logits")
    row.update(step)
    sizes = {"data": 1, "model": G}

    def variant_logits(name, mode="dep", decode_attn="gather"):
        """One eager decode step of another plan over the served state: its
        kernels' logits and its plain versions', and its launches."""
        xp = make_execution_plan(model, gen.variants.shape, sizes, mode=mode, policy=table,
                                 decode_attn=decode_attn, capacity_from=gen.xp.capacity_from)

        def logits(impl):
            with in_pool(eng):
                out = execution.forward_decode(eng.params, gen.cur_token, gen.state,
                                               execution.Ctx(model=model, xp=xp, impl=impl))
            return out["logits"].clone()

        registry.reset_launch_counts()
        got = logits(None)
        launches = {k: n for k, n in registry.launch_counts().items() if n}
        ref = logits("torch")
        err = logit_err(f"{label} {name} decode step, kernels vs plain",
                        got[:, :cfg.vocab_size], ref[:, :cfg.vocab_size])
        print(f"{label} {name} decode step launches {json.dumps(launches)}")
        return got, err, launches

    dwdp_logits, _, _ = variant_logits("dwdp all-fetch", mode="dwdp")
    row["dep_vs_dwdp_err"] = logit_err(f"{label}: DEP decode step vs the DWDP all-fetch step",
                                       dep_logits[:, :cfg.vocab_size],
                                       dwdp_logits[:, :cfg.vocab_size])
    del dwdp_logits
    _, row["qgather_err"], _ = variant_logits("dep qgather", decode_attn="qgather")
    _, row["hybrid_err"], hybrid_launches = variant_logits("hybrid", mode="hybrid")
    missing = [k for k in HYBRID_KERNELS if not hybrid_launches.get(k)]
    if missing:
        fail(f"{label}: the hybrid decode step never launched {missing}")

    # DEP's own prefill: tensor-parallel attention through flash attention
    xp = make_execution_plan(model, InputShape("ctx", PROMPT, 1, "prefill"), sizes, mode="dep")
    tokens = torch.as_tensor(prompts[0][None, :], dtype=torch.int64, device="cuda")
    registry.reset_launch_counts()
    clear_path_counts()
    with in_pool(eng):
        got = execution.forward_prefill(eng.params, tokens, execution.Ctx(model=model, xp=xp))
        got = got["last_logits"].clone()
    launched = {k: n for k, n in registry.launch_counts().items() if n}
    paths = path_counts()
    check_paths(f"{label} dep prefill", paths)
    n_layers = cfg.num_layers * G
    if launched != {k: n_layers for k in DEP_KERNELS} or sum(paths.values()) != n_layers:
        fail(f"{label}: the DEP prefill launched {launched}, paths {paths}; want "
             f"{n_layers} launches of each of {DEP_KERNELS} on the Hopper path, nothing else")
    with in_pool(eng):
        ref = execution.forward_prefill(eng.params, tokens,
                                        execution.Ctx(model=model, xp=xp, impl="torch"))
        ref = ref["last_logits"].clone()
    row["dep_prefill_err"] = logit_err(f"{label} DEP prefill (tensor-parallel attention) "
                                       f"logits, kernels vs plain", got[:, :cfg.vocab_size],
                                       ref[:, :cfg.vocab_size])
    row["dep_prefill_paths"] = paths
    del got, ref, tokens

    # a rolling ServingScheduler serve over the live client
    client = LiveReplicaClient.from_engine(eng)
    client.warmup()
    warm = captures(eng)
    row["rolling"] = drive_scheduler("dep rolling", client, served_requests(prompts, SERVING_LENS),
                                     ALL_FETCH_KERNELS)
    row["rolling"].pop("outputs")
    if captures(eng) != warm:
        fail(f"{label}: the rolling serve captured ({warm} -> {captures(eng)})")
    row["a2a_bytes_per_decode_step"] = a2a_bytes_per_decode_step(model, gen.xp)
    phase_peak = torch.cuda.max_memory_allocated()
    row["dep_phase_peak_gb"] = phase_peak / 1e9
    if phase_peak > PEAK_LIMIT:
        fail(f"{label}: peak memory {phase_peak / 1e9:.2f} GB > {PEAK_LIMIT / 1e9:.0f} GB")
    del eng, client, gen, model, dep_logits
    free_memory()

    # the same requests through eager steps
    eager, _ = build_engine(cfg, graphs=False, **kw)
    eager_outputs = serve(eager, prompts)
    row["eager_tpot_p50_s"] = eager.metrics.summary(horizon=eager.horizon())["tpot_p50_s"]
    print(f"{label}: graph and eager serves give the same tokens {eager_outputs == outputs}; "
          f"eager tpot_p50_s {row['eager_tpot_p50_s']:.4f}")
    if eager_outputs != outputs:
        fail(f"{label}: the eager DEP serve gave other tokens: {eager_outputs} vs {outputs}")
    del eager
    free_memory()
    a2a = row["a2a_bytes_per_decode_step"]
    print(f"dep ({card_line()}): tpot_p50_s {row['summary']['tpot_p50_s']:.4f} decode step "
          f"replay ms {row['replay_ms']:.2f} {row['replay_ms_range']} profiled by kind "
          f"{json.dumps({k: round(v, 2) for k, v in row['profile_ms'].items()})} landed_gb per "
          f"decode step {row['landed_gb']:.3f} (the merged attention) all-to-all bytes per "
          f"decode step {json.dumps(a2a)} peak_gb {row['peak_gb']:.2f} (phase "
          f"{row['dep_phase_peak_gb']:.2f})")
    return row


# --------------------------------------------------------------------------
# The serving layer: ServingScheduler over LiveReplicaClient, and replicas.
# --------------------------------------------------------------------------
def served_requests(prompts, lens) -> list:
    from repro_torch.runtime.serving import ServedRequest

    return [ServedRequest(req_id=i, prompt_len=len(p), target_len=n, tokens=p)
            for i, (p, n) in enumerate(zip(prompts, lens))]


def summary_line(summary: dict) -> str:
    """The serving summary's headline numbers (tps_per_gpu: one card per
    replica, whose G logical ranks share it)."""
    keys = ("completed", "ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "tpot_p95_s",
            "mean_tps_user", "tps_per_gpu", "gather_fetch_ratio", "gathered_mb_fetched",
            "gathered_mb_full", "predict_hit_rate", "spec_hit_rate", "cache_hit_rate", "admission")
    return json.dumps({k: summary.get(k) for k in keys})


def drive_scheduler(label: str, client, reqs, kernels, **kw) -> dict:
    """Serve ``reqs`` through a ``ServingScheduler`` over ``client`` with the
    launch counts and landed bytes set to 0 just before and read just after;
    every kernel in ``kernels`` must have launched. Returns the scheduler's
    numbers, summary and streams."""
    import torch
    from repro_torch.core import prefetch
    from repro_torch.kernels import registry
    from repro_torch.runtime.serving import ServingScheduler

    for r in reqs:
        r.resume = r.remaining = None
    registry.reset_launch_counts()
    prefetch.LANDED.bytes = 0
    sched = ServingScheduler(client, **kw)
    sched.submit(reqs)
    t0 = time.perf_counter()
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = registry.launch_counts()
    summary = sched.metrics.summary(horizon=sched.t)
    gen = client.gen
    landed_step = gen.step.record[("landed", "bytes")] if gen.step.record else None
    print(f"serving {label}: {sched.steps} decode steps, horizon {sched.t:.4f} s, wall "
          f"{wall:.3f} s; summary {summary_line(summary)}; landed GB over the serve "
          f"{prefetch.LANDED.bytes / 1e9:.3f}, per decode step (all {G} ranks, prefetch.LANDED) "
          f"{(landed_step or 0) / 1e9:.3f} beside the modelled per-rank decode step "
          f"{gen.gather_bytes['fetched'] / 1e9:.3f} GB fetched of {gen.gather_bytes['full'] / 1e9:.3f}"
          f" full; launches {json.dumps(counts)}")
    missing = [k for k in kernels if counts[k] <= 0]
    if missing:
        fail(f"serving {label}: kernels never launched: {missing}")
    if summary["completed"] != len(reqs):
        fail(f"serving {label}: {summary['completed']} of {len(reqs)} requests completed")
    return {"steps": sched.steps, "horizon_s": sched.t, "wall_s": wall, "summary": summary,
            "launches": counts, "landed_gb": prefetch.LANDED.bytes / 1e9,
            "landed_gb_per_decode_step": (landed_step or 0) / 1e9,
            "model_gb_per_rank_decode_step": gen.gather_bytes["fetched"] / 1e9,
            "outputs": {rid: list(t) for rid, t in sched.outputs.items()}}


def swap_resume(client, reqs, ref: dict, before: int = 3) -> bool:
    """Requests 0 and 1 admitted into slots 0 and 1, ``before`` decode steps,
    both evicted to the host, resumed into each other's slot, then decoded
    to their targets: their streams must equal ``ref``'s."""
    a, b = reqs[0], reqs[1]
    for r in (a, b):
        r.resume = None
    streams = {a.req_id: [client.admit(0, a)[0]], b.req_id: [client.admit(1, b)[0]]}
    slots = {0: a, 1: b}
    for i in range(before):
        toks, _ = client.step([0, 1])
        for slot, r in slots.items():
            streams[r.req_id].append(int(toks[slot]))
    snaps = {r.req_id: client.evict(slot) for slot, r in slots.items()}
    slots = {0: b, 1: a}
    for slot, r in slots.items():
        r.resume = snaps[r.req_id]
        client.admit(slot, r)
        r.resume = None
    while slots:
        toks, _ = client.step(sorted(slots))
        for slot, r in list(slots.items()):
            streams[r.req_id].append(int(toks[slot]))
            if len(streams[r.req_id]) == r.target_len:
                client.release(slot)
                del slots[slot]
    ok = all(streams[r.req_id] == ref[r.req_id] for r in (a, b))
    print(f"serving swap resume: requests {a.req_id}, {b.req_id} evicted after {before} steps "
          f"and resumed in each other's slot: streams equal the uninterrupted ones {ok}")
    return ok


def serving_layer(cfg, engine, prompts) -> dict:
    """The serving layer at DeepSeek-R1 width on the R1 engine's weights and
    graph pool, with row-local capacity (``capacity_from="global"``: with 1
    expert slot for 2 rows a request's tokens would depend on its batch
    neighbour, and rolling and epoch admission pair requests differently).
    4 requests at buckets 1024 and 512 with 8 / 16 / 8 / 16 output tokens
    through ``DisaggregatedEngine.run``, then ``ServingScheduler`` over
    ``LiveReplicaClient`` with rolling admission and in ``epoch_mode``: the
    three streams must be bitwise equal and rolling must take fewer decode
    steps. Then an SLO serve (evict_after 2, a target above 1 / TPOT) that
    evicts and resumes with the same streams, and two requests evicted and
    resumed in each other's slot. No capture after warmup. Returns the
    numbers."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.runtime.engine import (
        ContextServer, DisaggregatedEngine, GenerationServer, Request)
    from repro_torch.runtime.serving import AdmissionController, LiveReplicaClient, SLOConfig

    free_memory()
    sizes = {"data": 1, "model": G}
    kw = dict(capacity_from="global", space=engine.gen.space)
    ctx = ContextServer(engine.gen.model, sizes, prefill_len=engine.ctx.prefill_len,
                        prefill_buckets=engine.ctx.prefill_lens, cache_len=engine.ctx.cache_len,
                        **kw)
    gen = GenerationServer(engine.gen.model, sizes, max_batch=MAX_BATCH,
                           cache_len=engine.gen.cache_len, **kw)
    eng = DisaggregatedEngine(engine.params, ctx, gen)
    client = LiveReplicaClient.from_engine(eng)
    client.warmup()
    warm = captures(eng)
    lens = SERVING_LENS
    # the engine's fixed loop
    registry.reset_launch_counts()
    for i, (p, n) in enumerate(zip(prompts, lens)):
        eng.submit(Request(i, p, n))
    run_steps = 0
    while eng.busy():
        eng.run(1)
        run_steps += 1
    ref = {rid: list(t) for rid, t in eng.outputs.items()}
    run_summary = eng.metrics.summary(horizon=eng.horizon())
    print(f"serving engine.run: {run_steps} decode steps; summary {summary_line(run_summary)}; "
          f"launches {json.dumps(registry.launch_counts())}")
    out = {"lens": list(lens), "engine_run": {"steps": run_steps, "summary": run_summary}}
    reqs = served_requests(prompts, lens)
    for name, kw in (("rolling", {}), ("epoch", {"epoch_mode": True})):
        out[name] = drive_scheduler(name, client, reqs, ALL_FETCH_KERNELS, **kw)
    tpot = out["rolling"]["summary"]["tpot_p50_s"]
    # a fresh client: its step-time projection is empty, so both slots admit
    # and the measured steps miss the target
    slo = SLOConfig(target_tps_user=2.0 / tpot, evict_after=2)
    slo_client = LiveReplicaClient.from_engine(eng)
    out["slo"] = drive_scheduler(
        f"SLO (target {slo.target_tps_user:.2f} tokens/s/user, evict_after 2)", slo_client, reqs,
        ALL_FETCH_KERNELS, admission=AdmissionController(slo, slo_client.step_time))
    out["swap_resume_bitwise"] = swap_resume(client, reqs, ref)
    streams = {name: out[name].pop("outputs") for name in ("rolling", "epoch", "slo")}
    adm = out["slo"]["summary"].get("admission", {})
    print(f"serving ({card_line()}): rolling {out['rolling']['steps']} vs epoch "
          f"{out['epoch']['steps']} decode steps; streams rolling == epoch == engine.run == SLO "
          f"{all(s == ref for s in streams.values())}; SLO admission {json.dumps(adm)}; captures "
          f"(ctx, gen) after warmup {warm}, after serving {captures(eng)}")
    for name, s in streams.items():
        if s != ref:
            fail(f"serving {name}: streams differ from engine.run's: {s} vs {ref}")
    if not out["rolling"]["steps"] < out["epoch"]["steps"]:
        fail("serving: rolling admission took no fewer decode steps than epoch mode")
    if adm.get("evicted", 0) < 1 or adm.get("resumed", 0) < 1:
        fail(f"serving SLO: no eviction and resume ({adm})")
    if not out["swap_resume_bitwise"]:
        fail("serving: requests resumed in another slot gave other tokens")
    if captures(eng) != warm:
        fail(f"serving: captured after warmup ({warm} -> {captures(eng)})")
    out["captures"] = list(warm)
    del eng, client, slo_client, ctx, gen
    free_memory()
    return out


def predictive_trace(label: str, eng, prompts, ref_outputs, table) -> dict:
    """A predictive serve through the live client on a warmed demand engine
    switched to ``table``, with a ``RoutedTraceRecorder``: the bitmaps are
    (steps, ranks, experts), each rank's at most top_k * rows (one MoE layer),
    the tokens those of the all-fetch serve, and nothing is captured."""
    import numpy as np
    from repro_torch.runtime.serving import LiveReplicaClient, RoutedTraceRecorder

    warm = captures(eng)
    eng.gen.set_policy(table)
    trace = RoutedTraceRecorder()
    client = LiveReplicaClient.from_engine(eng)
    row = drive_scheduler(label, client, served_requests(prompts, [OUTPUT] * len(prompts)),
                          ("split_grouped_swiglu_demand",), on_step=trace)
    bm = trace.as_array()
    cfg = eng.gen.model.cfg
    per_rank = bm.sum(-1)
    limit = cfg.moe.top_k * MAX_BATCH
    print(f"serving {label}: routed trace {bm.shape} {bm.dtype}, experts per rank and step "
          f"{int(per_rank.min())}-{int(per_rank.max())} (at most {limit}); tokens equal the "
          f"all-fetch serve {row['outputs'] == ref_outputs}")
    if bm.shape != (row["steps"], G, cfg.moe.num_experts) or bm.dtype != np.bool_:
        fail(f"{label}: routed trace of shape {bm.shape} {bm.dtype}")
    if per_rank.max() > limit or not bm.any():
        fail(f"{label}: {int(per_rank.max())} routed experts on a rank, at most {limit}")
    if row.pop("outputs") != ref_outputs:
        fail(f"{label}: tokens differ from the all-fetch serve")
    if captures(eng) != warm:
        fail(f"{label}: captured after warmup ({warm} -> {captures(eng)})")
    row["trace_shape"] = list(bm.shape)
    row["experts_per_rank_max"] = int(per_rank.max())
    return row


def gemma_fleet(cfg) -> dict:
    """Two Gemma-3 replicas (the same seeded weights, graphs) behind
    ``MultiReplicaEngine``: a workload skewed to the 4096 bucket, routed
    least loaded; every request must complete. The replicas run one after
    another on the one card, each on its own clock; the merged
    ``tps_per_gpu`` counts one card per replica."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import build_engine
    from repro_torch.runtime.serving import (
        LiveReplicaClient, MultiReplicaEngine, ServingScheduler, WorkloadConfig,
        synthesize_workload)

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    scheds = []
    for _ in range(2):
        eng, _ = build_engine(
            cfg, mesh_shape=(1, G), prefill_len=GEMMA_PROMPT, prefill_buckets=(GEMMA_PROMPT // 2,),
            cache_len=GEMMA_PROMPT + FLEET_OSL * 2, max_batch=MAX_BATCH, dtype=torch.bfloat16,
            device="cuda", seed=0, geom_kwargs=GEMMA_GEOM,
        )
        client = LiveReplicaClient.from_engine(eng)
        client.warmup()
        scheds.append(ServingScheduler(client))
    warm = [captures(s.client) for s in scheds]
    fleet = MultiReplicaEngine(scheds)
    wl = WorkloadConfig(num_requests=FLEET_REQUESTS, isl_buckets=(GEMMA_PROMPT // 2, GEMMA_PROMPT),
                        isl_weights=(0.2, 0.8), osl=FLEET_OSL, osl_jitter=0.5, seed=1)
    reqs = synthesize_workload(wl, vocab_size=cfg.vocab_size)
    registry.reset_launch_counts()
    fleet.submit(reqs)
    t0 = time.perf_counter()
    merged = fleet.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = registry.launch_counts()
    summary = merged.summary(horizon=fleet.horizon())
    per = [{"requests": sorted(r for r, i in fleet.assignments.items() if i == k),
            "steps": s.steps, "horizon_s": s.t,
            "summary": s.metrics.summary(horizon=s.t)} for k, s in enumerate(scheds)]
    peak = torch.cuda.max_memory_allocated()
    print(f"serving fleet {cfg.name} x2 ({card_line()}): workload "
          f"{[(r.req_id, r.prompt_len, r.target_len) for r in reqs]}; router assignments "
          f"{json.dumps(fleet.assignments)}; per replica "
          f"{json.dumps([{k: v for k, v in p.items() if k != 'summary'} for p in per])}; merged "
          f"summary (num_gpus {merged.num_gpus}: one per replica, both on this card) "
          f"{summary_line(summary)}; wall {wall:.3f} s; peak {peak / 1e9:.2f} GB; launches "
          f"{json.dumps(counts)}")
    if summary["completed"] != len(reqs):
        fail(f"serving fleet: {summary['completed']} of {len(reqs)} requests completed")
    missing = [k for k in GEMMA_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"serving fleet: kernels never launched: {missing}")
    if [captures(s.client) for s in scheds] != warm:
        fail("serving fleet: captured after warmup")
    if min(len(p["requests"]) for p in per) < 1:
        fail("serving fleet: a replica got no request")
    out = {"assignments": dict(fleet.assignments), "horizon_s": fleet.horizon(), "wall_s": wall,
           "summary": summary, "replicas": per, "launches": counts, "peak_gb": peak / 1e9}
    del fleet, scheds, eng, client
    free_memory()
    return out


def r1_numbers(r1: dict) -> dict:
    """The serve numbers of the all-fetch graph serve, as a fetch-mode row."""
    s = r1["summary"]
    return {"tpot_p50_s": s["tpot_p50_s"], "tpot_p95_s": s["tpot_p95_s"],
            "ttft_p50_s": s["ttft_p50_s"], "mean_tps_user": s["mean_tps_user"],
            "tps_per_gpu": s["tps_per_gpu"], "wall_s": r1["wall_s"], "peak_gb": r1["peak_gb"],
            "reserved_gb": r1["reserved_gb"], "captures": r1["captures"],
            "fallbacks": r1["fallbacks"], "overflow_layers": r1["overflow_layers"],
            "launches": r1["launches"], "paths": r1["paths"]}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA device")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"the port's sources are not beside this script ({SRC}/repro_torch missing)")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np

    from repro_torch.kernels import build, registry
    from repro_torch.launch.serve import build_engine

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- build ----------------------------------------------------------
    t0 = time.perf_counter()
    report = build.build_all()
    print(f"build: {len(report)} kernel libraries compiled in {time.perf_counter() - t0:.1f} s "
          f"({sorted(report)})")
    for name, rep in sorted(report.items()):
        keep = [ln.strip() for ln in rep["ptxas"].splitlines()
                if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        print(f"ptxas -v {name}:")
        for ln in keep:
            print(f"  {ln}")
    for name in registry.KERNELS:
        build.load(name)

    # ---- kernel checks --------------------------------------------------
    cfg = r1_two_layers()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results: dict = {}
    gemma_cfg = gemma_six_layers()
    cases = kernel_cases(cfg, gemma_cfg) + [("flash_attention", phase, shp)
                                            for phase, shp in flash_cases(cfg, gemma_cfg)]
    for name, phase, shp in cases:
        if name == "flash_attention":
            row = run_flash_case(shp, gen)
        else:
            row = run_kernel_case(name, shp, gen)
        results.setdefault(name, {})[phase] = row
        worst_row = (f" worst row {row['max_row_rel_err']:.3e}"
                     if "max_row_rel_err" in row else "")
        plans = " ".join(f"{k} {json.dumps(v)}" for k, v in row.items() if k.startswith("plan"))
        library = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        widened = (f" widened_bf16_ms {row['widened_bf16_ms']:.4f}"
                   if "widened_bf16_ms" in row else "")
        print(f"kernel {name} {phase} {row['shape']}: rel_err {row['max_rel_err']:.3e}{worst_row} "
              f"(tol {KERNEL_TOL}) ms {row['ms']:.4f} {row['ms_range']} plain_ms "
              f"{row['plain_ms']:.4f} library_ms {library}{widened} bound_ms "
              f"{row['bound_ms']:.4f} ({row['bound_by']})"
              + (f" {plans} bitwise_repeat {row['bitwise_repeat']}" if plans else ""))
    grouped_ffn_row = grouped_ffn_case(cfg, gen)
    tile_err = check_hopper_tile(gen)
    demand_checks = check_demand_matches_grouped(cfg, gen)
    fp8_checks = check_fp8_matches_widened(cfg, gen)
    gemm_launches = drive_split_gemm(cfg, gen)

    # ---- serve ----------------------------------------------------------
    free_memory()
    rng = np.random.default_rng(0)
    # two pow2 prefill buckets: 1024 and 512 tokens, in turns
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT // (1 + i % 2)) for i in range(N_REQUESTS)]
    t0 = time.perf_counter()
    engine, model = build_engine(
        cfg, mesh_shape=(1, G), prefill_len=PROMPT, prefill_buckets=(PROMPT // 2,),
        cache_len=PROMPT + OUTPUT, max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda",
        seed=0, geom_kwargs=GEOM,
    )
    torch.cuda.synchronize()
    print(f"model: {cfg.name} d_model {cfg.d_model} layers {cfg.num_layers} "
          f"(first_dense {cfg.moe.first_dense}) experts {cfg.moe.num_experts} "
          f"geometry {model.geom.expert_axes}/{model.geom.moe_exec} attn_shards "
          f"{model.geom.attn_shards} ffn_shards {model.geom.ffn_shards}; init "
          f"{time.perf_counter() - t0:.1f} s, weights "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; prefill buckets "
          f"{engine.ctx.prefill_lens}")
    r1, outputs = serve_phase(f"{cfg.name} {PROMPT}", cfg, engine, prompts, ALL_FETCH_KERNELS)
    r1["isolation"] = check_isolation(cfg.name, cfg, engine, model, prompts)
    serving = serving_layer(cfg, engine, prompts)
    # the all-fetch decode state after the serve: every fetch mode's one
    # decode step starts from it
    snap = snapshot(engine.gen)
    ref_step = snapshot_step("fetch all graph", engine, snap)
    params = engine.params
    del engine, model
    free_memory()

    # ---- the whole path in fp32 at reduced width: kernels vs plain ---------
    from repro_torch.configs import reduced_variant

    small_cfg = reduced_variant(cfg)
    small, _ = build_engine(
        small_cfg, mesh_shape=(1, G), prefill_len=64, cache_len=80, max_batch=MAX_BATCH,
        dtype=torch.float32, device="cuda", seed=1, geom_kwargs=GEOM,
    )
    toks = rng.integers(0, small_cfg.vocab_size, 64)
    sk = small.ctx.forward(small.params, toks)["last_logits"][:, : small_cfg.vocab_size].clone()
    st = small.ctx.forward(small.params, toks, impl="torch")["last_logits"][:, : small_cfg.vocab_size]
    fp32_err = ((sk - st).abs().max() / st.abs().max()).item()
    print(f"fp32 reduced-width prefill logits kernels vs plain: max err / max|ref| "
          f"{fp32_err:.3e} (tol {FP32_LOGIT_TOL})")
    if fp32_err > FP32_LOGIT_TOL:
        fail(f"fp32 prefill logits disagree: {fp32_err:.3e} > {FP32_LOGIT_TOL}")
    del small, sk, st

    # ---- every fetch mode on the same weights, graphs and eager -----------
    modes = serve_fetch_modes(cfg, params, prompts, outputs, r1, snap, ref_step)
    demand_launches = sum(m["graph"]["demand_launches_measured"]
                          for mode, m in modes.items() if mode in dict(FETCH_MODES))

    # ---- DeepSeek-R1 at the paper's input length, on the same weights ------
    long_prompts = [rng.integers(0, cfg.vocab_size, LONG_PROMPT) for _ in range(LONG_REQUESTS)]
    long_eng, _ = build_engine(
        cfg, mesh_shape=(1, G), prefill_len=LONG_PROMPT, cache_len=LONG_PROMPT + OUTPUT,
        max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda", params=params,
        geom_kwargs=GEOM,
    )
    r1_long, _ = serve_phase(f"{cfg.name} {LONG_PROMPT}", cfg, long_eng, long_prompts,
                             ALL_FETCH_KERNELS)
    del long_eng
    free_memory()

    # ---- DEP: a DWDP context server feeding a DEP generation server ---------
    dep = dep_phase(cfg, params, prompts)
    del params
    free_memory()
    rolling = {"dep": dep["rolling"]["summary"], "dwdp_all_row_local": serving["rolling"]["summary"]}
    run = {"dep": dep["summary"], "dwdp_all": modes["all"]["graph"],
           "dwdp_demand": modes["demand"]["graph"]}
    print(f"dep vs dwdp ({card}; R1 {PROMPT}; tps_per_gpu counts one card, whose {G} logical "
          f"ranks share it): engine.run, 4 requests x {OUTPUT} tokens: " + json.dumps({
              k: {m: v.get(m) for m in ("tpot_p50_s", "mean_tps_user", "tps_per_gpu")}
              for k, v in run.items()}) + f"; rolling ServingScheduler ({list(SERVING_LENS)} "
          "tokens): " + json.dumps({k: {m: v.get(m) for m in ("tpot_p50_s", "mean_tps_user",
                                                                "tps_per_gpu")}
                                    for k, v in rolling.items()}) + "; decode step replay ms "
          + json.dumps({"dep": dep["replay_ms"], "dwdp_all": modes["all"]["graph"]["replay_ms"],
                        "dwdp_demand": modes["demand"]["graph"]["replay_ms"]}))

    # ---- Gemma-3-27B: sliding-window layers, dense split kernels -----------
    gemma_prompts = [rng.integers(0, gemma_cfg.vocab_size, GEMMA_PROMPT)
                     for _ in range(N_REQUESTS)]
    gemma_eng, gmodel = build_engine(
        gemma_cfg, mesh_shape=(1, G), prefill_len=GEMMA_PROMPT, cache_len=GEMMA_PROMPT + OUTPUT,
        max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda", seed=0,
        geom_kwargs=GEMMA_GEOM,
    )
    print(f"model: {gemma_cfg.name} d_model {gemma_cfg.d_model} layers "
          f"{gemma_cfg.num_layers} windows {[s.window for g in gmodel.plan for s in g.sigs]} "
          f"attn_shards "
          f"{gmodel.geom.attn_shards} kv_shard {gmodel.geom.kv_shard} ffn_shards "
          f"{gmodel.geom.ffn_shards} vocab_pad {gmodel.geom.vocab_pad}")
    gemma, _ = serve_phase(f"{gemma_cfg.name} {GEMMA_PROMPT}", gemma_cfg, gemma_eng,
                           gemma_prompts, GEMMA_KERNELS)
    gemma["isolation"] = check_isolation(gemma_cfg.name, gemma_cfg, gemma_eng, gmodel,
                                         gemma_prompts)
    del gemma_eng, gmodel
    fleet = gemma_fleet(gemma_cfg)

    # ---- report ---------------------------------------------------------
    served = collections.Counter()
    for run in (r1, r1_long, gemma):
        served.update(run["paths"])
    print(f"paths of #2-#7 over the three serves (R1 {PROMPT}, R1 {LONG_PROMPT}, Gemma-3 "
          f"{GEMMA_PROMPT}): {json.dumps(dict(sorted(served.items())))}")
    replaces = {
        "split_grouped_swiglu": "src/repro/kernels/split_gemm/split_gemm.py:261",
        "split_stack_gemm": "src/repro/kernels/split_gemm/dense.py:92",
        "split_reduce_gemm": "src/repro/kernels/split_gemm/dense.py:183",
        "split_dense_swiglu": "src/repro/kernels/split_gemm/dense.py:308",
        "split_grouped_swiglu_demand": "src/repro/kernels/split_gemm/split_gemm.py:419",
        "split_grouped_gemm": "src/repro/kernels/split_gemm/split_gemm.py:124",
        "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:74",
    }
    # the phase each kernel's headline numbers come from
    primary = {"flash_attention": "r1_1024_last"}
    # each kernel's launches on its own path, measured through the replays:
    # the all-fetch serve, the three route-before-gather graph serves;
    # ops.split_gemm eagerly
    launches = dict(r1["launches"], split_grouped_swiglu_demand=demand_launches,
                    split_grouped_gemm=gemm_launches)
    kernels = []
    for name in registry.KERNELS:
        head = primary.get(name, "decode")
        dec = results[name][head]
        others = {ph: row for ph, row in results[name].items() if ph != head}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "launches_r1_8192": r1_long["launches"][name],
            "launches_r1_1024_dep": dep["launches"][name],
            "launches_gemma3_4096": gemma["launches"][name],
            "max_abs_err": dec["max_abs_err"],
            "max_rel_err": dec["max_rel_err"],
            "ms": dec["ms"],
            "ms_range": dec["ms_range"],
            "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"],
            "library_ms": dec["library_ms"],
            "shape": dec["shape"],
            **others,
        })
        if "max_row_rel_err" in dec:
            kernels[-1].update(max_row_rel_err=dec["max_row_rel_err"], plan=dec["plan"],
                               bitwise_repeat=dec["bitwise_repeat"])
        if name == "split_grouped_swiglu_demand":
            kernels[-1]["checks"] = demand_checks
        if name == "split_grouped_gemm":
            kernels[-1]["fp8_bitwise_widened_bf16"] = fp8_checks
        if name in PLANNED:
            kernels[-1]["header"] = "src/repro_torch/kernels/csrc/split_hopper.cuh"
            kernels[-1].update({k: v for k, v in dec.items()
                                if k.startswith("plan_") or k == "bitwise_repeat"})
        if name == "split_reduce_gemm":
            kernels[-1]["hopper_tile_rel_err"] = tile_err
    predictive = modes["demand"]["graph"]["predictive_trace"]
    print(f"serving numbers ({card}; tps_per_gpu counts one card per replica, whose {G} logical "
          f"ranks share it): " + json.dumps({
              "r1_1024_rolling": serving["rolling"]["summary"],
              "r1_1024_epoch": serving["epoch"]["summary"],
              "r1_1024_slo": serving["slo"]["summary"],
              "r1_1024_engine_run": serving["engine_run"]["summary"],
              "steps": {k: serving[k]["steps"] for k in ("rolling", "epoch", "slo")},
              "landed_gb_per_decode_step": serving["rolling"]["landed_gb_per_decode_step"],
              "model_gb_per_rank_decode_step": serving["rolling"]["model_gb_per_rank_decode_step"],
              "r1_1024_predictive": predictive["summary"],
              "r1_1024_dep_rolling": dep["rolling"]["summary"],
              "grouped_ffn_dep_decode": grouped_ffn_row,
              "gemma3_fleet": fleet["summary"], "gemma3_fleet_assignments": fleet["assignments"]}))
    print(f"total_s {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
