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
   never calls) and its bound. The demand kernel is checked at each fetch
   mode's fetched bank; its padding rows must be exact zeros and its real
   experts' blocks bitwise kernel #2's;
4. ``ops.split_gemm`` (kernel #1's entry point; no engine calls it) at
   R1 expert shapes, its launches counted;
5. serve: ``build_engine`` at DeepSeek-R1 width (2 layers, first one
   dense), mesh (data=1, model=4) as 4 logical ranks, random weights from a
   seeded generator; 4 requests of 1024 tokens, 16 output tokens each,
   max_batch 2. Every kernel of the all-fetch path must have launched.
   One prefill's logits are compared with the plain versions' (tolerance
   below), and a request served alone must give the same tokens as served
   among the 4 (row-local capacity, ``capacity_from="global"``);
6. fetch modes: the same 4 requests on the same weights under
   ``expert_fetch`` demand, predictive and sync_free (route-before-gather
   decode through the demand kernel, which must launch); every request's
   tokens must equal the all-fetch tokens, and one decode step's logits
   must be bitwise the all-fetch step's. Per mode: TPOT, peak memory,
   landing bytes per decode step, fallbacks, summed ``pred_stats`` and a
   profiled decode step;
7. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Needs a CUDA device and the repository's ``src/`` beside this file.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
KERNEL_TOL = 2e-2             # bf16, relative to max|ref| (tests/test_kernels.py TOL)
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
                     "split_dense_swiglu")
# The route-before-gather modes. Residency-cache rows per rank and MoE
# layer (88 MB each at R1 width): 8 keeps the all-fetch prefill's two
# remote banks plus the 4 ranks' caches under the 70 GB limit.
CACHE_BUDGET = 8
FETCH_MODES = (("demand", {}), ("predictive", {"cache_budget": CACHE_BUDGET}),
               ("sync_free", {"cache_budget": CACHE_BUDGET}))
PEAK_LIMIT = 70e9
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
    device-to-device copies of the landing banks, everything else) beside
    the host wall time."""
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
    kinds = {"split kernels": 0.0, "landing copies": 0.0, "other device work": 0.0}
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key
        if any(k in name for k in ("grouped_kernel", "gate_up_kernel", "reduce_kernel")):
            kind = "split kernels"
        elif "Memcpy" in name or "memcpy" in name or "indexSelect" in name:
            # landing copies of split banks, row gathers of demand payloads
            kind = "landing copies"
        else:
            kind = "other device work"
        kinds[kind] += us / 1e3
        rows.append((us / 1e3, e.count, name[:70]))
    busy = sum(kinds.values())
    print(f"profile {label}: wall_ms_under_profiler {wall_ms:.2f} device_ms_sum {busy:.2f} "
          + " ".join(f"[{k}: {v:.2f} ms]" for k, v in kinds.items()))
    for ms, count, name in sorted(rows, reverse=True)[:8]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name}")
    return dict(kinds, device_ms=busy)


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


def kernel_cases(cfg):
    """(kernel, phase, shapes) at the per-rank main-path shapes."""
    from repro_torch.models.moe import capacity_for

    d, a = cfg.d_model, G
    qd = cfg.q_dim // a
    fs = cfg.d_ff // G
    e, fe = cfg.moe.num_experts, cfg.moe.d_ff
    cases = []
    for phase, t, c in (("prefill", PROMPT // G, capacity_for(PROMPT // G, e, cfg.moe.top_k, 1.25)),
                        ("decode", MAX_BATCH, capacity_for(MAX_BATCH, e, cfg.moe.top_k, 1.25))):
        cases.append(("split_stack_gemm", phase, dict(t=t, d=d, f=qd, s=a)))
        cases.append(("split_reduce_gemm", phase, dict(t=t, d=d, f=qd, s=a)))
        cases.append(("split_dense_swiglu", phase, dict(t=t, d=d, f=fs, s=G)))
        cases.append(("split_grouped_swiglu", phase, dict(c=c, d=d, f=fe, e=e, e_l=e // G)))
        cases.append(("split_grouped_gemm", phase, dict(c=c, d=d, f=fe, e=e, e_l=e // G)))
    # the demand kernel: 64 resident experts + the fetched bank of each
    # mode's decode (C 1, the few-row path), about half its rows valid, and
    # one tensor-core tile shape (C 16)
    rows = demand_fetched_rows(cfg)
    for phase, c, e_f in (("decode", 1, rows["decode"]),
                          ("decode_predictive", 1, rows["decode_predictive"]),
                          ("tile", 16, rows["decode"])):
        cases.append(("split_grouped_swiglu_demand", phase,
                      dict(c=c, d=d, f=fe, e_l=e // G, e_f=e_f)))
    return cases


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
        args = (rnd(e, c, d, scale=1.0), rnd(e_l, d, f), rnd(e - e_l, d, f))
        kern, plain = grouped.split_grouped_gemm, grouped.split_grouped_gemm_torch
        nbytes = 2 * (e * c * d + e * d * f + e * c * f)
        flops = 2 * e * c * d * f
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
    got = kern(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    abs_err = (got.float() - ref.float()).abs().max().item()
    rel_err = abs_err / max(ref.float().abs().max().item(), 1e-30)
    row = {"max_abs_err": abs_err, "max_rel_err": rel_err, "tol_rel": KERNEL_TOL}
    for key, fn in (("ms", kern), ("plain_ms", plain), ("library_ms", lib)):
        row[key], lo, hi = time_ms(lambda: fn(*args))
        row[f"{key}_range"] = [lo, hi]
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    row["shape"] = shp
    del args, got, ref
    torch.cuda.empty_cache()
    if rel_err > KERNEL_TOL:
        fail(f"{name} {shp}: kernel disagrees with its plain version: rel err {rel_err:.3e} > {KERNEL_TOL}")
    return row


def check_demand_matches_grouped(cfg, gen) -> dict:
    """The demand kernel over a fetched bank that is a subset of kernel
    #2's remote bank, on the same rows: its padding rows are exact zeros
    and every real expert's block is bitwise kernel #2's (few-row path at
    C 1 with each mode's fetched bank, tensor-core tiles at C 16)."""
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
    for c, e_f in ((1, rows["decode"]), (16, rows["decode"]), (1, rows["decode_predictive"])):
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


def drive_split_gemm(cfg, gen) -> int:
    """Kernel #1's path: its entry point ``ops.split_gemm`` (no engine
    calls it) at R1 expert shapes, C 16 and C 1, with the launch counts
    set to 0 just before and read just after."""
    import torch
    from repro_torch.kernels.split_gemm import ops

    d, f, e = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts
    e_l = e // G
    wl = (torch.randn(e_l, d, f, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    wr = (torch.randn(e - e_l, d, f, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    ops.reset_launch_counts()
    for c in (16, 1):
        x = torch.randn(e, c, d, generator=gen, device="cuda").to(torch.bfloat16)
        y = ops.split_gemm(x, wl, wr)
        if y.shape != (e, c, f) or not torch.isfinite(y).all():
            fail(f"ops.split_gemm C {c}: bad output {tuple(y.shape)}")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"ops.split_gemm path: launch counts {json.dumps(counts)}")
    if counts["split_grouped_gemm"] <= 0:
        fail("split_grouped_gemm never launched on its entry point")
    del wl, wr
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


def serve_fetch_modes(cfg, engine, model, prompts, ref_outputs, ref_summary, ref_peak) -> dict:
    """Serve the same requests on the all-fetch engine's weights under each
    route-before-gather mode. Each mode's tokens must equal the all-fetch
    tokens, and one decode step from the all-fetch engine's current state
    (with the mode's warm predictor) must give bitwise the all-fetch step's
    logits. Returns per-mode numbers."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import execution, prefetch
    from repro_torch.kernels.split_gemm import ops
    from repro_torch.launch.serve import build_engine

    params = engine.params
    tok0, state0 = engine.gen.cur_token, engine.gen.state
    ctx_all = execution.Ctx(model=model, xp=engine.gen.xp)

    def one_step(state, ctx):
        prefetch.LANDED.bytes = 0
        logits = execution.forward_decode(params, tok0, state, ctx)["logits"]
        torch.cuda.synchronize()
        return logits, prefetch.LANDED.bytes

    ref_logits, ref_landed = one_step(state0, ctx_all)
    prof = profile_step("decode step, fetch all", lambda: one_step(state0, ctx_all))
    rows = {"all": {"tpot_p50_s": ref_summary["tpot_p50_s"], "peak_gb": ref_peak / 1e9,
                    "landed_gb_per_decode_step": ref_landed / 1e9, "profile_ms": prof}}
    print(f"fetch all: tpot_p50_s {ref_summary['tpot_p50_s']:.4f} peak_gb {ref_peak / 1e9:.2f} "
          f"landed_gb_per_decode_step {ref_landed / 1e9:.3f}")
    for mode, kw in FETCH_MODES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng, m_model = build_engine(
            cfg, mesh_shape=(1, G), prefill_len=PROMPT, cache_len=PROMPT + OUTPUT,
            max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda", params=params,
            geom_kwargs=GEOM, expert_fetch=mode, **kw,
        )
        xp = eng.gen.xp
        if not execution.demand_fetch_active(cfg, m_model.geom, xp):
            fail(f"expert_fetch={mode}: the decode plan does not run the demand path")
        eng.warmup()
        ops.reset_launch_counts()
        execution.DEMAND.layers = execution.DEMAND.fallbacks = 0
        t0 = time.perf_counter()
        outs = serve(eng, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        layers, fallbacks = execution.DEMAND.layers, execution.DEMAND.fallbacks
        peak = torch.cuda.max_memory_allocated()
        summ = eng.metrics.summary()
        stats = np.sum(eng.gen.pred_stats, axis=0).tolist() if eng.gen.pred_stats else None
        state = dict(state0)
        if "pred" in eng.gen.state:
            state["pred"] = eng.gen.state["pred"]
        ctx = execution.Ctx(model=m_model, xp=xp)
        logits, landed = one_step(state, ctx)
        bitwise = torch.equal(logits, ref_logits)
        prof = profile_step(f"decode step, fetch {mode}", lambda: one_step(state, ctx))
        budgets = {
            "demand_or_corr": execution.resolve_demand_budget(cfg, m_model.geom, xp),
            "spec": (execution.resolve_spec_budget(cfg, m_model.geom, xp)
                     if execution.predictive_fetch_active(cfg, m_model.geom, xp) else 0),
            "cache_rows": kw.get("cache_budget", 0),
        }
        print(f"fetch {mode}: budgets {json.dumps(budgets)} tpot_p50_s {summ['tpot_p50_s']:.4f} "
              f"tpot_p95_s {summ['tpot_p95_s']:.4f} ttft_p50_s {summ['ttft_p50_s']:.4f} "
              f"wall_s {wall:.3f} peak_gb {peak / 1e9:.2f} landed_gb_per_decode_step "
              f"{landed / 1e9:.3f} demand_layers {layers} fallbacks {fallbacks} "
              f"pred_stats_sum {stats} launches {json.dumps(counts)} "
              f"tokens_equal_all {outs == ref_outputs} logits_bitwise_all {bitwise}")
        if outs != ref_outputs:
            fail(f"expert_fetch={mode}: tokens differ from the all-fetch tokens: "
                 f"{outs} vs {ref_outputs}")
        if not bitwise:
            err = (logits.float() - ref_logits.float()).abs().max().item()
            fail(f"expert_fetch={mode}: decode logits not bitwise the all-fetch ones (max {err})")
        if counts["split_grouped_swiglu_demand"] <= 0:
            fail(f"expert_fetch={mode}: split_grouped_swiglu_demand never launched")
        if peak > PEAK_LIMIT:
            fail(f"expert_fetch={mode}: peak memory {peak / 1e9:.2f} GB > {PEAK_LIMIT / 1e9:.0f} GB")
        rows[mode] = {
            "budgets": budgets, "tpot_p50_s": summ["tpot_p50_s"], "tpot_p95_s": summ["tpot_p95_s"],
            "ttft_p50_s": summ["ttft_p50_s"], "peak_gb": peak / 1e9,
            "landed_gb_per_decode_step": landed / 1e9, "demand_layers": layers,
            "fallbacks": fallbacks, "pred_stats_sum": stats, "launches": counts,
            "profile_ms": prof,
        }
        del eng, m_model, state, ctx, logits
    gc.collect()
    torch.cuda.empty_cache()
    print(f"fetch modes: {json.dumps({k: {kk: vv for kk, vv in v.items() if kk != 'launches'} for k, v in rows.items()})}")
    return rows


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

    from repro_torch.kernels import build
    from repro_torch.kernels.split_gemm import ops
    from repro_torch.launch.serve import build_engine
    from repro_torch.runtime.engine import ContextServer, DisaggregatedEngine, GenerationServer

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
    for name in ops.KERNELS:
        build.load(name)

    # ---- kernel checks --------------------------------------------------
    cfg = r1_two_layers()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results: dict = {}
    for name, phase, shp in kernel_cases(cfg):
        row = run_kernel_case(name, shp, gen)
        results.setdefault(name, {})[phase] = row
        print(f"kernel {name} {phase} {row['shape']}: rel_err {row['max_rel_err']:.3e} "
              f"(tol {KERNEL_TOL}) ms {row['ms']:.4f} {row['ms_range']} plain_ms "
              f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} bound_ms "
              f"{row['bound_ms']:.4f} ({row['bound_by']})")
    demand_checks = check_demand_matches_grouped(cfg, gen)
    gemm_launches = drive_split_gemm(cfg, gen)

    # ---- serve ----------------------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT) for _ in range(N_REQUESTS)]
    t0 = time.perf_counter()
    engine, model = build_engine(
        cfg, mesh_shape=(1, G), prefill_len=PROMPT, cache_len=PROMPT + OUTPUT,
        max_batch=MAX_BATCH, dtype=torch.bfloat16, device="cuda", seed=0,
        geom_kwargs=GEOM,
    )
    torch.cuda.synchronize()
    print(f"model: {cfg.name} d_model {cfg.d_model} layers {cfg.num_layers} "
          f"(first_dense {cfg.moe.first_dense}) experts {cfg.moe.num_experts} "
          f"geometry {model.geom.expert_axes}/{model.geom.moe_exec} attn_shards "
          f"{model.geom.attn_shards} ffn_shards {model.geom.ffn_shards}; init "
          f"{time.perf_counter() - t0:.1f} s, weights "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    engine.warmup()
    print(f"warmup (one prefill + one decode step, first calls): {time.perf_counter() - t0:.2f} s")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outputs = serve(engine, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for rec in sorted(engine.metrics.records, key=lambda r: r.req_id):
        print(f"request {rec.req_id}: tokens {outputs[rec.req_id]} ttft_s {rec.ttft:.4f} "
              f"tpot_s {rec.tpot:.4f}")
    summary = engine.metrics.summary()
    print(f"serve: {json.dumps(summary)} wall_s {wall:.3f}")
    print(f"peak memory allocated: {peak / 1e9:.2f} GB")
    print(f"launch counts on the served path: {json.dumps(counts)}")
    if summary["completed"] != N_REQUESTS:
        fail(f"{summary['completed']} of {N_REQUESTS} requests completed")
    for rid, toks in outputs.items():
        if len(toks) != OUTPUT or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"request {rid}: bad tokens {toks}")
    missing = [k for k in ALL_FETCH_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"kernels never launched on the served path: {missing}")
    if peak > PEAK_LIMIT:
        fail(f"peak memory {peak / 1e9:.2f} GB exceeds the {PEAK_LIMIT / 1e9:.0f} GB limit")

    # ---- prefill logits: kernels vs plain versions ------------------------
    lk = engine.ctx.forward(engine.params, prompts[0])["last_logits"]
    lt = engine.ctx.forward(engine.params, prompts[0], impl="torch")["last_logits"]
    v = cfg.vocab_size
    lk, lt = lk[:, :v].float(), lt[:, :v].float()
    if not (torch.isfinite(lk).all() and torch.isfinite(lt).all()):
        fail("non-finite prefill logits")
    logit_err = (torch.linalg.vector_norm(lk - lt) / torch.linalg.vector_norm(lt)).item()
    max_err = ((lk - lt).abs().max() / lt.abs().max()).item()
    print(f"prefill last_logits kernels vs plain: norm-wise rel err {logit_err:.3e} "
          f"(tol {LOGIT_TOL}); max err / max|ref| {max_err:.3e}; "
          f"argmax {int(lk.argmax())} vs {int(lt.argmax())}")
    if logit_err > LOGIT_TOL:
        fail(f"prefill logits disagree: {logit_err:.3e} > {LOGIT_TOL}")

    # ---- a request alone vs among the others ------------------------------
    sizes = {"data": 1, "model": G}

    def fresh_engine():
        kw = dict(capacity_from="global")
        return DisaggregatedEngine(
            engine.params,
            ContextServer(model, sizes, prefill_len=PROMPT, cache_len=engine.ctx.cache_len, **kw),
            GenerationServer(model, sizes, max_batch=MAX_BATCH, cache_len=engine.gen.cache_len, **kw),
        )

    among = serve(fresh_engine(), prompts)[0]
    alone = serve(fresh_engine(), prompts[:1])[0]
    print(f"request 0 among {N_REQUESTS}: {among}\nrequest 0 alone: {alone}")
    if among != alone:
        fail("a request served alone gave other tokens than served among the others")

    # ---- the whole path in fp32 at reduced width: kernels vs plain ---------
    from repro_torch.configs import reduced_variant

    small_cfg = reduced_variant(cfg)
    small, _ = build_engine(
        small_cfg, mesh_shape=(1, G), prefill_len=64, cache_len=80, max_batch=MAX_BATCH,
        dtype=torch.float32, device="cuda", seed=1, geom_kwargs=GEOM,
    )
    toks = rng.integers(0, small_cfg.vocab_size, 64)
    sk = small.ctx.forward(small.params, toks)["last_logits"][:, : small_cfg.vocab_size]
    st = small.ctx.forward(small.params, toks, impl="torch")["last_logits"][:, : small_cfg.vocab_size]
    fp32_err = ((sk - st).abs().max() / st.abs().max()).item()
    print(f"fp32 reduced-width prefill logits kernels vs plain: max err / max|ref| "
          f"{fp32_err:.3e} (tol {FP32_LOGIT_TOL})")
    if fp32_err > FP32_LOGIT_TOL:
        fail(f"fp32 prefill logits disagree: {fp32_err:.3e} > {FP32_LOGIT_TOL}")
    del small

    # ---- where the time goes: one prefill and one decode step, profiled ---
    for label, step in (("prefill", lambda: engine.ctx.forward(engine.params, prompts[0])),
                        ("decode", lambda: engine.gen.decode_step(engine.params))):
        profile_step(label, step)

    # ---- the route-before-gather fetch modes on the same weights ----------
    modes = serve_fetch_modes(cfg, engine, model, prompts, outputs, summary, peak)
    demand_launches = sum(m["launches"]["split_grouped_swiglu_demand"]
                          for mode, m in modes.items() if mode != "all")

    # ---- report ---------------------------------------------------------
    replaces = {
        "split_grouped_swiglu": "src/repro/kernels/split_gemm/split_gemm.py:261",
        "split_stack_gemm": "src/repro/kernels/split_gemm/dense.py:92",
        "split_reduce_gemm": "src/repro/kernels/split_gemm/dense.py:183",
        "split_dense_swiglu": "src/repro/kernels/split_gemm/dense.py:308",
        "split_grouped_swiglu_demand": "src/repro/kernels/split_gemm/split_gemm.py:419",
        "split_grouped_gemm": "src/repro/kernels/split_gemm/split_gemm.py:124",
    }
    # each kernel's launches on its own path: the all-fetch serve, the
    # three route-before-gather serves, ops.split_gemm
    launches = dict(counts, split_grouped_swiglu_demand=demand_launches,
                    split_grouped_gemm=gemm_launches)
    kernels = []
    for name in ops.KERNELS:
        dec = results[name]["decode"]
        others = {ph: row for ph, row in results[name].items() if ph != "decode"}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
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
        if name == "split_grouped_swiglu_demand":
            kernels[-1]["checks"] = demand_checks
    print(f"total_s {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
