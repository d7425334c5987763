#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each fails loudly; the exit code is non-zero on any error):

1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: every CUDA kernel of the DWDP path compiled with ``nvcc`` for
   sm_90a from ``src/repro_torch/kernels/csrc`` (time and ``-Xptxas -v``);
3. kernels: each kernel at the DeepSeek-R1 main-path shapes (prefill and
   decode, per logical rank, G' = 4, bf16) held against its plain PyTorch
   version (max error relative to max|ref| <= 2e-2), and timed with CUDA
   events beside its plain version, a per-bank torch.matmul/bmm
   composition (a yardstick the port never calls) and its bound;
4. serve: ``build_engine`` at DeepSeek-R1 width (2 layers, first one
   dense), mesh (data=1, model=4) as 4 logical ranks, random weights from a
   seeded generator; 4 requests of 1024 tokens, 16 output tokens each,
   max_batch 2. Every kernel must have launched on this path. One
   prefill's logits are compared with the plain versions' (tolerance
   below), and a request served alone must give the same tokens as served
   among the 4 (row-local capacity, ``capacity_from="global"``);
5. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Needs a CUDA device and the repository's ``src/`` beside this file.
"""
from __future__ import annotations

import dataclasses
import json
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
        elif "Memcpy" in name or "memcpy" in name:
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

    def grouped(x, gl, ul, dl, gr, ur, dr):
        e_l = gl.shape[0]

        def part(xe, g, u, d):
            return torch.bmm(F.silu(torch.bmm(xe, g)) * torch.bmm(xe, u), d)
        return torch.cat([part(x[:e_l], gl, ul, dl), part(x[e_l:], gr, ur, dr)], dim=0)

    return {"split_stack_gemm": stack, "split_reduce_gemm": reduce,
            "split_dense_swiglu": dense, "split_grouped_swiglu": grouped}


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
    else:
        c, d, f, e, e_l = shp["c"], shp["d"], shp["f"], shp["e"], shp["e_l"]
        args = (rnd(e, c, d, scale=1.0), rnd(e_l, d, f), rnd(e_l, d, f), rnd(e_l, f, d),
                rnd(e - e_l, d, f), rnd(e - e_l, d, f), rnd(e - e_l, f, d))
        kern, plain = grouped.split_grouped_swiglu, grouped.split_grouped_swiglu_torch
        nbytes = 2 * (2 * e * c * d + 3 * e * d * f)
        flops = 6 * e * c * d * f
    got = kern(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    abs_err = (got.float() - ref.float()).abs().max().item()
    rel_err = abs_err / max(ref.float().abs().max().item(), 1e-30)
    wbytes = sum(a.numel() * a.element_size() for a in args[1:])
    reps = 3 if wbytes > 4e9 else 20
    row = {
        "max_abs_err": abs_err,
        "max_rel_err": rel_err,
        "tol_rel": KERNEL_TOL,
        "ms": time_ms(lambda: kern(*args), reps),
        "plain_ms": time_ms(lambda: plain(*args), reps),
        "library_ms": time_ms(lambda: lib(*args), reps),
    }
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    del args, got, ref
    torch.cuda.empty_cache()
    if rel_err > KERNEL_TOL:
        fail(f"{name} {shp}: kernel disagrees with its plain version: rel err {rel_err:.3e} > {KERNEL_TOL}")
    return row


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
        results.setdefault(name, {})[phase] = dict(row, shape=shp)
        print(f"kernel {name} {phase} {shp}: rel_err {row['max_rel_err']:.3e} "
              f"(tol {KERNEL_TOL}) ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
              f"library_ms {row['library_ms']:.4f} bound_ms {row['bound_ms']:.4f} "
              f"({row['bound_by']})")

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
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        fail(f"kernels never launched on the served path: {missing}")
    if peak > 80e9:
        fail(f"peak memory {peak / 1e9:.2f} GB exceeds the card")

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

    # ---- report ---------------------------------------------------------
    replaces = {
        "split_grouped_swiglu": "src/repro/kernels/split_gemm/split_gemm.py:261",
        "split_stack_gemm": "src/repro/kernels/split_gemm/dense.py:92",
        "split_reduce_gemm": "src/repro/kernels/split_gemm/dense.py:183",
        "split_dense_swiglu": "src/repro/kernels/split_gemm/dense.py:308",
    }
    kernels = []
    for name in ops.KERNELS:
        dec, pre = results[name]["decode"], results[name]["prefill"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": counts[name],
            "max_abs_err": dec["max_abs_err"],
            "max_rel_err": dec["max_rel_err"],
            "ms": dec["ms"],
            "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"],
            "library_ms": dec["library_ms"],
            "shape": dec["shape"],
            "prefill": pre,
        })
    print(f"total_s {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
