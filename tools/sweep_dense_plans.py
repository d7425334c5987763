#!/usr/bin/env python3
"""Time the split kernels and flash attention on the card under candidate
launch plans, at the main path's per-rank shapes (G' = 4, bf16):
DeepSeek-R1 prefill at 1024- and 8192-token prompts (256 and 2048 rows;
expert capacity 16 and 88), decode (2 rows; expert capacity 1),
Gemma-3-27B prefill at a 4096-token prompt (1024 rows).

    python3 tools/sweep_dense_plans.py [--kernels stack,grouped,reduce,dense,flash,gemm]
                                       [--out build/sweep_dense_plans.json]
    python3 tools/sweep_dense_plans.py --defaults [--src OTHER/src] [--out ...]

Kernels: "stack" #4 (``split_stack_gemm``) at R1's q and k/v widths and
Gemma-3's; "grouped" #2 (``split_grouped_swiglu``) at C 16 and 88 and at
decode, C 1 and 2; "reduce" #5 (``split_reduce_gemm``); "dense" #6
(``split_dense_swiglu``); "flash" #7 (``flash_attention``) at the five
prefill shards of ``chip_smoke.py`` (R1 1024 first and last rank, R1 8192
last rank, Gemma-3 4096 local and global layer) and its ragged case;
"gemm" #1 (``split_grouped_gemm``) at R1's expert shapes, C 1, 16 and 88,
with bf16 and e4m3 banks. Default: stack, grouped and flash.
Candidates, beside the default plan (``dense.plan_split``,
``grouped.plan_grouped``, ``flash_attention.ops.flash_plan``): every
Hopper block tile of the op (BM 64 or 128, BN 128 or 256), the ring depth
(2 stages to as many as fit) and, where the tiles number fewer than two
waves, split-k 1-16 (stack) or 1-4 (reduce); the few-row path's block
target (k chunk). #2's gate/up and down launches are varied one at a
time, the other on its default plan; at C 1 and 2 its decode path (the
Hopper path at BM 64) at several ring depths, both launches alike, beside
the split_tile.cuh few-row path that #2 ran there before. #7: the ring
depth of its Hopper kernel (its earlier mma.sync kernel: ``--defaults``
with ``--src`` at an earlier checkout). #1: every block tile of its
launcher (BM 64 or 128, BN 256) at every ring depth that fits, with bf16 banks beside split_tile.cuh's path (its
path before the Hopper one) and with e4m3 banks beside the bf16 kernel on
the widened banks (no PyTorch call multiplies bf16 by fp8 without
quantizing the activations, so that is the fp8 yardstick).
Each plan's output is held against the default plan's (2e-2 relative to
max|ref|). #6's down product is timed as ``split_reduce_gemm`` on its
shapes, its gate/up launch as #6 minus that. Times: CUDA events, median of
5 windows of >= 40 ms (``chip_smoke.time_ms``), beside the card's name and
power limit and one per-bank torch.matmul/bmm composition (#7:
``scaled_dot_product_attention``; the yardsticks of ``chip_smoke.py``).
#4, #2 and #7 also get ``device_ms``: the same calls captured into a CUDA
graph and replayed, the device time without the host time between
launches (small launches are bound by the host).

``--defaults`` times only the default plans of #1 (bf16 banks; e4m3 where
the tree takes them), #2, #4, #5, #6 and #7 at those cases, through the
wrappers' public signatures, so that ``--src`` may point at another
checkout's ``src`` (an earlier commit, unpacked with ``git archive``): run
it for both trees in one call, in turns, to compare them on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

G = 4
R1 = dict(d=7168, qd=4096, kvd=256, fs=4608, fe=2048, e=256)
GEMMA = dict(d=5376, qd=1024, kvd=512, fs=5376)
FEW_ROW_TARGETS = (128, 256, 512, 1024, 2048, 4096)
# (label, rows, widths, Fs) of kernel #4; (label, C) of kernel #2
STACK_CASES = [("r1_1024", 256, R1, "qd"), ("r1_1024_kv", 256, R1, "kvd"),
               ("r1_8192", 2048, R1, "qd"), ("r1_8192_kv", 2048, R1, "kvd"),
               ("decode", 2, R1, "qd"), ("decode_kv", 2, R1, "kvd"),
               ("gemma3", 1024, GEMMA, "qd"), ("gemma3_kv", 1024, GEMMA, "kvd")]
GROUPED_CASES = [("r1_1024", 16), ("r1_8192", 88), ("decode", 1), ("decode_c2", 2)]
# (label, C) of kernel #1 at R1's expert shapes
GEMM_CASES = [("decode", 1), ("r1_1024", 16), ("r1_8192", 88)]
# (label, Sq, Sk, H, Kh, window, q_offset) of kernel #7 (batch 1, hd 128)
FLASH_CASES = [("r1_1024_first", 256, 1024, 128, 8, 0, 0),
               ("r1_1024_last", 256, 1024, 128, 8, 0, 768),
               ("r1_8192_last", 2048, 8192, 128, 8, 0, 6144),
               ("gemma3_local", 1024, 4096, 32, 16, 1024, 3072),
               ("gemma3_global", 1024, 4096, 32, 16, 0, 3072),
               ("gemma3_ragged", 1000, 3001, 32, 16, 700, 2001)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sweep_dense_plans.json"))
    ap.add_argument("--kernels", default="stack,grouped,flash")
    ap.add_argument("--cases", default="",
                    help="comma-separated case labels to run (default: all)")
    ap.add_argument("--defaults", action="store_true",
                    help="time the default plans of #4, #2 and #7 only")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        sys.exit("sweep_dense_plans: needs a CUDA device")
    card = chip_smoke.card_line()
    print(f"card: {card}")
    print(f"src: {os.path.abspath(args.src)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib = chip_smoke.library_versions()

    def rnd(*s, scale=0.05):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def rel(got, ref):
        return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

    def ms(fn):
        return chip_smoke.time_ms(fn)[0]

    def device_ms(fn, reps=10):
        """ms per call of ``fn``'s device work alone: ``reps`` calls
        captured into one CUDA graph, its replays timed as ``ms`` times a
        call (no host time between the launches)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(reps):
                fn()
        t = ms(graph.replay) / reps
        del graph
        return t

    def both(fn):  # (ms, device_ms) of one call
        return dict(ms=ms(fn), device_ms=device_ms(fn))

    rows = []

    def record(**row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    kernels = (("stack", "grouped", "flash", "gemm", "reduce", "dense") if args.defaults
               else args.kernels.split(","))
    if args.cases:
        keep = set(args.cases.split(","))
        STACK_CASES[:] = [c for c in STACK_CASES if c[0] in keep]
        GROUPED_CASES[:] = [c for c in GROUPED_CASES if c[0] in keep]
        FLASH_CASES[:] = [c for c in FLASH_CASES if c[0] in keep]
        GEMM_CASES[:] = [c for c in GEMM_CASES if c[0] in keep]
    if "stack" in kernels:
        sweep_stack(args.defaults, rnd, rel, both, lib, record)
    if "grouped" in kernels:
        sweep_grouped(args.defaults, rnd, rel, both, lib, record)
    if "flash" in kernels:
        sweep_flash(args.defaults, gen, rel, both, record)
    if "gemm" in kernels:
        sweep_gemm(args.defaults, rnd, rel, both, lib, record)
    if "reduce" in kernels or "dense" in kernels:
        sweep_reduce_dense(kernels, args.defaults, rnd, rel, ms, lib, record)
    bad = [r for r in rows if r["err"] > chip_smoke.KERNEL_TOL]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "src": os.path.abspath(args.src), "rows": rows}, fh, indent=1)
    print(card)
    if bad:
        sys.exit(f"sweep_dense_plans: {len(bad)} plans disagree with the default plan: {bad}")


def sweep_stack(defaults, rnd, rel, both, lib, record) -> None:
    """Kernel #4: the default plan and, unless ``defaults``, every Hopper
    tile x stages {2, 4, most} x splits (1-16 below two waves), or
    the few-row block targets."""
    from repro_torch.kernels.split_gemm import dense

    for label, t, w, fkey in STACK_CASES:
        d, f = w["d"], w[fkey]
        x, wl, wr = rnd(t, d), rnd(1, d, f), rnd(G - 1, d, f)
        ref = dense.split_stack_gemm(x, wl, wr)
        lib_t = both(lambda: lib["split_stack_gemm"](x, wl, wr))
        base = dict(case=label, kernel="split_stack_gemm", t=t, k=d, n=f,
                    library_ms=lib_t["ms"], library_device_ms=lib_t["device_ms"])
        record(**base, plan="default", err=0.0,
               **both(lambda: dense.split_stack_gemm(x, wl, wr)))
        if defaults:
            continue
        plan = dense.stack_plan(x, wl, wr)
        record(**base, plan=f"default = {plan.path} {list(plan.tile)} stages {plan.stages} "
               f"splits {plan.splits} chunk {plan.chunk}", err=0.0, ms=None)
        for name, cand in stack_candidates(dense, t, d, f):
            got = dense.split_stack_gemm(x, wl, wr, plan=cand)
            record(**base, plan=name, err=rel(got, ref),
                   **both(lambda: dense.split_stack_gemm(x, wl, wr, plan=cand)))
        del x, wl, wr, ref


def stack_candidates(dense, t, d, f):
    if t <= dense.FEW_ROW_MAXM:
        for blocks in FEW_ROW_TARGETS:
            yield f"few_row blocks~{blocks}", dense.few_row_plan("stack", t, d, f, G, blocks)
        return
    for bm, bn in dense.HOPPER_TILES["stack"]:
        tiles = dense._cdiv(t, bm) * dense._cdiv(f, bn) * G
        most = dense.max_stages("stack", bm, bn)
        for stages in sorted({2, 4, most}):
            for splits in ((1, 2, 4, 8, 16) if tiles < 2 * dense.SMS else (1,)):
                plan = dense.hopper_plan("stack", t, d, f, G, bm, bn, splits)
                yield (f"hopper {bm}x{bn} stages {stages} splits {splits}",
                       plan._replace(stages=stages))


def sweep_grouped(defaults, rnd, rel, both, lib, record) -> None:
    """Kernel #2: the default plans and, unless ``defaults``, every tile and
    ring depth of the gate/up launch (down on its default plan), then of
    the down launch (gate/up on its default plan)."""
    from repro_torch.kernels.split_gemm import dense, grouped

    d, f, e = R1["d"], R1["fe"], R1["e"]
    e_l = e // G
    ws = [rnd(e_l, d, f), rnd(e_l, d, f), rnd(e_l, f, d), rnd(e - e_l, d, f),
          rnd(e - e_l, d, f), rnd(e - e_l, f, d)]
    for label, c in GROUPED_CASES:
        x = rnd(e, c, d, scale=1.0)
        ref = grouped.split_grouped_swiglu(x, *ws)
        lib_t = both(lambda: lib["split_grouped_swiglu"](x, *ws))
        base = dict(case=label, kernel="split_grouped_swiglu", t=c, k=d, n=f,
                    library_ms=lib_t["ms"], library_device_ms=lib_t["device_ms"])
        record(**base, plan="default", err=0.0,
               **both(lambda: grouped.split_grouped_swiglu(x, *ws)))
        if defaults:
            continue
        gu, dn = grouped.grouped_swiglu_plans(x, *ws)
        record(**base, plan=f"default = gate_up {gu.path} {list(gu.tile)} stages {gu.stages} "
               f"chunk {gu.chunk}, down {dn.path} {list(dn.tile)} stages {dn.stages} "
               f"chunk {dn.chunk}", err=0.0, ms=None)
        cands = list(grouped_decode_candidates(dense, c, d, f)) if c <= 2 else []
        for bm, bn in (dense.HOPPER_TILES["gate_up"] if c > 2 else ()):
            if bm >= c or bm == 128:
                for stages in range(2, dense.max_stages("gate_up", bm, bn) + 1):
                    p = dense.hopper_plan("gate_up", c, d, f, 1, bm, bn)._replace(stages=stages)
                    cands.append((f"gate_up {bm}x{bn} stages {stages}", (p, dn)))
        for bm, bn in (dense.HOPPER_TILES["stack"] if c > 2 else ()):
            if bm >= c or bm == 128:
                most = dense.max_stages("stack", bm, bn)
                for stages in sorted({2, 3, 4, most}):
                    p = dense.hopper_plan("stack", c, f, d, 1, bm, bn)._replace(stages=stages)
                    cands.append((f"down {bm}x{bn} stages {stages}", (gu, p)))
        for name, pl in cands:
            got = grouped.split_grouped_swiglu(x, *ws, plans=pl)
            record(**base, plan=name, err=rel(got, ref),
                   **both(lambda: grouped.split_grouped_swiglu(x, *ws, plans=pl)))
        del x, ref
    del ws
    import torch
    torch.cuda.empty_cache()


def grouped_decode_candidates(dense, c, d, f):
    """#2's decode plans at C <= 2: the Hopper path at BM 64 at several
    ring depths, and split_tile.cuh's few-row path (the grouped kernels'
    earlier decode path)."""
    yield ("split_tile few-row (earlier decode path)",
           (dense.Plan("tile_few_row", (), 0, 1, 0, 0),) * 2)
    gu_most = dense.max_stages("gate_up", 64, 128)
    dn_most = dense.max_stages("stack", 64, 256)
    for st_gu, st_dn in sorted({(2, 2), (4, 4), (gu_most, dn_most)}):
        yield (f"hopper BM 64 gate_up stages {st_gu} down stages {st_dn}",
               (dense.hopper_plan("gate_up", c, d, f, 1, 64, 128)._replace(stages=st_gu),
                dense.hopper_plan("stack", c, f, d, 1, 64, 256)._replace(stages=st_dn)))


def sweep_gemm(defaults, rnd, rel, both, lib, record) -> None:
    """Kernel #1: the default plan with bf16 and e4m3 banks and, unless
    ``defaults``, BM 64 and 128 at every ring depth; bf16 also on
    split_tile.cuh's path; e4m3 beside the bf16 kernel on the widened
    banks. Every plan is held against the bf16 default on the same banks."""
    import torch
    from repro_torch.kernels.split_gemm import dense, grouped

    d, f, e = R1["d"], R1["fe"], R1["e"]
    e_l = e // G
    wl, wr = rnd(e_l, d, f), rnd(e - e_l, d, f)
    banks = {"bfloat16": (wl, wr)}
    q = (wl.to(torch.float8_e4m3fn), wr.to(torch.float8_e4m3fn))
    banks["float8_e4m3fn"] = q
    wide = (q[0].to(torch.bfloat16), q[1].to(torch.bfloat16))
    for label, c in GEMM_CASES:
        x = rnd(e, c, d, scale=1.0)
        for wname, (bl, br) in banks.items():
            ref_banks = (wl, wr) if wname == "bfloat16" else wide
            ref = grouped.split_grouped_gemm(x, *ref_banks)
            lib_t = both(lambda: lib["split_grouped_gemm"](x, *ref_banks))
            base = dict(case=label, kernel="split_grouped_gemm", weight=wname, t=c, k=d, n=f,
                        library_ms=lib_t["ms"] if wname == "bfloat16" else None,
                        library_device_ms=lib_t["device_ms"] if wname == "bfloat16" else None)
            if wname != "bfloat16":
                record(**base, plan="bf16 kernel on the widened banks", err=0.0,
                       **both(lambda: grouped.split_grouped_gemm(x, *wide)))
            try:
                got = grouped.split_grouped_gemm(x, bl, br)
            except TypeError as exc:  # a tree whose kernel takes no fp8 banks
                record(**base, plan="default", err=0.0, ms=None, unsupported=str(exc))
                continue
            record(**base, plan="default", err=rel(got, ref),
                   **both(lambda: grouped.split_grouped_gemm(x, bl, br)))
            if defaults:
                continue
            plan = grouped.gemm_plan(x, bl, br)
            record(**base, plan=f"default = {plan.path} {list(plan.tile)} stages {plan.stages}",
                   err=0.0, ms=None)
            cands = []
            if wname == "bfloat16":
                path = "tile_few_row" if c <= dense.FEW_ROW_MAXM else "mma"
                cands.append((f"split_tile {path} (the path before)",
                              dense.Plan(path, (), 0, 1, 0, 0)))
            wbytes = 2 if wname == "bfloat16" else 1
            for bm, bn in dense.HOPPER_TILES["gemm"]:
                for stages in range(2, dense.max_stages("gemm", bm, bn, wbytes) + 1):
                    p = dense.hopper_plan("gemm", c, d, f, 1, bm, bn, wbytes=wbytes)
                    cands.append((f"hopper {bm}x{bn} stages {stages}", p._replace(stages=stages)))
            for name, p in cands:
                got = grouped.split_grouped_gemm(x, bl, br, plan=p)
                record(**base, plan=name, err=rel(got, ref),
                       **both(lambda: grouped.split_grouped_gemm(x, bl, br, plan=p)))
        del x
    del wl, wr, banks, q, wide
    torch.cuda.empty_cache()


def sweep_flash(defaults, gen, rel, both, record) -> None:
    """Kernel #7: the default plan and, unless ``defaults``, every ring
    depth of its Hopper kernel, beside ``scaled_dot_product_attention``; each held
    against the default plan (over the whole output: the per-row check is
    ``chip_smoke.py``'s)."""
    import torch

    import chip_smoke
    from repro_torch.kernels.flash_attention import ops as fa

    for label, sq, sk, h, kh, window, q_offset in FLASH_CASES:
        q, k, v = (torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
                   for s in ((1, sq, h, 128), (1, sk, kh, 128), (1, sk, kh, 128)))
        kw = dict(window=window, q_offset=q_offset)
        ref = fa.flash_attention(q, k, v, **kw)
        lib_t = both(chip_smoke.sdpa_version(q, k, v, window, q_offset))
        base = dict(case=label, kernel="flash_attention", sq=sq, sk=sk, h=h, kh=kh, **kw,
                    library_ms=lib_t["ms"], library_device_ms=lib_t["device_ms"])
        record(**base, plan="default", err=0.0, **both(lambda: fa.flash_attention(q, k, v, **kw)))
        if defaults:
            continue
        plan = fa.flash_plan(torch.bfloat16, 128)
        record(**base, plan=f"default = {fa.plan_label(plan)}", err=0.0, ms=None)
        cands = [(fa.plan_label(pl), pl)
                 for pl in map(fa.wgmma_plan, (st for st in range(1, 7) if fa.wgmma_smem(st) <= fa.SMEM))]
        for name, pl in cands:
            got = fa.flash_attention(q, k, v, **kw, plan=pl)
            record(**base, plan=name, err=rel(got, ref),
                   **both(lambda: fa.flash_attention(q, k, v, **kw, plan=pl)))
        del q, k, v, ref
        torch.cuda.empty_cache()


def sweep_reduce_dense(kernels, defaults, rnd, rel, ms, lib, record) -> None:
    """Kernels #5 and #6: the default plan and, unless ``defaults``, ring
    depth and split-k 1-4 of the Hopper path, the few-row block target."""
    import torch
    from repro_torch.kernels.split_gemm import dense

    def candidates(op, t, k, n, s):
        base = dense.plan_split(op, torch.bfloat16, t, k, n, s)
        if defaults:
            yield "default", None
            return
        if base.path == "few_row":
            yield "default", base
            for blocks in FEW_ROW_TARGETS:
                yield f"blocks~{blocks}", dense.few_row_plan(op, t, k, n, s, blocks)
            return
        yield "default", base
        bm, bn = base.tile[:2]
        tiles = dense._cdiv(t, bm) * dense._cdiv(n, bn)
        few = op == "reduce" and tiles < 2 * dense.SMS
        for stages in range(2, dense.max_stages(op, bm, bn) + 1):
            for splits in ((1, 2, 3, 4) if few else (1,)):
                plan = dense.hopper_plan(op, t, k, n, s, bm, bn, splits)
                yield f"stages {stages} splits {splits}", plan._replace(stages=stages)

    shapes = [("r1_1024", 256, R1), ("r1_8192", 2048, R1), ("decode", 2, R1),
              ("gemma3", 1024, GEMMA)]
    for label, t, w in shapes:
        d = w["d"]
        if "reduce" in kernels:
            # #5 at the attention-output shape and at #6's down shape
            for kern, f in (("split_reduce_gemm", w["qd"]), ("down", w["fs"])):
                x, wl, wr = rnd(G, t, f), rnd(1, f, d), rnd(G - 1, f, d)
                ref = dense.split_reduce_gemm(x, wl, wr)
                lib_ms = ms(lambda: lib["split_reduce_gemm"](x, wl, wr))
                for name, plan in candidates("reduce", t, f, d, G):
                    err = rel(dense.split_reduce_gemm(x, wl, wr, plan=plan), ref)
                    record(case=label, kernel=kern, t=t, k=f, n=d, plan=name, err=err,
                           ms=ms(lambda: dense.split_reduce_gemm(x, wl, wr, plan=plan)),
                           library_ms=lib_ms)
                del x, wl, wr, ref
        if "dense" in kernels:
            f = w["fs"]
            x = rnd(t, d)
            ws = [rnd(1, d, f), rnd(1, d, f), rnd(1, f, d), rnd(G - 1, d, f), rnd(G - 1, d, f),
                  rnd(G - 1, f, d)]
            ref = dense.split_dense_swiglu(x, *ws)
            down = dense.dense_swiglu_plans(x, *ws)[1]
            lib_ms = ms(lambda: lib["split_dense_swiglu"](x, *ws))
            for name, plan in candidates("gate_up", t, d, f, G):
                plans = None if plan is None else (plan, down)
                err = rel(dense.split_dense_swiglu(x, *ws, plans=plans), ref)
                record(case=label, kernel="split_dense_swiglu", t=t, k=d, n=f,
                       plan=f"gate_up {name}", err=err,
                       ms=ms(lambda: dense.split_dense_swiglu(x, *ws, plans=plans)),
                       library_ms=lib_ms)
            del x, ws, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
