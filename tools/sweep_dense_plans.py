#!/usr/bin/env python3
"""Time kernels #5 (``split_reduce_gemm``) and #6 (``split_dense_swiglu``)
on the card under candidate launch plans, at the main path's per-rank
shapes (G' = 4, bf16): DeepSeek-R1 prefill at 1024- and 8192-token
prompts (256 and 2048 rows), decode (2 rows), Gemma-3-27B prefill at a
4096-token prompt (1024 rows).

    python3 tools/sweep_dense_plans.py [--out build/sweep_dense_plans.json]

Candidates, beside the default plan (``dense.plan_split``): the Hopper
path's ring depth (2 stages to as many as fit) and, where a reduce has
fewer than two waves of tiles, split-k 1-4; the few-row path's block
target (k chunk).
Each plan's output is held against the default plan's (2e-2 relative to
max|ref|). #6's down product is timed as ``split_reduce_gemm`` on its
shapes, its gate/up launch as #6 minus that. Times: CUDA events, median of
5 windows of >= 40 ms (``chip_smoke.time_ms``), beside the card's name and
power limit and one per-bank torch.matmul/bmm composition (the yardstick
of ``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

G = 4
R1 = dict(d=7168, qd=4096, fs=4608)
GEMMA = dict(d=5376, qd=1024, fs=5376)
FEW_ROW_TARGETS = (512, 1024, 2048, 4096)


def main() -> None:
    import torch

    import chip_smoke
    from repro_torch.kernels.split_gemm import dense

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sweep_dense_plans.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sweep_dense_plans: needs a CUDA device")
    card = chip_smoke.card_line()
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib = chip_smoke.library_versions()

    def rnd(*s):
        return (torch.randn(*s, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)

    def rel(got, ref):
        return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

    def ms(fn):
        return chip_smoke.time_ms(fn)[0]

    def candidates(op, t, k, n, s):
        base = dense.plan_split(op, torch.bfloat16, t, k, n, s)
        if base.path == "few_row":
            yield "default", base
            for blocks in FEW_ROW_TARGETS:
                yield f"blocks~{blocks}", dense.few_row_plan(op, t, k, n, s, blocks)
            return
        yield "default", base
        tiles = dense._cdiv(t, dense.HOPPER_BM) * dense._cdiv(n, dense.HOPPER_BN[op])
        few = op == "reduce" and tiles < 2 * dense.SMS
        for stages in range(2, dense.max_stages(op) + 1):
            for splits in ((1, 2, 3, 4) if few else (1,)):
                plan = base._replace(stages=stages, splits=splits,
                                     scratch=splits * t * n if splits > 1 else 0)
                yield f"stages {stages} splits {splits}", plan

    rows = []
    shapes = [("r1_1024", 256, R1), ("r1_8192", 2048, R1), ("decode", 2, R1),
              ("gemma3", 1024, GEMMA)]
    for label, t, w in shapes:
        d = w["d"]
        # #5 at the attention-output shape and at #6's down shape
        for kern, f in (("split_reduce_gemm", w["qd"]), ("down", w["fs"])):
            x, wl, wr = rnd(G, t, f), rnd(1, f, d), rnd(G - 1, f, d)
            ref = dense.split_reduce_gemm(x, wl, wr)
            lib_ms = ms(lambda: lib["split_reduce_gemm"](x, wl, wr))
            for name, plan in candidates("reduce", t, f, d, G):
                err = rel(dense.split_reduce_gemm(x, wl, wr, plan=plan), ref)
                row = dict(case=label, kernel=kern, t=t, k=f, n=d, plan=name, err=err,
                           ms=ms(lambda: dense.split_reduce_gemm(x, wl, wr, plan=plan)),
                           library_ms=lib_ms)
                rows.append(row)
                print(json.dumps(row), flush=True)
            del x, wl, wr, ref
        f = w["fs"]
        x = rnd(t, d)
        ws = [rnd(1, d, f), rnd(1, d, f), rnd(1, f, d), rnd(G - 1, d, f), rnd(G - 1, d, f),
              rnd(G - 1, f, d)]
        ref = dense.split_dense_swiglu(x, *ws)
        down = dense.dense_swiglu_plans(x, *ws)[1]
        lib_ms = ms(lambda: lib["split_dense_swiglu"](x, *ws))
        for name, plan in candidates("gate_up", t, d, f, G):
            err = rel(dense.split_dense_swiglu(x, *ws, plans=(plan, down)), ref)
            row = dict(case=label, kernel="split_dense_swiglu", t=t, k=d, n=f,
                       plan=f"gate_up {name}", err=err,
                       ms=ms(lambda: dense.split_dense_swiglu(x, *ws, plans=(plan, down))),
                       library_ms=lib_ms)
            rows.append(row)
            print(json.dumps(row), flush=True)
        del x, ws, ref
        torch.cuda.empty_cache()
    bad = [r for r in rows if r["err"] > chip_smoke.KERNEL_TOL]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "rows": rows}, fh, indent=1)
    print(card)
    if bad:
        sys.exit(f"sweep_dense_plans: {len(bad)} plans disagree with the default plan: {bad}")


if __name__ == "__main__":
    main()
