"""Grouped expert kernels over split banks: the MoE layer of the DWDP path.

Each wrapper launches its hand-written CUDA kernel for CUDA tensors and
runs its plain version for CPU tensors:

- ``split_grouped_swiglu`` (``csrc/split_grouped_swiglu.cu``, replacing
  the Pallas kernel
  ``repro/kernels/split_gemm/split_gemm.py::split_grouped_swiglu``): the
  fused per-expert SwiGLU over the (local, remote) expert banks.
- ``split_grouped_swiglu_demand`` (``csrc/split_grouped_swiglu_demand.cu``,
  replacing ``split_gemm.py::split_grouped_swiglu_demand``): the same over
  a (local, demand-fetched) bank pair whose fetched rows are padded to a
  budget; ``valid`` marks the real rows, and a padding row's output is
  exactly zero.
- ``split_grouped_gemm`` (``csrc/split_grouped_gemm.cu``, replacing
  ``split_gemm.py::split_grouped_gemm``): ``y[e] = x[e] @ W(e)``; its
  banks may be stored in fp8 (e4m3, e5m2) beside bf16 activations, widened
  exactly to bf16 on the chip as the Pallas kernel's ``_cast`` does.

Experts ``[0, E_l)`` read the local bank, the rest the second bank; no
merged bank is built.

``split_grouped_swiglu`` and ``split_grouped_swiglu_demand`` run the two
launches (gate/up, down) that ``plan_grouped`` picks from the per-expert
shapes: in bf16 ``hopper`` (``csrc/split_hopper.cuh``: TMA, an mbarrier
ring and wgmma, the activation read per expert) at every capacity, decode
(C 1) included; ``split_tile.cuh``'s launchers for fp32 and other widths
(``tile_few_row``, its few-row register kernels, at 2 rows or fewer;
``mma``/``fma`` as in ``dense.plan_split`` above). The demand kernel runs
the plan of kernel #2 for the same shapes, so its real experts get #2's
bits. ``split_grouped_gemm`` runs the one launch of op "gemm" (#2's down
launch on its own shapes). The banks of all three may be stored in fp8
(e4m3, e5m2) beside bf16 activations: the "hopper" path widens each fp8
tile exactly to bf16 on the chip (the Pallas kernels' ``_cast``); off it
the wrappers raise ``TypeError``. ``PATHS`` counts the launches of each
path.
"""
from __future__ import annotations

import collections
import functools

import torch

from repro_torch import counters
from repro_torch.kernels._launch import (
    FP8_DTYPES,
    WEIGHT_CODES,
    CudaKernel,
    bank_dims,
    cast_like,
    check_cuda_operands,
    on_cpu,
    weight_code,
)
from repro_torch.kernels.split_gemm.dense import (
    FEW_ROW_MAXM,
    Plan,
    _aligned,
    hopper_plan,
    path_key,
    row_class,
)
from repro_torch.models.moe import grouped_ffn

GROUPED_SWIGLU = CudaKernel("split_grouped_swiglu", n_ptrs=9, n_ints=19)
GROUPED_SWIGLU_DEMAND = CudaKernel("split_grouped_swiglu_demand", n_ptrs=10, n_ints=19)
GROUPED_GEMM = CudaKernel("split_grouped_gemm", n_ptrs=4, n_ints=13)
#: ring stages of #1 with bf16 banks: 3 beat or tied the most that fit
#: (4-5) at C 1, 16 and 88 in two sweeps (tools/sweep_dense_plans.py,
#: PERF.md); with fp8 banks the most that fit won
GEMM_BF16_STAGES = 3

#: Launches per (kernel, launch, path, row class) of the grouped SwiGLU
#: kernels, counted by the wrappers (``dense.path_key``: fp8 banks add
#: their dtype's name); kernel #1's keys always add the banks' dtype:
#: (kernel, "gemm", path, row class, dtype name).
PATHS: collections.Counter = collections.Counter()
counters.register("grouped paths", PATHS)


# --------------------------------------------------------------------------
# Plans.
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)  # a pure function, on every launch's host path
def plan_grouped(op: str, dtype: torch.dtype, rows: int, k: int, n: int,
                 aligned: bool = True, weight: torch.dtype | None = None) -> Plan:
    """The plan of one launch of the grouped SwiGLU: ``op`` "gate_up"
    (rows C, k D, n F) or "down" (rows C, k F, n D); or of kernel #1, op
    "gemm" (rows C, k D, n F). ``weight``: the banks' dtype, by default
    ``dtype``. A pure function of the per-expert shapes, never of the
    expert count, so the demand kernel (#3) runs kernel #2's plan and gets
    #2's bits.

    - fp32, or bf16 with a width that is not a multiple of 8 or an
      unaligned pointer: split_tile.cuh's launchers, "tile_few_row" (its
      few-row register kernels) at <= 2 rows, else "fma" (fp32) or "mma"
      (its mma.sync tiles).
    - otherwise "hopper", op GATE_UP (128 columns of gate and up) for
      gate/up and op STACK (256 columns) for down, the activation read per
      expert; BM 64 (one consumer warpgroup) at C <= 64, else 128, so up
      to 128 slots of an expert sit in one m tile and every weight byte is
      streamed once; no split (the experts fill the card). At decode (C 1,
      TMA zero-filling the other 63 rows of the tile) this beat
      split_hopper.cuh's few-row kernels extended per expert and the
      library call (tools/sweep_dense_plans.py, PERF.md).
    - "gemm" is "down" on #1's shapes, in GEMM_BF16_STAGES stages.
    - fp8 banks: the same Hopper tiles where n is also a multiple of 16
      (the banks' 16-byte row stride), in the most stages that fit beside
      the widened tiles (the bf16 plan's for gate_up and down). fp8 banks
      off the Hopper path have no kernel: the wrapper raises.
    """
    if op not in ("gate_up", "down", "gemm"):
        raise ValueError(f"unknown grouped op {op!r}")
    fp8 = weight in FP8_DTYPES
    wbytes = 1 if fp8 else 2
    hopper = (dtype == torch.bfloat16 and aligned and not (k % 8 or n % 8)
              and not (fp8 and n % 16))
    if not hopper:
        if rows <= FEW_ROW_MAXM:
            return Plan("tile_few_row", (), 0, 1, 0, 0)
        return Plan("mma" if dtype == torch.bfloat16 else "fma", (), 0, 1, 0, 0)
    bm = 64 if rows <= 64 else 128
    if op == "gate_up":
        return hopper_plan("gate_up", rows, k, n, 1, bm, 128, wbytes=wbytes)
    if op == "down":
        return hopper_plan("stack", rows, k, n, 1, bm, 256, wbytes=wbytes)
    if fp8:
        return hopper_plan("gemm", rows, k, n, 1, bm, 256, wbytes=1)
    return hopper_plan("gemm", rows, k, n, 1, bm, 256)._replace(stages=GEMM_BF16_STAGES)


def grouped_swiglu_plans(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r) -> tuple[Plan, Plan]:
    """(gate/up plan, down plan) of the grouped SwiGLU for these operands
    (#2's, and #3's with its fetched banks in place of the remote ones)."""
    _, c, d = x.shape
    f = (wg_l if wg_l.shape[0] else wg_r).shape[2]
    ok = _aligned(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r)
    return (plan_grouped("gate_up", x.dtype, c, d, f, ok, wg_l.dtype),
            plan_grouped("down", x.dtype, c, f, d, ok, wg_l.dtype))


def gemm_plan(x, w_local, w_remote) -> Plan:
    """The plan ``split_grouped_gemm`` runs for these operands."""
    _, c, d = x.shape
    w = w_local if w_local.shape[0] else w_remote
    return plan_grouped("gemm", x.dtype, c, d, w.shape[2], _aligned(x, w_local, w_remote),
                        w.dtype)


# --------------------------------------------------------------------------
# Plain versions (the JAX package's ``ops.*_jnp`` formulations).
# --------------------------------------------------------------------------
def split_grouped_swiglu_torch(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r):
    """Plain version: per-bank grouped FFN over the matching expert slice
    of ``x``, outputs concatenated (``ops.split_swiglu_jnp`` of the JAX
    package)."""
    e_l = wg_l.shape[0]
    y_l = grouped_ffn(x[:e_l], wg_l, wu_l, wd_l)
    y_r = grouped_ffn(x[e_l:], wg_r, wu_r, wd_r)
    return torch.cat([y_l, y_r], dim=0)


def split_grouped_swiglu_demand_torch(x, wg_l, wu_l, wd_l, wg_f, wu_f, wd_f, valid):
    """Plain version: per-bank grouped FFN, the fetched outputs zeroed
    where ``valid`` is False (``ops.split_swiglu_demand_jnp``)."""
    e_l = wg_l.shape[0]
    y_l = grouped_ffn(x[:e_l], wg_l, wu_l, wd_l)
    y_f = grouped_ffn(x[e_l:], wg_f, wu_f, wd_f)
    y_f = torch.where(valid[:, None, None], y_f, torch.zeros((), dtype=y_f.dtype))
    return torch.cat([y_l, y_f], dim=0)


def split_grouped_gemm_torch(x, w_local, w_remote):
    """Plain version: one einsum per bank, outputs concatenated."""
    e_l = w_local.shape[0]
    y_l = torch.einsum("ecd,edf->ecf", x[:e_l], cast_like(w_local, x))
    y_r = torch.einsum("ecd,edf->ecf", x[e_l:], cast_like(w_remote, x))
    return torch.cat([y_l, y_r], dim=0)


# --------------------------------------------------------------------------
# Kernel wrappers.
# --------------------------------------------------------------------------
def _swiglu_dims(name, x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (E, C, D), got {tuple(x.shape)}")
    e, c, d = x.shape
    e_l, e_r, (d_g, f) = bank_dims(name, wg_l, wg_r)
    for lo, re, tail in ((wu_l, wu_r, (d, f)), (wd_l, wd_r, (f, d))):
        n_l, n_r, t = bank_dims(name, lo, re)
        if (n_l, n_r, t) != (e_l, e_r, tail):
            raise ValueError(f"{name}: bank shapes disagree")
    if e_l + e_r != e or d_g != d:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match banks ({e_l}+{e_r}, {d_g}, {f})")
    return e, c, d, e_l, e_r, f


def split_grouped_swiglu(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r, plans: tuple | None = None):
    """Fused per-expert SwiGLU over split banks: (E, C, D) -> (E, C, D).

    Gate/up banks (E_*, D, F), down banks (E_*, F, D). ``plans``: (gate/up,
    down) launch plans on the card (default ``grouped_swiglu_plans``')."""
    name = GROUPED_SWIGLU.name
    e, c, d, e_l, e_r, f = _swiglu_dims(name, x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r)
    ops = (x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r)
    if on_cpu(*ops):
        return split_grouped_swiglu_torch(*ops)
    code = check_cuda_operands(name, *ops, fp8=True)
    gate_up, down = plans or grouped_swiglu_plans(*ops)
    wcode = weight_code(name, ops[1:], gate_up, down)
    h = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    GROUPED_SWIGLU.launch([*ops, h, out],
                          [e_l, e_r, c, d, f, code, wcode, *gate_up.ints(), *down.ints()])
    PATHS[path_key(name, "gate_up", gate_up, c, wg_l.dtype)] += 1
    PATHS[path_key(name, "down", down, c, wg_l.dtype)] += 1
    return out


def split_grouped_swiglu_demand(x, wg_l, wu_l, wd_l, wg_f, wu_f, wd_f, valid,
                                plans: tuple | None = None):
    """Fused SwiGLU over the (local, fetched) bank pair: (E_l + E_f, C, D)
    -> (E_l + E_f, C, D); ``valid`` (E_f,) bool marks the real fetched
    rows (padding rows read no weights and give zeros). Runs kernel #2's
    plans for these shapes (``plans``: others on the card)."""
    name = GROUPED_SWIGLU_DEMAND.name
    e, c, d, e_l, e_f, f = _swiglu_dims(name, x, wg_l, wu_l, wd_l, wg_f, wu_f, wd_f)
    if valid.dim() != 1 or valid.shape[0] != e_f or valid.dtype != torch.bool:
        raise ValueError(f"{name}: valid must be a ({e_f},) bool vector, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    ops = (x, wg_l, wu_l, wd_l, wg_f, wu_f, wd_f)
    if on_cpu(*ops, valid):
        return split_grouped_swiglu_demand_torch(*ops, valid)
    code = check_cuda_operands(name, *ops, fp8=True)
    gate_up, down = plans or grouped_swiglu_plans(*ops)
    wcode = weight_code(name, ops[1:], gate_up, down)
    valid = valid.contiguous()
    h = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    GROUPED_SWIGLU_DEMAND.launch([*ops, valid, h, out],
                                 [e_l, e_f, c, d, f, code, wcode, *gate_up.ints(), *down.ints()])
    PATHS[path_key(name, "gate_up", gate_up, c, wg_l.dtype)] += 1
    PATHS[path_key(name, "down", down, c, wg_l.dtype)] += 1
    return out


def check_gemm_operands(x, w_local, w_remote, plan: Plan) -> tuple[int, int]:
    """(dtype code, weight code) of a #1 launch under ``plan``; raises on
    what the kernel does not take: fp8 banks beside fp32 activations, and
    fp8 banks off the Hopper path (a width that is not a multiple of 8, F
    not a multiple of 16, an unaligned pointer)."""
    name = GROUPED_GEMM.name
    code = check_cuda_operands(name, x, w_local, w_remote, fp8=True)  # one bank dtype
    wcode = WEIGHT_CODES.get(w_local.dtype, 0)
    if wcode and plan.path != "hopper":
        raise TypeError(f"{name}: fp8-stored banks run on the Hopper path only (D a multiple "
                        f"of 8, F of 16, 16-byte aligned operands); this launch's plan is "
                        f"{plan.path!r}")
    return code, wcode


def split_grouped_gemm(x, w_local, w_remote, plan: Plan | None = None):
    """Grouped GEMM over split banks: x (E, C, D), banks (E_l, D, F) /
    (E - E_l, D, F) in x's dtype or, beside bf16 activations, in fp8 ->
    (E, C, F) in x's dtype. ``plan``: the launch plan on the card (default
    ``gemm_plan``'s)."""
    name = GROUPED_GEMM.name
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (E, C, D), got {tuple(x.shape)}")
    e, c, d = x.shape
    e_l, e_r, (d_w, f) = bank_dims(name, w_local, w_remote)
    if e_l + e_r != e or d_w != d:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match banks ({e_l}+{e_r}, {d_w}, {f})")
    if on_cpu(x, w_local, w_remote):
        return split_grouped_gemm_torch(x, w_local, w_remote)
    plan = plan or gemm_plan(x, w_local, w_remote)
    code, wcode = check_gemm_operands(x, w_local, w_remote, plan)
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    GROUPED_GEMM.launch([x, w_local, w_remote, out],
                        [e_l, e_r, c, d, f, code, wcode, *plan.ints()])
    PATHS[(name, "gemm", plan.path, row_class(c), str(w_local.dtype).removeprefix("torch."))] += 1
    return out
