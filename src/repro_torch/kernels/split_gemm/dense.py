"""Split dense kernels: attention QKV/O projections and dense SwiGLU.

Each wrapper launches its hand-written CUDA kernel for CUDA tensors and
runs its plain version for CPU tensors:

- ``split_stack_gemm`` (``csrc/split_stack_gemm.cu``, replacing
  ``repro/kernels/split_gemm/dense.py::split_stack_gemm``): shared x
  (T, D) against stacked slices -> (S, T, Fs), one output block per slice.
- ``split_reduce_gemm`` (``csrc/split_reduce_gemm.cu``, replacing
  ``dense.py::split_reduce_gemm``): sum_s x[s] @ w[s], (S, T, Fs) -> (T, D).
- ``split_dense_swiglu`` (``csrc/split_dense_swiglu.cu``, replacing
  ``dense.py::split_dense_swiglu``): y = sum_s swiglu_s(x), (T, D) -> (T, D).

Slices ``[0, S_l)`` read the local bank, the rest the remote bank.

Every launch of the three runs the path that ``plan_split`` picks from the
shapes (``csrc/split_hopper.cuh``): ``hopper`` (TMA, an mbarrier ring and
wgmma) over more than 2 bf16 rows, ``few_row`` at 2 rows or fewer, and
the ``split_tile.cuh`` tiles (``mma`` in bf16, ``fma`` in fp32) for fp32
and for widths or pointers the tensor maps cannot take. ``PATHS`` counts
the launches of each path.

The banks may be stored in fp8 (e4m3, e5m2) beside bf16 activations, as
the Pallas kernels' ``_cast`` allows: the ``hopper`` and ``few_row``
paths widen each fp8 tile exactly to bf16 on the chip (n a multiple of
16); where a plan leaves those paths the wrapper raises ``TypeError``.
"""
from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from repro_torch import counters
from repro_torch.kernels._launch import (
    FP8_DTYPES,
    CudaKernel,
    bank_dims,
    cast_like,
    check_cuda_operands,
    on_cpu,
    weight_code,
)

STACK_GEMM = CudaKernel("split_stack_gemm", n_ptrs=5, n_ints=13)
REDUCE_GEMM = CudaKernel("split_reduce_gemm", n_ptrs=5, n_ints=13)
DENSE_SWIGLU = CudaKernel("split_dense_swiglu", n_ptrs=10, n_ints=19)
#: The prefill path's single-tile check (not on any serving path).
HOPPER_TILE_CHECK = CudaKernel("split_hopper_tile_check", n_ptrs=3, n_ints=1,
                               lib="split_reduce_gemm")

# --------------------------------------------------------------------------
# Plans (csrc/split_hopper.cuh; the constants below are its own).
# --------------------------------------------------------------------------
#: C path codes: split_tile.cuh's launchers (mma.sync or FMA tiles, and its
#: few-row register path at <= 2 rows, which the grouped kernels name
#: "tile_few_row" for fp32 and other widths), the Hopper mainloop,
#: split_hopper.cuh's few-row kernels.
PATH_CODES = {"mma": 0, "fma": 0, "tile_few_row": 0, "hopper": 1, "few_row": 2}
SMS = 132                      # H100 SXM streaming multiprocessors
SMEM = 232448                  # shared memory of one block
HOPPER_BK = 64
#: the (BM, BN) block tiles the Hopper mainloop is built for, per op
#: (split_hopper.cuh hopper_tiled): BM 64 is one consumer warpgroup, 128
#: two; BN counts the columns of each B matrix (gate_up has two). Reduce
#: and gate_up keep the tiles that won at every main-path shape of #5/#6;
#: stack takes 128 columns only where 256 leave SMs idle (R1's and
#: Gemma-3's k/v widths); BM 64 serves at most 64 rows (#2's C 16)
#: (tools/sweep_dense_plans.py, PERF.md).
HOPPER_TILES = {"reduce": ((128, 256),), "gate_up": ((128, 128), (64, 128)),
                "stack": ((128, 256), (128, 128), (64, 256)),
                # kernel #1 (grouped.plan_grouped op "gemm"): op STACK, its
                # own launcher (split_hopper.cuh launch_gemm)
                "gemm": ((128, 256), (64, 256))}
MAX_SPLITS = 8
MIN_SPLIT_K_TILES = 2          # k tiles a split keeps at least
# The split decision's cost model: a full wave of the Hopper path runs at
# about PLAN_FLOPS (H100, tools/sweep_dense_plans.py), the fp32 partials
# are written and read once at HBM_BYTES, and their sum is one more launch.
PLAN_FLOPS = 600e12
HBM_BYTES = 3.35e12
SPLIT_LAUNCH_S = 5e-6
FEW_ROW_MAXM = 2
FEW_ROW_COLS = 256             # 32 lanes x 8 bf16 columns
#: blocks a few-row launch aims for (the best of 512-4096 in the sweep)
FEW_ROW_BLOCKS = {"reduce": 1024, "gate_up": 2048, "stack": 256}
FEW_ROW_K = 32                 # a split's k rows come in multiples of this

#: Launches per (kernel, launch, path, row class[, banks' dtype]), counted
#: by the wrappers (``path_key``).
PATHS: collections.Counter = collections.Counter()
counters.register("dense paths", PATHS)


def row_class(rows: int) -> str:
    """The row class of a launch in the ``PATHS`` keys: the few-row paths
    serve "rows<=2", the Hopper path "rows>2"."""
    return "rows>2" if rows > FEW_ROW_MAXM else "rows<=2"


def path_key(name: str, launch: str, plan: "Plan", rows: int, weight: torch.dtype) -> tuple:
    """The ``PATHS`` key of one launch: (kernel, launch, path, row class),
    then the banks' dtype name where they are stored in fp8."""
    key = (name, launch, plan.path, row_class(rows))
    return key + (str(weight).removeprefix("torch."),) if weight in FP8_DTYPES else key


class Plan(NamedTuple):
    path: str          # "hopper" | "few_row" | "mma" | "fma" | "tile_few_row"
    tile: tuple        # (BM, BN, BK) of the hopper path, () otherwise
    stages: int        # ring stages (hopper)
    splits: int        # k splits: fp32 partials summed in order by a second launch
    chunk: int         # k rows per split (few_row)
    scratch: int       # fp32 scratch elements

    def ints(self) -> list:
        bm, bn = self.tile[:2] if self.tile else (0, 0)
        return [PATH_CODES[self.path], bm, bn, self.stages, self.splits, self.chunk]


#: widened bf16 B tiles beside the ring of an fp8-stored bank (split_hopper.cuh)
WIDE_BUFS = 3


def stage_bytes(op: str, bm: int, bn: int, wbytes: int = 2) -> int:
    """Bytes of one ring stage of the Hopper path: the A tile and the B
    boxes (``wbytes`` 1: an fp8-stored bank's boxes, widened on the chip)."""
    mats = 2 if op == "gate_up" else 1
    return 2 * bm * HOPPER_BK + mats * wbytes * HOPPER_BK * bn


def max_stages(op: str, bm: int, bn: int, wbytes: int = 2) -> int:
    """The most ring stages (and their two barriers) that fit a block's
    shared memory beside 1024 bytes of alignment slack (4 of 48 KB at
    128 x 256) and, for fp8 banks (``wbytes`` 1), WIDE_BUFS widened bf16
    B tiles (gate_up: of both matrices)."""
    mats = 2 if op == "gate_up" else 1
    wide = WIDE_BUFS * mats * 2 * HOPPER_BK * bn if wbytes == 1 else 0
    return (SMEM - 1024 - wide) // (stage_bytes(op, bm, bn, wbytes) + 16)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def hopper_plan(op: str, rows: int, k: int, n: int, slices: int, bm: int, bn: int,
                splits: int = 1, wbytes: int = 2) -> Plan:
    """The Hopper launch of ``op`` with a (bm, bn) tile, the most stages
    that fit (``wbytes`` 1: fp8-stored banks), and ``splits`` k splits
    (reduce, stack)."""
    if (bm, bn) not in HOPPER_TILES[op]:
        raise ValueError(f"{op}: no {bm} x {bn} Hopper tile")
    per = 1 if op == "reduce" else slices  # output blocks of the partials
    scratch = splits * per * rows * n if splits > 1 else 0
    return Plan("hopper", (bm, bn, HOPPER_BK), max_stages(op, bm, bn, wbytes), splits, 0,
                scratch)


@functools.lru_cache(maxsize=None)  # a pure function, on every launch's host path
def plan_split(op: str, dtype: torch.dtype, rows: int, k: int, n: int, slices: int,
               aligned: bool = True, weight: torch.dtype | None = None) -> Plan:
    """The launch plan of one split launch, a pure function of its shapes
    and of the banks' dtype ``weight`` (by default ``dtype``).

    ``op`` "reduce": out (rows, n) = sum over ``slices`` of (rows, k) @ (k, n);
    "gate_up": per slice silu((rows, k) @ Wg) * ((rows, k) @ Wu), (k, n)
    each; "stack": per slice (rows, k) @ W(s), (k, n).
    ``aligned``: every operand's pointer is 16-byte aligned (the wrappers
    also require k and n to be multiples of 8).

    - fp32: "fma"; bf16 with a width that is not a multiple of 8 or an
      unaligned pointer: "mma" (split_tile.cuh's mma.sync tiles).
    - at most 2 rows: "few_row" (``few_row_plan``), about FEW_ROW_BLOCKS[op]
      blocks.
    - more rows: "hopper", BM 64 (one consumer warpgroup) at most 64 rows
      for gate_up and stack, else 128; reduce 128 x 256, gate_up 128
      columns of each matrix, stack 256 or 128 columns; as many ring
      stages as fit. Reduce and stack pick the tile width and ``splits``
      (k split into fp32 partials) that the cost model above puts first,
      the wider tile and fewer splits on a tie: tiles that fill fewer than
      two waves of SMS may split where the waves saved outweigh the
      partials' traffic and launch (each split keeps at least
      MIN_SPLIT_K_TILES k tiles); gate_up never splits.
    - fp8 banks: the same paths and tiles (the stages that fit beside the
      widened tiles are the bf16 plan's at every tile; the few-row path's
      blocks cover 512 columns), where n is also a multiple of 16 (the
      banks' 16-byte row stride); else "mma", which the wrapper refuses
      for fp8.
    """
    if op not in HOPPER_TILES:
        raise ValueError(f"unknown split op {op!r}")
    wbytes = 1 if weight in FP8_DTYPES else 2
    if dtype != torch.bfloat16:
        return Plan("fma", (), 0, 1, 0, 0)
    if not aligned or k % 8 or n % (8 if wbytes == 2 else 16):
        return Plan("mma", (), 0, 1, 0, 0)
    if rows <= FEW_ROW_MAXM:
        return few_row_plan(op, rows, k, n, slices, wbytes=wbytes)
    bm = 64 if rows <= 64 and op != "reduce" else 128
    if op == "gate_up":
        return hopper_plan(op, rows, k, n, slices, bm, 128, wbytes=wbytes)
    flops = 2 * rows * n * slices * k
    k_tiles = (slices if op == "reduce" else 1) * _cdiv(k, HOPPER_BK)
    per = 1 if op == "reduce" else slices

    def cost(bn, s):  # seconds: quantized waves of work, then the partials
        blocks = _cdiv(rows, bm) * _cdiv(n, bn) * per * s
        t = flops / PLAN_FLOPS * _cdiv(blocks, SMS) * SMS / blocks
        return t + (8 * s * per * rows * n / HBM_BYTES + SPLIT_LAUNCH_S if s > 1 else 0)

    options = []
    for bm_, bn in HOPPER_TILES[op]:
        if bm_ != bm:
            continue
        tiles = _cdiv(rows, bm) * _cdiv(n, bn) * per
        top = 1
        if tiles < 2 * SMS:
            top = max(1, min(MAX_SPLITS, k_tiles // MIN_SPLIT_K_TILES))
        options += [(cost(bn, s), -bn, s) for s in range(1, top + 1)]
    _, neg_bn, splits = min(options)
    return hopper_plan(op, rows, k, n, slices, bm, -neg_bn, splits, wbytes=wbytes)


def few_row_plan(op: str, rows: int, k: int, n: int, slices: int,
                 blocks: int | None = None, wbytes: int = 2) -> Plan:
    """The few-row launch with about ``blocks`` blocks: each block streams
    a chunk of ``chunk`` k rows (a multiple of FEW_ROW_K) of 256 columns
    (512 of fp8-stored banks, ``wbytes`` 1); a reduce's chunks never cross
    a slice (``splits`` = slices x chunks per slice)."""
    blocks = blocks or FEW_ROW_BLOCKS[op]
    cols = _cdiv(n, FEW_ROW_COLS * 2 // wbytes)
    if op == "reduce":
        per = _cdiv(_cdiv(blocks, cols), slices)
        chunk = _cdiv(_cdiv(k, per), FEW_ROW_K) * FEW_ROW_K
        splits = slices * _cdiv(k, chunk)
        scratch = splits * rows * n
    else:
        mats = 2 if op == "gate_up" else 1
        per = _cdiv(blocks, cols * slices)
        chunk = _cdiv(_cdiv(k, per), FEW_ROW_K) * FEW_ROW_K
        splits = _cdiv(k, chunk)
        scratch = splits * mats * slices * rows * n
    return Plan("few_row", (), 0, splits, chunk, scratch)


def _aligned(*tensors) -> bool:
    return all(t.numel() == 0 or t.data_ptr() % 16 == 0 for t in tensors)


def stack_plan(x, w_local, w_remote) -> Plan:
    """The plan ``split_stack_gemm`` runs for these operands."""
    t, d = x.shape
    s = w_local.shape[0] + w_remote.shape[0]
    f = (w_local if w_local.shape[0] else w_remote).shape[2]
    return plan_split("stack", x.dtype, t, d, f, s, _aligned(x, w_local, w_remote),
                      w_local.dtype)


def reduce_plan(x, w_local, w_remote) -> Plan:
    """The plan ``split_reduce_gemm`` runs for these operands."""
    s, t, f = x.shape
    d = (w_local if w_local.shape[0] else w_remote).shape[2]
    return plan_split("reduce", x.dtype, t, f, d, s, _aligned(x, w_local, w_remote),
                      w_local.dtype)


def dense_swiglu_plans(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r) -> tuple[Plan, Plan]:
    """(gate/up plan, down plan) that ``split_dense_swiglu`` runs."""
    t, d = x.shape
    s = wg_l.shape[0] + wg_r.shape[0]
    f = (wg_l if wg_l.shape[0] else wg_r).shape[2]
    ok = _aligned(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r)
    return (plan_split("gate_up", x.dtype, t, d, f, s, ok, wg_l.dtype),
            plan_split("reduce", x.dtype, t, f, d, s, ok, wg_l.dtype))


def _scratch(n: int, device):
    """fp32 scratch of ``n`` elements, or None (a null pointer) for none."""
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def hopper_tile_check(a, b):
    """(64, k) @ (k, 64) -> (64, 64) fp32 through one TMA load per operand and
    four wgmma steps (the prefill path's building blocks); bf16, k <= 64,
    on the card only."""
    if a.device.type != "cuda" or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError("hopper_tile_check takes bf16 CUDA tensors")
    k = a.shape[1]
    if a.shape != (64, k) or b.shape != (k, 64) or not 1 <= k <= HOPPER_BK or k % 8:
        raise ValueError(f"hopper_tile_check: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    out = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    HOPPER_TILE_CHECK.launch([a.contiguous(), b.contiguous(), out], [k])
    return out


# --------------------------------------------------------------------------
# Plain versions (the JAX package's ``ops.*_jnp`` formulations).
# --------------------------------------------------------------------------
def split_stack_gemm_torch(x, w_local, w_remote):
    y_l = torch.einsum("td,sdf->stf", x, cast_like(w_local, x))
    y_r = torch.einsum("td,sdf->stf", x, cast_like(w_remote, x))
    return torch.cat([y_l, y_r], dim=0)


def split_reduce_gemm_torch(x, w_local, w_remote):
    s_l = w_local.shape[0]
    y_l = torch.einsum("stf,sfd->td", x[:s_l], cast_like(w_local, x))
    y_r = torch.einsum("stf,sfd->td", x[s_l:], cast_like(w_remote, x))
    return y_l + y_r


def split_dense_swiglu_torch(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r):
    def part(wg, wu, wd):
        h = torch.nn.functional.silu(
            torch.einsum("td,sdf->tsf", x, cast_like(wg, x))
        ) * torch.einsum("td,sdf->tsf", x, cast_like(wu, x))
        return torch.einsum("tsf,sfd->td", h, cast_like(wd, x))

    return part(wg_l, wu_l, wd_l) + part(wg_r, wu_r, wd_r)


# --------------------------------------------------------------------------
# Kernel wrappers.
# --------------------------------------------------------------------------
def split_stack_gemm(x, w_local, w_remote, plan: Plan | None = None):
    """(T, D) x banks (S_l, D, Fs) / (S - S_l, D, Fs) -> (S, T, Fs).
    ``plan``: the launch plan on the card (default ``stack_plan``'s)."""
    name = STACK_GEMM.name
    s_l, s_r, (d, f) = bank_dims(name, w_local, w_remote)
    if x.dim() != 2 or x.shape[1] != d:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match banks (*, {d}, {f})")
    if on_cpu(x, w_local, w_remote):
        return split_stack_gemm_torch(x, w_local, w_remote)
    code = check_cuda_operands(name, x, w_local, w_remote, fp8=True)
    t = x.shape[0]
    plan = plan or stack_plan(x, w_local, w_remote)
    wcode = weight_code(name, (w_local, w_remote), plan)
    out = torch.empty((s_l + s_r, t, f), dtype=x.dtype, device=x.device)
    scratch = _scratch(plan.scratch, x.device)
    STACK_GEMM.launch([x, w_local, w_remote, out, scratch],
                      [s_l, s_r, t, d, f, code, wcode, *plan.ints()])
    PATHS[path_key(name, "stack", plan, t, w_local.dtype)] += 1
    return out


def split_reduce_gemm(x, w_local, w_remote, plan: Plan | None = None):
    """(S, T, Fs) x banks (S_l, Fs, D) / (S - S_l, Fs, D) -> (T, D).
    ``plan``: the launch plan on the card (default ``reduce_plan``'s)."""
    name = REDUCE_GEMM.name
    s_l, s_r, (f, d) = bank_dims(name, w_local, w_remote)
    if x.dim() != 3 or x.shape[0] != s_l + s_r or x.shape[2] != f:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match banks ({s_l}+{s_r}, {f}, {d})")
    if on_cpu(x, w_local, w_remote):
        return split_reduce_gemm_torch(x, w_local, w_remote)
    code = check_cuda_operands(name, x, w_local, w_remote, fp8=True)
    t = x.shape[1]
    plan = plan or reduce_plan(x, w_local, w_remote)
    wcode = weight_code(name, (w_local, w_remote), plan)
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    scratch = _scratch(plan.scratch, x.device)
    REDUCE_GEMM.launch([x, w_local, w_remote, out, scratch],
                       [s_l, s_r, t, f, d, code, wcode, *plan.ints()])
    PATHS[path_key(name, "reduce", plan, t, w_local.dtype)] += 1
    return out


def split_dense_swiglu(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r, plans: tuple | None = None):
    """(T, D) x gate/up banks (S_*, D, Fs), down banks (S_*, Fs, D) -> (T, D).
    ``plans``: (gate/up, down) launch plans on the card (default
    ``dense_swiglu_plans``')."""
    name = DENSE_SWIGLU.name
    s_l, s_r, (d, f) = bank_dims(name, wg_l, wg_r)
    for lo, re, tail in ((wu_l, wu_r, (d, f)), (wd_l, wd_r, (f, d))):
        if bank_dims(name, lo, re) != (s_l, s_r, tail):
            raise ValueError(f"{name}: bank shapes disagree")
    if x.dim() != 2 or x.shape[1] != d:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match banks (*, {d}, {f})")
    ops = (x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r)
    if on_cpu(*ops):
        return split_dense_swiglu_torch(*ops)
    code = check_cuda_operands(name, *ops, fp8=True)
    t = x.shape[0]
    gate_up, down = plans or dense_swiglu_plans(*ops)
    wcode = weight_code(name, ops[1:], gate_up, down)
    h = torch.empty((s_l + s_r, t, f), dtype=x.dtype, device=x.device)
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    # one scratch for both launches: stream order keeps them apart
    scratch = _scratch(max(gate_up.scratch, down.scratch), x.device)
    DENSE_SWIGLU.launch([*ops, h, out, scratch],
                        [s_l, s_r, t, d, f, code, wcode, *gate_up.ints(), *down.ints()])
    PATHS[path_key(name, "gate_up", gate_up, t, wg_l.dtype)] += 1
    PATHS[path_key(name, "reduce", down, t, wg_l.dtype)] += 1
    return out
