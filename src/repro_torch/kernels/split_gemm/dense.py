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
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import (
    CudaKernel,
    bank_dims,
    cast_like,
    check_cuda_operands,
    on_cpu,
)

STACK_GEMM = CudaKernel("split_stack_gemm", n_ptrs=4, n_ints=6)
REDUCE_GEMM = CudaKernel("split_reduce_gemm", n_ptrs=4, n_ints=6)
DENSE_SWIGLU = CudaKernel("split_dense_swiglu", n_ptrs=9, n_ints=6)


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
def split_stack_gemm(x, w_local, w_remote):
    """(T, D) x banks (S_l, D, Fs) / (S - S_l, D, Fs) -> (S, T, Fs)."""
    name = STACK_GEMM.name
    s_l, s_r, (d, f) = bank_dims(name, w_local, w_remote)
    if x.dim() != 2 or x.shape[1] != d:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match banks (*, {d}, {f})")
    if on_cpu(x, w_local, w_remote):
        return split_stack_gemm_torch(x, w_local, w_remote)
    code = check_cuda_operands(name, x, w_local, w_remote)
    t = x.shape[0]
    out = torch.empty((s_l + s_r, t, f), dtype=x.dtype, device=x.device)
    STACK_GEMM.launch([x, w_local, w_remote, out], [s_l, s_r, t, d, f, code])
    return out


def split_reduce_gemm(x, w_local, w_remote):
    """(S, T, Fs) x banks (S_l, Fs, D) / (S - S_l, Fs, D) -> (T, D)."""
    name = REDUCE_GEMM.name
    s_l, s_r, (f, d) = bank_dims(name, w_local, w_remote)
    if x.dim() != 3 or x.shape[0] != s_l + s_r or x.shape[2] != f:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match banks ({s_l}+{s_r}, {f}, {d})")
    if on_cpu(x, w_local, w_remote):
        return split_reduce_gemm_torch(x, w_local, w_remote)
    code = check_cuda_operands(name, x, w_local, w_remote)
    t = x.shape[1]
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    REDUCE_GEMM.launch([x, w_local, w_remote, out], [s_l, s_r, t, f, d, code])
    return out


def split_dense_swiglu(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r):
    """(T, D) x gate/up banks (S_*, D, Fs), down banks (S_*, Fs, D) -> (T, D)."""
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
    code = check_cuda_operands(name, *ops)
    t = x.shape[0]
    h = torch.empty((s_l + s_r, t, f), dtype=x.dtype, device=x.device)
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    DENSE_SWIGLU.launch([*ops, h, out], [s_l, s_r, t, d, f, code])
    return out
