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
  ``split_gemm.py::split_grouped_gemm``): ``y[e] = x[e] @ W(e)``.

Experts ``[0, E_l)`` read the local bank, the rest the second bank; no
merged bank is built.
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
from repro_torch.models.moe import grouped_ffn

GROUPED_SWIGLU = CudaKernel("split_grouped_swiglu", n_ptrs=9, n_ints=6)
GROUPED_SWIGLU_DEMAND = CudaKernel("split_grouped_swiglu_demand", n_ptrs=10, n_ints=6)
GROUPED_GEMM = CudaKernel("split_grouped_gemm", n_ptrs=4, n_ints=6)


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


def split_grouped_swiglu(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r):
    """Fused per-expert SwiGLU over split banks: (E, C, D) -> (E, C, D).

    Gate/up banks (E_*, D, F), down banks (E_*, F, D)."""
    name = GROUPED_SWIGLU.name
    e, c, d, e_l, e_r, f = _swiglu_dims(name, x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r)
    ops = (x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r)
    if on_cpu(*ops):
        return split_grouped_swiglu_torch(*ops)
    code = check_cuda_operands(name, *ops)
    h = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    GROUPED_SWIGLU.launch([*ops, h, out], [e_l, e_r, c, d, f, code])
    return out


def split_grouped_swiglu_demand(x, wg_l, wu_l, wd_l, wg_f, wu_f, wd_f, valid):
    """Fused SwiGLU over the (local, fetched) bank pair: (E_l + E_f, C, D)
    -> (E_l + E_f, C, D); ``valid`` (E_f,) bool marks the real fetched
    rows (padding rows read no weights and give zeros)."""
    name = GROUPED_SWIGLU_DEMAND.name
    e, c, d, e_l, e_f, f = _swiglu_dims(name, x, wg_l, wu_l, wd_l, wg_f, wu_f, wd_f)
    if valid.dim() != 1 or valid.shape[0] != e_f or valid.dtype != torch.bool:
        raise ValueError(f"{name}: valid must be a ({e_f},) bool vector, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    ops = (x, wg_l, wu_l, wd_l, wg_f, wu_f, wd_f)
    if on_cpu(*ops, valid):
        return split_grouped_swiglu_demand_torch(*ops, valid)
    code = check_cuda_operands(name, *ops)
    valid = valid.contiguous()
    h = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    GROUPED_SWIGLU_DEMAND.launch([*ops, valid, h, out], [e_l, e_f, c, d, f, code])
    return out


def split_grouped_gemm(x, w_local, w_remote):
    """Grouped GEMM over split banks: x (E, C, D), banks (E_l, D, F) /
    (E - E_l, D, F) -> (E, C, F)."""
    name = GROUPED_GEMM.name
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (E, C, D), got {tuple(x.shape)}")
    e, c, d = x.shape
    e_l, e_r, (d_w, f) = bank_dims(name, w_local, w_remote)
    if e_l + e_r != e or d_w != d:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match banks ({e_l}+{e_r}, {d_w}, {f})")
    if on_cpu(x, w_local, w_remote):
        return split_grouped_gemm_torch(x, w_local, w_remote)
    code = check_cuda_operands(name, x, w_local, w_remote)
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    GROUPED_GEMM.launch([x, w_local, w_remote, out], [e_l, e_r, c, d, f, code])
    return out
