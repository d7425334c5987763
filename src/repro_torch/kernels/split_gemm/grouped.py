"""Split grouped SwiGLU: the MoE expert kernel of the DWDP path.

``split_grouped_swiglu`` launches the hand-written CUDA kernel
(``csrc/split_grouped_swiglu.cu``, replacing the Pallas kernel
``repro/kernels/split_gemm/split_gemm.py::split_grouped_swiglu``) for
CUDA tensors and runs ``split_grouped_swiglu_torch``, the plain version,
for CPU tensors. Experts ``[0, E_l)`` read the local bank, the rest the
remote bank; no merged bank is built.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.split_gemm._launch import (
    CudaKernel,
    bank_dims,
    check_cuda_operands,
    on_cpu,
)
from repro_torch.models.moe import grouped_ffn

GROUPED_SWIGLU = CudaKernel("split_grouped_swiglu", n_ptrs=9, n_ints=6)


def split_grouped_swiglu_torch(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r):
    """Plain version: per-bank grouped FFN over the matching expert slice
    of ``x``, outputs concatenated (``ops.split_swiglu_jnp`` of the JAX
    package)."""
    e_l = wg_l.shape[0]
    y_l = grouped_ffn(x[:e_l], wg_l, wu_l, wd_l)
    y_r = grouped_ffn(x[e_l:], wg_r, wu_r, wd_r)
    return torch.cat([y_l, y_r], dim=0)


def split_grouped_swiglu(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r):
    """Fused per-expert SwiGLU over split banks: (E, C, D) -> (E, C, D).

    Gate/up banks (E_*, D, F), down banks (E_*, F, D)."""
    name = GROUPED_SWIGLU.name
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
    ops = (x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r)
    if on_cpu(*ops):
        return split_grouped_swiglu_torch(*ops)
    code = check_cuda_operands(name, *ops)
    h = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    GROUPED_SWIGLU.launch([*ops, h, out], [e_l, e_r, c, d, f, code])
    return out
