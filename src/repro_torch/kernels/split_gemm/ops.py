"""Engine-facing dispatch for the split-bank kernels.

Every op takes ``impl``:

- ``None`` or ``"kernel"`` — the kernel wrapper: the hand-written CUDA
  kernel for CUDA tensors (it launches or raises; there is no fallback),
  the plain version for CPU tensors.
- ``"torch"`` — the plain PyTorch version on any device (the JAX
  package's ``impl="jnp"``); ``chip_smoke.py`` compares against it.

Both honour the same contract: slices/experts ``[0, n_local)`` read the
local bank, the rest the remote bank, and no merged weight buffer is
built.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.split_gemm.dense import (
    split_dense_swiglu,
    split_dense_swiglu_torch,
    split_reduce_gemm,
    split_reduce_gemm_torch,
    split_stack_gemm,
    split_stack_gemm_torch,
)
from repro_torch.kernels.split_gemm.grouped import (
    split_grouped_gemm,
    split_grouped_gemm_torch,
    split_grouped_swiglu,
    split_grouped_swiglu_demand,
    split_grouped_swiglu_demand_torch,
    split_grouped_swiglu_torch,
)


def default_dense_impl(phase: str, device: torch.device) -> str:
    """The JAX package's policy (``ops.default_dense_impl``) with the card
    standing in for the TPU: the kernel for tensors on the card, the plain
    version on the CPU and for training."""
    if phase == "train":
        return "torch"
    return "kernel" if torch.device(device).type == "cuda" else "torch"


def _pick(impl, kernel, plain, name):
    if impl in (None, "kernel"):
        return kernel
    if impl == "torch":
        return plain
    raise ValueError(f"unknown {name} impl {impl!r}")


def split_swiglu(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r, *, impl=None):
    """Fused split grouped SwiGLU. x: (E, C, D) -> (E, C, D)."""
    fn = _pick(impl, split_grouped_swiglu, split_grouped_swiglu_torch, "split_swiglu")
    return fn(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r)


def split_swiglu_demand(x, wg_l, wu_l, wd_l, wg_f, wu_f, wd_f, valid, *, impl=None):
    """Fused SwiGLU over the (local, demand-fetched) bank pair.
    x: (E_l + E_f, C, D) -> (E_l + E_f, C, D); ``valid`` (E_f,) bool."""
    fn = _pick(impl, split_grouped_swiglu_demand, split_grouped_swiglu_demand_torch,
               "split_swiglu_demand")
    return fn(x, wg_l, wu_l, wd_l, wg_f, wu_f, wd_f, valid)


def split_gemm(x, w_local, w_remote, *, impl=None):
    """Grouped GEMM over split expert banks. x: (E, C, D) -> (E, C, F)."""
    fn = _pick(impl, split_grouped_gemm, split_grouped_gemm_torch, "split_gemm")
    return fn(x, w_local, w_remote)


def split_stack_matmul(x, w_local, w_remote, *, impl=None):
    """x: (T, D) -> (S, T, Fs), slice order = bank order."""
    fn = _pick(impl, split_stack_gemm, split_stack_gemm_torch, "split_stack_matmul")
    return fn(x, w_local, w_remote)


def split_reduce_matmul(x, w_local, w_remote, *, impl=None):
    """x: (S, T, Fs) -> (T, D) = sum_s x[s] @ w[s]."""
    fn = _pick(impl, split_reduce_gemm, split_reduce_gemm_torch, "split_reduce_matmul")
    return fn(x, w_local, w_remote)


def split_dense_ffn(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r, *, impl=None):
    """Dense split SwiGLU. x: (T, D) -> (T, D)."""
    fn = _pick(impl, split_dense_swiglu, split_dense_swiglu_torch, "split_dense_ffn")
    return fn(x, wg_l, wu_l, wd_l, wg_r, wu_r, wd_r)
