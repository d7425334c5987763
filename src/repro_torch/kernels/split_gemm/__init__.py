"""Split-bank kernels: CUDA kernels, plain versions and ``ops`` dispatch."""
from repro_torch.kernels.split_gemm.ops import (
    default_dense_impl,
    split_dense_ffn,
    split_gemm,
    split_reduce_matmul,
    split_stack_matmul,
    split_swiglu,
    split_swiglu_demand,
)

__all__ = [
    "default_dense_impl",
    "split_dense_ffn",
    "split_gemm",
    "split_reduce_matmul",
    "split_stack_matmul",
    "split_swiglu",
    "split_swiglu_demand",
]
