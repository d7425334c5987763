"""Every hand-written kernel of the port, by kernel name, and the launch
counts that show a path went through them (``chip_smoke.py`` sets them
to 0 before a path and reads them after)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.ops import FLASH_ATTENTION
from repro_torch.kernels.split_gemm.dense import DENSE_SWIGLU, REDUCE_GEMM, STACK_GEMM
from repro_torch.kernels.split_gemm.grouped import (
    GROUPED_GEMM,
    GROUPED_SWIGLU,
    GROUPED_SWIGLU_DEMAND,
)

KERNELS = {
    k.name: k
    for k in (GROUPED_SWIGLU, STACK_GEMM, REDUCE_GEMM, DENSE_SWIGLU, GROUPED_SWIGLU_DEMAND,
              GROUPED_GEMM, FLASH_ATTENTION)
}


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
