"""ctypes launch plumbing and argument checks shared by the port's kernels."""
from __future__ import annotations

import ctypes

import torch

from repro_torch import counters
from repro_torch.kernels import build

#: dtype codes of the C entry points (``csrc/split_tile.cuh``,
#: ``csrc/flash_attention.cu``).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the weight storage types the split kernels (#1-#6) widen to bf16 on the chip
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
#: weight codes of the split kernels' entry points (split_hopper.cuh W_*):
#: 0 the activation's own type, else fp8 widened to bf16 on the chip
WEIGHT_CODES = {torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
#: the plan paths that take fp8 banks (split_hopper.cuh; split_tile.cuh takes none)
FP8_PATHS = ("hopper", "few_row")


class CudaKernel:
    """One C entry point of a kernel library plus its launch counter.

    ``launches`` counts the wrapper calls that launched the kernel (one
    per call, whether the entry point issues one CUDA launch or two); it
    is a plain integer that a caller may read and reset. ``lib`` names the
    kernel library when the entry point is not its namesake."""

    def __init__(self, name: str, n_ptrs: int, n_ints: int, lib: str | None = None):
        self.name = name
        self.lib = lib or name
        self.n_ptrs = n_ptrs
        self.n_ints = n_ints
        self.launches = 0
        self._fn = None
        counters.register(name, self, ("launches",))

    def _entry(self):
        if self._fn is None:
            fn = getattr(build.load(self.lib), self.name)
            fn.argtypes = (
                [ctypes.c_void_p] * self.n_ptrs
                + [ctypes.c_int] * self.n_ints
                + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, tensors, ints) -> None:
        """Launch on the current CUDA stream of the first tensor's device
        (``None`` in ``tensors`` passes a null pointer). Raises if the
        launch was refused (``cudaGetLastError``)."""
        assert len(tensors) == self.n_ptrs and len(ints) == self.n_ints
        dev = tensors[0].device
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [0 if t is None else t.data_ptr() for t in tensors]
        if dev.index == torch.cuda.current_device():
            err = self._entry()(*ptrs, *ints, stream)
        else:
            with torch.cuda.device(dev):
                err = self._entry()(*ptrs, *ints, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {err}")
        self.launches += 1


def cast_like(w, like):
    """Weights stored in another type (fp8) upcast to the activation type
    on use — the JAX package's ``_cast``."""
    return w.to(like.dtype) if w.dtype != like.dtype else w


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs the
    plain version); False when every tensor lies on one CUDA device.
    Anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel operands on several devices: {sorted(map(str, devs))}")
    dev = next(iter(devs))
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on CUDA or CPU tensors, got {dev}")
    return False


def check_cuda_operands(name: str, x: torch.Tensor, *weights: torch.Tensor,
                        fp8: bool = False) -> int:
    """Dtype and layout checks of a kernel launch; returns the dtype code.

    ``fp8``: the kernel takes fp8-stored weights (all of one type) beside
    bfloat16 activations (the split kernels #1-#6); the others refuse them."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: activations must be float32 or bfloat16, got {x.dtype}")
    for w in weights:
        if w.dtype != x.dtype:
            if w.dtype in FP8_DTYPES:
                if not fp8:
                    raise TypeError(
                        f"{name}: fp8-stored weights are not supported by this CUDA "
                        "kernel (run impl='torch', which upcasts on use)"
                    )
                if x.dtype != torch.bfloat16:
                    raise TypeError(
                        f"{name}: fp8-stored weights need bfloat16 activations on the "
                        f"CUDA kernel, got {x.dtype} (run impl='torch', which upcasts on use)"
                    )
                continue
            raise TypeError(f"{name}: weight dtype {w.dtype} != activation dtype {x.dtype}")
    if len({w.dtype for w in weights}) > 1:
        raise TypeError(f"{name}: the weights are stored in several dtypes: "
                        f"{sorted(str(w.dtype) for w in weights)}")
    for t in (x, *weights):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return DTYPE_CODES[x.dtype]


def weight_code(name: str, weights, *plans) -> int:
    """The weight code (WEIGHT_CODES) of a split-kernel launch whose banks
    are ``weights`` under ``plans``; raises ``TypeError`` where fp8 banks
    meet a plan off the paths that widen them (split_tile.cuh's, taken for
    widths the tensor maps or 16-byte loads cannot take, or unaligned
    pointers). Call after ``check_cuda_operands(..., fp8=True)``, which
    refuses fp8 beside fp32 activations. No launch falls back."""
    code = WEIGHT_CODES.get(weights[0].dtype, 0)
    off = [p.path for p in plans if p.path not in FP8_PATHS]
    if code and off:
        raise TypeError(f"{name}: fp8-stored banks run on the Hopper and few-row paths only "
                        f"(k a multiple of 8, n of 16, 16-byte aligned operands); this "
                        f"launch's plan is {off[0]!r}")
    return code


def bank_dims(name: str, local: torch.Tensor, remote: torch.Tensor) -> tuple:
    """(n_local, n_remote, tail shape) of a (local, remote) bank pair."""
    if local.dim() != 3 or remote.dim() != 3:
        raise ValueError(f"{name}: banks must be 3-d stacks, got {local.shape} / {remote.shape}")
    n_l, n_r = local.shape[0], remote.shape[0]
    if n_l + n_r == 0:
        raise ValueError(f"{name}: both banks are empty")
    tail = tuple((local if n_l else remote).shape[1:])
    for w, n in ((local, n_l), (remote, n_r)):
        if n and tuple(w.shape[1:]) != tail:
            raise ValueError(f"{name}: bank shapes disagree: {local.shape} vs {remote.shape}")
    return n_l, n_r, tail
