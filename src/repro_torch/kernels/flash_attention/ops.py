"""Blockwise causal / sliding-window GQA attention: the prefill kernel.

``flash_attention`` (``csrc/flash_attention.cu``, replacing the Pallas
kernel ``repro/kernels/flash_attention/flash_attention.py::flash_attention``)
keeps the JAX signature and layout: q (B, Sq, H, hd), k / v (B, Sk, Kh, hd),
out like q; query head ``h`` reads kv head ``h // (H // Kh)``; query row
``i`` sits at absolute position ``q_offset + i``. ``impl``:

- ``None`` or ``"kernel"``: the hand-written CUDA kernel for CUDA tensors
  (it launches or raises; there is no fallback), the plain version for
  CPU tensors;
- ``"torch"``: the plain version on any device.

On the card each launch runs the plan ``flash_plan`` picks from the
shapes: "wgmma" (bf16 at hd 128, the launches of every model but
RecurrentGemma: TMA-fed K/V tiles, wgmma, 128 query rows and 128-key
tiles a block) or "mma" (fp32, and bf16 at hd 64 and 256: the earlier
mma.sync / FMA kernels, 64 query rows and 64-key tiles; bf16 at hd 128
has no "mma" kernel, fp32 at hd 256 none at all).

The plain version, ``flash_attention_torch`` (online softmax over
512-key blocks, every block visited and masked), is also the port's
``models.attention.mha_prefill``.
"""
from __future__ import annotations

import collections
import functools
import math
from typing import NamedTuple

import torch

from repro_torch import counters
from repro_torch.kernels._launch import DTYPE_CODES, CudaKernel, on_cpu
from repro_torch.kernels.split_gemm.dense import SMEM

NEG_INF = -1e30

FLASH_ATTENTION = CudaKernel("flash_attention", n_ptrs=4, n_ints=11)
#: head dims the kernel is built for (hd 256, RecurrentGemma's, in bf16 only)
HEAD_DIMS = (64, 128, 256)
#: query rows (two consumer warpgroups) and keys per tile of the Hopper
#: kernel (csrc/flash_attention.cu WgTile): the tile that won at every
#: prefill shape of the serving path (tools/sweep_dense_plans.py, PERF.md)
WGMMA_BQ = WGMMA_BKV = 128
PATH_CODES = {"mma": 0, "wgmma": 1}
#: Launches per plan on the card, counted by the wrapper.
PATHS: collections.Counter = collections.Counter()
counters.register("flash paths", PATHS)


class FlashPlan(NamedTuple):
    path: str      # "wgmma" | "mma"
    stages: int    # K/V ring stages (wgmma)

    def ints(self) -> list:
        return [PATH_CODES[self.path], self.stages]


def plan_label(plan: FlashPlan) -> str:
    return (f"wgmma {WGMMA_BQ}x{WGMMA_BKV} stages {plan.stages}" if plan.path == "wgmma"
            else plan.path)


def wgmma_smem(stages: int) -> int:
    """Shared memory of the Hopper kernel: alignment slack, the q tile,
    the K/V stages and their barriers (csrc/flash_attention.cu
    wg_smem_bytes)."""
    return 1024 + WGMMA_BQ * 256 + stages * 4 * WGMMA_BKV * 128 + 8 * (1 + 3 * stages)


def wgmma_plan(stages: int | None = None) -> FlashPlan:
    """The Hopper launch with ``stages`` ring stages (default: as many as
    fit, 3)."""
    if stages is None:
        stages = max(s for s in (1, 2, 3) if wgmma_smem(s) <= SMEM)
    if stages < 1 or wgmma_smem(stages) > SMEM:
        raise ValueError(f"flash_attention: {stages} ring stages do not fit")
    return FlashPlan("wgmma", stages)


@functools.lru_cache(maxsize=None)  # a pure function, on every launch's host path
def flash_plan(dtype: torch.dtype, hd: int) -> FlashPlan:
    """The launch plan of one flash attention call: bf16 at hd 128 runs
    "wgmma" with the most ring stages that fit; anything else "mma" (the
    earlier kernels)."""
    if dtype != torch.bfloat16 or hd != 128:
        return FlashPlan("mma", 0)
    return wgmma_plan()


def flash_attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    q_offset: int = 0,
    kv_offset: int = 0,
    block_kv: int = 512,
) -> torch.Tensor:
    """The plain version: chunked causal attention over 512-key blocks.
    q: (B,Sq,H,hd); k,v: (B,Sk,Kh,hd).

    window=0 means full causal; window=w limits attention to the last w
    keys. ``kv_offset`` is the absolute position of k[:, 0]; ``q_offset``
    that of q[:, 0]. Returns (B,Sq,H,hd)."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    rep = h // kh
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qt = (q * scale).permute(0, 2, 1, 3).reshape(b, kh, rep, sq, hd)
    kt = k.permute(0, 2, 1, 3)  # (B,Kh,Sk,hd)
    vt = v.permute(0, 2, 1, 3)

    block_kv = min(block_kv, sk)
    nblk = -(-sk // block_kv)
    q_pos = q_offset + torch.arange(sq, device=dev)

    acc = torch.zeros(b, kh, rep, sq, hd, dtype=torch.float32, device=dev)
    m_run = torch.full((b, kh, rep, sq), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros(b, kh, rep, sq, dtype=torch.float32, device=dev)
    for blk in range(nblk):
        start = blk * block_kv
        kj = kt[:, :, start:start + block_kv]
        vj = vt[:, :, start:start + block_kv]
        n = kj.shape[2]
        logits = torch.einsum("bkrqd,bkld->bkrql", qt.float(), kj.float())
        k_pos = kv_offset + start + torch.arange(n, device=dev)
        mask = k_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        # padded tail keys of the JAX block scan are masked out there; here
        # the last block is simply shorter, which leaves the sums unchanged
        m_new = torch.maximum(m_run, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkrql,bkld->bkrqd", p, vj.float())
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    return out.reshape(b, h, sq, hd).permute(0, 2, 1, 3).to(q.dtype)


def _check(q, k, v, window: int, q_offset: int) -> None:
    name = FLASH_ATTENTION.name
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "must be (B, S, heads, hd) with v shaped like k")
    b, sq, h, hd = q.shape
    bk, sk, kh, hdk = k.shape
    if bk != b or hdk != hd or kh == 0 or h % kh:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "(batch, head dim, or heads not a multiple of kv heads)")
    if window < 0 or q_offset < 0 or q_offset + sq > sk:
        raise ValueError(f"{name}: needs window >= 0 and 0 <= q_offset, q_offset + Sq <= Sk "
                         f"(every query row sees its own key); got window {window}, "
                         f"q_offset {q_offset}, Sq {sq}, Sk {sk}")


def flash_attention(q, k, v, *, window: int = 0, q_offset: int = 0, impl=None,
                    plan: FlashPlan | None = None):
    """Causal (``window=0``) or sliding-window attention. Returns (B, Sq, H, hd).
    ``plan``: the launch plan on the card (default ``flash_plan``'s)."""
    _check(q, k, v, window, q_offset)
    if impl == "torch":
        return flash_attention_torch(q, k, v, window=window, q_offset=q_offset)
    if impl not in (None, "kernel"):
        raise ValueError(f"unknown flash_attention impl {impl!r}")
    if on_cpu(q, k, v):
        return flash_attention_torch(q, k, v, window=window, q_offset=q_offset)
    name = FLASH_ATTENTION.name
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must start 16-byte aligned (the kernel copies "
                         "16-byte vectors)")
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} is not built (kernel head dims {HEAD_DIMS})")
    if hd == 256 and q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: head dim 256 is built for bfloat16 only, got {q.dtype}")
    plan = plan or flash_plan(q.dtype, hd)
    out = torch.empty_like(q)
    FLASH_ATTENTION.launch([q, k, v, out], [b, sq, sk, h, kh, hd, q_offset, window,
                                            DTYPE_CODES[q.dtype], *plan.ints()])
    PATHS[plan] += 1
    return out
