"""Shared primitive layers: RMSNorm, RoPE, softcap (per-rank local math)."""
from __future__ import annotations

import numpy as np
import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               freqs: torch.Tensor | None = None) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, head_dim); positions: (..., S).
    ``freqs``: ``rope_frequencies(head_dim, theta)`` already on x's device
    (``Model.rope_freqs``), which a captured step needs: it may not copy
    from the host."""
    head_dim = x.shape[-1]
    if freqs is None:
        freqs = torch.from_numpy(rope_frequencies(head_dim, theta)).to(x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return logits
    return cap * torch.tanh(logits / cap)
