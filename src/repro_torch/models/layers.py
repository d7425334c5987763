"""Shared primitive layers: RMSNorm, RoPE, softcap, the causal depthwise
convolution (per-rank local math)."""
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


def normal_init(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """A standard normal draw from ``gen`` in fp32, scaled, cast to ``dtype``
    (the JAX package's ``jax.random.normal(...) * s).astype(dtype)``)."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            * scale).to(dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return logits
    return cap * torch.tanh(logits / cap)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, S, D), w: (K, D); ``state`` (B, K-1, D)
    holds the K-1 inputs before x (zeros when None).

    Returns (out, new_state), the new state the trailing K-1 inputs, which
    a decode step continues from (``layers.causal_conv1d`` of the JAX
    package: the taps summed in order, in x's dtype)."""
    k, s = w.shape[0], x.shape[-2]
    if state is None:
        pad = torch.zeros(x.shape[:-2] + (k - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=-2)  # (B, S+K-1, D)
    out = xp[..., 0:s, :] * w[0]
    for i in range(1, k):
        out = out + xp[..., i:i + s, :] * w[i]
    new_state = xp[..., -(k - 1):, :] if k > 1 else torch.zeros_like(pad)
    return out.to(x.dtype), new_state
