"""GQA attention: chunked prefill + cache decode with LSE (per-rank math).

The port of ``repro.models.attention``. Plain PyTorch, as the JAX engine
uses plain jnp here. ``mha_prefill`` is the plain version of the flash
attention kernel (TPU kernel #7), ``kernels.flash_attention.ops.
flash_attention_torch``, re-exported here: it keeps the block loop over
KV blocks with an online softmax, so a full-width prefill never forms
the (B, H, S, S) logits. Sequence-sharded decode returns ``(out, lse)``
pairs that ``combine_partials`` (or the engine's rank-ordered combine)
reduces.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ops import NEG_INF
from repro_torch.kernels.flash_attention.ops import flash_attention_torch as mha_prefill

__all__ = ["NEG_INF", "combine_partials", "mha_decode_partial", "mha_prefill"]


def mha_decode_partial(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_positions: torch.Tensor,
    q_position: torch.Tensor,
    *,
    window: int = 0,
):
    """Single-token attention over a (possibly sequence-sharded) KV cache.

    q: (B,H,hd); k_cache,v_cache: (B,L,Kh,hd); kv_positions: (B,L)
    absolute positions of cache slots (negative = empty); q_position:
    (B,). Returns (out_local (B,H,hd), lse (B,H))."""
    b, h, hd = q.shape
    kh = k_cache.shape[2]
    rep = h // kh
    scale = 1.0 / math.sqrt(hd)

    qt = (q * scale).reshape(b, kh, rep, hd).float()
    kt = k_cache.permute(0, 2, 1, 3).float()  # (B,Kh,L,hd)
    vt = v_cache.permute(0, 2, 1, 3).float()

    logits = torch.einsum("bkrd,bkld->bkrl", qt, kt)
    mask = (kv_positions >= 0) & (kv_positions <= q_position[:, None])
    if window:
        mask &= q_position[:, None] - kv_positions < window
    logits = torch.where(mask[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    denom = p.sum(dim=-1)
    out = torch.einsum("bkrl,bkld->bkrd", p, vt)
    out = out / torch.clamp(denom, min=1e-30)[..., None]
    empty = denom <= 0.0
    lse = torch.where(
        empty, torch.full_like(m, NEG_INF), m + torch.log(torch.clamp(denom, min=1e-30))
    )
    return out.reshape(b, h, hd).to(q.dtype), lse.reshape(b, h)


def combine_partials(outs, lses) -> torch.Tensor:
    """Combine shard partials in rank order. outs: sequence of (B,H,hd),
    lses: sequence of (B,H) — the deterministic in-process counterpart of
    the psum-LSE reduction (``execution._attn_decode_cache``)."""
    m = lses[0]
    for l in lses[1:]:
        m = torch.maximum(m, l)
    num = None
    den = None
    for o, l in zip(outs, lses):
        w = torch.exp(l - m)
        term = o.float() * w[..., None]
        num = term if num is None else num + term
        den = w if den is None else den + w
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(outs[0].dtype)
