"""GQA attention: chunked prefill + cache decode with LSE (per-rank math).

The port of ``repro.models.attention``. Plain PyTorch, as the JAX engine
uses plain jnp here. ``mha_prefill`` keeps the block loop over KV blocks
with an online softmax, so a full-width prefill never forms the
(B, H, S, S) logits. Sequence-sharded decode returns ``(out, lse)``
pairs that ``combine_partials`` (or the engine's rank-ordered combine)
reduces.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def mha_prefill(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    q_offset: int = 0,
    kv_offset: int = 0,
    block_kv: int = 512,
) -> torch.Tensor:
    """Chunked causal attention. q: (B,Sq,H,hd); k,v: (B,Sk,Kh,hd).

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
