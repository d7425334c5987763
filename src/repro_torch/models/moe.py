"""MoE routing + grouped expert FFN (per-rank math, capacity dispatch).

The port of ``repro.models.moe``: dispatch scatters tokens into flat
(expert, slot) indices instead of a dense (T, E, C) one-hot, so memory
stays O(T*k + E*C*D). Cross-rank weight movement lives in
``repro_torch.core``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Dispatch(NamedTuple):
    flat_slot: torch.Tensor    # (T*k,) int64 index into (E*C) expert slots
    weight: torch.Tensor       # (T*k,) f32 combine weight (0 for dropped)
    keep: torch.Tensor         # (T*k,) bool
    gates: torch.Tensor        # (T, E) full softmax gates
    top_experts: torch.Tensor  # (T, k)


def capacity_for(tokens: int, num_experts: int, top_k: int, factor: float) -> int:
    cap = int(tokens * top_k / num_experts * factor) + 1
    if cap >= 8:
        return -(-cap // 8) * 8  # round up to a multiple of 8
    # decode-scale batches keep the exact count (no 8-slot floor)
    return cap


def route_topk(
    x: torch.Tensor, w_router: torch.Tensor, top_k: int, capacity: int,
    num_real: Optional[int] = None,
) -> Dispatch:
    """x: (T, D); w_router: (D, E). Experts >= num_real are padding slots
    of the placement and are masked out of routing."""
    e = w_router.shape[1]
    if w_router.dtype != x.dtype:
        w_router = w_router.to(x.dtype)
    logits = (x @ w_router).float()
    if num_real is not None and num_real < e:
        mask = torch.arange(e, device=x.device) < num_real
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    gates = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(gates, top_k, dim=-1)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)

    flat_exp = top_idx.reshape(-1)  # (T*k,) token-major priority
    oh = torch.nn.functional.one_hot(flat_exp, e)
    pos = ((torch.cumsum(oh, dim=0) - 1) * oh).sum(-1)  # slot within expert
    keep = pos < capacity
    flat_slot = flat_exp * capacity + torch.clamp(pos, max=capacity - 1)
    weight = top_vals.reshape(-1) * keep
    return Dispatch(flat_slot, weight, keep, gates, top_idx)


def route_topk_rows(
    x: torch.Tensor, w_router: torch.Tensor, top_k: int, capacity_per_row: int,
    num_real: Optional[int] = None,
) -> Dispatch:
    """Row-independent routing (``capacity_from == "global"``): x is
    (R, S, D); each row competes only with itself for its own
    ``capacity_per_row`` slots per expert. ``flat_slot`` indexes an
    ``(E, R * capacity_per_row)`` slot grid, row-major within an expert."""
    r, s, _ = x.shape
    e = w_router.shape[1]
    cap = capacity_per_row
    ds = [route_topk(x[i], w_router, top_k, cap, num_real=num_real) for i in range(r)]
    flat = torch.stack([d.flat_slot for d in ds])      # (R, S*k)
    exp = flat // cap
    pos = flat - exp * cap
    rows = torch.arange(r, device=x.device)[:, None]
    flat = exp * (r * cap) + rows * cap + pos
    return Dispatch(
        flat.reshape(-1),
        torch.stack([d.weight for d in ds]).reshape(-1),
        torch.stack([d.keep for d in ds]).reshape(-1),
        torch.stack([d.gates for d in ds]).reshape(r * s, e),
        torch.stack([d.top_experts for d in ds]).reshape(r * s, top_k),
    )


def dispatch_tokens(x: torch.Tensor, d: Dispatch, num_experts: int, capacity: int):
    """Scatter tokens into (E, C, D) expert batches. A kept slot receives
    exactly one token; dropped tokens add exact zeros, so the scatter is
    order-independent."""
    t, dm = x.shape
    k = d.flat_slot.shape[0] // t
    xk = torch.repeat_interleave(x, k, dim=0) * d.keep[:, None].to(x.dtype)
    xe = torch.zeros(num_experts * capacity, dm, dtype=x.dtype, device=x.device)
    xe.index_add_(0, d.flat_slot, xk)
    return xe.reshape(num_experts, capacity, dm)


def combine_tokens(ye: torch.Tensor, d: Dispatch, tokens: int) -> torch.Tensor:
    """Gather expert outputs back to (T, D) with combine weights."""
    e, c, dm = ye.shape
    k = d.flat_slot.shape[0] // tokens
    yk = ye.reshape(e * c, dm)[d.flat_slot] * d.weight[:, None].to(ye.dtype)
    return yk.reshape(tokens, k, dm).sum(dim=1)


def grouped_ffn(xe, w_gate, w_up, w_down):
    """Batched per-expert SwiGLU. xe: (E,C,D); w_*: (E,D,F)/(E,F,D)."""
    g = torch.bmm(xe, w_gate.to(xe.dtype))
    u = torch.bmm(xe, w_up.to(xe.dtype))
    h = torch.nn.functional.silu(g) * u
    return torch.bmm(h, w_down.to(xe.dtype))
