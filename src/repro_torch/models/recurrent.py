"""RG-LRU recurrent block (RecurrentGemma / Griffin): the port of
``repro.models.recurrent``.

The diagonal linear recurrence h_t = a_t*h_{t-1} + b_t is evaluated in
fp32 by a log-depth Hillis-Steele scan over the sequence: ``ceil(log2 S)``
passes of ``(a, b) <- (a * a_shift, a * b_shift + b)``, the JAX package's
associative-scan combine. (A ``cumsum`` of ``log a`` would divide by a
cumulative decay that reaches ~1e-12 and is not stable.) The projections
stay outside the scan.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import causal_conv1d, normal_init

_RGLRU_C = 8.0


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t*h_{t-1} + b_t from h0 = 0 along dim 1:
    returns (A, h) with A_t = prod_{s<=t} a_s and h the zero-state
    solution."""
    s = a.shape[1]
    for p in range(math.ceil(math.log2(s)) if s > 1 else 0):
        d = 1 << p
        a_sh, b_sh = a[:, :-d], b[:, :-d]
        tail_a, tail_b = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], tail_a * b_sh + tail_b], dim=1)
        a = torch.cat([a[:, :d], tail_a * a_sh], dim=1)
    return a, b


def rglru_parts(x: torch.Tensor, w_r: torch.Tensor, w_i: torch.Tensor, a_param: torch.Tensor):
    """Real-Gated LRU pieces for h_t = a_t*h_{t-1} + b_t with h0 = 0.

    Returns (A, h_loc), both (B, S, D) fp32: A the cumulative decay
    prod_{s<=t} a_s and h_loc the zero-state solution. The recurrence is
    linear and diagonal, so the solution for any h0 is ``h_loc + A * h0``:
    the fix-up of a sequence-sharded prefill (``core.execution``)."""
    r = torch.sigmoid(x @ w_r)
    i = torch.sigmoid(x @ w_i)
    log_a = -_RGLRU_C * F.softplus(a_param.float()) * r.float()
    a = torch.exp(log_a)
    gated = (x * i).float()
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated
    return linear_scan(a, b)


def rglru(x: torch.Tensor, w_r: torch.Tensor, w_i: torch.Tensor, a_param: torch.Tensor,
          h0: torch.Tensor):
    """Real-Gated LRU. x: (B,S,D); h0: (B,D). Returns (y, h_last)."""
    A, h_loc = rglru_parts(x, w_r, w_i, a_param)
    h = h_loc + A * h0.float()[:, None]
    return h.to(x.dtype), h[:, -1].to(x.dtype)


def recurrent_block(x: torch.Tensor, p: dict, state: dict | None):
    """Griffin recurrent block: (linear->conv->RG-LRU) * gelu(linear) -> out.

    x: (B,S,D). state: {"conv": (B,K-1,D), "h": (B,D)} or None (zeros).
    Returns (out, new_state)."""
    b, _, d = x.shape
    if state is None:
        state = {
            "conv": torch.zeros(b, p["conv_w"].shape[0] - 1, d, dtype=x.dtype, device=x.device),
            "h": torch.zeros(b, d, dtype=x.dtype, device=x.device),
        }
    branch = x @ p["w_x"]
    branch, conv_state = causal_conv1d(branch, p["conv_w"], state["conv"])
    branch, h_last = rglru(branch, p["w_r"], p["w_i"], p["a_param"], state["h"])
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    out = (branch * gate) @ p["w_o"]
    return out, {"conv": conv_state, "h": h_last}


def init_recurrent_params(gen: torch.Generator, d_model: int, dtype, device,
                          conv_width: int = 4) -> dict:
    """The JAX package's shapes and scales, drawn from ``gen``: five (D, D)
    projections at D^-0.5, the conv taps [0, ..., 0, 1] and ``a_param`` (fp32)
    such that a = U[0.9, 0.999]^(1/c) (Griffin's init)."""
    s = d_model**-0.5
    out = {k: normal_init(gen, (d_model, d_model), s, dtype, device)
           for k in ("w_x", "w_gate", "w_o", "w_r", "w_i")}
    conv = torch.zeros(conv_width, d_model, dtype=dtype, device=device)
    conv[-1] = 1.0
    u = torch.rand(d_model, generator=gen, dtype=torch.float32, device=device) * 0.099 + 0.9
    out["conv_w"] = conv
    out["a_param"] = torch.log(torch.expm1(-torch.log(u) / _RGLRU_C))
    return out
