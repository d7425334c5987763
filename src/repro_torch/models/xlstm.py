"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory): the port
of ``repro.models.xlstm``.

Both use exponential gating with the log-space max stabiliser of the xLSTM
paper (arXiv:2405.04517). The projections run outside the time loop; the
recurrence is a plain loop over tokens, one step each, the JAX package's
``lax.scan`` step for step (fp32 state, the ``exp(-m)`` floor of the
mLSTM normaliser).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal_init as _normal


# --------------------------------------------------------------------------
# mLSTM: per-head matrix memory C (hd x hd).
# --------------------------------------------------------------------------
def mlstm_block(x: torch.Tensor, p: dict, state: dict | None):
    """x: (B,S,D). state: {"C": (B,H,hd,hd), "n": (B,H,hd), "m": (B,H)}."""
    b, s, d = x.shape
    heads = p["w_if"].shape[1] // 2
    hd = d // heads
    if state is None:
        state = init_mlstm_state(b, heads, hd, x.dtype, x.device)
    q = (x @ p["w_q"]).reshape(b, s, heads, hd).float()
    k = ((x @ p["w_k"]).reshape(b, s, heads, hd) * hd**-0.5).float()
    v = (x @ p["w_v"]).reshape(b, s, heads, hd).float()
    gates = x @ p["w_if"]  # (B,S,2H): [i_raw, f_raw]
    i_raw = gates[..., :heads].float()
    log_f = F.logsigmoid(gates[..., heads:].float())
    o_gate = torch.sigmoid(x @ p["w_og"])
    c, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(s):
        qt, kt, vt, it, lft = q[:, t], k[:, t], v[:, t], i_raw[:, t], log_f[:, t]
        m_new = torch.maximum(lft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(lft + m - m_new)
        c = f_p[..., None, None] * c + i_p[..., None, None] * (kt[..., :, None] * vt[..., None, :])
        n = f_p[..., None] * n + i_p[..., None] * kt
        num = torch.einsum("bhde,bhd->bhe", c, qt)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qt).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    h = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    out = (h * o_gate) @ p["w_out"]
    return out, {"C": c, "n": n, "m": m}


def init_mlstm_state(batch: int, heads: int, head_dim: int, dtype, device) -> dict:
    return {
        "C": torch.zeros(batch, heads, head_dim, head_dim, dtype=torch.float32, device=device),
        "n": torch.zeros(batch, heads, head_dim, dtype=torch.float32, device=device),
        "m": torch.zeros(batch, heads, dtype=torch.float32, device=device),
    }


def init_mlstm_params(gen: torch.Generator, d_model: int, heads: int, dtype, device) -> dict:
    s = d_model**-0.5
    out = {k: _normal(gen, (d_model, d_model), s, dtype, device) for k in ("w_q", "w_k", "w_v")}
    out["w_if"] = _normal(gen, (d_model, 2 * heads), s, dtype, device)
    out["w_og"] = _normal(gen, (d_model, d_model), s, dtype, device)
    out["w_out"] = _normal(gen, (d_model, d_model), s, dtype, device)
    return out


# --------------------------------------------------------------------------
# sLSTM: scalar memory with per-head block-diagonal recurrent weights;
# strictly sequential (h_{t-1} feeds the gates).
# --------------------------------------------------------------------------
def slstm_block(x: torch.Tensor, p: dict, state: dict | None):
    """x: (B,S,D). state: {"c","n","h","m": (B,D)}."""
    b, s, d = x.shape
    heads = p["r_z"].shape[0]
    hd = d // heads
    if state is None:
        state = init_slstm_state(b, d, x.dtype, x.device)
    zx, ix, fx, ox = (x @ p[f"w_{g}"] for g in "zifo")

    def rmul(h, r):  # per-head block-diagonal recurrent product
        return torch.einsum("bhd,hde->bhe", h.reshape(b, heads, hd), r).reshape(b, d)

    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(s):
        z = torch.tanh(zx[:, t] + rmul(h, p["r_z"])).float()
        i_raw = (ix[:, t] + rmul(h, p["r_i"])).float()
        f_raw = (fx[:, t] + rmul(h, p["r_f"])).float()
        o = torch.sigmoid(ox[:, t] + rmul(h, p["r_o"])).float()
        log_f = F.logsigmoid(f_raw)
        m_new = torch.maximum(log_f + m, i_raw)
        i_p = torch.exp(i_raw - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        h = (o * c / torch.clamp(n, min=1e-12)).to(x.dtype)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1) @ p["w_out"]
    return out, {"c": c, "n": n, "h": h, "m": m}


def init_slstm_state(batch: int, d_model: int, dtype, device) -> dict:
    return {
        "c": torch.zeros(batch, d_model, dtype=torch.float32, device=device),
        "n": torch.zeros(batch, d_model, dtype=torch.float32, device=device),
        "h": torch.zeros(batch, d_model, dtype=dtype, device=device),
        "m": torch.zeros(batch, d_model, dtype=torch.float32, device=device),
    }


def init_slstm_params(gen: torch.Generator, d_model: int, heads: int, dtype, device) -> dict:
    s = d_model**-0.5
    hd = d_model // heads
    out = {f"w_{g}": _normal(gen, (d_model, d_model), s, dtype, device) for g in "zifo"}
    out.update({f"r_{g}": _normal(gen, (heads, hd, hd), hd**-0.5, dtype, device) for g in "zifo"})
    out["w_out"] = _normal(gen, (d_model, d_model), s, dtype, device)
    return out
