"""DWDP execution on logical ranks: the port of the all-fetch path of
``repro.core.execution``.

The JAX package runs one SPMD program per rank inside ``shard_map``. The
port runs the same per-rank program for every logical rank of the
``model`` axis in one process, rank by rank, and implements each
cross-rank operation in process:

- an all-gather is a ``torch.cat`` in rank order;
- a psum is a sum in fixed rank order (deterministic);
- a remote pull of a split bank copies the peers' shards into the rank's
  landing buffer (``core.prefetch``), on a side CUDA stream, one unit of
  work ahead (:class:`BankPipeline` — the stand-in for the layer-ahead
  prefetch of ``_run_unrolled`` / ``_run_scan_group``), ordered with CUDA
  events.

Weights move, activations do not: each rank serves its own tokens (its
sequence shard in prefill, the replicated rows in decode) end to end,
running the split kernels straight off its (resident, remote) bank pair.
Ported: split ``attn_qkv`` / ``attn_out`` / ``dense_ffn`` /
``moe_experts`` banks under ``split:all:allgather``, prefill with
sequence sharding and KV capture, decode over a sequence-sharded KV
cache with an LSE combine, the vocab-sharded head with a cross-shard
argmax. Not ported yet: demand/predictive/sync-free fetch, the ring
transports, merged layouts, DEP, rotate execution, training.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import BlockKind
from repro_torch.core import prefetch
from repro_torch.core.placement import make_placement
from repro_torch.core.strategy import ExecutionPlan
from repro_torch.kernels import split_gemm as split_gemm_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import apply_rope, rms_norm, softcap
from repro_torch.models.transformer import AXIS_MODEL, Geometry, LayerSig, Model

PyTree = Any


@dataclasses.dataclass
class Ctx:
    model: Model
    xp: ExecutionPlan
    capture_len: int = 0       # prefill: also emit a decode state of this len
    impl: Optional[str] = None  # None: the per-device default; "torch": plain versions
    pos: Any = None            # decode: (B,) per-row positions
    q_offsets: tuple = ()      # prefill: global offset of each rank's seq slice

    @property
    def cfg(self):
        return self.model.cfg

    @property
    def geom(self) -> Geometry:
        return self.model.geom

    @property
    def decode(self) -> bool:
        return self.xp.phase == "decode"

    @property
    def dense_impl(self) -> str:
        return self.impl or split_gemm_lib.default_dense_impl(self.xp.phase, self.model.device)

    @property
    def moe_impl(self) -> str:
        return self.impl or "kernel"


# ==========================================================================
# Gather set + gather.
# ==========================================================================
def _axes_size(xp: ExecutionPlan, axes: tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        size *= xp.mesh_sizes.get(a, 1)
    return size


def _require_split(geom: Geometry, xp: ExecutionPlan, axes, what: str) -> None:
    """The port gathers only through split banks over the model axis."""
    if len(axes) != 1 or _axes_size(xp, axes) <= 1:
        raise NotImplementedError(
            f"{what} gathered over {axes}: only single-axis split banks are ported"
        )


def gather_set(sig: LayerSig, geom: Geometry, xp: ExecutionPlan) -> tuple[str, ...]:
    """Keys of a layer's param tree that the prefetch pipeline gathers
    (``execution.gather_set`` of the JAX package, all-fetch DWDP)."""
    out: list[str] = []
    if sig.kind not in (BlockKind.GLOBAL_ATTN, BlockKind.LOCAL_ATTN):
        raise NotImplementedError(f"block kind {sig.kind} is not ported yet")
    if geom.attn_axes:
        _require_split(geom, xp, geom.attn_axes, "attention")
        out.append("attn")
    if sig.is_moe:
        pl = geom.moe_placement
        assert pl is not None
        if pl.subgroup_size > 1:
            if geom.moe_exec != "gather":
                raise NotImplementedError(f"moe_exec={geom.moe_exec!r} is not ported yet")
            _require_split(geom, xp, geom.expert_axes, "experts")
            out.append("moe/experts")
        if sig.shared_d_ff and geom.ffn_axes:
            _require_split(geom, xp, geom.ffn_axes, "shared expert")
            out.append("moe/shared")
    elif sig.ffn_dim and geom.ffn_axes:
        _require_split(geom, xp, geom.ffn_axes, "dense FFN")
        out.append("ffn")
    return tuple(out)


def _leading_placement(shards: int):
    """One slice per rank (subgroup = the whole axis, local_count 1)."""
    return make_placement(shards, shards)


_ATTN_PARTS = (("qkv", ("wq", "wk", "wv")), ("out", ("wo",)))


def gather_attn(lps: list[dict], geom: Geometry, copy_stream=None) -> list[prefetch.AttnBank]:
    """Every rank's attention banks as two families (qkv and out)."""
    pl = _leading_placement(geom.attn_shards)
    parts = {
        part: [{k: lp["attn"][k] for k in keys} for lp in lps]
        for part, keys in _ATTN_PARTS
    }
    return [
        prefetch.AttnBank(
            qkv=prefetch.gather_split_bank(parts["qkv"], r, pl, copy_stream=copy_stream),
            out=prefetch.gather_split_bank(parts["out"], r, pl, copy_stream=copy_stream),
        )
        for r in range(len(lps))
    ]


def gather_ffn(keys: tuple[str, ...], lps: list[dict], rank: int, geom: Geometry,
               copy_stream=None) -> dict:
    """One rank's FFN-side banks: ``ffn`` / ``moe/shared`` / ``moe/experts``."""
    out = {}
    for key in keys:
        if key == "ffn":
            shards, pl = [lp["ffn"] for lp in lps], _leading_placement(geom.ffn_shards)
        elif key == "moe/shared":
            shards, pl = [lp["moe"]["shared"] for lp in lps], _leading_placement(geom.ffn_shards)
        elif key == "moe/experts":
            shards, pl = [lp["moe"]["experts"] for lp in lps], geom.moe_placement
        else:
            continue
        out[key] = prefetch.gather_split_bank(shards, rank, pl, copy_stream=copy_stream)
    return out


class BankPipeline:
    """Issues each unit's remote pulls one unit ahead on a side stream.

    ``units`` is the ordered list of ``(key, thunk)`` a forward consumes;
    ``get(key)`` returns the unit's banks, first issuing the next unit so
    its copies overlap this unit's compute. Landing buffers are allocated
    on the consuming (current) stream, so the allocator reuses a dropped
    unit's memory in stream order; the side stream waits for an event
    recorded at allocation time before it writes, and the consumer waits
    for the side stream's event before it reads. At most two units are
    alive: the one in use and the one landing (callers drop a unit
    before asking for the next)."""

    def __init__(self, units: list, device: torch.device):
        self.units = units
        self.index = {key: i for i, (key, _) in enumerate(units)}
        self.device = device
        self.side = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.pending: dict[int, tuple] = {}

    def _issue(self, i: int) -> None:
        if i >= len(self.units) or i in self.pending:
            return
        thunk = self.units[i][1]
        if self.side is None:
            self.pending[i] = (thunk(None), None)
            return
        self.side.wait_stream(torch.cuda.current_stream(self.device))
        banks = thunk(self.side)
        landed = torch.cuda.Event()
        landed.record(self.side)
        self.pending[i] = (banks, landed)

    def get(self, key):
        i = self.index[key]
        self._issue(i)
        banks, landed = self.pending.pop(i)
        self._issue(i + 1)
        if landed is not None:
            torch.cuda.current_stream(self.device).wait_event(landed)
        return banks


# ==========================================================================
# Embedding / head.
# ==========================================================================
def _embed(params: list[dict], tokens: torch.Tensor, model: Model) -> torch.Tensor:
    """Row lookup over the vocab-sharded table: each token's row comes
    from the shard that owns it; the other shards add exact zeros (the
    JAX package's masked lookup + psum, summed in rank order)."""
    x = None
    for r, p in enumerate(params):
        emb = p["embed"]
        v_l = emb.shape[0]
        idx = tokens - r * v_l
        valid = (idx >= 0) & (idx < v_l)
        part = emb[idx.clamp(0, v_l - 1)].to(model.dtype) * valid[..., None].to(model.dtype)
        x = part if x is None else x + part
    return x


def _head(p: dict, cfg) -> torch.Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


def _rank_logits(h: torch.Tensor, p: dict, r: int, ctx: Ctx) -> torch.Tensor:
    """One rank's vocab-shard logits, padded vocab columns masked."""
    logits = (h @ _head(p, ctx.cfg)).float()
    logits = softcap(logits, ctx.cfg.logit_softcap)
    n = logits.shape[-1]
    cols = r * n + torch.arange(n, device=logits.device)
    return torch.where(cols < ctx.cfg.vocab_size, logits, torch.full_like(logits, -1e30))


# ==========================================================================
# Attention.
# ==========================================================================
def _project_heads(h, w, heads, head_dim):
    """h: (B,S,D); w: (A, D, dim/A) stacked -> (B,S,heads,head_dim)."""
    b, s, _ = h.shape
    out = torch.einsum("bsd,adh->bsah", h, w.to(h.dtype))
    return out.reshape(b, s, heads, head_dim)


def _attn_split_qkv(h, bank: prefetch.SplitBank, rank: int, ctx: Ctx):
    """q/k/v straight off a SplitBank. The kernel emits slices in rotated
    bank order; the roll back to canonical head order happens on the
    projected activations. KV slices are projected for all A positions
    and de-duplicated afterwards (``execution._attn_split_qkv``)."""
    cfg, geom = ctx.cfg, ctx.geom
    a = geom.attn_shards
    p = rank % a
    b, s, dm = h.shape
    h2d = h.reshape(b * s, dm).contiguous()
    canon = (torch.arange(a, device=h.device) - p) % a

    def stack(name):
        out = split_gemm_lib.split_stack_matmul(
            h2d, bank.local[name], bank.remote[name], impl=ctx.dense_impl
        )  # (A, T, fs) rotated
        return out.movedim(0, 1)[:, canon]  # (T, A, fs) canonical

    hd = cfg.head_dim
    q = stack("wq").reshape(b, s, cfg.num_heads, hd)
    dup = a // geom.kv_shard
    k = stack("wk")[:, ::dup].reshape(b, s, cfg.num_kv_heads, hd)
    v = stack("wv")[:, ::dup].reshape(b, s, cfg.num_kv_heads, hd)
    return q, k, v


def _attn_split_out(out, bank: prefetch.SplitBank, rank: int, ctx: Ctx):
    """Output projection off a SplitBank: roll the head slices into
    rotated bank order (activation side), then the reduce kernel sums the
    per-slice contributions."""
    a = ctx.geom.attn_shards
    p = rank % a
    b, s = out.shape[:2]
    rot = (torch.arange(a, device=out.device) + p) % a
    out = out.reshape(b, s, a, -1)[:, :, rot]
    out = out.reshape(b * s, a, -1).movedim(1, 0).contiguous()  # (A, T, fs)
    y = split_gemm_lib.split_reduce_matmul(
        out, bank.local["wo"], bank.remote["wo"], impl=ctx.dense_impl
    )
    return y.reshape(b, s, -1)


def _capture_kv_state(k, v, sig: LayerSig, ctx: Ctx, rank: int) -> dict:
    """Prefill K/V (already gathered over the sequence shards) -> the
    ring-buffer decode state slice owned by ``rank``
    (``execution._capture_kv_state``)."""
    xp = ctx.xp
    b, s = k.shape[0], k.shape[1]
    length = min(sig.window, ctx.capture_len) if sig.window else ctx.capture_len
    n_sh = xp.seq_shards if xp.seq_axes else 1
    if length % n_sh:
        raise ValueError(
            f"KV capture ring length {length} must divide over the {n_sh} "
            "sequence shards — pick a cache_len divisible by the shard count"
        )
    l_local = length // n_sh
    mine = rank if xp.seq_axes else 0
    l_idx = mine * l_local + torch.arange(l_local, device=k.device)
    pos_l = (s - 1) - ((s - 1 - l_idx) % length)
    valid = pos_l >= 0
    take = pos_l.clamp(0, s - 1)
    vmask = valid[None, :, None, None].to(k.dtype)
    return {
        "k": k[:, take] * vmask,
        "v": v[:, take] * vmask,
        "slot_pos": torch.where(valid, pos_l, torch.full_like(pos_l, -1))[None, :]
        .expand(b, l_local).to(torch.int32).contiguous(),
    }


def _attn_decode_partial(q, k_new, v_new, sig: LayerSig, ctx: Ctx, lstate: dict, rank: int):
    """Write each row's new token into this rank's slice of the ring,
    then attend over the slice: returns ((out, lse), new_state)."""
    xp = ctx.xp
    pos = ctx.pos
    l_local = lstate["k"].shape[1]
    n_sh = xp.seq_shards if xp.seq_axes else 1
    slot = pos % (l_local * n_sh)
    owner = slot // l_local
    li = slot % l_local
    mine = rank if xp.seq_axes else 0
    onehot = (torch.arange(l_local, device=pos.device)[None, :] == li[:, None]) & (
        owner == mine
    )[:, None]
    ck = torch.where(onehot[:, :, None, None], k_new.to(lstate["k"].dtype), lstate["k"])
    cv = torch.where(onehot[:, :, None, None], v_new.to(lstate["v"].dtype), lstate["v"])
    sp = torch.where(onehot, pos[:, None].to(torch.int32), lstate["slot_pos"])
    partial = attn_lib.mha_decode_partial(
        q[:, 0], ck.to(q.dtype), cv.to(q.dtype), sp, pos, window=sig.window
    )
    return partial, {"k": ck, "v": cv, "slot_pos": sp}


def _attn_layer(hs, lps, sig: LayerSig, ctx: Ctx, lstates, banks):
    """Attention for every rank: per-rank projections off the rank's
    banks, the cross-rank step (K/V all-gather in prefill, LSE combine in
    decode), per-rank output projections."""
    cfg, xp = ctx.cfg, ctx.xp
    n = len(hs)
    hd = cfg.head_dim
    qkv = []
    for r, h in enumerate(hs):
        if banks is not None:
            qkv.append(_attn_split_qkv(h, banks[r].qkv, r, ctx))
        else:
            aw = lps[r]["attn"]
            geom = ctx.geom
            dup = max(1, aw["wk"].shape[0] // geom.kv_shard)
            qkv.append((
                _project_heads(h, aw["wq"], cfg.num_heads, hd),
                _project_heads(h, aw["wk"][::dup], cfg.num_kv_heads, hd),
                _project_heads(h, aw["wv"][::dup], cfg.num_kv_heads, hd),
            ))
    new_states = lstates
    if ctx.decode:
        pos = ctx.pos
        partials, new_states = [], []
        for r, (q, k, v) in enumerate(qkv):
            q = apply_rope(q, pos[:, None], cfg.rope_theta)
            k = apply_rope(k, pos[:, None], cfg.rope_theta)
            part, st = _attn_decode_partial(q, k, v, sig, ctx, lstates[r], r)
            partials.append(part)
            new_states.append(st)
        if xp.seq_axes:
            out = attn_lib.combine_partials([o for o, _ in partials], [l for _, l in partials])
        else:
            out = partials[0][0]
        outs = [out[:, None]] * n
    else:
        qs, ks, vs = [], [], []
        for r, (q, k, v) in enumerate(qkv):
            b, s = q.shape[:2]
            posb = (ctx.q_offsets[r] + torch.arange(s, device=q.device)).expand(b, s)
            qs.append(apply_rope(q, posb, cfg.rope_theta))
            ks.append(apply_rope(k, posb, cfg.rope_theta))
            vs.append(v)
        k_all = torch.cat(ks, dim=1) if xp.seq_axes else ks[0]
        v_all = torch.cat(vs, dim=1) if xp.seq_axes else vs[0]
        outs = [
            attn_lib.mha_prefill(q, k_all, v_all, window=sig.window, q_offset=ctx.q_offsets[r])
            for r, q in enumerate(qs)
        ]
        if ctx.capture_len:
            new_states = [_capture_kv_state(k_all, v_all, sig, ctx, r) for r in range(n)]
    ys = []
    for r, out in enumerate(outs):
        if banks is not None:
            ys.append(_attn_split_out(out, banks[r].out, r, ctx))
        else:
            wo = lps[r]["attn"]["wo"]
            o = out.reshape(out.shape[0], out.shape[1], wo.shape[0], -1)
            ys.append(torch.einsum("bsag,agd->bsd", o, wo.to(o.dtype)))
    return ys, new_states


# ==========================================================================
# FFN (dense "virtual experts") + MoE.
# ==========================================================================
def _ffn_full(x2d, fp):
    """x2d: (T,D); fp stacked (S,D,F/S) full content (replicated layout)."""
    h = torch.nn.functional.silu(
        torch.einsum("td,sdf->tsf", x2d, fp["w_gate"].to(x2d.dtype))
    ) * torch.einsum("td,sdf->tsf", x2d, fp["w_up"].to(x2d.dtype))
    return torch.einsum("tsf,sfd->td", h, fp["w_down"].to(x2d.dtype))


def _ffn_apply(x2d, fp, ctx: Ctx, gathered=None):
    if not ctx.geom.ffn_axes:
        return _ffn_full(x2d, fp)
    assert isinstance(gathered, prefetch.SplitBank), "DWDP FFN weights must be prefetched"
    # y = sum_s swiglu_s(x) over (resident, remote) slice banks: the sum is
    # order-independent, so the rotated bank order needs no fix-up.
    lo, re = gathered.local, gathered.remote
    return split_gemm_lib.split_dense_ffn(
        x2d.contiguous(),
        lo["w_gate"], lo["w_up"], lo["w_down"],
        re["w_gate"], re["w_up"], re["w_down"],
        impl=ctx.dense_impl,
    )


def _rolled_dispatch(d: moe_lib.Dispatch, roll: int, e_pad: int, capacity: int):
    """Rotate the dispatch's expert coordinate by ``-roll`` so the rank's
    resident experts occupy positions [0, local) — the split banks'
    order. Only ``flat_slot`` moves."""
    exp = d.flat_slot // capacity
    slot = d.flat_slot - exp * capacity
    exp = (exp - roll) % e_pad
    return d._replace(flat_slot=exp * capacity + slot)


def _moe_apply(x2d, mp, ctx: Ctx, banks: dict, rows: int, rank: int):
    cfg, geom, xp = ctx.cfg, ctx.geom, ctx.xp
    moe = cfg.moe
    pl = geom.moe_placement
    assert moe is not None and pl is not None
    t = x2d.shape[0]
    e_pad = pl.num_padded
    if xp.capacity_from == "global":
        row_tokens = 1 if ctx.decode else xp.seq_len
        cap_row = moe_lib.capacity_for(row_tokens, moe.num_experts, moe.top_k, xp.capacity_factor)
        if not ctx.decode and xp.seq_shards > 1:
            cap_row = -(-cap_row // xp.seq_shards)
        cap = rows * cap_row
        d = moe_lib.route_topk_rows(
            x2d.reshape(rows, -1, x2d.shape[-1]), mp["router"], moe.top_k,
            cap_row, num_real=moe.num_experts,
        )
    else:
        cap = moe_lib.capacity_for(t, moe.num_experts, moe.top_k, xp.capacity_factor)
        d = moe_lib.route_topk(x2d, mp["router"], moe.top_k, cap, num_real=moe.num_experts)

    ex = mp["experts"]
    if pl.group_size == 1:
        xe = moe_lib.dispatch_tokens(x2d, d, e_pad, cap)
        ye = moe_lib.grouped_ffn(xe, ex["w_gate"], ex["w_up"], ex["w_down"])
    else:
        # §4.2 split path: tokens dispatch in rotated canonical order
        # (resident experts first); the kernel reads both banks by pointer.
        bank = banks["moe/experts"]
        roll = (rank % pl.subgroup_size) * pl.local_count
        d = _rolled_dispatch(d, roll, e_pad, cap)
        xe = moe_lib.dispatch_tokens(x2d, d, e_pad, cap)
        lo, re = bank.local, bank.remote
        ye = split_gemm_lib.split_swiglu(
            xe,
            lo["w_gate"], lo["w_up"], lo["w_down"],
            re["w_gate"], re["w_up"], re["w_down"],
            impl=ctx.moe_impl,
        )
    y = moe_lib.combine_tokens(ye, d, t)
    if "shared" in mp:
        y = y + _ffn_apply(x2d, mp["shared"], ctx, banks.get("moe/shared"))
    return y


# ==========================================================================
# One layer, the stack.
# ==========================================================================
def apply_layer(xs, lps, sig: LayerSig, ctx: Ctx, lstates, pipe: BankPipeline, lid):
    """One layer for every rank. ``lid`` names the layer's pipeline units."""
    eps = ctx.cfg.norm_eps
    keys = gather_set(sig, ctx.geom, ctx.xp)
    hs = [rms_norm(x, lp["norm1"], eps) for x, lp in zip(xs, lps)]
    attn_banks = pipe.get(("attn", lid)) if "attn" in keys else None
    outs, new_states = _attn_layer(hs, lps, sig, ctx, lstates, attn_banks)
    del attn_banks
    xs = [x + o for x, o in zip(xs, outs)]
    if "norm2" in lps[0]:
        ffn_keys = tuple(k for k in keys if k != "attn")
        for r, lp in enumerate(lps):
            h2 = rms_norm(xs[r], lp["norm2"], eps)
            b, s, dm = h2.shape
            h2f = h2.reshape(b * s, dm)
            banks = pipe.get(("ffn", lid, r)) if ffn_keys else {}
            if sig.is_moe:
                y = _moe_apply(h2f, lp["moe"], ctx, banks, rows=b, rank=r)
            else:
                y = _ffn_apply(h2f, lp["ffn"], ctx, banks.get("ffn"))
            del banks  # the next rank's unit lands in this one's place
            xs[r] = xs[r] + y.reshape(b, s, dm)
    return xs, new_states


def _index(tree, c):
    return prefetch.tree_map(lambda t: t[c], tree)


def _layer_walk(model: Model):
    """(group, cycle, position, sig) in execution order."""
    for group in model.plan:
        for c in range(group.n_cycles):
            for j, sig in enumerate(group.sigs):
                yield group, c, j, sig


def _layer_params(params, group, c, j) -> list[dict]:
    lps = [p["layers"][group.name][f"pos{j}"] for p in params]
    return [_index(lp, c) for lp in lps] if group.scan else lps


def _pipeline_units(params, ctx: Ctx) -> list:
    units = []
    geom, xp = ctx.geom, ctx.xp
    for group, c, j, sig in _layer_walk(ctx.model):
        keys = gather_set(sig, geom, xp)
        if not keys:
            continue
        lid = (group.name, c, j)
        lps = _layer_params(params, group, c, j)
        if "attn" in keys:
            units.append((("attn", lid), lambda st, lps=lps: gather_attn(lps, geom, st)))
        ffn_keys = tuple(k for k in keys if k != "attn")
        if ffn_keys:
            for r in range(len(params)):
                units.append((
                    ("ffn", lid, r),
                    lambda st, lps=lps, r=r, ks=ffn_keys: gather_ffn(ks, lps, r, geom, st),
                ))
    return units


def _run_stack(params, xs, ctx: Ctx, states):
    """The layer stack (scan groups become a Python loop over cycles)."""
    model = ctx.model
    pipe = BankPipeline(_pipeline_units(params, ctx), model.device)
    new_layers: dict = {}
    for group, c, j, sig in _layer_walk(model):
        lps = _layer_params(params, group, c, j)
        lstates = None
        if states is not None:
            lstates = states["layers"][group.name][f"pos{j}"]
            if group.scan:
                lstates = [_index(st, c) for st in lstates]
        xs, ns = apply_layer(xs, lps, sig, ctx, lstates, pipe, (group.name, c, j))
        if ns is not None:
            gd = new_layers.setdefault(group.name, {})
            if group.scan:
                gd.setdefault(f"pos{j}", []).append(ns)
            else:
                gd[f"pos{j}"] = ns
    for group in model.plan:
        if group.scan and group.name in new_layers:
            for key, cycles in new_layers[group.name].items():
                new_layers[group.name][key] = [
                    {f: torch.stack([cyc[r][f] for cyc in cycles]) for f in cycles[0][r]}
                    for r in range(len(cycles[0]))
                ]
    return xs, new_layers


def _check_sharding(ctx: Ctx) -> None:
    xp, n = ctx.xp, ctx.model.n_ranks
    if n > 1 and xp.seq_axes != (AXIS_MODEL,):
        raise NotImplementedError(
            f"the port runs the model axis as a sequence axis (got batch "
            f"{xp.batch_axes}, seq {xp.seq_axes}); batch-sharded plans are not ported"
        )


# ==========================================================================
# Phase entry points.
# ==========================================================================
@torch.no_grad()
def forward_prefill(params: list[dict], tokens: torch.Tensor, ctx: Ctx) -> dict:
    """tokens: (B, S) -> {"last_logits": (B, vocab_pad) f32[, "state"]}.

    Each rank holds S / G tokens of the sequence (``_positions_offset``);
    the last token's hidden state comes from the last shard."""
    _check_sharding(ctx)
    n = ctx.model.n_ranks
    b, s = tokens.shape
    if s % n:
        raise ValueError(f"prompt length {s} must divide over the {n} sequence shards")
    s_l = s // n
    ctx.q_offsets = tuple(r * s_l for r in range(n))
    xs = [_embed(params, tokens[:, r * s_l:(r + 1) * s_l], ctx.model) for r in range(n)]
    xs, new_states = _run_stack(params, xs, ctx, None)
    xl = rms_norm(xs[-1], params[-1]["final_norm"], ctx.cfg.norm_eps)[:, -1]
    logits = torch.cat([_rank_logits(xl, p, r, ctx) for r, p in enumerate(params)], dim=-1)
    out = {"last_logits": logits}
    if ctx.capture_len:
        out["state"] = {
            "pos": torch.full((b,), s, dtype=torch.int32, device=tokens.device),
            "layers": new_states,
        }
    return out


@torch.no_grad()
def forward_decode(params: list[dict], token: torch.Tensor, state: dict, ctx: Ctx) -> dict:
    """token: (B, 1) -> {"next_token": (B, 1), "state", "logits": (B, vocab_pad)}.

    The rows are replicated over the ranks; each rank runs them through
    its own banks and attends over its slice of the KV ring; the greedy
    token is the argmax across the vocab shards."""
    _check_sharding(ctx)
    n = ctx.model.n_ranks
    ctx.pos = state["pos"]
    x = _embed(params, token, ctx.model)
    xs, new_layers = _run_stack(params, [x] * n, ctx, state)
    vals, idxs, logits = [], [], []
    for r, (x, p) in enumerate(zip(xs, params)):
        h = rms_norm(x, p["final_norm"], ctx.cfg.norm_eps)[:, 0]
        lg = _rank_logits(h, p, r, ctx)
        logits.append(lg)
        vals.append(lg.amax(dim=-1))
        idxs.append(lg.argmax(dim=-1) + r * lg.shape[-1])
    best = torch.stack(vals).argmax(dim=0)
    nxt = torch.stack(idxs).gather(0, best[None])[0].to(torch.int32)
    new_state = {"pos": state["pos"] + 1, "layers": new_layers}
    return {"next_token": nxt[:, None], "state": new_state, "logits": torch.cat(logits, dim=-1)}
