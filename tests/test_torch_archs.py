"""The architectures beyond DeepSeek-R1 and Gemma-3: the port against the JAX
package on the CPU, at reduced size, on the same weights.

- Configs: the eleven architectures field for field, their layer plans at
  full depth (Llama-4 Maverick's every-other-layer MoE with its dense
  width, RecurrentGemma's (RG-LRU, RG-LRU, local) cycle over 26 layers),
  the shapes; no compile.
- Units: ``causal_conv1d``, ``rglru`` (and the same sequence streamed in
  two halves), ``recurrent_block``, ``mlstm_block`` and ``slstm_block``
  against the JAX functions on numpy-seeded inputs, in one jitted JAX
  program: fp32, 1e-5 relative to max|ref|.
- RecurrentGemma (reduced, 4 layers: a scan group of two (RG-LRU, local)
  cycles; random conv taps, so the sequence-sharded halo counts): the
  port at (1, 4) with B = 1 shards the prompt over the ranks and runs the
  RG-LRU fix-up, and captures the fixed-up state; the JAX package at
  (1, 1) runs it unsharded (its sequence-sharded branch keeps no state).
  Prefill logits, the captured states, then 3 decode steps' tokens under
  dwdp, dep and hybrid, and the engine's admit / snapshot of the states.
- xLSTM (reduced: an mLSTM and an sLSTM layer), prefill and decode;
  Llama-4 Maverick (reduced: a dense and an MoE layer, every=2),
  prefill; MusicGen (reduced) through the ``embeds`` input, prefill.

Model logits: fp32, 1e-4 relative to max|ref| (tests/test_torch_model.py).
The JAX runs are one program each, shared through ``tests/torch_refs.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import recurrent as jrecurrent
from repro.models import xlstm as jxlstm
from repro.models.transformer import make_layer_plan as jplan
from repro_torch import configs
from repro_torch.checkpoint.convert import from_jax_params
from repro_torch.configs.base import InputShape
from repro_torch.core import execution, strategy
from repro_torch.models import cache, layers, recurrent, xlstm
from repro_torch.models.transformer import build_model, make_layer_plan
from repro_torch.runtime.engine import Request
from torch_refs import arch_run, jit_quick, recurrent_canonical, reduced_arch

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

UNIT_TOL = 1e-5
TOL = 1e-4
MESH4 = {"data": 1, "model": 4}
RG, RG_PROMPT, RG_CACHE, RG_STEPS = "recurrentgemma-2b", 32, 48, 3
XL, XL_PROMPT, XL_CACHE, XL_STEPS = "xlstm-350m", 16, 24, 3


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# --------------------------------------------------------------------------
# Configs and layer plans.
# --------------------------------------------------------------------------
def test_configs_registry_and_plans_match_jax():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.get_shape("decode_32k").seq_len == 32_768
    for name, jcfg in jconfigs.ARCHS.items():
        cfg = configs.get_arch(name)
        assert [f.name for f in dataclasses.fields(cfg)] == \
            [f.name for f in dataclasses.fields(jcfg)], name
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        assert cfg.param_count() == jcfg.param_count(), name
        got = [(g.name, g.scan, g.n_cycles, g.first_layer,
                [(s.kind.value, s.window, s.is_moe, s.ffn_dim, s.shared_d_ff) for s in g.sigs])
               for g in make_layer_plan(cfg)]
        ref = [(g.name, g.scan, g.n_cycles, g.first_layer,
                [(s.kind.value, s.window, s.is_moe, s.ffn_dim, s.shared_d_ff) for s in g.sigs])
               for g in jplan(jcfg)]
        assert got == ref, name
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("nope")
    rg = make_layer_plan(configs.get_arch(RG))
    assert [(g.name, g.n_cycles, [s.kind.value for s in g.sigs]) for g in rg] == [
        ("body", 8, ["recurrent", "recurrent", "local_attn"]),
        ("suffix", 1, ["recurrent", "recurrent"])]
    mav = make_layer_plan(configs.get_arch("llama4-maverick-400b-a17b"))
    assert [(s.is_moe, s.ffn_dim) for s in mav[0].sigs] == [(False, 16384), (True, 0)]


# --------------------------------------------------------------------------
# Units against the JAX functions.
# --------------------------------------------------------------------------
B, S, D, H = 2, 21, 32, 4


@pytest.fixture(scope="module")
def units():
    """Numpy-seeded inputs and weights, and the JAX outputs of every unit
    from one jitted program."""
    rng = np.random.default_rng(29)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    conv_state = rng.standard_normal((B, 3, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    rec = recurrent_canonical(rng, "recurrent", D, H)["rec"]
    ml = recurrent_canonical(rng, "mlstm", D, H)["cell"]
    sl = recurrent_canonical(rng, "slstm", D, H)["cell"]
    mstate = {"C": rng.standard_normal((B, H, D // H, D // H)).astype(np.float32) * 0.1,
              "n": rng.standard_normal((B, H, D // H)).astype(np.float32) * 0.1,
              "m": rng.standard_normal((B, H)).astype(np.float32)}
    sstate = {k: rng.standard_normal((B, D)).astype(np.float32) for k in "cnhm"}
    sstate["n"] = np.abs(sstate["n"]) + 0.5

    @jit_quick
    def ref(x, conv_state, h0, rec, ml, mstate, sl, sstate):
        return {
            "conv": jlayers.causal_conv1d(x, rec["conv_w"], conv_state),
            "rglru": jrecurrent.rglru(x, rec["w_r"], rec["w_i"], rec["a_param"], h0),
            "rec": jrecurrent.recurrent_block(x, rec, {"conv": conv_state, "h": h0}),
            "mlstm": jxlstm.mlstm_block(x, ml, mstate),
            "mlstm0": jxlstm.mlstm_block(x, ml, None),
            "slstm": jxlstm.slstm_block(x, sl, sstate),
        }

    inputs = dict(x=x, conv_state=conv_state, h0=h0, rec=rec, ml=ml, mstate=mstate, sl=sl,
                  sstate=sstate)
    out = jax.tree.map(np.asarray, ref(**inputs))
    t = jax.tree.map(torch.from_numpy, inputs)
    return dict(ref=out, t=t)


def _close_tree(got, ref, tol=UNIT_TOL):
    for k in ref:
        assert _rel(got[k].numpy(), ref[k]) <= tol, k


def test_causal_conv1d_and_rglru_match_jax(units):
    t, ref = units["t"], units["ref"]
    out, st = layers.causal_conv1d(t["x"], t["rec"]["conv_w"], t["conv_state"])
    assert _rel(out, ref["conv"][0]) <= UNIT_TOL and _rel(st, ref["conv"][1]) == 0
    p = t["rec"]
    y, h_last = recurrent.rglru(t["x"], p["w_r"], p["w_i"], p["a_param"], t["h0"])
    assert _rel(y, ref["rglru"][0]) <= UNIT_TOL and _rel(h_last, ref["rglru"][1]) <= UNIT_TOL
    # streamed: the first 8 tokens, then the rest from the state they leave
    y1, h1 = recurrent.rglru(t["x"][:, :8], p["w_r"], p["w_i"], p["a_param"], t["h0"])
    y2, h2 = recurrent.rglru(t["x"][:, 8:], p["w_r"], p["w_i"], p["a_param"], h1)
    assert _rel(torch.cat([y1, y2], 1), y) <= UNIT_TOL and _rel(h2, h_last) <= UNIT_TOL
    # the scan against a plain loop over tokens
    a, b = torch.rand(B, S, D) * 0.9 + 0.05, torch.randn(B, S, D)
    big_a, hs = recurrent.linear_scan(a, b)
    h, prod = torch.zeros(B, D), torch.ones(B, D)
    for i in range(S):
        h, prod = a[:, i] * h + b[:, i], prod * a[:, i]
        assert _rel(hs[:, i], h) <= UNIT_TOL and _rel(big_a[:, i], prod) <= UNIT_TOL


def test_recurrent_and_xlstm_blocks_match_jax(units):
    t, ref = units["t"], units["ref"]
    out, st = recurrent.recurrent_block(t["x"], t["rec"], {"conv": t["conv_state"],
                                                           "h": t["h0"]})
    assert _rel(out, ref["rec"][0]) <= UNIT_TOL
    _close_tree(st, ref["rec"][1])
    for key, state in (("mlstm", {k: v.clone() for k, v in t["mstate"].items()}),
                       ("mlstm0", None)):
        out, st = xlstm.mlstm_block(t["x"], t["ml"], state)
        assert _rel(out, ref[key][0]) <= UNIT_TOL, key
        _close_tree(st, ref[key][1])
    out, st = xlstm.slstm_block(t["x"], t["sl"], dict(t["sstate"]))
    assert _rel(out, ref["slstm"][0]) <= UNIT_TOL
    _close_tree(st, ref["slstm"][1])


# --------------------------------------------------------------------------
# Whole models at reduced size.
# --------------------------------------------------------------------------
def _port(name: str):
    w = reduced_arch(name)
    model = build_model(w["cfg"], MESH4, device="cpu", **w["geom"])
    return w, model, from_jax_params(w["jparams4"], model)


def _prefill(model, params, inputs, cache_len: int = 0, **plan):
    x = torch.as_tensor(inputs[None] if inputs.ndim == 1 else inputs)
    xp = strategy.make_execution_plan(model, InputShape("p", x.shape[1], 1, "prefill"), MESH4,
                                      **plan)
    return xp, execution.forward_prefill(params, x, execution.Ctx(model=model, xp=xp,
                                                                  capture_len=cache_len))


def _decode(model, params, out, cache_len: int, steps: int, mode: str = "dwdp") -> list:
    xp = strategy.make_execution_plan(model, InputShape("g", cache_len, 1, "decode"), MESH4,
                                      mode=mode)
    tok = out["last_logits"].argmax(-1, keepdim=True)
    state, toks = out["state"], []
    for _ in range(steps):
        o = execution.forward_decode(params, tok, state, execution.Ctx(model=model, xp=xp))
        tok, state = o["next_token"], o["state"]
        toks.append(int(tok[0, 0]))
    return toks


@pytest.fixture(scope="module")
def rg():
    w, model, params = _port(RG)
    ref = arch_run(RG, RG_PROMPT, RG_CACHE, RG_STEPS)
    xp, out = _prefill(model, params, ref["inputs"], RG_CACHE)
    assert xp.seq_axes == ("model",) and xp.seq_shards == 4  # 8 tokens a rank
    return dict(w=w, model=model, params=params, ref=ref, out=out)


def test_recurrentgemma_sharded_prefill_matches_jax_unsharded(rg):
    model, ref, out = rg["model"], rg["ref"], rg["out"]
    assert [g.name for g in model.plan] == ["body"] and model.plan[0].scan
    assert model.geom.cell_axes == () and model.geom.attn_axes == ()
    assert _rel(out["last_logits"].numpy(), ref["logits"]) <= TOL
    # the captured state: the RG-LRU's fixed-up conv inputs and h (every rank
    # the whole state), the local layer's ring (rank r its quarter)
    body = out["state"]["layers"]["body"]
    jbody = ref["state"]["layers"]["body"]
    for f in ("conv", "h"):
        for rank in body["pos0"]:
            assert _rel(rank[f].numpy(), jbody["pos0"][f]) <= TOL, f
    ring = torch.cat([r["k"] for r in body["pos1"]], dim=2).numpy()
    assert _rel(ring, jbody["pos1"]["k"]) <= TOL
    # the recurrent layer's weights are one tree every rank shares
    assert all(p["layers"]["body"]["pos0"]["rec"] is rg["params"][0]["layers"]["body"]["pos0"]["rec"]
               for p in rg["params"])


@pytest.mark.parametrize("mode", ["dwdp", "dep", "hybrid"])
def test_recurrentgemma_decode_from_captured_state_matches_jax(rg, mode):
    toks = _decode(rg["model"], rg["params"], rg["out"], RG_CACHE, RG_STEPS, mode)
    assert toks == rg["ref"]["tokens"]


def test_recurrentgemma_engine_admit_and_snapshot_carry_recurrent_state(rg):
    """The context server's captured state through ``admit`` and a
    ``snapshot_slot`` re-admitted into the other slot: the JAX tokens."""
    from repro_torch.launch.serve import build_engine

    w, ref = rg["w"], rg["ref"]
    eng, _ = build_engine(w["cfg"], mesh_shape=(1, 4), prefill_len=RG_PROMPT,
                          cache_len=RG_CACHE, max_batch=2, device="cpu", params=rg["params"],
                          geom_kwargs=w["geom"])
    eng.submit(Request(0, ref["inputs"], 1 + RG_STEPS))
    eng.run(RG_STEPS + 2)
    first = int(np.argmax(ref["logits"][0]))
    assert list(eng.outputs[0]) == [first] + ref["tokens"]
    gen = eng.gen
    first_tok, state = eng.ctx.prefill(eng.params, ref["inputs"])
    gen.admit(0, 7, first_tok, state)
    snap = gen.snapshot_slot(0)
    assert snap["layers"]["body"]["pos0"][0]["h"].shape == (2, 1, w["cfg"].d_model)
    gen.admit(1, 8, snap["token"], snap)
    tokens = gen.decode_step(eng.params)
    assert tokens[0] == tokens[1] == ref["tokens"][0]


def test_xlstm_prefill_and_decode_match_jax():
    w, model, params = _port(XL)
    ref = arch_run(XL, XL_PROMPT, XL_CACHE, XL_STEPS)
    xp, out = _prefill(model, params, ref["inputs"], XL_CACHE)
    assert xp.seq_axes == () and xp.batch_axes == ()  # replicated rows, as the reference
    assert _rel(out["last_logits"].numpy(), ref["logits"]) <= TOL
    for key, f in (("pos0", "C"), ("pos1", "c")):
        got = out["state"]["layers"]["body"][key][3][f].numpy()
        assert _rel(got, ref["state"]["layers"]["body"][key][f]) <= TOL, key
    assert _decode(model, params, out, XL_CACHE, XL_STEPS) == ref["tokens"]
    st = cache.init_decode_state(model, 2, XL_CACHE, seq_shards=4)
    assert st["layers"]["body"]["pos0"][0]["C"].shape == (2, 4, 64, 64)
    assert set(st["layers"]["body"]["pos1"][0]) == {"c", "n", "h", "m"}


def test_maverick_interleave_prefill_matches_jax():
    name = "llama4-maverick-400b-a17b"
    w, model, params = _port(name)
    assert [(s.is_moe, s.ffn_dim, s.shared_d_ff) for s in model.plan[0].sigs] == \
        [(False, 256, 0), (True, 0, 128)]
    cap = w["cfg"].moe.num_experts / w["cfg"].moe.top_k  # no token dropped
    ref = arch_run(name, 16, 0, 0, capacity_factor=cap)
    _, out = _prefill(model, params, ref["inputs"], capacity_factor=cap)
    assert _rel(out["last_logits"].numpy(), ref["logits"]) <= TOL


def test_musicgen_embeds_input_prefill_matches_jax():
    name = "musicgen-medium"
    w, model, params = _port(name)
    ref = arch_run(name, 16, 0, 0, embeds=True)
    xp, out = _prefill(model, params, ref["inputs"])
    assert xp.seq_axes == ("model",)
    assert _rel(out["last_logits"].numpy(), ref["logits"]) <= TOL


def test_port_init_builds_recurrent_weights_and_refuses_fp8():
    """``Model.init_params`` draws the rec / cell trees at the JAX package's
    shapes (``a_param`` in float32), leaves every rank shares; an fp8
    model with recurrent layers is refused, naming fp8."""
    for name in (RG, XL):
        w = reduced_arch(name)
        model = build_model(w["cfg"], MESH4, dtype=torch.bfloat16, device="cpu", **w["geom"])
        params = model.init_params(torch.Generator().manual_seed(0))
        jtree = w["jm1"].param_struct()["layers"]
        for group in model.plan:
            for key, lp in params[0]["layers"][group.name].items():
                mixer = "attn" if "attn" in lp else ("rec" if "rec" in lp else "cell")
                if mixer == "attn":
                    continue
                assert all(p["layers"][group.name][key][mixer][leaf] is t
                           for p in params for leaf, t in lp[mixer].items())
                for leaf, t in lp[mixer].items():
                    ref = jtree[group.name][key][mixer][leaf]
                    assert tuple(t.shape) == ref.shape, (name, leaf)
                    assert t.dtype == (torch.float32 if leaf == "a_param" else torch.bfloat16)
        fp8 = build_model(w["cfg"], MESH4, dtype=torch.float8_e4m3fn, device="cpu", **w["geom"])
        with pytest.raises(NotImplementedError, match="fp8"):
            strategy.make_execution_plan(fp8, InputShape("p", 16, 1, "prefill"), MESH4)
