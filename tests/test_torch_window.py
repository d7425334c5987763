"""Sliding-window serving: the port at logical mesh (1, 4) against the JAX
package at (1, 1), on the same weights, for a tiny configuration with
Gemma-3's features.

Dense family, a LOCAL_ATTN and a GLOBAL_ATTN layer per cycle (two cycles:
a scan group), tied embeddings and Gemma-3's RoPE base; the window (8) is
shorter than the prompt (16) and divides over the 4 ranks. Prefill runs
the window branch of flash attention (its plain version on the CPU) and
captures each local layer's ring of 8 slots, 2 per rank; greedy decode
runs 10 steps, so every local ring wraps past the prompt. Tolerance as in
tests/test_torch_model.py: fp32, 1e-4 relative to max|ref| for the logits.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import InputShape as JShape
from repro.core import execution as jexec
from repro.core import strategy as jstrategy
from repro.launch.mesh import make_smoke_mesh
from repro_torch.checkpoint.convert import from_jax_params
from repro_torch.configs.base import InputShape
from repro_torch.core import execution, strategy
from repro_torch.models.transformer import build_model
from torch_refs import WINDOW_GEOM, jit_quick, tiny_window

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

TOL = 1e-4
GEOM = WINDOW_GEOM
PROMPT, CACHE, STEPS = 16, 32, 10


@pytest.fixture(scope="module")
def setup():
    w = tiny_window()  # the weights, shared with tests/test_torch_data_parallel.py
    cfg, jm1, jparams1, jparams4 = w["cfg"], w["jm1"], w["jparams1"], w["jparams4"]
    model = build_model(cfg, {"data": 1, "model": 4}, device="cpu", **GEOM)
    assert model.geom.attn_shards == 4 and model.geom.ffn_shards == 4
    assert [(g.name, g.scan, g.n_cycles) for g in model.plan] == [("body", True, 2)]
    assert [s.window for s in model.plan[0].sigs] == [8, 0]
    params = from_jax_params(jparams4, model)
    assert "lm_head" not in params[0]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT) for _ in range(2)]
    return dict(jm1=jm1, jparams1=jparams1, model=model, params=params,
                mesh=make_smoke_mesh(), prompts=prompts, cfg=cfg)


def _jax_prefill(s, toks):
    """The JAX (1, 1) prefill; its step is built (and compiled) once for the
    module."""
    if "jprefill" not in s:
        xp = jstrategy.make_execution_plan(
            s["jm1"], JShape("p", PROMPT, 1, "prefill"), {"data": 1, "model": 1})
        s["jprefill"] = jit_quick(jexec.make_step_fn(s["jm1"], xp, s["mesh"], capture_len=CACHE))
    return s["jprefill"](s["jparams1"], {"tokens": jnp.asarray(toks[None], jnp.int32)})


def _port_prefill(s, toks):
    xp = strategy.make_execution_plan(
        s["model"], InputShape("p", PROMPT, 1, "prefill"), {"data": 1, "model": 4})
    assert xp.seq_axes == ("model",)
    ctx = execution.Ctx(model=s["model"], xp=xp, capture_len=CACHE)
    return execution.forward_prefill(s["params"], torch.as_tensor(toks[None]), ctx)


def _cat_layers(layers_list, model, cat, per_rank):
    """Stack two requests' captured states on the batch axis (axis 1 in a
    scan group, behind the cycle axis)."""
    out = {}
    for group in model.plan:
        ax = 1 if group.scan else 0
        gd = {}
        for key, first in layers_list[0][group.name].items():
            if per_rank:
                gd[key] = [{f: cat([ls[group.name][key][r][f] for ls in layers_list], ax)
                            for f in first[r]} for r in range(len(first))]
            else:
                gd[key] = {f: cat([ls[group.name][key][f] for ls in layers_list], ax)
                           for f in first}
        out[group.name] = gd
    return out


def test_window_prefill_logits_match_jax(setup):
    for toks in setup["prompts"]:
        ref = np.asarray(_jax_prefill(setup, toks)["last_logits"])
        got = _port_prefill(setup, toks)["last_logits"].numpy()
        assert got.shape == ref.shape == (1, 256)
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_window_greedy_decode_matches_jax(setup):
    s = setup
    model = s["model"]
    jouts = [_jax_prefill(s, t) for t in s["prompts"]]
    touts = [_port_prefill(s, t) for t in s["prompts"]]
    local = touts[0]["state"]["layers"]["body"]["pos0"]
    assert len(local) == 4 and local[0]["k"].shape[:3] == (2, 1, 2)  # cycles, batch, slots
    # the captured rings: rank r owns slots [r L/4, (r+1) L/4) of the JAX ring
    for jo, to in zip(jouts, touts):
        for key in ("pos0", "pos1"):
            ranks = to["state"]["layers"]["body"][key]
            ring = jo["state"]["layers"]["body"][key]
            for f in ("k", "v", "slot_pos"):
                got = torch.cat([r[f] for r in ranks], dim=2).numpy()
                ref = np.asarray(ring[f])
                assert got.shape == ref.shape, (key, f, got.shape, ref.shape)
                assert np.abs(got - ref).max() <= TOL * max(np.abs(ref).max(), 1), (key, f)
    jstate = {"pos": jnp.concatenate([o["state"]["pos"] for o in jouts]),
              "layers": _cat_layers([o["state"]["layers"] for o in jouts], model,
                                    jnp.concatenate, per_rank=False)}
    tstate = {"pos": torch.cat([o["state"]["pos"] for o in touts]),
              "layers": _cat_layers([o["state"]["layers"] for o in touts], model,
                                    torch.cat, per_rank=True)}
    jtok = jnp.asarray([[int(np.argmax(o["last_logits"][0]))] for o in jouts], jnp.int32)
    ttok = torch.as_tensor([[int(o["last_logits"][0].argmax())] for o in touts])
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))

    jxp = jstrategy.make_execution_plan(
        s["jm1"], JShape("g", CACHE, 2, "decode"), {"data": 1, "model": 1})
    jstep = jit_quick(jexec.make_step_fn(s["jm1"], jxp, s["mesh"]))
    txp = strategy.make_execution_plan(
        model, InputShape("g", CACHE, 2, "decode"), {"data": 1, "model": 4})
    assert txp.seq_axes == ("model",) and not txp.batch_axes  # seq-sharded KV rings
    ctx = execution.Ctx(model=model, xp=txp)
    jtoks, ttoks = [], []
    for _ in range(STEPS):
        jo = jstep(s["jparams1"], {"token": jtok}, jstate)
        to = execution.forward_decode(s["params"], ttok, tstate, ctx)
        jtok, jstate = jo["next_token"], jo["state"]
        ttok, tstate = to["next_token"].long(), to["state"]
        top2 = torch.topk(to["logits"][:, : s["cfg"].vocab_size], 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        assert margin > 10 * TOL * top2[:, 0].abs().max().item(), margin
        jtoks.append(np.asarray(jtok)[:, 0])
        ttoks.append(ttok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))
    # the local layers' rings wrapped: every slot holds a decoded position
    slots = torch.cat([r["slot_pos"] for r in tstate["layers"]["body"]["pos0"]], dim=-1)
    assert int(slots.min()) >= PROMPT + STEPS - 8
