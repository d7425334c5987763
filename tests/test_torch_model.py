"""The port's DWDP, DEP and hybrid forwards at logical mesh (1, 4) against
the JAX package's replicated forward at (1, 1), on the same weights.

DWDP moves weights, not results, so the four logical ranks — split banks,
rotated orders, sequence-sharded prefill and KV cache, LSE combine,
vocab-sharded head — must reproduce the one-device math. DEP moves the
activations instead — tensor-parallel attention and FFN, the experts'
all-to-all, merged or qgather decode attention — and at (1, 1) the JAX
package's DEP computes exactly its DWDP (nothing is gathered), so both are
held to the same (1, 1) outputs, computed once for the module. A DEP
decode starts from a DWDP prefill's state, as the reference's default
serving pairs them (DEP's prefill captures no KV). Tolerance: fp32,
atol = rtol = 1e-4 (two frameworks sum in different orders). Both sides
run with capacity_factor = E / top_k, so no token is ever dropped in
either layout.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ArchConfig as JArch
from repro.configs.base import InputShape as JShape
from repro.configs.base import MoEConfig as JMoE
from repro.core import execution as jexec
from repro.core import strategy as jstrategy
from repro.launch.mesh import make_smoke_mesh
from repro.models.transformer import build_model as jbuild_model
from repro_torch.checkpoint.convert import from_jax_params
from repro_torch.configs.base import ArchConfig, InputShape, MoEConfig
from repro_torch.core import execution, strategy
from repro_torch.models.transformer import build_model

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

ATOL = RTOL = 1e-4
GEOM = dict(shard_attention=True, expert_axes=("model",), moe_exec="gather")
# vocab divisible by 4 (identical canonical values at (1,1) and (1,4));
# E = 8, top_k = 2 (2 local experts per rank, rotation exercised); 2 kv
# heads (kv_shard 2: the KV de-duplication path); a shared expert; a
# dense first layer and an MoE second layer.
FIELDS = dict(name="tiny-moe", family="moe", num_layers=2, d_model=64, num_heads=4,
              num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
MOE = dict(num_experts=8, top_k=2, d_ff=32, shared_d_ff=32, first_dense=1)
CAP = MOE["num_experts"] / MOE["top_k"]
PROMPT, CACHE = 16, 24


MODES = ("dwdp", "dep", "hybrid")
DECODE_STEPS = 6


def _jax_step(jm1, mesh, shape, **kw):
    xp = jstrategy.make_execution_plan(jm1, shape, {"data": 1, "model": 1}, capacity_factor=CAP)
    return jexec.make_step_fn(jm1, xp, mesh, **kw)


@pytest.fixture(scope="module")
def setup():
    """The weights in both packages, the prompts, and the JAX package's
    (1, 1) prefill logits and greedy decode tokens (computed once)."""
    jcfg = JArch(**FIELDS, moe=JMoE(**MOE))
    cfg = ArchConfig(**FIELDS, moe=MoEConfig(**MOE))
    jm1 = jbuild_model(jcfg, {"data": 1, "model": 1}, dtype=jnp.float32)
    key = jax.random.key(3)
    jparams1 = jm1.init_params(key)
    jm4 = jbuild_model(jcfg, {"data": 1, "model": 4}, dtype=jnp.float32, **GEOM)
    jparams4 = jax.tree.map(np.asarray, jm4.init_params(key))
    model = build_model(cfg, {"data": 1, "model": 4}, device="cpu", **GEOM)
    assert model.geom.kv_shard == 2 and model.geom.moe_placement.local_count == 2
    assert model.geom.attn_tp_ok and model.geom.ffn_axes == ("model",)
    params = from_jax_params(jparams4, model)
    mesh = make_smoke_mesh()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT) for _ in range(2)]

    prefill = _jax_step(jm1, mesh, JShape("p", PROMPT, 1, "prefill"), capture_len=CACHE)
    jouts = [prefill(jparams1, {"tokens": jnp.asarray(t[None], jnp.int32)}) for t in prompts]
    jstate = jax.tree.map(lambda *xs: jnp.concatenate(xs, 0), *[o["state"] for o in jouts])
    jtok = jnp.asarray([[int(np.argmax(o["last_logits"][0]))] for o in jouts], jnp.int32)
    decode = _jax_step(jm1, mesh, JShape("g", CACHE, 2, "decode"))
    jtoks = []
    for _ in range(DECODE_STEPS):
        jo = decode(jparams1, {"token": jtok}, jstate)
        jtok, jstate = jo["next_token"], jo["state"]
        jtoks.append(np.asarray(jtok)[:, 0])
    return dict(model=model, params=params, prompts=prompts, cfg=cfg,
                logits=[np.asarray(o["last_logits"]) for o in jouts],
                first=np.asarray([int(np.argmax(o["last_logits"][0])) for o in jouts]),
                tokens=np.stack(jtoks))


def _port_prefill(s, toks, mode="dwdp"):
    xp = strategy.make_execution_plan(
        s["model"], InputShape("p", PROMPT, 1, "prefill"), {"data": 1, "model": 4},
        mode=mode, capacity_factor=CAP)
    assert xp.seq_axes == ("model",)
    # DEP's tensor-parallel prefill attention captures no KV state
    ctx = execution.Ctx(model=s["model"], xp=xp, capture_len=0 if mode == "dep" else CACHE)
    return execution.forward_prefill(s["params"], torch.as_tensor(toks[None]), ctx)


def _port_decode(s, mode, decode_attn="gather"):
    """Greedy decode under ``mode`` from the prefill state of the context
    server that feeds it (DWDP for a DEP decode)."""
    touts = [_port_prefill(s, t, "dwdp" if mode == "dep" else mode) for t in s["prompts"]]
    tstate = {
        "pos": torch.cat([o["state"]["pos"] for o in touts]),
        "layers": {
            g: {key: [{f: torch.cat([o["state"]["layers"][g][key][r][f] for o in touts])
                       for f in ranks[0]} for r in range(len(ranks))]
                for key, ranks in gd.items()}
            for g, gd in touts[0]["state"]["layers"].items()
        },
    }
    ttok = torch.as_tensor([[int(o["last_logits"][0].argmax())] for o in touts])
    np.testing.assert_array_equal(ttok[:, 0].numpy(), s["first"])
    txp = strategy.make_execution_plan(
        s["model"], InputShape("g", CACHE, 2, "decode"), {"data": 1, "model": 4},
        mode=mode, capacity_factor=CAP, decode_attn=decode_attn)
    assert txp.seq_axes == ("model",) and not txp.batch_axes  # seq-sharded KV cache
    ctx = execution.Ctx(model=s["model"], xp=txp)
    ttoks = []
    for _ in range(DECODE_STEPS):
        to = execution.forward_decode(s["params"], ttok, tstate, ctx)
        ttok, tstate = to["next_token"].long(), to["state"]
        top2 = torch.topk(to["logits"][:, : s["cfg"].vocab_size], 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        assert margin > 10 * (ATOL + RTOL * top2[:, 0].abs().max().item()), margin
        ttoks.append(ttok[:, 0].numpy())
    return np.stack(ttoks)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_logits_match_jax(setup, mode):
    for toks, ref in zip(setup["prompts"], setup["logits"]):
        got = _port_prefill(setup, toks, mode)["last_logits"].numpy()
        assert got.shape == ref.shape == (1, 256)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_greedy_decode_tokens_match_jax(setup, mode):
    np.testing.assert_array_equal(_port_decode(setup, mode), setup["tokens"])


def test_dep_qgather_decode_matches_gather_tokens(setup):
    """DEP decode with the attention weights left sharded (q/k/v
    all-gathered) gives the gather-mode tokens — the JAX package's own
    ``test_decode_qgather_equivalence`` asserts them equal — and moves no
    weight: its wire-byte model is 0, the gather mode's the attention."""
    np.testing.assert_array_equal(_port_decode(setup, "dep", "qgather"), setup["tokens"])
    model = setup["model"]
    bytes_ = {
        da: execution.gathered_wire_bytes_per_step(model, strategy.make_execution_plan(
            model, InputShape("g", CACHE, 2, "decode"), {"data": 1, "model": 4}, mode="dep",
            decode_attn=da))["full"]
        for da in ("gather", "qgather")
    }
    assert bytes_["qgather"] == 0 < bytes_["gather"]


def test_dep_context_server_prefill_captures_no_state(setup):
    """A DEP prefill asked for a decode state refuses (the JAX package's
    tensor-parallel attention returns none); ``replicated`` is not ported."""
    s = setup
    xp = strategy.make_execution_plan(
        s["model"], InputShape("p", PROMPT, 1, "prefill"), {"data": 1, "model": 4}, mode="dep")
    assert not execution.captures_kv(s["model"].geom, xp)
    with pytest.raises(ValueError, match="captures no KV"):
        execution.forward_prefill(s["params"], torch.as_tensor(s["prompts"][0][None]),
                                  execution.Ctx(model=s["model"], xp=xp, capture_len=CACHE))
