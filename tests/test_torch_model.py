"""The port's DWDP forward at logical mesh (1, 4) against the JAX
package's replicated forward at (1, 1), on the same weights.

DWDP moves weights, not results, so the four logical ranks — split banks,
rotated orders, sequence-sharded prefill and KV cache, LSE combine,
vocab-sharded head — must reproduce the one-device math. Tolerance: fp32,
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


@pytest.fixture(scope="module")
def setup():
    jcfg = JArch(**FIELDS, moe=JMoE(**MOE))
    cfg = ArchConfig(**FIELDS, moe=MoEConfig(**MOE))
    jm1 = jbuild_model(jcfg, {"data": 1, "model": 1}, dtype=jnp.float32)
    key = jax.random.key(3)
    jparams1 = jm1.init_params(key)
    jm4 = jbuild_model(jcfg, {"data": 1, "model": 4}, dtype=jnp.float32, **GEOM)
    jparams4 = jax.tree.map(np.asarray, jm4.init_params(key))
    model = build_model(cfg, {"data": 1, "model": 4}, device="cpu", **GEOM)
    assert model.geom.kv_shard == 2 and model.geom.moe_placement.local_count == 2
    params = from_jax_params(jparams4, model)
    mesh = make_smoke_mesh()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT) for _ in range(2)]
    return dict(jm1=jm1, jparams1=jparams1, model=model, params=params, mesh=mesh,
                prompts=prompts, cfg=cfg)


def _jax_prefill(s, toks):
    xp = jstrategy.make_execution_plan(
        s["jm1"], JShape("p", PROMPT, 1, "prefill"), {"data": 1, "model": 1},
        capacity_factor=CAP)
    step = jexec.make_step_fn(s["jm1"], xp, s["mesh"], capture_len=CACHE)
    return step(s["jparams1"], {"tokens": jnp.asarray(toks[None], jnp.int32)})


def _port_prefill(s, toks):
    xp = strategy.make_execution_plan(
        s["model"], InputShape("p", PROMPT, 1, "prefill"), {"data": 1, "model": 4},
        capacity_factor=CAP)
    assert xp.seq_axes == ("model",)
    ctx = execution.Ctx(model=s["model"], xp=xp, capture_len=CACHE)
    return execution.forward_prefill(s["params"], torch.as_tensor(toks[None]), ctx)


def test_prefill_logits_match_jax(setup):
    for toks in setup["prompts"]:
        ref = np.asarray(_jax_prefill(setup, toks)["last_logits"])
        got = _port_prefill(setup, toks)["last_logits"].numpy()
        assert got.shape == ref.shape == (1, 256)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_greedy_decode_tokens_match_jax(setup):
    s = setup
    jouts = [_jax_prefill(s, t) for t in s["prompts"]]
    touts = [_port_prefill(s, t) for t in s["prompts"]]
    jstate = jax.tree.map(lambda *xs: jnp.concatenate(xs, 0), *[o["state"] for o in jouts])
    tstate = {
        "pos": torch.cat([o["state"]["pos"] for o in touts]),
        "layers": {
            g: {key: [{f: torch.cat([o["state"]["layers"][g][key][r][f] for o in touts])
                       for f in ranks[0]} for r in range(len(ranks))]
                for key, ranks in gd.items()}
            for g, gd in touts[0]["state"]["layers"].items()
        },
    }
    jtok = jnp.asarray([[int(np.argmax(o["last_logits"][0]))] for o in jouts], jnp.int32)
    ttok = torch.as_tensor([[int(o["last_logits"][0].argmax())] for o in touts])
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))

    jxp = jstrategy.make_execution_plan(
        s["jm1"], JShape("g", CACHE, 2, "decode"), {"data": 1, "model": 1}, capacity_factor=CAP)
    jstep = jexec.make_step_fn(s["jm1"], jxp, s["mesh"])
    txp = strategy.make_execution_plan(
        s["model"], InputShape("g", CACHE, 2, "decode"), {"data": 1, "model": 4},
        capacity_factor=CAP)
    assert txp.seq_axes == ("model",) and not txp.batch_axes  # seq-sharded KV cache
    ctx = execution.Ctx(model=s["model"], xp=txp)
    jtoks, ttoks = [], []
    for _ in range(6):
        jo = jstep(s["jparams1"], {"token": jtok}, jstate)
        to = execution.forward_decode(s["params"], ttok, tstate, ctx)
        jtok, jstate = jo["next_token"], jo["state"]
        ttok, tstate = to["next_token"].long(), to["state"]
        top2 = torch.topk(to["logits"][:, : s["cfg"].vocab_size], 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        assert margin > 10 * (ATOL + RTOL * top2[:, 0].abs().max().item()), margin
        jtoks.append(np.asarray(jtok)[:, 0])
        ttoks.append(ttok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))
