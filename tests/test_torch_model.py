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

The gather-policy space runs against the same (1, 1) outputs: at (1, 1)
nothing is gathered, so the JAX package's outputs are the same for every
policy. The merged layout, the ring and ring_sliced transports (3 slices,
which divide no width of the model, so the count steps down), the JAX
package's MIXED table (demand-fetched split experts, merged attention,
a split-ring dense FFN; tests/test_multidevice.py), a per-layer-group
table and hybrid with merged dense families. Within the port, ring and
ring_sliced land the same bytes as allgather, and MIXED is its COMPOSED
table (demand -> all, ring -> allgather) with no overflow: those
outputs are held bitwise.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.convert import from_jax_params
from repro_torch.configs.base import InputShape
from repro_torch.core import execution, strategy
from repro_torch.models.transformer import build_model
from torch_refs import (
    MOE_CACHE, MOE_CAP, MOE_DECODE_STEPS, MOE_GEOM, MOE_PROMPT, tiny_moe, tiny_moe_run,
)

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

ATOL = RTOL = 1e-4
# The tiny MoE model (``torch_refs``): vocab divisible by 4, E = 8, top_k
# = 2, 2 kv heads, a shared expert, a dense first and an MoE second layer.
GEOM, CAP = MOE_GEOM, MOE_CAP
PROMPT, CACHE, DECODE_STEPS = MOE_PROMPT, MOE_CACHE, MOE_DECODE_STEPS


MODES = ("dwdp", "dep", "hybrid")
# The JAX package's MIXED / COMPOSED tables (tests/test_multidevice.py);
# budget 100 >= the 2 experts per rank: the demand path never overflows.
MIXED = {"moe_experts": "split:demand:allgather:4:100", "attn_qkv": "merged:all:allgather",
         "attn_out": "merged:all:allgather", "dense_ffn": "split:all:ring"}
COMPOSED = {"moe_experts": "split:all:allgather", "attn_qkv": "merged:all:allgather",
            "attn_out": "merged:all:allgather", "dense_ffn": "split:all:allgather"}
# the dense layer's FFN (group "prefix") merged, the MoE layer's shared
# expert (group "body") split over the ring
PER_GROUP = {"prefix/dense_ffn": "merged:all:allgather", "body/dense_ffn": "split:all:ring"}
# (mode, policy) cases: the modes' default tables, then the policy space
POLICY_CASES = [pytest.param(m, None, id=m) for m in MODES] + [
    pytest.param("dwdp", "merged:all:allgather", id="dwdp-merged"),
    pytest.param("dwdp", "split:all:ring", id="dwdp-ring"),
    pytest.param("dwdp", "split:all:ring_sliced", id="dwdp-ring_sliced"),
    pytest.param("dwdp", "merged:all:ring_sliced:3", id="dwdp-merged-ring_sliced-3"),
    pytest.param("dwdp", MIXED, id="dwdp-mixed"),
    pytest.param("dwdp", PER_GROUP, id="dwdp-per-group"),
    pytest.param("hybrid", {"attn_qkv": "merged", "attn_out": "merged", "dense_ffn": "merged"},
                 id="hybrid-merged-dense"),
]


@pytest.fixture(scope="module")
def setup():
    """The weights in both packages, the prompts, and the JAX package's
    (1, 1) prefill logits and greedy decode tokens (``torch_refs``, computed
    once per process)."""
    w = tiny_moe()  # the weights, shared with tests/test_torch_data_parallel.py
    model = build_model(w["cfg"], {"data": 1, "model": 4}, device="cpu", **GEOM)
    assert model.geom.kv_shard == 2 and model.geom.moe_placement.local_count == 2
    assert model.geom.attn_tp_ok and model.geom.ffn_axes == ("model",)
    run = tiny_moe_run()
    return dict(model=model, params=from_jax_params(w["jparams4"], model), cfg=w["cfg"],
                prompts=run["prompts"], logits=run["logits"], first=run["first"],
                tokens=run["tokens"])


def _once(s, key, run):
    """``run()``'s result, computed once per module for ``key``: several
    tests read the same port run (a policy's prefill feeds its decode, and
    the bitwise pairs compare runs the parity tests make), which is
    deterministic on the CPU."""
    runs = s.setdefault("runs", {})
    if key not in runs:
        runs[key] = run()
    return runs[key]


def _policy_key(policy):
    return json.dumps(policy, sort_keys=True)


def _port_prefill(s, toks, mode="dwdp", policy=None):
    def run():
        xp = strategy.make_execution_plan(
            s["model"], InputShape("p", PROMPT, 1, "prefill"), {"data": 1, "model": 4},
            mode=mode, capacity_factor=CAP, policy=policy)
        assert xp.seq_axes == ("model",)
        # DEP's tensor-parallel prefill attention captures no KV state
        ctx = execution.Ctx(model=s["model"], xp=xp, capture_len=0 if mode == "dep" else CACHE)
        return execution.forward_prefill(s["params"], torch.as_tensor(toks[None]), ctx)

    index = next(i for i, t in enumerate(s["prompts"]) if t is toks)
    return _once(s, ("prefill", index, mode, _policy_key(policy)), run)


def _port_decode(s, mode, decode_attn="gather", policy=None, logits=None):
    """Greedy decode under ``mode`` (and ``policy``, in prefill and decode)
    from the prefill state of the context server that feeds it (DWDP for a
    DEP decode); each step's logits are appended to ``logits`` when
    given."""
    steps = []
    toks = _once(s, ("decode", mode, decode_attn, _policy_key(policy)),
                 lambda: _greedy(s, mode, decode_attn, policy, steps))
    if logits is not None:
        logits.extend(s["runs"][("logits", mode, decode_attn, _policy_key(policy))])
    return toks


def _greedy(s, mode, decode_attn, policy, steps):
    touts = [_port_prefill(s, t, "dwdp" if mode == "dep" else mode, policy)
             for t in s["prompts"]]
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
        mode=mode, capacity_factor=CAP, decode_attn=decode_attn, policy=policy)
    assert txp.seq_axes == ("model",) and not txp.batch_axes  # seq-sharded KV cache
    ctx = execution.Ctx(model=s["model"], xp=txp)
    ttoks = []
    for _ in range(DECODE_STEPS):
        to = execution.forward_decode(s["params"], ttok, tstate, ctx)
        ttok, tstate = to["next_token"].long(), to["state"]
        steps.append(to["logits"])
        top2 = torch.topk(to["logits"][:, : s["cfg"].vocab_size], 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        assert margin > 10 * (ATOL + RTOL * top2[:, 0].abs().max().item()), margin
        ttoks.append(ttok[:, 0].numpy())
    s["runs"][("logits", mode, decode_attn, _policy_key(policy))] = steps
    return np.stack(ttoks)


@pytest.mark.parametrize("mode,policy", POLICY_CASES)
def test_prefill_logits_match_jax(setup, mode, policy):
    for toks, ref in zip(setup["prompts"], setup["logits"]):
        got = _port_prefill(setup, toks, mode, policy)["last_logits"].numpy()
        assert got.shape == ref.shape == (1, 256)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode,policy", POLICY_CASES)
def test_greedy_decode_tokens_match_jax(setup, mode, policy):
    np.testing.assert_array_equal(_port_decode(setup, mode, policy=policy), setup["tokens"])


@pytest.mark.parametrize("policy,same_as", [
    ("split:all:ring", "split:all:allgather"),
    ("split:all:ring_sliced", "split:all:allgather"),
    ("merged:all:ring_sliced:3", "merged:all:allgather"),
    (MIXED, COMPOSED),
], ids=["ring", "ring_sliced", "merged-ring_sliced-3", "mixed-composed"])
def test_policy_pairs_bitwise(setup, policy, same_as):
    """Transports land the same bytes at the same positions, and a demand
    fetch that never overflows runs the all-fetch kernels' math: prefill
    logits and every decode step's logits and tokens bitwise (the JAX
    package's MIXED == COMPOSED claim)."""
    runs = []
    for pol in (policy, same_as):
        prefill = [_port_prefill(setup, t, "dwdp", pol)["last_logits"] for t in setup["prompts"]]
        steps = []
        toks = _port_decode(setup, "dwdp", policy=pol, logits=steps)
        runs.append((prefill, steps, toks))
    (p1, s1, t1), (p2, s2, t2) = runs
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(t1, setup["tokens"])


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
