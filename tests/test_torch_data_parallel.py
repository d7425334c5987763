"""Meshes with a data axis and batch-sharded plans on the port, against the
JAX package at (1, 1) on the same weights — the reference's own invariant
(tests/test_multidevice.py:1-4: every strategy on a sharded mesh matches
the one-device reference).

On (data=2, model=4) the port runs eight logical ranks, two data replicas
of a DWDP group of four: the weights are sharded over ``model`` and shared
by the replicas, the activations follow the plan's batch and sequence
axes over both.

- Prefill at S = 64: B = 8 on (2, 4) and B = 4 on (1, 4) shard the batch
  over ``model`` (each rank prefills whole sequences; the last logits meet
  the gathered head), B = 1 on (2, 4) shards the sequence over all eight
  ranks; modes dwdp, dep and hybrid on the tiny MoE model, dwdp and dep on
  the Gemma-3-like window model (tied embeddings: the gathered table).
  Relative error (max |got - ref| / max |ref|) < 2e-3, as
  test_multidevice.py:132.
- Decode, B = 4 on (2, 4): two rows per data replica, the KV ring over
  ``model``; DWDP in the four fetch modes, DEP with gather and qgather
  attention, hybrid: the greedy tokens of 3 steps equal JAX's (capacity
  factor E / top_k: no token drops in either layout).
- The engine at (2, 4), max-batch 4 (the context server shards one
  prompt over all eight ranks, the generation server its slots over the
  replicas, ``admit`` re-lays the ring out): every request's tokens equal
  the JAX engine's at (1, 1), DWDP and DEP generation.
- ``admit``'s re-layout, snapshots across meshes, the wire-byte model
  against the reference at (2, 4), and the refusals (a decode batch over
  ``model``, experts over several axes, the command line's pairs).

The JAX references run once per module; the weights and the JAX engine
come from ``torch_refs``, shared with test_torch_model, test_torch_window
and test_torch_engine.
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
from repro.models.transformer import build_model as jbuild_model
from repro_torch.checkpoint.convert import from_jax_params
from repro_torch.configs.base import InputShape
from repro_torch.core import execution, strategy
from repro_torch.core.placement import subgroup_positions
from repro_torch.launch import serve
from repro_torch.launch.serve import build_engine
from repro_torch.models import cache
from repro_torch.models.transformer import build_model
from repro_torch.runtime.engine import GenerationServer, Request
import torch_refs
from torch_refs import MOE_EXPERTS, MOE_GEOM, WINDOW_GEOM, jit_quick

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

S, CACHE, STEPS = 64, 72, 3       # CACHE divides over 8 ring shards
CAP = MOE_EXPERTS["num_experts"] / MOE_EXPERTS["top_k"]  # no drops
RELERR = 2e-3
MESH24, MESH14 = {"data": 2, "model": 4}, {"data": 1, "model": 4}
MODES = ("dwdp", "dep", "hybrid")
# decode plans at (2, 4): (mode, expert fetch, decode attention)
# (the fetch may also be a whole policy spec: the merged layout over the
# sliced ring, every family)
DECODES = [("dwdp", "all", "gather"), ("dwdp", "demand", "gather"),
           ("dwdp", "predictive", "gather"), ("dwdp", "sync_free", "gather"),
           ("dep", "all", "gather"), ("dep", "all", "qgather"), ("hybrid", "all", "gather"),
           ("dwdp", "merged:all:ring_sliced", "gather")]


def _jax_prefill(w, tokens, capture=0):
    xp = jstrategy.make_execution_plan(w["jm1"], JShape("p", tokens.shape[1], tokens.shape[0],
                                                        "prefill"),
                                       {"data": 1, "model": 1}, capacity_factor=CAP)
    step = jit_quick(jexec.make_step_fn(w["jm1"], xp, make_smoke_mesh(), capture_len=capture))
    return step(w["jparams1"], {"tokens": jnp.asarray(tokens, jnp.int32)})


def _port(w, geom, mesh):
    model = build_model(w["cfg"], mesh, device="cpu", **geom)
    return model, from_jax_params(w["jparams4"], model)


@pytest.fixture(scope="module")
def moe():
    """The tiny MoE model at (2, 4) and (1, 4), 8 prompts, and the JAX (1, 1)
    prefill logits of all 8 and greedy tokens of rows 0-3 over STEPS steps."""
    w = torch_refs.tiny_moe()
    tokens = np.random.default_rng(13).integers(0, w["cfg"].vocab_size, (8, S))
    out = _jax_prefill(w, tokens, capture=CACHE)
    state = jax.tree.map(lambda a: a[:4], out["state"])
    tok = jnp.argmax(out["last_logits"][:4], axis=-1).astype(jnp.int32)[:, None]
    xp = jstrategy.make_execution_plan(w["jm1"], JShape("g", CACHE, 4, "decode"),
                                       {"data": 1, "model": 1}, capacity_factor=CAP)
    decode = jit_quick(jexec.make_step_fn(w["jm1"], xp, make_smoke_mesh()))
    jtoks = []
    for _ in range(STEPS):
        o = decode(w["jparams1"], {"token": tok}, state)
        tok, state = o["next_token"], o["state"]
        jtoks.append(np.asarray(tok)[:, 0])
    m24, p24 = _port(w, MOE_GEOM, MESH24)
    m14, p14 = _port(w, MOE_GEOM, MESH14)
    return dict(w=w, tokens=tokens, logits=np.asarray(out["last_logits"]),
                first=np.asarray(jnp.argmax(out["last_logits"][:4], axis=-1)),
                jtoks=np.stack(jtoks), ports={(2, 4): (m24, p24), (1, 4): (m14, p14)})


@pytest.fixture(scope="module")
def window():
    """The Gemma-3-like window model at (2, 4) and (1, 4) and the JAX (1, 1)
    prefill logits of 8 prompts."""
    w = torch_refs.tiny_window()
    tokens = np.random.default_rng(17).integers(0, w["cfg"].vocab_size, (8, S))
    m24, p24 = _port(w, WINDOW_GEOM, MESH24)
    m14, p14 = _port(w, WINDOW_GEOM, MESH14)
    return dict(w=w, tokens=tokens, logits=np.asarray(_jax_prefill(w, tokens)["last_logits"]),
                ports={(2, 4): (m24, p24), (1, 4): (m14, p14)})


def _prefill(s, mesh, rows, mode, capture=0):
    """The port's prefill of ``rows`` on ``mesh``, run once per module for
    its arguments (every decode case starts from the same one; the runs are
    deterministic on the CPU and no test writes their outputs)."""
    key = (mesh, tuple(rows), mode, capture)
    runs = s.setdefault("runs", {})
    if key not in runs:
        model, params = s["ports"][mesh]
        sizes = {"data": mesh[0], "model": mesh[1]}
        xp = strategy.make_execution_plan(model, InputShape("p", S, len(rows), "prefill"),
                                          sizes, mode=mode, capacity_factor=CAP)
        ctx = execution.Ctx(model=model, xp=xp, capture_len=capture)
        runs[key] = xp, execution.forward_prefill(params, torch.as_tensor(s["tokens"][rows]), ctx)
    return runs[key]


def _relerr(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# (mesh, rows): the batch over data and model; over model; one row whose
# sequence shards over both axes
LAYOUTS = [((2, 4), list(range(8)), ("data", "model"), ()),
           ((1, 4), list(range(4)), ("model",), ()),
           ((2, 4), [5], (), ("data", "model"))]


@pytest.mark.parametrize("mode", MODES)
def test_moe_prefill_layouts_match_jax(moe, mode):
    for mesh, rows, batch_axes, seq_axes in LAYOUTS:
        xp, out = _prefill(moe, mesh, rows, mode)
        assert (xp.batch_axes, xp.seq_axes) == (batch_axes, seq_axes)
        got = out["last_logits"].numpy()
        assert got.shape == (len(rows), 256)
        assert _relerr(got, moe["logits"][rows]) < RELERR, (mesh, rows)


@pytest.mark.parametrize("mode", ("dwdp", "dep"))
def test_window_prefill_layouts_match_jax(window, mode):
    for mesh, rows, batch_axes, seq_axes in LAYOUTS:
        xp, out = _prefill(window, mesh, rows, mode)
        assert (xp.batch_axes, xp.seq_axes) == (batch_axes, seq_axes)
        assert _relerr(out["last_logits"].numpy(), window["logits"][rows]) < RELERR, (mesh, rows)


@pytest.mark.parametrize("mode,fetch,attn", DECODES)
def test_decode_on_two_data_replicas_matches_jax(moe, mode, fetch, attn):
    """B = 4 at (2, 4): the rows over ``data`` (2 per replica), the ring over
    ``model``. The state is the DWDP prefill's (a DEP decode is fed by a DWDP
    context server), captured at B = 4 in the decode layout."""
    model, params = moe["ports"][(2, 4)]
    pxp, out = _prefill(moe, (2, 4), list(range(4)), "dwdp", capture=CACHE)
    np.testing.assert_array_equal(out["last_logits"].argmax(-1).numpy(), moe["first"])
    policy = fetch if ":" in fetch else strategy.PolicyTable.uniform(fetch=fetch)
    xp = strategy.make_execution_plan(
        model, InputShape("g", CACHE, 4, "decode"), MESH24, mode=mode, capacity_factor=CAP,
        decode_attn=attn, policy=policy)
    assert (xp.batch_axes, xp.seq_axes) == (pxp.batch_axes, pxp.seq_axes) == (("data",), ("model",))
    assert execution.demand_fetch_active(model.cfg, model.geom, xp) == (
        fetch in strategy.EXPERT_FETCH[1:])
    state = {"pos": out["state"]["pos"], "layers": out["state"]["layers"]}
    state = execution.attach_predict_state(state, model, xp)
    tok = out["last_logits"].argmax(-1)[:, None]
    ctx = execution.Ctx(model=model, xp=xp)
    toks = []
    for _ in range(STEPS):
        o = execution.forward_decode(params, tok, state, ctx)
        tok, state = o["next_token"].long(), o["state"]
        toks.append(tok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(toks), moe["jtoks"])


def test_engine_on_two_data_replicas_matches_jax_engine():
    """Reduced DeepSeek-R1 at (2, 4), max-batch 4: the context server shards
    each 16-token prompt over all eight ranks, the generation server holds
    two slots per data replica; each request's tokens equal the JAX
    engine's at (1, 1) (no drops: E = top_k), with DWDP and with DEP
    generation."""
    cfg, _, jparams, prompts = torch_refs.r1_smoke()
    jeng = torch_refs.jax_serve()
    model = build_model(cfg, MESH24, device="cpu", **MOE_GEOM)
    params = from_jax_params(jparams, model)
    for gen_mode in ("dwdp", "dep"):
        eng, _ = build_engine(cfg, mesh_shape=(2, 4), prefill_len=torch_refs.R1_PROMPT,
                              cache_len=torch_refs.R1_CACHE, max_batch=4, gen_mode=gen_mode,
                              device="cpu", params=params, geom_kwargs=MOE_GEOM)
        assert eng.ctx.xp.seq_axes == ("data", "model")
        assert (eng.gen.xp.batch_axes, eng.gen.xp.seq_axes) == (("data",), ("model",))
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, torch_refs.R1_OUT))
        while eng.busy():
            eng.run(1)
        assert eng.outputs == jeng.outputs, gen_mode
        # a request is attributed a step's per-rank bytes over its own replica's slots
        assert eng.gen.step_shares([0, 1, 3]) == [0.5, 0.5, 1.0]


def test_admit_relayout_and_snapshot_refusal(moe):
    """One row prefilled on (2, 4) (its ring in 8 slices) admitted into slot
    3 of a (2, 4) server (data replica 1, the ring in 4 slices): every rank
    of replica 1 holds, for its ring slots, the positions and K/V that a
    (1, 4) prefill of the same row puts there (a third layout), and replica
    0 is untouched. A state without its ``"layout"`` is refused; a snapshot
    round-trips through another slot; a (1, 4) server refuses it."""
    model, params = moe["ports"][(2, 4)]
    _, out = _prefill(moe, (2, 4), [6], "dwdp", capture=CACHE)
    assert out["state"]["layout"].seq_shards == 8
    gen = GenerationServer(model, MESH24, max_batch=4, cache_len=CACHE, capacity_from="global")
    with pytest.raises(ValueError, match="layout"):  # a state without its layout
        gen.admit(3, 0, 7, {k: v for k, v in out["state"].items() if k != "layout"})
    gen.admit(3, 0, 7, out["state"])
    _, ref = _prefill(moe, (1, 4), [6], "dwdp", capture=CACHE)
    ring = cache.read_row(model, ref["state"]["layers"], ref["state"]["layout"], 0)
    for group in model.plan:
        for key, ranks in gen.state["layers"][group.name].items():
            n = ranks[0]["slot_pos"].shape[1]
            for r, entry in enumerate(ranks):
                want = {f: ring[group.name][key][f][r % 4 * n:(r % 4 + 1) * n] for f in entry}
                if r >= 4:  # replica 1: slot 3 is its local row 1
                    assert torch.equal(entry["slot_pos"][1], want["slot_pos"])
                    torch.testing.assert_close(entry["k"][1], want["k"], atol=1e-5, rtol=1e-5)
                    torch.testing.assert_close(entry["v"][1], want["v"], atol=1e-5, rtol=1e-5)
                else:
                    assert (entry["slot_pos"] == -1).all() and not entry["k"].any()
    assert gen.state["pos"].tolist() == [0, 0, 0, S] and gen.cur_token[3, 0] == 7
    snap = gen.snapshot_slot(3)
    gen.admit(0, 1, snap["token"], snap)
    back = cache.read_row(model, gen.state["layers"], gen.layout(), 0)
    same = cache.read_row(model, gen.state["layers"], gen.layout(), 3)
    assert all(torch.equal(back[g][k][f], same[g][k][f])
               for g in back for k in back[g] for f in back[g][k])
    m14, _ = moe["ports"][(1, 4)]
    other = GenerationServer(m14, MESH14, max_batch=2, cache_len=CACHE, capacity_from="global")
    with pytest.raises(ValueError, match="mesh"):
        other.admit(0, 1, snap["token"], snap)


def test_wire_bytes_match_reference_at_2x4(moe):
    """The static per-rank wire-byte model on (2, 4) plans (the context
    server's one-row prefill over eight shards, decode of two rows per
    replica under every fetch mode, DEP) equals the reference's."""
    model, _ = moe["ports"][(2, 4)]
    jm = jbuild_model(moe["w"]["jcfg"], MESH24, dtype=jnp.float32, **MOE_GEOM)
    for shape, mode, fetch in [(("p", S, 1, "prefill"), "dwdp", "all"),
                               *[(("g", CACHE, 4, "decode"), "dwdp", f)
                                 for f in ("all", "demand", "predictive", "sync_free")],
                               (("g", CACHE, 4, "decode"), "dep", "all")]:
        xp = strategy.make_execution_plan(model, InputShape(*shape), MESH24, mode=mode,
                                          policy=strategy.PolicyTable.uniform(fetch=fetch))
        jxp = jstrategy.make_execution_plan(jm, JShape(*shape), MESH24, mode=mode,
                                            policy=jstrategy.PolicyTable.uniform(fetch=fetch))
        assert (xp.batch_axes, xp.seq_axes) == (jxp.batch_axes, jxp.seq_axes)
        assert execution.gathered_wire_bytes_per_step(model, xp) == \
            jexec.gathered_wire_bytes_per_step(jm, jxp), (shape, mode, fetch)


def test_refusals(moe, monkeypatch):
    """A decode batch sharded over ``model`` raises ``ValueError`` naming the
    limit, in ``forward_decode``, the generation server and the command
    line (before any weight is drawn); experts over ("data", "model") stay
    refused; the weights of the two replicas are the same tensors."""
    model, params = moe["ports"][(2, 4)]
    xp = strategy.make_execution_plan(model, InputShape("g", CACHE, 8, "decode"), MESH24)
    assert xp.batch_axes == ("data", "model")
    state = cache.init_decode_state(model, 8, CACHE, batch_shards=8)
    with pytest.raises(ValueError, match="replicated over the"):
        execution.forward_decode(params, torch.zeros((8, 1), dtype=torch.long), state,
                                 execution.Ctx(model=model, xp=xp))
    with pytest.raises(ValueError, match="max_batch 8"):
        GenerationServer(model, MESH24, max_batch=8, cache_len=CACHE)
    # each rank's place in its expert subgroup: its model index
    assert subgroup_positions(MESH24, model.geom.expert_axes,
                              model.geom.moe_placement).tolist() == [0, 1, 2, 3] * 2

    def no_build(*a, **k):
        raise AssertionError("built a model for a refused pair")

    monkeypatch.setattr(serve, "build_model", no_build)
    cfg = moe["w"]["cfg"]
    for mesh, batch in (((2, 4), 8), ((1, 4), 4), ((0, 4), 2)):
        with pytest.raises(ValueError):
            build_engine(cfg, mesh_shape=mesh, max_batch=batch, device="cpu")
        with pytest.raises(SystemExit) as err:
            serve.main(["--arch", "deepseek-r1", "--device", "cpu", "--mesh",
                        ",".join(map(str, mesh)), "--max-batch", str(batch)])
        assert err.value.code == 2
    monkeypatch.undo()
    wide = build_model(cfg, MESH24, device="cpu", shard_attention=True,
                       expert_axes=("data", "model"), moe_exec="gather")
    with pytest.raises(NotImplementedError, match="model axis only"):
        wide.init_params(torch.Generator().manual_seed(0))
    for r in range(4):
        assert params[r]["layers"]["body"]["pos0"]["moe"]["experts"]["w_up"] is \
            params[r + 4]["layers"]["body"]["pos0"]["moe"]["experts"]["w_up"]
        assert params[r]["embed"] is params[r + 4]["embed"]
        # the validated fetch's checksum table is shared like the weights
        assert params[r]["layers"]["body"]["pos0"]["moe"]["checksums"] is \
            params[r + 4]["layers"]["body"]["pos0"]["moe"]["checksums"]
