"""The port's route-before-gather expert fetch (demand, predictive and
sync-free) against the JAX package.

- Plain kernels #3 (``split_grouped_swiglu_demand``) and #1
  (``split_grouped_gemm``) against the Pallas kernels in interpret mode
  and the jnp formulations, under tests/test_kernels.py's TOL.
- The prefetch primitives against the JAX functions on the same numpy
  inputs: the JAX collectives run under ``jax.vmap`` with a named axis
  (one vmapped lane per rank), the port's over its logical ranks. Index
  and bool outputs are equal, EMA floats within 1e-6.
- Decode on tests/test_multidevice.py's E = 20, top-2 configuration at
  logical mesh (1, 4): every fetch mode gives the port's all-fetch tokens
  and the JAX package's (1, 1) tokens (capacity factor E / top_k: no
  drops in either layout), the forced-overflow budget included.
- The deferred overflow that CUDA graphs capture: its flag is the OR of
  the eager path's per-layer decisions, the deferred step reads nothing
  on the host, the engine runs an overflowed step again (every mode, the
  port's all-fetch and the JAX tokens), and after warmup neither bucket
  lengths nor policy switches build a variant.
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
from repro.core import prefetch as jpf
from repro.core import strategy as jstrategy
from repro.core.placement import make_placement as jplacement
from repro.kernels.split_gemm import ops as jops
from repro.launch.mesh import make_smoke_mesh
from repro.models.cache import init_decode_state as jinit_decode_state
from repro.models.transformer import build_model as jbuild_model
from repro_torch.checkpoint.convert import from_jax_params
from repro_torch.configs.base import ArchConfig, InputShape, MoEConfig
from repro_torch.core import execution, prefetch, strategy
from repro_torch.core.placement import make_placement
from repro_torch.kernels import registry
from repro_torch.kernels.split_gemm import grouped
from repro_torch.kernels.split_gemm import ops as tops
from repro_torch.launch.serve import build_engine
from repro_torch.models.cache import init_decode_state
from repro_torch.models.transformer import build_model
from repro_torch.runtime.engine import HealthMonitor, Request
from torch_refs import jit_quick

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py TOL
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, *shapes, scale=0.1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _close(got_t, ref_j, dt):
    np.testing.assert_allclose(got_t.float().numpy(), np.asarray(ref_j, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


# --------------------------------------------------------------------------
# Kernels #3 and #1: plain versions against Pallas (interpret) and jnp.
# --------------------------------------------------------------------------
# (E_l, E_f, C, D, F, valid pattern): half the fetched rows valid, every
# fetched row invalid (the same shapes: one Pallas compile), an empty
# fetched bank.
DEMAND = [
    ((2, 4, 3, 64, 32, "half"), "float32"),
    ((2, 4, 3, 64, 32, "none"), "float32"),
    ((3, 0, 3, 64, 32, "half"), "float32"),
    ((2, 4, 3, 64, 32, "half"), "bfloat16"),
]


def _demand_inputs(shape, dt):
    e_l, e_f, c, d, f, pattern = shape
    arrs = _arrays(e_l + 7 * e_f + c + len(pattern), (e_l + e_f, c, d), (e_l, d, f), (e_l, d, f), (e_l, f, d),
                   (e_f, d, f), (e_f, d, f), (e_f, f, d))
    valid = (np.arange(e_f) % 2 == 0) if pattern == "half" else np.zeros(e_f, bool)
    return ([jnp.asarray(a, JDT[dt]) for a in arrs] + [jnp.asarray(valid)],
            [torch.from_numpy(a).to(TDT[dt]) for a in arrs], torch.from_numpy(valid))


@pytest.fixture(scope="module")
def demand_refs():
    """Every DEMAND case's Pallas kernel (interpret mode) and jnp version, in
    one jitted program for the module."""
    ins = {str(c): _demand_inputs(*c)[0] for c in DEMAND}
    return jit_quick(lambda ins: {k: [jops.split_swiglu_demand(*a, **kw)
                                      for kw in ({}, {"impl": "jnp"})]
                                  for k, a in ins.items()})(ins)


@pytest.mark.parametrize("shape,dt", DEMAND, ids=str)
def test_split_grouped_swiglu_demand_plain_matches_pallas_and_jnp(demand_refs, shape, dt):
    e_l = shape[0]
    _, tx, tv = _demand_inputs(shape, dt)
    got = grouped.split_grouped_swiglu_demand(*tx, tv)  # CPU tensors: the plain version
    assert torch.equal(got, tops.split_swiglu_demand(*tx, tv, impl="torch"))
    assert torch.all(got[e_l:][~tv] == 0)
    pallas, plain = demand_refs[str((shape, dt))]  # Pallas in interpret mode, jnp
    _close(got, pallas, dt)
    _close(got, plain, dt)


@pytest.mark.parametrize("shape", [(4, 2, 5, 64, 32), (4, 0, 1, 64, 32), (4, 4, 3, 64, 32)],
                         ids=str)
def test_split_grouped_gemm_plain_matches_pallas_and_einsum(shape):
    e, e_l, c, d, f = shape
    x, wl, wr = _arrays(sum(shape), (e, c, d), (e_l, d, f), (e - e_l, d, f))
    got = tops.split_gemm(torch.from_numpy(x), torch.from_numpy(wl), torch.from_numpy(wr))
    assert got.shape == (e, c, f)
    _close(got, jops.split_gemm(jnp.asarray(x), jnp.asarray(wl), jnp.asarray(wr)), "float32")
    ref = np.einsum("ecd,edf->ecf", x, np.concatenate([wl, wr], 0))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_demand_ops_dispatch_and_checks():
    arrs = [torch.from_numpy(a) for a in _arrays(4, (5, 2, 16), (2, 16, 8), (2, 16, 8),
                                                    (2, 8, 16), (3, 16, 8), (3, 16, 8), (3, 8, 16))]
    valid = torch.tensor([True, False, True])
    ref = tops.split_swiglu_demand(*arrs, valid, impl="torch")
    for impl in (None, "kernel"):
        assert torch.equal(tops.split_swiglu_demand(*arrs, valid, impl=impl), ref)
    with pytest.raises(ValueError, match="impl"):
        tops.split_swiglu_demand(*arrs, valid, impl="pallas")
    with pytest.raises(ValueError, match="bool vector"):
        grouped.split_grouped_swiglu_demand(*arrs, valid[:2])
    with pytest.raises(ValueError, match="does not match"):
        grouped.split_grouped_gemm(arrs[0][:4], arrs[1], arrs[4])
    assert {"split_grouped_swiglu_demand", "split_grouped_gemm"} <= set(registry.KERNELS)


# --------------------------------------------------------------------------
# Prefetch primitives against the JAX functions.
# --------------------------------------------------------------------------
PL_J, PL_T = jplacement(20, 4), make_placement(20, 4)  # G' 4, local 5


def _masks(seed, p=0.3):
    return np.random.default_rng(seed).random((4, 20)) < p


@pytest.mark.parametrize("budget", [1, 5])
def test_plan_and_payload_match_jax(budget):
    wanted = _masks(budget)
    have = np.random.default_rng(9).integers(0, 20, (4, 3))
    have_valid = np.random.default_rng(10).random((4, 3)) < 0.5
    rows = np.random.default_rng(11).standard_normal((4, 5, 3)).astype(np.float32)

    def jfn(w, ids, v, t):
        plan = jpf.plan_demand_fetch(w, "model", PL_J, budget=budget, agree_axes=("model",),
                                     exclude_ids=ids, exclude_valid=v)
        return plan, jpf.gather_demand_payload(t, plan, "model", PL_J, budget=budget)

    jplan, jbank = jit_quick(jax.vmap(jfn, axis_name="model"))(
        jnp.asarray(wanted), jnp.asarray(have, jnp.int32), jnp.asarray(have_valid),
        {"w": jnp.asarray(rows)})
    plans = prefetch.plan_demand_fetch(
        [torch.from_numpy(w) for w in wanted], PL_T, budget=budget,
        exclude=[(torch.from_numpy(i), torch.from_numpy(v)) for i, v in zip(have, have_valid)])
    shards = [{"w": torch.from_numpy(r)} for r in rows]
    for r, plan in enumerate(plans):
        np.testing.assert_array_equal(plan.masks.numpy(), np.asarray(jplan.masks[r]))
        np.testing.assert_array_equal(plan.fetched_ids.numpy(), np.asarray(jplan.fetched_ids[r]))
        np.testing.assert_array_equal(plan.valid.numpy(), np.asarray(jplan.valid[r]))
        assert bool(plan.overflow) == bool(jplan.overflow[r])
        bank = prefetch.gather_demand_payload(shards, plan, r, PL_T, budget=budget)
        np.testing.assert_array_equal(bank.fetched["w"].numpy(), np.asarray(jbank.fetched["w"][r]))
        np.testing.assert_array_equal(bank.fetched_ids.numpy(), np.asarray(jbank.fetched_ids[r]))
    assert any(bool(p.overflow) for p in plans) == (budget < 5 and bool(jplan.overflow[0]))


def test_compaction_and_bitmaps_match_jax():
    rng = np.random.default_rng(3)
    m = rng.random((3, 5)) < 0.5
    ids, valid = rng.integers(0, 20, 7), rng.random(7) < 0.5
    w = rng.random(20) < 0.4
    top = np.array([[1, 7], [19, 20], [3, 3]])
    pos = np.array([0, 63, 64, 200, 1000])
    masks = _masks(4)

    @jit_quick  # one compile for every JAX function of the test
    def ref(m, ids, valid, w, top, pos, masks):
        return (
            [jpf._compact_requests(m[i], b) for i, b in enumerate((1, 3, 5))],
            jpf.exclude_bitmap(20, ids, valid),
            [jpf.plan_from_bitmap(w, p, 4, 5, 2) for p in range(4)],
            jpf.routed_bitmaps(top, 20),
            jpf.position_buckets(pos),
            jpf.schedule_digest(masks),
        )

    compact, excl, scheds, routed, buckets, digest = ref(
        *(jnp.asarray(a) for a in (m, ids, valid, w, top, pos, masks)))
    t = torch.from_numpy
    for i, b in enumerate((1, 3, 5)):
        for a, r in zip(prefetch._compact_requests(t(m[i]), b), compact[i]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    np.testing.assert_array_equal(prefetch.exclude_bitmap(20, t(ids), t(valid)).numpy(),
                                  np.asarray(excl))
    for p in range(4):
        for a, r in zip(prefetch.plan_from_bitmap(t(w), p, 4, 5, 2), scheds[p]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    np.testing.assert_array_equal(prefetch.routed_bitmaps(t(top), 20).numpy(), np.asarray(routed))
    np.testing.assert_array_equal(prefetch.position_buckets(t(pos)).numpy(), np.asarray(buckets))
    assert float(prefetch.schedule_digest(t(masks))) == float(digest)


def test_predictor_matches_jax():
    rng = np.random.default_rng(5)
    prev = rng.random(20) < 0.3
    ema = (rng.random(20) * (rng.random(20) < 0.6)).astype(np.float32)
    ema[3] = ema[4]  # a tie: the lower id wins in both
    cids, cvalid = rng.integers(0, 20, 4), np.array([True, False, True, True])
    routed = rng.random((3, 2, 20)) < 0.15  # (mirrors, rows, E)
    buckets = np.eye(4, dtype=bool)[rng.integers(0, 4, (3, 2))]
    sig = rng.random((3, 2, 20)).astype(np.float32)
    sigw = rng.random((3, 2)).astype(np.float32)
    aff = rng.random((3, 2, 20)).astype(np.float32)
    posb = rng.random((3, 4, 20)).astype(np.float32)
    emas = rng.random((3, 20)).astype(np.float32)
    # (budget, which extra-score row or None)
    cases = ((2, None), (3, 0), (5, 1))

    @jit_quick
    def ref(prev, ema, cids, cvalid, routed, buckets, sig, sigw, aff, posb, emas):
        extra = jax.vmap(jpf.predict_extra_score)(sig, sigw)
        bitmaps = [
            jpf.predict_bitmap(prev, ema, PL_J, budget=b, exclude_ids=cids, exclude_valid=cvalid,
                               extra_score=None if e is None else extra[e])
            for b, e in cases
        ]
        folded = jax.vmap(jpf.update_predictor)(emas, aff, posb, sigw, routed, buckets)
        return extra, bitmaps, folded, jpf.pack_mirror_payload(routed[0], buckets[0])

    j_extra, j_bitmaps, j_folded, j_packed = ref(
        *(jnp.asarray(a) for a in (prev, ema, cids, cvalid, routed, buckets, sig, sigw, aff,
                                   posb, emas)))
    t = torch.from_numpy
    extra = prefetch.predict_extra_score(t(sig), t(sigw))
    np.testing.assert_allclose(extra.numpy(), np.asarray(j_extra), atol=1e-6)
    for (b, e), j_bits in zip(cases, j_bitmaps):
        got = prefetch.predict_bitmap(t(prev), t(ema), PL_T, budget=b, exclude_ids=t(cids),
                                      exclude_valid=t(cvalid),
                                      extra_score=None if e is None else extra[e])
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_bits))
    got = prefetch.update_predictor(t(emas), t(aff), t(posb), t(sigw), t(routed), t(buckets))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(j_folded[0]))
    for a, r in zip(got[1:], j_folded[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-6, rtol=0)
    packed = prefetch.pack_mirror_payload(t(routed[0]), t(buckets[0]))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_packed))
    r2, b2 = prefetch.unpack_mirror_payload(torch.stack([packed, packed]), 20)
    assert torch.equal(r2[1], t(routed[0])) and torch.equal(b2[0], t(buckets[0]))


# --------------------------------------------------------------------------
# Decode through every fetch mode on the E = 20, top-2 configuration.
# --------------------------------------------------------------------------
GEOM = dict(shard_attention=True, expert_axes=("model",), moe_exec="gather")
FIELDS = dict(name="demand-test", family="moe", num_layers=4, d_model=32, num_heads=2,
              num_kv_heads=2, head_dim=16, d_ff=0, vocab_size=128)
MOE = dict(num_experts=20, top_k=2, d_ff=48)
CAP = MOE["num_experts"] / MOE["top_k"]  # capacity 3 for 2 rows: nothing drops
CACHE, STEPS = 64, 6
FIRST = np.array([[7], [23]])


def _canonical_weights(jcfg, geom, seed=42):
    """Per-layer canonical (unsharded) weights drawn with numpy, scaled as
    ``repro.models.transformer.init_params`` scales them."""
    rng = np.random.default_rng(seed)
    d, qd, kvd, fe = jcfg.d_model, jcfg.q_dim, jcfg.kv_dim, jcfg.moe.d_ff
    num_padded, vocab_pad = geom.moe_placement.num_padded, geom.vocab_pad

    def dense(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)

    layers = [dict(wq=dense(d, qd), wk=dense(d, kvd), wv=dense(d, kvd), wo=dense(qd, d),
                   router=dense(d, num_padded), w_gate=dense(num_padded, d, fe),
                   w_up=dense(num_padded, d, fe), w_down=dense(num_padded, fe, d))
              for _ in range(jcfg.num_layers)]
    vocab = (rng.standard_normal((vocab_pad, d)).astype(np.float32), dense(d, vocab_pad))
    return layers, vocab


def _jax_layout(jm, canon):
    """The canonical weights in ``jm``'s storage layout: the tree
    ``jm.init_params`` returns, with the layout steps of
    ``init_attn_params`` and ``init_moe_params``."""
    layers, (embed, head) = canon
    geom, d = jm.geom, jm.cfg.d_model
    a, ksd, table = geom.attn_shards, geom.kv_shard, geom.moe_placement.table().reshape(-1)
    kv_rank = np.arange(a) // (a // ksd)

    def layer(c):
        qd, kvd = c["wq"].shape[1], c["wk"].shape[1]
        kv = {k: c[k].reshape(d, ksd, kvd // ksd).transpose(1, 0, 2)[kv_rank] for k in ("wk", "wv")}
        return {"norm1": np.zeros(d, np.float32), "norm2": np.zeros(d, np.float32),
                "attn": {"wq": c["wq"].reshape(d, a, qd // a).transpose(1, 0, 2),
                         "wo": c["wo"].reshape(a, qd // a, d), **kv},
                "moe": {"router": c["router"],
                        "experts": {k: c[k][table] for k in ("w_gate", "w_up", "w_down")}}}

    it, tree = iter(layers), {}
    for group in jm.plan:
        gdict = {}
        for j, _ in enumerate(group.sigs):
            if group.scan:
                per = [layer(next(it)) for _ in range(group.n_cycles)]
                gdict[f"pos{j}"] = jax.tree.map(lambda *xs: np.stack(xs), *per)
            else:
                gdict[f"pos{j}"] = layer(next(it))
        tree[group.name] = gdict
    out = {"embed": embed, "final_norm": np.zeros(d, np.float32), "lm_head": head, "layers": tree}
    ref = jax.eval_shape(jm.init_params, jax.random.key(0))
    assert jax.tree.structure(out) == jax.tree.structure(ref)
    assert all(x.shape == r.shape for x, r in zip(jax.tree.leaves(out), jax.tree.leaves(ref)))
    return out


@pytest.fixture(scope="module")
def decode_setup():
    """The port at (1, 4) and the JAX (1, 1) engine on the same canonical
    weights (drawn with numpy), and the JAX engine's greedy decode tokens
    (compiled once)."""
    jcfg = JArch(**FIELDS, moe=JMoE(**MOE))
    cfg = ArchConfig(**FIELDS, moe=MoEConfig(**MOE))
    jm1 = jbuild_model(jcfg, {"data": 1, "model": 1}, dtype=jnp.float32)
    jm4 = jbuild_model(jcfg, {"data": 1, "model": 4}, dtype=jnp.float32, **GEOM)
    model = build_model(cfg, {"data": 1, "model": 4}, device="cpu", **GEOM)
    canon = _canonical_weights(jcfg, jm1.geom)
    params = from_jax_params(_jax_layout(jm4, canon), model)
    xp = jstrategy.make_execution_plan(jm1, JShape("d", CACHE, 2, "decode"),
                                       {"data": 1, "model": 1}, capacity_factor=CAP)
    step = jit_quick(jexec.make_step_fn(jm1, xp, make_smoke_mesh()))
    jparams = jax.tree.map(jnp.asarray, _jax_layout(jm1, canon))
    state = jinit_decode_state(jm1, 2, CACHE)
    tok, jtoks = jnp.asarray(FIRST, jnp.int32), []
    for _ in range(STEPS):
        out = step(jparams, {"token": tok}, state)
        tok, state = out["next_token"], out["state"]
        jtoks.append(np.asarray(tok)[:, 0].tolist())
    return dict(model=model, params=params, jax_tokens=jtoks, cfg=cfg, runs={}, logits={},
                faults={})


def _port_decode(s, fetch="all", budget=0, cache_budget=0, fault_spec=None, validate=False,
                 steps=STEPS):
    """(tokens, per-step pred_stats, fallbacks) of a ``steps``-step decode,
    kept per configuration for the tests that read the same run (its
    per-step logits and fault_stats under ``s["logits"]`` / ``s["faults"]``)."""
    key = (fetch, budget, cache_budget, fault_spec, validate)
    if key not in s["runs"]:
        toks, stats, fallbacks, logits, fstats = _run_port_decode(
            s, fetch, budget, cache_budget, fault_spec, validate, steps)
        s["runs"][key] = toks, stats, fallbacks
        s["logits"][key], s["faults"][key] = logits, fstats
    return s["runs"][key]


def _run_port_decode(s, fetch, budget, cache_budget, fault_spec=None, validate=False,
                     steps=STEPS):
    model = s["model"]
    pol = strategy.PolicyTable.uniform(fetch=fetch, budget=budget, cache_budget=cache_budget)
    xp = strategy.make_execution_plan(model, InputShape("d", CACHE, 2, "decode"),
                                      {"data": 1, "model": 4}, policy=pol, capacity_factor=CAP,
                                      fault_spec=fault_spec, validate_fetch=validate)
    assert execution.demand_fetch_active(s["cfg"], model.geom, xp) == (fetch != "all")
    state = execution.attach_predict_state(init_decode_state(model, 2, CACHE, seq_shards=4),
                                           model, xp)
    assert ("pred" in state) == (fetch in ("predictive", "sync_free"))
    ctx = execution.Ctx(model=model, xp=xp)
    tok, toks, stats, logits, fstats = torch.as_tensor(FIRST), [], [], [], []
    execution.DEMAND.layers = execution.DEMAND.fallbacks = 0
    for _ in range(steps):
        out = execution.forward_decode(s["params"], tok, state, ctx)
        tok, state = out["next_token"].long(), out["state"]
        toks.append(tok[:, 0].tolist())
        logits.append(out["logits"])
        if "pred_stats" in out:
            stats.append(out["pred_stats"].tolist())
        if "fault_stats" in out:
            fstats.append(out["fault_stats"].tolist())
    return toks, stats, execution.DEMAND.fallbacks, logits, fstats


@pytest.fixture(scope="module")
def all_fetch_tokens(decode_setup):
    toks, stats, _ = _port_decode(decode_setup)
    assert not stats
    return toks


def test_all_fetch_decode_matches_jax(decode_setup, all_fetch_tokens):
    assert all_fetch_tokens == decode_setup["jax_tokens"]


@pytest.mark.parametrize("fetch,budget,cache_budget", [
    ("demand", 0, 0),
    ("predictive", 0, 0),
    ("predictive", 0, 8),
    ("sync_free", 0, 8),
    ("demand", 1, 0),      # budget 1: forced overflow fallbacks
    ("sync_free", 1, 4),
])
def test_fetch_modes_decode_match_all_fetch_and_jax(decode_setup, all_fetch_tokens, fetch,
                                                    budget, cache_budget):
    toks, stats, fallbacks = _port_decode(decode_setup, fetch, budget, cache_budget)
    assert toks == all_fetch_tokens == decode_setup["jax_tokens"]
    assert (fallbacks > 0) == (budget == 1)
    assert len(stats) == (STEPS if fetch != "demand" else 0)


# --------------------------------------------------------------------------
# The validated fetch: checksums, fault injection, repair.
# --------------------------------------------------------------------------
FAULTS = "seed=5,drop=0.2,zero=0.1,corrupt=0.1,cache=0.3"
VALIDATED = [("demand", 0), ("predictive", 8), ("sync_free", 8)]


@pytest.mark.parametrize("fetch,cache_budget", VALIDATED)
@pytest.mark.parametrize("faulty", [False, True], ids=["validated", "faults"])
def test_validated_decodes_match_unvalidated_and_jax(decode_setup, all_fetch_tokens, fetch,
                                                     cache_budget, faulty):
    """The validated fetch, without and with injected faults (drop, zero,
    corrupt and cache rot; sync_free also a mirror drift): the JAX engine's
    healthy tokens and, at every step, the port's unvalidated logits
    bitwise. A healthy validated run (2 steps: the cache is warm in the
    second) detects nothing; a faulty one (3 steps) detects at least every
    injected row, attributes each to a source position, and takes the full
    gather where a correction-round row was bad."""
    s = decode_setup
    spec = (FAULTS + (",mirror=0.5" if fetch == "sync_free" else "")) if faulty else None
    steps = 3 if faulty else 2
    toks, _, fallbacks = _port_decode(s, fetch, 0, cache_budget, spec, not faulty, steps)
    key = (fetch, 0, cache_budget, spec, not faulty)
    assert toks == all_fetch_tokens[:steps] == s["jax_tokens"][:steps]
    _port_decode(s, fetch, 0, cache_budget)
    plain = s["logits"][(fetch, 0, cache_budget, None, False)]
    assert all(torch.equal(a, b) for a, b in zip(s["logits"][key], plain[:steps]))
    fs = np.sum(s["faults"][key], axis=0)
    assert len(s["faults"][key]) == steps and len(fs) == 7 + 4
    if not faulty:
        assert not fs.any() and fallbacks == 0
        return
    injected = fs[0:4].sum()
    assert injected > 0 and fs[4] >= injected
    assert fs[4] == fs[7:].sum()
    assert fs[5] > 0 and fallbacks >= fs[5]  # checksum fallbacks, each one taken
    assert (fs[3] > 0) == (fetch != "demand") and (fs[6] > 0) == (fetch == "sync_free")


def test_fault_storm_walks_the_ladder_down_and_back(decode_setup, all_fetch_tokens):
    """A bad peer under predictive decode with a ``HealthMonitor``: the
    engine demotes through the exclusion rung and demand to the all-gather
    floor, promotes back once the floor has run clean, records every move
    and the fault counters, captures every rung in warmup and builds no
    variant after it; the tokens stay the all-fetch ones."""
    s = decode_setup
    eng, _ = build_engine(s["cfg"], mesh_shape=(1, 4), prefill_len=16, cache_len=CACHE,
                          max_batch=2, device="cpu", params=s["params"], geom_kwargs=GEOM,
                          capacity_from="global", expert_fetch="predictive",
                          fault_spec="seed=1,peers=1",
                          health=HealthMonitor(decay=0.5, demote_threshold=0.4, min_dwell=0))
    gen = eng.gen
    assert [label for label, _, _ in gen.ladder] == ["predictive", "predictive+excl", "demand",
                                                    "all", "reshard"]
    eng.warmup(exclusions=[(1,)])
    misses = gen.variants.stats["misses"]
    assert misses == 4 and gen.max_silent_level == 3
    gen.cur_token.copy_(torch.as_tensor(FIRST))
    toks = []
    for _ in range(7):
        eng.run(1)  # no request: the engine decodes the token row as it stands
        toks.append(gen.cur_token[:, 0].tolist())
    assert toks[:STEPS] == all_fetch_tokens
    moves = [(t["kind"], t["fetch"]) for t in eng.metrics.policy_transitions]
    assert moves[:3] == [("demote", "predictive+excl"), ("demote", "demand"), ("demote", "all")]
    assert ("promote", "demand") in moves and gen.excl in ((), (1,))
    assert gen.variants.stats["misses"] == misses and gen.variants.captures() == 0
    faults = eng.metrics.summary(1.0)["faults"]
    assert faults["detected"] == faults["injected_drop"] > 0
    assert eng.metrics.detected_by_peer[1] == faults["detected"] == sum(eng.metrics.detected_by_peer)
    assert gen.fault_fallbacks > 0
    # the terminal rung, only ever stepped onto explicitly: the all-gather
    # floor's variant, built in warmup, and its tokens
    assert gen.max_silent_level + 1 == len(gen.ladder) - 1 == 4
    gen.set_level(3)
    floor_step = gen.step
    want = gen.step_outputs(s["params"])[0]["logits"].clone()  # commits nothing
    assert gen.set_level(4) and gen.fetch_label == "reshard" and gen.step is floor_step
    assert torch.equal(gen.step_outputs(s["params"])[0]["logits"], want)
    assert gen.variants.stats["misses"] == misses and gen.variants.captures() == 0


def test_pred_stats_cold_warm_and_evictions(decode_setup):
    """[predicted, spec_hit, cache_hit, corr, evicted] per step: no hits on
    the cold step, hits after it, evictions at a small cache, and warm
    steps need a smaller correction round than the cold one."""
    for fetch in ("predictive", "sync_free"):
        _, stats, _ = _port_decode(decode_setup, fetch, 0, 8)
        assert stats[0][1] == 0 and stats[0][2] == 0, stats
        assert sum(st[1] + st[2] for st in stats[1:]) > 0, stats
        assert sum(st[4] for st in stats) > 0, stats
        assert min(st[3] for st in stats[1:]) < stats[0][3], stats


def test_engine_serves_every_fetch_mode_alike(decode_setup):
    """build_engine with each expert_fetch: prefill takes the demand path
    too (4 tokens per rank x top-2 < 15 remote experts), and the served
    tokens equal the all-fetch engine's; warmup leaves the predictive
    state as it found it."""
    s = decode_setup
    prompts = [np.random.default_rng(i).integers(0, 128, 16) for i in range(3)]  # 3 > max_batch
    outs = {}
    for fetch, cache_budget in (("all", 0), ("demand", 0), ("sync_free", 4)):
        eng, _ = build_engine(s["cfg"], mesh_shape=(1, 4), prefill_len=16, cache_len=32,
                              max_batch=2, device="cpu", params=s["params"], geom_kwargs=GEOM,
                              expert_fetch=fetch, cache_budget=cache_budget)
        assert execution.demand_fetch_active(s["cfg"], s["model"].geom, eng.ctx.xp) == (
            fetch != "all")
        pred = eng.gen.state.get("pred")
        eng.warmup()
        assert eng.gen.state.get("pred") is pred and not eng.gen.pred_stats
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, 3))
        eng.run(4)
        assert not eng.busy()
        outs[fetch] = eng.outputs
        assert len(eng.gen.pred_stats) == (4 if pred is not None else 0)
    assert outs["demand"] == outs["sync_free"] == outs["all"]


# --------------------------------------------------------------------------
# The deferred overflow: the step reads nothing on the host, its flag is
# read once per step, and the engine runs an overflowed step again.
# --------------------------------------------------------------------------
FORCED = {"all": {}, "demand": dict(demand_budget=1),
          "predictive": dict(demand_budget=1, cache_budget=8),
          "sync_free": dict(demand_budget=1, cache_budget=4)}


def _decode_inputs(s, fetch, budget=0, cache_budget=0):
    model = s["model"]
    pol = strategy.PolicyTable.uniform(fetch=fetch, budget=budget, cache_budget=cache_budget)
    xp = strategy.make_execution_plan(model, InputShape("d", CACHE, 2, "decode"),
                                      {"data": 1, "model": 4}, policy=pol, capacity_factor=CAP)
    state = execution.attach_predict_state(init_decode_state(model, 2, CACHE, seq_shards=4),
                                           model, xp)
    return xp, state


@pytest.mark.parametrize("fetch", sorted(FORCED))
def test_engine_reruns_overflowed_steps_exactly(decode_setup, all_fetch_tokens, fetch):
    """The generation server (deferred steps) with a budget of 1 row per
    peer: every overflowed step runs again eagerly and is counted, and the
    tokens are the port's all-fetch tokens and the JAX package's.
    (Row-local capacity: no token drops at 2 rows, as at factor E/top_k.)"""
    s = decode_setup
    eng, _ = build_engine(s["cfg"], mesh_shape=(1, 4), prefill_len=16, cache_len=CACHE,
                          max_batch=2, device="cpu", params=s["params"], geom_kwargs=GEOM,
                          capacity_from="global", expert_fetch=fetch, **FORCED[fetch])
    gen = eng.gen
    gen.cur_token.copy_(torch.as_tensor(FIRST))
    toks = [gen.decode_step(s["params"]).tolist() for _ in range(STEPS)]
    assert toks == all_fetch_tokens == s["jax_tokens"]
    assert (gen.fallbacks > 0) == (fetch != "all")
    assert gen.overflow_layers >= gen.fallbacks
    assert (gen.overflow_layers > 0) == (fetch != "all")
    assert len(gen.pred_stats) == (STEPS if fetch in ("predictive", "sync_free") else 0)


@pytest.mark.parametrize("fetch", ["demand", "predictive", "sync_free"])
@pytest.mark.parametrize("budget", [0, 1])
def test_deferred_flag_is_the_or_of_eager_decisions(decode_setup, fetch, budget):
    """One decode step, eager (per-layer host decisions) and deferred, from
    the same state: the deferred flag is set iff an eager layer fell back;
    a set flag counts its layers."""
    s = decode_setup
    xp, state = _decode_inputs(s, fetch, budget, 4 if fetch != "demand" else 0)
    tok = torch.as_tensor(FIRST)
    execution.DEMAND.fallbacks = 0
    eager = execution.forward_decode(s["params"], tok, state,
                                     execution.Ctx(model=s["model"], xp=xp))
    fell_back = execution.DEMAND.fallbacks
    deferred = execution.forward_decode(s["params"], tok, state,
                                        execution.Ctx(model=s["model"], xp=xp, deferred=True))
    assert execution.DEMAND.fallbacks == fell_back
    assert bool(deferred["overflow"]) == (fell_back > 0) == bool(eager["overflow"])
    assert (int(deferred["overflow_layers"]) > 0) == bool(deferred["overflow"])
    assert int(eager["overflow_layers"]) == fell_back
    assert (fell_back > 0) == (budget == 1)
    if not fell_back:
        assert torch.equal(deferred["logits"], eager["logits"])


@pytest.mark.parametrize("fetch", sorted(FORCED))
def test_deferred_decode_step_reads_nothing_on_the_host(decode_setup, fetch, monkeypatch):
    """A deferred decode step — what a CUDA graph captures — with every
    tensor-to-host read patched to raise."""
    s = decode_setup
    kw = FORCED[fetch]
    xp, state = _decode_inputs(s, fetch, kw.get("demand_budget", 0), kw.get("cache_budget", 0))
    tok = torch.as_tensor(FIRST)
    ctx = execution.Ctx(model=s["model"], xp=xp, deferred=True)

    def read(*args, **kwargs):
        raise AssertionError("a host read inside the deferred step")

    for name in ("__bool__", "item", "tolist", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, read)
    out = execution.forward_decode(s["params"], tok, state, ctx)
    monkeypatch.undo()
    assert bool(out["overflow"]) == (fetch != "all")


def test_no_variant_built_after_warmup(decode_setup):
    """After warmup (two prefill buckets, the demand and predictive decode
    tables), serving mixed prompt lengths with policy switches between
    steps builds no variant (zero misses) and captures nothing."""
    s = decode_setup
    eng, _ = build_engine(s["cfg"], mesh_shape=(1, 4), prefill_len=16, prefill_buckets=(8,),
                          cache_len=32, max_batch=2, device="cpu", params=s["params"],
                          geom_kwargs=GEOM, expert_fetch="demand")
    tables = (strategy.PolicyTable.uniform(fetch="predictive", cache_budget=4),
              strategy.PolicyTable.uniform(fetch="demand"))
    eng.warmup(tables[:1])
    misses = (eng.ctx.variants.stats["misses"], eng.gen.variants.stats["misses"])
    assert misses == (2, 2)
    rng = np.random.default_rng(4)
    for i, n in enumerate((8, 16, 8, 16)):
        eng.submit(Request(i, rng.integers(0, 128, n), 4))
    switches = steps = 0
    while eng.busy():
        switches += eng.gen.set_policy(tables[steps % 2])
        eng.run(1)
        steps += 1
    assert switches >= 3 and len(eng.outputs) == 4
    assert (eng.ctx.variants.stats["misses"], eng.gen.variants.stats["misses"]) == misses
    assert eng.ctx.variants.captures() == eng.gen.variants.captures() == 0
