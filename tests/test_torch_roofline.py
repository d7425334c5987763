"""The port's roofline cost model and policy resolution against the JAX
package's, on the same inputs, with no JAX compile and no JAX run: the
per-layer terms, the modeled step time, the budget forms, Figure 3's sweep
and crossover (``core.roofline``); the ``"auto"`` resolver's tables, the
engine-effective demotion and the decision rules of the reference's
tests/test_core.py (``core.strategy``); the budget tuner and the online
scheduler fed the same counters through one fake server; and the port's
engine serving ``"auto-online"`` against ``"auto"``. Models are geometry
only (no weights), except the tiny MoE engine's, drawn by the port."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.configs import reduced_variant as jreduced
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import InputShape as JShape
from repro.configs.base import MoEConfig as JMoE
from repro.core import roofline as jroofline
from repro.core import strategy as jstrategy
from repro.models.transformer import build_model as jbuild_model
from repro.runtime import engine as jengine
from repro_torch.configs.base import ArchConfig, BlockKind, InputShape, MoEConfig
from repro_torch.core import budget, roofline, strategy
from repro_torch.launch.serve import build_engine
from repro_torch.models.transformer import build_model
from repro_torch.runtime import engine
from repro_torch.runtime.engine import Request
from torch_refs import MOE_EXPERTS, MOE_FIELDS, MOE_GEOM

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

REL = 1e-12
R1_GEOM = dict(shard_attention=True, expert_axes=("model",), moe_exec="gather")
SIZES14 = {"data": 1, "model": 4}
SIZES24 = {"data": 2, "model": 4}


def _port_cfg(jcfg) -> ArchConfig:
    """The port's config of a JAX package config (the same fields)."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ArchConfig)}
    kw["block_pattern"] = tuple(BlockKind(k.value) for k in jcfg.block_pattern)
    if jcfg.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(jcfg.moe))
    return ArchConfig(**kw)


def _r1(depth: int):
    jcfg = jget_arch("deepseek-r1")
    if depth != jcfg.num_layers:
        jcfg = dataclasses.replace(jcfg, num_layers=depth,
                                   moe=dataclasses.replace(jcfg.moe, first_dense=1))
    return jcfg


CONFIGS = {
    "r1_depth2": lambda: _r1(2),
    "r1_depth61": lambda: _r1(61),
    "gemma3": lambda: jget_arch("gemma3-27b"),
    "tiny_moe": lambda: JArch(**MOE_FIELDS, moe=JMoE(**MOE_EXPERTS)),
}
HW = {"GB200": roofline.GB200, "H100": roofline.H100}


def _jhw(hw):
    return jroofline.Hardware(**dataclasses.asdict(hw))


def _jtable(table):
    return jstrategy.PolicyTable.from_dict(table.to_dict())


def _close(got, want, what=""):
    assert abs(got - want) <= REL * max(abs(want), 1e-300), (what, got, want)


def _uniform_tables():
    """Every layout x fetch x transport as a uniform table."""
    out = []
    for layout in ("split", "merged"):
        for fetch in (("all", "demand", "predictive", "sync_free") if layout == "split"
                      else ("all",)):
            for transport in strategy.PREFETCH_MODES:
                out.append(strategy.PolicyTable.uniform(layout=layout, fetch=fetch,
                                                        transport=transport))
    return out


UNIFORM = _uniform_tables()
MIXED = strategy.PolicyTable.from_dict({
    "moe_experts": "split:predictive:ring_sliced:4:16:8", "attn_qkv": "merged",
    "body/moe_experts": "split:demand", "prefix/dense_ffn": "merged:all:ring"})


# --------------------------------------------------------------------------
# The cost model.
# --------------------------------------------------------------------------
def test_budget_forms_match_reference():
    """The closed forms, exactly: the budgets and rungs the engine and the
    tuner use, the expected coverage and both fetches' wire terms."""
    for draws in (1, 2, 8, 16, 64, 512, 8192):
        for e, local in ((256, 64), (256, 32), (8, 2), (4, 1), (160, 40)):
            assert budget.demand_budget_rows(draws, e, local) == \
                jroofline.demand_budget_rows(draws, e, local)
            assert budget.predictive_budget_rows(draws, e, local) == \
                jroofline.predictive_budget_rows(draws, e, local)
            assert roofline.predictive_budget_rungs(draws, e, local) == \
                jroofline.predictive_budget_rungs(draws, e, local)
            assert roofline.expected_distinct_experts(draws, e) == \
                jroofline.expected_distinct_experts(draws, e)
            for kw in ({}, {"budget": 8}, {"cache_rows": 24}, {"cache_hit": 0.3},
                       {"predict_hit": 0.15, "validate": True}, {"sync_free": True},
                       {"redundancy": 2}):
                args = (draws, 8, e, 4, 3 * 7168 * 2048)
                assert roofline.predictive_fetch_terms(*args, **kw) == \
                    jroofline.predictive_fetch_terms(*args, **kw)
            for kw in ({}, {"budget": 8}, {"validate": True}, {"redundancy": 4}):
                args = (draws, 8, e, 4, 3 * 7168 * 2048)
                assert roofline.demand_prefetch_bytes(*args, **kw) == \
                    jroofline.demand_prefetch_bytes(*args, **kw)


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_layer_times_match_reference(arch, hw):
    """Every field of ``layer_times`` at the first three layers and the
    last (every layer of a short model), under the flat knobs
    and every uniform table, with and without gathered attention and
    replayed hit rates, to a relative 1e-12."""
    jcfg = CONFIGS[arch]()
    cfg, h = _port_cfg(jcfg), HW[hw]
    jh = _jhw(h)
    layers = sorted({0, 1, 2, cfg.num_layers - 1}) if cfg.num_layers > 8 else range(cfg.num_layers)
    for layer in layers:
        for tokens in (1, 8, 1024):
            for extra in ({}, {"attn_gathered": True, "cache_hit": 0.25, "predict_hit": 0.5,
                               "weight_bytes": 2, "kv_len": 2048}):
                kw = dict(tokens=tokens, group=4, layer=layer, **extra)
                runs = [(dict(weight_layout=lay, expert_fetch=f), dict(weight_layout=lay,
                                                                      expert_fetch=f))
                        for lay in ("split", "merged") for f in ("all", "demand", "predictive")]
                runs += [(dict(policies=t), dict(policies=_jtable(t))) for t in UNIFORM]
                runs.append((dict(policies=MIXED, layer_group="body"),
                             dict(policies=_jtable(MIXED), layer_group="body")))
                for mine, ref in runs:
                    got = roofline.layer_times(cfg, hw=h, **kw, **mine)
                    want = jroofline.layer_times(jcfg, hw=jh, **kw, **ref)
                    for a, b in zip(dataclasses.astuple(got), dataclasses.astuple(want)):
                        _close(a, b, (layer, tokens, mine))
                    _close(roofline.layer_step_time(got), jroofline.layer_step_time(want))


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_modeled_step_time_matches_reference(arch, hw):
    """``modeled_step_time`` under every uniform table and a mixed
    per-group table, with closed-form, scalar and per-group hit rates."""
    jcfg = CONFIGS[arch]()
    cfg, h = _port_cfg(jcfg), HW[hw]
    jh = _jhw(h)
    assert list(roofline.layer_group_names(cfg)) == jroofline.layer_group_names(jcfg)
    groups = set(roofline.layer_group_names(cfg))
    rates = ({}, {"cache_hit": 0.2, "predict_hit": 0.6},
             {"predict_hit": {g: 0.15 for g in groups}, "cache_hit": {g: 0.0 for g in groups}})
    for tokens, wb in ((1, 1), (2, 2), (8, 1), (256, 2)):
        for rate in rates:
            kw = dict(tokens=tokens, group=4, kv_len=1040, attn_gathered=True, weight_bytes=wb,
                      **rate)
            for t in UNIFORM + [MIXED]:
                _close(roofline.modeled_step_time(cfg, hw=h, policies=t, **kw),
                       jroofline.modeled_step_time(jcfg, hw=jh, policies=_jtable(t), **kw),
                       (tokens, wb, t.describe()))
            _close(roofline.modeled_step_time(cfg, hw=h, expert_fetch="sync_free",
                                              weight_layout="split", **kw),
                   jroofline.modeled_step_time(jcfg, hw=jh, expert_fetch="sync_free",
                                               weight_layout="split", **kw))


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_figure3_and_crossover_match_reference(arch, hw):
    jcfg = CONFIGS[arch]()
    cfg, h = _port_cfg(jcfg), HW[hw]
    jh = _jhw(h)
    for kw in ({}, {"weight_layout": "split", "attn_gathered": True, "expert_fetch": "demand",
                    "batch": 2}):
        got = roofline.figure3_sweep(cfg, hw=h, **kw)
        want = jroofline.figure3_sweep(jcfg, hw=jh, **kw)
        assert [r.keys() for r in got] == [r.keys() for r in want]
        for g, w in zip(got, want):
            for key in w:
                _close(g[key], w[key], key)
    assert roofline.crossover_isl(cfg, hw=h) == jroofline.crossover_isl(jcfg, hw=jh)


def test_card_view():
    """The per-logical-rank view of one H100: its rates, a quarter of its
    memory at four ranks, the measured copy rate as the link."""
    view = roofline.card_view(4)
    assert (view.flops, view.hbm_bw, view.hbm_bytes) == (989e12, 3.35e12, 20e9)
    assert view.link_bw == pytest.approx(1.5073e12, rel=1e-4)
    model = build_model(_port_cfg(_r1(2)), SIZES14, device="cpu", **R1_GEOM)
    assert roofline.serving_target(model) == (roofline.GB200, 1)


# --------------------------------------------------------------------------
# The resolver.
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def r1_models():
    """R1 at full width, depth 2 (first layer dense), on (1, 4) and (2, 4) in
    both packages: geometry only."""
    jcfg = _r1(2)
    cfg = _port_cfg(jcfg)
    out = {}
    for name, sizes in (("1x4", SIZES14), ("2x4", SIZES24)):
        jm = jbuild_model(jcfg, sizes, dtype=jnp.bfloat16, **R1_GEOM)
        m = build_model(cfg, sizes, dtype=torch.bfloat16, device="cpu", **R1_GEOM)
        for f in ("expert_axes", "moe_exec", "ffn_axes", "ffn_shards", "attn_axes",
                  "attn_shards"):
            assert getattr(m.geom, f) == getattr(jm.geom, f), f
        out[name] = (jm, m, sizes)
    return out


def _shapes(sizes):
    n = sizes["data"] * sizes["model"]
    decode = sorted({1, 2, n, 2 * n, 8 * n})  # 1 / 2 unsharded rows; 1, 2, 8 rows per rank
    return ([("gen", 1040, b, "decode") for b in decode]
            + [("ctx", s, 1, "prefill") for s in (1024, 16384)])


def _drifted(cfg):
    return {g: {"predict_hit": 0.15, "cache_hit": 0.0} for g in set(roofline.layer_group_names(cfg))}


@pytest.mark.parametrize("mesh", ["1x4", "2x4"])
def test_resolve_policies_matches_reference(r1_models, mesh):
    """``resolve_policies(..., "auto")`` gives the reference's table over
    decode at 1, 2 and 8 rows per rank (and 1 and 2 unsharded rows),
    prefill at 1024 and 16384 tokens, closed-form and drifted hit rates,
    GB200 and H100 (and the per-rank views of one card holding 4 and 3
    ranks, where the residency headroom, not the remote bank, sizes the
    cache), 1- and 2-byte weights; ``_auto_cache_rows`` alike."""
    jm, m, sizes = r1_models[mesh]
    for shp in _shapes(sizes):
        for hw in (roofline.GB200, roofline.H100, roofline.card_view(4), roofline.card_view(3)):
            for wb in (1, 2):
                for rates in (None, _drifted(m.cfg)):
                    got = strategy.resolve_policies(m, InputShape(*shp), sizes, "auto", hw=hw,
                                                    weight_bytes=wb, hit_rates=rates)
                    want = jstrategy.resolve_policies(jm, JShape(*shp), sizes, "auto",
                                                      hw=_jhw(hw), weight_bytes=wb,
                                                      hit_rates=rates)
                    assert got.to_dict() == want.to_dict(), (shp, hw.name, wb, rates)
                assert strategy._auto_cache_rows(m, InputShape(*shp), sizes, hw, wb) == \
                    jstrategy._auto_cache_rows(jm, JShape(*shp), sizes, _jhw(hw), wb)
    # "auto-online" resolves as "auto" in a plan, hw and weight bytes passed on
    shp = _shapes(sizes)[0]
    xp = strategy.make_execution_plan(m, InputShape(*shp), sizes, policy="auto-online",
                                      hw=roofline.H100, weight_bytes=2)
    assert xp.policies == strategy.resolve_policies(m, InputShape(*shp), sizes, hw=roofline.H100,
                                                    weight_bytes=2)
    assert strategy.make_execution_plan(m, InputShape(*shp), sizes, policy="auto").policies \
        .to_dict() == jstrategy.make_execution_plan(jm, JShape(*shp), sizes,
                                                    policy="auto").policies.to_dict()


# The tables of the card's auto serve (R1 depth 2, mesh (1, 4), cache 1040),
# as chip_smoke.py's phase 13 prints and checks them: entry -> (weight bytes,
# decode cache rows, prefill table, decode table at 1 and at 2 rows).
_SLICED = "split:all:ring_sliced"
_ALL_SLICED = {"default": "split:all:allgather", "moe_experts": _SLICED, "attn_qkv": _SLICED,
               "attn_out": _SLICED, "dense_ffn": _SLICED}
AUTO_TABLES = {
    "GB200": (1, 192, _ALL_SLICED,
              dict(_ALL_SLICED, moe_experts="split:predictive:ring_sliced:4:0:192")),
    "H100": (2, 192, _ALL_SLICED,
             dict(_ALL_SLICED, moe_experts="split:predictive:ring_sliced:4:0:192")),
    "H100/4": (2, 24, _ALL_SLICED, dict(_ALL_SLICED, moe_experts="split:demand:ring_sliced")),
}


def test_auto_tables_of_the_card_serve(r1_models):
    """R1 1024 on (1, 4): the prefill table and the decode table at 1 and 2
    rows under GB200 (the reference's default, 1-byte weights), H100 and
    the per-rank view of one card (bf16): the pinned tables, the
    reference's; the default cache of the whole remote bank (192 rows, 4 x
    192 x 88.08 MB = 67.6 GB) against the view's 24."""
    jm, m, sizes = r1_models["1x4"]
    for hw in (roofline.GB200, roofline.H100, roofline.card_view(4)):
        wb, cache, prefill, decode = AUTO_TABLES[hw.name]
        pre = InputShape("ctx", 1024, 1, "prefill")
        assert strategy.resolve_policies(m, pre, sizes, hw=hw, weight_bytes=wb).to_dict() == \
            prefill == jstrategy.resolve_policies(jm, JShape(*dataclasses.astuple(pre)), sizes,
                                                  hw=_jhw(hw), weight_bytes=wb).to_dict()
        for rows in (1, 2):
            dec = InputShape("gen", 1040, rows, "decode")
            assert strategy.resolve_policies(m, dec, sizes, hw=hw, weight_bytes=wb).to_dict() \
                == decode
            assert strategy._auto_cache_rows(m, dec, sizes, hw, wb) == cache
    per_expert = 3 * 7168 * 2048 * 2
    assert 4 * 192 * per_expert == pytest.approx(67.6e9, rel=1e-3)


def test_analytic_residency_matches_reference(r1_models):
    """``analytic_residency_bytes`` (the cache sizing's input) under every
    uniform table and a mixed per-group one, at decode and prefill, on both
    meshes, at 1- and 2-byte weights."""
    from repro.analysis.roofline_report import analytic_residency_bytes as jresidency
    from repro_torch.analysis.residency import analytic_residency_bytes

    for mesh in ("1x4", "2x4"):
        jm, m, sizes = r1_models[mesh]
        for shp in _shapes(sizes)[::2]:
            for t in UNIFORM[::3] + [strategy.PolicyTable.uniform(fetch="sync_free",
                                                                  cache_budget=24), MIXED]:
                xp = strategy.make_execution_plan(m, InputShape(*shp), sizes, policy=t)
                jxp = jstrategy.make_execution_plan(jm, JShape(*shp), sizes, policy=_jtable(t))
                for wb in (1, 2):
                    _close(analytic_residency_bytes(m.cfg, m.geom, xp, InputShape(*shp), wb),
                           jresidency(jm.cfg, jm.geom, jxp, JShape(*shp), wb), (mesh, shp))


def test_effective_policies_match_reference(r1_models):
    """Every uniform table (and a mixed per-group one) demoted to what the
    engine runs, at decode, short and long prefill, as the reference."""
    for mesh in ("1x4", "2x4"):
        jm, m, sizes = r1_models[mesh]
        for shp in _shapes(sizes):
            for t in UNIFORM + [MIXED]:
                got = strategy.effective_policies(m, InputShape(*shp), sizes, t)
                want = jstrategy.effective_policies(jm, JShape(*shp), sizes, _jtable(t))
                assert got.to_dict() == want.to_dict(), (mesh, shp, t.describe())


def _r1_gather_model():
    """The reference test's model: R1 at full depth on (2, 4), the gather
    geometry, in the port."""
    cfg = _port_cfg(jget_arch("deepseek-r1"))
    return cfg, SIZES24, build_model(cfg, SIZES24, device="cpu", moe_exec="gather",
                                     expert_axes=("model",))


def test_auto_resolver_decision_rules():
    """The reference's rules (tests/test_core.py) on the port: sync_free
    experts at 8 rows per rank, demand at one row, all-fetch at a long
    prefill, ring_sliced for R1's banks and allgather for a reduced
    GLM-4-9B's."""
    cfg, ms, m = _r1_gather_model()
    dec = strategy.resolve_policies(m, InputShape("gen", 2048, 64, "decode"), ms)
    assert dec.family("moe_experts").fetch == "sync_free"
    assert dec.family("moe_experts").layout == "split"
    assert dec.family("moe_experts").transport == "ring_sliced"
    dec1 = strategy.resolve_policies(m, InputShape("gen", 2048, 8, "decode"), ms)
    assert dec1.family("moe_experts").fetch == "demand"
    ctx = strategy.resolve_policies(m, InputShape("ctx", 16384, 1, "prefill"), ms)
    assert ctx.family("moe_experts").fetch == "all"
    assert ctx.family("moe_experts").layout == "split"
    small = _port_cfg(jreduced(jget_arch("glm4-9b")))
    m2 = build_model(small, ms, dtype=torch.float32, device="cpu")
    t2 = strategy.resolve_policies(m2, InputShape("gen", 64, 8, "decode"), ms)
    assert t2.family("moe_experts").transport == "allgather"


def test_auto_beats_every_uniform_policy_r1_decode():
    """At R1's 8 rows per rank on (2, 4) the resolved table's modeled decode
    step is at most every uniform table's at its engine-effective
    resolution, and below the worst one's by a quarter."""
    cfg, ms, m = _r1_gather_model()
    shape = InputShape("gen", 2048, 64, "decode")
    auto = strategy.resolve_policies(m, shape, ms)
    assert auto.family("moe_experts").fetch == "sync_free"
    kw = dict(tokens=8, group=4, kv_len=2048, attn_gathered=bool(m.geom.attn_axes))
    t_auto = roofline.modeled_step_time(cfg, policies=auto, **kw)
    uniforms = [roofline.modeled_step_time(
        cfg, policies=strategy.effective_policies(m, shape, ms, t), **kw) for t in UNIFORM]
    assert all(t_auto <= t + 1e-15 for t in uniforms)
    assert t_auto < max(uniforms) * 0.75


# --------------------------------------------------------------------------
# Online policies.
# --------------------------------------------------------------------------
class _FakeGen:
    """The generation-server surface the tuner and the scheduler read: the
    plan, the last step's counters, ``set_policy`` (a switch where the
    canonical table differs), the variant cache's size and level 0."""

    def __init__(self, xp, max_entries: int = 16):
        self.xp = xp
        self.level = 0
        self.last_pred_stats = None
        self.variants = types.SimpleNamespace(max_entries=max_entries)

    def set_policy(self, table) -> bool:
        if table.describe() == self.xp.policies.describe():
            return False
        self.xp = dataclasses.replace(self.xp, policies=table)
        return True


def _stats_sequence(n: int, seed: int) -> list:
    """``pred_stats`` rows whose miss share and speculative use swing
    between the tuner's raise and lower thresholds, and an idle step."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 11 == 10:
            out.append(None)
            continue
        pred = float(rng.integers(0, 40))
        hit, cache, miss = (float(x) for x in rng.integers(0, 20, 3))
        if (i // 6) % 2:
            miss = 0.0
        out.append(np.array([pred, hit, cache, miss, float(rng.integers(0, 4))], np.float32))
    return out


def test_budget_tuner_matches_reference():
    for rungs, start in (((8, 16, 24, 32), None), ((8, 16, 24, 32), 30), ((8,), None),
                         ((2,), 2)):
        mine, ref = engine.BudgetTuner(rungs, start=start), jengine.BudgetTuner(rungs, start=start)
        for stats in _stats_sequence(60, seed=len(rungs) + (start or 0)):
            assert mine.observe(stats) == ref.observe(stats)
            assert mine.budget == ref.budget
    with pytest.raises(ValueError):
        engine.BudgetTuner(())


@pytest.mark.parametrize("hw", sorted(HW))
def test_online_scheduler_matches_reference(r1_models, hw):
    """One sequence of active rows and counters through both schedulers on a
    fake server (R1 depth 2, (1, 4), 32 decode rows: 8 per rank, rungs 8-32):
    the same candidate tables, and at every step the same move, table and
    budget."""
    jm, m, sizes = r1_models["1x4"]
    shape = ("gen", 1040, 32, "decode")
    h = HW[hw]
    gen = _FakeGen(strategy.make_execution_plan(m, InputShape(*shape), sizes, policy="auto",
                                                hw=h))
    jgen = _FakeGen(jstrategy.make_execution_plan(jm, JShape(*shape), sizes, policy="auto",
                                                  hw=_jhw(h)))
    sched = engine.OnlinePolicyScheduler(m, sizes, InputShape(*shape), interval=2, hw=h)
    jsched = jengine.OnlinePolicyScheduler(jm, sizes, JShape(*shape), interval=2, hw=_jhw(h))
    cands = [t.describe() for t in sched.candidate_tables(gen)]
    assert cands == [t.describe() for t in jsched.candidate_tables(jgen)]
    assert sched.tuner.rungs == jsched.tuner.rungs == (8, 16, 24, 32)
    rng = np.random.default_rng(4)
    moves = []
    for stats in _stats_sequence(48, seed=9):
        rows = int(rng.integers(1, 33))
        gen.last_pred_stats = jgen.last_pred_stats = stats
        moved = sched.step(gen, rows)
        assert moved == jsched.step(jgen, rows)
        assert gen.xp.policies.describe() == jgen.xp.policies.describe()
        assert sched.tuner.budget == jsched.tuner.budget
        moves.append(moved)
    assert "switch" in moves


def test_auto_online_engine_matches_auto():
    """The tiny MoE model served by the port's engine under ``"auto-online"``
    (switch interval 2) and ``"auto"``: the same tokens, every variant miss
    kept as an entry (the reference's check), at least one recorded
    transition — and the reference's scheduler, fed the port's sequence of
    active rows and counters through a fake server, makes the same
    moves."""
    cfg = ArchConfig(**MOE_FIELDS, moe=MoEConfig(**MOE_EXPERTS))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 16) for _ in range(3)]
    outputs, seq = {}, []
    for policy in ("auto-online", "auto"):
        eng, model = build_engine(cfg, mesh_shape=(1, 4), prefill_len=16, cache_len=32,
                                  max_batch=2, device="cpu", geom_kwargs=MOE_GEOM, policy=policy,
                                  switch_interval=2, capacity_from="global")
        if eng.scheduler is not None:
            step = eng.scheduler.step

            def recorded(gen, rows, step=step):
                stats = gen.last_pred_stats
                seq.append((rows, None if stats is None else stats.copy(), step(gen, rows)))
                return seq[-1][2]

            eng.scheduler.step = recorded
        eng.warmup()
        for i, (p, n) in enumerate(zip(prompts, (6, 3, 5))):
            eng.submit(Request(i, p, n))
        while eng.busy():
            eng.run(1)
        outputs[policy] = dict(eng.outputs)
        summary = eng.metrics.summary(horizon=eng.horizon())
        assert summary["completed"] == 3
        assert eng.gen.variants.stats["misses"] == len(eng.gen.variants)
        if policy == "auto-online":
            transitions = summary["policy_transitions"]
            assert summary.get("policy_switches", 0) + summary.get("budget_resizes", 0) >= 1
            assert [t["kind"] for t in transitions] == [m for _, _, m in seq if m]
    assert outputs["auto-online"] == outputs["auto"]
    jm = jbuild_model(JArch(**MOE_FIELDS, moe=JMoE(**MOE_EXPERTS)), SIZES14, dtype=jnp.float32,
                      **MOE_GEOM)
    shape = JShape("gen", 32, 2, "decode")
    jgen = _FakeGen(jstrategy.make_execution_plan(jm, shape, SIZES14, policy="auto"))
    jsched = jengine.OnlinePolicyScheduler(jm, SIZES14, shape, interval=2)
    for rows, stats, moved in seq:
        jgen.last_pred_stats = stats
        assert jsched.step(jgen, rows) == moved
    assert any(m for _, _, m in seq)
