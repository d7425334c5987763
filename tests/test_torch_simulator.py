"""The port's cluster model against the JAX package's, on the same inputs:
the routing traces and the predictor's replay (``core.traces``), the
contention model (``core.contention``), the roofline's fault pricing, the
fail-stop re-shard (``prefetch.reshard_split_bank``), the cluster simulator
(``runtime.simulator``) and the modeled replica client
(``runtime.serving.modeled``). Host code, but for the JAX package's
predictor replay on one short trace (its five predictor functions compiled).

Each module's reference results are computed once, in a module fixture;
the tests mirror the reference's own (tests/test_syncfree.py,
tests/test_serving.py, tests/test_core.py, tests/test_rank_death.py,
tests/test_faults.py) and hold the port to it: arrays bitwise, the
simulator's summaries key for key (floats to 1e-9 relative, integers and
``None`` equal), the predictor's hit rates to 1e-6."""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import MoEConfig as JMoE
from repro.core import contention as jcontention
from repro.core import roofline as jroofline
from repro.core import traces as jtraces
from repro.core.placement import make_placement as jmake_placement
from repro.core.prefetch import reshard_split_bank as jreshard
from repro.core.strategy import GatherPolicy as JPolicy
from repro.core.strategy import PolicyTable as JTable
from repro.runtime import serving as jserving
from repro.runtime import simulator as jsim
from repro_torch.configs.base import ArchConfig, BlockKind, MoEConfig
from repro_torch.core import contention, roofline, traces
from repro_torch.core.faults import FaultTrace
from repro_torch.core.placement import make_placement
from repro_torch.core.prefetch import reshard_runs, reshard_split_bank
from repro_torch.core.strategy import GatherPolicy, PolicyTable
from repro_torch.runtime import serving, simulator

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FAULT_TRACE = os.path.join(FIXTURES, "fault_trace.npz")
SERVED_TRACE = os.path.join(FIXTURES, "served_routing_trace.npz")
REL = 1e-9


def _port_cfg(jcfg) -> ArchConfig:
    """The port's config of a JAX package config (the same fields)."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ArchConfig)}
    kw["block_pattern"] = tuple(BlockKind(k.value) for k in jcfg.block_pattern)
    if jcfg.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(jcfg.moe))
    return ArchConfig(**kw)


def _port_table(jt):
    """The port's policy table of a JAX package table."""
    pol = lambda p: GatherPolicy(**dataclasses.asdict(p))  # noqa: E731
    return PolicyTable(default=pol(jt.default), families=tuple((n, pol(p)) for n, p in jt.families),
                       overrides=tuple((g, n, pol(p)) for g, n, p in jt.overrides))


def _jax_hw(hw):
    return jroofline.Hardware(hw.name, hw.flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes)


def _assert_same(got, ref, path=""):
    """``got`` equals ``ref`` key for key: floats to ``REL``, the rest exactly."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, set(got) ^ set(ref))
        for k in ref:
            _assert_same(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref, err_msg=path)
    elif isinstance(ref, float) or isinstance(got, float):
        assert math.isclose(got, ref, rel_tol=REL, abs_tol=0.0), (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


R1_J = jget_arch("deepseek-r1")
R1 = _port_cfg(R1_J)
# tests/test_rank_death.py's fault-trace config (E 20, top_k 2)
TRACE_J = JArch(name="fault-trace", family="moe", num_layers=4, d_model=32, num_heads=2,
                num_kv_heads=2, head_dim=16, d_ff=0, vocab_size=128,
                moe=JMoE(num_experts=20, top_k=2, d_ff=48))
TRACE = _port_cfg(TRACE_J)


# --------------------------------------------------------------------------
# Routing traces and the predictor replay (tests/test_syncfree.py,
# tests/test_serving.py).
# --------------------------------------------------------------------------
ZIPF_CASES = [
    pytest.param((12, 4, 64, 8), dict(seed=3), id="12x4-E64-seed3"),
    pytest.param((12, 4, 64, 8), dict(seed=4), id="12x4-E64-seed4"),
    pytest.param((64, 8, 256, 8), dict(alpha=1.3, affinity=0.8, seed=0), id="skewed"),
    pytest.param((64, 8, 256, 8), dict(alpha=0.0, affinity=0.0, seed=0), id="uniform"),
    pytest.param((48, 8, 256, 8), dict(alpha=1.3, affinity=0.8, drift_every=24, seed=7),
                 id="r1-acceptance"),
]


@pytest.mark.parametrize("shape,kw", ZIPF_CASES)
def test_zipf_trace_bitwise_reference(shape, kw):
    got = traces.zipf_routing_trace(*shape, **kw)
    ref = jtraces.zipf_routing_trace(*shape, **kw)
    assert got.shape == shape[:2] + (shape[3],) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert all(len(set(row)) == shape[3] for row in got.reshape(-1, shape[3]).tolist())
    assert traces.trace_skew(got, shape[2]) == jtraces.trace_skew(ref, shape[2])


def test_zipf_trace_is_skewed_and_refuses_bad_arguments():
    skew = traces.trace_skew(traces.zipf_routing_trace(64, 8, 256, 8, alpha=1.3, affinity=0.8), 256)
    flat = traces.trace_skew(traces.zipf_routing_trace(64, 8, 256, 8, alpha=0.0, affinity=0.0), 256)
    assert skew > 3 * flat and flat < 0.15, (skew, flat)
    for args, kw in (((4, 2, 8, 16), {}), ((4, 2, 8, 2), {"affinity": 1.5})):
        with pytest.raises(ValueError):
            traces.zipf_routing_trace(*args, **kw)
        with pytest.raises(ValueError):
            jtraces.zipf_routing_trace(*args, **kw)
    with pytest.raises(ValueError):
        traces.zipf_scores(0)


def _random_bitmaps():
    steps, ranks, e, k = 6, 4, 16, 2
    rng = np.random.default_rng(0)
    bm = np.zeros((steps, ranks, e), bool)
    for t in range(steps):
        for r in range(ranks):
            bm[t, r, rng.choice(e, size=k, replace=False)] = True
    return bm


def _padding_bitmaps():
    bm = np.zeros((3, 2, 8), bool)
    bm[0, 0, [0, 1, 2, 3]] = True   # 4 experts -> 2 rows of top_k 2
    bm[1, 0, 5] = True
    bm[2, 1, [6, 7]] = True
    return bm


SERVED_CASES = [
    pytest.param(_random_bitmaps, 2, id="random"),
    pytest.param(lambda: _random_bitmaps()[:, 0], 2, id="one-rank"),
    pytest.param(_padding_bitmaps, 2, id="padding"),
    pytest.param(lambda: np.load(SERVED_TRACE)["bitmaps"], 2, id="served-fixture"),
]


@pytest.mark.parametrize("bitmaps,top_k", SERVED_CASES)
def test_from_served_trace_bitwise_reference(bitmaps, top_k):
    bm = bitmaps()
    got = traces.from_served_trace(bm, top_k=top_k)
    np.testing.assert_array_equal(got, jtraces.from_served_trace(bm, top_k=top_k))
    assert got.dtype == np.int32 and got.shape[0] == bm.shape[0] and got.shape[2] == top_k
    for t in range(bm.shape[0]):
        routed = set(np.flatnonzero(bm[t].reshape(-1, bm.shape[-1]).any(axis=0)))
        assert routed <= set(got[t].ravel())
        assert all(len(set(row)) == top_k for row in got[t].tolist())  # no duplicate in a row
    with pytest.raises(ValueError):
        traces.from_served_trace(bm, top_k=0)


@pytest.fixture(scope="module")
def short_replay():
    """The JAX package's replay of a short trace (12 steps at E 64, G' 4),
    with and without the richer signals. Its loop calls the predictor's
    functions eagerly, which compiles every ``jnp`` op inside them once per
    shape (about 4 s); they run here under ``jax.jit``, one program each."""
    import jax

    from repro.core import prefetch as jpf

    static = {"predict_bitmap": {"static_argnames": ("placement", "budget")},
              "routed_bitmaps": {"static_argnums": 1}}
    trace = jtraces.zipf_routing_trace(12, 4, 64, 8, alpha=1.3, affinity=0.8, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("predict_extra_score", "predict_bitmap", "routed_bitmaps",
                     "position_buckets", "update_predictor"):
            mp.setattr(jpf, name, jax.jit(getattr(jpf, name), **static.get(name, {})))
        return trace, {rich: jtraces.predictor_hit_rate(trace, 64, 4, budget=4, rich=rich)
                       for rich in (True, False)}


@pytest.mark.parametrize("rich", [True, False])
def test_predictor_hit_rate_matches_reference(short_replay, rich):
    trace, ref = short_replay
    got = traces.predictor_hit_rate(trace, 64, 4, budget=4, rich=rich, device="cpu")
    assert abs(got - ref[rich]) <= 1e-6, (got, ref[rich])


def test_predictor_acceptance_on_skewed_served_and_uniform_traces():
    """The JAX package's acceptance (tests/test_syncfree.py:263 and
    tests/test_serving.py:408), on the port alone: >= 0.9 on the R1
    acceptance trace (E 256 over G' 4, budget 16) and on the served fixture,
    the richer signals no worse than hotness alone, uniform routing < 0.6."""
    skewed = traces.zipf_routing_trace(48, 8, 256, 8, alpha=1.3, affinity=0.8, drift_every=24,
                                       seed=7)
    rich = traces.predictor_hit_rate(skewed, 256, 4, budget=16, device="cpu")
    plain = traces.predictor_hit_rate(skewed, 256, 4, budget=16, rich=False, device="cpu")
    assert rich >= 0.9 and rich >= plain - 0.02, (rich, plain)
    uniform = traces.zipf_routing_trace(32, 8, 256, 8, alpha=0.0, affinity=0.0, seed=7)
    assert traces.predictor_hit_rate(uniform, 256, 4, budget=16, device="cpu") < 0.6
    served = traces.from_served_trace(np.load(SERVED_TRACE)["bitmaps"], top_k=2)
    assert traces.predictor_hit_rate(served, 32, 4, budget=8, device="cpu") >= 0.9


def test_predictor_hit_rate_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace = traces.zipf_routing_trace(2, 2, 16, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traces.predictor_hit_rate(trace, 16, 4, budget=2)
    with pytest.raises(ValueError, match="steps, rows, top_k"):
        traces.predictor_hit_rate(trace[0], 16, 4, budget=2, device="cpu")


# --------------------------------------------------------------------------
# Contention: Table 2 and Listing 1 (tests/test_core.py:70-118).
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16, 24])
def test_contention_probabilities_match_reference(n):
    got, ref = contention.contention_probabilities(n), jcontention.contention_probabilities(n)
    assert got.keys() == ref.keys()
    assert all(abs(got[c] - ref[c]) <= 1e-12 for c in ref)
    assert abs(sum(got.values()) - 1.0) <= 1e-9
    assert contention.expected_contention(n) == jcontention.expected_contention(n)
    if n == 8:  # Table 2's DWDP8 row, percent to 2 places
        assert [round(100 * got[c], 2) for c in (1, 2, 3, 4)] == [39.66, 39.66, 16.52, 3.67]


def test_copy_plan_matches_reference():
    for sizes, peers, slice_bytes in (({"w": 10}, [1, 2, 3], 4), ({"a": 7, "b": 3}, [2, 0], 2)):
        got = contention.build_copy_plan(sizes, peers, slice_bytes)
        assert got == jcontention.build_copy_plan(sizes, peers, slice_bytes)
    plan = contention.build_copy_plan({"w": 10}, [1, 2, 3], slice_bytes=4)
    assert [p for (_, p, o, _) in plan if o == 0] == [1, 2, 3]
    assert [p for (_, p, o, _) in plan if o == 4] == [2, 3, 1]
    assert contention.PullRequest(1, 2, 3) == contention.PullRequest(dst=1, src=2, bytes=3)


@pytest.mark.parametrize("slice_bytes,inflight", [(None, 1), (1 << 20, 2), (3 << 19, 3)])
def test_copy_engine_matches_reference(slice_bytes, inflight):
    kw = dict(inflight=inflight, jitter_p=0.3, jitter_mult=2.5)
    for seed, offsets in ((0, None), (5, [0.0, 1e-4, 2e-4, 0.0, 5e-5, 0.0])):
        got = contention.CopyEngineSim(6, 900e9, slice_bytes, **kw).run_per_dst(
            8 << 20, seed, offsets)
        ref = jcontention.CopyEngineSim(6, 900e9, slice_bytes, **kw).run_per_dst(
            8 << 20, seed, offsets)
        assert got == ref


def test_tdm_speedup_matches_reference():
    got = contention.tdm_speedup(8, pull_bytes=16 << 20, bw=900e9, seeds=range(4))
    assert got == jcontention.tdm_speedup(8, pull_bytes=16 << 20, bw=900e9, seeds=range(4))
    assert got["speedup"] >= 1.0  # slicing never hurts in the model


# --------------------------------------------------------------------------
# The roofline's fault pricing (tests/test_rank_death.py:160-219,
# tests/test_faults.py:479).
# --------------------------------------------------------------------------
@pytest.mark.parametrize("e,g,dead", [(20, 4, 1), (12, 4, 3), (256, 4, 2), (256, 8, 7),
                                      (256, 8, 0), (256, 3, 1)])
def test_reshard_plan_rows_match_reference(e, g, dead):
    got, ref = roofline.reshard_plan_rows(e, g, dead), jroofline.reshard_plan_rows(e, g, dead)
    _assert_same(got, ref)
    assert int((got["local"] + got["wire"] + got["source"]).sum()) == e
    assert int(got["source"].sum()) == min(e, (dead % g + 1) * -(-e // g)) - dead % g * -(-e // g)
    if (e, g, dead) == (256, 4, 2):
        assert got["local"].tolist() == [64, 42, 64] and got["wire"].tolist() == [22, 0, 0]
        assert got["source"].tolist() == [0, 44, 20] and got["new_local"] == 86
    with pytest.raises(ValueError, match="group >= 2"):
        roofline.reshard_plan_rows(e, 1, 0)


DENSE_J = JArch(name="dense", family="dense", num_layers=2, d_model=32, num_heads=2,
                num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128)


@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("hw", ["GB200", "H100", "card4"])
def test_rank_death_recovery_matches_reference(group, hw):
    hw = {"GB200": roofline.GB200, "H100": roofline.H100, "card4": roofline.card_view(4)}[hw]
    for jcfg, wb in ((R1_J, 1), (R1_J, 2), (TRACE_J, 1), (DENSE_J, 1)):
        got = roofline.rank_death_recovery(_port_cfg(jcfg), group=group, hw=hw, weight_bytes=wb)
        _assert_same(got, jroofline.rank_death_recovery(jcfg, group=group, hw=_jax_hw(hw),
                                                        weight_bytes=wb))
    dense = roofline.rank_death_recovery(_port_cfg(DENSE_J), group=group, hw=hw)
    assert dense["wire_bytes"] == 0.0 and dense["seconds"] == 2e-4
    r1 = roofline.rank_death_recovery(R1, group=group, hw=hw)
    assert r1["seconds"] > 2e-4 and r1["per_survivor_wire_bytes"] <= (
        r1["wire_bytes"] + r1["source_bytes"])


LADDER_TABLES = {
    "predictive": (JTable.uniform(layout="split", fetch="predictive", cache_budget=8),
                   ["predictive", "predictive+excl", "demand", "all", "reshard"]),
    "sync_free": (JTable.uniform(layout="split", fetch="sync_free"),
                  ["sync_free", "sync_free+excl", "demand", "all", "reshard"]),
    "demand": (JTable.uniform(layout="split", fetch="demand"), ["demand", "all", "reshard"]),
    "all": (JTable.uniform(), ["all", "reshard"]),
}


@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("table", sorted(LADDER_TABLES))
def test_degraded_step_times_match_reference(group, table):
    jt, labels = LADDER_TABLES[table]
    for kw in ({}, {"excluded_peers": 2, "predict_hit": 0.8, "validate": False}):
        got = roofline.degraded_step_times(R1, _port_table(jt), tokens=8, group=group, **kw)
        _assert_same(got, jroofline.degraded_step_times(R1_J, jt, tokens=8, group=group, **kw))
        assert [r["fetch"] for r in got] == labels
    assert got[-1]["reshard_wire_mb"] > 0 and got[-1]["recovery_stall_us"] > 0
    if table == "predictive":
        assert got[-1]["vs_healthy"] > 1.0  # priced at the shrunk group


@pytest.mark.parametrize("jcfg", [R1_J, TRACE_J, DENSE_J, jget_arch("gemma3-27b")],
                         ids=lambda c: c.name)
def test_active_param_count_matches_reference(jcfg):
    cfg = _port_cfg(jcfg)
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.active_param_count() <= cfg.param_count()


# --------------------------------------------------------------------------
# The fail-stop re-shard (tests/test_rank_death.py:221).
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dead", [0, 1, 2, 3])
def test_reshard_split_bank_bitwise_reference(dead):
    e = 12
    old, new = make_placement(e, 4), make_placement(e, 3)
    jold, jnew = jmake_placement(e, 4), jmake_placement(e, 3)
    src = {"w": np.arange(e * 2, dtype=np.float32).reshape(e, 2),
           "b": {"v": np.arange(e * 6, dtype=np.float32).reshape(e, 3, 2) * -0.5}}
    table = old.table()

    def shard(tree, r):
        return {k: shard(v, r) if isinstance(v, dict) else v[table[r]].copy()
                for k, v in tree.items()}

    jshards = [shard(src, r) for r in range(4)]
    for leaf in (jshards[dead]["w"], jshards[dead]["b"]["v"]):
        leaf[:] = np.nan  # the dead peer's memory: recovery must not read it
    source = {"w": torch.from_numpy(src["w"]), "b": {"v": torch.from_numpy(src["b"]["v"])}}
    shards = [{"w": torch.from_numpy(s["w"]), "b": {"v": torch.from_numpy(s["b"]["v"])}}
              for s in jshards]
    got = reshard_split_bank(shards, old, new, dead, source)
    ref = jreshard(jshards, jold, jnew, dead, src)
    assert len(got) == len(ref) == new.subgroup_size
    for p, (g, r) in enumerate(zip(got, ref)):
        for leaf, jleaf, canon in ((g["w"], r["w"], src["w"]), (g["b"]["v"], r["b"]["v"],
                                                                 src["b"]["v"])):
            assert leaf.shape[0] == new.local_count and torch.isfinite(leaf).all()
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
            fresh = np.concatenate([canon, np.zeros_like(canon[:new.num_padded - e])])
            np.testing.assert_array_equal(leaf.numpy(), fresh[new.table()[p]])
    with pytest.raises(ValueError, match="expert set"):
        reshard_split_bank(shards, old, make_placement(8, 3), dead, source)
    with pytest.raises(ValueError, match="exactly the dead rank"):
        reshard_split_bank(shards, old, make_placement(e, 2), dead, source)


@pytest.mark.parametrize("e,g,dead", [(256, 4, 2), (256, 8, 5), (20, 4, 1), (12, 4, 0)])
def test_reshard_runs_count_the_plan_rows(e, g, dead):
    """The re-shard copies contiguous runs, at most one per old owner a new
    range overlaps (R1's 4 -> 3: at most three per new shard), and its rows
    by origin are ``reshard_plan_rows``'."""
    runs = reshard_runs(make_placement(e, g), make_placement(e, g - 1), dead)
    plan = roofline.reshard_plan_rows(e, g, dead)
    for pos, pos_runs in enumerate(runs):
        for kind in ("local", "wire", "source"):
            assert sum(b - a for k, _, a, b in pos_runs if k == kind) == plan[kind][pos]
        assert len({owner for _, owner, _, _ in pos_runs}) == len(pos_runs)
        if (e, g) == (256, 4):
            assert len(pos_runs) <= 3


# --------------------------------------------------------------------------
# The cluster simulator (tests/test_rank_death.py:267-330,
# tests/test_faults.py:465-495).
# --------------------------------------------------------------------------
R1_DWDP = dict(gen_mode="dwdp", osl=64, horizon_s=30.0)
TRACE_KW = dict(ctx_gpus=2, gen_gpus=8, gen_mode="dwdp", expert_fetch="sync_free", gen_batch=8,
                isl_max=64, osl=64)
SIM_CASES = {
    "default": (R1_J, dict(horizon_s=20.0)),
    "dep": (R1_J, dict(ctx_mode="dep", horizon_s=20.0)),
    "dwdp-all": (R1_J, R1_DWDP),
    "dwdp-demand": (R1_J, dict(R1_DWDP, expert_fetch="demand")),
    "dwdp-predictive": (R1_J, dict(R1_DWDP, expert_fetch="predictive", cache_budget=16)),
    "dwdp-sync_free": (R1_J, dict(R1_DWDP, expert_fetch="sync_free", cache_budget=16,
                                  predict_hit_rate=0.9, cache_hit_rate=0.5)),
    "storm": (R1_J, dict(R1_DWDP, expert_fetch="predictive", cache_budget=16, validate_fetch=True,
                         fault_rate=0.3, straggler_ranks=2, straggler_slowdown=3.0)),
    # no request completes in 300 s: a 0.63 s decode step, 1024 output tokens
    "zero-completion": (R1_J, dict(gen_mode="dwdp", expert_fetch="predictive", cache_budget=16,
                                   gen_gpus=8)),
    "fault-trace": (TRACE_J, dict(TRACE_KW, arrival_rate=8.0, horizon_s=10.0,
                                  fault_trace=FAULT_TRACE)),
    "trace-healthy": (TRACE_J, dict(TRACE_KW, arrival_rate=8.0, horizon_s=10.0)),
    "rank-death": (TRACE_J, dict(TRACE_KW, arrival_rate=5e4, horizon_s=0.01,
                                 fault_trace=((24, "rank_death", 3),))),
}


def _sim_configs(case):
    jcfg, kw = SIM_CASES[case]
    jkw, pkw = dict(kw), dict(kw)
    if isinstance(kw.get("fault_trace"), tuple):
        from repro.core.faults import FaultTrace as JTrace

        jkw["fault_trace"] = JTrace.from_events(kw["fault_trace"])
        pkw["fault_trace"] = FaultTrace.from_events(kw["fault_trace"])
    return jsim.SimConfig(cfg=jcfg, **jkw), simulator.SimConfig(cfg=_port_cfg(jcfg), **pkw)


@pytest.fixture(scope="module")
def sim_refs():
    """The JAX package's ``run()`` summary, decode step times and degraded
    table of every case."""
    out = {}
    for case in SIM_CASES:
        jsc, _ = _sim_configs(case)
        sim = jsim.ClusterSimulator(jsc)
        steps = [sim.gen_step_time(b) for b in (1, 8, 64)]
        steps += [sim.gen_step_time(8, fault_rate=fr) for fr in (0.0, 1.0)]
        out[case] = dict(summary=jsim.ClusterSimulator(jsc).run(), steps=steps,
                         ctx=[sim.ctx_time([8192]), sim.ctx_time([7000, 8192, 6600])],
                         degraded=sim.degraded_table(),
                         badness=sim.degraded_table([0.9, 0.1, 0.7, 0.0]))
    return out


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulator_matches_reference(sim_refs, case):
    _, sc = _sim_configs(case)
    sim = simulator.ClusterSimulator(sc)
    ref = sim_refs[case]
    steps = [sim.gen_step_time(b) for b in (1, 8, 64)]
    steps += [sim.gen_step_time(8, fault_rate=fr) for fr in (0.0, 1.0)]
    _assert_same(steps, ref["steps"])
    _assert_same([sim.ctx_time([8192]), sim.ctx_time([7000, 8192, 6600])], ref["ctx"])
    _assert_same(sim.degraded_table(), ref["degraded"])
    _assert_same(sim.degraded_table([0.9, 0.1, 0.7, 0.0]), ref["badness"])
    summary = simulator.ClusterSimulator(sc).run()
    _assert_same(summary, ref["summary"])
    if case == "zero-completion":
        assert summary["completed"] == 0
    if case == "fault-trace":  # the fixture's step-24 rank death fired
        assert summary["rank_deaths"] == 1 and summary["time_to_recover_p50_s"] > 0
        assert summary["completed"] == ref["summary"]["completed"] > 0
    if case == "rank-death":
        assert summary["requeued"] >= 1 and summary["migrated"] >= 1


def test_simulator_scenario_replay_orders():
    """tests/test_faults.py:479: the checksum metadata never makes a step
    faster, a storm of fallbacks and stragglers costs time, and the ladder's
    rows are labelled by the fetch each rung runs."""
    base = dict(cfg=R1, gen_mode="dwdp", expert_fetch="predictive", cache_budget=16, gen_gpus=8)
    t0 = simulator.ClusterSimulator(simulator.SimConfig(**base)).gen_step_time(64)
    t1 = simulator.ClusterSimulator(simulator.SimConfig(**base, validate_fetch=True)).gen_step_time(64)
    storm = simulator.ClusterSimulator(simulator.SimConfig(
        **base, validate_fetch=True, fault_rate=0.3, straggler_ranks=2, straggler_slowdown=3.0))
    assert t1 >= t0 and storm.gen_step_time(64) > t1
    assert [r["fetch"] for r in storm.degraded_table()] == [
        "predictive", "predictive+excl", "demand", "all", "reshard"]
    sc = simulator.SimConfig(cfg=TRACE, fault_trace=FAULT_TRACE)
    assert isinstance(sc.fault_trace, FaultTrace) and "rank_death" in sc.fault_trace.kinds
    for bad in (dict(fault_rate=1.5), dict(straggler_slowdown=0.5), dict(straggler_ranks=-1)):
        with pytest.raises(ValueError):
            simulator.SimConfig(cfg=R1, **bad)


def test_pareto_sweep_matches_reference():
    kw = dict(ctx_gpu_options=(2, 4), rate_options=(1.0,), horizon_s=10.0)
    for mode in ("dwdp", "dep"):
        _assert_same(simulator.pareto_sweep(R1, ctx_mode=mode, **kw),
                     jsim.pareto_sweep(R1_J, ctx_mode=mode, **kw))


# --------------------------------------------------------------------------
# The modeled fleet (tests/test_serving.py:310-370,
# tests/test_rank_death.py:350-396).
# --------------------------------------------------------------------------
def _fleet(pkg, fetch, straggle):
    """tests/test_serving.py's fleet: two 6-layer R1 replicas (2 context and
    8 generation GPUs each), the second a straggler when ``straggle``, 16
    requests of 4096 / 8192 tokens."""
    sv, sim, jcfg = (serving, simulator, R1_J) if pkg == "port" else (jserving, jsim, R1_J)
    jcfg = dataclasses.replace(jcfg, name="r1-serving-test", num_layers=6,
                               moe=dataclasses.replace(jcfg.moe, first_dense=1))
    jt = JTable(default=JPolicy(layout="split"), families=(("moe_experts", JPolicy(
        layout="split", fetch=fetch, cache_budget=128 if fetch == "sync_free" else 0)),))
    cfg, table = (_port_cfg(jcfg), _port_table(jt)) if pkg == "port" else (jcfg, jt)
    scheds = []
    for i in range(2):
        sc = sim.SimConfig(cfg=cfg, ctx_gpus=2, gen_gpus=8, ctx_mode="dwdp", gen_mode="dwdp",
                           gen_batch=8, gen_policies=table, predict_hit_rate=0.9,
                           cache_hit_rate=0.5, isl_max=8192, osl=1024,
                           straggler_ranks=1 if (straggle and i == 1) else 0,
                           straggler_slowdown=2.5)
        scheds.append(sv.ServingScheduler(sv.ModeledReplicaClient(sc, num_slots=8)))
    fleet = sv.MultiReplicaEngine(scheds)
    fleet.submit(sv.synthesize_workload(sv.WorkloadConfig(
        num_requests=16, isl_buckets=(4096, 8192), isl_weights=(0.3, 0.7), osl=64, seed=5)))
    return fleet, fleet.run().summary(fleet.horizon())


@pytest.mark.parametrize("fetch,straggle", [("demand", True), ("demand", False),
                                            ("sync_free", True)])
def test_modeled_fleet_matches_reference(fetch, straggle):
    fleet, summary = _fleet("port", fetch, straggle)
    jfleet, jsummary = _fleet("jax", fetch, straggle)
    _assert_same(summary, jsummary)
    _assert_same([s.t for s in fleet.schedulers], [s.t for s in jfleet.schedulers])
    assert summary["completed"] == 16
    if straggle:  # the straggler's clock runs long; the healthy replica's does not
        assert fleet.schedulers[1].t > 1.5 * fleet.schedulers[0].t


def _kill_fleet(pkg):
    """tests/test_rank_death.py's fleet: two replicas of 4 generation GPUs,
    16 requests; rank 0 of replica 0 killed after 5 steps of each."""
    sv, sim, cfg = (serving, simulator, TRACE) if pkg == "port" else (jserving, jsim, TRACE_J)
    scheds = [sv.ServingScheduler(sv.ModeledReplicaClient(sim.SimConfig(
        cfg=cfg, ctx_gpus=2, gen_gpus=4, gen_mode="dwdp", expert_fetch="sync_free", gen_batch=8,
        isl_max=64, osl=32), num_slots=8)) for _ in range(2)]
    fleet = sv.MultiReplicaEngine(scheds)
    fleet.submit(sv.synthesize_workload(sv.WorkloadConfig(num_requests=16, isl_buckets=(64,),
                                                           osl=32, seed=11)))
    for _ in range(5):
        for s in fleet.schedulers:
            s.step()
    active = fleet.schedulers[0].active_count()
    report = fleet.kill_rank(0, 2)
    return fleet, active, report, fleet.run().summary(fleet.horizon())


def test_modeled_kill_rank_matches_reference():
    fleet, active, report, summary = _kill_fleet("port")
    _, jactive, jreport, jsummary = _kill_fleet("jax")
    assert (active, report) == (jactive, jreport)
    _assert_same(summary, jsummary)
    assert active > 0 and report["migrated"] + report["requeued"] == active
    assert report["requeued"] >= 1                 # slot 2 sat on the dead rank
    assert summary["completed"] == 16              # no accepted request lost
    assert summary["rank_deaths"] == 1 and summary["time_to_recover_p50_s"] > 0
    assert fleet.schedulers[0].client.sim_cfg.gen_gpus == 3  # priced at the survivors
    client = serving.ModeledReplicaClient(simulator.SimConfig(cfg=TRACE, ctx_gpus=1, gen_gpus=1,
                                                              gen_batch=4))
    with pytest.raises(ValueError, match="1-GPU"):
        client.kill_rank(0)
