"""The port's serving layer (``repro_torch.runtime.serving``), its serving
metrics and its static wire-byte model against the JAX package's, on the
same inputs:

- ``synthesize_workload`` bitwise (lengths, arrivals, prompt tokens);
- ``AdmissionController`` decisions and eviction streaks over a grid;
- ``ServingScheduler``, ``ReplicaRouter`` and ``MultiReplicaEngine`` driven
  through both packages by one deterministic fake client (a copy of
  tests/test_serving.py's): call logs, outputs, records and
  ``summary(horizon)`` equal, for rolling and epoch admission, arrivals,
  SLO queueing and shedding, evict and resume, a plan-mismatch requeue,
  the router and a fail-stop quarantine;
- ``ServingMetrics.summary`` on records with gather and predictive shares,
  and with zero denominators;
- ``gathered_wire_bytes_per_step`` and the prefetch byte formulas;
- ``validate_restore_plan``.

Then the live client on the port alone (the predictive state across
admit, evict and resume, routed-expert traces, wire bytes that follow the
installed variant) and the serving command line. The live serve held
against the JAX engine's tokens is in tests/test_torch_engine.py.
"""
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
from repro.core import execution as jexec
from repro.core import prefetch as jpf
from repro.core import strategy as jstrategy
from repro.core.placement import make_placement as jplacement
from repro.models.transformer import build_model as jbuild_model
from repro.runtime import metrics as jmetrics
from repro.runtime import serving as jserving
from repro.runtime.engine import validate_restore_plan as jvalidate
from repro_torch.configs import get_arch, reduced_variant
from repro_torch.configs.base import ArchConfig, InputShape, MoEConfig
from repro_torch.core import execution, prefetch, strategy
from repro_torch.core.placement import make_placement
from repro_torch.launch.serve import build_engine, main
from repro_torch.models.transformer import build_model
from repro_torch.runtime import metrics, serving
from repro_torch.runtime.engine import validate_restore_plan

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

# --------------------------------------------------------------------------
# Workload and admission.
# --------------------------------------------------------------------------
WORKLOADS = [
    dict(num_requests=16, isl_buckets=(32, 64), isl_weights=(0.5, 0.5), osl=8,
         osl_jitter=0.5, arrival_rate=2.0, seed=11),
    dict(num_requests=12, isl_buckets=(32, 64), isl_weights=(1.0, 0.0), osl=8),
    dict(num_requests=9, isl_buckets=(512, 1024, 8192), isl_weights=(0.2, 0.5, 0.3), osl=16,
         osl_jitter=0.25, arrival_rate=0.5, seed=3),
]


@pytest.mark.parametrize("kw", WORKLOADS, ids=lambda kw: f"n{kw['num_requests']}")
@pytest.mark.parametrize("vocab", [0, 129280])
def test_workload_matches_reference_bitwise(kw, vocab):
    got = serving.synthesize_workload(serving.WorkloadConfig(**kw), vocab_size=vocab,
                                      req_id_base=5)
    ref = jserving.synthesize_workload(jserving.WorkloadConfig(**kw), vocab_size=vocab,
                                       req_id_base=5)
    assert len(got) == len(ref) == kw["num_requests"]
    for g, r in zip(got, ref):
        assert (g.req_id, g.prompt_len, g.target_len, g.arrival) == (
            r.req_id, r.prompt_len, r.target_len, r.arrival)
        if vocab:
            assert g.tokens.dtype == r.tokens.dtype and np.array_equal(g.tokens, r.tokens)
        else:
            assert g.tokens is None and r.tokens is None


def test_workload_config_checks_match_reference():
    for bad in (dict(num_requests=-1), dict(num_requests=1, isl_buckets=()),
                dict(num_requests=1, isl_buckets=(32,), isl_weights=(0.5, 0.5)),
                dict(num_requests=1, osl_jitter=1.0)):
        for pkg in (serving, jserving):
            with pytest.raises(ValueError):
                pkg.WorkloadConfig(**bad)
    for pkg in (serving, jserving):
        with pytest.raises(ValueError):
            pkg.ServedRequest(req_id=0, prompt_len=0, target_len=1)
        with pytest.raises(ValueError):
            pkg.SLOConfig(evict_after=0)


SLOS = [dict(), dict(target_tps_user=2.0, ttft_budget_s=10.0, max_queue=2),
        dict(target_tps_user=10.0, evict_after=3), dict(max_queue=1, ttft_budget_s=0.5)]


@pytest.mark.parametrize("slo", SLOS, ids=str)
def test_admission_matches_reference(slo):
    def step_time(b):
        return 0.1 * b if b < 6 else 0.0

    got = serving.AdmissionController(serving.SLOConfig(**slo), step_time)
    ref = jserving.AdmissionController(jserving.SLOConfig(**slo), step_time)
    for active in range(0, 8):
        for queue_len in (0, 1, 2, 3):
            for waited in (0.0, 0.4, 11.0):
                kw = dict(active=active, queue_len=queue_len, queued_for=waited)
                assert got.decide(**kw) == ref.decide(**kw), kw
    rng = np.random.default_rng(1)
    for _ in range(60):
        dur, active = float(rng.choice([0.05, 0.5, 0.0])), int(rng.integers(0, 4))
        assert got.observe_step(dur, active) == ref.observe_step(dur, active)
    for pkg in (got, ref):
        pkg.count("evicted", 2)
    assert got.counters == ref.counters
    assert {serving.ADMIT, serving.QUEUE, serving.REJECT} == {
        jserving.ADMIT, jserving.QUEUE, jserving.REJECT}


# --------------------------------------------------------------------------
# The scheduler, the router and the fleet through both packages.
# --------------------------------------------------------------------------
class FakeClient:
    """Deterministic replica client: fixed durations, token = 100 * (slot +
    1) + step count, full call log (tests/test_serving.py's). ``kill_rank``
    migrates the even active slots and requeues the odd ones; with
    ``refuse_resume`` a resumed admission raises as a plan mismatch does."""

    def __init__(self, num_slots=2, step_dur=1.0, admit_dur=0.25, warm=True,
                 refuse_resume=False):
        self.num_slots = num_slots
        self.num_gpus = 1
        self.step_dur = step_dur
        self.admit_dur = admit_dur
        self.warm = warm
        self.refuse_resume = refuse_resume
        self.log = []
        self._n = 0

    def admit(self, slot, req):
        self.log.append(("admit", slot, req.req_id, req.resume is not None))
        if req.resume is not None and self.refuse_resume:
            raise ValueError("snapshot_slot resume rejected")
        return 7, self.admit_dur

    def step(self, active):
        self.log.append(("step", tuple(active)))
        self._n += 1
        return [100 * (i + 1) + self._n for i in range(self.num_slots)], self.step_dur

    def step_time(self, batch):
        return self.step_dur

    def release(self, slot):
        self.log.append(("release", slot))

    def evict(self, slot):
        self.log.append(("evict", slot))
        return {"fake": True}

    def has_bucket(self, prompt_len):
        return self.warm

    def kill_rank(self, dead_rank, active_slots=()):
        self.log.append(("kill", dead_rank, tuple(active_slots)))
        return {"migrate": {s: {"plan": None} for s in active_slots if s % 2 == 0},
                "requeue": [s for s in active_slots if s % 2], "seconds": 0.5}


def _reqs(pkg, lens, arrival=0.0):
    return [pkg.ServedRequest(req_id=i, prompt_len=8, target_len=n, arrival=arrival)
            for i, n in enumerate(lens)]


def _run_scenario(name, pkg):
    """(call logs, outputs, records, summary, extra) of one scenario."""
    srv = pkg
    clients, extra = [], {}

    def sched(client=None, **kw):
        client = client or FakeClient()
        clients.append(client)
        return srv.ServingScheduler(client, **kw)

    if name in ("rolling", "epoch"):
        s = sched(epoch_mode=name == "epoch")
        s.submit(_reqs(srv, [2, 8, 2, 8]))
        m, horizon, scheds = s.run(), s.t, [s]
    elif name == "arrivals":
        s = sched(FakeClient(num_slots=3, step_dur=0.2))
        wl = srv.WorkloadConfig(num_requests=7, isl_buckets=(8, 16), osl=5, osl_jitter=0.5,
                                arrival_rate=1.5, seed=4)
        s.submit(srv.synthesize_workload(wl))
        m, horizon, scheds = s.run(), s.t, [s]
    elif name in ("evict", "requeue"):
        adm = srv.AdmissionController(srv.SLOConfig(target_tps_user=10.0, evict_after=2),
                                      lambda b: 0.01)
        s = sched(FakeClient(refuse_resume=name == "requeue"), admission=adm)
        s.submit(_reqs(srv, [6, 6, 3]))
        m, horizon, scheds = s.run(), s.t, [s]
        extra["counters"] = dict(adm.counters)
    elif name == "slo_queue":
        adm = srv.AdmissionController(
            srv.SLOConfig(target_tps_user=4.0, ttft_budget_s=2.0, max_queue=2), lambda b: 0.1 * b)
        s = sched(FakeClient(num_slots=3, step_dur=0.3), admission=adm)
        s.submit(_reqs(srv, [3, 5, 2, 6, 4, 3, 2, 5]))
        m, horizon, scheds = s.run(), s.t, [s]
        extra["counters"] = dict(adm.counters)
    elif name == "router":
        warm, cold = sched(FakeClient(warm=True)), sched(FakeClient(warm=False))
        router, req = srv.ReplicaRouter(), _reqs(srv, [4])[0]
        extra["picks"] = [router.pick([cold, warm], req)]
        warm.submit(_reqs(srv, [4, 4, 4]))
        extra["picks"].append(router.pick([cold, warm], req))
        m, horizon, scheds = warm.run(), warm.t, [warm]
    elif name in ("fleet", "quarantine"):
        scheds = [sched(FakeClient(num_slots=2, step_dur=d, warm=i == 0))
                  for i, d in enumerate((1.0, 0.4))]
        fleet = srv.MultiReplicaEngine(scheds)
        wl = srv.WorkloadConfig(num_requests=9, isl_buckets=(8, 16), isl_weights=(0.8, 0.2),
                                osl=4, osl_jitter=0.5, seed=2)
        fleet.submit(srv.synthesize_workload(wl))
        if name == "quarantine":
            scheds[0].run(max_steps=2)
            extra["kill"] = fleet.kill_rank(0, 3)
        m, horizon = fleet.run(), fleet.horizon()
        extra["assignments"] = dict(fleet.assignments)
        extra["num_gpus"] = m.num_gpus
    else:
        raise ValueError(name)
    records = sorted((dataclasses.asdict(r) for r in m.records), key=lambda r: r["req_id"])
    outputs = [dict(s.outputs) for s in scheds]
    extra["steps"] = [s.steps for s in scheds]
    return [c.log for c in clients], outputs, records, m.summary(horizon), extra


SCENARIOS = ["rolling", "epoch", "arrivals", "evict", "requeue", "slo_queue", "router", "fleet",
             "quarantine"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scheduler_matches_reference_on_a_fake_client(name):
    got = _run_scenario(name, serving)
    ref = _run_scenario(name, jserving)
    assert got == ref
    logs, _, records, summary, extra = got
    assert summary["completed"] == len(records) > 0
    if name == "epoch":
        assert extra["steps"] > _run_scenario("rolling", serving)[4]["steps"]
    if name in ("evict", "requeue"):
        assert summary["admission"]["evicted"] >= 1
        assert summary["admission"]["resumed" if name == "evict" else "requeued"] >= 1
    if name == "slo_queue":
        assert summary["admission"]["queued"] >= 1 and summary["admission"]["rejected"] >= 1
    if name == "router":
        assert extra["picks"] == [1, 0]  # locality at equal load, then load first
    if name == "quarantine":
        assert summary["rank_deaths"] == 1 and summary["migrated"] + summary["requeued"] >= 1
        assert any(entry[0] == "kill" for entry in logs[0])


def test_live_client_kill_rank_names_what_it_waits_for():
    """Without a standby engine there is nothing to swap in: ``kill_rank``
    says so (``ValueError``, as the reference's)."""
    client = serving.LiveReplicaClient(None, None, types.SimpleNamespace(max_batch=2))
    with pytest.raises(ValueError, match="standby engine"):
        client.kill_rank(1, [0])


# --------------------------------------------------------------------------
# Summaries.
# --------------------------------------------------------------------------
GATHER = {
    "full": 900.0e6, "fetched": 300.0e6,
    "families": {"moe_experts": {"full": 800.0e6, "fetched": 200.0e6},
                 "attn_qkv": {"full": 100.0e6, "fetched": 100.0e6},
                 "dense_ffn": {"full": 0.0, "fetched": 0.0}},
    "rounds": {"spec": 50.0e6, "corr": 150.0e6, "mirror": 1.5e3},
}


def _metrics(mod, case):
    m = mod.ServingMetrics(num_gpus=3)
    if case == "empty":
        return m
    for i in range(5):
        rec = mod.RequestRecord(req_id=i, arrival=0.1 * i, prompt_len=64, target_len=6,
                                first_token_time=1.0 + i, tokens_out=6 if i < 4 else 1)
        rec.done_time = None if i == 3 else rec.first_token_time + 0.37 * (i + 1)
        if case == "shares":
            rec.add_gather_share(GATHER)
            for step in range(i + 2):
                rec.add_gather_share(GATHER, 1.0 / (step + 2))
                rec.add_predict_share([16.0 + step, 5.0, 3.0 * step, 8.0, 1.0], 1.5e6,
                                      1.0 / (step + 2))
        m.records.append(rec)
    if case == "shares":
        m.record_admission("admitted", 4)
        m.record_admission("evicted")
        m.record_rank_death(migrated=2, requeued=1, seconds=0.75)
        m.record_transition(3, "switch", 0, "predictive")
        m.record_transition(7, "demote", 1, "demand")
    return m


@pytest.mark.parametrize("case", ["empty", "no_shares", "shares"])
def test_summary_matches_reference(case):
    got, ref = _metrics(metrics, case), _metrics(jmetrics, case)
    assert got.summary(12.5) == ref.summary(12.5)
    s = got.summary(12.5)
    for k in ("gather_fetch_ratio", "predict_hit_rate", "spec_hit_rate", "cache_hit_rate",
              "ttft_p50_s", "tpot_p95_s", "time_to_recover_p50_s", "tps_per_gpu"):
        assert k in s
    if case == "shares":
        assert s["gather_fetch_ratio"] == pytest.approx(1 / 3, abs=1e-4)
        assert set(s["gathered_mb_by_family"]) == {"moe_experts", "attn_qkv"}
        assert s["policy_switches"] == 1 and s["ladder_demotions"] == 1
        assert [r.hit_bytes for r in got.records] == [r.hit_bytes for r in ref.records]
    else:
        assert s["gather_fetch_ratio"] == s["predict_hit_rate"] == 0.0


# --------------------------------------------------------------------------
# Wire bytes.
# --------------------------------------------------------------------------
GEOM = dict(shard_attention=True, expert_axes=("model",), moe_exec="gather")
SIZES = {"data": 1, "model": 4}
# tests/test_torch_demand.py's configuration: E = 20, top-2, where the
# route-before-gather path engages at decode and prefill
E20 = dict(name="serving-test", family="moe", num_layers=4, d_model=32, num_heads=2,
           num_kv_heads=2, head_dim=16, d_ff=0, vocab_size=128)
E20_MOE = dict(num_experts=20, top_k=2, d_ff=48)


@pytest.fixture(scope="module")
def models():
    out = {"r1": (jbuild_model(jreduced(jget_arch("deepseek-r1")), SIZES, dtype=jnp.float32,
                               **GEOM),
                  build_model(reduced_variant(get_arch("deepseek-r1")), SIZES, device="cpu",
                              **GEOM)),
           "e20": (jbuild_model(JArch(**E20, moe=JMoE(**E20_MOE)), SIZES, dtype=jnp.bfloat16,
                                **GEOM),
                   build_model(ArchConfig(**E20, moe=MoEConfig(**E20_MOE)), SIZES,
                               dtype=torch.bfloat16, device="cpu", **GEOM))}
    return out


def _table(mod, fetch):
    cache = dict(cache_budget=4) if fetch in ("predictive", "sync_free") else {}
    return mod.PolicyTable.uniform(fetch=fetch, **cache)


@pytest.mark.parametrize("arch", ["r1", "e20"])
@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("fetch", ["all", "demand", "predictive", "sync_free"])
def test_gathered_wire_bytes_match_reference(models, arch, phase, fetch):
    jm, model = models[arch]
    shape = ("gen", 32, 2, "decode") if phase == "decode" else ("ctx", 16, 1, "prefill")
    jxp = jstrategy.make_execution_plan(jm, JShape(*shape), SIZES, policy=_table(jstrategy, fetch))
    xp = strategy.make_execution_plan(model, InputShape(*shape), SIZES,
                                      policy=_table(strategy, fetch))
    got = execution.gathered_wire_bytes_per_step(model, xp)
    assert got == jexec.gathered_wire_bytes_per_step(jm, jxp)
    active = arch == "e20" and fetch != "all"
    assert ("rounds" in got) == active
    assert ("mirror" in got.get("rounds", {})) == (active and fetch == "sync_free"
                                                   and phase == "decode")


@pytest.mark.parametrize("experts,group,redundancy", [(256, 4, 1), (20, 4, 1), (8, 6, 2)])
def test_prefetch_byte_formulas_match_reference(experts, group, redundancy):
    pl, jpl = (make_placement(experts, group, redundancy=redundancy),
               jplacement(experts, group, redundancy=redundancy))
    pe = 3 * 7168 * 2048 * 2
    assert prefetch.gather_bytes(pl, pe) == jpf.gather_bytes(jpl, pe)
    for budget in (0, 1, 3, 64, 1000):
        for validate in (False, True):  # the validated fetch's checksum table rides along
            assert prefetch.demand_fetch_bytes(pl, budget, pe, validate=validate) == (
                jpf.demand_fetch_bytes(jpl, budget, pe, validate=validate))
            for corr in (1, 5):
                assert prefetch.sync_free_fetch_bytes(pl, budget, corr, 2, pe,
                                                      validate=validate) == (
                    jpf.sync_free_fetch_bytes(jpl, budget, corr, 2, pe, validate=validate))
    for rows in (1, 2, 16):
        assert prefetch.sync_free_mirror_bytes(pl, rows) == jpf.sync_free_mirror_bytes(jpl, rows)


def test_validate_restore_plan_matches_reference():
    plan = {"model": "m", "mesh": (("data", 1), ("model", 4)), "cache_len": 32,
            "policies": "{}", "excl": ()}
    validate_restore_plan(None, plan)
    validate_restore_plan(plan, dict(plan))
    for other in (dict(plan, cache_len=64), dict(plan, mesh=(("data", 1), ("model", 2)),
                                                   policies="x")):
        with pytest.raises(ValueError) as got:
            validate_restore_plan(plan, other)
        with pytest.raises(ValueError) as ref:
            jvalidate(plan, other)
        assert str(got.value) == str(ref.value)


# --------------------------------------------------------------------------
# The live client on the port: predictive state, traces, wire bytes.
# --------------------------------------------------------------------------
def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _live(params=None, **kw):
    cfg = ArchConfig(**E20, moe=MoEConfig(**E20_MOE))
    eng, _ = build_engine(cfg, mesh_shape=(1, 4), prefill_len=16, prefill_buckets=(8,),
                          cache_len=48, max_batch=2, device="cpu", seed=3, params=params,
                          geom_kwargs=GEOM, capacity_from="global", **kw)
    return eng


def _requests(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [serving.ServedRequest(req_id=i, prompt_len=p, target_len=n,
                                  tokens=rng.integers(0, 128, p).astype(np.int32))
            for i, (p, n) in enumerate(lens)]


LENS = [(16, 6), (8, 7), (16, 5)]


@pytest.fixture(scope="module")
def all_fetch_serve():
    """The all-fetch engine and its serve of LENS through the live client."""
    base = _live()
    ref = serving.ServingScheduler(serving.LiveReplicaClient.from_engine(base))
    ref.submit(_requests(LENS))
    ref.run()
    return base, ref.outputs


@pytest.mark.parametrize("fetch", ["predictive", "sync_free"])
def test_live_predictive_serve_state_traces_and_wire_bytes(all_fetch_serve, fetch):
    """A predictive serve through the live client: its streams equal the
    all-fetch engine's (row-local capacity: a request's tokens do not
    depend on its neighbour); admit and evict leave the per-rank
    predictive state bitwise as it was; requests evicted from slots 0 and
    1 and resumed in each other's slot continue their streams; the routed
    trace has one (ranks, experts) bitmap per step with at most top_k *
    rows experts per rank and layer (sync-free folds every layer's routing
    into one mirror); the wire-byte model follows the installed bucket and
    policy."""
    base, ref_outputs = all_fetch_serve
    eng = _live(base.params, expert_fetch=fetch, cache_budget=4)
    client = serving.LiveReplicaClient.from_engine(eng)
    assert client.warmup() == 0 and client.has_bucket(8) and not client.has_bucket(12)
    trace = serving.RoutedTraceRecorder()
    sched = serving.ServingScheduler(client, on_step=trace)
    sched.submit(_requests(LENS))
    sched.run()
    assert sched.outputs == ref_outputs
    bm = trace.as_array()
    assert bm.shape == (sched.steps, 4, 20) and bm.dtype == bool
    layers = E20["num_layers"] if fetch == "sync_free" else 1
    assert (bm.sum(-1) <= E20_MOE["top_k"] * 2 * layers).all() and bm.any()
    s = sched.metrics.summary(sched.t)
    assert s["completed"] == 3 and s["predict_mb_predicted"] > 0
    assert s["gather_fetch_ratio"] > 0 and s["gathered_mb_by_round"]["spec"] > 0

    # admit and evict around a live predictive state
    a, b = _requests(LENS)[:2]
    first = [client.admit(0, a)[0], client.admit(1, b)[0]]
    toks = [client.step([0, 1])[0] for _ in range(2)]
    pred = [t.clone() for t in _leaves(eng.gen.state["pred"])]
    b.resume = client.evict(1)
    assert b.resume["plan"] == eng.gen.restore_plan() and client.can_resume(b.resume["plan"])
    assert not client.can_resume(dict(b.resume["plan"], cache_len=8))
    a.resume = client.evict(0)
    client.admit(0, b)
    client.admit(1, a)
    assert all(torch.equal(x, y) for x, y in zip(pred, _leaves(eng.gen.state["pred"])))
    for _ in range(2):
        toks.append(client.step([0, 1])[0][::-1])
    for rid in (0, 1):
        assert [first[rid]] + [int(t[rid]) for t in toks] == ref_outputs[rid][:5]
    with pytest.raises(ValueError, match="resume rejected"):
        eng.gen.admit(0, 9, 1, dict(b.resume, plan=dict(b.resume["plan"], excl=(2,))))

    # the wire-byte model of the installed variant
    for length in (8, 16):
        eng.ctx.prefill(eng.params, np.zeros(length, np.int64))
        assert eng.ctx.xp.seq_len == length
        assert eng.ctx.gather_bytes == execution.gathered_wire_bytes_per_step(
            eng.ctx.model, eng.ctx.xp)
    before = eng.gen.gather_bytes
    assert before["rounds"]["spec"] > 0 and eng.gen.last_pred_stats is not None
    assert eng.gen.set_policy(strategy.PolicyTable.uniform(fetch="demand", budget=1))
    assert eng.gen.last_pred_stats is None
    assert eng.gen.gather_bytes == execution.gathered_wire_bytes_per_step(
        eng.gen.model, eng.gen.xp) != before
    assert eng.gen.gather_bytes["fetched"] < base.gen.gather_bytes["fetched"]


def test_serve_cli_serves_a_workload_on_the_cpu(capsys):
    s = main(["--arch", "deepseek-r1", "--device", "cpu", "--serving", "--requests", "3",
              "--output-len", "3", "--isl-buckets", "32,64", "--replicas", "2",
              "--slo-tps-user", "1"])
    assert s["completed"] == 3 and s["total_output_tokens"] == 9 and s["tps_per_gpu"] > 0
    assert s["admission"]["admitted"] == 3 and s["gather_fetch_ratio"] == 1.0
    out = capsys.readouterr().out
    assert "one card per replica" in out and "replica 1:" in out
