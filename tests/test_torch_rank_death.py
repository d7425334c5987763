"""Rank death on the live engine: the survivors' mesh (G' - 1 = 3 on the
model axis), the standby's weights re-sharded from the survivors, the live
client's ``kill_rank`` and the degradation ladder's ``"reshard"`` rung,
held against the JAX package (``tests/test_rank_death.py``'s kill script,
``repro.runtime.serving.live``) on the CPU.

- The geometry and the activation plan at model 3 equal the reference's
  host code (``Geometry.build``, ``plan_activation_sharding``) for
  DeepSeek-R1's full widths and tiny configs: the unsharded attention, the
  padded vocabulary, FFN widths and experts, the prompt sharded over
  ``data`` only.
- ``checkpoint.convert.reshard_params`` turns a (1, 4) weight set into the
  (1, 3) one bitwise equal to a direct build from the same numpy weights
  (``tests/torch_refs.py``), for every dead position, with the dead rank's
  leaves NaN-filled first; the (1, 3) forward on the tiny MoE model's
  re-sharded weights matches the JAX package's (1, 1) run.
- ``LiveReplicaClient.kill_rank`` on stub servers agrees with the
  reference's on the slots it migrates and requeues, the wire bytes, the
  recovery's floor and the GPU count; a callable standby that fails leaves
  the client with no engine and says so.
- A two-replica (2, 4) fleet of the reference's tiny config loses rank 5
  after 4 decode steps: the migrated streams are bitwise the uninterrupted
  fleet's, every request completes, no variant is built after the
  standby's warmup; with a pre-built standby and with the port's callable
  one, which re-shards in place after the dying engine's graphs are
  released, and under the reference's predictive policy.

No subprocess, thread or sleep, and no JAX compile beyond ``torch_refs``'
tiny MoE run, which test_torch_model shares.
"""
import types

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import InputShape as JShape
from repro.configs.base import MoEConfig as JMoE
from repro.core.strategy import PolicyTable as JTable
from repro.core.strategy import degradation_ladder as jladder
from repro.core.strategy import plan_activation_sharding as jplan_sharding
from repro.models.transformer import Geometry as JGeometry
from repro.runtime.serving.live import LiveReplicaClient as JLiveReplicaClient
from repro_torch.checkpoint.convert import from_jax_params, reshard_params, to_checkpoint
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig, InputShape, MoEConfig
from repro_torch.core import roofline, strategy
from repro_torch.core.prefetch import tree_map
from repro_torch.launch.serve import build_engine
from repro_torch.models.transformer import Geometry, build_model, ffn_pad
from repro_torch.runtime.engine import GenerationServer
from repro_torch.runtime.serving import (
    LiveReplicaClient, MultiReplicaEngine, ServingScheduler, WorkloadConfig, synthesize_workload,
)
from torch_refs import (
    MOE_CACHE, MOE_CAP, MOE_EXPERTS, MOE_FIELDS, MOE_GEOM, MOE_PROMPT, canonical_weights, tiny_moe,
    tiny_moe_run, zero_padded_layout,
)

torch.set_num_threads(1)

# The reference's kill script (tests/test_rank_death.py): its config,
# target length, steps before the kill, dead rank (model axis 4 -> data row
# 1 -> slots 2 and 3 lose their KV) and policy, which fetches the experts
# predictively, so that the migrated snapshots leave predictor and cache
# state behind and the standby re-plans it. On the CPU a (2, 4) decode step
# under it takes about twice the all-fetch step, so the fleet runs it with
# the pre-built standby only; the callable standby's case fetches every
# expert. chip_smoke.py's phase 16 serves demand (ROADMAP Queue 3).
KILL_FIELDS = dict(name="rank-death", family="moe", num_layers=4, d_model=32, num_heads=2,
                   num_kv_heads=2, head_dim=16, d_ff=0, vocab_size=128)
KILL_EXPERTS = dict(num_experts=20, top_k=2, d_ff=48)
POLICY = {"moe_experts": "split:all:allgather"}
PREDICTIVE = {"moe_experts": "split:predictive:allgather:4:4:8"}
TARGET, PRE_STEPS, DEAD_RANK = 16, 4, 5
KILL_CFG = ArchConfig(**KILL_FIELDS, moe=MoEConfig(**KILL_EXPERTS))
TINY_CFG = ArchConfig(**MOE_FIELDS, moe=MoEConfig(**MOE_EXPERTS))
R1_GEOM = dict(MOE_GEOM)  # the chip's DeepSeek-R1 overrides, in both packages
TOL = 1e-4  # fp32, two frameworks summing in different orders (test_torch_model's ATOL, RTOL)


# --------------------------------------------------------------------------
# The geometry and the activation plan at G' = 3.
# --------------------------------------------------------------------------
GEOMETRY_CASES = {
    "r1": (lambda: get_arch("deepseek-r1"), lambda: jget_arch("deepseek-r1"), R1_GEOM),
    "r1-default": (lambda: get_arch("deepseek-r1"), lambda: jget_arch("deepseek-r1"), {}),
    "tiny-moe": (lambda: TINY_CFG, lambda: JArch(**MOE_FIELDS, moe=JMoE(**MOE_EXPERTS)), MOE_GEOM),
    "kill": (lambda: KILL_CFG, lambda: JArch(**KILL_FIELDS, moe=JMoE(**KILL_EXPERTS)), {}),
}


@pytest.mark.parametrize("mesh", [(1, 3), (2, 3)], ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_geometry_at_model_3_matches_reference(case, mesh):
    """``Geometry.build`` on the survivors' mesh: the same attention, FFN,
    vocabulary and expert layout as the reference's (host code)."""
    cfg_fn, jcfg_fn, kw = GEOMETRY_CASES[case]
    cfg, jcfg = cfg_fn(), jcfg_fn()
    sizes = {"data": mesh[0], "model": mesh[1]}
    got, ref = Geometry.build(cfg, sizes, **kw), JGeometry.build(jcfg, sizes, **kw)
    for field in ("attn_axes", "attn_shards", "kv_shard", "vocab_pad", "ffn_axes", "ffn_shards",
                  "expert_axes", "moe_exec", "attn_tp_ok"):
        assert getattr(got, field) == getattr(ref, field), field
    pl, jpl = got.moe_placement, ref.moe_placement
    assert (pl.num_padded, pl.local_count, pl.subgroup_size) == \
        (jpl.num_padded, jpl.local_count, jpl.subgroup_size)
    assert np.array_equal(pl.table(), jpl.table())
    dims = [cfg.moe.shared_d_ff] + [cfg.ffn_dim(layer) for layer in range(cfg.num_layers)]
    for f in filter(None, dims):
        assert ffn_pad(f, got.ffn_shards) == -(-f // ref.ffn_shards) * ref.ffn_shards
    if case == "r1":  # the trouble spots of DeepSeek-R1 on three ranks
        assert got.attn_axes == () and got.kv_shard == 1 and got.vocab_pad == 129_282
        assert (pl.num_padded, pl.local_count) == (258, 86)
        assert ffn_pad(18432, 3) // 3 == 6144 and ffn_pad(2048, 3) // 3 == 683


@pytest.mark.parametrize("shape", [("ctx", 1024, 1, "prefill"), ("gen", 1044, 4, "decode"),
                                   ("ctx", 8, 1, "prefill"), ("gen", 48, 4, "decode")],
                         ids=lambda s: f"{s[3]}-{s[1]}x{s[2]}")
@pytest.mark.parametrize("mesh", [(1, 3), (2, 3)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_activation_sharding_at_model_3_matches_reference(mesh, shape):
    """The survivors' prefill and decode plans: a 1024-token prompt shards
    over ``data`` only (1024 % 3), a decode batch of 4 over ``data``."""
    sizes = {"data": mesh[0], "model": mesh[1]}
    got = strategy.plan_activation_sharding(get_arch("deepseek-r1"), InputShape(*shape), sizes)
    assert got == jplan_sharding(jget_arch("deepseek-r1"), JShape(*shape), sizes)
    if mesh == (2, 3) and shape[1] == 1024:
        assert got == ((), ("data",))


# --------------------------------------------------------------------------
# The standby's weights.
# --------------------------------------------------------------------------
def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    else:
        yield path, tree


def _assert_bitwise(got, want) -> None:
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert torch.equal(a, b), path


def _poison(params: list, dead: int, g: int) -> None:
    """NaN into every leaf of model position ``dead`` that no survivor
    shares."""
    kept = {id(t) for m in range(g) if m != dead for _, t in _leaves(params[m])}
    for _, t in _leaves(params[dead]):
        if id(t) not in kept:
            t.fill_(float("nan"))


@pytest.fixture(scope="module")
def tiny_weights():
    """The tiny MoE model (a dense layer, an MoE layer with a shared
    expert) on (1, 1), (1, 3) and (1, 4) from one set of numpy weights."""
    models = {g: build_model(TINY_CFG, {"data": 1, "model": g}, device="cpu", **MOE_GEOM)
              for g in (1, 3, 4)}
    canon = canonical_weights(TINY_CFG, models[4], seed=27)
    trees = {g: zero_padded_layout(m, canon) for g, m in models.items()}
    return models, trees


@pytest.mark.parametrize("config", ["tiny-moe", "kill"])
@pytest.mark.parametrize("dead", range(4))
def test_reshard_params_is_a_direct_build(tiny_weights, config, dead):
    """(1, 4) -> (1, 3) (the tiny MoE model; the kill script's config, a
    scanned group, (2, 4) -> (2, 3)) with position ``dead`` lost is bitwise
    the weight set built straight on the survivors' mesh from the same
    numpy weights (checksum tables included), the dead rank's leaves
    NaN-filled first; ``free`` empties the old trees; ``to_checkpoint``
    inverts ``from_jax_params``."""
    if config == "tiny-moe":
        models, trees = tiny_weights
        m4, m3, src = models[4], models[3], trees[4]
        want = from_jax_params(trees[3], m3)
    else:  # a scanned group of four MoE layers, no dense FFN
        m4 = build_model(KILL_CFG, {"data": 2, "model": 4}, device="cpu")
        m3 = build_model(KILL_CFG, {"data": 2, "model": 3}, device="cpu")
        canon = canonical_weights(KILL_CFG, m4, seed=dead)
        src = zero_padded_layout(m4, canon)
        want = from_jax_params(zero_padded_layout(m3, canon), m3)
    params = from_jax_params(src, m4)
    _assert_bitwise(to_checkpoint(params, m4), tree_map(torch.as_tensor, src))
    _poison(params, dead, m4.geom.model_size)
    got = reshard_params(params, m4, m3, dead, src, free=True)
    assert len(got) == len(want) == m3.n_ranks
    for g, w in zip(got, want):
        _assert_bitwise(g, w)
    kept = {id(t) for p in got for _, t in _leaves(p)}
    assert all(id(t) in kept for p in params for _, t in _leaves(p))  # only the norms stay


def test_reshard_params_refuses_other_meshes(tiny_weights):
    models, trees = tiny_weights
    params = from_jax_params(trees[4], models[4])
    with pytest.raises(ValueError, match="model axis"):
        reshard_params(params, models[4], models[1], 0, trees[4])
    with pytest.raises(ValueError, match="dead model position"):
        reshard_params(params, models[4], models[3], 4, trees[4])


def _cat_states(states: list) -> dict:
    """One state of the prompts' prefill states (one layout), batch-major."""
    return {"pos": torch.cat([s["pos"] for s in states]), "layout": states[0]["layout"],
            "layers": {g: {key: [{f: torch.cat([s["layers"][g][key][r][f] for s in states])
                                  for f in ranks[0]} for r in range(len(ranks))]
                           for key, ranks in gd.items()}
                       for g, gd in states[0]["layers"].items()}}


def test_survivors_forward_matches_one_rank():
    """The (1, 3) forward (unsharded attention, padded vocabulary, shared
    expert and experts) on ``torch_refs.tiny_moe``'s (1, 4) weights
    re-sharded with position 1 lost (NaN-filled): both prompts' prefill
    logits within test_torch_model's ATOL/RTOL of the JAX package's (1, 1)
    run (``torch_refs.tiny_moe_run``, shared with test_torch_model), and
    every greedy decode step's tokens equal to its, from the prefill's state
    as it comes (its ring unsharded, the decode's sharded three ways)."""
    from repro_torch.core import execution

    w, ref = tiny_moe(), tiny_moe_run()
    m4, m3 = (build_model(w["cfg"], {"data": 1, "model": g}, device="cpu", **MOE_GEOM)
              for g in (4, 3))
    params = from_jax_params(w["jparams4"], m4)
    _poison(params, 1, 4)
    params = reshard_params(params, m4, m3, 1, w["jparams4"])
    assert m3.geom.attn_axes == () and m3.geom.vocab_pad == 258
    sizes, vocab = {"data": 1, "model": 3}, w["cfg"].vocab_size
    xp = strategy.make_execution_plan(m3, InputShape("p", MOE_PROMPT, 1, "prefill"), sizes,
                                      capacity_factor=MOE_CAP)
    ctx = execution.Ctx(model=m3, xp=xp, capture_len=MOE_CACHE)
    outs = [execution.forward_prefill(params, torch.as_tensor(t[None]), ctx)
            for t in ref["prompts"]]
    for out, want in zip(outs, ref["logits"]):
        got = out["last_logits"][:, :vocab].numpy()
        assert got.shape == want.shape == (1, vocab)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    tok = torch.as_tensor([[int(o["last_logits"][0, :vocab].argmax())] for o in outs])
    np.testing.assert_array_equal(tok[:, 0].numpy(), ref["first"])
    dxp = strategy.make_execution_plan(m3, InputShape("g", MOE_CACHE, 2, "decode"), sizes,
                                       capacity_factor=MOE_CAP)
    dctx, state = execution.Ctx(model=m3, xp=dxp), _cat_states([o["state"] for o in outs])
    # 16 % 3: the prompt is not sharded over model, the decode ring is, and
    # forward_decode lays the prefill's state out again (cache.relayout)
    assert (xp.seq_shards, dxp.seq_shards) == (1, 3)
    for want in ref["tokens"]:
        out = execution.forward_decode(params, tok, state, dctx)
        tok, state = out["next_token"].long(), out["state"]
        np.testing.assert_array_equal(tok[:, 0].numpy(), want)


# --------------------------------------------------------------------------
# kill_rank's report against the reference's, on stub servers.
# --------------------------------------------------------------------------
class _Variants:
    def __init__(self, log):
        self.log = log

    def release(self):
        self.log.append("release")


def _stub_gen(cfg, mesh, max_batch, log=None):
    def snapshot_slot(slot):
        return {"slot": slot}

    model = types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"))
    return types.SimpleNamespace(_mesh_sizes={"data": mesh[0], "model": mesh[1]},
                                 max_batch=max_batch, model=model, snapshot_slot=snapshot_slot,
                                 variants=_Variants(log if log is not None else []))


def _stub_engine(cfg, mesh, max_batch, log=None):
    return types.SimpleNamespace(params=["standby"], ctx=types.SimpleNamespace(
        variants=_Variants(log if log is not None else [])),
        gen=_stub_gen(cfg, mesh, max_batch, log))


@pytest.mark.parametrize("slots", [(), (0,), (0, 1, 2, 3), (1, 3)], ids=str)
@pytest.mark.parametrize("mesh", [(1, 4), (2, 4)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_kill_rank_report_matches_reference(mesh, slots):
    """For every dead rank: the same slots migrate (snapshotted) and requeue,
    the same modeled wire bytes, the seconds floored by the same modeled
    stall, one GPU fewer; the port's callable standby is called with the
    dead rank after the dying servers' graphs are released."""
    cfg, jcfg = get_arch("deepseek-r1"), jget_arch("deepseek-r1")
    g = mesh[0] * mesh[1]
    for dead in range(g):
        ref_client = JLiveReplicaClient(None, None, _stub_gen(jcfg, mesh, 4), num_gpus=g,
                                        standby=_stub_engine(jcfg, (mesh[0], 3), 4))
        ref = ref_client.kill_rank(dead, slots)
        floor = roofline.rank_death_recovery(cfg, group=g)["seconds"]
        log = []

        def standby(rank):
            log.append(("standby", rank))
            return _stub_engine(cfg, (mesh[0], 3), 4)

        for sb in (_stub_engine(cfg, (mesh[0], 3), 4), standby):
            client = LiveReplicaClient(["old"], types.SimpleNamespace(variants=_Variants(log)),
                                       _stub_gen(cfg, mesh, 4, log), num_gpus=g, standby=sb)
            got = client.kill_rank(dead, slots)
            assert got["migrate"] == ref["migrate"] and got["requeue"] == ref["requeue"]
            assert got["wire_bytes"] == pytest.approx(ref["wire_bytes"], rel=1e-12)
            assert got["seconds"] >= floor and ref["seconds"] >= floor
            assert client.num_gpus == ref_client.num_gpus == g - 1
            assert client.params == ["standby"] and client.standby is None
        assert log == ["release", "release", ("standby", dead)]


def test_kill_rank_refuses_without_a_standby_or_at_another_slot_count():
    cfg, jcfg = get_arch("deepseek-r1"), jget_arch("deepseek-r1")
    for client in (LiveReplicaClient(None, None, _stub_gen(cfg, (2, 4), 4)),
                   JLiveReplicaClient(None, None, _stub_gen(jcfg, (2, 4), 4))):
        with pytest.raises(ValueError, match="standby"):
            client.kill_rank(5, [0])
    for client in (LiveReplicaClient(None, None, _stub_gen(cfg, (2, 4), 4),
                                     standby=_stub_engine(cfg, (2, 3), 2)),
                   JLiveReplicaClient(None, None, _stub_gen(jcfg, (2, 4), 4),
                                      standby=_stub_engine(jcfg, (2, 3), 2))):
        with pytest.raises(ValueError, match="slot count"):
            client.kill_rank(5, [0])


@pytest.mark.parametrize("failure", ["raises", "slot-count"])
def test_kill_rank_callable_standby_failure_leaves_no_engine(failure):
    """A callable standby runs after the dying engine is released: where it
    raises or returns another slot count, ``kill_rank`` raises
    ``RuntimeError`` and the client holds no engine (not a released one)."""
    cfg = get_arch("deepseek-r1")

    def standby(rank):
        if failure == "raises":
            raise torch.cuda.OutOfMemoryError("no room for the standby")
        return _stub_engine(cfg, (2, 3), 2)

    log = []
    client = LiveReplicaClient(["old"], types.SimpleNamespace(variants=_Variants(log)),
                               _stub_gen(cfg, (2, 4), 4, log), num_gpus=8, standby=standby)
    with pytest.raises(RuntimeError, match="holds no engine") as info:
        client.kill_rank(5, [0, 2])
    assert isinstance(info.value.__cause__,
                      torch.cuda.OutOfMemoryError if failure == "raises" else ValueError)
    assert log == ["release", "release"]
    assert client.params is None and client.ctx is None and client.gen is None


# --------------------------------------------------------------------------
# The live fleet loses a rank mid-decode.
# --------------------------------------------------------------------------
def _kill_engine(mesh, params, warm: bool = False, policy=POLICY):
    eng, _ = build_engine(KILL_CFG, mesh_shape=mesh, prefill_len=8, cache_len=48, max_batch=4,
                          gen_mode="dwdp", policy=policy, device="cpu", params=params,
                          capacity_from="global")
    if warm:
        eng.warmup()
    return eng


def _requests(target: int = TARGET):
    """The kill script's 8 requests; their prompts do not depend on
    ``target``."""
    return synthesize_workload(WorkloadConfig(num_requests=8, isl_buckets=(8,), osl=target,
                                              seed=3), vocab_size=KILL_CFG.vocab_size)


def _outputs(fleet) -> dict:
    return {rid: list(toks) for s in fleet.schedulers for rid, toks in s.outputs.items()}


@pytest.fixture(scope="module")
def kill_setup():
    """The reference's weights as numpy draws laid out at (2, 4), and the
    uninterrupted streams of the requests the router sends to replica 0
    (every other one in arrival order), served on one (2, 4) replica: at
    row-local capacity (``capacity_from="global"``) a request's tokens do
    not depend on its batch neighbours, so these are the uninterrupted
    fleet's streams."""
    m24 = build_model(KILL_CFG, {"data": 2, "model": 4}, device="cpu")
    src = zero_padded_layout(m24, canonical_weights(KILL_CFG, m24, seed=3))
    reqs = sorted(_requests(), key=lambda r: (r.arrival, r.req_id))[::2]
    ref = ServingScheduler(LiveReplicaClient.from_engine(
        _kill_engine((2, 4), from_jax_params(src, m24)), num_gpus=8))
    ref.submit(reqs)
    ref.run()
    return m24, src, {rid: list(toks) for rid, toks in ref.outputs.items()}


@pytest.mark.parametrize("standby_kind,policy,target", [
    pytest.param("prebuilt", POLICY, TARGET, id="prebuilt"),
    pytest.param("callable", POLICY, TARGET, id="callable"),
    pytest.param("prebuilt", PREDICTIVE, TARGET // 2, id="prebuilt-predictive"),
])
def test_kill_mid_decode_migrates_bitwise(kill_setup, standby_kind, policy, target):
    """Two (2, 4) replicas; rank 5 of replica 0 dies after 4 decode steps.
    Its slots 2 and 3 (data row 1) requeue on the (2, 3) standby; slots 0
    and 1 migrate to replica 1, whose plan restores them, and their streams
    are bitwise the uninterrupted fleet's. Every request completes at
    ``target`` tokens, the summary's recovery keys are set, and no variant
    is built after the standby's warmup. ``callable``: the standby re-shards
    replica 0's weights in place (``reshard_params(free=True)``) when the
    client calls it, after releasing the dying engine's graphs.
    ``prebuilt-predictive``: the reference's predictive policy, 8 tokens a
    request (a step costs twice the all-fetch one here); the uninterrupted
    streams fetched every expert, and the predictive fetch lands the same
    tokens, so its migrants match their first 8. (The requeued streams are
    not compared: the standby shards an 8-token prompt 2 ways, not 8, and
    the capacity's drops follow the sequence shards, in the reference
    too.)"""
    m24, src, ref_out = kill_setup
    m23 = build_model(KILL_CFG, {"data": 2, "model": 3}, device="cpu")
    engines = [_kill_engine((2, 4), from_jax_params(src, m24), policy=policy) for _ in range(2)]
    built = []
    if standby_kind == "prebuilt":
        standby = _kill_engine((2, 3), reshard_params(engines[0].params, m24, m23,
                                                      DEAD_RANK % 4, src), warm=True,
                               policy=policy)
        built.append(standby)
    else:
        def standby(rank):
            eng = _kill_engine((2, 3), reshard_params(engines[0].params, m24, m23, rank % 4,
                                                      src, free=True), warm=True)
            built.append(eng)
            return eng
    fleet = MultiReplicaEngine([
        ServingScheduler(LiveReplicaClient.from_engine(engines[0], num_gpus=8, standby=standby)),
        ServingScheduler(LiveReplicaClient.from_engine(engines[1], num_gpus=8))])
    fleet.submit(_requests(target))
    first_home = dict(fleet.assignments)

    def builds():
        return sum(e.gen.variants.stats["misses"] + e.ctx.variants.stats["misses"]
                   for e in engines + built)

    for _ in range(PRE_STEPS):
        for s in fleet.schedulers:
            s.step()
    active = fleet.schedulers[0].active_count()
    report = fleet.kill_rank(0, DEAD_RANK)
    warm = builds()
    fleet.run()
    assert builds() == warm and len(built) == 1
    assert fleet.schedulers[0].client.gen is built[0].gen
    assert report["migrated"] + report["requeued"] == active == 4
    assert report == {"migrated": 2, "requeued": 2}
    out = _outputs(fleet)
    assert sorted(out) == list(range(8)) and all(len(t) == target for t in out.values())
    assert sorted(rid for rid, i in first_home.items() if i == 0) == sorted(ref_out)
    moved = [rid for rid in ref_out if fleet.assignments[rid] == 1]
    assert len(moved) == report["migrated"]
    assert all(out[rid] == ref_out[rid][:target] for rid in moved)
    summary = fleet.merged_metrics().summary(fleet.horizon())
    assert summary["completed"] == 8 and summary["rank_deaths"] == 1
    assert (summary["migrated"], summary["requeued"]) == (report["migrated"], report["requeued"])
    assert summary["time_to_recover_p50_s"] > 0


# --------------------------------------------------------------------------
# The ladder's "reshard" rung.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fetch", ["all", "demand", "predictive", "sync_free"])
def test_reshard_rung_is_the_reference_ladder_entry(fetch):
    """The rung a generation server steps onto at the ladder's top is the
    reference's ``"reshard"`` entry: the all-gather table, no exclusion."""
    table = strategy.PolicyTable.uniform(layout="split", fetch=fetch)
    jtable = JTable.uniform(layout="split", fetch=fetch)
    gen = types.SimpleNamespace(ladder=strategy.degradation_ladder(table),
                                _excl=GenerationServer._excl)
    label, ref_table, ref_excl = jladder(jtable)[-1]
    got_table, got_excl = GenerationServer._rung(gen, len(gen.ladder) - 1)
    assert label == gen.ladder[-1][0] == "reshard"
    assert got_table.describe() == ref_table.describe() and got_excl == ref_excl == ()
    assert got_table.family("moe_experts").fetch == "all"
