"""The port's fault machinery (``core/faults.py``, the validated fetch of
``core/prefetch.py``, the degradation ladder, ``HealthMonitor``) against
the JAX package.

- Checksums, the checksum table and row verification against the JAX
  functions under ``jax.vmap`` over 4 ranks (relative 1e-5: the two reduce
  in other orders).
- Tampering, verification and the fault counters fed with the JAX
  injector's own masks: the same rows, flags and counts.
- ``FaultSpec``, ``FaultTrace`` (on tests/fixtures/fault_trace.npz),
  ``HealthMonitor`` and ``degradation_ladder`` / ``degrade_policy_table``
  over grids: equal to the JAX package's.
- The port's own injector draws (a counter-based hash, not threefry):
  deterministic per seed, different across ranks and steps, within
  binomial bounds of their rates, mutually exclusive, bad peers always
  dropping, and the same from a Python step as from a device-side step
  tensor.
- The command line's fault flags reaching ``build_engine``.
"""
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import execution as jexec
from repro.core import faults as jfaults
from repro.core import prefetch as jpf
from repro.core import strategy as jstrategy
from repro.core.placement import make_placement as jplacement
from repro.runtime.engine import HealthMonitor as JHealthMonitor
from repro_torch.core import execution, faults, prefetch, strategy
from repro_torch.core.placement import make_placement
from repro_torch.runtime.engine import HealthMonitor
from torch_refs import jit_quick

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "fault_trace.npz")
PL_J, PL_T = jplacement(20, 4), make_placement(20, 4)  # G' 4, local 5
G, LOCAL = 4, 5


def _tree(seed, rows, wide=False):
    rng = np.random.default_rng(seed)
    tree = {"w_gate": (rng.standard_normal((rows, 6, 8)) * 0.1).astype(np.float32),
            "w_down": (rng.standard_normal((rows, 8, 70)) * 0.1).astype(np.float32)}
    if wide:  # 8320 elements: 122-element column blocks and a tail
        tree["w_up"] = (rng.standard_normal((rows, 64, 130)) * 0.1).astype(np.float32)
    return tree


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_checksums_table_and_verify_match_jax():
    """Per rank: the resident rows' checksums, the subgroup's table (the
    JAX all-gather), and a verification of 7 rows (2 tampered, 1 padding)
    against it. Leaves of 48, 560 and 8320 elements exercise the 61-periodic
    weights' column blocks and tails."""
    shards = [_tree(r, LOCAL, wide=True) for r in range(G)]
    rows = _tree(9, 7, wide=True)
    rows["w_gate"][2] = 1.0 - rows["w_gate"][2]
    rows["w_down"][5] = 0.0
    ids = np.array([3, 0, 7, 19, 12, 5, 11])
    valid = np.array([True, True, True, False, True, True, True])
    for k in rows:  # healthy rows are their owner's rows
        for i, e in enumerate(ids):
            if i not in (2, 5):
                rows[k][i] = shards[e // LOCAL][k][e % LOCAL]

    @jit_quick
    def ref(stacked, rows, ids, valid):
        def one(tree):
            table = jpf.checksum_table(tree, "model", PL_J)
            return jpf.row_checksums(tree), table, jpf.verify_rows(rows, ids, valid, table)
        return jax.vmap(one, axis_name="model")(stacked)

    stacked = {k: np.stack([s[k] for s in shards]) for k in shards[0]}
    j_local, j_table, (j_ok, j_bad) = ref(stacked, rows, ids, valid)
    tshards = [_t(s) for s in shards]
    for r in range(G):
        np.testing.assert_allclose(prefetch.row_checksums(tshards[r]).numpy(),
                                   np.asarray(j_local[r]), rtol=1e-5)
        table = prefetch.checksum_table(tshards, r, PL_T)
        np.testing.assert_allclose(table.numpy(), np.asarray(j_table[r]), rtol=1e-5)
        ok, bad = prefetch.verify_rows(_t(rows), torch.from_numpy(ids), torch.from_numpy(valid),
                                       table)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok[r]))
        np.testing.assert_array_equal(bad.numpy(), np.asarray(j_bad[r]))
        assert bad.tolist() == [False, False, True, False, False, True, False]
    empty = torch.zeros(0, dtype=torch.bool)
    assert prefetch.verify_rows(_t(rows), torch.from_numpy(ids[:0]), empty, table)[1].numel() == 0


class _Masks:
    """An injector whose masks are given (the JAX injector's)."""

    def __init__(self, masks):
        self.masks = masks

    def payload_masks(self, key, budget, position):
        return self.masks


TAMPER_SPECS = ("seed=5,drop=0.2,zero=0.2,corrupt=0.2,peers=1",)


def test_tamper_verify_and_counters_match_jax_on_its_masks():
    """The JAX injector's payload masks of a 3-row budget at step 7, per
    rank (position 1 a bad peer); tampering, verification, the injected counts and
    the per-source detected counts of both packages on those masks. Then
    bf16 rows: ``1 - w`` rounds alike."""
    budget, step = 3, 7
    payload = _tree(4, (G - 1) * budget)
    ids = np.random.default_rng(1).integers(0, 20, (G - 1) * budget)
    valid = np.random.default_rng(2).random((G - 1) * budget) < 0.8
    shards = [_tree(r + 10, LOCAL) for r in range(G)]
    for k in payload:  # untampered rows are their owner's rows
        for i, e in enumerate(ids):
            payload[k][i] = shards[e // LOCAL][k][e % LOCAL]
    stacked = {k: np.stack([s[k] for s in shards]) for k in shards[0]}
    w16 = (np.random.default_rng(3).standard_normal((4, 5, 6)) * 3).astype(np.float32)
    drop16 = np.array([False, True, False, False])
    corrupt16 = np.array([True, False, False, True])

    @jit_quick
    def ref(stacked):
        def one(tree, jspec):
            inj = jfaults.FaultInjector(jspec, "model", PL_J, {"model": G})
            key = inj.site_key("corr", step)
            drop, zero, corrupt = inj.payload_masks(key, budget)
            tampered = inj.tamper_rows(payload, drop | zero, corrupt)
            table = jpf.checksum_table(tree, "model", PL_J)
            ok, bad = jpf.verify_rows(tampered, ids, jnp.asarray(valid), table)
            p = jax.lax.axis_index("model") % G
            return ((drop, zero, corrupt), tampered, ok, bad,
                    jexec._injected_counts(inj, key, budget, jnp.asarray(valid)),
                    jexec._per_src_detected(bad, budget, G, p))
        outs = [jax.vmap(lambda t: one(t, jfaults.FaultSpec.parse(spec)), axis_name="model")(
            stacked) for spec in TAMPER_SPECS]
        bf16 = jfaults.FaultInjector.tamper_rows({"w": jnp.asarray(w16, jnp.bfloat16)},
                                                 jnp.asarray(drop16), jnp.asarray(corrupt16))
        return outs, bf16["w"]

    outs, j_bf16 = ref(stacked)
    tshards = [_t(s) for s in shards]
    for j_masks, j_tampered, j_ok, j_bad, j_counts, j_src in outs:
        seen = 0
        for r in range(G):
            masks = tuple(torch.from_numpy(np.array(m[r])) for m in j_masks)
            seen += int(sum(m.sum() for m in masks))
            tree = _t(payload)
            faults.FaultInjector.tamper_rows(tree, masks[0] | masks[1], masks[2])
            for k in tree:
                np.testing.assert_array_equal(tree[k].numpy(), np.asarray(j_tampered[k][r]))
            ok, bad = prefetch.verify_rows(tree, torch.from_numpy(ids), torch.from_numpy(valid),
                                           prefetch.checksum_table(tshards, r, PL_T))
            np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok[r]))
            np.testing.assert_array_equal(bad.numpy(), np.asarray(j_bad[r]))
            counts = execution._injected_counts(_Masks(masks), None, budget,
                                                torch.from_numpy(valid), r)
            np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts[r]))
            np.testing.assert_array_equal(
                execution._per_src_detected(bad, budget, G, r).numpy(), np.asarray(j_src[r]))
        assert seen > 0
    got = faults.FaultInjector.tamper_rows(torch.from_numpy(w16).bfloat16(),
                                           torch.from_numpy(drop16), torch.from_numpy(corrupt16))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(j_bf16, np.float32))


SPECS = ["seed=3,drop=0.1,corrupt=0.05,peers=2|5", "drop=0.5", "seed=7,zero=0.25,cache=0.125",
         "mirror=0.3,peers=0", "seed=1,trace=tests/fixtures/fault_trace.npz", " seed=2 , ", ""]
BAD_SPECS = ["drop=1.5", "frobnicate=1", "drop", "peers=-1", "cache=-0.1"]


def test_fault_spec_parse_and_describe_match_jax():
    for text in SPECS:
        got, ref = faults.FaultSpec.parse(text), jfaults.FaultSpec.parse(text)
        assert got.describe() == ref.describe()
        assert dataclass_dict(got) == dataclass_dict(ref)
        assert got.any_faults == ref.any_faults
        assert faults.FaultSpec.parse(got.describe()) == got
    for text in BAD_SPECS:
        with pytest.raises(ValueError):
            jfaults.FaultSpec.parse(text)
        with pytest.raises(ValueError):
            faults.FaultSpec.parse(text)
    assert faults.FaultSpec.parse("trace=" + FIXTURE).load_trace() is not None


def dataclass_dict(spec):
    return {f: getattr(spec, f) for f in ("seed", "drop_rate", "zero_rate", "corrupt_rate",
                                          "cache_corrupt_rate", "bad_peers", "mirror_rate",
                                          "trace")}


def test_fault_trace_queries_match_jax():
    got, ref = faults.FaultTrace.load(FIXTURE), jfaults.FaultTrace.load(FIXTURE)
    assert len(got) == len(ref) and got.kinds == ref.kinds
    last = int(ref.steps[-1])
    for step in range(last + 3):
        assert got.events_at(step) == ref.events_at(step)
        assert got.next_event_step(step) == ref.next_event_step(step)
        for peers in (1, 4):
            a, b = got.stat_vector(step, peers), ref.stat_vector(step, peers)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    assert got.events_in(3, 21) == ref.events_in(3, 21)
    for horizon in (None, 10, 40):
        assert got.fallback_rate(horizon) == ref.fallback_rate(horizon)
    np.testing.assert_array_equal(got.peer_pressure(4), ref.peer_pressure(4))
    events = [(5, "drop", 1), (2, "rank_death", 3), (5, "cache", 0)]
    a, b = faults.FaultTrace.from_events(events), jfaults.FaultTrace.from_events(events)
    assert a.events_in(0, 9) == b.events_in(0, 9)
    assert tuple(faults.FAULT_STAT_NAMES) == tuple(jfaults.FAULT_STAT_NAMES)
    assert faults.FAULT_STAT_BASE == jfaults.FAULT_STAT_BASE and faults.TRACE_KINDS == \
        jfaults.TRACE_KINDS
    with pytest.raises(ValueError):
        faults.FaultTrace(steps=[2, 1], kinds=("drop", "drop"), ranks=[0, 0])


@pytest.mark.parametrize("seed", range(4))
def test_health_monitor_decisions_match_jax(seed):
    """Seeded sequences of per-peer tails (storms, calm, intermittent) under
    several monitor settings: the same move at every step and the same bad
    peer set."""
    rng = np.random.default_rng(seed)
    kw = [dict(), dict(decay=0.5, demote_threshold=0.4, promote_threshold=0.1, min_dwell=1),
          dict(decay=0.9, demote_threshold=0.3, promote_threshold=0.05, min_dwell=0)][seed % 3]
    got, ref = HealthMonitor(**kw), JHealthMonitor(**kw)
    p_bad = rng.random(4) * (0.9 if seed % 2 else 0.3)
    for step in range(60):
        phase = (step // 15) % 2  # storms and calm spells
        tail = (rng.random(4) < p_bad * phase) * rng.integers(1, 5, 4)
        assert got.observe(tail) == ref.observe(tail)
        assert got.bad_peers() == ref.bad_peers()
        assert got.worst_peer() == ref.worst_peer()
    with pytest.raises(ValueError):
        HealthMonitor(decay=1.5)
    with pytest.raises(ValueError):
        HealthMonitor(demote_threshold=0.1, promote_threshold=0.5)


LADDER_TABLES = [
    {"moe_experts": "split:predictive:allgather:4:4:8"},
    {"moe_experts": "split:sync_free:ring_sliced:2:4:8"},
    {"moe_experts": "split:demand:ring"},
    {"moe_experts": "split:all"},
    {"default": "merged:all:ring", "moe_experts": "split:predictive:allgather:4:0:16"},
    {"moe_experts": "split:demand", "body/moe_experts": "split:sync_free:allgather:4:2:4",
     "attn_qkv": "merged"},
]


@pytest.mark.parametrize("spec", LADDER_TABLES, ids=str)
def test_degradation_ladder_matches_jax(spec):
    got = strategy.degradation_ladder(strategy.PolicyTable.from_dict(spec))
    ref = jstrategy.degradation_ladder(jstrategy.PolicyTable.from_dict(spec))
    assert [(label, excl) for label, _, excl in got] == [(label, excl) for label, _, excl in ref]
    assert [t.to_dict() for _, t, _ in got] == [t.to_dict() for _, t, _ in ref]
    for fetch in ("sync_free", "predictive", "demand", "all"):
        a = strategy.degrade_policy_table(strategy.PolicyTable.from_dict(spec), fetch)
        b = jstrategy.degrade_policy_table(jstrategy.PolicyTable.from_dict(spec), fetch)
        assert a.to_dict() == b.to_dict()
    with pytest.raises(ValueError):
        strategy.degrade_policy_table(strategy.PolicyTable.from_dict(spec), "rotate")


# --------------------------------------------------------------------------
# The port's own draws.
# --------------------------------------------------------------------------
def _inj(text, pl=PL_T, sizes=None):
    return faults.FaultInjector(faults.FaultSpec.parse(text), pl, sizes or {"data": 1, "model": G})


def test_injector_draws_deterministic_and_decorrelated():
    inj = _inj("seed=3,drop=0.3,zero=0.2,corrupt=0.2,cache=0.5")
    a = inj.payload_masks(inj.site_key("corr", 5, 1), 5, 1)
    b = inj.payload_masks(inj.site_key("corr", 5, 1), 5, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    draws = {key: inj.draws(inj.site_key(*key), 4096)
             for key in (("corr", 5, 1), ("corr", 5, 2), ("corr", 6, 1), ("spec", 5, 1))}
    other_seed = _inj("seed=4,drop=0.3")
    draws["seed"] = other_seed.draws(other_seed.site_key("corr", 5, 1), 4096)
    vals = list(draws.values())
    for i in range(len(vals)):
        for j in range(i + 1, len(vals)):
            assert (vals[i] == vals[j]).float().mean() < 0.01  # 24-bit draws rarely collide
    u = inj.draws(inj.site_key("cache", 0, 0), 4096).double() / 2 ** 24
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0 and abs(float(u.mean()) - 0.5) < 0.02
    # neighbouring draws are uncorrelated
    assert abs(float(torch.corrcoef(torch.stack([u[:-1], u[1:]]))[0, 1])) < 0.06


@pytest.mark.parametrize("rates", [(0.1, 0.05, 0.05, 0.2), (0.3, 0.2, 0.2, 0.5), (0.0, 0.5, 0.0, 0.0)])
def test_injector_rates_within_binomial_bounds_and_exclusive(rates):
    drop_r, zero_r, corrupt_r, cache_r = rates
    pl = make_placement(4 * 1000, 4)  # (G' - 1) * budget = 3000 rows per key
    inj = _inj(f"seed=11,drop={drop_r},zero={zero_r},corrupt={corrupt_r},cache={cache_r}", pl)
    n_drop = n_zero = n_corrupt = n_cache = n = 0
    for step in range(4):
        key = inj.site_key("corr", step, step % 4)
        drop, zero, corrupt = inj.payload_masks(key, 1000, step % 4)
        assert not bool((drop & zero).any() | (drop & corrupt).any() | (zero & corrupt).any())
        n_drop, n_zero, n_corrupt = (n_drop + int(drop.sum()), n_zero + int(zero.sum()),
                                     n_corrupt + int(corrupt.sum()))
        n_cache += int(inj.cache_mask(key, 3000).sum())
        n += 3000
    # the exclusive masks: zero is drawn among the rows not dropped, corrupt
    # among the rows neither dropped nor zeroed
    p_zero = (1 - drop_r) * zero_r
    p_corrupt = (1 - drop_r) * (1 - zero_r) * corrupt_r
    for got, p in ((n_drop, drop_r), (n_zero, p_zero), (n_corrupt, p_corrupt), (n_cache, cache_r)):
        assert abs(got - n * p) <= 5 * math.sqrt(n * p * (1 - p)) + 1, (got, n * p)


def test_bad_peers_always_drop():
    inj = _inj("seed=1,peers=2|5")  # 5 % 4 = position 1
    for p in range(G):
        drop, zero, corrupt = inj.payload_masks(inj.site_key("spec", 3, p), 3, p)
        src = [(p + 1 + i // 3) % G for i in range(9)]
        assert drop.tolist() == [s in (1, 2) for s in src]
        assert not bool(zero.any() | corrupt.any())


def test_masks_from_a_device_step_tensor_equal_the_eager_draws():
    """The step as a Python int and as a 0-d tensor (what a decode step
    reads from its positions, never on the host) key the same masks; the
    mirror flag picks the same target rank on every rank."""
    inj = _inj("seed=9,drop=0.3,zero=0.1,corrupt=0.1,cache=0.4,mirror=0.7")
    pos = torch.tensor([12, 17], dtype=torch.int32)
    for rank in range(G):
        a = inj.payload_masks(inj.site_key("corr", 17, rank), 5, rank)
        b = inj.payload_masks(inj.site_key("corr", pos.max(), rank), 5, rank)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert torch.equal(inj.cache_mask(inj.site_key("cache", 17, rank), 8),
                           inj.cache_mask(inj.site_key("cache", pos.max(), rank), 8))
    for step in range(40):
        flags = [bool(inj.mirror_flag(torch.tensor(step), r)) for r in range(G)]
        assert sum(flags) <= 1
        assert flags == [bool(inj.mirror_flag(step, r)) for r in range(G)]
    fired = sum(any(bool(inj.mirror_flag(s, r)) for r in range(G)) for s in range(100))
    assert abs(fired - 70) <= 5 * math.sqrt(100 * 0.21)
    assert not bool(_inj("seed=9").mirror_flag(3, 0))


@pytest.mark.parametrize("argv", [
    ["--fault-spec", "seed=3,drop=0.1,peers=2", "--health-dwell", "1", "--health-decay", "0.5"],
    ["--validate-fetch", "--no-health"],
    ["--fault-spec", "drop=1.5"]])
def test_cli_fault_flags_reach_build_engine(monkeypatch, argv):
    """``--fault-spec`` / ``--validate-fetch`` reach ``build_engine`` with
    the ``--health-*`` monitor (none under ``--no-health``); a malformed
    spec exits with status 2 before any model is built."""
    from repro_torch.launch import serve

    class Built(Exception):
        pass

    def built(*a, **k):
        raise Built(k)

    monkeypatch.setattr(serve, "build_engine", built)
    monkeypatch.setattr(serve, "build_model", built)
    cli = ["--arch", "deepseek-r1", "--device", "cpu", "--expert-fetch", "predictive", *argv]
    if "drop=1.5" in argv:
        with pytest.raises(SystemExit) as exc:
            serve.main(cli)
        assert exc.value.code == 2
        return
    with pytest.raises(Built) as exc:
        serve.main(cli)
    kw = exc.value.args[0]
    if "--no-health" in argv:
        assert kw["validate_fetch"] and kw["fault_spec"] is None and kw["health"] is None
        return
    assert kw["fault_spec"] == argv[1] and not kw["validate_fetch"]
    assert isinstance(kw["health"], HealthMonitor)
    assert (kw["health"].min_dwell, kw["health"].decay) == (1, 0.5)
