"""The port's gather-policy space against the JAX package's, with no JAX
compile and no JAX run: the policy surface (``GatherPolicy.parse`` /
``spec``, ``PolicyTable.from_dict`` / ``to_dict`` / ``family(name,
group)``, ``make_execution_plan``'s tables and errors, the deprecated flat
knobs), the command line's parsing (``parse_policy_flags``,
``resolve_cli_policy``; the reference's tests/test_core.py and
tests/test_system.py cases; ``"auto"`` against the reference's
resolution), the landings (every rank's split bank
merged, and every merged landing, equal to the canonical concatenation
over each transport, bitwise across transports), the static wire-byte
model against the reference's for the same tables, and ``LANDED`` with
its merge share exact for one merged and one split forward. The forwards
under these tables are held against the JAX package in
tests/test_torch_model.py, tests/test_torch_data_parallel.py and
tests/test_torch_engine.py."""
import argparse
import json
import warnings

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
from repro.core import strategy as jstrategy
from repro.launch import serve as jserve
from repro.models.transformer import build_model as jbuild_model
from repro_torch.configs import get_arch, reduced_variant
from repro_torch.configs.base import ArchConfig, InputShape, MoEConfig
from repro_torch.core import execution, prefetch, strategy
from repro_torch.core.placement import make_placement
from repro_torch.launch import serve
from repro_torch.models.transformer import build_model
from torch_refs import MOE_EXPERTS, MOE_FIELDS, MOE_GEOM

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

SIZES = {"data": 1, "model": 4}
SPECS = ["split", "merged", "split:demand", "split:demand:ring_sliced", "merged:all:ring",
         "merged:all:ring_sliced:3", "split:predictive:ring:4:8:16",
         "split:sync_free:allgather:2:0:4", {"layout": "merged", "transport": "ring"}]
BAD_SPECS = ["bogus", "split:bogus", "merged:demand", "split:all:tree", "split:all:ring:x", "",
             "split::ring", "split:all:ring:4:0:0:1", {"layoutx": "split"}, "split:all:ring:0",
             "split:demand:allgather:4:-1", "split:all:allgather:4:0:3"]
MIXED = {"moe_experts": "split:demand:allgather:4:100", "attn_qkv": "merged:all:allgather",
         "attn_out": "merged:all:allgather", "dense_ffn": "split:all:ring"}
TABLES = {
    "default": None,
    "merged": "merged:all:allgather",
    "ring_sliced": "split:all:ring_sliced:3",
    "mixed": MIXED,
    "per_group": {"prefix/dense_ffn": "merged", "body/dense_ffn": "split:all:ring",
                  "body/moe_experts": "split:demand:ring_sliced"},
    "predictive_body": {"default": "merged:all:ring", "attn_out": "split",
                        "body/moe_experts": "split:sync_free:ring:4:0:2"},
}
GROUPS = (None, "prefix", "body", "suffix")


def _parse(mod, spec):
    pol = mod.GatherPolicy.parse(spec)
    return (pol.layout, pol.fetch, pol.transport, pol.num_slices, pol.budget, pol.cache_budget)


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_gather_policy_parse_matches_reference(spec):
    assert _parse(strategy, spec) == _parse(jstrategy, spec)
    pol = strategy.GatherPolicy.parse(spec)
    assert pol.spec() == jstrategy.GatherPolicy.parse(spec).spec()
    assert strategy.GatherPolicy.parse(pol.spec()) == pol
    assert strategy.GatherPolicy.parse(pol) is pol


@pytest.mark.parametrize("spec", BAD_SPECS, ids=str)
def test_gather_policy_parse_refusals_match_reference(spec):
    with pytest.raises(ValueError):
        jstrategy.GatherPolicy.parse(spec)
    with pytest.raises(ValueError):
        strategy.GatherPolicy.parse(spec)


@pytest.mark.parametrize("name", sorted(k for k, v in TABLES.items() if isinstance(v, dict)))
def test_policy_table_dict_round_trip_and_lookup(name):
    """``from_dict`` / ``to_dict`` / ``describe`` and the lookup order of
    ``family(name, group)`` (override, family entry, default) as the
    reference's, for every family in every group."""
    spec = TABLES[name]
    table, jtable = strategy.PolicyTable.from_dict(spec), jstrategy.PolicyTable.from_dict(spec)
    assert table.to_dict() == jtable.to_dict() and table.describe() == jtable.describe()
    assert strategy.PolicyTable.from_dict(table.to_dict()) == table
    for fam in strategy.GATHER_FAMILIES + ("default",):
        for group in GROUPS:
            assert table.family(fam, group).spec() == jtable.family(fam, group).spec()


def test_policy_table_refusals_match_reference():
    for mod in (strategy, jstrategy):
        pol = mod.GatherPolicy()
        for bad in (
            lambda: mod.PolicyTable(families=(("attn_qkv", pol), ("attn_qkv", pol))),
            lambda: mod.PolicyTable(overrides=(("body", "dense_ffn", pol),) * 2),
            lambda: mod.PolicyTable(families=(("bogus", pol),)),
            lambda: mod.PolicyTable.from_dict({"attn_out": "split:demand"}),
            lambda: mod.PolicyTable.from_dict({"body/bogus": "split"}),
            lambda: mod.PolicyTable().family("bogus"),
        ):
            with pytest.raises(ValueError):
                bad()
    assert strategy.PolicyTable.uniform(fetch="demand", transport="ring").to_dict() == \
        jstrategy.PolicyTable.uniform(fetch="demand", transport="ring").to_dict()


@pytest.fixture(scope="module")
def models():
    """The tiny MoE model (a ``prefix`` dense layer, a ``body`` MoE layer)
    and reduced DeepSeek-R1 in both packages at (1, 4): geometry and plans
    only, no weights."""
    jtiny = JArch(**MOE_FIELDS, moe=JMoE(**MOE_EXPERTS))
    tiny = ArchConfig(**MOE_FIELDS, moe=MoEConfig(**MOE_EXPERTS))
    return {
        "tiny": (jbuild_model(jtiny, SIZES, dtype=jnp.float32, **MOE_GEOM),
                 build_model(tiny, SIZES, device="cpu", **MOE_GEOM)),
        "r1": (jbuild_model(jreduced(jget_arch("deepseek-r1")), SIZES, dtype=jnp.float32,
                            **MOE_GEOM),
               build_model(reduced_variant(get_arch("deepseek-r1")), SIZES, device="cpu",
                           **MOE_GEOM)),
    }


SHAPES = {"prefill": ("ctx", 16, 1, "prefill"), "decode": ("gen", 32, 2, "decode")}


@pytest.mark.parametrize("arch", ["tiny", "r1"])
@pytest.mark.parametrize("phase", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(TABLES))
def test_plans_and_wire_bytes_match_reference(models, arch, phase, name):
    """The same policy argument gives the reference's resolved table and its
    per-family wire bytes, per layer group (the bytes do not depend on the
    layout or the transport)."""
    jm, model = models[arch]
    assert [g.name for g in model.plan] == [g.name for g in jm.plan]
    jxp = jstrategy.make_execution_plan(jm, JShape(*SHAPES[phase]), SIZES, policy=TABLES[name])
    xp = strategy.make_execution_plan(model, InputShape(*SHAPES[phase]), SIZES,
                                      policy=TABLES[name])
    assert xp.policies.to_dict() == jxp.policies.to_dict()
    got = execution.gathered_wire_bytes_per_step(model, xp)
    assert got == jexec.gathered_wire_bytes_per_step(jm, jxp)
    for g in model.plan:
        for sig in g.sigs:
            assert execution.gather_set(sig, model.geom, xp, model.cfg, g.name) == tuple(
                "/".join(p) for p in jexec.gather_set(sig, jm.geom, jxp, jm.cfg, g.name))


def test_make_execution_plan_policy_arguments(models):
    """Spec strings, per-family mappings, policies and tables all resolve;
    group overrides name the model's groups; ``"auto"`` and
    ``"auto-online"`` resolve to the reference's table; the deprecated flat
    knobs warn, build the uniform
    table and refuse conflicts — each as in the reference (whose plans also
    keep deprecated flat reads, which the port does not)."""
    jm, model = models["tiny"]
    shape, jshape = InputShape(*SHAPES["decode"]), JShape(*SHAPES["decode"])
    for policy in ("merged:all:ring", strategy.GatherPolicy(layout="merged"),
                   strategy.PolicyTable.uniform(transport="ring_sliced", num_slices=2),
                   {"body/moe_experts": "merged"}):
        jpolicy = policy
        if not isinstance(policy, (str, dict)):
            jpolicy = jstrategy.PolicyTable.from_dict(strategy._coerce_policy(policy).to_dict())
        assert (strategy.make_execution_plan(model, shape, SIZES, policy=policy)
                .policies.to_dict()) == (jstrategy.make_execution_plan(
                    jm, jshape, SIZES, policy=jpolicy).policies.to_dict())
    xp = strategy.make_execution_plan(model, shape, SIZES, policy={"body/moe_experts": "merged"})
    assert xp.policy("moe_experts", "body").layout == "merged"
    assert xp.policy("moe_experts", "prefix").layout == xp.policy("moe_experts").layout == "split"
    with pytest.raises(ValueError, match=r"unknown layer group 'suffix'.*\['body', 'prefix'\]"):
        strategy.make_execution_plan(model, shape, SIZES, policy={"suffix/moe_experts": "merged"})
    with pytest.raises(ValueError, match="unknown gather family"):
        strategy.make_execution_plan(model, shape, SIZES, policy={"bogus": "split"})
    for lit in strategy.AUTO_POLICIES:
        assert strategy.make_execution_plan(model, shape, SIZES, policy=lit).policies.to_dict() \
            == jstrategy.make_execution_plan(jm, jshape, SIZES, policy=lit).policies.to_dict()
    legacy = dict(weight_layout="merged", prefetch="ring", num_slices=8)
    for mod, m, shp in ((strategy, model, shape), (jstrategy, jm, jshape)):
        with pytest.warns(DeprecationWarning, match="deprecated flat knobs"):
            xp_legacy = mod.make_execution_plan(m, shp, SIZES, **legacy)
        assert xp_legacy.policies.to_dict() == mod.PolicyTable.uniform(
            layout="merged", transport="ring", num_slices=8).to_dict()
        with pytest.warns(DeprecationWarning):
            dem = mod.make_execution_plan(m, shp, SIZES, expert_fetch="demand", demand_budget=16)
        assert dem.policy("moe_experts") == mod.GatherPolicy(fetch="demand", budget=16)
        with pytest.warns(DeprecationWarning):
            assert mod.make_execution_plan(m, shp, SIZES, moe_ffn="merged").policy(
                "moe_experts").layout == "merged"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(ValueError, match="conflicting"):
                mod.make_execution_plan(m, shp, SIZES, weight_layout="split", moe_ffn="merged")
            with pytest.raises(ValueError, match="conflicting"):
                mod.make_execution_plan(m, shp, SIZES, prefetch="ring", policy="merged")


def test_cli_policy_parsing_matches_reference(tmp_path):
    """``parse_policy_flags``: repeatable flags, the JSON file, flags over
    file entries, the ``auto`` literal, refusals; ``resolve_cli_policy``'s
    conflicts with the uniform flags — the reference's functions on the same
    inputs."""
    flags = ["moe_experts=split:demand:ring_sliced", "attn_qkv=merged", "default=split:all:ring",
             "body/dense_ffn=merged:all:ring_sliced:2"]
    t, jt = serve.parse_policy_flags(flags), jserve.parse_policy_flags(flags)
    assert t.to_dict() == jt.to_dict()
    f = tmp_path / "policies.json"
    f.write_text(json.dumps(t.to_dict()))
    assert serve.parse_policy_flags([], str(f)) == t
    over = ["moe_experts=split:all"]
    assert (serve.parse_policy_flags(over, str(f)).to_dict()
            == jserve.parse_policy_flags(over, str(f)).to_dict())
    for same in (["auto"], ["auto-online"], [], None):
        assert serve.parse_policy_flags(same) == jserve.parse_policy_flags(same)
    for bad, file in ((["bogus_family=split"], None), (["moe_experts=bogus"], None),
                      (["moe_experts"], None), (["auto", "attn_qkv=merged"], None),
                      (["auto"], str(f))):
        for mod in (serve, jserve):
            with pytest.raises(ValueError):
                mod.parse_policy_flags(bad, file)
    ns = dict(policy=["attn_qkv=merged"], policy_file=None, weight_layout=None,
              expert_fetch=None, demand_budget=None, cache_budget=None)
    for extra in ({}, {"weight_layout": "merged"}, {"demand_budget": 0},
                  {"policy": None, "expert_fetch": "demand"}):
        args = argparse.Namespace(**dict(ns, **extra))
        try:
            want = jserve.resolve_cli_policy(args)
        except ValueError:
            with pytest.raises(ValueError, match="conflicting"):
                serve.resolve_cli_policy(args)
            continue
        got = serve.resolve_cli_policy(args)
        assert (got is None and want is None) or got.to_dict() == want.to_dict()


@pytest.mark.parametrize("argv", [
    ["--policy", "auto"], ["--policy", "auto-online"],
    ["--policy", "attn_qkv=merged", "--weight-layout", "merged"],
    ["--policy", "dense_ffn=split:all:tree"]])
def test_cli_refusals_exit_before_building(monkeypatch, argv):
    """A ``--policy`` beside a uniform flag and a bad spec exit with status 2
    before any model is built; ``--policy auto`` and ``--policy
    auto-online`` are no longer refused: the literal reaches
    ``build_engine`` (with ``--switch-interval``), which resolves it."""
    class Built(Exception):
        pass

    def built(*a, **k):
        raise Built(k)

    monkeypatch.setattr(serve, "build_engine", built)
    monkeypatch.setattr(serve, "build_model", built)
    if "auto" in argv[1]:
        with pytest.raises(Built) as exc:
            serve.main(["--arch", "deepseek-r1", "--device", "cpu", "--switch-interval", "3",
                        *argv])
        kw = exc.value.args[0]
        assert kw["policy"] == argv[1] and kw["switch_interval"] == 3
        return
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "deepseek-r1", "--device", "cpu", *argv])
    assert exc.value.code == 2


def _tagged_shards(pl, width):
    """Rank r's resident tree: rows tagged with their canonical slice id,
    columns with their index (a 3-d leaf, sliced on its last dimension)."""
    table = pl.table()
    return [{"w": torch.as_tensor(table[r], dtype=torch.float32)[:, None, None] * 100
             + torch.arange(width, dtype=torch.float32)[None, None, :].repeat(1, 2, 1)}
            for r in range(pl.group_size)]


@pytest.mark.parametrize("experts,group,redundancy", [(8, 4, None), (4, 4, None), (6, 3, 1),
                                                      (2, 4, 2)])
@pytest.mark.parametrize("width,num_slices", [(6, 4), (7, 4), (12, 5)])
def test_landings_canonical_for_every_transport(experts, group, redundancy, width, num_slices):
    """Every rank's split bank, merged with ``merge_split_bank``, and every
    merged landing equal the canonical concatenation under every transport
    (``ring_sliced`` steps its slice count down until it divides the
    width: 4 -> 3 at 6 columns, 4 -> 1 at 7, 5 -> 4 at 12), bitwise equal
    to ``allgather``'s; ``LANDED`` counts every copied byte and the merged
    layout's resident copies also in ``merge_bytes``."""
    pl = make_placement(experts, group, redundancy=redundancy)
    g, local = pl.subgroup_size, pl.local_count
    shards = _tagged_shards(pl, width)
    canon = (torch.arange(pl.num_padded, dtype=torch.float32)[:, None, None] * 100
             + torch.arange(width, dtype=torch.float32)[None, None, :]).repeat(1, 2, 1)
    shard_bytes = local * 2 * width * 4
    assert prefetch.num_feature_slices(width, num_slices) == {6: 3, 7: 1, 12: 4}[width]
    for mode in strategy.PREFETCH_MODES:
        prefetch.LANDED.bytes = prefetch.LANDED.merge_bytes = 0
        for rank in range(pl.group_size):
            bank = prefetch.gather_split_bank(shards, rank, pl, mode=mode, num_slices=num_slices)
            assert bank.local is shards[rank]
            assert torch.equal(prefetch.merge_split_bank(bank, rank, pl)["w"], canon)
            merged = prefetch.gather_shards(shards, rank, pl, mode=mode, num_slices=num_slices)
            assert torch.equal(merged["w"], canon)
        n = pl.group_size
        assert prefetch.LANDED.bytes == n * (g - 1) * shard_bytes + n * g * shard_bytes
        assert prefetch.LANDED.merge_bytes == n * shard_bytes


def test_demand_payload_transports_bitwise():
    """A demand payload lands the same rows under every transport (``ring``
    shares ``allgather``'s direct schedule; ``ring_sliced`` gathers column
    slices)."""
    pl = make_placement(16, 4)
    rng = np.random.default_rng(3)
    shards = [{"w": torch.as_tensor(rng.standard_normal((4, 3, 8)), dtype=torch.float32)}
              for _ in range(4)]
    wanted = [torch.as_tensor(rng.random(16) < 0.4) for _ in range(4)]
    plans = prefetch.plan_demand_fetch(wanted, pl, budget=3)
    for r in range(4):
        ref = prefetch.gather_demand_payload(shards, plans[r], r, pl, budget=3)
        for mode in ("ring", "ring_sliced"):
            got = prefetch.gather_demand_payload(shards, plans[r], r, pl, budget=3, mode=mode,
                                                 num_slices=4)
            assert torch.equal(got.fetched["w"], ref.fetched["w"])


def test_landed_bytes_exact_for_merged_and_split_forward(models):
    """One prefill of the tiny MoE model: the split layout lands its peers'
    shards of every gathered leaf, (G' - 1) per rank and leaf; the merged
    layout also its own, G' per rank and leaf — 4/3 of split's — and
    ``merge_bytes`` is the resident copies alone."""
    model = models["tiny"][1]
    params = model.init_params(torch.Generator().manual_seed(0))
    g = 4
    xp = strategy.make_execution_plan(model, InputShape("p", 16, 1, "prefill"), SIZES)

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(t) for t in tree.values())
        return tree.numel() * tree.element_size()

    per_shard = 0  # one rank's resident bytes of every gathered leaf
    for group in model.plan:
        for j, sig in enumerate(group.sigs):
            lp = params[0]["layers"][group.name][f"pos{j}"]
            for key in execution.gather_set(sig, model.geom, xp, model.cfg, group.name):
                sub = lp
                for k in key.split("/"):
                    sub = sub[k]
                per_shard += nbytes(sub)
    assert per_shard > 0
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (1, 16)))
    landed = {}
    for layout in ("split", "merged"):
        xp = strategy.make_execution_plan(model, InputShape("p", 16, 1, "prefill"), SIZES,
                                          policy=f"{layout}:all:ring_sliced")
        prefetch.LANDED.bytes = prefetch.LANDED.merge_bytes = 0
        execution.forward_prefill(params, tokens, execution.Ctx(model=model, xp=xp))
        landed[layout] = (prefetch.LANDED.bytes, prefetch.LANDED.merge_bytes)
    n = model.n_ranks
    assert landed["split"] == (n * (g - 1) * per_shard, 0)
    assert landed["merged"] == (n * g * per_shard, n * per_shard)
    assert 3 * landed["merged"][0] == 4 * landed["split"][0]
