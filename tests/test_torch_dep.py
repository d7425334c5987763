"""DEP's building blocks in the port, with no JAX compile: the in-process
collectives (all-to-all, psum_scatter) and the merged landing against
explicit loops and ``torch.cat``; the static wire-byte model of DEP and
hybrid plans against the JAX package's on the same configuration; the
modes the plan refuses; and the servers' handling of modes (a DEP
context server is refused, the variant cache keys on the mode). The
forwards themselves are held against the JAX package in
tests/test_torch_model.py and tests/test_torch_engine.py."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.configs import reduced_variant as jreduced
from repro.configs.base import InputShape as JShape
from repro.core import execution as jexec
from repro.core import strategy as jstrategy
from repro.models.transformer import build_model as jbuild_model
from repro_torch.configs import get_arch, reduced_variant
from repro_torch.configs.base import InputShape
from repro_torch.core import collectives, execution, prefetch, strategy
from repro_torch.core.placement import make_placement
from repro_torch.models.transformer import build_model
from repro_torch.runtime.engine import ContextServer, GenerationServer

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

GEOM = dict(shard_attention=True, expert_axes=("model",), moe_exec="gather")
SIZES = {"data": 1, "model": 4}


def _rank_tensors(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("experts,group,redundancy", [(8, 4, 1), (2, 4, 2), (6, 6, 2)])
def test_all_to_all_matches_explicit_loop(experts, group, redundancy):
    """Dispatch (split experts, concat capacity) and return (split capacity,
    concat experts) against a loop over subgroup members; the round trip
    is the identity."""
    pl = make_placement(experts, group, redundancy=redundancy)
    g, local, cap, d = pl.subgroup_size, pl.local_count, 3, 5
    xs = _rank_tensors(group, (pl.num_padded, cap, d))
    got = collectives.all_to_all(xs, pl, split_dim=0, concat_dim=1)
    for r in range(group):
        base, p = (r // g) * g, r % g
        want = torch.empty(local, g * cap, d)
        for q in range(g):
            want[:, q * cap:(q + 1) * cap] = xs[base + q][p * local:(p + 1) * local]
        assert torch.equal(got[r], want)
    back = collectives.all_to_all(got, pl, split_dim=1, concat_dim=0)
    assert all(torch.equal(b, x) for b, x in zip(back, xs))


@pytest.mark.parametrize("dim,sizes", [(0, [3, 3, 3, 3]), (1, [2, 5, 1, 4])])
def test_psum_scatter_matches_rank_order_sum(dim, sizes):
    shape = [4, 6]
    shape[dim] = sum(sizes)
    parts = _rank_tensors(4, tuple(shape), seed=1)
    total = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    got = collectives.psum_scatter(parts, sizes, dim=dim)
    start = 0
    for r, n in enumerate(sizes):
        assert torch.equal(got[r], total.narrow(dim, start, n))
        start += n
    assert torch.equal(collectives.psum(parts), total)


def test_merged_landing_matches_cat():
    """Every subgroup shard, the rank's own included, in canonical order in
    one buffer per leaf, every byte counted as landed; the resident shards
    are left as they were."""
    pl = make_placement(4, 4)
    shards = [{"wq": t, "wo": t.transpose(1, 2).contiguous()}
              for t in _rank_tensors(4, (1, 6, 3), seed=2)]
    prefetch.LANDED.bytes = prefetch.LANDED.merge_bytes = 0
    for r in range(4):
        got = prefetch.gather_shards(shards, r, pl)
        for key in ("wq", "wo"):
            want = torch.cat([s[key] for s in shards])
            assert torch.equal(got[key], want)
            assert got[key].data_ptr() != shards[r][key].data_ptr()
    assert prefetch.LANDED.bytes == 4 * 2 * 4 * 18 * 4
    assert prefetch.LANDED.merge_bytes == 4 * 2 * 18 * 4  # each rank's own shards


def _r1_two_layers(mod):
    base = mod.get_arch("deepseek-r1")
    return dataclasses.replace(base, num_layers=2,
                               moe=dataclasses.replace(base.moe, first_dense=1))


@pytest.fixture(scope="module")
def models():
    """Both packages' reduced DeepSeek-R1 and its 2-layer full-width cut
    (geometry and plans only: no weights)."""
    import repro.configs as jconfigs
    import repro_torch.configs as configs

    return {
        "reduced": (jbuild_model(jreduced(jget_arch("deepseek-r1")), SIZES, dtype=jnp.float32,
                                 **GEOM),
                    build_model(reduced_variant(get_arch("deepseek-r1")), SIZES, device="cpu",
                                **GEOM)),
        "full": (jbuild_model(_r1_two_layers(jconfigs), SIZES, dtype=jnp.bfloat16, **GEOM),
                 build_model(_r1_two_layers(configs), SIZES, dtype=torch.bfloat16,
                             device="cpu", **GEOM)),
    }


@pytest.mark.parametrize("arch", ["reduced", "full"])
@pytest.mark.parametrize("mode,phase,decode_attn", [
    ("dep", "decode", "gather"), ("dep", "decode", "qgather"), ("dep", "prefill", "gather"),
    ("hybrid", "decode", "gather"), ("hybrid", "prefill", "gather"),
    ("dwdp", "decode", "qgather")])
def test_dep_wire_bytes_match_reference(models, arch, mode, phase, decode_attn):
    """DEP counts only its decode attention gather (the all-to-all moves
    activations, which the model does not count); hybrid its attention and
    dense banks; qgather no attention at all, in any mode."""
    jm, model = models[arch]
    shape = ("gen", 32, 2, "decode") if phase == "decode" else ("ctx", 16, 1, "prefill")
    jxp = jstrategy.make_execution_plan(jm, JShape(*shape), SIZES, mode=mode,
                                        decode_attn=decode_attn)
    xp = strategy.make_execution_plan(model, InputShape(*shape), SIZES, mode=mode,
                                      decode_attn=decode_attn)
    got = execution.gathered_wire_bytes_per_step(model, xp)
    assert got == jexec.gathered_wire_bytes_per_step(jm, jxp)
    fams = got["families"]
    assert (fams["moe_experts"]["full"] == 0) == (mode != "dwdp")
    assert (fams["attn_qkv"]["full"] > 0) == (decode_attn == "gather" and
                                              (mode == "hybrid" or phase == "decode"))
    assert (fams["dense_ffn"]["full"] > 0) == (mode != "dep")


def test_modes_make_execution_plan_takes(models):
    model = models["reduced"][1]
    shape = InputShape("gen", 32, 2, "decode")
    for mode in ("dwdp", "dep", "hybrid"):
        assert strategy.make_execution_plan(model, shape, SIZES, mode=mode).mode == mode
    # DEP accepts an expert fetch and runs it as the all-to-all (nothing engages)
    xp = strategy.make_execution_plan(model, shape, SIZES, mode="dep",
                                      policy=strategy.PolicyTable.uniform(fetch="predictive",
                                                                          cache_budget=2))
    assert not execution.demand_fetch_active(model.cfg, model.geom, xp)
    assert execution.init_predict_state(model, xp) == {}
    with pytest.raises(NotImplementedError, match="replicated"):
        strategy.make_execution_plan(model, shape, SIZES, mode="replicated")
    with pytest.raises(ValueError, match="decode_attn"):
        strategy.make_execution_plan(model, shape, SIZES, decode_attn="scatter")


def test_servers_and_modes(models):
    """A DEP context server is refused at construction (no KV to hand
    over); a hybrid one is built. A generation server's variants are of its
    mode, keyed on it, with no predictive state where no fetch engages."""
    model = models["reduced"][1]
    with pytest.raises(ValueError, match="captures no KV"):
        ContextServer(model, SIZES, mode="dep", prefill_len=16, cache_len=32)
    assert ContextServer(model, SIZES, mode="hybrid", prefill_len=16, cache_len=32).xp.mode == "hybrid"
    for mode in ("dep", "hybrid"):
        gen = GenerationServer(model, SIZES, mode=mode, max_batch=2, cache_len=32,
                               expert_fetch="demand")
        assert (gen.xp.mode, gen.xp.decode_attn) == (mode, "gather")
        assert "pred" not in gen.state
        xp, step = gen.variants.get(gen.xp.policies)
        assert xp is gen.xp and step is gen.step and len(gen.variants) == 1
        assert [k[0] for k in gen.variants._entries] == [mode]
