"""The port's forward-variant cache against the JAX package's:
``variant_key`` on the same policy tables, shape buckets and exclusion
sets, and ``PolicyVariantCache`` hits, misses and evictions over the same
``get`` sequence (a JAX ``get`` builds its plan and jit wrapper without
compiling). The captured CUDA graphs behind each variant run only on the
card (tests/test_torch_cuda.py); here a stand-in graph checks what a
capture and its replays count on the host."""
import collections
import contextlib
import gc
import types

import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import ArchConfig as JArch
from repro.configs.base import InputShape as JShape
from repro.configs.base import MoEConfig as JMoE
from repro.core.strategy import PolicyTable as JTable
from repro.launch.mesh import make_smoke_mesh
from repro.models.transformer import build_model as jbuild_model
from repro.runtime.engine import PolicyVariantCache as JCache
from repro.runtime.engine import variant_key as jvariant_key
from repro_torch import counters
from repro_torch.configs.base import ArchConfig, InputShape, MoEConfig
from repro_torch.core import execution, prefetch
from repro_torch.kernels import registry
from repro_torch.kernels.split_gemm import dense
from repro_torch.core.strategy import PolicyTable
from repro_torch.models.transformer import build_model
from repro_torch.runtime.engine import CountingStep, PolicyVariantCache, variant_key

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

FIELDS = dict(name="variant-test", family="moe", num_layers=2, d_model=32, num_heads=2,
              num_kv_heads=2, head_dim=16, d_ff=0, vocab_size=128)
MOE = dict(num_experts=8, top_k=2, d_ff=16)
# uniform-table arguments of both packages
TABLES = {
    "all": {},
    "demand": dict(fetch="demand"),
    "demand_b3": dict(fetch="demand", budget=3),
    "predictive": dict(fetch="predictive", cache_budget=8),
    "sync_free": dict(fetch="sync_free", budget=2, cache_budget=4),
}
SHAPES = {"decode": ("gen", 64, 2, "decode"), "prefill_8": ("ctx", 8, 1, "prefill"),
          "prefill_16": ("ctx", 16, 1, "prefill")}


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("excl", [(), (1,), (0, 3)], ids=str)
def test_variant_key_matches_jax(table, shape, excl):
    got = variant_key(PolicyTable.uniform(**TABLES[table]), InputShape(*SHAPES[shape]), excl)
    assert got == jvariant_key(JTable.uniform(**TABLES[table]), JShape(*SHAPES[shape]), excl)
    assert got[1] == (SHAPES[shape][3], SHAPES[shape][1], SHAPES[shape][2])


@pytest.fixture(scope="module")
def caches():
    """A factory of (port cache, JAX cache) pairs on one decode shape."""
    jm = jbuild_model(JArch(**FIELDS, moe=JMoE(**MOE)), {"data": 1, "model": 1},
                      dtype=jnp.float32)
    model = build_model(ArchConfig(**FIELDS, moe=MoEConfig(**MOE)), {"data": 1, "model": 4},
                        device="cpu", shard_attention=True, expert_axes=("model",),
                        moe_exec="gather")
    mesh = make_smoke_mesh()

    def make(max_entries):
        shape = SHAPES["decode"]
        port = PolicyVariantCache(model, {"data": 1, "model": 4}, InputShape(*shape),
                                  lambda xp: CountingStep(lambda params, inputs: {}, {}),
                                  max_entries=max_entries)
        ref = JCache(jm, mesh, {"data": 1, "model": 1}, JShape(*shape), mode="dwdp",
                     max_entries=max_entries)
        return port, ref

    return make


# get sequences: (table, shape override or None)
SEQUENCES = {
    "switches": [("demand", None), ("predictive", None), ("demand", None), ("all", None),
                 ("predictive", None), ("sync_free", None), ("demand", None)],
    "buckets": [("all", "prefill_16"), ("all", "prefill_8"), ("all", "prefill_16"),
                ("demand_b3", "prefill_8"), ("all", "prefill_8"), ("demand_b3", "prefill_16")],
}


@pytest.mark.parametrize("max_entries", [2, 16])
@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_variant_cache_stats_match_jax(caches, seq, max_entries):
    port, ref = caches(max_entries)
    for table, shape in SEQUENCES[seq]:
        kw = {} if shape is None else {"shape": InputShape(*SHAPES[shape])}
        jkw = {} if shape is None else {"shape": JShape(*SHAPES[shape])}
        xp, step = port.get(PolicyTable.uniform(**TABLES[table]), **kw)
        jxp = ref.get(JTable.uniform(**TABLES[table]), **jkw)[0]
        assert port.stats == ref.stats
        assert len(port) == len(ref)
        assert xp.policies.describe() == jxp.policies.describe()
        assert (xp.phase, xp.seq_len, xp.global_batch) == (jxp.phase, jxp.seq_len,
                                                           jxp.global_batch)
        assert step.captures() == 0  # the CPU captures nothing
    assert port.captures() == 0
    # a peer-exclusion set (the degradation ladder's rung) keys its own variant
    xp, _ = port.get(PolicyTable.uniform(fetch="demand"), (1,))
    jxp = ref.get(JTable.uniform(fetch="demand"), (1,))[0]
    assert xp.exclude_peers == jxp.exclude_peers == (1,)
    assert port.stats == ref.stats and len(port) == len(ref)


def test_eviction_releases_the_step():
    """An evicted variant's step drops its graph and outputs."""
    model = build_model(ArchConfig(**FIELDS, moe=MoEConfig(**MOE)), {"data": 1, "model": 4},
                        device="cpu", shard_attention=True, expert_axes=("model",),
                        moe_exec="gather")
    port = PolicyVariantCache(model, {"data": 1, "model": 4}, InputShape(*SHAPES["decode"]),
                              lambda xp: CountingStep(lambda params, inputs: {}, {}),
                              max_entries=1)
    _, first = port.get(PolicyTable.uniform())
    first.graph, first.outputs = object(), {"logits": torch.zeros(1)}  # as if captured
    _, second = port.get(PolicyTable.uniform(fetch="demand"))
    assert second is not first and len(port) == 1 and port.stats["evictions"] == 1
    assert first.graph is None and first.outputs is None


def test_adopt_seeds_a_variant_without_a_miss(caches):
    """``adopt`` seeds an entry without a miss, and the next ``get`` of it
    hits, in both packages."""
    port, ref = caches(4)
    table, jtable = PolicyTable.uniform(fetch="demand"), JTable.uniform(fetch="demand")
    entry = port.get(PolicyTable.uniform())
    port.adopt(table, (), entry)
    ref.adopt(jtable, (), ref.get(JTable.uniform()))
    assert port.stats == ref.stats == {"hits": 0, "misses": 1, "evictions": 0}
    assert port.get(table) is entry
    ref.get(jtable)
    assert port.stats == ref.stats and len(port) == len(ref) == 2


# --------------------------------------------------------------------------
# Host counters through captures and replays (a stand-in for the CUDA graph).
# --------------------------------------------------------------------------
class _Graph:
    def replay(self):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    """CountingStep captures into a stand-in graph in a stand-in space; the
    counters are restored after the test. The collection a capture runs first
    (a dropped graph freed inside a capture would invalidate it) has no
    graph to free here, and a full collection of the test process takes a
    fifth of a second: it is skipped."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(gc, "collect", lambda *a, **k: 0)
    with counters.recording():
        yield types.SimpleNamespace(eager=contextlib.nullcontext,
                                    pool=types.SimpleNamespace(id=None), stream=None)


def _counting_fn(params, inputs):
    """A step that counts as the port's kernels, landings and demand layers
    do."""
    registry.KERNELS["split_stack_gemm"].launches += 3
    dense.PATHS[("split_stack_gemm", "stack", "hopper", "rows>2")] += 3
    prefetch.LANDED.bytes += 1000
    execution.DEMAND.layers += 2
    return {"out": inputs["x"] + 1}


def test_recording_takes_the_record_back_out():
    before = counters.snapshot()
    with counters.recording() as record:
        _counting_fn(None, {"x": torch.zeros(1)})
    assert counters.snapshot() == before
    assert record == {("split_stack_gemm", "launches"): 3, ("landed", "bytes"): 1000,
                      ("demand", "layers"): 2,
                      ("dense paths", ("split_stack_gemm", "stack", "hopper", "rows>2")): 3}
    counters.add(record)
    counters.add({k: -n for k, n in record.items()})
    assert counters.snapshot() == before


def test_capture_counts_nothing_and_each_replay_adds_its_record(fake_graphs):
    """The eager warm-up before a capture ran on the device and counts;
    the capture ran nothing and counts nothing; each replay adds what the
    capture recorded."""
    step = CountingStep(_counting_fn, {"x": torch.zeros(1)}, fake_graphs)
    once = counters.snapshot()
    _counting_fn(None, {"x": torch.zeros(1)})
    once = counters.snapshot() - once
    counters.add({k: -n for k, n in once.items()})
    before = counters.snapshot()
    assert step.warm(None) == 1 and step.captures() == 1
    assert counters.snapshot() == before + once  # the warm-up only
    assert step.record == once
    for n in (1, 2):
        step(None, x=torch.ones(1))
        assert step.replays == n
        assert counters.snapshot() == before + collections.Counter(
            {k: (1 + n) * v for k, v in once.items()})
    assert step.warm(None) == 0


def test_cache_captures_count_every_capture(fake_graphs):
    """``captures()`` counts every capture of a step the cache built: an
    eviction does not lower it, and a recapture — of a variant built
    again, or of an evicted step still called — raises it."""
    model = build_model(ArchConfig(**FIELDS, moe=MoEConfig(**MOE)), {"data": 1, "model": 4},
                        device="cpu", shard_attention=True, expert_axes=("model",),
                        moe_exec="gather")
    cache = PolicyVariantCache(
        model, {"data": 1, "model": 4}, InputShape(*SHAPES["decode"]),
        lambda xp: CountingStep(lambda params, inputs: {}, {}, fake_graphs), max_entries=1)
    _, first = cache.get(PolicyTable.uniform())
    first.warm(None)
    _, second = cache.get(PolicyTable.uniform(fetch="demand"))  # evicts the first
    assert first.graph is None and cache.captures() == 1
    second.warm(None)
    assert cache.captures() == 2
    first(None)  # an evicted step still held and called captures again
    assert cache.captures() == 3
    _, again = cache.get(PolicyTable.uniform())
    again(None)
    assert again is not first and cache.captures() == 4 == cache.stats["misses"] + 1
