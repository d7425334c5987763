"""The port's serving engine against the JAX package's, end to end — the
engine loop (DWDP, and a DWDP context server feeding a DEP generation
server) and the serving layer's live client (rolling, epoch, and an
SLO-gated serve that evicts and resumes) against one JAX engine run — and
the weights carried across (the card-only kernel test is
tests/test_torch_cuda.py, which imports no JAX)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.npz import save_pytree
from repro.configs import get_arch as jget_arch
from repro.configs import reduced_variant as jreduced
from repro.launch.serve import build_engine as jbuild_engine
from repro.models.transformer import build_model as jbuild_model
from repro.runtime.engine import Request as JRequest
from repro_torch.checkpoint.convert import from_jax_params, load_npz
from repro_torch.configs import get_arch, reduced_variant
from repro_torch.launch.serve import build_engine
from repro_torch.models.transformer import build_model
from repro_torch.runtime.engine import Request
from repro_torch.runtime.serving import (
    AdmissionController,
    LiveReplicaClient,
    ServedRequest,
    ServingScheduler,
    SLOConfig,
)

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

GEOM = dict(shard_attention=True, expert_axes=("model",), moe_exec="gather")
PROMPT, CACHE, OUT = 16, 32, 5
# decode steps that serve 3 requests through 2 slots: OUT - 1 for the
# first two, then OUT - 1 for the third
STEPS = 2 * (OUT - 1)


@pytest.fixture(scope="module")
def r1_smoke():
    """Reduced DeepSeek-R1 (E = top_k = 4: every expert receives every
    token, so no token is dropped in either layout at factor 1.25), the
    JAX (1, 4) weights — the same canonical values as the (1, 1) engine's
    — and seeded prompts."""
    jcfg = jreduced(jget_arch("deepseek-r1"))
    cfg = reduced_variant(get_arch("deepseek-r1"))
    jm4 = jbuild_model(jcfg, {"data": 1, "model": 4}, dtype=jnp.float32, **GEOM)
    jparams = jax.tree.map(np.asarray, jm4.init_params(jax.random.key(0)))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT) for _ in range(3)]
    return cfg, jcfg, jparams, prompts


@pytest.fixture(scope="module")
def jax_serve(r1_smoke):
    """The JAX engine at (1, 1) serving the prompts through its loop (run
    once for the module): its engine, outputs and summary."""
    _, jcfg, _, prompts = r1_smoke
    jeng, _ = jbuild_engine(jcfg, mesh_shape=(1, 1), prefill_len=PROMPT, cache_len=CACHE,
                            max_batch=2, gen_mode="dwdp", dtype=jnp.float32, seed=0)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(i, p, OUT))
    jeng.run(STEPS)
    return jeng


def _port_engine(r1_smoke, gen_mode="dwdp"):
    cfg, _, jparams, _ = r1_smoke
    model = build_model(cfg, {"data": 1, "model": 4}, device="cpu", **GEOM)
    eng, _ = build_engine(cfg, mesh_shape=(1, 4), prefill_len=PROMPT, cache_len=CACHE,
                          max_batch=2, gen_mode=gen_mode, device="cpu",
                          params=from_jax_params(jparams, model), geom_kwargs=GEOM)
    return eng


def test_engine_tokens_match_jax_engine(r1_smoke, jax_serve):
    prompts = r1_smoke[3]
    eng = _port_engine(r1_smoke)
    assert eng.gen.xp.seq_axes == ("model",)  # max_batch 2: KV cache seq-sharded
    eng.warmup()  # off the serving path; must leave the slots untouched
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, OUT))
    eng.run(STEPS)
    assert not eng.busy()
    assert eng.outputs == jax_serve.outputs
    summary = eng.metrics.summary(horizon=eng.horizon())
    assert summary["completed"] == 3 and summary["total_output_tokens"] == 3 * OUT
    assert summary["ttft_p50_s"] > 0 and summary["tpot_p50_s"] > 0
    # each request is attributed its prefill's wire bytes and its share of
    # every decode step's (the JAX engine at (1, 1) gathers nothing)
    full = 3 * eng.ctx.gather_bytes["full"] + STEPS * eng.gen.gather_bytes["full"]
    assert summary["gathered_mb_full"] == round(full / 1e6, 3) > 0
    assert summary["gather_fetch_ratio"] == 1.0


def test_dep_generation_server_matches_jax_engine(r1_smoke, jax_serve):
    """The reference's default serving configuration: a DWDP context server
    feeding a DEP generation server (all-to-all experts, tensor-parallel
    FFN, merged decode attention) hands its KV over unchanged and gives the
    JAX engine's streams (at (1, 1) the JAX package's DEP is its DWDP).
    DEP decode gathers only the attention weights and attaches no
    predictive state."""
    prompts = r1_smoke[3]
    eng = _port_engine(r1_smoke, gen_mode="dep")
    assert (eng.ctx.xp.mode, eng.gen.xp.mode) == ("dwdp", "dep")
    assert "pred" not in eng.gen.state
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, OUT))
    eng.run(STEPS)
    assert not eng.busy()
    assert eng.outputs == jax_serve.outputs
    fams = eng.gen.gather_bytes["families"]
    assert fams["attn_qkv"]["full"] > 0 and fams["moe_experts"]["full"] == 0


def test_live_serving_matches_jax_engine(r1_smoke, jax_serve):
    """The port's ServingScheduler over LiveReplicaClient: rolling and epoch
    admission, and an SLO-gated serve whose projection admits (an
    optimistic step time) and whose every measured step misses its target
    (evict_after 2: evictions and resumes), all give the JAX engine's
    streams; the snapshot plan is the reference server's (the reference
    runs at (1, 1), the port at (1, 4))."""
    prompts = r1_smoke[3]
    eng = _port_engine(r1_smoke)
    client = LiveReplicaClient.from_engine(eng)
    client.warmup()
    reqs = [ServedRequest(req_id=i, prompt_len=PROMPT, target_len=OUT, tokens=p)
            for i, p in enumerate(prompts)]
    runs = {}
    for name in ("rolling", "epoch", "slo"):
        admission = (AdmissionController(SLOConfig(target_tps_user=1e9, evict_after=2),
                                         lambda batch: 0.0) if name == "slo" else None)
        sched = ServingScheduler(client, admission=admission, epoch_mode=name == "epoch")
        sched.submit(reqs)
        sched.run()
        runs[name] = sched.metrics.summary(horizon=sched.t)
        assert sched.outputs == jax_serve.outputs, name
    assert runs["rolling"]["completed"] == runs["epoch"]["completed"] == 3
    assert runs["slo"]["admission"]["evicted"] >= 1
    assert runs["slo"]["admission"]["resumed"] == runs["slo"]["admission"]["evicted"]
    assert runs["rolling"]["gather_fetch_ratio"] == 1.0 and runs["rolling"]["tps_per_gpu"] > 0
    assert eng.gen.restore_plan() == dict(jax_serve.gen.restore_plan(),
                                          mesh=(("data", 1), ("model", 4)))


def test_load_npz_reads_save_pytree(r1_smoke, tmp_path):
    cfg, _, jparams, _ = r1_smoke
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, jparams, max_chunk_bytes=1 << 16)  # forces chunked leaves
    loaded = load_npz(path)
    model = build_model(cfg, {"data": 1, "model": 4}, device="cpu", **GEOM)
    a, b = from_jax_params(loaded, model), from_jax_params(jparams, model)

    def leaves(t):
        return [x for v in t.values() for x in leaves(v)] if isinstance(t, dict) else [t]

    for ra, rb in zip(a, b):
        assert all(torch.equal(x, y) for x, y in zip(leaves(ra), leaves(rb)))


def test_from_jax_params_checks_geometry(r1_smoke):
    cfg, jcfg, jparams, _ = r1_smoke
    model = build_model(cfg, {"data": 1, "model": 4}, device="cpu", **GEOM)
    bad = dict(jparams, embed=jparams["embed"][:-4])
    with pytest.raises(ValueError, match="vocab_pad"):
        from_jax_params(bad, model)
    # a tree built without the attention override keeps attention replicated
    jm_repl = jbuild_model(jcfg, {"data": 1, "model": 4}, dtype=jnp.float32)
    repl = jax.tree.map(np.asarray, jm_repl.init_params(jax.random.key(0)))
    with pytest.raises(ValueError, match="attention stack"):
        from_jax_params(repl, model)


TOL = {"float32": 2e-5}  # tests/test_kernels.py TOL


def test_prefill_buckets_match_jax_context_server(r1_smoke):
    """Prefill buckets 8 and 16 on the port's context server at (1, 4)
    against the JAX package's at (1, 1): the same first token and the last
    logits within TOL, each length through its own bucket's step; the
    same bucket set and the same refusal of a non-pow2 bucket."""
    cfg, jcfg, jparams, prompts = r1_smoke
    jeng, _ = jbuild_engine(jcfg, mesh_shape=(1, 1), prefill_len=PROMPT, prefill_buckets=(8,),
                            cache_len=CACHE, max_batch=2, gen_mode="dwdp", dtype=jnp.float32,
                            seed=0)
    model = build_model(cfg, {"data": 1, "model": 4}, device="cpu", **GEOM)
    eng, _ = build_engine(cfg, mesh_shape=(1, 4), prefill_len=PROMPT, prefill_buckets=(8,),
                          cache_len=CACHE, max_batch=2, device="cpu",
                          params=from_jax_params(jparams, model), geom_kwargs=GEOM)
    assert eng.ctx.prefill_lens == jeng.ctx.prefill_lens == (8, 16)
    for length in (8, 16):
        tokens = prompts[length // 8][:length]
        jfirst, _ = jeng.ctx.prefill(jeng.params, tokens)
        jlogits = jeng.ctx.step(jeng.params, {"tokens": jnp.asarray(tokens[None, :], jnp.int32)})
        first, state = eng.ctx.prefill(eng.params, tokens)
        assert eng.ctx.xp.seq_len == length and state["pos"].tolist() == [length]
        assert first == jfirst
        got = eng.ctx.step(eng.params, tokens=torch.as_tensor(tokens[None, :]))["last_logits"]
        np.testing.assert_allclose(got[:, :cfg.vocab_size].numpy(),
                                   np.asarray(jlogits["last_logits"])[:, :cfg.vocab_size],
                                   atol=TOL["float32"], rtol=TOL["float32"])
    for bad in (12, 0):
        with pytest.raises(ValueError, match="powers of two"):
            build_engine(cfg, mesh_shape=(1, 4), prefill_len=PROMPT, prefill_buckets=(bad,),
                         cache_len=CACHE, device="cpu", geom_kwargs=GEOM)
        with pytest.raises(ValueError, match="powers of two"):
            jbuild_engine(jcfg, mesh_shape=(1, 1), prefill_len=PROMPT, prefill_buckets=(bad,),
                          cache_len=CACHE, dtype=jnp.float32)
    with pytest.raises(ValueError, match="matches no context-server bucket"):
        eng.submit(Request(0, prompts[0][:12], 2))
    with pytest.raises(ValueError, match="matches no prefill bucket"):
        eng.ctx.prefill(eng.params, prompts[0][:4])
