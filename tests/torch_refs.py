"""JAX-side weights and runs shared by the port's parity tests, built once
per process.

Several ``tests/test_torch_*.py`` files hold the port against the JAX
package on the same weights and the same JAX runs: the tiny MoE model
(``test_torch_model``, ``test_torch_data_parallel``), the Gemma-3-like
window model (``test_torch_window``, ``test_torch_data_parallel``) and the
reduced DeepSeek-R1 engine (``test_torch_engine``,
``test_torch_data_parallel``). Each builder is cached
(``functools.cache``), so a pytest run that takes those files in one process
builds the weights and serves the JAX engine once; the files' module
fixtures return the cached objects, which the tests only read.

The weights are the JAX package's own ``init_params`` at (1, 1) and at
(1, 4) from one key (:func:`jax_params`): the port converts the tree that
the JAX package laid out itself, and the JAX runs read the (1, 1) tree of
the same canonical values.
"""
import functools

import numpy as np

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.configs import reduced_variant as jreduced
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import BlockKind as JKind
from repro.configs.base import MoEConfig as JMoE
from repro.launch.mesh import _mesh
from repro.models.transformer import build_model as jbuild_model
from repro.runtime.engine import ContextServer as JContextServer
from repro.runtime.engine import DisaggregatedEngine as JEngine
from repro.runtime.engine import GenerationServer as JGenerationServer
from repro.runtime.engine import Request as JRequest
from repro_torch.configs import get_arch, reduced_variant
from repro_torch.configs.base import ArchConfig, BlockKind, MoEConfig


def jax_params(jm1, jm4, seed: int) -> tuple:
    """The JAX package's own ``init_params`` of ``jm1``'s (1, 1) and
    ``jm4``'s (1, 4) layouts from one key, compiled as one program (eager
    ``init_params`` compiles one small program per leaf shape, seconds per
    configuration): ``(jax (1, 1) tree, numpy (1, 4) tree)``. The JAX
    package draws canonical tensors and then lays them out, so both trees
    hold the same canonical values; the port converts the (1, 4) tree."""
    both = jax.jit(lambda k: (jm1.init_params(k), jm4.init_params(k)))(jax.random.key(seed))
    return both[0], jax.tree.map(np.asarray, both[1])


def jax_engine(jcfg, params, *, prefill_len: int, cache_len: int, max_batch: int = 2,
               prefill_buckets: tuple = (), gen_mode: str = "dwdp"):
    """The JAX package's engine at (1, 1) on ``params`` (``repro.launch.serve.
    build_engine``'s servers, without its ``init_params``)."""
    sizes = {"data": 1, "model": 1}
    mesh = _mesh((1, 1), ("data", "model"))
    model = jbuild_model(jcfg, sizes, dtype=jnp.float32)
    ctx = JContextServer(model, mesh, sizes, mode="dwdp", prefill_len=prefill_len,
                         prefill_buckets=prefill_buckets, cache_len=cache_len)
    gen = JGenerationServer(model, mesh, sizes, mode=gen_mode, max_batch=max_batch,
                            cache_len=cache_len)
    return JEngine(params, ctx, gen)


# --- the tiny MoE model ----------------------------------------------------
MOE_GEOM = dict(shard_attention=True, expert_axes=("model",), moe_exec="gather")
# vocab divisible by 4 (identical canonical values at (1,1) and (1,4));
# E = 8, top_k = 2 (2 local experts per rank, rotation exercised); 2 kv
# heads (kv_shard 2: the KV de-duplication path); a shared expert; a
# dense first layer and an MoE second layer.
MOE_FIELDS = dict(name="tiny-moe", family="moe", num_layers=2, d_model=64, num_heads=4,
                  num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
MOE_EXPERTS = dict(num_experts=8, top_k=2, d_ff=32, shared_d_ff=32, first_dense=1)


@functools.cache
def tiny_moe() -> dict:
    """The tiny MoE model's weights: the JAX (1, 1) tree and the (1, 4)
    tree (numpy) of the same canonical values, from ``init_params``."""
    jcfg = JArch(**MOE_FIELDS, moe=JMoE(**MOE_EXPERTS))
    cfg = ArchConfig(**MOE_FIELDS, moe=MoEConfig(**MOE_EXPERTS))
    jm1 = jbuild_model(jcfg, {"data": 1, "model": 1}, dtype=jnp.float32)
    jm4 = jbuild_model(jcfg, {"data": 1, "model": 4}, dtype=jnp.float32, **MOE_GEOM)
    jparams1, jparams4 = jax_params(jm1, jm4, seed=3)
    return dict(jcfg=jcfg, cfg=cfg, jm1=jm1, jparams1=jparams1, jparams4=jparams4)


# --- the Gemma-3-like window model -----------------------------------------
WINDOW_GEOM = dict(shard_attention=True, ffn_axes_override=("model",))
WINDOW_FIELDS = dict(name="tiny-window", family="dense", num_layers=4, d_model=64, num_heads=4,
                     num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, window=8,
                     rope_theta=1_000_000.0, tie_embeddings=True)


@functools.cache
def tiny_window() -> dict:
    """Dense, a LOCAL_ATTN and a GLOBAL_ATTN layer per cycle (two cycles: a
    scan group), tied embeddings, Gemma-3's RoPE base: the JAX (1, 1) and
    (1, 4) trees of the same canonical values."""
    jcfg = JArch(**WINDOW_FIELDS, block_pattern=(JKind.LOCAL_ATTN, JKind.GLOBAL_ATTN))
    cfg = ArchConfig(**WINDOW_FIELDS, block_pattern=(BlockKind.LOCAL_ATTN, BlockKind.GLOBAL_ATTN))
    jm1 = jbuild_model(jcfg, {"data": 1, "model": 1}, dtype=jnp.float32)
    jm4 = jbuild_model(jcfg, {"data": 1, "model": 4}, dtype=jnp.float32, **WINDOW_GEOM)
    jparams1, jparams4 = jax_params(jm1, jm4, seed=5)
    return dict(jcfg=jcfg, cfg=cfg, jm1=jm1, jparams1=jparams1, jparams4=jparams4)


# --- the reduced DeepSeek-R1 engine ----------------------------------------
R1_PROMPT, R1_CACHE, R1_OUT = 16, 32, 5
# decode steps that serve 3 requests through 2 slots: OUT - 1 for the
# first two, then OUT - 1 for the third
R1_STEPS = 2 * (R1_OUT - 1)


@functools.cache
def r1_smoke() -> tuple:
    """Reduced DeepSeek-R1 (E = top_k = 4: every expert receives every
    token, so no token is dropped in any layout at factor 1.25), its
    weights in the JAX (1, 4) layout and in the (1, 1) one (the same
    canonical values) and seeded prompts: ``(cfg, jcfg, jparams,
    prompts)``; the (1, 1) tree is ``r1_params1()``."""
    return _r1()[:4]


@functools.cache
def _r1() -> tuple:
    jcfg = jreduced(jget_arch("deepseek-r1"))
    cfg = reduced_variant(get_arch("deepseek-r1"))
    jm1 = jbuild_model(jcfg, {"data": 1, "model": 1}, dtype=jnp.float32)
    jm4 = jbuild_model(jcfg, {"data": 1, "model": 4}, dtype=jnp.float32, **MOE_GEOM)
    jparams1, jparams = jax_params(jm1, jm4, seed=0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, R1_PROMPT) for _ in range(3)]
    return cfg, jcfg, jparams, prompts, jparams1


def r1_params1():
    """``r1_smoke``'s weights in the JAX (1, 1) layout."""
    return _r1()[4]


@functools.cache
def jax_serve():
    """The JAX engine at (1, 1) serving ``r1_smoke``'s prompts through its
    loop, ``R1_OUT`` tokens each, 2 slots."""
    _, jcfg, _, prompts = r1_smoke()
    jeng = jax_engine(jcfg, r1_params1(), prefill_len=R1_PROMPT, cache_len=R1_CACHE)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(i, p, R1_OUT))
    jeng.run(R1_STEPS)
    return jeng
