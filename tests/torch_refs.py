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

The weights are canonical tensors drawn with numpy and scaled as the JAX
package's ``init_params`` scales its draws, laid out by that function's
steps at (1, 1) and at (1, 4) (:func:`jax_params`; its ``param_struct``
gives the same tree): the port converts the (1, 4) tree and the JAX runs
read the (1, 1) tree of the same canonical values. Compiling the JAX
package's ``init_params`` took seconds per configuration.
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


def _canonical_layer(rng, jcfg, geom, sig) -> dict:
    """One layer's canonical (unsharded) weights drawn with numpy, scaled as
    ``repro.models.transformer.init_layer_params`` scales its draws."""
    def dense(*shape, scale=None):
        scale = shape[-2] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if sig.kind not in (JKind.GLOBAL_ATTN, JKind.LOCAL_ATTN):
        raise NotImplementedError(f"no canonical draw for a {sig.kind} layer")
    d, qd, kvd = jcfg.d_model, jcfg.q_dim, jcfg.kv_dim
    out = {"attn": dict(wq=dense(d, qd), wk=dense(d, kvd), wv=dense(d, kvd), wo=dense(qd, d))}

    def ffn(f):
        s = geom.ffn_shards
        f_pad = -(-f // s) * s
        wd = dense(f_pad, d)
        wd[f:] = 0.0  # padded hidden units must not contribute
        return dict(w_gate=dense(d, f_pad), w_up=dense(d, f_pad), w_down=wd)

    if sig.is_moe:
        pl, fe = geom.moe_placement, jcfg.moe.d_ff
        valid = (np.arange(pl.num_padded) < jcfg.moe.num_experts).astype(np.float32)[:, None, None]
        out["moe"] = {"router": dense(d, pl.num_padded),
                      "experts": dict(w_gate=dense(pl.num_padded, d, fe) * valid,
                                      w_up=dense(pl.num_padded, d, fe) * valid,
                                      w_down=dense(pl.num_padded, fe, d) * valid)}
        if jcfg.moe.shared_d_ff:
            out["moe"]["shared"] = ffn(jcfg.moe.shared_d_ff)
    elif sig.ffn_dim:
        out["ffn"] = ffn(sig.ffn_dim)
    return out


def _jax_layout(jm, canon) -> dict:
    """The canonical weights ``canon`` in ``jm``'s storage layout: the tree
    ``jm.init_params`` returns, by the layout steps of ``init_attn_params``,
    ``init_ffn_params`` and ``init_moe_params``."""
    geom, d = jm.geom, jm.cfg.d_model
    a, ksd = geom.attn_shards, geom.kv_shard
    kv_rank = np.arange(a) // (a // ksd)

    def ffn(c):
        s = geom.ffn_shards
        f = c["w_down"].shape[0] // s
        return {"w_gate": c["w_gate"].reshape(d, s, f).transpose(1, 0, 2),
                "w_up": c["w_up"].reshape(d, s, f).transpose(1, 0, 2),
                "w_down": c["w_down"].reshape(s, f, d)}

    def layer(c):
        at = c["attn"]
        qd, kvd = at["wq"].shape[1], at["wk"].shape[1]
        out = {"norm1": np.zeros(d, np.float32),
               "attn": {"wq": at["wq"].reshape(d, a, qd // a).transpose(1, 0, 2),
                        "wo": at["wo"].reshape(a, qd // a, d),
                        **{k: at[k].reshape(d, ksd, kvd // ksd).transpose(1, 0, 2)[kv_rank]
                           for k in ("wk", "wv")}}}
        if "moe" in c:
            table = geom.moe_placement.table().reshape(-1)
            out["norm2"] = np.zeros(d, np.float32)
            out["moe"] = {"router": c["moe"]["router"],
                          "experts": {k: v[table] for k, v in c["moe"]["experts"].items()}}
            if "shared" in c["moe"]:
                out["moe"]["shared"] = ffn(c["moe"]["shared"])
        elif "ffn" in c:
            out["norm2"] = np.zeros(d, np.float32)
            out["ffn"] = ffn(c["ffn"])
        return out

    layers = {}
    for group, cycles in zip(jm.plan, canon["layers"]):
        layers[group.name] = {
            f"pos{j}": (jax.tree.map(lambda *xs: np.stack(xs), *[layer(c[j]) for c in cycles])
                        if group.scan else layer(cycles[0][j]))
            for j in range(len(group.sigs))}
    tree = {"embed": canon["embed"], "final_norm": np.zeros(d, np.float32), "layers": layers}
    if "lm_head" in canon:
        tree["lm_head"] = canon["lm_head"]
    return tree


def jax_params(jm1, jm4, seed: int) -> tuple:
    """Canonical weights drawn with numpy from ``seed``, scaled as the JAX
    package's ``init_params`` scales its draws, in ``jm1``'s (1, 1) and
    ``jm4``'s (1, 4) storage layouts: ``(jax (1, 1) tree, numpy (1, 4)
    tree)`` of the same canonical values; the port converts the (1, 4)
    tree. Drawing with numpy spares the compile of the JAX package's
    ``init_params`` (seconds per configuration)."""
    g1, g4 = jm1.geom, jm4.geom
    pads = lambda g: (g.vocab_pad, g.moe_placement.num_padded if g.moe_placement else 0)
    if pads(g1) != pads(g4) or [(g.name, g.scan, g.n_cycles, g.sigs) for g in jm1.plan] != \
            [(g.name, g.scan, g.n_cycles, g.sigs) for g in jm4.plan]:
        raise ValueError("the two layouts do not hold the same canonical weights")
    rng = np.random.default_rng(seed)
    d, cfg = jm1.cfg.d_model, jm1.cfg
    canon = {"embed": rng.standard_normal((g1.vocab_pad, d)).astype(np.float32), "layers": [
        [[_canonical_layer(rng, cfg, g4, sig) for sig in group.sigs]
         for _ in range(group.n_cycles if group.scan else 1)]
        for group in jm1.plan]}
    if not cfg.tie_embeddings:
        canon["lm_head"] = (rng.standard_normal((d, g1.vocab_pad)) * d ** -0.5).astype(np.float32)
    return jax.tree.map(jnp.asarray, _jax_layout(jm1, canon)), _jax_layout(jm4, canon)


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
    jparams1, jparams4 = jax_params(jm1, jm4, seed=4)
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
