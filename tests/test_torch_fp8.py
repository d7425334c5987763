"""Models stored in fp8 (e4m3, e5m2) in the port, against the JAX package.

The JAX package stores an fp8 model's weights and KV cache in fp8 and
computes in bf16, widening every weight on use (its ``_w`` and the Pallas
kernels' ``_cast``). The port does the same; on the card kernels #1-#6 widen
each fp8 tile on the chip, and on the CPU their plain versions widen the
banks (``cast_like``). Here, with inputs made by numpy from a seed:

- the plain versions of #2-#6 against the Pallas kernels in interpret mode
  (one jitted program for the module), each with its local banks in e4m3
  and its remote (or fetched) banks in e5m2;
- the tiny MoE of ``torch_refs`` at (1, 4) in e4m3: its greedy decode
  against the JAX package's fp8 decode at (1, 1), both from an empty cache;
  its prefill logits against the JAX package's bf16 prefill on the same
  weights widened to bf16 (exact): the JAX package's fp8 prefill raises at
  its head (``repro/core/execution.py:2286`` multiplies by the fp8 head
  without ``_w``), and the port widens there as the decode head does; its
  captured fp8 KV state against that run's state;
- within the port: the fp8 prefill is bitwise the bf16 model's on the
  widened weights, and its KV state bitwise that model's cast to e4m3;
- ``from_jax_params`` carries fp8 leaves bitwise, the wire bytes are the
  JAX package's at 1 byte a weight, and the plans and kernels that take no
  fp8 refuse it by name.

Tolerance: ``TOL["bfloat16"]`` of tests/test_kernels.py (2e-2), as max
error over max|ref|, since the compute is bf16; an fp8 KV entry may round
to the neighbouring e4m3 value where the two bf16 inputs differ, so the
fp8 state is held within one e4m3 step. The CUDA kernels' fp8 paths run on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import InputShape as JShape
from repro.core import execution as jexec
from repro.core import strategy as jstrategy
from repro.kernels.split_gemm import ops as jops
from repro.launch.mesh import make_smoke_mesh
from repro.models.cache import init_decode_state as jinit_decode_state
from repro.models.transformer import build_model as jbuild_model
from repro_torch.checkpoint.convert import from_jax_params, reshard_params
from repro_torch.configs.base import InputShape
from repro_torch.core import execution, prefetch, strategy
from repro_torch.kernels import _launch
from repro_torch.kernels.split_gemm import dense, grouped
from repro_torch.models.cache import init_decode_state
from repro_torch.models.transformer import build_model
from torch_refs import MOE_CACHE, MOE_CAP, MOE_GEOM, MOE_PROMPT, jit_quick, tiny_moe

# One intra-op thread per process: the suite runs several test workers.
torch.set_num_threads(1)

TOL = 2e-2  # tests/test_kernels.py TOL["bfloat16"]
BF, E4, E5 = torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2
FP8 = {"float8_e4m3fn": (E4, jnp.float8_e4m3fn), "float8_e5m2": (E5, jnp.float8_e5m2)}
G4 = {"data": 1, "model": 4}
DECODE_STEPS = 3
FIRST = [[3], [7]]


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# --------------------------------------------------------------------------
# Kernels #2-#6: the plain versions against the Pallas kernels.
# --------------------------------------------------------------------------
# (E, E_l, C, D, F) of the grouped kernels, (T, D, Fs, S_l, S_r) of the
# dense ones: a rotated split at a capacity and a row count that are no
# multiples of 8
GROUPED, DENSE = (4, 2, 3, 64, 32), (3, 64, 32, 1, 3)


def _inputs(local: str, remote: str) -> dict:
    """Every kernel's operands for both packages: bf16 activations, the
    local banks stored in ``local`` and the remote (fetched) ones in
    ``remote``, rounded once by torch and handed to JAX as the same stored
    values."""
    rng = np.random.default_rng(len(local))
    e, e_l, c, d, f = GROUPED
    t, dd, fs, s_l, s_r = DENSE
    s = s_l + s_r

    def arr(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    acts = {"x_e": arr(e, c, d, scale=1.0), "x": arr(t, dd, scale=1.0), "x_s": arr(s, t, fs)}
    banks = {"g_e": arr(e, d, f), "u_e": arr(e, d, f), "d_e": arr(e, f, d),
             "w_stack": arr(s, dd, fs), "w_reduce": arr(s, fs, dd),
             "g": arr(s, dd, fs), "u": arr(s, dd, fs), "d": arr(s, fs, dd)}
    tt = {k: torch.from_numpy(v).to(BF) for k, v in acts.items()}
    jj = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) for k, v in tt.items()}
    for k, v in banks.items():
        n = e_l if k.endswith("_e") else s_l
        for part, w, kind in ((":l", v[:n], local), (":r", v[n:], remote)):
            tt[k + part] = torch.from_numpy(np.ascontiguousarray(w)).to(FP8[kind][0])
            jj[k + part] = jnp.asarray(tt[k + part].float().numpy()).astype(FP8[kind][1])
    valid = np.arange(e - e_l) % 2 == 0
    tt["valid"], jj["valid"] = torch.from_numpy(valid), jnp.asarray(valid)

    def calls(a):
        def split(k):
            return a[k + ":l"], a[k + ":r"]

        ge, ue, de = (split(k) for k in ("g_e", "u_e", "d_e"))
        gl, ul, dl = (split(k) for k in ("g", "u", "d"))
        return {"split_grouped_swiglu": (a["x_e"], ge[0], ue[0], de[0], ge[1], ue[1], de[1]),
                "split_grouped_swiglu_demand": (a["x_e"], ge[0], ue[0], de[0], ge[1], ue[1],
                                                de[1], a["valid"]),
                "split_stack_gemm": (a["x"], *split("w_stack")),
                "split_reduce_gemm": (a["x_s"], *split("w_reduce")),
                "split_dense_swiglu": (a["x"], gl[0], ul[0], dl[0], gl[1], ul[1], dl[1])}

    return {"torch": calls(tt), "jax": calls(jj)}


#: (local banks, remote banks): each kernel widens both fp8 types in one call
#: (a second mix cost a second compile of every Pallas kernel, ~2 s)
MIX = ("float8_e4m3fn", "float8_e5m2")


TORCH_KERNELS = {"split_grouped_swiglu": grouped.split_grouped_swiglu,
                 "split_grouped_swiglu_demand": grouped.split_grouped_swiglu_demand,
                 "split_stack_gemm": dense.split_stack_gemm,
                 "split_reduce_gemm": dense.split_reduce_gemm,
                 "split_dense_swiglu": dense.split_dense_swiglu}
PALLAS = {"split_grouped_swiglu": jops.split_swiglu,
          "split_grouped_swiglu_demand": jops.split_swiglu_demand,
          "split_stack_gemm": jops.split_stack_matmul,
          "split_reduce_gemm": jops.split_reduce_matmul,
          "split_dense_swiglu": jops.split_dense_ffn}


@pytest.fixture(scope="module")
def pallas_refs():
    """Every kernel under MIX through its Pallas kernel (interpret mode),
    in one jitted program (each bank operand keeps its own fp8 type)."""
    return jit_quick(lambda ins: {k: PALLAS[k](*a) for k, a in ins.items()})(
        _inputs(*MIX)["jax"])


@pytest.mark.parametrize("kernel", list(TORCH_KERNELS))
def test_fp8_kernels_plain_match_pallas(pallas_refs, kernel):
    args = _inputs(*MIX)["torch"][kernel]
    remote = args[-2] if kernel == "split_grouped_swiglu_demand" else args[-1]
    assert (args[1].dtype, remote.dtype) == (E4, E5)
    got = TORCH_KERNELS[kernel](*args)  # CPU tensors: the plain version, widening on use
    assert got.dtype == BF
    assert _rel(got.float(), pallas_refs[kernel]) <= TOL


def test_fp8_kernel_refusals_and_plans():
    """What the CUDA kernels refuse, checked before a launch: fp8 banks
    beside fp32 activations and fp8 banks under a plan off the Hopper and
    few-row paths (a width that is no multiple of 16: #6 at 683 columns;
    an unaligned pointer). The fp8 plans keep the bf16 plan's tiles and
    stages at R1's shapes, and the few-row blocks cover 512 columns."""
    x = torch.zeros(4, 64, dtype=BF)
    w8 = torch.zeros(2, 64, 128).to(E4)
    with pytest.raises(TypeError, match="bfloat16 activations"):
        _launch.check_cuda_operands("split_stack_gemm", x.float(), w8, w8, fp8=True)
    assert _launch.check_cuda_operands("split_stack_gemm", x, w8, w8, fp8=True) == 1
    for op, n in (("gate_up", 683), ("stack", 72)):  # 683: #6 on (2, 3); 72 % 16
        plan = dense.plan_split(op, BF, 4, 64, n, 3, True, E4)
        assert plan.path == "mma" and dense.plan_split(op, BF, 4, 64, 72, 3, True).path != "mma"
        with pytest.raises(TypeError, match="Hopper and few-row paths only.*'mma'"):
            _launch.weight_code("split_dense_swiglu", (w8,), plan)
    unaligned = dense.plan_split("reduce", BF, 256, 64, 128, 4, False, E5)
    with pytest.raises(TypeError, match="'mma'"):
        _launch.weight_code("split_reduce_gemm", (w8.to(E5),), unaligned)
    with pytest.raises(TypeError, match="'tile_few_row'"):
        _launch.weight_code("split_grouped_swiglu", (w8,),
                            grouped.plan_grouped("gate_up", BF, 1, 64, 72, True, E4))
    assert _launch.weight_code("split_stack_gemm", (w8,), dense.plan_split(
        "stack", BF, 2, 64, 128, 4, True, E4)) == 1
    assert _launch.weight_code("split_stack_gemm", (w8.to(BF),), unaligned) == 0
    for op, k, n in (("stack", 7168, 4096), ("stack", 7168, 256), ("reduce", 4096, 7168),
                     ("gate_up", 7168, 4608), ("reduce", 4608, 7168)):
        for rows in (256, 2048):
            p8 = dense.plan_split(op, BF, rows, k, n, 4, True, E4)
            assert p8 == dense.plan_split(op, BF, rows, k, n, 4, True), (op, rows)
        few = dense.plan_split(op, BF, 2, k, n, 4, True, E4)
        assert few.path == "few_row"
        assert few == dense.few_row_plan(op, 2, k, n, 4, wbytes=1)
        assert dense.few_row_plan(op, 2, 2 * k, n, 4, wbytes=1).chunk >= 2 * few.chunk - 32
    for c in (1, 16, 88):
        for op, k, n in (("gate_up", 7168, 2048), ("down", 2048, 7168)):
            p8 = grouped.plan_grouped(op, BF, c, k, n, True, E5)
            assert p8.path == "hopper" and p8 == grouped.plan_grouped(op, BF, c, k, n, True)


# --------------------------------------------------------------------------
# The tiny MoE stored in e4m3.
# --------------------------------------------------------------------------
def _fp8_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32).astype(ml_dtypes.float8_e4m3fn),
                        tree)


@pytest.fixture(scope="module")
def fp8_moe():
    """The tiny MoE's weights rounded to e4m3 (numpy, the (1, 4) and (1, 1)
    layouts), two prompts, and the port's e4m3 and bf16 models at (1, 4) on
    those weights."""
    w = tiny_moe()
    p4 = _fp8_tree(w["jparams4"])
    rng = np.random.default_rng(11)
    prompts = np.stack([rng.integers(0, w["cfg"].vocab_size, MOE_PROMPT) for _ in range(2)])
    models = {dt: build_model(w["cfg"], G4, dtype=dt, device="cpu", **MOE_GEOM) for dt in (E4, BF)}
    return dict(w=w, p4=p4, p1=_fp8_tree(jax.tree.map(np.asarray, w["jparams1"])),
                prompts=prompts, models=models,
                params={dt: from_jax_params(p4, m) for dt, m in models.items()}, runs={})


@pytest.fixture(scope="module")
def jax_prefill(fp8_moe):
    """The JAX package's bf16 prefill at (1, 1) of both prompts on the
    widened weights (its fp8 prefill raises at the head): (logits, state)."""
    s, sizes1 = fp8_moe, {"data": 1, "model": 1}
    jm = jbuild_model(s["w"]["jcfg"], sizes1, dtype=jnp.bfloat16)
    xp = jstrategy.make_execution_plan(jm, JShape("p", MOE_PROMPT, 2, "prefill"), sizes1,
                                       capacity_factor=MOE_CAP)
    pre = jit_quick(jexec.make_step_fn(jm, xp, make_smoke_mesh(), capture_len=MOE_CACHE))
    out = pre(jax.tree.map(lambda a: jnp.asarray(a.astype(np.float32), jnp.bfloat16), s["p1"]),
              {"tokens": jnp.asarray(s["prompts"], jnp.int32)})
    return np.asarray(out["last_logits"]), out["state"]


@pytest.fixture(scope="module")
def jax_decode_tokens(fp8_moe):
    """The JAX package's greedy fp8 decode at (1, 1) from an empty cache."""
    s, sizes1 = fp8_moe, {"data": 1, "model": 1}
    jm = jbuild_model(s["w"]["jcfg"], sizes1, dtype=jnp.float8_e4m3fn)
    xp = jstrategy.make_execution_plan(jm, JShape("g", MOE_CACHE, 2, "decode"), sizes1,
                                       capacity_factor=MOE_CAP)
    dec = jit_quick(jexec.make_step_fn(jm, xp, make_smoke_mesh()))
    params, state = jax.tree.map(jnp.asarray, s["p1"]), jinit_decode_state(jm, 2, MOE_CACHE)
    tok, toks = jnp.asarray(FIRST, jnp.int32), []
    for _ in range(DECODE_STEPS):
        out = dec(params, {"token": tok}, state)
        tok, state = out["next_token"], out["state"]
        toks.append(np.asarray(tok)[:, 0].tolist())
    return toks


def _prefill(s, dt):
    if dt not in s["runs"]:
        model = s["models"][dt]
        xp = strategy.make_execution_plan(model, InputShape("p", MOE_PROMPT, 2, "prefill"), G4,
                                          capacity_factor=MOE_CAP)
        ctx = execution.Ctx(model=model, xp=xp, capture_len=MOE_CACHE)
        s["runs"][dt] = execution.forward_prefill(s["params"][dt], torch.as_tensor(s["prompts"]),
                                                  ctx)
    return s["runs"][dt]


def _kv(out) -> dict:
    """A prefill's captured K/V, each rank's ring slices joined: the (1, 1)
    ring of the JAX package, by (group, position, leaf)."""
    return {(g, key, f): torch.cat([r[f] for r in ranks], dim=1)
            for g, gd in out["state"]["layers"].items() for key, ranks in gd.items()
            for f in ("k", "v")}


def test_fp8_leaves_carry_across_bitwise(fp8_moe):
    s = fp8_moe
    params = s["params"][E4]
    emb = np.concatenate([p["embed"].view(torch.uint8).numpy() for p in params])
    np.testing.assert_array_equal(emb, s["p4"]["embed"].view(np.uint8))
    experts = params[1]["layers"]["body"]["pos0"]["moe"]["experts"]["w_gate"]
    assert experts.dtype == E4
    np.testing.assert_array_equal(
        experts.view(torch.uint8).numpy(),
        s["p4"]["layers"]["body"]["pos0"]["moe"]["experts"]["w_gate"][2:4].view(np.uint8))
    bf = s["params"][BF][1]["layers"]["body"]["pos0"]["moe"]["experts"]["w_gate"]
    assert torch.equal(bf, experts.to(BF))  # a bf16 model widens exactly
    assert "checksums" not in params[0]["layers"]["body"]["pos0"]["moe"]


def test_fp8_prefill_is_bitwise_the_widened_bf16_model(fp8_moe):
    """The fp8 model computes in bf16 on exactly the widened weights, so its
    prefill is bitwise the bf16 model's, and its K/V state that model's
    cast to e4m3."""
    o8, ob = _prefill(fp8_moe, E4), _prefill(fp8_moe, BF)
    assert torch.equal(o8["last_logits"], ob["last_logits"])
    k8, kb = _kv(o8), _kv(ob)
    for key, t in k8.items():
        assert t.dtype == E4 and kb[key].dtype == BF
        assert torch.equal(t.view(torch.uint8), kb[key].to(E4).view(torch.uint8)), key


def test_fp8_prefill_matches_jax_bf16_on_widened_weights(fp8_moe, jax_prefill):
    """Logits against the JAX package's bf16 prefill on the widened weights;
    the captured K/V: the bf16 model's (the fp8 state before its cast)
    within TOL of the JAX state, the fp8 state within one e4m3 step of that
    state cast to e4m3 (a value near a rounding boundary may round to the
    other side after bf16 differences)."""
    s, (jax_logits, jax_state) = fp8_moe, jax_prefill
    got = _prefill(s, E4)["last_logits"].numpy()
    assert got.shape == jax_logits.shape == (2, 256)
    assert _rel(got, jax_logits) <= TOL
    k8, kb = _kv(_prefill(s, E4)), _kv(_prefill(s, BF))
    for (g, key, f), t in k8.items():
        ref = np.asarray(jax_state["layers"][g][key][f]).astype(np.float32)
        assert _rel(kb[(g, key, f)].float().numpy(), ref) <= TOL, (g, key, f)
        ref8 = ref.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
        # one e4m3 step (3 mantissa bits; 2^-9 among the subnormals) beside
        # the bf16 states' own difference
        step = 2.0 ** -3 * np.abs(ref8) + 2.0 ** -9 + TOL * np.abs(ref).max()
        assert (np.abs(t.float().numpy() - ref8) <= step).all(), (g, key, f)


def test_fp8_decode_matches_jax_fp8_decode(fp8_moe, jax_decode_tokens):
    """Greedy decode of the e4m3 model from an empty fp8 cache, in all four
    fetch modes and under the ring and ring_sliced transports (copy
    schedules of the same fp8 bytes): the JAX package's fp8 tokens, and the
    tokens and logits of each bitwise the all-fetch allgather ones."""
    s = fp8_moe
    model, params = s["models"][E4], s["params"][E4]
    logits = {}
    for fetch, cache_budget, transport in (
            ("all", 0, "allgather"), ("demand", 0, "allgather"), ("predictive", 8, "allgather"),
            ("sync_free", 8, "allgather"), ("all", 0, "ring"), ("all", 0, "ring_sliced")):
        pol = strategy.PolicyTable.uniform(fetch=fetch, cache_budget=cache_budget,
                                           transport=transport)
        xp = strategy.make_execution_plan(model, InputShape("g", MOE_CACHE, 2, "decode"), G4,
                                          policy=pol, capacity_factor=MOE_CAP)
        state = execution.attach_predict_state(
            init_decode_state(model, 2, MOE_CACHE, seq_shards=4), model, xp)
        assert state["layers"]["body"]["pos0"][0]["k"].dtype == E4
        key = (fetch, transport)
        ctx, tok, toks, logits[key] = execution.Ctx(model=model, xp=xp), torch.as_tensor(FIRST), [], []
        for _ in range(DECODE_STEPS):
            out = execution.forward_decode(params, tok, state, ctx)
            tok, state = out["next_token"].long(), out["state"]
            toks.append(tok[:, 0].tolist())
            logits[key].append(out["logits"])
        assert state["layers"]["body"]["pos0"][0]["k"].dtype == E4
        assert toks == jax_decode_tokens, key
        assert all(torch.equal(a, b) for a, b in zip(logits[key], logits[("all", "allgather")])), key


def test_fp8_wire_bytes_match_jax_at_one_byte():
    """``gathered_wire_bytes_per_step`` of the e4m3 model against the JAX
    package's fp8 model (1 byte a weight) in every fetch mode, half the
    bf16 model's."""
    w = tiny_moe()
    jm = jbuild_model(w["jcfg"], G4, dtype=jnp.float8_e4m3fn, **MOE_GEOM)
    models = {dt: build_model(w["cfg"], G4, dtype=dt, device="cpu", **MOE_GEOM) for dt in (E4, BF)}
    for fetch in ("all", "demand", "predictive", "sync_free"):
        got = {}
        for dt, model in models.items():
            xp = strategy.make_execution_plan(model, InputShape("g", MOE_CACHE, 2, "decode"), G4,
                                              policy=strategy.PolicyTable.uniform(fetch=fetch))
            got[dt] = execution.gathered_wire_bytes_per_step(model, xp)
        jxp = jstrategy.make_execution_plan(jm, JShape("g", MOE_CACHE, 2, "decode"), G4,
                                            policy=jstrategy.PolicyTable.uniform(fetch=fetch))
        assert got[E4] == jexec.gathered_wire_bytes_per_step(jm, jxp), fetch
        assert got[E4]["families"]["attn_qkv"]["full"] * 2 == \
            got[BF]["families"]["attn_qkv"]["full"]


def test_fp8_landings_count_one_byte_a_weight():
    """A split bank of fp8 leaves lands as it is, and ``LANDED`` counts its
    real bytes."""
    x = torch.arange(4 * 6 * 4, dtype=torch.float32).reshape(4 * 6, 4)
    shards = [{"w": x[6 * r:6 * r + 6].reshape(1, 6, 4).to(E4)} for r in range(4)]
    prefetch.LANDED.bytes = 0
    bank = prefetch.gather_split_bank(shards, 1, execution._leading_placement(4))
    assert bank.remote["w"].dtype == E4 and bank.remote["w"].shape == (3, 6, 4)
    assert prefetch.LANDED.bytes == 3 * 6 * 4
    assert torch.equal(bank.local["w"].view(torch.uint8), shards[1]["w"].view(torch.uint8))


@pytest.mark.parametrize("what", ["dep", "hybrid", "merged", "validated", "faults", "mesh24",
                                  "reshard"])
def test_fp8_plans_outside_the_slice_raise(what):
    """An fp8 model under a plan the port does not hold for fp8 raises
    ``NotImplementedError`` naming fp8 when the plan is built (or, for a
    rank death's re-shard, when it is called)."""
    w = tiny_moe()
    mesh = {"data": 2, "model": 4} if what == "mesh24" else G4
    model = build_model(w["cfg"], mesh, dtype=E4, device="cpu", **MOE_GEOM)
    shape = InputShape("g", MOE_CACHE, 8 if what == "mesh24" else 2, "decode")
    kw = {"dep": dict(mode="dep"), "hybrid": dict(mode="hybrid"),
          "merged": dict(policy="merged:all:allgather"), "validated": dict(validate_fetch=True),
          "faults": dict(fault_spec="seed=1,drop=0.1"), "mesh24": {}, "reshard": {}}[what]
    with pytest.raises(NotImplementedError, match="fp8"):
        if what == "reshard":
            small = build_model(w["cfg"], {"data": 1, "model": 3}, dtype=E4, device="cpu",
                                **MOE_GEOM)
            reshard_params([], model, small, 0, {})
        else:
            strategy.make_execution_plan(model, shape, mesh, **kw)
    bf16 = build_model(w["cfg"], mesh, dtype=BF, device="cpu", **MOE_GEOM)
    if what != "reshard":  # the same plan of the bf16 model is built
        strategy.make_execution_plan(bf16, shape, mesh, **kw)
