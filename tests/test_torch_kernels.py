"""The port's kernel modules against the JAX package at small shapes.

Each plain version (what a kernel wrapper runs for CPU tensors) is held
against the Pallas kernel in interpret mode, as tests/test_kernels.py
runs it, and against the JAX package's jnp formulation. Inputs are made
with numpy from a seed. The CUDA kernels themselves run only on the card
(tests/test_torch_engine.py::test_cuda_kernels_match_plain_versions).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.split_gemm import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.kernels import _launch
from repro_torch.kernels.split_gemm import dense, grouped
from repro_torch.kernels.split_gemm import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

# The JAX references run under jax.jit, in one program per module or test: eager JAX
# compiles every op at every new shape, seconds per small test.
# tests/test_kernels.py TOL: fp32 2e-5, bf16 2e-2 (atol and rtol)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, *shapes, scale=0.1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _both(arrs, dt):
    return [jnp.asarray(a, JDT[dt]) for a in arrs], [torch.from_numpy(a).to(TDT[dt]) for a in arrs]


def _close(got_t, ref_j, dt):
    np.testing.assert_allclose(
        got_t.float().numpy(), np.asarray(ref_j, np.float32), atol=TOL[dt], rtol=TOL[dt]
    )


def _swiglu_shapes(e, e_l, c, d, f):
    e_r = e - e_l
    return [(e, c, d), (e_l, d, f), (e_l, d, f), (e_l, f, d), (e_r, d, f), (e_r, d, f), (e_r, f, d)]


def _dense_swiglu_shapes(t, d, f, s_l, s_r):
    return [(t, d), (s_l, d, f), (s_l, d, f), (s_l, f, d), (s_r, d, f), (s_r, d, f), (s_r, f, d)]


# (E, E_l, C, D, F): a rotated split, all-remote (E_l = 0), all-local
# (E_r = 0), capacities that are not multiples of 8, and C = 1; every
# shape in fp32, two in bf16 (interpret-mode Pallas is the cost here).
GROUPED = [(4, 2, 5, 64, 32), (4, 0, 1, 64, 32), (4, 4, 3, 64, 32), (8, 2, 1, 64, 64)]
GROUPED_CASES = [(s, "float32") for s in GROUPED] + [(s, "bfloat16") for s in GROUPED[:2]]
# (T, D, Fs, S_l, S_r)
DENSE = [(5, 64, 32, 1, 3), (1, 64, 32, 0, 2), (2, 64, 32, 2, 0)]
DENSE_CASES = [(s, "float32") for s in DENSE] + [(DENSE[0], "bfloat16")]


def _grouped_inputs(shape, dt):
    return _both(_arrays(sum(shape), *_swiglu_shapes(*shape)), dt)


def _dense_inputs(shape, dt):
    """(stack, reduce, dense-FFN) operands, each (JAX, torch)."""
    t, d, f, s_l, s_r = shape
    x, wl, wr, xr, wl2, wr2 = _arrays(
        sum(shape), (t, d), (s_l, d, f), (s_r, d, f), (s_l + s_r, t, f), (s_l, f, d), (s_r, f, d))
    return (_both([x, wl, wr], dt), _both([xr, wl2, wr2], dt),
            _both(_arrays(sum(shape) + 1, *_dense_swiglu_shapes(*shape)), dt))


BOTH = ({}, {"impl": "jnp"})  # each kernel: the Pallas kernel (interpret mode), then jnp


@pytest.fixture(scope="module")
def grouped_refs():
    """Every grouped case's JAX references, computed in one jitted program
    for the module (a program per case paid ~0.2 s of compile overhead)."""
    ins = {str(c): _grouped_inputs(*c)[0] for c in GROUPED_CASES}
    return jax.jit(lambda ins: {k: [jops.split_swiglu(*a, **kw) for kw in BOTH]
                                for k, a in ins.items()})(ins)


@pytest.fixture(scope="module")
def dense_refs():
    """Every dense case's JAX references of #4, #5 and #6, in one program."""
    fns = (jops.split_stack_matmul, jops.split_reduce_matmul, jops.split_dense_ffn)
    ins = {str(c): [ops[0] for ops in _dense_inputs(*c)] for c in DENSE_CASES}
    return jax.jit(lambda ins: {k: [[fn(*a, **kw) for kw in BOTH] for fn, a in zip(fns, ops)]
                                for k, ops in ins.items()})(ins)


@pytest.mark.parametrize("shape,dt", GROUPED_CASES, ids=str)
def test_split_grouped_swiglu_plain_matches_pallas_and_jnp(grouped_refs, shape, dt):
    tx = _grouped_inputs(shape, dt)[1]
    got = grouped.split_grouped_swiglu(*tx)  # CPU tensors: the plain version
    assert torch.equal(got, grouped.split_grouped_swiglu_torch(*tx))
    pallas, plain = grouped_refs[str((shape, dt))]
    _close(got, pallas, dt)
    _close(got, plain, dt)


@pytest.mark.parametrize("shape,dt", DENSE_CASES, ids=str)
def test_split_dense_kernels_plain_match_pallas_and_jnp(dense_refs, shape, dt):
    stack, reduce, ffn = (ops[1] for ops in _dense_inputs(shape, dt))
    for got, (pallas, plain) in zip((dense.split_stack_gemm(*stack),
                                     dense.split_reduce_gemm(*reduce),
                                     dense.split_dense_swiglu(*ffn)),
                                    dense_refs[str((shape, dt))]):
        _close(got, pallas, dt)
        _close(got, plain, dt)


def test_ops_dispatch_impls_agree_on_cpu():
    arrs = _arrays(3, *_swiglu_shapes(4, 1, 3, 32, 16))
    t = [torch.from_numpy(a) for a in arrs]
    for impl in (None, "kernel"):
        assert torch.equal(tops.split_swiglu(*t, impl=impl), tops.split_swiglu(*t, impl="torch"))
    with pytest.raises(ValueError, match="impl"):
        tops.split_swiglu(*t, impl="pallas")
    assert tops.default_dense_impl("prefill", torch.device("cpu")) == "torch"
    assert tops.default_dense_impl("decode", torch.device("cuda")) == "kernel"
    assert tops.default_dense_impl("train", torch.device("cuda")) == "torch"


def test_wrapper_checks():
    x, wl, wr = (torch.zeros(s) for s in ((2, 8), (1, 8, 4), (1, 8, 4)))
    with pytest.raises(ValueError, match="does not match"):
        dense.split_stack_gemm(torch.zeros(2, 6), wl, wr)
    with pytest.raises(ValueError, match="disagree"):
        dense.split_stack_gemm(x, wl, torch.zeros(1, 8, 5))
    with pytest.raises(ValueError, match="both banks are empty"):
        dense.split_stack_gemm(x, wl[:0], wr[:0])
    with pytest.raises(ValueError, match="several devices"):
        dense.split_stack_gemm(x, wl, wr.to("meta"))
    with pytest.raises(TypeError, match="fp8"):
        _launch.check_cuda_operands("k", x, wl.to(torch.float8_e4m3fn))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _launch.check_cuda_operands("k", x.half(), wl.half())
    with pytest.raises(ValueError, match="contiguous"):
        _launch.check_cuda_operands("k", x, wl.transpose(1, 2))


# (op, dtype, rows, k, n, slices, aligned) -> path, tile, splits: the plans
# of kernels #4, #5 and #6 (dense.plan_split) and of #2's two launches
# (grouped.plan_grouped, ops "expert_gate_up" and "expert_down", slices =
# experts) at R1's and Gemma-3's per-rank shapes (G' = 4) and at the edges
# of each path.
BF, F32 = torch.bfloat16, torch.float32
PLANS = [
    (("reduce", BF, 256, 4096, 7168, 4, True), "hopper", (128, 256, 64), 2),    # R1 #5, 1024
    (("reduce", BF, 256, 4608, 7168, 4, True), "hopper", (128, 256, 64), 2),    # R1 #6 down
    (("gate_up", BF, 256, 7168, 4608, 4, True), "hopper", (128, 128, 64), 1),   # R1 #6 gate/up
    (("reduce", BF, 2048, 4096, 7168, 4, True), "hopper", (128, 256, 64), 1),   # R1 #5, 8192
    (("reduce", BF, 1024, 1024, 5376, 4, True), "hopper", (128, 256, 64), 1),   # Gemma-3 #5
    (("reduce", BF, 1024, 5376, 5376, 4, True), "hopper", (128, 256, 64), 3),   # Gemma-3 down
    (("reduce", BF, 2, 4096, 7168, 4, True), "few_row", (), 40),                # R1 decode #5
    (("gate_up", BF, 2, 7168, 4608, 4, True), "few_row", (), 28),               # R1 decode #6
    (("reduce", BF, 3, 1024, 64, 4, True), "hopper", (128, 256, 64), 1),        # 3 rows
    (("reduce", BF, 37, 100, 130, 2, True), "mma", (), 1),                      # width % 8
    (("gate_up", BF, 256, 7168, 4608, 4, False), "mma", (), 1),                 # unaligned
    (("reduce", F32, 256, 4096, 7168, 4, True), "fma", (), 1),                  # fp32
    (("stack", BF, 256, 7168, 4096, 4, True), "hopper", (128, 256, 64), 1),     # R1 wq, 1024
    (("stack", BF, 256, 7168, 256, 4, True), "hopper", (128, 128, 64), 8),      # R1 wk/wv
    (("stack", BF, 2048, 7168, 4096, 4, True), "hopper", (128, 256, 64), 1),    # R1 wq, 8192
    (("stack", BF, 2048, 7168, 256, 4, True), "hopper", (128, 128, 64), 1),     # R1 wk, 8192
    (("stack", BF, 1024, 5376, 1024, 4, True), "hopper", (128, 256, 64), 1),    # Gemma-3 wq
    (("stack", BF, 1024, 5376, 512, 4, True), "hopper", (128, 128, 64), 1),     # Gemma-3 wk
    (("stack", BF, 2, 7168, 4096, 4, True), "few_row", (), 4),                  # R1 decode wq
    (("stack", BF, 2, 7168, 256, 4, True), "few_row", (), 56),                  # R1 decode wk
    (("stack", BF, 17, 200, 136, 2, True), "hopper", (64, 256, 64), 1),         # 17 rows
    (("stack", BF, 130, 7168, 256, 4, True), "hopper", (128, 128, 64), 8),      # 130 rows
    (("stack", BF, 37, 100, 130, 2, True), "mma", (), 1),                       # width % 8
    (("stack", BF, 256, 7168, 4096, 4, False), "mma", (), 1),                   # unaligned
    (("stack", F32, 256, 7168, 4096, 4, True), "fma", (), 1),                   # fp32
    (("expert_gate_up", BF, 16, 7168, 2048, 256, True), "hopper", (64, 128, 64), 1),   # R1 C 16
    (("expert_down", BF, 16, 2048, 7168, 256, True), "hopper", (64, 256, 64), 1),
    (("expert_gate_up", BF, 88, 7168, 2048, 256, True), "hopper", (128, 128, 64), 1),  # C 88
    (("expert_down", BF, 88, 2048, 7168, 256, True), "hopper", (128, 256, 64), 1),
    (("expert_gate_up", BF, 1, 7168, 2048, 256, True), "hopper", (64, 128, 64), 1),    # decode
    (("expert_down", BF, 1, 2048, 7168, 88, True), "hopper", (64, 256, 64), 1),        # #3
    (("expert_gate_up", BF, 2, 7168, 2048, 256, True), "hopper", (64, 128, 64), 1),    # C 2
    (("expert_down", BF, 2, 2048, 7168, 256, True), "hopper", (64, 256, 64), 1),
    (("expert_gate_up", BF, 1, 136, 72, 3, True), "hopper", (64, 128, 64), 1),         # ragged
    (("expert_down", F32, 1, 2048, 7168, 256, True), "tile_few_row", (), 1),           # fp32
    (("expert_gate_up", BF, 2, 100, 64, 3, True), "tile_few_row", (), 1),              # % 8
    (("expert_gate_up", BF, 130, 72, 136, 3, True), "hopper", (128, 128, 64), 1),      # 130
    (("expert_down", BF, 3, 72, 136, 6, True), "hopper", (64, 256, 64), 1),            # 3
    (("expert_gate_up", BF, 20, 100, 64, 3, True), "mma", (), 1),                      # % 8
    (("expert_down", F32, 16, 2048, 7168, 256, True), "fma", (), 1),                   # fp32
]


@pytest.mark.parametrize("args,path,tile,splits", PLANS, ids=str)
def test_dense_launch_plans(args, path, tile, splits):
    op, dtype, rows, k, n, slices, aligned = args
    if op.startswith("expert_"):
        # the grouped plans take the per-expert shapes only, so the demand
        # kernel (another expert count) runs kernel #2's plan
        kop = "gate_up" if op == "expert_gate_up" else "stack"
        plan = grouped.plan_grouped(op[len("expert_"):], dtype, rows, k, n, aligned)
        assert plan == grouped.plan_grouped(op[len("expert_"):], dtype, rows, k, n, aligned)
        per, slices = 1, 1
    else:
        kop = op
        plan = dense.plan_split(*args)
        assert plan == dense.plan_split(*args)  # a pure function of the shapes
        per = 1 if op == "reduce" else slices
    assert (plan.path, plan.tile, plan.splits) == (path, tile, splits)
    assert plan.ints()[0] == dense.PATH_CODES[path]
    if path == "hopper":
        bm, bn, _ = tile
        assert (bm, bn) in dense.HOPPER_TILES[kop]
        assert (bm == 64) == (rows <= 64 and kop != "reduce")
        tiles = -(-rows // bm) * -(-n // bn) * per
        assert splits == 1 or tiles < 2 * dense.SMS  # splits only below two waves
        assert kop != "gate_up" or splits == 1
        assert 2 <= plan.stages == dense.max_stages(kop, bm, bn)
        assert 1024 + plan.stages * (dense.stage_bytes(kop, bm, bn) + 16) <= dense.SMEM
        assert plan.scratch == (splits * per * rows * n if splits > 1 else 0)
        assert plan.ints()[1:3] == [bm, bn]
    elif path == "few_row":
        assert rows <= dense.FEW_ROW_MAXM
        assert plan.chunk % dense.FEW_ROW_K == 0
        per_k = -(-k // plan.chunk)
        blocks = -(-n // dense.FEW_ROW_COLS) * slices * (per_k if op == "reduce" else splits)
        assert dense.FEW_ROW_BLOCKS[op] // 2 <= blocks < 2 * dense.FEW_ROW_BLOCKS[op]
        mats = {"reduce": 1, "gate_up": 2 * slices, "stack": slices}[op]
        assert plan.scratch == splits * rows * n * mats
        assert op != "reduce" or splits == slices * per_k
    else:
        assert path != "tile_few_row" or rows <= dense.FEW_ROW_MAXM
        assert plan.scratch == 0 and plan.ints()[0] == 0


@pytest.mark.parametrize("c", [1, 2, 16])
@pytest.mark.parametrize("experts", [(1, 2), (64, 24), (64, 192)])
def test_grouped_plans_ignore_expert_count(c, experts):
    """The grouped SwiGLU's plans (#2's, and #3's with its fetched bank)
    depend on (C, D, F) only: the same plans at 3, 88 and 256 experts, so
    the demand kernel runs kernel #2's code and gets its bits."""
    d, f = 136, 72
    e_l, e_r = experts

    def plans(e_l, e_r):
        x = torch.zeros(e_l + e_r, c, d, dtype=torch.bfloat16)
        ws = [torch.zeros(n, *s, dtype=torch.bfloat16)
              for n in (e_l, e_r) for s in ((d, f), (d, f), (f, d))]
        return grouped.grouped_swiglu_plans(x, *ws[:3], *ws[3:])

    got = plans(e_l, e_r)
    assert got == plans(1, 2) == plans(64, 192)
    assert got == (grouped.plan_grouped("gate_up", torch.bfloat16, c, d, f),
                   grouped.plan_grouped("down", torch.bfloat16, c, f, d))
    assert [p.path for p in got] == ["hopper", "hopper"]


# --------------------------------------------------------------------------
# Routing, dispatch, attention and the small layers.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("t,cap,num_real", [(12, 2, 6), (9, 2, 8), (5, 1, 8)])
def test_route_topk_with_drops_matches_jax(t, cap, num_real):
    x, w = _arrays(t, (t, 16), (16, 8), scale=1.0)

    def jax_route(x, w):
        d = jmoe.route_topk(x, w, 2, cap, num_real=num_real)
        xe = jmoe.dispatch_tokens(x, d, 8, cap)
        return d, xe, jmoe.combine_tokens(xe, d, t)

    dj, xe_j, out_j = jax.jit(jax_route)(jnp.asarray(x), jnp.asarray(w))
    dt = tmoe.route_topk(torch.from_numpy(x), torch.from_numpy(w), 2, cap, num_real=num_real)
    assert not bool(np.all(np.asarray(dj.keep)))  # some tokens dropped
    np.testing.assert_array_equal(dt.flat_slot.numpy(), np.asarray(dj.flat_slot))
    np.testing.assert_array_equal(dt.keep.numpy(), np.asarray(dj.keep))
    np.testing.assert_allclose(dt.weight.numpy(), np.asarray(dj.weight), atol=1e-6)
    xe_t = tmoe.dispatch_tokens(torch.from_numpy(x), dt, 8, cap)
    np.testing.assert_allclose(xe_t.numpy(), np.asarray(xe_j), atol=1e-6)
    np.testing.assert_allclose(tmoe.combine_tokens(xe_t, dt, t).numpy(), np.asarray(out_j),
                               atol=1e-6)


def test_route_topk_rows_and_capacity_match_jax():
    x, w = _arrays(1, (3, 5, 16), (16, 8), scale=1.0)
    route = jax.jit(lambda x, w: jmoe.route_topk_rows(x, w, 2, 2, num_real=7))
    dj = route(jnp.asarray(x), jnp.asarray(w))
    dt = tmoe.route_topk_rows(torch.from_numpy(x), torch.from_numpy(w), 2, 2, num_real=7)
    np.testing.assert_array_equal(dt.flat_slot.numpy(), np.asarray(dj.flat_slot))
    np.testing.assert_array_equal(dt.keep.numpy(), np.asarray(dj.keep))
    np.testing.assert_allclose(dt.weight.numpy(), np.asarray(dj.weight), atol=1e-6)
    for tokens in (1, 2, 7, 256, 1000):
        for e, k, f in ((256, 8, 1.25), (8, 2, 4.0), (4, 4, 1.25)):
            assert tmoe.capacity_for(tokens, e, k, f) == jmoe.capacity_for(tokens, e, k, f)


@pytest.mark.parametrize("window,q_offset,sk", [(0, 0, 20), (6, 4, 24), (0, 8, 24)])
def test_mha_prefill_matches_jax(window, q_offset, sk):
    sq = sk - q_offset
    q, k, v = _arrays(sk, (2, sq, 4, 8), (2, sk, 2, 8), (2, sk, 2, 8), scale=1.0)
    prefill = jax.jit(lambda q, k, v: jattn.mha_prefill(q, k, v, window=window,
                                                         q_offset=q_offset, block_kv=8))
    ref = prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tattn.mha_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            window=window, q_offset=q_offset, block_kv=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_mha_decode_partial_and_combine_match_jax():
    q, k, v = _arrays(5, (2, 4, 8), (3, 2, 6, 2, 8), (3, 2, 6, 2, 8), scale=1.0)
    kv_pos = np.array([[0, 1, 2, 3, -1, -1], [4, 5, 6, 7, 8, 9]], np.int32)
    qpos = np.array([3, 7], np.int32)
    outs_t, lses_t, outs_j, lses_j = [], [], [], []
    partial = jax.jit(jattn.mha_decode_partial)
    for i in range(3):
        pos_i = np.where(kv_pos >= 0, kv_pos + 10 * i, -1).astype(np.int32) if i else kv_pos
        oj, lj = partial(jnp.asarray(q), jnp.asarray(k[i]), jnp.asarray(v[i]),
                         jnp.asarray(pos_i), jnp.asarray(qpos + 10 * (i == 2)))
        ot, lt = tattn.mha_decode_partial(torch.from_numpy(q), torch.from_numpy(k[i]),
                                          torch.from_numpy(v[i]), torch.from_numpy(pos_i),
                                          torch.from_numpy(qpos + 10 * (i == 2)))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
        outs_t.append(ot), lses_t.append(lt), outs_j.append(oj), lses_j.append(lj)
    ref = jax.jit(jattn.combine_partials)(jnp.stack(outs_j), jnp.stack(lses_j))
    np.testing.assert_allclose(tattn.combine_partials(outs_t, lses_t).numpy(), np.asarray(ref),
                               atol=1e-5)


def test_rms_norm_rope_softcap_match_jax():
    x, s = _arrays(9, (2, 5, 4, 16), (16,), scale=1.0)
    pos = np.arange(10).reshape(2, 5).astype(np.int32)
    norm, rope, cap = jax.jit(
        lambda x, s, p: (jlayers.rms_norm(x, s, 1e-6), jlayers.apply_rope(x, p, 1e4),
                         jlayers.softcap(x * 40, 30.0))
    )(jnp.asarray(x), jnp.asarray(s), jnp.asarray(pos))
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6).numpy(),
        np.asarray(norm), atol=1e-5)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(rope), atol=1e-5)
    np.testing.assert_allclose(
        tlayers.softcap(torch.from_numpy(x) * 40, 30.0).numpy(), np.asarray(cap), atol=1e-4)
