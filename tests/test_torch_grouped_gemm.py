"""Kernel #1 (split_grouped_gemm) of the port against the JAX package.

The port's ``ops.split_gemm`` on CPU tensors (its plain version, which the
wrapper runs there) against the Pallas kernel in interpret mode, with
bf16 activations and bf16, e4m3 and e5m2 banks; empty banks; the launch
plan as a pure function of the per-expert shapes; the wrapper's checks of
what the CUDA kernel refuses; and the exactness of the widening the CUDA
kernel applies to fp8 banks. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py). Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.split_gemm import ops as jops
from repro_torch.kernels import _launch
from repro_torch.kernels.split_gemm import dense, grouped
from repro_torch.kernels.split_gemm import ops as tops

# One intra-op thread per process: the suite runs several test workers.
torch.set_num_threads(1)

TOL = 2e-2  # tests/test_kernels.py TOL["bfloat16"] (atol and rtol)
BF = torch.bfloat16
WEIGHTS = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float8_e4m3fn": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
           "float8_e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}


def _inputs(seed, e, e_l, c, d, f, weight):
    """bf16 x (E, C, D) and the two banks in ``weight``, for both packages:
    the banks are rounded once by torch and handed to JAX as the exact
    float32 values of the stored type."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32)
    tdt, jdt = WEIGHTS[weight]
    tx = torch.from_numpy(x).to(BF)
    tw = torch.from_numpy(w).to(tdt)
    jx = jnp.asarray(tx.float().numpy(), jnp.bfloat16)
    jw = jnp.asarray(tw.float().numpy()).astype(jdt)
    return (tx, tw[:e_l], tw[e_l:]), (jx, jw[:e_l], jw[e_l:])


def _close(got, ref):
    assert got.dtype == BF
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL, rtol=TOL)


# (seed, E, E_l, C, D, F, weight) of each Pallas comparison: E 6 (4 local, 2
# remote), D 128, F 256 at C 1, 3 and 16; then an empty local or remote bank
CASES = {**{("full", c, w): (c, 6, 4, c, 128, 256, w) for c in (1, 3, 16) for w in WEIGHTS},
         **{("empty", e_l, w): (7 + e_l, 5, e_l, 2, 64, 128, w)
            for e_l in (0, 5) for w in ("bfloat16", "float8_e4m3fn")}}


@pytest.fixture(scope="module")
def pallas_refs():
    """The Pallas kernel (interpret mode) on every case's inputs, in one
    jitted program for the module (a program per case compiled ~0.4 s)."""
    ins = {"-".join(map(str, k)): _inputs(*args)[1] for k, args in CASES.items()}
    out = jax.jit(lambda ins: {k: jops.split_gemm(*v) for k, v in ins.items()})(ins)
    return {k: out["-".join(map(str, k))] for k in CASES}


@pytest.mark.parametrize("weight", list(WEIGHTS))
@pytest.mark.parametrize("c", [1, 3, 16])
def test_split_gemm_matches_pallas(pallas_refs, c, weight):
    """E 6 (4 local, 2 remote), D 128, F 256."""
    (tx, twl, twr), _ = _inputs(*CASES[("full", c, weight)])
    got = tops.split_gemm(tx, twl, twr)  # CPU tensors: the plain version
    assert torch.equal(got, grouped.split_grouped_gemm_torch(tx, twl, twr))
    _close(got, pallas_refs[("full", c, weight)])  # Pallas, interpret mode


@pytest.mark.parametrize("weight", ["bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("e_l", [0, 5], ids=["no_local", "no_remote"])
def test_split_gemm_empty_bank_matches_pallas(pallas_refs, e_l, weight):
    (tx, twl, twr), _ = _inputs(*CASES[("empty", e_l, weight)])
    assert min(twl.shape[0], twr.shape[0]) == 0
    _close(tops.split_gemm(tx, twl, twr), pallas_refs[("empty", e_l, weight)])


def test_ops_split_gemm_impls_agree_on_cpu():
    (tx, twl, twr), _ = _inputs(3, 4, 1, 3, 64, 32, "float8_e5m2")
    ref = tops.split_gemm(tx, twl, twr, impl="torch")
    for impl in (None, "kernel"):
        assert torch.equal(tops.split_gemm(tx, twl, twr, impl=impl), ref)
    with pytest.raises(ValueError, match="impl"):
        tops.split_gemm(tx, twl, twr, impl="pallas")


# (dtype, weight, C, D, F, aligned) -> (path, tile): kernel #1's plan at R1's
# expert shapes (D 7168, F 2048) and at the edges of each path.
F32, E4, E5 = torch.float32, torch.float8_e4m3fn, torch.float8_e5m2
GEMM_PLANS = [
    ((BF, BF, 1, 7168, 2048, True), "hopper", (64, 256, 64)),      # R1 decode
    ((BF, BF, 16, 7168, 2048, True), "hopper", (64, 256, 64)),     # R1 1024
    ((BF, BF, 88, 7168, 2048, True), "hopper", (128, 256, 64)),    # R1 8192
    ((BF, E4, 1, 7168, 2048, True), "hopper", (64, 256, 64)),
    ((BF, E4, 64, 7168, 2048, True), "hopper", (64, 256, 64)),
    ((BF, E5, 88, 7168, 2048, True), "hopper", (128, 256, 64)),
    ((BF, E4, 3, 136, 400, True), "hopper", (64, 256, 64)),        # ragged
    ((BF, BF, 3, 136, 72, True), "hopper", (64, 256, 64)),         # F % 16 in bf16
    ((BF, E4, 3, 136, 72, True), "mma", ()),                       # F % 16 in fp8
    ((BF, E4, 2, 136, 72, True), "tile_few_row", ()),
    ((BF, BF, 20, 100, 64, True), "mma", ()),                      # D % 8
    ((BF, BF, 2, 100, 64, True), "tile_few_row", ()),
    ((BF, BF, 16, 7168, 2048, False), "mma", ()),                  # unaligned
    ((F32, F32, 16, 7168, 2048, True), "fma", ()),                 # fp32
    ((F32, F32, 1, 7168, 2048, True), "tile_few_row", ()),
    ((F32, E4, 16, 7168, 2048, True), "fma", ()),                  # fp8 beside fp32
]


@pytest.mark.parametrize("args,path,tile", GEMM_PLANS, ids=str)
def test_gemm_plan_is_a_pure_function_of_the_expert_shapes(args, path, tile):
    """bf16 activations at widths the tensor maps take (D a multiple of 8,
    F of 8, or of 16 with fp8 banks): the Hopper path, #2's down plan on
    #1's shapes, BM 64 at C <= 64, else 128, BN 256; 3 ring stages with
    bf16 banks, the most that fit beside the widened tiles with fp8 banks;
    split_tile.cuh's launchers otherwise. The expert count never enters."""
    dtype, weight, c, d, f, aligned = args
    plan = grouped.plan_grouped("gemm", dtype, c, d, f, aligned, weight)
    assert plan == grouped.plan_grouped("gemm", dtype, c, d, f, aligned, weight)
    assert (plan.path, plan.tile, plan.splits, plan.scratch) == (path, tile, 1, 0)
    assert plan.ints()[0] == dense.PATH_CODES[path]
    if path != "hopper":
        return
    fp8 = weight != BF
    wbytes = 1 if fp8 else 2
    assert plan.tile[0] == (64 if c <= 64 else 128)
    most = dense.max_stages("gemm", plan.tile[0], 256, wbytes)
    assert plan.stages == (most if fp8 else grouped.GEMM_BF16_STAGES) and 2 <= plan.stages <= most
    wide = dense.WIDE_BUFS * 2 * dense.HOPPER_BK * 256 if fp8 else 0
    assert (1024 + wide + plan.stages * (dense.stage_bytes("gemm", plan.tile[0], 256, wbytes)
                                         + 16) <= dense.SMEM)
    if not fp8:
        down = grouped.plan_grouped("down", dtype, c, d, f, aligned)
        assert plan == down._replace(stages=grouped.GEMM_BF16_STAGES)
    else:  # the same block tile as the bf16 plan: the bitwise gate's premise
        assert plan.tile == grouped.plan_grouped("gemm", dtype, c, d, f, aligned, BF).tile


@pytest.mark.parametrize("weight", [BF, E4, E5])
def test_gemm_plan_ignores_expert_count(weight):
    def plan(e_l, e_r, c):
        x = torch.zeros(e_l + e_r, c, 136, dtype=BF)
        return grouped.gemm_plan(x, torch.zeros(e_l, 136, 400).to(weight),
                                 torch.zeros(e_r, 136, 400).to(weight))

    for c in (1, 16, 88):
        got = plan(1, 2, c)
        assert got == plan(64, 192, c) == plan(0, 6, c) == plan(5, 0, c)
        assert got == grouped.plan_grouped("gemm", BF, c, 136, 400, True, weight)
        assert got.path == "hopper"


def test_gemm_operand_checks():
    """What the CUDA kernel refuses, checked before a launch: fp8 banks
    beside fp32 activations, fp8 banks off the Hopper path, banks stored in
    two dtypes; and fp8 banks on every other kernel (no ``fp8=True``)."""
    x = torch.zeros(4, 3, 64, dtype=BF)
    w8 = torch.zeros(2, 64, 128).to(E4)
    hopper = grouped.gemm_plan(x, w8, w8)
    assert hopper.path == "hopper"
    assert grouped.check_gemm_operands(x, w8, w8, hopper) == (1, 1)
    assert grouped.check_gemm_operands(x, w8.to(E5), w8.to(E5), hopper) == (1, 2)
    assert grouped.check_gemm_operands(x, w8.to(BF), w8.to(BF), hopper) == (1, 0)
    assert grouped.check_gemm_operands(x, w8[:0], w8, hopper) == (1, 1)
    with pytest.raises(TypeError, match="bfloat16 activations"):
        grouped.check_gemm_operands(x.float(), w8, w8, hopper)
    w120 = w8[..., :120].contiguous()  # F 120: not a multiple of 16
    plan = grouped.gemm_plan(x, w120, w120)
    assert plan.path == "mma"
    with pytest.raises(TypeError, match="Hopper path only"):
        grouped.check_gemm_operands(x, w120, w120, plan)
    with pytest.raises(TypeError, match="several dtypes"):
        grouped.check_gemm_operands(x, w8, w8.to(E5), hopper)
    with pytest.raises(TypeError, match="not supported"):
        _launch.check_cuda_operands("split_stack_gemm", x[0], w8, w8)
    with pytest.raises(TypeError, match="bfloat16"):
        _launch.check_cuda_operands("k", x, w8.to(torch.float16), fp8=True)


@pytest.mark.parametrize("weight", [E4, E5], ids=str)
def test_fp8_widening_steps_are_exact(weight):
    """The CUDA kernel widens fp8 banks to bf16 as fp8 -> f16 (the
    hardware's cvt.rn.f16x2.{e4m3,e5m2}x2) -> f32 -> the f32's top 16 bits:
    for all 256 codes the f32's low 16 bits are zero and its top half is
    ``w.to(bfloat16)`` (NaN stays NaN), so the kernel's fp8 result is
    bitwise its bf16 result on the widened banks. An e5m2 code is the top
    byte of its f16."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    w = codes.view(weight)
    exact = w.float()
    nan = torch.isnan(exact)
    f32 = w.to(torch.float16).float()
    bits = f32.view(torch.int32)
    assert torch.all((bits[~nan] & 0xFFFF) == 0)
    top = (bits >> 16).to(torch.int16).view(BF)
    direct = w.to(BF)
    assert torch.equal(torch.isnan(top), nan) and torch.equal(torch.isnan(direct), nan)
    assert torch.equal(top[~nan], direct[~nan])
    assert torch.equal(direct[~nan].float(), exact[~nan])
    assert torch.equal(f32[~nan], exact[~nan])
    if weight == E5:
        f16 = (codes.to(torch.int16) << 8).view(torch.float16)
        assert torch.equal(f16.float()[~nan], exact[~nan])
