"""The port's flash attention (kernel #7) against the JAX package's.

On CPU tensors the wrapper runs its plain version (``mha_prefill``), so
this holds the function the CUDA kernel must compute: the same numpy
inputs go through the port and through ``flash_attention_ref`` (fp32
atol/rtol 2e-5, bf16 2e-2: tests/test_kernels.py TOL) and, at three
shapes in fp32, the Pallas kernel in interpret mode. The shape grid is
tests/test_kernels.py's: GQA rep 1/2/4, windows 33/64/100, q_offset 256
and a ragged Sk of 320. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention import flash_attention_ref as jref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.attention import mha_prefill
from torch_refs import jit_quick

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (b, sq, sk, h, kh, hd, window, q_offset): tests/test_kernels.py's grid
SHAPES = [
    (2, 128, 128, 4, 2, 64, 0, 0),
    (1, 128, 384, 8, 8, 128, 0, 256),
    (2, 256, 256, 4, 1, 64, 100, 0),
    (1, 128, 128, 6, 3, 64, 33, 0),
    (1, 64, 320, 4, 4, 64, 64, 256),
    (1, 128, 128, 4, 2, 128, 0, 0),
]
# Pallas in interpret mode costs 1-4 s a call: a windowed GQA shape, the
# offset causal shape and the ragged-Sk windowed shape.
INTERPRET = [SHAPES[3], SHAPES[1], SHAPES[4]]


def _sid(shape):
    return "x".join(map(str, shape))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's reference at every shape and dtype and its Pallas
    kernel (interpret mode) at the INTERPRET shapes, computed in one jitted
    program for the module (a program per case compiled ~0.3 s each)."""
    ins = {_sid(s): [_inputs(s), _inputs(s, seed=2)] for s in SHAPES}

    def run(ins):
        out = {}
        for shape in SHAPES:
            window, q_offset = shape[6], shape[7]
            arrs, arrs2 = ins[_sid(shape)]
            for dt in JDT:
                out[(_sid(shape), dt)] = jref(*(a.astype(JDT[dt]) for a in arrs), window=window,
                                              q_offset=q_offset)
            if shape in INTERPRET:
                out[(_sid(shape), "pallas")] = jflash(*arrs2, window=window, q_offset=q_offset,
                                                      block_q=64, block_k=64, interpret=True)
        return out

    return jit_quick(run)(jax.tree.map(jnp.asarray, ins))


def _inputs(shape, seed=1):
    b, sq, sk, h, kh, hd, _, _ = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd))]


def _port(arrs, dt, window, q_offset, impl=None):
    q, k, v = (torch.from_numpy(a).to(TDT[dt]) for a in arrs)
    return fa.flash_attention(q, k, v, window=window, q_offset=q_offset, impl=impl)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=_sid)
def test_flash_attention_matches_jax_ref(jax_refs, shape, dt):
    window, q_offset = shape[6], shape[7]
    ref = jax_refs[(_sid(shape), dt)]
    got = _port(_inputs(shape), dt, window, q_offset)
    assert got.shape == tuple(ref.shape) and got.dtype == TDT[dt]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("shape", INTERPRET, ids=_sid)
def test_flash_attention_matches_pallas_interpret(jax_refs, shape):
    window, q_offset = shape[6], shape[7]
    ref = jax_refs[(_sid(shape), "pallas")]
    got = _port(_inputs(shape, seed=2), "float32", window, q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_flash_attention_checks_and_dispatch():
    """CPU tensors and impl="torch" run the plain version (bitwise
    mha_prefill); malformed calls raise on every device."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(SHAPES[4]))
    ref = mha_prefill(q, k, v, window=64, q_offset=256)
    launches = fa.FLASH_ATTENTION.launches
    for impl in (None, "kernel", "torch"):
        assert torch.equal(fa.flash_attention(q, k, v, window=64, q_offset=256, impl=impl), ref)
    assert fa.FLASH_ATTENTION.launches == launches  # the plain version is no launch
    with pytest.raises(ValueError, match="impl"):
        fa.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, k, v, q_offset=257)  # row 63 would see no key of its own
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attention(q[..., :32], k, v)
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attention(q[:, :, :3], k[:, :, :2], v[:, :, :2])  # 3 heads over 2 kv heads
    with pytest.raises(ValueError, match="shaped like k"):
        fa.flash_attention(q, k, v[:, :-1])
    with pytest.raises(ValueError, match="several devices"):
        fa.flash_attention(q, k.to("meta"), v)


# (dtype, b, sq, h, hd) -> the CUDA kernel's plan: chip_smoke.py's five
# prefill shards (R1 1024 first and last rank: Sq 256, 128 heads; R1 8192
# last rank: Sq 2048; Gemma-3 4096 local and global layer: Sq 1024, 32
# heads; G' = 4), its ragged Gemma-3 case (Sq 1000) and grids of fewer
# blocks than the 132 SMs take 128 query rows and 128-key tiles in 3
# stages; fp32 and hd 64 the earlier kernels.
BF = torch.bfloat16
FLASH_PLANS = [
    ((BF, 1, 256, 128, 128), ("wgmma", 3)),
    ((BF, 1, 2048, 128, 128), ("wgmma", 3)),
    ((BF, 1, 1024, 32, 128), ("wgmma", 3)),
    ((BF, 1, 1000, 32, 128), ("wgmma", 3)),
    ((BF, 2, 190, 6, 128), ("wgmma", 3)),
    ((BF, 1, 300, 44, 128), ("wgmma", 3)),     # 132 blocks: one full wave
    ((BF, 1, 300, 43, 128), ("wgmma", 3)),     # 129 blocks
    ((torch.float32, 1, 256, 128, 128), ("mma", 0)),
    ((BF, 1, 256, 128, 64), ("mma", 0)),
]


@pytest.mark.parametrize("args,want", FLASH_PLANS, ids=str)
def test_flash_plan(args, want):
    """flash_plan is a pure function of the type and head dim, the same at
    every shape; its Hopper plan fits a block's shared memory with the
    most ring stages that do."""
    dtype, _, _, _, hd = args
    plan = fa.flash_plan(dtype, hd)
    assert tuple(plan) == want and plan == fa.flash_plan(dtype, hd)
    assert plan.ints() == [fa.PATH_CODES[plan.path], plan.stages]
    if plan.path == "wgmma":
        assert fa.wgmma_smem(plan.stages) <= fa.SMEM < fa.wgmma_smem(plan.stages + 1)
        assert plan == fa.wgmma_plan(plan.stages) == fa.wgmma_plan()
        assert fa.plan_label(plan) == "wgmma 128x128 stages 3"
