"""The port's CUDA kernels against their plain versions, on the card.

Runs where there is a card (a GPU machine need not have JAX, so this file
imports none):

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Without a card the test skips.
"""
import pytest
import torch


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    from repro_torch.kernels import registry
    from repro_torch.kernels.split_gemm import dense, grouped

    gen = torch.Generator(device="cuda").manual_seed(0)

    def check(got, ref, tol):
        # error relative to max|ref|; tol is tests/test_kernels.py TOL
        err = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        assert err <= tol, err

    def rnd(*s, dt):
        return (torch.randn(*s, generator=gen, device="cuda") * 0.1).to(dt)

    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for t, d, f, s_l, s_r in ((2, 256, 96, 1, 3), (37, 128, 64, 4, 0), (70, 64, 128, 0, 2)):
            x, wl, wr = rnd(t, d, dt=dt), rnd(s_l, d, f, dt=dt), rnd(s_r, d, f, dt=dt)
            xr, wl2, wr2 = rnd(s_l + s_r, t, f, dt=dt), rnd(s_l, f, d, dt=dt), rnd(s_r, f, d, dt=dt)
            ws = [rnd(s_l, d, f, dt=dt), rnd(s_l, d, f, dt=dt), rnd(s_l, f, d, dt=dt),
                  rnd(s_r, d, f, dt=dt), rnd(s_r, d, f, dt=dt), rnd(s_r, f, d, dt=dt)]
            pairs = [
                (dense.split_stack_gemm(x, wl, wr), dense.split_stack_gemm_torch(x, wl, wr)),
                (dense.split_reduce_gemm(xr, wl2, wr2), dense.split_reduce_gemm_torch(xr, wl2, wr2)),
                (dense.split_dense_swiglu(x, *ws), dense.split_dense_swiglu_torch(x, *ws)),
            ]
            for got, ref in pairs:
                check(got, ref, tol)
        for e, e_l, c in ((8, 2, 16), (4, 0, 1), (4, 4, 3)):
            x = rnd(e, c, 128, dt=dt)
            ws = [rnd(e_l, 128, 64, dt=dt), rnd(e_l, 128, 64, dt=dt), rnd(e_l, 64, 128, dt=dt),
                  rnd(e - e_l, 128, 64, dt=dt), rnd(e - e_l, 128, 64, dt=dt),
                  rnd(e - e_l, 64, 128, dt=dt)]
            got = grouped.split_grouped_swiglu(x, *ws)
            ref = grouped.split_grouped_swiglu_torch(x, *ws)
            check(got, ref, tol)
    torch.cuda.synchronize()
    counts = registry.launch_counts()
    assert all(counts[k.name] > 0 for k in (dense.STACK_GEMM, dense.REDUCE_GEMM,
                                            dense.DENSE_SWIGLU, grouped.GROUPED_SWIGLU))


@pytest.mark.cuda
def test_cuda_demand_and_grouped_gemm_kernels():
    """Kernels #3 and #1 against their plain versions; #3's padding rows
    are exact zeros and its real experts' blocks are bitwise kernel #2's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    from repro_torch.kernels.split_gemm import grouped

    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*s, dt):
        return (torch.randn(*s, generator=gen, device="cuda") * 0.1).to(dt)

    def rel(got, ref):
        return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for e_l, e_f, c in ((4, 6, 1), (3, 5, 2), (2, 4, 5), (0, 3, 17), (4, 0, 1)):
            d, f = 128, 64
            x = rnd(e_l + e_f, c, d, dt=dt)
            ws = [rnd(e_l, d, f, dt=dt), rnd(e_l, d, f, dt=dt), rnd(e_l, f, d, dt=dt),
                  rnd(e_f, d, f, dt=dt), rnd(e_f, d, f, dt=dt), rnd(e_f, f, d, dt=dt)]
            valid = torch.arange(e_f, device="cuda") % 2 == 0
            got = grouped.split_grouped_swiglu_demand(x, *ws, valid)
            ref = grouped.split_grouped_swiglu_demand_torch(x, *ws, valid)
            assert rel(got, ref) <= tol
            assert torch.all(got[e_l:][~valid] == 0)
            full = grouped.split_grouped_swiglu(x, *ws)
            keep = torch.cat([torch.ones(e_l, dtype=torch.bool, device="cuda"), valid])
            assert torch.equal(got[keep], full[keep])
            w_l, w_r = rnd(e_l, d, f, dt=dt), rnd(e_f, d, f, dt=dt)
            got = grouped.split_grouped_gemm(x, w_l, w_r)
            assert rel(got, grouped.split_grouped_gemm_torch(x, w_l, w_r)) <= tol
    torch.cuda.synchronize()
    assert grouped.GROUPED_SWIGLU_DEMAND.launches > 0 and grouped.GROUPED_GEMM.launches > 0


@pytest.mark.cuda
def test_cuda_flash_attention_kernel():
    """Kernel #7 against its plain version (flash_attention_torch) at a
    windowed shape with ragged Sq and Sk and a causal GQA shape with an
    offset; and the wrapper's checks of what the kernel does not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    from repro_torch.kernels.flash_attention import ops as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    launches = fa.FLASH_ATTENTION.launches
    # (b, sq, sk, h, kh, hd, window, q_offset)
    for b, sq, sk, h, kh, hd, window, q_offset in ((1, 100, 300, 4, 2, 64, 70, 200),
                                                    (2, 128, 384, 8, 2, 128, 0, 256)):
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q, k, v = (torch.randn(*s, generator=gen, device="cuda").to(dt)
                       for s in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd)))
            got = fa.flash_attention(q, k, v, window=window, q_offset=q_offset)
            ref = fa.flash_attention_torch(q, k, v, window=window, q_offset=q_offset)
            diff, ref_abs = (got.float() - ref.float()).abs(), ref.float().abs()
            err = (diff.max() / ref_abs.max()).item()
            # per query row and head too: rows that see few keys dominate max|ref|
            row_err = (diff.amax(-1) / ref_abs.amax(-1).clamp_min(1e-30)).max().item()
            assert max(err, row_err) <= tol, (b, sq, sk, window, dt, err, row_err)
    torch.cuda.synchronize()
    assert fa.FLASH_ATTENTION.launches == launches + 4
    q = torch.zeros(1, 64, 4, 128, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="share"):
        fa.flash_attention(q, k.float(), k)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="aligned"):
        k63 = k[:, :63].contiguous()
        fa.flash_attention(q.reshape(-1)[1:1 + 63 * 4 * 128].view(1, 63, 4, 128), k63, k63)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :96].contiguous(), k[..., :96].contiguous(),
                           k[..., :96].contiguous())
