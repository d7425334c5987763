"""The port's CUDA kernels against their plain versions, on the card.

Runs where there is a card (a GPU machine need not have JAX, so this file
imports none):

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Without a card the test skips.
"""
import weakref

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


@pytest.mark.cuda
def test_cuda_hopper_single_tile():
    """The prefill path's building blocks on one tile: one TMA load of a
    (64, k) K-major A and a (k, 64) N-major B (128-byte swizzle, zero fill
    past k) and four wgmma m64n64k16 steps, against a plain fp32 product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    from repro_torch.kernels.split_gemm import dense

    gen = torch.Generator(device="cuda").manual_seed(3)
    for k in (16, 40, 64):
        a = torch.randn(64, k, generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn(k, 64, generator=gen, device="cuda").to(torch.bfloat16)
        got = dense.hopper_tile_check(a, b)
        ref = a.float() @ b.float()
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        assert err <= 1e-5, (k, err)


# (T, Fs, D, S_l, S_r, path): ragged rows, Fs and D that are not multiples
# of the tile, an empty remote bank and an empty local bank, split-k
# partials (T 100), the few-row path (T <= 2) and a width that is not a
# multiple of 8 (split_tile.cuh's mma.sync tiles).
RAGGED = [(3, 1024, 64, 4, 0, "hopper"), (17, 200, 136, 0, 2, "hopper"),
          (100, 2048, 64, 1, 3, "hopper"), (300, 512, 264, 2, 1, "hopper"),
          (2048, 256, 384, 1, 3, "hopper"), (2, 520, 776, 1, 3, "few_row"),
          (1, 64, 64, 0, 2, "few_row"), (37, 100, 130, 1, 1, "mma")]


@pytest.mark.cuda
def test_cuda_dense_paths_ragged_deterministic_row_local():
    """Kernels #5 and #6 on every path of their plans against the plain
    versions (2e-2 relative to max|ref|), the path that ran counted; a
    repeated launch gives the same bits, and row 0's output the same bits
    whatever the other rows hold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    from repro_torch.kernels.split_gemm import dense

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf = torch.bfloat16

    def rnd(*s):
        return (torch.randn(*s, generator=gen, device="cuda") * 0.1).to(bf)

    def rel(got, ref):
        return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

    for t, f, d, s_l, s_r, path in RAGGED:
        s = s_l + s_r
        xr, wl, wr = rnd(s, t, f), rnd(s_l, f, d), rnd(s_r, f, d)
        plan = dense.reduce_plan(xr, wl, wr)
        assert plan.path == path, (t, f, d, plan)
        key = ("split_reduce_gemm", "reduce", path, dense.row_class(t))
        before = dense.PATHS[key]
        got = dense.split_reduce_gemm(xr, wl, wr)
        assert dense.PATHS[key] == before + 1
        assert rel(got, dense.split_reduce_gemm_torch(xr, wl, wr)) <= 2e-2, (t, f, d, plan)
        assert torch.equal(dense.split_reduce_gemm(xr, wl, wr), got)
        other = xr.clone()
        other[:, 1:] = rnd(s, t - 1, f)
        assert torch.equal(dense.split_reduce_gemm(other, wl, wr)[0], got[0])

        x = rnd(t, d)
        ws = [rnd(s_l, d, f), rnd(s_l, d, f), rnd(s_l, f, d),
              rnd(s_r, d, f), rnd(s_r, d, f), rnd(s_r, f, d)]
        gate_up, down = dense.dense_swiglu_plans(x, *ws)
        assert gate_up.path == down.path == path, (t, f, d, gate_up, down)
        key = ("split_dense_swiglu", "gate_up", path, dense.row_class(t))
        before = dense.PATHS[key]
        got = dense.split_dense_swiglu(x, *ws)
        assert dense.PATHS[key] == before + 1
        assert rel(got, dense.split_dense_swiglu_torch(x, *ws)) <= 2e-2, (t, f, d, gate_up)
        assert torch.equal(dense.split_dense_swiglu(x, *ws), got)
        other = x.clone()
        other[1:] = rnd(t - 1, d)
        assert torch.equal(dense.split_dense_swiglu(other, *ws)[0], got[0])
    torch.cuda.synchronize()


# (T, D, Fs, S_l, S_r, path, splits) of kernel #4: ragged rows (3, 17, 88,
# 130), D and Fs that are not tile multiples, an empty remote bank and an
# empty local bank, split-k partials (R1's width at a narrow Fs), the
# few-row path (T <= 2) and a width that is not a multiple of 8
# (split_tile.cuh's mma.sync tiles).
STACK = [(3, 256, 1032, 4, 0, "hopper", 1), (17, 200, 136, 0, 2, "hopper", 1),
         (88, 1024, 264, 1, 3, "hopper", 1), (130, 7168, 256, 1, 3, "hopper", 8),
         (2, 520, 776, 1, 3, "few_row", 9), (1, 64, 64, 0, 2, "few_row", 2),
         (37, 100, 130, 1, 1, "mma", 1)]


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
def test_cuda_stack_gemm_paths_ragged_deterministic_row_local():
    """Kernel #4 on its default plans and on every Hopper tile (BM 64/128 x
    BN 128/256, with 2 ring stages and with 3 k splits) against the plain
    version (2e-2 relative to max|ref|), the path that ran counted; a
    repeated launch gives the same bits, and row 0's output the same bits
    whatever the other rows hold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    from repro_torch.kernels.split_gemm import dense

    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*s):
        return (torch.randn(*s, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)

    for t, d, f, s_l, s_r, path, splits in STACK:
        x, wl, wr = rnd(t, d), rnd(s_l, d, f), rnd(s_r, d, f)
        ref = dense.split_stack_gemm_torch(x, wl, wr)
        plan = dense.stack_plan(x, wl, wr)
        assert (plan.path, plan.splits) == (path, splits), (t, d, f, plan)
        plans = [plan]
        if path == "hopper":
            for bm, bn in dense.HOPPER_TILES["stack"]:
                p = dense.hopper_plan("stack", t, d, f, s_l + s_r, bm, bn)
                plans += [p._replace(stages=2),
                          dense.hopper_plan("stack", t, d, f, s_l + s_r, bm, bn, splits=3)]
        for p in plans:
            key = ("split_stack_gemm", "stack", p.path, dense.row_class(t))
            before = dense.PATHS[key]
            got = dense.split_stack_gemm(x, wl, wr, plan=p)
            assert dense.PATHS[key] == before + 1
            assert _rel(got, ref) <= 2e-2, (t, d, f, p)
            assert torch.equal(dense.split_stack_gemm(x, wl, wr, plan=p), got), p
            if t > 1:
                other = x.clone()
                other[1:] = rnd(t - 1, d)
                assert torch.equal(dense.split_stack_gemm(other, wl, wr, plan=p)[:, 0],
                                   got[:, 0]), p
    torch.cuda.synchronize()


# (E, E_l, C, D, F, path) of kernels #2 and #3: ragged capacities (3, 17,
# 88, 130: BM 64, 128 and two m tiles), D and F that are not tile
# multiples, an empty local bank and an empty remote bank, decode's C 1
# and 2 (D and F multiples of 8 but not of the tiles) and a width that is
# not a multiple of 8, above 2 rows (split_tile.cuh's mma.sync tiles) and
# at 2 (its few-row register kernels).
GROUPED = [(6, 2, 3, 136, 72, "hopper"), (5, 0, 17, 64, 200, "hopper"),
           (4, 4, 88, 128, 64, "hopper"), (3, 1, 130, 72, 136, "hopper"),
           (4, 2, 2, 128, 64, "hopper"), (5, 2, 1, 264, 72, "hopper"),
           (4, 1, 2, 136, 520, "hopper"), (3, 1, 20, 100, 64, "mma"),
           (3, 1, 2, 100, 64, "tile_few_row")]


@pytest.mark.cuda
def test_cuda_grouped_swiglu_paths_ragged_deterministic_local():
    """Kernel #2 on its default plans and, on the Hopper path, on every
    tile of each launch, against the plain version (2e-2); the paths that
    ran counted; bitwise on repeat; expert 0's output unchanged when the
    other experts' rows change and row 0's when the other rows change;
    and kernel #3 on the same rows over a fetched subset of the remote
    bank: its real experts bitwise #2's, its padding rows exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    from repro_torch.kernels.split_gemm import dense, grouped

    gen = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*s, scale=0.1):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    for e, e_l, c, d, f, path in GROUPED:
        e_r = e - e_l
        x = rnd(e, c, d, scale=1.0)
        ws = [rnd(e_l, d, f), rnd(e_l, d, f), rnd(e_l, f, d),
              rnd(e_r, d, f), rnd(e_r, d, f), rnd(e_r, f, d)]
        ref = grouped.split_grouped_swiglu_torch(x, *ws)
        gu, dn = grouped.grouped_swiglu_plans(x, *ws)
        assert gu.path == dn.path == path, (e, c, d, f, gu, dn)
        plans = [(gu, dn)]
        if path == "hopper":
            plans += [(dense.hopper_plan("gate_up", c, d, f, 1, bm, bn), dn)
                      for bm, bn in dense.HOPPER_TILES["gate_up"]]
            plans += [(gu, dense.hopper_plan("stack", c, f, d, 1, bm, bn)._replace(stages=2))
                      for bm, bn in dense.HOPPER_TILES["stack"]]
        for pl in plans:
            keys = [("split_grouped_swiglu", launch, p.path, dense.row_class(c))
                    for launch, p in zip(("gate_up", "down"), pl)]
            before = [grouped.PATHS[k] for k in keys]
            got = grouped.split_grouped_swiglu(x, *ws, plans=pl)
            assert [grouped.PATHS[k] for k in keys] == [b + 1 for b in before]
            assert _rel(got, ref) <= 2e-2, (e, c, d, f, pl)
            assert torch.equal(grouped.split_grouped_swiglu(x, *ws, plans=pl), got), pl
            other = x.clone()
            other[1:] = rnd(e - 1, c, d, scale=1.0)
            assert torch.equal(grouped.split_grouped_swiglu(other, *ws, plans=pl)[0], got[0])
            if c > 1:
                other = x.clone()
                other[:, 1:] = rnd(e, c - 1, d, scale=1.0)
                assert torch.equal(grouped.split_grouped_swiglu(other, *ws, plans=pl)[:, 0],
                                   got[:, 0])
        # kernel #3 over a fetched subset of the remote bank, one row in two valid
        if e_r:
            full = grouped.split_grouped_swiglu(x, *ws)
            idx = torch.randperm(e_r, generator=gen, device="cuda")[:max(1, e_r - 1)]
            valid = torch.arange(idx.numel(), device="cuda") % 2 == 0
            x3 = torch.cat([x[:e_l], x[e_l:].index_select(0, idx)])
            wf = [w.index_select(0, idx) for w in ws[3:]]
            y3 = grouped.split_grouped_swiglu_demand(x3, *ws[:3], *wf, valid)
            assert torch.all(y3[e_l:][~valid] == 0)
            assert torch.equal(y3[:e_l], full[:e_l])
            assert torch.equal(y3[e_l:][valid], full[e_l:].index_select(0, idx)[valid])
            ref3 = grouped.split_grouped_swiglu_demand_torch(x3, *ws[:3], *wf, valid)
            assert _rel(y3, ref3) <= 2e-2
    torch.cuda.synchronize()


# (b, sq, sk, h, kh, window, q_offset) of kernel #7's Hopper path (bf16, hd
# 128): ragged Sq and Sk (not multiples of 64 or 128) with a window and an
# offset, a causal GQA shape of more blocks than SMs, small grids, and two
# batch rows.
FLASH = [(1, 100, 300, 4, 2, 70, 200), (1, 300, 1111, 48, 8, 0, 811),
         (2, 190, 450, 6, 3, 129, 260), (1, 77, 77, 2, 1, 0, 0)]


@pytest.mark.cuda
def test_cuda_flash_attention_wgmma_tiles():
    """Kernel #7's Hopper path (TMA-fed K/V, wgmma; 128 query rows and
    128-key tiles) on its default plan and at every ring depth (1-3
    stages), against the plain version (2e-2 relative to max|ref|, over
    the whole output and per query row and head); bitwise on repeat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    from repro_torch.kernels.flash_attention import ops as fa

    gen = torch.Generator(device="cuda").manual_seed(7)
    for b, sq, sk, h, kh, window, q_offset in FLASH:
        q, k, v = (torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
                   for s in ((b, sq, h, 128), (b, sk, kh, 128), (b, sk, kh, 128)))
        ref = fa.flash_attention_torch(q, k, v, window=window, q_offset=q_offset)
        default = fa.flash_plan(torch.bfloat16, 128)
        assert default == fa.wgmma_plan(3)
        plans = [default] + [fa.wgmma_plan(st) for st in (1, 2)]
        for plan in plans:
            got = fa.flash_attention(q, k, v, window=window, q_offset=q_offset, plan=plan)
            diff, ref_abs = (got.float() - ref.float()).abs(), ref.float().abs()
            err = (diff.max() / ref_abs.max()).item()
            row_err = (diff.amax(-1) / ref_abs.amax(-1).clamp_min(1e-30)).max().item()
            assert max(err, row_err) <= 2e-2, (b, sq, sk, window, plan, err, row_err)
            again = fa.flash_attention(q, k, v, window=window, q_offset=q_offset, plan=plan)
            assert torch.equal(again, got), plan
    torch.cuda.synchronize()


# (E, E_l, C, D, F) of kernel #1 on the Hopper path: decode's C 1, a ragged
# C 3 with D and F not multiples of the tiles (F a multiple of 16, as fp8
# banks need), C 16, C 88 and 130 (BM 128; two m tiles at BM 64), an empty
# local bank and an empty remote bank.
GEMM = [(5, 2, 1, 264, 272), (6, 4, 3, 136, 400), (4, 0, 16, 128, 256),
        (3, 3, 88, 192, 528), (3, 1, 130, 72, 144)]
FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


@pytest.mark.cuda
def test_cuda_grouped_gemm_hopper_bf16_and_fp8_banks():
    """Kernel #1 with bf16, e4m3 and e5m2 banks (bf16 activations) on its
    default plan and on every block tile at 2 ring stages, against the
    plain version (2e-2 relative to max|ref|), the path counted under the
    banks' dtype; bitwise on repeat; expert 0's output unchanged when the
    other experts' rows change; and an fp8 result bitwise the bf16 kernel's
    on the widened banks under the same plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    from repro_torch.kernels.split_gemm import dense, grouped

    gen = torch.Generator(device="cuda").manual_seed(8)
    bf = torch.bfloat16

    def rnd(*s, scale=0.1):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(bf)

    for e, e_l, c, d, f in GEMM:
        x, wl, wr = rnd(e, c, d, scale=1.0), rnd(e_l, d, f), rnd(e - e_l, d, f)
        for wdt in (bf, *FP8):
            ql, qr = wl.to(wdt), wr.to(wdt)
            ref = grouped.split_grouped_gemm_torch(x, ql, qr)
            plan = grouped.gemm_plan(x, ql, qr)
            assert plan.path == "hopper" and plan.tile[:2] == (64 if c <= 64 else 128, 256), plan
            wbytes = 1 if wdt in FP8 else 2
            plans = [plan] + [dense.hopper_plan("gemm", c, d, f, 1, bm, bn, wbytes=wbytes)
                              ._replace(stages=2) for bm, bn in dense.HOPPER_TILES["gemm"]]
            for p in plans:
                key = ("split_grouped_gemm", "gemm", "hopper", dense.row_class(c),
                       str(wdt).removeprefix("torch."))
                before = grouped.PATHS[key]
                got = grouped.split_grouped_gemm(x, ql, qr, plan=p)
                assert grouped.PATHS[key] == before + 1
                assert _rel(got, ref) <= 2e-2, (e, c, d, f, wdt, p)
                assert torch.equal(grouped.split_grouped_gemm(x, ql, qr, plan=p), got), p
                other = x.clone()
                other[1:] = rnd(e - 1, c, d, scale=1.0)
                assert torch.equal(grouped.split_grouped_gemm(other, ql, qr, plan=p)[0], got[0])
                if wdt in FP8:
                    wide = grouped.split_grouped_gemm(x, ql.to(bf), qr.to(bf), plan=p)
                    assert torch.equal(wide, got), (e, c, d, f, wdt, p)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_fp8_banks_refused_where_no_kernel_takes_them():
    """fp8 banks raise beside fp32 activations, at an F the Hopper path
    does not take (not a multiple of 16), and on kernels #2-#6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    from repro_torch.kernels.split_gemm import dense, grouped

    w8 = torch.zeros(2, 64, 128, device="cuda").to(torch.float8_e4m3fn)
    x = torch.zeros(4, 3, 64, device="cuda")
    with pytest.raises(TypeError, match="bfloat16 activations"):
        grouped.split_grouped_gemm(x, w8, w8)
    with pytest.raises(TypeError, match="Hopper path only"):
        w120 = w8[..., :120].contiguous()
        grouped.split_grouped_gemm(x.bfloat16(), w120, w120)
    with pytest.raises(TypeError, match="not supported"):
        dense.split_stack_gemm(x[0].bfloat16(), w8, w8)
    w8t = w8.transpose(1, 2).contiguous()
    with pytest.raises(TypeError, match="not supported"):
        grouped.split_grouped_swiglu(x.bfloat16(), w8, w8, w8t, w8, w8, w8t)


# --------------------------------------------------------------------------
# Serving through captured CUDA graphs, at a small MoE configuration whose
# decode runs the route-before-gather path (2 rows x top-2 < 24 remote
# experts) and whose prefill (16 tokens per rank) gathers every expert.
# --------------------------------------------------------------------------
GRAPH_GEOM = dict(shard_attention=True, expert_axes=("model",), moe_exec="gather")
GRAPH_PROMPTS = (64, 32, 64, 32)  # two pow2 buckets
GRAPH_OUT = 5


def _graph_cfg():
    from repro_torch.configs import ArchConfig, MoEConfig

    return ArchConfig(name="graph-test", family="moe", num_layers=3, d_model=256, num_heads=4,
                      num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512,
                      moe=MoEConfig(num_experts=32, top_k=2, d_ff=128, shared_d_ff=128,
                                    first_dense=1))


def _graph_engine(params=None, **kw):
    from repro_torch.launch.serve import build_engine

    return build_engine(_graph_cfg(), mesh_shape=(1, 4), prefill_len=64, prefill_buckets=(32,),
                        cache_len=96, max_batch=2, dtype=torch.bfloat16, device="cuda",
                        params=params, geom_kwargs=GRAPH_GEOM, **kw)[0]


def _graph_serve(eng):
    import numpy as np
    from repro_torch.runtime.engine import Request

    rng = np.random.default_rng(3)
    for i, n in enumerate(GRAPH_PROMPTS):
        eng.submit(Request(i, rng.integers(0, 512, n), GRAPH_OUT))
    while eng.busy():
        eng.run(1)
    return dict(eng.outputs)


def _captures(eng):
    return eng.ctx.variants.captures(), eng.gen.variants.captures()


@pytest.mark.cuda
@pytest.mark.parametrize("fetch", ["all", "demand", "predictive", "sync_free"])
def test_cuda_graph_serving_bitwise_eager(fetch):
    """Each fetch mode through graphs against the eager engine
    (``graphs=False``) on the same weights: the same tokens over two
    prefill buckets, the same host counts (launches, paths, landed bytes,
    demand layers: each replay adds its capture's record), one more decode
    step's logits bitwise, no capture after warmup, and a replayed step and
    an eager deferred step free of host syncs
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from repro_torch import counters
    from repro_torch.core import execution

    kw = dict(expert_fetch=fetch, cache_budget=4 if fetch in ("predictive", "sync_free") else 0)
    graph = _graph_engine(**kw)
    eager = _graph_engine(params=graph.params, graphs=False, **kw)
    assert execution.demand_fetch_active(graph.gen.model.cfg, graph.gen.model.geom,
                                         graph.gen.xp) == (fetch != "all")
    graph.warmup()
    eager.warmup()
    warm = _captures(graph)
    assert warm == (2, 1) and _captures(eager) == (0, 0)
    with counters.recording() as graph_counts:
        graph_tokens = _graph_serve(graph)
    with counters.recording() as eager_counts:
        eager_tokens = _graph_serve(eager)
    assert graph_tokens == eager_tokens
    assert graph_counts == eager_counts and graph_counts
    assert _captures(graph) == warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = graph.gen.step(graph.params)["logits"].clone()
        ctx = execution.Ctx(model=eager.gen.model, xp=eager.gen.xp, deferred=True)
        ref = execution.forward_decode(eager.params, eager.gen.cur_token, eager.gen.state,
                                       ctx)["logits"]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(logits, ref)
    assert graph.gen.fallbacks == eager.gen.fallbacks == 0


@pytest.mark.cuda
def test_cuda_graph_forced_overflow_rerun_and_eviction():
    """Demand decode with a budget of 1 row per peer overflows: every such
    step is run again eagerly and counted, and the tokens are the
    all-fetch engine's. Then a one-entry variant cache: a policy switch
    evicts the installed variant and frees its graph, and serving goes on
    through the new variant's capture with the same tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from repro_torch.core.strategy import PolicyTable

    ref = _graph_engine(graphs=False)
    want = _graph_serve(ref)
    forced = _graph_engine(params=ref.params, expert_fetch="demand", demand_budget=1)
    forced.warmup()
    assert _graph_serve(forced) == want
    assert forced.gen.fallbacks > 0

    small = _graph_engine(params=ref.params, expert_fetch="demand", variant_cache_size=1)
    small.warmup()
    old = small.gen.step
    assert old.captures() == 1 and old.graph is not None
    logits = weakref.ref(old.outputs["logits"])
    assert small.gen.set_policy(PolicyTable.uniform(fetch="predictive", cache_budget=4))
    assert small.gen.variants.stats["evictions"] == 1 and len(small.gen.variants) == 1
    assert old.graph is None and old.outputs is None
    assert logits() is None  # the graph's outputs are freed
    assert _graph_serve(small) == want
    assert small.gen.step.captures() == 1
    assert small.gen.variants.captures() == 2  # the eviction did not lower it


@pytest.mark.cuda
@pytest.mark.parametrize("gen_mode", ["dep", "hybrid"])
def test_cuda_dep_graph_step_bitwise_eager(gen_mode):
    """A DWDP context server feeding a DEP (or hybrid) generation server,
    through graphs against the eager engine on the same weights: the same
    tokens, no capture after warmup, one more decode step's logits bitwise
    the eager deferred step's and free of host syncs — and the same for
    DEP's qgather decode variant over the same state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from repro_torch.core import execution
    from repro_torch.core.strategy import make_execution_plan

    graph = _graph_engine(gen_mode=gen_mode)
    eager = _graph_engine(params=graph.params, graphs=False, gen_mode=gen_mode)
    assert graph.gen.xp.mode == gen_mode and "pred" not in graph.gen.state
    graph.warmup()
    eager.warmup()
    warm = _captures(graph)
    assert warm == (2, 1)
    assert _graph_serve(graph) == _graph_serve(eager)
    assert _captures(graph) == warm
    variants = [(graph.gen.step, graph.gen.xp)]
    if gen_mode == "dep":
        gen = graph.gen
        xq = make_execution_plan(gen.model, gen.variants.shape, gen.xp.mesh_sizes, mode="dep",
                                 policy=gen.xp.policies, decode_attn="qgather",
                                 capacity_from=gen.xp.capacity_from)
        variants.append((gen._build(xq), xq))
    for step, xp in variants:
        step(graph.params)  # captures a new variant off the timed path
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits = step(graph.params)["logits"].clone()
            ctx = execution.Ctx(model=eager.gen.model, xp=xp, deferred=True)
            ref = execution.forward_decode(eager.params, eager.gen.cur_token, eager.gen.state,
                                           ctx)["logits"]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(logits, ref), xp.decode_attn


@pytest.mark.cuda
@pytest.mark.parametrize("gen_mode", ["dwdp", "dep"])
def test_cuda_two_data_replicas_graph_bitwise_eager(gen_mode):
    """Mesh (data=2, model=4), max_batch 4: the context server shards each
    prompt over all eight ranks, the generation server two slots per data
    replica. The replicas' weights are the model ranks' own storage (the
    same ``data_ptr``); through graphs against the eager engine the same
    tokens, no capture after warmup, and one more decode step's logits
    bitwise the eager deferred step's, free of host syncs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from repro_torch.core import execution
    from repro_torch.launch.serve import build_engine

    def engine(**kw):
        return build_engine(_graph_cfg(), mesh_shape=(2, 4), prefill_len=64,
                            prefill_buckets=(32,), cache_len=96, max_batch=4,
                            dtype=torch.bfloat16, device="cuda", gen_mode=gen_mode,
                            geom_kwargs=GRAPH_GEOM, **kw)[0]

    graph = engine()
    eager = engine(params=graph.params, graphs=False)
    assert graph.ctx.xp.seq_axes == ("data", "model")
    assert (graph.gen.xp.batch_axes, graph.gen.xp.seq_axes) == (("data",), ("model",))

    def leaves(tree):
        return [x for v in tree.values() for x in leaves(v)] if isinstance(tree, dict) else [tree]

    for m in range(4):
        for a, b in zip(leaves(graph.params[m]), leaves(graph.params[m + 4]), strict=True):
            assert a.data_ptr() == b.data_ptr()
    graph.warmup()
    eager.warmup()
    warm = _captures(graph)
    assert warm == (2, 1)
    assert _graph_serve(graph) == _graph_serve(eager)
    assert _captures(graph) == warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = graph.gen.step(graph.params)["logits"].clone()
        ctx = execution.Ctx(model=eager.gen.model, xp=eager.gen.xp, deferred=True)
        ref = execution.forward_decode(eager.params, eager.gen.cur_token, eager.gen.state,
                                       ctx)["logits"]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert logits.shape[0] == 4 and torch.equal(logits, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("policy,same_as", [
    ("merged:all:ring_sliced:3", "merged:all:allgather"),
    ("split:all:ring_sliced", "split:all:allgather"),
    ({"moe_experts": "split:demand:ring_sliced:4:100", "attn_qkv": "merged",
      "attn_out": "split:all:ring", "body/dense_ffn": "merged:all:ring"},
     {"moe_experts": "split:all", "attn_qkv": "merged", "body/dense_ffn": "merged"}),
], ids=["merged-ring_sliced", "split-ring_sliced", "mixed"])
def test_cuda_policy_tables_graph_bitwise(policy, same_as):
    """Gather-policy tables through graphs: the landings' copies (column
    slices on the side stream, the demand payload's sliced row gathers
    included) land the same bytes as the allgather table's, so the tokens
    and one more decode step's logits are bitwise those of ``same_as``
    (a demand fetch that never overflows runs the all-fetch math); the
    graph serve equals the eager one and captures nothing after warmup."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    graph = _graph_engine(policy=policy)
    eager = _graph_engine(params=graph.params, graphs=False, policy=policy)
    ref = _graph_engine(params=graph.params, policy=same_as)
    outs, logits = [], []
    for eng in (graph, eager, ref):
        eng.warmup()
        warm = _captures(eng)
        outs.append(_graph_serve(eng))
        assert _captures(eng) == warm
        logits.append(eng.gen.step_outputs(eng.params)[0]["logits"].clone())
    assert outs[0] == outs[1] == outs[2]
    assert torch.equal(logits[0], logits[1]) and torch.equal(logits[0], logits[2])
    assert graph.gen.fallbacks == 0


@pytest.mark.cuda
def test_cuda_fault_masks_checksums_and_tamper_match_cpu():
    """The injector's masks on the card (keyed by a device step tensor,
    eagerly and from a replayed CUDA graph) equal the same draws on the
    CPU; checksums, verification and tampering agree with the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import faults, prefetch
    from repro_torch.core.placement import make_placement

    pl = make_placement(64, 4)
    spec = faults.FaultSpec.parse("seed=3,drop=0.2,zero=0.1,corrupt=0.1,cache=0.3,mirror=0.5,"
                                  "peers=2")
    inj = faults.FaultInjector(spec, pl, {"data": 1, "model": 4})
    for rank in range(4):
        for step in (0, 7, 1000):
            dev_step = torch.tensor([step - 1, step], dtype=torch.int32, device="cuda").max()
            cpu = inj.payload_masks(inj.site_key("corr", step, rank), 16, rank)
            gpu = inj.payload_masks(inj.site_key("corr", dev_step, rank), 16, rank)
            assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, gpu))
            assert torch.equal(inj.cache_mask(inj.site_key("cache", step, rank), 8),
                               inj.cache_mask(inj.site_key("cache", dev_step, rank), 8).cpu())
            assert bool(inj.mirror_flag(step, rank)) == bool(inj.mirror_flag(dev_step, rank))
    # a replayed graph draws the step its input holds
    step_in = torch.zeros((), dtype=torch.int64, device="cuda")
    inj.payload_masks(inj.site_key("spec", step_in, 1), 16, 1)  # warm up outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = inj.payload_masks(inj.site_key("spec", step_in, 1), 16, 1)
    for step in (3, 11):
        step_in.fill_(step)
        graph.replay()
        ref = inj.payload_masks(inj.site_key("spec", step, 1), 16, 1)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(out, ref))

    gen = torch.Generator().manual_seed(5)
    tree = {"w_gate": (torch.randn(9, 64, 300, generator=gen) * 0.1).bfloat16(),
            "w_down": (torch.randn(9, 300, 64, generator=gen) * 0.1).bfloat16()}
    gtree = {k: v.cuda() for k, v in tree.items()}
    cpu_cs, gpu_cs = prefetch.row_checksums(tree), prefetch.row_checksums(gtree).cpu()
    assert torch.allclose(gpu_cs, cpu_cs, rtol=1e-5, atol=0)
    drop = torch.tensor([False, True, False, False, False, False, True, False, False])
    corrupt = torch.tensor([False, False, True, False, False, False, False, False, True])
    faults.FaultInjector.tamper_rows(tree, drop, corrupt)
    faults.FaultInjector.tamper_rows(gtree, drop.cuda(), corrupt.cuda())
    assert all(torch.equal(tree[k], gtree[k].cpu()) for k in tree)
    ids, valid = torch.arange(9), torch.ones(9, dtype=torch.bool)
    ok, bad = prefetch.verify_rows(gtree, ids.cuda(), valid.cuda(), gpu_cs.cuda())
    assert bad.cpu().tolist() == (drop | corrupt).tolist() and torch.equal(ok.cpu(), ~bad.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("fetch", ["demand", "predictive", "sync_free"])
def test_cuda_validated_graph_serving_bitwise_eager(fetch):
    """The validated fetch with injected faults through graphs against the
    eager engine and the healthy all-fetch engine: the same tokens, the same
    fault counters (the graph's from its device step tensor), no capture
    after warmup, the faulty steps run again eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    spec = "seed=4,drop=0.2,zero=0.1,corrupt=0.1,cache=0.3" + (
        ",mirror=0.5" if fetch == "sync_free" else "")
    kw = dict(expert_fetch=fetch, cache_budget=4 if fetch != "demand" else 0, fault_spec=spec)
    ref = _graph_engine(graphs=False)
    want = _graph_serve(ref)
    graph = _graph_engine(params=ref.params, **kw)
    eager = _graph_engine(params=ref.params, graphs=False, **kw)
    graph.warmup()
    eager.warmup()
    warm = _captures(graph)
    assert _graph_serve(graph) == _graph_serve(eager) == want
    assert _captures(graph) == warm
    fg, fe = graph.metrics.summary(1.0)["faults"], eager.metrics.summary(1.0)["faults"]
    assert fg == fe and fg["detected"] >= sum(v for k, v in fg.items() if k.startswith("injected"))
    assert graph.gen.fault_fallbacks == eager.gen.fault_fallbacks > 0


@pytest.mark.cuda
def test_cuda_predictor_replay_matches_cpu():
    """The R1 acceptance trace (tests/test_syncfree.py:263) replayed on the
    card gives the CPU's hit rates, with and without the richer signals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the replay runs on the card")
    from repro_torch.core import traces

    trace = traces.zipf_routing_trace(48, 8, 256, 8, alpha=1.3, affinity=0.8, drift_every=24,
                                      seed=7)
    card = {}
    for rich in (True, False):
        card[rich] = traces.predictor_hit_rate(trace, 256, 4, budget=16, rich=rich)
        cpu = traces.predictor_hit_rate(trace, 256, 4, budget=16, rich=rich, device="cpu")
        assert abs(card[rich] - cpu) <= 1e-6, (rich, card[rich], cpu)
    assert card[True] >= 0.9 and card[True] >= card[False] - 0.02, card


@pytest.mark.cuda
def test_cuda_reshard_split_bank_bitwise_cpu():
    """G' 4 -> 3 over E 20 with position 1 dead: the survivors' shards on the
    card, ``source`` on the host (pinned), the dead shard NaN; the new
    shards land on the card, bitwise the CPU re-shard's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the re-shard's copies run on the card")
    from repro_torch.core import prefetch
    from repro_torch.core.placement import make_placement

    e, dead = 20, 1
    old, new = make_placement(e, 4), make_placement(e, 3)
    gen = torch.Generator().manual_seed(0)
    source = {"w_up": torch.randn(e, 24, 16, generator=gen).to(torch.bfloat16).pin_memory(),
              "w_down": torch.randn(e, 16, 24, generator=gen).to(torch.bfloat16).pin_memory()}
    table = torch.as_tensor(old.table())

    def shards(device):
        out = [{k: v[table[r]].to(device) for k, v in source.items()}
               for r in range(4)]
        for leaf in out[dead].values():
            leaf.fill_(float("nan"))
        return out

    events = {}
    got = prefetch.reshard_split_bank(shards("cuda"), old, new, dead, source, events=events)
    ref = prefetch.reshard_split_bank(shards("cpu"), old, new, dead, source)
    torch.cuda.synchronize()
    assert set(events) == set(prefetch.RESHARD_KINDS)
    for g, r in zip(got, ref):
        for k in source:
            assert g[k].device.type == "cuda" and not torch.isnan(g[k]).any()
            assert torch.equal(g[k].cpu(), r[k])
