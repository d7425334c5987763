// split_reduce_gemm: row-split reduction over split banks (attention O).
//
// Replaces the Pallas kernel repro/kernels/split_gemm/dense.py::split_reduce_gemm.
// Computes out = sum_s x[s] @ W(s): x (S, T, Fs), banks (S_l, Fs, D) /
// (S - S_l, Fs, D) -> out (T, D). The slice sum is order-independent, so
// the rotated remote-bank order needs no fix-up.
//
// Bound on the H100: the S * Fs * D weight bytes at decode (T 2) and at
// R1's prefill shard (T 256, where the operations come close); the
// operations at T 1024 and 2048. Design: the wrapper's plan
// (kernels/split_gemm/dense.py::plan_split) picks the path. bf16 with
// every width a multiple of 8 runs split_hopper.cuh: more than 2 rows a
// TMA + mbarrier ring feeding wgmma from two consumer warpgroups (128 x 256
// output tiles, the bank's TMA map switched at each slice boundary,
// optional fp32 split-k partials summed in order by a second launch); at
// most 2 rows the few-row kernels, k split over enough blocks to fill the
// card. fp32, and bf16 widths that are not multiples of 8, keep the
// split_tile.cuh launcher (FMA or mma.sync tiles, one block per output
// tile looping over every slice in order). fp8-stored banks (e4m3, e5m2;
// bf16 activations, D a multiple of 16), the Pallas kernel's _cast: both
// split_hopper.cuh paths widen each fp8 tile exactly to bf16 on the chip,
// bitwise the bf16 kernel's result on the widened banks under the same
// plan; split_tile.cuh takes no fp8. No atomics anywhere: results are
// deterministic.
#include "split_hopper.cuh"
#include "split_tile.cuh"

extern "C" int split_reduce_gemm(const void* x, const void* w_local, const void* w_remote,
                                 void* out, void* scratch, int s_local, int s_remote, int t,
                                 int fs, int d, int dtype, int wtype, int path, int bm, int bn,
                                 int stages, int splits, int chunk, void* stream) {
  using namespace split_hopper;
  cudaStream_t st = (cudaStream_t)stream;
  if (path == PATH_TILE)
    return wtype != W_SAME ? (int)cudaErrorInvalidValue
                           : SPLIT_DISPATCH(dtype, t, split_tile::launch_reduce, x, w_local,
                                            w_remote, out, s_local, s_local + s_remote, t, fs, d,
                                            st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const Plan plan{path, bm, bn, stages, splits, chunk};
  return by_weight(wtype, [&](auto w) {
    return launch_reduce<decltype(w)::value>(x, w_local, w_remote, out, (float*)scratch, s_local,
                                             s_local + s_remote, t, fs, d, plan, st);
  });
}

// The prefill path's single-tile check (split_hopper.cuh::tile_check):
// out (64, 64) fp32 = a (64, k) @ b (k, 64), bf16, k <= 64.
extern "C" int split_hopper_tile_check(const void* a, const void* b, void* out, int k,
                                       void* stream) {
  return split_hopper::tile_check(a, b, (float*)out, k, (cudaStream_t)stream);
}
