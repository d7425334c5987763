// split_stack_gemm: column-split projection over split banks (attention QKV).
//
// Replaces the Pallas kernel repro/kernels/split_gemm/dense.py::split_stack_gemm.
// Computes out[s] = x @ W(s) for s < S, W(s) from the local bank for
// s < S_l and from the remote bank otherwise: x (T, D), banks
// (S_l, D, Fs) / (S - S_l, D, Fs) -> out (S, T, Fs), fp32 accumulation.
//
// Bound on the H100: the S * D * Fs weight bytes at decode (T 2) and at
// R1's 256-row prefill shard (where the operations come close); the
// operations at 1024 and 2048 rows. R1's k and v projections are narrow
// (Fs 256, 8 kv heads over 4 slices), so their output tiles alone cannot
// fill 132 SMs. Design: the wrapper's plan
// (kernels/split_gemm/dense.py::plan_split, op "stack") picks the path.
// bf16 with every width a multiple of 8 runs split_hopper.cuh: more than 2
// rows the TMA + mbarrier ring feeding wgmma (op STACK: grid (m tiles,
// column tiles, slices x splits), the activation map shared by every
// slice, the slice's bank map chosen per block, an output block per
// slice); where the tiles fill too few SMs the plan splits k into fp32
// partials, summed in split order by a second launch. At most 2 rows the
// few-row kernel streams the banks with k split over ~1000 blocks. fp32,
// and bf16 widths or pointers the tensor maps cannot take, keep
// split_tile.cuh's grouped launcher. fp8-stored banks (e4m3, e5m2; bf16
// activations, Fs a multiple of 16), the Pallas kernel's _cast: both
// split_hopper.cuh paths widen each fp8 tile exactly to bf16 on the chip
// (in shared memory before the wgmma; in registers on the few-row path),
// bitwise the bf16 kernel's result on the widened banks under the same
// plan; split_tile.cuh takes no fp8. No atomics: results are
// deterministic.
#include "split_hopper.cuh"
#include "split_tile.cuh"

extern "C" int split_stack_gemm(const void* x, const void* w_local, const void* w_remote,
                                void* out, void* scratch, int s_local, int s_remote, int t,
                                int d, int f, int dtype, int wtype, int path, int bm, int bn,
                                int stages, int splits, int chunk, void* stream) {
  using namespace split_hopper;
  cudaStream_t st = (cudaStream_t)stream;
  const int s = s_local + s_remote;
  if (path == PATH_TILE)
    return wtype != W_SAME ? (int)cudaErrorInvalidValue
                           : SPLIT_DISPATCH(dtype, t, split_tile::launch_grouped, x, 0L, w_local,
                                            w_remote, out, s_local, s, t, d, f, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const Plan plan{path, bm, bn, stages, splits, chunk};
  return by_weight(wtype, [&](auto w) {
    return launch_slices<STACK, decltype(w)::value>(x, 1, w_local, nullptr, w_remote, nullptr,
                                                    out, (float*)scratch, nullptr, s_local, s, t,
                                                    d, f, plan, st);
  });
}
