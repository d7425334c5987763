// split_dense_swiglu: fused stacked-slice SwiGLU over split banks (dense
// FFN layers and the shared expert).
//
// Replaces the Pallas kernel repro/kernels/split_gemm/dense.py::split_dense_swiglu.
// Computes y = sum_s swiglu_s(x): x (T, D); gate/up banks (S_*, D, Fs),
// down banks (S_*, Fs, D) -> y (T, D), fp32 accumulation, the hidden h
// rounded to the activation type before the down product (as the Pallas
// kernel does, split_gemm.py:225).
//
// Bound on the H100: the 3 * S * D * Fs weight bytes at decode; the
// operations at prefill (6 * S * T * D * Fs). The Pallas kernel keeps a
// (T, D) fp32 output accumulator in VMEM; at D = 7168 that does not fit a
// block's 227 KB of shared memory. Schedule: write h to a scratch
// (S, T, Fs) buffer in the activation type (launch 1, gate and up on one
// activation tile, silu*mul on the fp32 accumulators), then the down
// product as the ordered slice reduction of split_reduce_gemm. Each launch
// takes the path of its own plan (kernels/split_gemm/dense.py::plan_split):
// bf16 with widths that are multiples of 8 runs split_hopper.cuh
// (TMA + mbarrier ring + wgmma over more than 2 rows; the few-row kernels,
// k split to fill the card, at 2 rows or fewer); fp32 and other widths
// keep the split_tile.cuh launchers. fp8-stored banks (e4m3, e5m2; bf16
// activations, D and Fs multiples of 16), the Pallas kernel's _cast: both
// split_hopper.cuh paths widen each fp8 tile exactly to bf16 on the chip
// (gate_up's gate and up tiles both), bitwise the bf16 kernel's result on
// the widened banks under the same plans; h stays bf16, and split_tile.cuh
// takes no fp8. No atomics: results are deterministic.
#include "split_hopper.cuh"
#include "split_tile.cuh"

extern "C" int split_dense_swiglu(const void* x, const void* g_local, const void* u_local,
                                  const void* d_local, const void* g_remote,
                                  const void* u_remote, const void* d_remote, void* h,
                                  void* out, void* scratch, int s_local, int s_remote, int t,
                                  int d, int fs, int dtype, int wtype, int gu_path, int gu_bm,
                                  int gu_bn, int gu_stages, int gu_splits, int gu_chunk,
                                  int dn_path, int dn_bm, int dn_bn, int dn_stages, int dn_splits,
                                  int dn_chunk, void* stream) {
  using namespace split_hopper;
  const int s = s_local + s_remote;
  cudaStream_t st = (cudaStream_t)stream;
  float* part = (float*)scratch;
  const Plan gu{gu_path, gu_bm, gu_bn, gu_stages, gu_splits, gu_chunk};
  const Plan dn{dn_path, dn_bm, dn_bn, dn_stages, dn_splits, dn_chunk};
  if (wtype != W_SAME && (dtype != 1 || gu.path == PATH_TILE || dn.path == PATH_TILE))
    return (int)cudaErrorInvalidValue;
  int err;
  if (gu.path == PATH_TILE)
    err = SPLIT_DISPATCH(dtype, t, split_tile::launch_gate_up, x, 0L, g_local, u_local,
                         g_remote, u_remote, h, s_local, s, t, d, fs, st);
  else
    err = dtype != 1 ? (int)cudaErrorInvalidValue : by_weight(wtype, [&](auto w) {
      return launch_slices<GATE_UP, decltype(w)::value>(x, 1, g_local, u_local, g_remote,
                                                        u_remote, h, part, nullptr, s_local, s,
                                                        t, d, fs, gu, st);
    });
  if (err) return err;
  if (dn.path == PATH_TILE)
    return SPLIT_DISPATCH(dtype, t, split_tile::launch_reduce, h, d_local, d_remote, out,
                          s_local, s, t, fs, d, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return by_weight(wtype, [&](auto w) {
    return launch_reduce<decltype(w)::value>(h, d_local, d_remote, out, part, s_local, s, t, fs,
                                             d, dn, st);
  });
}
