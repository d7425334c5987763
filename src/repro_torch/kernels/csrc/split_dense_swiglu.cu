// split_dense_swiglu: fused stacked-slice SwiGLU over split banks (dense
// FFN layers and the shared expert).
//
// Replaces the Pallas kernel repro/kernels/split_gemm/dense.py::split_dense_swiglu.
// Computes y = sum_s swiglu_s(x): x (T, D); gate/up banks (S_*, D, Fs),
// down banks (S_*, Fs, D) -> y (T, D), fp32 accumulation, the hidden h
// rounded to the activation type before the down product (as the Pallas
// kernel does, split_gemm.py:225).
//
// Bound on the H100: the 3 * S * D * Fs weight bytes. The Pallas kernel
// keeps a (T, D) fp32 output accumulator in VMEM; at D = 7168 that does
// not fit a block's 227 KB of shared memory. Schedule chosen: write h to
// a scratch (S, T, Fs) buffer in the activation type (launch 1, gate and
// up fused on one activation tile, silu*mul on the fp32 accumulators) and
// run the down product as a second launch, the ordered slice reduction
// of split_reduce_gemm. h is T * S * Fs elements — a small fraction of
// the weight bytes — and no atomics are used, so the sum is deterministic.
// Both launches pick their inner loop by row count (split_tile.cuh): two
// rows or fewer (decode) stream the weights straight into registers;
// more rows run mma.sync on shared-memory tiles (bf16; FMAs for fp32).
#include "split_tile.cuh"

extern "C" int split_dense_swiglu(const void* x, const void* g_local, const void* u_local,
                                  const void* d_local, const void* g_remote,
                                  const void* u_remote, const void* d_remote, void* h,
                                  void* out, int s_local, int s_remote, int t, int d, int fs,
                                  int dtype, void* stream) {
  const int s = s_local + s_remote;
  cudaStream_t st = (cudaStream_t)stream;
  int err = SPLIT_DISPATCH(dtype, t, split_tile::launch_gate_up, x, 0L, g_local, u_local,
                           g_remote, u_remote, h, s_local, s, t, d, fs, st);
  if (err) return err;
  return SPLIT_DISPATCH(dtype, t, split_tile::launch_reduce, h, d_local, d_remote, out,
                        s_local, s, t, fs, d, st);
}
