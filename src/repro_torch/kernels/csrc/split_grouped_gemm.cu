// split_grouped_gemm: grouped GEMM over a (resident, remote) expert bank
// pair.
//
// Replaces the Pallas kernel repro/kernels/split_gemm/split_gemm.py::split_grouped_gemm.
// Computes y[e] = x[e] @ W(e): x (E, C, D); banks (E_l, D, F) /
// (E - E_l, D, F) -> y (E, C, F), fp32 accumulation. Experts [0, E_l)
// read the local bank, the rest the remote bank, selected by pointer per
// block; an empty bank is never read.
//
// Bound on the H100: the E * D * F weight bytes (C << D at serving
// shapes). Design: one launch of split_tile.cuh's grouped kernel (the down
// product of kernel #2), one block per (F tile, C tile, expert): the
// few-row register path for <= 2 rows, mma.sync tiles (bf16) or FMA tiles
// (fp32) above, each weight tile read once per block, no atomics.
#include "split_tile.cuh"

extern "C" int split_grouped_gemm(const void* x, const void* w_local, const void* w_remote,
                                  void* out, int e_local, int e_remote, int c, int d, int f,
                                  int dtype, void* stream) {
  return SPLIT_DISPATCH(dtype, c, split_tile::launch_grouped, x, (long)c * d, w_local, w_remote,
                        out, e_local, e_local + e_remote, c, d, f, (cudaStream_t)stream);
}
