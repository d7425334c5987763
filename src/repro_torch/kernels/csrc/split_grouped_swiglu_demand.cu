// split_grouped_swiglu_demand: the MoE layer of the route-before-gather
// decode (demand, predictive and sync-free expert fetch).
//
// Replaces the Pallas kernel
// repro/kernels/split_gemm/split_gemm.py::split_grouped_swiglu_demand.
// Computes y[e] = (silu(x[e] @ Wg(e)) * (x[e] @ Wu(e))) @ Wd(e) over a
// (resident, fetched) expert bank pair: x (E_l + E_f, C, D); local banks
// (E_l, D, F) / (E_l, F, D); fetched banks (E_f, D, F) / (E_f, F, D), the
// demand-fetched rows padded to a per-peer budget; valid (E_f,) bytes
// marking the real fetched rows -> y (E_l + E_f, C, D). Expert e < E_l
// reads the local bank, the others the fetched bank, selected by pointer
// per block. A padding row (valid 0) reads no weights and its output block
// is exactly zero.
//
// Bound on the H100: the weight bytes of the real experts, 3 * D * F per
// expert (E_l + the valid fetched rows; 88 MB per expert at DeepSeek-R1
// width). Design: kernel #2's two launches (split_grouped_swiglu.cu) —
// gate and up into an (E, C, F) h scratch, then the grouped down product —
// with the valid vector passed to both (split_tile.cuh skip_expert), so
// padding rows cost a block that exits without touching device memory
// beyond its zero output. A real expert runs the very inner loops of
// kernel #2 (few-row register path for <= 2 rows, mma.sync tiles above),
// so its (C, D) block is bitwise identical to kernel #2's for the same
// rows and weights: the demand, predictive and sync-free decodes give the
// all-fetch decode's bits.
#include "split_tile.cuh"

extern "C" int split_grouped_swiglu_demand(const void* x, const void* g_local,
                                           const void* u_local, const void* d_local,
                                           const void* g_fetched, const void* u_fetched,
                                           const void* d_fetched, const void* valid, void* h,
                                           void* out, int e_local, int e_fetched, int c, int d,
                                           int f, int dtype, void* stream) {
  const int e = e_local + e_fetched;
  const unsigned char* v = (const unsigned char*)valid;
  cudaStream_t st = (cudaStream_t)stream;
  int err = SPLIT_DISPATCH(dtype, c, split_tile::launch_gate_up, x, (long)c * d, g_local,
                           u_local, g_fetched, u_fetched, h, e_local, e, c, d, f, st, v);
  if (err) return err;
  return SPLIT_DISPATCH(dtype, c, split_tile::launch_grouped, h, (long)c * f, d_local,
                        d_fetched, out, e_local, e, c, f, d, st, v);
}
