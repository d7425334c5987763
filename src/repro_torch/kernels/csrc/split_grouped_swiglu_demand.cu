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
// reads the local bank, the others the fetched bank. A padding row
// (valid 0) reads no weights and its output block is exactly zero.
//
// Bound on the H100: the weight bytes of the real experts, 3 * D * F per
// expert (E_l + the valid fetched rows; 88 MB per expert at DeepSeek-R1
// width). Design: kernel #2's two launches (split_grouped_swiglu.cu) on
// kernel #2's plan for the same C, D and F (grouped.py::plan_grouped),
// with the valid vector passed to both: on split_hopper.cuh's Hopper path
// (every capacity in bf16, decode included) a padding expert's producer
// issues no loads and its block writes zeros; on split_tile.cuh's
// launchers (fp32, other widths) a padding expert's block exits without
// reading weights (skip_expert). A
// real expert runs the very code of kernel #2, so its (C, D) block is
// bitwise kernel #2's for the same rows and weights: the demand,
// predictive and sync-free decodes give the all-fetch decode's bits.
// fp8-stored banks (e4m3, e5m2; bf16 activations) run kernel #2's fp8
// Hopper path on #2's plan, so the same holds for an fp8 model.
#include "split_hopper.cuh"
#include "split_tile.cuh"

extern "C" int split_grouped_swiglu_demand(const void* x, const void* g_local,
                                           const void* u_local, const void* d_local,
                                           const void* g_fetched, const void* u_fetched,
                                           const void* d_fetched, const void* valid, void* h,
                                           void* out, int e_local, int e_fetched, int c, int d,
                                           int f, int dtype, int wtype, int gu_path, int gu_bm,
                                           int gu_bn, int gu_stages, int gu_splits, int gu_chunk,
                                           int dn_path, int dn_bm, int dn_bn, int dn_stages,
                                           int dn_splits, int dn_chunk, void* stream) {
  using namespace split_hopper;
  const int e = e_local + e_fetched;
  const unsigned char* v = (const unsigned char*)valid;
  cudaStream_t st = (cudaStream_t)stream;
  if (gu_path != PATH_TILE || dn_path != PATH_TILE) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    const Plan gu{gu_path, gu_bm, gu_bn, gu_stages, gu_splits, gu_chunk};
    const Plan dn{dn_path, dn_bm, dn_bn, dn_stages, dn_splits, dn_chunk};
    return by_weight(wtype, [&](auto w) {
      return launch_grouped_swiglu<decltype(w)::value>(x, g_local, u_local, d_local, g_fetched,
                                                       u_fetched, d_fetched, h, out, v, e_local,
                                                       e, c, d, f, gu, dn, st);
    });
  }
  if (wtype != W_SAME) return (int)cudaErrorInvalidValue;
  int err = SPLIT_DISPATCH(dtype, c, split_tile::launch_gate_up, x, (long)c * d, g_local,
                           u_local, g_fetched, u_fetched, h, e_local, e, c, d, f, st, v);
  if (err) return err;
  return SPLIT_DISPATCH(dtype, c, split_tile::launch_grouped, h, (long)c * f, d_local,
                        d_fetched, out, e_local, e, c, f, d, st, v);
}
