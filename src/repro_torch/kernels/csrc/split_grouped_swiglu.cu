// split_grouped_swiglu: fused per-expert SwiGLU over the (resident,
// remote) expert banks — the MoE layer of the DWDP path.
//
// Replaces the Pallas kernel repro/kernels/split_gemm/split_gemm.py::split_grouped_swiglu.
// Computes y[e] = (silu(x[e] @ Wg(e)) * (x[e] @ Wu(e))) @ Wd(e) for every
// expert e: x (E, C, D); gate/up banks (E_*, D, F), down banks (E_*, F, D)
// -> y (E, C, D). Experts [0, E_l) read the local bank, the rest the
// remote bank, selected by pointer per block; an empty bank is never read.
//
// Bound on the H100: the 3 * E * D * F expert weight bytes (C is 16 slots
// in prefill, 1 in decode), 22.5 GB per layer at DeepSeek-R1 width. The
// Pallas kernel's (C, D) fp32 output accumulator (458 KB at C 16, D 7168)
// does not fit a block's 227 KB of shared memory. Schedule chosen: write
// h to a scratch (E, C, F) buffer in the activation type (launch 1: gate
// and up fused on one activation tile, silu*mul on the fp32 accumulators,
// rounded once as split_gemm.py:225 does) and run the down product as a
// second grouped launch. Every weight tile is read once; h is 1/D of the
// gate/up bytes per slot. No atomics: each output element has one fp32
// accumulator in a fixed K order, so the result is deterministic.
// Both launches pick their inner loop by row count (split_tile.cuh): two
// rows or fewer (decode) stream the weights straight into registers;
// more rows run mma.sync on shared-memory tiles (bf16; FMAs for fp32).
#include "split_tile.cuh"

extern "C" int split_grouped_swiglu(const void* x, const void* g_local, const void* u_local,
                                    const void* d_local, const void* g_remote,
                                    const void* u_remote, const void* d_remote, void* h,
                                    void* out, int e_local, int e_remote, int c, int d, int f,
                                    int dtype, void* stream) {
  const int e = e_local + e_remote;
  cudaStream_t st = (cudaStream_t)stream;
  int err = SPLIT_DISPATCH(dtype, c, split_tile::launch_gate_up, x, (long)c * d, g_local,
                           u_local, g_remote, u_remote, h, e_local, e, c, d, f, st);
  if (err) return err;
  return SPLIT_DISPATCH(dtype, c, split_tile::launch_grouped, h, (long)c * f, d_local,
                        d_remote, out, e_local, e, c, f, d, st);
}
