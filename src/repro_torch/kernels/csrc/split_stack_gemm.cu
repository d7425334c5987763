// split_stack_gemm: column-split projection over split banks (attention QKV).
//
// Replaces the Pallas kernel repro/kernels/split_gemm/dense.py::split_stack_gemm.
// Computes out[s] = x @ W(s) for s < S, W(s) from the local bank for
// s < S_l and from the remote bank otherwise: x (T, D), banks
// (S_l, D, Fs) / (S - S_l, D, Fs) -> out (S, T, Fs), fp32 accumulation.
//
// Bound on the H100: at the serving token counts (T = 2 decode rows, 256
// prefill tokens per rank) the weight bytes dominate (T << D), so the
// kernel is bound by streaming the banks. Design: one block per (Fs tile,
// T tile, slice), the slice's bank chosen by pointer. Decode (T <= 2)
// takes the few-row path of split_tile.cuh: 16-byte weight loads straight
// into registers, no padding rows computed. Prefill stages (32 x 64..128)
// tiles in shared memory and runs mma.sync on the tensor cores (bf16; FMAs
// for fp32), so the weights are read once per 16 or 64 tokens.
#include "split_tile.cuh"

extern "C" int split_stack_gemm(const void* x, const void* w_local, const void* w_remote,
                                void* out, int s_local, int s_remote, int t, int d, int f,
                                int dtype, void* stream) {
  return SPLIT_DISPATCH(dtype, t, split_tile::launch_grouped, x, 0L, w_local, w_remote, out,
                        s_local, s_local + s_remote, t, d, f, (cudaStream_t)stream);
}
