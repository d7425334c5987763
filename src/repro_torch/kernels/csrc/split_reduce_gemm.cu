// split_reduce_gemm: row-split reduction over split banks (attention O).
//
// Replaces the Pallas kernel repro/kernels/split_gemm/dense.py::split_reduce_gemm.
// Computes out = sum_s x[s] @ W(s): x (S, T, Fs), banks (S_l, Fs, D) /
// (S - S_l, Fs, D) -> out (T, D). The slice sum is order-independent, so
// the rotated remote-bank order needs no fix-up.
//
// Bound on the H100: the S * Fs * D weight bytes (T << Fs). Design: one
// block per (D tile, T tile) keeps one fp32 sum per output element and
// loops over every slice and every K tile in a fixed order — no atomics
// and no second pass, so the result is deterministic; each slice's bank
// is selected by pointer and its tiles are read once. Decode (T <= 2)
// takes the few-row path (weights streamed into registers, k-partials
// added in a fixed order); prefill runs mma.sync on shared-memory tiles
// (bf16; FMAs for fp32).
#include "split_tile.cuh"

extern "C" int split_reduce_gemm(const void* x, const void* w_local, const void* w_remote,
                                 void* out, int s_local, int s_remote, int t, int fs, int d,
                                 int dtype, void* stream) {
  return SPLIT_DISPATCH(dtype, t, split_tile::launch_reduce, x, w_local, w_remote, out,
                        s_local, s_local + s_remote, t, fs, d, (cudaStream_t)stream);
}
