// split_grouped_gemm: grouped GEMM over a (resident, remote) expert bank
// pair, the banks stored in bf16 or fp8.
//
// Replaces the Pallas kernel repro/kernels/split_gemm/split_gemm.py::split_grouped_gemm.
// Computes y[e] = x[e] @ W(e): x (E, C, D); banks (E_l, D, F) /
// (E - E_l, D, F) -> y (E, C, F), fp32 accumulation, the output in the
// activation type. Experts [0, E_l) read the local bank, the rest the
// remote bank; an empty bank is never read. fp8-stored banks (e4m3, e5m2)
// with bf16 activations are widened to bf16 on use, exactly, as the Pallas
// kernel's _cast does.
//
// Bound on the H100: the E * D * F weight bytes (C << D at serving
// shapes): 7.5 GB in bf16 at DeepSeek-R1's expert shapes per rank (E 256,
// D 7168, F 2048), 2.25 ms at 3.35 TB/s, half that in fp8. Design: the
// wrapper's plan (kernels/split_gemm/grouped.py::plan_grouped, op "gemm",
// a pure function of C, D, F and the weight type). bf16 activations with
// widths that are multiples of 8 (16 for F with fp8 banks) run
// split_hopper.cuh's TMA + mbarrier ring + wgmma mainloop as op STACK with
// the activation read per expert (the down launch of kernel #2): BM 64 at
// C <= 64, else 128, so all of an expert's rows sit in one m tile and
// every weight byte is streamed once; BN 256. fp8 banks run the same
// mainloop with the fp8 tiles widened in shared memory before the wgmma
// (split_hopper.cuh), bitwise the bf16 result on the widened banks. fp32
// and other widths keep split_tile.cuh's launchers (its few-row register
// path at <= 2 rows, mma.sync or FMA tiles above); they take no fp8 banks.
// No atomics: each output element has one fp32 accumulator in a fixed k
// order, so the result is deterministic.
#include "split_hopper.cuh"
#include "split_tile.cuh"

extern "C" int split_grouped_gemm(const void* x, const void* w_local, const void* w_remote,
                                  void* out, int e_local, int e_remote, int c, int d, int f,
                                  int dtype, int wtype, int path, int bm, int bn, int stages,
                                  int splits, int chunk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int e = e_local + e_remote;
  if (path == split_hopper::PATH_TILE) {
    if (wtype != split_hopper::W_SAME) return (int)cudaErrorInvalidValue;
    return SPLIT_DISPATCH(dtype, c, split_tile::launch_grouped, x, (long)c * d, w_local,
                          w_remote, out, e_local, e, c, d, f, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  using namespace split_hopper;
  const Plan plan{path, bm, bn, stages, splits, chunk};
  if (wtype == W_SAME)
    return launch_gemm<W_SAME>(x, w_local, w_remote, out, e_local, e, c, d, f, plan, st);
  if (wtype == W_E4M3)
    return launch_gemm<W_E4M3>(x, w_local, w_remote, out, e_local, e, c, d, f, plan, st);
  if (wtype == W_E5M2)
    return launch_gemm<W_E5M2>(x, w_local, w_remote, out, e_local, e, c, d, f, plan, st);
  return (int)cudaErrorInvalidValue;
}
