// split_grouped_swiglu: fused per-expert SwiGLU over the (resident,
// remote) expert banks — the MoE layer of the DWDP path.
//
// Replaces the Pallas kernel repro/kernels/split_gemm/split_gemm.py::split_grouped_swiglu.
// Computes y[e] = (silu(x[e] @ Wg(e)) * (x[e] @ Wu(e))) @ Wd(e) for every
// expert e: x (E, C, D); gate/up banks (E_*, D, F), down banks (E_*, F, D)
// -> y (E, C, D). Experts [0, E_l) read the local bank, the rest the
// remote bank; an empty bank is never read.
//
// Bound on the H100: the 3 * E * D * F expert weight bytes (C is 16 slots
// at R1's 1024-token prefill, 88 at its 8192-token prefill, 1 at decode),
// 22.5 GB per layer at DeepSeek-R1 width: 6.7 ms at 3.35 TB/s. The Pallas
// kernel's (C, D) fp32 output accumulator (458 KB at C 16, D 7168) does
// not fit a block's 227 KB of shared memory, so h goes to a scratch
// (E, C, F) buffer in the activation type (gate and up fused on one
// activation tile, silu*mul on the fp32 accumulators, rounded once as
// split_gemm.py:225 does) and the down product is a second launch.
//
// Design: each launch takes the path of the wrapper's plan
// (kernels/split_gemm/grouped.py::plan_grouped, a pure function of C, D,
// F). In bf16 with widths that are multiples of 8, at every capacity,
// split_hopper.cuh's TMA + mbarrier ring + wgmma mainloop: gate/up is op
// GATE_UP and down op STACK, both with a 3-d activation map (E, C, K) read
// per expert, so all of an expert's C rows sit in one m tile (BM 64 at
// C <= 64, else 128; TMA zero-fills the rows past C, never the next
// expert's) and every weight byte is streamed once. At decode (C 1) the
// 63 zero rows of each tile cost tensor work (~1.5 ms of the tensor
// cores) well under the weight bytes' 6.7 ms, and 4-5 ring stages keep
// ~160-200 KB of loads in flight per SM: ~96 % of the byte bound on the
// H100, ahead of split_hopper.cuh's few-row kernels extended per expert
// (the other decode design, timed and dropped: PERF.md) and of the
// per-bank torch.bmm composition.
// fp32 and other widths keep split_tile.cuh's launchers. fp8-stored
// banks (e4m3, e5m2; bf16 activations, D and F multiples of 16), the
// Pallas kernel's _cast, run the Hopper path with each fp8 tile widened
// exactly to bf16 in shared memory before its wgmma (gate_up's gate and
// up tiles both): bitwise the bf16 kernel on the widened banks under the
// same plans. split_tile.cuh takes no fp8.
// No atomics: each output element has one fp32 accumulator in a fixed k
// order, so the result is deterministic and a row's result never depends
// on another row or expert.
#include "split_hopper.cuh"
#include "split_tile.cuh"

extern "C" int split_grouped_swiglu(const void* x, const void* g_local, const void* u_local,
                                    const void* d_local, const void* g_remote,
                                    const void* u_remote, const void* d_remote, void* h,
                                    void* out, int e_local, int e_remote, int c, int d, int f,
                                    int dtype, int wtype, int gu_path, int gu_bm, int gu_bn,
                                    int gu_stages, int gu_splits, int gu_chunk, int dn_path,
                                    int dn_bm, int dn_bn, int dn_stages, int dn_splits,
                                    int dn_chunk, void* stream) {
  using namespace split_hopper;
  const int e = e_local + e_remote;
  cudaStream_t st = (cudaStream_t)stream;
  if (gu_path != PATH_TILE || dn_path != PATH_TILE) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    const Plan gu{gu_path, gu_bm, gu_bn, gu_stages, gu_splits, gu_chunk};
    const Plan dn{dn_path, dn_bm, dn_bn, dn_stages, dn_splits, dn_chunk};
    return by_weight(wtype, [&](auto w) {
      return launch_grouped_swiglu<decltype(w)::value>(x, g_local, u_local, d_local, g_remote,
                                                       u_remote, d_remote, h, out, nullptr,
                                                       e_local, e, c, d, f, gu, dn, st);
    });
  }
  if (wtype != W_SAME) return (int)cudaErrorInvalidValue;
  int err = SPLIT_DISPATCH(dtype, c, split_tile::launch_gate_up, x, (long)c * d, g_local,
                           u_local, g_remote, u_remote, h, e_local, e, c, d, f, st);
  if (err) return err;
  return SPLIT_DISPATCH(dtype, c, split_tile::launch_grouped, h, (long)c * f, d_local,
                        d_remote, out, e_local, e, c, f, d, st);
}
