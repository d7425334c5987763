// Hopper paths of the split-bank GEMMs, bf16 activations: split_stack_gemm
// (#4), the grouped SwiGLU (#2, and #3 on #2's plan), split_reduce_gemm
// (#5), split_dense_swiglu (#6) and split_grouped_gemm (#1), their banks
// stored in bf16 or in fp8 (e4m3, e5m2). The TMA, mbarrier and wgmma
// helpers are hopper.cuh's.
//
// Replaces, for these kernels, the mma.sync tiles and the few-row register
// path of split_tile.cuh (which fp32 and widths that are not multiples of
// 8 keep). The plan (path, block tile, stages, splits, k chunk) is chosen
// in Python (kernels/split_gemm/dense.py::plan_split,
// grouped.py::plan_grouped) as a pure function of the shapes and passed in
// as ints.
//
// The Hopper path (#4-#6 above 2 rows; #1-#3 at every capacity, decode's
// C 1 included; every width a multiple of 8): one warp-specialised
// mainloop, three epilogues.
//   reduce   out    = sum_s A[s] @ W(s), slices ascending, k ascending
//   gate_up  h[s]   = bf16(silu(A @ Wg(s)) * (A @ Wu(s)))
//   stack    out[s] = A @ W(s)
// A is one activation shared by every slice (#4, #6) or one per slice
// (#5's (S, T, Fs); the grouped kernels' (E, C, K) experts).
// Block: CW consumer warpgroups (64 rows each: BM 64 or 128) and a
// producer warpgroup whose first thread keeps TMA loads of the A tile (BM
// x 64, K-major) and the B tiles (64 x 64 boxes of the row-major (K, N)
// banks, N-major) in flight into a ring of shared-memory stages, each with
// a full and an empty mbarrier. The consumers issue wgmma m64n256k16 or
// m64n128k16 (two, gate and up, for gate_up) straight from the
// 128-byte-swizzled tiles, B with the transpose bit, one wgmma group in
// flight. With two consumer warpgroups setmaxnreg moves registers from the
// producer to them (128 fp32 accumulators a thread). The bank is chosen
// per slice: one TMA map per nonempty bank tensor, the producer switches
// maps at each slice boundary; an empty bank has no map and is never read.
// A is a 3-d map, so a ragged tile reads zeros and never the next slice's
// (or expert's) rows; TMA zero-fills reads past M, K and N. The epilogue
// stages the tile in the idle ring and stores it with masked, coalesced
// 16-byte writes.
//
// What bounds it on the H100: at R1's 256-row prefill shard the weight
// bytes and the operations are close (235 MB, 60 GFLOP for #4 and #5); at
// 1024 and 2048 rows the operations (989 TFLOP/s bf16); the grouped
// kernels at every capacity the expert weight bytes (22.5 GB a layer at
// R1 width: at C 1 the tile's 63 zero-filled rows cost tensor work but no
// bytes, and 4 to 5 stages of ~40 KB keep the loads in flight). The ring
// keeps up to ~200 KB of loads in flight per SM, so the tensor cores never
// wait on a synchronous copy. Where the output tiles number fewer than two
// waves of 132 SMs (R1's narrow k/v projections), the plan may split the
// k loop into fp32 partials, summed in split order by a second launch: no
// atomics.
//
// fp8-stored banks (every op; the weight type WT a template parameter of
// the mainloop and of the few-row kernels, the bf16 instantiations
// unchanged; the Pallas kernels' _cast): wgmma has no bf16 x fp8 form,
// and quantizing the activations would compute another function, so the
// weights are widened exactly to bf16 on the chip (every e4m3 and e5m2
// value, NaN and e5m2's infinities included, is a bf16 value). The
// producer TMA-loads each B box as 64 x 64 bytes (1-byte elements, no
// swizzle) into a stage whose B part is half the bf16 one (gate_up's two
// matrices both).
// The consumer warpgroups widen their stage, on their own, before its
// wgmma: each thread takes 16 fp8 bytes of a k row (one 16-byte shared
// load, the warp reading 512 contiguous bytes), widens them
// (cvt.rn.f16x2.{e4m3,e5m2}x2, f16 -> f32, the f32's top half: exact)
// and stores the two 16-byte chunks at their 128-byte-swizzled places in
// a bf16 B tile that the unchanged wgmma descriptors read (the 8 lanes of
// a store phase hit 8 distinct chunks: no bank conflicts). Then
// fence.proxy.async and a barrier of the consumer threads. The widened
// tiles (gate_up: the gate and the up boxes of a stage, 2 NB of them) are
// WIDE_BUFS (3) buffers outside the ring: buffer i % 3 is
// rewritten at iteration i and was last read by the wgmma of iteration
// i - 3; a consumer gets there only past the barrier of iteration i - 1,
// which every consumer passes only after waiting out its wgmma group
// i - 3, so no wgmma still reads it, with one or two consumer warpgroups.
// The widening of stage i overlaps the wgmma of stage i - 1. Every tile
// keeps the stages of its bf16 plan (dense.py max_stages): 5 stages of 8
// KB (A, zero-filled at C 1) + 16 KB (fp8 B) at BM 64, 4 of 16 + 16 KB at
// BM 128 (gate_up 128 x 128 included), beside 96 KB of widened tiles; 7
// of 16 + 8 KB beside 48 KB for stack's 128 x 128. The result is bitwise
// the bf16 kernel's on the widened banks under the same block tile: the
// same B tile bits meet the same wgmma sequence.
//
// The few-row path (#4-#6 at most 2 rows): few-row kernels stream the
// weights in 16-byte loads (ld.global.nc.L1::no_allocate, 8 in flight per
// thread, a warp reading 512 contiguous bytes of a k row) into fp32 sums;
// the 8 warps of a block are summed in warp order through shared memory.
// They split the k rows over ~250-2000 blocks to fill all 132 SMs into
// fp32 partials that a second launch sums in order (and applies silu * up
// for gate_up). Bound: the weight bytes at 3.35 TB/s. (Extended with an
// activation per expert and #3's valid bytes, they lost to the Hopper path
// as the grouped kernels' decode design: PERF.md.) With fp8 banks a
// lane's 16-byte load holds 16 columns of a k row, widened in registers
// (the same exact conversion), so a block covers 512 columns; each
// column's sums run in the bf16 kernel's order, so under the same plan
// (k chunk) the result is bitwise the bf16 kernel's on the widened banks.
//
// Every sum runs in a fixed order that depends on the shapes only, and a
// row's result never reads another row's data: repeated launches give the
// same bits, and a row's output does not depend on the other rows.
#pragma once

#include <cuda_fp16.h>

#include <type_traits>

#include "hopper.cuh"

namespace split_hopper {

using namespace hopper;

using bf16 = __nv_bfloat16;

// Plan paths, as passed by the wrappers (dense.py PATH_CODES).
constexpr int PATH_TILE = 0;     // split_tile.cuh's launchers (mma.sync or FMA tiles)
constexpr int PATH_HOPPER = 1;
constexpr int PATH_FEW_ROW = 2;

// ---------------------------------------------------------------------------
// Prefill mainloop.
// ---------------------------------------------------------------------------
constexpr int BK = 64;
constexpr int BOX_N = 64;                      // bf16 columns of one 128-byte swizzle row
constexpr int B_BYTES = BK * BOX_N * 2;        // 8 KB
constexpr int B8_BYTES = BK * BOX_N;           // 4 KB: one fp8 box, 64-byte rows
constexpr int WIDE_BUFS = 3;                   // widened bf16 B tiles of an fp8 ring

// Weight types of the banks (_launch.py WEIGHT_CODES): the activation's
// own, or fp8 widened to bf16 on the chip (bf16 activations).
constexpr int W_SAME = 0, W_E4M3 = 1, W_E5M2 = 2;

// f(std::integral_constant<int, WT>()) for the weight code wt: the
// entry points' one switch from a runtime code to the templates.
template <class F>
inline int by_weight(int wt, F&& f) {
  switch (wt) {
    case W_SAME: return f(std::integral_constant<int, W_SAME>());
    case W_E4M3: return f(std::integral_constant<int, W_E4M3>());
    case W_E5M2: return f(std::integral_constant<int, W_E5M2>());
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a ring: 1024 bytes of alignment slack, the
// stages and the widened B tiles of an fp8 ring (or, if larger, the
// epilogue's staging tile, which reuses them), a full and an empty barrier
// per stage.
__host__ __device__ inline size_t ring_bytes(int stages, int stage_bytes, int epi_bytes,
                                             int wide_bytes = 0) {
  const size_t ring = (size_t)stages * stage_bytes + wide_bytes;
  return ring > (size_t)epi_bytes ? ring : (size_t)epi_bytes;
}
inline size_t smem_bytes(int stages, int stage_bytes, int epi_bytes, int wide_bytes = 0) {
  return 1024 + ring_bytes(stages, stage_bytes, epi_bytes, wide_bytes) +
         2 * (size_t)stages * sizeof(uint64_t);
}

template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 256) wgmma_m64n256(d, da, db);
  else wgmma_m64n128(d, da, db);
}

enum Op { REDUCE = 0, GATE_UP = 1, STACK = 2 };

// The block tile of an op (dense.py HOPPER_TILES): CW consumer warpgroups
// of 64 rows each (BM 64 or 128), NB 64-column boxes per B matrix (BN 128
// or 256; gate_up has two B matrices, gate and up); WT the weight type.
template <int OP, int NB_, int CW_, int WT = W_SAME>
struct Tile {
  static constexpr int CW = CW_;
  static constexpr int BM = 64 * CW;
  static constexpr int NB = NB_;
  static constexpr int BN = NB * BOX_N;                 // columns per matrix
  static constexpr int MATS = OP == GATE_UP ? 2 : 1;    // B matrices per stage
  static constexpr bool FP8 = WT != W_SAME;
  static constexpr int BOX = FP8 ? B8_BYTES : B_BYTES;  // a landed B box
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE = A_BYTES + MATS * NB * BOX;
  static constexpr int WIDE = FP8 ? WIDE_BUFS * MATS * NB * B_BYTES : 0;  // widened B tiles
  static constexpr int ACC = BN / 2;                    // fp32 per thread per matrix
  static constexpr int THREADS = 128 * (CW + 1);        // + the producer warpgroup
  // The epilogue stages the tile in shared memory, rows padded by 8
  // elements (conflict-free fragment writes), fp32 at most.
  static constexpr int EPI_LD = BN + 8;
  static constexpr int EPI_BYTES = BM * EPI_LD * 4;
};

__device__ __forceinline__ float silu_mul(float g, float u) { return g / (1.f + __expf(-g)) * u; }

// Two fp8 values (the low byte of v first) -> two f32, exactly: the
// hardware's fp8x2 -> f16x2 conversion, then f16 -> f32.
template <int WT>
__device__ __forceinline__ float2 fp8x2_float2(uint32_t v) {
  uint32_t h;
  if constexpr (WT == W_E4M3)
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h) : "h"((uint16_t)v));
  else
    asm("cvt.rn.f16x2.e5m2x2 %0, %1;\n" : "=r"(h) : "h"((uint16_t)v));
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

// Two fp8 values -> bf16x2, exactly: the top half of each f32 (an fp8
// value has at most 4 significant bits, so the f32's low 16 bits are zero
// and the top half is its bf16; NaN and infinity stay so).
template <int WT>
__device__ __forceinline__ uint32_t widen2(uint32_t v) {
  const float2 f = fp8x2_float2<WT>(v);
  return __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632);
}

// Widen one stage's NB fp8 boxes (64 k rows of 64 bytes each, at src)
// into the bf16 B tile at dst: NB boxes of 64 rows x 128 bytes, 16-byte
// chunk c of row r at r * 128 + (c ^ (r % 8)) * 16 (the 128-byte swizzle
// TMA gives a bf16 box). Thread t of the THREADS consumer threads takes
// the 16-byte pieces t, t + THREADS, ...: piece i is box i / 256, row
// (i / 4) % 64, bytes 16 * (i % 4) of the row, whose 16 bf16 values are
// chunks 2 (i % 4) and 2 (i % 4) + 1 of the bf16 row. All of a thread's
// loads are issued before its conversions.
template <int WT, int NB, int THREADS>
__device__ __forceinline__ void widen_stage(uint32_t src, uint32_t dst, int t) {
  constexpr int PER = NB * 256 / THREADS;
  static_assert(NB * 256 % THREADS == 0, "widen_stage: whole pieces per thread");
  uint4 v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) v[j] = lds128(src + 16 * (t + j * THREADS));
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = t + j * THREADS;
    const int box = i / 256, r = (i / 4) % 64, q = i % 4;
    const uint4 lo = make_uint4(widen2<WT>(v[j].x), widen2<WT>(v[j].x >> 16),
                                widen2<WT>(v[j].y), widen2<WT>(v[j].y >> 16));
    const uint4 hi = make_uint4(widen2<WT>(v[j].z), widen2<WT>(v[j].z >> 16),
                                widen2<WT>(v[j].w), widen2<WT>(v[j].w >> 16));
    const uint32_t row = dst + box * B_BYTES + r * 128;
    sts128(row + ((2 * q) ^ (r % 8)) * 16, lo);
    sts128(row + ((2 * q + 1) ^ (r % 8)) * 16, hi);
  }
}

// A is always a 3-d map (slices, M, K), box (BK, BM, 1).
// REDUCE: grid (m tiles, column tiles, splits); the block sums its split's
//   share of the slice-major (slice, k tile) loop of A[s] @ W(s); out is
//   bf16 (M, N) or, with splits > 1, fp32 partials (splits, M, N).
// GATE_UP: grid (m tiles, column tiles, slices); b0 maps the gate bank, b1
//   the up bank; out is h (S, M, N) = bf16(silu(A @ Wg(s)) * (A @ Wu(s))).
// STACK: grid (m tiles, column tiles, slices x splits), z = s * splits +
//   split; the block sums its split's share of the k tiles of A @ W(s);
//   out is bf16 (S, M, N) or, with splits > 1, fp32 partials (splits, S,
//   M, N).
// GATE_UP and STACK read A[0] (a_slices 1: one activation shared by every
// slice) or A[s] (a_slices S: an activation per slice, the experts of the
// grouped kernels). valid (nullptr, or a byte per slice of the second
// bank): a slice marked 0 is padding; its producer issues no loads, and
// its block writes zeros.
template <int OP, int NB, int CW, int WT = W_SAME>
__global__ void __launch_bounds__(Tile<OP, NB, CW, WT>::THREADS, 1)
hopper_kernel(const __grid_constant__ CUtensorMap a_map,
              const __grid_constant__ CUtensorMap b0_local,
              const __grid_constant__ CUtensorMap b0_remote,
              const __grid_constant__ CUtensorMap b1_local,
              const __grid_constant__ CUtensorMap b1_remote, void* __restrict__ out,
              const unsigned char* __restrict__ valid, int n_local, int n_slices, int a_slices,
              int M, int N, int k_tiles, int stages, int splits) {
  using TL = Tile<OP, NB, CW, WT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      ring + ring_bytes(stages, TL::STAGE, TL::EPI_BYTES, TL::WIDE));
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * stages;

  const int m0 = blockIdx.x * TL::BM;
  const int n0 = blockIdx.y * TL::BN;
  int s = 0, split = 0;
  long it0, it1;
  if (OP == REDUCE) {
    const long total = (long)n_slices * k_tiles;
    it0 = blockIdx.z * total / splits;
    it1 = (blockIdx.z + 1) * total / splits;
  } else {
    s = OP == STACK ? (int)blockIdx.z / splits : (int)blockIdx.z;
    split = OP == STACK ? (int)blockIdx.z % splits : 0;
    it0 = (long)split * k_tiles / splits;
    it1 = (long)(split + 1) * k_tiles / splits;
    if (valid != nullptr && s >= n_local && valid[s - n_local] == 0) it1 = it0;  // padding
  }
  const int az = a_slices > 1 ? s : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, CW * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CW) {
    // ---- producer ------------------------------------------------------
    if constexpr (CW == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CW * 128) {
      int st = 0;
      uint32_t ph = 0;
      for (long it = it0; it < it1; ++it) {
        const int ss = OP == REDUCE ? (int)(it / k_tiles) : s;
        const int k = (OP == REDUCE ? (int)(it % k_tiles) : (int)it) * BK;
        const bool loc = ss < n_local;
        const int sb = loc ? ss : ss - n_local;
        mbar_wait(empty0 + 8 * st, ph ^ 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t a = ring_u32 + st * TL::STAGE;
        mbar_expect_tx(full, TL::STAGE);
        tma_3d(a, &a_map, full, k, m0, OP == REDUCE ? ss : az);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          tma_3d(a + TL::A_BYTES + j * TL::BOX, loc ? &b0_local : &b0_remote, full,
                 n0 + j * BOX_N, k, sb);
          if (OP == GATE_UP)
            tma_3d(a + TL::A_BYTES + (NB + j) * TL::BOX, loc ? &b1_local : &b1_remote, full,
                   n0 + j * BOX_N, k, sb);
        }
        if (++st == stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers -----------------------------------------------------
    // (one consumer warpgroup keeps its registers: 256 threads x 255 fit)
    if constexpr (CW == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    constexpr int R = TL::ACC;
    float acc0[R], acc1[OP == GATE_UP ? R : 1];
    zero(acc0);
    zero(acc1);
    int st = 0, prev = 0;
    uint32_t ph = 0;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    for (long it = it0; it < it1; ++it) {
      mbar_wait(full0 + 8 * st, ph);
      const uint32_t a = ring_u32 + st * TL::STAGE + wg * (64 * BK * 2);
      uint32_t b = ring_u32 + st * TL::STAGE + TL::A_BYTES;
      if constexpr (TL::FP8) {
        // widen the stage's fp8 boxes (gate_up: the gate boxes, then the
        // up boxes) into widened tile (it - it0) % 3, which the wgmma of
        // iteration it - 3 was the last to read
        const uint32_t wide = ring_u32 + stages * TL::STAGE +
                              (int)((it - it0) % WIDE_BUFS) * (TL::MATS * NB * B_BYTES);
        widen_stage<WT, TL::MATS * NB, CW * 128>(b, wide, threadIdx.x);
        fence_async_shared();
        bar_sync(1, CW * 128);
        b = wide;
      }
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = smem_desc(a + kk * 32, 16, 1024);
        wgmma_n<TL::BN>(acc0, da, smem_desc(b + kk * 2048, B_BYTES, 1024));
        if constexpr (OP == GATE_UP)
          wgmma_n<TL::BN>(acc1, da, smem_desc(b + NB * B_BYTES + kk * 2048, B_BYTES, 1024));
      }
      wgmma_commit();
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_wait<1>();  // the previous stage's group is done: release it
      if (it > it0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = st;
      if (++st == stages) {
        st = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);

    // ---- epilogue: the consumers stage the tile in the ring, idle once
    // every consumer warpgroup is past its last wgmma, then store it with
    // coalesced 16-byte writes (4-byte fragment stores straight to global
    // memory took ~10 % of a compute-bound launch). Fragment element i of
    // thread (warp, lane) is row warp*16 + lane/4 + 8*((i/2)%2), column
    // (i/4)*8 + 2*(lane%4) + i%2.
    bar_sync(1, CW * 128);
    fence_async_shared();
    const bool f32 = OP != GATE_UP && splits > 1;  // fp32 partials
    const int r0 = wg * 64 + warp * 16 + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < R; i += 2) {
      const int at = (r0 + 8 * ((i / 2) % 2)) * TL::EPI_LD + c0 + (i / 4) * 8;
      float v0 = acc0[i], v1 = acc0[i + 1];
      if constexpr (OP == GATE_UP) {
        v0 = silu_mul(v0, acc1[i]);
        v1 = silu_mul(v1, acc1[i + 1]);
      }
      if (f32)
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(ring) + at) = make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(ring) + at) =
            __floats2bfloat162_rn(v0, v1);
    }
    bar_sync(1, CW * 128);
    // element (row, col) of this tile's output matrix is base + row * N + col
    long base;
    if (OP == REDUCE) base = splits == 1 ? 0 : (long)blockIdx.z * M * N;
    else if (OP == GATE_UP) base = (long)s * M * N;
    else base = (splits == 1 ? (long)s : (long)split * n_slices + s) * M * N;
    const int v = f32 ? 4 : 8;  // elements of a 16-byte chunk; N % 8 == 0
    const int per_row = TL::BN / v;
    for (int idx = threadIdx.x; idx < TL::BM * per_row; idx += CW * 128) {
      const int r = idx / per_row, c = (idx % per_row) * v;
      if (m0 + r >= M || n0 + c >= N) continue;
      const long o = base + (long)(m0 + r) * N + n0 + c;
      const int at = r * TL::EPI_LD + c;
      if (f32)
        *reinterpret_cast<uint4*>(static_cast<float*>(out) + o) =
            *reinterpret_cast<const uint4*>(reinterpret_cast<const float*>(ring) + at);
      else
        *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) =
            *reinterpret_cast<const uint4*>(reinterpret_cast<const bf16*>(ring) + at);
    }
  }
}

// out (count elements, count % 4 == 0) = bf16(sum over splits of part), in split order.
__global__ void finish_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                                     int splits, long count) {
  const long i = 4 * ((long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= count) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int z = 1; z < splits; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(part + (long)z * count + i);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(s.x, s.y);
  *reinterpret_cast<__nv_bfloat162*>(out + i + 2) = __floats2bfloat162_rn(s.z, s.w);
}

// h (count = S*M*N elements) = bf16(silu(sum_z gate) * sum_z up), partials
// (splits, 2, S, M, N) summed in split order.
__global__ void finish_gate_up_kernel(const float* __restrict__ part, bf16* __restrict__ h,
                                      int splits, long count) {
  const long i = 2 * ((long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= count) return;
  float2 g = make_float2(0.f, 0.f), u = g;
  for (int z = 0; z < splits; ++z) {
    const float2 pg = *reinterpret_cast<const float2*>(part + (2L * z) * count + i);
    const float2 pu = *reinterpret_cast<const float2*>(part + (2L * z + 1) * count + i);
    g.x += pg.x;
    g.y += pg.y;
    u.x += pu.x;
    u.y += pu.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(h + i) =
      __floats2bfloat162_rn(silu_mul(g.x, u.x), silu_mul(g.y, u.y));
}

// ---------------------------------------------------------------------------
// Few-row path (at most FR_MAXM rows): grid (column blocks, [slices,] k
// splits). Lane l of every warp owns the VEC columns n0 + VEC l .. of a
// 16-byte load (8 bf16, or 16 fp8 widened in registers: FrW); warp w
// takes the k rows k0 + w, k0 + w + 8, ... of its split's chunk, several
// rows' 16-byte loads in flight at once.
// ---------------------------------------------------------------------------
constexpr int FR_THREADS = 256, FR_WARPS = 8, FR_COLS = 256, FR_MAXM = 2;
constexpr int FR_UNROLL = 4;    // gate_up: 2 matrices, 8 loads in flight per thread
constexpr int FR_UNROLL_R = 8;  // reduce: 8 loads in flight per thread

// The few-row kernels' view of a weight type: VEC columns per 16-byte
// load, COLS columns per block, ESZ bytes per weight.
template <int WT>
struct FrW {
  static constexpr int VEC = WT == W_SAME ? 8 : 16;
  static constexpr int COLS = 32 * VEC;
  static constexpr int ESZ = WT == W_SAME ? 2 : 1;
};

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// acc[m][j] += a[m] * w[j] over the VEC weights of one 16-byte load.
template <int WT>
__device__ __forceinline__ void fr_fma(float (&acc)[FR_MAXM][FrW<WT>::VEC], const uint4& w,
                                       const float (&a)[FR_MAXM]) {
  const uint32_t* q = reinterpret_cast<const uint32_t*>(&w);
#pragma unroll
  for (int v = 0; v < FrW<WT>::VEC / 2; ++v) {
    float2 f;
    if constexpr (WT == W_SAME)
      f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&w)[v]);
    else
      f = fp8x2_float2<WT>(q[v / 2] >> (16 * (v % 2)));
#pragma unroll
    for (int m = 0; m < FR_MAXM; ++m) {
      acc[m][2 * v] = fmaf(a[m], f.x, acc[m][2 * v]);
      acc[m][2 * v + 1] = fmaf(a[m], f.y, acc[m][2 * v + 1]);
    }
  }
}

// Sum the FR_WARPS warps' sums in warp order and store the rows < M of
// this block's columns (< N) at dst[nb] + m * N + n0 + col, 8 columns of
// every lane at a time (VEC / 8 rounds through red).
template <int NB, int VEC>
__device__ __forceinline__ void fr_store(float (&red)[FR_WARPS][NB][FR_MAXM][FR_COLS],
                                         const float (&acc)[NB][FR_MAXM][VEC], float* const* dst,
                                         int M, int N, int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < VEC / 8; ++h) {
    if (h) __syncthreads();  // the last round's sums have read red
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int m = 0; m < FR_MAXM; ++m)
#pragma unroll
        for (int v = 0; v < 8; ++v) red[warp][nb][m][lane * 8 + v] = acc[nb][m][8 * h + v];
    __syncthreads();
    for (int idx = threadIdx.x; idx < NB * FR_MAXM * FR_COLS; idx += FR_THREADS) {
      const int nb = idx / (FR_MAXM * FR_COLS), m = (idx / FR_COLS) % FR_MAXM, col = idx % FR_COLS;
      const int n = n0 + (col / 8) * VEC + 8 * h + col % 8;
      if (m >= M || n >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < FR_WARPS; ++w) s += red[w][nb][m][col];
      dst[nb][(long)m * N + n] = s;
    }
  }
}

// part (S * per_slice, M, N): block row y = s * per_slice + p sums the
// chunk p of slice s's k rows of A[s] @ W(s) (a chunk never crosses a
// slice, so the bank and A pointers are fixed per block).
template <int WT>
__global__ void __launch_bounds__(FR_THREADS)
fr_reduce_kernel(const bf16* __restrict__ A, const void* __restrict__ w_local,
                 const void* __restrict__ w_remote, float* __restrict__ part, int n_local, int M,
                 int Fs, int N, int chunk, int per_slice) {
  using W = FrW<WT>;
  __shared__ float red[FR_WARPS][1][FR_MAXM][FR_COLS];
  const int n0 = blockIdx.x * W::COLS, z = blockIdx.y;
  const int s = z / per_slice;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = (z - s * per_slice) * chunk, k1 = min(Fs, k0 + chunk);
  const int c = n0 + lane * W::VEC;
  const bool loc = s < n_local;
  const char* w = static_cast<const char*>(loc ? w_local : w_remote) +
                  ((long)(loc ? s : s - n_local) * Fs * N + c) * W::ESZ;
  const bf16* a_s = A + (long)s * M * Fs;
  float acc[1][FR_MAXM][W::VEC] = {};
  if (c < N) {
    for (int k = k0 + warp; k < k1; k += FR_WARPS * FR_UNROLL_R) {
      uint4 wv[FR_UNROLL_R];
      float a[FR_UNROLL_R][FR_MAXM];
#pragma unroll
      for (int u = 0; u < FR_UNROLL_R; ++u) {
        const int kk = k + u * FR_WARPS;
        wv[u] = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int m = 0; m < FR_MAXM; ++m) a[u][m] = 0.f;
        if (kk < k1) {
          wv[u] = ld_stream(w + (long)kk * N * W::ESZ);
#pragma unroll
          for (int m = 0; m < FR_MAXM; ++m)
            if (m < M) a[u][m] = __bfloat162float(a_s[(long)m * Fs + kk]);
        }
      }
#pragma unroll
      for (int u = 0; u < FR_UNROLL_R; ++u) fr_fma<WT>(acc[0], wv[u], a[u]);
    }
  }
  float* dst[1] = {part + (long)z * M * N};
  fr_store<1, W::VEC>(red, acc, dst, M, N, n0);
}

// part (ksplit, MATS, S, M, N): the split's k rows of x @ W0(s) and, for
// gate_up (MATS 2), of x @ W1(s); 8 loads in flight per thread either way.
template <int MATS, int WT>
__global__ void __launch_bounds__(FR_THREADS)
fr_slices_kernel(const bf16* __restrict__ x, const void* __restrict__ w0_local,
                 const void* __restrict__ w1_local, const void* __restrict__ w0_remote,
                 const void* __restrict__ w1_remote, float* __restrict__ part, int n_local,
                 int n_slices, int M, int K, int N, int chunk) {
  using W = FrW<WT>;
  constexpr int U = MATS == 2 ? FR_UNROLL : FR_UNROLL_R;
  __shared__ float red[FR_WARPS][MATS][FR_MAXM][FR_COLS];
  const int n0 = blockIdx.x * W::COLS, s = blockIdx.y, z = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = z * chunk, k1 = min(K, k0 + chunk);
  const int c = n0 + lane * W::VEC;
  const bool loc = s < n_local;
  const long off = ((long)(loc ? s : s - n_local) * K * N + c) * W::ESZ;
  const char* w[2] = {static_cast<const char*>(loc ? w0_local : w0_remote) + off,
                      MATS == 2 ? static_cast<const char*>(loc ? w1_local : w1_remote) + off
                                : nullptr};
  float acc[MATS][FR_MAXM][W::VEC] = {};
  if (c < N) {
    for (int k = k0 + warp; k < k1; k += FR_WARPS * U) {
      uint4 wv[MATS][U];
      float a[U][FR_MAXM];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = k + u * FR_WARPS;
#pragma unroll
        for (int j = 0; j < MATS; ++j) wv[j][u] = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int m = 0; m < FR_MAXM; ++m) a[u][m] = 0.f;
        if (kk < k1) {
#pragma unroll
          for (int j = 0; j < MATS; ++j) wv[j][u] = ld_stream(w[j] + (long)kk * N * W::ESZ);
#pragma unroll
          for (int m = 0; m < FR_MAXM; ++m)
            if (m < M) a[u][m] = __bfloat162float(x[(long)m * K + kk]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < MATS; ++j) fr_fma<WT>(acc[j], wv[j][u], a[u]);
    }
  }
  const long plane = (long)n_slices * M * N;
  float* dst[MATS];
#pragma unroll
  for (int j = 0; j < MATS; ++j) dst[j] = part + ((long)MATS * z + j) * plane + (long)s * M * N;
  fr_store<MATS, W::VEC>(red, acc, dst, M, N, n0);
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------
// Maps of a (S_b, K, N) bank: 64 x 64 boxes (bf16, 128-byte swizzle; or
// fp8, ``bytes1``: 64-byte rows, no swizzle).
inline int bank_map(CUtensorMap* map, const void* w, int n_banks, int K, int N,
                    bool bytes1 = false) {
  const uint64_t dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)n_banks};
  const uint32_t box[3] = {BOX_N, BK, 1};
  return make_map(map, w, 3, dims, box, bytes1);
}

// Map of an activation (slices, M, K): (BK, bm, 1) boxes. TMA zero-fills
// the rows past M, so a ragged tile never reads the next slice's rows.
inline int act_map(CUtensorMap* map, const void* A, int slices, int M, int K, int bm) {
  const uint64_t dims[3] = {(uint64_t)K, (uint64_t)M, (uint64_t)slices};
  const uint32_t box[3] = {BK, (uint32_t)bm, 1};
  return make_map(map, A, 3, dims, box);
}

// A launch plan, as the wrappers pass it (dense.py Plan.ints()): the path,
// the block tile (BM, BN) of the Hopper path, ring stages, k splits, and
// the few-row path's k chunk.
struct Plan {
  int path, bm, bn, stages, splits, chunk;
};

// The arguments of hopper_kernel beside its maps.
struct Args {
  void* out;
  const unsigned char* valid;
  int n_local, n_slices, a_slices, M, N, k_tiles, stages, splits;
};

template <int OP, int NB, int CW, int WT = W_SAME>
inline int hopper_launch(const CUtensorMap& a, const CUtensorMap& b0l, const CUtensorMap& b0r,
                         const CUtensorMap& b1l, const CUtensorMap& b1r, const Args& g,
                         cudaStream_t st) {
  using TL = Tile<OP, NB, CW, WT>;
  const size_t smem = smem_bytes(g.stages, TL::STAGE, TL::EPI_BYTES, TL::WIDE);
  // at least 2 stages: a stage is released one stage late
  if (g.stages < 2 || smem > MAX_SMEM || g.splits < 1) return (int)cudaErrorInvalidValue;
  // Set on every launch: a function-local "done" flag of an inline template
  // is one symbol for every library that includes this header, and each
  // library has its own kernel to set it on.
  const int err = (int)cudaFuncSetAttribute(
      hopper_kernel<OP, NB, CW, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return ATTR_ERROR + err;
  const unsigned z = OP == REDUCE ? g.splits : OP == STACK ? g.n_slices * g.splits : g.n_slices;
  dim3 grid(cdiv(g.M, TL::BM), cdiv(g.N, TL::BN), z);
  hopper_kernel<OP, NB, CW, WT><<<grid, TL::THREADS, smem, st>>>(
      a, b0l, b0r, b1l, b1r, g.out, g.valid, g.n_local, g.n_slices, g.a_slices, g.M, g.N,
      g.k_tiles, g.stages, g.splits);
  return (int)cudaGetLastError();
}

// The block tiles (BM, BN) each op is built for (dense.py HOPPER_TILES),
// with banks of weight type WT.
template <int OP, int WT>
inline int hopper_tiled(int bm, int bn, const CUtensorMap& a, const CUtensorMap& b0l,
                        const CUtensorMap& b0r, const CUtensorMap& b1l, const CUtensorMap& b1r,
                        const Args& g, cudaStream_t st) {
  if constexpr (OP == REDUCE) {
    if (bm == 128 && bn == 256) return hopper_launch<OP, 4, 2, WT>(a, b0l, b0r, b1l, b1r, g, st);
  } else if constexpr (OP == GATE_UP) {
    if (bm == 128 && bn == 128) return hopper_launch<OP, 2, 2, WT>(a, b0l, b0r, b1l, b1r, g, st);
    if (bm == 64 && bn == 128) return hopper_launch<OP, 2, 1, WT>(a, b0l, b0r, b1l, b1r, g, st);
  } else {
    if (bm == 128 && bn == 256) return hopper_launch<OP, 4, 2, WT>(a, b0l, b0r, b1l, b1r, g, st);
    if (bm == 128 && bn == 128) return hopper_launch<OP, 2, 2, WT>(a, b0l, b0r, b1l, b1r, g, st);
    if (bm == 64 && bn == 256) return hopper_launch<OP, 4, 1, WT>(a, b0l, b0r, b1l, b1r, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

inline int finish_reduce(const float* part, void* out, int splits, long count, cudaStream_t st) {
  finish_reduce_kernel<<<cdiv(count / 4, 256), 256, 0, st>>>(part, (bf16*)out, splits, count);
  return (int)cudaGetLastError();
}

// out (M, N) = sum_s A[s] @ W(s): A (S, M, K) bf16, banks (S_l, K, N) /
// (S - S_l, K, N) of weight type WT (fp8: N a multiple of 16, the banks'
// 16-byte row stride). scratch: fp32 partials when splits > 1.
template <int WT>
inline int launch_reduce(const void* A, const void* wl, const void* wr, void* out, float* scratch,
                         int n_local, int n_slices, int M, int K, int N, const Plan& p,
                         cudaStream_t st) {
  if (M == 0 || N == 0) return 0;
  if (WT != W_SAME && N % 16) return (int)cudaErrorInvalidValue;
  if (p.path == PATH_FEW_ROW) {
    if (M > FR_MAXM) return (int)cudaErrorInvalidValue;
    const int per_slice = cdiv(K, p.chunk);  // splits == n_slices * per_slice
    if (p.chunk < 1 || p.splits != n_slices * per_slice) return (int)cudaErrorInvalidValue;
    dim3 grid(cdiv(N, FrW<WT>::COLS), p.splits);
    fr_reduce_kernel<WT><<<grid, FR_THREADS, 0, st>>>((const bf16*)A, wl, wr, scratch, n_local,
                                                      M, K, N, p.chunk, per_slice);
    const int err = (int)cudaGetLastError();
    return err ? err : finish_reduce(scratch, out, p.splits, (long)M * N, st);
  }
  if (p.path != PATH_HOPPER) return (int)cudaErrorInvalidValue;
  CUtensorMap a, bl, br;
  int err = act_map(&a, A, n_slices, M, K, p.bm);
  if (!err) err = bank_map(&bl, wl, n_local, K, N, WT != W_SAME);
  if (!err) err = bank_map(&br, wr, n_slices - n_local, K, N, WT != W_SAME);
  if (err) return err;
  const Args g{p.splits == 1 ? out : (void*)scratch, nullptr, n_local, n_slices, n_slices, M, N,
               (int)cdiv(K, BK), p.stages, p.splits};
  err = hopper_tiled<REDUCE, WT>(p.bm, p.bn, a, bl, br, bl, br, g, st);
  if (err || p.splits == 1) return err;
  return finish_reduce(scratch, out, p.splits, (long)M * N, st);
}

// Per slice s < S: GATE_UP h[s] (M, N) = bf16(silu(A @ Wg(s)) * (A @ Wu(s)))
// (b0 the gate banks, b1 the up banks); STACK out[s] (M, N) = A @ W(s) (b0
// the banks, b1 unused). A is (M, K), shared by every slice (a_slices 1),
// or (S, M, K), one per slice (a_slices S: the grouped kernels' experts).
// Banks (S_l, K, N) / (S - S_l, K, N) of weight type WT (fp8: N a
// multiple of 16). scratch: fp32 partials (few-row path, split k). valid:
// see hopper_kernel (Hopper path only).
template <int OP, int WT>
inline int launch_slices(const void* A, int a_slices, const void* b0l, const void* b1l,
                         const void* b0r, const void* b1r, void* out, float* scratch,
                         const unsigned char* valid, int n_local, int n_slices, int M, int K,
                         int N, const Plan& p, cudaStream_t st) {
  static_assert(OP == GATE_UP || OP == STACK, "launch_slices: gate_up or stack");
  if (M == 0 || N == 0 || n_slices == 0) return 0;
  const long count = (long)n_slices * M * N;
  if (a_slices != 1 && a_slices != n_slices) return (int)cudaErrorInvalidValue;
  if (WT != W_SAME && N % 16) return (int)cudaErrorInvalidValue;
  if (p.path == PATH_FEW_ROW) {
    // one activation for every slice, every slice real
    if (M > FR_MAXM || a_slices != 1 || valid != nullptr || p.chunk < 1 ||
        p.splits != (int)cdiv(K, p.chunk))
      return (int)cudaErrorInvalidValue;
    dim3 grid(cdiv(N, FrW<WT>::COLS), n_slices, p.splits);
    fr_slices_kernel<OP == GATE_UP ? 2 : 1, WT><<<grid, FR_THREADS, 0, st>>>(
        (const bf16*)A, b0l, b1l, b0r, b1r, scratch, n_local, n_slices, M, K, N, p.chunk);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    if (OP == STACK) return finish_reduce(scratch, out, p.splits, count, st);
    finish_gate_up_kernel<<<cdiv(count / 2, 256), 256, 0, st>>>(scratch, (bf16*)out, p.splits,
                                                                count);
    return (int)cudaGetLastError();
  }
  if (p.path != PATH_HOPPER || (OP == GATE_UP && p.splits != 1)) return (int)cudaErrorInvalidValue;
  CUtensorMap a, m0l, m0r, m1l, m1r;
  int err = act_map(&a, A, a_slices, M, K, p.bm);
  constexpr bool b8 = WT != W_SAME;
  if (!err) err = bank_map(&m0l, b0l, n_local, K, N, b8);
  if (!err) err = bank_map(&m0r, b0r, n_slices - n_local, K, N, b8);
  if (OP == GATE_UP) {
    if (!err) err = bank_map(&m1l, b1l, n_local, K, N, b8);
    if (!err) err = bank_map(&m1r, b1r, n_slices - n_local, K, N, b8);
  } else {
    m1l = m0l;
    m1r = m0r;
  }
  if (err) return err;
  const Args g{p.splits == 1 ? out : (void*)scratch, valid, n_local, n_slices, a_slices, M, N,
               (int)cdiv(K, BK), p.stages, p.splits};
  err = hopper_tiled<OP, WT>(p.bm, p.bn, a, m0l, m0r, m1l, m1r, g, st);
  if (err || p.splits == 1) return err;
  return finish_reduce(scratch, out, p.splits, count, st);
}

// The grouped SwiGLU (kernels #2 and #3) on the Hopper path: x (E, C, D),
// gate/up banks (E_l, D, F) / (E - E_l, D, F), down banks (E_l, F, D) /
// (E - E_l, F, D). Launch 1 (GATE_UP, A per expert) writes h (E, C, F);
// launch 2 (STACK, A per expert) writes out (E, C, D). Every weight byte is
// streamed once per m tile; at C <= BM all of an expert's rows sit in one.
// The banks are of weight type WT (fp8: D and F multiples of 16); h is
// bf16 either way.
template <int WT>
inline int launch_grouped_swiglu(const void* x, const void* gl, const void* ul, const void* dl,
                                 const void* gr, const void* ur, const void* dr, void* h,
                                 void* out, const unsigned char* valid, int n_local, int E,
                                 int C, int D, int F, const Plan& gu, const Plan& dn,
                                 cudaStream_t st) {
  if (gu.path != PATH_HOPPER || dn.path != PATH_HOPPER || dn.splits != 1)
    return (int)cudaErrorInvalidValue;
  const int err = launch_slices<GATE_UP, WT>(x, E, gl, ul, gr, ur, h, nullptr, valid, n_local, E,
                                             C, D, F, gu, st);
  if (err) return err;
  return launch_slices<STACK, WT>(h, E, dl, nullptr, dr, nullptr, out, nullptr, valid, n_local,
                                  E, C, F, D, dn, st);
}

// Kernel #1 on the Hopper path: out[e] (C, F) = x[e] (C, D) @ W(e), x (E,
// C, D) bf16, banks (E_l, D, F) / (E - E_l, D, F) in bf16 (WT W_SAME) or
// fp8 (W_E4M3, W_E5M2, widened on the chip; F a multiple of 16 for the
// banks' 16-byte row stride): op STACK with the activation read per
// expert (#2's down launch), BM 64 or 128, BN 256 (BN 128 lost at C 1, 16
// and 88 in bf16 and fp8: PERF.md), no split.
// (A template, instantiated by split_grouped_gemm.cu alone: a kernel named
// in an inline function of this header is compiled into every library.)
template <int WT>
inline int launch_gemm(const void* x, const void* wl, const void* wr, void* out, int n_local,
                       int E, int C, int D, int F, const Plan& p, cudaStream_t st) {
  if (C == 0 || F == 0 || E == 0) return 0;
  if (p.path != PATH_HOPPER || p.splits != 1) return (int)cudaErrorInvalidValue;
  CUtensorMap a, bl, br;
  int err = act_map(&a, x, E, C, D, p.bm);
  if (!err) err = bank_map(&bl, wl, n_local, D, F, WT != W_SAME);
  if (!err) err = bank_map(&br, wr, E - n_local, D, F, WT != W_SAME);
  if (err) return err;
  const Args g{out, nullptr, n_local, E, E, C, F, (int)cdiv(D, BK), p.stages, 1};
  if (p.bm == 128 && p.bn == 256) return hopper_launch<STACK, 4, 2, WT>(a, bl, br, bl, br, g, st);
  if (p.bm == 64 && p.bn == 256) return hopper_launch<STACK, 4, 1, WT>(a, bl, br, bl, br, g, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Single-tile check of the prefill path's building blocks: out (64 x 64,
// fp32) = A (64 x K) @ B (K x 64), K <= 64, through one TMA load of each
// operand (the main path's boxes and swizzle, zero-filled past K) and four
// wgmma m64n64k16 steps on the same descriptors. tests/test_torch_cuda.py
// and chip_smoke.py hold it against a plain product.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128)
tile_check_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map, float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t a = smem_u32(tiles), b = a + 64 * BK * 2;
  const uint32_t bar = smem_u32(tiles + 64 * BK * 2 + B_BYTES);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 64 * BK * 2 + B_BYTES);
    tma_2d(a, &a_map, bar, 0, 0);
    tma_3d(b, &b_map, bar, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float acc[32];
  zero(acc);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n64(acc, smem_desc(a + kk * 32, 16, 1024), smem_desc(b + kk * 2048, B_BYTES, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    out[(warp * 16 + lane / 4 + 8 * ((i / 2) % 2)) * 64 + (i / 4) * 8 + 2 * (lane % 4) + i % 2] =
        acc[i];
}

inline int tile_check(const void* A, const void* B, float* out, int K, cudaStream_t st) {
  if (K < 1 || K > BK) return (int)cudaErrorInvalidValue;
  CUtensorMap a, b;
  const uint64_t adims[2] = {(uint64_t)K, 64};
  const uint32_t abox[2] = {BK, 64};
  int err = make_map(&a, A, 2, adims, abox);
  if (!err) err = bank_map(&b, B, 1, K, 64);
  if (err) return err;
  tile_check_kernel<<<1, 128, 1024 + 64 * BK * 2 + B_BYTES + 8, st>>>(a, b, out);
  return (int)cudaGetLastError();
}

}  // namespace split_hopper
