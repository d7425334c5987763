// Shared tile machinery of the split-bank kernels (sm_90a).
//
// Every split kernel of the port is built from three block-level GEMM
// shapes over a (local bank, remote bank) pair of weight stacks:
//
//   grouped_kernel  out[g] = A[g] @ W(g)                 (one group per z)
//   gate_up_kernel  h[g]   = silu(A[g] @ Wg(g)) * (A[g] @ Wu(g))
//   reduce_kernel   out    = sum_s A[s] @ W(s)           (slices looped in order)
//
// W(g) is read from the LOCAL bank for g < n_local and from the REMOTE
// bank otherwise: the bank is selected by pointer once per block, so only
// the selected bank is ever read (an empty bank is never touched).
//
// Design, for this card: at the token counts of serving (2 decode rows,
// 16-slot expert batches, 256-token prefill shards) every call is bound
// by the weight bytes it streams, so a block keeps a (BK x BN) weight
// tile in shared memory, loads it with 16-byte vector loads (coalesced,
// read once per block), and each thread accumulates a (TM x TN) fp32
// micro-tile with FMAs (fp32), or each warp runs mma.sync on the tensor
// cores (bf16). With at most two rows (decode) a tile would waste its
// work on padding rows, so those calls take a few-row path that streams
// the weight rows straight into registers (below). Sums run in a
// fixed order (k ascending, slices ascending, partials in index order)
// with no atomics, so every result is deterministic. wgmma, TMA and
// multi-stage pipelining are later work.
//
// The grouped and gate/up kernels take an optional ``valid`` vector (one
// byte per expert of the second bank; nullptr: every expert is real).
// The demand kernel passes it: a padding row of its budget-padded fetched
// bank reads no weights, its accumulators stay zero and its output block
// is written as zeros. Every other expert runs exactly the code it runs
// without the vector, so its result is bitwise the same.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace split_tile {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int TX = BN / TN;  // threads along N
  static constexpr int TY = BM / TM;  // threads along M
  static constexpr int THREADS = TX * TY;
};
// <= 16 rows (decode rows, expert capacity slots): one row per thread.
using Small = Cfg<16, 64, 64, 1, 4>;
// more rows (prefill shards): a 4 x 4 micro-tile per thread.
using Large = Cfg<64, 64, 32, 4, 4>;

template <typename T>
struct Vec { static constexpr int N = 16 / sizeof(T); };

// Shared-memory tiles; rows padded by 16 bytes against bank conflicts
// (keeps every row 16-byte aligned for the vector stores).
template <typename T, class C, int NB>
struct Smem {
  static constexpr int PAD = Vec<T>::N;
  T a[C::BM][C::BK + PAD];
  T b[NB][C::BK][C::BN + PAD];
};

// True for an expert of the second bank that ``valid`` marks as padding.
__device__ __forceinline__ bool skip_expert(const unsigned char* valid, int g, int n_local) {
  return valid != nullptr && g >= n_local && valid[g - n_local] == 0;
}

__device__ __forceinline__ bool aligned16(const void* p, long ld, int vec) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (ld % vec == 0);
}

// Copy the (R x CC) tile at (r0, c0) of the row-major (nr x nc) matrix g
// (leading dimension ld) into s, zero-filling outside the matrix.
template <typename T, int R, int CC, int LDS, int NT>
__device__ __forceinline__ void load_tile(T (*s)[LDS], const T* __restrict__ g, long ld,
                                          int nr, int nc, int r0, int c0, bool vec_ok) {
  constexpr int V = Vec<T>::N;
  constexpr int CV = CC / V;
  for (int idx = threadIdx.x; idx < R * CV; idx += NT) {
    const int r = idx / CV;
    const int c = (idx % CV) * V;
    const int gr = r0 + r;
    const int gc = c0 + c;
    if (vec_ok && gr < nr && gc + V <= nc) {
      *reinterpret_cast<uint4*>(&s[r][c]) =
          __ldg(reinterpret_cast<const uint4*>(g + (long)gr * ld + gc));
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        s[r][c + v] = (gr < nr && gc + v < nc) ? g[(long)gr * ld + gc + v] : from_f<T>(0.f);
    }
  }
}

// acc[nb] += A[m0:m0+BM, :K] @ B[nb][:K, n0:n0+BN] for NB weight matrices
// sharing one activation tile. A is (M x K), each B is (K x N), row-major.
template <typename T, class C, int NB>
__device__ __forceinline__ void gemm_tile(Smem<T, C, NB>& sm, const T* __restrict__ A, long lda,
                                          const T* const* B, long ldb, int M, int N, int K,
                                          int m0, int n0, float (&acc)[NB][C::TM][C::TN]) {
  constexpr int V = Vec<T>::N;
  const int tx = threadIdx.x % C::TX;
  const int ty = threadIdx.x / C::TX;
  const bool a_vec = aligned16(A, lda, V);
  bool b_vec[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) b_vec[nb] = aligned16(B[nb], ldb, V);

  for (int k0 = 0; k0 < K; k0 += C::BK) {
    load_tile<T, C::BM, C::BK, C::BK + Smem<T, C, NB>::PAD, C::THREADS>(sm.a, A, lda, M, K, m0,
                                                                        k0, a_vec);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      load_tile<T, C::BK, C::BN, C::BN + Smem<T, C, NB>::PAD, C::THREADS>(
          sm.b[nb], B[nb], ldb, K, N, k0, n0, b_vec[nb]);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < C::BK; ++kk) {
      float a[C::TM];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) a[i] = to_f(sm.a[ty * C::TM + i][kk]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < C::TN; ++j) {
          const float b = to_f(sm.b[nb][kk][tx + j * C::TX]);
#pragma unroll
          for (int i = 0; i < C::TM; ++i) acc[nb][i][j] = fmaf(a[i], b, acc[nb][i][j]);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, class C, int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][C::TM][C::TN]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) acc[nb][i][j] = 0.f;
}

// out[g] (M x N) = A[g] (M x K) @ W(g) (K x N); A[g] = A + g * a_stride
// (a_stride 0: one activation shared by every group).
template <typename T, class C>
__global__ void __launch_bounds__(C::THREADS)
grouped_kernel(const T* __restrict__ A, long a_stride, const T* __restrict__ w_local,
               const T* __restrict__ w_remote, T* __restrict__ out, int n_local, int M, int K,
               int N, const unsigned char* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<T, C, 1>*>(smem_raw);
  const int g = blockIdx.z;
  const long wsz = (long)K * N;
  const T* w = g < n_local ? w_local + g * wsz : w_remote + (g - n_local) * wsz;
  const T* B[1] = {w};
  float acc[1][C::TM][C::TN];
  zero_acc<T, C, 1>(acc);
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  if (!skip_expert(valid, g, n_local))
    gemm_tile<T, C, 1>(sm, A + g * a_stride, K, B, N, M, N, K, m0, n0, acc);
  T* o = out + (long)g * M * N;
  const int tx = threadIdx.x % C::TX, ty = threadIdx.x / C::TX;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = m0 + ty * C::TM + i;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int c = n0 + tx + j * C::TX;
      if (r < M && c < N) o[(long)r * N + c] = from_f<T>(acc[0][i][j]);
    }
  }
}

// h[g] (M x N) = silu(A[g] @ Wg(g)) * (A[g] @ Wu(g)), computed on the fp32
// accumulators and rounded once to the activation type.
template <typename T, class C>
__global__ void __launch_bounds__(C::THREADS)
gate_up_kernel(const T* __restrict__ A, long a_stride, const T* __restrict__ g_local,
               const T* __restrict__ u_local, const T* __restrict__ g_remote,
               const T* __restrict__ u_remote, T* __restrict__ h, int n_local, int M, int K,
               int N, const unsigned char* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<T, C, 2>*>(smem_raw);
  const int g = blockIdx.z;
  const long wsz = (long)K * N;
  const bool local = g < n_local;
  const long off = (local ? g : g - n_local) * wsz;
  const T* B[2] = {(local ? g_local : g_remote) + off, (local ? u_local : u_remote) + off};
  float acc[2][C::TM][C::TN];
  zero_acc<T, C, 2>(acc);
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  if (!skip_expert(valid, g, n_local))
    gemm_tile<T, C, 2>(sm, A + g * a_stride, K, B, N, M, N, K, m0, n0, acc);
  T* o = h + (long)g * M * N;
  const int tx = threadIdx.x % C::TX, ty = threadIdx.x / C::TX;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = m0 + ty * C::TM + i;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int c = n0 + tx + j * C::TX;
      if (r < M && c < N) {
        const float gv = acc[0][i][j];
        const float silu = gv / (1.f + __expf(-gv));
        o[(long)r * N + c] = from_f<T>(silu * acc[1][i][j]);
      }
    }
  }
}

// out (M x N) = sum_{s < S} A[s] (M x K) @ W(s) (K x N), slices in order,
// one fp32 accumulator per output element across all slices.
template <typename T, class C>
__global__ void __launch_bounds__(C::THREADS)
reduce_kernel(const T* __restrict__ A, const T* __restrict__ w_local,
              const T* __restrict__ w_remote, T* __restrict__ out, int n_local, int n_slices,
              int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<T, C, 1>*>(smem_raw);
  const long wsz = (long)K * N;
  float acc[1][C::TM][C::TN];
  zero_acc<T, C, 1>(acc);
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  for (int s = 0; s < n_slices; ++s) {
    const T* B[1] = {s < n_local ? w_local + s * wsz : w_remote + (s - n_local) * wsz};
    gemm_tile<T, C, 1>(sm, A + (long)s * M * K, K, B, N, M, N, K, m0, n0, acc);
  }
  const int tx = threadIdx.x % C::TX, ty = threadIdx.x / C::TX;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = m0 + ty * C::TM + i;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int c = n0 + tx + j * C::TX;
      if (r < M && c < N) out[(long)r * N + c] = from_f<T>(acc[0][i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Few-row path (M <= GV_MAXM: decode rows, one expert slot). A tile GEMM
// would spend most of its FMAs on padding rows, so here each thread owns
// 16 bytes of one weight row (V consecutive columns), streams the rows
// k = kp, kp + KP, ... straight from device memory (no shared-memory
// staging of the weights), and keeps M x V fp32 sums per weight matrix.
// The KP partial sums of a column are then added in a fixed order through
// shared memory, so the result stays deterministic.
// ---------------------------------------------------------------------------
constexpr int GV_MAXM = 2;
constexpr int GV_BN = 64;        // output columns per block
constexpr int GV_THREADS = 256;

template <typename T>
struct Gv {
  static constexpr int V = Vec<T>::N;          // columns per thread
  static constexpr int TX = GV_BN / V;         // threads along N
  static constexpr int KP = GV_THREADS / TX;   // k partitions
};

template <typename T, int NB>
__device__ __forceinline__ void gv_accum(const T* __restrict__ A, long lda,
                                         const T* const* B, long ldb, int M, int N, int K,
                                         int n0, float (&acc)[NB][GV_MAXM][Vec<T>::N]) {
  constexpr int V = Gv<T>::V;
  const int tx = threadIdx.x % Gv<T>::TX;
  const int kp = threadIdx.x / Gv<T>::TX;
  const int c = n0 + tx * V;
  bool vec[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) vec[nb] = aligned16(B[nb], ldb, V) && c + V <= N;
#pragma unroll 4
  for (int k = kp; k < K; k += Gv<T>::KP) {
    float a[GV_MAXM];
#pragma unroll
    for (int m = 0; m < GV_MAXM; ++m) a[m] = m < M ? to_f(A[(long)m * lda + k]) : 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const T* row = B[nb] + (long)k * ldb + c;
      uint4 u;
      T* w = reinterpret_cast<T*>(&u);
      if (vec[nb]) {
        u = __ldg(reinterpret_cast<const uint4*>(row));
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) w[v] = c + v < N ? row[v] : from_f<T>(0.f);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float b = to_f(w[v]);
#pragma unroll
        for (int m = 0; m < GV_MAXM; ++m) acc[nb][m][v] = fmaf(a[m], b, acc[nb][m][v]);
      }
    }
  }
}

template <typename T, int NB>
struct GvSmem {
  float red[Gv<T>::KP][NB][GV_MAXM][GV_BN];
};

// Sum the KP partials of every (m, column) in k-partition order; thread
// t < GV_MAXM * GV_BN then holds the totals of row t / GV_BN, column
// n0 + t % GV_BN in out[nb].
template <typename T, int NB>
__device__ __forceinline__ void gv_reduce(GvSmem<T, NB>& sm,
                                          const float (&acc)[NB][GV_MAXM][Vec<T>::N],
                                          float (&out)[NB]) {
  constexpr int V = Gv<T>::V;
  const int tx = threadIdx.x % Gv<T>::TX;
  const int kp = threadIdx.x / Gv<T>::TX;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int m = 0; m < GV_MAXM; ++m)
#pragma unroll
      for (int v = 0; v < V; ++v) sm.red[kp][nb][m][tx * V + v] = acc[nb][m][v];
  __syncthreads();
  if (threadIdx.x < GV_MAXM * GV_BN) {
    const int m = threadIdx.x / GV_BN, col = threadIdx.x % GV_BN;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float s = 0.f;
      for (int p = 0; p < Gv<T>::KP; ++p) s += sm.red[p][nb][m][col];
      out[nb] = s;
    }
  }
}

template <typename T, int NB>
__device__ __forceinline__ void gv_zero(float (&acc)[NB][GV_MAXM][Vec<T>::N]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int m = 0; m < GV_MAXM; ++m)
#pragma unroll
      for (int v = 0; v < Vec<T>::N; ++v) acc[nb][m][v] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(GV_THREADS)
gv_grouped_kernel(const T* __restrict__ A, long a_stride, const T* __restrict__ w_local,
                  const T* __restrict__ w_remote, T* __restrict__ out, int n_local, int M, int K,
                  int N, const unsigned char* __restrict__ valid) {
  __shared__ GvSmem<T, 1> sm;
  const int g = blockIdx.z;
  const long wsz = (long)K * N;
  const T* B[1] = {g < n_local ? w_local + g * wsz : w_remote + (g - n_local) * wsz};
  float acc[1][GV_MAXM][Vec<T>::N];
  gv_zero<T, 1>(acc);
  const int n0 = blockIdx.x * GV_BN;
  if (!skip_expert(valid, g, n_local)) gv_accum<T, 1>(A + g * a_stride, K, B, N, M, N, K, n0, acc);
  float tot[1];
  gv_reduce<T, 1>(sm, acc, tot);
  const int m = threadIdx.x / GV_BN, c = n0 + threadIdx.x % GV_BN;
  if (threadIdx.x < GV_MAXM * GV_BN && m < M && c < N)
    out[(long)g * M * N + (long)m * N + c] = from_f<T>(tot[0]);
}

template <typename T>
__global__ void __launch_bounds__(GV_THREADS)
gv_gate_up_kernel(const T* __restrict__ A, long a_stride, const T* __restrict__ g_local,
                  const T* __restrict__ u_local, const T* __restrict__ g_remote,
                  const T* __restrict__ u_remote, T* __restrict__ h, int n_local, int M, int K,
                  int N, const unsigned char* __restrict__ valid) {
  __shared__ GvSmem<T, 2> sm;
  const int g = blockIdx.z;
  const long wsz = (long)K * N;
  const bool local = g < n_local;
  const long off = (local ? g : g - n_local) * wsz;
  const T* B[2] = {(local ? g_local : g_remote) + off, (local ? u_local : u_remote) + off};
  float acc[2][GV_MAXM][Vec<T>::N];
  gv_zero<T, 2>(acc);
  const int n0 = blockIdx.x * GV_BN;
  if (!skip_expert(valid, g, n_local)) gv_accum<T, 2>(A + g * a_stride, K, B, N, M, N, K, n0, acc);
  float tot[2];
  gv_reduce<T, 2>(sm, acc, tot);
  const int m = threadIdx.x / GV_BN, c = n0 + threadIdx.x % GV_BN;
  if (threadIdx.x < GV_MAXM * GV_BN && m < M && c < N) {
    const float silu = tot[0] / (1.f + __expf(-tot[0]));
    h[(long)g * M * N + (long)m * N + c] = from_f<T>(silu * tot[1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(GV_THREADS)
gv_reduce_kernel(const T* __restrict__ A, const T* __restrict__ w_local,
                 const T* __restrict__ w_remote, T* __restrict__ out, int n_local, int n_slices,
                 int M, int K, int N) {
  __shared__ GvSmem<T, 1> sm;
  const long wsz = (long)K * N;
  float acc[1][GV_MAXM][Vec<T>::N];
  gv_zero<T, 1>(acc);
  const int n0 = blockIdx.x * GV_BN;
  for (int s = 0; s < n_slices; ++s) {
    const T* B[1] = {s < n_local ? w_local + s * wsz : w_remote + (s - n_local) * wsz};
    gv_accum<T, 1>(A + (long)s * M * K, K, B, N, M, N, K, n0, acc);
  }
  float tot[1];
  gv_reduce<T, 1>(sm, acc, tot);
  const int m = threadIdx.x / GV_BN, c = n0 + threadIdx.x % GV_BN;
  if (threadIdx.x < GV_MAXM * GV_BN && m < M && c < N) out[(long)m * N + c] = from_f<T>(tot[0]);
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16, more than GV_MAXM rows: prefill shards, expert
// capacity slots): warp-level mma.sync m16n8k16 with fp32 accumulators on
// the same shared-memory tiles. Each warp owns a (WM*16 x WN*8) piece of
// the block's output tile; the k order inside an mma is fixed by the
// hardware, so results stay deterministic.
// ---------------------------------------------------------------------------
template <int WARPS_M_, int WARPS_N_, int WM_, int WN_>
struct MCfg {
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, WM = WM_, WN = WN_;
  static constexpr int BM = WARPS_M * WM * 16, BN = WARPS_N * WN * 8, BK = 32;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
};
using MSmall = MCfg<1, 4, 1, 4>;  // 16 x 128 tile: up to 16 rows
using MLarge = MCfg<2, 2, 2, 4>;  // 64 x 64 tile

template <class C, int NB>
struct MSmem {
  static constexpr int PAD = 8;
  __nv_bfloat16 a[C::BM][C::BK + PAD];
  __nv_bfloat16 b[NB][C::BK][C::BN + PAD];
};

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class C, int NB>
__device__ __forceinline__ void mma_zero(float (&acc)[NB][C::WM][C::WN][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < C::WM; ++i)
#pragma unroll
      for (int j = 0; j < C::WN; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nb][i][j][r] = 0.f;
}

// acc[nb] += A[m0:m0+BM, :K] @ B[nb][:K, n0:n0+BN] on the tensor cores.
template <class C, int NB>
__device__ __forceinline__ void mma_tile(MSmem<C, NB>& sm, const __nv_bfloat16* __restrict__ A,
                                         long lda, const __nv_bfloat16* const* B, long ldb,
                                         int M, int N, int K, int m0, int n0,
                                         float (&acc)[NB][C::WM][C::WN][4]) {
  using T = __nv_bfloat16;
  constexpr int V = Vec<T>::N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const bool a_vec = aligned16(A, lda, V);
  bool b_vec[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) b_vec[nb] = aligned16(B[nb], ldb, V);

  for (int k0 = 0; k0 < K; k0 += C::BK) {
    load_tile<T, C::BM, C::BK, C::BK + MSmem<C, NB>::PAD, C::THREADS>(sm.a, A, lda, M, K, m0, k0,
                                                                      a_vec);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      load_tile<T, C::BK, C::BN, C::BN + MSmem<C, NB>::PAD, C::THREADS>(sm.b[nb], B[nb], ldb, K,
                                                                        N, k0, n0, b_vec[nb]);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      uint32_t a[C::WM][4];
#pragma unroll
      for (int i = 0; i < C::WM; ++i) {
        const int r = wm * C::WM * 16 + i * 16 + g;
        a[i][0] = ld_pair(&sm.a[r][kk + 2 * t]);
        a[i][1] = ld_pair(&sm.a[r + 8][kk + 2 * t]);
        a[i][2] = ld_pair(&sm.a[r][kk + 2 * t + 8]);
        a[i][3] = ld_pair(&sm.a[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < C::WN; ++j) {
          const int col = wn * C::WN * 8 + j * 8 + g;
          const uint32_t b0 = pack_pair(sm.b[nb][kk + 2 * t][col], sm.b[nb][kk + 2 * t + 1][col]);
          const uint32_t b1 =
              pack_pair(sm.b[nb][kk + 2 * t + 8][col], sm.b[nb][kk + 2 * t + 9][col]);
#pragma unroll
          for (int i = 0; i < C::WM; ++i) mma_bf16(acc[nb][i][j], a[i], b0, b1);
        }
      }
    }
    __syncthreads();
  }
}

// Call fn(i, j, r, row, col) for every accumulator element of this
// thread, with its row and column in the output matrix.
template <class C, class F>
__device__ __forceinline__ void mma_for_each(int m0, int n0, F&& fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < C::WM; ++i)
#pragma unroll
    for (int j = 0; j < C::WN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        fn(i, j, r, m0 + wm * C::WM * 16 + i * 16 + g + (r >= 2 ? 8 : 0),
           n0 + wn * C::WN * 8 + j * 8 + 2 * t + (r & 1));
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
mma_grouped_kernel(const __nv_bfloat16* __restrict__ A, long a_stride,
                   const __nv_bfloat16* __restrict__ w_local,
                   const __nv_bfloat16* __restrict__ w_remote, __nv_bfloat16* __restrict__ out,
                   int n_local, int M, int K, int N, const unsigned char* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<MSmem<C, 1>*>(smem_raw);
  const int g = blockIdx.z;
  const long wsz = (long)K * N;
  const __nv_bfloat16* B[1] = {g < n_local ? w_local + g * wsz : w_remote + (g - n_local) * wsz};
  float acc[1][C::WM][C::WN][4];
  mma_zero<C, 1>(acc);
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  if (!skip_expert(valid, g, n_local))
    mma_tile<C, 1>(sm, A + g * a_stride, K, B, N, M, N, K, m0, n0, acc);
  __nv_bfloat16* o = out + (long)g * M * N;
  mma_for_each<C>(m0, n0, [&](int i, int j, int r, int row, int col) {
    if (row < M && col < N) o[(long)row * N + col] = __float2bfloat16(acc[0][i][j][r]);
  });
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
mma_gate_up_kernel(const __nv_bfloat16* __restrict__ A, long a_stride,
                   const __nv_bfloat16* __restrict__ g_local,
                   const __nv_bfloat16* __restrict__ u_local,
                   const __nv_bfloat16* __restrict__ g_remote,
                   const __nv_bfloat16* __restrict__ u_remote, __nv_bfloat16* __restrict__ h,
                   int n_local, int M, int K, int N, const unsigned char* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<MSmem<C, 2>*>(smem_raw);
  const int g = blockIdx.z;
  const long wsz = (long)K * N;
  const bool local = g < n_local;
  const long off = (local ? g : g - n_local) * wsz;
  const __nv_bfloat16* B[2] = {(local ? g_local : g_remote) + off,
                               (local ? u_local : u_remote) + off};
  float acc[2][C::WM][C::WN][4];
  mma_zero<C, 2>(acc);
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  if (!skip_expert(valid, g, n_local))
    mma_tile<C, 2>(sm, A + g * a_stride, K, B, N, M, N, K, m0, n0, acc);
  __nv_bfloat16* o = h + (long)g * M * N;
  mma_for_each<C>(m0, n0, [&](int i, int j, int r, int row, int col) {
    if (row < M && col < N) {
      const float gv = acc[0][i][j][r];
      o[(long)row * N + col] = __float2bfloat16(gv / (1.f + __expf(-gv)) * acc[1][i][j][r]);
    }
  });
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
mma_reduce_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ w_local,
                  const __nv_bfloat16* __restrict__ w_remote, __nv_bfloat16* __restrict__ out,
                  int n_local, int n_slices, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<MSmem<C, 1>*>(smem_raw);
  const long wsz = (long)K * N;
  float acc[1][C::WM][C::WN][4];
  mma_zero<C, 1>(acc);
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  for (int s = 0; s < n_slices; ++s) {
    const __nv_bfloat16* B[1] = {s < n_local ? w_local + s * wsz
                                             : w_remote + (s - n_local) * wsz};
    mma_tile<C, 1>(sm, A + (long)s * M * K, K, B, N, M, N, K, m0, n0, acc);
  }
  mma_for_each<C>(m0, n0, [&](int i, int j, int r, int row, int col) {
    if (row < M && col < N) out[(long)row * N + col] = __float2bfloat16(acc[0][i][j][r]);
  });
}

inline unsigned cdiv(long a, long b) { return (unsigned)((a + b - 1) / b); }

template <class C>
int launch_mma_grouped(const void* A, long a_stride, const void* wl, const void* wr, void* out,
                       int n_local, int groups, int M, int K, int N, cudaStream_t st,
                       const unsigned char* valid) {
  using B = __nv_bfloat16;
  dim3 grid(cdiv(N, C::BN), cdiv(M, C::BM), groups);
  mma_grouped_kernel<C><<<grid, C::THREADS, sizeof(MSmem<C, 1>), st>>>(
      (const B*)A, a_stride, (const B*)wl, (const B*)wr, (B*)out, n_local, M, K, N, valid);
  return (int)cudaGetLastError();
}

template <class C>
int launch_mma_gate_up(const void* A, long a_stride, const void* gl, const void* ul,
                       const void* gr, const void* ur, void* h, int n_local, int groups, int M,
                       int K, int N, cudaStream_t st, const unsigned char* valid) {
  using B = __nv_bfloat16;
  dim3 grid(cdiv(N, C::BN), cdiv(M, C::BM), groups);
  mma_gate_up_kernel<C><<<grid, C::THREADS, sizeof(MSmem<C, 2>), st>>>(
      (const B*)A, a_stride, (const B*)gl, (const B*)ul, (const B*)gr, (const B*)ur, (B*)h,
      n_local, M, K, N, valid);
  return (int)cudaGetLastError();
}

template <class C>
int launch_mma_reduce(const void* A, const void* wl, const void* wr, void* out, int n_local,
                      int n_slices, int M, int K, int N, cudaStream_t st) {
  using B = __nv_bfloat16;
  dim3 grid(cdiv(N, C::BN), cdiv(M, C::BM), 1);
  mma_reduce_kernel<C><<<grid, C::THREADS, sizeof(MSmem<C, 1>), st>>>(
      (const B*)A, (const B*)wl, (const B*)wr, (B*)out, n_local, n_slices, M, K, N);
  return (int)cudaGetLastError();
}

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

// Launchers: the few-row path for M <= GV_MAXM; above it the tensor-core
// path for bf16 and the FMA tile path for fp32. ``valid`` (optional)
// marks the real experts of the second bank (see skip_expert).
template <typename T, class C>
int launch_grouped(const void* A, long a_stride, const void* wl, const void* wr, void* out,
                   int n_local, int groups, int M, int K, int N, cudaStream_t st,
                   const unsigned char* valid = nullptr) {
  if (groups == 0 || M == 0 || N == 0) return 0;
  if constexpr (kBf16<T>) {
    if (M > GV_MAXM)
      return M <= MSmall::BM
                 ? launch_mma_grouped<MSmall>(A, a_stride, wl, wr, out, n_local, groups, M, K, N,
                                              st, valid)
                 : launch_mma_grouped<MLarge>(A, a_stride, wl, wr, out, n_local, groups, M, K, N,
                                              st, valid);
  }
  if (M <= GV_MAXM) {
    dim3 grid(cdiv(N, GV_BN), 1, groups);
    gv_grouped_kernel<T><<<grid, GV_THREADS, 0, st>>>(
        (const T*)A, a_stride, (const T*)wl, (const T*)wr, (T*)out, n_local, M, K, N, valid);
    return (int)cudaGetLastError();
  }
  dim3 grid(cdiv(N, C::BN), cdiv(M, C::BM), groups);
  grouped_kernel<T, C><<<grid, C::THREADS, sizeof(Smem<T, C, 1>), st>>>(
      (const T*)A, a_stride, (const T*)wl, (const T*)wr, (T*)out, n_local, M, K, N, valid);
  return (int)cudaGetLastError();
}

template <typename T, class C>
int launch_gate_up(const void* A, long a_stride, const void* gl, const void* ul, const void* gr,
                   const void* ur, void* h, int n_local, int groups, int M, int K, int N,
                   cudaStream_t st, const unsigned char* valid = nullptr) {
  if (groups == 0 || M == 0 || N == 0) return 0;
  if constexpr (kBf16<T>) {
    if (M > GV_MAXM)
      return M <= MSmall::BM
                 ? launch_mma_gate_up<MSmall>(A, a_stride, gl, ul, gr, ur, h, n_local, groups, M,
                                              K, N, st, valid)
                 : launch_mma_gate_up<MLarge>(A, a_stride, gl, ul, gr, ur, h, n_local, groups, M,
                                              K, N, st, valid);
  }
  if (M <= GV_MAXM) {
    dim3 grid(cdiv(N, GV_BN), 1, groups);
    gv_gate_up_kernel<T><<<grid, GV_THREADS, 0, st>>>(
        (const T*)A, a_stride, (const T*)gl, (const T*)ul, (const T*)gr, (const T*)ur, (T*)h,
        n_local, M, K, N, valid);
    return (int)cudaGetLastError();
  }
  dim3 grid(cdiv(N, C::BN), cdiv(M, C::BM), groups);
  gate_up_kernel<T, C><<<grid, C::THREADS, sizeof(Smem<T, C, 2>), st>>>(
      (const T*)A, a_stride, (const T*)gl, (const T*)ul, (const T*)gr, (const T*)ur, (T*)h,
      n_local, M, K, N, valid);
  return (int)cudaGetLastError();
}

template <typename T, class C>
int launch_reduce(const void* A, const void* wl, const void* wr, void* out, int n_local,
                  int n_slices, int M, int K, int N, cudaStream_t st) {
  if (M == 0 || N == 0) return 0;
  if constexpr (kBf16<T>) {
    if (M > GV_MAXM)
      return M <= MSmall::BM
                 ? launch_mma_reduce<MSmall>(A, wl, wr, out, n_local, n_slices, M, K, N, st)
                 : launch_mma_reduce<MLarge>(A, wl, wr, out, n_local, n_slices, M, K, N, st);
  }
  if (M <= GV_MAXM) {
    dim3 grid(cdiv(N, GV_BN), 1, 1);
    gv_reduce_kernel<T><<<grid, GV_THREADS, 0, st>>>(
        (const T*)A, (const T*)wl, (const T*)wr, (T*)out, n_local, n_slices, M, K, N);
    return (int)cudaGetLastError();
  }
  dim3 grid(cdiv(N, C::BN), cdiv(M, C::BM), 1);
  reduce_kernel<T, C><<<grid, C::THREADS, sizeof(Smem<T, C, 1>), st>>>(
      (const T*)A, (const T*)wl, (const T*)wr, (T*)out, n_local, n_slices, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace split_tile


// dtype codes shared with the Python wrappers: 0 = float32, 1 = bfloat16.
// Rows <= 16 take the Small tile configuration, more rows the Large one.
#define SPLIT_DISPATCH(dtype, rows, FN, ...)                                             \
  ((dtype) == 0 ? ((rows) <= 16 ? FN<float, split_tile::Small>(__VA_ARGS__)             \
                                : FN<float, split_tile::Large>(__VA_ARGS__))            \
   : (dtype) == 1                                                                       \
       ? ((rows) <= 16 ? FN<__nv_bfloat16, split_tile::Small>(__VA_ARGS__)              \
                       : FN<__nv_bfloat16, split_tile::Large>(__VA_ARGS__))             \
       : (int)cudaErrorInvalidValue)
