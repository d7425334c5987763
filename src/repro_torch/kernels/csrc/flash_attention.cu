// flash_attention: blockwise causal / sliding-window GQA attention (prefill).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention. q (B, Sq, H, hd), k / v (B, Sk, Kh, hd), out like q;
// query head h reads kv head h / (H / Kh). Query row i sits at absolute
// position q_offset + i, key j at j; key j is visible to row i when
//   j <= q_offset + i,  j < Sk,  and (window > 0) q_offset + i - j < window.
// Numerics follow the Pallas kernel: q is scaled by 1/sqrt(hd) in q's type,
// logits and the online-softmax state (m, l, acc) are fp32, masked logits
// are -1e30, p is rounded to v's type before the PV product (bf16), and
// the output is acc / max(l, 1e-30) rounded to q's type. (exp is taken as
// exp2 of the fp32 logit times log2(e).)
//
// Bound on the H100: at the prefill shapes (256-2048 query rows per rank
// against 1024-8192 keys, 32-128 heads, hd 128) the visible query-key
// pairs cost 4 * hd operations per head each, against one read of q and of
// the visible k and v and one write of out: compute-bound at 989 TFLOP/s
// (bf16), except the shortest causal prompt, which is about even.
//
// Design, bf16 at hd 128 (every launch of the serving path; the wrapper's
// plan, ops.py::flash_plan, a pure function of the shapes, picks the
// tiles): warp-specialised like split_hopper.cuh, on hopper.cuh's helpers.
// A block owns 128 query rows of one head (two consumer warpgroups of 64
// rows) and a producer warpgroup whose first thread issues every load: the
// q tile once, then the visible key tiles of 128 keys, heaviest first (the diagonal tile, then down), each K
// and V tile by TMA through 4-d tensor maps over the (B, Sk, Kh, hd)
// tensors (two 64-column boxes, 128-byte swizzle) into a ring of stages
// with a K-full, a V-full and an empty mbarrier each. Each consumer
// warpgroup scales its q rows in shared memory (rounded to bf16), then per
// key tile: S = q K^T by wgmma m64n128k16 from shared memory (A = q and B
// = K, both K-major); mask (boundary tiles only); online softmax on the
// accumulator fragment (a row lives in a quad of lanes: two shuffles for
// the max, the row sum kept per thread until the end, exp2 with log2(e)
// folded in); p packed to bf16 in registers is the A fragment of O += P V
// (wgmma m64n128k16, A from registers, B = V N-major with the transpose
// bit), so p never touches shared memory; then the warpgroup releases the
// stage. The two consumer warpgroups interleave their softmax and their
// tensor-core work on the SM (setmaxnreg moves registers from the producer
// to them). The output, O / max(l, 1e-30) in bf16, is staged in the
// warpgroup's q tile in the 128-byte-swizzled layout and written by a
// TMA store, which clips the rows past Sq. Blocks run heaviest query
// tiles first, and the query heads that share a kv head are adjacent
// blocks, so their K/V reads hit L2. Only the key tiles that intersect
// [q_lo - window + 1, q_hi] are visited: a fully masked tile contributes
// exactly zero once a visible key has set m, and every row sees its own
// key, so skipping changes no result.
//
// fp32, and bf16 at hd 64 and 256, keep the earlier kernels below: 64
// query rows and 64-key tiles per block of 4 warps; bf16 with mma.sync
// m16n8k16 and a two-stage cp.async ring, fp32 with FMAs and synchronous
// loads. At hd 256 (RecurrentGemma's local attention) the bf16 kernel's
// shared memory is 165 KB (the q tile and two stages of K and V, rows
// padded by 16 bytes): one block per SM; its q fragments are read from
// shared memory at each use instead of held in registers.
#include <math.h>

#include "hopper.cuh"

namespace fa {

using namespace hopper;

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // keys per tile
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

using bf16 = __nv_bfloat16;

struct Geo {
  int sq, sk, h, kh, q_offset, window;
  float scale;
};

// Key tiles [t_lo, t_hi] of TK keys that hold a key visible to query rows
// [q0, q1).
template <int TK = BKV>
__device__ __forceinline__ void tile_range(const Geo& g, int q0, int q1, int& t_lo, int& t_hi) {
  const int qa_lo = g.q_offset + q0, qa_hi = g.q_offset + q1 - 1;
  const int k_hi = min(qa_hi, g.sk - 1);
  const int k_lo = g.window > 0 ? max(0, qa_lo - g.window + 1) : 0;
  t_lo = k_lo / TK;
  t_hi = k_hi / TK;
}

// True when every key of tile [k0, k0 + TK) is visible to every row of
// [q0, q1): no mask needed.
template <int TK = BKV>
__device__ __forceinline__ bool tile_full(const Geo& g, int q0, int q1, int k0) {
  const int qa_lo = g.q_offset + q0, qa_hi = g.q_offset + q1 - 1;
  const int k_last = k0 + TK - 1;
  return k_last <= qa_lo && k_last < g.sk && (g.window <= 0 || qa_hi - k0 < g.window);
}

__device__ __forceinline__ bool visible(const Geo& g, int row, int key) {
  const int qp = g.q_offset + row;
  return key <= qp && key < g.sk && (g.window <= 0 || qp - key < g.window);
}

// ---------------------------------------------------------------------------
// bf16 at hd 64: tensor cores (mma.sync m16n8k16).
// ---------------------------------------------------------------------------
template <int HD>
struct BfSmem {
  static constexpr int LD = HD + 8;  // 16-byte pad: conflict-free ldmatrix rows
  bf16 q[BQ][LD];
  bf16 k[2][BKV][LD];  // two-stage ring
  bf16 v[2][BKV][LD];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared; with ok false the 16 bytes
// are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// The q tile: rows [q0, q0 + BQ) of the head slice (row stride ld), each
// value multiplied by scale in fp32 and rounded back to bf16 (q * scale in
// q's type); zeros past row n.
template <int HD>
__device__ __forceinline__ void load_q(bf16 (*s)[HD + 8], const bf16* __restrict__ g, long ld,
                                       int n, int q0, float scale) {
  constexpr int CV = HD / 8;
  for (int idx = threadIdx.x; idx < BQ * CV; idx += THREADS) {
    const int r = idx / CV, c = (idx % CV) * 8;
    alignas(16) bf16 buf[8];
    if (q0 + r < n) {
      *reinterpret_cast<uint4*>(buf) =
          __ldg(reinterpret_cast<const uint4*>(g + (long)(q0 + r) * ld + c));
#pragma unroll
      for (int e = 0; e < 8; ++e) buf[e] = __float2bfloat16(__bfloat162float(buf[e]) * scale);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) buf[e] = __float2bfloat16(0.f);
    }
    *reinterpret_cast<uint4*>(&s[r][c]) = *reinterpret_cast<const uint4*>(buf);
  }
}

// Start the cp.async copies of key tile [k0, k0 + BKV) of k and v (zeros
// past key n) into one ring stage.
template <int HD>
__device__ __forceinline__ void load_kv_async(bf16 (*sk)[HD + 8], bf16 (*sv)[HD + 8],
                                              const bf16* kb, const bf16* vb, long ld, int n,
                                              int k0) {
  constexpr int CV = HD / 8;
  for (int idx = threadIdx.x; idx < BKV * CV; idx += THREADS) {
    const int r = idx / CV, c = (idx % CV) * 8;
    const bool ok = k0 + r < n;
    const long off = ok ? (long)(k0 + r) * ld + c : 0;
    cp_async16(&sk[r][c], kb + off, ok);
    cp_async16(&sv[r][c], vb + off, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
fa_bf16_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
               const bf16* __restrict__ V, bf16* __restrict__ O, Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<BfSmem<HD>*>(smem_raw);
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest query tiles first
  const int head = blockIdx.x, bi = blockIdx.z;
  const int kvh = head / (g.h / g.kh);
  const long ldq = (long)g.h * HD, ldk = (long)g.kh * HD;
  const bf16* qb = Q + (long)bi * g.sq * ldq + (long)head * HD;
  const bf16* kb = K + (long)bi * g.sk * ldk + (long)kvh * HD;
  const bf16* vb = V + (long)bi * g.sk * ldk + (long)kvh * HD;
  bf16* ob = O + (long)bi * g.sq * ldq + (long)head * HD;
  const int q0 = qt * BQ, q1 = min(q0 + BQ, g.sq);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;

  int t_lo, t_hi;
  tile_range(g, q0, q1, t_lo, t_hi);
  load_kv_async<HD>(sm.k[0], sm.v[0], kb, vb, ldk, g.sk, t_lo * BKV);
  cp_async_commit();
  load_q<HD>(sm.q, qb, ldq, g.sq, q0, g.scale);
  __syncthreads();
  // The q fragments stay in registers up to hd 128; at hd 256 they would
  // take 64 more registers beside the 128 of the accumulator, so they are
  // read from the q tile (which stays in shared memory) at each use.
  constexpr bool QREG = HD <= 128;
  uint32_t qf[QREG ? HD / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      ldmatrix_x4(qf[ks], &sm.q[warp * 16 + (lane % 16)][ks * 16 + (lane / 16) * 8]);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + gq;  // this thread's rows: row0, row0 + 8

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BKV;
    const int st = (t - t_lo) & 1;
    if (t < t_hi) load_kv_async<HD>(sm.k[st ^ 1], sm.v[st ^ 1], kb, vb, ldk, g.sk, k0 + BKV);
    cp_async_commit();
    cp_async_wait_one();  // tile t has landed
    __syncthreads();

    // S = (q * scale) K^T: 16 rows x 64 keys per warp, fp32.
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qf[ks][r];
      } else {
        ldmatrix_x4(a, &sm.q[warp * 16 + (lane % 16)][ks * 16 + (lane / 16) * 8]);
      }
#pragma unroll
      for (int jp = 0; jp < BKV / 16; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, &sm.k[st][jp * 16 + (lane % 8) + (lane / 16) * 8]
                           [ks * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
    if (!tile_full(g, q0, q1, k0)) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (!visible(g, row0 + (r >= 2 ? 8 : 0), k0 + j * 8 + 2 * tq + (r & 1)))
            s[j][r] = NEG_INF;
    }

    // Online softmax over the tile; a row's state lives in its quad of 4 lanes.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float corr[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      s[j][0] = expf(s[j][0] - mx[0]);
      s[j][1] = expf(s[j][1] - mx[0]);
      s[j][2] = expf(s[j][2] - mx[1]);
      s[j][3] = expf(s[j][3] - mx[1]);
      rs[0] += s[j][0] + s[j][1];
      rs[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // acc += bf16(p) V: the S fragments of two key octets form one A fragment.
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
      const uint32_t a[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                             pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                             pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &sm.v[st][ks * 16 + (lane % 8) + ((lane / 8) % 2) * 8]
                                  [np * 16 + (lane / 16) * 8]);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration
  }

  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= g.sq) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(ob + (long)row * ldq + col) =
          pack_bf16(o[n][2 * i] / den[i], o[n][2 * i + 1] / den[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the same tiles with FMAs. Thread (ty, tx) = (tid / 16, tid % 16)
// owns query rows ty + 8 r (r < 8) and, in S, keys tx + 16 c (c < 4); in
// the output, columns tx + 16 c (c < HD / 16).
// ---------------------------------------------------------------------------
template <int HD>
struct F32Smem {
  float q[BQ][HD + 1];
  float k[BKV][HD + 1];
  float v[BKV][HD];
  float p[BQ][BKV + 1];
  float corr[BQ];
};

template <int HD, int LD, int R>
__device__ __forceinline__ void load_rows_f32(float (*s)[LD], const float* __restrict__ g, long ld,
                                              int n, int r0, float scale) {
  for (int idx = threadIdx.x; idx < R * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD;
    const int gr = r0 + r;
    const float x = gr < n ? g[(long)gr * ld + c] : 0.f;
    s[r][c] = scale > 0.f ? x * scale : x;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
fa_f32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
              const float* __restrict__ V, float* __restrict__ O, Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<F32Smem<HD>*>(smem_raw);
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int head = blockIdx.x, bi = blockIdx.z;
  const int kvh = head / (g.h / g.kh);
  const long ldq = (long)g.h * HD, ldk = (long)g.kh * HD;
  const float* qb = Q + (long)bi * g.sq * ldq + (long)head * HD;
  const float* kb = K + (long)bi * g.sk * ldk + (long)kvh * HD;
  const float* vb = V + (long)bi * g.sk * ldk + (long)kvh * HD;
  float* ob = O + (long)bi * g.sq * ldq + (long)head * HD;
  const int q0 = qt * BQ, q1 = min(q0 + BQ, g.sq);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int OC = HD / 16;

  load_rows_f32<HD, HD + 1, BQ>(sm.q, qb, ldq, g.sq, q0, g.scale);
  float o[8][OC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < OC; ++c) o[r][c] = 0.f;
  // the softmax state of row threadIdx.x (threads < BQ)
  float m_row = NEG_INF, l_row = 0.f;

  int t_lo, t_hi;
  tile_range(g, q0, q1, t_lo, t_hi);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BKV;
    __syncthreads();
    load_rows_f32<HD, HD + 1, BKV>(sm.k, kb, ldk, g.sk, k0, 0.f);
    load_rows_f32<HD, HD, BKV>(sm.v, vb, ldk, g.sk, k0, 0.f);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sm.k[tx + 16 * c][d];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float qv = sm.q[ty + 8 * r][d];
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv, kv[c], s[r][c]);
      }
    }
    const bool full = tile_full(g, q0, q1, k0);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = ty + 8 * r, key = tx + 16 * c;
        sm.p[row][key] = (full || visible(g, q0 + row, k0 + key)) ? s[r][c] : NEG_INF;
      }
    __syncthreads();

    if (threadIdx.x < BQ) {
      float* pr = sm.p[threadIdx.x];
      float mx = m_row;
      for (int j = 0; j < BKV; ++j) mx = fmaxf(mx, pr[j]);
      float rs = 0.f;
      for (int j = 0; j < BKV; ++j) {
        pr[j] = expf(pr[j] - mx);
        rs += pr[j];
      }
      const float cr = expf(m_row - mx);
      l_row = l_row * cr + rs;
      m_row = mx;
      sm.corr[threadIdx.x] = cr;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float cr = sm.corr[ty + 8 * r];
#pragma unroll
      for (int c = 0; c < OC; ++c) o[r][c] *= cr;
    }
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float vv[OC];
#pragma unroll
      for (int c = 0; c < OC; ++c) vv[c] = sm.v[j][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float pv = sm.p[ty + 8 * r][j];
#pragma unroll
        for (int c = 0; c < OC; ++c) o[r][c] = fmaf(pv, vv[c], o[r][c]);
      }
    }
  }

  __syncthreads();
  if (threadIdx.x < BQ) sm.corr[threadIdx.x] = fmaxf(l_row, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = ty + 8 * r;
    if (q0 + row >= g.sq) continue;
    const float den = sm.corr[row];
#pragma unroll
    for (int c = 0; c < OC; ++c) ob[(long)(q0 + row) * ldq + tx + 16 * c] = o[r][c] / den;
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 128: TMA + mbarrier ring + wgmma (Hopper).
// ---------------------------------------------------------------------------
constexpr int WG_HD = 128;
constexpr int ROW = 128;                 // bytes of one 64-column box row (128-byte swizzle)
constexpr int BOX_ROWS = 64;             // rows of a q / out box: one warpgroup's
constexpr int Q_BOX = BOX_ROWS * ROW;    // 8 KB
constexpr int Q_WG = 2 * Q_BOX;          // one warpgroup's q tile: two 64-column boxes
constexpr float L2E = 1.4426950408889634f;

// The block tile: CW consumer warpgroups of 64 query rows, key tiles of
// BKV keys (the tile that won at every prefill shape of the serving path:
// tools/sweep_dense_plans.py, PERF.md).
struct WgTile {
  static constexpr int CW = 2, BKV = 128, BQ = 64 * CW;
  static constexpr int THREADS = 128 * (CW + 1);  // + the producer warpgroup
  static constexpr int Q_BYTES = CW * Q_WG;
  static constexpr int KV_BOX = BKV * ROW;        // one 64-column box of a K or V tile
  static constexpr int KV_BYTES = 2 * KV_BOX;
  static constexpr int STAGE = 2 * KV_BYTES;      // K then V
};
using TL = WgTile;

// Dynamic shared memory: 1024 bytes of alignment slack, the q tile, the
// stages, the q barrier and three barriers per stage.
inline size_t wg_smem_bytes(int stages) {
  return 1024 + TL::Q_BYTES + (size_t)stages * TL::STAGE + 8 * (1 + 3 * (size_t)stages);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x 128 keys) = q (64 x 128) @ K^T: A the warpgroup's q tile, B the
// K tile (128 keys x 128, K-major); both two 64-column boxes, 128-byte
// swizzle.
__device__ __forceinline__ void qk_wgmma(float (&s)[TL::BKV / 2], uint32_t q, uint32_t k) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WG_HD / 16; ++kk) {
    const uint64_t da = smem_desc(q + (kk / 4) * Q_BOX + (kk % 4) * 32, 16, 1024);
    const uint64_t db = smem_desc(k + (kk / 4) * TL::KV_BOX + (kk % 4) * 32, 16, 1024);
    wgmma_m64n128<0>(s, da, db);
  }
  wgmma_commit();
}

// grid: one block per (head, query tile, batch row), heads fastest, the
// heaviest query tiles first. q_map / o_map: (hd, H, Sq, B), boxes (64, 1,
// 64, 1); k_map / v_map: (hd, Kh, Sk, B), boxes (64, 1, BKV, 1).
__global__ void __launch_bounds__(TL::THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap o_map, Geo g, int stages) {
  constexpr int CW = TL::CW, BKV = TL::BKV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t q_s = smem_u32(base), ring = q_s + TL::Q_BYTES;
  const uint32_t q_full = ring + stages * TL::STAGE;
  const uint32_t full_k = q_full + 8, full_v = full_k + 8 * stages, empty = full_v + 8 * stages;

  const int n_qt = (g.sq + TL::BQ - 1) / TL::BQ;
  const int head = blockIdx.x % g.h;
  const int rest = blockIdx.x / g.h;
  const int qt = n_qt - 1 - rest % n_qt;  // heaviest query tiles first
  const int bi = rest / n_qt;
  const int kvh = head / (g.h / g.kh);
  const int q0 = qt * TL::BQ, q1 = min(q0 + TL::BQ, g.sq);
  int t_lo, t_hi;
  tile_range<BKV>(g, q0, q1, t_lo, t_hi);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < stages; ++i) {
      mbar_init(full_k + 8 * i, 1);
      mbar_init(full_v + 8 * i, 1);
      mbar_init(empty + 8 * i, CW * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CW) {
    // ---- producer ------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CW * 128) {
      const int q_wgs = min(CW, (g.sq - q0 + 63) / 64);  // warpgroups with rows
      mbar_expect_tx(q_full, q_wgs * Q_WG);
      for (int w = 0; w < q_wgs; ++w)
        for (int b = 0; b < 2; ++b)
          tma_4d(q_s + w * Q_WG + b * Q_BOX, &q_map, q_full, 64 * b, head, q0 + 64 * w, bi);
      int st = 0;
      uint32_t ph = 0;
      for (int t = t_hi; t >= t_lo; --t) {
        mbar_wait(empty + 8 * st, ph ^ 1);
        const uint32_t kt = ring + st * TL::STAGE, vt = kt + TL::KV_BYTES;
        mbar_expect_tx(full_k + 8 * st, TL::KV_BYTES);
        for (int b = 0; b < 2; ++b)
          tma_4d(kt + b * TL::KV_BOX, &k_map, full_k + 8 * st, 64 * b, kvh, t * BKV, bi);
        mbar_expect_tx(full_v + 8 * st, TL::KV_BYTES);
        for (int b = 0; b < 2; ++b)
          tma_4d(vt + b * TL::KV_BOX, &v_map, full_v + 8 * st, 64 * b, kvh, t * BKV, bi);
        if (++st == stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers -----------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int gq = lane / 4, tq = lane % 4;
    const int r0 = q0 + 64 * wg, r1 = min(r0 + 64, g.sq);  // this warpgroup's rows
    const uint32_t q_w = q_s + wg * Q_WG;
    // the key tiles this warpgroup sees (none when it has no rows)
    int w_lo = 1, w_hi = 0;
    if (r0 < r1) {
      tile_range<BKV>(g, r0, r1, w_lo, w_hi);
      // q * scale rounded to bf16, in place (the swizzle moves whole
      // 16-byte chunks, so an elementwise pass may ignore it)
      mbar_wait(q_full, 0);
      uint4* qv = reinterpret_cast<uint4*>(base + wg * Q_WG);
      for (int i = tid; i < Q_WG / 16; i += 128) {
        uint4 u = qv[i];
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          h2[e] = __floats2bfloat162_rn(f.x * g.scale, f.y * g.scale);
        }
        qv[i] = u;
      }
      fence_async_shared();
      bar_sync(1 + wg, 128);
    }

    float o[64];
    zero(o);
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const int row0 = r0 + warp * 16 + gq;  // this thread's rows: row0, row0 + 8
    int st = 0;
    uint32_t ph = 0;
    for (int t = t_hi; t >= t_lo; --t) {
      const uint32_t kt = ring + st * TL::STAGE, vt = kt + TL::KV_BYTES;
      mbar_wait(full_k + 8 * st, ph);
      if (t >= w_lo && t <= w_hi) {
        const int k0 = t * BKV;
        float s[BKV / 2];
        zero(s);
        fence_regs(s);
        qk_wgmma(s, q_w, kt);
        wgmma_wait<0>();
        fence_regs(s);
        if (!tile_full<BKV>(g, r0, r1, k0)) {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i)
            if (!visible(g, row0 + 8 * ((i / 2) % 2), k0 + (i / 4) * 8 + 2 * tq + (i % 2)))
              s[i] = NEG_INF;
        }
        // online softmax; element i of s is row (i / 2) % 2, key octet i / 4
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
        float msc[2], corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // a row with no visible key yet keeps p = 0 (its m stays -1e30)
          msc[r] = mx[r] == NEG_INF ? 0.f : mx[r] * L2E;
          corr[r] = ex2(fmaf(m[r], L2E, -msc[r]));
          m[r] = mx[r];
          l[r] *= corr[r];
        }
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          s[i] = ex2(fmaf(s[i], L2E, -msc[(i / 2) % 2]));
          l[(i / 2) % 2] += s[i];  // this thread's share; the quad sums at the end
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] *= corr[(i / 2) % 2];
        // p in bf16: the S fragment of key octets 2kk and 2kk + 1 is the A
        // fragment of the kk-th 16-key step
        uint32_t pa[BKV / 16][4];
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
            pa[kk][r] = *reinterpret_cast<const uint32_t*>(&h2);
          }
        mbar_wait(full_v + 8 * st, ph);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_m64n128_rs(o, pa[kk], smem_desc(vt + kk * 16 * ROW, TL::KV_BOX, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      if (lane == 0) mbar_arrive(empty + 8 * st);
      if (++st == stages) {
        st = 0;
        ph ^= 1;
      }
    }
    if (r0 >= r1) return;

    // ---- epilogue: O / max(l, 1e-30) in bf16, staged in the warpgroup's q
    // tile in the 128-byte-swizzled box layout, then one TMA store per box
    // (rows past Sq are clipped). Fragment element i of thread (warp,
    // lane) is row warp*16 + lane/4 + 8*((i/2)%2), column (i/4)*8 +
    // 2*(lane%4) + i%2.
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = warp * 16 + gq + 8 * ((i / 2) % 2), col = (i / 4) * 8 + 2 * tq;
      const int box = col / 64, chunk = ((col % 64) / 8) ^ (row % 8);
      *reinterpret_cast<__nv_bfloat162*>(base + wg * Q_WG + box * Q_BOX + row * ROW + chunk * 16 +
                                         (col % 8) * 2) =
          __floats2bfloat162_rn(o[i] / den[(i / 2) % 2], o[i + 1] / den[(i / 2) % 2]);
    }
    fence_async_shared();
    bar_sync(1 + wg, 128);
    if (tid == 0) {
      for (int b = 0; b < 2; ++b) tma_store_4d(&o_map, q_w + b * Q_BOX, 64 * b, head, r0, bi);
      tma_store_wait();
    }
  }
}

// The maps of the Hopper path: q and out (hd, H, Sq, B) in 64-row boxes,
// k and v (hd, Kh, Sk, B) in BKV-row boxes.
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int b, const Geo& g,
                 int stages, cudaStream_t st) {
  const size_t smem = wg_smem_bytes(stages);
  if (stages < 1 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, om;
  const uint64_t qdims[4] = {WG_HD, (uint64_t)g.h, (uint64_t)g.sq, (uint64_t)b};
  const uint64_t kdims[4] = {WG_HD, (uint64_t)g.kh, (uint64_t)g.sk, (uint64_t)b};
  const uint32_t qbox[4] = {64, 1, BOX_ROWS, 1}, kbox[4] = {64, 1, TL::BKV, 1};
  int err = make_map(&qm, q, 4, qdims, qbox);
  if (!err) err = make_map(&om, out, 4, qdims, qbox);
  if (!err) err = make_map(&km, k, 4, kdims, kbox);
  if (!err) err = make_map(&vm, v, 4, kdims, kbox);
  if (err) return err;
  // set on every launch (see split_hopper.cuh hopper_launch)
  err = (int)cudaFuncSetAttribute(fa_wgmma_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return ATTR_ERROR + err;
  const unsigned grid = (unsigned)g.h * cdiv(g.sq, TL::BQ) * (unsigned)b;
  fa_wgmma_kernel<<<grid, TL::THREADS, smem, st>>>(qm, km, vm, om, g, stages);
  return (int)cudaGetLastError();
}

template <class Smem, class Kern, class T>
int launch(Kern kern, const void* q, const void* k, const void* v, void* out, int b,
           const Geo& g, cudaStream_t st) {
  const int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(g.h, (g.sq + BQ - 1) / BQ, b);
  kern<<<grid, THREADS, bytes, st>>>((const T*)q, (const T*)k, (const T*)v, (T*)out, g);
  return (int)cudaGetLastError();
}

}  // namespace fa

// dtype codes shared with the Python wrapper: 0 = float32, 1 = bfloat16.
// The plan (ops.py flash_plan): path 1 = the Hopper kernel (bf16, hd 128)
// with that many ring stages; path 0 = the earlier kernels (fp32 at hd 64 or 128,
// bf16 at hd 64 or 256).
// q, k, v and out must be 16-byte aligned; the wrapper checks shapes,
// types and layout.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                               int sq, int sk, int h, int kh, int hd, int q_offset, int window,
                               int dtype, int path, int stages, void* stream) {
  if (b == 0 || sq == 0) return 0;
  const fa::Geo g{sq, sk, h, kh, q_offset, window, (float)(1.0 / sqrt((double)hd))};
  cudaStream_t st = (cudaStream_t)stream;
  if (path == 1) {
    if (dtype != 1 || hd != fa::WG_HD) return (int)cudaErrorInvalidValue;
    return fa::launch_wgmma(q, k, v, out, b, g, stages, st);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (hd == 64)
      return fa::launch<fa::BfSmem<64>, decltype(&fa::fa_bf16_kernel<64>), fa::bf16>(
          fa::fa_bf16_kernel<64>, q, k, v, out, b, g, st);
    if (hd == 256)
      return fa::launch<fa::BfSmem<256>, decltype(&fa::fa_bf16_kernel<256>), fa::bf16>(
          fa::fa_bf16_kernel<256>, q, k, v, out, b, g, st);
  } else if (dtype == 0) {
    if (hd == 64)
      return fa::launch<fa::F32Smem<64>, decltype(&fa::fa_f32_kernel<64>), float>(
          fa::fa_f32_kernel<64>, q, k, v, out, b, g, st);
    if (hd == 128)
      return fa::launch<fa::F32Smem<128>, decltype(&fa::fa_f32_kernel<128>), float>(
          fa::fa_f32_kernel<128>, q, k, v, out, b, g, st);
  }
  return (int)cudaErrorInvalidValue;
}
