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
// the output is acc / max(l, 1e-30) rounded to q's type.
//
// Bound on the H100: at the prefill shapes (256-2048 query rows per rank
// against 1024-8192 keys, 128 heads, hd 128) the unmasked query-key pairs
// cost 4 * hd operations per head each, against one read of q, k and v
// and one write of out: compute-bound, at 989 TFLOP/s (bf16), except the
// shortest causal prompt, which is about even.
//
// Design: one block of 4 warps per (query head, 64-query tile, batch row);
// each warp owns 16 query rows. The block stages its q tile (scaled) in
// shared memory once and keeps it in registers as mma fragments, then
// walks the 64-key tiles of k and v through a two-stage shared-memory ring
// filled by cp.async (the next tile lands while this one is computed),
// running mma.sync m16n8k16 (bf16 in, fp32 accumulate) for both QK^T and
// PV; the S accumulator fragment is re-packed in registers as the A
// fragment of the PV product, so p never leaves the registers. The key loop visits
// only the tiles that intersect [q_lo - window + 1, q_hi] of the query
// tile (the Pallas kernel visits every tile and masks): a fully masked
// tile contributes exactly zero once a visible key has set m, and every
// row sees its own key, so skipping changes no result. Masks are applied
// only on tiles that straddle a boundary. Blocks are scheduled heaviest
// first: every head's last query tile (which sees the most keys) before
// any head's second-to-last. fp32 inputs take a plain FMA path with the
// same tiles (no tensor cores, synchronous loads). Later work: wgmma, TMA,
// larger query tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // keys per tile
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

using bf16 = __nv_bfloat16;

struct Geo {
  int sq, sk, h, kh, q_offset, window;
  float scale;
};

// Key tiles [t_lo, t_hi] that hold a key visible to query rows [q0, q1).
__device__ __forceinline__ void tile_range(const Geo& g, int q0, int q1, int& t_lo, int& t_hi) {
  const int qa_lo = g.q_offset + q0, qa_hi = g.q_offset + q1 - 1;
  const int k_hi = min(qa_hi, g.sk - 1);
  const int k_lo = g.window > 0 ? max(0, qa_lo - g.window + 1) : 0;
  t_lo = k_lo / BKV;
  t_hi = k_hi / BKV;
}

// True when every key of tile [k0, k0 + BKV) is visible to every row of
// [q0, q1): no mask needed.
__device__ __forceinline__ bool tile_full(const Geo& g, int q0, int q1, int k0) {
  const int qa_lo = g.q_offset + q0, qa_hi = g.q_offset + q1 - 1;
  const int k_last = k0 + BKV - 1;
  return k_last <= qa_lo && k_last < g.sk && (g.window <= 0 || qa_hi - k0 < g.window);
}

__device__ __forceinline__ bool visible(const Geo& g, int row, int key) {
  const int qp = g.q_offset + row;
  return key <= qp && key < g.sk && (g.window <= 0 || qp - key < g.window);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16).
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
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    ldmatrix_x4(qf[ks], &sm.q[warp * 16 + (lane % 16)][ks * 16 + (lane / 16) * 8]);

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
#pragma unroll
      for (int jp = 0; jp < BKV / 16; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, &sm.k[st][jp * 16 + (lane % 8) + (lane / 16) * 8]
                           [ks * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16(s[2 * jp], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[ks], b[2], b[3]);
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
// hd must be 64 or 128 and q, k, v 16-byte aligned; the wrapper checks
// shapes, types and layout.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                               int sq, int sk, int h, int kh, int hd, int q_offset, int window,
                               int dtype, void* stream) {
  if (b == 0 || sq == 0) return 0;
  const fa::Geo g{sq, sk, h, kh, q_offset, window, (float)(1.0 / sqrt((double)hd))};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    if (hd == 64)
      return fa::launch<fa::BfSmem<64>, decltype(&fa::fa_bf16_kernel<64>), fa::bf16>(
          fa::fa_bf16_kernel<64>, q, k, v, out, b, g, st);
    if (hd == 128)
      return fa::launch<fa::BfSmem<128>, decltype(&fa::fa_bf16_kernel<128>), fa::bf16>(
          fa::fa_bf16_kernel<128>, q, k, v, out, b, g, st);
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
