// Causal GQA flash attention, forward and backward, bf16 in, f32 softmax.
//
// Replaces: distributed_training_sandbox_tpu/models/transformer.py,
// _attention_flash (jax's splash attention kernel: its forward
// pallas_calls and its dq / dkv backward pallas_calls), the attention of
// every layer under attention_impl="flash".
//
// Computes, for q (B, S, nq, hd) and k, v (B, S, nkv, hd) with nkv
// dividing nq (query head h reads kv head h / (nq / nkv); K and V are
// never repeated): scores q·k in f32 times `scale` (the plain path's
// order: the f32 scores are scaled, q is not pre-scaled in bf16 as the
// splash path does), key t visible to query s iff t <= s, softmax in
// f32, its weighted sum of V.  The forward writes O (B, S, nq, hd) bf16
// and the row logsumexp (B, nq, S) f32; the backward recomputes the
// probabilities from that logsumexp (the standard recomputation):
// D = rowsum(dO * O), dV = P^T dO, dS = P * (dO V^T - D),
// dQ = scale * dS K, dK = scale * dS^T Q.
//
// What bounds it on an H100: operations.  At S = 8192, hd = 128 a block
// reuses each staged K/V row for 64 query rows, ~2·64 flops per byte, and
// the causal work is 2·B·nq·S²·hd flops forward (2.5x that backward).
// This first version runs its products on the bf16 tensor cores through
// mma.sync m16n8k16 with f32 accumulation; wgmma, TMA and warp
// specialisation are later work (ROADMAP.md).
//
// Design.  Forward: one block of 4 warps per (query tile of 64 rows,
// query head, batch), 16 query rows a warp, Q fragments in registers,
// the tiles issued longest first.  It walks the causal key tiles of 64
// (tiles above the diagonal are never visited), staging K and V with
// cp.async (rows past S zero-filled, and masked), and keeps an online
// softmax: running max m and sum l per row, the accumulator rescaled by
// exp(m_old - m_new).  exp(s - m) is rounded to bf16 to enter the PV
// product, while l sums the f32 values.  Backward: three kernels, no
// float atomics, so a run repeats to the last digit: D per row; dK and
// dV per (key tile of 64, kv head, batch), looping over the group's
// query heads and the causal query tiles of 32 with both accumulators
// in registers; dQ per (query tile of 64, query head, batch), looping
// over the causal key tiles of 32.  Shared rows are padded to hd + 8
// elements, which keeps fragment loads and ldmatrix free of bank
// conflicts.
//
// Numerics vs the plain path (transformer._attention_xla): the plain
// path rounds the NORMALISED probabilities to bf16 before PV; this
// kernel rounds exp(s - m_running) and divides at the end.  Expect
// bf16-level differences in O and f32-level ones in the logsumexp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 64;       // forward query tile, dK/dV key tile, dQ query tile
constexpr int kSub = 32;        // dK/dV query tile, dQ key tile

// the row sum l takes each probability as computed, in f32
__device__ __forceinline__ float lsum_term(float p) { return p; }
// the backward reads the forward's f32 logsumexp as stored
__device__ __forceinline__ float lse_in(float x) { return x; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x8 b16 matrices, transposed: the B fragments of two n8 tiles
// from a row-major [k][n] tile
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage rows [s0, s0 + R) of head hh of a (B, S, nh, HD) tensor into a
// [R][HD + 8] shared tile; rows past S are zero-filled.
template <int HD, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src,
                                          int b, int S, int nh, int hh,
                                          int s0) {
  constexpr int kCh = HD / 8;
  for (int c = threadIdx.x; c < R * kCh; c += kThreads) {
    const int r = c / kCh, cc = (c % kCh) * 8;
    const int s = s0 + r;
    const bool ok = s < S;
    const bf16* p =
        ok ? src + ((static_cast<int64_t>(b) * S + s) * nh + hh) * HD + cc
           : src;
    cp_async16(dst + r * (HD + 8) + cc, p, ok ? 16 : 0);
  }
}

// A fragment (16 rows x 16 of k at column k0) of a [rows][HD + 8] tile
template <int HD>
__device__ __forceinline__ void a_frag(uint32_t a[4], const bf16* tile,
                                       int row0, int k0, int g, int t) {
  const bf16* p = tile + (row0 + g) * (HD + 8) + k0 + t * 2;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * (HD + 8));
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * (HD + 8) + 8);
}

// B fragment (16 of k at column k0 x 8 of n) of a tile stored [n][k]
template <int HD>
__device__ __forceinline__ void b_frag(uint32_t b[2], const bf16* tile,
                                       int n0, int k0, int g, int t) {
  const bf16* p = tile + (n0 + g) * (HD + 8) + k0 + t * 2;
  b[0] = lds32(p);
  b[1] = lds32(p + 8);
}

// acc[HD/8][4] += A (16 x 16·KC, C-fragment layout floats `c[2·KC][4]`,
// rounded to bf16) times the [k][HD] tile rows k0..
template <int HD, int KC>
__device__ __forceinline__ void mma_c_times_tile(float acc[][4],
                                                 const float c[][4],
                                                 const bf16* tile, int k0,
                                                 int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const uint32_t a[4] = {pack2(c[2 * kc][0], c[2 * kc][1]),
                           pack2(c[2 * kc][2], c[2 * kc][3]),
                           pack2(c[2 * kc + 1][0], c[2 * kc + 1][1]),
                           pack2(c[2 * kc + 1][2], c[2 * kc + 1][3])};
    const int kr = k0 + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, tile + kr * (HD + 8) + np * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * np], a, b);
      mma_bf16(acc[2 * np + 1], a, b + 2);
    }
  }
}

struct Geom {
  int S, nq, nkv;
  float scale;
};

// ------------------------------------------------------------- forward

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, Geom G) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kRows * LD;
  bf16* vs = ks + kRows * LD;
  const int S = G.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // longest first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (G.nq / G.nkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = warp * 16;

  load_rows<HD, kRows>(qs, q, b, S, G.nq, h, q0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) a_frag<HD>(qf[kk], qs, wr, kk * 16, g, t);

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float oacc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;

  const int n_tiles = (min(q0 + kRows, S) - 1) / kRows + 1;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kRows;
    __syncthreads();   // the previous tiles are consumed
    load_rows<HD, kRows>(ks, k, b, S, G.nkv, kh, k0);
    cp_async_commit();
    load_rows<HD, kRows>(vs, v, b, S, G.nkv, kh, k0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[kRows / 8][4];
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n) {
        uint32_t bb[2];
        b_frag<HD>(bb, ks, n * 8, kk * 16, g, t);
        mma_bf16(s[n], qf[kk], bb);
      }
    // scale the f32 scores, mask, and take each row's max; key k0 is
    // visible to every row of this tile (k0 <= q0), so the max is finite
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const float x = (col <= row[e / 2] && col < S) ? s[n][e] * G.scale
                                                       : -INFINITY;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - mn);
      m[r] = mn;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e / 2]);
        s[n][e] = p;
        ls[e / 2] += lsum_term(p);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[d][e] *= corr[e / 2];

    cp_async_wait<0>();
    __syncthreads();
    mma_c_times_tile<HD, kRows / 16>(oacc, s, vs, 0, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e / 2];
      if (r < S)
        o[((static_cast<int64_t>(b) * S + r) * G.nq + h) * HD + d * 8 +
          t * 2 + (e & 1)] = __float2bfloat16_rn(oacc[d][e] / l[e / 2]);
    }
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < S)
        lse[(static_cast<int64_t>(b) * G.nq + h) * S + row[r]] =
            m[r] + logf(l[r]);
}

// ------------------------------------------------------------ backward

// D = rowsum(dO * O), one warp per (b, s, h) row, in (B, nq, S) order
template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dot_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                  float* __restrict__ dvec, int B, Geom G) {
  const int idx = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= B * G.S * G.nq) return;
  const int h = idx % G.nq, s = (idx / G.nq) % G.S, b = idx / (G.nq * G.S);
  const int64_t base = static_cast<int64_t>(idx) * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc += __bfloat162float(o[base + d]) * __bfloat162float(dout[base + d]);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[(static_cast<int64_t>(b) * G.nq + h) * G.S + s] = acc;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dvec, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Geom G) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kRows * LD;
  bf16* qs = vs + kRows * LD;
  bf16* dos = qs + kSub * LD;
  float* lse_s = reinterpret_cast<float*>(dos + kSub * LD);
  float* d_s = lse_s + kSub;
  const int S = G.S, rep = G.nq / G.nkv;
  const int k0 = blockIdx.x * kRows;   // early keys have the most queries
  const int kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = warp * 16;
  const int key[2] = {k0 + wr + g, k0 + wr + g + 8};

  load_rows<HD, kRows>(ks, k, b, S, G.nkv, kh, k0);
  load_rows<HD, kRows>(vs, v, b, S, G.nkv, kh, k0);
  cp_async_commit();

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int h = kh * rep + r;
    for (int q0 = k0; q0 < S; q0 += kSub) {
      __syncthreads();   // the previous query tile is consumed
      load_rows<HD, kSub>(qs, q, b, S, G.nq, h, q0);
      load_rows<HD, kSub>(dos, dout, b, S, G.nq, h, q0);
      cp_async_commit();
      if (threadIdx.x < kSub) {
        const int s = q0 + threadIdx.x;
        const int64_t i = (static_cast<int64_t>(b) * G.nq + h) * S + s;
        lse_s[threadIdx.x] = s < S ? lse_in(lse[i]) : 0.f;
        d_s[threadIdx.x] = s < S ? dvec[i] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T (this warp's 16 keys x 32 queries) = K Q^T, then P^T
      float st[kSub / 8][4], dpt[kSub / 8][4];
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ka[4], va[4];
        a_frag<HD>(ka, ks, wr, kk * 16, g, t);
        a_frag<HD>(va, vs, wr, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n) {
          uint32_t bb[2];
          b_frag<HD>(bb, qs, n * 8, kk * 16, g, t);
          mma_bf16(st[n], ka, bb);
          b_frag<HD>(bb, dos, n * 8, kk * 16, g, t);
          mma_bf16(dpt[n], va, bb);   // dP^T = V dO^T
        }
      }
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + t * 2 + (e & 1), qi = q0 + c;
          const float p = (qi >= key[e / 2] && qi < S)
                              ? expf(st[n][e] * G.scale - lse_s[c])
                              : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - d_s[c]);   // dS^T
        }
      mma_c_times_tile<HD, kSub / 16>(dva, st, dos, 0, lane);   // P^T dO
      mma_c_times_tile<HD, kSub / 16>(dka, dpt, qs, 0, lane);   // dS^T Q
    }
  }

#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = key[e / 2];
      if (s < S) {
        const int64_t i =
            ((static_cast<int64_t>(b) * S + s) * G.nkv + kh) * HD + d * 8 +
            t * 2 + (e & 1);
        dk[i] = __float2bfloat16_rn(dka[d][e] * G.scale);
        dv[i] = __float2bfloat16_rn(dva[d][e]);
      }
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dvec,
                 bf16* __restrict__ dq, Geom G) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kRows * LD;
  bf16* ks = dos + kRows * LD;
  bf16* vs = ks + kSub * LD;
  const int S = G.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // longest first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (G.nq / G.nkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = warp * 16;
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};

  load_rows<HD, kRows>(qs, q, b, S, G.nq, h, q0);
  load_rows<HD, kRows>(dos, dout, b, S, G.nq, h, q0);
  cp_async_commit();
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t i = (static_cast<int64_t>(b) * G.nq + h) * S + row[r];
    lr[r] = row[r] < S ? lse_in(lse[i]) : 0.f;
    dr[r] = row[r] < S ? dvec[i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[HD / 16][4], df[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    a_frag<HD>(qf[kk], qs, wr, kk * 16, g, t);
    a_frag<HD>(df[kk], dos, wr, kk * 16, g, t);
  }
  float dqa[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[d][e] = 0.f;

  const int last = min(q0 + kRows, S) - 1;
  for (int k0 = 0; k0 <= last; k0 += kSub) {
    __syncthreads();   // the previous key tile is consumed
    load_rows<HD, kSub>(ks, k, b, S, G.nkv, kh, k0);
    load_rows<HD, kSub>(vs, v, b, S, G.nkv, kh, k0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
    for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n) {
        uint32_t bb[2];
        b_frag<HD>(bb, ks, n * 8, kk * 16, g, t);
        mma_bf16(s[n], qf[kk], bb);
        b_frag<HD>(bb, vs, n * 8, kk * 16, g, t);
        mma_bf16(dp[n], df[kk], bb);   // dP = dO V^T
      }
#pragma unroll
    for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1), r = row[e / 2];
        const float p = (col <= r && r < S)
                            ? expf(s[n][e] * G.scale - lr[e / 2])
                            : 0.f;
        s[n][e] = p * (dp[n][e] - dr[e / 2]);   // dS
      }
    mma_c_times_tile<HD, kSub / 16>(dqa, s, ks, 0, lane);   // dS K
  }

#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e / 2];
      if (r < S)
        dq[((static_cast<int64_t>(b) * S + r) * G.nq + h) * HD + d * 8 +
           t * 2 + (e & 1)] = __float2bfloat16_rn(dqa[d][e] * G.scale);
    }
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int HD>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, Geom G, cudaStream_t st) {
  const int smem = 3 * kRows * (HD + 8) * 2;
  if (int err = set_smem(fa_fwd_kernel<HD>, smem)) return err;
  const dim3 grid((G.S + kRows - 1) / kRows, G.nq, B);
  fa_fwd_kernel<HD><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), G);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* dvec, void* dq, void* dk,
        void* dv, int B, Geom G, cudaStream_t st) {
  const int rows = B * G.S * G.nq, per_block = kThreads / 32;
  fa_bwd_dot_kernel<HD><<<(rows + per_block - 1) / per_block, kThreads, 0,
                          st>>>(static_cast<const bf16*>(o),
                                static_cast<const bf16*>(dout),
                                static_cast<float*>(dvec), B, G);
  if (int err = static_cast<int>(cudaGetLastError())) return err;

  const int smem_kv = (2 * kRows + 2 * kSub) * (HD + 8) * 2 + 2 * kSub * 4;
  if (int err = set_smem(fa_bwd_dkdv_kernel<HD>, smem_kv)) return err;
  fa_bwd_dkdv_kernel<HD>
      <<<dim3((G.S + kRows - 1) / kRows, G.nkv, B), kThreads, smem_kv, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(dvec),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), G);
  if (int err = static_cast<int>(cudaGetLastError())) return err;

  const int smem_q = (2 * kRows + 2 * kSub) * (HD + 8) * 2;
  if (int err = set_smem(fa_bwd_dq_kernel<HD>, smem_q)) return err;
  fa_bwd_dq_kernel<HD>
      <<<dim3((G.S + kRows - 1) / kRows, G.nq, B), kThreads, smem_q, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(dvec),
          static_cast<bf16*>(dq), G);
  return static_cast<int>(cudaGetLastError());
}

bool bad_geom(int B, int S, int nq, int nkv) {
  return B < 1 || S < 1 || nkv < 1 || nq < nkv || nq % nkv || B > 65535 ||
         nq > 65535;
}

}  // namespace

// q (B, S, nq, hd), k / v (B, S, nkv, hd) bf16; o (B, S, nq, hd) bf16;
// lse (B, nq, S) f32.  hd is 128 (SmolLM3's).  Returns cudaGetLastError().
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, void* o, void* lse, int B,
                                     int S, int nq, int nkv, int hd,
                                     float scale, void* stream) {
  if (bad_geom(B, S, nq, nkv) || hd != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom G{S, nq, nkv, scale};
  return fwd<128>(q, k, v, o, lse, B, G, static_cast<cudaStream_t>(stream));
}

// The backward from the forward's o and lse and the output grad dout
// (B, S, nq, hd) bf16: dq like q, dk / dv like k; dvec (B, nq, S) f32
// scratch.  Returns cudaGetLastError().
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     void* dvec, void* dq, void* dk, void* dv,
                                     int B, int S, int nq, int nkv, int hd,
                                     float scale, void* stream) {
  if (bad_geom(B, S, nq, nkv) || hd != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom G{S, nq, nkv, scale};
  return bwd<128>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, G,
                  static_cast<cudaStream_t>(stream));
}
