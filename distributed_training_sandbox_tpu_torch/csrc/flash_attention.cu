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
// What bounds it on an H100: operations.  At S = 8192, hd = 128 the
// causal work is 2·B·nq·S²·hd flops forward (2.5x that backward, 3.5x
// as this backward computes it: dQ forms S and dP again), against a few
// passes over 8 MB tensors.  Only wgmma reaches the bf16 tensor cores'
// 989 TFLOP/s.
//
// Design.  Forward (not yet redesigned; ROADMAP.md): mma.sync m16n8k16
// with f32 accumulation, one block of 4 warps per (query tile of 64
// rows, query head, batch), 16 query rows a warp, Q fragments in
// registers, the tiles issued longest first.  It walks the causal key
// tiles of 64 (tiles above the diagonal are never visited), staging K
// and V with cp.async into rows padded to hd + 8 elements (rows past S
// zero-filled, and masked), and keeps an online softmax: running max m
// and sum l per row, the accumulator rescaled by exp(m_old - m_new).
// exp(s - m) is rounded to bf16 to enter the PV product, while l sums
// the f32 values.
//
// Backward, for Hopper: three kernels, no float atomics, so a run
// repeats to the last digit.  D per row (one warp a row).  dK and dV per
// (64 keys, kv head, batch): one warpgroup holds dK and dV (64 x 128 f32
// each) in registers while the group's query heads and causal query
// tiles of 64 stream through a 2-stage ring (Q and dO by TMA, 128-byte
// swizzled; their logsumexp and D); keys are wgmma's M, so Sᵀ = K Qᵀ and
// dPᵀ = V dOᵀ (m64n64k16, both operands K-major in shared memory, the
// two chains interleaved) come out in the A-operand register layout,
// where Pᵀ and dSᵀ are rounded to bf16 and fed from registers to dV +=
// Pᵀ dO and dK += dSᵀ Q (m64n128k16, dO and Q read MN-major through the
// descriptor's transpose).  dQ per (64 queries, query head, batch): Q
// and dO resident, the causal key tiles of 64 (K, V) through the same
// kind of ring, S and dP again, dQ += dS K with K read MN-major.  Two
// blocks share an SM.  The last query tiles see the most keys and are
// launched first; ragged S and the diagonal are masked element by
// element.  What bounds it in practice is latency: a block's steps
// (wait for the tile, both score chains, the exponentials, the dV / dK
// chains) run in turn, and two blocks an SM hide only part of it.

// Numerics vs the plain path (transformer._attention_xla): the plain
// path rounds the NORMALISED probabilities to bf16 before PV; this
// kernel rounds exp(s - m_running) and divides at the end.  Expect
// bf16-level differences in O and f32-level ones in the logsumexp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 64;       // forward query and key tile

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

// ---- dK/dV and dQ on wgmma.  One warpgroup a block, two blocks an SM
// (a block's dK and dV, or dQ, take most of its 255 registers a thread;
// two independent blocks hide each other's serial steps better than two
// warpgroups of one block that meet at every ring step).  The streamed
// tiles come through a 2-stage ring of TMA loads (4-D maps over (B, S,
// heads, hd), zeros past S) that one thread issues, completing on an
// mbarrier a stage; the block's resident tiles come by cp.async.  A 64
// x 128 bf16 tile is two 128-byte swizzled column blocks of 64 rows x
// 128 bytes (hopper.cuh); the same tile serves as a K-major operand (a
// product over hd) and as an MN-major B (a product over its rows, the
// descriptor's transpose).

constexpr int kWgThreads = 128;  // one warpgroup a block
constexpr int kBlocksPerSm = 2;   // what registers and shared memory allow
constexpr int kBwdStages = 2;     // ring depth
constexpr int kQt = 64;           // dK/dV: queries a ring step
constexpr int kKt = 64;           // dQ: keys a ring step

// bytes of a rows x 128 bf16 tile, and its column block cb
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * 256; }
__device__ __forceinline__ uint8_t* col_block(uint8_t* t, int rows, int cb) {
  return t + cb * rows * 128;
}

// 4 bytes from src to shared dst (zeros where !valid)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hop::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Issue the copies of rows [s0, s0 + R) of head hh of a (B, S, nh, 128)
// tensor into the swizzled tile dst (rows past S are zeros), spread over
// the block's threads.
template <int R>
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const bf16* __restrict__ src,
                                          int b, int S, int nh, int hh,
                                          int s0) {
  for (int i = threadIdx.x; i < R * 16; i += kWgThreads) {
    const int r = i / 16, c = i % 16, s = s0 + r;
    const bool ok = s < S;
    const bf16* p =
        ok ? src + ((static_cast<int64_t>(b) * S + s) * nh + hh) * 128 + c * 8
           : src;
    hop::cp_async16(col_block(dst, R, c / 8) + hop::sw128(r, c % 8), p, ok);
  }
}

// Descriptor of k16 step kk of a product over hd of a 64-row tile
// (K-major operand)
__device__ __forceinline__ uint64_t over_hd(const uint8_t* t, int kk) {
  return hop::sw128_desc(t + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024);
}

// Descriptor of k16 step kk of a product over the tile's 64 rows, B (16
// rows x 128 of hd) MN-major
__device__ __forceinline__ uint64_t over_rows(const uint8_t* t, int kk) {
  return hop::sw128_desc(t + kk * 16 * 128, 64 * 128, 1024);
}

// d1 = A1 · B1ᵀ and d2 = A2 · B2ᵀ over hd, each operand a 64-row tile:
// the two chains of 8 wgmma k16 steps interleaved, so that neither
// waits on its own last step
__device__ __forceinline__ void scores64x2(float (&d1)[32], const uint8_t* a1,
                                           const uint8_t* b1,
                                           float (&d2)[32], const uint8_t* a2,
                                           const uint8_t* b2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d1[i] = d2[i] = 0.f;
  hop::fence_regs(d1);
  hop::fence_regs(d2);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    hop::wgmma_m64n64k16_bf16_ss(d1, over_hd(a1, kk), over_hd(b1, kk));
    hop::wgmma_m64n64k16_bf16_ss(d2, over_hd(a2, kk), over_hd(b2, kk));
  }
}

// acc (64 x 128) += A (64 x 64, bf16 fragments in registers) times the
// 64-row tile t (rows the contraction, hd the columns)
__device__ __forceinline__ void acc_rows(float (&acc)[64],
                                         const uint32_t (&a)[4][4],
                                         const uint8_t* t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma_m64n128k16_bf16_rs_tb(acc, a[kk], over_rows(t, kk));
}

// dV += Pᵀ dO (where with_dv) and dK += dSᵀ Q over one query tile, the
// two chains interleaved
__device__ __forceinline__ void accumulate_dv_dk(
    float (&dva)[64], const uint32_t (&pa)[4][4], const uint8_t* dos,
    float (&dka)[64], const uint32_t (&da)[4][4], const uint8_t* qs,
    bool with_dv) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (with_dv)
      hop::wgmma_m64n128k16_bf16_rs_tb(dva, pa[kk], over_rows(dos, kk));
    hop::wgmma_m64n128k16_bf16_rs_tb(dka, da[kk], over_rows(qs, kk));
  }
}

// Accumulator element e of a 64 x 64 score tile: row 16 warp + lane / 4
// + 8 ((e / 2) % 2), column 8 (e / 4) + 2 (lane % 4) + e % 2; elements
// 8 kk .. 8 kk + 7 are the A fragment of columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ int acc_row(int e, int lane, int warp) {
  return 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
}
__device__ __forceinline__ int acc_col(int e, int lane) {
  return 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
}

// dK and dV: one block per (64 keys, kv head, batch); the group's query
// heads and the causal query tiles of 64 stream through the ring (Q and
// dO by TMA, their logsumexp and D by cp.async).  Keys are the M
// dimension: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ land in the A layout, where Pᵀ
// and dSᵀ are rounded to bf16 for dV += Pᵀ dO and dK += dSᵀ Q.
constexpr int kKvKeys = 64;
constexpr int kKvStage =
    ((2 * tile_bytes(kQt) + 2 * kQt * 4 + 1023) / 1024) * 1024;
constexpr int kKvSmem =
    2 * tile_bytes(kKvKeys) + kBwdStages * (kKvStage + 8) + 1008;

__global__ void __launch_bounds__(kWgThreads, kBlocksPerSm)
fa_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const float* __restrict__ lse,
                   const float* __restrict__ dvec, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Geom G) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ks = hop::align1024(smem_raw);
  uint8_t* const vs = ks + tile_bytes(kKvKeys);
  auto stage = [&](int j) {
    return vs + tile_bytes(kKvKeys) + (j % kBwdStages) * kKvStage;
  };
  const int S = G.S, rep = G.nq / G.nkv;
  const int k0 = blockIdx.x * kKvKeys;   // early keys have the most queries
  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32;
  const int n_qt = (S - k0 + kQt - 1) / kQt;
  const int n_items = rep * n_qt;
  // the ring's TMA completions, one a stage, after the ring
  uint64_t* full = reinterpret_cast<uint64_t*>(
      vs + tile_bytes(kKvKeys) + kBwdStages * kKvStage);

  if (tid == 0) {
    for (int i = 0; i < kBwdStages; ++i) hop::mbar_init(&full[i], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  load_tile<kKvKeys>(ks, k, b, S, G.nkv, kh, k0);
  load_tile<kKvKeys>(vs, v, b, S, G.nkv, kh, k0);
  hop::cp_async_commit();

  // ring step j: query head kh * rep + j / n_qt, queries from
  // k0 + 64 (j % n_qt): Q and dO by TMA (one thread), then the
  // logsumexp and D of each query by cp.async
  auto issue = [&](int j) {
    if (j < n_items) {
      const int h = kh * rep + j / n_qt, q0 = k0 + (j % n_qt) * kQt;
      uint8_t* st = stage(j);
      if (tid == 0) {
        uint64_t* bar = &full[j % kBwdStages];
        hop::mbar_expect_tx(bar, 2 * tile_bytes(kQt));
        for (int cb = 0; cb < 2; ++cb) {
          hop::tma_load_4d(col_block(st, kQt, cb), &tq, bar, 64 * cb, h, q0,
                           b);
          hop::tma_load_4d(col_block(st + tile_bytes(kQt), kQt, cb), &tdo,
                           bar, 64 * cb, h, q0, b);
        }
      }
      float* ls = reinterpret_cast<float*>(st + 2 * tile_bytes(kQt));
      if (tid < 2 * kQt) {
        const int r = tid % kQt, s = q0 + r;
        const int64_t i = (static_cast<int64_t>(b) * G.nq + h) * S + s;
        cp_async4(ls + tid, (tid < kQt ? lse : dvec) + (s < S ? i : 0),
                  s < S);
      }
    }
    hop::cp_async_commit();   // possibly empty: the group count stays even
  };
#pragma unroll
  for (int j = 0; j < kBwdStages - 1; ++j) issue(j);

  float dka[64], dva[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;

  for (int j = 0; j < n_items; ++j) {
    hop::cp_async_wait<kBwdStages - 2>();
    hop::mbar_wait(&full[j % kBwdStages], (j / kBwdStages) & 1);
    hop::fence_proxy_async();
    __syncthreads();   // step j has landed and step j - 1 is consumed
    issue(j + kBwdStages - 1);
    const int q0 = k0 + (j % n_qt) * kQt;
    const uint8_t* qs = stage(j);
    const uint8_t* dos = qs + tile_bytes(kQt);
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * tile_bytes(kQt));
    const float* d_s = lse_s + kQt;

    float st[32], dpt[32];
    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ
    scores64x2(st, ks, qs, dpt, vs, dos);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(st);
    hop::fence_regs(dpt);

    // Pᵀ and dSᵀ, rounded to bf16 in the A layout; only the diagonal
    // tile and one past S are masked element by element
    uint32_t pa[4][4], da[4][4];
    auto p_ds = [&](bool masked) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int key = k0 + acc_row(e, lane, warp);
        float p[2], ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = acc_col(e + u, lane), qi = q0 + c;
          p[u] = !masked || (qi >= key && qi < S)
                     ? expf(st[e + u] * G.scale - lse_in(lse_s[c]))
                     : 0.f;
          ds[u] = p[u] * (dpt[e + u] - d_s[c]);
        }
        pa[e / 8][(e % 8) / 2] = pack2(p[0], p[1]);
        da[e / 8][(e % 8) / 2] = pack2(ds[0], ds[1]);
      }
    };
    if (q0 == k0 || q0 + kQt > S)
      p_ds(true);
    else
      p_ds(false);
    hop::fence_regs(dva);
    hop::fence_regs(dka);
    hop::wgmma_fence();
    accumulate_dv_dk(dva, pa, dos, dka, da, qs, true);   // dV, dK
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dva);
    hop::fence_regs(dka);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = k0 + 16 * warp + lane / 4 + 8 * h;
    if (s >= S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * S + s) * G.nkv + kh) * 128;
#pragma unroll
    for (int jb = 0; jb < 16; ++jb) {
      const int d = 8 * jb + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(dk + row + d) =
          __floats2bfloat162_rn(dka[4 * jb + 2 * h] * G.scale,
                                dka[4 * jb + 2 * h + 1] * G.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + d) =
          __floats2bfloat162_rn(dva[4 * jb + 2 * h], dva[4 * jb + 2 * h + 1]);
    }
  }
}

// dQ: one block per (64 queries, query head, batch), Q and dO resident;
// the causal key tiles of 64 (K, V) stream through the ring by TMA.
// S = Q Kᵀ and dP = dO Vᵀ are computed again here, so that dQ needs no
// float atomics; dS is rounded to bf16 in the A layout for dQ += dS K.
constexpr int kDqRows = 64;
constexpr int kDqStage = 2 * tile_bytes(kKt);
constexpr int kDqSmem =
    2 * tile_bytes(kDqRows) + kBwdStages * (kDqStage + 8) + 1008;

__global__ void __launch_bounds__(kWgThreads, kBlocksPerSm)
fa_bwd_dq_kernel(const bf16* __restrict__ q,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dvec,
                 bf16* __restrict__ dq, Geom G) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const qs = hop::align1024(smem_raw);
  uint8_t* const dos = qs + tile_bytes(kDqRows);
  auto stage = [&](int j) {
    return dos + tile_bytes(kDqRows) + (j % kBwdStages) * kDqStage;
  };
  const int S = G.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;   // longest first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (G.nq / G.nkv);
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32;
  const int last = min(q0 + kDqRows, S) - 1;
  const int n_kt = last / kKt + 1;

  // the ring's TMA completions, one a stage, after the ring
  uint64_t* full = reinterpret_cast<uint64_t*>(
      dos + tile_bytes(kDqRows) + kBwdStages * kDqStage);
  if (tid == 0) {
    for (int i = 0; i < kBwdStages; ++i) hop::mbar_init(&full[i], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  load_tile<kDqRows>(qs, q, b, S, G.nq, h, q0);
  load_tile<kDqRows>(dos, dout, b, S, G.nq, h, q0);
  hop::cp_async_commit();
  // ring step j: the keys from 64 j, K and V by TMA (one thread)
  auto issue = [&](int j) {
    if (j < n_kt && tid == 0) {
      uint64_t* bar = &full[j % kBwdStages];
      hop::mbar_expect_tx(bar, 2 * tile_bytes(kKt));
      for (int cb = 0; cb < 2; ++cb) {
        hop::tma_load_4d(col_block(stage(j), kKt, cb), &tk, bar, 64 * cb, kh,
                         j * kKt, b);
        hop::tma_load_4d(col_block(stage(j) + tile_bytes(kKt), kKt, cb), &tv,
                         bar, 64 * cb, kh, j * kKt, b);
      }
    }
  };
#pragma unroll
  for (int j = 0; j < kBwdStages - 1; ++j) issue(j);

  int row[2];
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + 16 * warp + lane / 4 + 8 * r;
    const int64_t i = (static_cast<int64_t>(b) * G.nq + h) * S + row[r];
    lr[r] = row[r] < S ? lse_in(lse[i]) : 0.f;
    dr[r] = row[r] < S ? dvec[i] : 0.f;
  }
  float dqa[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dqa[i] = 0.f;

  hop::cp_async_wait<0>();   // Q and dO
  hop::fence_proxy_async();
  for (int j = 0; j < n_kt; ++j) {
    hop::mbar_wait(&full[j % kBwdStages], (j / kBwdStages) & 1);
    __syncthreads();   // tile j has landed and tile j - 1 is consumed
    issue(j + kBwdStages - 1);
    const uint8_t* kst = stage(j);
    const uint8_t* vst = kst + tile_bytes(kKt);
    const int t0 = j * kKt;

    float sc[32], dp[32];
    // S = Q Kᵀ and dP = dO Vᵀ
    scores64x2(sc, qs, kst, dp, dos, vst);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    hop::fence_regs(dp);
    // P, f32; only the diagonal tile and one past S are masked element
    // by element
    auto probs = [&](bool masked) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e / 2) % 2, key = t0 + acc_col(e, lane);
        sc[e] = !masked || (key <= row[r] && row[r] < S)
                    ? expf(sc[e] * G.scale - lr[r])
                    : 0.f;
      }
    };
    if (t0 == q0 || q0 + kDqRows > S)
      probs(true);
    else
      probs(false);

    uint32_t da[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = (e / 2) % 2;
      float ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) ds[u] = sc[e + u] * (dp[e + u] - dr[r]);
      da[e / 8][(e % 8) / 2] = pack2(ds[0], ds[1]);
    }
    hop::fence_regs(dqa);
    hop::wgmma_fence();
    acc_rows(dqa, da, kst);   // dQ += dS K
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dqa);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    bf16* o = dq + ((static_cast<int64_t>(b) * S + row[r]) * G.nq + h) * 128;
#pragma unroll
    for (int jb = 0; jb < 16; ++jb) {
      const int d = 8 * jb + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(
          dqa[4 * jb + 2 * r] * G.scale, dqa[4 * jb + 2 * r + 1] * G.scale);
    }
  }
}

// max_shared: the whole L1 as shared memory, so that the backward's
// blocks fit kBlocksPerSm to an SM
template <typename Kernel>
int set_smem(Kernel kernel, int bytes, bool max_shared = false) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && max_shared)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
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

int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* dvec, void* dq, void* dk,
        void* dv, int B, Geom G, cudaStream_t st) {
  const int rows = B * G.S * G.nq, per_block = kThreads / 32;
  fa_bwd_dot_kernel<128><<<(rows + per_block - 1) / per_block, kThreads, 0,
                           st>>>(static_cast<const bf16*>(o),
                                 static_cast<const bf16*>(dout),
                                 static_cast<float*>(dvec), B, G);
  if (int err = static_cast<int>(cudaGetLastError())) return err;

  CUtensorMap tq, tdo, tk, tv;
  if (!hop::heads_map(&tq, q, B, G.S, G.nq, kQt) ||
      !hop::heads_map(&tdo, dout, B, G.S, G.nq, kQt) ||
      !hop::heads_map(&tk, k, B, G.S, G.nkv, kKt) ||
      !hop::heads_map(&tv, v, B, G.S, G.nkv, kKt))
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = set_smem(fa_bwd_dkdv_kernel, kKvSmem, true)) return err;
  fa_bwd_dkdv_kernel<<<dim3((G.S + kKvKeys - 1) / kKvKeys, G.nkv, B),
                       kWgThreads, kKvSmem, st>>>(
      tq, tdo, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), G);
  if (int err = static_cast<int>(cudaGetLastError())) return err;

  if (int err = set_smem(fa_bwd_dq_kernel, kDqSmem, true)) return err;
  fa_bwd_dq_kernel<<<dim3((G.S + kDqRows - 1) / kDqRows, G.nq, B),
                     kWgThreads, kDqSmem, st>>>(
      static_cast<const bf16*>(q), tk, tv, static_cast<const bf16*>(dout),
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
  return bwd(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, G,
             static_cast<cudaStream_t>(stream));
}
