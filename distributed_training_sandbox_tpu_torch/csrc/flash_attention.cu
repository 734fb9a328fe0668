// Causal GQA flash attention, forward and backward, bf16 in, f32 softmax.
//
// Replaces: distributed_training_sandbox_tpu/models/transformer.py,
// _attention_flash (jax's splash attention kernel: its forward
// pallas_calls and its dq / dkv backward pallas_calls), the attention of
// every layer under attention_impl="flash".
//
// Computes, for q (B, S, nq, hd) and k, v (B, S, nkv, hd), hd 64 or 128
// (every kernel and launcher is a template on HD), with nkv dividing nq (query head h reads kv head h / (nq / nkv); K and V are
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
// At hd 64 (Llama-3.2-1B's and the corpus configs' heads) a tile's row
// is one 128-byte swizzled column block instead of two, QKᵀ takes four
// k16 steps instead of eight, and PV, dV, dK and dQ run on wgmma
// m64n64k16 instead of m64n128k16; the numerics are the hd-128 path's.
//
// Design, for Hopper: one warpgroup a block, two blocks an SM, the
// streamed tiles through rings of 4-D TMA loads (hopper.cuh heads_map,
// 128-byte swizzled, zeros past S) that one thread issues, completing on
// an mbarrier a stage.
//
// Forward: one block per (query head, 64 queries, batch), the query
// tiles longest first across every head.  Q is resident (one TMA load);
// the causal key tiles of 64 stream K and V through rings of 2 stages
// each.  S = Q Kᵀ runs on wgmma m64n64k16 (both operands K-major), the
// online softmax (running max m and sum l per row, the accumulator
// rescaled by exp(m_old - m_new)) in registers; exp(s - m) is rounded
// to bf16 in the A-operand register layout and O += P V runs on wgmma
// m64n128k16 with V read MN-major (the descriptor's transpose), while l
// sums the f32 values.  Tile j's scores are issued before tile j - 1's
// PV, so that the exponentials of tile j overlap that product; a stage
// is refilled once both products that read it have completed.  Only
// the diagonal tile (which alone can hold keys past S) is masked
// element by element.  One warpgroup and two stages measured fastest on
// an H100 (two warpgroups sharing the K/V tiles meet at every stage and
// wait for each other; three stages leave one block an SM).  A product
// issued under a condition made ptxas serialise every wgmma (warning
// C7514) and cost the forward a quarter of its speed, so the tile loop
// issues and retires each product unconditionally.
//
// Backward: three kernels, no float atomics, so a run
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
constexpr int kThreads = 128;   // 4 warps (the D kernel)

// the row sum l takes each probability as computed, in f32
__device__ __forceinline__ float lsum_term(float p) { return p; }
// the forward scales the f32 score as the tensor cores summed it
__device__ __forceinline__ float fwd_score(float s, float scale) { return s * scale; }
// the backward reads the forward's f32 logsumexp as stored
__device__ __forceinline__ float lse_in(float x) { return x; }
// the k16 steps of a product over hd (QKᵀ, dO Vᵀ)
__host__ __device__ constexpr int qk_steps(int hd) { return hd / 16; }
// the accumulator registers of a 64 x hd product (O, dK, dV, dQ) a thread
__host__ __device__ constexpr int acc_regs(int hd) { return hd / 2; }

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

struct Geom {
  int S, nq, nkv;
  float scale;
};

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
// x hd bf16 tile is hd / 64 128-byte swizzled column blocks of 64 rows
// x 128 bytes (hopper.cuh); the same tile serves as a K-major operand (a
// product over hd) and as an MN-major B (a product over its rows, the
// descriptor's transpose).

constexpr int kWgThreads = 128;  // one warpgroup a block
constexpr int kBlocksPerSm = 2;   // what registers and shared memory allow
constexpr int kBwdStages = 2;     // ring depth
constexpr int kQt = 64;           // dK/dV: queries a ring step
constexpr int kKt = 64;           // dQ: keys a ring step

// bytes of a rows x HD bf16 tile, and its column block cb
template <int HD>
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * HD * 2; }
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

// Issue the copies of rows [s0, s0 + R) of head hh of a (B, S, nh, HD)
// tensor into the swizzled tile dst (rows past S are zeros), spread over
// the block's threads.
template <int HD, int R>
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const bf16* __restrict__ src,
                                          int b, int S, int nh, int hh,
                                          int s0) {
  constexpr int kChunks = HD / 8;   // 16-byte chunks of a row
  for (int i = threadIdx.x; i < R * kChunks; i += kWgThreads) {
    const int r = i / kChunks, c = i % kChunks, s = s0 + r;
    const bool ok = s < S;
    const bf16* p =
        ok ? src + ((static_cast<int64_t>(b) * S + s) * nh + hh) * HD + c * 8
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
// rows x hd) MN-major
__device__ __forceinline__ uint64_t over_rows(const uint8_t* t, int kk) {
  return hop::sw128_desc(t + kk * 16 * 128, 64 * 128, 1024);
}

// d1 = A1 · B1ᵀ and d2 = A2 · B2ᵀ over hd, each operand a 64-row tile:
// the two chains of hd / 16 wgmma k16 steps interleaved, so that neither
// waits on its own last step
template <int HD>
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
  for (int kk = 0; kk < qk_steps(HD); ++kk) {
    hop::wgmma_m64n64k16_bf16_ss(d1, over_hd(a1, kk), over_hd(b1, kk));
    hop::wgmma_m64n64k16_bf16_ss(d2, over_hd(a2, kk), over_hd(b2, kk));
  }
}

// acc (64 x hd) += A (64 x 16, bf16 fragments in registers) times B (16
// x hd, shared, MN-major); the accumulator's N = hd / 2 registers a
// thread pick the shape
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&acc)[N], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 32 || N == 64, "hd 64 or 128");
  if constexpr (N == 32)
    hop::wgmma_m64n64k16_bf16_rs_tb(acc, a, db);
  else
    hop::wgmma_m64n128k16_bf16_rs_tb(acc, a, db);
}

// acc (64 x hd) += A (64 x 64, bf16 fragments in registers) times the
// 64-row tile t (rows the contraction, hd the columns)
template <int N>
__device__ __forceinline__ void acc_rows(float (&acc)[N],
                                         const uint32_t (&a)[4][4],
                                         const uint8_t* t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_pv(acc, a[kk], over_rows(t, kk));
}

// dV += Pᵀ dO (where with_dv) and dK += dSᵀ Q over one query tile, the
// two chains interleaved
template <int N>
__device__ __forceinline__ void accumulate_dv_dk(
    float (&dva)[N], const uint32_t (&pa)[4][4], const uint8_t* dos,
    float (&dka)[N], const uint32_t (&da)[4][4], const uint8_t* qs,
    bool with_dv) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (with_dv) wgmma_pv(dva, pa[kk], over_rows(dos, kk));
    wgmma_pv(dka, da[kk], over_rows(qs, kk));
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
template <int HD>
constexpr int kKvStage =
    ((2 * tile_bytes<HD>(kQt) + 2 * kQt * 4 + 1023) / 1024) * 1024;
template <int HD>
constexpr int kKvSmem =
    2 * tile_bytes<HD>(kKvKeys) + kBwdStages * (kKvStage<HD> + 8) + 1008;

template <int HD>
__global__ void __launch_bounds__(kWgThreads, kBlocksPerSm)
fa_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const float* __restrict__ lse,
                   const float* __restrict__ dvec, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Geom G) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ks = hop::align1024(smem_raw);
  uint8_t* const vs = ks + tile_bytes<HD>(kKvKeys);
  auto stage = [&](int j) {
    return vs + tile_bytes<HD>(kKvKeys) + (j % kBwdStages) * kKvStage<HD>;
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
      vs + tile_bytes<HD>(kKvKeys) + kBwdStages * kKvStage<HD>);

  if (tid == 0) {
    for (int i = 0; i < kBwdStages; ++i) hop::mbar_init(&full[i], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  load_tile<HD, kKvKeys>(ks, k, b, S, G.nkv, kh, k0);
  load_tile<HD, kKvKeys>(vs, v, b, S, G.nkv, kh, k0);
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
        hop::mbar_expect_tx(bar, 2 * tile_bytes<HD>(kQt));
        for (int cb = 0; cb < HD / 64; ++cb) {
          hop::tma_load_4d(col_block(st, kQt, cb), &tq, bar, 64 * cb, h, q0,
                           b);
          hop::tma_load_4d(col_block(st + tile_bytes<HD>(kQt), kQt, cb), &tdo,
                           bar, 64 * cb, h, q0, b);
        }
      }
      float* ls = reinterpret_cast<float*>(st + 2 * tile_bytes<HD>(kQt));
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

  float dka[acc_regs(HD)], dva[acc_regs(HD)];
#pragma unroll
  for (int i = 0; i < acc_regs(HD); ++i) dka[i] = dva[i] = 0.f;

  for (int j = 0; j < n_items; ++j) {
    hop::cp_async_wait<kBwdStages - 2>();
    hop::mbar_wait(&full[j % kBwdStages], (j / kBwdStages) & 1);
    hop::fence_proxy_async();
    __syncthreads();   // step j has landed and step j - 1 is consumed
    issue(j + kBwdStages - 1);
    const int q0 = k0 + (j % n_qt) * kQt;
    const uint8_t* qs = stage(j);
    const uint8_t* dos = qs + tile_bytes<HD>(kQt);
    const float* lse_s =
        reinterpret_cast<const float*>(qs + 2 * tile_bytes<HD>(kQt));
    const float* d_s = lse_s + kQt;

    float st[32], dpt[32];
    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ
    scores64x2<HD>(st, ks, qs, dpt, vs, dos);
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
    const int64_t row = ((static_cast<int64_t>(b) * S + s) * G.nkv + kh) * HD;
#pragma unroll
    for (int jb = 0; jb < HD / 8; ++jb) {
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
template <int HD>
constexpr int kDqStage = 2 * tile_bytes<HD>(kKt);
template <int HD>
constexpr int kDqSmem =
    2 * tile_bytes<HD>(kDqRows) + kBwdStages * (kDqStage<HD> + 8) + 1008;

template <int HD>
__global__ void __launch_bounds__(kWgThreads, kBlocksPerSm)
fa_bwd_dq_kernel(const bf16* __restrict__ q,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dvec,
                 bf16* __restrict__ dq, Geom G) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const qs = hop::align1024(smem_raw);
  uint8_t* const dos = qs + tile_bytes<HD>(kDqRows);
  auto stage = [&](int j) {
    return dos + tile_bytes<HD>(kDqRows) + (j % kBwdStages) * kDqStage<HD>;
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
      dos + tile_bytes<HD>(kDqRows) + kBwdStages * kDqStage<HD>);
  if (tid == 0) {
    for (int i = 0; i < kBwdStages; ++i) hop::mbar_init(&full[i], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  load_tile<HD, kDqRows>(qs, q, b, S, G.nq, h, q0);
  load_tile<HD, kDqRows>(dos, dout, b, S, G.nq, h, q0);
  hop::cp_async_commit();
  // ring step j: the keys from 64 j, K and V by TMA (one thread)
  auto issue = [&](int j) {
    if (j < n_kt && tid == 0) {
      uint64_t* bar = &full[j % kBwdStages];
      hop::mbar_expect_tx(bar, 2 * tile_bytes<HD>(kKt));
      for (int cb = 0; cb < HD / 64; ++cb) {
        hop::tma_load_4d(col_block(stage(j), kKt, cb), &tk, bar, 64 * cb, kh,
                         j * kKt, b);
        hop::tma_load_4d(col_block(stage(j) + tile_bytes<HD>(kKt), kKt, cb),
                         &tv, bar, 64 * cb, kh, j * kKt, b);
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
  float dqa[acc_regs(HD)];
#pragma unroll
  for (int i = 0; i < acc_regs(HD); ++i) dqa[i] = 0.f;

  hop::cp_async_wait<0>();   // Q and dO
  hop::fence_proxy_async();
  for (int j = 0; j < n_kt; ++j) {
    hop::mbar_wait(&full[j % kBwdStages], (j / kBwdStages) & 1);
    __syncthreads();   // tile j has landed and tile j - 1 is consumed
    issue(j + kBwdStages - 1);
    const uint8_t* kst = stage(j);
    const uint8_t* vst = kst + tile_bytes<HD>(kKt);
    const int t0 = j * kKt;

    float sc[32], dp[32];
    // S = Q Kᵀ and dP = dO Vᵀ
    scores64x2<HD>(sc, qs, kst, dp, dos, vst);
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
    bf16* o = dq + ((static_cast<int64_t>(b) * S + row[r]) * G.nq + h) * HD;
#pragma unroll
    for (int jb = 0; jb < HD / 8; ++jb) {
      const int d = 8 * jb + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(
          dqa[4 * jb + 2 * r] * G.scale, dqa[4 * jb + 2 * r + 1] * G.scale);
    }
  }
}

// ------------------------------------------------------------- forward

// One block per (query head, 64 queries, batch): one warpgroup with its
// 64 query rows resident; the causal key tiles of 64 stream K and V
// through a K ring and a V ring of kFwdStages each.  Tile j's S = Q Kᵀ
// is issued before tile j - 1's O += P V, so that tile j's exponentials
// run while the tensor cores take that product; once both have
// completed, K stage j and V stage j - 1 are refilled.
constexpr int kFwdStages = 2;
template <int HD>
constexpr int kFwdSmem = tile_bytes<HD>(64) +
                         2 * kFwdStages * tile_bytes<HD>(kKt) +
                         (2 * kFwdStages + 1) * 8 + 1008;

template <int HD>
__global__ void __launch_bounds__(kWgThreads, kBlocksPerSm)
fa_fwd_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
              float* __restrict__ lse, Geom G) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const qs = hop::align1024(smem_raw);
  uint8_t* const kring = qs + tile_bytes<HD>(64);
  uint8_t* const vring = kring + kFwdStages * tile_bytes<HD>(kKt);
  // the TMA completions (K stages, V stages, then Q), after the rings
  uint64_t* const kfull =
      reinterpret_cast<uint64_t*>(vring + kFwdStages * tile_bytes<HD>(kKt));
  uint64_t* const vfull = kfull + kFwdStages;
  uint64_t* const qfull = vfull + kFwdStages;
  auto ktile = [&](int j) {
    return kring + (j % kFwdStages) * tile_bytes<HD>(kKt);
  };
  auto vtile = [&](int j) {
    return vring + (j % kFwdStages) * tile_bytes<HD>(kKt);
  };
  const int S = G.S;
  const int h = blockIdx.x, b = blockIdx.z, kh = h / (G.nq / G.nkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;   // longest first
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the key tiles end at the rows' diagonal tile
  const int jlast = q0 / kKt, n_kt = jlast + 1;

  // rows [s0, s0 + 64) of head hh of a map into dst, completing on bar
  auto load = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int hh,
                  int s0) {
    hop::mbar_expect_tx(bar, tile_bytes<HD>(kKt));
    for (int cb = 0; cb < HD / 64; ++cb)
      hop::tma_load_4d(col_block(dst, kKt, cb), map, bar, 64 * cb, hh, s0, b);
  };
  if (tid == 0) {
    for (int i = 0; i < kFwdStages; ++i) {
      hop::mbar_init(&kfull[i], 1);
      hop::mbar_init(&vfull[i], 1);
    }
    hop::mbar_init(qfull, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();   // the barriers are initialised
  if (tid == 0) {
    load(qs, &tq, qfull, h, q0);
    for (int j = 0; j < kFwdStages && j < n_kt; ++j) {
      load(ktile(j), &tk, &kfull[j], kh, j * kKt);
      load(vtile(j), &tv, &vfull[j], kh, j * kKt);
    }
  }

  int row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row[r] = q0 + 16 * warp + lane / 4 + 8 * r;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  float sc[32], oacc[acc_regs(HD)];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < acc_regs(HD); ++i) oacc[i] = 0.f;

  // S = Q K_jᵀ, issued as one wgmma group
  auto scores = [&](int j) {
    hop::mbar_wait(&kfull[j % kFwdStages], (j / kFwdStages) & 1);
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    hop::fence_regs(sc);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < qk_steps(HD); ++kk)
      hop::wgmma_m64n64k16_bf16_ss(sc, over_hd(qs, kk), over_hd(ktile(j), kk));
    hop::wgmma_commit();
  };
  // O += P V_j (P the bf16 fragments in pa), issued as one wgmma group
  auto pv = [&](int j) {
    hop::mbar_wait(&vfull[j % kFwdStages], (j / kFwdStages) & 1);
    hop::fence_regs(oacc);
    hop::wgmma_fence();
    acc_rows(oacc, pa, vtile(j));   // O += P V
    hop::wgmma_commit();
  };
  // the online softmax of tile j's scores: scaled f32 scores, masked
  // on the diagonal tile (key t visible to row s iff t <= s, and
  // t < S), the new row max, corr = exp(m_old - m_new), sc =
  // exp(s - m_new) in f32 and l = l · corr + the row's sum of them; key
  // j · 64 <= q0 is visible to every row, so the max is finite
  auto softmax = [&](int j) {
    auto body = [&](bool masked) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e / 2) % 2, key = j * kKt + acc_col(e, lane);
        const float x = !masked || (key <= row[r] && key < S)
                            ? fwd_score(sc[e], G.scale)
                            : -INFINITY;
        sc[e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = expf(m[r] - mn);
        m[r] = mn;
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e / 2) % 2;
        const float p = expf(sc[e] - m[r]);
        sc[e] = p;
        ls[r] += lsum_term(p);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];
    };
    if (j == jlast)
      body(true);
    else
      body(false);
  };
  // exp(s - m) rounded to bf16, in the A layout of the PV product
  auto pack = [&]() {
#pragma unroll
    for (int e = 0; e < 32; e += 2)
      pa[e / 8][(e % 8) / 2] = pack2(sc[e], sc[e + 1]);
  };
  // after tile j's scores and tile j - 1's PV: K stage j and V stage
  // j - 1 are free for tiles j + kFwdStages and j - 1 + kFwdStages
  auto refill = [&](int j) {
    __syncthreads();
    if (tid == 0) {
      if (j + kFwdStages < n_kt)
        load(ktile(j), &tk, &kfull[j % kFwdStages], kh,
             (j + kFwdStages) * kKt);
      if (j >= 1 && j - 1 + kFwdStages < n_kt)
        load(vtile(j - 1), &tv, &vfull[(j - 1) % kFwdStages], kh,
             (j - 1 + kFwdStages) * kKt);
    }
  };

  hop::mbar_wait(qfull, 0);
  scores(0);
  hop::wgmma_wait<0>();
  hop::fence_regs(sc);
  softmax(0);
  refill(0);
  pack();
  for (int j = 1; j < n_kt; ++j) {
    scores(j);
    pv(j - 1);
    hop::wgmma_wait<1>();   // S_j
    hop::fence_regs(sc);
    softmax(j);             // while O += P_{j-1} V_{j-1} runs
    hop::wgmma_wait<0>();
    hop::fence_regs(oacc);
    refill(j);
#pragma unroll
    for (int i = 0; i < acc_regs(HD); ++i) oacc[i] *= corr[(i / 2) % 2];
    pack();
  }
  pv(n_kt - 1);
  hop::wgmma_wait<0>();
  hop::fence_regs(oacc);

#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    bf16* out = o + ((static_cast<int64_t>(b) * S + row[r]) * G.nq + h) * HD;
#pragma unroll
    for (int jb = 0; jb < HD / 8; ++jb) {
      const int d = 8 * jb + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(out + d) =
          __floats2bfloat162_rn(oacc[4 * jb + 2 * r] / l[r],
                                oacc[4 * jb + 2 * r + 1] / l[r]);
    }
    if (lane % 4 == 0)
      lse[(static_cast<int64_t>(b) * G.nq + h) * S + row[r]] =
          m[r] + logf(l[r]);
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
  CUtensorMap tq, tk, tv;
  if (!hop::heads_map(&tq, q, B, G.S, G.nq, HD, 64) ||
      !hop::heads_map(&tk, k, B, G.S, G.nkv, HD, kKt) ||
      !hop::heads_map(&tv, v, B, G.S, G.nkv, HD, kKt))
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = set_smem(fa_fwd_kernel<HD>, kFwdSmem<HD>, true)) return err;
  fa_fwd_kernel<HD><<<dim3(G.nq, (G.S + 63) / 64, B), kWgThreads,
                      kFwdSmem<HD>, st>>>(tq, tk, tv, static_cast<bf16*>(o),
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

  CUtensorMap tq, tdo, tk, tv;
  if (!hop::heads_map(&tq, q, B, G.S, G.nq, HD, kQt) ||
      !hop::heads_map(&tdo, dout, B, G.S, G.nq, HD, kQt) ||
      !hop::heads_map(&tk, k, B, G.S, G.nkv, HD, kKt) ||
      !hop::heads_map(&tv, v, B, G.S, G.nkv, HD, kKt))
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = set_smem(fa_bwd_dkdv_kernel<HD>, kKvSmem<HD>, true))
    return err;
  fa_bwd_dkdv_kernel<HD><<<dim3((G.S + kKvKeys - 1) / kKvKeys, G.nkv, B),
                           kWgThreads, kKvSmem<HD>, st>>>(
      tq, tdo, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), G);
  if (int err = static_cast<int>(cudaGetLastError())) return err;

  if (int err = set_smem(fa_bwd_dq_kernel<HD>, kDqSmem<HD>, true))
    return err;
  fa_bwd_dq_kernel<HD><<<dim3((G.S + kDqRows - 1) / kDqRows, G.nq, B),
                         kWgThreads, kDqSmem<HD>, st>>>(
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
// lse (B, nq, S) f32.  hd is 128 (SmolLM3's, Qwen3's) or 64 (Llama-3.2-1B's,
// SmolLM3-350M's).  Returns cudaGetLastError().
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, void* o, void* lse, int B,
                                     int S, int nq, int nkv, int hd,
                                     float scale, void* stream) {
  if (bad_geom(B, S, nq, nkv) || (hd != 128 && hd != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom G{S, nq, nkv, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd == 64 ? fwd<64>(q, k, v, o, lse, B, G, st)
                  : fwd<128>(q, k, v, o, lse, B, G, st);
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
  if (bad_geom(B, S, nq, nkv) || (hd != 128 && hd != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom G{S, nq, nkv, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd == 64
             ? bwd<64>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, G, st)
             : bwd<128>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, G, st);
}
