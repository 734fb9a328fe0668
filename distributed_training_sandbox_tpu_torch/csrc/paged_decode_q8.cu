// Paged-attention decode (S == 1) over an int8 KV page pool: K2.
//
// Replaces: distributed_training_sandbox_tpu/ops/paged_attention.py,
// paged_attention_decode (int8 branch: _decode_kernel_q8, _gather_pool).
//
// Computes what the reference computes, for every slot b and kv head g,
// with the rep grouped query rows quantised to int8 (codes qq, row
// scales qs) against the slot's pages read IN PLACE through the page
// table (int8 codes with one f32 scale per row, ks and vs):
//   score  = ((f32(qq · k) · qs) · ks) · f32(1/sqrt(hd)), the int32 dot
//            exact; the reference's `/ math.sqrt(hd)` becomes that
//            multiplication under jax.jit;
//   p      = softmax over positions <= apos[b] (masked ones get 0);
//   pvw    = p · vs, requantised per query row over ALL its positions:
//            sc = absmax · f32(1/127), code = rint(pvw / sc) clipped;
//   out    = f32(sum of code · v) · sc, the PV sum exact in int32.
// Output f32 (B, 1, n_kv, rep, hd), the layout of the reference.
//
// What bounds it on an H100: bytes.  Each (b, g) reads its visible K and
// V rows (2 · (apos+1) · (hd + 4) bytes) for about 4 · rep · hd integer
// operations per position: far below the card's operations per byte.
//
// Design: K1's (csrc/paged_decode.cu).  The positions of a slot are cut
// into chunks of 256; one block of 4 warps per (b, g, chunk); chunks
// wholly past apos[b] exit at once.  Each warp takes 32-key tiles: the
// lanes stage the tile's K rows in shared memory as 32-bit words (rows
// padded to an odd number of words), then each lane scores its key
// against the rep query rows with __dp4a.  The row-wide requantisation
// needs the softmax max and sum and then the absmax of pvw over the
// whole row before the first code, so there are four launches:
//  1 decode_stats: per chunk, the running max and sum of exp(s - max);
//  2 decode_amax:  per chunk, the absmax of pvw, from the folded row
//                  max and sum;
//  3 decode_pv:    the row's scale from the chunks' absmaxes, the codes,
//                  and the chunk's exact int32 PV sum, written as
//                  f32(sum) · sc (exact below 2^24: |sum| <= 127² · 256);
//  4 decode_sum:   the chunks' partial sums.
// K is read three times and V twice (V's scales in pass 2).
//
// Numerics vs the reference: the same operations; the softmax sum runs
// in another order and expf is the card's, so a probability can differ
// by an f32 ulp, which now and then moves a code across a rounding
// boundary (one step of sc · |v|).  The kernel is held to an allclose
// limit set between its reading and a mutant's (ops/paged_attention.py).

#include "paged_common.cuh"

namespace {

constexpr int kWarps = 4;                   // warps per block
constexpr int kTile = 32;                   // keys per tile = lanes
constexpr int kChunk = 2 * kWarps * kTile;  // positions per block: 256
constexpr int kMaxRep = 8;                  // query rows per kv head
constexpr int kMaxWords = 32;               // hd / 4 <= 32: hd <= 128

struct Geom {
  int P, page, nkv, rep, hd, W;   // W = hd / 4 words per row
  float inv_root_hd;
};

// Shared memory of one block: the q codes as words, the q scales, the
// per-warp codes of the current tile, the per-warp K tiles (reused for
// the merges at the end).
struct Smem {
  int* qw;
  float* qs;
  int* codes;
  int* kt;
  __device__ Smem(int* base, const Geom& G) {
    qw = base;
    qs = reinterpret_cast<float*>(qw + G.rep * G.W);
    codes = reinterpret_cast<int*>(qs + kMaxRep);
    kt = codes + kWarps * G.rep * kTile;
  }
};

__device__ __forceinline__ void load_q(const int8_t* qq, const float* qsc,
                                       Smem& sm, int bg, const Geom& G) {
  const int* qb = reinterpret_cast<const int*>(qq) +
                  static_cast<int64_t>(bg) * G.rep * G.W;
  for (int i = threadIdx.x; i < G.rep * G.W; i += blockDim.x) sm.qw[i] = qb[i];
  if (threadIdx.x < G.rep)
    sm.qs[threadIdx.x] = qsc[static_cast<int64_t>(bg) * G.rep + threadIdx.x];
}

__device__ __forceinline__ int64_t scale_row(int pg, int off, int g,
                                             const Geom& G) {
  return (static_cast<int64_t>(pg) * G.page + off) * G.nkv + g;
}

// Stage this warp's K tile at t0 and score lane's key against the rep
// query rows; s[r] = -inf where the key is past `last`.  Returns the
// lane's page id (the page of key t0 + lane).
__device__ int tile_scores(const int8_t* __restrict__ pk,
                           const float* __restrict__ pks,
                           const int* __restrict__ prow, const Smem& sm,
                           int* my_k, int t0, int last, int g, const Geom& G,
                           float s[kMaxRep]) {
  const int lane = threadIdx.x % 32;
  const int pos = t0 + lane;
  const bool vis = pos <= last;
  const int pg_lane = vis ? prow[pos / G.page] : 0;
  const int W = G.W;
  for (int t = 0; t < kTile; ++t) {
    const int pg = __shfl_sync(0xffffffffu, pg_lane, t);
    if (t0 + t <= last && lane < W)
      my_k[t * (W + 1) + lane] = reinterpret_cast<const int*>(
          pk + dts::pool_row(pg, (t0 + t) % G.page, g, G.page, G.nkv,
                             G.hd))[lane];
  }
  __syncwarp();
  const float ks = vis ? pks[scale_row(pg_lane, pos % G.page, g, G)] : 0.f;
  // register arrays are indexed by unrolled constants
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r >= G.rep) break;
    int acc = 0;
    for (int d = 0; d < W; ++d)
      acc = __dp4a(sm.qw[r * W + d], my_k[lane * (W + 1) + d], acc);
    s[r] = vis ? ((__int2float_rn(acc) * sm.qs[r]) * ks) * G.inv_root_hd
               : -INFINITY;
  }
  return pg_lane;
}

// Fold the chunks' (max, sum) into the row's softmax max and sum.
__device__ __forceinline__ void fold_stats(const float* __restrict__ stats,
                                           int bg, int nchunks, int used,
                                           int r, int rep, float* ML) {
  const float* st = stats + static_cast<int64_t>(bg) * nchunks * rep * 2;
  float M = -INFINITY, L = 0.f;
  for (int c = 0; c < used; ++c) M = fmaxf(M, st[(c * rep + r) * 2]);
  for (int c = 0; c < used; ++c)
    L += st[(c * rep + r) * 2 + 1] * expf(st[(c * rep + r) * 2] - M);
  ML[2 * r] = M;
  ML[2 * r + 1] = L;
}

__device__ __forceinline__ float pvw_scale(float amax) {
  return amax > 0.f ? amax * (1.0f / 127.0f) : 1.0f;
}

// Pass 1: per (b, g, chunk), the softmax max and sum of the chunk's keys.
__global__ void __launch_bounds__(kWarps * 32)
decode_stats(const int8_t* __restrict__ qq, const float* __restrict__ qsc,
             const int8_t* __restrict__ pk, const float* __restrict__ pks,
             const int* __restrict__ pages, const int* __restrict__ apos,
             float* __restrict__ stats, Geom G) {
  extern __shared__ int smem[];
  const int bg = blockIdx.x, b = bg / G.nkv, g = bg % G.nkv;
  const int kend = min(apos[b], G.P * G.page - 1);
  const int c0 = blockIdx.y * kChunk;
  if (c0 > kend) return;
  const int cend = min(kend, c0 + kChunk - 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Smem sm(smem, G);
  load_q(qq, qsc, sm, bg, G);
  __syncthreads();
  const int* prow = pages + static_cast<int64_t>(b) * G.P;
  int* my_k = sm.kt + warp * kTile * (G.W + 1);

  float m[kMaxRep], l[kMaxRep], s[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) m[r] = -INFINITY, l[r] = 0.f;
  for (int t0 = c0 + warp * kTile; t0 <= cend; t0 += kWarps * kTile) {
    tile_scores(pk, pks, prow, sm, my_k, t0, cend, g, G, s);
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= G.rep) break;
      // key t0 (lane 0) is visible, so m_new is finite
      const float m_new = fmaxf(m[r], dts::warp_max(s[r]));
      const float p = s[r] == -INFINITY ? 0.f : expf(s[r] - m_new);
      l[r] = l[r] * expf(m[r] - m_new) + dts::warp_sum(p);
      m[r] = m_new;
    }
    __syncwarp();
  }
  float* mg = reinterpret_cast<float*>(sm.kt);   // kWarps * rep * 2
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r >= G.rep) break;
    if (lane == 0) {
      mg[(warp * G.rep + r) * 2] = m[r];
      mg[(warp * G.rep + r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < G.rep) {
    const int r = threadIdx.x;
    float M = -INFINITY, L = 0.f;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mg[(w * G.rep + r) * 2]);
    for (int w = 0; w < kWarps; ++w) {
      const float mw = mg[(w * G.rep + r) * 2];
      if (mw != -INFINITY) L += mg[(w * G.rep + r) * 2 + 1] * expf(mw - M);
    }
    float* st = stats + ((static_cast<int64_t>(bg) * gridDim.y + blockIdx.y) *
                             G.rep + r) * 2;
    st[0] = M;
    st[1] = L;
  }
}

// Pass 2: per (b, g, chunk), the absmax of pvw = p · vs over the chunk.
__global__ void __launch_bounds__(kWarps * 32)
decode_amax(const int8_t* __restrict__ qq, const float* __restrict__ qsc,
            const int8_t* __restrict__ pk, const float* __restrict__ pks,
            const float* __restrict__ pvs, const int* __restrict__ pages,
            const int* __restrict__ apos, const float* __restrict__ stats,
            float* __restrict__ pamax, Geom G) {
  extern __shared__ int smem[];
  __shared__ float ML[2 * kMaxRep];
  const int bg = blockIdx.x, b = bg / G.nkv, g = bg % G.nkv;
  const int kend = min(apos[b], G.P * G.page - 1);
  const int c0 = blockIdx.y * kChunk;
  if (c0 > kend) return;
  const int cend = min(kend, c0 + kChunk - 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Smem sm(smem, G);
  load_q(qq, qsc, sm, bg, G);
  if (threadIdx.x < G.rep)
    fold_stats(stats, bg, gridDim.y, kend / kChunk + 1, threadIdx.x, G.rep,
               ML);
  __syncthreads();
  const int* prow = pages + static_cast<int64_t>(b) * G.P;
  int* my_k = sm.kt + warp * kTile * (G.W + 1);

  float a[kMaxRep], s[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) a[r] = 0.f;
  for (int t0 = c0 + warp * kTile; t0 <= cend; t0 += kWarps * kTile) {
    const int pg_lane = tile_scores(pk, pks, prow, sm, my_k, t0, cend, g, G,
                                    s);
    const int pos = t0 + lane;
    const float vs = pos <= cend
                         ? pvs[scale_row(pg_lane, pos % G.page, g, G)] : 0.f;
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= G.rep) break;
      const float p = s[r] == -INFINITY
                          ? 0.f : expf(s[r] - ML[2 * r]) / ML[2 * r + 1];
      a[r] = fmaxf(a[r], dts::warp_max(fabsf(p * vs)));
    }
    __syncwarp();
  }
  float* mg = reinterpret_cast<float*>(sm.kt);   // kWarps * rep
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r >= G.rep) break;
    if (lane == 0) mg[warp * G.rep + r] = a[r];
  }
  __syncthreads();
  if (threadIdx.x < G.rep) {
    const int r = threadIdx.x;
    float A = 0.f;
    for (int w = 0; w < kWarps; ++w) A = fmaxf(A, mg[w * G.rep + r]);
    pamax[(static_cast<int64_t>(bg) * gridDim.y + blockIdx.y) * G.rep + r] = A;
  }
}

// Pass 3: per (b, g, chunk), the codes of pvw at the row's scale and
// their exact int32 sum against V, written as f32(sum) · sc.
__global__ void __launch_bounds__(kWarps * 32)
decode_pv(const int8_t* __restrict__ qq, const float* __restrict__ qsc,
          const int8_t* __restrict__ pk, const int8_t* __restrict__ pv,
          const float* __restrict__ pks, const float* __restrict__ pvs,
          const int* __restrict__ pages, const int* __restrict__ apos,
          const float* __restrict__ stats, const float* __restrict__ pamax,
          float* __restrict__ part, Geom G) {
  extern __shared__ int smem[];
  __shared__ float ML[2 * kMaxRep];
  __shared__ float SC[kMaxRep];
  const int bg = blockIdx.x, b = bg / G.nkv, g = bg % G.nkv;
  const int kend = min(apos[b], G.P * G.page - 1);
  const int c0 = blockIdx.y * kChunk;
  if (c0 > kend) return;
  const int cend = min(kend, c0 + kChunk - 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rep = G.rep, W = G.W;
  Smem sm(smem, G);
  load_q(qq, qsc, sm, bg, G);
  if (threadIdx.x < rep) {
    const int r = threadIdx.x, used = kend / kChunk + 1;
    fold_stats(stats, bg, gridDim.y, used, r, rep, ML);
    const float* pa = pamax + static_cast<int64_t>(bg) * gridDim.y * rep;
    float A = 0.f;
    for (int c = 0; c < used; ++c) A = fmaxf(A, pa[c * rep + r]);
    SC[r] = pvw_scale(A);
  }
  __syncthreads();
  const int* prow = pages + static_cast<int64_t>(b) * G.P;
  int* my_k = sm.kt + warp * kTile * (W + 1);
  int* my_c = sm.codes + warp * rep * kTile;

  int acc[kMaxRep][4];
  float s[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0;
  for (int t0 = c0 + warp * kTile; t0 <= cend; t0 += kWarps * kTile) {
    const int pg_lane = tile_scores(pk, pks, prow, sm, my_k, t0, cend, g, G,
                                    s);
    const int pos = t0 + lane;
    const float vs = pos <= cend
                         ? pvs[scale_row(pg_lane, pos % G.page, g, G)] : 0.f;
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) break;
      int q = 0;
      if (s[r] != -INFINITY) {
        const float p = expf(s[r] - ML[2 * r]) / ML[2 * r + 1];
        q = max(-127, min(127, __float2int_rn(__fdiv_rn(p * vs, SC[r]))));
      }
      my_c[r * kTile + lane] = q;
    }
    __syncwarp();
    const int tn = min(kTile, cend - t0 + 1);
    for (int t = 0; t < tn; ++t) {
      const int pg = __shfl_sync(0xffffffffu, pg_lane, t);
      if (lane < W) {
        const int word = reinterpret_cast<const int*>(
            pv + dts::pool_row(pg, (t0 + t) % G.page, g, G.page, G.nkv,
                               G.hd))[lane];
        const int8_t* v4 = reinterpret_cast<const int8_t*>(&word);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r >= rep) break;
          const int c = my_c[r * kTile + t];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] += c * v4[i];
        }
      }
    }
    __syncwarp();
  }
  // sum the warps' integer sums into the chunk's
  int* mg = sm.kt;   // kWarps * rep * hd
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r >= rep) break;
    if (lane < W) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mg[(warp * rep + r) * G.hd + lane * 4 + i] = acc[r][i];
    }
  }
  __syncthreads();
  float* pb = part + (static_cast<int64_t>(bg) * gridDim.y + blockIdx.y) *
                         rep * G.hd;
  for (int idx = threadIdx.x; idx < rep * G.hd; idx += blockDim.x) {
    int v = 0;
    for (int w = 0; w < kWarps; ++w) v += mg[w * rep * G.hd + idx];
    pb[idx] = __int2float_rn(v) * SC[idx / G.hd];
  }
}

// out[bg] = sum of the partial sums of the chunks holding a visible key
__global__ void decode_sum(const float* __restrict__ part,
                           const int* __restrict__ apos,
                           float* __restrict__ out, int nchunks, Geom G) {
  const int bg = blockIdx.x, b = bg / G.nkv, n = G.rep * G.hd;
  const int used = min(apos[b], G.P * G.page - 1) / kChunk + 1;
  const float* pb = part + static_cast<int64_t>(bg) * nchunks * n;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    float v = 0.f;
    for (int c = 0; c < used; ++c) v += pb[c * n + idx];
    out[static_cast<int64_t>(bg) * n + idx] = v;
  }
}

int64_t nchunks_of(int P, int page) {
  return (static_cast<int64_t>(P) * page + kChunk - 1) / kChunk;
}

}  // namespace

// Floats of scratch the launch needs: per (b, g, chunk) and query row
// the softmax (max, sum), the pvw absmax and the partial PV sum.
extern "C" int64_t paged_decode_q8_scratch_floats(int B, int P, int page,
                                                  int nkv, int rep, int hd) {
  return static_cast<int64_t>(B) * nkv * nchunks_of(P, page) * rep *
         (hd + 3);
}

// qq (B, 1, nkv, rep, hd) int8; qs (B, 1, nkv, rep, 1) f32; pk/pv
// (n_pages, page, nkv, hd) int8; pks/pvs (n_pages, page, nkv, 1) f32;
// pages (B, P) int32; apos (B, 1) int32; scratch f32 of
// paged_decode_q8_scratch_floats; out (B, 1, nkv, rep, hd) f32.  All
// contiguous on one device; hd a multiple of 16, at most 128.  Returns
// cudaGetLastError() after the launches.
extern "C" int paged_decode_q8_launch(const void* qq, const void* qs,
                                      const void* pk, const void* pv,
                                      const void* pks, const void* pvs,
                                      const void* pages, const void* apos,
                                      void* scratch, void* out, int B, int P,
                                      int page, int nkv, int rep, int hd,
                                      void* stream) {
  if (rep < 1 || rep > kMaxRep || hd < 16 || hd > 4 * kMaxWords || hd % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = hd / 4;
  const Geom G{P, page, nkv, rep, hd, W, 1.0f / sqrtf(static_cast<float>(hd))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = static_cast<int>(nchunks_of(P, page));
  const size_t tiles = static_cast<size_t>(kWarps) * kTile * (W + 1);
  const size_t merge = static_cast<size_t>(kWarps) * rep * hd;
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(rep) * W + kMaxRep +
                     static_cast<size_t>(kWarps) * rep * kTile +
                     (tiles > merge ? tiles : merge));
  for (const void* fn : {reinterpret_cast<const void*>(decode_stats),
                         reinterpret_cast<const void*>(decode_amax),
                         reinterpret_cast<const void*>(decode_pv)}) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t rows = static_cast<int64_t>(B) * nkv * nchunks * rep;
  float* stats = static_cast<float*>(scratch);
  float* pamax = stats + rows * 2;
  float* part = pamax + rows;
  const dim3 grid(B * nkv, nchunks);
  const auto* q8 = static_cast<const int8_t*>(qq);
  const auto* qsf = static_cast<const float*>(qs);
  const auto* k8 = static_cast<const int8_t*>(pk);
  const auto* v8 = static_cast<const int8_t*>(pv);
  const auto* ksf = static_cast<const float*>(pks);
  const auto* vsf = static_cast<const float*>(pvs);
  const auto* pg = static_cast<const int*>(pages);
  const auto* ap = static_cast<const int*>(apos);
  decode_stats<<<grid, kWarps * 32, smem, s>>>(q8, qsf, k8, ksf, pg, ap, stats,
                                               G);
  decode_amax<<<grid, kWarps * 32, smem, s>>>(q8, qsf, k8, ksf, vsf, pg, ap,
                                              stats, pamax, G);
  decode_pv<<<grid, kWarps * 32, smem, s>>>(q8, qsf, k8, v8, ksf, vsf, pg, ap,
                                            stats, pamax, part, G);
  decode_sum<<<B * nkv, 128, 0, s>>>(part, ap, static_cast<float*>(out),
                                     nchunks, G);
  return static_cast<int>(cudaGetLastError());
}
