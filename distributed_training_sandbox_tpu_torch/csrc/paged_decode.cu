// Paged-attention decode (S == 1) over a float or bf16 KV page pool.
//
// Replaces: distributed_training_sandbox_tpu/ops/paged_attention.py,
// paged_attention_decode (float branch: _decode_kernel, _gather_pool).
//
// Computes what the reference computes, for every slot b and kv head g:
// the rep grouped query rows against the slot's pages read IN PLACE
// through the page table; scores q·k / sqrt(hd) in f32, positions past
// apos[b] masked, softmax, the probabilities rounded to the pool's type
// (the reference's probs_dtype cast), their weighted sum of V in f32.
// Output f32 (B, 1, n_kv, rep, hd), the layout of the reference.
//
// What bounds it on an H100: bytes.  Each (b, g) reads its visible K and
// V rows (2 · (apos+1) · hd elements) for 4 · rep · hd flops per
// position — about 2 flops per byte, far below the ~295 the card needs
// to be compute-bound.  So the design is about keeping enough loads in
// flight across the whole card.
//
// Design (split-K, "flash decoding", two passes):
//  * the positions of a slot are cut into chunks of kChunk; one block of
//    kWarps warps per (b, g, chunk) gives B · n_kv · ceil(view / kChunk)
//    blocks, enough to fill 132 SMs at B = 8.  Chunks wholly past
//    apos[b] exit at once: masked positions get probability exactly 0 in
//    the reference, so stopping at apos computes the same function while
//    reading only the rows the slot holds;
//  * pass 1 (decode_stats): per chunk, the running max and sum of
//    exp(score - max), each warp over its 32-key tiles (lanes load the
//    tile's page ids once and stage the K tile in shared memory with
//    16-byte loads; each lane scores one key against the rep queries);
//  * pass 2 (decode_pv): every chunk block folds the chunks' (max, sum)
//    into the row's softmax max M and denominator L, scores its keys
//    again, forms p = round(exp(s - M) / L) — the reference's rounded
//    probability — and accumulates p · v in f32, reading each V row once,
//    coalesced, straight from the pool;
//  * decode_sum adds the chunks' partial sums.
// K is read twice and V once: 1.5x the bytes of one pass.  An online
// softmax (one pass) cannot round the NORMALISED probability, and at 36
// layers that rounding decides tokens: without it the logits of the
// SmolLM3-3B smoke moved by 3.5 against the plain path.
//
// Numerics vs the reference: the same operations, in another summation
// order; expect agreement to f32 rounding, and rare one-ulp differences
// where a probability sits on a bf16 rounding boundary.

#include "paged_common.cuh"

namespace {

constexpr int kWarps = 4;                   // warps per block
constexpr int kTile = 32;                   // keys per tile = lanes
constexpr int kChunk = 2 * kWarps * kTile;  // positions per block: 256
constexpr int kMaxRep = 8;                  // query rows per kv head
constexpr int kMaxDs = 4;                   // head dims per lane: hd <= 128

struct Geom {
  int P, page, nkv, rep, hd;
};

// Shared-memory layout of one block: q rows, per-warp probabilities,
// per-warp K tiles (reused at the end for the warp merge).
struct Smem {
  float *qs, *ps, *kt;
  __device__ Smem(float* base, const Geom& G) {
    qs = base;
    ps = qs + G.rep * G.hd;
    kt = ps + kWarps * G.rep * kTile;
  }
};

template <typename T>
__device__ void load_q(const T* q, float* qs, int bg, const Geom& G) {
  const T* qb = q + static_cast<int64_t>(bg) * G.rep * G.hd;
  for (int i = threadIdx.x; i < G.rep * G.hd; i += blockDim.x)
    qs[i] = dts::to_f32(qb[i]);
}

// Stage this warp's K tile at t0 and score lane's key against the rep
// query rows; s[r] = -inf where the key is past `last`.  Returns the
// lane's page id (the page of key t0 + lane), for the V reads.
template <typename T>
__device__ int tile_scores(const T* __restrict__ pk,
                           const int* __restrict__ prow, const float* qs,
                           float* my_k, int t0, int last, int g,
                           const Geom& G, float s[kMaxRep]) {
  const int lane = threadIdx.x % 32;
  const int pos = t0 + lane;
  const bool vis = pos <= last;
  const int pg_lane = vis ? prow[pos / G.page] : 0;
  dts::stage_tile<T>(pk, my_k, G.hd + 1, t0, last, g, G.page, G.nkv, G.hd,
                     lane, 32, [&](int t) {
                       return __shfl_sync(0xffffffffu, pg_lane, t);
                     });
  __syncwarp();
  const float root_hd = sqrtf(static_cast<float>(G.hd));
  // register arrays are indexed by unrolled constants (a runtime index
  // would spill them to local memory)
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r >= G.rep) break;
    float acc = 0.f;
    for (int d = 0; d < G.hd; ++d)
      acc += qs[r * G.hd + d] * my_k[lane * (G.hd + 1) + d];
    s[r] = vis ? acc / root_hd : -INFINITY;
  }
  return pg_lane;
}

// Pass 1: per (b, g, chunk), the softmax max and sum of the chunk's keys.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_stats(const T* __restrict__ q, const T* __restrict__ pk,
             const int* __restrict__ pages, const int* __restrict__ apos,
             float* __restrict__ stats, Geom G) {
  extern __shared__ float smem[];
  const int bg = blockIdx.x, b = bg / G.nkv, g = bg % G.nkv;
  const int kend = min(apos[b], G.P * G.page - 1);
  const int c0 = blockIdx.y * kChunk;
  if (c0 > kend) return;
  const int cend = min(kend, c0 + kChunk - 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Smem sm(smem, G);
  load_q(q, sm.qs, bg, G);
  __syncthreads();
  const int* prow = pages + static_cast<int64_t>(b) * G.P;
  float* my_k = sm.kt + warp * kTile * (G.hd + 1);

  float m[kMaxRep], l[kMaxRep], s[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) m[r] = -INFINITY, l[r] = 0.f;
  for (int t0 = c0 + warp * kTile; t0 <= cend; t0 += kWarps * kTile) {
    tile_scores(pk, prow, sm.qs, my_k, t0, cend, g, G, s);
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
  // merge the warps: (max, sum) of the whole chunk
  float* mg = sm.kt;   // kWarps * rep * 2
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

// Pass 2: per (b, g, chunk), sum over the chunk's keys of the rounded
// probability times v.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_pv(const T* __restrict__ q, const T* __restrict__ pk,
          const T* __restrict__ pv, const int* __restrict__ pages,
          const int* __restrict__ apos, const float* __restrict__ stats,
          float* __restrict__ part, Geom G) {
  extern __shared__ float smem[];
  __shared__ float ML[2 * kMaxRep];
  const int bg = blockIdx.x, b = bg / G.nkv, g = bg % G.nkv;
  const int kend = min(apos[b], G.P * G.page - 1);
  const int c0 = blockIdx.y * kChunk;
  if (c0 > kend) return;
  const int cend = min(kend, c0 + kChunk - 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hd = G.hd, rep = G.rep;
  Smem sm(smem, G);
  load_q(q, sm.qs, bg, G);
  if (threadIdx.x < rep) {
    // fold the chunks' (max, sum) into the row's softmax max and sum
    const int r = threadIdx.x, used = kend / kChunk + 1;
    const float* st = stats + static_cast<int64_t>(bg) * gridDim.y * rep * 2;
    float M = -INFINITY, L = 0.f;
    for (int c = 0; c < used; ++c) M = fmaxf(M, st[(c * rep + r) * 2]);
    for (int c = 0; c < used; ++c)
      L += st[(c * rep + r) * 2 + 1] * expf(st[(c * rep + r) * 2] - M);
    ML[2 * r] = M;
    ML[2 * r + 1] = L;
  }
  __syncthreads();
  const int* prow = pages + static_cast<int64_t>(b) * G.P;
  float* my_k = sm.kt + warp * kTile * (hd + 1);
  float* my_p = sm.ps + warp * rep * kTile;

  float acc[kMaxRep][kMaxDs], s[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int i = 0; i < kMaxDs; ++i) acc[r][i] = 0.f;
  for (int t0 = c0 + warp * kTile; t0 <= cend; t0 += kWarps * kTile) {
    const int pg_lane = tile_scores(pk, prow, sm.qs, my_k, t0, cend, g, G, s);
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) break;
      my_p[r * kTile + lane] =
          s[r] == -INFINITY
              ? 0.f
              : dts::round_to<T>(expf(s[r] - ML[2 * r]) / ML[2 * r + 1]);
    }
    __syncwarp();
    const int tn = min(kTile, cend - t0 + 1);
    for (int t = 0; t < tn; ++t) {
      const int pg = __shfl_sync(0xffffffffu, pg_lane, t);
      const T* vrow = pv + dts::pool_row(pg, (t0 + t) % G.page, g, G.page,
                                         G.nkv, hd);
#pragma unroll
      for (int i = 0; i < kMaxDs; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) {
          const float vv = dts::to_f32(vrow[d]);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r >= rep) break;
            acc[r][i] += my_p[r * kTile + t] * vv;
          }
        }
      }
    }
    __syncwarp();
  }
  // sum the warps' partial sums into the chunk's
  float* mg = sm.kt;   // kWarps * rep * hd
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r >= rep) break;
#pragma unroll
    for (int i = 0; i < kMaxDs; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) mg[(warp * rep + r) * hd + d] = acc[r][i];
    }
  }
  __syncthreads();
  float* pb = part + (static_cast<int64_t>(bg) * gridDim.y + blockIdx.y) *
                         rep * hd;
  for (int idx = threadIdx.x; idx < rep * hd; idx += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += mg[w * rep * hd + idx];
    pb[idx] = v;
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

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const void* pages,
           const void* apos, void* scratch, void* out, int B, Geom G,
           cudaStream_t stream) {
  const int nchunks = (G.P * G.page + kChunk - 1) / kChunk;
  const size_t tiles = static_cast<size_t>(kWarps) * kTile * (G.hd + 1);
  const size_t merge = static_cast<size_t>(kWarps) * G.rep * G.hd;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(G.rep) * G.hd +
                       static_cast<size_t>(kWarps) * G.rep * kTile +
                       (tiles > merge ? tiles : merge));
  for (const void* fn : {reinterpret_cast<const void*>(decode_stats<T>),
                         reinterpret_cast<const void*>(decode_pv<T>)}) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* stats = static_cast<float*>(scratch);
  float* part = stats + static_cast<size_t>(B) * G.nkv * nchunks * G.rep * 2;
  const dim3 grid(B * G.nkv, nchunks);
  decode_stats<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const int*>(pages), static_cast<const int*>(apos), stats, G);
  decode_pv<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(pages),
      static_cast<const int*>(apos), stats, part, G);
  decode_sum<<<B * G.nkv, 128, 0, stream>>>(
      part, static_cast<const int*>(apos), static_cast<float*>(out), nchunks,
      G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch the launch needs: per (b, g, chunk) the softmax
// (max, sum) of each query row and its partial PV sum.
extern "C" int64_t paged_decode_scratch_floats(int B, int P, int page,
                                               int nkv, int rep, int hd) {
  const int64_t nchunks = (static_cast<int64_t>(P) * page + kChunk - 1) /
                          kChunk;
  return static_cast<int64_t>(B) * nkv * nchunks * rep * (hd + 2);
}

// q (B, 1, nkv, rep, hd); pk/pv (n_pages, page, nkv, hd); pages (B, P)
// int32; apos (B, 1) int32; scratch f32 of paged_decode_scratch_floats;
// out (B, 1, nkv, rep, hd) f32.  All contiguous on one device; hd a
// multiple of 8.  Returns cudaGetLastError() after the launches.
extern "C" int paged_decode_launch(const void* q, const void* pk,
                                   const void* pv, const void* pages,
                                   const void* apos, void* scratch, void* out,
                                   int B, int P, int page, int nkv, int rep,
                                   int hd, int dtype, void* stream) {
  if (rep < 1 || rep > kMaxRep || hd < 8 || hd > 32 * kMaxDs || hd % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom G{P, page, nkv, rep, hd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dts::kBFloat16)
    return launch<__nv_bfloat16>(q, pk, pv, pages, apos, scratch, out, B, G,
                                 s);
  if (dtype == dts::kFloat32)
    return launch<float>(q, pk, pv, pages, apos, scratch, out, B, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
