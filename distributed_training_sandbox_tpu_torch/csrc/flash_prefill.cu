// Chunked-prefill flash attention over a float or bf16 KV page pool.
//
// Replaces: distributed_training_sandbox_tpu/ops/flash_prefill.py,
// paged_flash_prefill (_prefill_kernel, its single-tile mode, which
// equals the engine's gather-then-einsum path).
//
// Computes what the reference computes, for every slot b, kv head g and
// chunk row s: the rep grouped query rows at absolute position
// apos[b, s] against the slot's pages read IN PLACE through the page
// table, causal on absolute positions (key t is visible iff
// t <= apos[b, s]); scores q·k / sqrt(hd) in f32, softmax, the
// probabilities rounded to the pool's type (the reference's probs_dtype
// cast), their weighted sum of V in f32.  Output f32
// (B, S, n_kv, rep, hd), the layout of the reference.
//
// What bounds it on an H100: operations (QKᵀ and PV over the visible
// keys; the K/V of one (b, g) is re-read by the chunk's row tiles from
// L2, not HBM), on the bf16 tensor cores (989 TFLOP/s) rather than the
// f32 CUDA cores (67).  What bounds this design in practice is latency:
// each warpgroup's steps (copies, QKᵀ, softmax, PV) run in turn, and
// four warpgroups an SM hide one another's waits.
//
// Design of the bf16 pool (the serve's, the main path): a block of two
// warpgroups, each holding 64 query vectors (the chunk rows' rep heads
// of one GQA group, row-major; a group that does not divide 128 splits
// a row between two blocks), shares every K/V tile; the grid is
// B x n_kv x ceil(S·rep / 128), row tiles with the most keys launched
// first, two blocks an SM (128 registers a thread).  Q, K and V live in
// shared memory as 128-byte swizzled tiles (hd split into 64-column
// blocks; hd < 64 is zero-padded to 64, which adds exact zeros), and K/V
// tiles go through a 3-stage ring of 16-byte cp.async copies read in
// place through the page table (the slot's page ids are staged once; a
// tile spans several pages of 8 or 16 rows).  Two passes over the keys,
// because the reference rounds the NORMALISED probability before PV (a
// one-pass online softmax cannot, and at 36 layers that rounding decides
// tokens).  Pass 1 needs K only: 64-key tiles, QKᵀ one wgmma m64n64k16
// per 16 of hd from shared Q and K (K-major), each into zeroed registers
// and the eight added in f32 (promote_qk), each row's max and sum in
// registers (the accumulator spreads a row over a quad of lanes: two
// shuffles).  Pass 2 takes K and V of 32 keys in the same stage bytes:
// the scores again (m64n32k16), round_bf16(exp(s - max) / sum) formed in
// the accumulator's registers, which are wgmma's A-operand layout as
// they stand, and P·V by wgmma m64n{64,128}k16 per 16 keys, V read
// MN-major (the descriptor's transpose).  The rounding is
// dts::round_to's; the probability then enters the A operand as its
// upper 16 bits, exact for a value round_to has rounded.  The division by
// the sum is correctly rounded from its reciprocal (Markstein), and the
// scores are scaled by f32(1/sqrt(hd)) as the plain path on the card
// does.  Tiles past the block's largest visible position are skipped;
// only tiles that cross some row's position are masked element by
// element; rows past S are never written.
//
// The f32 pool (tested, not on the main path) runs a CUDA-core kernel
// (f32 products, 32-key tiles staged behind block barriers, warp-wide
// row reductions), a separate template selected by the operand type:
// TF32 tensor cores would not meet its f32 tolerance.  A bf16 launch
// that fails returns its error; it does not fall back.
//
// Numerics vs the reference: the same operations, in another summation
// order (tensor cores sum the exact bf16 x bf16 products of a 16-deep
// k-group in their own order, truncating rather than rounding where they
// align addends; the groups' sums are added in f32, since one
// accumulation across all of hd truncated at the scale of the running
// score and flipped probabilities the plain path rounds as the f64
// oracle does); expect agreement to f32 rounding, and rare one-ulp
// differences where a probability sits on a bf16 rounding boundary: one
// such flip of a large probability moves an output by ~1e-3 (PERF.md).

#include "hopper.cuh"
#include "paged_common.cuh"

namespace {

struct Geom {
  int S, P, page, nkv, rep, hd;
  int page_shift;   // log2(page) where page is a power of two, else -1
};

constexpr int kQv = 64;   // query vectors per block (both kernels)

// ------------------------------------------------ f32 pool: CUDA cores

constexpr int kWarps = 4;
constexpr int kTile = 32;                 // keys per tile
constexpr int kQw = kQv / kWarps;         // query vectors per warp
constexpr int kMaxDs = 4;                 // hd <= 128

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                     const T* __restrict__ pv, const int* __restrict__ pages,
                     const int* __restrict__ apos, float* __restrict__ out,
                     Geom G) {
  extern __shared__ float smem[];
  __shared__ int kmax_s;
  __shared__ int pg_s[kTile];
  const int S = G.S, hd = G.hd, rep = G.rep;
  const int b = blockIdx.x / G.nkv;
  const int g = blockIdx.x % G.nkv;
  // whole chunk rows per block; its vectors past rows·rep idle
  const int rows = kQv / rep;
  const int s0 = blockIdx.y * rows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int* prow = pages + static_cast<int64_t>(b) * G.P;
  const int* arow = apos + static_cast<int64_t>(b) * S;
  const int V = G.P * G.page;
  const float root_hd = sqrtf(static_cast<float>(hd));

  float* qs = smem;                         // kQv * hd
  float* kt = qs + kQv * hd;                // kTile * (hd + 1)
  float* vt = kt + kTile * (hd + 1);        // kTile * hd
  float* ps = vt + kTile * hd;              // kWarps * kQw * kTile
  float* my_p = ps + warp * kQw * kTile;

  // query vector v = (row v / rep, head v % rep) of the block's rows
  if (threadIdx.x == 0) kmax_s = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < kQv * hd; i += blockDim.x) {
    const int v = i / hd, s = s0 + v / rep;
    float val = 0.f;
    if (s < S)
      val = dts::to_f32(
          q[(((static_cast<int64_t>(b) * S + s) * G.nkv + g) * rep + v % rep) *
                hd +
            i % hd]);
    qs[i] = val;
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    if (s0 + i < S) atomicMax(&kmax_s, min(arow[s0 + i], V - 1));
  __syncthreads();
  const int kmax = kmax_s;

  int ap[kQw];
  float m[kQw], l[kQw], acc[kQw][kMaxDs];
#pragma unroll
  for (int j = 0; j < kQw; ++j) {
    const int s = s0 + (warp * kQw + j) / rep;
    ap[j] = s < S ? arow[s] : 0;            // rows past S: never written
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDs; ++i) acc[j][i] = 0.f;
  }

  // stage tile t0 (K, and V in pass 2) and score this lane's key against
  // the warp's query vectors; s[j] = -inf where the key is not visible
  auto tile = [&](int t0, bool with_v, float s[kQw]) {
    __syncthreads();   // the previous tile is consumed
    if (threadIdx.x < kTile && t0 + threadIdx.x <= kmax)
      pg_s[threadIdx.x] = prow[(t0 + threadIdx.x) / G.page];
    __syncthreads();
    auto pg_of = [&](int t) { return pg_s[t]; };
    dts::stage_tile<T>(pk, kt, hd + 1, t0, kmax, g, G.page, G.nkv, hd,
                       threadIdx.x, blockDim.x, pg_of);
    if (with_v)
      dts::stage_tile<T>(pv, vt, hd, t0, kmax, g, G.page, G.nkv, hd,
                         threadIdx.x, blockDim.x, pg_of);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kQw; ++j) s[j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float kd = kt[lane * (hd + 1) + d];
#pragma unroll
      for (int j = 0; j < kQw; ++j)
        s[j] += qs[(warp * kQw + j) * hd + d] * kd;
    }
    const int pos = t0 + lane;
#pragma unroll
    for (int j = 0; j < kQw; ++j)
      s[j] = pos <= ap[j] ? s[j] / root_hd : -INFINITY;
  };

  float s[kQw];
  // pass 1: each query vector's softmax max and sum
  for (int t0 = 0; t0 <= kmax; t0 += kTile) {
    tile(t0, false, s);
#pragma unroll
    for (int j = 0; j < kQw; ++j) {
      // position 0 is visible to every row, so after the first tile
      // m_new is finite and a fully masked later tile leaves it alone
      const float m_new = fmaxf(m[j], dts::warp_max(s[j]));
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m_new);
      l[j] = l[j] * expf(m[j] - m_new) + dts::warp_sum(p);
      m[j] = m_new;
    }
  }
  // pass 2: rounded probabilities times V
  for (int t0 = 0; t0 <= kmax; t0 += kTile) {
    tile(t0, true, s);
#pragma unroll
    for (int j = 0; j < kQw; ++j)
      my_p[j * kTile + lane] =
          s[j] == -INFINITY ? 0.f
                            : dts::round_to<T>(expf(s[j] - m[j]) / l[j]);
    __syncwarp();
    const int tn = min(kTile, kmax - t0 + 1);
    for (int t = 0; t < tn; ++t) {
#pragma unroll
      for (int i = 0; i < kMaxDs; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) {
          const float vv = vt[t * hd + d];
#pragma unroll
          for (int j = 0; j < kQw; ++j) acc[j][i] += my_p[j * kTile + t] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kQw; ++j) {
    const int v = warp * kQw + j, s_ = s0 + v / rep;
    if (s_ >= S || v >= rows * rep) continue;   // past the block's rows
    float* o = out + (((static_cast<int64_t>(b) * S + s_) * G.nkv + g) * rep +
                      v % rep) * hd;
#pragma unroll
    for (int i = 0; i < kMaxDs; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) o[d] = acc[j][i];
    }
  }
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const void* pages,
           const void* apos, void* out, int B, Geom G, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kQv) * G.hd +
                       static_cast<size_t>(kTile) * (G.hd + 1) +
                       static_cast<size_t>(kTile) * G.hd +
                       static_cast<size_t>(kWarps) * kQw * kTile);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = kQv / G.rep;
  const dim3 grid(B * G.nkv, (G.S + rows - 1) / rows);
  flash_prefill_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(pages),
      static_cast<const int*>(apos), static_cast<float*>(out), G);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------ bf16 pool: wgmma, cp.async ring

// A stage of the ring holds pass 1's K tile of kKeys1 keys, or pass 2's
// K and V tiles of kKeys2 keys: the same bytes, so pass 1 (K only) walks
// the keys in half as many steps.
constexpr int kKeys1 = 64, kKeys2 = 32;   // keys per tile, passes 1 and 2
constexpr int kStages = 3;                // ring depth
constexpr int kWgs = 2;                   // consumer warpgroups a block
constexpr int kThreadsWg = 128 * kWgs;
constexpr int kBlocksPerSm = 2;           // what registers and smem allow
constexpr int kPageCap = 256;             // page-table entries staged
constexpr int kBlk = kQv * 128;           // one 64-row x 128-byte region

// Is key t visible to a row at absolute position ap (the reference's
// causal mask, t <= apos)?
__device__ __forceinline__ bool visible(int t, int ap) { return t <= ap; }

// f32 p and q as the bf16 pair (p low) of an A-operand register: their
// upper 16 bits, exact for values that round_to has rounded to bf16
__device__ __forceinline__ uint32_t bf16_pair(float p, float q) {
  return (__float_as_uint(p) >> 16) | (__float_as_uint(q) & 0xffff0000u);
}

// x / l rounded to nearest even, given r = 1 / l correctly rounded: q =
// x·r is within an ulp of x / l, and one FMA correction makes it the
// correctly rounded quotient (Markstein's theorem; x and x / l in the
// normal range, as every probability that can move a bf16 output is).
// Three instructions where the IEEE division takes a dozen and a slow
// path.
__device__ __forceinline__ float div_by(float x, float l, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, l, x), r, q);
}

// HDP: hd padded to 64 or 128 (one or two 128-byte column blocks)
template <int HDP>
struct Wg {
  static constexpr int kQBytes = (HDP / 64) * kBlk;   // one WG's Q; a stage
  static constexpr int kPagesAt = kQBytes * (kWgs + kStages);
  static constexpr int kSmem = kPagesAt + 4 * kPageCap + 1008;
};

// Issue the copies of keys [t0, t0 + KEYS) of kv head g (and their V
// rows) into stage st: hd split into 128-byte column blocks of KEYS
// rows, V's after K's; keys past kmax and columns past hd are zeros.
template <int HDP, int KEYS, bool WITH_V>
__device__ __forceinline__ void load_keys(uint8_t* st,
                                          const __nv_bfloat16* pk,
                                          const __nv_bfloat16* pv,
                                          const int* pg_s, const int* prow,
                                          int t0, int kmax, int g,
                                          Geom G) {
  constexpr int kChunks = HDP / 8, kPer = KEYS * kChunks / kThreadsWg;
  constexpr int kBlkKv = KEYS * 128;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + kThreadsWg * j;
    const int r = i / kChunks, c = i % kChunks, t = t0 + r;
    const bool ok = t <= kmax && c * 8 < G.hd;
    int64_t off = 0;
    if (ok) {
      const int pi = G.page_shift >= 0 ? t >> G.page_shift : t / G.page;
      const int pg = pi < kPageCap ? pg_s[pi] : prow[pi];
      off = dts::pool_row(pg, t - pi * G.page, g, G.page, G.nkv, G.hd) +
            c * 8;
    }
    const int so = (c / 8) * kBlkKv + hop::sw128(r, c % 8);
    hop::cp_async16(st + so, pk + off, ok);
    if (WITH_V)
      hop::cp_async16(st + (HDP / 64) * kBlkKv + so, pv + off, ok);
  }
}

// The f32 score takes one 16-deep k-group's tensor-core sum.
__device__ __forceinline__ float promote_qk(float acc, float part) {
  return acc + part;
}

// Scores of a warpgroup's 64 query vectors (Q at qs) against the KEYS
// keys at t0 in stage st, scaled; -inf where masked (only a tile that
// crosses a row's position is masked element by element).  Element e:
// row 16 warp + lane / 4 + 8 ((e / 2) % 2) of the warpgroup's, key
// t0 + 8 (e / 4) + 2 (lane % 4) + e % 2.  Each 16-deep k-group of hd is
// its own wgmma into zeroed registers (two in flight), and the group
// sums are added in f32 in promote_qk(): the tensor cores truncate
// where they align addends, and a sum carried across the k-groups would
// be truncated at the scale of the whole running score.
template <int HDP, int KEYS>
__device__ __forceinline__ void tile_scores(float (&sc)[KEYS / 2],
                                            const uint8_t* qs,
                                            const uint8_t* st, int t0,
                                            bool crossing, const int (&ap)[2],
                                            float inv_hd) {
  const int lane = threadIdx.x % 32;
  constexpr int kGroups = HDP / 16;
  float part[2][KEYS / 2];
#pragma unroll
  for (int e = 0; e < KEYS / 2; ++e) part[0][e] = part[1][e] = 0.f;
  auto group = [&](int kk) {
    const int at = (kk % 4) * 32;
    const uint64_t dq = hop::sw128_desc(qs + (kk / 4) * kBlk + at, 16, 1024);
    const uint64_t dk =
        hop::sw128_desc(st + (kk / 4) * KEYS * 128 + at, 16, 1024);
    hop::fence_regs(part[kk % 2]);
    hop::wgmma_fence();
    if constexpr (KEYS == 64)
      hop::wgmma_m64n64k16_bf16_ss(part[kk % 2], dq, dk, 0);
    else
      hop::wgmma_m64n32k16_bf16_ss(part[kk % 2], dq, dk, 0);
    hop::wgmma_commit();
  };
  group(0);
#pragma unroll
  for (int kk = 0; kk < kGroups; ++kk) {
    if (kk + 1 < kGroups) {
      group(kk + 1);
      hop::wgmma_wait<1>();
    } else {
      hop::wgmma_wait<0>();
    }
    hop::fence_regs(part[kk % 2]);
#pragma unroll
    for (int e = 0; e < KEYS / 2; ++e)
      sc[e] = kk ? promote_qk(sc[e], part[kk % 2][e]) : part[kk % 2][e];
  }
#pragma unroll
  for (int e = 0; e < KEYS / 2; ++e) {
    const int t = t0 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
    sc[e] = !crossing || visible(t, ap[(e / 2) % 2]) ? sc[e] * inv_hd
                                                     : -INFINITY;
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreadsWg, kBlocksPerSm)
flash_prefill_wgmma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ pk,
                    const __nv_bfloat16* __restrict__ pv,
                    const int* __restrict__ pages,
                    const int* __restrict__ apos, float* __restrict__ out,
                    Geom G) {
  using W = Wg<HDP>;
  constexpr int kChunks = HDP / 8;                 // 16-byte chunks a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const q0s = hop::align1024(smem_raw);
  auto stage = [&](int j) {
    return q0s + W::kQBytes * (kWgs + j % kStages);
  };

  const int S = G.S, hd = G.hd, rep = G.rep, nkv = G.nkv;
  const int b = blockIdx.x / nkv, g = blockIdx.x % nkv;
  // the last row tiles see the most keys: they are launched first
  const int vb = (gridDim.y - 1 - blockIdx.y) * kQv * kWgs;   // 1st vector
  // the rows the block's vectors touch, the first and the last maybe
  // in part
  const int s0 = vb / rep, rows = (vb + kQv * kWgs - 1) / rep - s0 + 1;
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = (tid % 128) / 32;
  const int v0 = vb + kQv * wg;             // this warpgroup's first vector
  const uint8_t* const qs = q0s + W::kQBytes * wg;
  const int* prow = pages + static_cast<int64_t>(b) * G.P;
  const int* arow = apos + static_cast<int64_t>(b) * S;
  const int V = G.P * G.page;

  // every warp finds the block's largest and smallest visible position
  int kmax = 0, kmin = 0x7fffffff;
  for (int i = lane; i < rows; i += 32)
    if (s0 + i < S) {
      const int a = min(arow[s0 + i], V - 1);
      kmax = max(kmax, a);
      kmin = min(kmin, a);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
  }
  const int nt1 = kmax / kKeys1 + 1, nt2 = kmax / kKeys2 + 1;

  // this thread's two accumulator rows (query vectors of its
  // warpgroup); a row past S sees every key the block stages and is
  // never written
  const int vr[2] = {16 * warp + lane / 4, 16 * warp + lane / 4 + 8};
  int ap[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = (v0 + vr[h]) / rep;
    ap[h] = s < S ? min(arow[s], V - 1) : kmax;
  }

  // the slot's page ids up to kmax, staged once (the first kPageCap)
  int* const pg_s = reinterpret_cast<int*>(q0s + W::kPagesAt);
  for (int i = tid; i <= min(kmax / G.page, kPageCap - 1); i += kThreadsWg)
    pg_s[i] = prow[i];
  __syncthreads();

  // Q: the block's vectors x hd, each warpgroup's 64 in its own tile,
  // zeros past S and past hd
  for (int i = tid; i < kQv * kWgs * kChunks; i += kThreadsWg) {
    const int v = i / kChunks, c = i % kChunks;
    const int vi = vb + v, s = vi / rep;
    const bool ok = s < S && c * 8 < hd;
    const __nv_bfloat16* src =
        ok ? q + (((static_cast<int64_t>(b) * S + s) * nkv + g) * rep +
                  vi % rep) * hd + c * 8
           : q;
    hop::cp_async16(q0s + (v / kQv) * W::kQBytes + (c / 8) * kBlk +
                        hop::sw128(v % kQv, c % 8),
                    src, ok);
  }
  hop::cp_async_commit();

  // Ring step j < nt1 is pass 1's tile j; j >= nt1 pass 2's tile j - nt1.
  auto issue = [&](int j) {
    if (j < nt1)
      load_keys<HDP, kKeys1, false>(stage(j), pk, pv, pg_s, prow,
                                    j * kKeys1, kmax, g, G);
    else if (j < nt1 + nt2)
      load_keys<HDP, kKeys2, true>(stage(j), pk, pv, pg_s, prow,
                                   (j - nt1) * kKeys2, kmax, g, G);
    hop::cp_async_commit();   // possibly empty: the group count stays even
  };
  // step j's tile has landed for every thread and step j - 1's is
  // consumed; then step j + kStages - 1's copies go out
  auto sync = [&](int j) {
    hop::cp_async_wait<kStages - 2>();
    hop::fence_proxy_async();
    __syncthreads();
    issue(j + kStages - 1);
  };

  // the scores' scale: f32(1 / f32(sqrt(hd))), as the plain path on the
  // card (ATen multiplies by the reciprocal of a scalar divisor) and the
  // jitted reference (XLA folds the constant division) apply it
  const float inv_hd = 1.0f / sqrtf(static_cast<float>(hd));
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  // pass 1: each row's running max and sum; a row's keys lie in a quad
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < nt1; ++j) {
    sync(j);
    const int t0 = j * kKeys1;
    float sc[kKeys1 / 2];
    tile_scores<HDP, kKeys1>(sc, qs, stage(j), t0, t0 + kKeys1 - 1 > kmin,
                             ap, inv_hd);
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < kKeys1 / 2; ++e)
      mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], sc[e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // position 0 is visible to every row, so after the first tile the
      // max is finite and a fully masked later tile leaves it
      mx[h] = fmaxf(m[h], mx[h]);
    }
#pragma unroll
    for (int e = 0; e < kKeys1 / 2; ++e) {
      const int h = (e / 2) % 2;
      sum[h] += sc[e] == -INFINITY ? 0.f : expf(sc[e] - mx[h]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * expf(m[h] - mx[h]) + sum[h];
      m[h] = mx[h];
    }
  }

  // pass 2: the rounded probabilities times V
  const float rl[2] = {1.0f / l[0], 1.0f / l[1]};
  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  for (int j = nt1; j < nt1 + nt2; ++j) {
    sync(j);
    const int t0 = (j - nt1) * kKeys2;
    const uint8_t* st = stage(j);
    float sc[kKeys2 / 2];
    tile_scores<HDP, kKeys2>(sc, qs, st, t0, t0 + kKeys2 - 1 > kmin, ap,
                             inv_hd);
    // wgmma's A operand as the accumulator's registers stand: keys
    // 16 kk .. 16 kk + 15 are elements 8 kk .. 8 kk + 7
    uint32_t a[kKeys2 / 16][4];
#pragma unroll
    for (int e = 0; e < kKeys2 / 2; e += 2) {
      const int h = (e / 2) % 2;
      float p[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        p[u] = sc[e + u] == -INFINITY
                   ? 0.f
                   : dts::round_to<__nv_bfloat16>(
                         div_by(expf(sc[e + u] - m[h]), l[h], rl[h]));
      a[e / 8][(e % 8) / 2] = bf16_pair(p[0], p[1]);
    }
    hop::fence_regs(o);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys2 / 16; ++kk) {
      const uint64_t dv = hop::sw128_desc(
          st + (HDP / 64) * kKeys2 * 128 + kk * 16 * 128, kKeys2 * 128, 1024);
      if constexpr (HDP == 128)
        hop::wgmma_m64n128k16_bf16_rs_tb(o, a[kk], dv);
      else
        hop::wgmma_m64n64k16_bf16_rs_tb(o, a[kk], dv);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int vi = v0 + vr[h], s = vi / rep;
    if (s >= S) continue;
    float* dst = out + (((static_cast<int64_t>(b) * S + s) * nkv + g) * rep +
                        vi % rep) * hd;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int d = 8 * j + 2 * (lane % 4);
      if (d < hd)
        *reinterpret_cast<float2*>(dst + d) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
  }
}

template <int HDP>
int launch_wgmma(const void* q, const void* pk, const void* pv,
                 const void* pages, const void* apos, void* out, int B,
                 Geom G, cudaStream_t stream) {
  const int smem = Wg<HDP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_wgmma<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  // all of the SM's shared memory, so that kBlocksPerSm blocks fit on it
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_prefill_wgmma<HDP>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vecs = kQv * kWgs;
  const dim3 grid(B * G.nkv, (G.S * G.rep + vecs - 1) / vecs);
  flash_prefill_wgmma<HDP><<<grid, kThreadsWg, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pk),
      static_cast<const __nv_bfloat16*>(pv), static_cast<const int*>(pages),
      static_cast<const int*>(apos), static_cast<float*>(out), G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, nkv, rep, hd); pk/pv (n_pages, page, nkv, hd); pages (B, P)
// int32; apos (B, S) int32; out (B, S, nkv, rep, hd) f32; every pointer
// 16-byte aligned.  rep must be in [1, 64] and hd a multiple of 8 in
// [8, 128].  bf16 runs the wgmma kernel, f32 the CUDA-core kernel.
// Returns cudaGetLastError().
extern "C" int flash_prefill_launch(const void* q, const void* pk,
                                    const void* pv, const void* pages,
                                    const void* apos, void* out, int B, int S,
                                    int P, int page, int nkv, int rep, int hd,
                                    int dtype, void* stream) {
  if (rep < 1 || rep > kQv || hd < 8 || hd > 32 * kMaxDs || hd % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int shift = 0;
  while ((1 << shift) < page) ++shift;
  const Geom G{S, P, page, nkv, rep, hd, (1 << shift) == page ? shift : -1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dts::kBFloat16)
    return hd <= 64
               ? launch_wgmma<64>(q, pk, pv, pages, apos, out, B, G, st)
               : launch_wgmma<128>(q, pk, pv, pages, apos, out, B, G, st);
  if (dtype == dts::kFloat32)
    return launch<float>(q, pk, pv, pages, apos, out, B, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
