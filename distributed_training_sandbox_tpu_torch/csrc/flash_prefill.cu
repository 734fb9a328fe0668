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
// What bounds it on an H100: operations.  A block reuses every K/V row
// it stages for 64 query vectors (about 64 flops per byte staged), and
// the K/V of one (b, g) is re-read by the chunk's row tiles from L2, not
// HBM.  This first version runs its dot products on the f32 CUDA cores
// (67 TFLOP/s), not the tensor cores (989 TFLOP/s in bf16), so it sits
// far above the tensor-core bound; moving QK and PV to mma/wgmma is the
// next step (ROADMAP.md).
//
// Design: one block of 4 warps per (b, g, tile of 64 / rep chunk rows):
// 64 query vectors, 16 per warp, held in shared memory.  The block walks
// the slot's positions up to the largest apos of its rows in 32-key
// tiles, twice.  The tile's page ids are loaded once into shared memory
// and K (and V) tiles are staged with 16-byte loads.  Pass 1: each lane
// scores one key against its warp's 16 query vectors and the warp keeps
// each vector's running max and sum of exp(score - max).  Pass 2: the
// scores again, the reference's rounded probability
// round(exp(s - max) / sum), and every lane accumulates 16 x (hd / 32)
// outputs in f32.  An online softmax (one pass) cannot round the
// NORMALISED probability, and at 36 layers that rounding decides tokens.
// Positions past a row's apos get probability exactly 0, as the
// reference's -1e30 mask gives them.
//
// Numerics vs the reference: the same operations, in another summation
// order; expect agreement to f32 rounding, and rare one-ulp differences
// where a probability sits on a bf16 rounding boundary.

#include "paged_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;                 // keys per tile
constexpr int kQv = 64;                   // query vectors per block
constexpr int kQw = kQv / kWarps;         // query vectors per warp
constexpr int kMaxDs = 4;                 // hd <= 128

struct Geom {
  int S, P, page, nkv, rep, hd;
};

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
  const int rows = kQv / rep;               // chunk rows per block
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
    if (s_ >= S) continue;
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

}  // namespace

// q (B, S, nkv, rep, hd); pk/pv (n_pages, page, nkv, hd); pages (B, P)
// int32; apos (B, S) int32; out (B, S, nkv, rep, hd) f32.  rep must
// divide 64 and hd be a multiple of 8.  Returns cudaGetLastError().
extern "C" int flash_prefill_launch(const void* q, const void* pk,
                                    const void* pv, const void* pages,
                                    const void* apos, void* out, int B, int S,
                                    int P, int page, int nkv, int rep, int hd,
                                    int dtype, void* stream) {
  if (rep < 1 || kQv % rep || hd < 8 || hd > 32 * kMaxDs || hd % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom G{S, P, page, nkv, rep, hd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dts::kBFloat16)
    return launch<__nv_bfloat16>(q, pk, pv, pages, apos, out, B, G, st);
  if (dtype == dts::kFloat32)
    return launch<float>(q, pk, pv, pages, apos, out, B, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
