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
// to be compute-bound.  So the design is about having every visible row
// in flight at once, reading each once, in one launch.
//
// Design, for Hopper: one launch, a thread-block cluster of kCluster
// blocks per (b, g).
//  * The visible positions 0..min(apos[b], V - 1) are cut into kCluster
//    contiguous ranges, one a block; a block wholly past apos issues no
//    loads (masked positions get probability exactly 0 in the
//    reference, so stopping at apos computes the same function while
//    reading only the rows the slot holds; the null page 0 of padded
//    table rows is never read).
//  * Loads: the K and V rows of one head are strided in the pool, so
//    every thread issues 16-byte cp.async copies of the visible rows
//    into shared memory, each row's page id read from the table, K and
//    V as two commit groups: a block's rows are in flight at once, and
//    its keys are scored while V still arrives.  (One bulk copy a row,
//    the TMA unit's 1-D form, was tried first: the unit takes such
//    copies one after another, and the loads became the block's
//    longest step.)  A range longer than the R rows a block holds is taken in
//    sub-ranges: K sub-range by sub-range first, the last sub-range's V
//    loaded with the first K.
//  * Scores: each block scores its keys once on the CUDA cores, a thread
//    a key against the rep query rows (K rows padded by 16 bytes in
//    shared memory, so that a warp's 16-byte loads of eight rows meet no
//    bank twice; q read as broadcasts), and keeps them in shared memory
//    (in a view longer than kCluster · kMaxRange positions, in a global
//    scratch the caller gives, each block its own slice) with its local
//    (max, sum of exp(s - max)) per query row.  (A group
//    of lanes per key summing by shuffles, tried first, was a chain of
//    dependent shuffles.)  Every loop over the query rows runs to RB,
//    rep rounded up to a power of two (a template argument), with zero
//    rows past rep: a loop that breaks at rep keeps the compiler from
//    issuing the next row's shared load before the branch.
//  * Exchange: through distributed shared memory and a cluster barrier,
//    every block reads the kCluster partial (max, sum) pairs, in rank
//    order, and forms the row's max M and sum L.
//  * PV: each block forms p = round_to<T>(exp(s - M) / L) from its kept
//    scores (K is never read again) and sums p · v from its V rows in
//    shared memory, two dims a thread, the positions split over groups
//    of hd / 2 threads whose sums are added in a fixed order.
//  * Reduction: after a second cluster barrier block c adds the
//    kCluster partial sums of its slice of the output, in rank order,
//    and writes it once: bitwise repeatable, no atomics.
// The two-pass structure of the softmax stays: an online softmax cannot
// round the NORMALISED probability, and at 36 layers that rounding
// decides tokens (without it the logits of the SmolLM3-3B smoke moved by
// 3.5 against the plain path).
//
// Numerics vs the reference: the same operations, in another summation
// order; expect agreement to f32 rounding, and rare one-ulp differences
// where a probability sits on a bf16 rounding boundary.

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "paged_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // 8 warps a block
constexpr int kCluster = 8;        // blocks per (b, g), portable size
constexpr int kMaxRep = 8;         // query rows per kv head
constexpr int kMaxHd = 128;        // head dims
// K + V rows a block holds at once: with the scores and sums, three
// blocks share an SM, so the serve shape's 256 blocks run in one wave
constexpr int kRowBytes = 57344;
// positions a block keeps scores for in shared memory; a longer range
// keeps them in the caller's scratch
constexpr int kMaxRange = 2048;
constexpr int kMaxView = 1 << 30;  // positions of a view, as int

struct Geom {
  int P, page, nkv, rep, hd;
};

// The last visible position of a slot whose query sits at ap, in a view
// of V positions: key t is visible iff t <= ap.
__device__ __forceinline__ int last_key(int ap, int V) { return min(ap, V - 1); }

// The most positions a block is given.
__host__ __device__ inline int range_max(const Geom& G) {
  return (G.P * G.page + kCluster - 1) / kCluster;
}
// whether the blocks keep their scores in shared memory
__host__ __device__ inline bool scores_shared(const Geom& G) {
  return range_max(G) <= kMaxRange;
}
// rep rounded up to a power of two: the stride of the scores
__host__ __device__ inline int rep_block(int rep) {
  return rep == 1 ? 1 : rep == 2 ? 2 : rep <= 4 ? 4 : 8;
}
// the K buffer's row stride in elements: 16 bytes of padding
template <typename T>
__host__ __device__ inline int kstride(const Geom& G) {
  return G.hd + 16 / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ inline int rows_held(const Geom& G) {
  const int r = kRowBytes / (2 * G.hd * static_cast<int>(sizeof(T)));
  return r < range_max(G) ? r : range_max(G);
}
// table entries a block's range can touch
__host__ __device__ inline int pages_held(const Geom& G) {
  return range_max(G) / G.page + 2;
}
// threads a PV group (two dims each), and the groups of a block
__host__ __device__ inline int pv_groups(const Geom& G) {
  const int n = kThreads / (G.hd / 2);
  return n > 1 ? n : 1;
}

// Shared-memory layout of one block; RB is rep rounded up to a power
// of two, the stride of the q rows and of each position's scores.
template <typename T, int RB>
struct Smem {
  T *kb, *vb;               // rows_held K and V rows
  float *gpart;             // the PV groups' sums, over the K rows
  float *qs, *sc, *stat;    // q rows (f32, zero past rep); scores, then p
                            // (or in the caller's scratch); (max, sum);
  float *ml, *part;         // the row's (M, L); PV sums
  int* pg;                  // the page ids of the block's range
  // bytes of the K rows' region: the K rows, or the groups' PV sums
  __host__ __device__ static size_t k_bytes(const Geom& G) {
    const size_t k = static_cast<size_t>(rows_held<T>(G)) * kstride<T>(G) *
                     sizeof(T);
    const size_t g = sizeof(float) * G.rep * pv_groups(G) * G.hd;
    return k > g ? k : g;
  }
  __host__ __device__ static size_t bytes(const Geom& G) {
    return k_bytes(G) +
           static_cast<size_t>(rows_held<T>(G)) * G.hd * sizeof(T) +
           sizeof(float) * (static_cast<size_t>(RB) * G.hd +
                            (scores_shared(G) ? static_cast<size_t>(
                                 range_max(G)) * RB : 0) +
                            4 * G.rep + G.rep * G.hd + pages_held(G));
  }
  __device__ Smem(unsigned char* base, const Geom& G) {
    kb = reinterpret_cast<T*>(base);
    gpart = reinterpret_cast<float*>(base);
    vb = reinterpret_cast<T*>(base + k_bytes(G));
    qs = reinterpret_cast<float*>(vb + rows_held<T>(G) * G.hd);
    sc = qs + RB * G.hd;
    stat = sc + (scores_shared(G) ? range_max(G) * RB : 0);
    ml = stat + 2 * G.rep;
    part = ml + 2 * G.rep;
    pg = reinterpret_cast<int*>(part + G.rep * G.hd);
  }
};

// RB floats of shared memory at p (16-byte aligned for RB >= 4)
template <int RB>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[RB]) {
  if constexpr (RB >= 4) {
#pragma unroll
    for (int i = 0; i < RB; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x, x[i + 1] = v.y, x[i + 2] = v.z, x[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RB; ++i) x[i] = p[i];
  }
}

template <typename T, int RB>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ pk,
              const T* __restrict__ pv, const int* __restrict__ pages,
              const int* __restrict__ apos, float* scores,
              float* __restrict__ out, Geom G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bg = blockIdx.x / kCluster, b = bg / G.nkv, g = bg % G.nkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hd = G.hd, rep = G.rep;
  Smem<T, RB> sm(smem_raw, G);
  if (!scores_shared(G))
    sm.sc = scores + static_cast<int64_t>(blockIdx.x) * range_max(G) * RB;
  const int* prow = pages + static_cast<int64_t>(b) * G.P;

  // this block's positions [p0, p0 + len) of the visible 0..kend
  const int n = last_key(apos[b], G.P * G.page) + 1;
  const int chunk = (n + kCluster - 1) / kCluster;
  const int p0 = rank * chunk;
  const int len = max(0, min(chunk, n - p0));
  const int held = rows_held<T>(G);
  const int n_sub = (len + held - 1) / held;
  const int cpr = hd * static_cast<int>(sizeof(T)) / 16;   // 16 B a row
  const int ks = kstride<T>(G);

  // issue the copies of the rows of sub-range s of the pool src into the
  // buffer dst (row stride `stride`), spread over the block's threads,
  // as one commit group (after a barrier: the buffer's earlier reads
  // are done, and the staged page ids are visible)
  auto issue = [&](T* dst, int stride, const T* __restrict__ src, int s) {
    const int cnt = min(held, len - s * held);
    __syncthreads();
    for (int i = tid; i < cnt * cpr; i += kThreads) {
      const int r = i / cpr, c = i % cpr, pos = p0 + s * held + r;
      const int64_t at = dts::pool_row(sm.pg[pos / G.page - p0 / G.page],
                                       pos % G.page, g, G.page, G.nkv, hd);
      hop::cp_async16(reinterpret_cast<uint8_t*>(dst + r * stride) + 16 * c,
                      reinterpret_cast<const uint8_t*>(src + at) + 16 * c,
                      true);
    }
    hop::cp_async_commit();
  };

  for (int i = tid; i < RB * hd; i += kThreads)
    sm.qs[i] = i < rep * hd
                   ? dts::to_f32(q[static_cast<int64_t>(bg) * rep * hd + i])
                   : 0.f;
  // the table entries of the range, read once
  if (len > 0)
    for (int i = p0 / G.page + tid; i <= (p0 + len - 1) / G.page;
         i += kThreads)
      sm.pg[i - p0 / G.page] = prow[i];
  if (len > 0) {
    issue(sm.kb, ks, pk, 0);
    issue(sm.vb, hd, pv, n_sub - 1);   // kept for the PV pass
  }
  __syncthreads();

  // scores: a thread a key, 16 bytes of its K row at a time against the
  // same 16 bytes of each query row (broadcast reads)
  const float root_hd = sqrtf(static_cast<float>(hd));
  constexpr int kVec = dts::Vec<T>::n;
  for (int s = 0; s < n_sub; ++s) {
    // K of sub-range s (the first V group may still be in flight)
    if (s == 0)
      hop::cp_async_wait<1>();
    else
      hop::cp_async_wait<0>();
    __syncthreads();
    const int cnt = min(held, len - s * held);
    for (int kr = tid; kr < cnt; kr += kThreads) {
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.f;
      for (int c = 0; c < hd; c += kVec) {
        float kv[kVec];
        dts::Vec<T>::load(sm.kb + kr * ks + c, kv);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float* qr = sm.qs + r * hd + c;
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[r] += qr[i] * kv[i];
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        sm.sc[(s * held + kr) * RB + r] = acc[r] / root_hd;
    }
    if (s + 1 < n_sub) issue(sm.kb, ks, pk, s + 1);
  }
  __syncthreads();

  // the block's (max, sum of exp(s - max)) per query row; a block with
  // no positions gives (-inf, 0)
  for (int r = warp; r < rep; r += kThreads / 32) {
    float mx = -INFINITY;
    for (int i = lane; i < len; i += 32) mx = fmaxf(mx, sm.sc[i * RB + r]);
    mx = dts::warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < len; i += 32) sum += expf(sm.sc[i * RB + r] - mx);
    sum = dts::warp_sum(sum);
    if (lane == 0) {
      sm.stat[2 * r] = mx;
      sm.stat[2 * r + 1] = len > 0 ? sum : 0.f;
    }
  }
  cluster.sync();

  // the row's softmax max M and sum L from the cluster's pairs, in rank
  // order (every block forms the same values)
  if (tid < rep) {
    const int r = tid;
    float M = -INFINITY, L = 0.f;
    for (int c = 0; c < kCluster; ++c)
      M = fmaxf(M, cluster.map_shared_rank(sm.stat, c)[2 * r]);
    for (int c = 0; c < kCluster; ++c) {
      const float* st = cluster.map_shared_rank(sm.stat, c);
      if (st[2 * r] != -INFINITY) L += st[2 * r + 1] * expf(st[2 * r] - M);
    }
    sm.ml[2 * r] = M;
    sm.ml[2 * r + 1] = L;
  }
  __syncthreads();
  // the rounded normalised probabilities, in place of the scores (0 in
  // the rows past rep)
  for (int i = tid; i < len * RB; i += kThreads) {
    const int r = i % RB;
    sm.sc[i] = r < rep ? dts::round_to<T>(expf(sm.sc[i] - sm.ml[2 * r]) /
                                          sm.ml[2 * r + 1])
                       : 0.f;
  }
  __syncthreads();

  // PV: ng groups of hd / 2 threads, two dims a thread, group gi taking
  // every ng-th position; the last sub-range's V is in the buffer, the
  // others are loaded after it
  const int ng = pv_groups(G), gi = tid / (hd / 2), d = 2 * (tid % (hd / 2));
  float acc[RB][2];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int t = 0; t < n_sub; ++t) {
    const int s = t == 0 ? n_sub - 1 : t - 1;
    if (t > 0) issue(sm.vb, hd, pv, s);
    hop::cp_async_wait<0>();
    __syncthreads();
    const int cnt = min(held, len - s * held);
    if (gi < ng)
#pragma unroll 4
      for (int kr = gi; kr < cnt; kr += ng) {
        float v0, v1, p[RB];
        dts::pair_f32(sm.vb + kr * hd + d, v0, v1);
        load_rows<RB>(sm.sc + (s * held + kr) * RB, p);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          acc[r][0] += p[r] * v0;
          acc[r][1] += p[r] * v1;
        }
      }
    __syncthreads();   // the buffer is read before the next sub-range
  }
  if (gi < ng)
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < rep) {
        sm.gpart[(gi * rep + r) * hd + d] = acc[r][0];
        sm.gpart[(gi * rep + r) * hd + d + 1] = acc[r][1];
      }
  __syncthreads();
  for (int i = tid; i < rep * hd; i += kThreads) {
    float v = 0.f;
    for (int k = 0; k < ng; ++k) v += sm.gpart[k * rep * hd + i];
    sm.part[i] = v;
  }
  cluster.sync();

  // block `rank` adds the cluster's partial sums of its slice, in rank
  // order, and writes it
  const int n_out = rep * hd, per = (n_out + kCluster - 1) / kCluster;
  for (int i = rank * per + tid; i < min(n_out, (rank + 1) * per);
       i += kThreads) {
    float v = 0.f;
    for (int c = 0; c < kCluster; ++c)
      v += cluster.map_shared_rank(sm.part, c)[i];
    out[static_cast<int64_t>(bg) * n_out + i] = v;
  }
  cluster.sync();   // no block leaves while its partial sums are read
}

constexpr int kMaxSmem = 232448;   // the most shared memory a block has

// The kernel's attributes, set once a device: dynamic shared memory up
// to kMaxSmem, and the whole L1 as shared memory (more blocks an SM).
template <typename T, int RB>
cudaError_t set_attributes() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(decode_kernel<T, RB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_kernel<T, RB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T, int RB>
int launch(const void* q, const void* pk, const void* pv, const void* pages,
           const void* apos, void* scores, void* out, int B, Geom G,
           cudaStream_t stream) {
  const size_t smem = Smem<T, RB>::bytes(G);
  if (smem > kMaxSmem || (!scores_shared(G) && scores == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_attributes<T, RB>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * B * G.nkv);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_kernel<T, RB>,
                           static_cast<const T*>(q), static_cast<const T*>(pk),
                           static_cast<const T*>(pv),
                           static_cast<const int*>(pages),
                           static_cast<const int*>(apos),
                           static_cast<float*>(scores),
                           static_cast<float*>(out), G);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the instance for rep rounded up to a power of two
template <typename T>
int launch_rep(const void* q, const void* pk, const void* pv,
               const void* pages, const void* apos, void* scores, void* out,
               int B, Geom G, cudaStream_t stream) {
  if (G.rep == 1)
    return launch<T, 1>(q, pk, pv, pages, apos, scores, out, B, G, stream);
  if (G.rep == 2)
    return launch<T, 2>(q, pk, pv, pages, apos, scores, out, B, G, stream);
  if (G.rep <= 4)
    return launch<T, 4>(q, pk, pv, pages, apos, scores, out, B, G, stream);
  return launch<T, 8>(q, pk, pv, pages, apos, scores, out, B, G, stream);
}

bool bad_geom(int B, int P, int page, int nkv, int rep) {
  return B < 1 || P < 1 || page < 1 || nkv < 1 || rep < 1 || rep > kMaxRep ||
         static_cast<int64_t>(P) * page > kMaxView ||
         static_cast<int64_t>(B) * nkv * kCluster > 0x7fffffff;
}

}  // namespace

// f32 elements of the scores scratch that paged_decode_launch takes: 0
// where the blocks keep their scores in shared memory (a view of at most
// kCluster · kMaxRange positions), else a slice of range_max · rep_block
// for each block.
extern "C" int64_t paged_decode_scratch_floats(int B, int P, int page,
                                               int nkv, int rep) {
  if (bad_geom(B, P, page, nkv, rep)) return 0;
  const Geom G{P, page, nkv, rep, 0};
  if (scores_shared(G)) return 0;
  return static_cast<int64_t>(B) * nkv * kCluster * range_max(G) *
         rep_block(rep);
}

// q (B, 1, nkv, rep, hd); pk/pv (n_pages, page, nkv, hd); pages (B, P)
// int32; apos (B, 1) int32; scores f32 of paged_decode_scratch_floats
// elements (null where that is 0); out (B, 1, nkv, rep, hd) f32.  All
// contiguous on one device, the pools 16-byte aligned; hd a multiple of
// 8, at most 128; rep at most 8.  Returns cudaGetLastError() after the
// launch.
extern "C" int paged_decode_launch(const void* q, const void* pk,
                                   const void* pv, const void* pages,
                                   const void* apos, void* scores, void* out,
                                   int B, int P, int page, int nkv, int rep,
                                   int hd, int dtype, void* stream) {
  if (bad_geom(B, P, page, nkv, rep) || hd < 8 || hd > kMaxHd || hd % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom G{P, page, nkv, rep, hd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dts::kBFloat16)
    return launch_rep<__nv_bfloat16>(q, pk, pv, pages, apos, scores, out, B,
                                     G, s);
  if (dtype == dts::kFloat32)
    return launch_rep<float>(q, pk, pv, pages, apos, scores, out, B, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
