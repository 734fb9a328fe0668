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
//   out    = f32(sum of code · v) · sc, the PV sum exact in int32 and
//            converted once, as the reference converts it.
// Output f32 (B, 1, n_kv, rep, hd), the layout of the reference.
//
// What bounds it on an H100: bytes.  Each (b, g) reads its visible K and
// V rows with their scales, 2 · (apos+1) · (hd + 4) bytes, for about
// 4 · rep · hd integer operations per position: about 8 operations a
// byte at rep 4 and hd 128, far below what the card needs to be bound by
// its operations.  So the design is about having every visible row in
// flight at once, reading each once, in one launch.
//
// Design, for Hopper: K1's (csrc/paged_decode.cu), one launch, a
// thread-block cluster of kCluster blocks per (b, g).
//  * The visible positions 0..min(apos[b], V - 1) are cut into kCluster
//    contiguous ranges, one a block; a block wholly past apos issues no
//    loads, and the null page 0 of padded table rows is never read.
//  * Loads: every thread issues 16-byte cp.async copies of the range's
//    K and V rows (hd bytes each, strided by n_kv · hd in the pool) and
//    4-byte ones of their f32 scales, each row's page id read once from
//    the table; K with both scales and V are two commit groups, so the
//    keys are scored while V still arrives.  A range longer than the R
//    rows a block holds is taken in sub-ranges, as K1 does.
//  * Scores: a thread a key, __dp4a on the CUDA cores over 16 bytes of
//    its K row at a time (rows padded by 16 bytes in shared memory, so
//    a warp's loads of eight rows meet no bank twice) against the query
//    rows' codes (broadcast reads).  Each position is scored once; the
//    scores stay in shared memory (in a view longer than kCluster ·
//    kMaxRange positions, in a global scratch the caller gives, each
//    block its own slice) beside the position's V scale.
//  * First exchange: each block's (max, sum of exp(s - max)) per query
//    row; after a cluster barrier every block reads the kCluster pairs
//    over distributed shared memory in rank order and forms the row's
//    max M and sum L.
//  * Second exchange: each block forms pvw = (exp(s - M) / L) · vs in
//    place of its scores and its local absmax of |pvw|; after a cluster
//    barrier every block takes the max of the kCluster values (a max is
//    exact in any order), the row's scale sc, and then its codes.
//  * PV: groups of hd / 4 threads, four dims a thread, sum code · v in
//    int32 over the block's positions from the V rows in shared memory.
//    After a third barrier block c adds the kCluster int32 partial sums
//    of its slice of the output and writes f32(sum) · sc once: the sum
//    is exact, so the result repeats bit for bit, with no atomics.
//
// Numerics vs the reference: the same operations; the softmax sums in
// another order and expf is the card's, so a probability can differ by
// an f32 ulp, which now and then moves a code across a rounding boundary
// (one step of sc · |v| in that output), or the row's absmax, and with
// it every output of the row, by an f32 ulp.  Where the codes and the
// row's scale agree, the output is bit-equal to the plain version's.
// The kernel is held to an allclose limit set between its reading and a
// mutant's (ops/paged_attention.py).

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "paged_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // 8 warps a block
constexpr int kCluster = 8;        // blocks per (b, g), portable size
constexpr int kMaxRep = 8;         // query rows per kv head
constexpr int kMaxHd = 128;        // head dims
// K + V rows a block holds at once: three blocks share an SM, so the
// serve shape's 256 blocks run in one wave
constexpr int kRowBytes = 57344;
// positions a block keeps scores for in shared memory; a longer range
// keeps them in the caller's scratch
constexpr int kMaxRange = 2048;
constexpr int kMaxView = 1 << 30;  // positions of a view, as int

struct Geom {
  int P, page, nkv, rep, hd;
  float inv_root_hd;
};

// The last visible position of a slot whose query sits at ap, in a view
// of V positions: key t is visible iff t <= ap.
__device__ __forceinline__ int last_key(int ap, int V) { return min(ap, V - 1); }
// Whether rank c's partial PV sums enter the output of a cluster of n.
__device__ __forceinline__ bool rank_in_sum(int c, int n) { return c < n; }

__device__ __forceinline__ float pvw_scale(float amax) {
  return amax > 0.f ? amax * (1.0f / 127.0f) : 1.0f;
}

// The code of x at the row's scale sc: a division, as the reference
// divides, rounded to nearest even and clipped.
__device__ __forceinline__ int pvw_code(float x, float sc) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(x, sc))));
}

// The most positions a block is given.
__host__ __device__ inline int range_max(const Geom& G) {
  return (G.P * G.page + kCluster - 1) / kCluster;
}
// whether the blocks keep their scores in shared memory
__host__ __device__ inline bool scores_shared(const Geom& G) {
  return range_max(G) <= kMaxRange;
}
// rep rounded up to a power of two: the stride of the scores and codes
__host__ __device__ inline int rep_block(int rep) {
  return rep == 1 ? 1 : rep == 2 ? 2 : rep <= 4 ? 4 : 8;
}
// the K buffer's row stride in bytes: 16 bytes of padding
__host__ __device__ inline int kstride(const Geom& G) { return G.hd + 16; }
__host__ __device__ inline int rows_held(const Geom& G) {
  const int r = kRowBytes / (2 * G.hd);
  return r < range_max(G) ? r : range_max(G);
}
// table entries a block's range can touch
__host__ __device__ inline int pages_held(const Geom& G) {
  return range_max(G) / G.page + 2;
}
// threads a PV group (four dims each), and the groups of a block
__host__ __device__ inline int pv_groups(const Geom& G) {
  return kThreads / (G.hd / 4);
}
__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~15ull; }

// Byte offsets of a block's shared-memory regions, each 16-byte aligned.
struct Layout {
  size_t vb, ks, vs, qw, qs, sc, vr, small, part, pg, total;
};

__host__ __device__ inline Layout layout(const Geom& G) {
  const size_t held = rows_held(G), RB = rep_block(G.rep);
  const size_t shared_range = scores_shared(G) ? range_max(G) : 0;
  Layout L;
  // the K rows, or after the scores the PV groups' int32 sums
  const size_t k = held * kstride(G);
  const size_t g = sizeof(int) * G.rep * pv_groups(G) * G.hd;
  L.vb = up16(k > g ? k : g);
  L.ks = L.vb + held * G.hd;
  L.vs = L.ks + up16(sizeof(float) * held);
  L.qw = L.vs + up16(sizeof(float) * held);
  L.qs = L.qw + RB * G.hd;
  L.sc = L.qs + up16(sizeof(float) * RB);
  L.vr = L.sc + up16(sizeof(float) * shared_range * RB);
  L.small = L.vr + up16(sizeof(float) * shared_range);
  // stat 2 · kMaxRep, ml 2 · kMaxRep, am, scl kMaxRep each, the warps'
  // absmaxes kThreads / 32 · kMaxRep
  L.part = L.small + sizeof(float) * (6 * kMaxRep + kThreads / 32 * kMaxRep);
  L.pg = L.part + sizeof(int) * G.rep * G.hd;
  L.total = L.pg + up16(sizeof(int) * pages_held(G));
  return L;
}

struct Smem {
  int8_t *kb, *vb;           // rows_held K (stride kstride) and V rows
  int* gpart;                // the PV groups' sums, over the K rows
  float *ks, *vs;            // the sub-range's K and V row scales
  int* qw;                   // q codes as words, RB rows (zero past rep)
  float* qs;                 // q scales (zero past rep)
  float *sc, *vr;            // scores, then pvw, then codes (RB a
                             // position); each position's V scale
  float *stat, *ml, *am, *scl, *wmax;  // (max, sum); (M, L); the block's
                             // absmax; the row's scale; the warps' absmax
  int* part;                 // the block's int32 PV sums
  int* pg;                   // the page ids of the block's range
  __device__ Smem(unsigned char* base, const Layout& L) {
    kb = reinterpret_cast<int8_t*>(base);
    gpart = reinterpret_cast<int*>(base);
    vb = reinterpret_cast<int8_t*>(base + L.vb);
    ks = reinterpret_cast<float*>(base + L.ks);
    vs = reinterpret_cast<float*>(base + L.vs);
    qw = reinterpret_cast<int*>(base + L.qw);
    qs = reinterpret_cast<float*>(base + L.qs);
    sc = reinterpret_cast<float*>(base + L.sc);
    vr = reinterpret_cast<float*>(base + L.vr);
    stat = reinterpret_cast<float*>(base + L.small);
    ml = stat + 2 * kMaxRep;
    am = ml + 2 * kMaxRep;
    scl = am + kMaxRep;
    wmax = scl + kMaxRep;
    part = reinterpret_cast<int*>(base + L.part);
    pg = reinterpret_cast<int*>(base + L.pg);
  }
};

__device__ __forceinline__ int64_t scale_row(int pg, int off, int g,
                                             const Geom& G) {
  return (static_cast<int64_t>(pg) * G.page + off) * G.nkv + g;
}

// RB ints of shared memory at p (16-byte aligned for RB >= 4)
template <int RB>
__device__ __forceinline__ void load_codes(const int* p, int (&x)[RB]) {
  if constexpr (RB >= 4) {
#pragma unroll
    for (int i = 0; i < RB; i += 4) {
      const int4 v = *reinterpret_cast<const int4*>(p + i);
      x[i] = v.x, x[i + 1] = v.y, x[i + 2] = v.z, x[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RB; ++i) x[i] = p[i];
  }
}

template <int RB>
__global__ void __launch_bounds__(kThreads)
decode_q8_kernel(const int8_t* __restrict__ qq, const float* __restrict__ qsc,
                 const int8_t* __restrict__ pk, const int8_t* __restrict__ pv,
                 const float* __restrict__ pks, const float* __restrict__ pvs,
                 const int* __restrict__ pages, const int* __restrict__ apos,
                 float* scratch, float* __restrict__ out, Geom G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bg = blockIdx.x / kCluster, b = bg / G.nkv, g = bg % G.nkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hd = G.hd, rep = G.rep, W = hd / 4;
  Smem sm(smem_raw, layout(G));
  if (!scores_shared(G)) {
    // the scratch: every block's scores, then every block's V scales
    const int64_t rm = range_max(G);
    sm.sc = scratch + static_cast<int64_t>(blockIdx.x) * rm * RB;
    sm.vr = scratch + static_cast<int64_t>(gridDim.x) * rm * RB +
            static_cast<int64_t>(blockIdx.x) * rm;
  }
  const int* prow = pages + static_cast<int64_t>(b) * G.P;

  // this block's positions [p0, p0 + len) of the visible 0..kend
  const int n = last_key(apos[b], G.P * G.page) + 1;
  const int chunk = (n + kCluster - 1) / kCluster;
  const int p0 = rank * chunk;
  const int len = max(0, min(chunk, n - p0));
  const int held = rows_held(G);
  const int n_sub = (len + held - 1) / held;
  const int cpr = hd / 16;   // 16-byte copies a row
  const int kst = kstride(G);

  auto page_of = [&](int pos) { return sm.pg[pos / G.page - p0 / G.page]; };
  // issue the copies of sub-range s's K rows and both row scales as one
  // commit group (after a barrier: the buffers' earlier reads are done,
  // and the staged page ids are visible)
  auto issue_k = [&](int s) {
    const int cnt = min(held, len - s * held), base = p0 + s * held;
    __syncthreads();
    for (int i = tid; i < cnt * cpr; i += kThreads) {
      const int r = i / cpr, c = i % cpr, pos = base + r;
      const int64_t at = dts::pool_row(page_of(pos), pos % G.page, g, G.page,
                                       G.nkv, hd);
      hop::cp_async16(sm.kb + r * kst + 16 * c, pk + at + 16 * c, true);
    }
    for (int r = tid; r < cnt; r += kThreads) {
      const int pos = base + r;
      const int64_t at = scale_row(page_of(pos), pos % G.page, g, G);
      hop::cp_async4(sm.ks + r, pks + at);
      hop::cp_async4(sm.vs + r, pvs + at);
    }
    hop::cp_async_commit();
  };
  // likewise sub-range s's V rows
  auto issue_v = [&](int s) {
    const int cnt = min(held, len - s * held), base = p0 + s * held;
    __syncthreads();
    for (int i = tid; i < cnt * cpr; i += kThreads) {
      const int r = i / cpr, c = i % cpr, pos = base + r;
      const int64_t at = dts::pool_row(page_of(pos), pos % G.page, g, G.page,
                                       G.nkv, hd);
      hop::cp_async16(sm.vb + r * hd + 16 * c, pv + at + 16 * c, true);
    }
    hop::cp_async_commit();
  };

  const int* qb = reinterpret_cast<const int*>(qq) +
                  static_cast<int64_t>(bg) * rep * W;
  for (int i = tid; i < RB * W; i += kThreads)
    sm.qw[i] = i < rep * W ? qb[i] : 0;
  if (tid < RB)
    sm.qs[tid] = tid < rep ? qsc[static_cast<int64_t>(bg) * rep + tid] : 0.f;
  // the table entries of the range, read once
  if (len > 0)
    for (int i = p0 / G.page + tid; i <= (p0 + len - 1) / G.page;
         i += kThreads)
      sm.pg[i - p0 / G.page] = prow[i];
  if (len > 0) {
    issue_k(0);
    issue_v(n_sub - 1);   // kept for the PV pass
  }
  __syncthreads();

  // scores: a thread a key, 16 bytes of its K row at a time against the
  // same 16 bytes of each query row (broadcast reads)
  for (int s = 0; s < n_sub; ++s) {
    // K of sub-range s (the first V group may still be in flight)
    if (s == 0)
      hop::cp_async_wait<1>();
    else
      hop::cp_async_wait<0>();
    __syncthreads();
    const int cnt = min(held, len - s * held);
    for (int kr = tid; kr < cnt; kr += kThreads) {
      int acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0;
      for (int c = 0; c < hd; c += 16) {
        const int4 k4 = *reinterpret_cast<const int4*>(sm.kb + kr * kst + c);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int4 q4 = *reinterpret_cast<const int4*>(sm.qw + r * W + c / 4);
          acc[r] = __dp4a(q4.x, k4.x, acc[r]);
          acc[r] = __dp4a(q4.y, k4.y, acc[r]);
          acc[r] = __dp4a(q4.z, k4.z, acc[r]);
          acc[r] = __dp4a(q4.w, k4.w, acc[r]);
        }
      }
      const float ksc = sm.ks[kr];
      float* srow = sm.sc + (s * held + kr) * RB;
#pragma unroll
      for (int r = 0; r < RB; ++r)
        srow[r] = ((__int2float_rn(acc[r]) * sm.qs[r]) * ksc) * G.inv_root_hd;
      sm.vr[s * held + kr] = sm.vs[kr];
    }
    if (s + 1 < n_sub) issue_k(s + 1);
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

  // pvw = p · vs in place of the scores (0 in the rows past rep), and
  // the block's absmax per row: a thread's entries all belong to query
  // row tid % RB, since RB divides kThreads
  const int rt = tid % RB;
  float amax = 0.f;
  for (int i = tid; i < len * RB; i += kThreads) {
    float w = 0.f;
    if (rt < rep)
      w = (expf(sm.sc[i] - sm.ml[2 * rt]) / sm.ml[2 * rt + 1]) *
          sm.vr[i / RB];
    sm.sc[i] = w;
    amax = fmaxf(amax, fabsf(w));
  }
  for (int o = 16; o >= RB; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane < RB) sm.wmax[warp * RB + lane] = amax;
  __syncthreads();
  if (tid < rep) {
    float a = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) a = fmaxf(a, sm.wmax[w * RB + tid]);
    sm.am[tid] = a;
  }
  cluster.sync();

  // the row's absmax over the cluster and its scale
  if (tid < rep) {
    const int r = tid;
    float A = 0.f;
    for (int c = 0; c < kCluster; ++c)
      A = fmaxf(A, cluster.map_shared_rank(sm.am, c)[r]);
    sm.scl[r] = pvw_scale(A);
  }
  __syncthreads();
  // the codes, in place of pvw
  int* codes = reinterpret_cast<int*>(sm.sc);
  for (int i = tid; i < len * RB; i += kThreads)
    codes[i] = rt < rep ? pvw_code(sm.sc[i], sm.scl[rt]) : 0;

  // PV: ng groups of W = hd / 4 threads, four dims a thread, group gi
  // taking every ng-th position; the last sub-range's V is in the
  // buffer, the others are loaded after it
  const int ng = pv_groups(G), gi = tid / W, w = tid % W;
  int acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0;
  for (int t = 0; t < n_sub; ++t) {
    const int s = t == 0 ? n_sub - 1 : t - 1;
    if (t > 0) issue_v(s);
    hop::cp_async_wait<0>();
    __syncthreads();
    const int cnt = min(held, len - s * held);
    if (gi < ng)
#pragma unroll 4
      for (int kr = gi; kr < cnt; kr += ng) {
        const int word = reinterpret_cast<const int*>(sm.vb + kr * hd)[w];
        const int8_t* v4 = reinterpret_cast<const int8_t*>(&word);
        int c[RB];
        load_codes<RB>(codes + (s * held + kr) * RB, c);
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] += c[r] * v4[i];
      }
    __syncthreads();   // the buffer is read before the next sub-range
  }
  if (gi < ng)
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < rep)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sm.gpart[(gi * rep + r) * hd + 4 * w + i] = acc[r][i];
  __syncthreads();
  for (int i = tid; i < rep * hd; i += kThreads) {
    int v = 0;
    for (int k = 0; k < ng; ++k) v += sm.gpart[k * rep * hd + i];
    sm.part[i] = v;
  }
  cluster.sync();

  // block `rank` adds the cluster's int32 sums of its slice, exactly,
  // and writes f32(sum) · sc once
  const int n_out = rep * hd, per = (n_out + kCluster - 1) / kCluster;
  for (int i = rank * per + tid; i < min(n_out, (rank + 1) * per);
       i += kThreads) {
    int v = 0;
    for (int c = 0; c < kCluster; ++c)
      if (rank_in_sum(c, kCluster))
        v += cluster.map_shared_rank(sm.part, c)[i];
    out[static_cast<int64_t>(bg) * n_out + i] =
        __int2float_rn(v) * sm.scl[i / hd];
  }
  cluster.sync();   // no block leaves while its partial sums are read
}

constexpr int kMaxSmem = 232448;   // the most shared memory a block has

// The kernel's attributes, set once a device: dynamic shared memory up
// to kMaxSmem, and the whole L1 as shared memory (more blocks an SM).
template <int RB>
cudaError_t set_attributes() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(decode_q8_kernel<RB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_q8_kernel<RB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

struct Args {
  const int8_t *qq, *pk, *pv;
  const float *qs, *pks, *pvs;
  const int *pages, *apos;
  float *scratch, *out;
};

template <int RB>
int launch(const Args& a, int B, const Geom& G, cudaStream_t stream) {
  const size_t smem = layout(G).total;
  if (smem > kMaxSmem || (!scores_shared(G) && a.scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_attributes<RB>();
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
  err = cudaLaunchKernelEx(&cfg, decode_q8_kernel<RB>, a.qq, a.qs, a.pk, a.pv,
                           a.pks, a.pvs, a.pages, a.apos, a.scratch, a.out, G);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool bad_geom(int B, int P, int page, int nkv, int rep, int hd) {
  return B < 1 || P < 1 || page < 1 || nkv < 1 || rep < 1 || rep > kMaxRep ||
         hd < 16 || hd > kMaxHd || hd % 16 ||
         static_cast<int64_t>(P) * page > kMaxView ||
         static_cast<int64_t>(B) * nkv * kCluster > 0x7fffffff;
}

}  // namespace

// f32 elements of the scratch that paged_decode_q8_launch takes: 0 where
// the blocks keep their scores in shared memory (a view of at most
// kCluster · kMaxRange positions), else for each block a slice of
// range_max · rep_block scores and one of range_max V scales.
extern "C" int64_t paged_decode_q8_scratch_floats(int B, int P, int page,
                                                  int nkv, int rep, int hd) {
  if (bad_geom(B, P, page, nkv, rep, hd)) return 0;
  const Geom G{P, page, nkv, rep, hd, 0.f};
  if (scores_shared(G)) return 0;
  return static_cast<int64_t>(B) * nkv * kCluster * range_max(G) *
         (rep_block(rep) + 1);
}

// qq (B, 1, nkv, rep, hd) int8; qs (B, 1, nkv, rep, 1) f32; pk/pv
// (n_pages, page, nkv, hd) int8; pks/pvs (n_pages, page, nkv, 1) f32;
// pages (B, P) int32; apos (B, 1) int32; scratch f32 of
// paged_decode_q8_scratch_floats elements (null where that is 0); out
// (B, 1, nkv, rep, hd) f32.  All contiguous on one device, qq and the
// pools 16-byte aligned; hd a multiple of 16, at most 128; rep at most
// 8.  Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_q8_launch(const void* qq, const void* qs,
                                      const void* pk, const void* pv,
                                      const void* pks, const void* pvs,
                                      const void* pages, const void* apos,
                                      void* scratch, void* out, int B, int P,
                                      int page, int nkv, int rep, int hd,
                                      void* stream) {
  if (bad_geom(B, P, page, nkv, rep, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom G{P, page, nkv, rep, hd,
               1.0f / sqrtf(static_cast<float>(hd))};
  const Args a{static_cast<const int8_t*>(qq),
               static_cast<const int8_t*>(pk),
               static_cast<const int8_t*>(pv),
               static_cast<const float*>(qs),
               static_cast<const float*>(pks),
               static_cast<const float*>(pvs),
               static_cast<const int*>(pages),
               static_cast<const int*>(apos),
               static_cast<float*>(scratch),
               static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rep == 1) return launch<1>(a, B, G, s);
  if (rep == 2) return launch<2>(a, B, G, s);
  if (rep <= 4) return launch<4>(a, B, G, s);
  return launch<8>(a, B, G, s);
}
