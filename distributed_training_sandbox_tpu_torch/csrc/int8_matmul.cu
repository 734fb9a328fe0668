// int8 GEMMs with a per-row and a per-column scale, K4 and K5:
//   out = bf16((f32(A·B) · xs[m]) · ws[n]),  A·B summed exactly in int32.
//
// Replaces: distributed_training_sandbox_tpu/ops/quant.py,
//   K4 int8_matmul_pallas (_qmm_kernel): A arrives quantised, (M, K)
//      int8 with its (M, 1) f32 row scales.  Every projection and the
//      unembedding of int8 serving (prequantized_dense), and the dX / dW
//      products of matmul_precision="int8_pallas_bwd";
//   K5 int8_matmul_pallas_fused (_fused_qmm_kernel): A arrives as the
//      bf16 activation; each row is quantised over its full K (scale =
//      absmax · f32(1/127), code = rint(x / scale) clipped to ±127).
//      The forward of every projection under "int8_pallas(_bwd)".
//
// Computes what the reference computes: int8 × int8 products summed in
// int32, which is exact at every shape of the slice (at the largest
// contraction, dW at M = 8192, |acc| <= 127² · 8192 < 2^31), then the
// epilogue in the reference's order, (f32(acc) · xs) · ws, and one
// round to nearest even to bf16.  The plain PyTorch versions
// (ops/quant.py) compute the same sums exactly, so the kernels are
// bit-equal to them whatever order they sum in: split-K partial sums
// added by integer atomics repeat bit for bit.  K5's quantiser divides
// (an IEEE division: never --use_fast_math, never x · (1/scale)) and
// rounds half to even.
//
// What bounds them on an H100: operations at the training shapes (M =
// 8192: ~650-1300 int8 operations per byte moved, above the card's ~590
// at 1979 TOPS over 3.35 TB/s); bytes at decode (M = 8: the weight is
// read once for 16 operations per byte).
//
// K4 has three designs; the wrapper (ops/quant.py k4_design) picks one
// from M and B's layout, and every one ends in k4_out:
// - B K-major, (N, K) (the training path's dX = g · Wᵀ and dW = Xᵀ · g,
//   whose operands the backward quantises along M straight into (K, M)
//   and (N, M) codes): K5's wgmma GEMM below, without its prologue.
// - B in the reference's (K, N) layout, M <= 16 (decode; the
//   unembedding): a split-K GEMV.  Reading the weight once is the bound,
//   so the grid is (N strips of 128 columns) x (K splits), sized to fill
//   the card about twice.  A lane loads 4 bytes of 4 consecutive k rows
//   (a warp reads 128 contiguous bytes a row), turns the 4 x 4 bytes
//   into 4 words of 4 k-values of one column (__byte_perm) and __dp4a's
//   each against the A rows' packed codes, staged once in shared memory.
//   The block's eight warps add their sums in shared memory; a split adds
//   its strip's sums into a zeroed int32 scratch by integer atomics, and
//   the strip's last block (a counter) takes them back with atomicExch
//   (leaving the scratch zero again for the next launch) and runs the
//   epilogue.  A single split writes its output directly.
// - B (K, N), M > 16 (the int8 prefill's chunks, the "int8" forward):
//   mma.sync m16n8k32 (s8) in one block of 8 warps per 128 x 128 output
//   tile, each warp a 64 x 32 sub-tile, K in slices of 128
//   double-buffered by cp.async, rows padded to 144 bytes; the B
//   fragments gather four bytes of a column (ldmatrix has no 8-bit
//   transpose), so no transposed copy of a weight is made.  Ragged edges
//   are zero-filled, so K % 16 == 0 and N % 16 == 0 are all it needs.
//
// K5.  Quantising inside the GEMM would divide each element once per
// block of the N grid, N / 128 times (86 for w_gate and w_up), and a
// (K, N) B would be gathered byte by byte.  Instead:
// 1. A prologue kernel (one warp per row) finds the row's absmax, writes
//    the scale, and writes the row's codes once into an (M, K) int8
//    scratch that the wrapper allocates.  The reference keeps the codes
//    in VMEM because a TPU block carries the full K; a Hopper block
//    cannot hold a 128 x 11 008 tile, so the codes make one round trip
//    through device memory (M·K bytes written and read, in the bound).
// 2. B arrives K-major, (N, K): the training path quantises w.t() along
//    its last axis, which gives the transpose of the reference's codes
//    bit for bit.  The wrapper transposes a (K, N) B itself.
// 3. The GEMM (K4's too, on its own codes): one block per 128 x 256
//    output tile, three warpgroups.  Warp 0 of the first is the
//    producer: one thread keeps a 4-stage ring of TMA loads in flight
//    (A 128 x 128 and B 256 x 128 bytes a stage, 128-byte swizzle,
//    completion on a "full" mbarrier each stage).  The two consumer warpgroups each own 64 rows: per stage
//    four wgmma m64n256k32 s8·s8→s32 from shared memory, both operands
//    K-major, the previous stage released to the producer on an "empty"
//    mbarrier once its wgmma group has retired.  TMA zero-fills past M,
//    N and K (codes 0 add nothing), so K % 16 == 0 (the row stride TMA
//    takes) is all it needs.  The epilogue scales in registers and
//    stores bf16 pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

// K4's epilogue, on every path: (f32(acc) · xs) · ws in the reference's
// order, one round to nearest even
__device__ __forceinline__ __nv_bfloat16 k4_out(int acc, float sx, float sw) {
  const float v = (__int2float_rn(acc) * sx) * sw;
  return __float2bfloat16_rn(v);
}

// ------------------------------------------ K4, B (K, N): mma.sync GEMM

constexpr int kBM = 128, kBN = 128;  // output tile
constexpr int kBK = 128;             // K slice (elements = bytes)
constexpr int kStride = kBK + 16;    // shared row stride in bytes
constexpr int kThreads = 256;        // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64, kWN = 32;    // warp tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kTile = 128 * kStride;    // bytes of one A or B tile
constexpr int kStage = 2 * kTile;       // A and B of one slice

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four bytes of one column, rows p, p + stride, ... (low byte first)
__device__ __forceinline__ uint32_t lds_col4(const uint8_t* p, int stride) {
  return static_cast<uint32_t>(p[0]) |
         (static_cast<uint32_t>(p[stride]) << 8) |
         (static_cast<uint32_t>(p[2 * stride]) << 16) |
         (static_cast<uint32_t>(p[3 * stride]) << 24);
}

// Stage rows [r0, r0 + 128) x columns [k0, k0 + 128) of a row-major
// (R, K) int8 matrix; what lies outside it is zero-filled.
__device__ __forceinline__ void load_rows(uint8_t* dst,
                                          const uint8_t* __restrict__ src,
                                          int R, int K, int r0, int k0) {
  constexpr int kChunks = kBK / 16;
  for (int c = threadIdx.x; c < 128 * kChunks; c += kThreads) {
    const int r = c / kChunks, kc = (c % kChunks) * 16;
    const int gr = r0 + r, gk = k0 + kc;
    const bool ok = gr < R && gk < K;
    const uint8_t* p = ok ? src + static_cast<int64_t>(gr) * K + gk : src;
    hop::cp_async16(dst + r * kStride + kc, p, ok);
  }
}

// Stage rows [k0, k0 + 128) x columns [n0, n0 + 128) of a (K, N) int8
// matrix (row stride N); what lies outside it is zero-filled.
__device__ __forceinline__ void load_cols(uint8_t* dst,
                                          const uint8_t* __restrict__ src,
                                          int K, int N, int k0, int n0) {
  constexpr int kChunks = kBN / 16;
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks, nc = (c % kChunks) * 16;
    const int gk = k0 + r, gn = n0 + nc;
    const bool ok = gk < K && gn < N;
    const uint8_t* p = ok ? src + static_cast<int64_t>(gk) * N + gn : src;
    hop::cp_async16(dst + r * kStride + nc, p, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
int8_mm(const uint8_t* __restrict__ a8, const uint8_t* __restrict__ b,
        const float* __restrict__ xs, const float* __restrict__ ws,
        __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * kWM, wn = (warp % 4) * kWN;
  const int g = lane / 4, t = lane % 4;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + kBK - 1) / kBK;
  load_rows(smem, a8, M, K, m0, 0);
  load_cols(smem + kTile, b, K, N, 0, n0);
  hop::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const uint8_t* as = smem + (kt % 2) * kStage;
    const uint8_t* bs = as + kTile;
    uint8_t* nxt = smem + ((kt + 1) % 2) * kStage;
    if (kt + 1 < nk) {
      load_rows(nxt, a8, M, K, m0, (kt + 1) * kBK);
      load_cols(nxt + kTile, b, K, N, (kt + 1) * kBK, n0);
    }
    hop::cp_async_commit();
    hop::cp_async_wait<1>();   // slice kt has landed
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const uint8_t* p = as + (wm + i * 16 + g) * kStride + ks + t * 4;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * kStride);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint8_t* p = bs + (ks + t * 4) * kStride + wn + j * 8 + g;
        bf[j][0] = lds_col4(p, kStride);
        bf[j][1] = lds_col4(p + 16 * kStride, kStride);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();   // this buffer is free for slice kt + 2
  }

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + i * 16 + g + (e / 2) * 8;
        const int c = n0 + wn + j * 8 + t * 2 + (e % 2);
        if (r < M && c < N)
          out[static_cast<int64_t>(r) * N + c] = k4_out(acc[i][j][e], xs[r],
                                                        ws[c]);
      }
}

int launch_mm(const void* a, const void* b, const float* xs, const float* ws,
              void* out, int M, int N, int K, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      int8_mm, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * kStage);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_mm<<<grid, kThreads, 2 * kStage, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), xs, ws,
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int M, int N, int K, bool b_kmajor) {
  return M < 1 || N < 1 || K < 16 || K % 16 || (!b_kmajor && N % 16);
}

// ------------------------------------ K4, B (K, N), M <= 16: split-K GEMV

namespace gemv {
constexpr int kCols = 128;         // a strip: 32 lanes x 4 columns
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;          // 4-row groups a warp loads at once
constexpr int kMinRows = 128;      // the least of K a split takes
constexpr int kMaxRows = 2048;     // the most (A's codes: 32 KB at M 16)
constexpr int kFill = 264;         // blocks wanted: two an SM

// (strips, splits, rows a split) of an (M <= 16, K) x (K, N) product
struct Plan {
  int strips, splits, rows;
};

Plan plan(int N, int K) {
  Plan p;
  p.strips = (N + kCols - 1) / kCols;
  int want = (kFill + p.strips - 1) / p.strips;
  want = std::min(want, std::max(1, K / kMinRows));
  want = std::max(want, (K + kMaxRows - 1) / kMaxRows);
  p.rows = ((K + want - 1) / want + 15) / 16 * 16;
  p.splits = (K + p.rows - 1) / p.rows;
  return p;
}
}  // namespace gemv

// Does split s of n add its partial sums into the strip's total?
__device__ __forceinline__ bool split_in_sum(int s, int n) { return s < n; }

// The 4 x 4 bytes w[r] (4 columns of k row r) as c[j] (4 k rows of
// column j, row 0 in the low byte)
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4],
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// Block (strip x, split y): rows [y·rows, +rows) of K against columns
// [128 x, +128) of B, for the MT >= M rows of A (rows past M are zeros).
// scratch: M·N int32 sums then one counter a strip, zero between
// launches (unused with one split).
template <int MT>
__global__ void __launch_bounds__(gemv::kThreads)
int8_gemv(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
          const float* __restrict__ xs, const float* __restrict__ ws,
          __nv_bfloat16* __restrict__ out, int* __restrict__ scratch, int M,
          int N, int K, int rows) {
  extern __shared__ uint32_t sm[];
  __shared__ int last;
  const int gw = rows / 4;                           // A words a row
  uint32_t* aw = sm;                                 // [MT][gw]
  int* red = reinterpret_cast<int*>(sm + MT * gw);   // [MT][kCols]
  const int n0 = blockIdx.x * gemv::kCols, k0 = blockIdx.y * rows;
  const int ng = min(rows, K - k0) / 4;              // 4-row groups
  for (int i = threadIdx.x; i < MT * ng; i += gemv::kThreads) {
    const int m = i / ng, g = i % ng;
    aw[m * gw + g] = m < M ? *reinterpret_cast<const uint32_t*>(
                                 a + static_cast<int64_t>(m) * K + k0 + 4 * g)
                           : 0u;
  }
  for (int i = threadIdx.x; i < MT * gemv::kCols; i += gemv::kThreads)
    red[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = n0 + 4 * lane;
  const bool inside = n < N;   // N % 4 == 0: a lane's 4 columns or none
  const uint8_t* bp = b + static_cast<int64_t>(k0) * N + n;
  int acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;
  // warp w takes groups w, w + 8, ...: the warps sweep consecutive rows
  for (int g0 = warp; g0 < ng; g0 += gemv::kWarps * gemv::kBatch) {
    uint32_t w[gemv::kBatch][4];
#pragma unroll
    for (int u = 0; u < gemv::kBatch; ++u) {
      const int g = g0 + gemv::kWarps * u;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[u][r] = inside && g < ng
                      ? __ldcs(reinterpret_cast<const unsigned int*>(
                            bp + static_cast<int64_t>(4 * g + r) * N))
                      : 0u;
    }
#pragma unroll
    for (int u = 0; u < gemv::kBatch; ++u) {
      const int g = g0 + gemv::kWarps * u;
      if (g >= ng) break;
      uint32_t c[4];
      transpose4x4(w[u], c);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int x = static_cast<int>(aw[m * gw + g]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[m][j] = __dp4a(static_cast<int>(c[j]), x, acc[m][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (m < M) atomicAdd(&red[m * gemv::kCols + 4 * lane + j], acc[m][j]);
  __syncthreads();

  if (gridDim.y == 1) {   // the block holds the whole sum
    for (int i = threadIdx.x; i < M * gemv::kCols; i += gemv::kThreads) {
      const int m = i / gemv::kCols, c = n0 + i % gemv::kCols;
      if (c < N)
        out[static_cast<int64_t>(m) * N + c] = k4_out(red[i], xs[m], ws[c]);
    }
    return;
  }
  if (split_in_sum(blockIdx.y, gridDim.y)) {
    for (int i = threadIdx.x; i < M * gemv::kCols; i += gemv::kThreads) {
      const int m = i / gemv::kCols, c = n0 + i % gemv::kCols;
      if (c < N) atomicAdd(&scratch[static_cast<int64_t>(m) * N + c], red[i]);
    }
  }
  __threadfence();   // this split's sums before its ticket
  __syncthreads();
  int* ticket = scratch + static_cast<int64_t>(M) * N + blockIdx.x;
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < M * gemv::kCols; i += gemv::kThreads) {
    const int m = i / gemv::kCols, c = n0 + i % gemv::kCols;
    if (c < N) {
      const int64_t o = static_cast<int64_t>(m) * N + c;
      out[o] = k4_out(atomicExch(&scratch[o], 0), xs[m], ws[c]);
    }
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <int MT>
int launch_gemv(const void* a, const void* b, const float* xs,
                const float* ws, void* out, int* scratch, int M, int N, int K,
                cudaStream_t stream) {
  const gemv::Plan p = gemv::plan(N, K);
  const int smem = MT * p.rows + MT * gemv::kCols * 4;
  int8_gemv<MT><<<dim3(p.strips, p.splits), gemv::kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), xs, ws,
      static_cast<__nv_bfloat16*>(out), scratch, M, N, K, p.rows);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------ K5: quantising prologue; the wgmma GEMM (K4, K5)

constexpr int kQRows = 8;   // prologue: rows (warps) per block

// The absmax of row elements [k0, min(K, k0 + 128)).  The sound kernel
// does not use it: it quantises every element of a row with the full
// row's scale (the mutation check swaps one for the other).
__device__ float slice_amax(const __nv_bfloat16* __restrict__ row, int k0,
                            int K) {
  float m = 0.f;
  for (int k = k0; k < min(K, k0 + 128); ++k)
    m = fmaxf(m, fabsf(__bfloat162float(row[k])));
  return m;
}

// The scale that quantises the row's elements at k (row scale s).
__device__ __forceinline__ float code_scale(float s,
                                            const __nv_bfloat16* __restrict__ row,
                                            int k, int K) {
  (void)row, (void)k, (void)K;
  return s;   // the scale of the full row
}

// One int8 code: rint(v / s) clipped to +-127 (IEEE division, half to
// even), the reference's jnp.clip(jnp.round(x / scale), -127, 127).
__device__ __forceinline__ uint32_t code(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(max(-127, min(127, q)))));
}

// K5's prologue: one warp per row.  s = absmax · f32(1/127) (1 for an
// all-zero row) into xs, and every element's code, once, into codes.
__global__ void __launch_bounds__(kQRows * 32)
quantise_rows(const __nv_bfloat16* __restrict__ x, uint8_t* __restrict__ codes,
              float* __restrict__ xs, int M, int K) {
  const int row = blockIdx.x * kQRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const __nv_bfloat16* p = x + static_cast<int64_t>(row) * K;
  float amax = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + k);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      amax = fmaxf(amax, fabsf(__bfloat162float(e[j])));
  }
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = amax > 0.f ? amax * (1.0f / 127.0f) : 1.0f;
  if (lane == 0) xs[row] = s;
  uint8_t* c = codes + static_cast<int64_t>(row) * K;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + k);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
    const float sk = code_scale(s, p, k, K);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j / 4] |= code(__bfloat162float(e[j]), sk) << (8 * (j % 4));
    *reinterpret_cast<uint2*>(c + k) = make_uint2(w[0], w[1]);
  }
}

namespace k5 {
constexpr int kBM = 128, kBN = 256, kBK = 128;   // tile; K in bytes
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK, kBBytes = kBN * kBK;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1008;
}  // namespace k5

// Does k-block kb of nk enter K5's sum?
__device__ __forceinline__ bool kblock_in_sum(int kb, int nk) {
  return kb < nk;
}

// Does k-block kb of nk enter the sum of K4's wgmma path?
__device__ __forceinline__ bool k4_kblock_in_sum(int kb, int nk) { return kb < nk; }

// K5's epilogue: (f32(acc) · xs) · ws in the reference's order, one
// round to nearest even
__device__ __forceinline__ __nv_bfloat16 k5_out(int acc, float sx,
                                                float sw) {
  return __float2bfloat16_rn((__int2float_rn(acc) * sx) * sw);
}

// The wgmma GEMM of K5 (kK5, on its prologue's codes) and of K4 (on the
// caller's codes); the two differ only in which hooks they name.
template <bool kK5>
__global__ void __launch_bounds__(k5::kThreads, 1)
wgmma_gemm(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tb,
           const float* __restrict__ xs, const float* __restrict__ ws,
           __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using k5::kStages;
  using k5::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = hop::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  auto a_tile = [&](int s) { return smem + s * kStageBytes; };
  auto b_tile = [&](int s) { return smem + s * kStageBytes + k5::kABytes; };
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * k5::kBM, n0 = blockIdx.x * k5::kBN;
  const int nk = (K + k5::kBK - 1) / k5::kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);   // the consumers' eight warps
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer: one thread issues every TMA load
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStages;
        hop::mbar_wait(&empty[s], ((kb / kStages) & 1) ^ 1);
        hop::mbar_expect_tx(&full[s], kStageBytes);
        hop::tma_load_2d(a_tile(s), &ta, &full[s], kb * k5::kBK, m0);
        hop::tma_load_2d(b_tile(s), &tb, &full[s], kb * k5::kBK, n0);
      }
    }
    return;
  }

  const int cw = wg - 1;   // consumer: rows cw * 64 .. + 63 of the tile
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % kStages;
    hop::mbar_wait(&full[s], (kb / kStages) & 1);
    hop::fence_regs(acc);
    hop::wgmma_fence();
    if (kK5 ? kblock_in_sum(kb, nk) : k4_kblock_in_sum(kb, nk)) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hop::wgmma_m64n256k32_s8_ss(
            acc, hop::sw128_desc(a_tile(s) + cw * 64 * 128 + k * 32, 16, 1024),
            hop::sw128_desc(b_tile(s) + k * 32, 16, 1024));
    }
    hop::wgmma_commit();
    hop::fence_regs(acc);
    hop::wgmma_wait<1>();   // k-block kb - 1's products have retired
    if (kb > 0 && lane == 0) hop::mbar_arrive(&empty[(kb - 1) % kStages]);
  }
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);

  const int r0 = m0 + cw * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= M) continue;
    const float sx = xs[r];
    __nv_bfloat16* orow = out + static_cast<int64_t>(r) * N;
#pragma unroll
    for (int j = 0; j < k5::kBN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      if (c >= N) continue;
      const int a0 = acc[4 * j + 2 * h];
      const __nv_bfloat16 v0 =
          kK5 ? k5_out(a0, sx, ws[c]) : k4_out(a0, sx, ws[c]);
      if (c + 1 < N) {
        const int a1 = acc[4 * j + 2 * h + 1];
        const __nv_bfloat16 v1 =
            kK5 ? k5_out(a1, sx, ws[c + 1]) : k4_out(a1, sx, ws[c + 1]);
        if (N % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __halves2bfloat162(v0, v1);
        } else {
          orow[c] = v0;
          orow[c + 1] = v1;
        }
      } else {
        orow[c] = v0;
      }
    }
  }
}

// The wgmma GEMM on a (M, K) and b (N, K) int8 codes, both K-major
template <bool kK5>
int launch_wgmma(const void* a, const void* b, const float* xs,
                 const float* ws, void* out, int M, int N, int K,
                 cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!hop::sw128_map(&ta, a, M, K, K, 1, k5::kBM) ||
      !hop::sw128_map(&tb, b, N, K, K, 1, k5::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      wgmma_gemm<kK5>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      k5::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + k5::kBN - 1) / k5::kBN, (M + k5::kBM - 1) / k5::kBM);
  wgmma_gemm<kK5><<<grid, k5::kThreads, k5::kSmem, stream>>>(
      ta, tb, xs, ws, static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4 with B K-major (the wgmma GEMM) or in the reference's (K, N)
// layout (mma.sync).  a (M, K) int8; b (N, K) int8 if b_kmajor else
// (K, N); xs (M) and ws (N) f32; out (M, N) bf16.  All contiguous on one
// device, K a multiple of 16 (and N for a (K, N) b); a and b 16-byte
// aligned for the K-major path (TMA).  Returns cudaGetLastError()
// (cudaErrorInvalidValue where the tensor maps cannot be made).
extern "C" int int8_matmul_launch(const void* a, const void* b,
                                  const void* xs, const void* ws, void* out,
                                  int M, int N, int K, int b_kmajor,
                                  void* stream) {
  if (bad_shape(M, N, K, b_kmajor))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(xs);
  const float* fw = static_cast<const float*>(ws);
  return b_kmajor ? launch_wgmma<false>(a, b, fx, fw, out, M, N, K, s)
                  : launch_mm(a, b, fx, fw, out, M, N, K, s);
}

// int32 elements of the zeroed scratch K4's GEMV takes for an (M, K) x
// (K, N) product: the M·N sums and a counter a strip; 0 where one split
// covers K.
extern "C" int64_t int8_gemv_scratch_ints(int M, int N, int K) {
  const gemv::Plan p = gemv::plan(N, K);
  return p.splits == 1 ? 0
                       : static_cast<int64_t>(M) * N + p.strips;
}

// K4 at M <= 16 with B in the reference's (K, N) layout: the split-K
// GEMV.  a (M, K) int8; b (K, N) int8; xs (M) and ws (N) f32; out (M, N)
// bf16; scratch int8_gemv_scratch_ints(M, N, K) int32, zero (the kernel
// leaves it zero).  All contiguous on one device, K and N multiples of
// 16.  Returns cudaGetLastError().
extern "C" int int8_gemv_launch(const void* a, const void* b, const void* xs,
                                const void* ws, void* out, void* scratch,
                                int M, int N, int K, void* stream) {
  if (bad_shape(M, N, K, false) || M > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(xs);
  const float* fw = static_cast<const float*>(ws);
  int* sc = static_cast<int*>(scratch);
  if (M <= 1) return launch_gemv<1>(a, b, fx, fw, out, sc, M, N, K, s);
  if (M <= 2) return launch_gemv<2>(a, b, fx, fw, out, sc, M, N, K, s);
  if (M <= 4) return launch_gemv<4>(a, b, fx, fw, out, sc, M, N, K, s);
  if (M <= 8) return launch_gemv<8>(a, b, fx, fw, out, sc, M, N, K, s);
  return launch_gemv<16>(a, b, fx, fw, out, sc, M, N, K, s);
}

// K5.  x (M, K) bf16; b (N, K) int8, K-major; codes (M, K) int8 and xs
// (M) f32, scratch that receives the codes and row scales; ws (N) f32;
// out (M, N) bf16.  All contiguous, 16-byte aligned, on one device; K a
// multiple of 16.  Two launches: the quantising prologue, then the GEMM.
// Returns cudaGetLastError() (cudaErrorInvalidValue where the tensor
// maps cannot be made).
extern "C" int int8_matmul_fused_launch(const void* x, const void* b,
                                        void* codes, void* xs, const void* ws,
                                        void* out, int M, int N, int K,
                                        void* stream) {
  if (bad_shape(M, N, K, true))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantise_rows<<<(M + kQRows - 1) / kQRows, kQRows * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<uint8_t*>(codes),
      static_cast<float*>(xs), M, K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_wgmma<true>(codes, b, static_cast<const float*>(xs),
                            static_cast<const float*>(ws), out, M, N, K, s);
}
