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
// bit-equal to them.  K5's quantiser divides (an IEEE division: never
// --use_fast_math, never x · (1/scale)) and rounds half to even.
//
// What bounds them on an H100: operations at the training shapes (M =
// 8192: ~650-1300 int8 operations per byte moved, above the card's ~590
// at 1979 TOPS over 3.35 TB/s); bytes at decode (M = 8: the weight is
// read once for 16 operations per byte).
//
// K4: mma.sync m16n8k32 (s8) in one block of 8
// warps per 128 x 128 output tile, each warp a 64 x 32 sub-tile, K in
// slices of 128 double-buffered by cp.async, rows padded to 144 bytes.
// B comes in either layout: K-major (N, K), read with 32-bit fragment
// loads (the dX product), or the reference's (K, N), whose fragments
// gather four bytes of a column (ldmatrix has no 8-bit transpose); no
// transposed copy of a weight is made.  Ragged edges are zero-filled,
// so K % 16 == 0 (and N % 16 == 0 for a (K, N) B) is all it needs.
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
// 3. The GEMM: one block per 128 x 256 output tile, three warpgroups.
//    Warp 0 of the first is the producer: one thread keeps a 4-stage
//    ring of TMA loads in flight (A 128 x 128 and B 256 x 128 bytes a
//    stage, 128-byte swizzle, completion on a "full" mbarrier each
//    stage).  The two consumer warpgroups each own 64 rows: per stage
//    four wgmma m64n256k32 s8·s8→s32 from shared memory, both operands
//    K-major, the previous stage released to the producer on an "empty"
//    mbarrier once its wgmma group has retired.  TMA zero-fills past M,
//    N and K (codes 0 add nothing), so K % 16 == 0 (the row stride TMA
//    takes) is all it needs.  The epilogue scales in registers and
//    stores bf16 pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ------------------------------------------------- K4: mma.sync GEMM

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

// kBKMajor: B is (N, K), else (K, N).
template <bool kBKMajor>
__global__ void __launch_bounds__(kThreads)
int8_mm(const uint8_t* __restrict__ a8, const uint8_t* __restrict__ b,
        const float* __restrict__ xs, const float* __restrict__ ws,
        __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * kWM, wn = (warp % 4) * kWN;
  const int g = lane / 4, t = lane % 4;

  auto load_b = [&](uint8_t* dst, int k0) {
    if constexpr (kBKMajor)
      load_rows(dst, b, N, K, n0, k0);
    else
      load_cols(dst, b, K, N, k0, n0);
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + kBK - 1) / kBK;
  load_rows(smem, a8, M, K, m0, 0);
  load_b(smem + kTile, 0);
  hop::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const uint8_t* as = smem + (kt % 2) * kStage;
    const uint8_t* bs = as + kTile;
    uint8_t* nxt = smem + ((kt + 1) % 2) * kStage;
    const bool more = kt + 1 < nk;
    if (more) {
      load_rows(nxt, a8, M, K, m0, (kt + 1) * kBK);
      load_b(nxt + kTile, (kt + 1) * kBK);
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
        if constexpr (kBKMajor) {
          const uint8_t* p = bs + (wn + j * 8 + g) * kStride + ks + t * 4;
          bf[j][0] = lds32(p);
          bf[j][1] = lds32(p + 16);
        } else {
          const uint8_t* p = bs + (ks + t * 4) * kStride + wn + j * 8 + g;
          bf[j][0] = lds_col4(p, kStride);
          bf[j][1] = lds_col4(p + 16 * kStride, kStride);
        }
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
        if (r < M && c < N) {
          const float sx = xs[r], sw = ws[c];
          const float v = (__int2float_rn(acc[i][j][e]) * sx) * sw;
          out[static_cast<int64_t>(r) * N + c] = __float2bfloat16_rn(v);
        }
      }
}

template <bool kBKMajor>
int launch_mm(const void* a, const void* b, const float* xs, const float* ws,
              void* out, int M, int N, int K, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      int8_mm<kBKMajor>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * kStage);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_mm<kBKMajor><<<grid, kThreads, 2 * kStage, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), xs, ws,
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int M, int N, int K, bool b_kmajor) {
  return M < 1 || N < 1 || K < 16 || K % 16 || (!b_kmajor && N % 16);
}

// --------------------------------- K5: quantising prologue, wgmma GEMM

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

// Does k-block kb of nk enter the sum?
__device__ __forceinline__ bool kblock_in_sum(int kb, int nk) {
  return kb < nk;
}

// K5's epilogue: (f32(acc) · xs) · ws in the reference's order, one
// round to nearest even
__device__ __forceinline__ __nv_bfloat16 k5_out(int acc, float sx,
                                                float sw) {
  return __float2bfloat16_rn((__int2float_rn(acc) * sx) * sw);
}

__global__ void __launch_bounds__(k5::kThreads, 1)
k5_gemm(const __grid_constant__ CUtensorMap ta,
        const __grid_constant__ CUtensorMap tb, const float* __restrict__ xs,
        const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int M,
        int N, int K) {
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
    if (kblock_in_sum(kb, nk)) {
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
      const __nv_bfloat16 v0 = k5_out(acc[4 * j + 2 * h], sx, ws[c]);
      if (c + 1 < N) {
        const __nv_bfloat16 v1 = k5_out(acc[4 * j + 2 * h + 1], sx, ws[c + 1]);
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

}  // namespace

// K4.  a (M, K) int8; b (N, K) int8 if b_kmajor else (K, N); xs (M) and
// ws (N) f32; out (M, N) bf16.  All contiguous on one device, K a
// multiple of 16 (and N for a (K, N) b).  Returns cudaGetLastError().
extern "C" int int8_matmul_launch(const void* a, const void* b,
                                  const void* xs, const void* ws, void* out,
                                  int M, int N, int K, int b_kmajor,
                                  void* stream) {
  if (bad_shape(M, N, K, b_kmajor))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(xs);
  const float* fw = static_cast<const float*>(ws);
  return b_kmajor ? launch_mm<true>(a, b, fx, fw, out, M, N, K, s)
                  : launch_mm<false>(a, b, fx, fw, out, M, N, K, s);
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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap ta, tb;
  if (!hop::sw128_map(&ta, codes, M, K, K, 1, k5::kBM) ||
      !hop::sw128_map(&tb, b, N, K, K, 1, k5::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(k5_gemm,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             k5::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + k5::kBN - 1) / k5::kBN, (M + k5::kBM - 1) / k5::kBM);
  k5_gemm<<<grid, k5::kThreads, k5::kSmem, s>>>(
      ta, tb, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
