// fp8 GEMM with per-tensor scales: out = bf16((A·B · a_s) · b_s).
//
// Replaces: distributed_training_sandbox_tpu/ops/quant.py,
// fp8_matmul_pallas (_fp8_mm_kernel), the forward product of every
// projection under matmul_precision="fp8_pallas".
//
// Computes what the reference computes: A (M, K) and B (K, N) hold
// e4m3 values; each product of two e4m3 values is exact in f32, the
// sum runs in f32, and the epilogue multiplies the f32 sum by the two
// f32 scalar scales in the reference's order, (acc · a_s) · b_s, and
// rounds to bf16 (round to nearest even).
//
// What bounds it on an H100: operations.  At the training path's shapes
// (M = 8192, K x N up to 2048 x 11008) a product does ~2·M·N·K / (M·K +
// K·N + 2·M·N) ≈ 650-1300 operations per byte it must move, above the
// card's ~590 fp8 operations per byte of HBM bandwidth.  This first
// version uses the fp8 tensor cores through mma.sync (m16n8k32, e4m3),
// which reach only part of the 1979 TFLOP/s that wgmma can; wgmma with a
// TMA-fed ring of tiles is the next step (ROADMAP.md).
//
// Design: one block of 8 warps per 128 x 128 output tile; each warp
// owns a 64 x 32 sub-tile (4 x 4 mma tiles).  The block walks K in
// slices of 128, double-buffered in shared memory with cp.async (16-byte
// copies; rows past M or N and columns past K are zero-filled, so ragged
// edges need no divisibility beyond K % 16 == 0).  B arrives K-major
// (bt, (N, K)): Hopper's fp8 MMAs take B K-major and ldmatrix.trans has
// no 8-bit form, so the wrapper (ops/quant.py) writes the transposed
// copy of the (K, N) weight; fragments are then plain 32-bit shared
// loads.  Rows are padded to 144 bytes, which keeps the fragment loads
// free of bank conflicts.
//
// Accumulation precision: each 128-deep slice is summed by the tensor
// cores into zeroed registers and then added into the f32 accumulators
// (the promotion of DeepSeek-V3's report, section 3.3.2), so the tensor
// cores' limited-precision internal accumulation never spans more than
// 128 products.
//
// Numerics vs the reference: the same exact products, summed in another
// order; expect one bf16 ulp where the f32 sums straddle a rounding
// boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128;  // output tile
constexpr int kBK = 128;             // K slice (elements = bytes)
constexpr int kStride = kBK + 16;    // shared row stride in bytes
constexpr int kThreads = 256;        // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64, kWN = 32;    // warp tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kStage = (kBM + kBN) * kStride;  // bytes per buffer

// the f32 accumulator takes one 128-deep slice's tensor-core sum
__device__ __forceinline__ float promote(float acc, float part) {
  return acc + part;
}

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

__device__ __forceinline__ void mma_e4m3(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [r0, r0 + 128) x columns [k0, k0 + 128) of a row-major
// (R, K) fp8 matrix; what lies outside it is zero-filled.
__device__ __forceinline__ void load_slice(uint8_t* dst,
                                           const uint8_t* __restrict__ src,
                                           int R, int K, int r0, int k0) {
  constexpr int kChunks = kBK / 16;
  for (int c = threadIdx.x; c < kBM * kChunks; c += kThreads) {
    const int r = c / kChunks, kc = (c % kChunks) * 16;
    const int gr = r0 + r, gk = k0 + kc;
    const bool ok = gr < R && gk < K;
    const uint8_t* p = ok ? src + static_cast<int64_t>(gr) * K + gk : src;
    cp_async16(dst + r * kStride + kc, p, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
fp8_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt,
                  const float* __restrict__ a_scale,
                  const float* __restrict__ b_scale,
                  __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * kWM, wn = (warp % 4) * kWN;
  const int g = lane / 4, t = lane % 4;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  load_slice(smem, a, M, K, m0, 0);
  load_slice(smem + kBM * kStride, bt, N, K, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const uint8_t* as = smem + (kt % 2) * kStage;
    const uint8_t* bs = as + kBM * kStride;
    if (kt + 1 < nk) {
      uint8_t* nxt = smem + ((kt + 1) % 2) * kStage;
      load_slice(nxt, a, M, K, m0, (kt + 1) * kBK);
      load_slice(nxt + kBM * kStride, bt, N, K, n0, (kt + 1) * kBK);
    }
    cp_async_commit();
    cp_async_wait<1>();   // slice kt has landed
    __syncthreads();

    float part[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
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
        const uint8_t* p = bs + (wn + j * 8 + g) * kStride + ks + t * 4;
        bf[j][0] = lds32(p);
        bf[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_e4m3(part[i][j], af[i], bf[j]);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = promote(acc[i][j][e], part[i][j][e]);
    __syncthreads();   // this buffer is free for slice kt + 2
  }

  const float sa = *a_scale, sb = *b_scale;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + i * 16 + g + (e / 2) * 8;
        const int c = n0 + wn + j * 8 + t * 2 + (e % 2);
        if (r < M && c < N)
          out[static_cast<int64_t>(r) * N + c] =
              __float2bfloat16_rn(acc[i][j][e] * sa * sb);
      }
}

}  // namespace

// a (M, K) e4m3, bt (N, K) e4m3 (B transposed), a_scale / b_scale one
// f32 each on the device, out (M, N) bf16.  K must be a multiple of 16
// and the operands 16-byte aligned.  Returns cudaGetLastError().
extern "C" int fp8_matmul_launch(const void* a, const void* bt,
                                 const void* a_scale, const void* b_scale,
                                 void* out, int M, int N, int K,
                                 void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * kStage;
  const cudaError_t err = cudaFuncSetAttribute(
      fp8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  fp8_matmul_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt),
      static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
