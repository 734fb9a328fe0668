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
// card's ~590 fp8 operations per byte of HBM bandwidth.  Only wgmma
// reaches the tensor cores' peak, and only a ring of tiles in flight
// keeps them fed.
//
// Accumulation precision decides the design.  The fp8 wgmma
// (m64n128k32 e4m3·e4m3→f32) sums the 32 products of one instruction in
// a reduced internal precision: on an H100 a build of this kernel on it
// missed the kernel's tolerance (ops/quant.py TOLERANCE, set for f32
// sums) by a gate ratio of 40-105 at the training shapes, with every
// 128-deep k-block promoted into f32 registers, and promoting every k32
// step on its own did not close the gap (PERF.md).  The bf16 wgmma sums
// in f32, and every e4m3 value is exact in bf16, so the kernel runs the
// bf16 wgmma (989 TFLOP/s, half the fp8 peak) on the same exact
// products:
// 1. A prologue kernel writes both operands' codes as bf16 into scratch
//    that the wrapper allocates ((M, K) and (N, K), exact; 3 bytes more
//    an element through device memory).  Converting inside the GEMM,
//    per tile, was slower: every block of a row of tiles converts the
//    same B again, and the conversion's shared-memory traffic did not
//    overlap the products.
// 2. The GEMM (K5's skeleton, csrc/int8_matmul.cu): one block per 128 x
//    128 output tile, three warpgroups.  Warp 0 of the first is the
//    producer: one thread keeps a 3-stage ring of TMA loads in flight (A
//    and B 128 rows x 128 of K a stage, each as two 128-byte swizzled
//    column blocks, completion on a "full" mbarrier each stage).  The
//    two consumer warpgroups each own 64 rows of the tile: per stage
//    eight wgmma m64n128k16 bf16 steps from shared memory, both
//    operands K-major, then the stage goes back to the producer on an
//    "empty" mbarrier.
// B arrives K-major, (N, K): the training path quantises the weight
// straight into that layout (ops/quant.py quantize_fp8_kmajor), so no
// transposed copy is made per launch.  TMA zero-fills past M, N and K
// (codes 0 add nothing), so K % 16 == 0 (the row strides TMA takes) is
// all it needs; stores are guarded.
//
// Each 128-deep k-block is summed into its own registers (the first
// wgmma of the block overwrites them) and then added into the f32
// accumulators in promote() (the promotion of DeepSeek-V3's report,
// section 3.3.2), so no tensor-core accumulation spans more than 128
// products.
//
// Numerics vs the reference: the same exact products, summed in another
// order; expect one bf16 ulp where the f32 sums straddle a rounding
// boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 128;   // tile; K in elements
constexpr int kThreads = 384;   // producer warpgroup + 2 consumers

// A ring stage holds A and B, each kBM rows x kBK bf16 values as two
// 128-byte column blocks.
constexpr int kOpBytes = kBM * kBK * 2;
constexpr int kStageBytes = 2 * kOpBytes;
constexpr int kStages = 3;
constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1008;

// the f32 accumulator takes one 128-deep k-block's tensor-core sum
__device__ __forceinline__ float promote(float acc, float part) {
  return acc + part;
}

// Four e4m3 codes (the bytes of w, low first) as four bf16 values, two
// to a word, exactly: lo holds codes 0 and 1, hi codes 2 and 3.  A
// code's sign, exponent and mantissa bits placed in bf16's fields read
// as 2^-120 times its value (a subnormal code lands on the bf16
// subnormal with its significand), and one multiply by 2^120, exact,
// rebiases them.
__device__ __forceinline__ void e4m3x4_to_bf16(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t t0 = __byte_perm(w, 0u, 0x1404);   // codes 0, 1 high
  const uint32_t t1 = __byte_perm(w, 0u, 0x3424);   // codes 2, 3 high
  const uint32_t r0 = (t0 & 0x80008000u) | ((t0 >> 4) & 0x07F007F0u);
  const uint32_t r1 = (t1 & 0x80008000u) | ((t1 >> 4) & 0x07F007F0u);
  constexpr uint32_t kTwo120 = 0x7B807B80u;   // bf16x2 (2^120, 2^120)
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(lo) : "r"(r0), "r"(kTwo120));
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(hi) : "r"(r1), "r"(kTwo120));
}

// The prologue: n16 groups of 16 e4m3 codes at src as bf16 at dst
// (both contiguous, 16-byte aligned), grid-stride.
__global__ void __launch_bounds__(256)
e4m3_to_bf16(const uint4* __restrict__ src, uint4* __restrict__ dst,
             int64_t n16) {
  for (int64_t i = blockIdx.x * 256ll + threadIdx.x; i < n16;
       i += static_cast<int64_t>(gridDim.x) * 256) {
    const uint4 in = src[i];
    uint32_t o[8];
    e4m3x4_to_bf16(in.x, o[0], o[1]);
    e4m3x4_to_bf16(in.y, o[2], o[3]);
    e4m3x4_to_bf16(in.z, o[4], o[5]);
    e4m3x4_to_bf16(in.w, o[6], o[7]);
    dst[2 * i] = make_uint4(o[0], o[1], o[2], o[3]);
    dst[2 * i + 1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// The GEMM on the prologue's bf16 codes
__global__ void __launch_bounds__(kThreads, 1)
fp8_gemm(const __grid_constant__ CUtensorMap ta,
         const __grid_constant__ CUtensorMap tb,
         const float* __restrict__ a_scale, const float* __restrict__ b_scale,
         __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  constexpr int kBlk = kBM * 128;   // one 128-byte column block
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = hop::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  auto a_tile = [&](int s) { return smem + s * kStageBytes; };
  auto b_tile = [&](int s) { return a_tile(s) + kOpBytes; };
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;

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
#pragma unroll
        for (int cb = 0; cb < 2; ++cb) {   // 128-byte column blocks
          const int k0 = kb * kBK + cb * 64;
          hop::tma_load_2d(a_tile(s) + cb * kBlk, &ta, &full[s], k0, m0);
          hop::tma_load_2d(b_tile(s) + cb * kBlk, &tb, &full[s], k0, n0);
        }
      }
    }
    return;
  }

  const int cw = wg - 1;   // consumer: rows cw * 64 .. + 63 of the tile
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % kStages;
    hop::mbar_wait(&full[s], (kb / kStages) & 1);
    hop::fence_regs(part);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 8; ++k) {   // k16 steps, 32 bytes each
      const int at = (k / 4) * kBlk + (k % 4) * 32;
      const uint64_t da =
          hop::sw128_desc(a_tile(s) + at + cw * 64 * 128, 16, 1024);
      const uint64_t db = hop::sw128_desc(b_tile(s) + at, 16, 1024);
      hop::wgmma_m64n128k16_bf16_ss(part, da, db, k > 0);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(part);
    if (lane == 0) hop::mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = promote(acc[i], part[i]);
  }

  const float sa = *a_scale, sb = *b_scale;
  const int r0 = m0 + cw * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= M) continue;
    __nv_bfloat16* orow = out + static_cast<int64_t>(r) * N;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      if (c >= N) continue;
      const __nv_bfloat16 v0 =
          __float2bfloat16_rn(acc[4 * j + 2 * h] * sa * sb);
      if (c + 1 < N) {
        const __nv_bfloat16 v1 =
            __float2bfloat16_rn(acc[4 * j + 2 * h + 1] * sa * sb);
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

int gemm(const void* a, const void* bt, const void* a_scale,
         const void* b_scale, void* out, int M, int N, int K,
         cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!hop::sw128_map(&ta, a, M, K, static_cast<int64_t>(K) * 2, 2, kBM) ||
      !hop::sw128_map(&tb, bt, N, K, static_cast<int64_t>(K) * 2, 2, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      fp8_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  fp8_gemm<<<grid, kThreads, kSmem, stream>>>(
      ta, tb, static_cast<const float*>(a_scale),
      static_cast<const float*>(b_scale), static_cast<__nv_bfloat16*>(out),
      M, N, K);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int M, int N, int K) {
  return M < 1 || N < 1 || K < 16 || K % 16;
}

}  // namespace

// a (M, K) e4m3, bt (N, K) e4m3 (B K-major), a_scale / b_scale one f32
// each on the device; a16 (M, K) and b16 (N, K) bf16 scratch that
// receives the codes as bf16; out (M, N) bf16.  All contiguous and
// 16-byte aligned, K a multiple of 16.  Three launches: the prologue for
// A and for B, then the GEMM.  Returns cudaGetLastError()
// (cudaErrorInvalidValue where the tensor maps cannot be made).
extern "C" int fp8_matmul_launch(const void* a, const void* bt,
                                 const void* a_scale, const void* b_scale,
                                 void* a16, void* b16, void* out, int M,
                                 int N, int K, void* stream) {
  if (bad_shape(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t na = static_cast<int64_t>(M) * K / 16;
  const int64_t nb = static_cast<int64_t>(N) * K / 16;
  e4m3_to_bf16<<<1056, 256, 0, s>>>(static_cast<const uint4*>(a),
                                    static_cast<uint4*>(a16), na);
  e4m3_to_bf16<<<1056, 256, 0, s>>>(static_cast<const uint4*>(bt),
                                    static_cast<uint4*>(b16), nb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return gemm(a16, b16, a_scale, b_scale, out, M, N, K, s);
}
