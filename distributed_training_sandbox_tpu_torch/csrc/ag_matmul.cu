// One ring chunk's product of the FSDP all-gather matmul:
// out (M, N) = bf16(A (M, Kc) · B (Kc, N)), f32 accumulation.
//
// Replaces: distributed_training_sandbox_tpu/ops/collectives.py,
// all_gather_matmul_pallas (_agmm_tile_call / _agmm_chunk_kernel), the
// per-chunk tile matmul of every projection under FSDP's
// overlap="ring_fused_pallas".
//
// Computes what the reference computes: each output element's sum over
// the chunk's whole contraction dim Kc runs in one f32 accumulator and
// is rounded once to bf16 (round to nearest even) in the epilogue, as
// the Pallas kernel's one dot per block with full-K operand blocks does.
// No split-K and no atomics: each output belongs to one thread, whose
// sum runs in a fixed order, so two launches are bit for bit equal.
//
// What bounds it on an H100: operations.  At the training path's shapes
// (M = 8192 rows, Kc x N from 512 x 2048 to 11008 x 2048) a product
// does 2·M·N·Kc flops over (M·Kc + Kc·N + M·N) · 2 bytes, 400-1400
// flops a byte, above the card's ~295 bf16 flops per byte of HBM
// bandwidth.  This first version runs the bf16 tensor cores through
// mma.sync (m16n8k16), which reaches only part of the 989 TFLOP/s that
// wgmma with a TMA-fed ring of tiles can (ROADMAP.md).
//
// Design: one block of 8 warps per 128 x 128 output tile; each warp owns
// a 64 x 32 sub-tile (4 x 4 mma tiles, 64 f32 accumulators a thread).
// The block walks Kc in 32-deep tiles through a 3-stage cp.async ring in
// shared memory (16-byte copies).  A is read in place with its own row
// stride (lda), so the strided chunk a[..., s:s+Kc] of the activation
// needs no copy; B is the (Kc, N) shard in the reference's layout, read
// as [k][n] tiles and turned into column fragments by ldmatrix.trans.
// Rows past M, columns past N and k past Kc are zero-filled, so Kc = 2752
// (86 tiles of 32) or any multiple of 8 needs no padding.  Shared rows
// are padded by 8 elements, which keeps the fragment loads free of bank
// conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128;  // output tile
constexpr int kBK = 32;              // K tile
constexpr int kStages = 3;           // cp.async ring depth
constexpr int kThreads = 256;        // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64, kWN = 32;    // warp tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kALd = kBK + 8;        // A tile [kBM][kALd]
constexpr int kBLd = kBN + 8;        // B tile [kBK][kBLd]
constexpr int kStage = kBM * kALd + kBK * kBLd;   // elements per stage

// the f32 accumulator keeps each K tile's tensor-core sum as it is
__device__ __forceinline__ float acc_keep(float x) { return x; }

// the K tiles that enter the sum: every one of the chunk's
__device__ __forceinline__ bool tile_in_sum(int kt, int nk) { return kt < nk; }

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

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x8 b16 matrices, transposed: the B fragments of two n8 tiles
// from a row-major [k][n] tile
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage K tile kt: A rows [m0, m0 + kBM) x k [k0, k0 + kBK) and B rows
// k [k0, k0 + kBK) x columns [n0, n0 + kBN); what lies outside the
// operands is zero-filled.
__device__ __forceinline__ void load_tile(bf16* st, const bf16* __restrict__ a,
                                          const bf16* __restrict__ b, int M,
                                          int N, int K, int lda, int m0,
                                          int n0, int kt) {
  const int k0 = kt * kBK;
  bf16* as = st;
  bf16* bs = st + kBM * kALd;
  constexpr int kACh = kBK / 8;   // 16-byte chunks per A row
  for (int c = threadIdx.x; c < kBM * kACh; c += kThreads) {
    const int r = c / kACh, kc = (c % kACh) * 8;
    const int gr = m0 + r, gk = k0 + kc;
    const bool ok = gr < M && gk < K;
    const bf16* p = ok ? a + static_cast<int64_t>(gr) * lda + gk : a;
    cp_async16(as + r * kALd + kc, p, ok ? 16 : 0);
  }
  constexpr int kBCh = kBN / 8;   // 16-byte chunks per B row
  for (int c = threadIdx.x; c < kBK * kBCh; c += kThreads) {
    const int r = c / kBCh, nc = (c % kBCh) * 8;
    const int gk = k0 + r, gn = n0 + nc;
    const bool ok = gk < K && gn < N;
    const bf16* p = ok ? b + static_cast<int64_t>(gk) * N + gn : b;
    cp_async16(bs + r * kBLd + nc, p, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
ag_matmul_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                 bf16* __restrict__ out, int M, int N, int K, int lda) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
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
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_tile(smem + s * kStage, a, b, M, N, K, lda, m0, n0, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();   // tile kt has landed
    __syncthreads();                // and tile kt - 1's stage is free
    const int nt = kt + kStages - 1;
    if (nt < nk)
      load_tile(smem + (nt % kStages) * kStage, a, b, M, N, K, lda, m0, n0,
                nt);
    cp_async_commit();
    if (!tile_in_sum(kt, nk)) continue;

    const bf16* as = smem + (kt % kStages) * kStage;
    const bf16* bs = as + kBM * kALd;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[kMT][4], bfr[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const bf16* p = as + (wm + i * 16 + g) * kALd + ks + t * 2;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * kALd);
        af[i][2] = lds32(p + 8);
        af[i][3] = lds32(p + 8 * kALd + 8);
      }
      const int kr = ks + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t r[4];
        ldsm_x4_trans(r, bs + kr * kBLd + wn + jp * 16 + (lane >> 4) * 8);
        bfr[2 * jp][0] = r[0];
        bfr[2 * jp][1] = r[1];
        bfr[2 * jp + 1][0] = r[2];
        bfr[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = acc_keep(acc[i][j][e]);
  }
  cp_async_wait<0>();

  // epilogue: one rounding to bf16, two neighbouring columns a store
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + i * 16 + g + h * 8;
        const int c = n0 + wn + j * 8 + t * 2;
        if (r < M && c < N)
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<int64_t>(r) * N + c) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

}  // namespace

// a (M, K) bf16 with row stride lda (elements), b (K, N) bf16 row-major,
// out (M, N) bf16 row-major.  K, N and lda must be multiples of 8 and
// the operands 16-byte aligned.  Returns cudaGetLastError().
extern "C" int ag_matmul_launch(const void* a, const void* b, void* out,
                                int M, int N, int K, int lda, void* stream) {
  if (M < 1 || N < 8 || K < 8 || K % 8 || N % 8 || lda % 8 || lda < K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kStages * kStage * static_cast<int>(sizeof(bf16));
  const cudaError_t err = cudaFuncSetAttribute(
      ag_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  ag_matmul_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), M, N, K, lda);
  return static_cast<int>(cudaGetLastError());
}
