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
// bandwidth.  Only wgmma reaches the bf16 tensor cores' 989 TFLOP/s, and
// only a ring of tiles in flight keeps them fed.
//
// Design: a persistent grid of one block an SM (384 threads, three
// warpgroups) walks the 128 x 256 output tiles in a grouped order
// (kGroupM row tiles a column sweep, so that the blocks of a wave share
// A's rows and B's columns in L2).
// - Warpgroup 0 is the producer.  It gives up registers (setmaxnreg 40)
//   and one thread keeps a 4-stage ring of TMA loads in flight across
//   tiles: a stage is A's 128 rows x 64 of K (16 KB, one 128-byte
//   swizzled column block) and B's 64 rows of K x 256 columns (32 KB,
//   four column blocks of 64 rows x 128 bytes), completing on a "full"
//   mbarrier.  A is read in place as a 2-D box of the strided chunk
//   a[..., s:s+Kc] (tensor map base the chunk's pointer, row stride
//   lda · 2 bytes), B in the shard's own (Kc, N) layout: no copy of
//   either.  TMA zero-fills rows past M and k past Kc; B's boxes wholly
//   past N are not loaded (their columns are never stored).
// - Warpgroups 1 and 2 are the consumers (setmaxnreg 232), 64 rows of
//   the tile each: per stage four wgmma m64n256k16 bf16 -> f32 from
//   shared memory, A K-major and B MN-major (the descriptor's transpose
//   bit).  One wgmma group stays in flight across stages: a stage goes
//   back to the producer on its "empty" mbarrier once the next stage's
//   group is issued and its own has retired (wgmma_wait<1>).
// - The epilogue rounds each f32 sum once to bf16 and stores pairs from
//   registers, guarded against M and N; meanwhile the producer is
//   already loading the next tile's stages.
// Kc, N and lda must be multiples of 8 and the operands 16-byte aligned
// (the strides and bases TMA takes); Kc = 2752 (43 stages of 64) needs
// no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 256, kBK = 64;   // tile; K in elements
constexpr int kStages = 4;
constexpr int kThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kGroupM = 8;      // row tiles a column sweep of the walk
constexpr int kABytes = kBM * kBK * 2;          // one column block
constexpr int kBBlock = kBK * 128;              // 64 rows x 128 bytes
constexpr int kBBytes = (kBN / 64) * kBBlock;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1008;

// Rounds the f32 accumulators to bf16 after every k-block?  Never: each
// output's sum stays f32 over the whole chunk.
__device__ __forceinline__ bool acc_rounded() { return false; }

// the K tiles that enter the sum: every one of the chunk's
__device__ __forceinline__ bool tile_in_sum(int kt, int nk) { return kt < nk; }

// Output tile t of the grouped walk: (first row, first column)
__device__ __forceinline__ void tile_origin(int t, int mt, int nt, int& m0,
                                            int& n0) {
  const int per_group = kGroupM * nt;
  const int first = (t / per_group) * kGroupM;
  const int rows = min(mt - first, kGroupM);
  const int r = t % per_group;
  m0 = (first + r % rows) * kBM;
  n0 = (r / rows) * kBN;
}

__global__ void __launch_bounds__(kThreads, 1)
ag_matmul_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = hop::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  auto a_tile = [&](int s) { return smem + s * kStageBytes; };
  auto b_tile = [&](int s) { return a_tile(s) + kABytes; };
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int mt = (M + kBM - 1) / kBM, nt = (N + kBN - 1) / kBN;
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;   // stages issued, over every tile of this block
      for (int t = blockIdx.x; t < mt * nt; t += gridDim.x) {
        int m0, n0;
        tile_origin(t, mt, nt, m0, n0);
        const int nb = min(kBN, N - n0 + 63) / 64;   // B boxes inside N
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % kStages;
          hop::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          hop::mbar_expect_tx(&full[s], kABytes + nb * kBBlock);
          hop::tma_load_2d(a_tile(s), &ta, &full[s], kb * kBK, m0);
          for (int cb = 0; cb < nb; ++cb)
            hop::tma_load_2d(b_tile(s) + cb * kBBlock, &tb, &full[s],
                             n0 + 64 * cb, kb * kBK);
        }
      }
    }
  } else {   // consumers: rows cw * 64 .. + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int row = cw * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
    float acc[128];
    int it = 0;   // stages consumed, over every tile of this block
    for (int t = blockIdx.x; t < mt * nt; t += gridDim.x) {
      int m0, n0;
      tile_origin(t, mt, nt, m0, n0);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % kStages;
        hop::mbar_wait(&full[s], (it / kStages) & 1);
        hop::fence_regs(acc);
        hop::wgmma_fence();
        if (tile_in_sum(kb, nk)) {
#pragma unroll
          for (int k = 0; k < 4; ++k)   // k16 steps of the stage
            hop::wgmma_m64n256k16_bf16_ss_tb(
                acc, hop::sw128_desc(a_tile(s) + cw * 64 * 128 + k * 32, 16,
                                     1024),
                hop::sw128_desc(b_tile(s) + k * 16 * 128, kBBlock, 1024));
        }
        hop::wgmma_commit();
        hop::fence_regs(acc);
        hop::wgmma_wait<1>();   // the previous stage's group has retired
        if (kb > 0 && lane == 0)
          hop::mbar_arrive(&empty[(it - 1) % kStages]);
        if (acc_rounded()) {
          hop::wgmma_wait<0>();
          hop::fence_regs(acc);
#pragma unroll
          for (int i = 0; i < 128; ++i)
            acc[i] = __bfloat162float(__float2bfloat16_rn(acc[i]));
        }
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (lane == 0) hop::mbar_arrive(&empty[(it - 1) % kStages]);

      // one rounding to bf16, two neighbouring columns a store
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + row + 8 * h;
        if (r >= M) continue;
        bf16* orow = out + static_cast<int64_t>(r) * N;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int c = n0 + 8 * j + 2 * (lane % 4);
          if (c < N)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                      acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace

// a (M, K) bf16 with row stride lda (elements), b (K, N) bf16 row-major,
// out (M, N) bf16 row-major.  K, N and lda must be multiples of 8 and
// the operands 16-byte aligned.  Returns cudaGetLastError()
// (cudaErrorInvalidValue where the tensor maps cannot be made).
extern "C" int ag_matmul_launch(const void* a, const void* b, void* out,
                                int M, int N, int K, int lda, void* stream) {
  if (M < 1 || N < 8 || K < 8 || K % 8 || N % 8 || lda % 8 || lda < K)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  if (!hop::sw128_map(&ta, a, M, K, static_cast<int64_t>(lda) * 2, 2, kBM) ||
      !hop::sw128_map(&tb, b, K, N, static_cast<int64_t>(N) * 2, 2, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      ag_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  ag_matmul_kernel<<<std::min(tiles, sm_count()), kThreads, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<bf16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
