// int8 GEMMs with a per-row and a per-column scale, K4 and K5:
//   out = bf16((f32(A·B) · xs[m]) · ws[n]),  A·B summed exactly in int32.
//
// Replaces: distributed_training_sandbox_tpu/ops/quant.py,
//   K4 int8_matmul_pallas (_qmm_kernel): A arrives quantised, (M, K)
//      int8 with its (M, 1) f32 row scales.  Every projection and the
//      unembedding of int8 serving (prequantized_dense), and the dX / dW
//      products of matmul_precision="int8_pallas_bwd";
//   K5 int8_matmul_pallas_fused (_fused_qmm_kernel): A arrives as the
//      bf16 activation; each row is quantised in the kernel over its
//      full K (scale = absmax · f32(1/127), code = rint(x / scale)
//      clipped to ±127), and the codes never leave shared memory.  The
//      forward of every projection under "int8_pallas(_bwd)".
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
// What bounds it on an H100: operations at the training shapes (M =
// 8192: ~650-1300 int8 operations per byte moved, above the card's ~590
// at 1979 TOPS over 3.35 TB/s); bytes at decode (M = 8: the weight is
// read once for 16 operations per byte).  This first version uses the
// int8 tensor cores through mma.sync (m16n8k32, s8), which reach only
// part of what wgmma can; wgmma with a TMA-fed ring is the next step.
//
// Design (K6's, csrc/fp8_matmul.cu): one block of 8 warps per 128 x 128
// output tile, each warp a 64 x 32 sub-tile (4 x 4 mma tiles), K in
// slices of 128, double-buffered in shared memory.  Rows are padded to
// 144 bytes.  A is row-major over K.  B comes in either layout: K-major
// (N, K), read with 32-bit fragment loads (the dX product, whose weight
// (K, N) quantised along N already is that layout), or the reference's
// (K, N), whose fragments gather four bytes of a column (Hopper's 8-bit
// MMAs take B K-major and ldmatrix has no 8-bit transpose); no
// transposed copy of a weight is made.  K5 runs a prologue kernel for
// the row scales (the absmax needs the whole row before the first code:
// a 128-row block of 11 008 bf16 columns does not fit in shared memory),
// then loads each bf16 tile into registers one slice ahead, quantises
// it and stores the codes to shared memory.
//
// Ragged edges: rows past M and N and columns past K are zero-filled
// (code 0), so only K % 16 == 0 (and N % 16 == 0 for a (K, N) B) is
// needed for the 16-byte loads.

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
constexpr int kTile = 128 * kStride;    // bytes of one A or B tile
constexpr int kStage = 2 * kTile;       // A and B of one slice
constexpr int kAChunks = kBM * kBK / 8 / kThreads;  // bf16 x 8 per thread

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
    cp_async16(dst + r * kStride + kc, p, ok ? 16 : 0);
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
    cp_async16(dst + r * kStride + nc, p, ok ? 16 : 0);
  }
}

// The absmax of row gr over the K slice at k0.  The sound kernel does
// not use it: it quantises every slice of a row with the full row's
// scale (the mutation check swaps one for the other).
__device__ float slice_amax(const __nv_bfloat16* __restrict__ x, int gr,
                            int k0, int K) {
  float m = 0.f;
  for (int k = k0; k < min(K, k0 + kBK); ++k)
    m = fmaxf(m, fabsf(__bfloat162float(x[static_cast<int64_t>(gr) * K + k])));
  return m;
}

// The scale that quantises row gr's elements of the slice at k0.
__device__ __forceinline__ float code_scale(const float* __restrict__ xs,
                                            const __nv_bfloat16* __restrict__ x,
                                            int gr, int k0, int K) {
  (void)x, (void)k0, (void)K;
  return xs[gr];   // the scale of the full row
}

// One int8 code: rint(v / s) clipped to +-127 (IEEE division, half to
// even), the reference's jnp.clip(jnp.round(x / scale), -127, 127).
__device__ __forceinline__ uint32_t code(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(max(-127, min(127, q)))));
}

// K5: this thread's 8 chunks of 8 bf16 of the A slice at k0, into
// registers (zeros outside the matrix).
__device__ __forceinline__ void load_x(uint4 (&ra)[kAChunks],
                                       const __nv_bfloat16* __restrict__ x,
                                       int M, int K, int m0, int k0) {
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int gr = m0 + c / 16, gk = k0 + (c % 16) * 8;
    ra[i] = (gr < M && gk < K)
                ? *reinterpret_cast<const uint4*>(
                      x + static_cast<int64_t>(gr) * K + gk)
                : make_uint4(0u, 0u, 0u, 0u);
  }
}

// K5: quantise the registers of load_x with each row's scale and store
// the codes as the A tile.
__device__ __forceinline__ void store_codes(uint8_t* dst,
                                            const uint4 (&ra)[kAChunks],
                                            const float* __restrict__ xs,
                                            const __nv_bfloat16* __restrict__ x,
                                            int M, int K, int m0, int k0) {
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / 16, kc = (c % 16) * 8, gr = m0 + r;
    const float s = gr < M ? code_scale(xs, x, gr, k0, K) : 1.f;
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&ra[i]);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j / 4] |= code(__bfloat162float(e[j]), s) << (8 * (j % 4));
    *reinterpret_cast<uint2*>(dst + r * kStride + kc) = make_uint2(w[0], w[1]);
  }
}

// K5's prologue: one warp per row, s = absmax · f32(1/127) (1 for an
// all-zero row).
__global__ void __launch_bounds__(kThreads)
row_scales(const __nv_bfloat16* __restrict__ x, float* __restrict__ xs,
           int M, int K) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const __nv_bfloat16* p = x + static_cast<int64_t>(row) * K;
  float amax = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + k);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(e[j])));
  }
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0)
    xs[row] = amax > 0.f ? amax * (1.0f / 127.0f) : 1.0f;
}

// kFused: A is the bf16 activation (K5), else int8 codes (K4).
// kBKMajor: B is (N, K), else (K, N).
template <bool kFused, bool kBKMajor>
__global__ void __launch_bounds__(kThreads)
int8_mm(const void* __restrict__ a_, const uint8_t* __restrict__ b,
        const float* __restrict__ xs, const float* __restrict__ ws,
        __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* a8 = static_cast<const uint8_t*>(a_);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a_);
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

  uint4 ra[kAChunks];
  const int nk = (K + kBK - 1) / kBK;
  if constexpr (kFused) {
    load_x(ra, x, M, K, m0, 0);
    store_codes(smem, ra, xs, x, M, K, m0, 0);
  } else {
    load_rows(smem, a8, M, K, m0, 0);
  }
  load_b(smem + kTile, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const uint8_t* as = smem + (kt % 2) * kStage;
    const uint8_t* bs = as + kTile;
    uint8_t* nxt = smem + ((kt + 1) % 2) * kStage;
    const bool more = kt + 1 < nk;
    if (more) {
      if constexpr (!kFused) load_rows(nxt, a8, M, K, m0, (kt + 1) * kBK);
      load_b(nxt + kTile, (kt + 1) * kBK);
    }
    cp_async_commit();
    if constexpr (kFused) {
      // the next slice's bf16 loads are in flight during this slice's MMAs
      if (more) load_x(ra, x, M, K, m0, (kt + 1) * kBK);
    }
    cp_async_wait<1>();   // slice kt has landed
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
    if constexpr (kFused) {
      // the other buffer was last read before the previous barrier
      if (more) store_codes(nxt, ra, xs, x, M, K, m0, (kt + 1) * kBK);
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

template <bool kFused, bool kBKMajor>
int launch_mm(const void* a, const void* b, const float* xs, const float* ws,
              void* out, int M, int N, int K, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      int8_mm<kFused, kBKMajor>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * kStage);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_mm<kFused, kBKMajor><<<grid, kThreads, 2 * kStage, stream>>>(
      a, static_cast<const uint8_t*>(b), xs, ws,
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int M, int N, int K, bool b_kmajor) {
  return M < 1 || N < 1 || K < 16 || K % 16 || (!b_kmajor && N % 16);
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
  return b_kmajor ? launch_mm<false, true>(a, b, fx, fw, out, M, N, K, s)
                  : launch_mm<false, false>(a, b, fx, fw, out, M, N, K, s);
}

// K5.  x (M, K) bf16; b (K, N) int8; xs (M) f32 scratch that receives
// the row scales; ws (N) f32; out (M, N) bf16.  Two launches: the row
// scales, then the GEMM.  Returns cudaGetLastError().
extern "C" int int8_matmul_fused_launch(const void* x, const void* b,
                                        void* xs, const void* ws, void* out,
                                        int M, int N, int K, void* stream) {
  if (bad_shape(M, N, K, false))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_scales<<<(M + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(xs), M, K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_mm<true, false>(x, b, static_cast<const float*>(xs),
                                static_cast<const float*>(ws), out, M, N, K,
                                s);
}
