// Helpers shared by the paged-attention kernels (paged_decode.cu,
// flash_prefill.cu): element loads to f32, rounding to the pool's type,
// warp-wide reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace dts {

// dtype codes of the C interface; the Python wrappers pass the same
enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T (round to nearest even) and back: the reference's
// `probs.astype(probs_dtype)` before the PV contraction
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of T at src (16-byte aligned) unpacked to floats
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
  __device__ static void load(const T* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < n; ++j) dst[j] = to_f32(e[j]);
  }
};

// two neighbouring elements of T (4- or 8-byte aligned) as floats
__device__ __forceinline__ void pair_f32(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void pair_f32(const __nv_bfloat16* p, float& a,
                                         float& b) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Offset of row (page pg, slot off, kv head g) in an
// (n_pages, page, n_kv, hd) pool.
__device__ __forceinline__ int64_t pool_row(int pg, int off, int g, int page,
                                            int nkv, int hd) {
  return ((static_cast<int64_t>(pg) * page + off) * nkv + g) * hd;
}

// Stage rows [t0, t0 + 32) of one kv head into shared memory as f32
// (row stride `stride` floats), 16 bytes a load; rows past `last` are
// zero.  `pg_of` gives the page of tile row t.  Run by `nthreads`
// threads numbered `tid`.
template <typename T, typename PageOf>
__device__ __forceinline__ void stage_tile(const T* __restrict__ pool,
                                           float* dst, int stride, int t0,
                                           int last, int g, int page, int nkv,
                                           int hd, int tid, int nthreads,
                                           PageOf pg_of) {
  const int vpr = hd / Vec<T>::n;
  for (int e = tid; e < 32 * vpr; e += nthreads) {
    const int t = e / vpr, c = e % vpr;
    const int pg = pg_of(t);   // every thread calls it (it may shuffle)
    float* d = dst + t * stride + c * Vec<T>::n;
    if (t0 + t <= last) {
      Vec<T>::load(pool + pool_row(pg, (t0 + t) % page, g, page, nkv, hd) +
                       c * Vec<T>::n,
                   d);
    } else {
#pragma unroll
      for (int j = 0; j < Vec<T>::n; ++j) d[j] = 0.f;
    }
  }
}

}  // namespace dts
