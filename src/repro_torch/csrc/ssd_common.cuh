// What the SSD scan's forward (ssd_scan.cu, #5) and its backward
// (ssd_scan_bwd.cu, #5b) share: fp32 operands as T bf16 terms for the tensor
// cores, a product over the term pairs i + j < T, and a chunk's prefix sum of
// dt*A in one fixed order.  kernels/_build.py hashes it with both sources.

#pragma once

#include "sm90.cuh"  // bf16, mma_bf16

namespace {

// (x, y) as T bf16 pairs: the first rounds (x, y), each next one what
// the earlier ones leave (a rounding's residual is exact in fp32)
template <int T>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t (&t)[T]) {
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    t[k] = *reinterpret_cast<const uint32_t*>(&h);
    x -= __low2float(h);
    y -= __high2float(h);
  }
}

// four fp32 values as T planes of four bf16 at element offset off (a
// multiple of 4) of each plane
template <int T>
__device__ __forceinline__ void put4(bf16* planes, int plane, int off, float4 v) {
  uint32_t a[T], b[T];
  split_pair<T>(v.x, v.y, a);
  split_pair<T>(v.z, v.w, b);
#pragma unroll
  for (int k = 0; k < T; ++k)
    *reinterpret_cast<uint2*>(planes + k * plane + off) = make_uint2(a[k], b[k]);
}

// d += sum over the term pairs i + j < T of a_i b_j
template <int T>
__device__ __forceinline__ void mma_terms(float (&d)[4], const uint32_t (&a)[T][4],
                                          const uint32_t (&b0)[T], const uint32_t (&b1)[T]) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j)
      if (i + j < T) mma_bf16(d, a[i], b0[j], b1[j]);
}

// acc[j] += a b_j for the tiles j < nj (at most J), over the same term
// pairs; consecutive products go to different tiles, so that none waits on
// the one before it
template <int T, int J>
__device__ __forceinline__ void mma_terms(float (&d)[J][4], const uint32_t (&a)[T][4],
                                          const uint32_t (&b)[J][2][T], int nj) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int k = 0; k < T; ++k)
      if (i + k < T)
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (j < nj) mma_bf16(d[j], a[i], b[j][0][k], b[j][1][k]);
}

// A warp's prefix sum of a chunk's dt*A, from its lane's share d of dt
// (lane l: tokens 2l and 2l + 1): acum (inclusive) at those tokens, 0 from
// token c on
__device__ __forceinline__ float2 prefix_pair(float2 d, float a_h, int c) {
  const int lane = threadIdx.x % 32;
  const int t0 = 2 * lane, t1 = 2 * lane + 1;
  const float v0 = d.x * a_h;
  const float v1 = v0 + d.y * a_h;
  float incl = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  return make_float2(t0 < c ? excl + v0 : 0.f, t1 < c ? incl : 0.f);
}

// warp 0, from its share d of dt: acum[t] (inclusive prefix sum of dt*A) and
// dts[t] for t < c, 0 for c <= t < 64
__device__ __forceinline__ void chunk_prefix(float2 d, float a_h, int c, float* acum,
                                             float* dts) {
  const int t0 = 2 * threadIdx.x;
  const float2 ac = prefix_pair(d, a_h, c);
  dts[t0] = d.x;
  dts[t0 + 1] = d.y;
  acum[t0] = ac.x;
  acum[t0 + 1] = ac.y;
}

}  // namespace
