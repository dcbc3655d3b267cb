// Flash-attention forward for Hopper (sm_90a), fp32 inputs, on the CUDA
// cores; plain C interface for ctypes.  bf16 inputs run on the tensor cores
// in flash_fwd_tc.cu: each input type has exactly one kernel.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd
//   (Pallas body _fwd_kernel, with _block_visible / _mask_block) for fp32
//   inputs (the training path and the fp32 dequantized pool views).
//
// What it computes: o = softmax(scale * q k^T + mask) v and the row
// log-sum-exp, for q [B, Sq, H, D] and k, v [B, Skv, Hkv, D] (GQA: query
// head h reads kv head h / (H / Hkv)).  The mask is the int32 band
// (q_off, kv_off, lo, hi) with static strides -- (i, j) visible iff
// lo <= (q_off + stride_q*i) - (kv_off + stride_kv*j) <= hi -- composed with
// optional per-token segment ids.  The band lives in device memory, either one
// [4] band for the whole batch or one per batch row ([B, 4]); the latter is
// how a dense-cache decode step runs every slot at its own depth in one
// launch.  Softmax arithmetic is fp32; o is written in fp32 and lse
// [B, H, Sq] in fp32 (NEG_INF for an empty row, whose o is exactly 0).
//
// What bounds it on an H100: at prefill lengths the work is 4*D flops per
// visible (query, key) pair against 2*D*(Sq+Skv)*H bytes of q/k/v, far above
// the card's ~295 flop/byte balance point -- it is bound by arithmetic.
// It does that arithmetic in fp32 on the CUDA cores (67 TFLOP/s peak, no
// TF32): the card-vs-CPU training gates rest on its exact fp32 products.
//
// Design:
//   * one block per (q tile of BQ=64 rows, query head, batch row); 256
//     threads as a 16 x 16 grid, thread (ty, tx) owns rows ty*4..ty*4+3;
//   * the TPU kernel's sequential kv grid axis becomes a loop over KV tiles
//     of BK=32 keys staged in shared memory, and the loop bounds are
//     solved from the band, so tiles the band hides are never loaded (the TPU
//     kernel skips them with pl.when);
//   * scores: each thread a 4 x 2 micro-tile (keys tx and tx+16), q read as
//     float4 broadcasts, K rows padded to D+1 floats (no bank conflicts);
//     the row max/sum reduce over the 16 lanes sharing ty;
//   * P goes through shared memory, and each thread accumulates o for its 4
//     rows over dims tx + 16*c;
//   * the ragged edge is masked (rows >= Sq are never written, keys >= Skv
//     never visible), so Sq need not divide the tile: a decode step calls it
//     with Sq = 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per KV tile
constexpr int NT = 256;  // threads per block (16 x 16)

__host__ __device__ __forceinline__ long long floor_div(long long a, long long b) {
  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}
__host__ __device__ __forceinline__ long long ceil_div(long long a, long long b) {
  return -floor_div(-a, b);
}

template <int D>
constexpr int smem_floats() {
  // Qs [BQ][D+4] + Ks [BK][D+1] + Vs [BK][D] + Ps [BQ][BK+1] + segk [BK]
  return BQ * (D + 4) + BK * (D + 1) + BK * D + BQ * (BK + 1) + BK;
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ band, int band_stride,
    const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
    float* __restrict__ o, float* __restrict__ lse,
    int Sq, int Skv, int H, int Hkv, float scale, int stride_q, int stride_kv) {
  constexpr int QS = D + 4;   // Qs row stride (float4-aligned, 2 rows per warp on distinct banks)
  constexpr int KS = D + 1;   // Ks row stride (conflict-free column reads)
  constexpr int PS = BK + 1;  // Ps row stride
  constexpr int DC = D / 16;  // output dims per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * D;
  int* segk = reinterpret_cast<int*>(Ps + BQ * PS);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const bool has_seg = seg_q != nullptr;

  const int* bd = band + (size_t)b * band_stride;
  const long long q_off = bd[0], kv_off = bd[1], lo = bd[2], hi = bd[3];

  // visible key interval of this block's rows, solved from the band
  const int r_last = min(r0 + BQ, Sq) - 1;
  const long long qmin = q_off + (long long)stride_q * r0;
  const long long qmax = q_off + (long long)stride_q * r_last;
  long long jlo = ceil_div(qmin - hi - kv_off, stride_kv);
  long long jhi = floor_div(qmax - lo - kv_off, stride_kv);
  if (jlo < 0) jlo = 0;
  if (jhi > Skv - 1) jhi = Skv - 1;

  // q tile -> shared, pre-scaled
  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int row = r0 + r;
    float x = 0.f;
    if (row < Sq) x = q[(((size_t)b * Sq + row) * H + h) * D + d] * scale;
    Qs[r * QS + d] = x;
  }

  long long qpos[4];
  int segq[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    row_ok[i] = row < Sq;
    qpos[i] = q_off + (long long)stride_q * row;
    segq[i] = (has_seg && row_ok[i]) ? seg_q[row] : 0;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (long long j0 = jlo; j0 <= jhi; j0 += BK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed (and Qs written)
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      const long long key = j0 + j;
      float kx = 0.f, vx = 0.f;
      if (key <= jhi) {
        const size_t off = (((size_t)b * Skv + key) * Hkv + hk) * D + d;
        kx = k[off];
        vx = v[off];
      }
      Ks[j * KS + d] = kx;
      Vs[j * D + d] = vx;
    }
    if (tid < BK) {
      const long long key = j0 + tid;
      segk[tid] = (has_seg && key <= jhi) ? seg_kv[key] : 0;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * QS + d]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* kr = &Ks[(tx + 16 * c) * KS + d];
        const float k0 = kr[0], k1 = kr[1], k2 = kr[2], k3 = kr[3];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i][c] += qv[i].x * k0 + qv[i].y * k1 + qv[i].z * k2 + qv[i].w * k3;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool vis[2];
      float mloc = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int jj = tx + 16 * c;
        const long long key = j0 + jj;
        const long long diff = qpos[i] - (kv_off + (long long)stride_kv * key);
        vis[c] = row_ok[i] && key <= jhi && diff >= lo && diff <= hi &&
                 (!has_seg || segq[i] == segk[jj]);
        if (vis[c]) mloc = fmaxf(mloc, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
      const float m_new = fmaxf(m[i], mloc);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = vis[c] ? expf(s[i][c] - m_new) : 0.f;
        psum += p;
        Ps[(ty * 4 + i) * PS + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    const int row = r0 + ty * 4 + i;
    const bool nonempty = l[i] > 0.f;
    float* orow = o + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      orow[tx + 16 * c] = nonempty ? acc[i][c] / l[i] : 0.f;
    if (tx == 0)
      lse[((size_t)b * H + h) * Sq + row] = nonempty ? m[i] + logf(l[i]) : kNegInf;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* band,
                   int band_stride, const void* seg_q, const void* seg_kv, void* o,
                   void* lse, int B, int Sq, int Skv, int H, int Hkv, float scale,
                   int stride_q, int stride_kv, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kern = flash_fwd_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(band), band_stride, static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_kv), static_cast<float*>(o), static_cast<float*>(lse), Sq, Skv,
      H, Hkv, scale, stride_q, stride_kv);
  return cudaGetLastError();
}

cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* band,
                       int band_stride, const void* seg_q, const void* seg_kv, void* o,
                       void* lse, int B, int Sq, int Skv, int H, int Hkv, float scale,
                       int stride_q, int stride_kv, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<32>(q, k, v, band, band_stride, seg_q, seg_kv, o, lse, B, Sq, Skv, H,
                        Hkv, scale, stride_q, stride_kv, stream);
    case 64:
      return launch<64>(q, k, v, band, band_stride, seg_q, seg_kv, o, lse, B, Sq, Skv, H,
                        Hkv, scale, stride_q, stride_kv, stream);
    case 128:
      return launch<128>(q, k, v, band, band_stride, seg_q, seg_kv, o, lse, B, Sq, Skv, H,
                         Hkv, scale, stride_q, stride_kv, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// fp32 only.  Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* band,
                         int band_stride, const void* seg_q, const void* seg_kv, void* o,
                         void* lse, int B, int Sq, int Skv, int H, int Hkv, int D, float scale,
                         int stride_q, int stride_kv, void* stream) {
  return (int)dispatch_d(D, q, k, v, band, band_stride, seg_q, seg_kv, o, lse, B, Sq, Skv, H, Hkv,
                         scale, stride_q, stride_kv, static_cast<cudaStream_t>(stream));
}
