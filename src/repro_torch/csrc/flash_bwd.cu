// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_bwd, both
//   of its Pallas calls:
//   * flash_bwd_dq  -- the dQ call (body _dq_kernel);
//   * flash_bwd_dkv -- the dK/dV call (body _dkv_kernel).
//
// What they compute, from the forward's saved lse and delta = rowsum(dO * O):
//   S  = scale * q k^T,  P = exp(S - lse) on visible pairs (0 elsewhere),
//   dP = dO v^T,         dS = P * (dP - delta) * scale,
//   dQ = dS k,  dK = dS^T q,  dV = P^T dO,
// with dK/dV summed over the GQA group (query heads hk*g .. hk*g+g-1 read kv
// head hk, g = H / Hkv).  Visibility is flash_fwd.cu's: the int32 band
// (q_off, kv_off, lo, hi) in device memory with static strides, composed with
// optional segment ids.  One [4] band serves the whole batch (the JAX
// backward takes no per-row band).  q, k, v, dO are [B, S, heads, D] in fp32
// or bf16; lse and delta are fp32 [B, H, Sq] (delta is transposed to that
// layout by the wrapper, as JAX does before its Pallas calls).  Arithmetic
// is fp32; dq, dk, dv are written once, in the input type.
//
// What bounds them on an H100: per visible (query, key) pair and query head,
// dQ does 6*D flops (S, dP, dQ) and dK/dV 8*D (S, dP, dV, dK), against
// ~2*D bytes per token and head of inputs and outputs -- far above the card's
// ~295 flop/byte balance point at training lengths, so both are bound by
// arithmetic.  Like flash_fwd.cu, this first version does the arithmetic in
// fp32 on the CUDA cores (67 TFLOP/s peak, no tensor cores); wgmma/TMA are
// later work.
//
// Design:
//   * dQ: one block per (q tile of 64 rows, query head, batch row); the TPU
//     kernel's sequential kv grid axis becomes a loop over KV tiles of 32
//     keys, bounded by the band so hidden tiles are never loaded.  Each of
//     the 256 threads (16 x 16) owns 4 rows: a 4 x 2 micro-tile of S and dP
//     (keys tx, tx+16), dS staged through shared memory, then dQ accumulated
//     in registers over dims tx + 16*c.
//   * dK/dV: one block per (kv tile of 64 keys, kv head, batch row); the loop
//     runs over the group's g query heads x the q tiles of 32 rows that the
//     band lets see the tile.  Each thread owns 4 keys and accumulates both
//     dK and dV in registers; P^T and dS^T are staged in shared memory.  No
//     atomics and no split of a kv tile's sum across blocks: every output is
//     written once by one block in a fixed order, so repeated launches give
//     bitwise-identical gradients.
//   * empty rows (lse = NEG_INF) and masked pairs are SELECTED to 0 before
//     any multiply (exp(s - lse) would be inf there); the ragged edges are
//     masked, so Sq and Skv need not divide the tiles.
//   * tiles are staged as fp32 in dynamic shared memory (~110-120 KB at
//     D = 128), above the 48 KB static limit: each launch first raises the
//     kernel's limit with cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block (16 x 16)
constexpr int DQ_BQ = 64;  // dQ: query rows per block
constexpr int DQ_BK = 32;  // dQ: keys per KV tile
constexpr int KV_BK = 64;  // dK/dV: keys per block
constexpr int KV_BQ = 32;  // dK/dV: query rows per q tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ long long floor_div(long long a, long long b) {
  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}
__host__ __device__ __forceinline__ long long ceil_div(long long a, long long b) {
  return -floor_div(-a, b);
}

__device__ __forceinline__ float dot4(float4 a, float b0, float b1, float b2, float b3) {
  return a.x * b0 + a.y * b1 + a.z * b2 + a.w * b3;
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
constexpr int dq_smem_floats() {
  // Qs, dOs [BQ][D+4] + Ks, Vs [BK][D+1] + dSs [BQ][BK+1] + segk [BK]
  return 2 * DQ_BQ * (D + 4) + 2 * DQ_BK * (D + 1) + DQ_BQ * (DQ_BK + 1) + DQ_BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ band,
    const int* __restrict__ seg_q, const int* __restrict__ seg_kv, T* __restrict__ dq,
    int Sq, int Skv, int H, int Hkv, float scale, int stride_q, int stride_kv) {
  constexpr int BQ = DQ_BQ, BK = DQ_BK;
  constexpr int QS = D + 4;   // Qs/dOs row stride (float4-aligned)
  constexpr int KS = D + 1;   // Ks/Vs row stride (conflict-free column reads)
  constexpr int PS = BK + 1;  // dSs row stride
  constexpr int DC = D / 16;  // output dims per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * QS;
  float* Ks = dOs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* dSs = Vs + BK * KS;
  int* segk = reinterpret_cast<int*>(dSs + BQ * PS);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const bool has_seg = seg_q != nullptr;
  const long long q_off = band[0], kv_off = band[1], lo = band[2], hi = band[3];

  // visible key interval of this block's rows, solved from the band
  const int r_last = min(r0 + BQ, Sq) - 1;
  const long long qmin = q_off + (long long)stride_q * r0;
  const long long qmax = q_off + (long long)stride_q * r_last;
  long long jlo = ceil_div(qmin - hi - kv_off, stride_kv);
  long long jhi = floor_div(qmax - lo - kv_off, stride_kv);
  if (jlo < 0) jlo = 0;
  if (jhi > Skv - 1) jhi = Skv - 1;

  // q (pre-scaled) and dO tiles -> shared
  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int row = r0 + r;
    float qx = 0.f, ox = 0.f;
    if (row < Sq) {
      const size_t off = (((size_t)b * Sq + row) * H + h) * D + d;
      qx = to_f(q[off]) * scale;
      ox = to_f(dout[off]);
    }
    Qs[r * QS + d] = qx;
    dOs[r * QS + d] = ox;
  }

  long long qpos[4];
  int segq[4];
  bool row_ok[4];
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    row_ok[i] = row < Sq;
    qpos[i] = q_off + (long long)stride_q * row;
    segq[i] = (has_seg && row_ok[i]) ? seg_q[row] : 0;
    const size_t li = ((size_t)b * H + h) * Sq + row;
    lse_r[i] = row_ok[i] ? lse[li] : 0.f;
    delta_r[i] = row_ok[i] ? delta[li] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (long long j0 = jlo; j0 <= jhi; j0 += BK) {
    __syncthreads();  // previous tile's Ks/Vs/dSs consumed (and Qs/dOs written)
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      const long long key = j0 + j;
      float kx = 0.f, vx = 0.f;
      if (key <= jhi) {
        const size_t off = (((size_t)b * Skv + key) * Hkv + hk) * D + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      Ks[j * KS + d] = kx;
      Vs[j * KS + d] = vx;
    }
    if (tid < BK) {
      const long long key = j0 + tid;
      segk[tid] = (has_seg && key <= jhi) ? seg_kv[key] : 0;
    }
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
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
        for (int i = 0; i < 4; ++i) s[i][c] += dot4(qv[i], k0, k1, k2, k3);
      }
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ov[i] = *reinterpret_cast<const float4*>(&dOs[(ty * 4 + i) * QS + d]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* vr = &Vs[(tx + 16 * c) * KS + d];
        const float v0 = vr[0], v1 = vr[1], v2 = vr[2], v3 = vr[3];
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[i][c] += dot4(ov[i], v0, v1, v2, v3);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int jj = tx + 16 * c;
        const long long key = j0 + jj;
        const long long diff = qpos[i] - (kv_off + (long long)stride_kv * key);
        const bool vis = row_ok[i] && key <= jhi && diff >= lo && diff <= hi &&
                         (!has_seg || segq[i] == segk[jj]);
        // select, never multiply: exp(s - NEG_INF) is inf on an empty row
        const float p = vis ? expf(s[i][c] - lse_r[i]) : 0.f;
        dSs[(ty * 4 + i) * PS + jj] = vis ? p * (dp[i][c] - delta_r[i]) * scale : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kk = Ks[j * KS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += dsv[i] * kk;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    const int row = r0 + ty * 4 + i;
    T* out = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) out[tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

template <int D>
constexpr int dkv_smem_floats() {
  // Ks, Vs [BK][D+4] + Qs, dOs [BQ][D+1] + Pt, dSt [BK][BQ+1] + lse, delta, segq [BQ]
  return 2 * KV_BK * (D + 4) + 2 * KV_BQ * (D + 1) + 2 * KV_BK * (KV_BQ + 1) + 3 * KV_BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ band,
    const int* __restrict__ seg_q, const int* __restrict__ seg_kv, T* __restrict__ dk,
    T* __restrict__ dv, int Sq, int Skv, int H, int Hkv, float scale, int stride_q,
    int stride_kv) {
  constexpr int BK = KV_BK, BQ = KV_BQ;
  constexpr int KS = D + 4;   // Ks/Vs row stride (float4-aligned)
  constexpr int QS = D + 1;   // Qs/dOs row stride (conflict-free column reads)
  constexpr int PT = BQ + 1;  // Pt/dSt row stride
  constexpr int DC = D / 16;  // output dims per thread

  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * KS;
  float* Qs = Vs + BK * KS;
  float* dOs = Qs + BQ * QS;
  float* Pt = dOs + BQ * QS;
  float* dSt = Pt + BK * PT;
  float* lse_s = dSt + BK * PT;
  float* delta_s = lse_s + BQ;
  int* segq_s = reinterpret_cast<int*>(delta_s + BQ);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / Hkv;
  const bool has_seg = seg_q != nullptr;
  const long long q_off = band[0], kv_off = band[1], lo = band[2], hi = band[3];

  // visible query interval of this block's keys, solved from the band:
  // lo <= (q_off + sq*i) - (kv_off + skv*j) <= hi
  const int c_last = min(c0 + BK, Skv) - 1;
  const long long kmin = kv_off + (long long)stride_kv * c0;
  const long long kmax = kv_off + (long long)stride_kv * c_last;
  long long ilo = ceil_div(kmin + lo - q_off, stride_q);
  long long ihi = floor_div(kmax + hi - q_off, stride_q);
  if (ilo < 0) ilo = 0;
  if (ihi > Sq - 1) ihi = Sq - 1;

  // k and v tiles -> shared (unscaled)
  for (int idx = tid; idx < BK * D; idx += NT) {
    const int j = idx / D, d = idx % D;
    const int key = c0 + j;
    float kx = 0.f, vx = 0.f;
    if (key < Skv) {
      const size_t off = (((size_t)b * Skv + key) * Hkv + hk) * D + d;
      kx = to_f(k[off]);
      vx = to_f(v[off]);
    }
    Ks[j * KS + d] = kx;
    Vs[j * KS + d] = vx;
  }

  long long kpos[4];
  int segk[4];
  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + ty * 4 + i;
    key_ok[i] = key < Skv;
    kpos[i] = kv_off + (long long)stride_kv * key;
    segk[i] = (has_seg && key_ok[i]) ? seg_kv[key] : 0;
  }

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    for (long long i0 = ilo; i0 <= ihi; i0 += BQ) {
      __syncthreads();  // previous tile's Qs/dOs/Pt/dSt consumed (and Ks/Vs written)
      for (int idx = tid; idx < BQ * D; idx += NT) {
        const int r = idx / D, d = idx % D;
        const long long row = i0 + r;
        float qx = 0.f, ox = 0.f;
        if (row <= ihi) {
          const size_t off = (((size_t)b * Sq + row) * H + h) * D + d;
          qx = to_f(q[off]);
          ox = to_f(dout[off]);
        }
        Qs[r * QS + d] = qx;
        dOs[r * QS + d] = ox;
      }
      if (tid < BQ) {
        const long long row = i0 + tid;
        const bool ok = row <= ihi;
        const size_t li = ((size_t)b * H + h) * Sq + row;
        lse_s[tid] = ok ? lse[li] : 0.f;
        delta_s[tid] = ok ? delta[li] : 0.f;
        segq_s[tid] = (has_seg && ok) ? seg_q[row] : 0;
      }
      __syncthreads();

      // S^T and dP^T micro-tiles: keys ty*4+i, queries tx and tx+16
      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 kv4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          kv4[i] = *reinterpret_cast<const float4*>(&Ks[(ty * 4 + i) * KS + d]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float* qr = &Qs[(tx + 16 * c) * QS + d];
          const float q0 = qr[0], q1 = qr[1], q2 = qr[2], q3 = qr[3];
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i][c] += dot4(kv4[i], q0, q1, q2, q3);
        }
      }
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 vv4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          vv4[i] = *reinterpret_cast<const float4*>(&Vs[(ty * 4 + i) * KS + d]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float* orow = &dOs[(tx + 16 * c) * QS + d];
          const float o0 = orow[0], o1 = orow[1], o2 = orow[2], o3 = orow[3];
#pragma unroll
          for (int i = 0; i < 4; ++i) dp[i][c] += dot4(vv4[i], o0, o1, o2, o3);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qq = tx + 16 * c;
          const long long row = i0 + qq;
          const long long diff = (q_off + (long long)stride_q * row) - kpos[i];
          const bool vis = key_ok[i] && row <= ihi && diff >= lo && diff <= hi &&
                           (!has_seg || segq_s[qq] == segk[i]);
          // select, never multiply: exp(s - NEG_INF) is inf on an empty row
          const float p = vis ? expf(s[i][c] * scale - lse_s[qq]) : 0.f;
          Pt[(ty * 4 + i) * PT + qq] = p;
          dSt[(ty * 4 + i) * PT + qq] = vis ? p * (dp[i][c] - delta_s[qq]) * scale : 0.f;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Pt[(ty * 4 + i) * PT + qq];
          dsv[i] = dSt[(ty * 4 + i) * PT + qq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float o = dOs[qq * QS + tx + 16 * c];
          const float qd = Qs[qq * QS + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c] += pv[i] * o;
            acc_k[i][c] += dsv[i] * qd;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!key_ok[i]) continue;
    const int key = c0 + ty * 4 + i;
    const size_t off = (((size_t)b * Skv + key) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(acc_k[i][c]);
      dv[off + tx + 16 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *band, *seg_q, *seg_kv;
  void *out0, *out1;
  int B, Sq, Skv, H, Hkv;
  float scale;
  int stride_q, stride_kv;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = sizeof(float) * dq_smem_floats<D>();
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + DQ_BQ - 1) / DQ_BQ, a.H, a.B);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.band),
      static_cast<const int*>(a.seg_q), static_cast<const int*>(a.seg_kv),
      static_cast<T*>(a.out0), a.Sq, a.Skv, a.H, a.Hkv, a.scale, a.stride_q, a.stride_kv);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = sizeof(float) * dkv_smem_floats<D>();
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Skv + KV_BK - 1) / KV_BK, a.Hkv, a.B);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.band),
      static_cast<const int*>(a.seg_q), static_cast<const int*>(a.seg_kv),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.Sq, a.Skv, a.H, a.Hkv, a.scale,
      a.stride_q, a.stride_kv);
  return cudaGetLastError();
}

template <bool DKV, typename T>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 32: return DKV ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64: return DKV ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128: return DKV ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int dispatch(int dtype, int D, const Args& a) {
  if (a.H % a.Hkv != 0 || a.stride_q < 1 || a.stride_kv < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_d<DKV, float>(D, a);
  if (dtype == 1) return (int)dispatch_d<DKV, __nv_bfloat16>(D, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, dout: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D] (dtype 0 = float32, 1 = bfloat16);
// lse, delta: float32 [B, H, Sq]; band: int32 [4] on the device; seg_q [Sq] and
// seg_kv [Skv] int32 or both null.  dq: [B, Sq, H, D] in the input type.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* band,
                            const void* seg_q, const void* seg_kv, void* dq, int B, int Sq,
                            int Skv, int H, int Hkv, int D, float scale, int stride_q,
                            int stride_kv, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, band, seg_q, seg_kv, dq, nullptr,
         B, Sq, Skv, H, Hkv, scale, stride_q, stride_kv, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, D, a);
}

// As flash_bwd_dq; dk, dv: [B, Skv, Hkv, D] in the input type, each summed over
// the query heads of its GQA group.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* band,
                             const void* seg_q, const void* seg_kv, void* dk, void* dv, int B,
                             int Sq, int Skv, int H, int Hkv, int D, float scale, int stride_q,
                             int stride_kv, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, band, seg_q, seg_kv, dk, dv,
         B, Sq, Skv, H, Hkv, scale, stride_q, stride_kv, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, D, a);
}
