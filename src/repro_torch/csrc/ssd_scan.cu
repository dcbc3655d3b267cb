// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_fwd (Pallas body
//   _ssd_kernel).  It computes what the serving path of the JAX package
//   computes (models/ssm.py::_ssd_chunked + ssd_scan at h0 = 0), which is
//   also what the Pallas kernel was written to compute.
//
// What it computes: for x [B, S, H, P], dt [B, S, H] (softplus applied),
// A [H] (< 0) and B, C [B, S, G, N] (head h reads group h / (H / G)), the
// recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = C_t h_t from
// h_0 = 0, in chunks of c <= 64 tokens: with acum the inclusive prefix sum of
// dt*A inside a chunk,
//   y[t]  = sum_{s<=t} exp(acum_t - acum_s) (C_t . B_s) dt_s x_s
//           + exp(acum_t) C_t h_in^T
//   h_out = exp(acum_last) h_in + sum_s exp(acum_last - acum_s) dt_s x_s B_s^T
// x, dt, A, B, C and y are fp32, as the model gives them (JAX casts the
// scan's inputs to fp32 too); the final state [B, H, P, N] is fp32.  The decay of a hidden pair (s > t) is 0 by
// selection: its exponential is never taken.  (The Pallas kernel multiplies
// exp(acum_t - acum_s) by a 0/1 mask: once a chunk's sum of dt*|A| passes
// ~88 a hidden pair's exp is inf, and inf * 0 is NaN.)
//
// What bounds it on an H100: per token and head the function needs
// (c+1)*P flops for the causal half of the intra-chunk product, 4*P*N for
// the inter-chunk term and the state update, and (c+1)*N / (H/G) for its
// share of the group's causal C.B^T scores, against (P + 1 + 2N/(H/G)) * 4
// bytes in and P * 4 bytes out -- for mamba2-370m (P 64, N 128, c 64,
// H/G 32) ~37,000 flops per 0.55 KB, far above the card's balance point:
// it is bound by arithmetic.  This first version does
// the arithmetic in fp32 on the CUDA cores (67 TFLOP/s peak); tensor cores,
// TMA and a chunk-parallel state pass are later work.
//
// Design:
//   * one block per (16 head channels of P, head, batch row).  The rows of
//     the state h[p, :] evolve independently (h[p, :] reads only x[:, p] and
//     the shared dt, A, B, C), so P splits into tiles of 16 and each block
//     recomputes the chunk's C.B^T scores for its tile: at batch 1,
//     mamba2-370m gives 32 x 4 = 128 blocks for the 132 SMs, where one block
//     per head would give 32;
//   * the TPU kernel's sequential chunk grid axis becomes a loop inside the
//     block, and the [16, N] fp32 state tile stays in shared memory for the
//     whole sequence: it never goes to device memory until the end;
//   * per chunk: B and C are staged transposed ([N][68] floats), so the
//     scores' 4 x 4 micro-tiles read both operands as float4; the prefix sum
//     of dt*A is one warp's shuffle scan (c <= 64: two tokens a lane); the
//     decay-weighted scores go through shared memory to the y pass (one row
//     t and four channels a thread, float4 x reads), which also adds the
//     inter-chunk term exp(acum_t) C_t h^T; then each thread updates its
//     own state entries in place;
//   * inputs take batch / sequence / head strides (the last dim dense), so a
//     view into the fused input projection needs no copy;
//   * ~98 KB of shared memory at N = 128, so two blocks fit an SM; the
//     launch bounds let each thread keep up to 128 registers;
//   * no atomics and a fixed summation order: two launches are bitwise
//     equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PT = 16;    // head channels (of P) per block
constexpr int CMAX = 64;  // longest chunk
constexpr int RS = 68;    // row stride of the transposed B / C tiles (float4-aligned)
constexpr int MS = 65;    // row stride of the score tile
constexpr int NT = 256;   // threads per block

template <int N>
constexpr int smem_floats() {
  // Bt, Ct [N][RS] + Ms [CMAX][MS] + hT [N][PT] + xs [CMAX][PT]
  // + dts, acum, wend, eac [CMAX]
  return 2 * N * RS + CMAX * MS + N * PT + CMAX * PT + 4 * CMAX;
}

template <int N>
__global__ void __launch_bounds__(NT, 2) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    float* __restrict__ y, float* __restrict__ state,
    int S, int H, int P, int G, int chunk,
    long long sxb, long long sxs, long long sxh,
    long long sdb, long long sds, long long sdh,
    long long sbb, long long sbs, long long sbg,
    long long scb, long long scs, long long scg) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Bt = smem;                  // [N][RS]: B of the chunk, transposed
  float* Ct = Bt + N * RS;           // [N][RS]
  float* Ms = Ct + N * RS;           // [CMAX][MS]: decay-weighted scores
  float* hT = Ms + CMAX * MS;        // [N][PT]: the state tile, transposed
  float* xs = hT + N * PT;           // [CMAX][PT]
  float* dts = xs + CMAX * PT;       // [CMAX]
  float* acum = dts + CMAX;          // [CMAX] inclusive prefix sum of dt*A
  float* wend = acum + CMAX;         // [CMAX] exp(acum_last - acum_s) * dt_s
  float* eac = wend + CMAX;          // [CMAX] exp(acum_t)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const float a_h = A[h];

  const float* xb = x + b * sxb + h * sxh + p0;
  const float* dtb = dt + b * sdb + h * sdh;
  const float* Bb = Bm + b * sbb + g * sbg;
  const float* Cb = Cm + b * scb + g * scg;

  for (int i = tid; i < N * PT; i += NT) hT[i] = 0.f;

  // the y pass: row t, channels 4*pq .. 4*pq+3
  const int yt = tid >> 2, pq = tid & 3;
  // the scores: rows 4*ty .. 4*ty+3, columns 4*tx .. 4*tx+3
  const int tx = tid & 15, ty = tid >> 4;

  const int c = chunk;
  const int nz = S / chunk;
  for (int z = 0; z < nz; ++z) {
    const long long s0 = (long long)z * c;

    // ---- stage B, C (transposed), x and dt; the prefix sum of dt*A ------
    // consecutive threads take consecutive tokens, so the transposed writes
    // hit consecutive banks
    for (int i = tid; i < c * (N / 4); i += NT) {
      const int s = i % c, q = i / c;
      const float4 bv = *reinterpret_cast<const float4*>(Bb + (s0 + s) * sbs + 4 * q);
      const float4 cv = *reinterpret_cast<const float4*>(Cb + (s0 + s) * scs + 4 * q);
      Bt[(4 * q + 0) * RS + s] = bv.x;
      Bt[(4 * q + 1) * RS + s] = bv.y;
      Bt[(4 * q + 2) * RS + s] = bv.z;
      Bt[(4 * q + 3) * RS + s] = bv.w;
      Ct[(4 * q + 0) * RS + s] = cv.x;
      Ct[(4 * q + 1) * RS + s] = cv.y;
      Ct[(4 * q + 2) * RS + s] = cv.z;
      Ct[(4 * q + 3) * RS + s] = cv.w;
    }
    for (int i = tid; i < c * PT; i += NT) {
      const int s = i / PT, p = i % PT;
      xs[i] = xb[(s0 + s) * sxs + p];
    }
    if (tid < 32) {
      // warp scan over c <= 64 tokens: lane l owns tokens 2l and 2l+1
      const int t0 = 2 * tid, t1 = 2 * tid + 1;
      const float d0 = t0 < c ? dtb[(s0 + t0) * sds] : 0.f;
      const float d1 = t1 < c ? dtb[(s0 + t1) * sds] : 0.f;
      const float v0 = d0 * a_h;
      const float v1 = v0 + d1 * a_h;
      float incl = v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      if (t0 < c) { dts[t0] = d0; acum[t0] = excl + v0; }
      if (t1 < c) { dts[t1] = d1; acum[t1] = incl; }
      __syncwarp();
      const float last = acum[c - 1];
      if (t0 < c) { wend[t0] = expf(last - acum[t0]) * d0; eac[t0] = expf(acum[t0]); }
      if (t1 < c) { wend[t1] = expf(last - acum[t1]) * d1; eac[t1] = expf(acum[t1]); }
    }
    __syncthreads();

    // ---- scores: M[t][s] = (C_t . B_s) exp(acum_t - acum_s) dt_s, s <= t -
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(Ct + n * RS + 4 * ty);
        const float4 bv = *reinterpret_cast<const float4*>(Bt + n * RS + 4 * tx);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cr[i], br[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * tx + j;
          float m = 0.f;  // hidden pairs and rows past the chunk: 0 by selection
          if (s <= t && t < c) m = acc[i][j] * expf(acum[t] - acum[s]) * dts[s];
          Ms[t * MS + s] = m;
        }
      }
    }
    __syncthreads();

    // ---- y: intra-chunk quadratic form + inter-chunk term ------------------
    if (yt < c) {
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s <= yt; ++s) {
        const float m = Ms[yt * MS + s];
        const float4 xv = *reinterpret_cast<const float4*>(xs + s * PT + 4 * pq);
        o[0] = fmaf(m, xv.x, o[0]);
        o[1] = fmaf(m, xv.y, o[1]);
        o[2] = fmaf(m, xv.z, o[2]);
        o[3] = fmaf(m, xv.w, o[3]);
      }
      float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float cn = Ct[n * RS + yt];
        const float4 hv = *reinterpret_cast<const float4*>(hT + n * PT + 4 * pq);
        e[0] = fmaf(cn, hv.x, e[0]);
        e[1] = fmaf(cn, hv.y, e[1]);
        e[2] = fmaf(cn, hv.z, e[2]);
        e[3] = fmaf(cn, hv.w, e[3]);
      }
      const float ea = eac[yt];
      float* yrow = y + (((long long)b * S + s0 + yt) * H + h) * P + p0 + 4 * pq;
#pragma unroll
      for (int k = 0; k < 4; ++k) yrow[k] = fmaf(ea, e[k], o[k]);
    }
    __syncthreads();

    // ---- state: h <- exp(acum_last) h + sum_s wend_s x_s B_s^T ------------
    {
      const float total = eac[c - 1];
#pragma unroll
      for (int k = 0; k < (N + 63) / 64; ++k) {
        const int n = (tid >> 2) + 64 * k;
        if (n < N) {
          float4* hp = reinterpret_cast<float4*>(hT + n * PT + 4 * pq);
          float4 hv = *hp;
          hv.x *= total;
          hv.y *= total;
          hv.z *= total;
          hv.w *= total;
          for (int s = 0; s < c; ++s) {
            const float bw = Bt[n * RS + s] * wend[s];
            const float4 xv = *reinterpret_cast<const float4*>(xs + s * PT + 4 * pq);
            hv.x = fmaf(bw, xv.x, hv.x);
            hv.y = fmaf(bw, xv.y, hv.y);
            hv.z = fmaf(bw, xv.z, hv.z);
            hv.w = fmaf(bw, xv.w, hv.w);
          }
          *hp = hv;
        }
      }
    }
    __syncthreads();
  }

  float* st = state + (((long long)b * H + h) * P + p0) * N;
  for (int i = tid; i < PT * N; i += NT) {
    const int p = i / N, n = i % N;
    st[(long long)p * N + n] = hT[n * PT + p];
  }
}

template <int N>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                   void* y, void* state, int B, int S, int H, int P, int G, int chunk,
                   const long long* st, cudaStream_t stream) {
  const int smem = smem_floats<N>() * (int)sizeof(float);
  auto kern = ssd_scan_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(P / PT, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state), S, H, P, G, chunk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

cudaError_t dispatch_n(int N, const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, void* y, void* state, int B, int S, int H, int P, int G,
                       int chunk, const long long* st, cudaStream_t stream) {
  switch (N) {
    case 8: return launch<8>(x, dt, A, Bm, Cm, y, state, B, S, H, P, G, chunk, st, stream);
    case 16: return launch<16>(x, dt, A, Bm, Cm, y, state, B, S, H, P, G, chunk, st, stream);
    case 32: return launch<32>(x, dt, A, Bm, Cm, y, state, B, S, H, P, G, chunk, st, stream);
    case 64: return launch<64>(x, dt, A, Bm, Cm, y, state, B, S, H, P, G, chunk, st, stream);
    case 128: return launch<128>(x, dt, A, Bm, Cm, y, state, B, S, H, P, G, chunk, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], A [H], Bm / Cm [B, S, G, N], all fp32;
// element strides (batch, sequence, head or group) of x, dt, Bm, Cm in that
// order, the last dim dense.  y [B, S, H, P]
// contiguous fp32, state [B, H, P, N] fp32 contiguous.  P in
// {16, 32, 64}, N in {8, 16, 32, 64, 128}, 1 <= chunk <= 64 dividing S.
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, void* y, void* state, int B, int S, int H, int P, int G,
                        int N, int chunk, long long sxb, long long sxs, long long sxh,
                        long long sdb, long long sds, long long sdh, long long sbb,
                        long long sbs, long long sbg, long long scb, long long scs,
                        long long scg, void* stream) {
  if (P % PT || P < PT || P > 64 || chunk < 1 || chunk > CMAX || S % chunk || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch_n(N, x, dt, A, Bm, Cm, y, state, B, S, H, P, G, chunk, st, s);
}
