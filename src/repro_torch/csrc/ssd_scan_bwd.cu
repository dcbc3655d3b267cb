// The Mamba-2 SSD chunked scan's gradients on Hopper (sm_90a), fp32 on the
// CUDA cores, plain C interface for ctypes.
//
// Replaces no Pallas kernel: the JAX package differentiates its jnp chunked
// scan (src/repro/models/ssm.py::_ssd_chunked) with jax.grad, and its Pallas
// forward (src/repro/kernels/ssd_scan.py::ssd_scan_fwd) has no backward.  The
// port runs a hand-written forward (ssd_scan.cu, #5) where JAX runs jnp, so
// its gradient is a kernel too (#5b), behind kernels/ssd_scan.py::_SSDScan.
//
// What it computes: for the forward of ssd_scan.cu (x [B, S, H, P], dt
// [B, S, H], A [H] < 0, B and C [B, S, G, N], head h reading group h / (H/G),
// h_0 = 0, chunks of c <= 64 tokens, acum the inclusive prefix sum of dt*A
// inside a chunk) and the gradients dy [B, S, H, P] of y and dstate
// [B, H, P, N] of the final state (or none: zeros), the gradients dx, ddt,
// dA [H], dB and dC [B, S, G, N] (summed over the heads of a group).  With
// h_in the state entering a chunk, g the gradient of the state leaving it,
// W_s = exp(acum_last - acum_s), E_t = exp(acum_t), L[t][s] = exp(acum_t -
// acum_s) for s <= t, S[t][s] = C_t . B_s and D[t][s] = dy_t . x_s:
//   dx_s  = dt_s (sum_t L S[t][s] dy_t + W_s g B_s)
//   dB_s  = sum_t L dt_s D[t][s] C_t + W_s dt_s x_s^T g
//   dC_t  = sum_s L dt_s D[t][s] B_s + E_t dy_t h_in
//   ddt_s = sum_t L S D[t][s] + W_s <g, x_s B_s^T> + A d(a)_s
//   dA    = sum over every token of dt_s d(a)_s
// where d(a) is the reverse prefix sum inside the chunk of d(acum): the
// intra-chunk rows minus columns of L S dt D (the diagonal, which cancels,
// left out of both), E_t (dy_t h_in) . C_t, minus W_s dt_s <g, x_s B_s^T>,
// and on acum_last their sum plus E_last <g, h_in>.
//
// Design: the forward's chunked form run backwards, four launches of one C
// call on the caller's stream, each parallel over chunks:
//   (a) ssd_bwd_states_kernel, one block per (chunk, head or head + H,
//       batch row): each chunk's own end state sum_s W_s dt_s x_s B_s^T
//       (blocks y < H, which also write exp(acum_last)), and its term of the
//       state gradient sum_t E_t dy_t C_t^T (blocks y >= H);
//   (b) ssd_bwd_pass_kernel, one thread per state entry of (batch row,
//       head) and direction: forwards over chunks, h_in[z+1] = exp(acum_last)
//       h_in[z] + state[z] (h_in[0] = 0), written over the chunk states; and
//       backwards, g[z-1] = exp(acum_last[z]) g[z] + term[z] from g[last] =
//       dstate, written over the terms;
//   (c) ssd_bwd_chunk_kernel, one block per (chunk, head, batch row): the
//       c x c products S and D, the masked L S, L dt D and L S D, then dx, dB
//       and dC by head (dB and dC into scratch), ddt and the chunk's share of
//       dA; the carry <g, h_in> and every sum over a row in a fixed order;
//   (d) ssd_bwd_reduce_kernel: dB and dC summed over the heads of each
//       group and dA over every chunk and batch row, in a fixed order.
// Every product is fp32 on the CUDA cores from shared memory, each thread a
// 4 x 4 tile of the output (rows and columns strided, so a warp reads
// neighbouring words).  Recomputing h_in costs one more pass over x and B;
// saving the forward's [B, S/c, H, P, N] states instead would hold 33.5 MB
// per layer and batch row for mamba2-370m at S 2048.
//
// What bounds it on an H100: the function moves x, dy and dx, B, C, dB, dC,
// dt and ddt once: for mamba2-370m (B 1, S 2048, H 32, P 64, N 128) 55.0 MB,
// 16.4 us at 3.35 TB/s, against ~7 GFLOP of products (2.1 us on the tensor
// cores, 105 us on the fp32 CUDA cores).  This kernel does the products on
// the CUDA cores and sends the chunk states and their gradients through
// device memory: it is bound by the CUDA cores' rate (PERF.md has its times).
//
// Numerics: every decay is masked by SELECTION: exp(acum_t - acum_s) is
// taken only for s <= t, and the decay is never factored as exp(acum_t)
// exp(-acum_s); every exponent is <= 0, so no inf meets a zero (JAX's
// jax.grad of _ssd_chunked gives NaN there once a chunk's sum of dt*|A|
// passes ~88: ROADMAP C.7).  No atomics: two calls give bitwise-equal
// gradients.
//
// Shapes: P in {16, 32, 64}, N in {8, 16, 32, 64, 128}, 1 <= c <= 64 dividing
// S (short chunks padded to a multiple of 16 rows with zeros), G dividing H;
// batch / sequence / head strides on x, dt, B, C, the last dim dense; dy,
// dstate and every output contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block of (a) and (c)
constexpr int CMAX = 64;       // longest chunk
constexpr int PASS_BATCH = 8;  // chunks whose states the pass loads at once
constexpr int RED = 33;        // row stride of the per-row partial sums (<= 32 column tiles)
constexpr int NVEC = 8;        // per-token vectors of (c)

struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *dy, *dstate;
  float *dx, *ddt, *dA, *dBm, *dCm;
  float *states, *grads, *decay, *dBp, *dCp, *dAp;
  int B, S, H, P, G, N, chunk, nz, cp;
  long long sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg;
};

// warp 0: acum[t] (inclusive prefix sum of dt*A) and dts[t] for t < c, 0 for
// c <= t < 64 (lane l owns tokens 2l and 2l + 1), in the order ssd_scan.cu
// sums them
__device__ __forceinline__ void chunk_prefix(const float* dtb, long long sds, float a_h, int c,
                                             float* acum, float* dts) {
  const int lane = threadIdx.x;
  const int t0 = 2 * lane, t1 = t0 + 1;
  const float d0 = t0 < c ? dtb[t0 * sds] : 0.f, d1 = t1 < c ? dtb[t1 * sds] : 0.f;
  const float v0 = d0 * a_h;
  const float v1 = v0 + d1 * a_h;
  float incl = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  dts[t0] = d0;
  dts[t1] = d1;
  acum[t0] = t0 < c ? excl + v0 : 0.f;
  acum[t1] = t1 < c ? incl : 0.f;
}

// acc[ii][jj] += sum_k A(i, k) Bt(k, j) over k < K, for rows i = it + ii MI
// and columns j = jt + jj NJ; A(i, k) = A[i ai + k ak], Bt(k, j) = Bt[k bk + j bj]
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* A, int ai, int ak,
                                   const float* Bt, int bk, int bj, int it, int MI, int jt,
                                   int NJ, int K) {
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = A[(it + q * MI) * ai + k * ak];
      b[q] = Bt[k * bk + (jt + q * NJ) * bj];
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;
}

// rows [0, cp) x cols [0, W) of a chunk's rows (row r at src + r * rs) into
// shared memory at stride ld; zeros from row c on
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, long long rs, int c,
                                      int cp, int W) {
  for (int i = threadIdx.x; i < cp * W; i += blockDim.x) {
    const int r = i / W, q = i % W;
    dst[r * ld + q] = r < c ? src[r * rs + q] : 0.f;
  }
}

// the block's sum of v (every thread's), in a fixed order; red holds NT / 32
// floats; every thread gets the sum
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// ---- (a) each chunk's own end state, and its term of the state gradient ----
// Blocks y < H: state[p][n] = sum_s W_s dt_s x_s[p] B_s[n], and exp(acum_last);
// blocks y >= H: term[p][n] = sum_t E_t dy_t[p] C_t[n].
__global__ void __launch_bounds__(NT) ssd_bwd_states_kernel(const Args a) {
  extern __shared__ float smem[];
  const int z = blockIdx.x, b = blockIdx.z;
  const bool grad_side = blockIdx.y >= a.H;
  const int h = grad_side ? blockIdx.y - a.H : blockIdx.y;
  const int g = h / (a.H / a.G);
  const int c = a.chunk, cp = a.cp, P = a.P, N = a.N;
  const int RP = P + 1, RN = N + 1;
  float* Us = smem;            // x or dy, [s][p]
  float* Vs = Us + cp * RP;    // B or C, [s][n]
  float* acum = Vs + cp * RN;  // then the row weights
  float* dts = acum + CMAX;
  const long long s0 = (long long)z * c;
  if (grad_side) {
    stage(Us, RP, a.dy + ((long long)b * a.S + s0) * a.H * P + (long long)h * P,
          (long long)a.H * P, c, cp, P);
    stage(Vs, RN, a.Cm + b * a.scb + s0 * a.scs + g * a.scg, a.scs, c, cp, N);
  } else {
    stage(Us, RP, a.x + b * a.sxb + s0 * a.sxs + h * a.sxh, a.sxs, c, cp, P);
    stage(Vs, RN, a.Bm + b * a.sbb + s0 * a.sbs + g * a.sbg, a.sbs, c, cp, N);
  }
  if (threadIdx.x < 32)
    chunk_prefix(a.dt + b * a.sdb + s0 * a.sds + h * a.sdh, a.sds, a.A[h], c, acum, dts);
  __syncthreads();
  const float last = acum[c - 1];
  __syncthreads();
  if (threadIdx.x < CMAX) {
    const int t = threadIdx.x;
    acum[t] = t >= c ? 0.f : grad_side ? expf(acum[t]) : expf(last - acum[t]) * dts[t];
  }
  if (!grad_side && threadIdx.x == 0) a.decay[((long long)b * a.nz + z) * a.H + h] = expf(last);
  __syncthreads();
  for (int i = threadIdx.x; i < cp * P; i += NT) Us[(i / P) * RP + i % P] *= acum[i / P];
  __syncthreads();

  // out[p][n] = sum_s U[s][p] V[s][n]
  const int MI = P / 4, NJ = N / 4;
  float* out = (grad_side ? a.grads : a.states) + (((long long)b * a.nz + z) * a.H + h) * P * N;
  for (int tt = threadIdx.x; tt < MI * NJ; tt += NT) {
    const int it = tt / NJ, jt = tt % NJ;
    float acc[4][4];
    zero(acc);
    mm(acc, Us, 1, RP, Vs, RN, 1, it, MI, jt, NJ, cp);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        out[(long long)(it + ii * MI) * N + jt + jj * NJ] = acc[ii][jj];
  }
}

// ---- (b) the passes across chunks ------------------------------------------
// blockIdx.y 0: states[z] (a chunk's own end state) becomes h_in[z];
// blockIdx.y 1: grads[z] (a chunk's term) becomes g[z], from g[last] = dstate.
__global__ void __launch_bounds__(256) ssd_bwd_pass_kernel(const Args a) {
  const long long pn = (long long)a.P * a.N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)a.B * a.H * pn) return;
  const long long bh = i / pn, r = i % pn;
  const int b = (int)(bh / a.H), h = (int)(bh % a.H);
  const bool rev = blockIdx.y == 1;
  float* st = (rev ? a.grads : a.states) + ((long long)b * a.nz * a.H + h) * pn + r;
  const float* dec = a.decay + (long long)b * a.nz * a.H + h;
  const long long zs = (long long)a.H * pn;  // floats from one chunk's state to the next
  float carry = (rev && a.dstate != nullptr) ? a.dstate[bh * pn + r] : 0.f;
  for (int k0 = 0; k0 < a.nz; k0 += PASS_BATCH) {
    float v[PASS_BATCH], d[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (k0 + k < a.nz) {
        const int z = rev ? a.nz - 1 - (k0 + k) : k0 + k;
        v[k] = st[z * zs];
        d[k] = dec[(long long)z * a.H];
      }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (k0 + k < a.nz) {
        const int z = rev ? a.nz - 1 - (k0 + k) : k0 + k;
        st[z * zs] = carry;
        carry = fmaf(d[k], carry, v[k]);
      }
  }
}

// ---- (c) each chunk's gradients --------------------------------------------
__global__ void __launch_bounds__(NT) ssd_bwd_chunk_kernel(const Args a) {
  extern __shared__ float smem[];
  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int c = a.chunk, cp = a.cp, P = a.P, N = a.N;
  const int RP = P + 1, RN = N + 1, RC = cp + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* xs = smem;          // x, [s][p]
  float* dys = xs + cp * RP;  // dy, [t][p]
  float* Bs = dys + cp * RP;  // B, [s][n]
  float* Cs = Bs + cp * RN;   // C, [t][n]
  float* Gs = Cs + cp * RN;   // g, then h_in, [p][n]
  float* Ss = Gs + P * RN;    // S, then L S, [t][s]
  float* Ds = Ss + cp * RC;   // D, then L dt D, [t][s]
  float* Qs = Ds + cp * RC;   // L S D, [t][s]
  float* red = Qs + cp * RC;  // per-row partials, [row][column tile]
  float* acum = red + cp * RED;
  float* dts = acum + CMAX;
  float* W = dts + CMAX;      // exp(acum_last - acum_s)
  float* E = W + CMAX;        // exp(acum_t)
  float* rowq = E + CMAX;     // sum_{s<t} L S D[t][s] dt_s
  float* colq = rowq + CMAX;  // sum_{t>s} L S D[t][s]
  float* xgB = colq + CMAX;   // <g, x_s B_s^T>
  float* V = xgB + CMAX;      // E_t (dy_t h_in) . C_t
  float* scal = V + CMAX;     // block sums

  const long long s0 = (long long)z * c;
  const long long bzh = ((long long)b * a.nz + z) * a.H + h;
  const float* hin = a.states + bzh * P * N;
  stage(xs, RP, a.x + b * a.sxb + s0 * a.sxs + h * a.sxh, a.sxs, c, cp, P);
  stage(dys, RP, a.dy + ((long long)b * a.S + s0) * a.H * P + (long long)h * P,
        (long long)a.H * P, c, cp, P);
  stage(Bs, RN, a.Bm + b * a.sbb + s0 * a.sbs + g * a.sbg, a.sbs, c, cp, N);
  stage(Cs, RN, a.Cm + b * a.scb + s0 * a.scs + g * a.scg, a.scs, c, cp, N);
  stage(Gs, RN, a.grads + bzh * P * N, N, P, P, N);
  if (warp == 0)
    chunk_prefix(a.dt + b * a.sdb + s0 * a.sds + h * a.sdh, a.sds, a.A[h], c, acum, dts);
  __syncthreads();
  const float last = acum[c - 1];
  if (tid < CMAX) {
    W[tid] = tid < c ? expf(last - acum[tid]) : 0.f;
    E[tid] = tid < c ? expf(acum[tid]) : 0.f;
  }

  // S[t][s] = C_t . B_s and D[t][s] = dy_t . x_s
  {
    const int MI = cp / 4, NJ = cp / 4;
    for (int tt = tid; tt < MI * NJ; tt += NT) {
      const int it = tt / NJ, jt = tt % NJ;
      float acc[4][4];
      zero(acc);
      mm(acc, Cs, RN, 1, Bs, 1, RN, it, MI, jt, NJ, N);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) Ss[(it + ii * MI) * RC + jt + jj * NJ] = acc[ii][jj];
      zero(acc);
      mm(acc, dys, RP, 1, xs, 1, RP, it, MI, jt, NJ, P);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) Ds[(it + ii * MI) * RC + jt + jj * NJ] = acc[ii][jj];
    }
  }
  __syncthreads();
  // the decay by selection: only s <= t < c takes an exponential
  for (int i = tid; i < cp * cp; i += NT) {
    const int t = i / cp, s = i % cp;
    float p1 = 0.f, q = 0.f, ds = 0.f;
    if (t < c && s <= t) {
      const float L = expf(acum[t] - acum[s]);
      const float Dv = Ds[t * RC + s];
      p1 = L * Ss[t * RC + s];
      q = p1 * Dv;
      ds = L * dts[s] * Dv;
    }
    Ss[t * RC + s] = p1;
    Ds[t * RC + s] = ds;
    Qs[t * RC + s] = q;
  }
  __syncthreads();
  // LSD's diagonal leaves d(acum) exactly (a row's term and a column's,
  // opposite signs): the sums skip it, so it cancels without rounding
  if (tid < cp) {
    float r = 0.f;
    for (int s = 0; s < tid; ++s) r = fmaf(Qs[tid * RC + s], dts[s], r);
    rowq[tid] = r;
  } else if (tid < 2 * cp) {
    const int s = tid - cp;
    float col = 0.f;
    for (int t = s + 1; t < cp; ++t) col += Qs[t * RC + s];
    colq[s] = col;
  }

  // dx[s][p] = dt_s (sum_t LS[t][s] dy[t][p] + W_s (B g^T)[s][p]); the row
  // partials of <x_s, (B g^T)_s> go to red
  {
    const int MI = cp / 4, NJ = P / 4;
    for (int tt = tid; tt < MI * NJ; tt += NT) {
      const int it = tt / NJ, jt = tt % NJ;
      float acc[4][4];
      zero(acc);
      mm(acc, Bs, RN, 1, Gs, 1, RN, it, MI, jt, NJ, N);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int s = it + ii * MI;
        float part = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) part = fmaf(xs[s * RP + jt + jj * NJ], acc[ii][jj], part);
        red[s * RED + jt] = part;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] *= W[s];
      }
      mm(acc, Ss, 1, RC, dys, RP, 1, it, MI, jt, NJ, cp);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int s = it + ii * MI;
        if (s >= c) continue;
        float* row = a.dx + (((long long)b * a.S + s0 + s) * a.H + h) * P;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) row[jt + jj * NJ] = dts[s] * acc[ii][jj];
      }
    }
    __syncthreads();
    if (tid < cp) {
      float sum = 0.f;
      for (int j = 0; j < NJ; ++j) sum += red[tid * RED + j];
      xgB[tid] = sum;
    }
  }

  // dB[s][n] = sum_t LdtD[t][s] C[t][n] + W_s dt_s (x g)[s][n]
  {
    const int MI = cp / 4, NJ = N / 4;
    for (int tt = tid; tt < MI * NJ; tt += NT) {
      const int it = tt / NJ, jt = tt % NJ;
      float acc[4][4];
      zero(acc);
      mm(acc, xs, RP, 1, Gs, RN, 1, it, MI, jt, NJ, P);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int s = it + ii * MI;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] *= W[s] * dts[s];
      }
      mm(acc, Ds, 1, RC, Cs, RN, 1, it, MI, jt, NJ, cp);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int s = it + ii * MI;
        if (s >= c) continue;
        float* row = a.dBp + (((long long)b * a.S + s0 + s) * a.H + h) * N;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) row[jt + jj * NJ] = acc[ii][jj];
      }
    }
  }
  // the carry's term on acum_last: <g, h_in>, in a fixed order
  float part = 0.f;
  for (int i = tid; i < P * N; i += NT) part = fmaf(Gs[(i / N) * RN + i % N], hin[i], part);
  const float carry = block_sum(part, scal);
  __syncthreads();
  stage(Gs, RN, hin, N, P, P, N);  // h_in from here on
  __syncthreads();

  // dC[t][n] = sum_s LdtD[t][s] B[s][n] + E_t (dy h_in)[t][n]; the row
  // partials of (dy_t h_in) . C_t go to red
  {
    const int MI = cp / 4, NJ = N / 4;
    for (int tt = tid; tt < MI * NJ; tt += NT) {
      const int it = tt / NJ, jt = tt % NJ;
      float acc[4][4];
      zero(acc);
      mm(acc, dys, RP, 1, Gs, RN, 1, it, MI, jt, NJ, P);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int t = it + ii * MI;
        float part2 = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) part2 = fmaf(Cs[t * RN + jt + jj * NJ], acc[ii][jj], part2);
        red[t * RED + jt] = part2;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] *= E[t];
      }
      mm(acc, Ds, RC, 1, Bs, RN, 1, it, MI, jt, NJ, cp);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int t = it + ii * MI;
        if (t >= c) continue;
        float* row = a.dCp + (((long long)b * a.S + s0 + t) * a.H + h) * N;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) row[jt + jj * NJ] = acc[ii][jj];
      }
    }
    __syncthreads();
    if (tid < cp) {
      float sum = 0.f;
      for (int j = 0; j < NJ; ++j) sum += red[tid * RED + j];
      V[tid] = E[tid] * sum;
    }
  }
  __syncthreads();

  // d(acum) -> d(a) by a reverse prefix sum; ddt and the chunk's share of dA
  if (warp == 0) {
    const float a_h = a.A[h];
    float dac[2], ddir[2], u[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = 2 * lane + k;
      u[k] = dac[k] = ddir[k] = 0.f;
      if (t < c) {
        u[k] = W[t] * dts[t] * xgB[t];
        dac[k] = rowq[t] - dts[t] * colq[t] + V[t] - u[k];
        ddir[k] = Qs[t * RC + t] + colq[t] + W[t] * xgB[t];
      }
    }
    float usum = u[0] + u[1];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) usum += __shfl_xor_sync(0xffffffffu, usum, off);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (2 * lane + k == c - 1) dac[k] += usum + E[c - 1] * carry;
    float incl = dac[0] + dac[1];  // then the sum over this lane's pair and every later lane's
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += v;
    }
    float excl = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) excl = 0.f;
    const float da1 = excl + dac[1], da0 = da1 + dac[0];
    float* drow = a.ddt + ((long long)b * a.S + s0) * a.H + h;
    if (2 * lane < c) drow[(long long)(2 * lane) * a.H] = ddir[0] + a_h * da0;
    if (2 * lane + 1 < c) drow[(long long)(2 * lane + 1) * a.H] = ddir[1] + a_h * da1;
    float dsum = dts[2 * lane] * da0 + dts[2 * lane + 1] * da1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if (lane == 0) a.dAp[bzh] = dsum;
  }
}

// ---- (d) the sums over a group's heads and over chunks ----------------------
__global__ void __launch_bounds__(256) ssd_bwd_reduce_kernel(const Args a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nbc = (long long)a.B * a.S * a.G * a.N;
  const int rep = a.H / a.G;
  if (i < 2 * nbc) {
    const bool is_c = i >= nbc;
    const long long j = is_c ? i - nbc : i;
    const long long n = j % a.N, r = j / a.N;
    const long long gi = r % a.G, bs = r / a.G;
    const float* src = (is_c ? a.dCp : a.dBp) + (bs * a.H + gi * rep) * a.N + n;
    float sum = 0.f;
    for (int k = 0; k < rep; ++k) sum += src[(long long)k * a.N];
    (is_c ? a.dCm : a.dBm)[j] = sum;
  } else if (i < 2 * nbc + a.H) {
    const int h = (int)(i - 2 * nbc);
    float sum = 0.f;
    for (long long r = 0; r < (long long)a.B * a.nz; ++r) sum += a.dAp[r * a.H + h];
    a.dA[h] = sum;
  }
}

template <typename K>
cudaError_t launch_smem(K kern, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                        const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], A [H], Bm / Cm [B, S, G, N], all fp32, with
// element strides (batch, sequence, head or group) of x, dt, Bm, Cm in that
// order, the last dim dense; dy [B, S, H, P] and dstate [B, H, P, N] (null:
// zeros) contiguous fp32.  Outputs, contiguous fp32: dx [B, S, H, P], ddt
// [B, S, H], dA [H], dBm / dCm [B, S, G, N].  Scratch, contiguous fp32:
// states and grads [B, S/chunk, H, P, N], decay [B, S/chunk, H], dBp / dCp
// [B, S, H, N], dAp [B, S/chunk, H].  P in {16, 32, 64}, N in {8, 16, 32, 64,
// 128}, 1 <= chunk <= 64 dividing S.  Launches four kernels on the stream;
// returns the first launch error (cudaGetLastError()).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* dy, const void* dstate, void* dx,
                            void* ddt, void* dA, void* dBm, void* dCm, void* states, void* grads,
                            void* decay, void* dBp, void* dCp, void* dAp, int B, int S, int H,
                            int P, int G, int N, int chunk, long long sxb, long long sxs,
                            long long sxh, long long sdb, long long sds, long long sdh,
                            long long sbb, long long sbs, long long sbg, long long scb,
                            long long scs, long long scg, void* stream) {
  if (P % 16 || P < 16 || P > 64 || N % 8 || N < 8 || N > 128 || chunk < 1 || chunk > CMAX ||
      S % chunk || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = static_cast<const float*>(Bm);
  a.Cm = static_cast<const float*>(Cm);
  a.dy = static_cast<const float*>(dy);
  a.dstate = static_cast<const float*>(dstate);
  a.dx = static_cast<float*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dBm = static_cast<float*>(dBm);
  a.dCm = static_cast<float*>(dCm);
  a.states = static_cast<float*>(states);
  a.grads = static_cast<float*>(grads);
  a.decay = static_cast<float*>(decay);
  a.dBp = static_cast<float*>(dBp);
  a.dCp = static_cast<float*>(dCp);
  a.dAp = static_cast<float*>(dAp);
  a.B = B; a.S = S; a.H = H; a.P = P; a.G = G; a.N = N; a.chunk = chunk;
  a.nz = S / chunk;
  a.cp = (chunk + 15) / 16 * 16;
  a.sxb = sxb; a.sxs = sxs; a.sxh = sxh;
  a.sdb = sdb; a.sds = sds; a.sdh = sdh;
  a.sbb = sbb; a.sbs = sbs; a.sbg = sbg;
  a.scb = scb; a.scs = scs; a.scg = scg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = a.cp, RP = P + 1, RN = N + 1, RC = cp + 1;
  const size_t states_smem = sizeof(float) * (cp * RP + cp * RN + 2 * CMAX);
  const size_t chunk_smem = sizeof(float) * (2 * cp * RP + 2 * cp * RN + P * RN + 3 * cp * RC +
                                             cp * RED + NVEC * CMAX + NT / 32);
  cudaError_t err = launch_smem(ssd_bwd_states_kernel, dim3(a.nz, 2 * H, B), NT, states_smem, s, a);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * H * P * N;
  err = launch_smem(ssd_bwd_pass_kernel, dim3((unsigned)((n + 255) / 256), 2), 256, 0, s, a);
  if (err != cudaSuccess) return (int)err;
  err = launch_smem(ssd_bwd_chunk_kernel, dim3(a.nz, H, B), NT, chunk_smem, s, a);
  if (err != cudaSuccess) return (int)err;
  const long long m = 2LL * B * S * G * N + H;
  return (int)launch_smem(ssd_bwd_reduce_kernel, dim3((unsigned)((m + 255) / 256)), 256, 0, s, a);
}
