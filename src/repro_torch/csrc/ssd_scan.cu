// Mamba-2 SSD chunked scan on Hopper's tensor cores (sm_90a), plain C
// interface for ctypes.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_fwd (Pallas body
//   _ssd_kernel, pallas_call :115).  It computes what the serving path of the
//   JAX package computes (models/ssm.py::_ssd_chunked + ssd_scan at h0 = 0),
//   which is also what the Pallas kernel was written to compute.
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
// scan's inputs to fp32 too); the final state [B, H, P, N] is fp32.
//
// What bounds it on an H100: per token and head the function needs
// (c+1)*P flops for the causal half of the intra-chunk product, 4*P*N for
// the inter-chunk term and the state update, and (c+1)*N / (H/G) for its
// share of the group's causal C.B^T scores, against (P + 1 + 2N/(H/G)) * 4
// bytes in and P * 4 bytes out.  On the tensor cores (989 TFLOP/s in bf16)
// that is under the card's balance point: for mamba2-370m (B 1, S 2048, H 32,
// P 64, N 128) 2.4 GFLOP take 2.5 us, the 36.96 MB of x, y, B, C, dt and the
// state 11.0 us -- bound by bytes.  What the design adds on top: the
// per-chunk states go through device memory (see scratch below), and the
// products run in split precision, three bf16 products for each fp32 one
// (six under autograd, see Numerics).
//
// Design: four passes in three kernels, launched in order by one ssd_scan()
// call on the caller's stream, each parallel over chunks (the only thing a
// chunk needs from the one before it is the [P, N] state it starts from):
//   (a) the scores: one block per (chunk, group x 16-row tile, batch row)
//       computes the causal 16 x 16 tiles of the chunk's c x c scores C.B^T,
//       once per group and shared by all of its heads, into scratch;
//   (b) the chunk states: one block per (chunk, head, batch row) takes the
//       prefix sum of dt*A (one warp's shuffle scan), writes exp(acum_last)
//       for the state pass, and computes the chunk's own end state
//       sum_s exp(acum_last - acum_s) dt_s x_s B_s^T on the tensor cores;
//       (a) and (b) are the blocks of one launch, ssd_scan_chunk_kernel;
//   (c) ssd_scan_pass_kernel, one thread per 4 state entries of (batch row,
//       head): h_in[z+1] = exp(acum_last[z]) h_in[z] + state[z] in fp32 on
//       the CUDA cores, sequential over chunks only (loads issued a batch of
//       chunks ahead), written over the chunk states in place; the last
//       carry is the final state;
//   (d) ssd_scan_y_kernel, one block per (chunk, head, batch row): the prefix
//       sum again, then y = exp(acum_t) C h_in^T + M x with the decay-weighted
//       scores M[t][s] = scores[t][s] exp(acum_t - acum_s) dt_s formed in fp32
//       in registers, on the tensor cores.
// A block loads all of its tiles at once into registers, then splits them
// into shared memory.  On an H100 the blocks of (b) and (d) run in waves,
// each wave's loads before its products, so neither the memory nor the
// tensor cores are busy all the time (see PERF.md for the times by kernel):
// blocks that walk several heads or items and load the next one during the
// products measured slower (more registers, fewer blocks per SM).
// Scratch, allocated by the wrapper: the scores [B, S/c, G, cp, cp] fp32 (cp
// = c rounded up to 16), exp(acum_last) [B, S/c, H] fp32 and the chunk
// states [B, S/c, H, P, N] fp32.  For mamba2-370m at S 2048 that is 0.52 +
// 0.004 + 33.55 = 34.08 MB per call; for hymba-1.5b at S 1024 (H 50, N 16)
// 0.26 + 0.003 + 3.28 = 3.55 MB.
//
// Numerics (the term count is settled by tests/test_torch_ssd_split.py, which
// emulates this arithmetic on the CPU against the JAX package):
//   * every product is mma.sync m16n8k16 (bf16 operands, fp32 accumulators),
//     fragments through ldmatrix from shared memory or built in registers;
//   * every fp32 operand -- x, x * exp(acum_last - acum_s) dt_s, B, C, M and
//     h_in -- goes in as T bf16 terms, split once (staged into shared
//     memory, or in registers for C and M), and a product runs the term
//     pairs i + j < T.  The caller picks T: serving takes 2 (hi.hi + hi.lo +
//     lo.hi), the training forward under autograd 3 (six products).  The
//     emulation reads 0.06-0.15 of the gate (1e-4 of the output's scale)
//     with two terms, where one term of any operand reads 2.3-40x it; three
//     read 0.001-0.011, the plain fp32 chunked form's own distance to the
//     sequential oracle.  Two terms put a train step's card-vs-CPU
//     gradients near the limit of chip_smoke's train parity (PERF.md);
//   * sums are fp32; at most (N + c) / 16 * 3 = 36 products (72 with three
//     terms) go into one accumulator, so the tensor cores' truncating adds
//     stay ~1e-6 of it;
//   * the decay is masked by SELECTION: exp(acum_t - acum_s) is taken only
//     for s <= t, a hidden pair is 0 without an exponential, and the decay
//     is never factored as exp(acum_t) exp(-acum_s) (exp(-acum_s) overflows
//     once a chunk's sum of dt*|A| passes ~88).  Every exponent is <= 0.
//     (The Pallas kernel multiplies exp(acum_t - acum_s) by a 0/1 mask: inf
//     * 0 is NaN there.)
//   * no atomics and a fixed order of summation: two calls are bitwise equal.
//
// Shapes: P in {16, 32, 64}, N in {8, 16, 32, 64, 128} (N = 8 padded to 16
// with zeros in shared memory), 1 <= c <= 64 dividing S (short chunks padded
// to a multiple of 16 rows with zeros), G dividing H; batch / sequence /
// head strides on every input, the last dim dense.

#include "ssd_common.cuh"  // the bf16 split, mma_terms, the chunk prefix; ldmatrix, mma.sync

namespace {

constexpr int NT = 128;        // threads per block: four warps
constexpr int CMAX = 64;       // longest chunk
constexpr int PMAX = 64;       // widest head
constexpr int XS = PMAX + 8;   // row stride (bf16) of a staged x tile
constexpr int PASS_BATCH = 8;  // chunks whose states the pass loads at once

// T: bf16 terms of every fp32 operand (the caller's `terms`, 2 or 3)
template <int NP, int T>  // N padded to a multiple of 16
struct Cfg {
  static constexpr int RS = NP + 8;        // row stride (bf16) of a staged B, C or h tile
  static constexpr int NTILE = CMAX * RS;  // one term of a [64, NP] tile
  static constexpr int XTILE = CMAX * XS;  // one term of a [64, PMAX] tile
  // (a): 16 rows of C and B; (b): x * w and B, then acum and w; (d): x and
  // h_in, then acum and dt
  static constexpr int SCORES_SMEM = T * (16 * RS + NTILE) * 2;
  static constexpr int CHUNK_SMEM = T * (XTILE + NTILE) * 2 + 2 * CMAX * 4;
  static_assert(SCORES_SMEM <= CHUNK_SMEM, "(a) fits in (b)'s shared memory");
};

__device__ __forceinline__ float4 ld4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// A tile of fp32 rows, 4 Q wide, is staged in two steps so that all of a
// thread's loads are in flight at once: load_tile reads the thread's share
// into registers (element k: row (tid + k NT) / Q, columns from
// 4 ((tid + k NT) % Q); zeros from row `valid` on), store_tile writes it
// split into T planes (rows below `rows`, each scaled by rowscale[row]
// when given).
template <int ITER, typename F>
__device__ __forceinline__ void load_tile(float4 (&v)[ITER], int Q, int valid, F at) {
#pragma unroll
  for (int k = 0; k < ITER; ++k) {
    const int i = threadIdx.x + k * NT, r = i / Q;
    v[k] = r < valid ? at(r, i % Q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int T, int ITER>
__device__ __forceinline__ void store_tile(const float4 (&v)[ITER], int Q, int rows,
                                           bf16* planes, int plane, int stride,
                                           const float* rowscale = nullptr) {
#pragma unroll
  for (int k = 0; k < ITER; ++k) {
    const int i = threadIdx.x + k * NT, r = i / Q;
    if (r < rows)
      put4<T>(planes, plane, r * stride + 4 * (i % Q),
           rowscale ? scale4(v[k], rowscale[r]) : v[k]);
  }
}

// four columns of a B or C row (zeros past N)
__device__ __forceinline__ float4 ld_bc(const float* row, int q, int N) {
  return 4 * q < N ? *reinterpret_cast<const float4*>(row + 4 * q)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
}

// warp 0's share of a chunk's dt: lane l owns tokens 2l and 2l+1 (0 past c)
__device__ __forceinline__ float2 load_dt(const float* dtb, long long sds, int c) {
  const int t0 = 2 * threadIdx.x, t1 = t0 + 1;
  return make_float2(t0 < c ? dtb[t0 * sds] : 0.f, t1 < c ? dtb[t1 * sds] : 0.f);
}

struct Args {
  const float *x, *dt, *A, *Bm, *Cm;
  float *y, *state, *scores, *decay, *states;
  int B, S, H, P, G, N, chunk, nz, cp, xvec;
  long long sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg;
};

// ---- (a) scores = C B^T, once per (chunk, group) --------------------------
// One block per (chunk, group x 16-row tile rt, batch row), y = H + 4 g +
// rt of the chunk kernel's grid: warp w computes the 16 x 16 tile (rt, w)
// for w <= rt.
template <int NP, int T>
__device__ __forceinline__ void scores_block(const Args& a, bf16* Cs) {
  bf16* Bs = Cs + T * 16 * Cfg<NP, T>::RS;  // Cs: C rows 16 rt .. 16 rt + 15
  constexpr int RS = Cfg<NP, T>::RS, Q = NP / 4, IT = CMAX * Q / NT;
  const int z = blockIdx.x, b = blockIdx.z;
  const int g = (blockIdx.y - a.H) / 4, rt = (blockIdx.y - a.H) % 4;
  if (16 * rt >= a.chunk) return;
  const long long s0 = (long long)z * a.chunk;
  const int rows = 16 * rt + 16;
  {
    const float* cb = a.Cm + b * a.scb + (s0 + 16 * rt) * a.scs + g * a.scg;
    const float* bb = a.Bm + b * a.sbb + s0 * a.sbs + g * a.sbg;
    float4 cv[(16 * Q + NT - 1) / NT], bv[IT];
    load_tile(cv, Q, min(a.chunk - 16 * rt, 16),
              [&](int r, int q) { return ld_bc(cb + r * a.scs, q, a.N); });
    load_tile(bv, Q, min(a.chunk, rows),
              [&](int r, int q) { return ld_bc(bb + r * a.sbs, q, a.N); });
    store_tile<T>(cv, Q, 16, Cs, 16 * RS, RS);
    store_tile<T>(bv, Q, rows, Bs, Cfg<NP, T>::NTILE, RS);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp > rt) return;
  float acc[2][4] = {};
  const uint32_t cbase = smem_u32(Cs), bbase = smem_u32(Bs);
#pragma unroll
  for (int ks = 0; ks < NP / 16; ++ks) {
    uint32_t af[T][4], bf[T][4];
#pragma unroll
    for (int k = 0; k < T; ++k) {
      ldsm_x4(cbase + 2 * (k * 16 * RS + ((lane & 7) + ((lane >> 3) & 1) * 8) * RS
                           + 16 * ks + ((lane >> 4) & 1) * 8), af[k]);
      ldsm_x4(bbase + 2 * (k * Cfg<NP, T>::NTILE
                           + (16 * warp + (lane & 7) + ((lane >> 4) & 1) * 8) * RS
                           + 16 * ks + ((lane >> 3) & 1) * 8), bf[k]);
    }
    uint32_t b0[T], b1[T], b2[T], b3[T];
#pragma unroll
    for (int k = 0; k < T; ++k) {
      b0[k] = bf[k][0]; b1[k] = bf[k][1]; b2[k] = bf[k][2]; b3[k] = bf[k][3];
    }
    mma_terms<T>(acc[0], af, b0, b1);
    mma_terms<T>(acc[1], af, b2, b3);
  }
  float* out = a.scores + (((long long)b * a.nz + z) * a.G + g) * a.cp * a.cp;
  const int t = 16 * rt + lane / 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = 16 * warp + 8 * hf + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + t * a.cp + s) = make_float2(acc[hf][0], acc[hf][1]);
    *reinterpret_cast<float2*>(out + (t + 8) * a.cp + s) =
        make_float2(acc[hf][2], acc[hf][3]);
  }
}

// ---- (b) the chunk's own end state, and exp(acum_last) --------------------
// One block per (chunk, head, batch row), y = h of the chunk kernel's grid.
template <int NP, int T>
__device__ __forceinline__ void states_block(const Args& a, bf16* Xs) {  // Xs: x * w, [s][p]
  bf16* Bs = Xs + T * Cfg<NP, T>::XTILE;  // B, [s][n]
  float* acum = reinterpret_cast<float*>(Bs + T * Cfg<NP, T>::NTILE);
  float* wts = acum + CMAX;  // dt_s, then w_s = exp(acum_last - acum_s) dt_s
  constexpr int RS = Cfg<NP, T>::RS;
  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int c = a.chunk, P = a.P;
  const long long s0 = (long long)z * c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  constexpr int Q = NP / 4, IT = CMAX * Q / NT, ITX = CMAX * PMAX / 4 / NT;
  const float* xb = a.x + b * a.sxb + s0 * a.sxs + h * a.sxh;
  const float* bb = a.Bm + b * a.sbb + s0 * a.sbs + g * a.sbg;
  float4 xv[ITX], bv[IT];
  load_tile(xv, P / 4, c, [&](int r, int q) { return ld4(xb + r * a.sxs + 4 * q, a.xvec); });
  load_tile(bv, Q, c, [&](int r, int q) { return ld_bc(bb + r * a.sbs, q, a.N); });
  if (warp == 0) {
    chunk_prefix(load_dt(a.dt + b * a.sdb + s0 * a.sds + h * a.sdh, a.sds, c), a.A[h], c, acum,
                 wts);
    __syncwarp();
    const float last = acum[c - 1];
    for (int t = lane; t < CMAX; t += 32) wts[t] = t < c ? expf(last - acum[t]) * wts[t] : 0.f;
    if (lane == 0) a.decay[((long long)b * a.nz + z) * a.H + h] = expf(last);
  }
  __syncthreads();
  store_tile<T>(xv, P / 4, a.cp, Xs, Cfg<NP, T>::XTILE, XS, wts);
  store_tile<T>(bv, Q, a.cp, Bs, Cfg<NP, T>::NTILE, RS);
  __syncthreads();

  // state[p][n] = sum_s (x w)[s][p] B[s][n]: A = (x w)^T, B = B, both read
  // transposed by ldmatrix.  Warps split the n-tile pairs (WP ways) and the
  // p-tiles (WM ways).
  constexpr int NPAIR = NP / 16;
  constexpr int WP = NPAIR < 4 ? NPAIR : 4;
  constexpr int WM = 4 / WP;
  constexpr int UP = NPAIR / WP;  // n-tile pairs per warp
  const int wp = warp % WP, wm = warp / WP;
  const int MT = P / 16;
  float acc[4][UP][2][4] = {};
  const uint32_t xbase = smem_u32(Xs), bbase = smem_u32(Bs);
  for (int ks = 0; ks < a.cp / 16; ++ks) {
    uint32_t bf[UP][T][4];
#pragma unroll
    for (int u = 0; u < UP; ++u)
#pragma unroll
      for (int k = 0; k < T; ++k)
        ldsm_x4_trans(bbase + 2 * (k * Cfg<NP, T>::NTILE
                                   + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * RS
                                   + 16 * (wp + WP * u) + ((lane >> 4) & 1) * 8), bf[u][k]);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int mt = wm + WM * v;
      if (mt >= MT) break;
      uint32_t af[T][4];
#pragma unroll
      for (int k = 0; k < T; ++k)
        ldsm_x4_trans(xbase + 2 * (k * Cfg<NP, T>::XTILE
                                   + (16 * ks + (lane & 7) + ((lane >> 4) & 1) * 8) * XS
                                   + 16 * mt + ((lane >> 3) & 1) * 8), af[k]);
#pragma unroll
      for (int u = 0; u < UP; ++u) {
        uint32_t b0[T], b1[T], b2[T], b3[T];
#pragma unroll
        for (int k = 0; k < T; ++k) {
          b0[k] = bf[u][k][0]; b1[k] = bf[u][k][1]; b2[k] = bf[u][k][2]; b3[k] = bf[u][k][3];
        }
        mma_terms<T>(acc[v][u][0], af, b0, b1);
        mma_terms<T>(acc[v][u][1], af, b2, b3);
      }
    }
  }
  float* out = a.states + (((long long)b * a.nz + z) * a.H + h) * P * a.N;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int mt = wm + WM * v;
    if (mt >= MT) break;
    const int p = 16 * mt + lane / 4;
#pragma unroll
    for (int u = 0; u < UP; ++u)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = 16 * (wp + WP * u) + 8 * hf + 2 * (lane % 4);
        if (n >= a.N) continue;
        *reinterpret_cast<float2*>(out + (long long)p * a.N + n) =
            make_float2(acc[v][u][hf][0], acc[v][u][hf][1]);
        *reinterpret_cast<float2*>(out + (long long)(p + 8) * a.N + n) =
            make_float2(acc[v][u][hf][2], acc[v][u][hf][3]);
      }
  }
}

// (a) and (b) in one launch: blocks y < H take (b), the rest (a)
template <int NP, int T>
__global__ void __launch_bounds__(NT) ssd_scan_chunk_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  if (blockIdx.y < a.H)
    states_block<NP, T>(a, reinterpret_cast<bf16*>(smem4));
  else
    scores_block<NP, T>(a, reinterpret_cast<bf16*>(smem4));
}

// ---- (c) the state pass across chunks --------------------------------------
// states[z] (a chunk's own end state) becomes h_in[z], the state entering
// chunk z, for z >= 1 (h_in[0] = 0 is never read); the carry after the last
// chunk is the final state.
__global__ void __launch_bounds__(256) ssd_scan_pass_kernel(const Args a) {
  const long long pn4 = (long long)a.P * a.N / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)a.B * a.H * pn4) return;
  const long long bh = i / pn4, r = i % pn4;
  const int b = (int)(bh / a.H), h = (int)(bh % a.H);
  float4* st = reinterpret_cast<float4*>(a.states) + ((long long)b * a.nz * a.H + h) * pn4 + r;
  const float* dec = a.decay + (long long)b * a.nz * a.H + h;
  const long long zs = (long long)a.H * pn4;  // float4s from one chunk's state to the next
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z0 = 0; z0 < a.nz; z0 += PASS_BATCH) {
    float4 v[PASS_BATCH];
    float d[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (z0 + k < a.nz) {
        v[k] = st[(z0 + k) * zs];
        d[k] = dec[(long long)(z0 + k) * a.H];
      }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (z0 + k < a.nz) {
        if (z0 + k > 0) st[(z0 + k) * zs] = carry;
        carry = make_float4(fmaf(d[k], carry.x, v[k].x), fmaf(d[k], carry.y, v[k].y),
                            fmaf(d[k], carry.z, v[k].z), fmaf(d[k], carry.w, v[k].w));
      }
  }
  reinterpret_cast<float4*>(a.state)[bh * pn4 + r] = carry;
}

// ---- (d) y = exp(acum_t) C h_in^T + M x ------------------------------------
template <int NP, int T>
__global__ void __launch_bounds__(NT) ssd_scan_y_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  bf16* Xs = reinterpret_cast<bf16*>(smem4);  // x, [s][p]
  bf16* Hs = Xs + T * Cfg<NP, T>::XTILE;      // h_in, [p][n]
  float* acum = reinterpret_cast<float*>(Hs + T * Cfg<NP, T>::NTILE);
  float* dts = acum + CMAX;
  constexpr int RS = Cfg<NP, T>::RS;
  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int c = a.chunk, P = a.P, N = a.N;
  const long long s0 = (long long)z * c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  constexpr int Q = NP / 4, IT = PMAX * Q / NT, ITX = CMAX * PMAX / 4 / NT;
  {
    const float* xb = a.x + b * a.sxb + s0 * a.sxs + h * a.sxh;
    const float* hb = a.states + (((long long)b * a.nz + z) * a.H + h) * P * N;
    float4 xv[ITX], hv[IT];
    load_tile(xv, P / 4, c, [&](int r, int q) { return ld4(xb + r * a.sxs + 4 * q, a.xvec); });
    if (z > 0) load_tile(hv, Q, P, [&](int r, int q) { return ld_bc(hb + r * N, q, N); });
    if (warp == 0)
      chunk_prefix(load_dt(a.dt + b * a.sdb + s0 * a.sds + h * a.sdh, a.sds, c), a.A[h], c,
                   acum, dts);
    store_tile<T>(xv, P / 4, a.cp, Xs, Cfg<NP, T>::XTILE, XS);
    if (z > 0) store_tile<T>(hv, Q, P, Hs, Cfg<NP, T>::NTILE, RS);
  }
  // this thread's rows t0, t1 of the chunk; its pairs of fragment columns
  // start at q2 and q2 + 8.  Its C values (the A operand of the inter-chunk
  // product, k = n) and its scores (the intra-chunk product's, k = s <= t)
  // come from device memory, all requested before the barrier.
  const int t0 = 16 * warp + lane / 4, t1 = t0 + 8;
  const int q2 = 2 * (lane % 4);
  float2 cf[NP / 16][4], sf[4][4];  // e: (t0, k) (t1, k) (t0, k + 8) (t1, k + 8)
  const float2 zero2 = make_float2(0.f, 0.f);
  if (16 * warp < c) {
    const float* cb = a.Cm + b * a.scb + s0 * a.scs + g * a.scg;
    const float* sc = a.scores + (((long long)b * a.nz + z) * a.G + g) * a.cp * a.cp;
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = (e & 1) ? t1 : t0, n = 16 * ks + q2 + 8 * (e >> 1);
        cf[ks][e] = (z > 0 && t < c && n < N)
                        ? *reinterpret_cast<const float2*>(cb + t * a.scs + n) : zero2;
      }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = (e & 1) ? t1 : t0, s = 16 * ks + q2 + 8 * (e >> 1);
        sf[ks][e] = (ks <= warp && t < c && s <= t)
                        ? *reinterpret_cast<const float2*>(sc + t * a.cp + s) : zero2;
      }
  }
  __syncthreads();
  if (16 * warp >= c) return;

  const int npair = P / 16;
  float acc[4][2][4] = {};
  const uint32_t xbase = smem_u32(Xs), hbase = smem_u32(Hs);

  if (z > 0) {
    // inter-chunk: C split in registers; h_in (k = n contiguous per p) from
    // shared memory
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks) {
      uint32_t af[T][4];
      {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t tt[T];
          split_pair<T>(cf[ks][e].x, cf[ks][e].y, tt);
#pragma unroll
          for (int k = 0; k < T; ++k) af[k][e] = tt[k];
        }
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (jp >= npair) break;
        uint32_t bf[T][4];
#pragma unroll
        for (int k = 0; k < T; ++k)
          ldsm_x4(hbase + 2 * (k * Cfg<NP, T>::NTILE
                               + (16 * jp + (lane & 7) + ((lane >> 4) & 1) * 8) * RS
                               + 16 * ks + ((lane >> 3) & 1) * 8), bf[k]);
        uint32_t b0[T], b1[T], b2[T], b3[T];
#pragma unroll
        for (int k = 0; k < T; ++k) {
          b0[k] = bf[k][0]; b1[k] = bf[k][1]; b2[k] = bf[k][2]; b3[k] = bf[k][3];
        }
        mma_terms<T>(acc[jp][0], af, b0, b1);
        mma_terms<T>(acc[jp][1], af, b2, b3);
      }
    }
    const float e0 = t0 < c ? expf(acum[t0]) : 0.f;
    const float e1 = t1 < c ? expf(acum[t1]) : 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        acc[jp][hf][0] *= e0;
        acc[jp][hf][1] *= e0;
        acc[jp][hf][2] *= e1;
        acc[jp][hf][3] *= e1;
      }
  }

  // intra-chunk: M (rows t, k = s <= t) formed in registers from the scores,
  // hidden pairs 0 by selection; x (k = s rows) read transposed
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks > warp) break;
    uint32_t af[T][4];
    {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = (e & 1) ? t1 : t0, s = 16 * ks + q2 + 8 * (e >> 1);
        float m0 = 0.f, m1 = 0.f;
        if (t < c && s <= t) {
          m0 = sf[ks][e].x * expf(acum[t] - acum[s]) * dts[s];
          if (s + 1 <= t) m1 = sf[ks][e].y * expf(acum[t] - acum[s + 1]) * dts[s + 1];
        }
        uint32_t tt[T];
        split_pair<T>(m0, m1, tt);
#pragma unroll
        for (int k = 0; k < T; ++k) af[k][e] = tt[k];
      }
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp >= npair) break;
      uint32_t bf[T][4];
#pragma unroll
      for (int k = 0; k < T; ++k)
        ldsm_x4_trans(xbase + 2 * (k * Cfg<NP, T>::XTILE
                                   + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * XS
                                   + 16 * jp + ((lane >> 4) & 1) * 8), bf[k]);
      uint32_t b0[T], b1[T], b2[T], b3[T];
#pragma unroll
      for (int k = 0; k < T; ++k) {
        b0[k] = bf[k][0]; b1[k] = bf[k][1]; b2[k] = bf[k][2]; b3[k] = bf[k][3];
      }
      mma_terms<T>(acc[jp][0], af, b0, b1);
      mma_terms<T>(acc[jp][1], af, b2, b3);
    }
  }

  // y rows t0, t1 (< c), columns 16jp + 8hf + q2, +1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r ? t1 : t0;
    if (t >= c) continue;
    float* yrow = a.y + (((long long)b * a.S + s0 + t) * a.H + h) * P;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp >= npair) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(yrow + 16 * jp + 8 * hf + q2) =
            make_float2(acc[jp][hf][2 * r], acc[jp][hf][2 * r + 1]);
    }
  }
}

template <typename K>
cudaError_t launch_smem(K kern, dim3 grid, int threads, int smem, cudaStream_t stream,
                        const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NP, int T>
cudaError_t launch_all(const Args& a, cudaStream_t stream) {
  cudaError_t err = launch_smem(ssd_scan_chunk_kernel<NP, T>, dim3(a.nz, a.H + 4 * a.G, a.B), NT,
                                Cfg<NP, T>::CHUNK_SMEM, stream, a);
  if (err != cudaSuccess) return err;
  const long long n4 = (long long)a.B * a.H * a.P * a.N / 4;
  err = launch_smem(ssd_scan_pass_kernel, dim3((unsigned)((n4 + 255) / 256)), 256, 0, stream, a);
  if (err != cudaSuccess) return err;
  return launch_smem(ssd_scan_y_kernel<NP, T>, dim3(a.nz, a.H, a.B), NT, Cfg<NP, T>::CHUNK_SMEM,
                     stream, a);
}

template <int T>
cudaError_t dispatch_n(const Args& a, cudaStream_t s) {
  switch (a.N) {
    case 8:
    case 16: return launch_all<16, T>(a, s);
    case 32: return launch_all<32, T>(a, s);
    case 64: return launch_all<64, T>(a, s);
    case 128: return launch_all<128, T>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], A [H], Bm / Cm [B, S, G, N], all fp32;
// element strides (batch, sequence, head or group) of x, dt, Bm, Cm in that
// order, the last dim dense (B and C rows 16-byte aligned).  y [B, S, H, P]
// contiguous fp32, state [B, H, P, N] fp32 contiguous.  Scratch, contiguous
// fp32: scores [B, S/chunk, G, cp, cp] (cp = chunk rounded up to 16), decay
// [B, S/chunk, H], states [B, S/chunk, H, P, N].  P in {16, 32, 64}, N in
// {8, 16, 32, 64, 128}, 1 <= chunk <= 64 dividing S.  terms: bf16 terms of
// every fp32 operand, 2 or 3.  Launches three kernels on the stream; returns
// the first launch error (cudaGetLastError()).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, void* y, void* state, void* scores, void* decay,
                        void* states, int B, int S, int H, int P, int G, int N, int chunk,
                        long long sxb, long long sxs, long long sxh, long long sdb,
                        long long sds, long long sdh, long long sbb, long long sbs,
                        long long sbg, long long scb, long long scs, long long scg,
                        int terms, void* stream) {
  if (P % 16 || P < 16 || P > PMAX || chunk < 1 || chunk > CMAX || S % chunk || G < 1 ||
      H % G || terms < 2 || terms > 3)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = static_cast<const float*>(Bm);
  a.Cm = static_cast<const float*>(Cm);
  a.y = static_cast<float*>(y);
  a.state = static_cast<float*>(state);
  a.scores = static_cast<float*>(scores);
  a.decay = static_cast<float*>(decay);
  a.states = static_cast<float*>(states);
  a.B = B; a.S = S; a.H = H; a.P = P; a.G = G; a.N = N; a.chunk = chunk;
  a.nz = S / chunk;
  a.cp = (chunk + 15) / 16 * 16;
  // x rows as float4 when every row starts 16-byte aligned
  a.xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && sxb % 4 == 0 && sxs % 4 == 0 &&
           sxh % 4 == 0;
  a.sxb = sxb; a.sxs = sxs; a.sxh = sxh;
  a.sdb = sdb; a.sds = sds; a.sdh = sdh;
  a.sbb = sbb; a.sbs = sbs; a.sbg = sbg;
  a.scb = scb; a.scs = scs; a.scg = scg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(terms == 2 ? dispatch_n<2>(a, s) : dispatch_n<3>(a, s));
}
