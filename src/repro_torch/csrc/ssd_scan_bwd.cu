// The Mamba-2 SSD chunked scan's gradients on Hopper's tensor cores
// (sm_90a), plain C interface for ctypes.
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
// and on acum_last their sum plus E_last <g, h_in>.  Summed over a group's
// heads, the intra-chunk terms of dB and dC are one product each: with M =
// sum_h L dt D (c x c), dB gets M^T C and dC gets M B.
//
// What bounds it on an H100: the function reads x, dy, dt, B, C (and
// dstate) and writes dx, ddt, dA, dB and dC once: at mamba2-370m's train row
// (B 4, S 4096, H 32, P 64, G 1, N 128, chunk 64) 440 MB, 0.1315 ms at 3.35
// TB/s, against 5.6e10 flops of products (0.057 ms at 989 TFLOP/s in bf16):
// bound by bytes.
//
// Design: three launches of one C call on the caller's stream.
//   (a) ssd_bwd_state_kernel, one block per (16 MI rows of P, direction,
//       head, batch row), four warps: walks the chunks in order (direction
//       0) or in reverse (1), carrying its [16 MI, N] slice of the state in
//       registers as mma accumulators.  Per chunk it computes on the tensor
//       cores the chunk's own end state (x w)^T B (w_s = W_s dt_s) or its
//       term of the state gradient (E dy)^T C, writes the carry before the
//       chunk (h_in[z], or g[z] from g[last] = dstate) and folds the chunk
//       in: carry = exp(acum_last) carry + term.  Both walks run at once, in
//       different blocks; every warp takes the chunk's prefix sum itself (one
//       barrier a chunk).  MI = 4 (all of P = 64) at N >= 64 where that
//       leaves a block for every SM (mamba2's train row: 256 blocks), else 2
//       (1 at P = 16).
//   (b) ssd_bwd_chunk_kernel, one block per (chunk, group x head slice,
//       batch row), eight warps (each 16 rows of the chunk and half of the
//       columns; the two warps of a scheduler take rows r and 3 - r, so the
//       causal work is even): S = C B^T once, then it walks the slice's heads
//       in order.  A head's x and dy are split once into bf16 planes, which
//       the products read with ldmatrix; then D = dy x^T, in fp32 L S D (its
//       row and column sums and diagonal) and M += L dt D, dx = dt_s ((L S)^T
//       dy + W_s B g^T), dB += W dt (x g) and dC += E (dy h_in) (g and h_in
//       in tiles of at most 64 columns of N, split as the fragments are
//       built), and one warp's d(acum) scan for ddt and the chunk's share of
//       dA.  After the last head, dB += M^T C and dC += M B; the slice's dB
//       and dC go to scratch.  A slice holds enough heads that the launch has
//       about two blocks per SM (whole groups when there are many chunks:
//       mamba2's train row takes 2 slices of 16 heads, its serving row B 1 x
//       2048 8 slices of 4).  C is read from device memory where it is used
//       (the L2 holds it), to leave shared memory to the rest.
//   (c) ssd_bwd_reduce_kernel: dB and dC summed over a group's head slices
//       and dA over every chunk and batch row, in a fixed order.
// Loads in flight: (a) loads the next chunk's tiles with cp.async while it
// multiplies the current one; (b) loads the next head's x, dy and dt as soon
// as the current head's are split, and the next (g, h_in) tile pair while it
// multiplies the current pair.
//
// Scratch at mamba2's train row, through device memory per call: h_in and g
// [B, S/c, H, P, N] fp32, 268.4 MB each, written once by (a) and read once
// by (b): 1,073.7 MB; the slices' dB and dC [B, S, G, slices, N], 16.8 MB
// each, written and read once: 67.1 MB; dA's shares 32 KB.  1.14 GB in all,
// where the CUDA-core kernel of PR 25 moved 3.22 GB (its chunk states and
// their gradients written, read and written by the passes, read again:
// 2,147 MB; every head's dB and dC before the group sum, [B, S, H, N]:
// 1,074 MB).
//
// Numerics (the term count is settled by tests/test_torch_ssd_bwd_split.py,
// which emulates this arithmetic on the CPU against the JAX package):
//   * every product is mma.sync m16n8k16 (bf16 operands, fp32
//     accumulators): every fp32 operand -- x and dy (and in (a) x w and E
//     dy), B, C, the masked L S and M, h_in and g -- split into T = 3 bf16
//     terms, and a product runs the term pairs i + j < 3 (six products for
//     each fp32 one); (b)'s row weights W dt and E scale the rows of its
//     products' sums.  The emulation reads 0.007-0.23 of the CPU gate (2e-5
//     of each gradient's largest |value|), the plain fp32 backward's own
//     distance to the sequential oracle; two terms read 0.42-0.93 of it,
//     6-51x the plain backward;
//   * the d(acum) row and column sums, the reverse prefix sum, the passes
//     across chunks and every exponential are fp32 on the CUDA cores;
//   * every decay is masked by SELECTION: exp(acum_t - acum_s) is taken only
//     for s <= t, and the decay is never factored as exp(acum_t)
//     exp(-acum_s); every exponent is <= 0, so no inf meets a zero (JAX's
//     jax.grad of _ssd_chunked gives NaN there once a chunk's sum of dt*|A|
//     passes ~88: ROADMAP C.7);
//   * no atomics and a fixed order of summation: two calls give
//     bitwise-equal gradients.
//
// Shapes: P in {16, 32, 64}, N in {8, 16, 32, 64, 128} (N = 8 padded to 16,
// P to 64 in (b), a chunk to 64 rows, all with zeros in shared memory), 1 <=
// c <= 64 dividing S, G dividing H; batch / sequence /
// head strides on x, dt, B, C, the last dim dense and the rows of x, B and C
// 16-byte aligned; dy, dstate and every output contiguous.

#include "ssd_common.cuh"  // the bf16 split, mma_terms, the chunk prefix

namespace {

constexpr int T = 3;  // BWD_TERMS: bf16 terms of every fp32 operand
constexpr int CMAX = 64;      // longest chunk
constexpr int PMAX = 64;      // widest head
constexpr int RP = PMAX + 4;  // row stride (floats) of a staged [64][<= 64] tile
constexpr int NT1 = 128;      // threads of (a)
constexpr int NT2 = 256;      // threads of (b)

struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *dy, *dstate;
  float *dx, *ddt, *dA, *dBm, *dCm;
  float *hin, *gst, *dBp, *dCp, *dAp;
  int B, S, H, P, G, N, chunk, nz, hps, nsl;
  long long sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg;
};

// 4-byte async copy; a zero source size fills the destination with zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// waits until at most n of this thread's cp.async groups are pending (at
// most 3 from n >= 3 on)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else if (n == 2)
    cp_async_wait<2>();
  else
    cp_async_wait<3>();
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// An A fragment (16 x 16) as T bf16 terms, from f(m, k) = {A(m, k),
// A(m, k + 1)} at local row m < 16 and even column k < 16
template <typename F>
__device__ __forceinline__ void frag_a(uint32_t (&a)[T][4], F f) {
  const int lane = threadIdx.x % 32, m = lane / 4, k = 2 * (lane % 4);
  const float2 v[4] = {f(m, k), f(m + 8, k), f(m, k + 8), f(m + 8, k + 8)};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t t[T];
    split_pair<T>(v[e].x, v[e].y, t);
#pragma unroll
    for (int i = 0; i < T; ++i) a[i][e] = t[i];
  }
}

// A B fragment (16 x 8) as T bf16 terms, from f(k, n) = {B(k, n),
// B(k + 1, n)} at even local row k < 16 and column n < 8
template <typename F>
__device__ __forceinline__ void frag_b(uint32_t (&b0)[T], uint32_t (&b1)[T], F f) {
  const int lane = threadIdx.x % 32, n = lane / 4, k = 2 * (lane % 4);
  const float2 v0 = f(k, n), v1 = f(k + 8, n);
  split_pair<T>(v0.x, v0.y, b0);
  split_pair<T>(v1.x, v1.y, b1);
}

// ---- (a) the chunk states and their gradients, carried across chunks ------
// Shared memory: two stages of ([64][16 MI] rows of x or dy, [64][NP] rows of
// B or C, dt), every row from the chunk's length on zeros.
template <int NP, int MI>
struct StateSmem {
  static constexpr int RU = 16 * MI + 4, RV = NP + 4;
  static constexpr int STAGE = CMAX * RU + CMAX * RV + CMAX;  // floats
  static constexpr int BYTES = 2 * STAGE * 4;
};

// MI: 16-row tiles of P a block carries (1, 2 or 4; see launch_all)
template <int NP, int MI>
__global__ void __launch_bounds__(NT1) ssd_bwd_state_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  using Sm = StateSmem<NP, MI>;
  constexpr int RU = Sm::RU, RV = Sm::RV, STAGE = Sm::STAGE;
  // a warp's tiles of the [16 MI, NP] state: m-tiles m_base + m_step mi
  // (mi < WM), n-tiles n_base + 4 j (j < NJ); at NP 16 (two n-tiles) a warp
  // takes one n-tile and every other pair of m-tiles
  constexpr int NPT = NP / 8;
  constexpr bool ONE = NPT < 4;
  constexpr int WM = ONE ? (MI * NPT / 4 > 0 ? MI * NPT / 4 : 1) : MI, NJ = ONE ? 1 : NPT / 4;
  constexpr int m_step = ONE ? 4 / NPT : 1;
  const int p0 = 16 * MI * (blockIdx.x / 2), rev = blockIdx.x % 2, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int c = a.chunk, N = a.N, P = a.P;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = lane / 4, q2 = 2 * (lane % 4);
  const int m_base = ONE ? warp / NPT : 0, n_base = ONE ? warp % NPT : warp;
  const int nj = !ONE || warp < MI * NPT ? NJ : 0;  // this warp's n-tiles
  // U: x or dy (16 MI columns), V: B or C
  const float* ub = rev ? a.dy + (long long)b * a.S * a.H * P + (long long)h * P + p0
                        : a.x + b * a.sxb + h * a.sxh + p0;
  const long long us = rev ? (long long)a.H * P : a.sxs;
  const float* vb = rev ? a.Cm + b * a.scb + g * a.scg : a.Bm + b * a.sbb + g * a.sbg;
  const long long vs = rev ? a.scs : a.sbs;
  const float* db = a.dt + b * a.sdb + h * a.sdh;

  auto issue = [&](int z, int stage) {
    float* U = sm + stage * STAGE;
    float* V = U + CMAX * RU;
    float* D = V + CMAX * RV;
    const long long s0 = (long long)z * c;
    for (int i = tid; i < CMAX * 4 * MI; i += NT1) {
      const int row = i / (4 * MI), q = i % (4 * MI);
      const bool ok = row < c;
      cp_async16(smem_u32(U + row * RU + 4 * q), ok ? ub + (s0 + row) * us + 4 * q : ub, ok);
    }
    for (int i = tid; i < CMAX * (NP / 4); i += NT1) {
      const int row = i / (NP / 4), q = i % (NP / 4);
      const bool ok = row < c && 4 * q < N;
      cp_async16(smem_u32(V + row * RV + 4 * q), ok ? vb + (s0 + row) * vs + 4 * q : vb, ok);
    }
    for (int t = tid; t < CMAX; t += NT1) {
      const bool ok = t < c;
      cp_async4(smem_u32(D + t), ok ? db + (s0 + t) * a.sds : db, ok);
    }
    cp_async_commit();
  };

  // the carry: rows p0 + 16 (m_base + m_step mi) + r0 (+ 8), columns 8 (n_base
  // + 4 j) + q2 (+ 1); the reverse walk starts from dstate
  float carry[WM][NJ][4];
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = 8 * (n_base + 4 * j) + q2;
      float2 lo = make_float2(0.f, 0.f), hi = lo;
      if (rev && a.dstate != nullptr && j < nj && n < N) {
        const float* ds =
            a.dstate + (((long long)b * a.H + h) * P + p0 + 16 * (m_base + m_step * mi) + r0) * N + n;
        lo = ld2(ds);
        hi = ld2(ds + 8 * N);
      }
      carry[mi][j][0] = lo.x;
      carry[mi][j][1] = lo.y;
      carry[mi][j][2] = hi.x;
      carry[mi][j][3] = hi.y;
    }
  const float a_h = a.A[h];
  float* outb = (rev ? a.gst : a.hin) + (((long long)b * a.nz * a.H + h) * P + p0 + r0) * N;
  const long long zstride = (long long)a.H * P * N;
  issue(rev ? a.nz - 1 : 0, 0);
  for (int it = 0; it < a.nz; ++it) {
    const int z = rev ? a.nz - 1 - it : it, stage = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // this chunk's tiles are in; every warp is done with the last one's
    if (it + 1 < a.nz) issue(rev ? z - 1 : z + 1, stage ^ 1);
    const float* U = sm + stage * STAGE;
    const float* V = U + CMAX * RU;
    const float* D = V + CMAX * RV;
    // every warp its own prefix sum: lane l holds tokens 2l, 2l + 1, and the
    // row weights w_s = W_s dt_s (forward) or E_t (reverse)
    const float2 d2 = ld2(D + 2 * lane);
    const float2 ac = prefix_pair(d2, a_h, c);
    const float last = __shfl_sync(0xffffffffu, (c - 1) % 2 ? ac.y : ac.x, (c - 1) / 2);
    float2 w;
    if (rev) {
      w = make_float2(2 * lane < c ? expf(ac.x) : 0.f, 2 * lane + 1 < c ? expf(ac.y) : 0.f);
    } else {
      w = make_float2(2 * lane < c ? expf(last - ac.x) * d2.x : 0.f,
                      2 * lane + 1 < c ? expf(last - ac.y) * d2.y : 0.f);
    }

    // term[p][n] = sum_s (U w)[s][p] V[s][n]: A = (U w)^T, B = V
    float acc[WM][NJ][4] = {};
#pragma unroll
    for (int ks = 0; ks < CMAX / 16; ++ks) {
      // the weights of rows 16 ks + q2 (+ 1) and 16 ks + q2 + 8 (+ 1)
      const int src = 8 * ks + lane % 4;
      const float2 wl = make_float2(__shfl_sync(0xffffffffu, w.x, src),
                                    __shfl_sync(0xffffffffu, w.y, src));
      const float2 wh = make_float2(__shfl_sync(0xffffffffu, w.x, src + 4),
                                    __shfl_sync(0xffffffffu, w.y, src + 4));
      uint32_t bf[NJ][2][T];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j < nj)
          frag_b(bf[j][0], bf[j][1], [&](int k, int n) {
            const float* v = V + (16 * ks + k) * RV + 8 * (n_base + 4 * j) + n;
            return make_float2(v[0], v[RV]);
          });
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {
        uint32_t af[T][4];
        frag_a(af, [&](int m, int k) {
          const int s = 16 * ks + k;
          const float2 ws = k < 8 ? wl : wh;
          const float* u = U + s * RU + 16 * (m_base + m_step * mi) + m;
          return make_float2(u[0] * ws.x, u[RU] * ws.y);
        });
        mma_terms<T, NJ>(acc[mi], af, bf, nj);
      }
    }
    // the carry before this chunk is h_in[z] (or g[z]); then fold the chunk in
    const float d = expf(last);
    float* out = outb + z * zstride;
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = 8 * (n_base + 4 * j) + q2;
        if (j < nj && n < N) {
          float* o = out + 16 * (m_base + m_step * mi) * N + n;
          *reinterpret_cast<float2*>(o) = make_float2(carry[mi][j][0], carry[mi][j][1]);
          *reinterpret_cast<float2*>(o + 8 * N) = make_float2(carry[mi][j][2], carry[mi][j][3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) carry[mi][j][e] = fmaf(d, carry[mi][j][e], acc[mi][j][e]);
      }
  }
}

// ---- (b) each chunk's gradients, a group's heads in turn ------------------
constexpr int XS = PMAX + 8;       // row stride (bf16) of an x or dy plane
constexpr int PLANE = CMAX * XS;   // one bf16 term of an x or dy tile

// ldmatrix of two 8 x 8 matrices (lanes 0-15 give the rows)
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// from T planes of a [64][XS] bf16 tile: an A fragment (rows m0.., columns
// k0..), the B fragment of an n-tile stored [n][k] (n0.., k0..), and the B
// fragments of two n-tiles stored [k][n] (k0.., n0.. and n0 + 8..)
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[T][4], const bf16* planes, int m0, int k0) {
  const int lane = threadIdx.x % 32;
  const uint32_t base = smem_u32(planes) + 2 * ((m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                                                k0 + ((lane >> 4) & 1) * 8);
#pragma unroll
  for (int k = 0; k < T; ++k) ldsm_x4(base + 2 * k * PLANE, a[k]);
}
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&b)[2][T], const bf16* planes, int n0, int k0) {
  const int lane = threadIdx.x % 32;
  const uint32_t base =
      smem_u32(planes) + 2 * ((n0 + (lane & 7)) * XS + k0 + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int k = 0; k < T; ++k) ldsm_x2(base + 2 * k * PLANE, b[0][k], b[1][k]);
}
__device__ __forceinline__ void ldsm_b_kn2(uint32_t (&b0)[2][T], uint32_t (&b1)[2][T],
                                           const bf16* planes, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  const uint32_t base = smem_u32(planes) + 2 * ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                                                n0 + ((lane >> 4) & 1) * 8);
#pragma unroll
  for (int k = 0; k < T; ++k) {
    uint32_t r[4];
    ldsm_x4_trans(base + 2 * k * PLANE, r);
    b0[0][k] = r[0];
    b0[1][k] = r[1];
    b1[0][k] = r[2];
    b1[1][k] = r[3];
  }
}

// two neighbouring values of a tile from the sum of its T planes (which is
// the fp32 value but for the last split's residual, below 2^-24 of it)
__device__ __forceinline__ float2 plane_sum(const bf16* planes, int off) {
  float2 v = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(planes + k * PLANE + off);
    v.x += __low2float(t);
    v.y += __high2float(t);
  }
  return v;
}

template <int NP>
struct ChunkSmem {
  static constexpr int RN = NP + 4;
  static constexpr int NW = NP < 64 ? NP : 64;  // columns of N in a g or h_in tile
  static constexpr int RG = NW + 4;             // row stride of a g or h_in tile
  static constexpr int TILE = CMAX * RP;        // one [64][<= 64] fp32 tile
  static constexpr int GT = CMAX * RG;          // one g or h_in tile
  // B; S (then M); x, dy and dt as they land; x and dy as T bf16 planes
  // each; two slots of a (g, h_in) pair; acum, dt, W, E; the partial sums
  static constexpr int FLOATS = CMAX * RN + 3 * TILE + CMAX + T * PLANE + 4 * GT + 4 * CMAX +
                                11 * CMAX + NT2 / 32;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(BYTES <= 232448, "fits one SM's shared memory");
};

template <int NP>
__global__ void __launch_bounds__(NT2, 1) ssd_bwd_chunk_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  using Sm = ChunkSmem<NP>;
  constexpr int RN = Sm::RN, NW = Sm::NW, RG = Sm::RG, TILE = Sm::TILE, GT = Sm::GT;
  constexpr int NPH = NP / NW;  // (g, h_in) tile pairs per head
  constexpr int NJW = NW / 16;  // n-tiles of 8 a warp takes of a tile's NW columns
  float* Bs = reinterpret_cast<float*>(smem4);     // B, [s][n]
  float* Ss = Bs + CMAX * RN;                       // S, then M, [t][s]
  float* Xl = Ss + TILE;                            // x as it lands, [s][p]
  float* DYl = Xl + TILE;                           // dy as it lands, [t][p]
  float* dtb = DYl + TILE;                          // dt as it lands
  bf16* Xp = reinterpret_cast<bf16*>(dtb + CMAX);   // x, T planes [s][p]
  bf16* DYp = Xp + T * PLANE;                       // dy, T planes [t][p]
  float* GH = reinterpret_cast<float*>(DYp + T * PLANE);  // two slots of g, h_in [p][n]
  float* acum = GH + 4 * GT;
  float* dts = acum + CMAX;
  float* Wv = dts + CMAX;                           // exp(acum_last - acum_s)
  float* Ev = Wv + CMAX;                            // exp(acum_t)
  float* rowp = Ev + CMAX;                          // [hf][t]: sum_{s<t} LSD dt_s
  float* colp = rowp + 2 * CMAX;                    // [4 row tiles][s]: sum_{t>s} LSD
  float* diag = colp + 4 * CMAX;                    // LSD[t][t]
  float* xgbp = diag + CMAX;                        // [hf][s]: <g, x_s B_s^T>
  float* vp = xgbp + 2 * CMAX;                      // [hf][t]: E_t (dy_t h_in) . C_t
  float* dotp = vp + 2 * CMAX;                      // [warp]: <g, h_in>

  const int z = blockIdx.x, b = blockIdx.z;
  const int rep = a.H / a.G, g = blockIdx.y / a.nsl, sl = blockIdx.y % a.nsl;
  const int h0 = g * rep + sl * a.hps, nh = min(a.hps, rep - sl * a.hps);
  constexpr int MT = CMAX / 16, KP = PMAX / 16;  // row tiles; k-steps over P
  const int c = a.chunk, P = a.P, N = a.N;
  const long long s0 = (long long)z * c;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // rows 16 r .. 16 r + 15 and half hf of the columns; the warps that share a
  // scheduler (w, w + 4) take rows r and 3 - r, whose causal work adds up
  const int r = warp < 4 ? warp / 2 : 3 - (warp - 4) / 2, hf = warp % 2;
  const int r0 = lane / 4, q2 = 2 * (lane % 4);
  // C is read where it is used, from device memory (the L2 holds it): rows t
  // of this chunk, zeros past the chunk and past N
  const float* Cg = a.Cm + b * a.scb + s0 * a.scs + g * a.scg;
  auto cpair = [&](int t, int n) {
    return t < c && n < N ? ld2(Cg + t * a.scs + n) : make_float2(0.f, 0.f);
  };

  auto issue_b = [&]() {
    const float* bb = a.Bm + b * a.sbb + g * a.sbg;
    for (int i = tid; i < CMAX * (NP / 4); i += NT2) {
      const int row = i / (NP / 4), q = i % (NP / 4);
      const bool ok = row < c && 4 * q < N;
      cp_async16(smem_u32(Bs + row * RN + 4 * q), ok ? bb + (s0 + row) * a.sbs + 4 * q : bb, ok);
    }
    cp_async_commit();
  };
  auto issue_xdy = [&](int hi) {
    const int h = h0 + hi;
    const float* xb = a.x + b * a.sxb + h * a.sxh;
    const float* yb = a.dy + (long long)b * a.S * a.H * P + (long long)h * P;
    const float* db = a.dt + b * a.sdb + h * a.sdh;
    for (int i = tid; i < CMAX * PMAX / 4; i += NT2) {
      const int row = i / (PMAX / 4), q = i % (PMAX / 4);
      const bool ok = row < c && 4 * q < P;
      cp_async16(smem_u32(Xl + row * RP + 4 * q), ok ? xb + (s0 + row) * a.sxs + 4 * q : xb, ok);
      cp_async16(smem_u32(DYl + row * RP + 4 * q), ok ? yb + (s0 + row) * a.H * P + 4 * q : yb,
                 ok);
    }
    for (int t = tid; t < CMAX; t += NT2) {
      const bool ok = t < c;
      cp_async4(smem_u32(dtb + t), ok ? db + (s0 + t) * a.sds : db, ok);
    }
    cp_async_commit();
  };
  // pair j: head j / NPH, columns (j % NPH) NW .. + NW of g and h_in
  auto issue_pair = [&](int j) {
    const int h = h0 + j / NPH, n0 = (j % NPH) * NW;
    float* gt = GH + (j & 1) * 2 * GT;
    const long long base = (((long long)b * a.nz + z) * a.H + h) * P * N + n0;
    for (int i = tid; i < PMAX * (NW / 4); i += NT2) {
      const int p = i / (NW / 4), q = i % (NW / 4);
      const bool ok = p < P && n0 + 4 * q < N;
      const long long off = ok ? base + (long long)p * N + 4 * q : 0;
      cp_async16(smem_u32(gt + p * RG + 4 * q), a.gst + off, ok);
      cp_async16(smem_u32(gt + GT + p * RG + 4 * q), a.hin + off, ok);
    }
    cp_async_commit();
  };

  issue_b();
  issue_xdy(0);
  issue_pair(0);
  int issued = 3, g_xdy = 1, g_pair = 2;  // cp.async groups committed; the ones waited for next
  cp_async_wait<2>();
  __syncthreads();

  // S = C B^T into Ss, in S's partition: this warp's rows, and the n-tiles j =
  // 2 jj + hf, jj < nst, where s <= t can hold
  const int nst = r + 1;
  {
    float acc[4][4] = {};
#pragma unroll 1
    for (int ks = 0; ks < NP / 16; ++ks) {
      uint32_t af[T][4], bf[4][2][T];
      frag_a(af, [&](int m, int k) { return cpair(16 * r + m, 16 * ks + k); });
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (jj < nst)
          frag_b(bf[jj][0], bf[jj][1], [&](int k, int n) {
            return ld2(Bs + (8 * (2 * jj + hf) + n) * RN + 16 * ks + k);
          });
      mma_terms<T, 4>(acc, af, bf, nst);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 2 * jj + hf;
      if (jj >= nst) break;
      float* o = Ss + (16 * r + r0) * RP + 8 * j + q2;
      *reinterpret_cast<float2*>(o) = make_float2(acc[jj][0], acc[jj][1]);
      *reinterpret_cast<float2*>(o + 8 * RP) = make_float2(acc[jj][2], acc[jj][3]);
    }
  }

  // accumulated over the slice's heads: M (in S's partition), dB and dC
  // (rows 16 r .., columns hf NW / 2 + 8 jj of each tile of NW columns)
  float Macc[4][4] = {};
  float dBacc[NPH][NJW][4] = {}, dCacc[NPH][NJW][4] = {};

  for (int hi = 0; hi < nh; ++hi) {
    const int h = h0 + hi;
    cp_async_wait_upto(issued - 1 - g_xdy);
    __syncthreads();  // this head's x, dy, dt are in; the last head is done everywhere
    // x and dy into T bf16 planes, every element split once
    for (int i = tid; i < CMAX * PMAX / 4; i += NT2) {
      const int row = i / (PMAX / 4), q = i % (PMAX / 4);
      put4<T>(Xp, PLANE, row * XS + 4 * q,
              *reinterpret_cast<const float4*>(Xl + row * RP + 4 * q));
      put4<T>(DYp, PLANE, row * XS + 4 * q,
              *reinterpret_cast<const float4*>(DYl + row * RP + 4 * q));
    }
    if (warp == 0) {
      chunk_prefix(make_float2(dtb[2 * lane], dtb[2 * lane + 1]), a.A[h], c, acum, dts);
      __syncwarp();
      const float last = acum[c - 1];
      for (int t = lane; t < CMAX; t += 32) {
        Wv[t] = t < c ? expf(last - acum[t]) : 0.f;
        Ev[t] = t < c ? expf(acum[t]) : 0.f;
      }
    }
    __syncthreads();  // the planes and the prefix sums are in; x, dy, dt free
    if (hi + 1 < nh) {
      issue_xdy(hi + 1);
      g_xdy = issued++;
    }

    // D = dy x^T in S's partition; then by selection (s <= t < c) L S D, its
    // strict row sums (times dt_s) and column sums and its diagonal, and
    // M += L dt D
    {
      float Dacc[4][4] = {};
#pragma unroll 1
      for (int ks = 0; ks < KP; ++ks) {
        uint32_t af[T][4], bf[4][2][T];
        ldsm_a(af, DYp, 16 * r, 16 * ks);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (jj < nst) ldsm_b_nk(bf[jj], Xp, 8 * (2 * jj + hf), 16 * ks);
        mma_terms<T, 4>(Dacc, af, bf, nst);
      }
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < MT; ++jj) {
        const int j = 2 * jj + hf;
        float csum[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * r + r0 + 8 * (e >> 1), s = 8 * j + q2 + (e & 1);
          if (s <= t && t < c) {
            const float L = expf(acum[t] - acum[s]);
            const float q = L * Ss[t * RP + s] * Dacc[jj][e];
            Macc[jj][e] += L * dts[s] * Dacc[jj][e];
            if (s < t) {
              rsum[e >> 1] += q * dts[s];
              csum[e & 1] += q;
            } else {
              diag[t] = q;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {  // over the warp's 16 rows
          float v = csum[k];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (r0 == 0) colp[r * CMAX + 8 * j + q2 + k] = v;
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {  // over the quad's columns
        float v = rsum[k];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (lane % 4 == 0) rowp[hf * CMAX + 16 * r + r0 + 8 * k] = v;
      }
    }

    // dx's intra-chunk term, rows s of this warp, columns p of its half:
    // (L S)^T dy, A formed from S by selection
    float ACCi[4][4] = {};
#pragma unroll 1
    for (int kt = 0; kt < MT; ++kt) {
      if (kt < r) continue;  // (L S)[t][s] = 0 for t < s
      uint32_t af[T][4], bf[4][2][T];
      frag_a(af, [&](int m, int k) {
        const int s = 16 * r + m, t = 16 * kt + k;
        const float v0 = s <= t && t < c ? expf(acum[t] - acum[s]) * Ss[t * RP + s] : 0.f;
        const float v1 =
            s <= t + 1 && t + 1 < c ? expf(acum[t + 1] - acum[s]) * Ss[(t + 1) * RP + s] : 0.f;
        return make_float2(v0, v1);
      });
      ldsm_b_kn2(bf[0], bf[1], DYp, 16 * kt, 8 * hf * KP);
      ldsm_b_kn2(bf[2], bf[3], DYp, 16 * kt, 8 * hf * KP + 16);
      mma_terms<T, 4>(ACCi, af, bf, KP);
    }

    float ACCc[4][4] = {};  // dx's carry term, B g^T, tile by tile
    float vsum[2] = {0.f, 0.f}, dotv = 0.f;
#pragma unroll
    for (int ni = 0; ni < NPH; ++ni) {
      const int j = hi * NPH + ni;
      cp_async_wait_upto(issued - 1 - g_pair);
      __syncthreads();  // this pair is in; the slot of the last pair is free
      if (j + 1 < nh * NPH) {
        issue_pair(j + 1);
        g_pair = issued++;
      }
      const float* Gt = GH + (j & 1) * 2 * GT;
      const float* Ht = Gt + GT;
      const int n0 = ni * NW, nn = hf * (NW / 2);
      // dx's carry term: sum over the tile's n of B[s][n] g[p][n]
#pragma unroll 1
      for (int ks = 0; ks < NW / 16; ++ks) {
        uint32_t af[T][4], bf[4][2][T];
        frag_a(af, [&](int m, int k) { return ld2(Bs + (16 * r + m) * RN + n0 + 16 * ks + k); });
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          frag_b(bf[jj][0], bf[jj][1], [&](int k, int n) {
            return ld2(Gt + (8 * (hf * KP + jj) + n) * RG + 16 * ks + k);
          });
        mma_terms<T, 4>(ACCc, af, bf, KP);
      }
      // dB += W_s dt_s (x g)
      {
        float tmp[NJW][4] = {};
#pragma unroll 1
        for (int ks = 0; ks < KP; ++ks) {
          uint32_t af[T][4], bf[NJW][2][T];
          ldsm_a(af, Xp, 16 * r, 16 * ks);
#pragma unroll
          for (int jj = 0; jj < NJW; ++jj)
            frag_b(bf[jj][0], bf[jj][1], [&](int k, int n) {
              const float* v = Gt + (16 * ks + k) * RG + nn + 8 * jj + n;
              return make_float2(v[0], v[RG]);
            });
          mma_terms<T, NJW>(tmp, af, bf, NJW);
        }
#pragma unroll
        for (int jj = 0; jj < NJW; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = 16 * r + r0 + 8 * (e >> 1);
            dBacc[ni][jj][e] += Wv[s] * dts[s] * tmp[jj][e];
          }
      }
      // dC += E_t (dy h_in), and V's share over this warp's columns
      {
        float tmp[NJW][4] = {};
#pragma unroll 1
        for (int ks = 0; ks < KP; ++ks) {
          uint32_t af[T][4], bf[NJW][2][T];
          ldsm_a(af, DYp, 16 * r, 16 * ks);
#pragma unroll
          for (int jj = 0; jj < NJW; ++jj)
            frag_b(bf[jj][0], bf[jj][1], [&](int k, int n) {
              const float* v = Ht + (16 * ks + k) * RG + nn + 8 * jj + n;
              return make_float2(v[0], v[RG]);
            });
          mma_terms<T, NJW>(tmp, af, bf, NJW);
        }
#pragma unroll
        for (int jj = 0; jj < NJW; ++jj)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int t = 16 * r + r0 + 8 * k;
            const float2 cv = cpair(t, n0 + nn + 8 * jj + q2);
            const float u0 = Ev[t] * tmp[jj][2 * k], u1 = Ev[t] * tmp[jj][2 * k + 1];
            vsum[k] += cv.x * u0 + cv.y * u1;
            dCacc[ni][jj][2 * k] += u0;
            dCacc[ni][jj][2 * k + 1] += u1;
          }
      }
      // <g, h_in> over this tile, every thread its own elements
      for (int i = tid; i < P * NW; i += NT2) {
        const int p = i / NW, n = i % NW;
        dotv += Gt[p * RG + n] * Ht[p * RG + n];
      }
    }

    {
      // <g, x_s B_s^T> = x_s . (B g^T)_s and V, per row over this warp's half;
      // dx = dt_s (intra + W_s carry)
      float xg[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int pj = hf * KP + jj;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int s = 16 * r + r0 + 8 * k;
          const float2 xv = plane_sum(Xp, s * XS + 8 * pj + q2);
          xg[k] += xv.x * ACCc[jj][2 * k] + xv.y * ACCc[jj][2 * k + 1];
          if (s < c && 8 * pj < P) {
            float* row = a.dx + (((long long)b * a.S + s0 + s) * a.H + h) * P + 8 * pj + q2;
            *reinterpret_cast<float2*>(row) =
                make_float2(dts[s] * (ACCi[jj][2 * k] + Wv[s] * ACCc[jj][2 * k]),
                            dts[s] * (ACCi[jj][2 * k + 1] + Wv[s] * ACCc[jj][2 * k + 1]));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float u = xg[k], v = vsum[k];
        u += __shfl_xor_sync(0xffffffffu, u, 1);
        u += __shfl_xor_sync(0xffffffffu, u, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (lane % 4 == 0) {
          xgbp[hf * CMAX + 16 * r + r0 + 8 * k] = u;
          vp[hf * CMAX + 16 * r + r0 + 8 * k] = v;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dotv += __shfl_xor_sync(0xffffffffu, dotv, off);
    if (lane == 0) dotp[warp] = dotv;
    __syncthreads();

    // d(acum) -> d(a) by a reverse prefix sum; ddt and the chunk's share of dA
    if (warp == 0) {
      const float a_h = a.A[h];
      float dot = 0.f;
      for (int w = 0; w < NT2 / 32; ++w) dot += dotp[w];
      float dac[2], ddir[2], u[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 2 * lane + k;
        u[k] = dac[k] = ddir[k] = 0.f;
        if (t < c) {
          float col = 0.f;
          for (int rr = 0; rr < MT; ++rr) col += colp[rr * CMAX + t];
          const float xg = xgbp[t] + xgbp[CMAX + t];
          u[k] = Wv[t] * dts[t] * xg;
          dac[k] = rowp[t] + rowp[CMAX + t] - dts[t] * col + (vp[t] + vp[CMAX + t]) - u[k];
          ddir[k] = diag[t] + col + Wv[t] * xg;
        }
      }
      float usum = u[0] + u[1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) usum += __shfl_xor_sync(0xffffffffu, usum, off);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (2 * lane + k == c - 1) dac[k] += usum + Ev[c - 1] * dot;
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
      if (lane == 0) a.dAp[((long long)b * a.nz + z) * a.H + h] = dsum;
    }
  }

  // the slice's intra-chunk terms of dB and dC: M^T C and M B, M through Ss
  __syncthreads();
  {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 2 * jj + hf;
      if (jj >= MT) break;
      float* o = Ss + (16 * r + r0) * RP + 8 * j + q2;
      *reinterpret_cast<float2*>(o) = make_float2(Macc[jj][0], Macc[jj][1]);
      *reinterpret_cast<float2*>(o + 8 * RP) = make_float2(Macc[jj][2], Macc[jj][3]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int ni = 0; ni < NPH; ++ni) {
    const int n0 = ni * NW + hf * (NW / 2);
#pragma unroll 1
    for (int kt = 0; kt < MT; ++kt) {  // dB[s] += sum_{t >= s} M[t][s] C[t]
      if (kt < r) continue;
      uint32_t af[T][4];
      frag_a(af, [&](int m, int k) {
        const float* v = Ss + (16 * kt + k) * RP + 16 * r + m;
        return make_float2(v[0], v[RP]);
      });
      uint32_t bf[NJW][2][T];
#pragma unroll
      for (int jj = 0; jj < NJW; ++jj)
        frag_b(bf[jj][0], bf[jj][1], [&](int k, int n) {
          const int t = 16 * kt + k, col = n0 + 8 * jj + n;
          return make_float2(t < c && col < N ? Cg[t * a.scs + col] : 0.f,
                             t + 1 < c && col < N ? Cg[(t + 1) * a.scs + col] : 0.f);
        });
      mma_terms<T, NJW>(dBacc[ni], af, bf, NJW);
    }
#pragma unroll 1
    for (int ks = 0; ks < MT; ++ks) {  // dC[t] += sum_{s <= t} M[t][s] B[s]
      if (ks > r) break;
      uint32_t af[T][4];
      frag_a(af, [&](int m, int k) { return ld2(Ss + (16 * r + m) * RP + 16 * ks + k); });
      uint32_t bf[NJW][2][T];
#pragma unroll
      for (int jj = 0; jj < NJW; ++jj)
        frag_b(bf[jj][0], bf[jj][1], [&](int k, int n) {
          const float* v = Bs + (16 * ks + k) * RN + n0 + 8 * jj + n;
          return make_float2(v[0], v[RN]);
        });
      mma_terms<T, NJW>(dCacc[ni], af, bf, NJW);
    }
#pragma unroll
    for (int jj = 0; jj < NJW; ++jj) {
      const int n = n0 + 8 * jj + q2;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 16 * r + r0 + 8 * k;
        if (t >= c || n >= N) continue;
        const long long o = ((((long long)b * a.S + s0 + t) * a.G + g) * a.nsl + sl) * N + n;
        *reinterpret_cast<float2*>(a.dBp + o) =
            make_float2(dBacc[ni][jj][2 * k], dBacc[ni][jj][2 * k + 1]);
        *reinterpret_cast<float2*>(a.dCp + o) =
            make_float2(dCacc[ni][jj][2 * k], dCacc[ni][jj][2 * k + 1]);
      }
    }
  }
}

// ---- (c) the sums over a group's head slices and over chunks --------------
__global__ void __launch_bounds__(256) ssd_bwd_reduce_kernel(const Args a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nbc = (long long)a.B * a.S * a.G * a.N;
  if (i < 2 * nbc) {
    const bool is_c = i >= nbc;
    const long long j = is_c ? i - nbc : i;
    const float* src = (is_c ? a.dCp : a.dBp) + (j / a.N) * a.nsl * a.N + j % a.N;
    float sum = 0.f;
    for (int k = 0; k < a.nsl; ++k) sum += src[(long long)k * a.N];
    (is_c ? a.dCm : a.dBm)[j] = sum;
  } else if (i < 2 * nbc + a.H) {
    const int h = (int)(i - 2 * nbc);
    float sum = 0.f;
    for (long long r = 0; r < (long long)a.B * a.nz; ++r) sum += a.dAp[r * a.H + h];
    a.dA[h] = sum;
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

template <int NP>
cudaError_t launch_all(const Args& a, cudaStream_t s) {
  // (a): the widest slice of P that still gives one block per SM
  const int mi = NP >= 64 && a.P == 64 && 2LL * a.B * a.H >= 132 ? 4 : a.P / 16 < 2 ? a.P / 16 : 2;
  const dim3 sgrid(2 * (a.P / (16 * mi)), a.H, a.B);
  const cudaError_t err =
      mi == 4   ? launch_smem(ssd_bwd_state_kernel<NP, 4>, sgrid, NT1, StateSmem<NP, 4>::BYTES, s, a)
      : mi == 2 ? launch_smem(ssd_bwd_state_kernel<NP, 2>, sgrid, NT1, StateSmem<NP, 2>::BYTES, s, a)
                : launch_smem(ssd_bwd_state_kernel<NP, 1>, sgrid, NT1, StateSmem<NP, 1>::BYTES, s, a);
  if (err != cudaSuccess) return err;
  const cudaError_t err2 = launch_smem(ssd_bwd_chunk_kernel<NP>, dim3(a.nz, a.G * a.nsl, a.B), NT2,
                    ChunkSmem<NP>::BYTES, s, a);
  if (err2 != cudaSuccess) return err2;
  const long long m = 2LL * a.B * a.S * a.G * a.N + a.H;
  return launch_smem(ssd_bwd_reduce_kernel, dim3((unsigned)((m + 255) / 256)), 256, 0, s, a);
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], A [H], Bm / Cm [B, S, G, N], all fp32, with
// element strides (batch, sequence, head or group) of x, dt, Bm, Cm in that
// order, the last dim dense, the rows of x, Bm and Cm 16-byte aligned; dy
// [B, S, H, P] and dstate [B, H, P, N] (null: zeros) contiguous fp32.
// Outputs, contiguous fp32: dx [B, S, H, P], ddt [B, S, H], dA [H], dBm /
// dCm [B, S, G, N].  Scratch, contiguous fp32: hin and gst [B, S/chunk, H,
// P, N], dBp / dCp [B, S, G, slices, N], dAp [B, S/chunk, H], with slices =
// ceil((H/G) / hps), hps the heads of a group one block of (b) walks.  P in
// {16, 32, 64}, N in {8, 16, 32, 64, 128}, 1 <= chunk <= 64 dividing S.
// Launches three kernels on the stream; returns the first launch error
// (cudaGetLastError()).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* dy, const void* dstate, void* dx,
                            void* ddt, void* dA, void* dBm, void* dCm, void* hin, void* gst,
                            void* dBp, void* dCp, void* dAp, int B, int S, int H, int P, int G,
                            int N, int chunk, int hps, long long sxb, long long sxs,
                            long long sxh, long long sdb, long long sds, long long sdh,
                            long long sbb, long long sbs, long long sbg, long long scb,
                            long long scs, long long scg, void* stream) {
  if (P % 16 || P < 16 || P > PMAX || chunk < 1 || chunk > CMAX || S % chunk || G < 1 ||
      H % G || hps < 1)
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
  a.hin = static_cast<float*>(hin);
  a.gst = static_cast<float*>(gst);
  a.dBp = static_cast<float*>(dBp);
  a.dCp = static_cast<float*>(dCp);
  a.dAp = static_cast<float*>(dAp);
  a.B = B; a.S = S; a.H = H; a.P = P; a.G = G; a.N = N; a.chunk = chunk;
  a.nz = S / chunk;
  a.hps = hps;
  a.nsl = (H / G + hps - 1) / hps;
  a.sxb = sxb; a.sxs = sxs; a.sxh = sxh;
  a.sdb = sdb; a.sds = sds; a.sdh = sdh;
  a.sbb = sbb; a.sbs = sbs; a.sbg = sbg;
  a.scb = scb; a.scs = scs; a.scg = scg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8:
    case 16: return (int)launch_all<16>(a, s);
    case 32: return (int)launch_all<32>(a, s);
    case 64: return (int)launch_all<64>(a, s);
    case 128: return (int)launch_all<128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
