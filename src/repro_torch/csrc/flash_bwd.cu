// Flash-attention backward on Hopper's tensor cores (sm_90a), fp32 and bf16
// inputs; plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_bwd, both
//   of its Pallas calls:
//   * flash_bwd_dq  -- the dQ call (body _dq_kernel, pallas_call :411);
//   * flash_bwd_dkv -- the dK/dV call (body _dkv_kernel, pallas_call :461).
//
// What they compute, from the forward's saved lse and delta = rowsum(dO * O):
//   S  = scale * q k^T,  P = exp(S - lse) on visible pairs (0 elsewhere),
//   dP = dO v^T,         dS = P * (dP - delta) * scale,
//   dQ = dS k,  dK = dS^T q,  dV = P^T dO,
// with dK/dV summed over the GQA group (query heads hk*g .. hk*g+g-1 read kv
// head hk, g = H / Hkv).  Visibility is the forward's: the int32 band (q_off,
// kv_off, lo, hi) in device memory with static strides, composed with
// optional segment ids; one [4] band serves the whole batch (the JAX
// backward takes no per-row band).  lse and delta are fp32 [B, H, Sq] (delta
// transposed to that layout by the wrapper, as JAX does before its Pallas
// calls).  dq, dk, dv come out in the input type.
//
// What bounds them on an H100: per visible (query, key) pair and query head,
// dQ does 6*D flops (S, dP, dQ) and dK/dV 8*D (S, dP, dV, dK), against ~2*D
// bytes per token and head of inputs and outputs -- far above the card's
// ~295 flop/byte balance point at training lengths: both are bound by the
// tensor cores (989 TFLOP/s in bf16), so every product runs on wgmma.
//
// Numerics (the term counts are settled by tests/test_torch_bwd_split.py,
// which emulates this arithmetic on the CPU against the JAX backward):
//   * every product takes bf16 operands and accumulates in fp32; a bf16 x
//     bf16 product is exact in fp32;
//   * bf16 inputs: q, k, v, dO are one exact term each.  P and dS (fp32) are
//     split into two bf16 terms, hi + lo (16 bits); one bf16 P or dS breaks
//     the bf16 gate (the emulation: 10-16x its limit, 0.81-0.92 with two);
//   * fp32 inputs (the training path): a pre-pass (flash_bwd_split_kernel,
//     one launch per backward call) writes q, k, v and dO as two bf16 terms
//     each, hi + lo, into scratch the wrapper allocates, and TMA loads the
//     terms like any bf16 tile.  Each product runs hi.hi + hi.lo + lo.hi
//     (T = 2 terms: the pairs i + j < 2); P and dS are split the same way.
//     That carries ~16 of fp32's 24 bits: the emulation reads 0.10-0.26 of
//     the fp32 gate, while a single-term P and dS read 15-25x it;
//   * P = exp2(S * scale * log2(e) - lse * log2(e)), dS in fp32; outputs are
//     rounded once;
//   * the tensor cores truncate as they accumulate, so a long sum kept in one
//     accumulator drifts: at S = 4096 causal, GQA group 4 (3072 products into
//     each dK/dV accumulator) the fp32 body read 0.8 of its gate on an H100.
//     With fp32 outputs the kernels fold their accumulators into the output
//     every FOLD tiles (round to nearest) and restart them from 0: 0.23-0.26.
//
// Design (the JAX grid's sequential axis becomes a loop inside the CTA):
//   * dQ: one CTA per (64 query rows, query head, batch row).  q and dO
//     (all terms) are loaded once by TMA; k and v tiles stream through a
//     ring of stages, loaded by TMA from one thread (full / empty
//     mbarriers).  Per tile: S = Q K^T and dP = dO V^T (wgmma, both operands
//     from shared memory), then dS in registers as the A operand of dQ += dS
//     K, with K read MN-major (the transpose bit).
//   * dK/dV: one CTA per (64 keys, kv head, batch row).  k and v are loaded
//     once; the loop runs over the group's g query heads x the q tiles that
//     the band lets see these keys, with q, dO, lse, delta (and the rows'
//     segment ids) streaming through the ring.  Keys are the rows: S^T = K
//     Q^T and dP^T = V dO^T, so P^T and dS^T are already the A operands of
//     dV += P^T dO and dK += dS^T Q (dO and Q read MN-major).
//   * D <= 128: streamed tiles of 64 rows through two stages, one warpgroup
//     a CTA in both kernels (m64n64k16).
//   * D = 96 (minicpm3-4b's MLA training: the expanded heads, V padded from
//     64 to the qk width, as JAX's backward takes them): Cfg keys its
//     swizzle on D % 64, so 96 is three column blocks of 32 dims in 64-byte
//     swizzle (D 32's layout, three times), dQ += dS K and the dK/dV
//     products on m64n32k16 a column block.  Registers: dK and dV's two 64 x
//     96 fp32 accumulators are 96 a thread (128 at D 128).  Shared memory,
//     fp32 inputs (two terms): 48 KB of resident tiles and two stages of
//     50 KB, ~149 KB; bf16 ~77 KB.  So D 96 takes the one-warpgroup kernels
//     below, not the wide ones.  The padded third of V is computed like the
//     rest (dV's last 32 dims are 0 and dP sums zeros there), as JAX does.
//   * D = 256 (gemma-7b; Cfg<256, T>, the kernels of namespace wide): a 64 x
//     256 fp32 accumulator is 128 registers a thread and dK/dV has two, so a
//     CTA is two warpgroups (256 threads) over its 64 rows, warpgroup w
//     owning dims [128w, 128w + 128) of dQ (64 registers), or of dK and dV
//     (128).  The streamed tiles are 32 rows (S and dP on m64n32k16, 16
//     registers each; dS's two terms 16).  Both warpgroups need all of P
//     and dS, whose score sums run over all 256 dims: warpgroup 0 issues S
//     (dK/dV: S^T) and turns it into P, warpgroup 1 issues dP, and the two
//     swap them through 16 KB of shared memory behind named barriers (a
//     thread's elements to the same thread of the other warpgroup).  So the
//     tensor work is not repeated (issuing both products in both
//     warpgroups would cost 1.5x), each score is still one accumulator's
//     sum over D as at D <= 128 (no partial sums over halves of D to add),
//     and both warpgroups form dS alike.  fp32 inputs hold the two resident
//     tensors' terms in 128 KB, so their ring has one stage of 64 KB (a CTA
//     waits for each tile); bf16 inputs keep two.  FOLD stays 16 tiles, so
//     at D = 256 the fp32 accumulators fold every 512 products (1024 at
//     D <= 128).  The D <= 128 kernels are kept apart from these, so their
//     code does not move.
//   * loop bounds are solved per CTA from the band in device memory, so
//     hidden tiles are never loaded; a tile that the band shows whole takes
//     the elementwise pass unmasked, any other one is masked element by
//     element.  Every product is issued in straight-line code, the same
//     every tile (a wgmma under a branch ptxas cannot prove uniform is
//     serialized); at D = 256 the two warpgroups differ only in their
//     operands' addresses;
//   * empty rows (lse = NEG_INF) and masked pairs are SELECTED to 0, never
//     multiplied; ragged Sq / Skv are zero-filled by TMA and masked;
//   * no atomics: every output element belongs to one CTA (one warpgroup of
//     it), whose sums run in a fixed order, so two launches give
//     bitwise-equal results.

#include <string.h>

#include "sm90.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// (x, y) as two bf16 pairs: hi = bf16(x, y), lo = bf16 of what hi leaves
__device__ __forceinline__ void split2_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// visible iff lo <= q position - k position <= hi
__device__ __forceinline__ bool band_visible(long long qpos, long long kpos, long long lo,
                                             long long hi) {
  const long long diff = qpos - kpos;
  return diff >= lo && diff <= hi;
}

// a named barrier over n threads (barrier 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ===========================================================================
// the shared engine
// ===========================================================================

constexpr int NT = 128;    // one warpgroup
constexpr int ROWS = 64;   // a CTA's own rows: dQ's query rows, dK/dV's keys
constexpr int STAGES = 2;  // ring of streamed tiles (D = 256: Cfg::RING)
constexpr int TP = 2;      // bf16 terms of P and dS
// fp32 outputs (see Numerics above): every FOLD tiles a CTA adds its
// accumulators into its own rows of the output (round to nearest; no atomics:
// one CTA owns the rows) and starts them from 0.
constexpr int FOLD = 16;
// A 1-D TMA box starts on a 16-byte boundary in global memory: a row vector
// (lse, delta, segment ids) of a tile starting at element x is loaded as a
// box of VBOX elements from x & ~3 and read from offset x & 3.
constexpr int VBOX = ROWS + 4;
constexpr int VSTRIDE = 384;  // bytes between a stage's row vectors (TMA writes 128-byte aligned)

// T: bf16 terms per input value (1 for bf16 inputs, 2 for fp32 inputs).  The
// resident tiles are [64, D] (q and dO in dQ, k and v in dK/dV), the streamed
// ones [BN, D]; D = 256 as the Design notes say.
template <int D, int T>
struct Cfg {
  // swizzle span (bytes) = column block row: 128 where D is a multiple of
  // 64, else 64 (D 32, and D 96 as three 32-dim blocks)
  static constexpr int SWB = D % 64 == 0 ? 128 : 64;
  static constexpr int CB = SWB / 2;                   // dims per column block
  static_assert(D % CB == 0, "a whole number of column blocks");
  static constexpr int NCB = D / CB;                   // column blocks
  static constexpr uint64_t LAYOUT = D % 64 == 0 ? 1 : 2;  // descriptor swizzle mode
  static constexpr int BN = D == 256 ? 32 : ROWS;      // rows of a streamed tile
  static constexpr int RING = D == 256 && T == 2 ? 1 : STAGES;  // stages of the ring
  static constexpr int WG = D == 256 ? 2 : 1;          // warpgroups a CTA
  static constexpr int RTILE = ROWS * D * 2;           // one term of a resident tile
  static constexpr int STILE = BN * D * 2;             // one term of a streamed tile
  static constexpr int RES = 2 * T * RTILE;            // two tensors' resident tiles, all terms
  static constexpr int STR = 2 * T * STILE;            // two tensors' streamed tiles, all terms
  static constexpr int VEC = 2048;                     // a stage's row vectors (3 x VSTRIDE)
  static constexpr int STAGE = STR + VEC;
  // the exchange of P and dP (dK/dV: P^T and dP^T): float [warpgroup][BN / 2][NT]
  static constexpr int XCH_OFF = RES + RING * STAGE;
  static constexpr int XCH = WG > 1 ? WG * (BN / 2) * NT * 4 : 0;
  // shared memory: the resident tiles (RES), the ring of RING stages, the
  // exchange, the barriers (u64 full, empty [stages], resident).  At D = 256:
  // fp32 128 + 66 + 16 KB = 210 KB, bf16 64 + 2 x 34 + 16 KB = 148 KB, each
  // with 1 KB of alignment and the barriers beside.
  static constexpr int BAR_OFF = XCH_OFF + XCH;
  static constexpr int SMEM = 1024 + BAR_OFF + (2 * RING + 1) * 8;
  static_assert(SMEM <= 232448, "a block's shared memory on sm_90");
};

template <int T> struct OutType { typedef float type; };  // fp32 inputs carry 2 terms
template <> struct OutType<1> { typedef bf16 type; };

// one pair of output values: fp32 stored or added to what is there; bf16
// (written once) stored
__device__ __forceinline__ void put2(float* p, float x, float y, bool add) {
  float2 v = make_float2(x, y);
  if (add) {
    const float2 o = *reinterpret_cast<const float2*>(p);
    v.x += o.x;
    v.y += o.y;
  }
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void put2(bf16* p, float x, float y, bool) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// This thread's elements of a 64 x (NCB column blocks) accumulator into rows
// [0, n_rows) of out (row r at out + r * stride), then cleared.  Element e
// of column block c sits at row warp * 16 + lane / 4 + 8 * ((e / 2) % 2),
// dim c * CB + (e / 4) * 8 + 2 * (lane % 4) + e % 2, warp counted within
// the thread's warpgroup (of WG in the CTA).
template <int WG, typename OutT, int NCB, int HALF>
__device__ __forceinline__ void write_rows(float (&acc)[NCB][HALF], OutT* out, size_t stride,
                                           int n_rows, bool add) {
  const int lane = threadIdx.x % 32, warp = (WG > 1 ? threadIdx.x % NT : threadIdx.x) / 32;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = warp * 16 + lane / 4 + 8 * h2;
    if (r >= n_rows) continue;
    OutT* row = out + r * stride + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < NCB; ++c)
#pragma unroll
      for (int j = 0; j < HALF / 4; ++j)
        put2(row + c * 2 * HALF + j * 8, acc[c][4 * j + 2 * h2], acc[c][4 * j + 2 * h2 + 1], add);
  }
#pragma unroll
  for (int c = 0; c < NCB; ++c)
#pragma unroll
    for (int e = 0; e < HALF; ++e) acc[c][e] = 0.f;
}

// acc (64 x BN) = sum over the term pairs i + j < T of A_i B_j^T over D.  A
// is a resident [64, D] tile of T terms at a0 (term t at + t * RTILE), B a
// streamed [BN, D] tile at b0 (term t at + t * STILE), both stored as column
// blocks [rows][SWB] swizzled as TMA writes them: both are K-major.  The
// first product overwrites acc.
template <int D, int T>
__device__ __forceinline__ void ss_products(float (&acc)[Cfg<D, T>::BN / 2], uint32_t a0,
                                            uint32_t b0) {
  using C = Cfg<D, T>;
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; i + j < T; ++j)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t cb = (kk * 16) / C::CB, within = ((kk * 16) % C::CB) * 2;
        const uint64_t da = smem_desc(a0 + i * C::RTILE + cb * ROWS * C::SWB + within, 16,
                                      8 * C::SWB, C::LAYOUT);
        const uint64_t db = smem_desc(b0 + j * C::STILE + cb * C::BN * C::SWB + within, 16,
                                      8 * C::SWB, C::LAYOUT);
        if constexpr (C::BN == 64)
          wgmma_ss_m64n64(acc, da, db, i + j + kk > 0);
        else
          wgmma_ss_m64n32(acc, da, db, i + j + kk > 0);
      }
}

// The A operand of the register products: TP bf16 terms of a 64 x BN fp32
// accumulator; k-step u (columns 16u .. 16u+15) is the accumulator's blocks
// 2u and 2u+1 (the m16n8 accumulator and A-fragment layouts agree)
template <int BN>
struct Frag {
  uint32_t r[TP][BN / 16][4];
};
template <int BN>
__device__ __forceinline__ void make_frag(const float (&x)[BN / 2], Frag<BN>& f) {
#pragma unroll
  for (int u = 0; u < BN / 16; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split2_bf16(x[8 * u + 2 * e], x[8 * u + 2 * e + 1], f.r[0][u][e], f.r[1][u][e]);
}

// acc (64 x NC column blocks, one [64][CB] block each) += sum over the term
// pairs i + j < max(TP, T) of F_i B_j: F from registers (k = the BN columns
// of the scores), B the streamed [BN, D] tile of T terms whose column block
// 0 here is at b0, read MN-major (one product per column block, whose N fits
// one swizzle atom; the leading offset is then unused, so it takes the
// stride offset's value).
template <int D, int T, int NC>
__device__ __forceinline__ void rs_products(float (&acc)[NC][Cfg<D, T>::CB / 2],
                                            const Frag<Cfg<D, T>::BN>& f, uint32_t b0) {
  using C = Cfg<D, T>;
  constexpr int NMAX = TP > T ? TP : T;
#pragma unroll
  for (int u = 0; u < C::BN / 16; ++u)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int j = 0; j < T; ++j) {
          if (i + j >= NMAX) continue;  // resolved at compile time
          const uint64_t db = smem_desc(b0 + j * C::STILE + c * C::BN * C::SWB + u * 16 * C::SWB,
                                        8 * C::SWB, 8 * C::SWB, C::LAYOUT);
          if constexpr (C::CB == 64)
            wgmma_rs_m64n64(acc[c], f.r[i][u], db);
          else
            wgmma_rs_m64n32(acc[c], f.r[i][u], db);
        }
}

// an [R, D] tile of T terms (R a multiple of BN, the maps' box rows): one box
// of one column block x BN rows per term, column block and BN rows;
// coordinates (dim, head, row, batch row + term * B)
template <int D, int T, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int row, int b, int B) {
  using C = Cfg<D, T>;
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int c = 0; c < C::NCB; ++c)
#pragma unroll
      for (int r = 0; r < R / C::BN; ++r)
        tma_load_4d(dst + t * R * D * 2 + c * R * C::SWB + r * C::BN * C::SWB, map, bar,
                    c * C::CB, head, row + r * C::BN, b + t * B);
}

// the ring's barriers: full[s] completes when stage s's bytes have landed,
// empty[s] when all the CTA's threads are done with it
template <int STAGES>
struct Ring {
  uint32_t full, empty, res;
  __device__ __forceinline__ void init(uint32_t bars, int threads) {
    full = bars;
    empty = bars + STAGES * 8;
    res = empty + STAGES * 8;
    if (threadIdx.x == 0) {
      for (int st = 0; st < STAGES; ++st) {
        mbar_init(full + st * 8, 1);
        mbar_init(empty + st * 8, threads);
      }
      mbar_init(res, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // before thread 0 refills stage u % STAGES with tile u: that stage's
  // previous tile (u - STAGES) is done with
  __device__ __forceinline__ uint32_t claim(int u) {
    const int st = u % STAGES;
    if (u >= STAGES) mbar_wait(empty + st * 8, (u / STAGES - 1) & 1);
    return full + st * 8;
  }
  __device__ __forceinline__ void wait_full(int t) {
    mbar_wait(full + (t % STAGES) * 8, (t / STAGES) & 1);
  }
  __device__ __forceinline__ void release(int t) { mbar_arrive(empty + (t % STAGES) * 8); }
};

// ===========================================================================
// dQ
// ===========================================================================

// tm_q, tm_do: q and dO as (D, H, Sq, B * T) tensor maps; tm_k, tm_v: k and v
// as (D, Hkv, Skv, B * T); boxes of one column block x 64 rows.  tm_seg:
// seg_kv (1-D, boxes of VBOX) when seg_q is given.
template <int D, int T>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_seg, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ band, const int* __restrict__ seg_q,
    typename OutType<T>::type* __restrict__ dq, int B, int Sq, int Skv, int H, int Hkv,
    float scale, int stride_q, int stride_kv) {
  using C = Cfg<D, T>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sDO = base + T * C::RTILE;  // resident
  const uint32_t sRing = base + C::RES;  // stage s: k terms, v terms, seg_kv [VBOX]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest tiles first (causal)
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const bool has_seg = seg_q != nullptr;
  const long long q_off = band[0], kv_off = band[1], lo = band[2], hi = band[3];
  const float sl2 = scale * kLog2e;

  // the visible key interval of this CTA's rows, solved from the band
  const int r_last = min(r0 + ROWS, Sq) - 1;
  const long long qmin = q_off + (long long)stride_q * r0;
  const long long qmax = q_off + (long long)stride_q * r_last;
  long long jlo = ceil_div(qmin - hi - kv_off, stride_kv);
  long long jhi = floor_div(qmax - lo - kv_off, stride_kv);
  if (jlo < 0) jlo = 0;
  if (jhi > Skv - 1) jhi = Skv - 1;
  const int n_tiles = jhi >= jlo ? (int)((jhi - jlo) / ROWS) + 1 : 0;

  Ring<STAGES> ring;
  ring.init(base + C::BAR_OFF, NT);
  auto load_kv = [&](int u) {  // thread 0
    const uint32_t full = ring.claim(u);
    const uint32_t dst = sRing + (u % STAGES) * C::STAGE;
    mbar_expect_tx(full, C::STR + (has_seg ? VBOX * 4 : 0));
    const int j0 = (int)(jlo + (long long)u * ROWS);
    load_tile<D, T, ROWS>(dst, &tm_k, full, hk, j0, b, B);
    load_tile<D, T, ROWS>(dst + T * C::STILE, &tm_v, full, hk, j0, b, B);
    if (has_seg) tma_load_1d(dst + C::STR, &tm_seg, full, j0 & ~3);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(ring.res, C::RES);
    load_tile<D, T, ROWS>(sQ, &tm_q, ring.res, h, r0, b, B);
    load_tile<D, T, ROWS>(sDO, &tm_do, ring.res, h, r0, b, B);
    for (int u = 0; u < STAGES && u < n_tiles; ++u) load_kv(u);
  }
  __syncwarp();

  // this thread's two rows (accumulator rows lane/4 and lane/4 + 8 of its warp)
  long long qpos[2];
  int segq[2];
  bool row_ok[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = r0 + warp * 16 + lane / 4 + 8 * h2;
    row_ok[h2] = row < Sq;
    qpos[h2] = q_off + (long long)stride_q * row;
    segq[h2] = (has_seg && row_ok[h2]) ? seg_q[row] : 0;
    const size_t li = ((size_t)b * H + h) * Sq + (row_ok[h2] ? row : 0);
    lse2[h2] = row_ok[h2] ? lse[li] * kLog2e : 0.f;
    dlt[h2] = row_ok[h2] ? delta[li] : 0.f;
  }

  float acc[C::NCB][C::CB / 2];
#pragma unroll
  for (int c = 0; c < C::NCB; ++c)
#pragma unroll
    for (int e = 0; e < C::CB / 2; ++e) acc[c][e] = 0.f;

  if (n_tiles > 0) mbar_wait(ring.res, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t sK = sRing + (t % STAGES) * C::STAGE, sV = sK + T * C::STILE;
    const long long j0 = jlo + (long long)t * ROWS, j1 = j0 + ROWS - 1;
    const int* segk = reinterpret_cast<const int*>(sbase + (sK - base) + C::STR) + (j0 & 3);
    ring.wait_full(t);
    float s[32], dp[32];
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
    ss_products<D, T>(s, sQ, sK);
    ss_products<D, T>(dp, sDO, sV);
    wgmma_commit();
    // does the band show the whole tile to every row of the CTA?
    const bool full = !has_seg && j1 <= jhi && qmin - (kv_off + (long long)stride_kv * j1) >= lo &&
                      qmax - (kv_off + (long long)stride_kv * j0) <= hi;
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    // element e: row (e / 2) % 2 of this thread's pair, key column
    // (e / 4) * 8 + 2 * (lane % 4) + e % 2
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h2 = (e / 2) % 2;
      float p = fast_exp2(fmaf(s[e], sl2, -lse2[h2]));
      if (!full) {
        const int col = (e / 4) * 8 + 2 * (lane % 4) + e % 2;
        const long long key = j0 + col;
        const bool vis = row_ok[h2] && key <= jhi &&
                         band_visible(qpos[h2], kv_off + (long long)stride_kv * key, lo, hi) &&
                         (!has_seg || segq[h2] == segk[col]);
        p = vis ? p : 0.f;  // select, never multiply: exp2 is inf on an empty row
      }
      dp[e] = p * (dp[e] - dlt[h2]) * scale;
    }
    Frag<ROWS> fds;
    make_frag<ROWS>(dp, fds);
#pragma unroll
    for (int c = 0; c < C::NCB; ++c) fence_operands(acc[c]);
    wgmma_fence();
    rs_products<D, T, C::NCB>(acc, fds, sK);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::NCB; ++c) fence_operands(acc[c]);
    ring.release(t);
    if (tid == 0 && t + STAGES < n_tiles) load_kv(t + STAGES);
    __syncwarp();
    if (T > 1 && ((t + 1) % FOLD == 0 || t + 1 == n_tiles))
      write_rows<1>(acc, dq + (((size_t)b * Sq + r0) * H + h) * D, (size_t)H * D, Sq - r0,
                 t >= FOLD);
  }
  if (T == 1 || n_tiles == 0)
    write_rows<1>(acc, dq + (((size_t)b * Sq + r0) * H + h) * D, (size_t)H * D, Sq - r0, false);
}

// ===========================================================================
// dK / dV
// ===========================================================================

// tm_q, tm_do, tm_k, tm_v as for dQ; tm_lse, tm_delta: lse and delta as 1-D
// maps over [B * H * Sq] (boxes of VBOX); tm_seg: seg_q (1-D) when seg_q is
// given.
template <int D, int T>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_lse, const __grid_constant__ CUtensorMap tm_delta,
    const __grid_constant__ CUtensorMap tm_seg, const int* __restrict__ band,
    const int* __restrict__ seg_kv, typename OutType<T>::type* __restrict__ dk,
    typename OutType<T>::type* __restrict__ dv, int B, int Sq, int Skv, int H, int Hkv,
    float scale, int stride_q, int stride_kv) {
  using C = Cfg<D, T>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + T * C::RTILE;  // resident
  // stage s: q terms, dO terms, then lse, delta, seg_q [VBOX] each
  const uint32_t sRing = base + C::RES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * ROWS;  // causal: the first keys see the most rows
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const bool has_seg = seg_kv != nullptr;
  const long long q_off = band[0], kv_off = band[1], lo = band[2], hi = band[3];
  const float sl2 = scale * kLog2e;

  // the visible query interval of this CTA's keys, solved from the band:
  // lo <= (q_off + sq*i) - (kv_off + skv*j) <= hi
  const int c_last = min(c0 + ROWS, Skv) - 1;
  const long long kmin = kv_off + (long long)stride_kv * c0;
  const long long kmax = kv_off + (long long)stride_kv * c_last;
  long long ilo = ceil_div(kmin + lo - q_off, stride_q);
  long long ihi = floor_div(kmax + hi - q_off, stride_q);
  if (ilo < 0) ilo = 0;
  if (ihi > Sq - 1) ihi = Sq - 1;
  const int nq = ihi >= ilo ? (int)((ihi - ilo) / ROWS) + 1 : 0;
  const int n_tiles = g * nq;  // tile u: head hk * g + u / nq, rows ilo + (u % nq) * 64

  Ring<STAGES> ring;
  ring.init(base + C::BAR_OFF, NT);
  auto load_q = [&](int u) {  // thread 0
    const uint32_t full = ring.claim(u);
    const uint32_t dst = sRing + (u % STAGES) * C::STAGE;
    mbar_expect_tx(full, C::STR + (has_seg ? 3 : 2) * VBOX * 4);
    const int h = hk * g + u / nq;
    const int i0 = (int)(ilo + (long long)(u % nq) * ROWS);
    load_tile<D, T, ROWS>(dst, &tm_q, full, h, i0, b, B);
    load_tile<D, T, ROWS>(dst + T * C::STILE, &tm_do, full, h, i0, b, B);
    const int li = (b * H + h) * Sq + i0;
    tma_load_1d(dst + C::STR, &tm_lse, full, li & ~3);
    tma_load_1d(dst + C::STR + VSTRIDE, &tm_delta, full, li & ~3);
    if (has_seg) tma_load_1d(dst + C::STR + 2 * VSTRIDE, &tm_seg, full, i0 & ~3);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(ring.res, C::RES);
    load_tile<D, T, ROWS>(sK, &tm_k, ring.res, hk, c0, b, B);
    load_tile<D, T, ROWS>(sV, &tm_v, ring.res, hk, c0, b, B);
    for (int u = 0; u < STAGES && u < n_tiles; ++u) load_q(u);
  }
  __syncwarp();

  // this thread's two keys (accumulator rows lane/4 and lane/4 + 8 of its warp)
  long long kpos[2];
  int segk[2];
  bool key_ok[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int key = c0 + warp * 16 + lane / 4 + 8 * h2;
    key_ok[h2] = key < Skv;
    kpos[h2] = kv_off + (long long)stride_kv * key;
    segk[h2] = (has_seg && key_ok[h2]) ? seg_kv[key] : 0;
  }

  float acc_k[C::NCB][C::CB / 2], acc_v[C::NCB][C::CB / 2];
#pragma unroll
  for (int c = 0; c < C::NCB; ++c)
#pragma unroll
    for (int e = 0; e < C::CB / 2; ++e) acc_k[c][e] = acc_v[c][e] = 0.f;

  if (n_tiles > 0) mbar_wait(ring.res, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t sQ = sRing + (t % STAGES) * C::STAGE, sDO = sQ + T * C::STILE;
    const long long i0 = ilo + (long long)(t % nq) * ROWS, i1 = i0 + ROWS - 1;
    const int li = (b * H + hk * g + t / nq) * Sq + (int)i0;
    const uint8_t* vec = sbase + (sQ - base) + C::STR;
    const float* lse_s = reinterpret_cast<const float*>(vec) + (li & 3);
    const float* delta_s = reinterpret_cast<const float*>(vec + VSTRIDE) + (li & 3);
    const int* segq_s = reinterpret_cast<const int*>(vec + 2 * VSTRIDE) + (i0 & 3);
    ring.wait_full(t);
    float s[32], dp[32];
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
    ss_products<D, T>(s, sK, sQ);    // S^T = K Q^T
    ss_products<D, T>(dp, sV, sDO);  // dP^T = V dO^T
    wgmma_commit();
    // does the band show the whole tile to every key of the CTA?
    const bool full = !has_seg && i1 <= ihi &&
                      (q_off + (long long)stride_q * i0) - kmax >= lo &&
                      (q_off + (long long)stride_q * i1) - kmin <= hi;
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    // element e: key row (e / 2) % 2 of this thread's pair, query column
    // (e / 4) * 8 + 2 * (lane % 4) + e % 2
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int h2 = (e / 2) % 2;
      const int col = (e / 4) * 8 + 2 * (lane % 4);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float p = fast_exp2(fmaf(s[e + x], sl2, -lse_s[col + x] * kLog2e));
        if (!full) {
          const long long row = i0 + col + x;
          const bool vis = key_ok[h2] && row <= ihi &&
                           band_visible(q_off + (long long)stride_q * row, kpos[h2], lo, hi) &&
                           (!has_seg || segq_s[col + x] == segk[h2]);
          p = vis ? p : 0.f;  // select, never multiply: exp2 is inf on an empty row
        }
        s[e + x] = p;
        dp[e + x] = p * (dp[e + x] - delta_s[col + x]) * scale;
      }
    }
    Frag<ROWS> fp, fds;
    make_frag<ROWS>(s, fp);
    make_frag<ROWS>(dp, fds);
#pragma unroll
    for (int c = 0; c < C::NCB; ++c) {
      fence_operands(acc_v[c]);
      fence_operands(acc_k[c]);
    }
    wgmma_fence();
    rs_products<D, T, C::NCB>(acc_v, fp, sDO);  // dV += P^T dO
    rs_products<D, T, C::NCB>(acc_k, fds, sQ);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::NCB; ++c) {
      fence_operands(acc_v[c]);
      fence_operands(acc_k[c]);
    }
    ring.release(t);
    if (tid == 0 && t + STAGES < n_tiles) load_q(t + STAGES);
    __syncwarp();
    if (T > 1 && ((t + 1) % FOLD == 0 || t + 1 == n_tiles)) {
      const size_t off = (((size_t)b * Skv + c0) * Hkv + hk) * D;
      write_rows<1>(acc_k, dk + off, (size_t)Hkv * D, Skv - c0, t >= FOLD);
      write_rows<1>(acc_v, dv + off, (size_t)Hkv * D, Skv - c0, t >= FOLD);
    }
  }
  if (T == 1 || n_tiles == 0) {
    const size_t off = (((size_t)b * Skv + c0) * Hkv + hk) * D;
    write_rows<1>(acc_k, dk + off, (size_t)Hkv * D, Skv - c0, false);
    write_rows<1>(acc_v, dv + off, (size_t)Hkv * D, Skv - c0, false);
  }
}

// ===========================================================================
// head dim 256: two warpgroups a CTA (see Design above)
// ===========================================================================

namespace wide {

constexpr int WG = 2;          // warpgroups a CTA, warpgroup w owning dims [128w, 128w + 128)
constexpr int BN = 32;         // rows of a streamed tile
constexpr int NE = BN / 2;     // a thread's elements of a 64 x BN score tile
constexpr int XB = 1, XA = 2;  // named barriers: exchange written, exchange read

// The swap of the two warpgroups' score tiles: warpgroup 0 holds P (or
// P^T) in s, warpgroup 1 dP (dP^T); a thread's element e goes to
// xch[w][e][thread] and comes back from the other warpgroup's slot, so that
// every thread leaves with P in s and dP in dp.  Barrier XA: the other
// warpgroup is done reading the last tile's; XB: this tile's are written.
__device__ __forceinline__ void swap_scores(float* xch, int wg, float (&s)[NE], float (&dp)[NE]) {
  const int i = threadIdx.x % NT;
  named_sync(XA, NT * WG);
#pragma unroll
  for (int e = 0; e < NE; ++e) xch[(wg * NE + e) * NT + i] = s[e];
  named_sync(XB, NT * WG);
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const float other = xch[((1 - wg) * NE + e) * NT + i];
    dp[e] = wg == 0 ? other : s[e];
    s[e] = wg == 0 ? s[e] : other;
  }
}

// dQ at D = 256: as the one-warpgroup kernel; warpgroup 0 issues S = Q K^T,
// warpgroup 1 dP = dO V^T.
template <int D, int T>
__global__ void __launch_bounds__(NT * WG) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_seg, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ band, const int* __restrict__ seg_q,
    typename OutType<T>::type* __restrict__ dq, int B, int Sq, int Skv, int H, int Hkv,
    float scale, int stride_q, int stride_kv) {
  using C = Cfg<D, T>;
  static_assert(C::WG == WG && C::BN == BN, "the wide kernels' tiling");
  constexpr int S = C::RING, NCW = C::NCB / WG;  // stages; column blocks of dQ a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  float* const xch = reinterpret_cast<float*>(sbase + C::XCH_OFF);
  const uint32_t sQ = base, sDO = base + T * C::RTILE;  // resident
  const uint32_t sRing = base + C::RES;  // stage s: k terms, v terms, seg_kv [VBOX]

  const int tid = threadIdx.x, wg = tid / NT, warp = (tid % NT) / 32, lane = tid % 32;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest tiles first (causal)
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const bool has_seg = seg_q != nullptr;
  const long long q_off = band[0], kv_off = band[1], lo = band[2], hi = band[3];
  const float sl2 = scale * kLog2e;

  // the visible key interval of this CTA's rows, solved from the band
  const int r_last = min(r0 + ROWS, Sq) - 1;
  const long long qmin = q_off + (long long)stride_q * r0;
  const long long qmax = q_off + (long long)stride_q * r_last;
  long long jlo = ceil_div(qmin - hi - kv_off, stride_kv);
  long long jhi = floor_div(qmax - lo - kv_off, stride_kv);
  if (jlo < 0) jlo = 0;
  if (jhi > Skv - 1) jhi = Skv - 1;
  const int n_tiles = jhi >= jlo ? (int)((jhi - jlo) / BN) + 1 : 0;

  Ring<S> ring;
  ring.init(base + C::BAR_OFF, NT * WG);
  auto load_kv = [&](int u) {  // thread 0
    const uint32_t full = ring.claim(u);
    const uint32_t dst = sRing + (u % S) * C::STAGE;
    mbar_expect_tx(full, C::STR + (has_seg ? VBOX * 4 : 0));
    const int j0 = (int)(jlo + (long long)u * BN);
    load_tile<D, T, BN>(dst, &tm_k, full, hk, j0, b, B);
    load_tile<D, T, BN>(dst + T * C::STILE, &tm_v, full, hk, j0, b, B);
    if (has_seg) tma_load_1d(dst + C::STR, &tm_seg, full, j0 & ~3);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(ring.res, C::RES);
    load_tile<D, T, ROWS>(sQ, &tm_q, ring.res, h, r0, b, B);
    load_tile<D, T, ROWS>(sDO, &tm_do, ring.res, h, r0, b, B);
    for (int u = 0; u < S && u < n_tiles; ++u) load_kv(u);
  }
  __syncwarp();

  // this thread's two rows (accumulator rows lane/4 and lane/4 + 8 of its warp)
  long long qpos[2];
  int segq[2];
  bool row_ok[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = r0 + warp * 16 + lane / 4 + 8 * h2;
    row_ok[h2] = row < Sq;
    qpos[h2] = q_off + (long long)stride_q * row;
    segq[h2] = (has_seg && row_ok[h2]) ? seg_q[row] : 0;
    const size_t li = ((size_t)b * H + h) * Sq + (row_ok[h2] ? row : 0);
    lse2[h2] = row_ok[h2] ? lse[li] * kLog2e : 0.f;
    dlt[h2] = row_ok[h2] ? delta[li] : 0.f;
  }

  float acc[NCW][C::CB / 2];
#pragma unroll
  for (int c = 0; c < NCW; ++c)
#pragma unroll
    for (int e = 0; e < C::CB / 2; ++e) acc[c][e] = 0.f;
  typename OutType<T>::type* const out =
      dq + (((size_t)b * Sq + r0) * H + h) * D + wg * NCW * C::CB;

  if (n_tiles > 0) mbar_wait(ring.res, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t sK = sRing + (t % S) * C::STAGE, sV = sK + T * C::STILE;
    const long long j0 = jlo + (long long)t * BN, j1 = j0 + BN - 1;
    const int* segk = reinterpret_cast<const int*>(sbase + (sK - base) + C::STR) + (j0 & 3);
    ring.wait_full(t);
    float s[NE];
    fence_operands(s);
    wgmma_fence();
    ss_products<D, T>(s, wg == 0 ? sQ : sDO, wg == 0 ? sK : sV);  // S, or dP
    wgmma_commit();
    // does the band show the whole tile to every row of the CTA?
    const bool full = !has_seg && j1 <= jhi && qmin - (kv_off + (long long)stride_kv * j1) >= lo &&
                      qmax - (kv_off + (long long)stride_kv * j0) <= hi;
    wgmma_wait<0>();
    fence_operands(s);
    // warpgroup 0: P from S.  Element e: row (e / 2) % 2 of this thread's
    // pair, key column (e / 4) * 8 + 2 * (lane % 4) + e % 2
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int h2 = (e / 2) % 2;
      float p = fast_exp2(fmaf(s[e], sl2, -lse2[h2]));
      if (!full) {
        const int col = (e / 4) * 8 + 2 * (lane % 4) + e % 2;
        const long long key = j0 + col;
        const bool vis = row_ok[h2] && key <= jhi &&
                         band_visible(qpos[h2], kv_off + (long long)stride_kv * key, lo, hi) &&
                         (!has_seg || segq[h2] == segk[col]);
        p = vis ? p : 0.f;  // select, never multiply: exp2 is inf on an empty row
      }
      s[e] = wg == 0 ? p : s[e];
    }
    float dp[NE];
    swap_scores(xch, wg, s, dp);  // s: P
#pragma unroll
    for (int e = 0; e < NE; ++e) dp[e] = s[e] * (dp[e] - dlt[(e / 2) % 2]) * scale;
    Frag<BN> fds;
    make_frag<BN>(dp, fds);
#pragma unroll
    for (int c = 0; c < NCW; ++c) fence_operands(acc[c]);
    wgmma_fence();
    rs_products<D, T, NCW>(acc, fds, sK + wg * NCW * BN * C::SWB);  // this warpgroup's dims
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCW; ++c) fence_operands(acc[c]);
    ring.release(t);
    if (tid == 0 && t + S < n_tiles) load_kv(t + S);
    __syncwarp();
    if (T > 1 && ((t + 1) % FOLD == 0 || t + 1 == n_tiles))
      write_rows<WG>(acc, out, (size_t)H * D, Sq - r0, t >= FOLD);
  }
  if (T == 1 || n_tiles == 0) write_rows<WG>(acc, out, (size_t)H * D, Sq - r0, false);
}

// dK / dV at D = 256: as the one-warpgroup kernel; warpgroup 0 issues S^T =
// K Q^T, warpgroup 1 dP^T = V dO^T.
template <int D, int T>
__global__ void __launch_bounds__(NT * WG) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_lse, const __grid_constant__ CUtensorMap tm_delta,
    const __grid_constant__ CUtensorMap tm_seg, const int* __restrict__ band,
    const int* __restrict__ seg_kv, typename OutType<T>::type* __restrict__ dk,
    typename OutType<T>::type* __restrict__ dv, int B, int Sq, int Skv, int H, int Hkv,
    float scale, int stride_q, int stride_kv) {
  using C = Cfg<D, T>;
  static_assert(C::WG == WG && C::BN == BN, "the wide kernels' tiling");
  constexpr int S = C::RING, NCW = C::NCB / WG;  // stages; column blocks of dK, dV a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  float* const xch = reinterpret_cast<float*>(sbase + C::XCH_OFF);
  const uint32_t sK = base, sV = base + T * C::RTILE;  // resident
  // stage s: q terms, dO terms, then lse, delta, seg_q [VBOX] each
  const uint32_t sRing = base + C::RES;

  const int tid = threadIdx.x, wg = tid / NT, warp = (tid % NT) / 32, lane = tid % 32;
  const int c0 = blockIdx.x * ROWS;  // causal: the first keys see the most rows
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const bool has_seg = seg_kv != nullptr;
  const long long q_off = band[0], kv_off = band[1], lo = band[2], hi = band[3];
  const float sl2 = scale * kLog2e;

  // the visible query interval of this CTA's keys, solved from the band:
  // lo <= (q_off + sq*i) - (kv_off + skv*j) <= hi
  const int c_last = min(c0 + ROWS, Skv) - 1;
  const long long kmin = kv_off + (long long)stride_kv * c0;
  const long long kmax = kv_off + (long long)stride_kv * c_last;
  long long ilo = ceil_div(kmin + lo - q_off, stride_q);
  long long ihi = floor_div(kmax + hi - q_off, stride_q);
  if (ilo < 0) ilo = 0;
  if (ihi > Sq - 1) ihi = Sq - 1;
  const int nq = ihi >= ilo ? (int)((ihi - ilo) / BN) + 1 : 0;
  const int n_tiles = g * nq;  // tile u: head hk * g + u / nq, rows ilo + (u % nq) * BN

  Ring<S> ring;
  ring.init(base + C::BAR_OFF, NT * WG);
  auto load_q = [&](int u) {  // thread 0
    const uint32_t full = ring.claim(u);
    const uint32_t dst = sRing + (u % S) * C::STAGE;
    mbar_expect_tx(full, C::STR + (has_seg ? 3 : 2) * VBOX * 4);
    const int h = hk * g + u / nq;
    const int i0 = (int)(ilo + (long long)(u % nq) * BN);
    load_tile<D, T, BN>(dst, &tm_q, full, h, i0, b, B);
    load_tile<D, T, BN>(dst + T * C::STILE, &tm_do, full, h, i0, b, B);
    const int li = (b * H + h) * Sq + i0;
    tma_load_1d(dst + C::STR, &tm_lse, full, li & ~3);
    tma_load_1d(dst + C::STR + VSTRIDE, &tm_delta, full, li & ~3);
    if (has_seg) tma_load_1d(dst + C::STR + 2 * VSTRIDE, &tm_seg, full, i0 & ~3);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(ring.res, C::RES);
    load_tile<D, T, ROWS>(sK, &tm_k, ring.res, hk, c0, b, B);
    load_tile<D, T, ROWS>(sV, &tm_v, ring.res, hk, c0, b, B);
    for (int u = 0; u < S && u < n_tiles; ++u) load_q(u);
  }
  __syncwarp();

  // this thread's two keys (accumulator rows lane/4 and lane/4 + 8 of its warp)
  long long kpos[2];
  int segk[2];
  bool key_ok[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int key = c0 + warp * 16 + lane / 4 + 8 * h2;
    key_ok[h2] = key < Skv;
    kpos[h2] = kv_off + (long long)stride_kv * key;
    segk[h2] = (has_seg && key_ok[h2]) ? seg_kv[key] : 0;
  }

  float acc_k[NCW][C::CB / 2], acc_v[NCW][C::CB / 2];
#pragma unroll
  for (int c = 0; c < NCW; ++c)
#pragma unroll
    for (int e = 0; e < C::CB / 2; ++e) acc_k[c][e] = acc_v[c][e] = 0.f;
  const size_t off = (((size_t)b * Skv + c0) * Hkv + hk) * D + wg * NCW * C::CB;

  if (n_tiles > 0) mbar_wait(ring.res, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t sQ = sRing + (t % S) * C::STAGE, sDO = sQ + T * C::STILE;
    const long long i0 = ilo + (long long)(t % nq) * BN, i1 = i0 + BN - 1;
    const int li = (b * H + hk * g + t / nq) * Sq + (int)i0;
    const uint8_t* vec = sbase + (sQ - base) + C::STR;
    const float* lse_s = reinterpret_cast<const float*>(vec) + (li & 3);
    const float* delta_s = reinterpret_cast<const float*>(vec + VSTRIDE) + (li & 3);
    const int* segq_s = reinterpret_cast<const int*>(vec + 2 * VSTRIDE) + (i0 & 3);
    ring.wait_full(t);
    float s[NE];
    fence_operands(s);
    wgmma_fence();
    ss_products<D, T>(s, wg == 0 ? sK : sV, wg == 0 ? sQ : sDO);  // S^T, or dP^T
    wgmma_commit();
    // does the band show the whole tile to every key of the CTA?
    const bool full = !has_seg && i1 <= ihi &&
                      (q_off + (long long)stride_q * i0) - kmax >= lo &&
                      (q_off + (long long)stride_q * i1) - kmin <= hi;
    wgmma_wait<0>();
    fence_operands(s);
    // warpgroup 0: P^T from S^T.  Element e: key row (e / 2) % 2 of this
    // thread's pair, query column (e / 4) * 8 + 2 * (lane % 4) + e % 2
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int h2 = (e / 2) % 2;
      const int col = (e / 4) * 8 + 2 * (lane % 4) + e % 2;
      float p = fast_exp2(fmaf(s[e], sl2, -lse_s[col] * kLog2e));
      if (!full) {
        const long long row = i0 + col;
        const bool vis = key_ok[h2] && row <= ihi &&
                         band_visible(q_off + (long long)stride_q * row, kpos[h2], lo, hi) &&
                         (!has_seg || segq_s[col] == segk[h2]);
        p = vis ? p : 0.f;  // select, never multiply: exp2 is inf on an empty row
      }
      s[e] = wg == 0 ? p : s[e];
    }
    float dp[NE];
    swap_scores(xch, wg, s, dp);  // s: P^T
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int col = (e / 4) * 8 + 2 * (lane % 4) + e % 2;
      dp[e] = s[e] * (dp[e] - delta_s[col]) * scale;
    }
    Frag<BN> fp, fds;
    make_frag<BN>(s, fp);
    make_frag<BN>(dp, fds);
#pragma unroll
    for (int c = 0; c < NCW; ++c) {
      fence_operands(acc_v[c]);
      fence_operands(acc_k[c]);
    }
    wgmma_fence();
    const uint32_t half = wg * NCW * BN * C::SWB;  // this warpgroup's column blocks
    rs_products<D, T, NCW>(acc_v, fp, sDO + half);  // dV += P^T dO
    rs_products<D, T, NCW>(acc_k, fds, sQ + half);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCW; ++c) {
      fence_operands(acc_v[c]);
      fence_operands(acc_k[c]);
    }
    ring.release(t);
    if (tid == 0 && t + S < n_tiles) load_q(t + S);
    __syncwarp();
    if (T > 1 && ((t + 1) % FOLD == 0 || t + 1 == n_tiles)) {
      write_rows<WG>(acc_k, dk + off, (size_t)Hkv * D, Skv - c0, t >= FOLD);
      write_rows<WG>(acc_v, dv + off, (size_t)Hkv * D, Skv - c0, t >= FOLD);
    }
  }
  if (T == 1 || n_tiles == 0) {
    write_rows<WG>(acc_k, dk + off, (size_t)Hkv * D, Skv - c0, false);
    write_rows<WG>(acc_v, dv + off, (size_t)Hkv * D, Skv - c0, false);
  }
}

}  // namespace wide

// ===========================================================================
// the fp32 pre-pass: q, k, v, dO as two bf16 terms each
// ===========================================================================

__global__ void __launch_bounds__(256) flash_bwd_split_kernel(SplitArgs a) {
  split_terms_body(a);
}

// ===========================================================================
// launchers
// ===========================================================================

// a [B * T, S, heads, D] bf16 array as a 4-D map (D, heads, S, B * T), boxes
// of one column block x BN rows, swizzled as wgmma reads them
template <int D>
bool encode_rows(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int BT, int S,
                 int heads) {
  constexpr int CB = Cfg<D, 1>::CB;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)BT};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CB, 1, (cuuint32_t)Cfg<D, 1>::BN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                Cfg<D, 1>::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a flat [n] array of 4-byte values (fp32 or int32) as a 1-D map, boxes of
// VBOX
bool encode_vec(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, long long n,
                CUtensorMapDataType type) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};  // unused for one dimension
  const cuuint32_t box[1] = {(cuuint32_t)VBOX};
  const cuuint32_t unit[1] = {1};
  return encode(map, type, 1, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *band, *seg_q, *seg_kv;
  void *out0, *out1;
  int B, Sq, Skv, H, Hkv;
  float scale;
  int stride_q, stride_kv;
  cudaStream_t stream;
};

// the four operand maps (q, k, v, dO) and seg_kv's or seg_q's
template <int D, int T>
cudaError_t encode_operands(const Args& a, CUtensorMap (&m)[4]) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const bool ok = encode_rows<D>(encode, &m[0], a.q, a.B * T, a.Sq, a.H) &&
                  encode_rows<D>(encode, &m[1], a.k, a.B * T, a.Skv, a.Hkv) &&
                  encode_rows<D>(encode, &m[2], a.v, a.B * T, a.Skv, a.Hkv) &&
                  encode_rows<D>(encode, &m[3], a.dout, a.B * T, a.Sq, a.H);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// the kernels of head dim D: one warpgroup a CTA, or two (wide::, D = 256)
template <int D, int T>
constexpr auto dq_kernel() {
  if constexpr (Cfg<D, T>::WG > 1)
    return wide::flash_bwd_dq_kernel<D, T>;
  else
    return flash_bwd_dq_kernel<D, T>;
}
template <int D, int T>
constexpr auto dkv_kernel() {
  if constexpr (Cfg<D, T>::WG > 1)
    return wide::flash_bwd_dkv_kernel<D, T>;
  else
    return flash_bwd_dkv_kernel<D, T>;
}

template <int D, int T>
cudaError_t launch_dq(const Args& a) {
  CUtensorMap m[4], tm_seg;
  memset(&tm_seg, 0, sizeof(tm_seg));
  cudaError_t err = encode_operands<D, T>(a, m);
  if (err != cudaSuccess) return err;
  if (a.seg_kv != nullptr &&
      !encode_vec(encode_tiled(), &tm_seg, a.seg_kv, a.Skv, CU_TENSOR_MAP_DATA_TYPE_INT32))
    return cudaErrorInvalidValue;
  const int smem = Cfg<D, T>::SMEM;
  auto kern = dq_kernel<D, T>();
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + ROWS - 1) / ROWS, a.H, a.B);
  kern<<<grid, NT * Cfg<D, T>::WG, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], tm_seg, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.band),
      static_cast<const int*>(a.seg_q), static_cast<typename OutType<T>::type*>(a.out0), a.B,
      a.Sq, a.Skv, a.H, a.Hkv, a.scale, a.stride_q, a.stride_kv);
  return cudaGetLastError();
}

template <int D, int T>
cudaError_t launch_dkv(const Args& a) {
  CUtensorMap m[4], tm_lse, tm_delta, tm_seg;
  memset(&tm_seg, 0, sizeof(tm_seg));
  cudaError_t err = encode_operands<D, T>(a, m);
  if (err != cudaSuccess) return err;
  const EncodeTiledFn encode = encode_tiled();
  const long long rows = (long long)a.B * a.H * a.Sq;
  if (!encode_vec(encode, &tm_lse, a.lse, rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !encode_vec(encode, &tm_delta, a.delta, rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      (a.seg_q != nullptr &&
       !encode_vec(encode, &tm_seg, a.seg_q, a.Sq, CU_TENSOR_MAP_DATA_TYPE_INT32)))
    return cudaErrorInvalidValue;
  const int smem = Cfg<D, T>::SMEM;
  auto kern = dkv_kernel<D, T>();
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Skv + ROWS - 1) / ROWS, a.Hkv, a.B);
  kern<<<grid, NT * Cfg<D, T>::WG, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], tm_lse, tm_delta, tm_seg, static_cast<const int*>(a.band),
      static_cast<const int*>(a.seg_kv), static_cast<typename OutType<T>::type*>(a.out0),
      static_cast<typename OutType<T>::type*>(a.out1), a.B, a.Sq, a.Skv, a.H, a.Hkv, a.scale,
      a.stride_q, a.stride_kv);
  return cudaGetLastError();
}

template <bool DKV, int T>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 32: return DKV ? launch_dkv<32, T>(a) : launch_dq<32, T>(a);
    case 64: return DKV ? launch_dkv<64, T>(a) : launch_dq<64, T>(a);
    case 96: return DKV ? launch_dkv<96, T>(a) : launch_dq<96, T>(a);
    case 128: return DKV ? launch_dkv<128, T>(a) : launch_dq<128, T>(a);
    case 256: return DKV ? launch_dkv<256, T>(a) : launch_dq<256, T>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int dispatch(int terms, int D, const Args& a) {
  if (a.H % a.Hkv != 0 || a.stride_q < 1 || a.stride_kv < 1 || a.B < 1 || a.Sq < 1 || a.Skv < 1)
    return (int)cudaErrorInvalidValue;
  if ((a.seg_q == nullptr) != (a.seg_kv == nullptr)) return (int)cudaErrorInvalidValue;
  if (terms == 1) return (int)dispatch_d<DKV, 1>(D, a);
  if (terms == 2) return (int)dispatch_d<DKV, 2>(D, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, dout: [terms, B, Sq, H, D] bf16; k, v: [terms, B, Skv, Hkv, D] bf16 --
// the inputs themselves (terms = 1, bf16 inputs) or flash_bwd_split's hi and
// lo terms (terms = 2, fp32 inputs), each 16-byte aligned; lse, delta: fp32
// [B, H, Sq], 16-byte aligned; band: int32 [4] on the device; seg_q [Sq] and
// seg_kv [Skv] int32 (16-byte aligned) or both null.  dq: [B, Sq, H, D],
// bf16 for terms = 1 and fp32 for terms = 2.  Returns cudaGetLastError()
// after the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* band,
                            const void* seg_q, const void* seg_kv, void* dq, int B, int Sq,
                            int Skv, int H, int Hkv, int D, float scale, int stride_q,
                            int stride_kv, int terms, void* stream) {
  Args a{q, k, v, dout, lse, delta, band, seg_q, seg_kv, dq, nullptr,
         B, Sq, Skv, H, Hkv, scale, stride_q, stride_kv, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(terms, D, a);
}

// As flash_bwd_dq; dk, dv: [B, Skv, Hkv, D] in dq's type, each summed over the
// query heads of its GQA group.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* band,
                             const void* seg_q, const void* seg_kv, void* dk, void* dv, int B,
                             int Sq, int Skv, int H, int Hkv, int D, float scale, int stride_q,
                             int stride_kv, int terms, void* stream) {
  Args a{q, k, v, dout, lse, delta, band, seg_q, seg_kv, dk, dv,
         B, Sq, Skv, H, Hkv, scale, stride_q, stride_kv, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(terms, D, a);
}

// The fp32 pre-pass (sm90.cuh's split_terms_body): count <= 4 fp32 arrays
// src[i] of n[i] values (q, k, v, dout) into [2, n[i]] bf16 terms (hi, then
// lo) at dst[i].
extern "C" int flash_bwd_split(const void* const* src, void* const* dst, const long long* n,
                               int count, void* stream) {
  return (int)launch_split(flash_bwd_split_kernel, src, dst, n, count,
                           static_cast<cudaStream_t>(stream));
}
