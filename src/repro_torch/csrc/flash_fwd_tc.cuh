// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 and fp32
// inputs: the kernels and their launchers, instantiated by two libraries with
// a plain C interface for ctypes, each built by its own nvcc (all at once):
// csrc/flash_fwd_tc.cu (head dims 32, 64, 128 and 256: both bodies, the
// combine, the fp32 pre-pass) and csrc/flash_fwd_mla.cu (MLA's head dims 96
// and 288: the tile body).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd
//   (Pallas body _fwd_kernel, with _block_visible / _mask_block) for both
//   input types.
//
// What it computes: o = softmax(scale * q k^T + mask) v and the fp32 row
// log-sum-exp, for q [B, Sq, H, D] and k, v [B, Skv, Hkv, D] (GQA: query
// head h reads kv head h / (H / Hkv)); the mask is the int32 band (q_off,
// kv_off, lo, hi) -- (i, j) visible iff lo <= (q_off + stride_q*i) -
// (kv_off + stride_kv*j) <= hi -- with static strides, one [4] band or one
// per batch row ([B, 4]) in device memory, composed with optional per-token
// segment ids.  An empty row has o = 0 and lse = NEG_INF exactly.  o comes
// out in the input type.
//
// Numerics: every product takes bf16 operands and sums in fp32 (a bf16 x
// bf16 product is exact in fp32); the scale is applied to the fp32 scores and
// the softmax is fp32.  T, the bf16 terms per input value, is a template
// argument of both bodies:
//   * bf16 inputs (T = 1) are one exact term each;
//   * fp32 inputs (T = 2) go in as hi + lo terms (hi = bf16(x), lo = bf16(x -
//     hi): ~16 of fp32's 24 bits), written by a pre-pass
//     (flash_fwd_split_kernel, one launch per forward call) into scratch the
//     wrapper allocates; the bodies load the terms like bf16 tiles.  S = Q K^T
//     runs the term pairs i + j < T (hi.hi + hi.lo + lo.hi).
//     tests/test_torch_fwd_split.py settled T against the JAX forward: T = 2
//     reads 0.13-0.20 of the fp32 gate (1e-4 on o and lse) at unit-normal
//     inputs and 0.59-0.74 where |o| reaches 12; T = 1 reads 75-440x it.
//   * P enters P.V as three bf16 terms, hi + mid + lo, which carry fp32's 24
//     bits; P.V runs the pairs i + j < max(3, T) of P's and V's terms.  A
//     single bf16 P (|error| up to 2^-8 p) moves o by up to 2^-8 max|v| and
//     flips o's own bf16 rounding often enough to break a 1e-2 limit where
//     |o| >= 2 (one ulp there is 2^-6); two terms (2^-16 p) still flipped one
//     element of the S=2048 segment case on the card.
//   * the tensor cores truncate as they accumulate.  With fp32 outputs the
//     tile body adds its o accumulators into o (rescaled to the running max,
//     round to nearest) every FOLD tiles and restarts them from 0, so no
//     accumulator sums more than FOLD tiles of a long row (16,384 keys on the
//     mesh path); the backward does the same (flash_bwd.cu's FOLD).
//
// Two bodies, chosen by the wrapper from the shapes alone:
//
// (a) flash_fwd_tile_kernel -- prefill, packed prefill, chunks, windows,
//   training.  What bounds it: 4*D flops per visible (query, key) pair
//   against 2*D*(Sq*H + 2*Skv*Hkv) bytes -- far above the card's ~295
//   flop/byte balance at prefill lengths, so the tensor cores (and, beside
//   them, the softmax's exponentials); fp32 inputs issue 3 + 5 products
//   where bf16 issues 1 + 3.
//   * one CTA per (tile of 128 packed rows, kv head, batch row); a packed
//     row is a (query row, head of the GQA group) pair, r = i*G + g, so the
//     G heads of one kv head share each K/V tile load (G x fewer K/V bytes)
//     and a row's position, band and segment id are those of its query row;
//   * two warpgroups of 64 packed rows; S = Q K^T and O += P V on wgmma
//     (m64n64k16, bf16 operands, fp32 accumulators): Q (loaded once, all
//     terms) and the K tile from shared memory, P from registers, V from
//     shared memory (MN-major);
//   * K and V tiles of 64 keys (all terms) in two rings of STAGES stages
//     each (4; 2 for fp32 at D = 128, where Q's two terms take 64 KB of the
//     227 KB), loaded by TMA (one thread of warpgroup 1, the later of the
//     two; 128-byte-swizzled boxes of 64 dims, 64-byte for D = 32, as wgmma
//     reads them).  Tile t's K is free once both warpgroups have its scores'
//     softmax, its V once both have its P.V products: K tile t + STAGES and
//     V tile t + STAGES - 1 load then, a whole tile ahead with 2 stages;
//     mbarriers say when a tile has landed (full) and when both warpgroups
//     are done with it (empty);
//   * no CTA-wide barrier in the loop: the warpgroups take turns issuing
//     their products (named barriers), so one's softmax runs while the
//     other's products do; within a warpgroup, tile j's scores are issued
//     beside tile j-1's P.V products;
//   * the products are issued in straight-line code, the same for every
//     tile (a data-dependent branch around a wgmma makes the compiler
//     serialize them all);
//   * the key interval is solved from the band per CTA (tiles the band hides
//     are never loaded); a warpgroup's softmax takes a tile unmasked when the
//     band and segments show all of it to its rows, and masks element by
//     element only otherwise;
//   * tiles run heaviest first (causal prefill: the last rows first);
//   * head dim 256 (gemma-7b): a warpgroup's o over 64 rows x 256 dims is
//     128 fp32 registers a thread, so the key tile is 32 (S 16 registers,
//     P's three terms 24) and S = Q K^T runs on m64n32k16; fp32 inputs
//     there take one warpgroup of 64 rows a CTA (Q's two terms at 128 rows
//     would take 128 KB) over two rings of two stages (TileCfg);
//   * head dims 96 and 288 (minicpm3-4b's MLA: prefill over the expanded
//     heads at 96, chunks, verifies and dense-cache decode ticks over the
//     absorbed latent at 288, 40 query heads on one kv head, every row
//     count): 32-dim column blocks of 64-byte swizzle (TMA boxes of 32
//     dims, P.V on m64n32k16 per block), so neither is padded; D = 288
//     takes D = 256's tile and warpgroups, o at 144 registers a thread.
//
// (b) flash_fwd_decode_kernel -- at most 32 packed rows (Sq * G <= 32: a
//   decode tick, a speculative verify; 16 at D = 256, whose o accumulators
//   over 16 rows are already 128 registers a lane; none at D = 96 and 288,
//   which the tile body takes at every row count).  What bounds it: reading K and V of
//   the visible keys once per kv head (4*D flops per 4*D bytes).
//   * one CTA per (key split, kv head, batch row); 4 warps walk disjoint
//     16-key tiles of the split's share of the interval, each with its own
//     2-stage cp.async ring (all terms; one stage for fp32 at D = 256,
//     where two would not fit) and no block barrier, and products
//     on mma.sync.m16n8k16 (bf16, fp32 accumulators) over the G*Sq packed
//     rows;
//   * the warps' (m, l, acc) merge in shared memory in a fixed order; with
//     more than one split each CTA writes a normalized fp32 partial and its
//     lse, and flash_fwd_combine_kernel merges them by lse (fixed order, no
//     atomics: two launches are bitwise equal).  In both bodies and the
//     combine a NaN score makes its row's o and lse NaN, as in JAX's kernels
//     (the running maxima drop NaN, exp keeps it, the epilogues pass it; a
//     NaN input splits into NaN terms).

#pragma once

#include <string.h>

#include "sm90.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// PTX helpers (the rest are sm90.cuh's)
// ---------------------------------------------------------------------------

// shared memory written through the generic proxy (cp.async, st.shared), as
// seen by the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the arrive of this thread's earlier cp.asyncs on an mbarrier (counted in
// its init count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// named barriers over n threads (barrier 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ int named_count(int id, int n, bool pred) {
  int c;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %3, 0;\nbar.red.popc.u32 %0, %1, %2, p;\n}\n"
      : "=r"(c)
      : "r"(id), "r"(n), "r"((int)pred)
      : "memory");
  return c;
}



// visible iff lo <= (q position) - (kv_off + stride_kv * key) <= hi
__device__ __forceinline__ bool band_visible(long long qpos, long long key, long long kv_off,
                                             int stride_kv, long long lo, long long hi) {
  const long long diff = qpos - (kv_off + (long long)stride_kv * key);
  return diff >= lo && diff <= hi;
}


// ===========================================================================
// (a) the tile body
// ===========================================================================

constexpr int TB_STAGES = 4;  // stages of each K / V ring where they fit
// fp32 outputs: every FOLD tiles the o accumulators are added into o and
// restarted from 0 (see Numerics above)
constexpr int FOLD = 16;
// A 1-D TMA box must start on a 16-byte boundary in global memory and land
// 128-byte aligned in shared memory: a tile's key segment ids (from key j0)
// are loaded as a box of SEG_BOX ids from j0 & ~3 into a stage's
// TB_SEG_INTS slots and read from offset j0 & 3.
constexpr int TB_SEG_INTS = 96;

// T: bf16 terms per input value (1 for bf16 inputs, 2 for fp32 inputs).
// D <= 128: two warpgroups (128 packed rows a CTA) over 64-key tiles.
// D = 256: a warpgroup's o accumulators over 64 rows x 256 dims are 128
// fp32 registers a thread, so the key tile is 32 (S takes 16 registers, P's
// three terms 24, where 64 keys would take 32 and 48); and at T = 2 Q's two
// terms at 128 rows would take 128 KB of shared memory, so a CTA is one
// warpgroup of 64 rows (Q 64 KB, two rings of two 32 KB stages).
// D = 96 and 288 (MLA's expanded heads and its absorbed latent): rows of
// 32-dim column blocks of 64-byte swizzle (3 and 9 of them), as D = 32's one;
// D = 288 is D = 256's configuration with o at 144 registers a thread.
// The rings take 4 stages, or as many as fit the 227 KB (2 for fp32 at D >=
// 96: Q's two terms take 48-74 KB).
template <int D, int T>
struct TileCfg {
  static constexpr int WG = D >= 256 && T == 2 ? 1 : 2;  // warpgroups of 64 packed rows
  static constexpr int THREADS = 128 * WG;
  static constexpr int ROWS = 64 * WG;                 // packed rows per CTA
  static constexpr int BK = D >= 256 ? 32 : 64;        // keys per K/V tile
  static constexpr int SEG_BOX = BK + 4;
  static constexpr int SWB = D % 64 == 0 ? 128 : 64;   // swizzle span (bytes) = column block row
  static constexpr int CB = SWB / 2;                   // dims per column block
  static constexpr int NCB = D / CB;                   // column blocks
  static constexpr uint64_t LAYOUT = SWB == 128 ? 1 : 2;  // descriptor swizzle mode
  static constexpr int Q_TERM = ROWS * D * 2;          // one term of Q
  static constexpr int KV_TERM = BK * D * 2;           // one term of a K or V tile
  static constexpr int Q_BYTES = T * Q_TERM;
  static constexpr int KV_BYTES = T * KV_TERM;         // a K or V tile, all terms
  // the CTA's shared memory with TB_STAGES stages in each ring
  static constexpr int SMEM_FULL =
      1024 + Q_BYTES + 2 * TB_STAGES * (KV_BYTES + TB_SEG_INTS * 2) + (4 * TB_STAGES + 1) * 8;
  static constexpr int STAGES = SMEM_FULL <= 232448 ? TB_STAGES : 2;
  static constexpr int V_OFF = Q_BYTES + STAGES * KV_BYTES;       // K ring at Q_BYTES
  static constexpr int SEG_OFF = V_OFF + STAGES * KV_BYTES;       // int [stages][TB_SEG_INTS]
  static constexpr int BAR_OFF = SEG_OFF + STAGES * TB_SEG_INTS * 4;
  // u64 full_k, empty_k, full_v, empty_v [stages], q
  static constexpr int SMEM = 1024 + BAR_OFF + (4 * STAGES + 1) * 8;
  static_assert(SMEM <= 232448, "the tile does not fit shared memory");
};

template <int T> struct OutType { typedef float type; };  // fp32 inputs carry 2 terms
template <> struct OutType<1> { typedef bf16 type; };

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store1(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// byte offset of 16-byte chunk c8 of row r in a [rows, D] tile stored as
// column blocks [rows][SWB bytes], swizzled as wgmma reads them and TMA
// writes them: the chunk index XOR the 128-byte line's index within its
// 1024-byte (SWB = 128) or 512-byte (SWB = 64) atom
template <int D>
__device__ __forceinline__ uint32_t tile_off(int r, int c8, int rows) {
  using C = TileCfg<D, 1>;
  const uint32_t off =
      (c8 / (C::CB / 8)) * rows * C::SWB + r * C::SWB + (c8 % (C::CB / 8)) * 16;
  return off ^ (((off >> 7) & (C::SWB / 16 - 1)) << 4);
}

// P as the A operand of P.V: three bf16 terms per value, hi + mid + lo, so
// P carries fp32's 24 bits; keys 16u..16u+15 are the score accumulator's
// blocks 2u and 2u+1 (the m16n8 accumulator and A-fragment layouts agree)
template <int BK>
struct PFrag {
  uint32_t r[3][BK / 16][4];
};

template <int BK>
__device__ __forceinline__ void make_pfrag(const float (&p)[BK / 2], PFrag<BK>& f) {
#pragma unroll
  for (int u = 0; u < BK / 16; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      split3_bf16(p[8 * u + 2 * x], p[8 * u + 2 * x + 1], f.r[0][u][x], f.r[1][u][x],
                  f.r[2][u][x]);
}

// O += P V for one key tile: the pairs i + j < max(3, T) of P's terms and
// the T terms of the V tile at sV (term j at + j * KV_TERM).  V's tile is
// MN-major (dims contiguous); one product per column block, whose N fits
// one swizzle atom (the leading offset is then unused, so it takes the
// stride offset's value).  Issues and commits; the caller waits.
template <int D, int T>
__device__ __forceinline__ void pv_products(
    float (&oacc)[TileCfg<D, T>::NCB][TileCfg<D, T>::CB / 2],
    const PFrag<TileCfg<D, T>::BK>& p, uint32_t sV) {
  using C = TileCfg<D, T>;
  constexpr int NP = T > 3 ? T : 3;
#pragma unroll
  for (int u = 0; u < C::BK / 16; ++u) {
#pragma unroll
    for (int c = 0; c < C::NCB; ++c) {
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int j = 0; j < T; ++j) {
          if (term + j >= NP) continue;  // resolved at compile time
          const uint64_t dv = smem_desc(sV + j * C::KV_TERM + c * C::BK * C::SWB + u * 16 * C::SWB,
                                        8 * C::SWB, 8 * C::SWB, C::LAYOUT);
          if constexpr (C::CB == 64)
            wgmma_rs_m64n64(oacc[c], p.r[term][u], dv);
          else
            wgmma_rs_m64n32(oacc[c], p.r[term][u], dv);
        }
    }
  }
  wgmma_commit();
}

// S = Q K^T for one warpgroup's 64 rows and a key tile: the term pairs
// i + j < T of Q (term i at sQw + i * Q_TERM) and K (term j at sK + j *
// KV_TERM).  Issues and commits; the caller waits.
template <int D, int T>
__device__ __forceinline__ void qk_products(float (&s)[TileCfg<D, T>::BK / 2], uint32_t sQw,
                                            uint32_t sK) {
  using C = TileCfg<D, T>;
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; i + j < T; ++j)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t cb = (kk * 16) / C::CB, within = ((kk * 16) % C::CB) * 2;
        const uint64_t da = smem_desc(sQw + i * C::Q_TERM + cb * C::ROWS * C::SWB + within, 16,
                                      8 * C::SWB, C::LAYOUT);
        const uint64_t db = smem_desc(sK + j * C::KV_TERM + cb * C::BK * C::SWB + within, 16,
                                      8 * C::SWB, C::LAYOUT);
        if constexpr (C::BK == 64)
          wgmma_ss_m64n64(s, da, db, i + j + kk > 0);  // the first product overwrites s
        else
          wgmma_ss_m64n32(s, da, db, i + j + kk > 0);
      }
  wgmma_commit();
}

// what the per-element mask needs of this thread's two rows
struct RowMask {
  long long qpos[2];
  int seg[2];
};

// Online softmax of one tile's scores in the log2 domain: s becomes P
// (fp32), m2 / lsum move on, alpha rescales the rows' earlier accumulators.
// Element e of s (BK / 2 of them) sits at row (e / 2) % 2 of this thread's
// pair and key column (e / 4) * 8 + 2 * (lane % 4) + e % 2.
template <int BK>
__device__ __forceinline__ void tile_softmax(float (&s)[BK / 2], float (&m2)[2], float (&lsum)[2],
                                             float (&alpha)[2], bool full, float scale_log2,
                                             const RowMask& rm, const int* segk, long long j0,
                                             long long jhi, long long kv_off, int stride_kv,
                                             long long lo, long long hi, bool has_seg, int lane) {
  constexpr int NE = BK / 2;
  // the row max of the raw scores (scale > 0), hidden ones at -inf
  float rmax[2] = {neg_inf(), neg_inf()};
  if (!full) {
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int h2 = (e / 2) % 2;
      const int col = (e / 4) * 8 + 2 * (lane % 4) + e % 2;
      const long long key = j0 + col;
      const bool vis = key <= jhi && band_visible(rm.qpos[h2], key, kv_off, stride_kv, lo, hi) &&
                       (!has_seg || rm.seg[h2] == segk[col]);
      s[e] = vis ? s[e] : neg_inf();
    }
  }
#pragma unroll
  for (int e = 0; e < NE; ++e) rmax[(e / 2) % 2] = fmaxf(rmax[(e / 2) % 2], s[e]);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float m_new = fmaxf(m2[h2], quad_max(rmax[h2]) * scale_log2);
    alpha[h2] = fast_exp2(m2[h2] - m_new);
    m2[h2] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    s[e] = fast_exp2(fmaf(s[e], scale_log2, -m2[(e / 2) % 2]));
    psum[(e / 2) % 2] += s[e];
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) lsum[h2] = lsum[h2] * alpha[h2] + psum[h2];
}

// tm_k, tm_v: k and v (all terms: [T * B, Skv, Hkv, D]) as 4-D tensor maps
// (D, Hkv, Skv, B * T) with a box of one column block x BK keys; tm_seg:
// seg_kv (1-D, a box of SEG_BOX) when seg_q is given.  q: [T * B, Sq, H, D].
template <int D, int T>
__global__ void __launch_bounds__(TileCfg<D, T>::THREADS, 1) flash_fwd_tile_kernel(
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_seg, const bf16* __restrict__ q,
    const int* __restrict__ band, int band_stride, const int* __restrict__ seg_q,
    typename OutType<T>::type* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H,
    int Hkv, float scale_log2, int stride_q, int stride_kv) {
  using C = TileCfg<D, T>;
  constexpr int ON = C::CB;  // N of one P.V product: one column block of V
  constexpr int S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK0 = sQ + C::Q_BYTES;
  const uint32_t sV0 = sQ + C::V_OFF;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int G = H / Hkv;
  const int R = Sq * G;  // packed rows of this (batch row, kv head)
  const int r0 = (gridDim.x - 1 - blockIdx.x) * C::ROWS;  // heaviest tiles first
  const int hk = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const bool has_seg = seg_q != nullptr;
  // the thread that loads the K / V tiles: the last warpgroup's first, the
  // later of the two to be done with a tile
  const bool loader = tid == (C::WG - 1) * 128;

  const int* bd = band + (size_t)b * band_stride;
  const long long q_off = bd[0], kv_off = bd[1], lo = bd[2], hi = bd[3];

  // the CTA's visible key interval, solved from the band
  const int i_first = r0 / G, i_last = (min(r0 + C::ROWS, R) - 1) / G;
  long long jlo = ceil_div(q_off + (long long)stride_q * i_first - hi - kv_off, stride_kv);
  long long jhi = floor_div(q_off + (long long)stride_q * i_last - lo - kv_off, stride_kv);
  if (jlo < 0) jlo = 0;
  if (jhi > Skv - 1) jhi = Skv - 1;
  const int n_tiles = jhi >= jlo ? (int)((jhi - jlo) / C::BK) + 1 : 0;

  // this warpgroup's rows (one past R computes rows it never writes)
  const int wr0 = r0 + wg * 64;
  const long long wqmin = q_off + (long long)stride_q * (min(wr0, R - 1) / G);
  const long long wqmax = q_off + (long long)stride_q * (min(wr0 + 63, R - 1) / G);

  // this thread's two rows (accumulator rows lane/4 and lane/4 + 8 of its warp)
  int row_r[2];
  RowMask rm;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    row_r[h2] = wr0 + warp * 16 + lane / 4 + 8 * h2;
    const int i = min(row_r[h2], R - 1) / G;
    rm.qpos[h2] = q_off + (long long)stride_q * i;
    rm.seg[h2] = has_seg ? seg_q[i] : 0;
  }

  // Shared-memory rings: K tile u lives in stage u % S of the K ring (with
  // its keys' segment ids), V tile u in stage u % S of the V ring.  The
  // loader loads a tile with TMA; full_*[s] completes when its bytes have
  // landed, empty_*[s] when every thread is done with it: K tile t after the
  // softmax of its scores, V tile t after its P.V products.  The two
  // warpgroups run on these barriers, not on CTA-wide ones, so they drift
  // apart: they take turns issuing their products (named barriers 1 and 2),
  // and one warpgroup's softmax runs while the other's products do.
  const uint32_t full_k = sQ + C::BAR_OFF, empty_k = full_k + S * 8;
  const uint32_t full_v = empty_k + S * 8, empty_v = full_v + S * 8;
  const uint32_t bar_q = empty_v + S * 8;
  const uint32_t sSeg = sQ + C::SEG_OFF;
  // stage st's ids from the tile's first key (every tile starts at jlo mod 4)
  const int* segk = reinterpret_cast<const int*>(smem_raw + (sQ - raw) + C::SEG_OFF) + (jlo & 3);
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full_k + st * 8, 1);
      mbar_init(empty_k + st * 8, C::THREADS);
      mbar_init(full_v + st * 8, 1);
      mbar_init(empty_v + st * 8, C::THREADS);
    }
    mbar_init(bar_q, C::THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Q, once, by every thread's cp.asyncs (a packed row's heads are
  // contiguous, its query rows H * D apart; term i at + i * B * Sq * H * D)
#pragma unroll
  for (int term = 0; term < T; ++term) {
    constexpr int CH = D / 8;
    const size_t qb = ((size_t)term * B + b) * Sq * H * D;
    for (int idx = tid; idx < C::ROWS * CH; idx += C::THREADS) {
      const int r = idx / CH, c8 = idx % CH;
      const int pr = r0 + r;
      const bool valid = pr < R;
      const size_t off =
          valid ? qb + ((size_t)(pr / G) * H + hk * G + pr % G) * D + c8 * 8 : 0;
      cp_async16(sQ + term * C::Q_TERM + tile_off<D>(r, c8, C::ROWS), q + off, valid);
    }
  }
  cp_async_mbar_arrive(bar_q);
  // K or V tile u (the loader): wait until its stage's previous tile (u - S)
  // is free, then one box per term and column block, and with K the keys'
  // segment ids
  auto load_tile = [&](const CUtensorMap* map, uint32_t ring, uint32_t full0, uint32_t empty0,
                       int u, bool seg) {
    const int st = u % S;
    if (u >= S) mbar_wait(empty0 + st * 8, (u / S - 1) & 1);
    const uint32_t full = full0 + st * 8;
    mbar_expect_tx(full, C::KV_BYTES + (seg ? C::SEG_BOX * 4 : 0));
    const int j0 = (int)(jlo + (long long)u * C::BK);
#pragma unroll
    for (int term = 0; term < T; ++term)
#pragma unroll
      for (int c = 0; c < C::NCB; ++c)
        tma_load_4d(ring + st * C::KV_BYTES + term * C::KV_TERM + c * C::BK * C::SWB, map, full,
                    c * C::CB, hk, j0, b + term * B);
    if (seg) tma_load_1d(sSeg + st * TB_SEG_INTS * 4, &tm_seg, full, j0 & ~3);
  };
  auto load_k = [&](int u) { load_tile(&tm_k, sK0, full_k, empty_k, u, has_seg); };
  auto load_v = [&](int u) { load_tile(&tm_v, sV0, full_v, empty_v, u, false); };
  // after tile t's softmax and tile t-1's P.V: K tile t + S and V tile
  // t + S - 1 take the stages those two free
  auto load_next = [&](int t) {
    if (!loader) return;
    if (t + S < n_tiles) load_k(t + S);
    if (t + S - 1 < n_tiles) load_v(t + S - 1);
  };
  if (loader) {
    for (int u = 0; u < S && u < n_tiles; ++u) load_k(u);
    for (int u = 0; u < S - 1 && u < n_tiles; ++u) load_v(u);
  }

  // do all of this warpgroup's rows share one segment id?
  int rowseg = 0;
  bool rows_uniform = false;
  if (has_seg) {
    const int wi_first = min(wr0, R - 1) / G;
    const int n_i = min(wr0 + 63, R - 1) / G - wi_first + 1;  // <= 64
    rowseg = seg_q[wi_first];
    const int wt = tid % 128;
    rows_uniform = named_count(3 + wg, 128, wt < n_i && seg_q[wi_first + wt] != rowseg) == 0;
  }

  // K tile t has landed.  Returns whether the band and the segments show
  // all of it to this warpgroup's rows.
  auto begin_tile = [&](int t) -> bool {
    const int st = t % S;
    const long long j0 = jlo + (long long)t * C::BK, j1 = j0 + C::BK - 1;
    if (t == 0) {
      mbar_wait(bar_q, 0);
      fence_proxy_async();  // Q's cp.async data, as wgmma reads it
    }
    mbar_wait(full_k + st * 8, (t / S) & 1);
    bool seg_all = true;
    if (has_seg) {
      const long long kend = j1 < jhi ? j1 : jhi;
      const int wt = tid % 128;
      const bool same = wt < C::BK && j0 + wt <= kend && segk[st * TB_SEG_INTS + wt] == rowseg;
      const int n_same = named_count(3 + wg, 128, same);
      seg_all = rows_uniform && n_same == (int)(kend - j0 + 1);
    }
    const long long kp0 = kv_off + (long long)stride_kv * j0;
    const long long kp1 = kv_off + (long long)stride_kv * j1;
    return seg_all && j1 <= jhi && wqmin - kp1 >= lo && wqmax - kp0 <= hi;
  };
  auto wait_v = [&](int t) { mbar_wait(full_v + (t % S) * 8, (t / S) & 1); };
  // turns: this warpgroup issues its products after the other one issued
  // its own (warpgroup 0 first); the last turn of warpgroup 1 hands none on.
  // A CTA of one warpgroup takes no turns.
  auto turn_begin = [&]() {
    if constexpr (C::WG == 2) named_sync(1 + wg, 2 * 128);
  };
  auto turn_end = [&](bool last) {
    if constexpr (C::WG == 2)
      if (!(last && wg == 1)) named_arrive(2 - wg, 2 * 128);
  };

  float oacc[C::NCB][ON / 2];
#pragma unroll
  for (int c = 0; c < C::NCB; ++c)
#pragma unroll
    for (int e = 0; e < ON / 2; ++e) oacc[c][e] = 0.f;
  float m2[2] = {kNegInf, kNegInf};  // running max of the log2-scaled scores
  float lsum[2] = {0.f, 0.f};        // this thread's share of the row sums
  const uint32_t sQw = sQ + wg * 64 * C::SWB;
  using OutT = typename OutType<T>::type;
  // fp32 outputs: the accumulators folded into o so far, scaled to mf
  float mf[2] = {kNegInf, kNegInf};
  bool folded = false;
  // this thread's elements of o: row r's dims c * CB + j * 8 + 2 * (lane % 4)
  auto orow_of = [&](int h2) -> OutT* {
    const int r = row_r[h2];
    return o + (((size_t)b * Sq + r / G) * H + hk * G + r % G) * D + 2 * (lane % 4);
  };
  // o (the folded part rescaled to m2) + oacc, times inv, for row h2
  auto out_pair = [&](int h2, int c, int j, float inv, float& x, float& y) {
    x = oacc[c][4 * j + 2 * h2];
    y = oacc[c][4 * j + 2 * h2 + 1];
    if constexpr (T > 1) {
      if (folded) {
        const float f = fast_exp2(mf[h2] - m2[h2]);
        const float2 w = *reinterpret_cast<const float2*>(orow_of(h2) + c * C::CB + j * 8);
        x = fmaf(w.x, f, x);
        y = fmaf(w.y, f, y);
      }
    }
    x *= inv;
    y *= inv;
  };

  // The products are issued in straight-line code, the same every tile: a
  // data-dependent branch around them makes the compiler serialize every
  // wgmma.  Tile t's scores are issued beside tile t-1's P.V, so t's softmax
  // runs while those products (and the other warpgroup's) do.
  if (n_tiles > 0) {
    if (C::WG == 2 && wg == 1) named_arrive(1, 2 * 128);  // warpgroup 0 takes the first turn
    PFrag<C::BK> pf;
    float s[C::BK / 2];
    {
      const bool full = begin_tile(0);
      fence_operands(s);
      turn_begin();
      wgmma_fence();
      qk_products<D, T>(s, sQw, sK0);
      turn_end(false);
      wgmma_wait<0>();
      fence_operands(s);
      float alpha[2];
      tile_softmax<C::BK>(s, m2, lsum, alpha, full, scale_log2, rm, segk, jlo, jhi, kv_off,
                          stride_kv, lo, hi, has_seg, lane);
      mbar_arrive(empty_k);  // K tile 0 is done with
      make_pfrag<C::BK>(s, pf);
      load_next(0);
    }
    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % S, sp = (t - 1) % S;
      const bool full = begin_tile(t);
      wait_v(t - 1);
      fence_operands(s);
#pragma unroll
      for (int c = 0; c < C::NCB; ++c) fence_operands(oacc[c]);
      turn_begin();
      wgmma_fence();
      qk_products<D, T>(s, sQw, sK0 + st * C::KV_BYTES);
      pv_products<D, T>(oacc, pf, sV0 + sp * C::KV_BYTES);
      turn_end(false);
      wgmma_wait<1>();  // the scores; the P.V products may still run
      fence_operands(s);
      float alpha[2];
      tile_softmax<C::BK>(s, m2, lsum, alpha, full, scale_log2, rm, segk + st * TB_SEG_INTS,
                          jlo + (long long)t * C::BK, jhi, kv_off, stride_kv, lo, hi, has_seg,
                          lane);
      wgmma_wait<0>();
      mbar_arrive(empty_k + st * 8);  // K tile t and V tile t - 1 are done with
      mbar_arrive(empty_v + sp * 8);
#pragma unroll
      for (int c = 0; c < C::NCB; ++c) {
        fence_operands(oacc[c]);
#pragma unroll
        for (int e = 0; e < ON / 2; ++e) oacc[c][e] *= alpha[(e / 2) % 2];
      }
      if constexpr (T > 1) {
        // tiles t - FOLD .. t - 1 into o (this thread's own elements), at m2
        if (t % FOLD == 0) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            if (row_r[h2] >= R) continue;
#pragma unroll
            for (int c = 0; c < C::NCB; ++c)
#pragma unroll
              for (int j = 0; j < ON / 8; ++j) {
                float x, y;
                out_pair(h2, c, j, 1.f, x, y);
                store2(orow_of(h2) + c * C::CB + j * 8, x, y);
              }
          }
#pragma unroll
          for (int c = 0; c < C::NCB; ++c)
#pragma unroll
            for (int e = 0; e < ON / 2; ++e) oacc[c][e] = 0.f;
          mf[0] = m2[0];
          mf[1] = m2[1];
          folded = true;
        }
      }
      make_pfrag<C::BK>(s, pf);
      load_next(t);
    }
    wait_v(n_tiles - 1);
#pragma unroll
    for (int c = 0; c < C::NCB; ++c) fence_operands(oacc[c]);
    turn_begin();
    wgmma_fence();
    pv_products<D, T>(oacc, pf, sV0 + ((n_tiles - 1) % S) * C::KV_BYTES);
    turn_end(true);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::NCB; ++c) fence_operands(oacc[c]);
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float l = quad_sum(lsum[h2]);
    const int r = row_r[h2];
    if (r >= R) continue;
    const int i = r / G, h = hk * G + r % G;
    const float inv = !(l <= 0.f) ? 1.f / l : 0.f;  // a NaN sum passes
#pragma unroll
    for (int c = 0; c < C::NCB; ++c)
#pragma unroll
      for (int j = 0; j < ON / 8; ++j) {
        float x, y;
        out_pair(h2, c, j, inv, x, y);
        store2(orow_of(h2) + c * C::CB + j * 8, x, y);
      }
    if (lane % 4 == 0)
      lse[((size_t)b * H + h) * Sq + i] = !(l <= 0.f) ? m2[h2] * kLn2 + logf(l) : kNegInf;
  }
}

// ===========================================================================
// (b) the decode body
// ===========================================================================

constexpr int DB_THREADS = 128;  // 4 warps
constexpr int DB_WARPS = 4;
constexpr int DB_KT = 16;  // keys per warp tile

// D = 256 takes one 16-row tile (MT = 1: a warp's o accumulators are 128
// fp32 registers a lane), and at T = 2 one stage a warp (two-stage rings
// of both terms would take 264 KB of shared memory)
template <int D, int MT, int T>
struct DecCfg {
  static constexpr int STAGES = D == 256 && T == 2 ? 1 : 2;
  static constexpr int ROWS = MT * 16;               // packed rows held (>= Sq * G)
  static constexpr int RSB = (D + 8) * 2;            // smem row stride, bytes (ldmatrix conflict-free)
  static constexpr int Q_TERM = ROWS * RSB;          // one term of Q
  static constexpr int Q_BYTES = T * Q_TERM;
  static constexpr int TILE_BYTES = DB_KT * RSB;     // one term of a K or V tile
  static constexpr int KV_BYTES = T * TILE_BYTES;    // a K or V tile, all terms
  static constexpr int WARP_BYTES = STAGES * 2 * KV_BYTES;  // the stages of K and V
  static constexpr int STAGING = DB_WARPS * WARP_BYTES;
  static constexpr int ACC_BYTES = DB_WARPS * ROWS * D * 4;  // the merge's partial sums
  static constexpr int SCRATCH = STAGING > ACC_BYTES ? STAGING : ACC_BYTES;
  static constexpr int SEG_OFF = Q_BYTES + SCRATCH;          // int [warps][2][DB_KT]
  static constexpr int ML_OFF = SEG_OFF + DB_WARPS * 2 * DB_KT * 4;  // float m, l [warps][ROWS]
  static constexpr int FIN_OFF = ML_OFF + 2 * DB_WARPS * ROWS * 4;   // float M, L, f[warps] [ROWS]
  static constexpr int SMEM = FIN_OFF + (2 + DB_WARPS) * ROWS * 4;
  static_assert(D <= 128 || MT == 1, "D = 256 holds one 16-row tile");
};

// a K and a V tile of 16 keys, all terms (term t of k at k + t * term_stride)
template <int D, int MT, int T>
__device__ __forceinline__ void dec_load_kv(uint32_t sK, uint32_t sV, int* segk,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v,
                                            const int* __restrict__ seg_kv, long long j0, int b,
                                            int hk, int Skv, int Hkv, size_t term_stride,
                                            int lane) {
  using C = DecCfg<D, MT, T>;
  constexpr int CH = D / 8;
#pragma unroll
  for (int term = 0; term < T; ++term)
    for (int idx = lane; idx < DB_KT * CH; idx += 32) {
      const int r = idx / CH, c8 = idx % CH;
      const long long key = j0 + r;
      const bool valid = key < Skv;
      const size_t off =
          valid ? term * term_stride + (((size_t)b * Skv + key) * Hkv + hk) * D + c8 * 8 : 0;
      const uint32_t dst = term * C::TILE_BYTES + r * C::RSB + c8 * 16;
      cp_async16(sK + dst, k + off, valid);
      cp_async16(sV + dst, v + off, valid);
    }
  if (seg_kv != nullptr && lane < DB_KT) {
    const long long key = j0 + lane;
    segk[lane] = key < Skv ? seg_kv[key] : 0;
  }
}

// q [T * B, Sq, H, D], k and v [T * B, Skv, Hkv, D]: all terms
template <int D, int MT, int T>
__global__ void __launch_bounds__(DB_THREADS) flash_fwd_decode_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ band, int band_stride, const int* __restrict__ seg_q,
    const int* __restrict__ seg_kv, typename OutType<T>::type* __restrict__ o,
    float* __restrict__ lse, float* __restrict__ o_parts, float* __restrict__ lse_parts, int Sq,
    int Skv, int H, int Hkv, float scale_log2, int stride_q, int stride_kv) {
  using C = DecCfg<D, MT, T>;
  constexpr int NP = T > 3 ? T : 3;  // P.V: the pairs i + j < NP of P's and V's terms
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sScratch = sQ + C::Q_BYTES;
  int* segk_all = reinterpret_cast<int*>(smem + C::SEG_OFF);
  float* m_w = reinterpret_cast<float*>(smem + C::ML_OFF);
  float* l_w = m_w + DB_WARPS * C::ROWS;
  float* fin_m = reinterpret_cast<float*>(smem + C::FIN_OFF);
  float* fin_l = fin_m + C::ROWS;
  float* fin_f = fin_l + C::ROWS;  // [warps][ROWS]
  float* accbuf = reinterpret_cast<float*>(smem + C::Q_BYTES);  // [warps][ROWS][D], after the loop

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int splits = gridDim.x, split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z;
  const int G = H / Hkv;
  const int R = Sq * G;  // <= ROWS
  const bool has_seg = seg_q != nullptr;

  const int* bd = band + (size_t)b * band_stride;
  const long long q_off = bd[0], kv_off = bd[1], lo = bd[2], hi = bd[3];
  const long long qmin = q_off, qmax = q_off + (long long)stride_q * (Sq - 1);
  long long jlo = ceil_div(qmin - hi - kv_off, stride_kv);
  long long jhi = floor_div(qmax - lo - kv_off, stride_kv);
  if (jlo < 0) jlo = 0;
  if (jhi > Skv - 1) jhi = Skv - 1;
  const long long n_tiles = jhi >= jlo ? (jhi - jlo) / DB_KT + 1 : 0;
  const int t_begin = (int)(n_tiles * split / splits);
  const int t_end = (int)(n_tiles * (split + 1) / splits);

  // Q: packed row r = i * G + g -> q[b, i, hk * G + g]; rows >= R are zero
  const size_t kv_terms = (size_t)B * Skv * Hkv * D;  // between two terms of k or v
  {
    constexpr int CH = D / 8;
#pragma unroll
    for (int term = 0; term < T; ++term) {
      const size_t qb = ((size_t)term * B + b) * Sq * H * D;
      for (int idx = tid; idx < C::ROWS * CH; idx += DB_THREADS) {
        const int r = idx / CH, c8 = idx % CH;
        const bool valid = r < R;
        const size_t off = valid ? qb + ((size_t)(r / G) * H + hk * G + r % G) * D + c8 * 8 : 0;
        cp_async16(sQ + term * C::Q_TERM + r * C::RSB + c8 * 16, q + off, valid);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // this thread's rows: lane/4 and lane/4 + 8 of each 16-row m tile
  long long qpos[MT][2];
  int segr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int i = min(mt * 16 + lane / 4 + 8 * h2, R - 1) / G;
      qpos[mt][h2] = q_off + (long long)stride_q * i;
      segr[mt][h2] = has_seg ? seg_q[i] : 0;
    }

  float oacc[MT][D / 8][4];
  float m2[MT][2], lsum[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mt][n][e] = 0.f;
    m2[mt][0] = m2[mt][1] = kNegInf;
    lsum[mt][0] = lsum[mt][1] = 0.f;
  }

  // this warp's tiles: t_begin + warp, + 4, ...; its own 2-stage ring (the
  // next tile loads while this one computes), or with one stage each tile
  // loads in its turn
  constexpr int S1 = C::STAGES - 1;  // 1: two stages, 0: one
  const uint32_t sWarp = sScratch + warp * C::WARP_BYTES;
  int* segk_warp = segk_all + warp * 2 * DB_KT;
  int t = t_begin + warp;
  if (S1 && t < t_end)
    dec_load_kv<D, MT, T>(sWarp, sWarp + C::KV_BYTES, segk_warp, k, v, seg_kv,
                          jlo + (long long)t * DB_KT, b, hk, Skv, Hkv, kv_terms, lane);
  cp_async_commit();
  for (int st = 0; t < t_end; t += DB_WARPS, st ^= S1) {
    if (t + S1 * DB_WARPS < t_end) {
      const uint32_t sn = sWarp + (st ^ S1) * 2 * C::KV_BYTES;
      dec_load_kv<D, MT, T>(sn, sn + C::KV_BYTES, segk_warp + (st ^ S1) * DB_KT, k, v, seg_kv,
                            jlo + (long long)(t + S1 * DB_WARPS) * DB_KT, b, hk, Skv, Hkv,
                            kv_terms, lane);
    }
    cp_async_commit();
    cp_async_wait<S1>();
    __syncwarp();
    const uint32_t sK = sWarp + st * 2 * C::KV_BYTES, sV = sK + C::KV_BYTES;
    const int* segk = segk_warp + st * DB_KT;
    const long long j0 = jlo + (long long)t * DB_KT;
    const long long j1 = j0 + DB_KT - 1;
    const long long kp0 = kv_off + (long long)stride_kv * j0;
    const long long kp1 = kv_off + (long long)stride_kv * j1;
    const bool full = !has_seg && j1 <= jhi && qmin - kp1 >= lo && qmax - kp0 <= hi;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // S = Q K^T for 16 rows x 16 keys (n8 blocks 0 and 1): the term
      // pairs i + j < T
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int i = 0; i < T; ++i) {
          uint32_t a[4];
          ldsm_x4(sQ + i * C::Q_TERM + (mt * 16 + ((lane / 8) % 2) * 8 + lane % 8) * C::RSB +
                      (kk * 16 + (lane / 16) * 8) * 2,
                  a);
#pragma unroll
          for (int j = 0; i + j < T; ++j) {
            uint32_t bk[4];
            ldsm_x4(sK + j * C::TILE_BYTES + ((lane / 16) * 8 + lane % 8) * C::RSB +
                        (kk * 16 + ((lane / 8) % 2) * 8) * 2,
                    bk);
            mma_bf16(s[0], a, bk[0], bk[1]);
            mma_bf16(s[1], a, bk[2], bk[3]);
          }
        }
      // element (nb, e): row half e / 2, key column nb * 8 + 2 * (lane % 4) + e % 2
      float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h2 = e / 2;
          float x = s[nb][e] * scale_log2;
          if (!full) {
            const int col = nb * 8 + 2 * (lane % 4) + e % 2;
            const long long key = j0 + col;
            const bool vis = key <= jhi &&
                             band_visible(qpos[mt][h2], key, kv_off, stride_kv, lo, hi) &&
                             (!has_seg || segr[mt][h2] == segk[col]);
            x = vis ? x : neg_inf();
          }
          s[nb][e] = x;
          rmax[h2] = fmaxf(rmax[h2], x);
        }
      float alpha[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float m_new = fmaxf(m2[mt][h2], quad_max(rmax[h2]));
        alpha[h2] = fast_exp2(m2[mt][h2] - m_new);
        m2[mt][h2] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nb][e] = fast_exp2(s[nb][e] - m2[mt][e / 2]);
          psum[e / 2] += s[nb][e];
        }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) lsum[mt][h2] = lsum[mt][h2] * alpha[h2] + psum[h2];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[mt][n][e] *= alpha[e / 2];
      // P (16 rows x 16 keys) as the A fragment, three bf16 terms
      uint32_t pf[3][4];
      split3_bf16(s[0][0], s[0][1], pf[0][0], pf[1][0], pf[2][0]);
      split3_bf16(s[0][2], s[0][3], pf[0][1], pf[1][1], pf[2][1]);
      split3_bf16(s[1][0], s[1][1], pf[0][2], pf[1][2], pf[2][2]);
      split3_bf16(s[1][2], s[1][3], pf[0][3], pf[1][3], pf[2][3]);
#pragma unroll
      for (int p2 = 0; p2 < D / 16; ++p2)
#pragma unroll
        for (int j = 0; j < T; ++j) {
          uint32_t bv[4];
          ldsm_x4_trans(sV + j * C::TILE_BYTES + (((lane / 8) % 2) * 8 + lane % 8) * C::RSB +
                            (p2 * 16 + (lane / 16) * 8) * 2,
                        bv);
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            if (term + j >= NP) continue;  // resolved at compile time
            mma_bf16(oacc[mt][2 * p2], pf[term], bv[0], bv[1]);
            mma_bf16(oacc[mt][2 * p2 + 1], pf[term], bv[2], bv[3]);
          }
        }
    }
    __syncwarp();  // stage st is free for this warp's next-but-one tile
  }
  cp_async_wait<0>();

  // merge the warps: row max, weights and sums in a fixed order
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float l = quad_sum(lsum[mt][h2]);
      if (lane % 4 == 0) {
        const int row = mt * 16 + lane / 4 + 8 * h2;
        m_w[warp * C::ROWS + row] = m2[mt][h2];
        l_w[warp * C::ROWS + row] = l;
      }
    }
  __syncthreads();  // every warp is past its loop: the staging is free
  if (tid < C::ROWS) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < DB_WARPS; ++w) M = fmaxf(M, m_w[w * C::ROWS + tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < DB_WARPS; ++w) {
      const float f = fast_exp2(m_w[w * C::ROWS + tid] - M);
      fin_f[w * C::ROWS + tid] = f;
      L += f * l_w[w * C::ROWS + tid];
    }
    fin_m[tid] = M;
    fin_l[tid] = L;
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + lane / 4 + 8 * (e / 2);
        const int d = n * 8 + 2 * (lane % 4) + e % 2;
        accbuf[(warp * C::ROWS + row) * D + d] = oacc[mt][n][e] * fin_f[warp * C::ROWS + row];
      }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += DB_THREADS) {
    const int row = idx / D, d = idx % D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < DB_WARPS; ++w) acc += accbuf[(w * C::ROWS + row) * D + d];
    const float L = fin_l[row];
    const float val = !(L <= 0.f) ? acc / L : 0.f;  // a NaN sum passes
    const int i = row / G, h = hk * G + row % G;
    const size_t orow = ((size_t)b * Sq + i) * H + h;
    if (splits == 1)
      store1(o + orow * D + d, val);
    else
      o_parts[((size_t)split * B * Sq * H + orow) * D + d] = val;
  }
  for (int row = tid; row < R; row += DB_THREADS) {
    const float L = fin_l[row];
    const float val = !(L <= 0.f) ? fin_m[row] * kLn2 + logf(L) : kNegInf;
    const int i = row / G, h = hk * G + row % G;
    const size_t li = ((size_t)b * H + h) * Sq + i;
    if (splits == 1)
      lse[li] = val;
    else
      lse_parts[(size_t)split * B * H * Sq + li] = val;
  }
}

// Merge the splits' partials by their lse: one warp per (b, i, h) row
template <int T>
__global__ void __launch_bounds__(128) flash_fwd_combine_kernel(
    const float* __restrict__ o_parts, const float* __restrict__ lse_parts,
    typename OutType<T>::type* __restrict__ o, float* __restrict__ lse, int splits, int B, int Sq,
    int H, int D) {
  const int lane = threadIdx.x % 32;
  const long long rows = (long long)B * Sq * H;
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;  // (b * Sq + i) * H + h
  if (row >= rows) return;
  const int h = (int)(row % H);
  const long long bi = row / H;
  const int i = (int)(bi % Sq), b = (int)(bi / Sq);
  const size_t li = ((size_t)b * H + h) * Sq + i;
  const size_t lstride = (size_t)B * H * Sq;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = max_nan(M, lse_parts[s * lstride + li]);
  if (M <= kNegInf) {
    for (int d = lane; d < D; d += 32) store1(o + row * D + d, 0.f);
    if (lane == 0) lse[li] = kNegInf;
    return;
  }
  float W = 0.f;
  for (int s = 0; s < splits; ++s) W += expf(lse_parts[s * lstride + li] - M);
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s)
      acc += expf(lse_parts[s * lstride + li] - M) * o_parts[((size_t)s * rows + row) * D + d];
    store1(o + row * D + d, acc / W);
  }
  if (lane == 0) lse[li] = M + logf(W);
}

// ===========================================================================
// launchers
// ===========================================================================

// The bodies' arguments, as the C entry points take them
struct Args {
  const void *q, *k, *v, *band;
  int band_stride;
  const void *seg_q, *seg_kv;
  void *o, *lse, *o_parts, *lse_parts;
  int splits, B, Sq, Skv, H, Hkv;
  float scale_log2;
  int stride_q, stride_kv;
  cudaStream_t stream;
};

template <int D, int T>
cudaError_t launch_tile(const Args& a) {
  using C = TileCfg<D, T>;
  CUtensorMap tm_k, tm_v, tm_seg;
  memset(&tm_k, 0, sizeof(tm_k));
  memset(&tm_v, 0, sizeof(tm_v));
  memset(&tm_seg, 0, sizeof(tm_seg));
  if (a.Skv > 0) {  // with no keys the kernel loads nothing
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    // all terms: [T * B, Skv, Hkv, D]
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)a.Hkv, (cuuint64_t)a.Skv,
                                (cuuint64_t)a.B * T};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)a.Hkv * D * 2,
                                   (cuuint64_t)a.Skv * a.Hkv * D * 2};
    const cuuint32_t box[4] = {(cuuint32_t)C::CB, 1, (cuuint32_t)C::BK, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swizzle =
        C::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    if (encode(&tm_k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(a.k), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
        encode(&tm_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(a.v), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
    if (a.seg_kv != nullptr) {
      const cuuint64_t seg_dims[1] = {(cuuint64_t)a.Skv};
      const cuuint32_t seg_box[1] = {(cuuint32_t)C::SEG_BOX};
      if (encode(&tm_seg, CU_TENSOR_MAP_DATA_TYPE_INT32, 1, const_cast<void*>(a.seg_kv),
                 seg_dims, strides, seg_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    }
  }
  const int smem = C::SMEM;
  auto kern = flash_fwd_tile_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int R = a.Sq * (a.H / a.Hkv);
  dim3 grid((R + C::ROWS - 1) / C::ROWS, a.Hkv, a.B);
  kern<<<grid, C::THREADS, smem, a.stream>>>(
      tm_k, tm_v, tm_seg, static_cast<const bf16*>(a.q), static_cast<const int*>(a.band),
      a.band_stride, static_cast<const int*>(a.seg_q),
      static_cast<typename OutType<T>::type*>(a.o), static_cast<float*>(a.lse), a.Sq, a.Skv, a.H,
      a.Hkv, a.scale_log2, a.stride_q, a.stride_kv);
  return cudaGetLastError();
}

template <int D, int MT, int T>
cudaError_t launch_decode(const Args& a) {
  const int smem = DecCfg<D, MT, T>::SMEM;
  auto kern = flash_fwd_decode_kernel<D, MT, T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using OutT = typename OutType<T>::type;
  dim3 grid(a.splits, a.Hkv, a.B);
  kern<<<grid, DB_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const int*>(a.band), a.band_stride, static_cast<const int*>(a.seg_q),
      static_cast<const int*>(a.seg_kv), static_cast<OutT*>(a.o), static_cast<float*>(a.lse),
      static_cast<float*>(a.o_parts), static_cast<float*>(a.lse_parts), a.Sq, a.Skv, a.H, a.Hkv,
      a.scale_log2, a.stride_q, a.stride_kv);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long rows = (long long)a.B * a.Sq * a.H;
  flash_fwd_combine_kernel<T><<<(unsigned)((rows + 3) / 4), 128, 0, a.stream>>>(
      static_cast<const float*>(a.o_parts), static_cast<const float*>(a.lse_parts),
      static_cast<OutT*>(a.o), static_cast<float*>(a.lse), a.splits, a.B, a.Sq, a.H, D);
  return cudaGetLastError();
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace
