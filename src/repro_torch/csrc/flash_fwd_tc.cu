// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 inputs;
// plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd
//   (Pallas body _fwd_kernel, with _block_visible / _mask_block) for bf16
//   inputs.  fp32 inputs keep the CUDA-core kernel in flash_fwd.cu.
//
// What it computes: as flash_fwd.cu -- o = softmax(scale * q k^T + mask) v
// and the fp32 row log-sum-exp, for q [B, Sq, H, D] and k, v [B, Skv, Hkv,
// D] (GQA: query head h reads kv head h / (H / Hkv)); the mask is the int32
// band (q_off, kv_off, lo, hi) with strides, one [4] band or one per batch
// row ([B, 4]) in device memory, composed with optional per-token segment
// ids.  An empty row has o = 0 and lse = NEG_INF exactly.
//
// Numerics: scores and softmax are fp32 (bf16 x bf16 products are exact in
// fp32; the scale is applied to the fp32 scores).  P enters P.V as three
// bf16 terms, hi + mid + lo, which carry fp32's 24 bits, so o differs from
// the plain version's fp32 P.V only by the order of the sums.  A single
// bf16 P (|error| up to 2^-8 p) moves o by up to 2^-8 max|v| and flips o's
// own bf16 rounding often enough to break a 1e-2 limit where |o| >= 2 (one
// ulp there is 2^-6); two terms (2^-16 p) still flipped one element of the
// S=2048 segment case on the card.
//
// Two bodies, chosen by the wrapper from the shapes alone:
//
// (a) flash_fwd_tile_kernel -- prefill, packed prefill, chunks, windows.
//   What bounds it: 4*D flops per visible (query, key) pair against
//   2*D*(Sq*H + 2*Skv*Hkv) bytes -- far above the card's ~295 flop/byte
//   balance at prefill lengths, so the tensor cores (and, beside them, the
//   softmax's exponentials).
//   * one CTA per (tile of 128 packed rows, kv head, batch row); a packed
//     row is a (query row, head of the GQA group) pair, r = i*G + g, so the
//     G heads of one kv head share each K/V tile load (G x fewer K/V bytes)
//     and a row's position, band and segment id are those of its query row;
//   * two warpgroups of 64 packed rows; S = Q K^T and O += P V on wgmma
//     (m64n64k16, bf16 operands, fp32 accumulators): Q (loaded once) and the
//     K tile from shared memory, P from registers, V from shared memory
//     (MN-major);
//   * K/V tiles of 64 keys in a 4-stage ring, loaded by TMA (one thread;
//     128-byte-swizzled boxes of 64 dims, 64-byte for D = 32, as wgmma reads
//     them) two tiles ahead; mbarriers say when a tile has landed (full) and
//     when both warpgroups are done with it (empty);
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
//   * tiles run heaviest first (causal prefill: the last rows first).
//
// (b) flash_fwd_decode_kernel -- at most 32 packed rows (Sq * G <= 32: a
//   decode tick, a speculative verify).  What bounds it: reading K and V of
//   the visible keys once per kv head (4*D flops per 4*D bytes).
//   * one CTA per (key split, kv head, batch row); 4 warps walk disjoint
//     16-key tiles of the split's share of the interval, each with its own
//     2-stage cp.async ring and no block barrier, and products on
//     mma.sync.m16n8k16 (bf16, fp32 accumulators) over the G*Sq packed rows;
//   * the warps' (m, l, acc) merge in shared memory in a fixed order; with
//     more than one split each CTA writes a normalized fp32 partial and its
//     lse, and flash_fwd_combine_kernel merges them by lse (fixed order, no
//     atomics: two launches are bitwise equal).  In both bodies and the
//     combine a NaN score makes its row's o and lse NaN, as in JAX's kernels
//     (the running maxima drop NaN, exp keeps it, the epilogues pass it).

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

constexpr int TB_THREADS = 256;  // two warpgroups
constexpr int TB_ROWS = 128;     // packed rows per CTA, 64 per warpgroup
constexpr int TB_BK = 64;        // keys per K/V tile
constexpr int TB_STAGES = 4;  // tile t + 2 loads while t - 1's V and t's K are read
// A 1-D TMA box must start on a 16-byte boundary in global memory and land
// 128-byte aligned in shared memory: a tile's key segment ids (from key j0)
// are loaded as a box of TB_SEG_BOX ids from j0 & ~3 into a stage's
// TB_SEG_INTS slots and read from offset j0 & 3.
constexpr int TB_SEG_BOX = TB_BK + 4;
constexpr int TB_SEG_INTS = 96;

template <int D>
struct TileCfg {
  static constexpr int SWB = D >= 64 ? 128 : 64;       // swizzle span (bytes) = column block row
  static constexpr int CB = SWB / 2;                   // dims per column block
  static constexpr int NCB = D / CB;                   // column blocks
  static constexpr uint64_t LAYOUT = D >= 64 ? 1 : 2;  // descriptor swizzle mode
  static constexpr int Q_BYTES = TB_ROWS * D * 2;
  static constexpr int KV_BYTES = TB_BK * D * 2;
  static constexpr int SEG_OFF = Q_BYTES + 2 * TB_STAGES * KV_BYTES;  // int [stages][TB_SEG_INTS]
  static constexpr int BAR_OFF = SEG_OFF + TB_STAGES * TB_SEG_INTS * 4;  // u64 full, empty [stages], q
  static constexpr int SMEM = 1024 + BAR_OFF + (2 * TB_STAGES + 1) * 8;
};

// byte offset of 16-byte chunk c8 of row r in a [rows, D] tile stored as
// column blocks [rows][SWB bytes], swizzled as wgmma reads them and TMA
// writes them: the chunk index XOR the 128-byte line's index within its
// 1024-byte (SWB = 128) or 512-byte (SWB = 64) atom
template <int D>
__device__ __forceinline__ uint32_t tile_off(int r, int c8, int rows) {
  using C = TileCfg<D>;
  const uint32_t off =
      (c8 / (C::CB / 8)) * rows * C::SWB + r * C::SWB + (c8 % (C::CB / 8)) * 16;
  return off ^ (((off >> 7) & (C::SWB / 16 - 1)) << 4);
}

// P as the A operand of P.V: three bf16 terms per value, hi + mid + lo, so
// P carries fp32's 24 bits; keys 16u..16u+15 are the score accumulator's
// blocks 2u and 2u+1 (the m16n8 accumulator and A-fragment layouts agree)
struct PFrag {
  uint32_t r[3][TB_BK / 16][4];
};

__device__ __forceinline__ void make_pfrag(const float (&p)[32], PFrag& f) {
#pragma unroll
  for (int u = 0; u < TB_BK / 16; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      split3_bf16(p[8 * u + 2 * x], p[8 * u + 2 * x + 1], f.r[0][u][x], f.r[1][u][x],
                  f.r[2][u][x]);
}

// O += P V for one 64-key tile.  V's tile is MN-major (dims contiguous); one
// product per column block, whose N fits one swizzle atom (the leading
// offset is then unused, so it takes the stride offset's value).  Issues and
// commits; the caller waits.
template <int D>
__device__ __forceinline__ void pv_products(float (&oacc)[TileCfg<D>::NCB][TileCfg<D>::CB / 2],
                                            const PFrag& p, uint32_t sV) {
  using C = TileCfg<D>;
#pragma unroll
  for (int u = 0; u < TB_BK / 16; ++u) {
#pragma unroll
    for (int c = 0; c < C::NCB; ++c) {
      const uint64_t dv = smem_desc(sV + c * TB_BK * C::SWB + u * 16 * C::SWB, 8 * C::SWB,
                                    8 * C::SWB, C::LAYOUT);
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        if constexpr (C::CB == 64)
          wgmma_rs_m64n64(oacc[c], p.r[term][u], dv);
        else
          wgmma_rs_m64n32(oacc[c], p.r[term][u], dv);
      }
    }
  }
  wgmma_commit();
}

// S = Q K^T for one warpgroup's 64 rows and a 64-key tile.  Issues and
// commits; the caller waits.
template <int D>
__device__ __forceinline__ void qk_products(float (&s)[32], uint32_t sQw, uint32_t sK) {
  using C = TileCfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t cb = (kk * 16) / C::CB, within = ((kk * 16) % C::CB) * 2;
    const uint64_t da =
        smem_desc(sQw + cb * TB_ROWS * C::SWB + within, 16, 8 * C::SWB, C::LAYOUT);
    const uint64_t db = smem_desc(sK + cb * TB_BK * C::SWB + within, 16, 8 * C::SWB, C::LAYOUT);
    wgmma_ss_m64n64(s, da, db, kk > 0);  // the first k-step overwrites s
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
// Element e of s sits at row (e / 2) % 2 of this thread's pair and key
// column (e / 4) * 8 + 2 * (lane % 4) + e % 2.
__device__ __forceinline__ void tile_softmax(float (&s)[32], float (&m2)[2], float (&lsum)[2],
                                             float (&alpha)[2], bool full, float scale_log2,
                                             const RowMask& rm, const int* segk, long long j0,
                                             long long jhi, long long kv_off, int stride_kv,
                                             long long lo, long long hi, bool has_seg, int lane) {
  // the row max of the raw scores (scale > 0), hidden ones at -inf
  float rmax[2] = {neg_inf(), neg_inf()};
  if (!full) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h2 = (e / 2) % 2;
      const int col = (e / 4) * 8 + 2 * (lane % 4) + e % 2;
      const long long key = j0 + col;
      const bool vis = key <= jhi && band_visible(rm.qpos[h2], key, kv_off, stride_kv, lo, hi) &&
                       (!has_seg || rm.seg[h2] == segk[col]);
      s[e] = vis ? s[e] : neg_inf();
    }
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) rmax[(e / 2) % 2] = fmaxf(rmax[(e / 2) % 2], s[e]);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float m_new = fmaxf(m2[h2], quad_max(rmax[h2]) * scale_log2);
    alpha[h2] = fast_exp2(m2[h2] - m_new);
    m2[h2] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = fast_exp2(fmaf(s[e], scale_log2, -m2[(e / 2) % 2]));
    psum[(e / 2) % 2] += s[e];
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) lsum[h2] = lsum[h2] * alpha[h2] + psum[h2];
}

// tm_k, tm_v: k and v as 4-D tensor maps (D, Hkv, Skv, B) with a box of one
// column block x 64 keys; tm_seg: seg_kv (1-D, a box of 64) when seg_q is
// given
template <int D>
__global__ void __launch_bounds__(TB_THREADS, 1) flash_fwd_tile_kernel(
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_seg, const bf16* __restrict__ q,
    const int* __restrict__ band, int band_stride, const int* __restrict__ seg_q,
    bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
    float scale_log2, int stride_q, int stride_kv) {
  using C = TileCfg<D>;
  constexpr int ON = C::CB;  // N of one P.V product: one column block of V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK0 = sQ + C::Q_BYTES;
  const uint32_t sV0 = sK0 + TB_STAGES * C::KV_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int G = H / Hkv;
  const int R = Sq * G;  // packed rows of this (batch row, kv head)
  const int r0 = (gridDim.x - 1 - blockIdx.x) * TB_ROWS;  // heaviest tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const bool has_seg = seg_q != nullptr;

  const int* bd = band + (size_t)b * band_stride;
  const long long q_off = bd[0], kv_off = bd[1], lo = bd[2], hi = bd[3];

  // the CTA's visible key interval, solved from the band
  const int i_first = r0 / G, i_last = (min(r0 + TB_ROWS, R) - 1) / G;
  long long jlo = ceil_div(q_off + (long long)stride_q * i_first - hi - kv_off, stride_kv);
  long long jhi = floor_div(q_off + (long long)stride_q * i_last - lo - kv_off, stride_kv);
  if (jlo < 0) jlo = 0;
  if (jhi > Skv - 1) jhi = Skv - 1;
  const int n_tiles = jhi >= jlo ? (int)((jhi - jlo) / TB_BK) + 1 : 0;

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

  // Shared-memory ring: tile u lives in stage u % TB_STAGES.  Thread 0
  // loads a tile with TMA; full[s] completes when its bytes have landed, and
  // empty[s] when every thread is done with it (its P.V products complete).
  // The two warpgroups run on these barriers, not on CTA-wide ones, so they
  // drift apart: they take turns issuing their products (named barriers 1
  // and 2), and one warpgroup's softmax runs while the other's products do.
  const uint32_t bar_full = sQ + C::BAR_OFF, bar_empty = bar_full + TB_STAGES * 8;
  const uint32_t bar_q = bar_empty + TB_STAGES * 8;
  const uint32_t sSeg = sQ + C::SEG_OFF;
  // stage st's ids from the tile's first key (every tile starts at jlo mod 4)
  const int* segk = reinterpret_cast<const int*>(smem_raw + (sQ - raw) + C::SEG_OFF) + (jlo & 3);
  if (tid == 0) {
    for (int st = 0; st < TB_STAGES; ++st) {
      mbar_init(bar_full + st * 8, 1);
      mbar_init(bar_empty + st * 8, TB_THREADS);
    }
    mbar_init(bar_q, TB_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Q, once, by every thread's cp.asyncs (a packed row's heads are
  // contiguous, its query rows H * D apart)
  {
    constexpr int CH = D / 8;
    const size_t qb = (size_t)b * Sq * H * D;
    for (int idx = tid; idx < TB_ROWS * CH; idx += TB_THREADS) {
      const int r = idx / CH, c8 = idx % CH;
      const int pr = r0 + r;
      const bool valid = pr < R;
      const size_t off =
          valid ? qb + ((size_t)(pr / G) * H + hk * G + pr % G) * D + c8 * 8 : 0;
      cp_async16(sQ + tile_off<D>(r, c8, TB_ROWS), q + off, valid);
    }
    cp_async_mbar_arrive(bar_q);
  }
  // tile u (thread 0): wait until its stage's previous tile (u - TB_STAGES)
  // is free, then one box per column block of K and of V, and the keys'
  // segment ids
  auto load_tile = [&](int u) {
    if (tid != 0) return;
    const int st = u % TB_STAGES;
    if (u >= TB_STAGES) mbar_wait(bar_empty + st * 8, (u / TB_STAGES - 1) & 1);
    const uint32_t full = bar_full + st * 8;
    mbar_expect_tx(full, 2 * C::KV_BYTES + (has_seg ? TB_SEG_BOX * 4 : 0));
    const int j0 = (int)(jlo + (long long)u * TB_BK);
#pragma unroll
    for (int c = 0; c < C::NCB; ++c) {
      const uint32_t off = st * C::KV_BYTES + c * TB_BK * C::SWB;
      tma_load_4d(sK0 + off, &tm_k, full, c * C::CB, hk, j0, b);
      tma_load_4d(sV0 + off, &tm_v, full, c * C::CB, hk, j0, b);
    }
    if (has_seg) tma_load_1d(sSeg + st * TB_SEG_INTS * 4, &tm_seg, full, j0 & ~3);
  };
  if (n_tiles > 0) load_tile(0);
  if (n_tiles > 1) load_tile(1);

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

  // Tile t has landed.  Returns whether the band and the segments show all
  // of it to this warpgroup's rows.
  auto begin_tile = [&](int t) -> bool {
    const int st = t % TB_STAGES;
    const long long j0 = jlo + (long long)t * TB_BK, j1 = j0 + TB_BK - 1;
    if (t == 0) {
      mbar_wait(bar_q, 0);
      fence_proxy_async();  // Q's cp.async data, as wgmma reads it
    }
    mbar_wait(bar_full + st * 8, (t / TB_STAGES) & 1);
    bool seg_all = true;
    if (has_seg) {
      const long long kend = j1 < jhi ? j1 : jhi;
      const int wt = tid % 128;
      const bool same = wt < TB_BK && j0 + wt <= kend && segk[st * TB_SEG_INTS + wt] == rowseg;
      const int n_same = named_count(3 + wg, 128, same);
      seg_all = rows_uniform && n_same == (int)(kend - j0 + 1);
    }
    const long long kp0 = kv_off + (long long)stride_kv * j0;
    const long long kp1 = kv_off + (long long)stride_kv * j1;
    return seg_all && j1 <= jhi && wqmin - kp1 >= lo && wqmax - kp0 <= hi;
  };
  // turns: this warpgroup issues its products after the other one issued
  // its own (warpgroup 0 first); the last turn of warpgroup 1 hands none on
  auto turn_begin = [&]() { named_sync(1 + wg, 2 * 128); };
  auto turn_end = [&](bool last) {
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

  // The products are issued in straight-line code, the same every tile: a
  // data-dependent branch around them makes the compiler serialize every
  // wgmma.  Tile t's scores are issued beside tile t-1's P.V, so t's softmax
  // runs while those products (and the other warpgroup's) do.
  if (n_tiles > 0) {
    if (wg == 1) named_arrive(1, 2 * 128);  // warpgroup 0 takes the first turn
    PFrag pf;
    float s[32];
    {
      const bool full = begin_tile(0);
      fence_operands(s);
      turn_begin();
      wgmma_fence();
      qk_products<D>(s, sQw, sK0);
      turn_end(false);
      wgmma_wait<0>();
      fence_operands(s);
      float alpha[2];
      tile_softmax(s, m2, lsum, alpha, full, scale_log2, rm, segk, jlo, jhi, kv_off, stride_kv,
                   lo, hi, has_seg, lane);
      make_pfrag(s, pf);
      if (n_tiles > 2) load_tile(2);
    }
    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % TB_STAGES, sp = (t - 1) % TB_STAGES;
      const bool full = begin_tile(t);
      fence_operands(s);
#pragma unroll
      for (int c = 0; c < C::NCB; ++c) fence_operands(oacc[c]);
      turn_begin();
      wgmma_fence();
      qk_products<D>(s, sQw, sK0 + st * C::KV_BYTES);
      pv_products<D>(oacc, pf, sV0 + sp * C::KV_BYTES);
      turn_end(false);
      wgmma_wait<1>();  // the scores; the P.V products may still run
      fence_operands(s);
      float alpha[2];
      tile_softmax(s, m2, lsum, alpha, full, scale_log2, rm, segk + st * TB_SEG_INTS,
                   jlo + (long long)t * TB_BK, jhi, kv_off, stride_kv, lo, hi, has_seg, lane);
      wgmma_wait<0>();
      mbar_arrive(bar_empty + sp * 8);  // tile t - 1 is done with
#pragma unroll
      for (int c = 0; c < C::NCB; ++c) {
        fence_operands(oacc[c]);
#pragma unroll
        for (int e = 0; e < ON / 2; ++e) oacc[c][e] *= alpha[(e / 2) % 2];
      }
      make_pfrag(s, pf);
      if (t + 2 < n_tiles) load_tile(t + 2);
    }
#pragma unroll
    for (int c = 0; c < C::NCB; ++c) fence_operands(oacc[c]);
    turn_begin();
    wgmma_fence();
    pv_products<D>(oacc, pf, sV0 + ((n_tiles - 1) % TB_STAGES) * C::KV_BYTES);
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
    bf16* orow = o + (((size_t)b * Sq + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < C::NCB; ++c)
#pragma unroll
      for (int j = 0; j < ON / 8; ++j) {
        const int d = c * C::CB + j * 8 + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            oacc[c][4 * j + 2 * h2] * inv, oacc[c][4 * j + 2 * h2 + 1] * inv);
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

template <int D, int MT>
struct DecCfg {
  static constexpr int ROWS = MT * 16;               // packed rows held (>= Sq * G)
  static constexpr int RSB = (D + 8) * 2;            // smem row stride, bytes (ldmatrix conflict-free)
  static constexpr int Q_BYTES = ROWS * RSB;
  static constexpr int TILE_BYTES = DB_KT * RSB;     // one K or V tile
  static constexpr int WARP_BYTES = 2 * 2 * TILE_BYTES;  // 2 stages of K and V
  static constexpr int STAGING = DB_WARPS * WARP_BYTES;
  static constexpr int ACC_BYTES = DB_WARPS * ROWS * D * 4;  // the merge's partial sums
  static constexpr int SCRATCH = STAGING > ACC_BYTES ? STAGING : ACC_BYTES;
  static constexpr int SEG_OFF = Q_BYTES + SCRATCH;          // int [warps][2][DB_KT]
  static constexpr int ML_OFF = SEG_OFF + DB_WARPS * 2 * DB_KT * 4;  // float m, l [warps][ROWS]
  static constexpr int FIN_OFF = ML_OFF + 2 * DB_WARPS * ROWS * 4;   // float M, L, f[warps] [ROWS]
  static constexpr int SMEM = FIN_OFF + (2 + DB_WARPS) * ROWS * 4;
};

template <int D, int MT>
__device__ __forceinline__ void dec_load_kv(uint32_t sK, uint32_t sV, int* segk,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v,
                                            const int* __restrict__ seg_kv, long long j0, int b,
                                            int hk, int Skv, int Hkv, int lane) {
  using C = DecCfg<D, MT>;
  constexpr int CH = D / 8;
  for (int idx = lane; idx < DB_KT * CH; idx += 32) {
    const int r = idx / CH, c8 = idx % CH;
    const long long key = j0 + r;
    const bool valid = key < Skv;
    const size_t off = valid ? (((size_t)b * Skv + key) * Hkv + hk) * D + c8 * 8 : 0;
    const uint32_t dst = r * C::RSB + c8 * 16;
    cp_async16(sK + dst, k + off, valid);
    cp_async16(sV + dst, v + off, valid);
  }
  if (seg_kv != nullptr && lane < DB_KT) {
    const long long key = j0 + lane;
    segk[lane] = key < Skv ? seg_kv[key] : 0;
  }
}

template <int D, int MT>
__global__ void __launch_bounds__(DB_THREADS) flash_fwd_decode_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ band, int band_stride, const int* __restrict__ seg_q,
    const int* __restrict__ seg_kv, bf16* __restrict__ o, float* __restrict__ lse,
    float* __restrict__ o_parts, float* __restrict__ lse_parts, int Sq, int Skv, int H,
    int Hkv, float scale_log2, int stride_q, int stride_kv) {
  using C = DecCfg<D, MT>;
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
  {
    constexpr int CH = D / 8;
    const size_t qb = (size_t)b * Sq * H * D;
    for (int idx = tid; idx < C::ROWS * CH; idx += DB_THREADS) {
      const int r = idx / CH, c8 = idx % CH;
      const bool valid = r < R;
      const size_t off = valid ? qb + ((size_t)(r / G) * H + hk * G + r % G) * D + c8 * 8 : 0;
      cp_async16(sQ + r * C::RSB + c8 * 16, q + off, valid);
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

  // this warp's tiles: t_begin + warp, + 4, ...; its own 2-stage ring
  const uint32_t sWarp = sScratch + warp * C::WARP_BYTES;
  int* segk_warp = segk_all + warp * 2 * DB_KT;
  int t = t_begin + warp;
  if (t < t_end)
    dec_load_kv<D, MT>(sWarp, sWarp + C::TILE_BYTES, segk_warp, k, v, seg_kv,
                       jlo + (long long)t * DB_KT, b, hk, Skv, Hkv, lane);
  cp_async_commit();
  for (int st = 0; t < t_end; t += DB_WARPS, st ^= 1) {
    if (t + DB_WARPS < t_end) {
      const uint32_t sn = sWarp + (st ^ 1) * 2 * C::TILE_BYTES;
      dec_load_kv<D, MT>(sn, sn + C::TILE_BYTES, segk_warp + (st ^ 1) * DB_KT, k, v, seg_kv,
                         jlo + (long long)(t + DB_WARPS) * DB_KT, b, hk, Skv, Hkv, lane);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const uint32_t sK = sWarp + st * 2 * C::TILE_BYTES, sV = sK + C::TILE_BYTES;
    const int* segk = segk_warp + st * DB_KT;
    const long long j0 = jlo + (long long)t * DB_KT;
    const long long j1 = j0 + DB_KT - 1;
    const long long kp0 = kv_off + (long long)stride_kv * j0;
    const long long kp1 = kv_off + (long long)stride_kv * j1;
    const bool full = !has_seg && j1 <= jhi && qmin - kp1 >= lo && qmax - kp0 <= hi;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // S = Q K^T for 16 rows x 16 keys: n8 blocks 0 and 1
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], bk[4];
        ldsm_x4(sQ + (mt * 16 + ((lane / 8) % 2) * 8 + lane % 8) * C::RSB +
                    (kk * 16 + (lane / 16) * 8) * 2,
                a);
        ldsm_x4(sK + ((lane / 16) * 8 + lane % 8) * C::RSB + (kk * 16 + ((lane / 8) % 2) * 8) * 2,
                bk);
        mma_bf16(s[0], a, bk[0], bk[1]);
        mma_bf16(s[1], a, bk[2], bk[3]);
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
      for (int p2 = 0; p2 < D / 16; ++p2) {
        uint32_t bv[4];
        ldsm_x4_trans(sV + (((lane / 8) % 2) * 8 + lane % 8) * C::RSB +
                          (p2 * 16 + (lane / 16) * 8) * 2,
                      bv);
#pragma unroll
        for (int term = 0; term < 3; ++term) {
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
      o[orow * D + d] = __float2bfloat16(val);
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
__global__ void __launch_bounds__(128) flash_fwd_combine_kernel(
    const float* __restrict__ o_parts, const float* __restrict__ lse_parts,
    bf16* __restrict__ o, float* __restrict__ lse, int splits, int B, int Sq, int H, int D) {
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
    for (int d = lane; d < D; d += 32) o[row * D + d] = __float2bfloat16(0.f);
    if (lane == 0) lse[li] = kNegInf;
    return;
  }
  float W = 0.f;
  for (int s = 0; s < splits; ++s) W += expf(lse_parts[s * lstride + li] - M);
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s)
      acc += expf(lse_parts[s * lstride + li] - M) * o_parts[((size_t)s * rows + row) * D + d];
    o[row * D + d] = __float2bfloat16(acc / W);
  }
  if (lane == 0) lse[li] = M + logf(W);
}

// ===========================================================================
// launchers
// ===========================================================================

template <int D>
cudaError_t launch_tile(const void* q, const void* k, const void* v, const void* band,
                        int band_stride, const void* seg_q, const void* seg_kv, void* o, void* lse,
                        int B, int Sq, int Skv, int H, int Hkv, float scale_log2, int stride_q,
                        int stride_kv, cudaStream_t stream) {
  using C = TileCfg<D>;
  CUtensorMap tm_k, tm_v, tm_seg;
  memset(&tm_k, 0, sizeof(tm_k));
  memset(&tm_v, 0, sizeof(tm_v));
  memset(&tm_seg, 0, sizeof(tm_seg));
  if (Skv > 0) {  // with no keys the kernel loads nothing
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)Skv, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                   (cuuint64_t)Skv * Hkv * D * 2};
    const cuuint32_t box[4] = {(cuuint32_t)C::CB, 1, (cuuint32_t)TB_BK, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swizzle =
        D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    if (encode(&tm_k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(k), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
        encode(&tm_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(v), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
    if (seg_kv != nullptr) {
      const cuuint64_t seg_dims[1] = {(cuuint64_t)Skv};
      const cuuint32_t seg_box[1] = {(cuuint32_t)TB_SEG_BOX};
      if (encode(&tm_seg, CU_TENSOR_MAP_DATA_TYPE_INT32, 1, const_cast<void*>(seg_kv), seg_dims,
                 strides, seg_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    }
  }
  const int smem = C::SMEM;
  auto kern = flash_fwd_tile_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int R = Sq * (H / Hkv);
  dim3 grid((R + TB_ROWS - 1) / TB_ROWS, Hkv, B);
  kern<<<grid, TB_THREADS, smem, stream>>>(
      tm_k, tm_v, tm_seg, static_cast<const bf16*>(q), static_cast<const int*>(band), band_stride,
      static_cast<const int*>(seg_q), static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Skv,
      H, Hkv, scale_log2, stride_q, stride_kv);
  return cudaGetLastError();
}

template <int D, int MT>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const void* band,
                          int band_stride, const void* seg_q, const void* seg_kv, void* o,
                          void* lse, void* o_parts, void* lse_parts, int splits, int B, int Sq,
                          int Skv, int H, int Hkv, float scale_log2, int stride_q, int stride_kv,
                          cudaStream_t stream) {
  const int smem = DecCfg<D, MT>::SMEM;
  auto kern = flash_fwd_decode_kernel<D, MT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(splits, Hkv, B);
  kern<<<grid, DB_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(band), band_stride, static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_kv), static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<float*>(o_parts), static_cast<float*>(lse_parts), Sq, Skv, H, Hkv, scale_log2,
      stride_q, stride_kv);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long rows = (long long)B * Sq * H;
  flash_fwd_combine_kernel<<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(
      static_cast<const float*>(o_parts), static_cast<const float*>(lse_parts),
      static_cast<bf16*>(o), static_cast<float*>(lse), splits, B, Sq, H, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_decode(const void* q, const void* k, const void* v, const void* band,
                            int band_stride, const void* seg_q, const void* seg_kv, void* o,
                            void* lse, void* o_parts, void* lse_parts, int splits, int B, int Sq,
                            int Skv, int H, int Hkv, float scale_log2, int stride_q,
                            int stride_kv, cudaStream_t stream) {
  const int R = Sq * (H / Hkv);
  if (R <= 16)
    return launch_decode<D, 1>(q, k, v, band, band_stride, seg_q, seg_kv, o, lse, o_parts,
                               lse_parts, splits, B, Sq, Skv, H, Hkv, scale_log2, stride_q,
                               stride_kv, stream);
  if (R <= 32)
    return launch_decode<D, 2>(q, k, v, band, band_stride, seg_q, seg_kv, o, lse, o_parts,
                               lse_parts, splits, B, Sq, Skv, H, Hkv, scale_log2, stride_q,
                               stride_kv, stream);
  return cudaErrorInvalidValue;
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace

// Both entry points take bf16 q [B, Sq, H, D], k and v [B, Skv, Hkv, D],
// the int32 band ([4] with band_stride 0, or [B, 4] with 4), optional int32
// segment ids (seg_q [Sq], seg_kv [Skv], or both null), and write o [B, Sq,
// H, D] (bf16) and lse [B, H, Sq] (fp32).  They return cudaGetLastError()
// after the launches.

extern "C" int flash_fwd_tile(const void* q, const void* k, const void* v, const void* band,
                              int band_stride, const void* seg_q, const void* seg_kv, void* o,
                              void* lse, int B, int Sq, int Skv, int H, int Hkv, int D,
                              float scale, int stride_q, int stride_kv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  switch (D) {
    case 32:
      return (int)launch_tile<32>(q, k, v, band, band_stride, seg_q, seg_kv, o, lse, B, Sq, Skv,
                                  H, Hkv, sl2, stride_q, stride_kv, s);
    case 64:
      return (int)launch_tile<64>(q, k, v, band, band_stride, seg_q, seg_kv, o, lse, B, Sq, Skv,
                                  H, Hkv, sl2, stride_q, stride_kv, s);
    case 128:
      return (int)launch_tile<128>(q, k, v, band, band_stride, seg_q, seg_kv, o, lse, B, Sq, Skv,
                                   H, Hkv, sl2, stride_q, stride_kv, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Sq * (H / Hkv) <= 32.  With splits > 1, o_parts (fp32 [splits, B, Sq, H,
// D]) and lse_parts (fp32 [splits, B, H, Sq]) are the partials' scratch.
extern "C" int flash_fwd_decode(const void* q, const void* k, const void* v, const void* band,
                                int band_stride, const void* seg_q, const void* seg_kv, void* o,
                                void* lse, void* o_parts, void* lse_parts, int splits, int B,
                                int Sq, int Skv, int H, int Hkv, int D, float scale, int stride_q,
                                int stride_kv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  if (splits < 1 || (splits > 1 && (o_parts == nullptr || lse_parts == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return (int)dispatch_decode<32>(q, k, v, band, band_stride, seg_q, seg_kv, o, lse, o_parts,
                                      lse_parts, splits, B, Sq, Skv, H, Hkv, sl2, stride_q,
                                      stride_kv, s);
    case 64:
      return (int)dispatch_decode<64>(q, k, v, band, band_stride, seg_q, seg_kv, o, lse, o_parts,
                                      lse_parts, splits, B, Sq, Skv, H, Hkv, sl2, stride_q,
                                      stride_kv, s);
    case 128:
      return (int)dispatch_decode<128>(q, k, v, band, band_stride, seg_q, seg_kv, o, lse,
                                       o_parts, lse_parts, splits, B, Sq, Skv, H, Hkv, sl2,
                                       stride_q, stride_kv, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
