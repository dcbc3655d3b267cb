// Paged split-K flash-decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/paged_decode.py::paged_flash_decode
//   (Pallas body _decode_kernel with its clamped kv_index_map, call :301),
//   both pool kinds: an fp pool (q's type), and the quantized branch
//   (:161-167, scale BlockSpecs :273-277) whose int8 / fp8-e4m3 pages carry
//   fp32 per-(token, kv-head) scales; and the plain split combine
//   (combine_split_partials) that follows the Pallas call.
//
// What it computes: one decode token per slot row b straight off the page
// pool.  Query q [B, H, D], pool [num_pages, page_size, Hkv, D], block table
// bt [B, max_pages] (-1 = unallocated), per-row position pos [B] (or one
// for every row).  Local slot j of a row lives at offset j % page_size of
// logical page j / page_size and holds global position kv_off + stride_kv*j;
// it is visible iff max(pos - hi, 0) <= position <= pos and its page is
// allocated.  Output o [B, H, D] in q's type and lse [B, H] fp32; a row that
// sees nothing gets exactly o = 0, lse = NEG_INF.  A quantized pool adds
// k_scale / v_scale [num_pages, page_size, Hkv] fp32: element (page, t, h,
// d) stands for code * scale[page, t, h].
//
// What bounds it on an H100: bytes.  Each visible K/V element is read once
// and used for 2 flops per query head of its GQA group (8 flops per byte of
// bf16 for granite's group of 4), far below the card's ~295 flop/byte
// balance, so the floor is the visible pages' bytes over 3.35 TB/s (a few
// microseconds at serving depths).  At that size the launch, the number of
// blocks that find work, and the latency of each block's first loads decide
// the time.
//
// Design:
//   * the row's visible local slots [j_lo, j_hi] are solved per block from
//     pos, kv_off, stride_kv and the window, and cut into 16-slot tiles
//     aligned to 16 (one tile is one page at the serving page size of 16);
//     as many of the row's `splits` blocks as get at least MIN_SHARE tiles
//     each take equal shares of them, so work follows depth, not capacity;
//     the other blocks exit at once, and a row that one block serves gets
//     o and lse from it directly (each block costs a few dependent memory
//     latencies, and a merge more: a shallow row is cheapest whole);
//   * one block per (split, kv head, row), the GQA group's query rows packed
//     together, so each K/V tile is read once for the whole group; 4 warps
//     walk disjoint tiles of the block's share, each with its own 2-stage
//     cp.async ring (16 bytes per thread, neighbouring lanes on one token
//     row; no block barrier in the loop), the block-table read of the next
//     tile issued a tile earlier still;
//   * every token row's address comes from bt (page j / page_size, offset j
//     % page_size), so any page size, partial last pages and holes inside
//     the visible range are served; slots outside [j_lo, j_hi] or on a -1
//     page are zero-filled and masked (a warp ballot), never dereferenced,
//     and a quantized pool's scales come through the same page and offset;
//   * bf16 q (paged_decode_mma_kernel): S = Q K^T and O += P V on
//     mma.sync.m16n8k16 (bf16 operands, fp32 accumulators), the group's rows
//     in one 16-row tile.  A quantized page stays 1 byte per element in
//     shared memory: ldmatrix moves the codes as byte pairs and they are
//     widened to bf16 in registers (int8 and e4m3 values are exact in bf16);
//     for K the head dimension is permuted the same way in Q's fragments, for
//     V the output dimension is (undone when o is written).  The k scale
//     multiplies the fp32 score, the v scale is folded into P.  P enters P.V
//     as three bf16 terms (split3_bf16), which carry fp32's 24 bits: one
//     bf16 P flips o's bf16 rounding against the plain version.  Each
//     product goes into a fresh accumulator that is added to the running
//     sums on the CUDA cores: the tensor cores truncate as they accumulate;
//   * fp32 q (paged_decode_simt_kernel, the card-vs-CPU parity path): the
//     same tiles, ring and split, in fp32 on the CUDA cores: a token per
//     lane pair for the scores, the group's rows by shuffles, P through
//     shared memory for P.V;
//   * head dim 256 (gemma-7b): o alone is 128 fp32 registers a thread, so
//     the tensor-core body reads Q's fragments from shared memory instead of
//     holding all 64 registers of them (QFrag), and the fp32 body's ring
//     keeps one stage per warp (two would need 261 KB);
//   * head dim 288 at GQA groups up to 48 (minicpm3-4b's absorbed MLA
//     latent: 40 query heads on one latent head): o over the group's rows
//     and all of D would be 432 registers a lane, so the block shares each
//     tile through one ring and its 9 warps own (16-row tile, third of D)
//     pieces of o (paged_decode_wide_*_kernel, below);
//   * the warps' (m, l, o) merge in shared memory in a fixed order.  A row
//     that one block serves gets o and lse from it; a row shared by several
//     gets a normalized fp32 partial and its lse from each, and
//     paged_decode_combine_kernel, launched by the same C call, merges
//     those rows by lse in a fixed order straight into o and lse (the
//     splits spread over a warp's lanes).  No atomics: two launches are
//     bitwise equal.  A NaN score (a poisoned key or scale) makes its row's
//     o and lse NaN through every body and the combine, as in JAX's
//     kernels: the serving engine's NaN guard depends on it.

#include <cuda_fp8.h>

#include <type_traits>

#include "sm90.cuh"  // cp.async, ldmatrix, mma.sync, split3_bf16, floor/ceil_div

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int NT = 128;  // 4 warps
constexpr int NW = NT / 32;
constexpr int KT = 16;  // local slots per tile
constexpr int MAX_GROUP = 16;  // query heads per kv head: one 16-row mma tile
constexpr int MIN_SHARE = 8;  // tiles per block at least (two per warp)

enum PoolType { POOL_FP = 0, POOL_INT8 = 1, POOL_FP8 = 2 };

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // quantized pools only
  const float* v_scale;
  const int* bt;
  const int* pos;  // null: pos_value for every row
  int pos_stride, pos_value;
  void* o;  // [B, H, D] in q's type
  float* lse;  // [B, H]
  float* o_parts;  // [B, splits, H, D]: partials of rows shared by blocks
  float* lse_parts;  // [B, splits, H]
  int H, Hkv, page_size, max_pages, splits, kv_off, stride_kv, hi;
  float scale_log2;
};

// A warp's ring: STAGES stages of [K tile | V tile | 16 k scales | 16 v
// scales], token rows RS bytes apart.  RS is an odd multiple of 16 bytes, so
// the 8 rows an ldmatrix (or a quarter-warp's 16-byte loads) touches hit
// distinct banks.  Two stages (a tile in flight beside the one in use),
// one where two would not fit: fp32 rows at D = 256 (4 warps x 2 stages x
// 33 KB = 261 KB).
template <int EB, int D>  // EB: bytes per pool element
struct Ring {
  static constexpr int ELEM = EB;
  static constexpr int RS = D * EB + 16;
  static constexpr int CH = D * EB / 16;  // 16-byte chunks per token row (even)
  static constexpr int TILE = KT * RS;
  static constexpr int STAGE = 2 * TILE + 2 * KT * 4;
  static constexpr int STAGES = D * EB > 512 ? 1 : 2;
  static constexpr int WARP = STAGES * STAGE;
  static constexpr int ALL = NW * WARP;
};

// Q's A fragments stay in registers up to D = 128; at D = 256 they would
// take 64 registers a thread beside o's 128, so the tensor-core body keeps
// Q (bf16, rows QRS bytes apart: ldmatrix conflict-free) in shared memory
// and reads each 16 dims' fragment where it multiplies
template <int D>
struct QFrag {
  static constexpr bool REG = D <= 128;
  static constexpr int QRS = (D + 8) * 2;
  static constexpr int BYTES = REG ? 0 : MAX_GROUP * QRS;
};

// Shared memory of a block: the rings (after the loop: the warps' partial
// outputs, [NW][16][D] fp32), then the merge's row statistics, then Q (the
// tensor-core body at D = 256: bf16 [16][D + 8]; the fp32 body: fp32
// [16][D]) and (fp32 body) the warps' P tiles.
template <typename R, int D>
struct Smem {
  static constexpr int ACC = NW * MAX_GROUP * D * 4;
  static constexpr int SCRATCH = R::ALL > ACC ? R::ALL : ACC;
  static constexpr int ML = SCRATCH;  // m_w, l_w [NW][16], fin_m, fin_l [16], fin_f [NW][16]
  static constexpr int ML_FLOATS = 3 * NW * MAX_GROUP + 2 * MAX_GROUP;
  static constexpr int Q = ML + ML_FLOATS * 4;  // fp32 body: Q [16][D], P [NW][16][KT]
  static constexpr int P = Q + MAX_GROUP * D * 4;
  static constexpr int MMA = Q + QFrag<D>::BYTES;
  static constexpr int SIMT = P + NW * MAX_GROUP * KT * 4;
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// two codes (low byte -> low half) as an exact bf16 pair
template <int POOL>
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t pair) {
  if constexpr (POOL == POOL_INT8) {
    return pack_bf16(static_cast<float>(static_cast<int8_t>(pair & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((pair >> 8) & 0xffu)));
  } else {
    const __half2_raw h =
        __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(pair & 0xffffu), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    return pack_bf16(f.x, f.y);
  }
}

template <int POOL>
__device__ __forceinline__ float code_f32(uint32_t byte) {
  if constexpr (POOL == POOL_INT8) {
    return static_cast<float>(static_cast<int8_t>(byte & 0xffu));
  } else {
    return __half2float(__half(
        __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(byte & 0xffu), __NV_E4M3)));
  }
}

// The row's visible local slots and this block's share of their 16-slot
// tiles.  A row takes only as many of its blocks as give each at least
// MIN_SHARE tiles (eff); the others exit at once, and with eff = 1 the one
// block writes o and lse itself, so a shallow row costs one block and no
// merge whatever the split count.
struct Share {
  int j_lo, j_hi;  // visible local slots (inclusive)
  int tile0;  // tile index of j_lo
  int eff;  // blocks of the row that have a share (1 .. splits)
  int t_begin, t_end;  // this block's tiles, relative to tile0
};

__device__ __forceinline__ Share solve_share(const Args& a, int b, int split) {
  const long long pos_b = a.pos != nullptr ? a.pos[(size_t)b * a.pos_stride] : a.pos_value;
  long long win_lo = pos_b - a.hi;
  if (win_lo < 0) win_lo = 0;
  long long j_lo = ceil_div(win_lo - a.kv_off, a.stride_kv);
  if (j_lo < 0) j_lo = 0;
  long long j_hi = floor_div(pos_b - a.kv_off, a.stride_kv);
  const long long cap = (long long)a.max_pages * a.page_size - 1;
  if (j_hi > cap) j_hi = cap;
  Share s;
  s.j_lo = (int)j_lo;
  s.j_hi = (int)j_hi;
  s.tile0 = (int)(j_lo / KT);
  const long long n_tiles = j_hi >= j_lo ? j_hi / KT - j_lo / KT + 1 : 0;
  const long long eff = (n_tiles + MIN_SHARE - 1) / MIN_SHARE;
  s.eff = eff < 1 ? 1 : (eff > a.splits ? a.splits : (int)eff);
  s.t_begin = split < s.eff ? (int)(n_tiles * split / s.eff) : 0;
  s.t_end = split < s.eff ? (int)(n_tiles * (split + 1) / s.eff) : 0;
  return s;
}

// The physical page of this lane's slot (lane % 16) of tile t (counted from
// the share's tile0), or -1 when the slot is hidden, unallocated or past the
// share: one block-table read, issued a tile ahead of its use
__device__ __forceinline__ int slot_page(const Args& a, const int* bt_row, const Share& sh, int t,
                                         int lane) {
  const int j = (sh.tile0 + t) * KT + (lane & (KT - 1));
  return t < sh.t_end && j >= sh.j_lo && j <= sh.j_hi ? bt_row[j / a.page_size] : -1;
}

// One warp's copy of tile t into a ring stage, 16 bytes per lane and
// instruction; lane r < 16 knows slot r's page (phys), and lanes r, r + 16
// copy its scales.  A hidden slot is zero-filled and never read.  Returns the
// tile's visible slots as a bit mask (bit r: slot r).
template <typename R, int D, bool QUANT>
__device__ __forceinline__ uint32_t issue_tile(uint32_t stage, const Args& a, const Share& sh,
                                               int t, int phys, int hk, int lane) {
  constexpr int EB = R::ELEM;
  const int r = lane & (KT - 1);
  const int j = (sh.tile0 + t) * KT + r;
  const bool valid = phys >= 0;
  const size_t row = valid ? ((size_t)phys * a.page_size + j % a.page_size) * a.Hkv + hk : 0;
  // neighbouring lanes take neighbouring chunks of one row (each lane's row
  // offset passed round by a shuffle): a row's D * EB bytes in one
  // instruction, two 128-byte lines per half-warp at bf16
  constexpr int LPR = R::CH < 32 ? R::CH : 32;  // lanes per row and instruction
  constexpr int RPI = 32 / LPR;  // rows per instruction
  const long long mine = valid ? (long long)row : -1;
#pragma unroll
  for (int i = 0; i < KT / RPI; ++i) {
    const int slot = i * RPI + lane / LPR;
    const long long rs = __shfl_sync(0xffffffffu, mine, slot);
    const bool ok = rs >= 0;
    const size_t off = ok ? (size_t)rs * (D * EB) : 0;
#pragma unroll
    for (int k = 0; k < R::CH / LPR; ++k) {
      const int c = k * LPR + lane % LPR;
      const uint32_t dst = stage + slot * R::RS + c * 16;
      cp_async16(dst, static_cast<const uint8_t*>(a.k_pool) + off + c * 16, ok);
      cp_async16(dst + R::TILE, static_cast<const uint8_t*>(a.v_pool) + off + c * 16, ok);
    }
  }
  if constexpr (QUANT) {
    const float* src = (lane < KT ? a.k_scale : a.v_scale) + row;
    cp_async4(stage + 2 * R::TILE + (lane >> 4) * KT * 4 + r * 4, src, valid);
  }
  return __ballot_sync(0xffffffffu, valid) & 0xffffu;
}

// A warp's walk over its tiles of the share (t_begin + warp, + NW, ...):
// STAGES - 1 tiles in flight ahead of the one in use, the block-table read
// one tile further ahead; body(stage bytes, stage address, mask) runs on
// each tile with a visible slot.  No block barrier.
template <typename R, int D, bool QUANT, typename Body>
__device__ __forceinline__ void walk_tiles(const Args& a, const Share& sh, int hk, int warp,
                                           int lane, uint8_t* smem, Body&& body) {
  constexpr int S = R::STAGES;
  const uint32_t sWarp = smem_u32(smem) + warp * R::WARP;
  const uint8_t* pWarp = smem + warp * R::WARP;
  const int* bt_row = a.bt + (size_t)blockIdx.z * a.max_pages;
  int t = sh.t_begin + warp;
  uint32_t vm[S];  // masks of tiles t, t + NW, ...
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    const int ti = t + i * NW;
    vm[i] = 0;
    if (ti < sh.t_end)
      vm[i] = issue_tile<R, D, QUANT>(sWarp + i * R::STAGE, a, sh, ti,
                                      slot_page(a, bt_row, sh, ti, lane), hk, lane);
    cp_async_commit();
  }
  int phys_next = slot_page(a, bt_row, sh, t + (S - 1) * NW, lane);
  for (int st = 0; t < sh.t_end; t += NW) {
    const int tn = t + (S - 1) * NW;
    const int sn = st + S - 1 < S ? st + S - 1 : st - 1;
    vm[S - 1] = 0;
    if (tn < sh.t_end)
      vm[S - 1] = issue_tile<R, D, QUANT>(sWarp + sn * R::STAGE, a, sh, tn, phys_next, hk, lane);
    phys_next = slot_page(a, bt_row, sh, tn + NW, lane);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncwarp();
    if (vm[0] != 0)  // a tile wholly hidden is skipped (uniform over the warp)
      body(pWarp + st * R::STAGE, sWarp + st * R::STAGE, vm[0]);
    __syncwarp();  // stage st is free again
#pragma unroll
    for (int i = 0; i < S - 1; ++i) vm[i] = vm[i + 1];
    st = st + 1 < S ? st + 1 : 0;
  }
  cp_async_wait<0>();
}

// A row with no visible slot: its one block writes o = 0, lse = NEG_INF
template <typename OutT>
__device__ void write_empty(const Args& a, int b, int hk, int G, int D) {
  for (int idx = threadIdx.x; idx < G * (D + 1); idx += blockDim.x) {
    const int g = idx / (D + 1), d = idx % (D + 1);
    const size_t bh = (size_t)b * a.H + hk * G + g;
    if (d < D)
      static_cast<OutT*>(a.o)[bh * D + d] = OutT(0.f);
    else
      a.lse[bh] = kNegInf;
  }
}

// After every warp left its loop and wrote its (m, l) per row: the block's
// row max, each warp's weight and the row sum, in a fixed order
__device__ __forceinline__ void merge_weights(float* ml) {
  const float* m_w = ml;
  const float* l_w = ml + NW * MAX_GROUP;
  float* fin_m = ml + 2 * NW * MAX_GROUP;
  float* fin_l = fin_m + MAX_GROUP;
  float* fin_f = fin_l + MAX_GROUP;  // [NW][16]
  const int row = threadIdx.x;
  if (row < MAX_GROUP) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, m_w[w * MAX_GROUP + row]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = fast_exp2(m_w[w * MAX_GROUP + row] - M);
      fin_f[w * MAX_GROUP + row] = f;
      L += f * l_w[w * MAX_GROUP + row];
    }
    fin_m[row] = M;
    fin_l[row] = L;
  }
}

// Sum the warps' weighted outputs (accbuf [NW][16][D]) and write o and lse
// (the row's only block) or the block's partial
template <typename OutT, int D>
__device__ void write_out(const Args& a, const float* accbuf, const float* ml, int b, int hk,
                          int G, int split, bool direct) {
  const float* fin_m = ml + 2 * NW * MAX_GROUP;
  const float* fin_l = fin_m + MAX_GROUP;
  for (int idx = threadIdx.x; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) acc += accbuf[(w * MAX_GROUP + g) * D + d];
    const float L = fin_l[g];
    const float val = !(L <= 0.f) ? acc / L : 0.f;  // a NaN sum passes
    const int h = hk * G + g;
    if (direct)
      static_cast<OutT*>(a.o)[((size_t)b * a.H + h) * D + d] = OutT(val);
    else
      a.o_parts[(((size_t)b * a.splits + split) * a.H + h) * D + d] = val;
  }
  for (int g = threadIdx.x; g < G; g += NT) {
    const float L = fin_l[g];
    const float val = !(L <= 0.f) ? fin_m[g] * kLn2 + logf(L) : kNegInf;
    const int h = hk * G + g;
    if (direct)
      a.lse[(size_t)b * a.H + h] = val;
    else
      a.lse_parts[((size_t)b * a.splits + split) * a.H + h] = val;
  }
}

// ===========================================================================
// bf16 q: the tensor-core body
// ===========================================================================

template <int POOL, int D>
__global__ void __launch_bounds__(NT) paged_decode_mma_kernel(const __grid_constant__ Args a) {
  constexpr bool QUANT = POOL != POOL_FP;
  using R = Ring<QUANT ? 1 : 2, D>;
  using SM = Smem<R, D>;
  constexpr int NB = D / 8;  // n-blocks of o
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const Share sh = solve_share(a, b, split);
  if (split >= sh.eff) return;  // no share: the row's merge skips this block
  if (sh.t_begin == sh.t_end) {  // (eff = 1)
    write_empty<bf16>(a, b, hk, G, D);
    return;
  }

  // Q's A fragments: rows lane/4 and lane/4 + 8 of the group (zero past G).
  // Over a quantized pool the head dimension is permuted within each 16:
  // this thread's k indices 2q, 2q+1 | 2q+8, 2q+9 (q = lane % 4) read dims
  // 4q, 4q+1 | 4q+2, 4q+3, the four codes one ldmatrix gives it below.
  // Up to D = 128 all of them in registers; at D = 256 (QFrag) Q waits in
  // shared memory with its dims in fragment order (column k of a 16 holds
  // the dim k reads), and one ldmatrix brings each 16 dims' fragment where
  // it multiplies.
  using QF = QFrag<D>;
  uint32_t qf[QF::REG ? D / 16 : 1][4];
  const bf16* qb = static_cast<const bf16*>(a.q) + ((size_t)b * a.H + hk * G) * D;
  if constexpr (QF::REG) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = lane / 4 + 8 * (e & 1);
        const int col = kk * 16 + (QUANT ? 4 * (lane % 4) + 2 * (e >> 1)
                                         : 2 * (lane % 4) + 8 * (e >> 1));
        qf[kk][e] = row < G ? *reinterpret_cast<const uint32_t*>(qb + (size_t)row * D + col) : 0u;
      }
  } else {
    // [16][D + 8] bf16, rows past G zero; k = 2q + 8h + p of a 16 holds dim
    // 4q + 2h + p over a quantized pool, dim k otherwise
    bf16* qs = reinterpret_cast<bf16*>(smem + SM::Q);
    for (int idx = tid; idx < MAX_GROUP * D; idx += NT) {
      const int row = idx / D, k = idx % D, k16 = k % 16;
      const int dim = QUANT ? k - k16 + 4 * ((k16 % 8) / 2) + 2 * (k16 / 8) + k16 % 2 : k;
      qs[row * (QF::QRS / 2) + k] = row < G ? qb[(size_t)row * D + dim] : __float2bfloat16(0.f);
    }
    __syncthreads();
  }
  // the A fragment of dims 16 kk .. 16 kk + 15
  const uint32_t sQf = smem_u32(smem + SM::Q) + (((lane / 8) % 2) * 8 + lane % 8) * QF::QRS +
                       (lane / 16) * 16;
  auto q_frag = [&](int kk, uint32_t (&f)[4]) {
    if constexpr (QF::REG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = qf[kk][e];
    } else {
      ldsm_x4(sQf + kk * 32, f);
    }
  };

  float oacc[NB][4];
  float m2[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  // The tensor cores truncate as they add into an accumulator: each product
  // below goes into a fresh accumulator and is added to the running fp32
  // sums on the CUDA cores (round to nearest), so o stays within fp32
  // rounding of the plain version over any depth.
  walk_tiles<R, D, QUANT>(a, sh, hk, warp, lane, smem, [&](const uint8_t* pst, uint32_t sK,
                                                          uint32_t vm) {
    const uint32_t sV = sK + R::TILE;
    const float* ksc = reinterpret_cast<const float*>(pst + 2 * R::TILE);
    const float* vsc = ksc + KT;
    // S = Q K^T, 16 rows x 16 slots: n-block 0 slots 0-7, n-block 1 slots 8-15
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if constexpr (!QUANT) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4];
        ldsm_x4(sK + ((lane / 16) * 8 + lane % 8) * R::RS + (kk * 16 + ((lane / 8) % 2) * 8) * 2,
                bk);
        float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        uint32_t af[4];
        q_frag(kk, af);
        mma_bf16(u[0], af, bk[0], bk[1]);
        mma_bf16(u[1], af, bk[2], bk[3]);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[e / 4][e % 4] += u[e / 4][e % 4];
      }
    } else {
      // byte pairs: matrix i covers slots 8 * (i % 2) + 0..7 and dims 16 *
      // (kk + i / 2) + 0..15; the thread gets codes of dims 4q .. 4q + 3
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t bk[4];
        ldsm_x4(sK + (((lane / 8) % 2) * 8 + lane % 8) * R::RS + (kk + lane / 16) * 16, bk);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          uint32_t af[4];
          q_frag(kk + half, af);
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            const uint32_t w = bk[2 * half + nb];
            mma_bf16(u[nb], af, codes_bf16x2<POOL>(w), codes_bf16x2<POOL>(w >> 16));
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) s[e / 4][e % 4] += u[e / 4][e % 4];
        }
      }
    }
    // element (nb, e): row half e / 2, slot nb * 8 + 2 * (lane % 4) + e % 2
    float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = nb * 8 + 2 * (lane % 4) + (e & 1);
        float x = s[nb][e] * a.scale_log2;
        if constexpr (QUANT) x *= ksc[slot];
        x = (vm >> slot) & 1u ? x : neg_inf();
        s[nb][e] = x;
        rmax[e / 2] = fmaxf(rmax[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float m_new = fmaxf(m2[h2], quad_max(rmax[h2]));
      alpha[h2] = fast_exp2(m2[h2] - m_new);
      m2[h2] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[nb][e] - m2[e / 2]);
        psum[e / 2] += p;
        // the v scale folded into P (the row sum keeps P itself)
        if constexpr (QUANT)
          s[nb][e] = p * vsc[nb * 8 + 2 * (lane % 4) + (e & 1)];
        else
          s[nb][e] = p;
      }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) lsum[h2] = lsum[h2] * alpha[h2] + psum[h2];
    // P (16 rows x 16 slots) as the A fragment, three bf16 terms
    uint32_t pf[3][4];
    split3_bf16(s[0][0], s[0][1], pf[0][0], pf[1][0], pf[2][0]);
    split3_bf16(s[0][2], s[0][3], pf[0][1], pf[1][1], pf[2][1]);
    split3_bf16(s[1][0], s[1][1], pf[0][2], pf[1][2], pf[2][2]);
    split3_bf16(s[1][2], s[1][3], pf[0][3], pf[1][3], pf[2][3]);
    // o = alpha o + P V for n-blocks n0 and n0 + 1 (B fragments b0/b1 of
    // each), the terms smallest first
    auto pv2 = [&](int n0, uint32_t b00, uint32_t b01, uint32_t b10, uint32_t b11) {
      float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int term = 2; term >= 0; --term) {
        mma_bf16(u[0], pf[term], b00, b01);
        mma_bf16(u[1], pf[term], b10, b11);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        oacc[n0 + e / 4][e % 4] = oacc[n0 + e / 4][e % 4] * alpha[(e % 4) / 2] + u[e / 4][e % 4];
    };
    if constexpr (!QUANT) {
#pragma unroll
      for (int p2 = 0; p2 < D / 16; ++p2) {
        uint32_t bv[4];
        ldsm_x4_trans(sV + (((lane / 8) % 2) * 8 + lane % 8) * R::RS +
                          (p2 * 16 + (lane / 16) * 8) * 2,
                      bv);
        pv2(2 * p2, bv[0], bv[1], bv[2], bv[3]);
      }
    } else {
      // byte pairs, transposed: matrix i covers slots 8 * (i % 2) + 0..7
      // and dims 16 * (2 c2 + i / 2) + 0..15; the thread gets slots 2q,
      // 2q+1 at dims 2n, 2n+1 (n = lane / 4).  Output n-block 2g + par
      // holds dims 16 g + 2 n' + par.
#pragma unroll
      for (int c2 = 0; c2 < D / 32; ++c2) {
        uint32_t bv[4];
        ldsm_x4_trans(sV + (((lane / 8) % 2) * 8 + lane % 8) * R::RS + (2 * c2 + lane / 16) * 16,
                      bv);
#pragma unroll
        for (int g2 = 0; g2 < 2; ++g2) {
          const uint32_t lo8 = __byte_perm(bv[2 * g2], 0, 0x3120);  // slots 0-7
          const uint32_t hi8 = __byte_perm(bv[2 * g2 + 1], 0, 0x3120);  // slots 8-15
          pv2(2 * (2 * c2 + g2), codes_bf16x2<POOL>(lo8), codes_bf16x2<POOL>(hi8),
              codes_bf16x2<POOL>(lo8 >> 16), codes_bf16x2<POOL>(hi8 >> 16));
        }
      }
    }
  });

  float* ml = reinterpret_cast<float*>(smem + SM::ML);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float l = quad_sum(lsum[h2]);
    if (lane % 4 == 0) {
      const int row = lane / 4 + 8 * h2;
      ml[warp * MAX_GROUP + row] = m2[h2];
      ml[NW * MAX_GROUP + warp * MAX_GROUP + row] = l;
    }
  }
  __syncthreads();  // every warp is past its loop: the rings are free
  merge_weights(ml);
  __syncthreads();
  float* accbuf = reinterpret_cast<float*>(smem);
  const float* fin_f = ml + 2 * NW * MAX_GROUP + 2 * MAX_GROUP;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = lane / 4 + 8 * (e / 2);
      const int col = 2 * (lane % 4) + (e & 1);
      const int d = QUANT ? 16 * (n / 2) + 2 * col + (n & 1) : 8 * n + col;
      accbuf[(warp * MAX_GROUP + row) * D + d] = oacc[n][e] * fin_f[warp * MAX_GROUP + row];
    }
  __syncthreads();
  write_out<bf16, D>(a, accbuf, ml, b, hk, G, split, sh.eff == 1);
}

// ===========================================================================
// fp32 q: the CUDA-core body
// ===========================================================================

template <int POOL, int D>
__global__ void __launch_bounds__(NT) paged_decode_simt_kernel(const __grid_constant__ Args a) {
  constexpr bool QUANT = POOL != POOL_FP;
  constexpr int DH = D / 2;  // dims per half-warp in the scores
  constexpr int DC = D / 32;  // dims per lane in P.V
  using R = Ring<QUANT ? 1 : 4, D>;
  using SM = Smem<R, D>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const Share sh = solve_share(a, b, split);
  if (split >= sh.eff) return;  // no share: the row's merge skips this block
  if (sh.t_begin == sh.t_end) {  // (eff = 1)
    write_empty<float>(a, b, hk, G, D);
    return;
  }
  float* Qs = reinterpret_cast<float*>(smem + SM::Q);  // [16][D], zero past G
  float* pw = reinterpret_cast<float*>(smem + SM::P) + warp * MAX_GROUP * KT;  // [16][KT]
  {
    const float* qb = static_cast<const float*>(a.q) + ((size_t)b * a.H + hk * G) * D;
    for (int idx = tid; idx < MAX_GROUP * D; idx += NT)
      Qs[idx] = idx / D < G ? qb[idx] : 0.f;
  }
  __syncthreads();

  float m[MAX_GROUP], l[MAX_GROUP], acc[MAX_GROUP][DC];
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[g][c] = 0.f;
  }

  const int r = lane & (KT - 1), half = lane >> 4;
  walk_tiles<R, D, QUANT>(a, sh, hk, warp, lane, smem, [&](const uint8_t* Kt, uint32_t,
                                                          uint32_t vm) {
    const uint8_t* Vt = Kt + R::TILE;
    const float* ksc = reinterpret_cast<const float*>(Kt + 2 * R::TILE);
    const float* vsc = ksc + KT;
    // scores: lane pair (r, r + 16) shares slot r, each half of the dims
    float s[MAX_GROUP];
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) s[g] = 0.f;
    const float* qh = Qs + half * DH;
    if constexpr (!QUANT) {
      const float* kr = reinterpret_cast<const float*>(Kt + r * R::RS) + half * DH;
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int g = 0; g < MAX_GROUP; ++g) {
          if (g >= G) break;
          const float4 q4 = *reinterpret_cast<const float4*>(qh + g * D + d);
          s[g] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
        }
      }
    } else {
      const uint8_t* kr = Kt + r * R::RS + half * DH;
#pragma unroll 1
      for (int d = 0; d < DH; d += 16) {
        const uint4 c4 = *reinterpret_cast<const uint4*>(kr + d);
        const uint32_t w[4] = {c4.x, c4.y, c4.z, c4.w};
        float kf[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) kf[e] = code_f32<POOL>(w[e / 4] >> (8 * (e % 4)));
#pragma unroll
        for (int g = 0; g < MAX_GROUP; ++g) {
          if (g >= G) break;
#pragma unroll
          for (int e = 0; e < 16; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qh + g * D + d + e);
            s[g] += q4.x * kf[e] + q4.y * kf[e + 1] + q4.z * kf[e + 2] + q4.w * kf[e + 3];
          }
        }
      }
    }
    const bool vis = (vm >> r) & 1u;
    const float kmul = QUANT ? a.scale_log2 * ksc[r] : a.scale_log2;
    const float vmul = QUANT ? vsc[r] : 1.f;
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) {
      if (g >= G) break;  // uniform over the warp
      const float sg = s[g] + __shfl_xor_sync(0xffffffffu, s[g], 16);  // both halves
      const float x = vis ? sg * kmul : neg_inf();
      float tmax = x;
#pragma unroll
      for (int off = 1; off < KT; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[g], tmax);
      const float alpha = fast_exp2(m[g] - m_new);
      const float p = fast_exp2(x - m_new);
      float ps = p;
#pragma unroll
      for (int off = 1; off < KT; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[g] = l[g] * alpha + ps;
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[g][c] *= alpha;
      if (half == 0) pw[g * KT + r] = p * vmul;
    }
    __syncwarp();
#pragma unroll 4
    for (int tk = 0; tk < KT; ++tk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        if constexpr (QUANT)
          vv[c] = code_f32<POOL>(Vt[tk * R::RS + lane + 32 * c]);
        else
          vv[c] = reinterpret_cast<const float*>(Vt + tk * R::RS)[lane + 32 * c];
      }
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g) {
        if (g >= G) break;
        const float pt = pw[g * KT + tk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[g][c] += pt * vv[c];
      }
    }
    __syncwarp();  // this warp's P tile is free again
  });

  float* ml = reinterpret_cast<float*>(smem + SM::ML);
  if (lane < MAX_GROUP) {
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
      if (g == lane) {
        ml[warp * MAX_GROUP + g] = m[g];
        ml[NW * MAX_GROUP + warp * MAX_GROUP + g] = l[g];
      }
  }
  __syncthreads();  // every warp is past its loop: the rings are free
  merge_weights(ml);
  __syncthreads();
  float* accbuf = reinterpret_cast<float*>(smem);
  const float* fin_f = ml + 2 * NW * MAX_GROUP + 2 * MAX_GROUP;
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) {
    const float f = fin_f[warp * MAX_GROUP + g];
#pragma unroll
    for (int c = 0; c < DC; ++c) accbuf[(warp * MAX_GROUP + g) * D + lane + 32 * c] = acc[g][c] * f;
  }
  __syncthreads();
  write_out<float, D>(a, accbuf, ml, b, hk, G, split, sh.eff == 1);
}

// ===========================================================================
// D = 288 at GQA groups up to 48: MLA's absorbed latent (minicpm3-4b: 40
// query heads against one latent "head" of kv_lora_rank + rope = 288 dims)
// ===========================================================================
//
// The bodies above keep a warp's o over all of the group's rows and all of
// D in registers: 48 padded rows x 288 dims would be 432 a lane.  So here
// the block shares each K / V tile: 9 warps, warp w owning row tile w / 3
// (16 of the 48 padded rows) and third w % 3 of D (96 dims) of o, and all of
// them walk the block's tiles together through one ring in shared memory
// (filled by every thread's cp.asyncs, WIDE_STAGES tiles in flight, a block
// barrier per tile).  Each warp computes its row tile's scores over the
// whole of D (the three warps of a row tile repeat that product: bytes, not
// products, bound the kernel) and so holds its rows' (m, l) itself: a warp
// writes its own (rows, dims) of o, with no merge between warps.  A row
// tile wholly past the group computes nothing.  The split over the row's
// tiles, the combine, the quantized branch, the masks and the NaN paths
// are those of the bodies above.

constexpr int WIDE_D = 288;
constexpr int WIDE_GROUP = 48;  // three 16-row tiles
constexpr int WIDE_WARPS = 9;   // 3 row tiles x 3 thirds of D
constexpr int WIDE_NT = 32 * WIDE_WARPS;

// A stage: [K tile | V tile | 16 k scales | 16 v scales | 16 visible flags],
// token rows RS bytes apart (an odd multiple of 16: ldmatrix conflict-free)
template <int EB, int D>
struct WideRing {
  static constexpr int ELEM = EB;
  static constexpr int RS = D * EB + 16;
  static constexpr int CH = D * EB / 16;
  static constexpr int TILE = KT * RS;
  static constexpr int SCALES = 2 * TILE;
  static constexpr int VIS = SCALES + 2 * KT * 4;
  static constexpr int STAGE = VIS + KT * 4;
  static constexpr int STAGES = EB == 4 ? 3 : 4;
  static constexpr int ALL = STAGES * STAGE;
};

// shared memory of a wide block: the ring, Q (bf16 [48][D + 8] in fragment
// order for the tensor-core body, fp32 [48][D] for the CUDA-core one), and
// (CUDA-core body) the warps' P tiles [WIDE_WARPS][16][KT]
template <typename R, int D>
struct WideSmem {
  static constexpr int Q = R::ALL;
  static constexpr int QRS = (D + 8) * 2;
  static constexpr int MMA = Q + WIDE_GROUP * QRS;
  static constexpr int P = Q + WIDE_GROUP * D * 4;
  static constexpr int SIMT = P + WIDE_WARPS * 16 * KT * 4;
};

// The block's copy of tile t into a stage: every thread's 16-byte chunks of
// its K and V rows; threads 0-15 the tile's visible flags (and the k
// scales), 16-31 the v scales.  A hidden slot is zero-filled and never read.
template <typename R, int D, bool QUANT>
__device__ __forceinline__ void wide_issue(uint32_t stage, int* vis, const Args& a,
                                           const Share& sh, const int* bt_row, int t, int hk) {
  constexpr int EB = R::ELEM;
  for (int idx = threadIdx.x; idx < KT * R::CH + 2 * KT; idx += WIDE_NT) {
    const int r = idx < KT * R::CH ? idx / R::CH : (idx - KT * R::CH) % KT;
    const int j = (sh.tile0 + t) * KT + r;
    const int phys = j >= sh.j_lo && j <= sh.j_hi ? bt_row[j / a.page_size] : -1;
    const bool ok = phys >= 0;
    const size_t row = ok ? ((size_t)phys * a.page_size + j % a.page_size) * a.Hkv + hk : 0;
    if (idx < KT * R::CH) {
      const int c = idx % R::CH;
      const uint32_t dst = stage + r * R::RS + c * 16;
      const size_t off = row * (D * EB) + c * 16;
      cp_async16(dst, static_cast<const uint8_t*>(a.k_pool) + off, ok);
      cp_async16(dst + R::TILE, static_cast<const uint8_t*>(a.v_pool) + off, ok);
    } else {
      const int kind = (idx - KT * R::CH) / KT;  // 0: k scale and the flag, 1: v scale
      if (kind == 0) vis[r] = ok;
      if constexpr (QUANT)
        cp_async4(stage + R::SCALES + kind * KT * 4 + r * 4,
                  (kind == 0 ? a.k_scale : a.v_scale) + row, ok);
    }
  }
}

// The block's walk over its share: WIDE_STAGES - 1 tiles in flight ahead of
// the one in use; body(stage bytes, stage address, visible mask) runs on
// every tile with a visible slot, in every thread (a block barrier on each
// side of it)
template <typename R, int D, bool QUANT, typename Body>
__device__ __forceinline__ void wide_walk(const Args& a, const Share& sh, int hk, uint8_t* smem,
                                          Body&& body) {
  constexpr int S = R::STAGES;
  const uint32_t s0 = smem_u32(smem);
  const int* bt_row = a.bt + (size_t)blockIdx.z * a.max_pages;
  const int n = sh.t_end - sh.t_begin;
  auto vis_of = [&](int st) { return reinterpret_cast<int*>(smem + st * R::STAGE + R::VIS); };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n) wide_issue<R, D, QUANT>(s0 + i * R::STAGE, vis_of(i), a, sh, bt_row, sh.t_begin + i, hk);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    const int in = i + S - 1;
    if (in < n)
      wide_issue<R, D, QUANT>(s0 + (in % S) * R::STAGE, vis_of(in % S), a, sh, bt_row,
                              sh.t_begin + in, hk);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncthreads();  // tile i has landed, for every thread
    const int st = i % S;
    const int* vis = vis_of(st);
    uint32_t vm = 0;
#pragma unroll
    for (int r = 0; r < KT; ++r) vm |= vis[r] ? 1u << r : 0u;
    if (vm != 0)  // uniform over the block
      body(smem + st * R::STAGE, s0 + st * R::STAGE, vm);
    __syncthreads();  // stage st is free again
  }
  cp_async_wait<0>();
}

// One element of o (the row's only block: direct) or of the block's
// partial, from its unnormalized sum acc and the row sum L
template <typename OutT>
__device__ __forceinline__ void wide_store(const Args& a, int b, int hk, int G, int split,
                                           bool direct, int row, int d, float acc, float L) {
  const float val = !(L <= 0.f) ? acc / L : 0.f;  // a NaN sum passes
  const int h = hk * G + row;
  if (direct)
    static_cast<OutT*>(a.o)[((size_t)b * a.H + h) * WIDE_D + d] = OutT(val);
  else
    a.o_parts[(((size_t)b * a.splits + split) * a.H + h) * WIDE_D + d] = val;
}

// The row's lse (m2: its running max in the log2 domain), as wide_store
__device__ __forceinline__ void wide_store_lse(const Args& a, int b, int hk, int G, int split,
                                               bool direct, int row, float m2, float L) {
  const float val = !(L <= 0.f) ? m2 * kLn2 + logf(L) : kNegInf;
  const int h = hk * G + row;
  if (direct)
    a.lse[(size_t)b * a.H + h] = val;
  else
    a.lse_parts[((size_t)b * a.splits + split) * a.H + h] = val;
}

// bf16 q: products on mma.sync, as paged_decode_mma_kernel's
template <int POOL, int D>
__global__ void __launch_bounds__(WIDE_NT) paged_decode_wide_mma_kernel(
    const __grid_constant__ Args a) {
  constexpr bool QUANT = POOL != POOL_FP;
  using R = WideRing<QUANT ? 1 : 2, D>;
  using SM = WideSmem<R, D>;
  constexpr int DT = D / 3;       // dims of o per warp
  constexpr int NB = DT / 8;      // its n-blocks
  static_assert(D % 96 == 0, "a third of D is whole 32-dim blocks");
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp / 3, dt = warp % 3;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const Share sh = solve_share(a, b, split);
  if (split >= sh.eff) return;  // no share: the row's merge skips this block
  if (sh.t_begin == sh.t_end) {  // (eff = 1)
    write_empty<bf16>(a, b, hk, G, D);
    return;
  }
  // Q [48][D + 8] bf16, rows past G zero, dims in fragment order over a
  // quantized pool (paged_decode_mma_kernel's QFrag layout)
  {
    const bf16* qb = static_cast<const bf16*>(a.q) + ((size_t)b * a.H + hk * G) * D;
    bf16* qs = reinterpret_cast<bf16*>(smem + SM::Q);
    for (int idx = tid; idx < WIDE_GROUP * D; idx += WIDE_NT) {
      const int row = idx / D, k = idx % D, k16 = k % 16;
      const int dim = QUANT ? k - k16 + 4 * ((k16 % 8) / 2) + 2 * (k16 / 8) + k16 % 2 : k;
      qs[row * (SM::QRS / 2) + k] = row < G ? qb[(size_t)row * D + dim] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();
  const bool active = rt * 16 < G;  // uniform over the warp
  const uint32_t sQf = smem_u32(smem + SM::Q) +
                       (rt * 16 + ((lane / 8) % 2) * 8 + lane % 8) * SM::QRS + (lane / 16) * 16;

  float oacc[NB][4];
  float m2[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  wide_walk<R, D, QUANT>(a, sh, hk, smem, [&](const uint8_t* pst, uint32_t sK, uint32_t vm) {
    if (!active) return;
    const uint32_t sV = sK + R::TILE;
    const float* ksc = reinterpret_cast<const float*>(pst + R::SCALES);
    const float* vsc = ksc + KT;
    // S = Q K^T over all of D, 16 rows x 16 slots, each k16 product into a
    // fresh accumulator added on the CUDA cores (paged_decode_mma_kernel)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if constexpr (!QUANT) {
#pragma unroll 6
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4], af[4];
        ldsm_x4(sK + ((lane / 16) * 8 + lane % 8) * R::RS + (kk * 16 + ((lane / 8) % 2) * 8) * 2,
                bk);
        ldsm_x4(sQf + kk * 32, af);
        float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        mma_bf16(u[0], af, bk[0], bk[1]);
        mma_bf16(u[1], af, bk[2], bk[3]);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[e / 4][e % 4] += u[e / 4][e % 4];
      }
    } else {
#pragma unroll 3
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t bk[4];
        ldsm_x4(sK + (((lane / 8) % 2) * 8 + lane % 8) * R::RS + (kk + lane / 16) * 16, bk);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          uint32_t af[4];
          ldsm_x4(sQf + (kk + half) * 32, af);
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            const uint32_t w = bk[2 * half + nb];
            mma_bf16(u[nb], af, codes_bf16x2<POOL>(w), codes_bf16x2<POOL>(w >> 16));
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) s[e / 4][e % 4] += u[e / 4][e % 4];
        }
      }
    }
    float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = nb * 8 + 2 * (lane % 4) + (e & 1);
        float x = s[nb][e] * a.scale_log2;
        if constexpr (QUANT) x *= ksc[slot];
        x = (vm >> slot) & 1u ? x : neg_inf();
        s[nb][e] = x;
        rmax[e / 2] = fmaxf(rmax[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float m_new = fmaxf(m2[h2], quad_max(rmax[h2]));
      alpha[h2] = fast_exp2(m2[h2] - m_new);
      m2[h2] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[nb][e] - m2[e / 2]);
        psum[e / 2] += p;
        if constexpr (QUANT)
          s[nb][e] = p * vsc[nb * 8 + 2 * (lane % 4) + (e & 1)];
        else
          s[nb][e] = p;
      }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) lsum[h2] = lsum[h2] * alpha[h2] + psum[h2];
    uint32_t pf[3][4];
    split3_bf16(s[0][0], s[0][1], pf[0][0], pf[1][0], pf[2][0]);
    split3_bf16(s[0][2], s[0][3], pf[0][1], pf[1][1], pf[2][1]);
    split3_bf16(s[1][0], s[1][1], pf[0][2], pf[1][2], pf[2][2]);
    split3_bf16(s[1][2], s[1][3], pf[0][3], pf[1][3], pf[2][3]);
    auto pv2 = [&](int n0, uint32_t b00, uint32_t b01, uint32_t b10, uint32_t b11) {
      float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int term = 2; term >= 0; --term) {
        mma_bf16(u[0], pf[term], b00, b01);
        mma_bf16(u[1], pf[term], b10, b11);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        oacc[n0 + e / 4][e % 4] = oacc[n0 + e / 4][e % 4] * alpha[(e % 4) / 2] + u[e / 4][e % 4];
    };
    // o = alpha o + P V over this warp's third of D
    if constexpr (!QUANT) {
#pragma unroll
      for (int lp = 0; lp < DT / 16; ++lp) {
        uint32_t bv[4];
        ldsm_x4_trans(sV + (((lane / 8) % 2) * 8 + lane % 8) * R::RS +
                          ((dt * (DT / 16) + lp) * 16 + (lane / 16) * 8) * 2,
                      bv);
        pv2(2 * lp, bv[0], bv[1], bv[2], bv[3]);
      }
    } else {
#pragma unroll
      for (int lc = 0; lc < DT / 32; ++lc) {
        uint32_t bv[4];
        ldsm_x4_trans(sV + (((lane / 8) % 2) * 8 + lane % 8) * R::RS +
                          (2 * (dt * (DT / 32) + lc) + lane / 16) * 16,
                      bv);
#pragma unroll
        for (int g2 = 0; g2 < 2; ++g2) {
          const uint32_t lo8 = __byte_perm(bv[2 * g2], 0, 0x3120);
          const uint32_t hi8 = __byte_perm(bv[2 * g2 + 1], 0, 0x3120);
          pv2(2 * (2 * lc + g2), codes_bf16x2<POOL>(lo8), codes_bf16x2<POOL>(hi8),
              codes_bf16x2<POOL>(lo8 >> 16), codes_bf16x2<POOL>(hi8 >> 16));
        }
      }
    }
  });

  if (!active) return;
  const bool direct = sh.eff == 1;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float L = quad_sum(lsum[h2]);
    const int row = rt * 16 + lane / 4 + 8 * h2;
    if (row >= G) continue;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int col = 2 * (lane % 4) + p;
        const int d = dt * DT + (QUANT ? 16 * (n / 2) + 2 * col + (n & 1) : 8 * n + col);
        wide_store<bf16>(a, b, hk, G, split, direct, row, d, oacc[n][2 * h2 + p], L);
      }
    if (dt == 0 && lane % 4 == 0) wide_store_lse(a, b, hk, G, split, direct, row, m2[h2], L);
  }
}

// fp32 q: on the CUDA cores, as paged_decode_simt_kernel's: a slot per lane
// pair for the scores (each half of D), the row tile's rows by shuffles, P
// through shared memory for P.V, a lane holding dims lane + 32 c of the
// warp's third
template <int POOL, int D>
__global__ void __launch_bounds__(WIDE_NT) paged_decode_wide_simt_kernel(
    const __grid_constant__ Args a) {
  constexpr bool QUANT = POOL != POOL_FP;
  using R = WideRing<QUANT ? 1 : 4, D>;
  using SM = WideSmem<R, D>;
  constexpr int DH = D / 2;        // dims per half-warp in the scores
  constexpr int DT = D / 3;        // dims of o per warp
  constexpr int DC = DT / 32;      // dims per lane in P.V
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp / 3, dt = warp % 3;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const Share sh = solve_share(a, b, split);
  if (split >= sh.eff) return;
  if (sh.t_begin == sh.t_end) {
    write_empty<float>(a, b, hk, G, D);
    return;
  }
  float* Qs = reinterpret_cast<float*>(smem + SM::Q);  // [48][D], zero past G
  float* pw = reinterpret_cast<float*>(smem + SM::P) + warp * 16 * KT;  // [16][KT]
  {
    const float* qb = static_cast<const float*>(a.q) + ((size_t)b * a.H + hk * G) * D;
    for (int idx = tid; idx < WIDE_GROUP * D; idx += WIDE_NT)
      Qs[idx] = idx / D < G ? qb[idx] : 0.f;
  }
  __syncthreads();
  const int g0 = rt * 16;
  const int ng = G - g0 < 16 ? G - g0 : 16;  // this warp's rows (<= 0: none)

  float m[16], l[16], acc[16][DC];
#pragma unroll
  for (int g = 0; g < 16; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[g][c] = 0.f;
  }

  const int r = lane & (KT - 1), half = lane >> 4;
  wide_walk<R, D, QUANT>(a, sh, hk, smem, [&](const uint8_t* Kt, uint32_t, uint32_t vm) {
    if (ng <= 0) return;
    const uint8_t* Vt = Kt + R::TILE;
    const float* ksc = reinterpret_cast<const float*>(Kt + R::SCALES);
    const float* vsc = ksc + KT;
    float s[16];
#pragma unroll
    for (int g = 0; g < 16; ++g) s[g] = 0.f;
    const float* qh = Qs + g0 * D + half * DH;
    if constexpr (!QUANT) {
      const float* kr = reinterpret_cast<const float*>(Kt + r * R::RS) + half * DH;
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int g = 0; g < 16; ++g) {
          if (g >= ng) break;
          const float4 q4 = *reinterpret_cast<const float4*>(qh + g * D + d);
          s[g] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
        }
      }
    } else {
      const uint8_t* kr = Kt + r * R::RS + half * DH;
#pragma unroll 1
      for (int d = 0; d < DH; d += 16) {
        const uint4 c4 = *reinterpret_cast<const uint4*>(kr + d);
        const uint32_t w[4] = {c4.x, c4.y, c4.z, c4.w};
        float kf[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) kf[e] = code_f32<POOL>(w[e / 4] >> (8 * (e % 4)));
#pragma unroll
        for (int g = 0; g < 16; ++g) {
          if (g >= ng) break;
#pragma unroll
          for (int e = 0; e < 16; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qh + g * D + d + e);
            s[g] += q4.x * kf[e] + q4.y * kf[e + 1] + q4.z * kf[e + 2] + q4.w * kf[e + 3];
          }
        }
      }
    }
    const bool vis = (vm >> r) & 1u;
    const float kmul = QUANT ? a.scale_log2 * ksc[r] : a.scale_log2;
    const float vmul = QUANT ? vsc[r] : 1.f;
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      if (g >= ng) break;  // uniform over the warp
      const float sg = s[g] + __shfl_xor_sync(0xffffffffu, s[g], 16);
      const float x = vis ? sg * kmul : neg_inf();
      float tmax = x;
#pragma unroll
      for (int off = 1; off < KT; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[g], tmax);
      const float alpha = fast_exp2(m[g] - m_new);
      const float p = fast_exp2(x - m_new);
      float ps = p;
#pragma unroll
      for (int off = 1; off < KT; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[g] = l[g] * alpha + ps;
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[g][c] *= alpha;
      if (half == 0) pw[g * KT + r] = p * vmul;
    }
    __syncwarp();
#pragma unroll 4
    for (int tk = 0; tk < KT; ++tk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = dt * DT + lane + 32 * c;
        if constexpr (QUANT)
          vv[c] = code_f32<POOL>(Vt[tk * R::RS + d]);
        else
          vv[c] = reinterpret_cast<const float*>(Vt + tk * R::RS)[d];
      }
#pragma unroll
      for (int g = 0; g < 16; ++g) {
        if (g >= ng) break;
        const float pt = pw[g * KT + tk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[g][c] += pt * vv[c];
      }
    }
    __syncwarp();  // this warp's P tile is free again
  });

  const bool direct = sh.eff == 1;
#pragma unroll
  for (int g = 0; g < 16; ++g) {
    if (g >= ng) break;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      wide_store<float>(a, b, hk, G, split, direct, g0 + g, dt * DT + lane + 32 * c, acc[g][c],
                        l[g]);
    if (dt == 0 && lane == 0) wide_store_lse(a, b, hk, G, split, direct, g0 + g, m[g], l[g]);
  }
}

// ===========================================================================
// the split combine
// ===========================================================================

// Merge the splits' partials ([B, S, H, D] fp32, lse [B, S, H]) by their lse,
// one warp per (b, h) row, splits in order; empty partials (lse NEG_INF)
// weigh 0 and are never read, so a row with none left is exactly o = 0, lse
// = NEG_INF.  After the main kernel (solve: geo holds its arguments), a row
// merges the partials of its eff blocks, and a row with eff = 1 (written by
// its block) is left alone; alone, every row merges all S.  A lane holds
// dims lane + 32 c for c < D / 32 <= DCMAX (4 up to D = 128, 8 at 256, 9 at
// 288).
template <int BF16_OUT, int DCMAX>
__global__ void __launch_bounds__(128) paged_decode_combine_kernel(
    const float* __restrict__ o_parts, const float* __restrict__ lse_parts, void* __restrict__ o,
    float* __restrict__ lse, int B, int S_all, int H, int D, const __grid_constant__ Args geo,
    int solve) {
  using OutT = typename std::conditional<BF16_OUT != 0, bf16, float>::type;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;  // b * H + h
  if (row >= (long long)B * H) return;
  const int b = (int)(row / H), h = (int)(row % H);
  const int S = solve ? solve_share(geo, b, 0).eff : S_all;
  if (solve && S == 1) return;
  const float* lp = lse_parts + (size_t)b * S_all * H + h;  // split s at lp[s * H]
  const float* op = o_parts + ((size_t)b * S_all * H + h) * D;  // split s at op[s * H * D]
  OutT* orow = static_cast<OutT*>(o) + row * D;
  // the row max and the weights' sum, the splits spread over the lanes
  float M = kNegInf;
  // NaN-keeping maxima and weights: a split with a NaN score poisons the row
  for (int s = lane; s < S; s += 32) M = max_nan(M, lp[(size_t)s * H]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = max_nan(M, __shfl_xor_sync(0xffffffffu, M, off));
  if (M <= kNegInf / 2) {
    for (int d = lane; d < D; d += 32) orow[d] = OutT(0.f);
    if (lane == 0) lse[row] = kNegInf;
    return;
  }
  float W = 0.f;
  for (int s = lane; s < S; s += 32) {
    const float ls = lp[(size_t)s * H];
    if (!(ls <= kNegInf / 2)) W += expf(ls - M);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) W += __shfl_xor_sync(0xffffffffu, W, off);
  // o: dims lane + 32 c; split i's weight from lane i % 32, splits in order
  // (an empty split weighs 0 and its partial, never written, is not used)
  float acc[DCMAX];
#pragma unroll
  for (int c = 0; c < DCMAX; ++c) acc[c] = 0.f;
  const int DC = D / 32;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const float ls = s0 + lane < S ? lp[(size_t)(s0 + lane) * H] : kNegInf;
    const float w = !(ls <= kNegInf / 2) ? expf(ls - M) : 0.f;
    const int n = S - s0 < 32 ? S - s0 : 32;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float wi = __shfl_sync(0xffffffffu, w, i);
      const float* src = op + (size_t)(s0 + i) * H * D + lane;
#pragma unroll
      for (int c = 0; c < DCMAX; ++c)
        if (c < DC) {
          const float x = src[32 * c];
          acc[c] = !(wi <= 0.f) ? fmaf(wi, x, acc[c]) : acc[c];
        }
    }
  }
#pragma unroll
  for (int c = 0; c < DCMAX; ++c)
    if (c < DC) orow[lane + 32 * c] = OutT(acc[c] / W);
  if (lane == 0) lse[row] = M + logf(W);
}

cudaError_t launch_combine(const float* o_parts, const float* lse_parts, void* o, float* lse,
                           int B, int S, int H, int D, int bf16_out, const Args& geo, int solve,
                           cudaStream_t stream) {
  const long long rows = (long long)B * H;
  const unsigned blocks = (unsigned)((rows + 3) / 4);
  auto kern = D > 256   ? (bf16_out ? paged_decode_combine_kernel<1, 9>
                                    : paged_decode_combine_kernel<0, 9>)
              : D > 128 ? (bf16_out ? paged_decode_combine_kernel<1, 8>
                                    : paged_decode_combine_kernel<0, 8>)
                        : (bf16_out ? paged_decode_combine_kernel<1, 4>
                                    : paged_decode_combine_kernel<0, 4>);
  kern<<<blocks, 128, 0, stream>>>(o_parts, lse_parts, o, lse, B, S, H, D, geo, solve);
  return cudaGetLastError();
}

template <int POOL, int D, bool MMA>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int EB = POOL != POOL_FP ? 1 : (MMA ? 2 : 4);
  constexpr int smem = MMA ? Smem<Ring<EB, D>, D>::MMA : Smem<Ring<EB, D>, D>::SIMT;
  auto kern = MMA ? paged_decode_mma_kernel<POOL, D> : paged_decode_simt_kernel<POOL, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.splits, a.Hkv, B);
  kern<<<grid, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return launch_combine(a.o_parts, a.lse_parts, a.o, a.lse, B, a.splits, a.H, D, MMA ? 1 : 0, a,
                        1, stream);
}

template <int POOL, bool MMA>
cudaError_t launch_wide(const Args& a, int B, cudaStream_t stream) {
  constexpr int D = WIDE_D;
  constexpr int EB = POOL != POOL_FP ? 1 : (MMA ? 2 : 4);
  using SM = WideSmem<WideRing<EB, D>, D>;
  constexpr int smem = MMA ? SM::MMA : SM::SIMT;
  auto kern = MMA ? paged_decode_wide_mma_kernel<POOL, D> : paged_decode_wide_simt_kernel<POOL, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.splits, a.Hkv, B);
  kern<<<grid, WIDE_NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return launch_combine(a.o_parts, a.lse_parts, a.o, a.lse, B, a.splits, a.H, D, MMA ? 1 : 0, a,
                        1, stream);
}

template <int POOL, bool MMA>
cudaError_t dispatch_d(int D, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<POOL, 32, MMA>(a, B, stream);
    case 64: return launch<POOL, 64, MMA>(a, B, stream);
    case 128: return launch<POOL, 128, MMA>(a, B, stream);
    case 256: return launch<POOL, 256, MMA>(a, B, stream);
    case WIDE_D: return launch_wide<POOL, MMA>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool MMA>
cudaError_t dispatch_pool(int pool_type, int D, const Args& a, int B, cudaStream_t stream) {
  switch (pool_type) {
    case POOL_FP: return dispatch_d<POOL_FP, MMA>(D, a, B, stream);
    case POOL_INT8: return dispatch_d<POOL_INT8, MMA>(D, a, B, stream);
    case POOL_FP8: return dispatch_d<POOL_FP8, MMA>(D, a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, D] (dtype: 0 = float32, 1 = bfloat16), pools [num_pages,
// page_size, Hkv, D] (pool_type: 0 = q's type, k_scale/v_scale null; 1 =
// int8, 2 = fp8-e4m3, with k_scale/v_scale [num_pages, page_size, Hkv]
// fp32), bt [B, max_pages] int32, pos int32 at pos[b * pos_stride] (or
// pos_value for every row when pos is null).  Writes o [B, H, D] in q's
// type and lse [B, H] fp32; with splits > 1, o_parts [B, splits, H, D] and
// lse_parts [B, splits, H] (fp32) are the partials' scratch and a second
// kernel merges the rows that more than one block shared.  Returns
// cudaGetLastError() after the launches.
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* k_scale, const void* v_scale, const void* bt,
                            const void* pos, int pos_stride, int pos_value, void* o, void* lse,
                            void* o_parts, void* lse_parts, int B, int H, int Hkv, int D,
                            int page_size, int max_pages, int splits, int kv_off, int stride_kv,
                            int hi, float scale, int dtype, int pool_type, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > (D == WIDE_D ? WIDE_GROUP : MAX_GROUP) ||
      page_size < 1 || stride_kv < 1 ||
      max_pages < 1 || splits < 1 || (splits > 1 && (o_parts == nullptr || lse_parts == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((pool_type != POOL_FP) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  if (pool_type != POOL_FP && D % 16 != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int*>(bt),
               static_cast<const int*>(pos), pos_stride, pos_value, o, static_cast<float*>(lse),
               static_cast<float*>(o_parts), static_cast<float*>(lse_parts), H, Hkv, page_size,
               max_pages, splits, kv_off, stride_kv, hi, scale * kLog2e};
  if (dtype == 0) return (int)dispatch_pool<false>(pool_type, D, a, B, s);
  if (dtype == 1) return (int)dispatch_pool<true>(pool_type, D, a, B, s);
  return (int)cudaErrorInvalidValue;
}

// The combine alone: o_parts [B, S, H, D] and lse_parts [B, S, H] fp32 ->
// o [B, H, D] (dtype: 0 = float32, 1 = bfloat16; D 32, 64, 128, 256 or 288)
// and lse [B, H] fp32.
extern "C" int paged_decode_combine(const void* o_parts, const void* lse_parts, void* o, void* lse,
                                    int B, int S, int H, int D, int dtype, void* stream) {
  if (S < 1 || (dtype != 0 && dtype != 1) || D % 32 != 0 || (D > 256 && D != WIDE_D))
    return (int)cudaErrorInvalidValue;
  const Args none{};
  return (int)launch_combine(static_cast<const float*>(o_parts),
                             static_cast<const float*>(lse_parts), o, static_cast<float*>(lse), B,
                             S, H, D, dtype, none, 0, static_cast<cudaStream_t>(stream));
}
