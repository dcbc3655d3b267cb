// Paged split-K flash-decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/paged_decode.py::paged_flash_decode
//   (Pallas body _decode_kernel with its clamped kv_index_map), both pool
//   kinds: an fp pool (q's type), and the quantized branch
//   (src/repro/kernels/paged_decode.py:161-167, scale BlockSpecs :273-277)
//   whose int8 / fp8-e4m3 pages carry fp32 per-(token, kv-head) scales.
//
// What it computes: one decode token per slot row b straight off the page
// pool.  Query q [B, H, D] (the token's heads), pool [num_pages, page_size,
// Hkv, D], block table bt [B, max_pages] (-1 = unallocated), per-row
// position pos [B].  Local slot j of a row lives at offset j % page_size of
// logical page j / page_size and holds global position kv_off + stride_kv*j;
// it is visible iff max(pos - hi, 0) <= position <= pos.  The logical pages
// are split into num_splits runs of pages_per_split pages; each (row, split,
// kv head) writes an fp32 partial (o, lse) that the caller merges with an
// LSE combine (kernels/paged_decode.py::combine_split_partials).  A
// quantized pool adds k_scale / v_scale [num_pages, page_size, Hkv] fp32:
// element (page, t, h, d) stands for code * scale[page, t, h].
//
// What bounds it on an H100: bytes.  Each visible K/V element is read once
// and used for 2 flops per query head of its GQA group (8 flops per byte of
// bf16 for granite's group of 4, 16 per byte of int8/fp8 codes), far below
// the card's ~295 flop/byte balance point, so the floor is the visible
// pages' bytes over 3.35 TB/s.  A quantized page moves 1-byte codes plus one
// fp32 scale per (token, head) for K and for V: at D=128 that is
// (2*128 + 8) / (2*128*2) = 0.516x the bytes of a bf16 page.
//
// Design:
//   * one block per (split, kv head, slot row), the GQA group's query rows
//     together in the block, so each K/V page is read from memory once for
//     the whole group;
//   * the block reads its own bt row and pos and turns the TPU kernel's
//     clamped index map into a loop bound: it walks only the logical pages in
//     [lp_lo, lp_hi] inside its split and skips bt == -1, so unallocated,
//     too-deep and out-of-window pages cost nothing -- reads follow depth,
//     not capacity.  Scale reads go through the same physical page and
//     offset as the codes, so a -1 entry is never dereferenced for either;
//   * a page is staged in shared memory (fp32) 32 tokens at a time; warp w
//     scores group rows w, w+4, ... with one token per lane, reduces the row
//     max/sum by warp shuffles, and accumulates o over dims lane + 32*c;
//   * quantized pages are loaded 16 codes (16 bytes) per thread and
//     converted to fp32 in shared memory (int8 by a cast, fp8 by
//     __nv_fp8_e4m3's float conversion); the scales are not applied per
//     element but folded in: s = (q . code) * k_scale * softmax_scale, and
//     o += p * v_scale * code, which matches dequantize-then-attend within
//     fp32 rounding;
//   * the partial last page is masked by global position, exactly the band
//     predicate of the dense path; an empty split writes o = 0, lse = NEG_INF.
//
// Not done yet (later work): cp.async/TMA staging and fp8 wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int NT = 128;        // 4 warps
constexpr int NW = NT / 32;
constexpr int TT = 32;         // tokens staged per shared-memory tile
constexpr int MAX_GROUP = 16;  // query heads per kv head
constexpr int GW = MAX_GROUP / NW;  // group rows per warp
constexpr int QB = 16;         // codes per 16-byte load of a quantized page

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float code_to_f(int8_t, uint8_t b) {
  return static_cast<float>(static_cast<int8_t>(b));
}
__device__ __forceinline__ float code_to_f(__nv_fp8_e4m3, uint8_t b) {
  __nv_fp8_e4m3 x;
  x.__x = static_cast<__nv_fp8_storage_t>(b);
  return static_cast<float>(x);
}

template <typename P>
constexpr bool kQuantPool =
    std::is_same<P, int8_t>::value || std::is_same<P, __nv_fp8_e4m3>::value;

__host__ __device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}
__host__ __device__ __forceinline__ long long ceil_div(long long a, long long b) {
  return -floor_div(-a, b);
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // quantized pools only
  const float* v_scale;
  const int* bt;
  const int* pos;
  float* o_parts;
  float* lse_parts;
  int H, Hkv, page_size, max_pages, num_splits, pages_per_split;
  int kv_off, stride_kv, hi;
  float scale;
};

template <int D>
constexpr int smem_floats() {
  // Qs [MAX_GROUP][D] + Ks [TT][D+1] + Vs [TT][D] + the tile's K and V scales
  return MAX_GROUP * D + TT * (D + 1) + TT * D + 2 * TT;
}

// T: q's type (fp32 / bf16); P: the pool's element type (T, int8_t or
// __nv_fp8_e4m3)
template <typename T, typename P, int D>
__global__ void __launch_bounds__(NT) paged_decode_kernel(const Args a) {
  constexpr bool QUANT = kQuantPool<P>;
  constexpr int KS = D + 1;
  constexpr int DC = D / 32;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + MAX_GROUP * D;
  float* Vs = Ks + TT * KS;
  float* Ksc = Vs + TT * D;
  float* Vsc = Ksc + TT;

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const P* __restrict__ k_pool = static_cast<const P*>(a.k_pool);
  const P* __restrict__ v_pool = static_cast<const P*>(a.v_pool);
  const int H = a.H, Hkv = a.Hkv, page_size = a.page_size;
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int idx = tid; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    Qs[g * D + d] = to_f(q[((size_t)b * H + hk * G + g) * D + d]);
  }

  const long long pos_b = a.pos[b];
  long long win_lo = pos_b - a.hi;
  if (win_lo < 0) win_lo = 0;
  const long long span = (long long)a.stride_kv * page_size;
  long long lp_hi = floor_div(pos_b - a.kv_off, span);  // last page starting <= pos
  long long j_lo = ceil_div(win_lo - a.kv_off, a.stride_kv);
  if (j_lo < 0) j_lo = 0;
  long long lp_lo = j_lo / page_size;  // first page ending inside the window
  const long long s_lo = (long long)split * a.pages_per_split;
  const long long s_hi = s_lo + a.pages_per_split - 1;
  if (lp_lo < s_lo) lp_lo = s_lo;
  if (lp_hi > s_hi) lp_hi = s_hi;
  if (lp_hi > a.max_pages - 1) lp_hi = a.max_pages - 1;

  float m[GW], l[GW], acc[GW][DC];
#pragma unroll
  for (int gi = 0; gi < GW; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[gi][c] = 0.f;
  }

  const int* bt_row = a.bt + (size_t)b * a.max_pages;
  for (long long lp = lp_lo; lp <= lp_hi; ++lp) {
    const int phys = bt_row[lp];
    if (phys < 0) continue;  // unallocated: uniform over the block
    for (int t0 = 0; t0 < page_size; t0 += TT) {
      const int nt = min(TT, page_size - t0);
      __syncthreads();  // previous tile consumed (and Qs written)
      if constexpr (QUANT) {
        // 16 codes (16 bytes) per thread and load; a token's head row is D
        // contiguous bytes at a 16-byte aligned offset (D % 16 == 0)
        constexpr int CH = D / QB;
        const uint8_t* kb = reinterpret_cast<const uint8_t*>(k_pool);
        const uint8_t* vb = reinterpret_cast<const uint8_t*>(v_pool);
        for (int idx = tid; idx < nt * CH; idx += NT) {
          const int t = idx / CH, c = idx % CH;
          const size_t off = (((size_t)phys * page_size + t0 + t) * Hkv + hk) * D + c * QB;
          const uint4 kc = *reinterpret_cast<const uint4*>(kb + off);
          const uint4 vc = *reinterpret_cast<const uint4*>(vb + off);
          // bytes by shifts of the four words (constant indices once
          // unrolled, so the words stay in registers)
          const uint32_t kw[4] = {kc.x, kc.y, kc.z, kc.w};
          const uint32_t vw[4] = {vc.x, vc.y, vc.z, vc.w};
#pragma unroll
          for (int e = 0; e < QB; ++e) {
            const int sh = 8 * (e & 3);
            Ks[t * KS + c * QB + e] = code_to_f(P(), (kw[e >> 2] >> sh) & 0xffu);
            Vs[t * D + c * QB + e] = code_to_f(P(), (vw[e >> 2] >> sh) & 0xffu);
          }
        }
        // the scales of the same tokens: same physical page, same offsets
        for (int t = tid; t < nt; t += NT) {
          const size_t srow = ((size_t)phys * page_size + t0 + t) * Hkv + hk;
          Ksc[t] = a.k_scale[srow];
          Vsc[t] = a.v_scale[srow];
        }
      } else {
        for (int idx = tid; idx < nt * D; idx += NT) {
          const int t = idx / D, d = idx % D;
          const size_t off = (((size_t)phys * page_size + t0 + t) * Hkv + hk) * D + d;
          Ks[t * KS + d] = to_f(k_pool[off]);
          Vs[t * D + d] = to_f(v_pool[off]);
        }
      }
      __syncthreads();
      const long long gpos =
          a.kv_off + (long long)a.stride_kv * (lp * page_size + t0 + lane);
      const bool vis = lane < nt && gpos <= pos_b && gpos >= win_lo;
      float s_mul = a.scale;
      if constexpr (QUANT) s_mul *= (lane < nt ? Ksc[lane] : 0.f);
#pragma unroll
      for (int gi = 0; gi < GW; ++gi) {
        const int g = warp + NW * gi;
        if (g >= G) break;  // uniform over the warp
        float s = 0.f;
        if (lane < nt) {
          const float* kr = &Ks[lane * KS];
          const float* qr = &Qs[g * D];
#pragma unroll 8
          for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
          s *= s_mul;
        }
        float mloc = vis ? s : kNegInf;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
        const float m_new = fmaxf(m[gi], mloc);
        const float alpha = expf(m[gi] - m_new);
        const float p = vis ? expf(s - m_new) : 0.f;
        float psum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l[gi] = l[gi] * alpha + psum;
        m[gi] = m_new;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[gi][c] *= alpha;
        for (int t = 0; t < nt; ++t) {
          float pt = __shfl_sync(0xffffffffu, p, t);
          if constexpr (QUANT) pt *= Vsc[t];
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[gi][c] += pt * Vs[t * D + lane + 32 * c];
        }
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < GW; ++gi) {
    const int g = warp + NW * gi;
    if (g >= G) break;
    const int h = hk * G + g;
    const size_t row = ((size_t)b * a.num_splits + split) * H + h;
    const bool nonempty = l[gi] > 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      a.o_parts[row * D + lane + 32 * c] = nonempty ? acc[gi][c] / l[gi] : 0.f;
    if (lane == 0) a.lse_parts[row] = nonempty ? m[gi] + logf(l[gi]) : kNegInf;
  }
}

template <typename T, typename P, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kern = paged_decode_kernel<T, P, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.num_splits, a.Hkv, B);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_d(int D, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, P, 32>(a, B, stream);
    case 64: return launch<T, P, 64>(a, B, stream);
    case 128: return launch<T, P, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_pool(int pool_type, int D, const Args& a, int B, cudaStream_t stream) {
  switch (pool_type) {
    case 0: return dispatch_d<T, T>(D, a, B, stream);
    case 1: return dispatch_d<T, int8_t>(D, a, B, stream);
    case 2: return dispatch_d<T, __nv_fp8_e4m3>(D, a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (q's type and an fp pool's): 0 = float32, 1 = bfloat16.
// pool_type: 0 = fp (q's type, k_scale/v_scale null), 1 = int8, 2 = fp8-e4m3
// (k_scale/v_scale [num_pages, page_size, Hkv] fp32, required).
// Returns cudaGetLastError() after the launch.
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* k_scale, const void* v_scale, const void* bt,
                            const void* pos, void* o_parts, void* lse_parts, int B, int H,
                            int Hkv, int D, int page_size, int max_pages, int num_splits,
                            int pages_per_split, int kv_off, int stride_kv, int hi,
                            float scale, int dtype, int pool_type, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hkv != 0 || H / Hkv > MAX_GROUP) return (int)cudaErrorInvalidValue;
  if ((pool_type != 0) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  if (pool_type != 0 && D % QB != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int*>(bt),
               static_cast<const int*>(pos), static_cast<float*>(o_parts),
               static_cast<float*>(lse_parts), H, Hkv, page_size, max_pages, num_splits,
               pages_per_split, kv_off, stride_kv, hi, scale};
  if (dtype == 0) return (int)dispatch_pool<float>(pool_type, D, a, B, s);
  if (dtype == 1) return (int)dispatch_pool<__nv_bfloat16>(pool_type, D, a, B, s);
  return (int)cudaErrorInvalidValue;
}
