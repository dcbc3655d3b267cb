// Paged split-K flash-decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/paged_decode.py::paged_flash_decode
//   (Pallas body _decode_kernel with its clamped kv_index_map), fp page pool.
//   The int8/fp8 dequant branch of that kernel is not ported yet.
//
// What it computes: one decode token per slot row b straight off the page
// pool.  Query q [B, H, D] (the token's heads), pool [num_pages, page_size,
// Hkv, D], block table bt [B, max_pages] (-1 = unallocated), per-row
// position pos [B].  Local slot j of a row lives at offset j % page_size of
// logical page j / page_size and holds global position kv_off + stride_kv*j;
// it is visible iff max(pos - hi, 0) <= position <= pos.  The logical pages
// are split into num_splits runs of pages_per_split pages; each (row, split,
// kv head) writes an fp32 partial (o, lse) that the caller merges with an
// LSE combine (kernels/paged_decode.py::combine_split_partials).
//
// What bounds it on an H100: bytes.  Each visible K/V element is read once
// and used for 2 flops per query head of its GQA group (8 flops per byte of
// bf16 for granite's group of 4), far below the card's ~295 flop/byte
// balance point, so the floor is the visible pages' bytes over 3.35 TB/s.
//
// Design:
//   * one block per (split, kv head, slot row), the GQA group's query rows
//     together in the block, so each K/V page is read from memory once for
//     the whole group;
//   * the block reads its own bt row and pos and turns the TPU kernel's
//     clamped index map into a loop bound: it walks only the logical pages in
//     [lp_lo, lp_hi] inside its split and skips bt == -1, so unallocated,
//     too-deep and out-of-window pages cost nothing -- reads follow depth,
//     not capacity;
//   * a page is staged in shared memory (fp32) 32 tokens at a time; warp w
//     scores group rows w, w+4, ... with one token per lane, reduces the row
//     max/sum by warp shuffles, and accumulates o over dims lane + 32*c;
//   * the partial last page is masked by global position, exactly the band
//     predicate of the dense path; an empty split writes o = 0, lse = NEG_INF.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int NT = 128;        // 4 warps
constexpr int NW = NT / 32;
constexpr int TT = 32;         // tokens staged per shared-memory tile
constexpr int MAX_GROUP = 16;  // query heads per kv head
constexpr int GW = MAX_GROUP / NW;  // group rows per warp

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}
__host__ __device__ __forceinline__ long long ceil_div(long long a, long long b) {
  return -floor_div(-a, b);
}

template <int D>
constexpr int smem_floats() {
  // Qs [MAX_GROUP][D] + Ks [TT][D+1] + Vs [TT][D]
  return MAX_GROUP * D + TT * (D + 1) + TT * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ bt, const int* __restrict__ pos,
    float* __restrict__ o_parts, float* __restrict__ lse_parts,
    int H, int Hkv, int page_size, int max_pages, int num_splits, int pages_per_split,
    int kv_off, int stride_kv, int hi, float scale) {
  constexpr int KS = D + 1;
  constexpr int DC = D / 32;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + MAX_GROUP * D;
  float* Vs = Ks + TT * KS;

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int idx = tid; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    Qs[g * D + d] = to_f(q[((size_t)b * H + hk * G + g) * D + d]);
  }

  const long long pos_b = pos[b];
  long long win_lo = pos_b - hi;
  if (win_lo < 0) win_lo = 0;
  const long long span = (long long)stride_kv * page_size;
  long long lp_hi = floor_div(pos_b - kv_off, span);  // last page starting <= pos
  long long j_lo = ceil_div(win_lo - kv_off, stride_kv);
  if (j_lo < 0) j_lo = 0;
  long long lp_lo = j_lo / page_size;  // first page ending inside the window
  const long long s_lo = (long long)split * pages_per_split;
  const long long s_hi = s_lo + pages_per_split - 1;
  if (lp_lo < s_lo) lp_lo = s_lo;
  if (lp_hi > s_hi) lp_hi = s_hi;
  if (lp_hi > max_pages - 1) lp_hi = max_pages - 1;

  float m[GW], l[GW], acc[GW][DC];
#pragma unroll
  for (int gi = 0; gi < GW; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[gi][c] = 0.f;
  }

  const int* bt_row = bt + (size_t)b * max_pages;
  for (long long lp = lp_lo; lp <= lp_hi; ++lp) {
    const int phys = bt_row[lp];
    if (phys < 0) continue;  // unallocated: uniform over the block
    for (int t0 = 0; t0 < page_size; t0 += TT) {
      const int nt = min(TT, page_size - t0);
      __syncthreads();  // previous tile consumed (and Qs written)
      for (int idx = tid; idx < nt * D; idx += NT) {
        const int t = idx / D, d = idx % D;
        const size_t off = (((size_t)phys * page_size + t0 + t) * Hkv + hk) * D + d;
        Ks[t * KS + d] = to_f(k_pool[off]);
        Vs[t * D + d] = to_f(v_pool[off]);
      }
      __syncthreads();
      const long long gpos =
          kv_off + (long long)stride_kv * (lp * page_size + t0 + lane);
      const bool vis = lane < nt && gpos <= pos_b && gpos >= win_lo;
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
          s *= scale;
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
          const float pt = __shfl_sync(0xffffffffu, p, t);
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
    const size_t row = ((size_t)b * num_splits + split) * H + h;
    const bool nonempty = l[gi] > 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o_parts[row * D + lane + 32 * c] = nonempty ? acc[gi][c] / l[gi] : 0.f;
    if (lane == 0) lse_parts[row] = nonempty ? m[gi] + logf(l[gi]) : kNegInf;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* bt,
                   const void* pos, void* o_parts, void* lse_parts, int B, int H, int Hkv,
                   int page_size, int max_pages, int num_splits, int pages_per_split,
                   int kv_off, int stride_kv, int hi, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(num_splits, Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(bt), static_cast<const int*>(pos), static_cast<float*>(o_parts),
      static_cast<float*>(lse_parts), H, Hkv, page_size, max_pages, num_splits,
      pages_per_split, kv_off, stride_kv, hi, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k_pool, const void* v_pool,
                       const void* bt, const void* pos, void* o_parts, void* lse_parts, int B,
                       int H, int Hkv, int page_size, int max_pages, int num_splits,
                       int pages_per_split, int kv_off, int stride_kv, int hi, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, bt, pos, o_parts, lse_parts, B, H, Hkv,
                           page_size, max_pages, num_splits, pages_per_split, kv_off,
                           stride_kv, hi, scale, stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, bt, pos, o_parts, lse_parts, B, H, Hkv,
                           page_size, max_pages, num_splits, pages_per_split, kv_off,
                           stride_kv, hi, scale, stream);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, bt, pos, o_parts, lse_parts, B, H, Hkv,
                            page_size, max_pages, num_splits, pages_per_split, kv_off,
                            stride_kv, hi, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* bt, const void* pos, void* o_parts, void* lse_parts,
                            int B, int H, int Hkv, int D, int page_size, int max_pages,
                            int num_splits, int pages_per_split, int kv_off, int stride_kv,
                            int hi, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hkv != 0 || H / Hkv > MAX_GROUP) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k_pool, v_pool, bt, pos, o_parts, lse_parts, B, H,
                                  Hkv, page_size, max_pages, num_splits, pages_per_split,
                                  kv_off, stride_kv, hi, scale, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k_pool, v_pool, bt, pos, o_parts, lse_parts,
                                          B, H, Hkv, page_size, max_pages, num_splits,
                                          pages_per_split, kv_off, stride_kv, hi, scale, s);
  return (int)cudaErrorInvalidValue;
}
