// Flash-attention forward on Hopper's tensor cores (sm_90a): the tile body
// at head dims 32, 64, 128 and 256, the decode body with its split combine,
// and the fp32 pre-pass, behind a plain C interface for ctypes.  The kernels
// and their design are in flash_fwd_tc.cuh.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd.

#include "flash_fwd_tc.cuh"

namespace {

template <int T>
cudaError_t dispatch_tile(int D, const Args& a) {
  switch (D) {
    case 32: return launch_tile<32, T>(a);
    case 64: return launch_tile<64, T>(a);
    case 128: return launch_tile<128, T>(a);
    case 256: return launch_tile<256, T>(a);
    default: return cudaErrorInvalidValue;
  }
}

// at most 32 packed rows, 16 at D = 256 (the wrapper's plan sends more to
// the tile body, and MLA's head dims to flash_fwd_mla.cu's)
template <int D, int T>
cudaError_t decode_rows(const Args& a) {
  const int R = a.Sq * (a.H / a.Hkv);
  if (R <= 16) return launch_decode<D, 1, T>(a);
  if constexpr (D <= 128)
    if (R <= 32) return launch_decode<D, 2, T>(a);
  return cudaErrorInvalidValue;
}

template <int T>
cudaError_t dispatch_decode(int D, const Args& a) {
  switch (D) {
    case 32: return decode_rows<32, T>(a);
    case 64: return decode_rows<64, T>(a);
    case 128: return decode_rows<128, T>(a);
    case 256: return decode_rows<256, T>(a);
    default: return cudaErrorInvalidValue;
  }
}

// ===========================================================================
// the fp32 pre-pass: q, k, v as two bf16 terms each
// ===========================================================================

__global__ void __launch_bounds__(256) flash_fwd_split_kernel(SplitArgs a) {
  split_terms_body(a);
}

}  // namespace

// Both bodies take q [terms, B, Sq, H, D], k and v [terms, B, Skv, Hkv, D]
// as bf16 (the inputs themselves for terms = 1, bf16 inputs; flash_fwd_split's
// terms for terms = 2, fp32 inputs), the int32 band ([4] with band_stride
// 0, or [B, 4] with 4), optional int32 segment ids (seg_q [Sq], seg_kv [Skv],
// or both null), and write o [B, Sq, H, D] (bf16 for terms = 1, fp32 for
// terms = 2) and lse [B, H, Sq] (fp32).  They return cudaGetLastError()
// after the launches.

extern "C" int flash_fwd_tile(const void* q, const void* k, const void* v, const void* band,
                              int band_stride, const void* seg_q, const void* seg_kv, void* o,
                              void* lse, int B, int Sq, int Skv, int H, int Hkv, int D,
                              float scale, int stride_q, int stride_kv, int terms, void* stream) {
  const Args a{q, k, v, band, band_stride, seg_q, seg_kv, o, lse, nullptr, nullptr, 1, B, Sq,
               Skv, H, Hkv, scale * kLog2e, stride_q, stride_kv,
               static_cast<cudaStream_t>(stream)};
  if (terms == 1) return (int)dispatch_tile<1>(D, a);
  if (terms == 2) return (int)dispatch_tile<2>(D, a);
  return (int)cudaErrorInvalidValue;
}

// Sq * (H / Hkv) <= 32 (16 at D = 256).  With splits > 1, o_parts (fp32 [splits, B, Sq, H,
// D]) and lse_parts (fp32 [splits, B, H, Sq]) are the partials' scratch.
extern "C" int flash_fwd_decode(const void* q, const void* k, const void* v, const void* band,
                                int band_stride, const void* seg_q, const void* seg_kv, void* o,
                                void* lse, void* o_parts, void* lse_parts, int splits, int B,
                                int Sq, int Skv, int H, int Hkv, int D, float scale, int stride_q,
                                int stride_kv, int terms, void* stream) {
  if (splits < 1 || (splits > 1 && (o_parts == nullptr || lse_parts == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, band, band_stride, seg_q, seg_kv, o, lse, o_parts, lse_parts, splits, B,
               Sq, Skv, H, Hkv, scale * kLog2e, stride_q, stride_kv,
               static_cast<cudaStream_t>(stream)};
  if (terms == 1) return (int)dispatch_decode<1>(D, a);
  if (terms == 2) return (int)dispatch_decode<2>(D, a);
  return (int)cudaErrorInvalidValue;
}

// The fp32 bodies' pre-pass (sm90.cuh's split_terms_body): count <= 4 fp32
// arrays src[i] of n[i] values (q, k, v) into [2, n[i]] bf16 terms (hi, then
// lo) at dst[i].
extern "C" int flash_fwd_split(const void* const* src, void* const* dst, const long long* n,
                               int count, void* stream) {
  return (int)launch_split(flash_fwd_split_kernel, src, dst, n, count,
                           static_cast<cudaStream_t>(stream));
}
