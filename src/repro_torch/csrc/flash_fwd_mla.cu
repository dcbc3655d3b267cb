// Flash-attention forward's tile body (flash_fwd_tc.cuh) at minicpm3-4b's
// MLA head dims, bf16 and fp32 inputs, behind a plain C interface for
// ctypes: 96 (prefill over the expanded heads, V padded to the qk width) and
// 288 (chunks, verifies and dense-cache decode ticks over the absorbed
// latent: 40 query heads on one kv head).  A library of its own, so that its
// nvcc runs beside flash_fwd_tc.cu's; the decode body takes neither dim.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd, at
// those head dims.

#include "flash_fwd_tc.cuh"

namespace {

template <int T>
cudaError_t dispatch_tile(int D, const Args& a) {
  switch (D) {
    case 96: return launch_tile<96, T>(a);
    case 288: return launch_tile<288, T>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// As flash_fwd_tc.cu's flash_fwd_tile, at D 96 or 288.
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
