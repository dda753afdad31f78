// Entry point of the decode kernel over a float32 or bfloat16 cache: the
// split-K decode of B7 (flash_attention_pallas,
// src/repro/kernels/flash_attention/flash_attention.py); the design, what
// bounds it and how it is laid out are in flash_decode.cuh.
#include "flash_decode.cuh"

extern "C" {

// q [B, Hq, Sq, D], k and v [B, Hkv, Sk, D], o [B, Hq, Sq, D] (float32 or,
// with is_bf16, bfloat16), each by base pointer and batch, head and row
// strides in elements (last axis contiguous, rows 16-byte aligned); at most
// 16 query rows per kv head.  Split s walks keys [k_lo + s chunk,
// min(k_lo + (s + 1) chunk, k_hi)).  scratch holds B * Hkv * splits * R *
// (D + 2) floats.  window <= 0 means no window.
int flash_decode_fwd(const void* q, const void* k, const void* v, void* o,
                     long long qsb, long long qsh, long long qss,
                     long long ksb, long long ksh, long long kss,
                     long long vsb, long long vsh, long long vss,
                     long long osb, long long osh, long long oss,
                     int B, int Hq, int Hkv, int Sq, int D, int is_bf16, float scale,
                     int causal, int window, int q_offset, int k_lo, int k_hi, int chunk,
                     int splits, void* scratch, void* stream) {
  Params p{q, k, v, o, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  if (!make_params(p, B, Hq, Hkv, Sq, D, scale, splits, scratch)) return cudaErrorInvalidValue;
  p.k_lo = k_lo; p.k_hi = k_hi; p.chunk = chunk;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? by_width<__nv_bfloat16, __nv_bfloat16>(p, B, D, st)
                 : by_width<float, float>(p, B, D, st);
}

}  // extern "C"
