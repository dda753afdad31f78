// Entry point of the decode kernel over the int8 KV cache: the split-K
// decode of B7 (flash_attention_pallas,
// src/repro/kernels/flash_attention/flash_attention.py) reading int8 K/V
// rows and their bfloat16 scales, dequantized in registers; the design is
// in flash_decode.cuh.
#include "flash_decode.cuh"

extern "C" {

// flash_decode_fwd (flash_decode.cu) over an int8 cache: k and v int8 (rows
// 16-byte aligned), sk and sv their bfloat16 scales [B, Hkv, Sk] by batch,
// head and row strides in elements; q and o float32 or, with q_is_bf16,
// bfloat16.  d_head 64, 128 or 256.
int flash_decode_int8_fwd(const void* q, const void* k, const void* v, void* o,
                          long long qsb, long long qsh, long long qss,
                          long long ksb, long long ksh, long long kss,
                          long long vsb, long long vsh, long long vss,
                          long long osb, long long osh, long long oss,
                          const void* sk, const void* sv,
                          long long sksb, long long sksh, long long skss,
                          long long svsb, long long svsh, long long svss,
                          int B, int Hq, int Hkv, int Sq, int D, int q_is_bf16, float scale,
                          int causal, int window, int q_offset, int k_lo, int k_hi, int chunk,
                          int splits, void* scratch, void* stream) {
  Params p{q, k, v, o, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  if (!make_params(p, B, Hq, Hkv, Sq, D, scale, splits, scratch)) return cudaErrorInvalidValue;
  p.k_lo = k_lo; p.k_hi = k_hi; p.chunk = chunk;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.sk = sk; p.sv = sv;
  p.sksb = sksb; p.sksh = sksh; p.skss = skss;
  p.svsb = svsb; p.svsh = svsh; p.svss = svss;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q_is_bf16 ? by_width<__nv_bfloat16, int8_t>(p, B, D, st)
                   : by_width<float, int8_t>(p, B, D, st);
}

}  // extern "C"
