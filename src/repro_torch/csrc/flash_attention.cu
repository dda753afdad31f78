// Hopper kernel of GQA attention on the CUDA cores: causal mask, sliding
// window, q_offset.
//
// Replaces flash_attention_pallas (B7) of the reference package
// (src/repro/kernels/flash_attention/flash_attention.py) on the calls that
// ops.attention_route sends here: more than 16 query rows per kv head in
// float32 (the LM's float32 check), or in bfloat16 at d_head 16 or 32 (the
// widths the tensor-core kernel, flash_attention_sm90.cu, does not take).
// Decode goes to flash_decode.cu.
//
// What it computes: for query head h of batch b, row i at absolute position
// pos = q_offset + i, the softmax over the keys j of kv head h / (Hq / Hkv)
// that it sees (j < Sk; j <= pos if causal; j > pos - window if windowed) of
// (scale * q . k_j), applied to v.  Inputs are float32 or bfloat16; scores,
// the running max m, the running sum l and the accumulator are float32; the
// output is acc / max(l, 1e-30) in the input type.  A row that sees no key
// gives 0.
//
// What bounds it on an H100: operations (4 * D flops per visible query-key
// pair).  In float32 there is no tensor-core route that keeps the LM's
// float32 check within its bound (TF32 keeps about three digits), so the
// products run on the CUDA cores, whose float32 rate (67 TFLOP/s) is the
// ceiling.
//
// Design, kept simple on purpose:
//   * One block of 16 x 16 threads per (q tile of 64 rows, q head, batch).
//     The Pallas kernel stages the whole K/V sequence in VMEM; here K and V
//     pass through shared memory 64 rows at a time (a loop inside the block
//     takes the place of the TPU's sequential walk), in the input type, with
//     the q tile kept in shared memory as float32 pre-multiplied by scale,
//     as Pallas does.  At D = 256 the q tile, a K and a V tile and the
//     64 x 64 P tile take 217 KB in float32: dynamic shared memory, above
//     the 48 KB static limit, with cudaFuncSetAttribute.
//   * S = q k^T: thread (ty, tx) owns query rows ty + 16 i and key columns
//     tx + 16 j; K rows are padded by 16 bytes so the 16-byte reads of 16
//     neighbouring rows fall on distinct banks.  The row max and row sum
//     are shuffles across the 16 tx lanes of a half warp, which all keep the
//     same (m, l) of their rows.
//   * The masked p is set to 0 after the exponential (the Pallas kernel's
//     where): while m is still -1e30 exp(s - m) of a masked entry is 1.
//   * O += P V: P goes through shared memory; each thread owns the same
//     query rows and D / 16 output columns, interleaved in 8-wide chunks
//     so each 16-byte read of a V row is conflict-free.
//   * Key tiles that the causal bound or the window mask for every row of
//     the block are skipped: the same function with less work (a fully
//     masked tile leaves (m, l, acc) exactly as they were).  Rows past Sq or
//     Sk are bound-checked; nothing is padded by copying.
//   * Query tiles run latest first, so the heaviest causal tiles start
//     early.  Strides are arguments (the last axis is contiguous), so q, k,
//     v may be views of [B, S, H, D] projections or of a [L, B, H, S, D]
//     cache.  Launches on the given stream, allocates nothing, does not
//     synchronise, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // key rows per tile
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q; const void* k; const void* v; void* o;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int B, Hq, Hkv, Sq, Sk;
  float scale;
  int causal, window, q_offset;  // window <= 0: none
};

// ------------------------------------------------------- 8-element moves
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
template <typename T>
__device__ __forceinline__ void copy8(const T* src, T* dst) {  // 16 or 32 bytes
#pragma unroll
  for (int i = 0; i < (int)(8 * sizeof(T) / 16); ++i)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}
template <typename T>
__device__ __forceinline__ void zero8(T* dst) {
#pragma unroll
  for (int i = 0; i < (int)(8 * sizeof(T) / 16); ++i)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DC>
__device__ __forceinline__ int out_col(int tx, int c) {
  // 8-wide chunks interleaved over the 16 tx lanes when a thread has whole
  // chunks (D >= 128); contiguous otherwise
  if constexpr (DC % 8 == 0) return ((c / 8) * kTX + tx) * 8 + (c % 8);
  else return tx * DC + c;
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * kBQ * (D + 4) + 2 * sizeof(T) * kBK * (D + 16 / sizeof(T)) +
         sizeof(float) * kBQ * (kBK + 4);
}

// ------------------------------------------------------------- the kernel
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
  constexpr int RQ = kBQ / kTY;              // query rows per thread
  constexpr int KC = kBK / kTX;              // key columns per thread in S
  constexpr int DC = D / kTX;                // output columns per thread
  constexpr int CH = D / 8;                  // 8-element chunks per row
  constexpr int QS = D + 4;                  // row strides in shared memory
  constexpr int KS = D + 16 / (int)sizeof(T);
  constexpr int PS = kBK + 4;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  T* sK = reinterpret_cast<T*>(sQ + kBQ * QS);
  T* sV = sK + kBK * KS;
  float* sP = reinterpret_cast<float*>(sV + kBK * KS);

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTX + tx;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.Hq / p.Hkv);
  const int nq = min(kBQ, p.Sq - q0);
  const T* Q = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* K = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* V = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;
  T* O = static_cast<T*>(p.o) + b * p.osb + h * p.osh;

  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    float f[8];
    if (r < nq) {
      load8(Q + (q0 + r) * p.qss + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sQ[r * QS + c + e] = f[e] * p.scale;
  }

  // the keys some row of this tile may see: [k_begin, k_end)
  const int pos_lo = p.q_offset + q0;
  const int pos_hi = p.q_offset + q0 + nq - 1;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, pos_hi + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, pos_lo - p.window + 1);
  k_begin = (k_begin / kBK) * kBK;

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // sQ written / the previous tile's sK, sV, sP read
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      if (k0 + r < p.Sk) {
        copy8(K + (long long)(k0 + r) * p.kss + c, sK + r * KS + c);
        copy8(V + (long long)(k0 + r) * p.vss + c, sV + r * KS + c);
      } else {
        zero8(sK + r * KS + c);
        zero8(sV + r * KS + c);
      }
    }
    __syncthreads();

    // ---- S = (scale q) k^T for rows ty + 16 i, keys tx + 16 j
    float s[RQ][KC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 8) {
      float kf[KC][8];
#pragma unroll
      for (int j = 0; j < KC; ++j) load8(sK + (tx + kTX * j) * KS + d, kf[j]);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        float qf[8];
        load8(sQ + (ty + kTY * i) * QS + d, qf);
#pragma unroll
        for (int j = 0; j < KC; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[i][j] = fmaf(qf[e], kf[j][e], s[i][j]);
      }
    }

    // ---- online softmax: mask, new max, p = exp(s - m) zeroed where masked
    float alpha[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int pos = pos_lo + ty + kTY * i;
      bool ok[KC];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int kp = k0 + tx + kTX * j;
        ok[j] = kp < p.Sk && (!p.causal || kp <= pos) && (p.window <= 0 || kp > pos - p.window);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        sP[(ty + kTY * i) * PS + tx + kTX * j] = pj;
        rs += pj;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = m_new;
    }
    __syncthreads();

    // ---- acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vf[DC];
      if constexpr (DC % 8 == 0) {
#pragma unroll
        for (int c = 0; c < DC; c += 8) load8(sV + kk * KS + out_col<DC>(tx, c), vf + c);
      } else {
#pragma unroll
        for (int c = 0; c < DC; ++c) vf[c] = to_f(sV[kk * KS + out_col<DC>(tx, c)]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float pv = sP[(ty + kTY * i) * PS + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv, vf[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + kTY * i;
    if (r >= nq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = O + (long long)(q0 + r) * p.oss;
    if constexpr (DC % 8 == 0) {
#pragma unroll
      for (int c = 0; c < DC; c += 8) {
        float v8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v8[e] = acc[i][c + e] / den;
        store8(orow + out_col<DC>(tx, c), v8);
      }
    } else {
#pragma unroll
      for (int c = 0; c < DC; ++c) put(orow + out_col<DC>(tx, c), acc[i][c] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, p.B), block(kTX, kTY);
  flash_fwd<T, D><<<grid, block, smem, stream>>>(p);
  return cudaGetLastError();
}

// float32 at every width; bfloat16 only at 16 and 32 (wider bf16 goes to
// the tensor-core kernel)
template <typename T>
cudaError_t by_width(const Params& p, int D, cudaStream_t stream) {
  constexpr bool all = sizeof(T) == 4;
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: if constexpr (all) return launch<T, 64>(p, stream); break;
    case 128: if constexpr (all) return launch<T, 128>(p, stream); break;
    case 256: if constexpr (all) return launch<T, 256>(p, stream); break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B, Hq, Sq, D], k and v [B, Hkv, Sk, D], o [B, Hq, Sq, D], each given by
// its base pointer and its batch, head and row strides in elements (the last
// axis contiguous, rows 16-byte aligned).  is_bf16 selects bfloat16 (D 16 or
// 32) over float32 (D 16 to 256) for all four.  window <= 0 means no window.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        long long qsb, long long qsh, long long qss,
                        long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss,
                        long long osb, long long osh, long long oss,
                        int B, int Hq, int Hkv, int Sq, int Sk, int D, int is_bf16,
                        float scale, int causal, int window, int q_offset, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const Params p{q, k, v, o, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                 B, Hq, Hkv, Sq, Sk, scale, causal, window, q_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? by_width<__nv_bfloat16>(p, D, st) : by_width<float>(p, D, st);
}

}  // extern "C"
