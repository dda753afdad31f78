// Hopper kernel of GQA attention's decode: split-K over the cache, with all
// the q heads of a kv head in one block.  The kernels' templates; the
// entry points instantiate them: flash_decode.cu for float32 and bfloat16
// caches, flash_decode_int8.cu for the int8 cache (two sources, so that
// nvcc builds the two sets of instantiations at once).
//
// Replaces flash_attention_pallas (B7) of the reference package
// (src/repro/kernels/flash_attention/flash_attention.py) on the calls that
// ops.attention_route sends here: at most 16 query rows per kv head
// (Sq x group <= 16), float32 or bfloat16, d_head 16 to 256.  Every decode
// step of the LM comes here (one token, two q heads per kv head).
//
// The int8 KV cache (flash_decode_int8_fwd) takes the same kernels: q and
// the output stay float32 or bfloat16, K and V are int8 rows with one
// bfloat16 scale per (batch, kv head, row), and each element is dequantized
// in registers as float(int8) * float(scale), the reference's float32
// dequantization (src/repro/models/transformer.py, _attention), so only the
// summation order differs from the plain version.  The reference reaches no
// Pallas kernel there (masked float32 einsums); the port's decode takes B7's
// route for bf16 caches, and the int8 cache takes the same one.
//
// What it computes: as flash_attention.cu.  For query head h of batch b,
// row i at absolute position pos = q_offset + i, the softmax over the keys
// j of kv head h / (Hq / Hkv) it sees (j < Sk; j <= pos if causal; j > pos -
// window if windowed) of scale * q . k_j, applied to v; scores, (m, l) and
// the accumulator are float32, the output is acc / max(l, 1e-30) in the
// input type.  A row that sees no key gives 0.
//
// What bounds it on an H100: bytes.  One token reads every visible cached
// key and value row once (68 MB for gemma3-4b's global layer at 2,079 rows
// and batch 8) for about one flop a byte, far below the 295 at which the
// tensor cores would matter, so the products run on the CUDA cores in
// float32 and the design is about keeping HBM busy:
//   * The grid is (splits, Hkv, B).  The host cuts the rows any query row
//     may see, [k_lo, k_hi), into runs of ``chunk`` rows (ops.decode_splits:
//     four blocks an SM, runs of at least 64 rows), and each block walks its
//     run alone.
//   * One block holds all group x Sq query rows of its kv head (R <= 16), so
//     a cached row is read once, not once per q head.
//   * K and V stream through shared memory in tiles of up to 64 rows (8 KB
//     each, so six blocks fit an SM at d_head 256), double-buffered with
//     cp.async, 16 bytes a thread; rows past the run are zero-filled without
//     a read, so the cache past cache_len is never touched.  An int8 tile
//     holds twice the rows of a bf16 one in the same bytes; its rows'
//     scales (2-byte strided, no vector load) go to shared memory beside it
//     by plain loads, 0 past the run.  A thread still reads 8 columns of a
//     row from shared memory (8 bytes of int8), so the lane-to-column map of
//     Q K and of P V is the bf16 path's.
//   * Scores: a row of D is split over D / 8 threads, 8 columns each (q's in
//     registers), and their partial dots meet in shuffles; a thread's keys
//     of a tile are unrolled, so their shuffle chains interleave.  Softmax:
//     a warp a query row, in base 2 with the scale folded into q.  P V: each
//     thread keeps R x 8 float32 sums over its share of the keys; the shares
//     are added once, at the end, through shared memory.
//   * Each block writes its partial (m, l, acc[D]) in float32 to scratch the
//     wrapper allocates; a second kernel merges the splits of every
//     (batch, kv head, row): m* = max m_s, l* = sum l_s 2^(m_s - m*), out =
//     sum acc_s 2^(m_s - m*) / max(l*, 1e-30).  A split that sees no key
//     holds (-inf, 0, 0) and adds nothing.
//   * Launches on the given stream, allocates nothing, does not
//     synchronise, returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;

struct Params {
  const void* q; const void* k; const void* v; void* o;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int Hkv, group, Sq, R;          // R = group * Sq query rows a block
  int k_lo, k_hi, chunk, splits;  // split s walks [k_lo + s chunk, min(k_lo + (s+1) chunk, k_hi))
  float scale_log2;               // scale * log2(e)
  int causal, window, q_offset;   // window <= 0: none
  float* acc;                     // [B, Hkv, splits, R, D] partial sums
  float* ml;                      // [B, Hkv, splits, R, 2] partial (m, l)
  const void* sk; const void* sv; // int8 caches: bf16 scales [B, Hkv, Sk]
  long long sksb, sksh, skss, svsb, svsh, svss;
};

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
// 8 int8 values (8 bytes) of a row in shared memory, each exactly as a float
__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = static_cast<float>(static_cast<int>(u.x << (24 - 8 * i)) >> 24);
    o[4 + i] = static_cast<float>(static_cast<int>(u.y << (24 - 8 * i)) >> 24);
  }
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

// 16 bytes from global to shared memory; zero-filled, with nothing read,
// where ``ok`` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// TKV: the cache's element type (float, bf16, or int8 with scales)
template <typename TKV, int D, int RM>
struct Layout {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static constexpr int CT = D / 8;                       // threads across a row
  static constexpr int NG = kThreads / CT;               // key rows in flight
  static constexpr int TK0 = 8192 / (D * (int)sizeof(TKV));
  static constexpr int TK = TK0 < 64 ? TK0 : 64;         // key rows a tile (<= 8 KB)
  static constexpr int RPW = (RM + kWarps - 1) / kWarps; // query rows a warp owns
  static constexpr bool kQReg = RM <= 8;                 // q in registers, else shared
  static constexpr size_t kTiles = 4 * (size_t)TK * D * sizeof(TKV);   // K, V x 2 buffers
  static constexpr size_t kRed = (size_t)NG * RM * D * sizeof(float);
  static constexpr size_t kRegion = kTiles > kRed ? kTiles : kRed;
  static constexpr size_t kBytes =
      kRegion + sizeof(float) * ((kQReg ? 0 : RM * D) + RM * TK + RM + (kQuant ? 4 * TK : 0));
  static_assert(TK % NG == 0, "every thread walks the same number of keys");
};

// ------------------------------------------------------ split pass
// T: q and the output (float or bf16); TKV: the cache (T, or int8 with scales)
template <typename T, typename TKV, int D, int RM>
__global__ void __launch_bounds__(kThreads) decode_split(const Params p) {
  using L = Layout<TKV, D, RM>;
  constexpr bool kQuant = L::kQuant;
  constexpr int CT = L::CT, NG = L::NG, TK = L::TK, KPT = TK / NG;  // keys a thread, a tile
  constexpr int CPR = D * (int)sizeof(TKV) / 16;         // 16-byte chunks a row
  constexpr int CH = 16 / (int)sizeof(TKV);
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* sK = reinterpret_cast<TKV*>(smem);                // [2][TK][D]
  TKV* sV = sK + 2 * TK * D;                             // [2][TK][D]
  float* red = reinterpret_cast<float*>(smem);           // [NG][RM][D], after the walk
  float* sP = reinterpret_cast<float*>(smem + L::kRegion);  // [RM][TK] scores, then p
  float* sA = sP + RM * TK;                              // [RM] rescale of the tile
  float* sQ = sA + RM;                                   // [RM][D] where not in registers
  float* sSK = sQ + (L::kQReg ? 0 : RM * D);             // int8: [2][TK] scales of K
  float* sSV = sSK + 2 * TK;                             // int8: [2][TK] scales of V

  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = tid / CT, c8 = (tid % CT) * 8;
  const int start = p.k_lo + s * p.chunk;
  const int end = min(start + p.chunk, p.k_hi);
  const int nt = end > start ? (end - start + TK - 1) / TK : 0;
  const TKV* K = static_cast<const TKV*>(p.k) + b * p.ksb + kvh * p.ksh;
  const TKV* V = static_cast<const TKV*>(p.v) + b * p.vsb + kvh * p.vsh;

  auto load_tile = [&](int t, int buf) {
    const int k0 = start + t * TK;
#pragma unroll
    for (int c = tid; c < TK * CPR; c += kThreads) {
      const int r = c / CPR, off = (c % CPR) * CH;
      const bool ok = k0 + r < end;
      const long long row = ok ? k0 + r : start;
      cp_async16(sK + (buf * TK + r) * D + off, K + row * p.kss + off, ok);
      cp_async16(sV + (buf * TK + r) * D + off, V + row * p.vss + off, ok);
    }
    if constexpr (kQuant) {   // the tile's scales; buffer `buf` is free (see the walk)
      if (tid < TK) {
        const long long row = k0 + tid;
        const bool ok = row < end;
        const __nv_bfloat16* SK = static_cast<const __nv_bfloat16*>(p.sk);
        const __nv_bfloat16* SV = static_cast<const __nv_bfloat16*>(p.sv);
        sSK[buf * TK + tid] = ok ? __bfloat162float(SK[b * p.sksb + kvh * p.sksh + row * p.skss])
                                 : 0.0f;
        sSV[buf * TK + tid] = ok ? __bfloat162float(SV[b * p.svsb + kvh * p.svsh + row * p.svss])
                                 : 0.0f;
      }
    }
    cp_async_commit();
  };
  if (nt > 0) load_tile(0, 0);

  // this thread's 8 columns of the query rows, scaled to base 2: row
  // r = g * Sq + i is row i of head kvh * group + g
  float qr[L::kQReg ? RM : 1][8];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (r < p.R) {
      load8(static_cast<const T*>(p.q) + b * p.qsb +
                (long long)(kvh * p.group + r / p.Sq) * p.qsh + (long long)(r % p.Sq) * p.qss + c8,
            x);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if constexpr (L::kQReg) qr[r][e] = x[e] * p.scale_log2;
      else sQ[r * D + c8 + e] = x[e] * p.scale_log2;
    }
  }

  auto qval = [&](int r, int e) -> float {
    if constexpr (L::kQReg) return qr[r][e];
    else return sQ[r * D + c8 + e];
  };

  float acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;
  float m[L::RPW], l[L::RPW];
#pragma unroll
  for (int j = 0; j < L::RPW; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.0f;
  }

  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    if (t + 1 < nt) {
      load_tile(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();          // tile t landed for every thread (and sQ written)
    const int k0 = start + t * TK;
    const TKV* tK = sK + buf * TK * D;
    const TKV* tV = sV + buf * TK * D;

    // ---- scores of keys g, g + NG, ...: D / 8 threads a key, then shuffles;
    //      the KPT keys' chains are independent and interleave
    float part[KPT][RM];
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      float kv[8];
      load8(tK + (g + j * NG) * D + c8, kv);
      if constexpr (kQuant) {
        const float sc = sSK[buf * TK + g + j * NG];
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] *= sc;
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        float x = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(qval(r, e), kv[e], x);
        part[j][r] = x;
      }
    }
#pragma unroll
    for (int off = CT / 2; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < KPT; ++j)
#pragma unroll
        for (int r = 0; r < RM; ++r) part[j][r] += __shfl_xor_sync(0xffffffffu, part[j][r], off);
    if (c8 == 0) {
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kk = g + j * NG, kp = k0 + kk;
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r < p.R) {
            const int pos = p.q_offset + r % p.Sq;
            const bool ok = kp < end && (!p.causal || kp <= pos) &&
                            (p.window <= 0 || kp > pos - p.window);
            sP[r * TK + kk] = ok ? part[j][r] : -INFINITY;
          }
        }
      }
    }
    __syncthreads();

    // ---- online softmax: warp w owns rows w, w + 4, ...
#pragma unroll
    for (int j = 0; j < L::RPW; ++j) {
      const int r = warp + kWarps * j;
      if (r < p.R) {
        float mx = -INFINITY;
        for (int kk = lane; kk < TK; kk += 32) mx = fmaxf(mx, sP[r * TK + kk]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[j], mx);
        const float mu = mn == -INFINITY ? 0.0f : mn;   // nothing seen yet
        const float a = ex2(m[j] - mu);
        float sum = 0.0f;
        for (int kk = lane; kk < TK; kk += 32) {
          const float e = ex2(sP[r * TK + kk] - mu);
          sP[r * TK + kk] = e;
          sum += e;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[j] = l[j] * a + sum;
        m[j] = mn;
        if (lane == 0) sA[r] = a;
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + p v over this thread's keys
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < p.R) {
        const float a = sA[r];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] *= a;
      }
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kk = g + j * NG;
      float vv[8];
      load8(tV + kk * D + c8, vv);
      if constexpr (kQuant) {
        const float sc = sSV[buf * TK + kk];
#pragma unroll
        for (int e = 0; e < 8; ++e) vv[e] *= sc;
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (r < p.R) {
          const float pr = sP[r * TK + kk];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pr, vv[e], acc[r][e]);
        }
      }
    }
    __syncthreads();          // buffer `buf` is free for tile t + 2
  }

  // ---- the NG key shares added through shared memory; (m, l) by row
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(g * RM + r) * D + c8 + e] = acc[r][e];
  __syncthreads();
  const long long slot = ((long long)b * p.Hkv + kvh) * p.splits + s;
  float* out = p.acc + slot * p.R * D;
  for (int e = tid; e < p.R * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float sum = 0.0f;
#pragma unroll 4
    for (int gg = 0; gg < NG; ++gg) sum += red[(gg * RM + r) * D + d];
    out[e] = sum;
  }
#pragma unroll
  for (int j = 0; j < L::RPW; ++j) {
    const int r = warp + kWarps * j;
    if (r < p.R && lane == 0) {
      p.ml[(slot * p.R + r) * 2] = m[j];
      p.ml[(slot * p.R + r) * 2 + 1] = l[j];
    }
  }
}

// ------------------------------------------------------ merge pass
// grid (R, Hkv, B), D threads: row r of every split of one (batch, kv head).
// The splits' (m, l) are staged in shared memory, then each thread adds its
// column of the splits' sums, four loads in flight.
template <typename T>
__global__ void decode_merge(const Params p, int D) {
  extern __shared__ float w[];                           // [splits] weights
  const int r = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const long long first = ((long long)b * p.Hkv + kvh) * p.splits;
  float* ml = w + p.splits;                              // [splits][2]
  for (int s = threadIdx.x; s < p.splits; s += blockDim.x) {
    ml[2 * s] = p.ml[((first + s) * p.R + r) * 2];
    ml[2 * s + 1] = p.ml[((first + s) * p.R + r) * 2 + 1];
  }
  __syncthreads();
  float mstar = -INFINITY;
  for (int s = 0; s < p.splits; ++s) mstar = fmaxf(mstar, ml[2 * s]);
  const float mu = mstar == -INFINITY ? 0.0f : mstar;
  float lsum = 0.0f;
  for (int s = 0; s < p.splits; ++s) lsum += ml[2 * s + 1] * ex2(ml[2 * s] - mu);
  __syncthreads();
  for (int s = threadIdx.x; s < p.splits; s += blockDim.x) w[s] = ex2(ml[2 * s] - mu);
  __syncthreads();
  const float inv = 1.0f / fmaxf(lsum, 1e-30f);
  T* O = static_cast<T*>(p.o) + b * p.osb + (long long)(kvh * p.group + r / p.Sq) * p.osh +
         (long long)(r % p.Sq) * p.oss;
  const float* acc = p.acc + (first * p.R + r) * D;
  const long long step = (long long)p.R * D;             // from one split to the next
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.0f;
#pragma unroll 4
    for (int s = 0; s < p.splits; ++s) a += acc[s * step + d] * w[s];
    put(O + d, a * inv);
  }
}

template <typename T, typename TKV, int D, int RM>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = Layout<TKV, D, RM>::kBytes;
  static const cudaError_t ready = cudaFuncSetAttribute(
      decode_split<T, TKV, D, RM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ready != cudaSuccess) return ready;
  decode_split<T, TKV, D, RM><<<dim3(p.splits, p.Hkv, B), kThreads, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge<T><<<dim3(p.R, p.Hkv, B), D, 3 * p.splits * sizeof(float), stream>>>(p, D);
  return cudaGetLastError();
}

template <typename T, typename TKV, int D>
cudaError_t by_rows(const Params& p, int B, cudaStream_t stream) {
  if (p.R <= 2) return launch<T, TKV, D, 2>(p, B, stream);
  if (p.R <= 8) return launch<T, TKV, D, 8>(p, B, stream);
  return launch<T, TKV, D, kMaxRows>(p, B, stream);
}

// the int8 cache is built for d_head 64, 128 and 256 only (ops.INT8_HEAD_DIMS)
template <typename T, typename TKV>
cudaError_t by_width(const Params& p, int B, int D, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  switch (D) {
    case 16:
      if constexpr (!kQuant) return by_rows<T, TKV, 16>(p, B, stream);
      return cudaErrorInvalidValue;
    case 32:
      if constexpr (!kQuant) return by_rows<T, TKV, 32>(p, B, stream);
      return cudaErrorInvalidValue;
    case 64: return by_rows<T, TKV, 64>(p, B, stream);
    case 128: return by_rows<T, TKV, 128>(p, B, stream);
    case 256: return by_rows<T, TKV, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the Params of a call, or false where its shape is refused
bool make_params(Params& p, int B, int Hq, int Hkv, int Sq, int D, float scale, int splits,
                 void* scratch) {
  if (Hkv <= 0 || Hq % Hkv != 0 || splits <= 0) return false;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.Sq = Sq;
  p.R = p.group * Sq;
  if (p.R > kMaxRows || p.R <= 0) return false;
  p.splits = splits;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.acc = static_cast<float*>(scratch);
  p.ml = p.acc + (long long)B * Hkv * splits * p.R * D;
  return true;
}

}  // namespace
