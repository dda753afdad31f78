// Hopper kernel of the sorted segment-sum: out[v] = sum of contrib[e] over
// the edges e of segment v.
//
// Replaces bucket_scatter_pallas (B5) of the reference package
// (src/repro/kernels/bucket_scatter/bucket_scatter.py), the aggregation
// under every sum and mean of the GNNs' message passing (models/gnn.py).
//
// What it computes: for every segment v, out[v, :] = sum over e in
// [ptr[v], ptr[v+1]) of contrib[e, :], summed in float32 and written once
// in the input type (float32 or bfloat16); an empty segment writes 0.
//
// What bounds it on an H100: bytes.  One add per value read; what must move
// is contrib once, the pointer and the output.  The TPU kernel pads each
// block of destinations to a fixed edge count and multiplies by a one-hot
// matrix, because the TPU's vector unit has no scatter; here the edges are
// sorted by segment, so a segment is a contiguous run that a warp (or a
// group of lanes) reads and sums in registers: no one-hot product, no
// padding, no atomics, and the result does not depend on scheduling.
//
// Design, kept simple on purpose (a right kernel first):
//   * C > 8: one warp per segment, lanes across channels; four values a
//     lane in one vector load (16 bytes in float32, 8 in bfloat16) when C
//     is a multiple of 4 and the operands are aligned, one value a lane
//     otherwise (PNA's 75 channels).  The edge loop is unrolled by four so
//     that four rows are in flight.
//   * C <= 8 (counts at C = 1, EGNN's coordinate deltas at C = 3): G lanes
//     a segment and 32 / G segments a warp, G a power of two from 1 to 32
//     that the host picks from the mean segment length E / V
//     (common.lane_group, as for B1 and B3).  A GNN request's union graph has about one edge
//     per segment (168,960 edges into 169,984), so G is 1 there: a thread a
//     segment, neighbouring threads on neighbouring segments, so the reads
//     of ptr and of the edge rows are coalesced across the warp, where a
//     warp a segment left 31 of 32 lanes idle.  Each lane keeps C float32
//     sums of the edges e0 + j, e0 + j + G, ... in order, then a G-wide
//     butterfly of shuffles adds the lanes'; lane 0 writes the row.
//   * Offsets are 64-bit throughout: ptr is int64 and every row offset is
//     computed in 64 bits.
//   * Blocks of 256 threads (eight segments on the wide path); launches on
//     the given stream, allocates nothing, does not synchronise, returns
//     cudaGetLastError().
//
// Not done yet (later work): split a hub segment across warps, and stage
// rows through shared memory with cp.async for long segments.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kSegsPerBlock = 8;
constexpr int kSmallC = 8;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(b) << 16);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ void ld4(const float* p, float (&a)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  a[0] = t.x;
  a[1] = t.y;
  a[2] = t.z;
  a[3] = t.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&a)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  a[0] = __uint_as_float(t.x << 16);
  a[1] = __uint_as_float(t.x & 0xffff0000u);
  a[2] = __uint_as_float(t.y << 16);
  a[3] = __uint_as_float(t.y & 0xffff0000u);
}
__device__ __forceinline__ void st4(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ unsigned int bits(float x) {
  return static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&a)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bits(a[0]) | bits(a[1]) << 16,
                                            bits(a[2]) | bits(a[3]) << 16);
}

// lanes across channels, VEC values a lane
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarp * kSegsPerBlock)
seg_sum_channels(const T* __restrict__ contrib, long long C, const long long* __restrict__ ptr,
                 long long V, T* __restrict__ out) {
  const long long v = (long long)blockIdx.x * kSegsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (v >= V) return;
  const long long e0 = ptr[v], e1 = ptr[v + 1];
  for (long long c = (long long)lane * VEC; c < C; c += kWarp * VEC) {
    float a[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = 0.0f;
    const T* row = contrib + e0 * C + c;
#pragma unroll 4
    for (long long e = e0; e < e1; ++e, row += C) {
      if constexpr (VEC == 4) {
        float t[4];
        ld4(row, t);
#pragma unroll
        for (int k = 0; k < 4; ++k) a[k] += t[k];
      } else {
        a[0] += ld(row);
      }
    }
    if constexpr (VEC == 4) {
      st4(out + v * C + c, a);
    } else {
      st(out + v * C + c, a[0]);
    }
  }
}

// G lanes a segment across its edges, C <= kSmallC sums a lane, then a
// G-wide shuffle butterfly; 256 / G segments a block
template <typename T, int G>
__global__ void __launch_bounds__(kWarp * kSegsPerBlock)
seg_sum_lanes(const T* __restrict__ contrib, int C, const long long* __restrict__ ptr,
              long long V, T* __restrict__ out) {
  const long long v = ((long long)blockIdx.x * kWarp * kSegsPerBlock + threadIdx.x) / G;
  const int sub = threadIdx.x % G;
  const bool live = v < V;
  float a[kSmallC];
#pragma unroll
  for (int k = 0; k < kSmallC; ++k) a[k] = 0.0f;
  if (live) {
    const long long e1 = ptr[v + 1];
    for (long long e = ptr[v] + sub; e < e1; e += G) {
      const T* row = contrib + e * C;
#pragma unroll
      for (int k = 0; k < kSmallC; ++k)
        if (k < C) a[k] += ld(row + k);
    }
  }
  if constexpr (G > 1) {
#pragma unroll
    for (int k = 0; k < kSmallC; ++k) {
      if (k < C) {
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
      }
    }
  }
  if (live && sub == 0) {
#pragma unroll
    for (int k = 0; k < kSmallC; ++k)
      if (k < C) st(out + v * C + k, a[k]);
  }
}

template <typename T, int G>
void launch_lanes(const T* in, int C, const long long* ptr, long long V, T* o, cudaStream_t st) {
  constexpr long long per_block = kWarp * kSegsPerBlock / G;
  const dim3 grid((unsigned)((V + per_block - 1) / per_block)), block(kWarp * kSegsPerBlock);
  seg_sum_lanes<T, G><<<grid, block, 0, st>>>(in, C, ptr, V, o);
}

template <typename T>
int launch(const void* contrib, long long C, const long long* ptr, long long V, int G, void* out,
           cudaStream_t st) {
  const T* in = static_cast<const T*>(contrib);
  T* o = static_cast<T*>(out);
  if (C <= kSmallC) {
    switch (G) {
      case 1: launch_lanes<T, 1>(in, (int)C, ptr, V, o, st); break;
      case 2: launch_lanes<T, 2>(in, (int)C, ptr, V, o, st); break;
      case 4: launch_lanes<T, 4>(in, (int)C, ptr, V, o, st); break;
      case 8: launch_lanes<T, 8>(in, (int)C, ptr, V, o, st); break;
      case 16: launch_lanes<T, 16>(in, (int)C, ptr, V, o, st); break;
      case 32: launch_lanes<T, 32>(in, (int)C, ptr, V, o, st); break;
      default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
  const dim3 grid((unsigned)((V + kSegsPerBlock - 1) / kSegsPerBlock)), block(kWarp * kSegsPerBlock);
  const uintptr_t align = 4 * sizeof(T);
  if (C % 4 == 0 && reinterpret_cast<uintptr_t>(in) % align == 0 &&
      reinterpret_cast<uintptr_t>(o) % align == 0) {
    seg_sum_channels<T, 4><<<grid, block, 0, st>>>(in, C, ptr, V, o);
  } else {
    seg_sum_channels<T, 1><<<grid, block, 0, st>>>(in, C, ptr, V, o);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// contrib [E, C] contiguous (dtype 0 = float32, 1 = bfloat16), ptr int64
// [V + 1] with ptr[V] = E, out [V, C] of the same dtype; G, the lanes a
// segment of the narrow path (C <= 8; the wide path ignores it), is a power
// of two from 1 to 32.
int bucket_scatter_fwd(const void* contrib, int dtype, long long C, const long long* ptr,
                       long long V, int G, void* out, void* stream) {
  if (V <= 0 || C <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(contrib, C, ptr, V, G, out, st);
  if (dtype == 1) return launch<__nv_bfloat16>(contrib, C, ptr, V, G, out, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
