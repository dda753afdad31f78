// Hopper kernel of TimeWarp bucket alignment: counts times the mask of the
// buckets an entity's validity interval overlaps.
//
// Replaces interval_warp_pallas (B6) of the reference package
// (src/repro/kernels/interval_warp/interval_warp.py).
//
// What it computes: out[n, b] = counts[n, b] * m, where m is 1 if
// ivl[n, 0] < bedges[b + 1] and bedges[b] < ivl[n, 1], else 0, in the
// counts' type (float32 or bfloat16).  A multiply, not a select, as in the
// reference: NaN, infinities and -0.0 come out exactly as the reference's
// do (0 * inf is NaN, 0 * -x is -0.0).
//
// What bounds it on an H100: bytes.  Two compares and a multiply per value;
// what must move is counts and the output once each, the intervals once
// (8 bytes per entity) and the B + 1 bucket edges.  The Pallas kernel tiles
// N into VMEM blocks so that the mask never reaches HBM; here the mask
// lives in a register.  A thread a value with a 64-bit division each, and
// the row's interval re-read by every thread of the row, kept the first
// version at half of that bound.
//
// Design:
//   * Each thread takes one 16-byte chunk of a row: 4 float32 values or 8
//     bfloat16.  A block is 2-D, (chunks a row) x (rows), so the row and
//     the chunk come from the thread's index with no division; offsets are
//     32-bit while N * B < 2^31.
//   * The row's interval is one int2 load (a broadcast among the row's
//     threads); the bucket edges (B <= 64) are staged in shared memory
//     once a block.
//   * Loads and stores carry streaming hints (__ldcs, __stcs): nothing is
//     read twice.
//   * The product x * m is taken per value in float32 and rounded back to
//     the counts' type; for bfloat16 that is exact, since m is 0 or 1.
//   * A scalar path (one value a thread, the interval as two int loads)
//     covers B not a multiple of the vector width and views that are not
//     16-byte aligned.
//   * Launches on the given stream, allocates nothing, does not
//     synchronise, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 64;

// x * m of one value, from and back to its bits (float32, or bfloat16 in
// the low 16 bits)
template <typename T>
__device__ __forceinline__ unsigned mask_bits(unsigned x, float m) {
  if constexpr (std::is_same_v<T, float>) {
    return __float_as_uint(__uint_as_float(x) * m);
  } else {
    return __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(x << 16) * m));
  }
}

template <typename T, int VEC, bool WIDE>
__global__ void __launch_bounds__(kThreads)
warp_mask(const T* __restrict__ counts, const int* __restrict__ ivl, const int* __restrict__ bedges,
          long long N, int B, T* __restrict__ out) {
  using Idx = std::conditional_t<WIDE, long long, int>;
  using Bits = std::conditional_t<sizeof(T) == 4, unsigned, unsigned short>;
  __shared__ int edges[kMaxB + 1];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i <= B; i += blockDim.x * blockDim.y) edges[i] = __ldg(bedges + i);
  __syncthreads();
  const Idx n = (Idx)blockIdx.x * (Idx)blockDim.y + (Idx)threadIdx.y;
  if (n >= N) return;
  const int b0 = threadIdx.x * VEC;
  int s, e;
  if constexpr (VEC > 1) {
    const int2 iv = __ldg(reinterpret_cast<const int2*>(ivl) + n);
    s = iv.x;
    e = iv.y;
  } else {
    s = __ldg(ivl + 2 * n);
    e = __ldg(ivl + 2 * n + 1);
  }
  float m[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) m[v] = (s < edges[b0 + v + 1] && edges[b0 + v] < e) ? 1.0f : 0.0f;
  const Idx i = n * (Idx)B + (Idx)b0;
  if constexpr (VEC == 1) {
    const Bits x = __ldcs(reinterpret_cast<const Bits*>(counts) + i);
    __stcs(reinterpret_cast<Bits*>(out) + i, (Bits)mask_bits<T>(x, m[0]));
  } else {
    constexpr int kPerWord = 4 / sizeof(T);   // values in each 32-bit word of the chunk
    const uint4 x = __ldcs(reinterpret_cast<const uint4*>(counts + i));
    const unsigned in[4] = {x.x, x.y, x.z, x.w};
    unsigned o[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if constexpr (kPerWord == 1) {
        o[w] = mask_bits<T>(in[w], m[w]);
      } else {
        o[w] = mask_bits<T>(in[w] & 0xffffu, m[2 * w]) |
               (mask_bits<T>(in[w] >> 16, m[2 * w + 1]) << 16);
      }
    }
    __stcs(reinterpret_cast<uint4*>(out + i), make_uint4(o[0], o[1], o[2], o[3]));
  }
}

template <typename T, int VEC>
int launch_vec(const void* counts, const int* ivl, const int* bedges, long long N, int B,
               void* out, cudaStream_t st) {
  const int per_row = B / VEC;
  const dim3 block(per_row, kThreads / per_row);
  const long long blocks = (N + block.y - 1) / block.y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* c = static_cast<const T*>(counts);
  T* o = static_cast<T*>(out);
  if (N * B < (1LL << 31)) {
    warp_mask<T, VEC, false><<<(unsigned)blocks, block, 0, st>>>(c, ivl, bedges, N, B, o);
  } else {
    warp_mask<T, VEC, true><<<(unsigned)blocks, block, 0, st>>>(c, ivl, bedges, N, B, o);
  }
  return cudaGetLastError();
}

template <typename T>
int launch(const void* counts, const int* ivl, const int* bedges, long long N, int B, void* out,
           cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = B % kVec == 0 && reinterpret_cast<uintptr_t>(counts) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ivl) % 8 == 0;
  return vec ? launch_vec<T, kVec>(counts, ivl, bedges, N, B, out, st)
             : launch_vec<T, 1>(counts, ivl, bedges, N, B, out, st);
}

}  // namespace

extern "C" {

// counts [N, B] contiguous (dtype 0 = float32, 1 = bfloat16), ivl int32
// [N, 2] contiguous, bedges int32 [B + 1], out [N, B] of the counts' dtype;
// 1 <= B <= 64.
int interval_warp_fwd(const void* counts, int dtype, const int* ivl, const int* bedges,
                      long long N, int B, void* out, void* stream) {
  if (N <= 0) return cudaSuccess;
  if (B < 1 || B > kMaxB) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(counts, ivl, bedges, N, B, out, st);
  if (dtype == 1) return launch<__nv_bfloat16>(counts, ivl, bedges, N, B, out, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
