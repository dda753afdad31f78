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
// lives in a register.
//
// Design, kept simple on purpose (a right kernel first):
//   * One thread per value of [N, B], a grid-stride loop in 64-bit indices,
//     so that neighbouring threads read and write neighbouring values.
//   * The bucket edges (B <= 64 here) are staged in shared memory once per
//     block; the interval of row n is read through the read-only cache by
//     the B threads of that row.
//   * bfloat16 values are widened to float32, multiplied by 0 or 1 (exact)
//     and rounded back, which gives the bfloat16 product.
//   * Launches on the given stream, allocates nothing, does not
//     synchronise, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 64;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_mask(const T* __restrict__ counts, const int* __restrict__ ivl, const int* __restrict__ bedges,
          long long N, int B, T* __restrict__ out) {
  __shared__ int edges[kMaxB + 1];
  for (int i = threadIdx.x; i <= B; i += blockDim.x) edges[i] = bedges[i];
  __syncthreads();
  const long long total = N * B;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long n = i / B;
    const int b = (int)(i - n * B);
    const int s = __ldg(ivl + 2 * n), e = __ldg(ivl + 2 * n + 1);
    const float m = (s < edges[b + 1] && edges[b] < e) ? 1.0f : 0.0f;
    put(out + i, widen(counts[i]) * m);
  }
}

template <typename T>
int launch(const void* counts, const int* ivl, const int* bedges, long long N, int B, void* out,
           cudaStream_t st) {
  const long long total = N * B;
  const long long want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < (1LL << 20) ? want : (1LL << 20));
  warp_mask<T><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(counts), ivl, bedges, N, B,
                                            static_cast<T*>(out));
  return cudaGetLastError();
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
