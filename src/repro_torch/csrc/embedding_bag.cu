// Hopper kernel of EmbeddingBag: per bag, the sum or mean of table rows.
//
// Replaces embedding_bag_pallas (B8) of the reference package
// (src/repro/kernels/embedding_bag/embedding_bag.py), the lookup under each
// of DLRM's 26 sparse features.
//
// What it computes: out[b, :] = sum over j of table[min(idx[b, j], V - 1), :]
// for the indices >= 0 (-1 marks padding and is skipped, not counted; an
// index at or above V reads row V - 1 and is counted, as the reference's
// gather clamps it); for mode mean, divided by max(count, 1).  float32 in
// and out.
//
// What bounds it on an H100: bytes.  One add per float read; what must move
// is the indices, one table row per distinct index and the output.  The
// Pallas kernel keeps the gather out of HBM by DMA-ing each row into VMEM
// and summing there; here each row goes from HBM straight into registers.
//
// Design, kept simple on purpose (a right kernel first):
//   * One warp per bag, lanes across D: at D = 64 (RM2) each lane takes two
//     floats, so a row is one coalesced 256-byte read (VEC = 2 when D is a
//     multiple of 64; one float per lane otherwise).
//   * Every lane reads the bag's indices (one broadcast load each) and
//     skips padding with a branch, never by multiplying by 0: a row that is
//     not read must not be able to put a NaN into the sum.
//   * Eight bags per block of 256 threads; launches on the given stream,
//     allocates nothing, does not synchronise, returns cudaGetLastError().
//
// Not done yet (later work): several rows in flight per warp for long
// bags, and all of a model's tables in one launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kBagsPerBlock = 8;

template <int VEC>
__global__ void __launch_bounds__(kWarp * kBagsPerBlock)
ebag_fwd(const float* __restrict__ table, long long V, int D, const int* __restrict__ idx,
         long long B, int L, int mean, float* __restrict__ out) {
  const long long bag = (long long)blockIdx.x * kBagsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (bag >= B) return;
  const int* ix = idx + bag * L;
  for (int c = lane * VEC; c < D; c += kWarp * VEC) {
    float a[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) a[e] = 0.0f;
    int cnt = 0;
    for (int j = 0; j < L; ++j) {
      const int raw = __ldg(ix + j);
      if (raw < 0) continue;
      const long long r = raw < V ? raw : V - 1;
      ++cnt;
      const float* row = table + r * D + c;
      if constexpr (VEC == 2) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(row));
        a[0] += t.x;
        a[1] += t.y;
      } else {
        a[0] += __ldg(row);
      }
    }
    if (mean) {
      const float n = fmaxf((float)cnt, 1.0f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] /= n;
    }
    float* o = out + bag * D + c;
    if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(o) = make_float2(a[0], a[1]);
    } else {
      o[0] = a[0];
    }
  }
}

}  // namespace

extern "C" {

// table [V, D] float32 contiguous, idx [B, L] int32 contiguous, out [B, D]
// float32; mode 0 = sum, 1 = mean.
int embedding_bag_fwd(const float* table, long long V, int D, const int* idx, long long B,
                      int L, int mode, float* out, void* stream) {
  if (B <= 0) return cudaSuccess;
  const dim3 grid((unsigned)((B + kBagsPerBlock - 1) / kBagsPerBlock)), block(kWarp * kBagsPerBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec2 = D % (2 * kWarp) == 0 && reinterpret_cast<uintptr_t>(table) % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 8 == 0;
  if (vec2) {
    ebag_fwd<2><<<grid, block, 0, st>>>(table, V, D, idx, B, L, mode, out);
  } else {
    ebag_fwd<1><<<grid, block, 0, st>>>(table, V, D, idx, B, L, mode, out);
  }
  return cudaGetLastError();
}

}  // extern "C"
