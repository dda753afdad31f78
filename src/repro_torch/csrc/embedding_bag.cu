// Hopper kernel of EmbeddingBag, table-batched: for every bag and every one
// of F tables, the sum or mean of that table's rows the bag names.
//
// Replaces embedding_bag_pallas (B8) of the reference package
// (src/repro/kernels/embedding_bag/embedding_bag.py), the lookup under each
// of DLRM's 26 sparse features.  The reference calls it once per table; one
// launch here serves all of a forward's tables, as the Pallas kernel's note
// on FBGEMM's table-batched embedding suggests.
//
// What it computes: out[b, f, :] = sum over j of
// table_f[min(idx[b, f, j], V_f - 1), :] for the indices >= 0 (-1 marks
// padding and is skipped, not counted; an index at or above V_f reads row
// V_f - 1 of that table and is counted, as the reference's gather clamps
// it); for mode mean, divided by max(count, 1).  Within a bag the rows are
// added in the order j = 0 .. L - 1, starting from 0, so every table's
// result is the single-table call's bit for bit.  float32 in and out.
//
// What bounds it on an H100: bytes.  One add per float read; what must move
// is the indices, one table row per distinct index and the output.  The
// Pallas kernel keeps the gather out of HBM by DMA-ing each row into VMEM
// and summing there; here each row goes from HBM straight into registers.
// At DLRM's batch 512 the work is a few MB, so a forward's time was its 26
// launches and the host's 26 wrapper calls, index copies and a stack of
// the outputs; at batch 262,144 it is 3.3 GB of random 256-byte rows.
//
// Design:
//   * One launch for F <= 64 tables.  Their row pointers and row counts
//     travel in a 1 KB struct passed by value (no device allocation, no
//     host-to-device copy) and are staged in shared memory once a block.
//     The indices are [B, F, L] int32, read in place; the output is
//     written at a given bag stride, so the bags can land in a slice of
//     the caller's buffer (DLRM's interaction input) with no stack.
//   * The (bag, table) items are walked in the order of the index array:
//     item i = b * F + f, position p = i * L + j.  A lane group of G lanes
//     (G = 16 at D = 64: 16-byte loads, four floats a lane) walks a run of
//     kItems consecutive items, kInFlight positions a step: it issues the
//     loads of all of them (several bags at L = 1, several j of a bag at
//     L > 1) before any add, so several rows are in flight a lane.  A
//     warp serves 32 / G groups at once.
//   * Each step a warp loads its groups' indices once, coalesced, one lane
//     a position, and hands them out with __shfl_sync.
//   * Rows are read, and outputs written, with streaming hints (__ldcs,
//     __stcs): neither is reused.
//   * Padding is dropped by a branch, never by multiplying by 0: a row that
//     is not read must not be able to put a NaN into the sum.
//   * A narrow path (four bytes a lane) serves D not a multiple of 4 and
//     pointers or a stride that are not 16-byte aligned.
//   * Launches on the given stream, allocates nothing, does not
//     synchronise, returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxTables = 64;
constexpr int kInFlight = 4;    // positions a group loads before it adds
constexpr int kItems = 4;       // items a group walks
constexpr int kMinGroupLog2 = 2;  // G >= 4, so a warp's positions a step fit its 32 lanes

struct Tables {
  const float* ptr[kMaxTables];
  long long rows[kMaxTables];
};

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    r[0] = t.x;
    r[1] = t.y;
    r[2] = t.z;
    r[3] = t.w;
  } else {
    r[0] = __ldcs(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float (&a)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  } else {
    __stcs(p, a[0]);
  }
}

// n_items = B * F; L == 0 is walked as one padding position an item, so
// that every bag is written (zeros).
template <int VEC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
ebags(const __grid_constant__ Tables tabs, int F, int D, const int* __restrict__ idx,
      long long n_items, int L, int mean, int group_log2, float* __restrict__ out,
      long long out_stride) {
  __shared__ const float* s_ptr[kMaxTables];
  __shared__ long long s_rows[kMaxTables];
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    s_ptr[f] = tabs.ptr[f];
    s_rows[f] = tabs.rows[f];
  }
  __syncthreads();
  const int groups = kWarp >> group_log2, G = 1 << group_log2;
  const int lane = threadIdx.x % kWarp, g = lane >> group_log2, t = lane & (G - 1);
  const long long warp_item = ((long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp) *
                              groups * kItems;
  if (warp_item >= n_items) return;   // the whole warp: no lane is left for a shuffle
  const int Lp = L > 0 ? L : 1;
  const long long item0 = warp_item + (long long)g * kItems;
  const int n_pos = (int)(item0 < n_items ? (n_items - item0 < kItems ? n_items - item0 : kItems)
                                          : 0) * Lp;   // this group's positions
  // the position a lane fetches each step: group lane / kInFlight's, slot lane % kInFlight
  const int fg = lane / kInFlight, fk = lane % kInFlight;
  const long long f_item0 = warp_item + (long long)fg * kItems;
  const int f_npos = fg < groups && f_item0 < n_items
                         ? (int)(n_items - f_item0 < kItems ? n_items - f_item0 : kItems) * Lp
                         : 0;
  const int* f_idx = idx + f_item0 * L;
  const int steps = (kItems * Lp + kInFlight - 1) / kInFlight;   // alike for every group
  const long long b_first = item0 / F;
  const int f_first = (int)(item0 - b_first * F);
  for (int c0 = 0; c0 < D; c0 += G * VEC) {   // one pass at D <= G * VEC
    const int c = c0 + t * VEC;
    const bool col = c < D;
    long long b = b_first;   // the bag, table and j of this group's next position
    int f = f_first, j = 0;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    int cnt = 0;
    for (int s = 0; s < steps; ++s) {
      const int fq = s * kInFlight + fk;
      const int mine = L > 0 && fq < f_npos ? __ldg(f_idx + fq) : -1;
      float r[kInFlight][VEC];
      bool ok[kInFlight], last[kInFlight];
      float* dst[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {   // issue the loads
        const int raw = __shfl_sync(0xffffffffu, mine, g * kInFlight + k);
        const bool live = s * kInFlight + k < n_pos;
        ok[k] = live && raw >= 0;
        last[k] = live && j == Lp - 1;
        if (ok[k] && col) {
          const long long V = s_rows[f];
          load_row<VEC>(s_ptr[f] + (raw < V ? raw : V - 1) * D + c, r[k]);
        }
        dst[k] = out + b * out_stride + (long long)f * D + c;
        if (++j == Lp) {
          j = 0;
          if (++f == F) {
            f = 0;
            ++b;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {   // then add, in the order of j
        if (ok[k]) {
          ++cnt;
          if (col) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] += r[k][e];
          }
        }
        if (last[k]) {
          if (col) {
            if (mean) {
              const float n = fmaxf((float)cnt, 1.0f);
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[e] /= n;
            }
            store_row<VEC>(dst[k], acc);
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
          cnt = 0;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// F tables (host arrays: tables[f] a contiguous float32 [rows[f], D] on the
// card, rows[f] >= 1), idx [B, F, L] int32 contiguous, out [B, F, D]
// float32 with bag stride out_stride (elements) and rows of D contiguous
// floats; mode 0 = sum, 1 = mean; 1 <= F <= 64.
int embedding_bags_fwd(const void* const* tables, const long long* rows, int F, int D,
                       const int* idx, long long B, int L, int mode, float* out,
                       long long out_stride, void* stream) {
  if (F < 1 || F > kMaxTables || D < 1 || L < 0) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  Tables tabs;
  bool aligned = D % 4 == 0 && out_stride % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int f = 0; f < F; ++f) {
    tabs.ptr[f] = static_cast<const float*>(tables[f]);
    tabs.rows[f] = rows[f];
    aligned = aligned && reinterpret_cast<uintptr_t>(tables[f]) % 16 == 0;
  }
  const int vec = aligned ? 4 : 1;
  const int lanes = (D + vec - 1) / vec;   // lanes a row needs
  int group_log2 = kMinGroupLog2;
  while ((1 << group_log2) < lanes && (1 << group_log2) < kWarp) ++group_log2;
  const long long n_items = B * F;
  const long long per_block = (long long)kWarpsPerBlock * (kWarp >> group_log2) * kItems;
  const long long blocks = (n_items + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(kWarp * kWarpsPerBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    ebags<4><<<grid, block, 0, st>>>(tabs, F, D, idx, n_items, L, mode, group_log2, out,
                                     out_stride);
  } else {
    ebags<1><<<grid, block, 0, st>>>(tabs, F, D, idx, n_items, L, mode, group_log2, out,
                                     out_stride);
  }
  return cudaGetLastError();
}

}  // extern "C"
