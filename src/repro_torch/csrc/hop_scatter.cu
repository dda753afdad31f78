// Hopper kernels of the traversal hop: gather -> temporal mask -> segment
// reduce, over the arrival-sorted CSR of the traversal edges.
//
// Four kernels, one per TPU kernel of the reference package
// (src/repro/kernels/hop_scatter/hop_scatter.py):
//
//   hop_fused_cols       <- fused_hop_cols_pallas     (B1)
//   hop_fused_interval   <- fused_hop_interval_pallas (B2)
//   hop_scatter_cols     <- scatter_cols_pallas       (B3)
//   hop_scatter_extremum <- scatter_extremum_pallas   (B4)
//
// What bounds them on an H100: bytes.  A hop does a handful of flops per
// value it reads (one multiply-add per gathered state cell, the interval
// clamps' column/row sums), far below the ~20 flops per byte at which
// float32 arithmetic, not the 3.35 TB/s of HBM, would be the limit.  The
// bytes that must move are the CSR pointer, the per-edge source ids and
// weights, the gathered state rows and the output.  The Pallas kernels
// avoid writing the per-edge [E, C] state to HBM; these do the same: each
// destination's contributions are summed in registers (or shared memory, for
// the interval cells) and only the [V, C] result is written.
//
// Design, kept simple on purpose (a right kernel first):
//   * The TPU kernels' block/slot layout and chunked prefix-difference
//     reduction are VMEM artifacts and are not carried over.  Traversal edges
//     are sorted by arrival, so ptr[v]..ptr[v+1] is destination v's edge run;
//     a destination is reduced by walking its run.
//   * The query batch is a grid axis (blockIdx.y): the reference gets it by
//     vmap over pallas_call, which has no CUDA counterpart.
//   * Narrow rows (C a power of two <= 32, i.e. static C = 1 and bucket
//     C = B = 16): one warp per destination; lane l takes column l % C of edge
//     slot l / C, so 32 / C edges are read per step with neighbouring lanes
//     on neighbouring addresses, and a shuffle tree folds the slots.
//   * Wide rows: one block per (destination, query), threads over columns.
//   * Interval cells (B2): one block per (destination, query), threads over
//     the B*(B+1) cells; each edge's cells are staged in shared memory so the
//     start clamp (column sums) and end clamp (row sums) can read across
//     threads.  Edges with weight 0 or a zero-row source add nothing and are
//     skipped.
//   * Sums of per-edge counts are exact in float32 while they stay below
//     2^24 (the engine's invariant), so the summation order of these kernels
//     gives the same bits as the reference's; above 2^24 it may not.
//   * Each entry point launches on the given stream, allocates nothing, does
//     not synchronise, and returns cudaGetLastError().
//
// Not done yet (later work): balancing zipf hubs across blocks, staging the
// gathered rows through shared memory with cp.async/TMA, and a persistent grid.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kNarrowWarps = 8;  // destinations per block on the narrow path
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fold(float a, float b, bool is_min) {
  return is_min ? fminf(a, b) : fmaxf(a, b);
}

// ---------------------------------------------------------------- loaders
// A loader gives the contribution of edge e at column c for query q, and the
// edge's extremum-channel value.
struct GatherLoad {  // B1: state[q, src[e], c] * w[q, e, c]; src == n_rows is the zero row
  const float* state; long long sq; int n_rows;
  const int* src;
  const float* w; long long wq;
  const float* mch; long long mq; float neutral;
  int C;
  __device__ __forceinline__ float get(int q, long long e, int c) const {
    const int s = src[e];
    if (s >= n_rows) return 0.0f;
    return state[q * sq + (long long)s * C + c] * w[q * wq + e * C + c];
  }
  __device__ __forceinline__ float channel(int q, long long e) const {
    const int s = src[e];
    return s < n_rows ? mch[q * mq + s] : neutral;
  }
};

struct ContribLoad {  // B3: contrib[q, e, c]
  const float* contrib; long long cq; int C;
  __device__ __forceinline__ float get(int q, long long e, int c) const {
    return contrib[q * cq + e * C + c];
  }
  __device__ __forceinline__ float channel(int, long long) const { return 0.0f; }
};

// Narrow rows: one warp per destination, 32 / C edges per step.
template <class Load, bool kExtremum>
__global__ void narrow_kernel(Load ld, const int* __restrict__ ptr, int V, int C,
                              float neutral, bool is_min, float* __restrict__ out,
                              float* __restrict__ mch_out) {
  const int v = blockIdx.x * kNarrowWarps + threadIdx.y;
  const int q = blockIdx.y;
  if (v >= V) return;  // whole warp leaves together
  const int lane = threadIdx.x;
  const int col = lane % C;
  const int slot = lane / C;
  const int G = kWarp / C;
  const long long start = ptr[v], end = ptr[v + 1];
  float acc = 0.0f;
  float m = neutral;
  for (long long base = start; base < end; base += G) {
    const long long e = base + slot;
    const bool live = e < end;
    const float x = live ? ld.get(q, e, col) : 0.0f;
    acc += x;
    if (kExtremum) {
      float r = x;  // row sum over this edge's C lanes
      for (int off = C >> 1; off > 0; off >>= 1) r += __shfl_xor_sync(kFull, r, off);
      if (live && r > 0.0f) m = fold(m, ld.channel(q, e), is_min);
    }
  }
  for (int off = kWarp >> 1; off >= C; off >>= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
    if (kExtremum) m = fold(m, __shfl_xor_sync(kFull, m, off), is_min);
  }
  if (slot == 0) out[((long long)q * V + v) * C + col] = acc;
  if (kExtremum && lane == 0) mch_out[(long long)q * V + v] = m;
}

// Wide rows: one block per (destination, query), threads over columns.
template <class Load, bool kExtremum>
__global__ void wide_kernel(Load ld, const int* __restrict__ ptr, int V, int C,
                            float neutral, bool is_min, float* __restrict__ out,
                            float* __restrict__ mch_out) {
  const int v = blockIdx.x;
  const int q = blockIdx.y;
  const long long start = ptr[v], end = ptr[v + 1];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.0f;
    for (long long e = start; e < end; ++e) acc += ld.get(q, e, c);
    out[((long long)q * V + v) * C + c] = acc;
  }
  if (kExtremum) {
    // threads over edges: each edge's row sum decides its liveness
    __shared__ float red[kWarp];
    float m = neutral;
    for (long long e = start + threadIdx.x; e < end; e += blockDim.x) {
      float r = 0.0f;
      for (int c = 0; c < C; ++c) r += ld.get(q, e, c);
      if (r > 0.0f) m = fold(m, ld.channel(q, e), is_min);
    }
    for (int off = kWarp >> 1; off > 0; off >>= 1)
      m = fold(m, __shfl_xor_sync(kFull, m, off), is_min);
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    if (lane == 0) red[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 1; i < (int)(blockDim.x / kWarp); ++i) m = fold(m, red[i], is_min);
      mch_out[(long long)q * V + v] = m;
    }
  }
}

// B2: interval cells.  Shared memory: cells[NC] | tmp[NC] | acc[NC] | red[32].
template <bool kExtremum>
__global__ void interval_kernel(const float* __restrict__ state, long long sq, int n_rows,
                                int B, const int* __restrict__ src,
                                const float* __restrict__ w, long long wq,
                                const int* __restrict__ sb, long long sbq,
                                const int* __restrict__ eb, long long ebq,
                                const int* __restrict__ ptr, int V,
                                const float* __restrict__ mch, long long mq,
                                float neutral, bool is_min, float* __restrict__ out,
                                float* __restrict__ mch_out) {
  extern __shared__ float smem[];
  const int Bp1 = B + 1;
  const int NC = B * Bp1;
  float* cells = smem;
  float* tmp = smem + NC;
  float* acc = smem + 2 * NC;
  float* red = smem + 3 * NC;
  const int v = blockIdx.x;
  const int q = blockIdx.y;
  const int T = blockDim.x;
  const long long start = ptr[v], end = ptr[v + 1];
  for (int c = threadIdx.x; c < NC; c += T) acc[c] = 0.0f;
  float m = neutral;  // meaningful in thread 0
  for (long long e = start; e < end; ++e) {
    const float we = w[q * wq + e];
    const int s = src[e];
    if (we == 0.0f || s >= n_rows) continue;  // uniform across the block
    const int sbe = sb[q * sbq + e];
    const int ebe = eb[q * ebq + e];
    const float* row = state + q * sq + (long long)s * NC;
    for (int c = threadIdx.x; c < NC; c += T) cells[c] = row[c];
    __syncthreads();
    // start clamp: starts below sbe move onto row sbe
    for (int c = threadIdx.x; c < NC; c += T) {
      const int r = c / Bp1, k = c % Bp1;
      float x = 0.0f;
      if (r > sbe) {
        x = cells[c];
      } else if (r == sbe) {
        for (int rr = 0; rr <= sbe; ++rr) x += cells[rr * Bp1 + k];
      }
      tmp[c] = x;
    }
    __syncthreads();
    // end clamp: ends at or above ebe move onto column ebe; keep s < e cells
    float part = 0.0f;
    for (int c = threadIdx.x; c < NC; c += T) {
      const int r = c / Bp1, k = c % Bp1;
      float x = 0.0f;
      if (k < ebe) {
        x = tmp[c];
      } else if (k == ebe) {
        for (int kk = ebe; kk < Bp1; ++kk) x += tmp[r * Bp1 + kk];
      }
      x = (r < k) ? x * we : 0.0f;
      acc[c] += x;
      part += x;
    }
    if (kExtremum) {
      for (int off = kWarp >> 1; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
      if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = part;
      __syncthreads();
      if (threadIdx.x == 0) {
        float tot = 0.0f;
        for (int i = 0; i < T / kWarp; ++i) tot += red[i];
        if (tot > 0.0f) m = fold(m, mch[q * mq + s], is_min);
      }
    }
    __syncthreads();  // cells/tmp/red are rewritten by the next edge
  }
  __syncthreads();
  for (int c = threadIdx.x; c < NC; c += T) out[((long long)q * V + v) * NC + c] = acc[c];
  if (kExtremum && threadIdx.x == 0) mch_out[(long long)q * V + v] = m;
}

// B4: segment min/max of a per-edge channel gated by alive > 0.
__global__ void extremum_kernel(const float* __restrict__ m_e, long long mq,
                                const float* __restrict__ alive, long long aq,
                                const int* __restrict__ ptr, int V, float neutral,
                                bool is_min, float* __restrict__ out) {
  const int v = blockIdx.x * kNarrowWarps + threadIdx.y;
  const int q = blockIdx.y;
  if (v >= V) return;
  const long long start = ptr[v], end = ptr[v + 1];
  float m = neutral;
  for (long long e = start + threadIdx.x; e < end; e += kWarp)
    if (alive[q * aq + e] > 0.0f) m = fold(m, m_e[q * mq + e], is_min);
  for (int off = kWarp >> 1; off > 0; off >>= 1)
    m = fold(m, __shfl_xor_sync(kFull, m, off), is_min);
  if (threadIdx.x == 0) out[(long long)q * V + v] = m;
}

bool narrow(int C) { return C >= 1 && C <= kWarp && (kWarp % C) == 0; }

int wide_threads(int C) {
  int t = ((C + kWarp - 1) / kWarp) * kWarp;
  return t > 1024 ? 1024 : t;
}

template <class Load>
int launch_cols(const Load& ld, const int* ptr, int V, int Q, int C, bool extremum,
                float neutral, bool is_min, float* out, float* mch_out, cudaStream_t st) {
  if (narrow(C)) {
    dim3 block(kWarp, kNarrowWarps), grid((V + kNarrowWarps - 1) / kNarrowWarps, Q);
    if (extremum)
      narrow_kernel<Load, true><<<grid, block, 0, st>>>(ld, ptr, V, C, neutral, is_min, out, mch_out);
    else
      narrow_kernel<Load, false><<<grid, block, 0, st>>>(ld, ptr, V, C, neutral, is_min, out, mch_out);
  } else {
    dim3 block(wide_threads(C)), grid(V, Q);
    if (extremum)
      wide_kernel<Load, true><<<grid, block, 0, st>>>(ld, ptr, V, C, neutral, is_min, out, mch_out);
    else
      wide_kernel<Load, false><<<grid, block, 0, st>>>(ld, ptr, V, C, neutral, is_min, out, mch_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B1.  state [Q, n_rows, C] (q-stride sq), src [E] in [0, n_rows] (n_rows =
// zero row), w [Q, E, C] (q-stride wq, 0 when shared), ptr [V+1];
// optional extremum channel mch [Q, n_rows] (q-stride mq) -> mch_out [Q, V].
int hop_fused_cols(const float* state, long long sq, int n_rows, int C, const int* src,
                   const float* w, long long wq, const int* ptr, int V, int Q,
                   const float* mch, long long mq, float neutral, int op_is_min,
                   float* out, float* mch_out, void* stream) {
  GatherLoad ld{state, sq, n_rows, src, w, wq, mch, mq, neutral, C};
  return launch_cols(ld, ptr, V, Q, C, mch != nullptr, neutral, op_is_min != 0, out,
                     mch_out, (cudaStream_t)stream);
}

// B2.  state [Q, n_rows, B*(B+1)], w/sb/eb [Q, E] (q-strides), ptr [V+1].
int hop_fused_interval(const float* state, long long sq, int n_rows, int B, const int* src,
                       const float* w, long long wq, const int* sb, long long sbq,
                       const int* eb, long long ebq, const int* ptr, int V, int Q,
                       const float* mch, long long mq, float neutral, int op_is_min,
                       float* out, float* mch_out, void* stream) {
  const int NC = B * (B + 1);
  const int T = wide_threads(NC);
  const size_t smem = (3 * (size_t)NC + kWarp) * sizeof(float);
  const bool ext = mch != nullptr;
  if (smem > 48 * 1024) {
    cudaError_t err = ext ? cudaFuncSetAttribute(interval_kernel<true>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem)
                          : cudaFuncSetAttribute(interval_kernel<false>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(V, Q);
  cudaStream_t st = (cudaStream_t)stream;
  if (ext)
    interval_kernel<true><<<grid, T, smem, st>>>(state, sq, n_rows, B, src, w, wq, sb, sbq, eb,
                                                 ebq, ptr, V, mch, mq, neutral, op_is_min != 0,
                                                 out, mch_out);
  else
    interval_kernel<false><<<grid, T, smem, st>>>(state, sq, n_rows, B, src, w, wq, sb, sbq, eb,
                                                  ebq, ptr, V, mch, mq, neutral, op_is_min != 0,
                                                  out, mch_out);
  return (int)cudaGetLastError();
}

// B3.  contrib [Q, E, C] (q-stride cq), ptr [V+1] -> out [Q, V, C].
int hop_scatter_cols(const float* contrib, long long cq, int C, const int* ptr, int V, int Q,
                     float* out, void* stream) {
  ContribLoad ld{contrib, cq, C};
  return launch_cols(ld, ptr, V, Q, C, false, 0.0f, true, out, nullptr,
                     (cudaStream_t)stream);
}

// B4.  m_e, alive [Q, E] (q-strides), ptr [V+1] -> out [Q, V].
int hop_scatter_extremum(const float* m_e, long long mq, const float* alive, long long aq,
                         const int* ptr, int V, int Q, float neutral, int op_is_min,
                         float* out, void* stream) {
  dim3 block(kWarp, kNarrowWarps), grid((V + kNarrowWarps - 1) / kNarrowWarps, Q);
  extremum_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(m_e, mq, alive, aq, ptr, V,
                                                            neutral, op_is_min != 0, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
