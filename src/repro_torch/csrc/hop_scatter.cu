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
// What bounds them on an H100: bytes, and the latency of the dependent loads
// a destination's walk makes (ptr -> src -> state).  A hop does a handful of
// flops per value it reads (one multiply-add per gathered state cell, the
// interval clamps' column/row sums), far below the ~20 flops per byte at
// which float32 arithmetic, not the 3.35 TB/s of HBM, would be the limit.
// The Pallas kernels avoid writing the per-edge [E, C] state to HBM; these do
// the same: each destination's contributions are summed in registers and only
// the [V, C] result is written.  The TPU kernels' block/slot layout and
// chunked prefix-difference reduction are VMEM artifacts and are not carried
// over: traversal edges are sorted by arrival, so ptr[v]..ptr[v+1] is
// destination v's edge run, and a destination is reduced by walking its run.
// The main path's graph has a mean arrival degree of about 5 (median 2, at
// most a few hundred), so the kernels are shaped for short runs.
//
// Narrow rows (B1 and B3 at C = vec * 2^k with at most 32 lanes an edge:
// static C = 1, bucket C = 16):
//   * A lane reads vec consecutive columns (a float4 where the wrapper found
//     the rows 16-byte aligned, else 1), so an edge takes C / vec lanes.  A
//     group of G edge slots of those lanes takes one destination, and a
//     warp holds the rest in consecutive destinations.  The wrapper picks G,
//     a power of two, from half the mean degree E / V (ops.lane_group), so a
//     destination of typical degree is done in about two steps instead of
//     leaving most of a warp idle.
//   * The query axis is inside the kernel: a lane carries the sums of a tile
//     of up to 8 queries (4 with float4 lanes) in registers, so an edge's
//     src index and a weight shared across queries (query stride 0) are read
//     once for the tile, and src is loaded a step ahead.  The state is
//     addressed with a query and a row stride, so that with the extremum
//     channel on rows narrower than a 32-byte sector (C = 1) the wrapper can
//     hand over a [N, Q, C + 1] copy in which a source's state and channel
//     for 8 queries share 64 bytes.
//   * A weight of 0 adds nothing, so its state value is not read: the gather
//     touches only the source rows the hop's predicate keeps.
//   * The MIN/MAX channel rides the same pass: one lane of an edge with any
//     non-zero weight reads the channel beside the state, and the edge is
//     alive when its row sum (the values just summed, then a shuffle over
//     the edge's lanes) is > 0.  The fold over slots shares the sum's tree.
//   * The warp walks as many steps as its busiest destination needs, so every
//     lane is present at every shuffle; a hub of any degree stays correct.
// Wide rows (any other C): one block per (destination, query), threads over
// columns.
//
// Interval cells (B2), B + 1 <= 32: one warp per (destination, query), eight
// consecutive destinations per block.  Lane k owns column k of the B x (B+1)
// cells and keeps its B rows in registers:
//   * the warp loads the metadata (weight, src, start/end bucket) of 32 edges
//     at once and walks only the edges that can contribute (a ballot), so an
//     edge with weight 0, a zero-row source or an empty clamp costs nothing;
//   * start clamp: a running sum down the lane's own rows;
//   * end clamp: the cells at columns >= eb of a row fold onto column eb, a
//     sum across lanes by shuffles, for the rows that survive (sb <= r < eb);
//   * the r < k mask and the weight, then the sums stay in registers: no
//     shared memory and no barrier per edge;
//   * with the extremum, the edge's total is a warp sum and lane 0 gathers
//     the channel once.
// B >= 32 keeps a block per (destination, query) over shared memory.
//
// Sums of per-edge counts are exact in float32 while they stay below 2^24
// (the engine's invariant), so the summation order of these kernels gives
// the same bits as the plain versions'; above 2^24 it may not.  No atomics:
// every output has one writer, and the order of its sum is fixed.  Each
// entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
//
// Not done yet (later work): staging the gathered rows through shared memory
// with cp.async/TMA, a persistent grid, and an engine that keeps its states
// in the [N, Q, C] layout so that no copy is needed.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;   // narrow and interval-warp kernels: 256 threads
// Queries a lane of the narrow kernel carries: 8 at one column a lane, 4 at
// float4 lanes (16 sums a lane; 32 left B1 at C = 16 with 2 blocks an SM).
template <int kVec>
constexpr int kQueryTile = kVec == 1 ? 8 : 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fold(float a, float b, bool is_min) {
  return is_min ? fminf(a, b) : fmaxf(a, b);
}

// ---------------------------------------------------------------- vectors
// A lane of the narrow-row kernels reads kVec consecutive columns at once
// (a float4 where the wrapper found the rows 16-byte aligned).
template <int kVec>
struct Vec {
  float v[kVec];
};

template <int kVec>
__device__ __forceinline__ Vec<kVec> load_vec(const float* p);

template <>
__device__ __forceinline__ Vec<1> load_vec<1>(const float* p) {
  return Vec<1>{{__ldg(p)}};
}

template <>
__device__ __forceinline__ Vec<4> load_vec<4>(const float* p) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  return Vec<4>{{t.x, t.y, t.z, t.w}};
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int t = 0; t < kVec; ++t) p[t] = x[t];
  }
}

// ---------------------------------------------------------------- loaders
// ``ahead`` loads what edge e's gather depends on (its source row and a
// weight shared across queries) a step before ``load`` uses it; ``load``
// gives the contributions of edge e at columns c0 .. c0 + kVec - 1 for
// queries q0 .. q0 + nq - 1 (queries past nq get 0) and whether any of the
// lane's weights is non-zero; ``get`` one query's contribution (wide rows);
// ``channel`` the extremum channel at a source row.
template <int kVec>
struct Ahead {
  int s;            // source row
  Vec<kVec> w;      // the weights, when shared across queries
};

struct GatherLoad {  // B1: state[q, src[e], c] * w[q, e, c]; src >= n_rows is the zero row
  const float* state; long long sq, rs;   // element (q, s, c) at q * sq + s * rs + c
  int n_rows;
  const int* src;
  const float* w; long long wq;           // element (q, e, c) at q * wq + e * C + c
  const float* mch; long long mq, mrs;    // element (q, s) at q * mq + s * mrs
  int C;
  template <int kVec>
  __device__ __forceinline__ Ahead<kVec> ahead(int e, int c0) const {
    Ahead<kVec> a{__ldg(src + e), Vec<kVec>{}};
    if (wq == 0) a.w = load_vec<kVec>(w + (long long)e * C + c0);
    return a;
  }
  // A weight of 0 adds nothing (the engine's states are finite), so its
  // state value is not read: the gather touches only the rows the hop uses.
  template <int kVec>
  __device__ __forceinline__ bool load(int e, const Ahead<kVec>& a, int c0, int q0, int nq,
                                       float (&x)[kQueryTile<kVec>][kVec]) const {
    bool any = false;
#pragma unroll
    for (int j = 0; j < kQueryTile<kVec>; ++j)
#pragma unroll
      for (int t = 0; t < kVec; ++t) x[j][t] = 0.0f;
    if (a.s >= n_rows) return false;
    const float* row = state + q0 * sq + (long long)a.s * rs + c0;
    const float* we = w + q0 * wq + (long long)e * C + c0;
#pragma unroll
    for (int j = 0; j < kQueryTile<kVec>; ++j) {
      if (j >= nq) continue;
      const Vec<kVec> wj = wq == 0 ? a.w : load_vec<kVec>(we + j * wq);
      bool nz = false;
#pragma unroll
      for (int t = 0; t < kVec; ++t) nz |= wj.v[t] != 0.0f;
      if (nz) {
        const Vec<kVec> st = load_vec<kVec>(row + j * sq);
#pragma unroll
        for (int t = 0; t < kVec; ++t) x[j][t] = wj.v[t] != 0.0f ? st.v[t] * wj.v[t] : 0.0f;
      }
      any |= nz;
    }
    return any;
  }
  __device__ __forceinline__ int source(long long e) const { return src[e]; }
  __device__ __forceinline__ float get(int q, long long e, int c) const {
    const int s = src[e];
    if (s >= n_rows) return 0.0f;
    return state[q * sq + (long long)s * rs + c] * w[q * wq + e * C + c];
  }
  __device__ __forceinline__ float channel(int q, int s) const {
    return __ldg(mch + q * mq + (long long)s * mrs);
  }
};

struct ContribLoad {  // B3: contrib[q, e, c]
  const float* contrib; long long cq; int C;
  template <int kVec>
  __device__ __forceinline__ Ahead<kVec> ahead(int, int) const { return Ahead<kVec>{}; }
  template <int kVec>
  __device__ __forceinline__ bool load(int e, const Ahead<kVec>&, int c0, int q0, int nq,
                                       float (&x)[kQueryTile<kVec>][kVec]) const {
    const float* p = contrib + q0 * cq + (long long)e * C + c0;
#pragma unroll
    for (int j = 0; j < kQueryTile<kVec>; ++j) {
      const Vec<kVec> y = j < nq ? load_vec<kVec>(p + j * cq) : Vec<kVec>{};
#pragma unroll
      for (int t = 0; t < kVec; ++t) x[j][t] = y.v[t];
    }
    return true;
  }
  __device__ __forceinline__ int source(long long) const { return 0; }
  __device__ __forceinline__ float get(int q, long long e, int c) const {
    return contrib[q * cq + e * C + c];
  }
  __device__ __forceinline__ float channel(int, int) const { return 0.0f; }
};

// Narrow rows: 2^log_g edge slots x 2^log_l lanes of kVec columns per
// destination (C = 2^log_l * kVec); the Q queries in tiles of kQueryTile.
template <class Load, bool kExtremum, int kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
narrow_kernel(Load ld, const int* __restrict__ ptr, int V, int Q, int log_l, int log_g,
              float neutral, bool is_min, float* __restrict__ out,
              float* __restrict__ mch_out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int log_w = log_l + log_g;           // log2 of the lanes per destination
  const int L = 1 << log_l;                  // lanes per edge
  const int G = 1 << log_g;                  // edge slots per destination
  const int C = L * kVec;
  const int unit = lane & (L - 1);
  const int slot = (lane >> log_l) & (G - 1);
  const int v = (warp << (5 - log_w)) + (lane >> log_w);
  const bool has_v = v < V;
  const int start = has_v ? __ldg(ptr + v) : 0;
  const int end = has_v ? __ldg(ptr + v + 1) : 0;
  // every lane walks the busiest destination's number of steps, so all 32
  // are present at each shuffle
  const int steps = __reduce_max_sync(kFull, (end - start + G - 1) >> log_g);
  for (int q0 = 0; q0 < Q; q0 += kQueryTile<kVec>) {
    const int nq = min(kQueryTile<kVec>, Q - q0);
    float acc[kQueryTile<kVec>][kVec], m[kQueryTile<kVec>];
#pragma unroll
    for (int j = 0; j < kQueryTile<kVec>; ++j) {
#pragma unroll
      for (int t = 0; t < kVec; ++t) acc[j][t] = 0.0f;
      m[j] = neutral;
    }
    const int c0 = unit * kVec;
    Ahead<kVec> next{};
    if (start + slot < end) next = ld.template ahead<kVec>(start + slot, c0);
    for (int i = 0; i < steps; ++i) {
      const int e = start + (i << log_g) + slot;
      const bool live = e < end;
      const Ahead<kVec> cur = next;
      if (e + G < end) next = ld.template ahead<kVec>(e + G, c0);  // a step ahead
      const int s = cur.s;
      float x[kQueryTile<kVec>][kVec];
      bool weighted = false;
      if (live) {
        weighted = ld.template load<kVec>(e, cur, c0, q0, nq, x);
      } else {
#pragma unroll
        for (int j = 0; j < kQueryTile<kVec>; ++j)
#pragma unroll
          for (int t = 0; t < kVec; ++t) x[j][t] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kQueryTile<kVec>; ++j)
#pragma unroll
        for (int t = 0; t < kVec; ++t) acc[j][t] += x[j][t];
      if (kExtremum) {
        // the channel of an edge with any non-zero weight is read beside its
        // state, before the edge is known to be alive
        const unsigned slot_lanes = (L == kWarp ? kFull : ((1u << L) - 1u)) << (lane & ~(L - 1));
        const unsigned weighted_lanes = __ballot_sync(kFull, weighted);  // every lane votes
        const bool fetch = unit == 0 && (weighted_lanes & slot_lanes) != 0;
        float ch[kQueryTile<kVec>], r[kQueryTile<kVec>];
#pragma unroll
        for (int j = 0; j < kQueryTile<kVec>; ++j) {
          ch[j] = fetch && j < nq ? ld.channel(q0 + j, s) : neutral;
          r[j] = x[j][0];
#pragma unroll
          for (int t = 1; t < kVec; ++t) r[j] += x[j][t];
        }
        // the edge is alive for query j when its row sum over C columns is > 0
#pragma unroll
        for (int j = 0; j < kQueryTile<kVec>; ++j)
          for (int off = 1; off < L; off <<= 1) r[j] += __shfl_xor_sync(kFull, r[j], off);
        if (fetch) {
#pragma unroll
          for (int j = 0; j < kQueryTile<kVec>; ++j)
            if (r[j] > 0.0f) m[j] = fold(m[j], ch[j], is_min);
        }
      }
    }
    // fold the G slots: lanes that differ only in their slot bits
    for (int off = L; off < (L << log_g); off <<= 1) {
#pragma unroll
      for (int j = 0; j < kQueryTile<kVec>; ++j) {
#pragma unroll
        for (int t = 0; t < kVec; ++t) acc[j][t] += __shfl_xor_sync(kFull, acc[j][t], off);
        if (kExtremum) m[j] = fold(m[j], __shfl_xor_sync(kFull, m[j], off), is_min);
      }
    }
    if (has_v && slot == 0) {
#pragma unroll
      for (int j = 0; j < kQueryTile<kVec>; ++j)
        if (j < nq) store_vec<kVec>(out + ((long long)(q0 + j) * V + v) * C + unit * kVec, acc[j]);
      if (kExtremum && unit == 0) {
#pragma unroll
        for (int j = 0; j < kQueryTile<kVec>; ++j)
          if (j < nq) mch_out[(long long)(q0 + j) * V + v] = m[j];
      }
    }
  }
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
      if (r > 0.0f) m = fold(m, ld.channel(q, ld.source(e)), is_min);
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

// ---------------------------------------------------------------- B2
struct IntervalArgs {
  const float* state; long long sq; int n_rows; int B;   // state [Q, n_rows, B*(B+1)]
  const int* src;
  const float* w; long long wq;                          // [Q, E] (query strides)
  const int* sb; long long sbq;
  const int* eb; long long ebq;
  const int* ptr; int V;
  const float* mch; long long mq;                        // [Q, n_rows]
  float neutral; bool is_min;
  float* out; float* mch_out;
};

// B + 1 <= 32: a warp per (destination, query); lane k owns column k and
// keeps rows 0 .. kRows - 1 (kRows >= B) of it in registers.
template <int kRows, bool kExtremum>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
interval_warp_kernel(const IntervalArgs a) {
  const int k = threadIdx.x & (kWarp - 1);
  const int v = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int q = blockIdx.y;
  if (v >= a.V) return;  // the whole warp leaves together
  const int B = a.B;
  const int Bp1 = B + 1;
  const int NC = B * Bp1;
  const bool own = k <= B;  // the lane owns column k
  const int start = __ldg(a.ptr + v), end = __ldg(a.ptr + v + 1);
  const float* state = a.state + q * a.sq;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  float m = a.neutral;  // meaningful in lane 0
  for (int base = start; base < end; base += kWarp) {
    // lane i holds the metadata of edge base + i
    const int ei = base + k;
    float w_i = 0.0f;
    int s_i = a.n_rows, sb_i = 0, eb_i = 0;
    if (ei < end) {
      w_i = __ldg(a.w + q * a.wq + ei);
      s_i = __ldg(a.src + ei);
      sb_i = __ldg(a.sb + q * a.sbq + ei);
      eb_i = __ldg(a.eb + q * a.ebq + ei);
    }
    // only rows max(sb, 0) <= r < min(eb, B) can hold a cell r < k after
    // the clamps: an edge with none of them, weight 0 or the zero row adds
    // nothing and is not alive
    const bool adds = ei < end && w_i != 0.0f && s_i < a.n_rows && max(sb_i, 0) < min(eb_i, B);
    unsigned todo = __ballot_sync(kFull, adds);
    while (todo) {
      const int i = __ffs(todo) - 1;
      todo &= todo - 1;
      const float we = __shfl_sync(kFull, w_i, i);
      const int s = __shfl_sync(kFull, s_i, i);
      const int sbe = __shfl_sync(kFull, sb_i, i);
      const int ebe = __shfl_sync(kFull, eb_i, i);
      const int lo = max(sbe, 0), hi = min(ebe, B);
      const float* colp = state + (long long)s * NC + k;
      // start clamp: the rows up to sbe fold onto row sbe (a running sum)
      float t[kRows];
      float run = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float c = (own && r < hi) ? __ldg(colp + r * Bp1) : 0.0f;
        if (r <= sbe) run += c;
        t[r] = r < sbe ? 0.0f : (r == sbe ? run : c);
      }
      float part = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < lo || r >= hi) continue;  // uniform across the warp
        float x = t[r];
        if (ebe <= B) {
          // end clamp: the cells at columns >= ebe fold onto column ebe
          float tail = (own && k >= ebe) ? t[r] : 0.0f;
#pragma unroll
          for (int off = kWarp >> 1; off > 0; off >>= 1)
            tail += __shfl_xor_sync(kFull, tail, off);
          x = k < ebe ? t[r] : (k == ebe ? tail : 0.0f);
        }
        x = (own && r < k) ? x * we : 0.0f;  // cells with start < end only
        acc[r] += x;
        part += x;
      }
      if (kExtremum) {
#pragma unroll
        for (int off = kWarp >> 1; off > 0; off >>= 1)
          part += __shfl_xor_sync(kFull, part, off);
        if (k == 0 && part > 0.0f) m = fold(m, __ldg(a.mch + q * a.mq + s), a.is_min);
      }
    }
  }
  if (own) {
    float* o = a.out + ((long long)q * a.V + v) * NC + k;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < B) o[r * Bp1] = acc[r];
  }
  if (kExtremum && k == 0) a.mch_out[(long long)q * a.V + v] = m;
}

// B >= 32: a block per (destination, query), threads over the B*(B+1)
// cells.  Shared memory: cells[NC] | tmp[NC] | acc[NC] | red[32].
template <bool kExtremum>
__global__ void interval_block_kernel(const IntervalArgs a) {
  extern __shared__ float smem[];
  const int B = a.B;
  const int Bp1 = B + 1;
  const int NC = B * Bp1;
  float* cells = smem;
  float* tmp = smem + NC;
  float* acc = smem + 2 * NC;
  float* red = smem + 3 * NC;
  const int v = blockIdx.x;
  const int q = blockIdx.y;
  const int T = blockDim.x;
  const int start = a.ptr[v], end = a.ptr[v + 1];
  for (int c = threadIdx.x; c < NC; c += T) acc[c] = 0.0f;
  float m = a.neutral;  // meaningful in thread 0
  for (int e = start; e < end; ++e) {
    const float we = a.w[q * a.wq + e];
    const int s = a.src[e];
    if (we == 0.0f || s >= a.n_rows) continue;  // uniform across the block
    const int sbe = a.sb[q * a.sbq + e];
    const int ebe = a.eb[q * a.ebq + e];
    const float* row = a.state + q * a.sq + (long long)s * NC;
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
        if (tot > 0.0f) m = fold(m, a.mch[q * a.mq + s], a.is_min);
      }
    }
    __syncthreads();  // cells/tmp/red are rewritten by the next edge
  }
  __syncthreads();
  for (int c = threadIdx.x; c < NC; c += T) a.out[((long long)q * a.V + v) * NC + c] = acc[c];
  if (kExtremum && threadIdx.x == 0) a.mch_out[(long long)q * a.V + v] = m;
}

// B4: segment min/max of a per-edge channel gated by alive > 0.
__global__ void extremum_kernel(const float* __restrict__ m_e, long long mq,
                                const float* __restrict__ alive, long long aq,
                                const int* __restrict__ ptr, int V, float neutral,
                                bool is_min, float* __restrict__ out) {
  const int v = blockIdx.x * kWarpsPerBlock + threadIdx.y;
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

int log2_exact(int x) {  // log2 of a power of two, else -1
  if (x < 1 || (x & (x - 1)) != 0) return -1;
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// The narrow path takes C = kVec * 2^k columns with at most 32 lanes an edge.
bool narrow(int C, int vec) {
  return (vec == 1 || vec == 4) && C % vec == 0 && C / vec <= kWarp && log2_exact(C / vec) >= 0;
}

int wide_threads(int C) {
  int t = ((C + kWarp - 1) / kWarp) * kWarp;
  return t > 1024 ? 1024 : t;
}

template <class Load, bool kExtremum, int kVec>
void launch_narrow(const Load& ld, const int* ptr, int V, int Q, int log_l, int log_g,
                   float neutral, bool is_min, float* out, float* mch_out, cudaStream_t st) {
  const long long per_block = (long long)kWarpsPerBlock * (kWarp >> (log_l + log_g));
  const unsigned blocks = (unsigned)((V + per_block - 1) / per_block);
  narrow_kernel<Load, kExtremum, kVec><<<blocks, kWarp * kWarpsPerBlock, 0, st>>>(
      ld, ptr, V, Q, log_l, log_g, neutral, is_min, out, mch_out);
}

template <class Load, bool kExtremum>
int launch_cols(const Load& ld, const int* ptr, int V, int Q, int C, int vec, int G,
                float neutral, bool is_min, float* out, float* mch_out, cudaStream_t st) {
  if (narrow(C, vec)) {
    const int log_l = log2_exact(C / vec), log_g = log2_exact(G);
    if (log_g < 0 || log_l + log_g > 5) return (int)cudaErrorInvalidValue;
    if (vec == 4)
      launch_narrow<Load, kExtremum, 4>(ld, ptr, V, Q, log_l, log_g, neutral, is_min, out,
                                        mch_out, st);
    else
      launch_narrow<Load, kExtremum, 1>(ld, ptr, V, Q, log_l, log_g, neutral, is_min, out,
                                        mch_out, st);
  } else {
    dim3 block(wide_threads(C)), grid(V, Q);
    wide_kernel<Load, kExtremum><<<grid, block, 0, st>>>(ld, ptr, V, C, neutral, is_min, out,
                                                         mch_out);
  }
  return (int)cudaGetLastError();
}

template <int kRows>
void launch_interval_warp(const IntervalArgs& a, int Q, bool ext, cudaStream_t st) {
  dim3 grid((a.V + kWarpsPerBlock - 1) / kWarpsPerBlock, Q);
  const int threads = kWarp * kWarpsPerBlock;
  if (ext)
    interval_warp_kernel<kRows, true><<<grid, threads, 0, st>>>(a);
  else
    interval_warp_kernel<kRows, false><<<grid, threads, 0, st>>>(a);
}

}  // namespace

extern "C" {

// B1.  state element (q, s, c) at state[q * sq + s * rs + c] (s < n_rows;
// s == n_rows is the zero row), src [E], w [Q, E, C] (q-stride wq, 0 when
// shared), ptr [V+1]; optional extremum channel, element (q, s) at
// mch[q * mq + s * mrs] -> mch_out [Q, V].  Narrow path (C = vec * 2^k <=
// 32 * vec): vec columns a lane (1, or 4 on 16-byte aligned rows), G edge
// slots per destination (a power of two, G * C / vec <= 32).
int hop_fused_cols(const float* state, long long sq, long long rs, int n_rows, int C,
                   const int* src, const float* w, long long wq, const int* ptr, int V, int Q,
                   int vec, int G, const float* mch, long long mq, long long mrs, float neutral,
                   int op_is_min, float* out, float* mch_out, void* stream) {
  GatherLoad ld{state, sq, rs, n_rows, src, w, wq, mch, mq, mrs, C};
  cudaStream_t st = (cudaStream_t)stream;
  if (mch != nullptr)
    return launch_cols<GatherLoad, true>(ld, ptr, V, Q, C, vec, G, neutral, op_is_min != 0, out,
                                         mch_out, st);
  return launch_cols<GatherLoad, false>(ld, ptr, V, Q, C, vec, G, neutral, op_is_min != 0, out,
                                        mch_out, st);
}

// B2.  state [Q, n_rows, B*(B+1)], w/sb/eb [Q, E] (q-strides), ptr [V+1].
int hop_fused_interval(const float* state, long long sq, int n_rows, int B, const int* src,
                       const float* w, long long wq, const int* sb, long long sbq,
                       const int* eb, long long ebq, const int* ptr, int V, int Q,
                       const float* mch, long long mq, float neutral, int op_is_min,
                       float* out, float* mch_out, void* stream) {
  const IntervalArgs a{state, sq, n_rows, B, src, w, wq, sb, sbq, eb, ebq, ptr, V,
                       mch, mq, neutral, op_is_min != 0, out, mch_out};
  const bool ext = mch != nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (B + 1 <= kWarp) {
    if (B <= 16)
      launch_interval_warp<16>(a, Q, ext, st);
    else
      launch_interval_warp<31>(a, Q, ext, st);
    return (int)cudaGetLastError();
  }
  const int NC = B * (B + 1);
  const int T = wide_threads(NC);
  const size_t smem = (3 * (size_t)NC + kWarp) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = ext ? cudaFuncSetAttribute(interval_block_kernel<true>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem)
                          : cudaFuncSetAttribute(interval_block_kernel<false>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(V, Q);
  if (ext)
    interval_block_kernel<true><<<grid, T, smem, st>>>(a);
  else
    interval_block_kernel<false><<<grid, T, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// B3.  contrib [Q, E, C] (q-stride cq), ptr [V+1] -> out [Q, V, C]; the
// launch parameters as B1's.
int hop_scatter_cols(const float* contrib, long long cq, int C, const int* ptr, int V, int Q,
                     int vec, int G, float* out, void* stream) {
  ContribLoad ld{contrib, cq, C};
  return launch_cols<ContribLoad, false>(ld, ptr, V, Q, C, vec, G, 0.0f, true, out, nullptr,
                                         (cudaStream_t)stream);
}

// B4.  m_e, alive [Q, E] (q-strides), ptr [V+1] -> out [Q, V].
int hop_scatter_extremum(const float* m_e, long long mq, const float* alive, long long aq,
                         const int* ptr, int V, int Q, float neutral, int op_is_min,
                         float* out, void* stream) {
  dim3 block(kWarp, kWarpsPerBlock), grid((V + kWarpsPerBlock - 1) / kWarpsPerBlock, Q);
  extremum_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(m_e, mq, alive, aq, ptr, V,
                                                            neutral, op_is_min != 0, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
