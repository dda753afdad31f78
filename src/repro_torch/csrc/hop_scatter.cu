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
// Gated segment min/max (B4), out[q, v] = min or max of m_e[q, e] over v's
// run with alive[q, e] > 0, neutral where none is.  It moves 4 (V + 1 +
// 2 Q E + Q V) bytes and does one compare an edge, so bytes bound it; the
// TPU kernel's VMEM blocks become edge-balanced tiles:
//   * A block takes a tile of 1,024 consecutive edges (4 a thread; 8 was
//     slower), whatever the runs are, so hubs, skew and empty runs cost no
//     idle lanes.  A thread loads its K edges' m_e and alive together, as
//     16-byte streaming loads where the wrapper found the query rows 16-byte
//     aligned (else scalars), and selects with the gate: no branch before a
//     load.  The next query's loads are issued before this one is reduced.
//   * The destinations are found once a tile, for every query: a small first
//     kernel finds each tile's first destination by a warp-wide 32-way
//     search of ptr; the tile owns the destinations whose runs start in it,
//     writes neutral for its empty ones and marks the first edge of each of
//     the others in shared memory.  The query axis is a loop inside the
//     block (strides mq and aq), so ptr is read once, not Q times.
//   * Reduction: each thread folds its K edges, then a segmented scan over
//     the block (head flags; __shfl_up_sync in each warp, the 8 warps'
//     totals through shared memory) gives each thread the value of the run
//     it continues, and the thread holding a run's last edge writes it.
//   * A run that lies inside one tile has that one writer and a plain store.
//     Only a run that crosses a tile's edge (at most two a tile) is combined
//     across blocks, with atomicMin / atomicMax on the float's bits: a float
//     with the sign bit clear orders as a signed int, one with it set in
//     reverse as an unsigned int, so no decoding pass is needed.  The first
//     kernel fills those destinations with neutral beforehand, so a call is
//     two launches.  This order puts -0.0 below +0.0, where fminf / fmaxf
//     inside a tile may return either, so a run holding both zeros may give
//     either sign (the plain version's scatter_reduce_ does not fix it
//     either).  NaN is left out: the engine's channels are integer-valued
//     property columns and +-inf, and a NaN would order by its bits here.
//     Min and max do not depend on order, so on those values the result is
//     the plain version's, bit for bit.
//
// Sums of per-edge counts are exact in float32 while they stay below 2^24
// (the engine's invariant), so the summation order of these kernels gives
// the same bits as the plain versions'; above 2^24 it may not.  B1-B3 use no
// atomics: every output has one writer, and the order of its sum is fixed.
// Each entry point launches on the given stream, allocates nothing, does not
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

// ---------------------------------------------------------------- B4
// Segment min/max of a per-edge channel gated by alive > 0, over tiles of
// kExtThreads * kExtEdges consecutive edges (see the header).
constexpr int kExtThreads = 256;
constexpr int kExtWarps = kExtThreads / kWarp;
constexpr int kExtEdges = 4;                       // edges a thread
constexpr int kExtTile = kExtThreads * kExtEdges;  // edges a tile

// The first i in [0, n) with a[i] >= key, or n: each round the warp's lanes
// probe 32 evenly spaced entries and a ballot keeps the gap the answer lies
// in, so 1,380,000 entries take 6 rounds of one load.  Every lane takes part.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a, int n, long long key) {
  const int lane = threadIdx.x % kWarp;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + kWarp - 1) / kWarp;
    const int p = lo + lane * step;  // clamped: a hoisted load stays inside a
    const unsigned ge = __ballot_sync(kFull, p >= hi || __ldg(a + min(p, hi - 1)) >= key);
    if (ge == 0) {
      lo += (kWarp - 1) * step + 1;
    } else {
      const int f = __ffs(ge) - 1;
      hi = min(hi, lo + f * step);
      if (f > 0) lo += (f - 1) * step + 1;
      else hi = lo;
    }
  }
  return lo;
}

// *p = min or max(*p, x) for x and *p not NaN.  With the sign bit clear a
// float's bits order as a signed int, and every such float lies above every
// float with it set; with it set they order in reverse as an unsigned int.
// So a positive x (or +0.0) goes through the signed-int atomic and a
// negative one (or -0.0) through the unsigned one, in place, with no
// decoding: this order puts -0.0 just below +0.0.
template <bool kMin>
__device__ __forceinline__ void atomic_fold(float* p, float x) {
  const bool neg = __float_as_int(x) < 0;
  if (kMin) {
    if (neg) atomicMax(reinterpret_cast<unsigned*>(p), __float_as_uint(x));
    else atomicMin(reinterpret_cast<int*>(p), __float_as_int(x));
  } else {
    if (neg) atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(x));
    else atomicMax(reinterpret_cast<int*>(p), __float_as_int(x));
  }
}

template <bool kMin>
__device__ __forceinline__ float fold2(float a, float b) {
  return kMin ? fminf(a, b) : fmaxf(a, b);
}

// One load of a query row: streaming (evict first) where each query has its
// own row, the read-only path where every query shares it.  Volatile asm: the
// compiler may hoist the header intrinsics (__ldcs, __ldg: asm that is not
// volatile) above the branch that guards them, and a thread past the last
// edge (or an empty channel, whose pointer may be null) would then read off
// the end of its row.
__device__ __forceinline__ float4 ld_row4(const float* p, bool own) {
  float4 r;
  if (own)
    asm volatile("ld.global.cs.v4.f32 {%0,%1,%2,%3}, [%4];"
                 : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w) : "l"(p));
  else
    asm volatile("ld.global.nc.v4.f32 {%0,%1,%2,%3}, [%4];"
                 : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w) : "l"(p));
  return r;
}

__device__ __forceinline__ float ld_row(const float* p, bool own) {
  float r;
  if (own)
    asm volatile("ld.global.cs.f32 %0, [%1];" : "=f"(r) : "l"(p));
  else
    asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(r) : "l"(p));
  return r;
}

// K consecutive edges of one query row (m and alive), as 16-byte loads where
// the rows are aligned (kVec) and the thread's edges are all real (rem, the
// edges left from the first to the tile's end, >= K), else as scalars; edges
// past rem read as dead.  rem is compared as it is: with the count clamped
// to [0, K] and compared with K, nvcc 12 for sm_90a branched on the predicate
// of a fused min/max (VIMNMX.RELU) and took the 16-byte loads for the
// threads with fewer than K edges, and the scalar ones for full threads (an
// empty, null channel then faulted).
template <int K, bool kVec>
__device__ __forceinline__ void load_edges(const float* m_row, const float* a_row, bool m_own,
                                           bool a_own, int rem, float (&m)[K], float (&a)[K]) {
  if (kVec && rem >= K) {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      const float4 x = ld_row4(m_row + 4 * j, m_own);
      const float4 y = ld_row4(a_row + 4 * j, a_own);
      m[4 * j] = x.x; m[4 * j + 1] = x.y; m[4 * j + 2] = x.z; m[4 * j + 3] = x.w;
      a[4 * j] = y.x; a[4 * j + 1] = y.y; a[4 * j + 2] = y.z; a[4 * j + 3] = y.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      m[i] = 0.0f;
      a[i] = 0.0f;
      if (i < rem) {
        m[i] = ld_row(m_row + i, m_own);
        a[i] = ld_row(a_row + i, a_own);
      }
    }
  }
}

// First kernel: tile_lo[t] = the first destination whose run starts at or
// after edge t * tile (t = 0 .. n_tiles; the last is V), one warp a tile, and
// neutral into every destination whose run crosses the tile's first edge:
// the main kernel combines those with atomics.
__global__ void __launch_bounds__(kExtThreads)
extremum_seed_kernel(const int* __restrict__ ptr, int V, int E, int Q, int n_tiles, float neutral,
                     int* __restrict__ tile_lo, float* __restrict__ out) {
  const int t = blockIdx.x * kExtWarps + threadIdx.x / kWarp;
  if (t > n_tiles) return;  // a whole warp leaves: t is the warp's
  const long long b = (long long)t * kExtTile;
  const int v = warp_lower_bound(ptr, V, b);
  const int lane = threadIdx.x % kWarp;
  if (lane == 0) tile_lo[t] = v;
  // the run holding edge b began before it: destination v - 1 (ptr[0] = 0)
  if (b > 0 && b < E && __ldg(ptr + v) > b)
    for (int q = lane; q < Q; q += kWarp) out[(long long)q * V + v - 1] = neutral;
}

template <bool kVec, bool kMin>
__global__ void __launch_bounds__(kExtThreads)
extremum_kernel(const float* __restrict__ m_e, long long mq, const float* __restrict__ alive,
                long long aq, const int* __restrict__ ptr, const int* __restrict__ tile_lo,
                int V, int E, int Q, float neutral, float* __restrict__ out) {
  constexpr int K = kExtEdges, T = kExtTile;
  __shared__ int head_v[T];               // destination whose run starts at tile edge i, or -1
  __shared__ int s_hp[kExtWarps];         // each warp's last run start
  __shared__ float s_val[2][kExtWarps];   // each warp's segmented total (by query parity)
  __shared__ int s_head[2][kExtWarps];    // ... and whether a run starts in the warp
  __shared__ int s_in;                    // the run that crosses into the tile, or -1
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int b0 = blockIdx.x * T;          // the wrapper keeps E + T below 2^31
  const int b1 = min(E, b0 + T);
  const int i0 = tid * K;                 // the thread's first edge, in the tile
  const int e0 = b0 + i0;
  const int rem = b1 - e0;                // edges from its first to the tile's end
  const int nv = min(K, rem);             // its real edges (none when <= 0)
  const bool m_own = mq != 0, a_own = aq != 0;
  float m[K], a[K];
  load_edges<K, kVec>(m_e + e0, alive + e0, m_own, a_own, rem, m, a);  // query 0, in flight

  // ---- the tile's destinations, once for every query
  const int v_lo = __ldg(tile_lo + blockIdx.x), v_hi = __ldg(tile_lo + blockIdx.x + 1);
  for (int i = tid; i < T; i += kExtThreads) head_v[i] = -1;
  if (tid == 0) s_in = b0 < E && __ldg(ptr + v_lo) > b0 ? v_lo - 1 : -1;
  __syncthreads();
  for (int v = v_lo + tid; v < v_hi; v += kExtThreads) {
    const int s = __ldg(ptr + v), e = __ldg(ptr + v + 1);
    if (s < e)
      head_v[s - b0] = v;
    else
      for (int q = 0; q < Q; ++q) out[(long long)q * V + v] = neutral;
  }
  __syncthreads();
  unsigned heads = 0;                     // bit i: a run starts at the thread's edge i
  int hv[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    hv[i] = i < nv ? head_v[i0 + i] : -1;
    if (hv[i] >= 0) heads |= 1u << i;
  }
  // the start of the run the thread's first edge continues: an exclusive
  // max-scan of each thread's last run start over the block
  int hp = heads ? i0 + 31 - __clz(heads) : -1;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int o = __shfl_up_sync(kFull, hp, off);
    if (lane >= off) hp = max(hp, o);
  }
  if (lane == kWarp - 1) s_hp[warp] = hp;
  __syncthreads();
  hp = __shfl_up_sync(kFull, hp, 1);
  if (lane == 0) hp = -1;
  for (int w = 0; w < warp; ++w) hp = max(hp, s_hp[w]);
  // the runs that end at the thread's edges, their destinations, and which
  // of them cross the tile's first or last edge (bit i of cross)
  int dst[K];
  unsigned cross = 0;
  {
    int cur = hp >= 0 ? head_v[hp] : s_in;
    bool cur_in = hp < 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (heads >> i & 1u) {
        cur = hv[i];
        cur_in = false;
      }
      dst[i] = -1;
      if (i < nv) {
        const bool tile_end = e0 + i + 1 == b1;
        const bool ends = i + 1 < nv ? (heads >> (i + 1) & 1u) != 0
                                     : tile_end || head_v[i0 + i + 1] >= 0;
        if (ends && cur >= 0) {
          dst[i] = cur;
          if (cur_in || (tile_end && b1 < E && __ldg(ptr + cur + 1) > b1)) cross |= 1u << i;
        }
      }
    }
  }

  // ---- the queries
  for (int q = 0; q < Q; ++q) {
    float mn[K], an[K];
    if (q + 1 < Q)
      load_edges<K, kVec>(m_e + (q + 1) * mq + e0, alive + (q + 1) * aq + e0, m_own, a_own, rem,
                          mn, an);
    float g[K];
#pragma unroll
    for (int i = 0; i < K; ++i) g[i] = a[i] > 0.0f ? m[i] : neutral;
    // the thread's part of its last run (all of it when no run starts here)
    float v = neutral;
#pragma unroll
    for (int i = 0; i < K; ++i) v = heads >> i & 1u ? g[i] : fold2<kMin>(v, g[i]);
    // segmented inclusive scan over the warp: (head, v) after (head', v') is
    // (head | head', head ? v : fold(v', v))
    int hd = heads != 0;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const float vo = __shfl_up_sync(kFull, v, off);
      const int ho = __shfl_up_sync(kFull, hd, off);
      if (lane >= off) {
        if (!hd) v = fold2<kMin>(vo, v);
        hd |= ho;
      }
    }
    const int buf = q & 1;                // two buffers: one barrier a query
    if (lane == kWarp - 1) {
      s_val[buf][warp] = v;
      s_head[buf][warp] = hd;
    }
    __syncthreads();
    float c = neutral;                    // the run in progress where the thread starts
    for (int w = 0; w < warp; ++w)
      c = s_head[buf][w] ? s_val[buf][w] : fold2<kMin>(c, s_val[buf][w]);
    const float ve = __shfl_up_sync(kFull, v, 1);
    const int he = __shfl_up_sync(kFull, hd, 1);
    if (lane > 0) c = he ? ve : fold2<kMin>(c, ve);
    float* orow = out + (long long)q * V;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      c = heads >> i & 1u ? g[i] : fold2<kMin>(c, g[i]);
      if (dst[i] >= 0) {
        if (cross >> i & 1u)
          atomic_fold<kMin>(orow + dst[i], c);
        else
          orow[dst[i]] = c;
      }
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      m[i] = mn[i];
      a[i] = an[i];
    }
  }
}

template <bool kVec>
void launch_extremum(const float* m_e, long long mq, const float* alive, long long aq,
                     const int* ptr, const int* tile_lo, int V, int E, int Q, float neutral,
                     bool is_min, float* out, int n_tiles, cudaStream_t st) {
  if (is_min)
    extremum_kernel<kVec, true><<<n_tiles, kExtThreads, 0, st>>>(m_e, mq, alive, aq, ptr, tile_lo,
                                                                  V, E, Q, neutral, out);
  else
    extremum_kernel<kVec, false><<<n_tiles, kExtThreads, 0, st>>>(m_e, mq, alive, aq, ptr, tile_lo,
                                                                   V, E, Q, neutral, out);
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

// B4.  m_e, alive [Q, E] (q-strides), ptr [V+1] (ptr[0] = 0, ptr[V] = E)
// -> out [Q, V]; vec 4 where the rows are 16-byte aligned, else 1; tile_lo
// scratch of n_tile_lo ints, at least E / kExtTile + 2 (else
// cudaErrorInvalidValue, and nothing is launched: the caller sized it with
// its own tile size).  Two launches: the seed kernel, then the tiles.
int hop_scatter_extremum(const float* m_e, long long mq, const float* alive, long long aq,
                         const int* ptr, int V, int E, int Q, int vec, float neutral,
                         int op_is_min, int* tile_lo, int n_tile_lo, float* out, void* stream) {
  const int n_tiles = E / kExtTile + 1;  // the last tile also owns the runs that start at E
  if ((vec != 1 && vec != 4) || n_tile_lo < n_tiles + 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  extremum_seed_kernel<<<(n_tiles + kExtWarps) / kExtWarps, kExtThreads, 0, st>>>(
      ptr, V, E, Q, n_tiles, neutral, tile_lo, out);
  if (vec == 4)
    launch_extremum<true>(m_e, mq, alive, aq, ptr, tile_lo, V, E, Q, neutral, op_is_min != 0, out,
                          n_tiles, st);
  else
    launch_extremum<false>(m_e, mq, alive, aq, ptr, tile_lo, V, E, Q, neutral, op_is_min != 0, out,
                           n_tiles, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
