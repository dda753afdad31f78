// Hopper tensor-core kernel of GQA attention's prefill: bf16, causal mask,
// sliding window, q_offset.  wgmma for both products, TMA for every load.
//
// Replaces flash_attention_pallas (B7) of the reference package
// (src/repro/kernels/flash_attention/flash_attention.py) on the calls that
// ops.attention_route sends here: bfloat16, d_head 64, 128 or 256, and more
// than 16 query rows per kv head (every prefill of the LM).  Float32 calls,
// other head widths and decode go to flash_attention.cu and
// flash_decode.cu.
//
// What it computes: as flash_attention.cu.  For query head h of batch b,
// row i at absolute position pos = q_offset + i, the softmax over the keys
// j of kv head h / (Hq / Hkv) it sees (j < Sk; j <= pos if causal; j > pos -
// window if windowed) of scale * q . k_j, applied to v.  Scores, the
// running max m, the running sum l and the accumulator are float32; the
// output is acc / max(l, 1e-30) in bf16.  A row that sees no key gives 0.
//
// What bounds it on an H100: operations.  4 * D flops per visible
// query-key pair; one gemma3-4b global prefill (8 x 2048 tokens, 8 q heads,
// d_head 256, causal) is 137 GFLOP against 0.13 GB of q, k, v and output,
// about 1,000 flops a byte, far above the 295 at which the bf16 tensor
// cores (989 TFLOP/s) and not HBM set the pace.  So both products run on
// the tensor cores (wgmma) and the loads are TMA's.
//
// Design (the shape of FlashAttention-3 at d_head 256):
//   * A block of three warpgroups per (128 query rows, q head, batch): one
//     producer and two consumers of 64 query rows each.  setmaxnreg gives
//     the producer 24 registers and each consumer 240: a consumer holds the
//     64 x D float32 accumulator (D / 2 registers a thread) beside the
//     64 x 64 scores (32).
//   * The producer's one thread loads the q tile once and then K and V tiles
//     of 64 rows through a ring of two stages in shared memory, by TMA with
//     the 128-byte swizzle (a D-wide row is D / 64 column blocks of 128
//     bytes).  mbarriers carry "full" (TMA's byte count) to the consumers
//     and "empty" (all 256 consumer threads arrive) back.  Tensor maps are
//     encoded per call on the host (cuTensorMapEncodeTiled, fetched through
//     cudaGetDriverEntryPoint, so the library does not link libcuda) and
//     passed as __grid_constant__ parameters.  Their outer axes (row, head,
//     batch) are sorted by stride, so q, k and v may be views of [B, S, H,
//     D] projections or of a [L, B, H, S, D] cache.
//   * S = q K^T: D / 16 wgmma m64n64k16 with both operands in shared memory
//     (K-major, 128-byte swizzle).  The online softmax runs on the
//     accumulator's registers in float32 (base 2, scale folded in): a quad
//     of threads shares a row, so the row max takes two shuffles and the
//     row sum none until the end.  The mask is computed from absolute
//     positions, and only on tiles that straddle the diagonal, the window's
//     lower edge or Sk.
//   * O += P V: P is converted to bf16 in registers, where the accumulator's
//     layout is already wgmma's A-fragment layout, and V is read from shared
//     memory as the MN-major B operand (the transpose bit).  P goes as two
//     bf16 parts, hi = bf16(p) and lo = bf16(p - hi), so eight wgmma
//     m64nDk16 a tile: rounding p once (as SDPA and the FlashAttention
//     kernels do) moved the output of rows that see few keys by up to 2^-8
//     on the card, past one bf16 rounding of the output, which is the bound
//     the kernel is held to; the second part costs a third more tensor-core
//     work.
//   * TMA zero-fills rows past Sq and past the keys' end, and those are
//     masked too.  The key maps end at the last key any row may see
//     (min(Sk, q_offset + Sq) when causal), so rows past it (a cache's
//     unwritten tail) are never read.
//   * Key tiles that the causal bound or the window mask for every row of a
//     consumer are skipped (the producer loads the block's union); query
//     tiles run heaviest first.  The output is written from registers to the
//     [B, Sq, Hq, D] storage the wrapper allocates.  Launches on the given
//     stream, allocates nothing, does not synchronise, returns
//     cudaGetLastError().
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <chrono>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kBM = 128;        // query rows a block: 64 a consumer warpgroup
constexpr int kBN = 64;         // key rows a tile
constexpr int kStages = 2;
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kCol = 64;        // bf16 columns in one 128-byte swizzled row

struct Params {
  __nv_bfloat16* o;
  long long osb, osh, oss;
  int Hq, Hkv, Sq, Sk;          // Sk: key rows the maps expose
  float scale_log2;             // scale * log2(e)
  int causal, window, q_offset; // window <= 0: none
  int q_perm, k_perm, v_perm;   // slots of (row, head, batch) among a map's outer axes
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// a [rows][64] bf16 box of a rank-4 map at (col, c1, c2, c3) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// the map's outer coordinates of (row, head, batch): perm holds the slot of
// each in two bits
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int perm, int col, int row, int head, int batch) {
  int c[3];
  c[perm & 3] = row;
  c[(perm >> 2) & 3] = head;
  c[(perm >> 4) & 3] = batch;
  tma_load(dst, map, bar, col, c[0], c[1], c[2]);
}

// wgmma operand descriptor of a 128-byte-swizzled tile: start address, the
// leading and stride byte offsets (16-byte units), layout 1 = SWIZZLE_128B
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// (x, y) as two bf16 pairs, hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - f.x, y - f.y);
}

// ------------------------------------------------- wgmma m64nNk16, bf16 -> f32
// S = q K^T: A (q) and B (K) from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// O += P V: A (P, bf16) from registers, B (V) from shared memory, MN-major
// (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

__device__ __forceinline__ bool visible(const Params& p, int kp, int pos) {
  return kp < p.Sk && (!p.causal || kp <= pos) && (p.window <= 0 || kp > pos - p.window);
}

// shared memory: the q tile, then per stage a K and a V tile, each as D / 64
// column blocks of [rows][64] bf16 (128-byte rows, swizzled), then the
// mbarriers; 1024 bytes of slack align the tiles to the swizzle's atom
template <int D>
struct Smem {
  static constexpr uint32_t kQ = kBM * D * 2;
  static constexpr uint32_t kKV = kBN * D * 2;
  static constexpr uint32_t kQBlock = kBM * 128;
  static constexpr uint32_t kKVBlock = kBN * 128;
  static constexpr uint32_t kBars = kQ + 2 * kStages * kKV;
  static constexpr uint32_t kBytes = 1024 + kBars + 8 * (2 * kStages + 1);
};

// ------------------------------------------------------------- the kernel
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t full = base + L::kBars;       // full[st] at full + 8 st
  const uint32_t empty = full + 8 * kStages;
  const uint32_t qbar = empty + 8 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.Hq / p.Hkv);
  const int nq = min(kBM, p.Sq - q0);
  const int pos_lo = p.q_offset + q0, pos_hi = pos_lo + nq - 1;
  // the key tiles some row of the block may see: [k_begin, k_end)
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, pos_hi + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, pos_lo - p.window + 1);
  k_begin = k_begin / kBN * kBN;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBN - 1) / kBN : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, L::kQ);
      for (int j = 0; j < D / kCol; ++j)
        tma_rows(sQ + j * L::kQBlock, &tq, qbar, p.q_perm, j * kCol, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty + 8 * st, ((t / kStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * st;
        const uint32_t sk = base + L::kQ + st * 2 * L::kKV, sv = sk + L::kKV;
        const int k0 = k_begin + t * kBN;
        mbar_expect_tx(bar, 2 * L::kKV);
        for (int j = 0; j < D / kCol; ++j) {
          tma_rows(sk + j * L::kKVBlock, &tk, bar, p.k_perm, j * kCol, k0, kvh, b);
          tma_rows(sv + j * L::kKVBlock, &tv, bar, p.v_perm, j * kCol, k0, kvh, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = cw * 64 + warp * 16 + lane / 4;   // this thread's rows: r0, r0 + 8
    const int pos0 = p.q_offset + q0 + r0, pos1 = pos0 + 8;
    const int wg_lo = p.q_offset + q0 + cw * 64, wg_hi = wg_lo + 63;
    const bool idle = cw * 64 >= nq;                 // every row past Sq
    const int col = 2 * (lane % 4);
    const uint32_t q_base = sQ + cw * 64 * 128;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    mbar_wait(qbar, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int k0 = k_begin + t * kBN;
      const uint32_t sk = base + L::kQ + st * 2 * L::kKV, sv = sk + L::kKV;
      mbar_wait(full + 8 * st, (t / kStages) & 1);
      const bool skip = idle || (p.causal && k0 > wg_hi) ||
                        (p.window > 0 && k0 + kBN - 1 <= wg_lo - p.window);
      if (!skip) {
        // ---- S = q K^T (64 x 64, float32)
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.0f;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(s, desc(q_base + (kk / 4) * L::kQBlock + (kk % 4) * 32, 16, 1024),
                       desc(sk + (kk / 4) * L::kKVBlock + (kk % 4) * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);

        // ---- online softmax in base 2; s[4j + c] is row r0, key 8j + col + c,
        //      s[4j + 2 + c] row r0 + 8
        const bool mask = k0 + kBN > p.Sk || (p.causal && k0 + kBN - 1 > wg_lo) ||
                          (p.window > 0 && k0 <= wg_hi - p.window);
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x0 = s[4 * j + c] * p.scale_log2, x1 = s[4 * j + 2 + c] * p.scale_log2;
            if (mask) {
              const int kp = k0 + 8 * j + col + c;
              if (!visible(p, kp, pos0)) x0 = -INFINITY;
              if (!visible(p, kp, pos1)) x1 = -INFINITY;
            }
            s[4 * j + c] = x0;
            s[4 * j + 2 + c] = x1;
            mx0 = fmaxf(mx0, x0);
            mx1 = fmaxf(mx1, x1);
          }
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float mu0 = mn0 == -INFINITY ? 0.0f : mn0;   // a row with nothing seen yet
        const float mu1 = mn1 == -INFINITY ? 0.0f : mn1;
        const float a0 = ex2(m0 - mu0), a1 = ex2(m1 - mu1);
        m0 = mn0;
        m1 = mn1;
        float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            s[4 * j + c] = ex2(s[4 * j + c] - mu0);
            s[4 * j + 2 + c] = ex2(s[4 * j + 2 + c] - mu1);
            rs0 += s[4 * j + c];
            rs1 += s[4 * j + 2 + c];
          }
        }
        l0 = l0 * a0 + rs0;      // this thread's part of the row sum
        l1 = l1 * a1 + rs1;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
        // P as wgmma's A fragments, keys 16 kk .. 16 kk + 15, in two bf16
        // parts: p = hi + lo to 2^-17, where hi alone is off by up to 2^-9
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1],
                                                 hi[kk][i], lo[kk][i]);

        // ---- O += P V: V is the MN-major B operand, 16 key rows a step
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv = desc(sv + kk * 16 * 128, L::kKVBlock, 1024);
          wgmma_pv<D>(o, hi[kk], dv);
          wgmma_pv<D>(o, lo[kk], dv);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(o);
      }
      mbar_arrive(empty + 8 * st);
    }

    // ---- out = acc / max(l, 1e-30), the quad's partial sums added
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float i0 = 1.0f / fmaxf(l0, 1e-30f), i1 = 1.0f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* O = p.o + b * p.osb + h * p.osh;
    const int row0 = q0 + r0, row1 = row0 + 8;
    if (row0 < p.Sq) {
      __nv_bfloat16* orow = O + row0 * p.oss + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
    }
    if (row1 < p.Sq) {
      __nv_bfloat16* orow = O + row1 * p.oss + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
  }
}

// ------------------------------------------------------------ tensor maps
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's encoder, fetched once through the runtime (no -lcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                    cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// A rank-4 map of a [B, H, S, D] bf16 view (element strides sb, sh, ss; the
// last axis contiguous) whose box is [rows][64].  The outer axes are sorted
// by stride, an axis of one index last (its stride is then free), so the
// strides rise whatever view the caller hands over; *perm receives the slot
// of (row, head, batch), two bits each.  False where the driver refuses.
bool make_map(CUtensorMap* map, const void* ptr, int D, long long S, long long H, long long B,
              long long ss, long long sh, long long sb, int rows, int* perm) {
  const long long size[3] = {S, H, B};
  const long long stride[3] = {2 * ss, 2 * sh, 2 * sb};
  auto key = [&](int a) { return size[a] == 1 ? (1LL << 62) : stride[a]; };
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && key(order[j]) < key(order[j - 1]); --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 1, 1, 1};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {kCol, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  long long next = 2LL * D;
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    const int a = order[i];
    const long long st = size[a] == 1 ? next : stride[a];
    dims[1 + i] = static_cast<cuuint64_t>(size[a]);
    strides[i] = static_cast<cuuint64_t>(st);
    next = st * size[a];
    if (a == 0) box[1 + i] = static_cast<cuuint32_t>(rows);
    *perm |= i << (2 * a);
  }
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                   strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The three maps of a call.  The key maps end at the last key any row may
// see, so the unwritten rows of a cache are never read; *k_rows receives
// that count.  False where the driver refuses a map.
bool encode_maps(const void* q, const void* k, const void* v,
                 long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss,
                 int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal, int q_offset,
                 CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv, int* k_rows, int perm[3]) {
  long long rows = Sk;
  if (causal) rows = rows < (long long)q_offset + Sq ? rows : (long long)q_offset + Sq;
  if (rows < 0) rows = 0;
  *k_rows = static_cast<int>(rows);
  const long long map_rows = rows > 0 ? rows : 1;
  return make_map(tq, q, D, Sq, Hq, B, qss, qsh, qsb, kBM, &perm[0]) &&
         make_map(tk, k, D, map_rows, Hkv, B, kss, ksh, ksb, kBN, &perm[1]) &&
         make_map(tv, v, D, map_rows, Hkv, B, vss, vsh, vsb, kBN, &perm[2]);
}

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, int B, cudaStream_t stream) {
  constexpr uint32_t smem = Smem<D>::kBytes;
  static const cudaError_t ready = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (ready != cudaSuccess) return ready;
  const dim3 grid((p.Sq + kBM - 1) / kBM, p.Hq, B);
  flash_fwd_tc<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Hq, Sq, D], k and v [B, Hkv, Sk, D], o [B, Hq, Sq, D], all bfloat16,
// each given by its base pointer and its batch, head and row strides in
// elements (the last axis contiguous, base and strides 16-byte aligned).
// D is 64, 128 or 256.  window <= 0 means no window.
int flash_attention_tc_fwd(const void* q, const void* k, const void* v, void* o,
                           long long qsb, long long qsh, long long qss,
                           long long ksb, long long ksh, long long kss,
                           long long vsb, long long vsh, long long vss,
                           long long osb, long long osh, long long oss,
                           int B, int Hq, int Hkv, int Sq, int Sk, int D, float scale,
                           int causal, int window, int q_offset, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (D != 64 && D != 128 && D != 256)) return cudaErrorInvalidValue;
  if (encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  int k_rows = 0, perm[3];
  if (!encode_maps(q, k, v, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, B, Hq, Hkv, Sq, Sk, D,
                   causal, q_offset, &tq, &tk, &tv, &k_rows, perm))
    return cudaErrorInvalidValue;
  const Params p{static_cast<__nv_bfloat16*>(o), osb, osh, oss, Hq, Hkv, Sq, k_rows,
                 scale * 1.4426950408889634f, causal, window, q_offset, perm[0], perm[1], perm[2]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(tq, tk, tv, p, B, st);
    case 128: return launch<128>(tq, tk, tv, p, B, st);
    default: return launch<256>(tq, tk, tv, p, B, st);
  }
}

// Host nanoseconds to encode the three maps of a call on these operands,
// by the code flash_attention_tc_fwd runs for it, the mean of ``iters``;
// -1 where the driver refuses a map.
int flash_attention_tc_encode_ns(const void* q, const void* k, const void* v,
                                 long long qsb, long long qsh, long long qss,
                                 long long ksb, long long ksh, long long kss,
                                 long long vsb, long long vsh, long long vss,
                                 int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                                 int q_offset, int iters) {
  if (encoder() == nullptr || iters <= 0) return -1;
  CUtensorMap tq, tk, tv;
  int k_rows = 0, perm[3];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (!encode_maps(q, k, v, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, B, Hq, Hkv, Sq, Sk,
                     D, causal, q_offset, &tq, &tk, &tv, &k_rows, perm))
      return -1;
  const auto t1 = std::chrono::steady_clock::now();
  return static_cast<int>(std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count() /
                          iters);
}

}  // extern "C"
