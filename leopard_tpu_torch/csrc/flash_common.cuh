// Pieces shared by the flash-attention forward (flash_attention.cu, K1) and
// backward (flash_attention_bwd.cu, K2) on Hopper: the tile sizes, the
// shared-memory layout of a head-dim tile, its TMA tensor maps and loads,
// wgmma descriptors and products, and the mask of one (q, kv) pair
// (mbarriers and the map encoder come from tma_common.cuh, which the int4
// matmul shares). Keeping one copy keeps the forward and the backward in step: a pair
// the forward masked must be masked by the backward, and both read the same
// tile ranges (ops/flash_attention.py::tile_ranges).
//
// Head-dim tiles. A tile of R rows of one head lives in shared memory as
// column chunks, each written by one TMA load of a rank-4 tensor map over
// the [B, S, H, D] tensor ((D, H, S, B) innermost first, so a ragged S tail
// is filled with zeros inside its batch row):
//   - 64-column chunks (128 bytes a row) with the 128-byte swizzle;
//   - a 16-column tail chunk (32 bytes a row) with the 32-byte swizzle where
//     D is not a multiple of 64: columns 64..79 at D = 72 (TMA fills 72..79
//     with zeros), columns 0..15 at D = 16.
// So D = 16, 64, 72, 128 are 0+1, 1+0, 1+1, 2+0 chunks + tail, and the
// padded width DP is 16, 64, 80, 128.
//
// wgmma operands (sm_90a). A chunk is read two ways through descriptors:
//   - K-major (the head dim is the product's k dim: Q K^T, K Q^T, dO V^T):
//     8-row groups 1,024 bytes apart (256 with the 32-byte swizzle), a k16
//     step advances 32 bytes inside the 128-byte row;
//   - MN-major (the head dim is the output's n dim: P V, dS K, P^T dO,
//     dS^T Q): the transpose bit set, 16 rows of the tile per k16 step; one
//     instruction spans one chunk (n64, or n16 for the tail), so the
//     descriptor's leading offset (next chunk) is never walked.
// The fp32 accumulator of m64nNk16 gives thread (warp w, lane = 4g + t)
// rows 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1 of every
// n8 block j: d[4j + 0..3] = (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// Per 16 columns that is the register A operand of the next product, so
// P and dS go from one product to the next without shared memory.

#pragma once

#include <cuda_bf16.h>

#include "tma_common.cuh"  // shared memory, mbarriers, TMA, the map encoder

namespace leopard_flash {

using namespace leopard_tma;

typedef __nv_bfloat16 bf16;

// no real score is that low; masked scores and empty rows use it, never -inf
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Rows per block, stated once on each side (ops/flash_attention.py TILE,
// UID_BLOCK) and checked by the entry points: a forward or dq block holds
// kTile q rows, a dk/dv block kTile kv rows, and the tile ranges are per
// kTile rows; each consumer warpgroup owns kUid rows, the granularity of
// the per-block segment ids.
constexpr int kTile = 128;
constexpr int kUid = 64;
constexpr int kStages = 3;   // TMA ring depth
constexpr int kThreads = 384;  // two consumer warpgroups, then the producer's

template <int D>
struct HeadDim {
  static_assert(D == 16 || D == 64 || D == 72 || D == 128, "head dim");
  static constexpr int kChunks = D / 64;        // 64-column chunks
  static constexpr bool kTail = D % 64 != 0;    // a 16-column chunk after them
  static constexpr int DP = kChunks * 64 + (kTail ? 16 : 0);
  static constexpr int KS = DP / 16;            // k16 steps over the head dim
  // bytes of an R-row tile
  static constexpr int bytes(int rows) { return rows * DP * 2; }
};

// The consumer warpgroup of this thread, as a value the compiler knows to be
// the same across the warp (so branches on it do not split a warpgroup)
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// The block's (tile, head, batch row) in a 1-D grid of n_tiles x n_heads x
// batch blocks. With longest_first (causal q tiles, whose work grows with
// the index) every head and row runs its last tile first, so the launch
// ends on short blocks; otherwise a head's tiles run side by side, so that
// the kv (or q) tiles they all read come from L2 and not device memory.
struct BlockCoords {
  int tile, head, batch;
};
__device__ __forceinline__ BlockCoords block_coords(int n_tiles, int n_heads, bool longest_first) {
  const int id = blockIdx.x;
  if (longest_first) {
    const int per_tile = gridDim.x / n_tiles;  // n_heads x batch
    return {n_tiles - 1 - id / per_tile, (id % per_tile) % n_heads, (id % per_tile) / n_heads};
  }
  return {id % n_tiles, (id / n_tiles) % n_heads, id / (n_tiles * n_heads)};
}

// --------------------------------------------------------------------- TMA

// Load one box of a rank-4 map at (col, head, row, batch) into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

// Load `rows` rows from `row` of one head into an R-row tile: every chunk.
// maps[0] has 64-column boxes (128-byte swizzle), maps[1] 16-column boxes
// (32-byte swizzle); both have R-row boxes.
template <int D, int R>
__device__ __forceinline__ void tma_load_tile(unsigned char* tile, const CUtensorMap* maps,
                                              uint64_t* bar, int head, int row, int batch) {
  using HD = HeadDim<D>;
#pragma unroll
  for (int c = 0; c < HD::kChunks; ++c)
    tma_load(tile + c * R * 128, &maps[0], bar, c * 64, head, row, batch);
  if (HD::kTail) tma_load(tile + HD::kChunks * R * 128, &maps[1], bar, HD::kChunks * 64, head, row, batch);
}

// ------------------------------------------------------------------- wgmma

// layout types of the descriptor (bits 62-63)
constexpr uint64_t kSwizzle128 = 1, kSwizzle32 = 3;

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint64_t layout, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | layout << 62;
}

// K-major operand: rows [row, row + 64 or N) of an R-row tile, k16 step ks
// over the head dim
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row, int ks) {
  using HD = HeadDim<D>;
  if (ks < HD::kChunks * 4) {
    const uint32_t a = tile + (ks / 4) * R * 128 + row * 128 + (ks % 4) * 32;
    return make_desc(a, kSwizzle128, 16, 1024);
  }
  return make_desc(tile + HD::kChunks * R * 128 + row * 32, kSwizzle32, 16, 256);
}

// MN-major operand: chunk c of the head dim as n, rows [16 ks, 16 ks + 16)
// of an R-row tile as k
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int c, int ks) {
  using HD = HeadDim<D>;
  if (c < HD::kChunks) return make_desc(tile + c * R * 128 + ks * 2048, kSwizzle128, 1024, 1024);
  return make_desc(tile + HD::kChunks * R * 128 + ks * 512, kSwizzle32, 256, 256);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define LF_R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define LF_R8(i) LF_R4(i), LF_R4(i + 4)
#define LF_R16(i) LF_R8(i), LF_R8(i + 8)
#define LF_R32(i) LF_R16(i), LF_R16(i + 16)
#define LF_R64(i) LF_R32(i), LF_R32(i + 32)

// d (64 x 128 fp32) (+)= A (64 x 16, smem, K-major) B^T (128 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : LF_R64(0)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64 fp32) (+)= A (64 x 16, smem, K-major) B^T (64 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : LF_R32(0)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64 fp32) += A (64 x 16, registers) B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : LF_R32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16 fp32) += A (64 x 16, registers) B (16 x 16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : LF_R8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef LF_R4
#undef LF_R8
#undef LF_R16
#undef LF_R32
#undef LF_R64

// S (64 x N) = A (64 rows of an RA-row tile from row `row`) B^T (an N-row
// tile), both K-major over the head dim; N = 128 or 64
template <int D, int RA, int N>
__device__ __forceinline__ void product_k(float (&s)[N / 2], uint32_t a_tile, int row,
                                          uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < HeadDim<D>::KS; ++ks) {
    const uint64_t a = desc_k<D, RA>(a_tile, row, ks), b = desc_k<D, N>(b_tile, 0, ks);
    if constexpr (N == 128)
      wgmma_ss_n128(s, a, b, ks > 0);
    else
      wgmma_ss_n64(s, a, b, ks > 0);
  }
}

// Accumulators of a 64 x D result in head-dim chunks: main[c] for the
// 64-column chunks, tail for the 16-column one.
template <int D>
struct HeadAcc {
  float main[HeadDim<D>::kChunks > 0 ? HeadDim<D>::kChunks : 1][32];
  float tail[8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < HeadDim<D>::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) main[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tail[i] = 0.f;
  }
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int c = 0; c < HeadDim<D>::kChunks; ++c) fence_regs(main[c]);
    if (HeadDim<D>::kTail) fence_regs(tail);
  }
  // rows g (r = 0) and g + 8 (r = 1) times f[r]
  __device__ __forceinline__ void scale_rows(const float (&f)[2]) {
#pragma unroll
    for (int c = 0; c < HeadDim<D>::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) main[c][i] *= f[(i >> 1) & 1];
    if (HeadDim<D>::kTail) {
#pragma unroll
      for (int i = 0; i < 8; ++i) tail[i] *= f[(i >> 1) & 1];
    }
  }
  // += P (64 x 16 KS2, register A fragments) B (16 KS2 rows of an R-row
  // tile, MN-major)
  template <int R, int KS2>
  __device__ __forceinline__ void product_mn(const uint32_t (&p)[KS2][4], uint32_t b_tile) {
#pragma unroll
    for (int ks = 0; ks < KS2; ++ks) {
#pragma unroll
      for (int c = 0; c < HeadDim<D>::kChunks; ++c)
        wgmma_rs_n64(main[c], p[ks], desc_mn<D, R>(b_tile, c, ks));
      if (HeadDim<D>::kTail)
        wgmma_rs_n16(tail, p[ks], desc_mn<D, R>(b_tile, HeadDim<D>::kChunks, ks));
    }
  }
  // Write rows g and g + 8 (r = 0, 1) as bf16 times f[r], those with
  // in[r]; `rows[r]` points at each row's first element.
  __device__ __forceinline__ void store(bf16* const (&rows)[2], const bool (&in)[2],
                                        const float (&f)[2], int t) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!in[r]) continue;
#pragma unroll
      for (int c = 0; c < HeadDim<D>::kChunks; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(rows[r] + c * 64 + 8 * j + 2 * t) =
              __floats2bfloat162_rn(main[c][4 * j + 2 * r] * f[r], main[c][4 * j + 2 * r + 1] * f[r]);
      if (HeadDim<D>::kTail) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = HeadDim<D>::kChunks * 64 + 8 * j + 2 * t;
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(rows[r] + col) =
                __floats2bfloat162_rn(tail[4 * j + 2 * r] * f[r], tail[4 * j + 2 * r + 1] * f[r]);
        }
      }
    }
  }
};

// 2^x on the special-function unit in one instruction (inputs far below
// -126 flush to 0, which a masked score of -1e30 needs)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 x N fp32 accumulators -> bf16 A fragments over N / 16 k16 steps
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 2]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[k][i] = pack_bf16(c[8 * k + 2 * i], c[8 * k + 2 * i + 1]);
}

// Whether query qi attends key kj: both inside their sequences, the same
// non-zero segment (when segments are given; qs/ks are the two ids), causal
// (qi + offset >= kj) and within the sliding window (qi + offset - kj <
// window; window <= 0 is none). `offset` is the q - kv offset of a block of
// a longer sequence (a ring block: q row i sits at position i + offset
// counted from kv row 0); 0 everywhere else.
__device__ __forceinline__ bool attends(int qi, int kj, int sq, int skv, bool has_seg, int qs,
                                        int ks, int causal, int window, int offset) {
  bool ok = qi < sq && kj < skv;
  if (has_seg) ok = ok && qs != 0 && qs == ks;
  const int qp = qi + offset;
  if (causal) ok = ok && qp >= kj;
  if (window > 0) ok = ok && qp - kj < window;
  return ok;
}

// Whether a tile of q rows [q0, q0 + nq) and kv rows [k0, k0 + nk) needs
// the per-element mask: it crosses the end of either sequence, the causal
// diagonal or the window's edge (both shifted by the q - kv offset), or its
// rows are not all of one segment (uniform: every kUid-row block of both
// sides carries the same non-zero id, read from the per-block ids; -1 marks
// a mixed or padding block).
__device__ __forceinline__ bool needs_mask(int q0, int nq, int k0, int nk, int sq, int skv,
                                           int causal, int window, int offset, bool has_seg,
                                           bool uniform) {
  return q0 + nq > sq || k0 + nk > skv || (causal && k0 + nk - 1 > q0 + offset) ||
         (window > 0 && q0 + offset + nq - 1 - k0 >= window) || (has_seg && !uniform);
}

// ------------------------------------------------------------ host: maps

// The two maps of a bf16 [B, S, H, D] tensor (element strides sb, ss, sh;
// unit D stride) for R-row tiles: maps[0] 64-column boxes with the 128-byte
// swizzle, maps[1] 16-column boxes with the 32-byte swizzle. Each is made
// only where the head dim has such chunks. The base must be 16-byte aligned
// and every stride a multiple of 8 elements (the wrapper copies otherwise).
template <int D>
cudaError_t make_maps(CUtensorMap (&maps)[2], const void* base, int B, int S, int H, long long sb,
                      long long ss, long long sh, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int m = 0; m < 2; ++m) {
    if (m == 0 ? HeadDim<D>::kChunks == 0 : !HeadDim<D>::kTail) continue;
    const cuuint32_t box[4] = {m == 0 ? 64u : 16u, 1u, (cuuint32_t)rows, 1u};
    CUresult r = encode(&maps[m], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        m == 0 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace leopard_flash
