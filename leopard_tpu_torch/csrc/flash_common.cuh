// Pieces shared by the flash-attention forward (flash_attention.cu, K1) and
// backward (flash_attention_bwd.cu, K2): bf16 tensor-core products with
// mma.sync.m16n8k16, guarded row loads, the mask of one (q, kv) pair, and the
// tile-skip predicate. Keeping one copy keeps the forward and the backward in
// step: a tile the forward skipped must be skipped by the backward, and a
// pair the forward masked must be masked by the backward.
//
// m16n8k16 fragment layouts (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = (row g, cols 2t..2t+1), a1 = (row g+8, same),
//                         a2 = (row g, cols 2t+8..2t+9), a3 = (row g+8, same);
//   B (16x8, col): b0 = (k rows 2t..2t+1, col g), b1 = (k rows 2t+8..2t+9);
//   C (16x8 fp32): c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, same).
// So a 16 x 64 accumulator tile (8 n-tiles) is, register for register, the
// A operand of a product over its 64 columns (4 k-steps): `acc_to_a` packs it.
// A B operand whose k dim is contiguous in shared memory (K rows for Q K^T,
// or a transposed tile) loads as two 32-bit words per thread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace leopard_flash {

typedef __nv_bfloat16 bf16;

// no real score is that low; masked scores and empty rows use it, never -inf
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of the 16 rows r0 = 16 * warp + g (and r0 + 8) for k-step ks of
// a row-major shared tile with row stride ld
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int r0,
                                       int ks, int t) {
  const int c = ks * 16 + t * 2;
  a[0] = lds32(&tile[r0 * ld + c]);
  a[1] = lds32(&tile[(r0 + 8) * ld + c]);
  a[2] = lds32(&tile[r0 * ld + c + 8]);
  a[3] = lds32(&tile[(r0 + 8) * ld + c + 8]);
}

// c[n] += A B for the warp's 16 rows and N8 n-tiles of 8 columns, over KS
// k-steps of 16: A row-major (rows r0, r0 + 8), B stored as B^T row-major
// (row = output column, contiguous k), both in shared memory
template <int KS, int N8>
__device__ __forceinline__ void mma_tile(float (&c)[N8][4], const bf16* a_tile, int lda,
                                         const bf16* bt_tile, int ldb, int r0, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    load_a(a, a_tile, lda, r0, ks, t);
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const bf16* br = &bt_tile[(n * 8 + g) * ldb + ks * 16 + t * 2];
      mma_bf16(c[n], a, lds32(br), lds32(br + 8));
    }
  }
}

// c[n] += A B with A given as fragments (an accumulator tile packed by
// acc_to_a) and B^T row-major in shared memory
template <int KS, int N8>
__device__ __forceinline__ void mma_frag(float (&c)[N8][4], const uint32_t (&a)[KS][4],
                                         const bf16* bt_tile, int ldb, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const bf16* br = &bt_tile[(n * 8 + g) * ldb + ks * 16 + t * 2];
      mma_bf16(c[n], a[ks], lds32(br), lds32(br + 8));
    }
  }
}

// 16 x (8 * N8) fp32 accumulators → bf16 A fragments over N8 / 2 k-steps:
// n-tile 2kk gives A columns 0..7 (regs 0, 1), 2kk + 1 columns 8..15 (2, 3)
template <int N8>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N8 / 2][4], const float (&c)[N8][4]) {
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    a[n / 2][(n % 2) * 2 + 0] = pack_bf16(c[n][0], c[n][1]);
    a[n / 2][(n % 2) * 2 + 1] = pack_bf16(c[n][2], c[n][3]);
  }
}

// Copy 8 consecutive head-dim elements of one row (dims c8..c8+7) into dst,
// zero past D and for rows outside the tensor.
template <int D>
__device__ __forceinline__ void load8(bf16 (&dst)[8], const bf16* row, int c8, bool in, int vec) {
  if (in && c8 + 8 <= D && vec) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(row + c8);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dst[i] = (in && c8 + i < D) ? row[c8 + i] : __float2bfloat16(0.f);
}

// Whether query qi attends key kj: kj inside the kv sequence, the same
// non-zero segment (when segments are given; qs/ks are the two ids), causal
// (qi >= kj) and within the sliding window (qi - kj < window; window <= 0 is
// none). CHECK_Q also requires qi inside the q sequence: the backward needs
// it, the forward never stores a row past the end. The two forms compile
// differently, each the faster one for its kernel (no spill in the forward).
template <bool CHECK_Q>
__device__ __forceinline__ bool attends(int qi, int kj, int sq, int skv, bool has_seg, int qs,
                                        int ks, int causal, int window) {
  bool ok = (CHECK_Q ? qi < sq : true) && kj < skv;
  if (has_seg) ok = ok && qs != 0 && qs == ks;
  if (causal) ok = ok && qi >= kj;
  if (window > 0) ok = ok && qi - kj < window;
  return ok;
}

// Whether the tile of q rows [q0, q0 + bq) and kv rows [k0, k0 + bk) holds
// any pair the causal and window masks let through: the TPU kernels'
// _should_run (ops/pallas/flash_attention.py:336-343).
__device__ __forceinline__ bool tile_runs(int q0, int bq, int k0, int bk, int causal,
                                          int window) {
  bool run = true;
  if (causal) run = q0 + bq - 1 >= k0;
  if (window > 0) run = run && k0 + bk - 1 > q0 - window;
  return run;
}

}  // namespace leopard_flash
