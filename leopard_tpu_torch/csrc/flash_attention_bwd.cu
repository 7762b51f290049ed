// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels leopard_tpu/ops/pallas/flash_attention.py
// (_flash_backward with _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel,
// which share _bwd_mask_and_p): FlashAttention-2 gradients of
// O = softmax(scale * Q K^T + mask) V from the forward's per-row logsumexp
// (flash_attention.cu writes it when asked), without the S x S matrices ever
// reaching device memory:
//   P  = exp(scale * Q K^T - lse) where the mask lets the pair through, else 0
//        (a select, never a product, so a fully-masked row's lse of -1e30 is
//        never exponentiated);
//   dP = dO V^T;  delta = rowsum(dO * O), by a small kernel here (fp32);
//   dS = P * (dP - delta) * scale;
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO.
// The pair mask, the mask-or-not test of a tile and the tile ranges are the
// forward's (flash_common.cuh, ops/flash_attention.py::tile_ranges), so a
// pair is in the backward exactly when it was in the forward.
//
// Three launches on the caller's stream:
//   - delta: one warp per (batch, head, q row), [B, Hq, Sq] fp32;
//   - dq: one block per (q head, batch, tile of 128 q rows), looping over
//     the kv rows of the tile's range in tiles of 64; S = Q K^T and
//     dP = dO V^T from shared memory, dQ += dS K with dS in registers and K
//     read MN-major;
//   - dk/dv: one block per (kv head, batch, tile of 128 kv rows), looping
//     over the group's q heads and, for each, the q rows of the kv tile's
//     range in tiles of 64; S^T = K Q^T and dP^T = V dO^T from shared
//     memory, dV += P^T dO and dK += dS^T Q with P^T and dS^T in registers
//     and dO, Q read MN-major. Summing the GQA group in the block replaces
//     the TPU kernel's per-q-head fp32 partials that XLA group-sums
//     (flash_attention.py:538-539).
// No atomics and no partials: the gradients are the same bits on every run.
// Each block is the forward's shape: two consumer warpgroups of 64 rows and
// a producer warpgroup whose one thread streams the tiles through a TMA ring
// of kStages stages with full/empty mbarriers; every product is wgmma. P and
// dS are rounded to bf16 before their products, as the TPU kernel rounds
// them to the operands' dtype; products accumulate in fp32. Rows of a
// skipped tile or range (padding q or kv rows, rows outside every range)
// are written as exact zeros, since dq, dk and dv come from torch.empty.
//
// What bounds it on the H100: operations. 7 products of 2 D flops per
// attended pair and head (Q K^T and dO V^T are computed in both kernels)
// where 5 would do with dQ accumulated across blocks; that form needs
// atomics or partials, so the bits would not repeat.
//
// Layouts: q, out, dO, dQ [B, Sq, Hq, D]; k, v, dK, dV [B, Skv, Hkv, D];
// bf16, read by TMA and written through strides with a unit D stride; lse
// and delta fp32 [B, Hq, Sq] contiguous.

#include "flash_common.cuh"

namespace {

using namespace leopard_flash;

constexpr int BQ = kTile;   // dq kernel: q rows per block
constexpr int BK = 64;      // dq kernel: kv rows per ring stage
constexpr int BK2 = kTile;  // dk/dv kernel: kv rows per block
constexpr int BQ2 = 64;     // dk/dv kernel: q rows per ring stage

struct Params {
  CUtensorMap q[2], k[2], v[2], dout[2];
  const float* lse;
  float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const int* q_seg;
  const int* kv_seg;
  const int* kv_ranges;  // [B or 1, n_qtiles, 2] kv rows per q tile
  const int* q_ranges;   // [B or 1, n_kvtiles, 2] q rows per kv tile
  const int* q_uid;
  const int* kv_uid;
  int Sq, Skv, Hq, group, n_qtiles, n_kvtiles;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  long long qseg_sb, kvseg_sb, kvr_sb, qr_sb, quid_sb, kvuid_sb;
  float scale, scale_log2;
  int causal, window;
};

template <int D>
struct DqSmem {
  static constexpr int Q = HeadDim<D>::bytes(BQ);  // and dO
  static constexpr int KV = HeadDim<D>::bytes(BK);
  static constexpr int STAGE = 2 * KV;
  static constexpr int BARS = 2 * Q + kStages * STAGE;
  static constexpr int total = BARS + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
struct DkvSmem {
  static constexpr int KV = HeadDim<D>::bytes(BK2);  // and V
  static constexpr int Q = HeadDim<D>::bytes(BQ2);   // and dO
  // a stage: Q, dO, then the tile's lse (log2 domain) and delta as fp32,
  // padded to the 128-byte swizzle's 1,024-byte alignment
  static constexpr int STAGE = 2 * Q + 1024;
  static constexpr int BARS = 2 * KV + kStages * STAGE;
  static constexpr int total = BARS + (1 + 2 * kStages) * 8 + 1024;
};

__device__ __forceinline__ void init_barriers(uint64_t* once, uint64_t* full, uint64_t* empty,
                                              int full_count) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// delta[b, h, q] = sum_d dO[b, q, h, d] * O[b, q, h, d] in fp32; one warp a row
__global__ void __launch_bounds__(256) delta_kernel(const bf16* out, const bf16* dout,
                                                    float* delta, int B, int Sq, int Hq, int D,
                                                    long long o_sb, long long o_ss,
                                                    long long o_sh, long long d_sb,
                                                    long long d_ss, long long d_sh) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * Hq * Sq) return;
  const int qi = row % Sq, h = (row / Sq) % Hq, b = row / ((long long)Sq * Hq);
  const bf16* o = out + b * o_sb + qi * o_ss + h * o_sh;
  const bf16* d = dout + b * d_sb + qi * d_ss + h * d_sh;
  float acc = 0.f;
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + c));
    acc += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Whether the kUid-row q block at q0 and kv block at k0 carry one and the
// same segment id on every row (the segment side of needs_mask)
__device__ __forceinline__ bool uniform_pair(const int* q_uid, const int* kv_uid, int q0, int k0,
                                             int sq, int skv) {
  if (q_uid == nullptr || q0 >= sq || k0 >= skv) return false;
  const int u = q_uid[q0 / kUid];
  return u >= 0 && kv_uid[k0 / kUid] == u;
}

template <bool MASK>
__device__ __forceinline__ void dq_tile(float (&s)[BK / 2], float (&dp)[BK / 2], const Params& p,
                                        const int (&qi)[2], const int (&qs)[2],
                                        const float (&lse2)[2], const float (&delta)[2],
                                        const int* kv_seg, int k0, int t) {
  const bool has_seg = kv_seg != nullptr;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    float pr = exp2_fast(s[i] * p.scale_log2 - lse2[r]);
    if (MASK) {
      const int kj = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int ks = has_seg && kj < p.Skv ? __ldg(kv_seg + kj) : 0;
      pr = attends(qi[r], kj, p.Sq, p.Skv, has_seg, qs[r], ks, p.causal, p.window) ? pr : 0.f;
    }
    s[i] = pr * (dp[i] - delta[r]) * p.scale;  // dS
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(const __grid_constant__ Params p) {
  using SM = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + SM::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const BlockCoords at = block_coords(p.n_qtiles, p.Hq, p.causal);
  const int qt = at.tile, h = at.head, b = at.batch, hk = h / p.group;
  const int q0 = qt * BQ;
  const int* range = p.kv_ranges + b * p.kvr_sb + 2 * qt;
  const int lo = range[0], hi = range[1];
  const int k_begin = lo / BK * BK;
  const int n_tiles = hi > lo ? (hi - k_begin + BK - 1) / BK : 0;
  init_barriers(q_full, full, empty, 1);

  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_expect_tx(q_full, 2 * SM::Q);
      tma_load_tile<D, BQ>(sm, p.q, q_full, h, q0, b);
      tma_load_tile<D, BQ>(sm + SM::Q, p.dout, q_full, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* stage = sm + 2 * SM::Q + s * SM::STAGE;
        mbar_expect_tx(&full[s], SM::STAGE);
        tma_load_tile<D, BK>(stage, p.k, &full[s], hk, k_begin + it * BK, b);
        tma_load_tile<D, BK>(stage + SM::KV, p.v, &full[s], hk, k_begin + it * BK, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warpgroup(), tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
  const int qw = q0 + wg * 64;
  const int qi[2] = {qw + warp * 16 + g, qw + warp * 16 + g + 8};
  const bool has_seg = p.q_seg != nullptr;
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
  int qs[2] = {0, 0};
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qi[r] < p.Sq;
    if (has_seg && in) qs[r] = p.q_seg[b * p.qseg_sb + qi[r]];
    lse2[r] = in ? p.lse[row_base + qi[r]] * kLog2e : 0.f;
    delta[r] = in ? p.delta[row_base + qi[r]] : 0.f;
  }
  const int* kv_seg = has_seg ? p.kv_seg + b * p.kvseg_sb : nullptr;
  const int* q_uid = has_seg ? p.q_uid + b * p.quid_sb : nullptr;
  const int* kv_uid = has_seg ? p.kv_uid + b * p.kvuid_sb : nullptr;

  HeadAcc<D> dq;
  dq.zero();
  const uint32_t q_tile = smem_u32(sm), do_tile = q_tile + SM::Q;
  if (n_tiles > 0) mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = k_begin + it * BK;
    const uint32_t k_tile = smem_u32(sm + 2 * SM::Q + s * SM::STAGE);
    const uint32_t v_tile = k_tile + SM::KV;
    mbar_wait(&full[s], (it / kStages) & 1);
    if (qw >= p.Sq) {  // no row of this warpgroup is in the sequence
      if (tw == 0) mbar_arrive(&empty[s]);
      continue;
    }

    float sc[BK / 2], dp[BK / 2];
    wgmma_fence();
    product_k<D, BQ, BK>(sc, q_tile, wg * 64, k_tile);
    product_k<D, BQ, BK>(dp, do_tile, wg * 64, v_tile);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);

    const bool uniform = uniform_pair(q_uid, kv_uid, qw, k0, p.Sq, p.Skv);
    if (needs_mask(qw, 64, k0, BK, p.Sq, p.Skv, p.causal, p.window, has_seg, uniform))
      dq_tile<true>(sc, dp, p, qi, qs, lse2, delta, kv_seg, k0, t);
    else
      dq_tile<false>(sc, dp, p, qi, qs, lse2, delta, kv_seg, k0, t);
    uint32_t ds[BK / 16][4];
    acc_to_a<BK>(ds, sc);

    wgmma_fence();
    dq.template product_mn<BK, BK / 16>(ds, k_tile);
    wgmma_commit();
    wgmma_wait();
    dq.fence();
    fence_regs(ds);
    if (tw == 0) mbar_arrive(&empty[s]);
  }

  bf16* rows[2];
  bool in[2];
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    in[r] = qi[r] < p.Sq;
    rows[r] = p.dq + b * p.dq_sb + (long long)qi[r] * p.dq_ss + h * p.dq_sh;
  }
  dq.store(rows, in, one, t);
}

// P^T and dS^T of one tile, in place of S^T and dP^T: rows are kv rows
// kj[r], columns the q rows q0 + 8 (i / 4) + 2t + (i & 1)
template <bool MASK>
__device__ __forceinline__ void dkv_tile(float (&st)[BQ2 / 2], float (&dpt)[BQ2 / 2],
                                         const Params& p, const int (&kj)[2], const int (&ks)[2],
                                         const float* rows, const int* q_seg, int q0, int t) {
  const bool has_seg = q_seg != nullptr;
#pragma unroll
  for (int i = 0; i < BQ2 / 2; ++i) {
    const int r = (i >> 1) & 1, col = 8 * (i / 4) + 2 * t + (i & 1);
    float pr = exp2_fast(st[i] * p.scale_log2 - rows[col]);  // rows: lse2, then delta
    if (MASK) {
      const int qi = q0 + col;
      const int qs = has_seg && qi < p.Sq ? __ldg(q_seg + qi) : 0;
      pr = attends(qi, kj[r], p.Sq, p.Skv, has_seg, qs, ks[r], p.causal, p.window) ? pr : 0.f;
    }
    st[i] = pr;
    dpt[i] = pr * (dpt[i] - rows[BQ2 + col]) * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(const __grid_constant__ Params p) {
  using SM = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + SM::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  // causal: the first kv tiles see the most q rows, so they start first
  const BlockCoords at = block_coords(p.n_kvtiles, p.Hq / p.group, p.causal);
  const int kt = p.causal ? p.n_kvtiles - 1 - at.tile : at.tile, hk = at.head, b = at.batch;
  const int k0 = kt * BK2;
  const int* range = p.q_ranges + b * p.qr_sb + 2 * kt;
  const int lo = range[0], hi = range[1];
  const int q_begin = lo / BQ2 * BQ2;
  const int per_head = hi > lo ? (hi - q_begin + BQ2 - 1) / BQ2 : 0;
  const int n_tiles = per_head * p.group;
  init_barriers(kv_full, full, empty, 32);  // a stage is full when the producer warp arrived

  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 288 && n_tiles > 0) {  // the producer warp
      const int lane = threadIdx.x - 256;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * SM::KV);
        tma_load_tile<D, BK2>(sm, p.k, kv_full, hk, k0, b);
        tma_load_tile<D, BK2>(sm + SM::KV, p.v, kv_full, hk, k0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int h = hk * p.group + it / per_head;
        const int q0 = q_begin + (it % per_head) * BQ2;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* stage = sm + 2 * SM::KV + s * SM::STAGE;
        if (lane == 0) {
          mbar_add_tx(&full[s], 2 * SM::Q);
          tma_load_tile<D, BQ2>(stage, p.q, &full[s], h, q0, b);
          tma_load_tile<D, BQ2>(stage + SM::Q, p.dout, &full[s], h, q0, b);
        }
        // the q rows' lse (log2 domain) and delta, 0 past the sequence
        float* rows = reinterpret_cast<float*>(stage + 2 * SM::Q);
        const long long base = ((long long)b * p.Hq + h) * p.Sq;
        for (int i = lane; i < BQ2; i += 32) {
          const bool in = q0 + i < p.Sq;
          rows[i] = in ? p.lse[base + q0 + i] * kLog2e : 0.f;
          rows[BQ2 + i] = in ? p.delta[base + q0 + i] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warpgroup(), tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
  const int kw = k0 + wg * 64;
  const int kj[2] = {kw + warp * 16 + g, kw + warp * 16 + g + 8};
  const bool has_seg = p.q_seg != nullptr;
  int ks[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) ks[r] = kj[r] < p.Skv ? p.kv_seg[b * p.kvseg_sb + kj[r]] : 0;
  }
  const int* q_seg = has_seg ? p.q_seg + b * p.qseg_sb : nullptr;
  const int* q_uid = has_seg ? p.q_uid + b * p.quid_sb : nullptr;
  const int* kv_uid = has_seg ? p.kv_uid + b * p.kvuid_sb : nullptr;

  HeadAcc<D> dk, dv;
  dk.zero();
  dv.zero();
  const uint32_t k_tile = smem_u32(sm), v_tile = k_tile + SM::KV;
  if (n_tiles > 0) mbar_wait(kv_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int q0 = q_begin + (it % per_head) * BQ2;
    const uint32_t q_tile = smem_u32(sm + 2 * SM::KV + s * SM::STAGE);
    const uint32_t do_tile = q_tile + SM::Q;
    const float* rows = reinterpret_cast<const float*>(sm + 2 * SM::KV + s * SM::STAGE + 2 * SM::Q);
    mbar_wait(&full[s], (it / kStages) & 1);
    if (kw >= p.Skv) {  // no row of this warpgroup is in the sequence
      if (tw == 0) mbar_arrive(&empty[s]);
      continue;
    }

    float st[BQ2 / 2], dpt[BQ2 / 2];
    wgmma_fence();
    product_k<D, BK2, BQ2>(st, k_tile, wg * 64, q_tile);
    product_k<D, BK2, BQ2>(dpt, v_tile, wg * 64, do_tile);
    wgmma_commit();
    wgmma_wait();
    fence_regs(st);
    fence_regs(dpt);

    const bool uniform = uniform_pair(q_uid, kv_uid, q0, kw, p.Sq, p.Skv);
    if (needs_mask(q0, BQ2, kw, 64, p.Sq, p.Skv, p.causal, p.window, has_seg, uniform))
      dkv_tile<true>(st, dpt, p, kj, ks, rows, q_seg, q0, t);
    else
      dkv_tile<false>(st, dpt, p, kj, ks, rows, q_seg, q0, t);
    uint32_t pa[BQ2 / 16][4], da[BQ2 / 16][4];
    acc_to_a<BQ2>(pa, st);
    acc_to_a<BQ2>(da, dpt);

    wgmma_fence();
    dv.template product_mn<BQ2, BQ2 / 16>(pa, do_tile);
    dk.template product_mn<BQ2, BQ2 / 16>(da, q_tile);
    wgmma_commit();
    wgmma_wait();
    dv.fence();
    dk.fence();
    fence_regs(pa);
    fence_regs(da);
    if (tw == 0) mbar_arrive(&empty[s]);
  }

  const float one[2] = {1.f, 1.f};
  bool in[2];
  bf16* dk_rows[2];
  bf16* dv_rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    in[r] = kj[r] < p.Skv;
    dk_rows[r] = p.dk + b * p.dk_sb + (long long)kj[r] * p.dk_ss + hk * p.dk_sh;
    dv_rows[r] = p.dv + b * p.dv_sb + (long long)kj[r] * p.dv_ss + hk * p.dv_sh;
  }
  dk.store(dk_rows, in, one, t);
  dv.store(dv_rows, in, one, t);
}

template <int D>
cudaError_t launch(Params& p, const void* q, const void* k, const void* v, const void* dout,
                   int B, int Hkv, const long long* st, cudaStream_t stream) {
  // the dq kernel: 128-row Q/dO boxes, 64-row K/V boxes; dk/dv the other way
  Params pq = p;
  cudaError_t err = make_maps<D>(pq.q, q, B, p.Sq, p.Hq, st[0], st[1], st[2], BQ);
  if (err == cudaSuccess) err = make_maps<D>(pq.dout, dout, B, p.Sq, p.Hq, st[12], st[13], st[14], BQ);
  if (err == cudaSuccess) err = make_maps<D>(pq.k, k, B, p.Skv, Hkv, st[3], st[4], st[5], BK);
  if (err == cudaSuccess) err = make_maps<D>(pq.v, v, B, p.Skv, Hkv, st[6], st[7], st[8], BK);
  if (err == cudaSuccess) err = make_maps<D>(p.q, q, B, p.Sq, p.Hq, st[0], st[1], st[2], BQ2);
  if (err == cudaSuccess) err = make_maps<D>(p.dout, dout, B, p.Sq, p.Hq, st[12], st[13], st[14], BQ2);
  if (err == cudaSuccess) err = make_maps<D>(p.k, k, B, p.Skv, Hkv, st[3], st[4], st[5], BK2);
  if (err == cudaSuccess) err = make_maps<D>(p.v, v, B, p.Skv, Hkv, st[6], st[7], st[8], BK2);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqSmem<D>::total);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, DkvSmem<D>::total);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<p.n_qtiles * p.Hq * B, kThreads, DqSmem<D>::total, stream>>>(pq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D><<<p.n_kvtiles * Hkv * B, kThreads, DkvSmem<D>::total, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 tensors whose bases are 16-byte aligned and whose b, s, h strides
// are multiples of 8 elements (what TMA addresses); strides (in elements)
// holds 30 values: q, k, v, out, dout, dq, dk, dv (b, s, h each), then the
// batch strides of q_seg, kv_seg, kv_ranges, q_ranges, q_uid and kv_uid.
// lse is contiguous [B, Hq, Sq] fp32; delta is a [B, Hq, Sq] fp32 buffer
// that this call fills. kv_ranges / q_ranges are tile_ranges' two outputs;
// q_uid / kv_uid the per-64-row segment ids (null with null segments).
// block and uid_block are the caller's tile sizes, checked against the
// kernels'. Returns 0 or a cudaError_t code (cudaErrorInvalidValue for an
// unsupported head dim, head grouping, tile size or layout).
int leopard_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                const void* dout, const float* lse, float* delta, void* dq,
                                void* dk, void* dv, const int* q_seg, const int* kv_seg,
                                const int* kv_ranges, const int* q_ranges, const int* q_uid,
                                const int* kv_uid, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                int block, int uid_block, const long long* strides, float scale,
                                int causal, int window, void* stream) {
  if (block != kTile || uid_block != kUid) return cudaErrorInvalidValue;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0) return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Hq == 0) return cudaSuccess;
  if (D != 16 && D != 64 && D != 72 && D != 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * Hq * Sq;
  delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta, B, Sq, Hq, D,
      strides[9], strides[10], strides[11], strides[12], strides[13], strides[14]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Params p;
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.kv_ranges = kv_ranges;
  p.q_ranges = q_ranges;
  p.q_uid = q_uid;
  p.kv_uid = kv_uid;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.group = Hq / Hkv;
  p.n_qtiles = (Sq + BQ - 1) / BQ;
  p.n_kvtiles = (Skv + BK2 - 1) / BK2;
  long long* dst[15] = {&p.dq_sb, &p.dq_ss, &p.dq_sh, &p.dk_sb, &p.dk_ss,
                        &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh, &p.qseg_sb,
                        &p.kvseg_sb, &p.kvr_sb, &p.qr_sb, &p.quid_sb, &p.kvuid_sb};
  for (int i = 0; i < 15; ++i) *dst[i] = strides[15 + i];
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.window = window;
  switch (D) {
    case 16: return launch<16>(p, q, k, v, dout, B, Hkv, strides, s);
    case 64: return launch<64>(p, q, k, v, dout, B, Hkv, strides, s);
    case 72: return launch<72>(p, q, k, v, dout, B, Hkv, strides, s);
    default: return launch<128>(p, q, k, v, dout, B, Hkv, strides, s);
  }
}

const char* leopard_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
