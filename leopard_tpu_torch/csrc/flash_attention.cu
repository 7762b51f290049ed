// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel leopard_tpu/ops/pallas/flash_attention.py
// (_flash_forward / _flash_kernel, with _should_run's tile skipping):
// O = softmax(scale * Q K^T + mask) V per (batch row, q head, tile of 128 q
// rows), with an online softmax whose state (m, l, acc) is fp32, so the
// S x S score matrix never reaches device memory.
//
// Semantics, held to the dense version (ops/attention.py) by the tests:
//   - bf16 q/k/v/o in the layout [B, S, H, D], read through strides, no
//     transposes; the D stride is 1;
//   - GQA: q head h reads kv head h / (Hq / Hkv);
//   - segment mask: a pair attends iff q_seg == kv_seg and both are non-zero
//     (0 = padding); null segment pointers mean no segment mask;
//   - causal (q index >= kv index) and sliding window (q - kv < window;
//     window <= 0 means none);
//   - the ragged tail (S not a multiple of the tile, e.g. 676 patches) is
//     filled with zeros by TMA and masked: callers never pad;
//   - masked scores are -1e30, never -inf, masked probabilities are exactly
//     0, and the denominator is max(l, 1e-30): a fully-masked or skipped row
//     (a padding query) comes out 0, never NaN;
//   - P is rounded to bf16 before the PV product, as the TPU kernel rounds it
//     to V's dtype; both products accumulate in fp32;
//   - for training, a non-null lse pointer also receives each row's
//     logsumexp of the scaled, masked scores, m + log(l), as a compact
//     [B, Hq, Sq] fp32 array (the TPU kernel keeps a 128-lane replica of it,
//     flash_attention.py:52-58); a row with no attended pair gets -1e30,
//     which the backward (flash_attention_bwd.cu) never exponentiates
//     unmasked. Serving passes null and writes nothing more.
//
// What bounds it on the H100: operations (2 products of 2 D flops per
// attended pair and head at 989 TF/s bf16). The design, for Hopper:
//   - one block of 384 threads per (q head, batch row, tile of 128 q rows):
//     two consumer warpgroups of 64 q rows each and a producer warpgroup
//     that gives its registers to them (setmaxnreg) and of which one thread
//     issues every load;
//   - Q arrives once by TMA; K and V stream through a ring of kStages
//     stages of kKvTile<D> kv rows, each stage guarded by a full and an
//     empty mbarrier, so loads run ahead of the products;
//   - S = Q K^T is wgmma m64nNk16 (N = the kv tile) with both operands
//     K-major in shared memory; O += P V is wgmma with P in registers (the
//     accumulator layout is the A layout) and V read MN-major (the
//     transpose bit): V is never transposed or copied;
//   - the softmax runs in registers in the log2 domain (log2(e) folded
//     into the scale, one ex2.approx per element);
//   - tiles are skipped by range: each q tile loops over the kv rows
//     [lo, hi) of ops/flash_attention.py::tile_ranges (segments, causal band
//     and window); a tile gets the per-element mask only where it crosses
//     the diagonal, the window's edge, a sequence end or a segment boundary;
//     a warpgroup whose 64 rows all lie past the sequence's end computes
//     nothing;
//   - the grid runs the longest causal q tiles first, and otherwise a
//     head's q tiles side by side, so that they read K and V from L2.
// Left for later: ping-pong of the two warpgroups and the softmax overlapped
// with the next product (each product waits for its result), persistent
// blocks (each block's prologue is exposed: one block fits an SM).

#include "flash_common.cuh"

namespace {

using namespace leopard_flash;

constexpr int BM = kTile;  // q rows per block

// kv rows per ring stage: 128 at D = 128; 64 below, where the products are
// short next to the softmax, and a 676-row sequence wastes 4% of its last
// 64-row tile against 12% of a 128-row one (~10% faster at the tower's
// shape, ~5% slower at the decoder's: tools/time_flash_kernels.py)
template <int D>
constexpr int kKvTile = D == 128 ? 128 : 64;

struct Params {
  CUtensorMap q[2], k[2], v[2];  // [0] 64-column boxes, [1] 16-column boxes
  bf16* o;
  float* lse;  // [B, Hq, Sq] or null
  const int* q_seg;
  const int* kv_seg;
  const int* ranges;  // [B or 1, n_qtiles, 2] kv rows [lo, hi) per q tile
  const int* q_uid;   // [B, ceil(Sq / 64)] segment id of each 64-row block, -1 if mixed
  const int* kv_uid;  // [B, ceil(Skv / 64)]
  int Sq, Skv, Hq, group, n_qtiles;
  long long o_sb, o_ss, o_sh;
  long long qseg_sb, kvseg_sb, ranges_sb, quid_sb, kvuid_sb;
  float scale_log2;
  int causal, window;
};

template <int D>
struct Smem {
  static constexpr int Q = HeadDim<D>::bytes(BM);
  static constexpr int KV = HeadDim<D>::bytes(kKvTile<D>);  // one of K, V
  static constexpr int STAGE = 2 * KV;
  static constexpr int BARS = Q + kStages * STAGE;
  static constexpr int total = BARS + (1 + 2 * kStages) * 8 + 1024;  // + alignment slack
};

// One kv tile's scores -> probabilities, in place, with the online-softmax
// update of m and l and the factor alpha for the output rows; P packed as
// bf16 A fragments. MASK applies the per-element mask.
template <bool MASK, int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], uint32_t (&pa)[BN / 16][4],
                                             const Params& p, const int (&qi)[2],
                                             const int (&qs)[2], const int* kv_seg, int k0,
                                             int t) {
  const bool has_seg = kv_seg != nullptr;
  float mt[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i] * p.scale_log2;
    if (MASK) {
      const int kj = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int ks = has_seg && kj < p.Skv ? __ldg(kv_seg + kj) : 0;
      x = attends(qi[r], kj, p.Sq, p.Skv, has_seg, qs[r], ks, p.causal, p.window) ? x : kNegInf;
    }
    s[i] = x;
    mt[r] = fmaxf(mt[r], x);
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(m[r], mt[r]);
    alpha[r] = exp2_fast(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float e = exp2_fast(s[i] - m[r]);
    s[i] = MASK ? (s[i] > 0.5f * kNegInf ? e : 0.f) : e;
    rs[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = l[r] * alpha[r] + rs[r];
  }
  acc_to_a<BN>(pa, s);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const __grid_constant__ Params p) {
  using SM = Smem<D>;
  constexpr int BN = kKvTile<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + SM::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const BlockCoords at = block_coords(p.n_qtiles, p.Hq, p.causal);
  const int qt = at.tile, h = at.head, b = at.batch, hk = h / p.group;
  const int q0 = qt * BM;
  const int* range = p.ranges + b * p.ranges_sb + 2 * qt;
  const int lo = range[0], hi = range[1];
  const int k_begin = lo / BN * BN;
  const int n_tiles = hi > lo ? (hi - k_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_expect_tx(q_full, SM::Q);
      tma_load_tile<D, BM>(sm, p.q, q_full, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* stage = sm + SM::Q + s * SM::STAGE;
        mbar_expect_tx(&full[s], SM::STAGE);
        tma_load_tile<D, BN>(stage, p.k, &full[s], hk, k_begin + it * BN, b);
        tma_load_tile<D, BN>(stage + SM::KV, p.v, &full[s], hk, k_begin + it * BN, b);
      }
    }
    return;
  }

  // consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warpgroup(), tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
  const int qw = q0 + wg * 64;  // this warpgroup's first row
  const int qi[2] = {qw + warp * 16 + g, qw + warp * 16 + g + 8};
  const bool has_seg = p.q_seg != nullptr;
  int qs[2] = {0, 0};
  int q_uid = -1;
  const int* kv_seg = nullptr;
  const int* kv_uid = nullptr;
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) qs[r] = qi[r] < p.Sq ? p.q_seg[b * p.qseg_sb + qi[r]] : 0;
    q_uid = qw < p.Sq ? p.q_uid[b * p.quid_sb + qw / kUid] : -1;
    kv_seg = p.kv_seg + b * p.kvseg_sb;
    kv_uid = p.kv_uid + b * p.kvuid_sb;
  }
  const int n_kvuid = (p.Skv + kUid - 1) / kUid;

  HeadAcc<D> o;
  o.zero();
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_tile = smem_u32(sm);
  if (n_tiles > 0) mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = k_begin + it * BN;
    const uint32_t k_tile = smem_u32(sm + SM::Q + s * SM::STAGE);
    const uint32_t v_tile = k_tile + SM::KV;
    mbar_wait(&full[s], (it / kStages) & 1);
    if (qw >= p.Sq) {  // no row of this warpgroup is in the sequence
      if (tw == 0) mbar_arrive(&empty[s]);
      continue;
    }

    float sc[BN / 2];
    wgmma_fence();
    product_k<D, BM, BN>(sc, q_tile, wg * 64, k_tile);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    bool uniform = q_uid >= 0;
#pragma unroll
    for (int u = 0; u < BN / kUid; ++u) {
      const int kb = k0 / kUid + u;
      uniform = uniform && kb < n_kvuid && kv_uid[kb] == q_uid;
    }
    float alpha[2];
    uint32_t pa[BN / 16][4];
    if (needs_mask(qw, 64, k0, BN, p.Sq, p.Skv, p.causal, p.window, has_seg, uniform))
      softmax_tile<true, BN>(sc, m, l, alpha, pa, p, qi, qs, kv_seg, k0, t);
    else
      softmax_tile<false, BN>(sc, m, l, alpha, pa, p, qi, qs, kv_seg, k0, t);

    o.scale_rows(alpha);
    wgmma_fence();
    o.template product_mn<BN, BN / 16>(pa, v_tile);
    wgmma_commit();
    wgmma_wait();
    o.fence();
    fence_regs(pa);
    if (tw == 0) mbar_arrive(&empty[s]);
  }

  bf16* rows[2];
  bool in[2];
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    in[r] = qi[r] < p.Sq;
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    rows[r] = p.o + b * p.o_sb + (long long)qi[r] * p.o_ss + h * p.o_sh;
  }
  o.store(rows, in, inv, t);
  if (p.lse != nullptr && t == 0) {  // the 4 threads of a row hold the same m, l
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (in[r])
        p.lse[((long long)b * p.Hq + h) * p.Sq + qi[r]] =
            l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNegInf;
  }
}

template <int D>
cudaError_t launch(Params& p, const void* q, const void* k, const void* v, int B, int Hq, int Hkv,
                   const long long* st, cudaStream_t stream) {
  cudaError_t err = make_maps<D>(p.q, q, B, p.Sq, Hq, st[0], st[1], st[2], BM);
  constexpr int BN = kKvTile<D>;
  if (err == cudaSuccess) err = make_maps<D>(p.k, k, B, p.Skv, Hkv, st[3], st[4], st[5], BN);
  if (err == cudaSuccess) err = make_maps<D>(p.v, v, B, p.Skv, Hkv, st[6], st[7], st[8], BN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::total);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D><<<p.n_qtiles * Hq * B, kThreads, Smem<D>::total, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 tensors whose bases are 16-byte aligned and whose b, s, h strides
// are multiples of 8 elements (what TMA addresses); strides (in elements)
// holds 17 values: q, k, v, o (b, s, h each), then the batch strides of
// q_seg, kv_seg, ranges, q_uid and kv_uid. ranges is tile_ranges' kv range
// per q tile; q_uid/kv_uid the per-64-row segment ids (null with null
// segments). lse is null (serving) or a contiguous [B, Hq, Sq] fp32 array
// (training). block and uid_block are the caller's tile sizes, checked
// against the kernel's. Returns 0 or a cudaError_t code
// (cudaErrorInvalidValue for an unsupported head dim, head grouping, tile
// size or layout).
int leopard_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                                const int* q_seg, const int* kv_seg, const int* ranges,
                                const int* q_uid, const int* kv_uid, int B, int Sq, int Skv,
                                int Hq, int Hkv, int D, int block, int uid_block,
                                const long long* strides, float scale, int causal, int window,
                                void* stream) {
  if (block != kTile || uid_block != kUid) return cudaErrorInvalidValue;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0) return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Hq == 0) return cudaSuccess;
  Params p;
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.ranges = ranges;
  p.q_uid = q_uid;
  p.kv_uid = kv_uid;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.group = Hq / Hkv;
  p.n_qtiles = (Sq + BM - 1) / BM;
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.qseg_sb = strides[12];
  p.kvseg_sb = strides[13];
  p.ranges_sb = strides[14];
  p.quid_sb = strides[15];
  p.kvuid_sb = strides[16];
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, q, k, v, B, Hq, Hkv, strides, s);
    case 64: return launch<64>(p, q, k, v, B, Hq, Hkv, strides, s);
    case 72: return launch<72>(p, q, k, v, B, Hq, Hkv, strides, s);
    case 128: return launch<128>(p, q, k, v, B, Hq, Hkv, strides, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* leopard_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
