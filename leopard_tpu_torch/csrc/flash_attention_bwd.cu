// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels leopard_tpu/ops/pallas/flash_attention.py
// (_flash_backward with _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel,
// which share _bwd_mask_and_p): FlashAttention-2 gradients of
// O = softmax(scale * Q K^T + mask) V from the forward's per-row logsumexp
// (flash_attention.cu writes it when asked), without the S x S matrices ever
// reaching device memory:
//   P  = exp(scale * Q K^T - lse) where the mask lets the pair through, else 0
//        (a select, never a product, so a fully-masked row's lse of about
//        -1e30 is never exponentiated);
//   dP = dO V^T;  delta = rowsum(dO * O), computed by the caller in fp32;
//   dS = P * (dP - delta) * scale;
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO.
// Masks and tile skipping are the forward's (flash_common.cuh: `attends`,
// `tile_runs`), so a pair is in the backward exactly when it was in the
// forward.
//
// Two kernels, as on the TPU, but with the sequential grid dimension turned
// into a loop inside each block, since blocks run in parallel on the H100:
//   - dq: one block per (batch, q head, tile of 64 q rows), looping over the
//     kv tiles; each of 4 warps owns 16 q rows and keeps its dQ in fp32
//     registers;
//   - dk/dv: one block per (batch, KV head, tile of 64 kv rows), looping over
//     the group's q heads and their tiles of 32 q rows; each warp owns 16 kv
//     rows and keeps dK and dV in fp32 registers. Summing the GQA group in
//     the block replaces the TPU kernel's per-q-head [B, Hq, S, D] fp32
//     partials that XLA group-sums (flash_attention.py:538-539): no atomics
//     and no partials, so the gradients are the same bits on every run.
// P and dS are rounded to bf16 before their products, as the TPU kernel
// rounds them to the operands' dtype; every product accumulates in fp32 on
// the tensor cores (mma.sync.m16n8k16), like the forward.
//
// What bounds it on the H100: operations. Each kernel recomputes Q K^T and
// dO V^T, so it runs 7 products of 2 * D flops per attended pair and head
// where 5 would do, on mma.sync, which does not reach the card's wgmma rate;
// tiles are loaded without a cp.async pipeline. Those are the later, faster
// version's work; this one is simple and right first.
//
// Layouts: q, dO, dQ [B, Sq, Hq, D]; k, v, dK, dV [B, Skv, Hkv, D]; bf16, read
// and written through strides with a unit D stride; lse and delta fp32
// [B, Hq, Sq] contiguous. A head dim that is not a multiple of 16 (72) is
// zero-padded to the next one in shared memory only, and ragged sequence
// tails (676) are masked on load and store, as in the forward.

#include "flash_common.cuh"

namespace {

using namespace leopard_flash;

constexpr int NT = 128;  // threads: 4 warps
constexpr int BQ = 64;   // dq kernel: q rows per block (4 warps x 16)
constexpr int BK = 64;   // kv rows per tile (dq kernel) and per block (dk/dv kernel)
constexpr int BQ2 = 32;  // dk/dv kernel: q rows per inner tile

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const int* q_seg;
  const int* kv_seg;
  int Sq, Skv, Hq, group;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  long long qseg_sb, kvseg_sb;
  float scale;
  int causal;
  int window;
  int vec;  // 1: every input row start is 16-byte aligned, so rows load as uint4
};

template <int D>
struct Dims {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded for m16n8k16
  static constexpr int LD = DP + 8;              // row-major tiles: +16 bytes a row,
  static constexpr int LDT = BK + 8;             // transposed tiles too, so that
  static constexpr int LDT2 = BQ2 + 8;           // fragment loads hit distinct banks
  static constexpr int C8 = DP / 8;              // 8-element chunks per row
  static constexpr size_t dq_smem =
      sizeof(bf16) * (2 * BQ * LD + 2 * BK * LD + DP * LDT) + sizeof(int) * (BQ + BK);
  static constexpr size_t dkv_smem = sizeof(bf16) * (2 * BK * LD + 2 * BQ2 * LD + 2 * DP * LDT2) +
                                     sizeof(float) * 2 * BQ2 + sizeof(int) * (BQ2 + BK);
};

// Load `rows` rows starting at row0 of one head into a row-major tile
// [rows][LD] and, if t_tile is given, also transposed into [DP][ldt]; rows
// past n and dims past D are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, bf16* t_tile, int ldt, const bf16* base,
                                          long long row_stride, int row0, int n, int vec) {
  using T = Dims<D>;
  for (int e = threadIdx.x; e < ROWS * T::C8; e += NT) {
    // consecutive threads take consecutive rows, so that the scattered
    // 2-byte stores of the transposed copy hit distinct banks
    const int j = e % ROWS, c8 = (e / ROWS) * 8;
    __align__(16) bf16 tmp[8];
    load8<D>(tmp, base + (long long)(row0 + j) * row_stride, c8, row0 + j < n, vec);
    *reinterpret_cast<uint4*>(&tile[j * T::LD + c8]) = *reinterpret_cast<uint4*>(tmp);
    if (t_tile != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) t_tile[(c8 + i) * ldt + j] = tmp[i];
    }
  }
}

// Write a warp's 16 rows (r0 and r0 + 8 of the tile starting at row0) of an
// fp32 accumulator [DP/8][4] as bf16, rows past n and dims past D skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride, int row0, int r0,
                                           int n, int t, const float (&acc)[Dims<D>::DP / 8][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    if (row >= n) continue;
    bf16* out = base + (long long)row * row_stride;
#pragma unroll
    for (int c = 0; c < Dims<D>::DP / 8; ++c) {
      const int d = c * 8 + t * 2;
      if (d < D) out[d] = __float2bfloat16(acc[c][2 * r]);
      if (d + 1 < D) out[d + 1] = __float2bfloat16(acc[c][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Params p) {
  using T = Dims<D>;
  constexpr int KS = T::DP / 16;  // k-steps over the head dim
  constexpr int ON = T::DP / 8;   // n-tiles of dQ

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* dOs = Qs + BQ * T::LD;                   // [BQ][LD]
  bf16* Ks = dOs + BQ * T::LD;                   // [BK][LD]
  bf16* Vs = Ks + BK * T::LD;                    // [BK][LD]
  bf16* Kt = Vs + BK * T::LD;                    // K transposed, [DP][LDT]
  int* qseg_s = reinterpret_cast<int*>(Kt + T::DP * T::LDT);  // [BQ]
  int* kseg_s = qseg_s + BQ;                                  // [BK]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const bool has_seg = p.q_seg != nullptr;

  const bf16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  load_tile<D, BQ>(Qs, nullptr, 0, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq, p.vec);
  load_tile<D, BQ>(dOs, nullptr, 0, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, p.Sq,
                   p.vec);
  if (has_seg) {
    for (int i = tid; i < BQ; i += NT)
      qseg_s[i] = q0 + i < p.Sq ? p.q_seg[b * p.qseg_sb + q0 + i] : 0;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
  int qi[2], qs[2];
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + r0 + 8 * r;
    qs[r] = has_seg ? qseg_s[r0 + 8 * r] : 1;
    lse[r] = qi[r] < p.Sq ? p.lse[row_base + qi[r]] : 0.f;
    delta[r] = qi[r] < p.Sq ? p.delta[row_base + qi[r]] : 0.f;
  }

  float dq[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int k0 = 0; k0 < p.Skv; k0 += BK) {
    if (!tile_runs(q0, BQ, k0, BK, p.causal, p.window)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, BK>(Ks, Kt, T::LDT, kg, p.k_ss, k0, p.Skv, p.vec);
    load_tile<D, BK>(Vs, nullptr, 0, vg, p.v_ss, k0, p.Skv, p.vec);
    if (has_seg) {
      for (int j = tid; j < BK; j += NT)
        kseg_s[j] = k0 + j < p.Skv ? p.kv_seg[b * p.kvseg_sb + k0 + j] : 0;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 q rows x 64 keys per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_tile<KS, 8>(s, Qs, T::LD, Ks, T::LD, r0, g, t);
    mma_tile<KS, 8>(dp, dOs, T::LD, Vs, T::LD, r0, g, t);

    // element [n][e] is row r0 + 8 (e / 2), key k0 + 8n + 2t + e % 2; s
    // becomes dS in place
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int j = n * 8 + t * 2 + (e % 2);
        const bool ok = attends<true>(qi[r], k0 + j, p.Sq, p.Skv, has_seg, qs[r],
                                      has_seg ? kseg_s[j] : 1, p.causal, p.window);
        const float pr = ok ? __expf(s[n][e] * p.scale - lse[r]) : 0.f;
        s[n][e] = pr * (dp[n][e] - delta[r]) * p.scale;
      }
    }
    // dQ += dS K: B[key][dim] = K[key][dim] = Kt[dim][key]
    uint32_t ds[4][4];
    acc_to_a<8>(ds, s);
    mma_frag<4, ON>(dq, ds, Kt, T::LDT, g, t);
  }
  store_rows<D>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, q0, r0, p.Sq, t, dq);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Params p) {
  using T = Dims<D>;
  constexpr int KS = T::DP / 16;
  constexpr int ON = T::DP / 8;
  constexpr int QN = BQ2 / 8;  // n-tiles of q columns in S^T

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]
  bf16* Vs = Ks + BK * T::LD;                    // [BK][LD]
  bf16* Qs = Vs + BK * T::LD;                    // [BQ2][LD]
  bf16* dOs = Qs + BQ2 * T::LD;                  // [BQ2][LD]
  bf16* Qt = dOs + BQ2 * T::LD;                  // Q transposed, [DP][LDT2]
  bf16* dOt = Qt + T::DP * T::LDT2;              // dO transposed, [DP][LDT2]
  float* lse_s = reinterpret_cast<float*>(dOt + T::DP * T::LDT2);  // [BQ2]
  float* delta_s = lse_s + BQ2;                                    // [BQ2]
  int* qseg_s = reinterpret_cast<int*>(delta_s + BQ2);             // [BQ2]
  int* kseg_s = qseg_s + BQ2;                                      // [BK]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const bool has_seg = p.q_seg != nullptr;

  load_tile<D, BK>(Ks, nullptr, 0, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.Skv, p.vec);
  load_tile<D, BK>(Vs, nullptr, 0, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.Skv, p.vec);
  if (has_seg) {
    for (int j = tid; j < BK; j += NT)
      kseg_s[j] = k0 + j < p.Skv ? p.kv_seg[b * p.kvseg_sb + k0 + j] : 0;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's kv rows: r0 and r0 + 8
  int kj[2], ks[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kj[r] = k0 + r0 + 8 * r;
    ks[r] = has_seg ? kseg_s[r0 + 8 * r] : 1;
  }

  float dk[ON][4], dv[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // causal: the first q tile that reaches this kv tile's first row
  const int q_begin = p.causal ? (k0 / BQ2) * BQ2 : 0;
  for (int hi = 0; hi < p.group; ++hi) {
    const int h = hk * p.group + hi;
    const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
    const bf16* dog = p.dout + b * p.do_sb + h * p.do_sh;
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    for (int q0 = q_begin; q0 < p.Sq; q0 += BQ2) {
      if (!tile_runs(q0, BQ2, k0, BK, p.causal, p.window)) continue;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D, BQ2>(Qs, Qt, T::LDT2, qg, p.q_ss, q0, p.Sq, p.vec);
      load_tile<D, BQ2>(dOs, dOt, T::LDT2, dog, p.do_ss, q0, p.Sq, p.vec);
      for (int i = tid; i < BQ2; i += NT) {
        const int qi = q0 + i;
        lse_s[i] = qi < p.Sq ? p.lse[row_base + qi] : 0.f;
        delta_s[i] = qi < p.Sq ? p.delta[row_base + qi] : 0.f;
        qseg_s[i] = has_seg && qi < p.Sq ? p.q_seg[b * p.qseg_sb + qi] : 0;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 32 q columns per warp
      float st[QN][4], dpt[QN][4];
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      mma_tile<KS, QN>(st, Ks, T::LD, Qs, T::LD, r0, g, t);
      mma_tile<KS, QN>(dpt, Vs, T::LD, dOs, T::LD, r0, g, t);

      // element [n][e] is kv row r0 + 8 (e / 2), q column 8n + 2t + e % 2;
      // st becomes P^T and dpt dS^T in place
#pragma unroll
      for (int n = 0; n < QN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const int c = n * 8 + t * 2 + (e % 2);
          const bool ok = attends<true>(q0 + c, kj[r], p.Sq, p.Skv, has_seg,
                                        has_seg ? qseg_s[c] : 1, ks[r], p.causal, p.window);
          const float pr = ok ? __expf(st[n][e] * p.scale - lse_s[c]) : 0.f;
          st[n][e] = pr;
          dpt[n][e] = pr * (dpt[n][e] - delta_s[c]) * p.scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q: B[q][dim] read from the transposed tiles
      uint32_t pa[QN / 2][4], da[QN / 2][4];
      acc_to_a<QN>(pa, st);
      acc_to_a<QN>(da, dpt);
      mma_frag<QN / 2, ON>(dv, pa, dOt, T::LDT2, g, t);
      mma_frag<QN / 2, ON>(dk, da, Qt, T::LDT2, g, t);
    }
  }
  store_rows<D>(p.dk + b * p.dk_sb + hk * p.dk_sh, p.dk_ss, k0, r0, p.Skv, t, dk);
  store_rows<D>(p.dv + b * p.dv_sb + hk * p.dv_sh, p.dv_ss, k0, r0, p.Skv, t, dv);
}

template <int D>
cudaError_t launch(const Params& p, int B, int Hq, int Hkv, cudaStream_t stream) {
  using T = Dims<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::dkv_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<dim3((p.Sq + BQ - 1) / BQ, Hq, B), NT, T::dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.Skv > 0)
    flash_bwd_dkv_kernel<D><<<dim3((p.Skv + BK - 1) / BK, Hkv, B), NT, T::dkv_smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 tensors; strides (in elements) holds 23 values: q, k, v, dout, dq,
// dk, dv (b, s, h each), then q_seg b and kv_seg b. lse and delta are
// contiguous [B, Hq, Sq] fp32. Null segment pointers mean no segment mask.
// Returns 0 or a cudaError_t code (cudaErrorInvalidValue for an unsupported
// head dim or head grouping).
int leopard_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq, void* dk,
                                void* dv, const int* q_seg, const int* kv_seg, int B, int Sq,
                                int Skv, int Hq, int Hkv, int D, const long long* strides,
                                float scale, int causal, int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Hq == 0) return cudaSuccess;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.group = Hq / Hkv;
  long long* dst[21] = {&p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,  &p.k_ss,  &p.k_sh,  &p.v_sb,
                        &p.v_ss,  &p.v_sh,  &p.do_sb, &p.do_ss, &p.do_sh, &p.dq_sb, &p.dq_ss,
                        &p.dq_sh, &p.dk_sb, &p.dk_ss, &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh};
  for (int i = 0; i < 21; ++i) *dst[i] = strides[i];
  p.qseg_sb = strides[21];
  p.kvseg_sb = strides[22];
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  // uint4 row loads need every input row start 16-byte aligned: the bases
  // and every input stride a multiple of 8 elements
  bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
               reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
              16) == 0;
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % 8 == 0;
  p.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, B, Hq, Hkv, s);
    case 64: return launch<64>(p, B, Hq, Hkv, s);
    case 72: return launch<72>(p, B, Hq, Hkv, s);
    case 128: return launch<128>(p, B, Hq, Hkv, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* leopard_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
