// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel leopard_tpu/ops/pallas/flash_attention.py
// (_flash_forward / _flash_kernel): O = softmax(scale * Q K^T + mask) V per
// (batch row, q head, tile of 64 q rows), with an online softmax whose state
// (m, l, acc) is fp32, so the S x S score matrix never reaches device memory.
//
// Semantics, held to the dense version (ops/attention.py) by the tests:
//   - bf16 q/k/v/o in the layout [B, S, H, D], read through strides, no
//     transposes; the D stride is 1;
//   - GQA: q head h reads kv head h / (Hq / Hkv);
//   - segment mask: a pair attends iff q_seg == kv_seg and both are non-zero
//     (0 = padding); null segment pointers mean no segment mask;
//   - causal (q index >= kv index) with the kv tiles above the diagonal
//     skipped; sliding window (q - kv < window) with the tiles below the band
//     skipped; window <= 0 means none;
//   - the ragged tail (S not a multiple of 64, e.g. 676 patches) is masked
//     on load and store: callers never pad;
//   - masked scores are -1e30, never -inf, masked probabilities are exactly
//     0, and the denominator is max(l, 1e-30): a fully-masked row (a padding
//     query) comes out 0, never NaN, so its k/v can never poison valid rows;
//   - P is rounded to bf16 before the PV product, as the TPU kernel rounds it
//     to V's dtype; both products accumulate in fp32;
//   - for training, a non-null lse pointer also receives each row's
//     logsumexp of the scaled, masked scores, m + log(max(l, 1e-30)), as a
//     compact [B, Hq, Sq] fp32 array (the TPU kernel keeps a 128-lane replica
//     of it, flash_attention.py:52-58); a fully-masked row gets about -1e30,
//     which the backward (flash_attention_bwd.cu) never exponentiates
//     unmasked. Serving passes null and writes nothing more.
//
// The helpers, the pair mask and the tile-skip predicate live in
// flash_common.cuh, shared with the backward.
//
// What bounds it on the H100: both products run on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), the pre-Hopper warp-level
// instruction; wgmma, which alone reaches the card's full bf16 rate, and TMA
// loads are later work. At the decoder's prefill shape the kernel is
// compute-bound (a kv tile is reused by 64 q rows from shared memory, and
// tiles above the causal diagonal are skipped). The design keeps the per-tile
// work on the tensor cores: each of 4 warps owns 16 q rows, keeps its Q
// fragments in registers for the whole kv loop, and feeds the score
// accumulators straight back as the A operand of the PV product (the
// m16n8k16 accumulator layout is the A-fragment layout), so P never touches
// shared memory. Shared-memory rows are padded by 16 bytes so that fragment
// loads are free of bank conflicts. Loads are not yet overlapped with the
// products (no cp.async pipeline); several blocks per SM hide the latency.
//
// A head dim that is not a multiple of 16 (72, the SigLIP tower's) is padded
// with zeros to the next multiple of 16 in shared memory only.
//
// Shared memory at D=128 is about 53 KB, above the 48 KB default, so every
// launch first raises cudaFuncAttributeMaxDynamicSharedMemorySize, and the
// entry point returns cudaGetLastError() so that a refused launch is seen.

#include "flash_common.cuh"

namespace {

using namespace leopard_flash;

constexpr int BM = 64;   // q rows per block (4 warps x 16)
constexpr int BN = 64;   // kv rows per tile
constexpr int NT = 128;  // threads

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // [B, Hq, Sq] or null
  const int* q_seg;
  const int* kv_seg;
  int Sq, Skv, Hq, group;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long qseg_sb, kvseg_sb;
  float scale;
  int causal;
  int window;
  int vec;  // 1: every row start is 16-byte aligned, so rows load as uint4
};

template <int D>
struct Tile {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded for m16n8k16
  static constexpr int LDQ = DP + 8;             // row strides in bf16 elements:
  static constexpr int LDK = DP + 8;             // +16 bytes, conflict-free
  static constexpr int LDV = BN + 8;             // fragment loads
  static constexpr size_t smem =
      sizeof(bf16) * (BM * LDQ + BN * LDK + DP * LDV) + sizeof(int) * (BM + BN);
};

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  using T = Tile<D>;
  constexpr int DP = T::DP;
  constexpr int KS = DP / 16;  // k-steps of the QK^T product
  constexpr int ON = DP / 8;   // n-tiles of the output
  constexpr int C8 = DP / 8;   // 8-element chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][LDQ]
  bf16* Ks = Qs + BM * T::LDQ;                   // [BN][LDK]
  bf16* Vt = Ks + BN * T::LDK;                   // V transposed, [DP][LDV]
  int* qseg_s = reinterpret_cast<int*>(Vt + DP * T::LDV);  // [BM]
  int* kseg_s = qseg_s + BM;                               // [BN]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma group row, thread in group
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const bool has_seg = p.q_seg != nullptr;

  const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  bf16* og = p.o + b * p.o_sb + h * p.o_sh;

  for (int e = tid; e < BM * C8; e += NT) {
    const int i = e / C8, c8 = (e % C8) * 8;
    __align__(16) bf16 tmp[8];
    load8<D>(tmp, qg + (long long)(q0 + i) * p.q_ss, c8, q0 + i < p.Sq, p.vec);
    *reinterpret_cast<uint4*>(&Qs[i * T::LDQ + c8]) = *reinterpret_cast<uint4*>(tmp);
  }
  if (has_seg) {
    for (int i = tid; i < BM; i += NT) {
      const int qi = q0 + i;
      qseg_s[i] = qi < p.Sq ? p.q_seg[b * p.qseg_sb + qi] : 0;
    }
  }
  __syncthreads();

  // this warp's rows: r0 = warp*16 + g and r0 + 8
  const int r0 = warp * 16 + g;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + t * 2;
    qf[ks][0] = lds32(&Qs[r0 * T::LDQ + c]);
    qf[ks][1] = lds32(&Qs[(r0 + 8) * T::LDQ + c]);
    qf[ks][2] = lds32(&Qs[r0 * T::LDQ + c + 8]);
    qf[ks][3] = lds32(&Qs[(r0 + 8) * T::LDQ + c + 8]);
  }
  int qi[2], qs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + r0 + 8 * r;
    qs[r] = has_seg ? qseg_s[r0 + 8 * r] : 1;
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // kv tiles this q tile can see: causal stops after the diagonal, the
  // sliding window starts at the first tile inside the band. These are
  // exactly the tiles for which tile_runs(q0, BM, k0, BN, ...) holds, the
  // predicate the backward kernels skip by.
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(kv_end, q0 + BM);
  int kv_begin = 0;
  if (p.window > 0) {
    const int lo = q0 - p.window + 1;  // smallest kv index row q0 attends
    if (lo > 0) kv_begin = (lo / BN) * BN;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BN * C8; e += NT) {
      const int j = e / C8, c8 = (e % C8) * 8;
      __align__(16) bf16 tmp[8];
      load8<D>(tmp, kg + (long long)(k0 + j) * p.k_ss, c8, k0 + j < p.Skv, p.vec);
      *reinterpret_cast<uint4*>(&Ks[j * T::LDK + c8]) = *reinterpret_cast<uint4*>(tmp);
    }
    // V goes in transposed; consecutive threads take consecutive keys so
    // that the scattered 2-byte stores of one warp hit distinct banks
    for (int e = tid; e < BN * C8; e += NT) {
      const int j = e % BN, c8 = (e / BN) * 8;
      __align__(16) bf16 tmp[8];
      load8<D>(tmp, vg + (long long)(k0 + j) * p.v_ss, c8, k0 + j < p.Skv, p.vec);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c8 + i) * T::LDV + j] = tmp[i];
    }
    if (has_seg) {
      for (int j = tid; j < BN; j += NT) {
        const int kj = k0 + j;
        kseg_s[j] = kj < p.Skv ? p.kv_seg[b * p.kvseg_sb + kj] : 0;
      }
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* kr = &Ks[(n * 8 + g) * T::LDK + ks * 16 + t * 2];
        mma_bf16(s[n], qf[ks], lds32(kr), lds32(kr + 8));
      }
    }

    // mask and online softmax; element s[n][2r + c] is row r0 + 8r, key
    // n*8 + 2t + c, and a row is spread over the 4 threads of its group
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int j = n * 8 + t * 2 + (e % 2);
        const bool ok = attends<false>(qi[r], k0 + j, p.Sq, p.Skv, has_seg, qs[r],
                                       has_seg ? kseg_s[j] : 1, p.causal, p.window);
        s[n][e] = ok ? s[n][e] * p.scale : kNegInf;
        mt[r] = fmaxf(mt[r], s[n][e]);
      }
    }
    float alpha[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      m_new[r] = fmaxf(m[r], mt[r]);
      alpha[r] = __expf(m[r] - m_new[r]);
      m[r] = m_new[r];
    }
    uint32_t pa[4][4];  // P as the A operand of PV: 4 k-steps of 16 keys
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        pe[e] = s[n][e] > 0.5f * kNegInf ? __expf(s[n][e] - m_new[r]) : 0.f;
        rs[r] += pe[e];
      }
      // n-tile 2kk -> A columns 0..7 (regs 0, 1), 2kk+1 -> columns 8..15 (regs 2, 3)
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(pe[0], pe[1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(pe[2], pe[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V: B[k][n] = V[key k][dim n] = Vt[n][k]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        const bf16* vr = &Vt[(n * 8 + g) * T::LDV + kk * 16 + t * 2];
        mma_bf16(acc[n], pa[kk], lds32(vr), lds32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= p.Sq) continue;
    if (p.lse != nullptr && t == 0)  // the 4 threads of a row hold the same m, l
      p.lse[((long long)b * p.Hq + h) * p.Sq + qi[r]] = m[r] + logf(fmaxf(l[r], 1e-30f));
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = og + (long long)qi[r] * p.o_ss;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      const int d = n * 8 + t * 2;
      if (d < D) orow[d] = __float2bfloat16(acc[n][2 * r] * inv);
      if (d + 1 < D) orow[d + 1] = __float2bfloat16(acc[n][2 * r + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, int Hq, cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, Hq, B);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 tensors; strides (in elements) holds 14 values: q (b, s, h),
// k (b, s, h), v (b, s, h), o (b, s, h), q_seg b, kv_seg b. lse is null
// (serving) or a contiguous [B, Hq, Sq] fp32 array (training). Returns 0 or
// a cudaError_t code (cudaErrorInvalidValue for an unsupported head dim or
// head grouping).
int leopard_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                float* lse, const int* q_seg, const int* kv_seg, int B,
                                int Sq, int Skv, int Hq, int Hkv, int D,
                                const long long* strides, float scale, int causal, int window,
                                void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Hq == 0) return cudaSuccess;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.group = Hq / Hkv;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.qseg_sb = strides[12];
  p.kvseg_sb = strides[13];
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  // uint4 row loads need every row start 16-byte aligned: the bases and
  // every stride a multiple of 8 elements
  bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
               reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % 8 == 0;
  p.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, B, Hq, s);
    case 64: return launch<64>(p, B, Hq, s);
    case 72: return launch<72>(p, B, Hq, s);
    case 128: return launch<128>(p, B, Hq, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* leopard_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
