// int4 weight matmul for decode on NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel leopard_tpu/ops/pallas/int4_matmul.py
// (int4_matmul / _kernel): out[M, N] = x[M, K] (bf16) times an int4 weight
// packed as q4 uint8 [K/2, N] ("split-half": byte (i, n) holds logical row i
// in its low nibble and row i + K/2 in its high nibble, offset-binary q + 8
// with q in [-7, 7]) with f32 scales s [K/128, N], one per (128-row group,
// column). Needs 1 <= M <= 64, K % 256 == 0, N % 128 == 0. The result is
// f32, or bf16 rounded once from it when the caller asks.
//
// What bounds it on the H100: device memory. A packed byte carries two
// weights, 4 FLOP per row of x, so even M = 64 sits far below the card's
// ~295 FLOP/byte ridge; at decode (M = 2) the 225 matmuls of an 8B step
// must move 4.0 GB, 1.195 ms at 3.35 TB/s. The kernel has to keep ~2-3 MB
// of packed weight in flight and spend few instructions on each byte.
//
// Design:
//   - Roles swapped on the tensor cores. mma.sync m16n8k16 (bf16, fp32
//     accumulate) takes the weight's output columns as its 16 rows and the
//     rows of x as its n (n8 tiles, M padded to 8, 16, 32 or 64), so M = 2
//     does 8/2 = 4x the useful products, ~0.12 ms of tensor time a step,
//     and M = 9..64 still reads the weight once. mma.sync rather than wgmma:
//     the A fragment comes out of the unpack in registers in exactly the
//     m16n8k16 layout, one warp owns 16 columns with no warpgroup-wide
//     waits between the per-group products, and the tensor rate is not
//     what bounds the kernel.
//   - Loads. A block owns 128 output columns and a range of K in whole
//     group pairs: 128 packed rows are one 128-row scale group of each
//     nibble plane (lo: group g, hi: group g + K/256). One producer warp
//     fills a ring of 4 stages, each holding the 128 x 128 packed tile (one
//     TMA load through a 2-D map with the 128-byte swizzle, encoded once per
//     weight by the host and cached), the tile's x rows of both planes as
//     bf16 (1-D bulk copies of 256 bytes, 272-byte rows so the x reads do
//     not conflict) and the two planes' scale rows (two bulk copies). Eight
//     consumer warps wait on the stage's mbarrier and free it when read.
//     Two blocks fit an SM for M <= 16: up to 128 KB of weight in flight.
//   - Unpack in registers, never through a bf16 tile. ldmatrix.trans reads
//     the byte tile as 8 x 8 matrices of 16-bit pairs: a thread (lane
//     4g + t) gets bytes (row 2t, col 2g), (2t, 2g + 1), (2t + 1, 2g),
//     (2t + 1, 2g + 1) of each 8-row, 16-column matrix. prmt picks the two
//     bytes of column 2g (and of 2g + 1), lop3 ORs each plane's nibbles into
//     the mantissa of bf16 128.0 (0x4300), and one bf16x2 fma subtracts 136:
//     v - 8 exactly, two weights at a time, 12 instructions per 4 packed
//     bytes. MMA row g is column 2g and row g + 8 is column 2g + 1, so those
//     registers are the A fragment as they are; the epilogue writes the
//     columns back in order. The k slots are the packed rows in order, and
//     x's row i (lo) or i + K/2 (hi) is the matching B fragment.
//   - Scales exactly in fp32. The weights enter the products as the
//     integers v - 8; each plane's 128-row group accumulates into its own
//     fp32 fragment, folded in as acc += s[g, n] * part with the scale in
//     fp32. Nothing is rounded but x to bf16.
//   - Work split. The host (ops/int4_matmul.py::plan_splits) splits K in
//     whole group pairs, up to 8 ways, where N / 128 alone gives too few
//     blocks for one wave (wk/wv: 8 tiles), and no further than one wave.
//     Split blocks write fp32 partials to a workspace the host keeps per
//     stream; the last block of a column tile to finish (a counter per
//     tile, reset by that block) loads all the tile's partials at once and
//     sums them in split order. One launch does the whole call, and the
//     sum repeats bit for bit. (Summing them across a thread-block cluster
//     through distributed shared memory instead measured slower: clusters
//     of 8 cost wq/wo and down ~3-6 µs a call.)
// ptxas (-Xptxas -v, sm_90a, -O3, nvcc 12.9) per n8-tile count NT (M <= 8,
// 16, 32, 64), with 288 threads and 80 bytes of static shared memory (the
// mbarriers) beside the dynamic ring:
//   NT = 1:  68 registers, no spills,  91,136 bytes dynamic (2 blocks an SM)
//   NT = 2:  78 registers, no spills, 107,520 bytes (2 blocks an SM)
//   NT = 4: 128 registers, no spills, 140,288 bytes (1 block an SM)
//   NT = 8: 168 registers, 160 bytes of spill stores and 220 of loads,
//           209,920 bytes (1 block an SM): M = 33-64 is not the decode path
//           this kernel is shaped for.

#include <cuda_bf16.h>
#include <string.h>

#include "tma_common.cuh"

namespace {

using namespace leopard_tma;

typedef __nv_bfloat16 bf16;

constexpr int BN = 128;         // output columns per block
constexpr int ROWS = 128;       // packed rows per stage: one scale group of each plane
constexpr int GROUP = 128;      // rows per scale group
constexpr int kWarps = 8;       // consumer warps, 16 columns each
constexpr int kThreads = (kWarps + 1) * 32;  // and one producer warp
constexpr int kStages = 4;
constexpr int XROW = ROWS + 8;  // bf16 per staged x row: 272 bytes, conflict-free ldmatrix
constexpr int MAX_M = 64;
constexpr int MAX_SPLITS = 8;     // K ranges a column tile is split into
constexpr int SPLIT_COUNTERS = 256;  // int32 at the workspace's start, one per column tile

// Shared memory of one stage for NT n8 tiles of x rows (M <= 8 NT)
template <int NT>
struct Layout {
  static constexpr int W = ROWS * BN;              // packed tile, 1,024-byte aligned
  static constexpr int X = 2 * 8 * NT * XROW * 2;  // x rows of both planes
  static constexpr int S = 2 * BN * 4;             // both planes' scale rows
  static constexpr int STAGE = (W + X + S + 1023) / 1024 * 1024;
  static constexpr int SMEM = kStages * STAGE + 1024;  // + alignment slack
};

struct Args {
  const bf16* x;   // [M, K]
  const float* s;  // [K/128, N]
  void* out;       // [M, N], f32 or bf16
  int* counters;   // [N / 128] when split, 0 between launches
  float* partial;  // [splits, M, N] when split
  int M, K, N, per, out_bf16;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (16 x 8 fp32) += a (16 x 16 bf16) b (16 x 8 bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The nibbles in bits 0-3 and 16-19 of v (other bits ignored) as bf16x2
// v - 8, exactly: OR-ed into the mantissa of 128.0 they make 128 + v, and
// (128 + v) * 1 - 136 rounds nowhere.
__device__ __forceinline__ uint32_t nibbles_minus_8(uint32_t v) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(r) : "r"(v), "r"(0x000F000Fu), "r"(0x43004300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// One ldmatrix.trans register (bytes (2t, 2g), (2t, 2g+1), (2t+1, 2g),
// (2t+1, 2g+1) of an 8 x 16 byte matrix) as four A registers: column 2g
// (MMA row g) and column 2g + 1 (row g + 8), each for the lo and hi plane,
// k slots 2t and 2t + 1.
__device__ __forceinline__ void unpack(uint32_t r, uint32_t& lo_even, uint32_t& hi_even,
                                       uint32_t& lo_odd, uint32_t& hi_odd) {
  const uint32_t even = __byte_perm(r, 0, 0x4240);  // bytes 0 and 2: column 2g
  const uint32_t odd = __byte_perm(r, 0, 0x4341);   // bytes 1 and 3: column 2g + 1
  lo_even = nibbles_minus_8(even);
  hi_even = nibbles_minus_8(even >> 4);
  lo_odd = nibbles_minus_8(odd);
  hi_odd = nibbles_minus_8(odd >> 4);
}

__device__ __forceinline__ void store2(void* out, int out_bf16, size_t idx, float a, float b) {
  if (out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + idx) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(a, b);
}

// part[j] += A (16 columns x 32 packed rows of one plane, two k16 steps)
// times x's matching 32 rows, for every n8 tile j of x; bx is the plane's x
// rows in shared memory, slab the 32-row slab of the stage
template <int NT>
__device__ __forceinline__ void plane_products(float (&part)[NT][4], const uint32_t (&a)[2][4],
                                               uint32_t bx, int slab, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t b[4];
    ldsm_x4(b, bx + ((8 * j + (lane & 7)) * XROW + slab * 32 + 8 * (lane >> 3)) * 2);
    mma(part[j], a[0], b[0], b[1]);
    mma(part[j], a[1], b[2], b[3]);
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 2 ? 2 : 1)
    int4_matmul_kernel(const __grid_constant__ CUtensorMap wmap, const Args a) {
  using L = Layout<NT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const int split = blockIdx.y, splits = gridDim.y;
  const int n0 = blockIdx.x * BN;
  const int M = a.M;
  const int pairs = a.K / (2 * GROUP);  // group pairs; the hi plane's groups follow the lo plane's
  const int gp0 = split * a.per;
  const int n_it = min(pairs, gp0 + a.per) - gp0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == kWarps * 32)
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // consumer warp w owns columns [16 w, 16 w + 16) of the tile; thread (g, t)
  // ends with columns 2g, 2g + 1 of x rows 8j + 2t and 8j + 2t + 1
  const int g = lane >> 2, t = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  if (warp == kWarps) {  // the producer
    const uint32_t tx = L::W + 2 * M * ROWS * 2 + L::S;
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
      unsigned char* stage = sm + st * L::STAGE;
      const int gp = gp0 + it;
      if (lane == 0) {
        mbar_expect_tx(&full[st], tx);
        tma_load_2d(stage, &wmap, &full[st], n0, gp * ROWS);
        bulk_load(stage + L::W + L::X, a.s + (size_t)gp * a.N + n0, BN * 4, &full[st]);
        bulk_load(stage + L::W + L::X + BN * 4, a.s + (size_t)(gp + pairs) * a.N + n0, BN * 4,
                  &full[st]);
      }
      __syncwarp();  // the stage's bytes are expected before the other lanes copy
      for (int c = lane; c < 2 * M; c += 32) {
        const int plane = c / M, m = c % M;
        bulk_load(stage + L::W + (plane * 8 * NT + m) * XROW * 2,
                  a.x + (size_t)m * a.K + (size_t)plane * (a.K / 2) + (size_t)gp * ROWS, ROWS * 2,
                  &full[st]);
      }
    }
  } else {  // the consumers
    // x rows [M, 8 NT) of every stage stay zero: no copy writes them
    constexpr int words = XROW / 2;
    const int pad = 8 * NT - M;
    for (int i = threadIdx.x; i < kStages * 2 * pad * words; i += kWarps * 32) {
      const int r = i / words;
      const int st = r / (2 * pad), plane = r / pad % 2, row = M + r % pad;
      reinterpret_cast<uint32_t*>(sm + st * L::STAGE + L::W +
                                  (plane * 8 * NT + row) * XROW * 2)[i % words] = 0;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWarps * 32) : "memory");  // consumers only
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      const unsigned char* stage = sm + st * L::STAGE;
      const uint32_t wt = smem_u32(stage), xt = wt + L::W;
      float lo[NT][4], hi[NT][4];  // this group pair's products, one per plane
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) lo[j][i] = hi[j][i] = 0.f;
#pragma unroll
      for (int slab = 0; slab < ROWS / 32; ++slab) {
        // packed rows [32 slab, 32 slab + 32) of the warp's 16 columns: matrix
        // lane / 8 takes rows 8 (lane / 8) + lane % 8 (the swizzle moves the
        // 16-byte chunk of row r to chunk ^ r % 8)
        uint32_t q[4];
        ldsm_x4_trans(q, wt + (slab * 32 + lane) * BN + ((warp ^ (lane & 7)) << 4));
        uint32_t al[2][4], ah[2][4];  // A fragments of two k16 steps, per plane
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          unpack(q[2 * s], al[s][0], ah[s][0], al[s][1], ah[s][1]);
          unpack(q[2 * s + 1], al[s][2], ah[s][2], al[s][3], ah[s][3]);
        }
        plane_products<NT>(lo, al, xt, slab, lane);
        plane_products<NT>(hi, ah, xt + 8 * NT * XROW * 2, slab, lane);
      }
      const float* sc = reinterpret_cast<const float*>(stage + L::W + L::X) + 16 * warp + 2 * g;
      const float2 slo = *reinterpret_cast<const float2*>(sc);
      const float2 shi = *reinterpret_cast<const float2*>(sc + BN);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      // c0, c1: column 2g (MMA row g); c2, c3: column 2g + 1 (row g + 8)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] = fmaf(slo.x, lo[j][0], acc[j][0]);
        acc[j][1] = fmaf(slo.x, lo[j][1], acc[j][1]);
        acc[j][2] = fmaf(slo.y, lo[j][2], acc[j][2]);
        acc[j][3] = fmaf(slo.y, lo[j][3], acc[j][3]);
        acc[j][0] = fmaf(shi.x, hi[j][0], acc[j][0]);
        acc[j][1] = fmaf(shi.x, hi[j][1], acc[j][1]);
        acc[j][2] = fmaf(shi.y, hi[j][2], acc[j][2]);
        acc[j][3] = fmaf(shi.y, hi[j][3], acc[j][3]);
      }
    }
  }

  const int col = 16 * warp + 2 * g;  // in the tile
  if (splits == 1) {
    if (warp < kWarps) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int m = 8 * j + 2 * t;
        if (m < M) store2(a.out, a.out_bf16, (size_t)m * a.N + n0 + col, acc[j][0], acc[j][2]);
        if (m + 1 < M)
          store2(a.out, a.out_bf16, (size_t)(m + 1) * a.N + n0 + col, acc[j][1], acc[j][3]);
      }
    }
    return;
  }

  // K split: each block writes its fp32 partial; the last block of the
  // column tile to finish (a counter per tile, reset by that block) sums the
  // partials in split order, loading them all at once
  if (warp < kWarps) {
    float* part = a.partial + (size_t)split * M * a.N + n0 + col;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = 8 * j + 2 * t;
      if (m < M) store2(part, 0, (size_t)m * a.N, acc[j][0], acc[j][2]);
      if (m + 1 < M) store2(part, 0, (size_t)(m + 1) * a.N, acc[j][1], acc[j][3]);
    }
  }
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&a.counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < M * BN / 4; i += kThreads) {
    const size_t idx = (size_t)(i / (BN / 4)) * a.N + n0 + 4 * (i % (BN / 4));
    float4 part[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits)
        part[r] = __ldcg(reinterpret_cast<const float4*>(a.partial + (size_t)r * M * a.N + idx));
    float4 v = part[0];
#pragma unroll
    for (int r = 1; r < MAX_SPLITS; ++r) {
      if (r < splits) {
        v.x += part[r].x;
        v.y += part[r].y;
        v.z += part[r].z;
        v.w += part[r].w;
      }
    }
    if (a.out_bf16) {
      store2(a.out, 1, idx, v.x, v.y);
      store2(a.out, 1, idx + 2, v.z, v.w);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + idx) = v;
    }
  }
  if (threadIdx.x == 0) a.counters[blockIdx.x] = 0;
}

// What the host keeps per weight (ops/int4_matmul.py::_PlanStruct mirrors it)
struct HostPlan {
  unsigned char wmap[128];  // CUtensorMap of q4 as uint8 [K/2, N], 128 x 128 boxes
  const float* s;
  int K, N, device, pad;
};

template <int NT>
cudaError_t launch(const CUtensorMap& map, const Args& a, int splits, int device,
                   cudaStream_t stream) {
  static bool sized[64] = {};  // the shared-memory limit, set once per device
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!sized[device]) {
    cudaError_t err = cudaFuncSetAttribute(int4_matmul_kernel<NT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Layout<NT>::SMEM);
    if (err != cudaSuccess) return err;
    sized[device] = true;
  }
  int4_matmul_kernel<NT><<<dim3(a.N / BN, splits), kThreads, Layout<NT>::SMEM, stream>>>(map, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Fill `plan` (a HostPlan) for q4 uint8 [K/2, N] and s f32 [K/128, N], both
// contiguous and 16-byte aligned on `device`: encodes q4's tensor map once.
// Returns 0 or a cudaError_t code.
int leopard_int4_plan(const void* q4, const void* s, int K, int N, int device, void* plan) {
  if (K <= 0 || K % (2 * GROUP) != 0 || N <= 0 || N % BN != 0 || q4 == nullptr || s == nullptr ||
      plan == nullptr || reinterpret_cast<uintptr_t>(q4) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(s) % 16 != 0)
    return cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  HostPlan* p = static_cast<HostPlan*>(plan);
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)(K / 2)};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {BN, ROWS};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q4), dims, strides,
                      box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  memcpy(p->wmap, &map, sizeof map);
  p->s = static_cast<const float*>(s);
  p->K = K;
  p->N = N;
  p->device = device;
  p->pad = 0;
  return cudaSuccess;
}

// out [M, N] (f32, or bf16 with out_bf16) = x bf16 [M, K] (contiguous,
// 16-byte aligned) times the plan's weight, on `stream`. Split i covers
// group pairs [i * per, (i + 1) * per); splits <= 8. A split call needs
// N / 128 <= 256 and `workspace`: 256 int32 counters, zero (the kernel
// leaves them so), then room for the fp32 partials [splits, M, N]; calls
// that share a workspace must not run at once. Returns 0 or a cudaError_t
// code (cudaErrorInvalidValue for what the kernel does not take).
int leopard_int4_matmul(const void* plan, const void* x, void* out, void* workspace, int M,
                        int splits, int per, int out_bf16, void* stream) {
  const HostPlan* p = static_cast<const HostPlan*>(plan);
  if (p == nullptr || x == nullptr || out == nullptr || M < 1 || M > MAX_M ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  const int pairs = p->K / (2 * GROUP);
  if (splits < 1 || splits > MAX_SPLITS || per < 1 || (splits - 1) * per >= pairs ||
      splits * per < pairs ||
      (splits > 1 && (workspace == nullptr || p->N / BN > SPLIT_COUNTERS)))
    return cudaErrorInvalidValue;
  CUtensorMap map;
  memcpy(&map, p->wmap, sizeof map);
  int* counters = static_cast<int*>(workspace);
  float* partial = splits > 1 ? reinterpret_cast<float*>(counters + SPLIT_COUNTERS) : nullptr;
  const Args a{static_cast<const bf16*>(x), p->s, out, counters, partial, M, p->K, p->N, per,
               out_bf16 != 0};
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != p->device && (err = cudaSetDevice(p->device)) != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8)
    err = launch<1>(map, a, splits, p->device, st);
  else if (M <= 16)
    err = launch<2>(map, a, splits, p->device, st);
  else if (M <= 32)
    err = launch<4>(map, a, splits, p->device, st);
  else
    err = launch<8>(map, a, splits, p->device, st);
  if (current != p->device) cudaSetDevice(current);
  return err;
}

const char* leopard_int4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
