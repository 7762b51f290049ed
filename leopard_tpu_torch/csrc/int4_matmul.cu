// int4 weight matmul for decode on NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel leopard_tpu/ops/pallas/int4_matmul.py
// (int4_matmul / _kernel): out[M, N] f32 = x[M, K] (bf16) times an int4
// weight packed as q4 uint8 [K/2, N] ("split-half": byte (i, n) holds logical
// row i in its low nibble and row i + K/2 in its high nibble, offset-binary
// q + 8 with q in [-7, 7]) with f32 scales s [K/128, N], one per (128-row
// group, column). Needs 1 <= M <= 64, K % 256 == 0, N % 128 == 0.
//
// What bounds it on the H100: device memory. At decode (M = 2) each packed
// byte carries two weights, 4 FLOP, against 0.5 byte of weight read, far
// below the card's ~295 FLOP/byte ridge; even M = 64 stays under it. So the
// design reads the packed bytes once, coalesced, and never writes the
// dequantized weight anywhere:
//   - a block owns 128 output columns; each of its 128 threads owns 8
//     consecutive columns and reads them as one 8-byte load per packed row,
//     so a half-warp reads one 128-byte row segment; the 8 row lanes take
//     16 consecutive rows each of every 128-row group; a thread issues its
//     16 loads of the next group before it computes the current one, so
//     128 bytes a thread stay in flight under the arithmetic (device
//     memory's latency, not its bandwidth, bounded a first version that
//     kept one load in flight);
//   - nibbles are unpacked in registers (no int4 MMA on Hopper): a nibble v
//     OR-ed into the mantissa of 2^23 is the float 2^23 + v, so one OR and one
//     subtraction give v - 8 exactly; the weight is (v - 8) * s in fp32 and
//     feeds fp32 FMAs with x, which is staged per group in shared memory as
//     fp32. Both nibbles of a byte are used at once, x[:, i] with the low
//     one and x[:, i + K/2] with the high one: the TPU kernel's two dots;
//   - rows of x are processed MT at a time (MT = 1, 2, 4 or 8 from M), so the
//     accumulators (MT x 8 a thread) stay in registers; M > 8 re-reads the
//     weight once per 8 rows;
//   - N / 128 alone gives too few blocks for the narrow matrices (wk/wv at
//     N = 1,024: 8 blocks on 132 SMs), so K is split across blocks in whole
//     128-row groups; the splits write partials [splits, M, N] and a second
//     pass sums them in a fixed order: the result is deterministic, with no
//     atomics.
// Measured on an H100 SXM (80 GB HBM3, 700 W power limit) at the 8B decode
// shapes with M = 2, it reads 0.85-1.4 TB/s of packed weight, under the
// card's 3.35 TB/s: at about 12 instructions per packed byte (unpack, scale,
// FMAs), instruction issue bounds it, not memory. Dequantizing to bf16 for
// the tensor cores (mma.sync or wgmma), which would take about 4, TMA loads
// and persistent blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BN = 128;       // output columns per block
constexpr int CPT = 8;        // columns per thread: one 8-byte load
constexpr int TX = BN / CPT;  // 16 threads across the columns
constexpr int TY = 8;         // row lanes
constexpr int NT = TX * TY;   // 128 threads
constexpr int GROUP = 128;    // rows per scale group
constexpr int ROWS = GROUP / TY;  // consecutive rows of a group per thread
static_assert(NT == GROUP, "each thread stages one row of x per group");

// v - 8 for a nibble v, exactly: 0x4B000000 is 2^23, whose mantissa holds v
__device__ __forceinline__ float nibble_minus_8(uint32_t v) {
  return __int_as_float(0x4B000000u | v) - 8388616.0f;
}

template <int MT>
__global__ void __launch_bounds__(NT)
    int4_matmul_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ q4,
                       const float* __restrict__ s, float* __restrict__ dst, int M, int K,
                       int N, int groups_per_split) {
  __shared__ float xs[2][MT][GROUP];  // this group's x as fp32: [lo | hi][row][k]
  __shared__ float red[TY][MT][BN];   // row-lane partial sums
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int n0 = blockIdx.x * BN;
  const int col = n0 + tx * CPT;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int kh = K / 2;
  const int groups = kh / GROUP;  // packed-row groups; the high rows' scales follow them
  const int g0 = split * groups_per_split;
  const int g1 = min(groups, g0 + groups_per_split);
  const int r0 = ty * ROWS;  // this thread's rows of each group: [r0, r0 + ROWS)

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[m][j] = 0.f;

  // this thread's ROWS weight loads of a group, all in flight at once; the
  // next group's load while this group computes
  const uint8_t* qt = q4 + (size_t)r0 * N + col;
  const size_t group_stride = (size_t)GROUP * N;
  uint2 p[ROWS], p_next[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    p[i] = __ldg(reinterpret_cast<const uint2*>(qt + g0 * group_stride + (size_t)i * N));
  for (int g = g0; g < g1; ++g) {
    if (g + 1 < g1) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        p_next[i] = __ldg(reinterpret_cast<const uint2*>(qt + (g + 1) * group_stride + (size_t)i * N));
    }
    float slo[CPT], shi[CPT];
    {
      const float4* pl = reinterpret_cast<const float4*>(s + (size_t)g * N + col);
      const float4* ph = reinterpret_cast<const float4*>(s + (size_t)(g + groups) * N + col);
      const float4 a = __ldg(pl), b = __ldg(pl + 1), c = __ldg(ph), d = __ldg(ph + 1);
      slo[0] = a.x; slo[1] = a.y; slo[2] = a.z; slo[3] = a.w;
      slo[4] = b.x; slo[5] = b.y; slo[6] = b.z; slo[7] = b.w;
      shi[0] = c.x; shi[1] = c.y; shi[2] = c.z; shi[3] = c.w;
      shi[4] = d.x; shi[5] = d.y; shi[6] = d.z; shi[7] = d.w;
    }
    __syncthreads();  // every thread is done with the previous group's xs
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float lo = 0.f, hi = 0.f;
      if (m0 + m < M) {
        const bf16* xr = x + (size_t)(m0 + m) * K + (size_t)g * GROUP + tid;
        lo = __bfloat162float(xr[0]);
        hi = __bfloat162float(xr[kh]);
      }
      xs[0][m][tid] = lo;
      xs[1][m][tid] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      // x as scalars: float4 reads of xs put these arrays in local memory
      float xl[MT], xh[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        xl[m] = xs[0][m][r0 + i];
        xh[m] = xs[1][m][r0 + i];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const uint32_t byte = ((j < 4 ? p[i].x : p[i].y) >> (8 * (j & 3))) & 0xFFu;
        const float wl = nibble_minus_8(byte & 15u) * slo[j];
        const float wh = nibble_minus_8(byte >> 4) * shi[j];
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][j] = fmaf(xh[m], wh, fmaf(xl[m], wl, acc[m][j]));
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) p[i] = p_next[i];
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) red[ty][m][tx * CPT + j] = acc[m][j];
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m >= M) break;
    float v = 0.f;
#pragma unroll
    for (int t = 0; t < TY; ++t) v += red[t][m][tid];
    dst[((size_t)split * M + m0 + m) * N + n0 + tid] = v;
  }
}

// out = sum over splits of partial[split], in split order
__global__ void sum_splits_kernel(const float4* __restrict__ partial, float4* __restrict__ out,
                                  int splits, int count4) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count4; i += gridDim.x * blockDim.x) {
    float4 a = partial[i];
    for (int sp = 1; sp < splits; ++sp) {
      const float4 b = partial[(size_t)sp * count4 + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    out[i] = a;
  }
}

template <int MT>
void launch(const bf16* x, const uint8_t* q4, const float* s, float* dst, int M, int K, int N,
            int splits, int groups_per_split, cudaStream_t stream) {
  dim3 grid(N / BN, splits, (M + MT - 1) / MT);
  int4_matmul_kernel<MT><<<grid, NT, 0, stream>>>(x, q4, s, dst, M, K, N, groups_per_split);
}

}  // namespace

extern "C" {

// x bf16 [M, K], q4 uint8 [K/2, N], s f32 [K/128, N], out f32 [M, N], all
// contiguous; partial f32 [splits, M, N] when splits > 1, else unused. Split
// i covers packed-row groups [i * groups_per_split, (i + 1) * groups_per_split).
// Returns 0 or a cudaError_t code (cudaErrorInvalidValue for shapes the
// kernel does not take).
int leopard_int4_matmul(const void* x, const void* q4, const void* s, void* out, void* partial,
                        int M, int K, int N, int splits, int groups_per_split, void* stream) {
  if (M < 1 || M > 64 || K <= 0 || K % 256 != 0 || N <= 0 || N % BN != 0)
    return cudaErrorInvalidValue;
  const int groups = K / 2 / GROUP;
  if (splits < 1 || groups_per_split < 1 || (splits - 1) * groups_per_split >= groups ||
      splits * groups_per_split < groups || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* qb = static_cast<const uint8_t*>(q4);
  const float* sb = static_cast<const float*>(s);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  if (M == 1)
    launch<1>(xb, qb, sb, dst, M, K, N, splits, groups_per_split, st);
  else if (M == 2)
    launch<2>(xb, qb, sb, dst, M, K, N, splits, groups_per_split, st);
  else if (M <= 4)
    launch<4>(xb, qb, sb, dst, M, K, N, splits, groups_per_split, st);
  else
    launch<8>(xb, qb, sb, dst, M, K, N, splits, groups_per_split, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int count4 = M * N / 4;
  const int blocks = min((count4 + 255) / 256, 1024);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(static_cast<const float4*>(partial),
                                            static_cast<float4*>(out), splits, count4);
  return cudaGetLastError();
}

const char* leopard_int4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
