// LayerNorm over the last axis on NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel leopard_tpu/ops/pallas/norms.py (fused_layer_norm /
// _ln_kernel): y = (x - mean) * rsqrt(var + eps) * w + b over each row of
// x [rows, H], in fp32 in the order of ops/norms.py::layer_norm_ref (the
// mean, then the mean of (x - mean)^2; rsqrt; times w, plus b), cast to x's
// dtype (bf16, fp16 or fp32; w and b in any of the three).
//
// What bounds it on the H100: device memory. A row is read once and written
// once (4.6 KB at 1,152 bf16) for ~8 operations an element, so the work is
// bytes: 0.0298 ms at 3.35 TB/s for the tower's (21,632, 1,152). To reach
// that, every SM must keep tens of KB of loads in flight, and the
// statistics must not stall the loads behind them.
//
// Design:
//   - One warp a row. Each lane holds its H/32 elements in registers (36
//     at 1,152, 32 at 1,024), read from shared memory as 8- or 16-byte
//     vectors (the host picks the width: ops/fused_norms.py::vector_bytes;
//     1,152 bf16 is 288 8-byte vectors, 9 a lane). Both reductions are
//     __shfl_xor_sync butterflies: no shared memory, no __syncthreads, and
//     every lane ends with the same sum bit for bit. The output goes from
//     registers to device memory in the same vectors.
//   - Persistent blocks. The grid is min(ceil(rows / warps a block), SMs x
//     blocks resident an SM); each warp walks rows with a grid-wide stride
//     and loads w and b into registers once for all of them, in x's dtype
//     (exact in fp32), converted to fp32 where they are used.
//   - The next rows in flight, in shared memory. Each warp owns a ring of
//     kSlots row slots, each filled by one bulk copy (cp.async.bulk, the
//     TMA's 1-D form) that lane 0 issues and an mbarrier per slot
//     completes. The first kSlots rows are asked for before anything else;
//     a slot is asked for its next row as soon as every lane holds the row
//     it had, before that row is reduced and stored. So while a warp
//     reduces one row, its next two are on their way, and the registers
//     hold one row: 96-113 registers a thread (bf16), 16-20 warps an SM,
//     up to ~74 KB of rows in flight on an SM at 1,152 bf16.
//   - Each lane sums its elements, and then their squared deviations, in
//     fp32; the 32 lanes' sums are added in fp64 and rounded once to fp32
//     (see warp_mean): two fp32-to-fp64 conversions a lane and a row, not
//     two an element, so the statistics cost a few fp32 operations an
//     element on calls of a few thousand rows too.
//   - Why the rows wait in shared memory and not in a second register
//     buffer: two row buffers and w and b as fp32 registers take 124-207
//     registers a thread, so only 8-16 warps an SM, too few rows in flight
//     for calls of 4,616-5,408 rows. In the ring, what an SM keeps in
//     flight is bounded by its shared memory, not by its registers.
//   - Everything else takes a second kernel: rows wider than 1,152 (up to
//     MAX_WIDTH in ops/fused_norms.py), rows that the bulk copy cannot read
//     (a base or row stride off the 16-byte grid), w or b in another dtype
//     than x or off the vector grid, and loads narrower than 8 bytes (odd
//     widths). A warp a row, three passes over the row (sum, squared
//     deviations, output), the later two from L1/L2, w and b read per row.
//     No path of the models runs it (their LayerNorms are 1,024 and 1,152
//     wide, rows contiguous, parameters in x's dtype).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_common.cuh"  // mbarriers and bulk copies

namespace {

using bf16 = __nv_bfloat16;
using namespace leopard_tma;

constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 2;  // row slots a warp has in shared memory
constexpr int kBarBytes = kWarps * kSlots * 8;  // the slots' mbarriers, before the rows

enum DType { kBF16 = 0, kF16 = 1, kF32 = 2 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// V elements moved by one load or store instruction.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// Element i of w or b, whatever their dtype (the wide path).
__device__ __forceinline__ float load_param(const void* p, int64_t i, int dtype) {
  if (dtype == kF32) return static_cast<const float*>(p)[i];
  if (dtype == kBF16) return __bfloat162float(static_cast<const bf16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

// A copy of v that the compiler cannot see through: what is computed from
// it (w's and b's conversions to fp32) is computed again for each row, not
// hoisted out of the row loop into 72 more registers a thread.
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> opaque(const Vec<T, V>& v) {
  static_assert(sizeof(Vec<T, V>) % 4 == 0, "whole 32-bit words");
  Vec<T, V> out;
  const uint32_t* in = reinterpret_cast<const uint32_t*>(&v);
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(out) / 4); ++i)
    asm volatile("mov.b32 %0, %1;" : "=r"(o[i]) : "r"(in[i]));
  return out;
}

// The mean over the row's elements of the 32 lanes' fp32 partial sums:
// added in fp64 by a shuffle butterfly (each lane adds the same two values
// in either order, so every lane ends with the same bits), where the sum
// of 32 fp32 values is exact unless their magnitudes span more than ~2^24,
// then scaled by 1 / h in fp64 (a multiply, not a division, on the row's
// critical path; the fp32 result is the quotient's, but where the two
// fp64 values straddle an fp32 rounding boundary, ~2^-28 of rows) and
// rounded once to fp32.
__device__ __forceinline__ float warp_mean(float part, double inv_h) {
  double v = part;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return static_cast<float>(v * inv_h);
}

// The output, rounded as layer_norm_ref rounds it: each step in fp32,
// (x - mean) * rstd, times w, plus b, no fused multiply-add.
__device__ __forceinline__ float norm_out(float x, float mean, float rstd, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x - mean, rstd), w), b);
}

struct Args {
  const void* x;
  const void* w;
  const void* b;
  void* out;
  int64_t rows;
  int h;
  int64_t x_stride;    // elements between rows
  int64_t out_stride;
  float eps;
  int w_dtype;
  int b_dtype;
};

// The ring path: a warp a row, N vectors of V elements a lane (vector j of
// lane l is the row's vector 32 j + l, present where that is inside the
// row), rows fed through the warp's kSlots shared-memory slots. Needs x's
// base, row stride and row 16-byte aligned, and w and b in x's dtype,
// aligned to the vectors.
template <typename T, int V, int N>
__global__ void __launch_bounds__(kThreads) ln_ring_kernel(const Args a) {
  using Vt = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= a.rows) return;  // warp-uniform; no block-wide barrier follows
  const uint32_t row_bytes = a.h * static_cast<uint32_t>(sizeof(T));
  const int nvec = a.h / V;
  const double inv_h = 1.0 / a.h;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + warp * kSlots;
  unsigned char* ring = smem + kBarBytes + static_cast<size_t>(warp) * kSlots * row_bytes;
  const unsigned char* x = static_cast<const unsigned char*>(a.x);
  const int64_t x_row_bytes = a.x_stride * static_cast<int64_t>(sizeof(T));
  if (lane == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
    for (int s = 0; s < kSlots; ++s) {
      const int64_t r = row + s * warps;
      if (r < a.rows) {
        mbar_expect_tx(&bars[s], row_bytes);
        bulk_load(ring + s * row_bytes, x + r * x_row_bytes, row_bytes, &bars[s]);
      }
    }
  }
  __syncwarp();

  // w and b in registers, in x's dtype (exact in fp32), loaded once
  Vt w[N], b[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (32 * j + lane < nvec) {
      w[j] = static_cast<const Vt*>(a.w)[32 * j + lane];
      b[j] = static_cast<const Vt*>(a.b)[32 * j + lane];
    }

  int s = 0, parity = 0;
  while (true) {
    mbar_wait(&bars[s], parity);
    const Vt* src = reinterpret_cast<const Vt*>(ring + s * row_bytes);
    Vt buf[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (32 * j + lane < nvec) buf[j] = src[32 * j + lane];
    float sum[V] = {};
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (32 * j + lane < nvec) {
#pragma unroll
        for (int k = 0; k < V; ++k) sum[k] += to_f32(buf[j].v[k]);
      }
#pragma unroll
    for (int k = 1; k < V; ++k) sum[0] += sum[k];
    const float mean = warp_mean(sum[0], inv_h);
    // every lane holds its part of the row (the sum used it): the slot
    // takes the row kSlots ahead
    __syncwarp();
    const int64_t ahead = row + kSlots * warps;
    if (lane == 0 && ahead < a.rows) {
      mbar_expect_tx(&bars[s], row_bytes);
      bulk_load(ring + s * row_bytes, x + ahead * x_row_bytes, row_bytes, &bars[s]);
    }
    float q[V] = {};
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (32 * j + lane < nvec) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float d = to_f32(buf[j].v[k]) - mean;
          q[k] = __fmaf_rn(d, d, q[k]);
        }
      }
#pragma unroll
    for (int k = 1; k < V; ++k) q[0] += q[k];
    const float rstd = rsqrtf(warp_mean(q[0], inv_h) + a.eps);
    Vt* dst = reinterpret_cast<Vt*>(static_cast<T*>(a.out) + row * a.out_stride);
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (32 * j + lane < nvec) {
        const Vt wj = opaque(w[j]), bj = opaque(b[j]);
        Vt o;
#pragma unroll
        for (int k = 0; k < V; ++k)
          o.v[k] = from_f32<T>(
              norm_out(to_f32(buf[j].v[k]), mean, rstd, to_f32(wj.v[k]), to_f32(bj.v[k])));
        dst[32 * j + lane] = o;
      }
    row += warps;
    if (row >= a.rows) return;
    if (++s == kSlots) s = 0, parity ^= 1;
  }
}

// The wide path: any H, three passes over each row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) ln_wide_kernel(const Args a) {
  using Vt = Vec<T, V>;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int nvec = a.h / V;
  const double inv_h = 1.0 / a.h;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < a.rows; row += warps) {
    const Vt* src = reinterpret_cast<const Vt*>(static_cast<const T*>(a.x) + row * a.x_stride);
    // the ring kernel's order: V running sums a lane, then added together
    float s[V] = {};
    for (int c = lane; c < nvec; c += 32) {
      const Vt v = src[c];
#pragma unroll
      for (int k = 0; k < V; ++k) s[k] += to_f32(v.v[k]);
    }
#pragma unroll
    for (int k = 1; k < V; ++k) s[0] += s[k];
    const float mean = warp_mean(s[0], inv_h);
    float q[V] = {};
    for (int c = lane; c < nvec; c += 32) {
      const Vt v = src[c];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = to_f32(v.v[k]) - mean;
        q[k] = __fmaf_rn(d, d, q[k]);
      }
    }
#pragma unroll
    for (int k = 1; k < V; ++k) q[0] += q[k];
    const float rstd = rsqrtf(warp_mean(q[0], inv_h) + a.eps);
    Vt* dst = reinterpret_cast<Vt*>(static_cast<T*>(a.out) + row * a.out_stride);
    for (int c = lane; c < nvec; c += 32) {
      const Vt v = src[c];
      Vt o;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int64_t i = static_cast<int64_t>(c) * V + k;
        o.v[k] = from_f32<T>(norm_out(to_f32(v.v[k]), mean, rstd, load_param(a.w, i, a.w_dtype),
                                      load_param(a.b, i, a.b_dtype)));
      }
      dst[c] = o;
    }
  }
}

int sm_count(int device) {
  static int counts[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (counts[device] == 0)
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device);
  return counts[device];
}

// Blocks of one kernel an SM holds at `smem` bytes of dynamic shared memory,
// asked again only when `smem` changes.
struct Resident {
  int smem = -1;
  int blocks = 0;
};

// One persistent launch of `kernel`: no more blocks than the card holds at once.
template <typename Kernel>
cudaError_t launch(Kernel kernel, Resident& resident, int smem, const Args& a, int device,
                   cudaStream_t st) {
  if (resident.smem != smem) {
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident.blocks, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (resident.blocks < 1) return cudaErrorInvalidConfiguration;
    resident.smem = smem;
  }
  const int64_t wanted = (a.rows + kWarps - 1) / kWarps;
  const int64_t most = static_cast<int64_t>(sm_count(device)) * resident.blocks;
  const int grid = static_cast<int>(wanted < most ? wanted : most);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int V, int N>
cudaError_t launch_ring(const Args& a, int device, cudaStream_t st) {
  constexpr int kMaxSmem = kBarBytes + kWarps * kSlots * 32 * N * V * sizeof(T);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ln_ring_kernel<T, V, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  static Resident resident;
  const int smem = kBarBytes + kWarps * kSlots * a.h * static_cast<int>(sizeof(T));
  return launch(ln_ring_kernel<T, V, N>, resident, smem, a, device, st);
}

template <typename T, int V>
cudaError_t launch_wide(const Args& a, int device, cudaStream_t st) {
  static Resident resident;
  return launch(ln_wide_kernel<T, V>, resident, 0, a, device, st);
}

// The ring path where the bulk copy can read the rows, the vectors are 8 or
// 16 bytes and a lane holds at most 36 elements (H <= 1,152), in the
// smallest tier (32 or 36 elements a lane) that holds the row; else the
// wide kernel.
template <typename T, int V>
cudaError_t dispatch_width(const Args& a, bool ring, int device, cudaStream_t st) {
  const int per_lane = ((a.h / V + 31) / 32) * V;
  if constexpr (V * sizeof(T) >= 8) {
    if (ring && per_lane <= 32) return launch_ring<T, V, 32 / V>(a, device, st);
    if constexpr (36 % V == 0)
      if (ring && per_lane <= 36) return launch_ring<T, V, 36 / V>(a, device, st);
  }
  return launch_wide<T, V>(a, device, st);
}

template <typename T>
cudaError_t dispatch(const Args& a, int vec_bytes, bool ring, int device, cudaStream_t st) {
  switch (vec_bytes / static_cast<int>(sizeof(T))) {
    case 1: return dispatch_width<T, 1>(a, ring, device, st);
    case 2: return dispatch_width<T, 2>(a, ring, device, st);
    case 4: return dispatch_width<T, 4>(a, ring, device, st);
    case 8:
      if constexpr (sizeof(T) == 2) return dispatch_width<T, 8>(a, ring, device, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

extern "C" {

// out [rows, h] = LayerNorm of x [rows, h] (rows `x_stride` and `out_stride`
// elements apart, unit column stride) with w, b [h] contiguous, on `stream`
// of `device`. dtype: 0 bf16, 1 fp16, 2 fp32, for x and out; w_dtype and
// b_dtype the same codes. vec_bytes (16, 8, 4 or 2, at least the element
// size) must divide x, out, h bytes and, where rows > 1, both row strides in
// bytes. Returns 0 or a cudaError_t code (cudaErrorInvalidValue for what
// the kernel does not take).
int leopard_layer_norm(const void* x, const void* w, const void* b, void* out, long long rows,
                       int h, long long x_stride, long long out_stride, float eps, int dtype,
                       int w_dtype, int b_dtype, int vec_bytes, int device, void* stream) {
  const int size = dtype == kF32 ? 4 : 2;
  if (x == nullptr || w == nullptr || b == nullptr || out == nullptr || rows < 0 || h < 0 ||
      dtype < kBF16 || dtype > kF32 || w_dtype < kBF16 || w_dtype > kF32 || b_dtype < kBF16 ||
      b_dtype > kF32 || (vec_bytes != 16 && vec_bytes != 8 && vec_bytes != 4 && vec_bytes != 2) ||
      vec_bytes < size || (static_cast<long long>(h) * size) % vec_bytes != 0 ||
      !aligned(x, vec_bytes) || !aligned(out, vec_bytes) ||
      (rows > 1 && ((x_stride * size) % vec_bytes != 0 || (out_stride * size) % vec_bytes != 0)))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  // what the bulk copy reads (16-byte aligned rows, a multiple of 16
  // bytes) and the ring kernel's w and b (x's dtype, vector-aligned)
  const bool ring = aligned(x, 16) && (static_cast<long long>(h) * size) % 16 == 0 &&
                    (rows == 1 || (x_stride * size) % 16 == 0) && w_dtype == dtype &&
                    b_dtype == dtype && aligned(w, vec_bytes) && aligned(b, vec_bytes);
  const Args a{x, w, b, out, rows, h, x_stride, out_stride, eps, w_dtype, b_dtype};
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    err = dispatch<bf16>(a, vec_bytes, ring, device, st);
  else if (dtype == kF16)
    err = dispatch<__half>(a, vec_bytes, ring, device, st);
  else
    err = dispatch<float>(a, vec_bytes, ring, device, st);
  if (current != device) cudaSetDevice(current);
  return err;
}

const char* leopard_layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
