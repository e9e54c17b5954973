// RMSNorm with a fixed reduction order for Hopper (sm_90a).
//
// Replaces the reference's rms_norm (src/repro/models/common.py:78), which
// XLA fuses on the TPU (no Pallas kernel there). It runs before every
// attention and MLP block and before the lm_head:
//     y = (x · rsqrt(mean(x², -1) + eps)) · scale,   in f32, cast to x's dtype.
//
// Why a kernel: the serving engine's determinism contract needs a row's
// result to be independent of how many rows share the call. torch.mean's
// CUDA reduction picks its order from the tensor's shape, so on an H100 the
// rows of an (8, 1, 1536) call can round differently from the same rows
// inside an (8, 64, 1536) call; a request whose prompt ends in a one-token
// prefill bucket alone but in a wider bucket in a fleet could then change
// its greedy tokens. Here the order is fixed per row:
//   * one warp per row; lane l reads the 16-byte vectors l, l+32, l+64, ...
//     of the row and sums their squares in that order with fmaf;
//   * the 32 lane sums combine by an xor butterfly (offsets 16, 8, 4, 2, 1);
//     addition commutes, so every lane holds the same total;
//   * var = total / d; r = rsqrtf(var + eps); y = (x·r)·scale, each product
//     rounded on its own (no contraction), then rounded to x's dtype.
// Nothing in this depends on the number of rows, so rows are bit-identical
// whatever call they sit in.
//
// Bound on an H100 SXM: memory (x read once, y written once, scale read
// once per block from L2); at the main path's decode shape (8 rows of 1536
// bf16) that is 49 KB, far below a microsecond, so one call costs its
// launch. Design: 4 warps (4 rows) per block of 128 threads; the row is read
// twice, for the sum and for the scaling (the second read hits L1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int ROWS_PER_BLOCK = NTHREADS / 32;

template <typename T>
struct Vec;  // the 16 / sizeof(T) elements of a 16-byte vector
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // bf16 -> f32 is exact: the high 16 bits
      f[2 * c] = __uint_as_float(w[c] << 16);
      f[2 * c + 1] = __uint_as_float(w[c] & 0xffff0000u);
    }
  }
  __device__ static uint4 store(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * c]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * c + 1]));
      w[c] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float scale_at(const float* s, int i) { return s[i]; }
__device__ __forceinline__ float scale_at(const __nv_bfloat16* s, int i) {
  return __bfloat162float(s[i]);
}

template <typename T, typename TS>
__global__ void __launch_bounds__(NTHREADS)
    rms_norm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                    T* __restrict__ y, int rows, int d, float eps) {
  constexpr int EPV = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps exit together
  const int nvec = d / EPV;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  float ss = 0.0f;
  for (int e = lane; e < nvec; e += 32) {
    float f[EPV];
    Vec<T>::load(__ldg(xr + e), f);
#pragma unroll
    for (int c = 0; c < EPV; ++c) ss = fmaf(f[c], f[c], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), eps));

  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * d);
  for (int e = lane; e < nvec; e += 32) {  // the row again, from L1
    float f[EPV];
    Vec<T>::load(__ldg(xr + e), f);
#pragma unroll
    for (int c = 0; c < EPV; ++c)
      f[c] = __fmul_rn(__fmul_rn(f[c], r), scale_at(scale, e * EPV + c));
    yr[e] = Vec<T>::store(f);
  }
}

template <typename T, typename TS>
cudaError_t launch(const void* x, const void* scale, void* y, int rows, int d,
                   float eps, cudaStream_t s) {
  const dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  rms_norm_kernel<T, TS><<<grid, NTHREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale),
      static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_bf16: 0 -> x and y are f32, 1 -> bf16. scale_bf16: the same for scale.
// x, y: (rows, d) row-major, 16-byte aligned; d a multiple of the vector
// width (4 f32 or 8 bf16).
int rms_norm_launch(const void* x, int x_bf16, const void* scale, int scale_bf16,
                    void* y, int rows, int d, float eps, void* stream) {
  const int epv = x_bf16 ? 8 : 4;
  if (d <= 0 || d % epv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_bf16)
    e = scale_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d, eps, s)
                   : launch<__nv_bfloat16, float>(x, scale, y, rows, d, eps, s);
  else
    e = scale_bf16 ? launch<float, __nv_bfloat16>(x, scale, y, rows, d, eps, s)
                   : launch<float, float>(x, scale, y, rows, d, eps, s);
  return static_cast<int>(e);
}

}  // extern "C"
