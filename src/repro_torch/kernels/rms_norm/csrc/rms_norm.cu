// RMSNorm with a fixed reduction order for Hopper (sm_90a), alone or fused
// with the residual add that precedes it.
//
// Replaces the reference's rms_norm (src/repro/models/common.py:78), which
// XLA fuses on the TPU with the residual add before it (no Pallas kernel
// there). It runs before every attention, MLP and recurrent block and
// before the lm_head:
//     y = (x · rsqrt(mean(x², -1) + eps)) · scale,   in f32, cast to x's dtype.
// add_rms_norm computes the residual stream's add and the norm after it in
// one launch:
//     x_new = x + delta            (in f32, rounded once to x's dtype, as
//                                   PyTorch's add of two such tensors)
//     h     = rms_norm(x_new)
// and writes both; every norm of a block's serving path that follows an
// add runs so (the one after the embedding runs rms_norm alone).
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
// whatever call they sit in, and add_rms_norm's h equals rms_norm of its
// x_new bit for bit (the same program on the same values).
//
// Bound on an H100 SXM: memory (x and delta read once, x_new and y written
// once, scale read once per block, from L2 after the first); at the main
// path's decode shape (8 rows of 1536 bf16) that is ≈ 100 KB, far below a
// microsecond, so a call costs its launch and its latency chain. Design:
//   * fusing the add removes a launch (and a round trip of x_new through
//     memory) from every norm that follows a residual add;
//   * 4 warps (4 rows) per block of 128 threads; a lane holds its vectors
//     of the row in registers (NV of them, a template bound, for rows of up
//     to 32 vectors a lane: d <= 8192 in bf16, d <= 4096 in f32), so the
//     row is read from memory once and the scaling needs no second read;
//     all of a lane's loads, and for rows of up to 12 vectors a lane the
//     scale's 16-byte vectors too, are issued before the first sum;
//   * wider rows (llama3-405b's 16384) take a second pass, which reads the
//     row again (x_new as this lane wrote it, or x) from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int ROWS_PER_BLOCK = NTHREADS / 32;
constexpr int MAX_NV = 32;         // vectors a lane holds in registers
constexpr int MAX_SCALE_NV = 12;   // ... with the scale's vectors beside them

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

// The EPV scale values that go with the e-th vector of a row, as loaded:
// 16-byte vectors (two for f32 scales of a bf16 row), or one 8-byte vector
// for the bf16 scales of an f32 row.
template <typename TS, int EPV>
struct ScaleVec {
  static constexpr int W = EPV * (int)sizeof(TS) / 4;  // 32-bit words
  uint32_t w[W];
  __device__ void load(const TS* s, int e) {
    const uint32_t* base = reinterpret_cast<const uint32_t*>(s) + (size_t)e * W;
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(base) + q);
        w[4 * q] = u.x;
        w[4 * q + 1] = u.y;
        w[4 * q + 2] = u.z;
        w[4 * q + 3] = u.w;
      }
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(base));
      w[0] = u.x;
      w[1] = u.y;
    }
  }
  __device__ float at(int c) const {
    if constexpr (sizeof(TS) == 4) return __uint_as_float(w[c]);
    return __uint_as_float(c % 2 ? (w[c / 2] & 0xffff0000u) : (w[c / 2] << 16));
  }
};

template <typename T>
__device__ __forceinline__ uint4 add_rounded(const uint4& a, const uint4& b) {
  constexpr int EPV = Vec<T>::N;
  float fa[EPV], fb[EPV];
  Vec<T>::load(a, fa);
  Vec<T>::load(b, fb);
#pragma unroll
  for (int c = 0; c < EPV; ++c) fa[c] = __fadd_rn(fa[c], fb[c]);
  return Vec<T>::store(fa);  // one rounding to T
}

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& u, float ss) {
  constexpr int EPV = Vec<T>::N;
  float f[EPV];
  Vec<T>::load(u, f);
#pragma unroll
  for (int c = 0; c < EPV; ++c) ss = fmaf(f[c], f[c], ss);
  return ss;
}

template <typename T, typename TS>
__device__ __forceinline__ uint4 scaled(const uint4& u, float r,
                                        const ScaleVec<TS, Vec<T>::N>& s) {
  constexpr int EPV = Vec<T>::N;
  float f[EPV];
  Vec<T>::load(u, f);
#pragma unroll
  for (int c = 0; c < EPV; ++c) f[c] = __fmul_rn(__fmul_rn(f[c], r), s.at(c));
  return Vec<T>::store(f);
}

__device__ __forceinline__ float inv_rms(float ss, int d, float eps) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  return rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), eps));
}

// NV > 0: the lane's vectors (at most NV) stay in registers; NV == 0: two
// passes over the row. ADD: x_new = x + delta is written to x_out and
// normed; otherwise x is normed (delta and x_out unused).
template <typename T, typename TS, int NV, bool ADD>
__global__ void __launch_bounds__(NTHREADS)
    norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                const TS* __restrict__ scale, T* __restrict__ x_out,
                T* __restrict__ y, int rows, int d, float eps) {
  constexpr int EPV = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps exit together
  const int nvec = d / EPV;
  const size_t off = (size_t)row * d;
  const uint4* xr = reinterpret_cast<const uint4*>(x + off);
  const uint4* dr = ADD ? reinterpret_cast<const uint4*>(delta + off) : nullptr;
  uint4* xo = ADD ? reinterpret_cast<uint4*>(x_out + off) : nullptr;
  uint4* yr = reinterpret_cast<uint4*>(y + off);
  float ss = 0.0f;

  if constexpr (NV > 0) {
    constexpr bool SCALE_REGS = NV <= MAX_SCALE_NV;
    uint4 v[NV];  // the lane's vectors of x_new (or x)
    ScaleVec<TS, EPV> sv[SCALE_REGS ? NV : 1];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int e = lane + 32 * q;
      if (e < nvec) {
        v[q] = __ldg(xr + e);
        if constexpr (SCALE_REGS) sv[q].load(scale, e);
      }
    }
    if constexpr (ADD) {
      uint4 dv[NV];
#pragma unroll
      for (int q = 0; q < NV; ++q)
        if (lane + 32 * q < nvec) dv[q] = __ldg(dr + lane + 32 * q);
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int e = lane + 32 * q;
        if (e < nvec) {
          v[q] = add_rounded<T>(v[q], dv[q]);
          xo[e] = v[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NV; ++q)
      if (lane + 32 * q < nvec) ss = sum_squares<T>(v[q], ss);
    const float r = inv_rms(ss, d, eps);
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int e = lane + 32 * q;
      if (e < nvec) {
        if constexpr (SCALE_REGS) {
          yr[e] = scaled<T, TS>(v[q], r, sv[q]);
        } else {
          ScaleVec<TS, EPV> s;
          s.load(scale, e);
          yr[e] = scaled<T, TS>(v[q], r, s);
        }
      }
    }
  } else {
    for (int e = lane; e < nvec; e += 32) {
      uint4 u = __ldg(xr + e);
      if constexpr (ADD) {
        u = add_rounded<T>(u, __ldg(dr + e));
        xo[e] = u;
      }
      ss = sum_squares<T>(u, ss);
    }
    const float r = inv_rms(ss, d, eps);
    for (int e = lane; e < nvec; e += 32) {  // the row again, from L1/L2
      ScaleVec<TS, EPV> s;
      s.load(scale, e);
      uint4 u;
      if constexpr (ADD)
        u = xo[e];  // x_new as this lane wrote it: a plain load, not __ldg
      else
        u = __ldg(xr + e);
      yr[e] = scaled<T, TS>(u, r, s);
    }
  }
}

template <typename T, typename TS, bool ADD, int NV>
cudaError_t launch_nv(const void* x, const void* delta, const void* scale,
                      void* x_out, void* y, int rows, int d, float eps,
                      cudaStream_t s) {
  const dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  norm_kernel<T, TS, NV, ADD><<<grid, NTHREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta),
      static_cast<const TS*>(scale), static_cast<T*>(x_out),
      static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

// The smallest register bound that holds a lane's vectors, or two passes.
template <typename T, typename TS, bool ADD>
cudaError_t launch(const void* x, const void* delta, const void* scale,
                   void* x_out, void* y, int rows, int d, float eps,
                   cudaStream_t s) {
  const int per_lane = (d / Vec<T>::N + 31) / 32;
#define NORM_NV(n)                                                          \
  if (per_lane <= n)                                                        \
    return launch_nv<T, TS, ADD, n>(x, delta, scale, x_out, y, rows, d, eps, s);
  NORM_NV(4) NORM_NV(8) NORM_NV(12) NORM_NV(16) NORM_NV(24) NORM_NV(MAX_NV)
#undef NORM_NV
  return launch_nv<T, TS, ADD, 0>(x, delta, scale, x_out, y, rows, d, eps, s);
}

template <bool ADD>
int dispatch(const void* x, const void* delta, int x_bf16, const void* scale,
             int scale_bf16, void* x_out, void* y, int rows, int d, float eps,
             void* stream) {
  const int epv = x_bf16 ? 8 : 4;
  if (d <= 0 || d % epv || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t e;
  if (x_bf16)
    e = scale_bf16 ? launch<bf, bf, ADD>(x, delta, scale, x_out, y, rows, d, eps, s)
                   : launch<bf, float, ADD>(x, delta, scale, x_out, y, rows, d, eps, s);
  else
    e = scale_bf16 ? launch<float, bf, ADD>(x, delta, scale, x_out, y, rows, d, eps, s)
                   : launch<float, float, ADD>(x, delta, scale, x_out, y, rows, d, eps, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// x_bf16: 0 -> x and y are f32, 1 -> bf16. scale_bf16: the same for scale.
// x, y: (rows, d) row-major, 16-byte aligned; d a multiple of the vector
// width (4 f32 or 8 bf16); scale (d,) 16-byte aligned.
int rms_norm_launch(const void* x, int x_bf16, const void* scale, int scale_bf16,
                    void* y, int rows, int d, float eps, void* stream) {
  return dispatch<false>(x, nullptr, x_bf16, scale, scale_bf16, nullptr, y,
                         rows, d, eps, stream);
}

// The same, with delta (x's shape and dtype) added first: x_out = x + delta
// and y = rms_norm(x_out). x_out and y must not overlap x or delta.
int add_rms_norm_launch(const void* x, const void* delta, int x_bf16,
                        const void* scale, int scale_bf16, void* x_out, void* y,
                        int rows, int d, float eps, void* stream) {
  return dispatch<true>(x, delta, x_bf16, scale, scale_bf16, x_out, y, rows, d,
                        eps, stream);
}

}  // extern "C"
