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
//
// The backward (training), for rms_norm and add_rms_norm alike, in f32
// inside, with r = rsqrt(mean(x²) + eps), x̂ = x·r and ĝ = dy·scale:
//     dx     = r·(ĝ − x̂·mean(ĝ·x̂))        rounded to x's dtype; with the
//                                          gradient of add_rms_norm's x_new
//                                          (res), rounded again after + res
//     dscale = Σ_rows dy·x̂                 rounded to scale's dtype
// x is the norm's input (add_rms_norm's x_new). No float atomics, every sum
// in a fixed order that depends on (rows, d) only, so a training run is
// bit-reproducible. Bound on an H100 SXM: memory (x, dy and res read once,
// dx written once; the scale and the dscale partials are small beside
// them): 50 MB, 15 µs, a call at the training shape (4096 rows of 1536,
// bf16, with res). Two launches a call:
//   * norm_bwd_kernel: a block of W warps (W·32 threads) takes a fixed
//     tile of `tile_rows` consecutive rows; warp w takes the tile's rows
//     w, w + W, ... in order, one row at a time, as the forward: lane l
//     holds the row's 16-byte vectors l, l + 32, ... of x and dy (and, for
//     up to 6 vectors a lane, res) in registers (NV of them, a template
//     bound, for rows of up to 12 vectors a lane: d <= 3072 in bf16, d <=
//     1536 in f32), all loads issued before the first sum; r and mean(ĝ·x̂)
//     are summed lane-strided (fmaf) and reduced by the xor butterfly; dx
//     is computed per element, each product rounded alone, and written
//     from registers. Wider rows take a second pass over the row (from L1/L2),
//     as the forward does. Each warp adds dy·x̂ of its rows, in row order,
//     into a row of d f32 of shared memory of its own (a lane touches only
//     its own vectors' columns: no barrier); after the tile the block sums
//     its W rows in warp order into one f32 partial row per block;
//   * norm_bwd_scale_sum: each column's partials summed over the blocks in
//     block order, rounded to scale's dtype.
// The host picks W and the tile (repro_torch.kernels.rms_norm.ops.
// backward_tiling): tiles of 32 rows (4096 rows are 128 blocks on the 132
// SMs, one block an SM), W = 8 where 8 rows of d f32 fit in 128 KB of
// shared memory (d <= 4096), fewer above (16384: 2). At (t)'s shape a
// block is 8 warps, 48 KB of shared memory and NV = 6: nvcc -Xptxas -v
// (sm_90a) gives 122 registers a thread with res, 105 without, so two
// blocks an SM would fit, but the 128 blocks take one each. Every
// instantiation: 64-203 registers (NV = 12 the most), no spills. Tiles of
// 16 rows, 16 warps a block, and loading the next row while this one is
// computed were each no faster at (t)'s shape.

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

// ------------------------------------------------------------- backward
constexpr int BWD_MAX_WARPS = 8;
constexpr int BWD_MAX_NV = 12;     // vectors a lane holds in registers
constexpr int BWD_RES_NV = 6;      // ... with res's vectors beside them
constexpr int BWD_MAX_SMEM = 227 * 1024;

template <typename TS>
__device__ __forceinline__ TS from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// dx of one vector (EPV elements) from x, dy, the scale, r and mean(ĝ·x̂),
// res added after dx is rounded to T (RES); dy·x̂ added into acc (the
// warp's dscale row at the vector's columns).
template <typename T, typename TS, bool RES>
__device__ __forceinline__ uint4 bwd_vector(const uint4& xv, const uint4& gv,
                                            const uint4& rv,
                                            const ScaleVec<TS, Vec<T>::N>& s,
                                            float r, float mean_gx,
                                            float* __restrict__ acc) {
  constexpr int EPV = Vec<T>::N;
  float fx[EPV], fg[EPV], out[EPV];
  Vec<T>::load(xv, fx);
  Vec<T>::load(gv, fg);
  float4* a4 = reinterpret_cast<float4*>(acc);
  float a[EPV];
#pragma unroll
  for (int q = 0; q < EPV / 4; ++q) {
    const float4 t = a4[q];
    a[4 * q] = t.x; a[4 * q + 1] = t.y; a[4 * q + 2] = t.z; a[4 * q + 3] = t.w;
  }
#pragma unroll
  for (int c = 0; c < EPV; ++c) {
    const float g = __fmul_rn(fg[c], s.at(c));
    const float xh = __fmul_rn(fx[c], r);
    out[c] = __fmul_rn(r, __fsub_rn(g, __fmul_rn(xh, mean_gx)));
    a[c] = __fadd_rn(a[c], __fmul_rn(fg[c], xh));
  }
#pragma unroll
  for (int q = 0; q < EPV / 4; ++q)
    a4[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  uint4 v = Vec<T>::store(out);  // dx rounded to T
  if constexpr (RES) {
    float fr[EPV];
    Vec<T>::load(v, out);
    Vec<T>::load(rv, fr);
#pragma unroll
    for (int c = 0; c < EPV; ++c) out[c] = __fadd_rn(out[c], fr[c]);
    v = Vec<T>::store(out);
  }
  return v;
}

// Σ x² and Σ ĝ·x of one vector, in element order (fmaf, as the forward).
template <typename T, typename TS>
__device__ __forceinline__ void bwd_sums(const uint4& xv, const uint4& gv,
                                         const ScaleVec<TS, Vec<T>::N>& s,
                                         float& ss, float& gx) {
  constexpr int EPV = Vec<T>::N;
  float fx[EPV], fg[EPV];
  Vec<T>::load(xv, fx);
  Vec<T>::load(gv, fg);
#pragma unroll
  for (int c = 0; c < EPV; ++c) {
    ss = fmaf(fx[c], fx[c], ss);
    gx = fmaf(__fmul_rn(fg[c], s.at(c)), fx[c], gx);
  }
}

// r of the row (from Σ x² over the row's lanes) and mean(ĝ·x̂) (from the
// lane sums of ĝ·x): two xor butterflies.
__device__ __forceinline__ void bwd_row_stats(float ss, float gx, int d,
                                              float eps, float& r,
                                              float& mean_gx) {
  r = inv_rms(ss, d, eps);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    gx = __fadd_rn(gx, __shfl_xor_sync(0xffffffffu, gx, o));
  mean_gx = __fdiv_rn(__fmul_rn(r, gx), (float)d);
}

// The rows of one tile: dx of each row (a warp a row), and the tile's
// partial of dscale, partial[blockIdx.x][col] = Σ over the tile's rows of
// dy·x̂, summed per warp in row order and over the warps in warp order.
// NV > 0: the lane's vectors (at most NV) stay in registers; NV == 0: two
// passes over the row. Dynamic shared memory: W rows of d f32.
template <typename T, typename TS, int NV, bool RES>
__global__ void __launch_bounds__(BWD_MAX_WARPS * 32, (NV > 0 && NV <= 8) ? 2 : 1)
    norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const T* __restrict__ res, const TS* __restrict__ scale,
                    T* __restrict__ dx, float* __restrict__ partial, int rows,
                    int d, int tile_rows, float eps) {
  constexpr int EPV = Vec<T>::N;
  extern __shared__ __align__(16) float acc_s[];  // (W, d)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int nvec = d / EPV;
  float* acc = acc_s + (size_t)warp * d;
  for (int e = lane; e < nvec; e += 32)  // the lane's own columns only
#pragma unroll
    for (int q = 0; q < EPV / 4; ++q)
      reinterpret_cast<float4*>(acc + (size_t)e * EPV)[q] =
          make_float4(0.f, 0.f, 0.f, 0.f);
  const int r0 = blockIdx.x * tile_rows;
  const int r1 = min(rows, r0 + tile_rows);

  for (int row = r0 + warp; row < r1; row += warps) {
    const size_t off = (size_t)row * d;
    const uint4* xr = reinterpret_cast<const uint4*>(x + off);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + off);
    const uint4* rr = RES ? reinterpret_cast<const uint4*>(res + off) : nullptr;
    uint4* dr = reinterpret_cast<uint4*>(dx + off);
    float ss = 0.0f, gx = 0.0f, r, mean_gx;
    if constexpr (NV > 0) {
      constexpr bool RES_REGS = RES && NV <= BWD_RES_NV;
      uint4 xv[NV], gv[NV], rv[RES_REGS ? NV : 1];
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int e = lane + 32 * q;
        if (e < nvec) {
          xv[q] = __ldg(xr + e);
          gv[q] = __ldg(gr + e);
          if constexpr (RES_REGS) rv[q] = __ldg(rr + e);
        }
      }
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int e = lane + 32 * q;
        if (e < nvec) {
          ScaleVec<TS, EPV> s;
          s.load(scale, e);
          bwd_sums<T, TS>(xv[q], gv[q], s, ss, gx);
        }
      }
      bwd_row_stats(ss, gx, d, eps, r, mean_gx);
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int e = lane + 32 * q;
        if (e < nvec) {
          ScaleVec<TS, EPV> s;
          s.load(scale, e);
          uint4 rq = make_uint4(0u, 0u, 0u, 0u);
          if constexpr (RES_REGS) rq = rv[q];
          else if constexpr (RES) rq = __ldg(rr + e);
          dr[e] = bwd_vector<T, TS, RES>(xv[q], gv[q], rq, s, r, mean_gx,
                                         acc + (size_t)e * EPV);
        }
      }
    } else {
#pragma unroll 4
      for (int e = lane; e < nvec; e += 32) {
        ScaleVec<TS, EPV> s;
        s.load(scale, e);
        bwd_sums<T, TS>(__ldg(xr + e), __ldg(gr + e), s, ss, gx);
      }
      bwd_row_stats(ss, gx, d, eps, r, mean_gx);
#pragma unroll 4
      for (int e = lane; e < nvec; e += 32) {  // the row again, from L1/L2
        ScaleVec<TS, EPV> s;
        s.load(scale, e);
        const uint4 rq = RES ? __ldg(rr + e) : make_uint4(0u, 0u, 0u, 0u);
        dr[e] = bwd_vector<T, TS, RES>(__ldg(xr + e), __ldg(gr + e), rq, s, r,
                                       mean_gx, acc + (size_t)e * EPV);
      }
    }
  }
  __syncthreads();  // every warp's dscale row complete
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float sum = 0.0f;
    for (int w = 0; w < warps; ++w) sum = __fadd_rn(sum, acc_s[(size_t)w * d + col]);
    partial[(size_t)blockIdx.x * d + col] = sum;
  }
}

// dscale[col] = Σ over the tiles, in order, of partial[tile][col].
template <typename TS>
__global__ void __launch_bounds__(NTHREADS)
    norm_bwd_scale_sum(const float* __restrict__ partial,
                       TS* __restrict__ dscale, int n_tiles, int d) {
  const int col = blockIdx.x * NTHREADS + threadIdx.x;
  if (col >= d) return;
  float s = 0.0f;
  for (int t = 0; t < n_tiles; ++t)
    s = __fadd_rn(s, partial[(size_t)t * d + col]);
  dscale[col] = from_f32<TS>(s);
}

// Raise a kernel's dynamic shared-memory limit once per device when a launch
// needs more than it was given (a benign race at worst repeats the call).
template <typename K>
cudaError_t allow_smem(K kern, int smem, int* allowed) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && allowed[dev] >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < 64) allowed[dev] = smem;
  return e;
}

template <typename T, typename TS, bool RES, int NV>
cudaError_t launch_bwd_nv(const void* x, const void* dy, const void* res,
                          const void* scale, void* dx, float* partial,
                          int rows, int d, int tile_rows, int warps, float eps,
                          cudaStream_t s) {
  auto kern = norm_bwd_kernel<T, TS, NV, RES>;
  static int allowed[64] = {};
  const int smem = warps * d * (int)sizeof(float);
  cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  kern<<<(rows + tile_rows - 1) / tile_rows, warps * 32, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(res), static_cast<const TS*>(scale),
      static_cast<T*>(dx), partial, rows, d, tile_rows, eps);
  return cudaGetLastError();
}

template <typename T, typename TS, bool RES>
cudaError_t launch_bwd(const void* x, const void* dy, const void* res,
                       const void* scale, void* dx, void* dscale,
                       float* partial, int rows, int d, int tile_rows,
                       int warps, float eps, cudaStream_t s) {
  const int per_lane = (d / Vec<T>::N + 31) / 32;
  cudaError_t e;
#define NORM_BWD_NV(n)                                                        \
  if (per_lane <= n)                                                          \
    e = launch_bwd_nv<T, TS, RES, n>(x, dy, res, scale, dx, partial, rows, d, \
                                     tile_rows, warps, eps, s);               \
  else
  NORM_BWD_NV(4) NORM_BWD_NV(6) NORM_BWD_NV(8) NORM_BWD_NV(BWD_MAX_NV)
#undef NORM_BWD_NV
  e = launch_bwd_nv<T, TS, RES, 0>(x, dy, res, scale, dx, partial, rows, d,
                                   tile_rows, warps, eps, s);
  if (e != cudaSuccess) return e;
  const int n_tiles = (rows + tile_rows - 1) / tile_rows;
  norm_bwd_scale_sum<TS><<<(d + NTHREADS - 1) / NTHREADS, NTHREADS, 0, s>>>(
      partial, static_cast<TS*>(dscale), n_tiles, d);
  return cudaGetLastError();
}

template <typename T, typename TS>
cudaError_t launch_bwd_res(const void* x, const void* dy, const void* res,
                           const void* scale, void* dx, void* dscale,
                           float* partial, int rows, int d, int tile_rows,
                           int warps, float eps, cudaStream_t s) {
  return res ? launch_bwd<T, TS, true>(x, dy, res, scale, dx, dscale, partial,
                                       rows, d, tile_rows, warps, eps, s)
             : launch_bwd<T, TS, false>(x, dy, res, scale, dx, dscale, partial,
                                        rows, d, tile_rows, warps, eps, s);
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

// Backward of rms_norm (res null) or add_rms_norm (res: the gradient of
// x_new, added to dx after its rounding): x the norm's input, dy the
// gradient of its output, both (rows, d) like dx; dscale (d,) in scale's
// dtype. tile_rows rows a block, warps (1..8) warps a block (warps · d f32
// of shared memory); partial: (ceil(rows / tile_rows), d) f32 workspace.
// rows >= 1. Two launches on the stream.
int rms_norm_bwd_launch(const void* x, const void* dy, const void* res,
                        int x_bf16, const void* scale, int scale_bf16, void* dx,
                        void* dscale, void* partial, int rows, int d,
                        int tile_rows, int warps, float eps, void* stream) {
  const int epv = x_bf16 ? 8 : 4;
  if (d <= 0 || d % epv || rows <= 0 || tile_rows <= 0 || warps <= 0 ||
      warps > BWD_MAX_WARPS || (long long)warps * d * 4 > BWD_MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partial);
  using bf = __nv_bfloat16;
  cudaError_t e;
  if (x_bf16)
    e = scale_bf16
            ? launch_bwd_res<bf, bf>(x, dy, res, scale, dx, dscale, pt, rows, d, tile_rows, warps, eps, s)
            : launch_bwd_res<bf, float>(x, dy, res, scale, dx, dscale, pt, rows, d, tile_rows, warps, eps, s);
  else
    e = scale_bf16
            ? launch_bwd_res<float, bf>(x, dy, res, scale, dx, dscale, pt, rows, d, tile_rows, warps, eps, s)
            : launch_bwd_res<float, float>(x, dy, res, scale, dx, dscale, pt, rows, d, tile_rows, warps, eps, s);
  return static_cast<int>(e);
}

}  // extern "C"
