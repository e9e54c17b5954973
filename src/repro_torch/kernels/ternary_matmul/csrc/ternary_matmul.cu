// PTQTP ternary matmul for Hopper (sm_90a): y = x · Ŵᵀ, Ŵ = α¹∘T¹ + α²∘T².
//
// Replaces the two Pallas TPU kernels of the reference package:
//   ternary_matvec_pallas  (src/repro/kernels/ternary_matmul/kernel.py:175)
//       -> ternary_matvec_kernel below, every linear layer at decode (m < 128)
//   ternary_matmul_pallas  (src/repro/kernels/ternary_matmul/kernel.py:91)
//       -> ternary_matmul_kernel below, prefill chunks with m >= 128
//
// Inputs: x (m, d) f32 or bf16, row-major; t1p, t2p (n, d/4) uint8 packed
// trit-planes (field 0b01 = +1, 0b10 = -1, trit j at bits 2(j%4) of byte
// j/4); alpha (n, d/G, 2) f32. Output y (m, n) f32, or bf16 when x is bf16
// (the f32 result rounded to nearest even, as a cast of it would round).
//
// Arithmetic order (the batch-invariance contract). For every output (i, j)
// both kernels compute exactly
//     acc = 0
//     for g in 0 .. d/G-1:                      (groups in order)
//         s1 = s2 = 0
//         for k in g*G .. g*G+G-1:              (ascending)
//             s1 = fmaf(x[i,k], t1[j,k], s1);  s2 = fmaf(x[i,k], t2[j,k], s2)
//         acc = acc + (s1*α¹[j,g] + s2*α²[j,g])  (round-to-nearest, no FMA)
// so a row's result depends neither on m nor on which kernel ran it: the
// matvec and the tiled kernel give bit-identical rows, and a request's
// logits do not depend on what shares its batch or chunk.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 FMA outside the tensor
// cores, 989 TFLOP/s bf16 tensor cores):
//   * matvec: memory in principle. Per call it must read both planes
//     (n·d/2 bytes) and α (8·n·d/G bytes); x and y are small. But at 8 rows
//     of x the two planes cost 16 f32 FMAs per packed weight pair, which at
//     the FMA pipes' rate takes longer than reading the planes: in practice
//     it is bound by instruction issue. Design: one lane per output column
//     j, 32 columns per block, one warp per group g of those columns (up to
//     16 warps; past 16 groups a warp takes every 16th). A lane reads its
//     column's group of each plane with 16-byte loads (whole 32-byte
//     sectors). The warp first stages the group's x (8 rows × G) as f32 in
//     its own slice of shared memory, so x is converted once per warp and
//     every lane then reads the same values in 16-byte broadcast loads. The
//     per-group partials of up to 8 rows of x go to shared memory; one
//     thread per (row, column) then adds them in group order. No split-K.
//   * tiled kernel: operations. 2·m·n·d multiply-adds per plane pair on the
//     f32 FMA pipes, against the 989 TFLOP/s a tensor-core GEMM could reach
//     on the same product: this kernel keeps the exact order above instead
//     (wgmma sums in another order and is later work). Design: a 64×64
//     output tile per block of 128 threads, 8×4 outputs per thread with its
//     per-group sums s1, s2 and its acc in registers. d is walked in steps
//     of 32 (a group is G/32 steps). Each step stages x (32×64 f32) and both
//     plane tiles, unpacked to f32 trits, k-major in shared memory, so a
//     thread reads its 8 x values and 4+4 trits of one k as four 16-byte
//     loads for 64 FMAs; the next step's x and planes are fetched into
//     registers while this step computes. Ragged m and n edges are masked,
//     never padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 2-bit field q of a packed word -> trit as float: 1 -> +1, 2 -> -1,
// 0 (and unused 3) -> 0. Trit q of 4 little-endian bytes sits at bits 2q.
__device__ __forceinline__ float trit(uint32_t word, int q) {
  uint32_t f = (word >> (2 * q)) & 3u;
  return (f == 1u) ? 1.0f : ((f == 2u) ? -1.0f : 0.0f);
}

__device__ __forceinline__ float group_term(float s1, float s2, float a1,
                                            float a2) {
  return __fadd_rn(__fmul_rn(s1, a1), __fmul_rn(s2, a2));
}

// y is f32, or bf16 rounded to nearest even
__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// four adjacent outputs in one 16-byte (f32) or 8-byte (bf16) store
__device__ __forceinline__ void store_y4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_y4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

constexpr int MV_COLS = 32;       // output columns per block (one per lane)
constexpr int MV_MAX_WARPS = 16;  // warps per block: one per group, up to 16
constexpr int MV_ROWS = 8;        // rows of x per pass

// the 16 / sizeof(T) values of x in one 16-byte vector, as f32
template <typename T>
__device__ __forceinline__ void vec_to_f32(const uint4& u,
                                           float (&out)[16 / sizeof(T)]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (sizeof(T) == 4) {
      out[c] = __uint_as_float(w[c]);
    } else {  // bf16 -> f32 is exact: the high 16 bits
      out[2 * c] = __uint_as_float(w[c] << 16);
      out[2 * c + 1] = __uint_as_float(w[c] & 0xffff0000u);
    }
  }
}

// the NW 32-bit words (16 trits each) of one group of one plane row, in
// 16-byte loads (8-byte loads when the group has only 8 bytes, G = 32)
template <int NW>
__device__ __forceinline__ void load_words(const uint8_t* p,
                                           uint32_t (&w)[NW]) {
  if constexpr (NW % 4 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 u = __ldg(q + i);
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else {
    const uint2* q = reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) {
      const uint2 u = __ldg(q + i);
      w[2 * i] = u.x;
      w[2 * i + 1] = u.y;
    }
  }
}

// ---------------------------------------------------------------- matvec
template <typename T, typename TY, int G>
__global__ void __launch_bounds__(MV_COLS* MV_MAX_WARPS)
    ternary_matvec_kernel(const T* __restrict__ x,
                          const uint8_t* __restrict__ t1p,
                          const uint8_t* __restrict__ t2p,
                          const float* __restrict__ alpha,
                          TY* __restrict__ y, int m, int n, int d) {
  constexpr int NW = G / 16;                // 32-bit words of one group, one plane
  constexpr int EPV = 16 / (int)sizeof(T);  // x values per 16-byte vector
  constexpr int XV = MV_ROWS * G / EPV / 32;  // x vectors per lane per group
  extern __shared__ __align__(16) float smem[];
  const int ng = d / G;
  const int nwarps = blockDim.x / 32;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float* partial = smem;  // [MV_ROWS][ng][MV_COLS] group terms
  float* xw = smem + (size_t)MV_ROWS * ng * MV_COLS + (size_t)warp * MV_ROWS * G;
  const int j = blockIdx.x * MV_COLS + lane;
  const bool col_ok = j < n;
  const int jc = col_ok ? j : n - 1;  // lanes past n read a valid row; dropped
  const size_t row_bytes = (size_t)d / 4;
  const uint8_t* p1 = t1p + (size_t)jc * row_bytes;
  const uint8_t* p2 = t2p + (size_t)jc * row_bytes;
  const float2* a_row = reinterpret_cast<const float2*>(alpha) + (size_t)jc * ng;

  for (int m0 = 0; m0 < m; m0 += MV_ROWS) {
    const int mr = min(MV_ROWS, m - m0);
    for (int g = warp; g < ng; g += nwarps) {
      uint32_t w1[NW], w2[NW];
      load_words<NW>(p1 + (size_t)g * (G / 4), w1);
      load_words<NW>(p2 + (size_t)g * (G / 4), w2);
      const float2 a = __ldg(a_row + g);
      // this group's columns of the pass's rows of x, as f32, into the
      // warp's own slice of shared memory (rows past m repeat row m-1;
      // their partials are never summed)
      uint4 xr[XV];
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        const int v = lane + 32 * i, r = v / (G / EPV), c = (v % (G / EPV)) * EPV;
        xr[i] = __ldg(reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + min(r, mr - 1)) * d + (size_t)g * G + c));
      }
      __syncwarp();  // the warp is done reading its previous group's x
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        const int v = lane + 32 * i, r = v / (G / EPV), c = (v % (G / EPV)) * EPV;
        float f[EPV];
        vec_to_f32<T>(xr[i], f);
#pragma unroll
        for (int q = 0; q < EPV; q += 4)
          *reinterpret_cast<float4*>(xw + r * G + c + q) =
              make_float4(f[q], f[q + 1], f[q + 2], f[q + 3]);
      }
      __syncwarp();
      float s1[MV_ROWS], s2[MV_ROWS];
#pragma unroll
      for (int r = 0; r < MV_ROWS; ++r) s1[r] = s2[r] = 0.0f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        float u1[16], u2[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          u1[e] = trit(w1[w], e);
          u2[e] = trit(w2[w], e);
        }
#pragma unroll
        for (int r = 0; r < MV_ROWS; ++r) {
          const float4* xq = reinterpret_cast<const float4*>(xw + r * G + 16 * w);
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // broadcast: every lane reads the same x
            const float4 f = xq[i];
            s1[r] = fmaf(f.x, u1[4 * i], s1[r]);
            s2[r] = fmaf(f.x, u2[4 * i], s2[r]);
            s1[r] = fmaf(f.y, u1[4 * i + 1], s1[r]);
            s2[r] = fmaf(f.y, u2[4 * i + 1], s2[r]);
            s1[r] = fmaf(f.z, u1[4 * i + 2], s1[r]);
            s2[r] = fmaf(f.z, u2[4 * i + 2], s2[r]);
            s1[r] = fmaf(f.w, u1[4 * i + 3], s1[r]);
            s2[r] = fmaf(f.w, u2[4 * i + 3], s2[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MV_ROWS; ++r)
        partial[((size_t)r * ng + g) * MV_COLS + lane] =
            group_term(s1[r], s2[r], a.x, a.y);
    }
    __syncthreads();
    // one thread per (row, column): add the group partials in group order
    for (int r = warp; r < mr && col_ok; r += nwarps) {
      float acc = 0.0f;
      for (int g = 0; g < ng; ++g)
        acc = __fadd_rn(acc, partial[((size_t)r * ng + g) * MV_COLS + lane]);
      store_y(y + (size_t)(m0 + r) * n + j, acc);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ tiled matmul
// 64×64 output tile per block of 128 threads: thread (tx, ty) owns rows
// ty*8 .. ty*8+7 and columns tx*4 .. tx*4+3 of the tile.
constexpr int MM_BM = 64, MM_BN = 64, MM_BK = 32, MM_TM = 8, MM_TN = 4;
constexpr int MM_THREADS = (MM_BM / MM_TM) * (MM_BN / MM_TN);  // 128

template <typename T, typename TY>
__global__ void __launch_bounds__(MM_THREADS)
    ternary_matmul_kernel(const T* __restrict__ x,
                          const uint8_t* __restrict__ t1p,
                          const uint8_t* __restrict__ t2p,
                          const float* __restrict__ alpha,
                          TY* __restrict__ y, int m, int n, int d, int G) {
  // k-major tiles, so a thread's 8 rows (4 columns) of one k are adjacent
  __shared__ __align__(16) float xs[MM_BK][MM_BM];
  __shared__ __align__(16) float u1s[MM_BK][MM_BN];
  __shared__ __align__(16) float u2s[MM_BK][MM_BN];
  __shared__ float2 as[MM_BN];
  const int tid = threadIdx.x;
  const int tx = tid % (MM_BN / MM_TN), ty = tid / (MM_BN / MM_TN);
  const int i0 = blockIdx.y * MM_BM, j0 = blockIdx.x * MM_BN;
  const int ng = d / G, spg = G / MM_BK, n_steps = d / MM_BK;

  // staging: thread tid fetches 16 of a step's 32 x values of tile row
  // tid/2, and 16 trits (4 bytes) of each plane of tile column tid/2
  const int sr = tid / 2, sh = tid % 2;
  const bool x_ok = i0 + sr < m, p_ok = j0 + sr < n;
  const T* xp = x + (size_t)(x_ok ? i0 + sr : 0) * d + 16 * sh;
  const size_t p_off = (size_t)(p_ok ? j0 + sr : 0) * (d / 4) + 4 * sh;
  uint4 xv[sizeof(T)];
#pragma unroll
  for (int i = 0; i < (int)sizeof(T); ++i) xv[i] = make_uint4(0u, 0u, 0u, 0u);
  uint32_t w1 = 0u, w2 = 0u;  // rows past n stay all-zero trits
  auto fetch = [&](int s) {   // global -> registers for step s
    const int k0 = s * MM_BK;
    if (x_ok) {
      const uint4* q = reinterpret_cast<const uint4*>(xp + k0);
#pragma unroll
      for (int i = 0; i < (int)sizeof(T); ++i) xv[i] = __ldg(q + i);
    }
    if (p_ok) {
      w1 = __ldg(reinterpret_cast<const uint32_t*>(t1p + p_off + k0 / 4));
      w2 = __ldg(reinterpret_cast<const uint32_t*>(t2p + p_off + k0 / 4));
    }
  };

  float acc[MM_TM][MM_TN], s1[MM_TM][MM_TN], s2[MM_TM][MM_TN];
#pragma unroll
  for (int a = 0; a < MM_TM; ++a)
#pragma unroll
    for (int b = 0; b < MM_TN; ++b) acc[a][b] = s1[a][b] = s2[a][b] = 0.0f;

  fetch(0);
  for (int s = 0; s < n_steps; ++s) {
    const int g = s / spg, sg = s % spg;
    __syncthreads();  // every thread is done with the previous step's tiles
#pragma unroll
    for (int i = 0; i < (int)sizeof(T); ++i) {
      constexpr int EPV = 16 / (int)sizeof(T);
      float f[EPV];
      vec_to_f32<T>(xv[i], f);
#pragma unroll
      for (int e = 0; e < EPV; ++e) xs[16 * sh + EPV * i + e][sr] = f[e];
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      u1s[16 * sh + e][sr] = trit(w1, e);
      u2s[16 * sh + e][sr] = trit(w2, e);
    }
    if (sg == 0 && tid < MM_BN)
      as[tid] = (j0 + tid < n)
                    ? reinterpret_cast<const float2*>(alpha)[(size_t)(j0 + tid) * ng + g]
                    : make_float2(0.0f, 0.0f);
    __syncthreads();
    if (s + 1 < n_steps) fetch(s + 1);  // in flight while this step computes
#pragma unroll
    for (int k = 0; k < MM_BK; ++k) {
      const float4 xa = *reinterpret_cast<const float4*>(&xs[k][ty * MM_TM]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[k][ty * MM_TM + 4]);
      const float4 v1 = *reinterpret_cast<const float4*>(&u1s[k][tx * MM_TN]);
      const float4 v2 = *reinterpret_cast<const float4*>(&u2s[k][tx * MM_TN]);
      const float xr[MM_TM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float c1[MM_TN] = {v1.x, v1.y, v1.z, v1.w};
      const float c2[MM_TN] = {v2.x, v2.y, v2.z, v2.w};
#pragma unroll
      for (int a = 0; a < MM_TM; ++a)
#pragma unroll
        for (int b = 0; b < MM_TN; ++b) {
          s1[a][b] = fmaf(xr[a], c1[b], s1[a][b]);
          s2[a][b] = fmaf(xr[a], c2[b], s2[a][b]);
        }
    }
    if (sg == spg - 1) {  // group done: fold it into acc, in group order
#pragma unroll
      for (int b = 0; b < MM_TN; ++b) {
        const float2 al = as[tx * MM_TN + b];
#pragma unroll
        for (int a = 0; a < MM_TM; ++a) {
          acc[a][b] = __fadd_rn(acc[a][b], group_term(s1[a][b], s2[a][b], al.x, al.y));
          s1[a][b] = s2[a][b] = 0.0f;
        }
      }
    }
  }
  const int j = j0 + tx * MM_TN;
#pragma unroll
  for (int a = 0; a < MM_TM; ++a) {
    const int i = i0 + ty * MM_TM + a;
    if (i >= m) continue;
    TY* yr = y + (size_t)i * n;
    if (n % 4 == 0 && j + MM_TN <= n) {
      store_y4(yr + j, acc[a]);
    } else {
#pragma unroll
      for (int b = 0; b < MM_TN; ++b)
        if (j + b < n) store_y(yr + j + b, acc[a][b]);
    }
  }
}

template <typename T, typename TY, int G>
cudaError_t launch_matvec(const void* x, const void* t1p, const void* t2p,
                          const void* alpha, void* y, int m, int n, int d,
                          cudaStream_t stream) {
  const int ng = d / G;
  const int nwarps = ng < MV_MAX_WARPS ? ng : MV_MAX_WARPS;
  const size_t smem =
      sizeof(float) * MV_ROWS * ((size_t)ng * MV_COLS + (size_t)nwarps * G);
  auto kern = ternary_matvec_kernel<T, TY, G>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((n + MV_COLS - 1) / MV_COLS);
  kern<<<grid, MV_COLS * nwarps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(t1p),
      static_cast<const uint8_t*>(t2p), static_cast<const float*>(alpha),
      static_cast<TY*>(y), m, n, d);
  return cudaGetLastError();
}

template <typename T, typename TY>
cudaError_t launch_matvec_g(int G, const void* x, const void* t1p,
                            const void* t2p, const void* alpha, void* y, int m,
                            int n, int d, cudaStream_t s) {
  switch (G) {
    case 32: return launch_matvec<T, TY, 32>(x, t1p, t2p, alpha, y, m, n, d, s);
    case 64: return launch_matvec<T, TY, 64>(x, t1p, t2p, alpha, y, m, n, d, s);
    case 128: return launch_matvec<T, TY, 128>(x, t1p, t2p, alpha, y, m, n, d, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename TY>
cudaError_t launch_matmul(const void* x, const void* t1p, const void* t2p,
                          const void* alpha, void* y, int m, int n, int d,
                          int G, cudaStream_t s) {
  if (G % MM_BK) return cudaErrorInvalidValue;
  dim3 grid((n + MM_BN - 1) / MM_BN, (m + MM_BM - 1) / MM_BM);
  ternary_matmul_kernel<T, TY><<<grid, MM_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(t1p),
      static_cast<const uint8_t*>(t2p), static_cast<const float*>(alpha),
      static_cast<TY*>(y), m, n, d, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_bf16: 0 -> x is f32, 1 -> x is bf16. y_bf16: 0 -> y is f32, 1 -> y is
// bf16 (only with bf16 x). Group size G in {32, 64, 128}.
int ternary_matvec_launch(const void* x, int x_bf16, const void* t1p,
                          const void* t2p, const void* alpha, void* y,
                          int y_bf16, int m, int n, int d, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!x_bf16)
    e = y_bf16 ? cudaErrorInvalidValue
               : launch_matvec_g<float, float>(G, x, t1p, t2p, alpha, y, m, n, d, s);
  else if (y_bf16)
    e = launch_matvec_g<__nv_bfloat16, __nv_bfloat16>(G, x, t1p, t2p, alpha, y, m,
                                                      n, d, s);
  else
    e = launch_matvec_g<__nv_bfloat16, float>(G, x, t1p, t2p, alpha, y, m, n, d, s);
  return static_cast<int>(e);
}

// The same arguments; G must be a multiple of 32 (one staged step is 32
// columns of d).
int ternary_matmul_launch(const void* x, int x_bf16, const void* t1p,
                          const void* t2p, const void* alpha, void* y,
                          int y_bf16, int m, int n, int d, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!x_bf16)
    e = y_bf16 ? cudaErrorInvalidValue
               : launch_matmul<float, float>(x, t1p, t2p, alpha, y, m, n, d, G, s);
  else if (y_bf16)
    e = launch_matmul<__nv_bfloat16, __nv_bfloat16>(x, t1p, t2p, alpha, y, m, n, d,
                                                    G, s);
  else
    e = launch_matmul<__nv_bfloat16, float>(x, t1p, t2p, alpha, y, m, n, d, G, s);
  return static_cast<int>(e);
}

}  // extern "C"
