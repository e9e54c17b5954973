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
// Two routes, chosen by x's dtype in the launchers at the bottom of this
// file (``mma_route``): bf16 x (the full-width serving dtype) runs on the
// tensor cores, f32 x on the FMA kernels.
//
// Arithmetic order (the batch-invariance contract). Both routes give, for
// every output (token i, feature j), a result that depends neither on m nor
// on which kernel ran the row nor on the row's neighbours: the matvec and
// the tiled kernel give bit-identical rows, and a request's logits do not
// depend on what shares its batch or chunk.
//
//   bf16 x, tensor cores. Both kernels run the shared tile routine
//   (``a_fragment``, ``chunk_mma`` and ``group_term`` below) in this order
//   exactly:
//     acc = 0
//     for g in 0 .. d/G-1:                            (groups in order)
//         p1 = p2 = 0                                 (fresh per group, C = 0)
//         for c in 0 .. G/16-1:                       (k16 chunks in order)
//             p1 = mma_m16n8k16(T1[j, g*G+16c : +16], x[i, same k], p1)
//             p2 = mma_m16n8k16(T2[j, ...],           x[i, ...],    p2)
//         acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(p1, a1[j,g]),
//                                        __fmul_rn(p2, a2[j,g])))
//   with mma_m16n8k16 = mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//   Trits are exact in bf16 and x already is bf16, so every product is
//   exact; the result then depends only on the instruction and this order.
//   The weights are the A operand (16 features by 16 k), x the B operand
//   (16 k by 8 tokens), so one tile shape serves both kernels. Lane
//   (gid = lane/4, tig = lane%4) builds its A registers straight from the
//   packed words: trit k of a k16 chunk sits at bits 2k of the chunk's
//   32-bit word, and the lane's registers a0..a3 are the nibbles at bits
//   4*tig and 4*tig+16 of rows gid and gid+8 (a0 = row gid low k, a1 = row
//   gid+8 low k, a2 = row gid k+8, a3 = row gid+8 k+8), each mapped to one
//   bf16x2 (field 01 -> +1 = 0x3F80, 10 -> -1 = 0xBF80, 00 and 11 -> 0, the
//   lower k in the low half). ``NIBBLE_BF16X2`` and ``a_fragment`` in
//   ../ops.py state that table and those offsets in Python, and
//   ``trit_pairs`` there mirrors the byte permute that computes them here;
//   tests/test_torch_kernels.py holds them against the reference unpacking.
//
//   f32 x, FMA pipes. Both kernels compute exactly
//     acc = 0
//     for g in 0 .. d/G-1:                      (groups in order)
//         s1 = s2 = 0
//         for k in g*G .. g*G+G-1:              (ascending)
//             s1 = fmaf(x[i,k], t1[j,k], s1);  s2 = fmaf(x[i,k], t2[j,k], s2)
//         acc = acc + (s1*a1[j,g] + s2*a2[j,g])  (round-to-nearest, no FMA)
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 FMA outside the tensor
// cores, 989 TFLOP/s bf16 tensor cores):
//   * matvec: bytes. Per call it must read both planes (n*d/2 bytes) and
//     alpha (8*n*d/G bytes); x and y are small.
//     - tensor cores (``ternary_matvec_mma_kernel``): one block owns 16
//       features (one m16 tile), and its warps split the groups (warp w takes
//       groups w, w+W, ...; up to 16 warps). A lane loads its two rows' group
//       words of both planes in 16-byte loads and its token's x pairs from
//       global memory, runs the group's 2*G/16 MMAs per 8 tokens and writes
//       the group's terms to shared memory; one thread per (token, feature)
//       then adds them in group order. m > 8 walks 8-token passes.
//     - FMA: at 8 rows of x the two planes cost 16 f32 FMAs per packed
//       weight pair, which takes longer than reading the planes: it is
//       bound by instruction issue. Design: one lane per output column j, 32
//       columns per block, one warp per group g of those columns (up to 16
//       warps; past 16 groups a warp takes every 16th). A lane reads its
//       column's group of each plane with 16-byte loads (whole 32-byte
//       sectors). The warp first stages the group's x (8 rows x G) as f32 in
//       its own slice of shared memory, so x is converted once per warp and
//       every lane then reads the same values in 16-byte broadcast loads. The
//       per-group partials of up to 8 rows of x go to shared memory; one
//       thread per (row, column) then adds them in group order. No split-K.
//   * tiled kernel: operations, 2*m*n*d multiply-adds per plane.
//     - tensor cores (``ternary_matmul_mma_kernel``): a 64-feature by
//       128-token block tile, 8 warps of 16 features by 64 tokens (one m16
//       tile by eight n8 tiles: p1, p2 and acc are 3 x 32 f32 registers).
//       d is walked in stages of 64 (four k16 chunks); each stage's x tile
//       (rows padded to 144 bytes, so ldmatrix is conflict-free) and both
//       plane tiles go to shared memory with cp.async, in a ring of four
//       stages: three are in flight while one computes. A warp unpacks the
//       A registers of a stage's four chunks once and reuses them across
//       its eight token tiles; B comes from ldmatrix.x4. G is a template
//       parameter, so where a group ends is known at compile time and the
//       unrolled chunk loop has no branch; alpha is fetched a whole group
//       before its fold. The tensor work is twice the dense product's, one
//       MMA per plane.
//     - FMA: the f32 FMA pipes, against the 989 TFLOP/s a tensor-core GEMM
//       could reach on the same product. Design: a 64x64 output tile per
//       block of 128 threads, 8x4 outputs per thread with its per-group sums
//       s1, s2 and its acc in registers. d is walked in steps of 32 (a group
//       is G/32 steps). Each step stages x (32x64 f32) and both plane tiles,
//       unpacked to f32 trits, k-major in shared memory, so a thread reads
//       its 8 x values and 4+4 trits of one k as four 16-byte loads for 64
//       FMAs; the next step's x and planes are fetched into registers while
//       this step computes.
//
// The MoE experts' products (the reference vmaps ternary_matmul over the
// expert axis, src/repro/models/moe.py:70) are one launch of either kernel
// with the expert on blockIdx.z (``expert_offsets``).
//
//   Ragged m and n edges are masked (rows past the edge read zeros or a
//   clamped valid row, and their outputs are dropped), never padded in
//   memory.

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

// A stacked launch (the MoE experts' products, ``ternary_matmul_experts``)
// runs expert e = blockIdx.z on its own slices: x (E, m, d), the planes
// (E, n, d/4), alpha (E, n, d/G, 2) and y (E, m, n). Every block then runs
// the unstacked kernel's code on them, so an expert's rows have the bits
// of a launch of that expert's matrix alone; a plain launch has one z.
struct ExpertOffsets {
  size_t x, planes, alpha, y;  // elements of x, plane bytes, floats, outputs
};
__device__ __forceinline__ ExpertOffsets expert_offsets(int m, int n, int d,
                                                        int ng) {
  const size_t e = blockIdx.z;
  return {e * m * d, e * n * (d / 4), e * n * ng * 2, e * m * n};
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
  {  // expert blockIdx.z of a stacked launch (see expert_offsets)
    const ExpertOffsets eo = expert_offsets(m, n, d, ng);
    x += eo.x;
    t1p += eo.planes;
    t2p += eo.planes;
    alpha += eo.alpha;
    y += eo.y;
  }
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
  {  // expert blockIdx.z of a stacked launch (see expert_offsets)
    const ExpertOffsets eo = expert_offsets(m, n, d, ng);
    x += eo.x;
    t1p += eo.planes;
    t2p += eo.planes;
    alpha += eo.alpha;
    y += eo.y;
  }

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

// ------------------------------------------- tensor-core tile routine (bf16 x)
// One m16n8k16 MMA with f32 accumulation: d = A·B + d, A 16x16 bf16 (row),
// B 16x8 bf16 (col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two A registers that one row's 32-bit chunk word gives lane tig: the
// nibbles at bits 4*tig (k = 2tig, 2tig+1) and 4*tig+16 (k + 8), each as a
// bf16x2 of its two trits, the lower k in the low half. Byte permute of
// the tables lo = [00 80 80 00] (low byte of a trit's bf16, by field) and
// hi = [00 3F BF 00] (its high byte): the selector nibbles are f, f+4 for
// each of the two fields. Mirrored by ``trit_pairs`` in ../ops.py.
__device__ __forceinline__ void trit_pairs(uint32_t w, int tig, uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t v = (w >> (4 * tig)) & 0x000F000Fu;
  const uint32_t f = (v * 0x41u) & 0x03030303u;  // fields at bits 0, 8, 16, 24
  const uint32_t sel = f * 0x11u + 0x40404040u;  // nibbles f, f+4 per field
  lo = __byte_perm(0x00808000u, 0x00BF3F00u, sel);
  hi = __byte_perm(0x00808000u, 0x00BF3F00u, sel >> 16);
}

// The A registers of one plane's k16 chunk for this lane, from the chunk
// words of tile rows gid (wlo) and gid+8 (whi).
__device__ __forceinline__ void a_fragment(uint32_t wlo, uint32_t whi, int tig,
                                           uint32_t (&a)[4]) {
  trit_pairs(wlo, tig, a[0], a[2]);
  trit_pairs(whi, tig, a[1], a[3]);
}

// One k16 chunk for NT 8-token tiles: A of each plane (a1, a2), B of each
// tile in b[t], then per tile one MMA per plane. Every output's chain is
// p = mma(chunk c, p) in chunk order, whichever kernel calls this.
template <int NT>
__device__ __forceinline__ void chunk_mma(const uint32_t (&a1)[4],
                                          const uint32_t (&a2)[4],
                                          const uint32_t (&b)[NT][2],
                                          float (&p1)[NT][4], float (&p2)[NT][4]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    mma_bf16(p1[t], a1, b[t][0], b[t][1]);
    mma_bf16(p2[t], a2, b[t][0], b[t][1]);
  }
}

// A D fragment's element e lies on feature row gid (e < 2) or gid+8, and
// on token column 2*tig + (e & 1): the group's alpha of that row.
__device__ __forceinline__ float2 alpha_of(int e, float2 a_lo, float2 a_hi) {
  return e < 2 ? a_lo : a_hi;
}

__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {  // zero-fills when !ok
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most N of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// ---------------------------------------------- matvec on the tensor cores
constexpr int MMV_FEATS = 16;      // features per block: one m16 tile
constexpr int MMV_MAX_WARPS = 16;  // warps per block, one group each at a time
constexpr int MMV_TOKENS = 8;      // tokens per pass: one n8 tile

template <typename TY, int G>
__global__ void __launch_bounds__(32 * MMV_MAX_WARPS)
    ternary_matvec_mma_kernel(const __nv_bfloat16* __restrict__ x,
                              const uint8_t* __restrict__ t1p,
                              const uint8_t* __restrict__ t2p,
                              const float* __restrict__ alpha,
                              TY* __restrict__ y, int m, int n, int d) {
  constexpr int CPG = G / 16;  // k16 chunks of a group = words of a plane row
  extern __shared__ __align__(16) float terms[];  // [ng][MMV_FEATS][MMV_TOKENS]
  const int ng = d / G;
  {  // expert blockIdx.z of a stacked launch (see expert_offsets)
    const ExpertOffsets eo = expert_offsets(m, n, d, ng);
    x += eo.x;
    t1p += eo.planes;
    t2p += eo.planes;
    alpha += eo.alpha;
    y += eo.y;
  }
  const int nwarps = blockDim.x / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int j0 = blockIdx.x * MMV_FEATS;
  // rows past n read row n-1; their outputs are dropped
  const int jlo = min(j0 + gid, n - 1), jhi = min(j0 + gid + 8, n - 1);
  const size_t row_bytes = (size_t)d / 4;
  const uint8_t* p1lo = t1p + (size_t)jlo * row_bytes;
  const uint8_t* p1hi = t1p + (size_t)jhi * row_bytes;
  const uint8_t* p2lo = t2p + (size_t)jlo * row_bytes;
  const uint8_t* p2hi = t2p + (size_t)jhi * row_bytes;
  const float2* alo = reinterpret_cast<const float2*>(alpha) + (size_t)jlo * ng;
  const float2* ahi = reinterpret_cast<const float2*>(alpha) + (size_t)jhi * ng;

  for (int m0 = 0; m0 < m; m0 += MMV_TOKENS) {
    const int mr = min(MMV_TOKENS, m - m0);
    // this lane's B column is token gid (tokens past m read row m-1; their
    // outputs are dropped), its k pairs 2*tig and 2*tig+8 of each chunk
    const __nv_bfloat16* xr = x + (size_t)(m0 + min(gid, mr - 1)) * d + 2 * tig;
    for (int g = warp; g < ng; g += nwarps) {
      uint32_t w1lo[CPG], w1hi[CPG], w2lo[CPG], w2hi[CPG];
      load_words<CPG>(p1lo + (size_t)g * (G / 4), w1lo);
      load_words<CPG>(p1hi + (size_t)g * (G / 4), w1hi);
      load_words<CPG>(p2lo + (size_t)g * (G / 4), w2lo);
      load_words<CPG>(p2hi + (size_t)g * (G / 4), w2hi);
      const float2 a_lo = __ldg(alo + g), a_hi = __ldg(ahi + g);
      uint32_t b[CPG][1][2];
#pragma unroll
      for (int c = 0; c < CPG; ++c) {
        b[c][0][0] = ldg_u32(xr + (size_t)g * G + 16 * c);
        b[c][0][1] = ldg_u32(xr + (size_t)g * G + 16 * c + 8);
      }
      float p1[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
      float p2[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int c = 0; c < CPG; ++c) {
        uint32_t a1[4], a2[4];
        a_fragment(w1lo[c], w1hi[c], tig, a1);
        a_fragment(w2lo[c], w2hi[c], tig, a2);
        chunk_mma<1>(a1, a2, b[c], p1, p2);
      }
      float t[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = alpha_of(e, a_lo, a_hi);
        t[e] = group_term(p1[0][e], p2[0][e], a.x, a.y);
      }
      float* tg = terms + (size_t)g * MMV_FEATS * MMV_TOKENS;
      *reinterpret_cast<float2*>(tg + gid * MMV_TOKENS + 2 * tig) =
          make_float2(t[0], t[1]);
      *reinterpret_cast<float2*>(tg + (gid + 8) * MMV_TOKENS + 2 * tig) =
          make_float2(t[2], t[3]);
    }
    __syncthreads();
    // one thread per (token, feature): add the group terms in group order
    for (int idx = threadIdx.x; idx < mr * MMV_FEATS; idx += blockDim.x) {
      const int r = idx / MMV_FEATS, f = idx % MMV_FEATS;
      if (j0 + f >= n) continue;
      float acc = 0.0f;
      for (int g = 0; g < ng; ++g)
        acc = __fadd_rn(acc, terms[((size_t)g * MMV_FEATS + f) * MMV_TOKENS + r]);
      store_y(y + (size_t)(m0 + r) * n + j0 + f, acc);
    }
    __syncthreads();
  }
}

// ------------------------------------------ tiled matmul on the tensor cores
constexpr int TC_WF = 4;                    // warps along features
constexpr int TC_WT = 2;                    // warps along tokens
constexpr int TC_NT = 8;                    // n8 token tiles per warp
constexpr int TC_BN = 16 * TC_WF;           // 64 features per block
constexpr int TC_BM = 8 * TC_NT * TC_WT;    // 128 tokens per block
constexpr int TC_BK = 64;                   // k per stage: four k16 chunks
constexpr int TC_XS = TC_BK + 8;            // x row in shared memory: 144 bytes
constexpr int TC_STAGES = 4;                // cp.async ring: 3 stages in flight
constexpr int TC_THREADS = 32 * TC_WF * TC_WT;

struct TcStage {
  uint16_t x[TC_BM][TC_XS];  // tokens x k, bf16 bits
  uint4 p[2][TC_BN];              // plane, feature: the stage's 64 trits
};

template <typename TY, int G>
__global__ void __launch_bounds__(TC_THREADS)
    ternary_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                              const uint8_t* __restrict__ t1p,
                              const uint8_t* __restrict__ t2p,
                              const float* __restrict__ alpha,
                              TY* __restrict__ y, int m, int n, int d) {
  constexpr int CPS = TC_BK / 16;  // k16 chunks per stage
  constexpr int CPG = G / 16;      // k16 chunks per group
  static_assert(CPS % CPG == 0 || CPG % CPS == 0, "groups and stages nest");
  extern __shared__ __align__(128) unsigned char tc_smem[];
  TcStage* st = reinterpret_cast<TcStage*>(tc_smem);  // [TC_STAGES]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wf = warp % TC_WF, wt = warp / TC_WF;
  const int i0 = blockIdx.y * TC_BM, j0 = blockIdx.x * TC_BN;
  const int ng = d / G, n_steps = d / TC_BK;
  {  // expert blockIdx.z of a stacked launch (see expert_offsets)
    const ExpertOffsets eo = expert_offsets(m, n, d, ng);
    x += eo.x;
    t1p += eo.planes;
    t2p += eo.planes;
    alpha += eo.alpha;
    y += eo.y;
  }
  const size_t row_bytes = (size_t)d / 4;
  // this thread's cp.async sources: x rows xr0 + 32*i at column piece xc
  // (rows past m zero-fill), and one plane row (rows past n zero-fill);
  // each stage adds its k offset
  constexpr int XPIECES = TC_BK / 8;                  // 16-byte pieces of a row
  constexpr int XROWS = TC_THREADS / XPIECES;         // rows per sweep
  const int xr0 = tid / XPIECES, xc = 8 * (tid % XPIECES);
  const __nv_bfloat16* xg = x + (size_t)min(i0 + xr0, m - 1) * d + xc;
  const int pl = tid / TC_BN, pr = tid % TC_BN;        // tid < 2*TC_BN
  const uint8_t* pg = (pl ? t2p : t1p) + (size_t)min(j0 + pr, n - 1) * row_bytes;
  const bool p_ok = j0 + pr < n;
  auto load_stage = [&](int s, TcStage& S) {
    const int k0 = s * TC_BK;
#pragma unroll
    for (int i = 0; i < TC_BM / XROWS; ++i) {
      const int r = xr0 + i * XROWS;
      const bool ok = i0 + r < m;
      cp_async16(&S.x[r][xc], ok ? xg + (size_t)i * XROWS * d + k0 : x, ok);
    }
    if (tid < 2 * TC_BN) cp_async16(&S.p[pl][pr], pg + k0 / 4, p_ok);
  };

  float acc[TC_NT][4], p1[TC_NT][4], p2[TC_NT][4];
#pragma unroll
  for (int t = 0; t < TC_NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = p1[t][e] = p2[t][e] = 0.0f;

  const int fr = wf * 16 + gid;  // tile row of the lane's features fr, fr+8
  const float2* al = reinterpret_cast<const float2*>(alpha);
  const float2* alo = al + (size_t)min(j0 + fr, n - 1) * ng;
  const float2* ahi = al + (size_t)min(j0 + fr + 8, n - 1) * ng;
  // alpha of the group being walked, fetched a whole group ahead of its use
  int g = 0;
  float2 a_lo = __ldg(alo), a_hi = __ldg(ahi);
  auto fold = [&]() {  // the group ends: fold it into acc, in group order
#pragma unroll
    for (int t = 0; t < TC_NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = alpha_of(e, a_lo, a_hi);
        acc[t][e] = __fadd_rn(acc[t][e], group_term(p1[t][e], p2[t][e], a.x, a.y));
        p1[t][e] = p2[t][e] = 0.0f;
      }
    g = min(g + 1, ng - 1);
    a_lo = __ldg(alo + g);
    a_hi = __ldg(ahi + g);
  };
  // ldmatrix.x4 of tiles t, t+1: lane gives row (lane & 7) of matrix
  // lane / 8 = (tile t + lane / 16, k half (lane / 8) % 2)
  const int lrow = wt * 8 * TC_NT + 8 * (lane / 16) + lane % 8;
  const int lcol = 8 * ((lane / 8) % 2);

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < n_steps) load_stage(s, st[s]);
    cp_async_commit();  // (empty groups past the last stage keep the count)
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<TC_STAGES - 2>();  // stage s has landed, for this thread
    __syncthreads();  // ... for all; and all are done with stage s-1's buffer
    const int nx = s + TC_STAGES - 1;
    if (nx < n_steps) load_stage(nx, st[nx % TC_STAGES]);
    cp_async_commit();
    const TcStage& S = st[s % TC_STAGES];
    // the stage's A registers, all four chunks, both planes
    const uint4 q1lo = S.p[0][fr], q1hi = S.p[0][fr + 8];
    const uint4 q2lo = S.p[1][fr], q2hi = S.p[1][fr + 8];
    const uint32_t w1lo[CPS] = {q1lo.x, q1lo.y, q1lo.z, q1lo.w};
    const uint32_t w1hi[CPS] = {q1hi.x, q1hi.y, q1hi.z, q1hi.w};
    const uint32_t w2lo[CPS] = {q2lo.x, q2lo.y, q2lo.z, q2lo.w};
    const uint32_t w2hi[CPS] = {q2hi.x, q2hi.y, q2hi.z, q2hi.w};
    uint32_t a1[CPS][4], a2[CPS][4];
#pragma unroll
    for (int c = 0; c < CPS; ++c) {
      a_fragment(w1lo[c], w1hi[c], tig, a1[c]);
      a_fragment(w2lo[c], w2hi[c], tig, a2[c]);
    }
#pragma unroll
    for (int c = 0; c < CPS; ++c) {
      uint32_t b[TC_NT][2];
#pragma unroll
      for (int t = 0; t < TC_NT; t += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, &S.x[lrow + 8 * t][16 * c + lcol]);
        b[t][0] = r[0];
        b[t][1] = r[1];
        b[t + 1][0] = r[2];
        b[t + 1][1] = r[3];
      }
      chunk_mma<TC_NT>(a1[c], a2[c], b, p1, p2);
      if constexpr (CPG <= CPS) {  // groups end inside the stage, known here
        if ((c + 1) % CPG == 0) fold();
      }
    }
    if constexpr (CPG > CPS) {  // a group spans CPG / CPS stages
      if ((s + 1) % (CPG / CPS) == 0) fold();
    }
  }
#pragma unroll
  for (int t = 0; t < TC_NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + wt * 8 * TC_NT + 8 * t + 2 * tig + (e & 1);
      const int j = j0 + fr + 8 * (e / 2);
      if (i < m && j < n) store_y(y + (size_t)i * n + j, acc[t][e]);
    }
}

// cudaFuncSetAttribute is not a stream operation, costs the host more than
// a launch, and is no call to make while a stream is being captured into a
// CUDA graph: each launcher raises its kernel's dynamic shared-memory limit
// only when the kernel needs more on this device than it was given
// (``allowed``, one table per kernel instantiation; a benign race at worst
// repeats the call). The engine's first, eager call of every dispatch
// raises it before the dispatch is captured.
template <typename K>
cudaError_t allow_smem(K kern, size_t smem, int* allowed) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && allowed[dev] >= (int)smem) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < 64) allowed[dev] = (int)smem;
  return e;
}

template <typename TY, int G>
cudaError_t launch_matvec_mma(const void* x, const void* t1p, const void* t2p,
                              const void* alpha, void* y, int m, int n, int d,
                              int ne, cudaStream_t stream) {
  const int ng = d / G;
  const int nwarps = ng < MMV_MAX_WARPS ? ng : MMV_MAX_WARPS;
  const size_t smem = sizeof(float) * (size_t)ng * MMV_FEATS * MMV_TOKENS;
  auto kern = ternary_matvec_mma_kernel<TY, G>;
  static int allowed[64] = {};
  const cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid((n + MMV_FEATS - 1) / MMV_FEATS, 1, ne);
  kern<<<grid, 32 * nwarps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(t1p),
      static_cast<const uint8_t*>(t2p), static_cast<const float*>(alpha),
      static_cast<TY*>(y), m, n, d);
  return cudaGetLastError();
}

template <typename TY>
cudaError_t launch_matvec_mma_g(int G, const void* x, const void* t1p,
                                const void* t2p, const void* alpha, void* y,
                                int m, int n, int d, int ne, cudaStream_t s) {
  switch (G) {
    case 32: return launch_matvec_mma<TY, 32>(x, t1p, t2p, alpha, y, m, n, d, ne, s);
    case 64: return launch_matvec_mma<TY, 64>(x, t1p, t2p, alpha, y, m, n, d, ne, s);
    case 128: return launch_matvec_mma<TY, 128>(x, t1p, t2p, alpha, y, m, n, d, ne, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TY, int G>
cudaError_t launch_matmul_mma(const void* x, const void* t1p, const void* t2p,
                              const void* alpha, void* y, int m, int n, int d,
                              int ne, cudaStream_t s) {
  if (d % TC_BK) return cudaErrorInvalidValue;
  constexpr size_t smem = sizeof(TcStage) * TC_STAGES;
  auto kern = ternary_matmul_mma_kernel<TY, G>;
  static int allowed[64] = {};
  const cudaError_t attr = allow_smem(kern, smem, allowed);
  if (attr != cudaSuccess) return attr;
  dim3 grid((n + TC_BN - 1) / TC_BN, (m + TC_BM - 1) / TC_BM, ne);
  kern<<<grid, TC_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(t1p),
      static_cast<const uint8_t*>(t2p), static_cast<const float*>(alpha),
      static_cast<TY*>(y), m, n, d);
  return cudaGetLastError();
}

template <typename TY>
cudaError_t launch_matmul_mma_g(int G, const void* x, const void* t1p,
                                const void* t2p, const void* alpha, void* y,
                                int m, int n, int d, int ne, cudaStream_t s) {
  switch (G) {
    case 32: return launch_matmul_mma<TY, 32>(x, t1p, t2p, alpha, y, m, n, d, ne, s);
    case 64: return launch_matmul_mma<TY, 64>(x, t1p, t2p, alpha, y, m, n, d, ne, s);
    case 128: return launch_matmul_mma<TY, 128>(x, t1p, t2p, alpha, y, m, n, d, ne, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename TY, int G>
cudaError_t launch_matvec(const void* x, const void* t1p, const void* t2p,
                          const void* alpha, void* y, int m, int n, int d,
                          int ne, cudaStream_t stream) {
  const int ng = d / G;
  const int nwarps = ng < MV_MAX_WARPS ? ng : MV_MAX_WARPS;
  const size_t smem =
      sizeof(float) * MV_ROWS * ((size_t)ng * MV_COLS + (size_t)nwarps * G);
  auto kern = ternary_matvec_kernel<T, TY, G>;
  static int allowed[64] = {};
  const cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid((n + MV_COLS - 1) / MV_COLS, 1, ne);
  kern<<<grid, MV_COLS * nwarps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(t1p),
      static_cast<const uint8_t*>(t2p), static_cast<const float*>(alpha),
      static_cast<TY*>(y), m, n, d);
  return cudaGetLastError();
}

template <typename T, typename TY>
cudaError_t launch_matvec_g(int G, const void* x, const void* t1p,
                            const void* t2p, const void* alpha, void* y, int m,
                            int n, int d, int ne, cudaStream_t s) {
  switch (G) {
    case 32: return launch_matvec<T, TY, 32>(x, t1p, t2p, alpha, y, m, n, d, ne, s);
    case 64: return launch_matvec<T, TY, 64>(x, t1p, t2p, alpha, y, m, n, d, ne, s);
    case 128: return launch_matvec<T, TY, 128>(x, t1p, t2p, alpha, y, m, n, d, ne, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename TY>
cudaError_t launch_matmul(const void* x, const void* t1p, const void* t2p,
                          const void* alpha, void* y, int m, int n, int d,
                          int G, int ne, cudaStream_t s) {
  if (G % MM_BK) return cudaErrorInvalidValue;
  dim3 grid((n + MM_BN - 1) / MM_BN, (m + MM_BM - 1) / MM_BM, ne);
  ternary_matmul_kernel<T, TY><<<grid, MM_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(t1p),
      static_cast<const uint8_t*>(t2p), static_cast<const float*>(alpha),
      static_cast<TY*>(y), m, n, d, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when x of this dtype (x_bf16: 0 f32, 1 bf16) runs on the tensor cores
// (mma.sync), 0 when on the FMA kernels; both launchers below dispatch on it.
int ternary_mma_route(int x_bf16) { return x_bf16 ? 1 : 0; }

// x_bf16: 0 -> x is f32, 1 -> x is bf16. y_bf16: 0 -> y is f32, 1 -> y is
// bf16 (only with bf16 x). Group size G in {32, 64, 128}. ne: products
// stacked along a leading expert axis (x (ne, m, d), planes (ne, n, d/4),
// alpha (ne, n, d/G, 2), y (ne, m, n)), one per blockIdx.z; 1 for a plain
// product.
int ternary_matvec_launch(const void* x, int x_bf16, const void* t1p,
                          const void* t2p, const void* alpha, void* y,
                          int y_bf16, int m, int n, int d, int G, int ne,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!ternary_mma_route(x_bf16))
    e = y_bf16 ? cudaErrorInvalidValue
               : launch_matvec_g<float, float>(G, x, t1p, t2p, alpha, y, m, n, d, ne, s);
  else if (y_bf16)
    e = launch_matvec_mma_g<__nv_bfloat16>(G, x, t1p, t2p, alpha, y, m, n, d, ne, s);
  else
    e = launch_matvec_mma_g<float>(G, x, t1p, t2p, alpha, y, m, n, d, ne, s);
  return static_cast<int>(e);
}

// The same arguments; G must be a multiple of 32 for f32 x (one staged FMA
// step is 32 columns of d), and in {32, 64, 128} for bf16 x.
int ternary_matmul_launch(const void* x, int x_bf16, const void* t1p,
                          const void* t2p, const void* alpha, void* y,
                          int y_bf16, int m, int n, int d, int G, int ne,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!ternary_mma_route(x_bf16))
    e = y_bf16 ? cudaErrorInvalidValue
               : launch_matmul<float, float>(x, t1p, t2p, alpha, y, m, n, d, G, ne, s);
  else if (y_bf16)
    e = launch_matmul_mma_g<__nv_bfloat16>(G, x, t1p, t2p, alpha, y, m, n, d, ne, s);
  else
    e = launch_matmul_mma_g<float>(G, x, t1p, t2p, alpha, y, m, n, d, ne, s);
  return static_cast<int>(e);
}

}  // extern "C"
