// The RWKV6 time-mix recurrence (WKV) and its head-wise group norm for
// Hopper (sm_90a), with a fixed order per row.
//
// Replaces the reference's lax.scan in rwkv_time_forward
// (src/repro/models/rwkv6.py:128-146) and _group_norm (:81-89), which XLA
// fuses on the TPU (no Pallas kernel there). Per row b, head h, step t:
//     y_j  = sum_i r_i (S_ij + u_i k_i v_j)
//     S_ij = w_i S_ij + k_i v_j            only for t < length[b]
// then y rounded to the activation dtype (the reference's .astype(x.dtype))
// and normalised over the head's hd values:
//     out_j = ((y_j - mean) * rsqrt(var + 1e-5)) * scale_j,  cast to x's dtype
// with mean and the population variance in f32. r, k, v and out are in the
// activation dtype (f32 or bf16), w (the decay) in f32, u and scale in the
// parameter dtype; the state S (B, H, hd, hd) in f32 is updated in place.
//
// Why a kernel: in plain PyTorch each step is a chain of small kernels per
// layer (~16 k launches for one 64-token prefill chunk of rwkv6-3b), and
// two of them break the serving engine's batch invariance: the readout
// einsum lowers to a bmm whose cuBLAS kernel (and summation order) follows
// the batch, and torch.mean / torch.var pick their reduction order by shape.
// Here every order is fixed:
//   * one block per (row, head); two threads a column j (hd 64; one at hd
//     16), thread q keeping rows i = 32q .. 32q + 31 of column j of S in
//     registers for the whole call;
//   * the readout y_j = p_0 + p_1, p_q summed over its 32 rows in order;
//     every product and sum is rounded on its own (_rn
//     intrinsics, no contraction), so the state update has the plain
//     version's two roundings, w·S + kv, and the state its bits;
//   * the norm of a step's head vector sums over j = 0..hd-1 in order.
// Nothing depends on the batch, the number of steps in a call, the tile
// size or other rows, so a row alone, in a batch of 8, fed as one chunk or
// token by token gives the same bits. (The two partial sums round
// otherwise than one chain over i = 0..hd-1 would: within the stated
// tolerance of the plain version, whose sum has an order of its own.)
//
// Bound on an H100 SXM: memory. At decode (S = 1) the state dominates: it
// is read and written once, 2·B·H·hd²·4 bytes (10.5 MB for 8 rows of
// rwkv6-3b's 40 heads of 64, ~3 µs at 3.35 TB/s); r, k, v, w and the
// output add 4-5 B·H·hd per step. The operations (5·hd² a head and step,
// 7·hd² instructions: no fused multiply-add keeps the roundings) are the
// next limit at S = 64. Design, for the serving shapes (8 rows × 40 heads
// are 320 blocks on 132 SMs, so a step's latency and the busiest SM's
// issue rate are what cost):
//   * the chunk is staged in shared memory in tiles of up to TILE = 32
//     steps: r, k, v (activation dtype) and w (f32) of the (row, head)
//     arrive by cp.async, double-buffered, so tile n+1 loads while tile n
//     runs; any S works (the last tile is ragged). r and k are widened to
//     f32 once a tile. Four barriers a tile, none a step;
//   * two threads a column (128 a block) split the 7·hd² instructions of
//     a step two ways: with one thread a column the 640 warps of a call
//     sit two to a scheduler on the busiest SMs, each issuing a whole
//     column's step; each thread reads r_i, k_i, w_i and u_i by broadcast
//     from shared memory in 16-byte vectors (rows padded so the two
//     threads' reads fall in distinct banks) and runs G = 4 consecutive
//     live steps interleaved: for each i, step t reads S_ij and updates it
//     before step t+1 reads it, so four readout chains run side by side.
//     The two partials of a column meet by a warp shuffle; each step's y_j
//     (rounded to the activation dtype) goes to a shared y tile;
//   * after the tile's recurrence, thread t normalises step t's head
//     vector (the sums over j in order), and the block writes the tile's
//     outputs, each step's hd values as one coalesced row.
// Limits: hd 16 and 64 are built (the configs' head dims); a block takes
// ≈ 70 KB of dynamic shared memory for bf16 at hd 64 (3 blocks an SM; the
// limit is raised once per device), ≈ 95 KB for f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;  // steps staged at once
constexpr int G = 4;      // live steps interleaved in the recurrence
constexpr int QPAD = 4;   // floats between two threads' rows in shared memory

// The block of one (row, head): NQ threads a column j, thread (j, q) holding
// rows i = q·QI .. q·QI + QI - 1 of column j. A warp holds CW columns, its
// lanes q·CW + (j mod CW): the NQ threads of a column sit CW lanes apart.
template <int HD>
struct Geo {
  static constexpr int QI = HD < 32 ? HD : 32;  // rows a thread holds
  static constexpr int NQ = HD / QI;           // threads a column
  static constexpr int NT = HD * NQ;           // threads a block
  static constexpr int CW = 32 / NQ;           // columns a warp
  static constexpr int RS = NQ * (QI + QPAD);  // floats of a padded step row
  // where value i of a step sits in a padded row: the NQ quarters' 16-byte
  // reads of one instruction fall in distinct banks
  __device__ static int pad(int i) { return (i / QI) * (QI + QPAD) + i % QI; }
};

__device__ __forceinline__ float ld(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void st(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One staging buffer as cp.async fills it: tile steps of r, k, v (T, hd
// values each) and w (f32, in padded rows).
template <int HD, typename T>
struct Raw {
  T* r;
  T* k;
  T* v;
  float* w;
  __device__ Raw(unsigned char* base, int tile) {
    r = reinterpret_cast<T*>(base);
    k = r + tile * HD;
    v = k + tile * HD;
    w = reinterpret_cast<float*>(v + tile * HD);
  }
  static constexpr size_t bytes_per_step =
      3 * HD * sizeof(T) + Geo<HD>::RS * sizeof(float);
};

// Issue the cp.async copies of nt steps of one (row, head): step t's hd
// values of each operand start at element base + t·step_stride.
template <int HD, typename T>
__device__ __forceinline__ void stage(const Raw<HD, T>& dst, const T* r,
                                      const T* k, const T* v, const float* w,
                                      size_t base, size_t step_stride, int nt,
                                      int tid) {
  using Gm = Geo<HD>;
  constexpr int EPC = 16 / sizeof(T);  // elements of a 16-byte chunk
  constexpr int CR = HD / EPC;         // chunks of a step's r, k or v
  constexpr int CF = HD / 4;           // ... of its w
  for (int c = tid; c < nt * CR; c += Gm::NT) {
    const int t = c / CR, e = (c % CR) * EPC;
    const size_t g = base + (size_t)t * step_stride + e;
    cp_async16(dst.r + t * HD + e, r + g);
    cp_async16(dst.k + t * HD + e, k + g);
    cp_async16(dst.v + t * HD + e, v + g);
  }
  for (int c = tid; c < nt * CF; c += Gm::NT) {
    const int t = c / CF, e = (c % CF) * 4;
    cp_async16(dst.w + t * Gm::RS + Gm::pad(e),
               w + base + (size_t)t * step_stride + e);
  }
}

// Steps t..t+NS-1 of the tile for thread (j, q): its partial readout of
// each step over its rows i in order, then (LIVE) their state update,
// interleaved across the steps row by row; the column's NQ partials then
// add in the order q = 0, 1, ..., and lane q = 0 writes y_j, rounded to T,
// to y_s.
template <int HD, int NS, bool LIVE, typename T>
__device__ __forceinline__ void steps(float (&col)[Geo<HD>::QI], const float* rf,
                                      const float* kf, const float* wf,
                                      const T* v, const float* u_s, float* y_s,
                                      int t, int j, int q) {
  using Gm = Geo<HD>;
  constexpr int QI = Gm::QI;
  const int qo = q * (QI + QPAD);
  float vj[NS], p[NS];
#pragma unroll
  for (int g = 0; g < NS; ++g) {
    vj[g] = to_f32(v[(t + g) * HD + j]);
    p[g] = 0.0f;
  }
#pragma unroll
  for (int i0 = 0; i0 < QI; i0 += 4) {
    const float4 u4 = *reinterpret_cast<const float4*>(u_s + qo + i0);
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
    for (int g = 0; g < NS; ++g) {
      const int s = (t + g) * Gm::RS + qo + i0;
      const float4 r4 = *reinterpret_cast<const float4*>(rf + s);
      const float4 k4 = *reinterpret_cast<const float4*>(kf + s);
      float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (LIVE) w4 = *reinterpret_cast<const float4*>(wf + s);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + c;
        const float kv = __fmul_rn(kk[c], vj[g]);
        p[g] = __fadd_rn(p[g], __fmul_rn(rr[c], __fadd_rn(col[i], __fmul_rn(u[c], kv))));
        if constexpr (LIVE) col[i] = __fadd_rn(__fmul_rn(ww[c], col[i]), kv);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < NS; ++g) {
    float y = p[g];
#pragma unroll
    for (int qq = 1; qq < Gm::NQ; ++qq)
      y = __fadd_rn(y, __shfl_down_sync(0xffffffffu, p[g], qq * Gm::CW));
    if (q == 0) y_s[(t + g) * (HD + 1) + j] = round_to(y, (T*)nullptr);
  }
}

template <int HD, typename T, typename TP>
__global__ void __launch_bounds__(Geo<HD>::NT, 3)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const TP* __restrict__ u, float* __restrict__ state,
                const int* __restrict__ lengths, const TP* __restrict__ scale,
                T* __restrict__ out, int S, int H, int tile, float eps) {
  using Gm = Geo<HD>;
  constexpr int QI = Gm::QI;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int j = (tid / 32) * Gm::CW + tid % Gm::CW;  // the column
  const int q = (tid % 32) / Gm::CW;                  // its rows' block
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t raw_bytes = tile * Raw<HD, T>::bytes_per_step;
  auto raw = [&](int n) { return Raw<HD, T>(smem + (n & 1) * raw_bytes, tile); };
  float* rf = reinterpret_cast<float*>(smem + 2 * raw_bytes);  // (tile, RS)
  float* kf = rf + tile * Gm::RS;
  float* u_s = kf + tile * Gm::RS;       // (RS,)
  float* sc_s = u_s + Gm::RS;            // (HD,)
  float* y_s = sc_s + HD;                // (tile, HD + 1): no bank conflicts
  float* mean_s = y_s + tile * (HD + 1);  // per step of the tile
  float* rs_s = mean_s + tile;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const size_t step_stride = (size_t)H * HD;
  const size_t row0 = ((size_t)b * S * H + h) * HD;  // step 0 of head h

  stage(raw(0), r, k, v, w, row0, step_stride, S < tile ? S : tile, tid);
  cp_async_commit();

  float col[QI];  // rows q·QI.. of column j of this row's and head's state
  const size_t sbase = ((size_t)b * H + h) * HD * HD + (size_t)q * QI * HD + j;
#pragma unroll
  for (int i = 0; i < QI; ++i) col[i] = state[sbase + (size_t)i * HD];
  for (int e = tid; e < HD; e += Gm::NT) {
    u_s[Gm::pad(e)] = ld(u, (size_t)h * HD + e);
    sc_s[e] = ld(scale, (size_t)h * HD + e);
  }

  const int ntiles = (S + tile - 1) / tile;
  for (int n = 0; n < ntiles; ++n) {
    const int t0 = n * tile;
    const int nt = S - t0 < tile ? S - t0 : tile;
    if (n + 1 < ntiles) {  // the next tile loads while this one runs
      const int t1 = t0 + tile;
      stage(raw(n + 1), r, k, v, w, row0 + (size_t)t1 * step_stride,
            step_stride, S - t1 < tile ? S - t1 : tile, tid);
    }
    cp_async_commit();
    cp_async_wait_prior();  // this tile's copies (this thread's) landed
    __syncthreads();        // ... and every thread's; u_s, sc_s too
    const Raw<HD, T> tl = raw(n);
    for (int e = tid; e < nt * HD; e += Gm::NT) {  // r, k as f32, padded
      const int t = e / HD, i = e % HD;
      rf[t * Gm::RS + Gm::pad(i)] = to_f32(tl.r[e]);
      kf[t * Gm::RS + Gm::pad(i)] = to_f32(tl.k[e]);
    }
    __syncthreads();
    int live = len - t0;
    live = live < 0 ? 0 : (live > nt ? nt : live);
    int t = 0;
    for (; t + G <= live; t += G)
      steps<HD, G, true>(col, rf, kf, tl.w, tl.v, u_s, y_s, t, j, q);
    for (; t < live; ++t)
      steps<HD, 1, true>(col, rf, kf, tl.w, tl.v, u_s, y_s, t, j, q);
    for (; t < nt; ++t)
      steps<HD, 1, false>(col, rf, kf, tl.w, tl.v, u_s, y_s, t, j, q);
    __syncthreads();  // the tile's y complete
    for (int s = tid; s < nt; s += Gm::NT) {  // the group norm of step s
      const float* ys = y_s + s * (HD + 1);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < HD; ++i) sum = __fadd_rn(sum, ys[i]);
      const float mean = __fdiv_rn(sum, (float)HD);
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float d = __fsub_rn(ys[i], mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
      mean_s[s] = mean;
      rs_s[s] = rsqrtf(__fadd_rn(__fdiv_rn(sq, (float)HD), eps));
    }
    __syncthreads();  // the tile's means and scales
    for (int e = tid; e < nt * HD; e += Gm::NT) {  // coalesced rows of hd
      const int s = e / HD, c = e % HD;
      st(out, row0 + (size_t)(t0 + s) * step_stride + c,
         __fmul_rn(__fmul_rn(__fsub_rn(y_s[s * (HD + 1) + c], mean_s[s]), rs_s[s]),
                   sc_s[c]));
    }
    // the next tile's first barrier orders these reads before the buffers
    // are rewritten
  }
#pragma unroll
  for (int i = 0; i < QI; ++i) state[sbase + (size_t)i * HD] = col[i];
}

template <int HD, typename T>
size_t smem_bytes(int tile) {
  using Gm = Geo<HD>;
  return 2 * tile * Raw<HD, T>::bytes_per_step +
         sizeof(float) * (2 * tile * Gm::RS + Gm::RS + HD + tile * (HD + 1) +
                          2 * tile);
}

template <int HD, typename T, typename TP>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* state, const void* lengths,
                   const void* scale, void* out, int B, int S, int H, float eps,
                   cudaStream_t s) {
  auto kern = wkv6_kernel<HD, T, TP>;
  const int tile = S < TILE ? S : TILE;
  const int smem = static_cast<int>(smem_bytes<HD, T>(tile));
  // cudaFuncSetAttribute costs the host more than the launch: raise the
  // shared-memory limit only when this kernel needs more on this device
  // than it was given (a benign race at worst repeats it).
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= 64 || allowed[dev] < smem)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) allowed[dev] = smem;
  }
  kern<<<dim3(H, B), Geo<HD>::NT, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const TP*>(u), static_cast<float*>(state),
      static_cast<const int*>(lengths), static_cast<const TP*>(scale),
      static_cast<T*>(out), S, H, tile, eps);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(int x_bf16, int p_bf16, const void* r, const void* k,
                     const void* v, const void* w, const void* u, void* state,
                     const void* lengths, const void* scale, void* out, int B,
                     int S, int H, float eps, cudaStream_t s) {
  if (x_bf16)
    return p_bf16 ? launch<HD, __nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, state, lengths, scale, out, B, S, H, eps, s)
                  : launch<HD, __nv_bfloat16, float>(r, k, v, w, u, state, lengths, scale, out, B, S, H, eps, s);
  return p_bf16 ? launch<HD, float, __nv_bfloat16>(r, k, v, w, u, state, lengths, scale, out, B, S, H, eps, s)
                : launch<HD, float, float>(r, k, v, w, u, state, lengths, scale, out, B, S, H, eps, s);
}

}  // namespace

extern "C" {

// r, k, v, out: (B, S, H, hd) row-major in the activation dtype (x_bf16: 0
// f32, 1 bf16); w: (B, S, H, hd) f32; r, k, v and w 16-byte aligned; u:
// (H, hd) and scale: (H·hd,) in the parameter dtype (p_bf16); state: (B,
// H, hd, hd) f32, in place; lengths: (B,) int32, clamped to [0, S]. hd is
// 16 or 64 (the configs' head dims).
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* state, const void* lengths,
                const void* scale, void* out, int x_bf16, int p_bf16, int B,
                int S, int H, int hd, float eps, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(dispatch<16>(x_bf16, p_bf16, r, k, v, w, u, state, lengths, scale, out, B, S, H, eps, s));
    case 64: return static_cast<int>(dispatch<64>(x_bf16, p_bf16, r, k, v, w, u, state, lengths, scale, out, B, S, H, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
