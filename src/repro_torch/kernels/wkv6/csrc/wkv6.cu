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
                T* __restrict__ out, float* __restrict__ ckpt,
                T* __restrict__ yraw, int S, int H, int tile, float eps) {
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
    if (ckpt != nullptr) {  // the state before this tile, for the backward
      float* cp = ckpt + (((size_t)b * H + h) * ntiles + n) * HD * HD +
                  (size_t)q * QI * HD + j;
#pragma unroll
      for (int i = 0; i < QI; ++i) cp[(size_t)i * HD] = col[i];
    }
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
      const size_t o = row0 + (size_t)(t0 + s) * step_stride + c;
      st(out, o, __fmul_rn(__fmul_rn(__fsub_rn(y_s[s * (HD + 1) + c], mean_s[s]), rs_s[s]),
                           sc_s[c]));
      if (yraw != nullptr) st(yraw, o, y_s[s * (HD + 1) + c]);  // already in T
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
                   const void* scale, void* out, void* ckpt, void* yraw, int B,
                   int S, int H, float eps, cudaStream_t s) {
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
      static_cast<T*>(out), static_cast<float*>(ckpt), static_cast<T*>(yraw),
      S, H, tile, eps);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(int x_bf16, int p_bf16, const void* r, const void* k,
                     const void* v, const void* w, const void* u, void* state,
                     const void* lengths, const void* scale, void* out,
                     void* ckpt, void* yraw, int B, int S, int H, float eps,
                     cudaStream_t s) {
  if (x_bf16)
    return p_bf16 ? launch<HD, __nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, state, lengths, scale, out, ckpt, yraw, B, S, H, eps, s)
                  : launch<HD, __nv_bfloat16, float>(r, k, v, w, u, state, lengths, scale, out, ckpt, yraw, B, S, H, eps, s);
  return p_bf16 ? launch<HD, float, __nv_bfloat16>(r, k, v, w, u, state, lengths, scale, out, ckpt, yraw, B, S, H, eps, s)
                : launch<HD, float, float>(r, k, v, w, u, state, lengths, scale, out, ckpt, yraw, B, S, H, eps, s);
}

// ---------------------------------------------------------------- backward
//
// The gradients of the forward above for its output's gradient dout, in
// the formulas of PyTorch's autograd of the plain version
// (ref.wkv6_backward_plain). The group norm's, per step and head, from the
// readout y (yraw, in T) and its mean and rstd recomputed:
//     yn = (y - mean)·rstd,  dyn = dout·scale,  dscale = Σ dout·yn
//     dy = T(rstd·((dyn - mean(dyn)) - yn·mean(dyn·yn)))
// then the scan's, backwards over the steps, with D the gradient of the
// state after step t (zero after the last step) and S the state before it.
// The u-bonus terms are rank 1, so with a_t = Σ_j dy_j v_j and
// c_t = Σ_i r_i u_i k_i (sums over the head, once a step):
//     dr_i = Σ_j S_ij dy_j + u_i k_i a_t,   du_i += r_i k_i a_t
//     dk_i = [live] Σ_j D_ij v_j + r_i u_i a_t,   dw_i = [live] Σ_j D_ij S_ij
//     dv_j = [live] Σ_i D_ij k_i + c_t dy_j
//     D_ij <- r_i dy_j + (w_i D_ij (live) or D_ij (padding))
// The states before each step are recomputed forward from the state the
// forward wrote at each 32-step tile's start (ckpt), never by dividing by w,
// and stay on chip.
//
// Design: one block a (row, head) of 256 threads at hd 64 (32 at hd 16),
// thread (p, q) holding columns 8q .. 8q + 7 (hd 16: 4q ..) of rows 2p and
// 2p + 1 of D in registers for the whole call; the tiles run last to
// first. Bound: operations (≈ 14·hd² a head and step, f32), 4.64 ms for
// (u)'s 32 calls. What sets the time is the shared-memory pipe (every
// thread reads its columns of v and dy each step, and the shuffles go the
// same way), latency (each step is a few short chains of sums and
// shuffles), and the blocks an SM: 201,472 bytes of shared memory a block
// in bf16 (221,952 in f32), so one block (8 warps) an SM, and (u)'s 320
// blocks take 3 waves of 132 (2.4 would do). Two rows a thread halve the
// broadcast reads of v and dy and the shuffles of dv's sum against one row
// of 16 columns a thread (faster at (u)'s shape; 8 threads a row, 512
// threads at 128 registers, spilled and was slower). A tile:
//   * its r, k, v, w, dout and readout arrive in one staging buffer by
//     cp.async, issued before the previous tile's recompute and steps, so
//     they land while those run; at the tile's start they are converted to
//     f32 tiles (the staging buffer is then free for the next tile's
//     copies: with the f32 tiles, two buffers);
//   * the group norm's backward, a_t and c_t: a warp a step, a lane one
//     (hd 16) or two (hd 64) channels, every sum over the head by the xor
//     butterfly; each lane adds dout·yn of its channels over the steps;
//   * the states: from ckpt, the tile's states before steps 4, 8, ..., 28
//     (sub-tile checkpoints, 7·hd² f32 of shared memory, each thread its own
//     elements, the 16-byte chunks of a row swizzled against bank
//     conflicts) in one forward pass; then sub-tile by sub-tile from the
//     last, the 4 states of the sub-tile in registers (recomputed with the
//     forward's two roundings, w·S then + k·v, so they equal the forward's
//     bit for bit), and its steps backwards. Recompute: 28 + 24 = 52 state
//     steps a tile of 32, 1.6× the forward's (≈ 5 of the ≈ 19 operations
//     an element and step);
//   * a step: the sums over j of the thread's two rows (Σ S·dy, Σ D·v,
//     Σ D·S) each in the thread in column order (fmaf), then across the
//     row pair's 8 threads by one reduce-scatter (xor 4, 2, 1), which
//     leaves each of 6 threads one of dr, dk, dw of one row; they overwrite
//     the step's r, k and w in shared memory. dv's sum over i: the thread's
//     two rows by an fmaf, then a reduce-scatter over the warp's 4 row
//     pairs (xor 16, 8; each lane left with 2 columns), then through shared
//     memory (two buffers) over the 8 warps in warp order after the
//     sub-tile's one barrier; dv overwrites the step's v. The tile's
//     gradients are written as coalesced rows at its end (writing dr, dk
//     and dw from the step straight to device memory was slower).
// du and dscale add in f32 in each thread in step order; a second launch
// adds the blocks' partials over the rows in row order: no float atomics,
// so every bit is reproducible. No scratch grows with B·H·hd².
//
// nvcc -Xptxas -v (sm_90a): hd 64, 216 registers a thread with bf16
// activations (198 with f32), hd 16 158 (145); no spills. Shared memory, not
// registers, holds a block to one an SM.

template <int HD, typename T>
struct Bwd {
  static constexpr int L = 4;             // steps a sub-tile
  static constexpr int NSUB = TILE / L;   // sub-tiles a tile
  static constexpr int CPT = HD == 64 ? 8 : 4;  // columns a thread (of 2 rows)
  static constexpr int TPR = HD / CPT;    // threads a pair of state rows
  static constexpr int NT = HD / 2 * TPR;  // threads a block
  static constexpr int NW = NT / 32;      // warps
  static constexpr int VPL = (HD + 31) / 32;  // channels a lane (group norm)
  static constexpr int TS = TILE * HD;
  // floats: sub-tile checkpoints, r, k, v, w, dy tiles, dv partials (two
  // buffers), a_t, c_t, u, scale; then the staging buffer's bytes
  static constexpr size_t floats = (size_t)(NSUB - 1) * HD * HD + 5 * TS +
                                   2 * (size_t)L * NW * HD + 2 * TILE + 2 * HD;
  static constexpr size_t raw_bytes = (size_t)TILE * HD * (4 + 5 * sizeof(T));
  static constexpr size_t smem = floats * sizeof(float) + raw_bytes;
  // the 16-byte chunk k of a row of a sub-tile checkpoint: at hd 64 the 8
  // lanes of one shared-memory phase (a row pair's 8 threads, 2 chunks a
  // row each) land in 8 distinct bank groups
  __device__ static int chunk(int k) {
    if constexpr (HD == 64) return k ^ ((k >> 3) & 1);
    return k;
  }
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Issue the cp.async copies of nt steps of one (row, head) into the staging
// buffer: w (f32), then r, k, v, dout, yraw (T), each (TILE, HD).
template <int HD, typename T>
__device__ __forceinline__ void bwd_stage(unsigned char* raw, const T* r, const T* k,
                                          const T* v, const float* w,
                                          const T* dout, const T* yraw,
                                          size_t base, size_t step_stride, int nt,
                                          int tid) {
  using Bw = Bwd<HD, T>;
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CR = HD / EPC;
  float* ws = reinterpret_cast<float*>(raw);
  T* rs = reinterpret_cast<T*>(ws + Bw::TS);
  for (int c = tid; c < nt * (HD / 4); c += Bw::NT) {
    const int t = c / (HD / 4), e = (c % (HD / 4)) * 4;
    cp_async16(ws + t * HD + e, w + base + (size_t)t * step_stride + e);
  }
  for (int c = tid; c < nt * CR; c += Bw::NT) {
    const int t = c / CR, e = (c % CR) * EPC;
    const size_t g = base + (size_t)t * step_stride + e;
    const int o = t * HD + e;
    cp_async16(rs + o, r + g);
    cp_async16(rs + Bw::TS + o, k + g);
    cp_async16(rs + 2 * Bw::TS + o, v + g);
    cp_async16(rs + 3 * Bw::TS + o, dout + g);
    cp_async16(rs + 4 * Bw::TS + o, yraw + g);
  }
}

// Sums over lanes by recursive halving: x[0..N) of every lane summed over
// the lane bits HI, HI/2, ..., LO, each lane keeping half of its values
// while it has more than one (the upper half where its bit is set), then
// the plain butterfly; returns the index of the first kept value (base);
// `dup` is set where another lane holds the same sums.
template <int N, int HI, int LO>
__device__ __forceinline__ void reduce_scatter(float (&x)[N], int lane, int& base,
                                               bool& dup) {
  base = 0;
  dup = false;
  int n = N;
#pragma unroll
  for (int o = HI; o >= LO; o >>= 1) {
    if (n > 1) {
      const int half = n / 2;
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int c = 0; c < N / 2; ++c) {
        if (c < half) {
          const float send = upper ? x[c] : x[c + half];
          const float keep = upper ? x[c + half] : x[c];
          x[c] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
        }
      }
      if (upper) base += half;
      n = half;
    } else {
      x[0] = __fadd_rn(x[0], __shfl_xor_sync(0xffffffffu, x[0], o));
      dup = dup || (lane & o) != 0;
    }
  }
}

// The thread's CPT columns of a state row (16-byte chunks k0.., through
// `chunk` when swizzled) into dst.
template <int HD, typename T, int CPT>
__device__ __forceinline__ void load_row(float (&dst)[CPT], const float* row, int k0,
                                         bool swizzled) {
#pragma unroll
  for (int c4 = 0; c4 < CPT / 4; ++c4) {
    const int k = swizzled ? Bwd<HD, T>::chunk(k0 + c4) : k0 + c4;
    const float4 x = reinterpret_cast<const float4*>(row)[k];
    dst[4 * c4] = x.x; dst[4 * c4 + 1] = x.y; dst[4 * c4 + 2] = x.z; dst[4 * c4 + 3] = x.w;
  }
}

template <int HD, typename T, int CPT>
__device__ __forceinline__ void store_row(float* row, const float (&src)[CPT], int k0) {
#pragma unroll
  for (int c4 = 0; c4 < CPT / 4; ++c4)
    reinterpret_cast<float4*>(row)[Bwd<HD, T>::chunk(k0 + c4)] =
        make_float4(src[4 * c4], src[4 * c4 + 1], src[4 * c4 + 2], src[4 * c4 + 3]);
}

// One state update of the thread's two rows, as the forward rounds it:
// S = w·S, then + k·v (v: the thread's CPT columns of the step's v).
template <int CPT>
__device__ __forceinline__ void recompute(float (&dst)[2][CPT], const float (&src)[2][CPT],
                                          float2 w2, float2 k2, const float* v) {
#pragma unroll
  for (int c4 = 0; c4 < CPT / 4; ++c4) {
    const float4 x = reinterpret_cast<const float4*>(v)[c4];
    const float vj[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = 4 * c4 + cc;
      dst[0][c] = __fadd_rn(__fmul_rn(w2.x, src[0][c]), __fmul_rn(k2.x, vj[cc]));
      dst[1][c] = __fadd_rn(__fmul_rn(w2.y, src[1][c]), __fmul_rn(k2.y, vj[cc]));
    }
  }
}

template <int HD, typename T, typename TP>
__global__ void __launch_bounds__(Bwd<HD, T>::NT, 1)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ w,
                    const TP* __restrict__ u, const float* __restrict__ ckpt,
                    const T* __restrict__ yraw, const int* __restrict__ lengths,
                    const TP* __restrict__ scale, const T* __restrict__ dout,
                    T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                    float* __restrict__ dw, float* __restrict__ part, int S,
                    int H, float eps) {
  using Bw = Bwd<HD, T>;
  constexpr int L = Bw::L, TPR = Bw::TPR, CPT = Bw::CPT, NT = Bw::NT, NW = Bw::NW;
  constexpr int TS = Bw::TS, VPL = Bw::VPL;
  extern __shared__ __align__(16) float sm[];
  float* sub_s = sm;                              // (NSUB - 1, HD, HD)
  float* r_s = sub_s + (Bw::NSUB - 1) * HD * HD;  // (TILE, HD) each: r, then dr
  float* k_s = r_s + TS;                          // k, then dk
  float* v_s = k_s + TS;                          // v, then dv
  float* w_s = v_s + TS;                          // w, then dw
  float* dy_s = w_s + TS;
  float* dvp = dy_s + TS;                         // (2, L, NW, HD)
  float* a_s = dvp + 2 * L * NW * HD;             // (TILE,) a_t, then c_t
  float* c_s = a_s + TILE;
  float* u_s = c_s + TILE;                        // (HD,)
  float* sc_s = u_s + HD;
  unsigned char* raw = reinterpret_cast<unsigned char*>(sc_s + HD);
  const float* rw = reinterpret_cast<const float*>(raw);
  const T* rt = reinterpret_cast<const T*>(rw + TS);  // r, k, v, dout, yraw

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q = tid % TPR, j0 = q * CPT, k0 = j0 / 4;  // the thread's columns
  const int i0 = 2 * (tid / TPR);                      // its rows i0, i0 + 1
  const int h = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int ntiles = (S + TILE - 1) / TILE;
  const size_t step_stride = (size_t)H * HD;
  const size_t row0 = ((size_t)b * S * H + h) * HD;
  const float* cpb = ckpt + ((size_t)b * H + h) * ntiles * HD * HD + (size_t)i0 * HD;
  for (int e = tid; e < HD; e += NT) {
    u_s[e] = ld(u, (size_t)h * HD + e);
    sc_s[e] = ld(scale, (size_t)h * HD + e);
  }
  {
    const int t0 = (ntiles - 1) * TILE;
    bwd_stage<HD, T>(raw, r, k, v, w, dout, yraw, row0 + (size_t)t0 * step_stride,
                     step_stride, S - t0, tid);
    cp_async_commit();
  }
  float D[2][CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) D[0][c] = D[1][c] = 0.0f;
  float du0 = 0.0f, du1 = 0.0f, dsc[VPL];
#pragma unroll
  for (int e = 0; e < VPL; ++e) dsc[e] = 0.0f;

  for (int n = ntiles - 1; n >= 0; --n) {
    const int t0 = n * TILE;
    const int nt = S - t0 < TILE ? S - t0 : TILE;
    cp_async_wait_all();
    __syncthreads();  // the tile staged; the previous tile's gradients written
    // the group norm's backward, a_t and c_t: a warp a step
    for (int t = warp; t < nt; t += NW) {
      float y[VPL], dov[VPL], vv[VPL], rr[VPL], kk[VPL];
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < VPL; ++e) {
        const int j = lane + 32 * e, o = t * HD + j;
        const bool in = j < HD;
        y[e] = in ? to_f32(rt[4 * TS + o]) : 0.0f;
        dov[e] = in ? to_f32(rt[3 * TS + o]) : 0.0f;
        rr[e] = in ? to_f32(rt[o]) : 0.0f;
        kk[e] = in ? to_f32(rt[TS + o]) : 0.0f;
        vv[e] = in ? to_f32(rt[2 * TS + o]) : 0.0f;
        if (in) {
          r_s[o] = rr[e];
          k_s[o] = kk[e];
          v_s[o] = vv[e];
          w_s[o] = rw[o];
        }
        sum = __fadd_rn(sum, y[e]);
      }
      const float mean = __fdiv_rn(warp_sum(sum), (float)HD);
      float sq = 0.0f;
#pragma unroll
      for (int e = 0; e < VPL; ++e) {
        const float d = lane + 32 * e < HD ? __fsub_rn(y[e], mean) : 0.0f;
        sq = fmaf(d, d, sq);
      }
      const float rs = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)HD), eps));
      float yn[VPL], dyn[VPL], m1 = 0.0f, m2 = 0.0f;
#pragma unroll
      for (int e = 0; e < VPL; ++e) {
        const int j = lane + 32 * e;
        const bool in = j < HD;
        yn[e] = in ? __fmul_rn(__fsub_rn(y[e], mean), rs) : 0.0f;
        dyn[e] = in ? __fmul_rn(dov[e], sc_s[j]) : 0.0f;
        m1 = __fadd_rn(m1, dyn[e]);
        m2 = fmaf(dyn[e], yn[e], m2);
        dsc[e] = fmaf(dov[e], yn[e], dsc[e]);
      }
      m1 = __fdiv_rn(warp_sum(m1), (float)HD);
      m2 = __fdiv_rn(warp_sum(m2), (float)HD);
      float a = 0.0f, c = 0.0f;
#pragma unroll
      for (int e = 0; e < VPL; ++e) {
        const int j = lane + 32 * e;
        if (j < HD) {
          const float dy = round_to(
              __fmul_rn(rs, __fsub_rn(__fsub_rn(dyn[e], m1), __fmul_rn(yn[e], m2))),
              (T*)nullptr);
          dy_s[t * HD + j] = dy;
          a = fmaf(dy, vv[e], a);
          c = fmaf(__fmul_rn(rr[e], u_s[j]), kk[e], c);
        }
      }
      a = warp_sum(a);
      c = warp_sum(c);
      if (lane == 0) {
        a_s[t] = a;
        c_s[t] = c;
      }
    }
    __syncthreads();  // the f32 tiles complete; the staging buffer is free
    if (n > 0) {      // the next tile's copies land while this one runs
      const int t1 = t0 - TILE;
      bwd_stage<HD, T>(raw, r, k, v, w, dout, yraw, row0 + (size_t)t1 * step_stride,
                       step_stride, TILE, tid);
      cp_async_commit();
    }
    const int nsub = (nt + L - 1) / L;
    {  // the sub-tile checkpoints: the states before steps 4, 8, ... (each
       // thread its own elements: no barrier)
      float St[2][CPT];
      load_row<HD, T, CPT>(St[0], cpb + (size_t)n * HD * HD, k0, false);
      load_row<HD, T, CPT>(St[1], cpb + (size_t)n * HD * HD + HD, k0, false);
      for (int m = 1; m < nsub; ++m) {
#pragma unroll
        for (int s = 0; s < L; ++s) {
          const int t = (m - 1) * L + s;
          if (t0 + t < len)
            recompute<CPT>(St, St, *reinterpret_cast<const float2*>(w_s + t * HD + i0),
                           *reinterpret_cast<const float2*>(k_s + t * HD + i0),
                           v_s + t * HD + j0);
        }
        float* dst = sub_s + (size_t)(m - 1) * HD * HD + (size_t)i0 * HD;
        store_row<HD, T, CPT>(dst, St[0], k0);
        store_row<HD, T, CPT>(dst + HD, St[1], k0);
      }
    }
    for (int m = nsub - 1; m >= 0; --m) {
      const int ts = m * L;
      const int ns = nt - ts < L ? nt - ts : L;
      float Sr[L][2][CPT];  // the states before steps ts .. ts + ns - 1
      {
        const float* src = m == 0 ? cpb + (size_t)n * HD * HD
                                  : sub_s + (size_t)(m - 1) * HD * HD + (size_t)i0 * HD;
        load_row<HD, T, CPT>(Sr[0][0], src, k0, m != 0);
        load_row<HD, T, CPT>(Sr[0][1], src + HD, k0, m != 0);
      }
#pragma unroll
      for (int s = 1; s < L; ++s) {
        if (s < ns) {
          const int t = ts + s - 1;
          if (t0 + t < len) {
            recompute<CPT>(Sr[s], Sr[s - 1], *reinterpret_cast<const float2*>(w_s + t * HD + i0),
                           *reinterpret_cast<const float2*>(k_s + t * HD + i0),
                           v_s + t * HD + j0);
          } else {
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              Sr[s][0][c] = Sr[s - 1][0][c];
              Sr[s][1][c] = Sr[s - 1][1][c];
            }
          }
        }
      }
      float* dvb = dvp + (m & 1) * L * NW * HD;
#pragma unroll
      for (int s = L - 1; s >= 0; --s) {  // the sub-tile's steps backwards
        if (s < ns) {
          const int t = ts + s;
          const bool live = t0 + t < len;
          const float2 r2 = *reinterpret_cast<const float2*>(r_s + t * HD + i0);
          const float2 k2 = *reinterpret_cast<const float2*>(k_s + t * HD + i0);
          const float2 w2 = *reinterpret_cast<const float2*>(w_s + t * HD + i0);
          const float a = a_s[t];
          float vj[CPT], dyj[CPT];
#pragma unroll
          for (int c4 = 0; c4 < CPT / 4; ++c4) {
            const float4 x = reinterpret_cast<const float4*>(v_s + t * HD + j0)[c4];
            const float4 g = reinterpret_cast<const float4*>(dy_s + t * HD + j0)[c4];
            vj[4 * c4] = x.x; vj[4 * c4 + 1] = x.y; vj[4 * c4 + 2] = x.z; vj[4 * c4 + 3] = x.w;
            dyj[4 * c4] = g.x; dyj[4 * c4 + 1] = g.y; dyj[4 * c4 + 2] = g.z; dyj[4 * c4 + 3] = g.w;
          }
          // the rows' sums over the thread's columns, in column order:
          // Σ S·dy, Σ D·v, Σ D·S of rows i0 and i0 + 1 (two slots unused)
          float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, pv[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            x[0] = fmaf(Sr[s][0][c], dyj[c], x[0]);
            x[1] = fmaf(Sr[s][1][c], dyj[c], x[1]);
          }
          if (live) {
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              pv[c] = fmaf(D[1][c], k2.y, __fmul_rn(D[0][c], k2.x));
              x[2] = fmaf(D[0][c], vj[c], x[2]);
              x[3] = fmaf(D[1][c], vj[c], x[3]);
              x[4] = fmaf(D[0][c], Sr[s][0][c], x[4]);
              x[5] = fmaf(D[1][c], Sr[s][1][c], x[5]);
              D[0][c] = fmaf(w2.x, D[0][c], __fmul_rn(r2.x, dyj[c]));
              D[1][c] = fmaf(w2.y, D[1][c], __fmul_rn(r2.y, dyj[c]));
            }
          } else {
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              D[0][c] = __fadd_rn(D[0][c], __fmul_rn(r2.x, dyj[c]));
              D[1][c] = __fadd_rn(D[1][c], __fmul_rn(r2.y, dyj[c]));
            }
          }
          du0 = fmaf(__fmul_rn(r2.x, k2.x), a, du0);
          du1 = fmaf(__fmul_rn(r2.y, k2.y), a, du1);
          int xb;
          bool xdup;
          reduce_scatter<8, TPR / 2, 1>(x, lane, xb, xdup);  // over the pair's threads
          __syncwarp();  // the pair's threads have read r, k, w of step t
#pragma unroll
          for (int c = 0; c < 8 / TPR; ++c) {
            const int idx = xb + c;  // 0, 1: dr; 2, 3: dk; 4, 5: dw of rows i0, i0 + 1
            const int row = i0 + (idx & 1);
            const float ri = idx & 1 ? r2.y : r2.x, ki = idx & 1 ? k2.y : k2.x;
            const float ui = u_s[row];
            if (idx < 2)
              r_s[t * HD + row] = fmaf(__fmul_rn(ui, ki), a, x[c]);
            else if (idx < 4)
              k_s[t * HD + row] = fmaf(__fmul_rn(ri, ui), a, x[c]);
            else if (idx < 6)
              w_s[t * HD + row] = live ? x[c] : 0.0f;
          }
          if (live) {  // uniform over the block
            int base;
            bool dup;
            reduce_scatter<CPT, 16, TPR>(pv, lane, base, dup);  // over the warp's row pairs
            if (!dup) {
              constexpr int KEPT = (CPT >> (TPR == 8 ? 2 : 3)) > 0 ? (CPT >> (TPR == 8 ? 2 : 3)) : 1;
#pragma unroll
              for (int c = 0; c < KEPT; ++c)
                dvb[(s * NW + warp) * HD + j0 + base + c] = pv[c];
            }
          }
        }
      }
      __syncthreads();  // the sub-tile's dv partials complete
      for (int e = tid; e < L * HD; e += NT) {  // dv of the sub-tile's steps: (g, j), the warps in order
        const int g = e / HD, j = e % HD;
        if (g < ns) {
          const int t = ts + g;
          float acc = 0.0f;
          if (t0 + t < len) {
#pragma unroll
            for (int ww = 0; ww < NW; ++ww) acc = __fadd_rn(acc, dvb[(g * NW + ww) * HD + j]);
          }
          v_s[t * HD + j] = fmaf(c_s[t], dy_s[t * HD + j], acc);
        }
      }
    }
    __syncthreads();  // the tile's dr, dk, dv, dw complete
    for (int e = 4 * tid; e < nt * HD; e += 4 * NT) {  // coalesced rows of hd
      const int t = e / HD, c = e % HD;
      const size_t g = row0 + (size_t)(t0 + t) * step_stride + c;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        st(dr, g + x, r_s[e + x]);
        st(dk, g + x, k_s[e + x]);
        st(dv, g + x, v_s[e + x]);
      }
      *reinterpret_cast<float4*>(dw + g) = *reinterpret_cast<const float4*>(w_s + e);
    }
  }
  // du of rows i0, i0 + 1; dscale of the lanes' channels, the warps in order
  if (q == 0) {
    part[(size_t)b * H * HD + (size_t)h * HD + i0] = du0;
    part[(size_t)b * H * HD + (size_t)h * HD + i0 + 1] = du1;
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < VPL; ++e)
    if (lane + 32 * e < HD) dvp[warp * HD + lane + 32 * e] = dsc[e];
  __syncthreads();
  for (int j = tid; j < HD; j += NT) {
    float s = 0.0f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) s = __fadd_rn(s, dvp[ww * HD + j]);
    part[((size_t)B + b) * H * HD + (size_t)h * HD + j] = s;
  }
}

// du and dscale: the blocks' partials (2, B, D) summed over rows in row
// order, a thread a channel
template <typename TP>
__global__ void wkv6_bwd_reduce_kernel(const float* __restrict__ part,
                                       TP* __restrict__ du,
                                       TP* __restrict__ dscale, int B, int D) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  float s0 = 0.0f, s1 = 0.0f;
  for (int b = 0; b < B; ++b) {
    s0 = __fadd_rn(s0, part[(size_t)b * D + c]);
    s1 = __fadd_rn(s1, part[((size_t)B + b) * D + c]);
  }
  st(du, c, s0);
  st(dscale, c, s1);
}

struct BwdArgs {
  const void *r, *k, *v, *w, *u, *ckpt, *yraw, *lengths, *scale, *dout;
  void *dr, *dk, *dv, *dw, *part, *du, *dscale;
  int B, S, H;
  float eps;
};

template <int HD, typename T, typename TP>
cudaError_t bwd_launch(const BwdArgs& a, cudaStream_t s) {
  auto kern = wkv6_bwd_kernel<HD, T, TP>;
  const int smem = static_cast<int>(Bwd<HD, T>::smem);
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= 64 || allowed[dev] < smem)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) allowed[dev] = smem;
  }
  kern<<<dim3(a.H, a.B), Bwd<HD, T>::NT, smem, s>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.w),
      static_cast<const TP*>(a.u), static_cast<const float*>(a.ckpt),
      static_cast<const T*>(a.yraw), static_cast<const int*>(a.lengths),
      static_cast<const TP*>(a.scale), static_cast<const T*>(a.dout),
      static_cast<T*>(a.dr), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<float*>(a.dw), static_cast<float*>(a.part), a.S, a.H, a.eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int d = a.H * HD;
  wkv6_bwd_reduce_kernel<TP><<<(d + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(a.part), static_cast<TP*>(a.du),
      static_cast<TP*>(a.dscale), a.B, d);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_dispatch(int x_bf16, int p_bf16, const BwdArgs& a, cudaStream_t s) {
  if (x_bf16)
    return p_bf16 ? bwd_launch<HD, __nv_bfloat16, __nv_bfloat16>(a, s)
                  : bwd_launch<HD, __nv_bfloat16, float>(a, s);
  return p_bf16 ? bwd_launch<HD, float, __nv_bfloat16>(a, s)
                : bwd_launch<HD, float, float>(a, s);
}

}  // namespace

extern "C" {

// r, k, v, out: (B, S, H, hd) row-major in the activation dtype (x_bf16: 0
// f32, 1 bf16); w: (B, S, H, hd) f32; r, k, v and w 16-byte aligned; u:
// (H, hd) and scale: (H·hd,) in the parameter dtype (p_bf16); state: (B,
// H, hd, hd) f32, in place; lengths: (B,) int32, clamped to [0, S]; ckpt
// and yraw: null, or (B, H, ceil(S/32), hd, hd) f32, the state at the start
// of each tile of 32 steps, and (B, S, H, hd) in the activation dtype, the
// readout before its norm (the backward's inputs). hd is 16 or 64 (the
// configs' head dims).
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* state, const void* lengths,
                const void* scale, void* out, void* ckpt, void* yraw,
                int x_bf16, int p_bf16, int B, int S, int H, int hd, float eps,
                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(dispatch<16>(x_bf16, p_bf16, r, k, v, w, u, state, lengths, scale, out, ckpt, yraw, B, S, H, eps, s));
    case 64: return static_cast<int>(dispatch<64>(x_bf16, p_bf16, r, k, v, w, u, state, lengths, scale, out, ckpt, yraw, B, S, H, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward: the forward's inputs, ckpt and yraw as its forward wrote
// them, dout (B, S, H, hd) in the activation dtype; writes dr, dk, dv in
// the activation dtype and dw f32 (B, S, H, hd), du (H, hd) and dscale
// (H·hd,) in the parameter dtype; part: (2, B, H·hd) f32 scratch; dout,
// yraw and ckpt 16-byte aligned. Two launches on the stream.
int wkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                    const void* u, const void* ckpt, const void* yraw,
                    const void* lengths, const void* scale, const void* dout,
                    void* dr, void* dk, void* dv, void* dw, void* part,
                    void* du, void* dscale, int x_bf16, int p_bf16,
                    int B, int S, int H, int hd, float eps, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{r, k, v, w, u, ckpt, yraw, lengths, scale, dout, dr, dk, dv,
                  dw, part, du, dscale, B, S, H, eps};
  switch (hd) {
    case 16: return static_cast<int>(bwd_dispatch<16>(x_bf16, p_bf16, a, s));
    case 64: return static_cast<int>(bwd_dispatch<64>(x_bf16, p_bf16, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
