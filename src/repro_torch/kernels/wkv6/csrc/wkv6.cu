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
//   * one block per (row, head), one thread per column j, which keeps its
//     column of S in registers for the whole call;
//   * each step stages r, k, w of the head in shared memory; thread j sums
//     its y_j over i = 0..hd-1 in that order; every product and sum is
//     rounded on its own (_rn intrinsics, no contraction), so the state
//     update has the plain version's two roundings, w·S + kv;
//   * the norm's sums run over j = 0..hd-1 in order, the same in every
//     thread (each reads the head's y from shared memory).
// Nothing depends on the batch, the number of steps in a call, or other
// rows, so a row alone, in a batch of 8, fed as one chunk or token by
// token gives the same bits.
//
// Bound on an H100 SXM: memory. At decode (S = 1) the state dominates: it
// is read and written once, 2·B·H·hd²·4 bytes (10.5 MB for 8 rows of
// rwkv6-3b's 40 heads of 64, ~3 µs at 3.35 TB/s); r, k, v, w and the
// output add 4-5 B·H·hd per step. Operations (~5·hd² a head and step) stay
// far below the f32 rate. Design limits: the steps of one call run in
// order inside each block with two barriers a step; 8 rows × 40 heads fill
// 320 blocks of 64 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int HD, typename T, typename TP>
__global__ void __launch_bounds__(HD)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const TP* __restrict__ u, float* __restrict__ state,
                const int* __restrict__ lengths, const TP* __restrict__ scale,
                T* __restrict__ out, int S, int H, float eps) {
  __shared__ float r_s[HD], k_s[HD], w_s[HD], u_s[HD], y_s[HD];
  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  float col[HD];  // column j of this row's and head's state
  const size_t sbase = ((size_t)b * H + h) * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) col[i] = state[sbase + (size_t)i * HD];
  u_s[j] = ld(u, (size_t)h * HD + j);
  const float sc = ld(scale, (size_t)h * HD + j);

  for (int t = 0; t < S; ++t) {
    const size_t idx = (((size_t)b * S + t) * H + h) * HD + j;
    r_s[j] = ld(r, idx);
    k_s[j] = ld(k, idx);
    w_s[j] = __ldg(w + idx);
    const float vj = ld(v, idx);
    __syncthreads();
    float y = 0.0f;
    if (t < len) {
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = __fmul_rn(k_s[i], vj);
        y = __fadd_rn(y, __fmul_rn(r_s[i], __fadd_rn(col[i], __fmul_rn(u_s[i], kv))));
        col[i] = __fadd_rn(__fmul_rn(w_s[i], col[i]), kv);
      }
    } else {
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = __fmul_rn(k_s[i], vj);
        y = __fadd_rn(y, __fmul_rn(r_s[i], __fadd_rn(col[i], __fmul_rn(u_s[i], kv))));
      }
    }
    const float yr = round_to(y, (T*)nullptr);
    y_s[j] = yr;
    __syncthreads();
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < HD; ++i) sum = __fadd_rn(sum, y_s[i]);
    const float mean = __fdiv_rn(sum, (float)HD);
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float d = __fsub_rn(y_s[i], mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
    const float rs = rsqrtf(__fadd_rn(__fdiv_rn(sq, (float)HD), eps));
    st(out, idx, __fmul_rn(__fmul_rn(__fsub_rn(yr, mean), rs), sc));
    __syncthreads();  // the next step overwrites the staged vectors
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) state[sbase + (size_t)i * HD] = col[i];
}

template <int HD, typename T, typename TP>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* state, const void* lengths,
                   const void* scale, void* out, int B, int S, int H, float eps,
                   cudaStream_t s) {
  wkv6_kernel<HD, T, TP><<<dim3(H, B), HD, 0, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const TP*>(u), static_cast<float*>(state),
      static_cast<const int*>(lengths), static_cast<const TP*>(scale),
      static_cast<T*>(out), S, H, eps);
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
// f32, 1 bf16); w: (B, S, H, hd) f32; u: (H, hd) and scale: (H·hd,) in the
// parameter dtype (p_bf16); state: (B, H, hd, hd) f32, in place; lengths:
// (B,) int32, clamped to [0, S]. hd is 16 or 64 (the configs' head dims).
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
