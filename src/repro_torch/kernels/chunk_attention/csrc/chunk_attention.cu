// Chunk attention over the KV ring for Hopper (sm_90a).
//
// Replaces chunk_attention_pallas (src/repro/kernels/chunk_attention/
// kernel.py:197): online-softmax GQA of a chunk's queries against the ring
// *before* this chunk is written, plus the chunk's own keys as the last
// tile(s). It serves every attention read of the serving path: prefill
// chunks (L = bucket length) and decode (L = 1).
//
// Layouts (the reference's public ones):
//   q        (B, L, KV, G, hd)  f32 or bf16, query head h = kv*G + g
//   k_new/v_new (B, L, KV, hd)  same dtype as q
//   ring k/v (B, cap, KV, hd)   q's dtype, or int8 with per-(slot, kv-head)
//            scales (B, cap, KV) f32
//   pos_buf  (B, cap) i32 absolute position per slot (-1 = empty)
//   positions (B, L) i32, lengths (B,) i32
//   out      (B, L, KV, G, hd) f32
// Visible iff 0 <= qpos - kpos < reach; ring slots also need pos >= 0,
// chunk keys also need j < length. A row that sees nothing gives 0.
//
// Bound on an H100 SXM: memory. The work is reading the ring once per kv
// head (2·cap·hd elements per (b, kv)) plus q, the chunk and the output;
// the score and PV products are ~4·G·L·cap·hd flops, far below the tensor
// rate at these sizes. In practice the walk is bound by the latency of its
// serial tiles. Design: one block of 128 threads per (batch, kv-head, tile
// of 16 query rows of the G·L that share the kv head). The block walks the
// ring in tiles of 32 slots. The positions of tile t+1 load while tile t is
// processed; a tile that no row of the block can see is skipped (exact: an
// all-masked tile leaves m, l and acc unchanged). Otherwise its K and V
// come in 16-byte loads, all in flight at once, and are dequantized into
// shared memory in f32. Scores run lane = slot / warp = rows (padding rows
// skipped), the online-softmax update uses warp shuffles (with the explicit
// re-mask after exp), and P·V accumulates with one thread per head dim.
// The chunk's own keys fold in as the final tiles through the same code.
// Output is acc / max(l, 1e-30). At L = 1 the grid is B·KV blocks (16 at
// the main path's B = 8, KV = 2: 16 of 132 SMs busy, one block of 4 warps
// each); split-KV is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int RT = 16;       // query rows per block
constexpr int TK = 32;       // key slots per tile (one per lane)
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr int NO_KEY = INT_MIN;  // slot holds nothing visible to anyone

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int reach) {
  if (kpos == NO_KEY || qpos == NO_KEY) return false;
  const long long dd = (long long)qpos - (long long)kpos;
  return dd >= 0 && dd < reach;
}

// the 16 / sizeof(T) elements of a 16-byte vector as f32 (by bit operations,
// so the vector stays in registers)
template <typename T>
__device__ __forceinline__ void to_f32x(const uint4& u, float* out);
template <>
__device__ __forceinline__ void to_f32x<float>(const uint4& u, float* out) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void to_f32x<__nv_bfloat16>(const uint4& u,
                                                       float* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // bf16 -> f32 is exact: the high 16 bits
    out[2 * c] = __uint_as_float(w[c] << 16);
    out[2 * c + 1] = __uint_as_float(w[c] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void to_f32x<int8_t>(const uint4& u, float* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int c = 0; c < 16; ++c)
    out[c] = (float)(int8_t)((w[c / 4] >> (8 * (c % 4))) & 0xffu);
}

// Stage one tile of TK key slots into shared memory as f32: ks [TK][hd+1],
// vs [TK][hd]. Slot s of the tile is element row `row0 + s*KV` of k/v (each
// row hd elements); slots whose kpos is NO_KEY are zeroed, never read.
// Scales (int8 rings) are per row. All of a thread's loads are in flight
// before the first is converted.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           const float* __restrict__ k_scale,
                                           const float* __restrict__ v_scale,
                                           float* ks, float* vs,
                                           const int* kpos_s, size_t row0,
                                           int KV, int hd) {
  constexpr int EPV = 16 / (int)sizeof(T);        // elements per 16-byte vector
  constexpr int MAXV = TK * 128 / EPV / NTHREADS;  // vectors per thread, hd <= 128
  const int vpr = hd / EPV;                        // vectors per slot row
  const int nvec = TK * vpr;
  uint4 kr[MAXV], vr[MAXV];
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int e = threadIdx.x + i * NTHREADS;
    kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (e < nvec && kpos_s[e / vpr] != NO_KEY) {
      const size_t off = (row0 + (size_t)(e / vpr) * KV) * hd + (size_t)(e % vpr) * EPV;
      kr[i] = __ldg(reinterpret_cast<const uint4*>(k + off));
      vr[i] = __ldg(reinterpret_cast<const uint4*>(v + off));
    }
  }
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int e = threadIdx.x + i * NTHREADS;
    if (e >= nvec) break;
    const int ss = e / vpr, d0 = (e % vpr) * EPV;
    float kf[EPV], vf[EPV];
    to_f32x<T>(kr[i], kf);
    to_f32x<T>(vr[i], vf);
    if (k_scale != nullptr && kpos_s[ss] != NO_KEY) {
      const size_t si = row0 + (size_t)ss * KV;
      const float sk = k_scale[si], sv = v_scale[si];
#pragma unroll
      for (int c = 0; c < EPV; ++c) {
        kf[c] *= sk;
        vf[c] *= sv;
      }
    }
#pragma unroll
    for (int c = 0; c < EPV; ++c) {
      ks[ss * (hd + 1) + d0 + c] = kf[c];
      vs[ss * hd + d0 + c] = vf[c];
    }
  }
}

template <typename TQ, typename TC>
__global__ void __launch_bounds__(NTHREADS)
    chunk_attention_kernel(const TQ* __restrict__ q,
                           const TQ* __restrict__ k_new,
                           const TQ* __restrict__ v_new,
                           const TC* __restrict__ k_ring,
                           const TC* __restrict__ v_ring,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ pos_buf,
                           const int* __restrict__ positions,
                           const int* __restrict__ lengths,
                           float* __restrict__ out, int L, int KV, int G,
                           int hd, int cap, int reach, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [RT][hd]
  float* ks = qs + RT * hd;                // [TK][hd + 1]
  float* vs = ks + TK * (hd + 1);          // [TK][hd]
  float* ps = vs + TK * hd;                // [RT][TK]
  float* m_s = ps + RT * TK;               // [RT]
  float* l_s = m_s + RT;                   // [RT]
  float* a_s = l_s + RT;                   // [RT]
  int* qpos_s = reinterpret_cast<int*>(a_s + RT);  // [RT]
  int* kpos_s = qpos_s + RT;                        // [TK]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.x * RT;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = L * G;
  const int length = lengths[b];

  // query rows r = l*G + g of this (b, kv), pre-scaled in f32
  for (int e = tid; e < RT * hd; e += NTHREADS) {
    const int rr = e / hd, dd = e % hd, r = r0 + rr;
    float v = 0.0f;
    if (r < rows) {
      const int l = r / G, g = r % G;
      v = to_f32(q[((((size_t)b * L + l) * KV + kv) * G + g) * hd + dd]) * scale;
    }
    qs[e] = v;
  }
  if (tid < RT) {
    const int r = r0 + tid;
    qpos_s[tid] = (r < rows) ? positions[(size_t)b * L + r / G] : NO_KEY;
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }
  float acc[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) acc[i] = 0.0f;

  const int rows_here = min(RT, rows - r0);
  const int n_ring = (cap + TK - 1) / TK;
  const int n_tiles = n_ring + (L + TK - 1) / TK;
  // key position of slot `tid` of tile t (NO_KEY if nothing is there)
  auto key_pos = [&](int t) {
    const bool ring = t < n_ring;
    const int s = (ring ? t : t - n_ring) * TK + tid;
    if (s >= (ring ? cap : min(L, length))) return NO_KEY;
    const int kp = ring ? pos_buf[(size_t)b * cap + s] : positions[(size_t)b * L + s];
    return (ring && kp < 0) ? NO_KEY : kp;
  };
  int kp_next = tid < TK ? key_pos(0) : NO_KEY;
  for (int t = 0; t < n_tiles; ++t) {
    const bool ring = t < n_ring;
    const int s0 = ring ? t * TK : (t - n_ring) * TK;
    __syncthreads();  // previous tile fully consumed
    if (tid < TK) {
      kpos_s[tid] = kp_next;
      // the next tile's positions load while this tile is processed
      if (t + 1 < n_tiles) kp_next = key_pos(t + 1);
    }
    __syncthreads();
    int any = 0;
#pragma unroll
    for (int i = 0; i < RT / NWARPS; ++i)
      any |= visible(qpos_s[warp + NWARPS * i], kpos_s[lane], reach);
    if (!__syncthreads_or(any)) continue;  // all-masked tile: exact no-op

    // K and V of the tile in 16-byte vectors: every load is issued before
    // any is used, then dequantized to f32 in shared memory
    if (ring)
      stage_tile<TC>(k_ring, v_ring, k_scale, v_scale, ks, vs, kpos_s,
                     ((size_t)b * cap + s0) * KV + kv, KV, hd);
    else
      stage_tile<TQ>(k_new, v_new, nullptr, nullptr, ks, vs, kpos_s,
                     ((size_t)b * L + s0) * KV + kv, KV, hd);
    __syncthreads();

    // scores: lane = slot, warp w owns rows w, w+4, w+8, w+12
#pragma unroll
    for (int i = 0; i < RT / NWARPS; ++i) {
      const int rr = warp + NWARPS * i;
      if (rr >= rows_here) continue;  // padding rows of the last row tile
      const bool ok = visible(qpos_s[rr], kpos_s[lane], reach);
      float logit = 0.0f;
      const float* qr = qs + rr * hd;
      const float* kr = ks + lane * (hd + 1);
      for (int dd = 0; dd < hd; ++dd) logit = fmaf(qr[dd], kr[dd], logit);
      logit = ok ? logit : NEG_INF;
      float mx = logit;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[rr];
      const float m_new = fmaxf(m_old, mx);
      // explicit re-mask: while a row has seen nothing, m_new == NEG_INF and
      // exp(logit - m_new) would be 1 for masked slots
      const float p = ok ? expf(logit - m_new) : 0.0f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[rr * TK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[rr] = alpha;
        m_s[rr] = m_new;
        l_s[rr] = l_s[rr] * alpha + sum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P · V, one thread per head dim
    if (tid < hd) {
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        if (rr >= rows_here) break;
        float pv = 0.0f;
#pragma unroll 8
        for (int s = 0; s < TK; ++s) pv = fmaf(ps[rr * TK + s], vs[s * hd + tid], pv);
        acc[rr] = acc[rr] * a_s[rr] + pv;
      }
    }
  }
  __syncthreads();
  if (tid < hd) {
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      const int r = r0 + rr;
      if (r >= rows) continue;
      const int l = r / G, g = r % G;
      out[((((size_t)b * L + l) * KV + kv) * G + g) * hd + tid] =
          acc[rr] / fmaxf(l_s[rr], 1e-30f);
    }
  }
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)RT * hd + (size_t)TK * (hd + 1) + (size_t)TK * hd +
                          (size_t)RT * TK + 3 * RT) +
         sizeof(int) * (RT + TK);
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* kn, const void* vn, const void* kr,
                   const void* vr, const void* ksc, const void* vsc,
                   const void* pos_buf, const void* positions,
                   const void* lengths, void* out, int B, int L, int KV, int G,
                   int hd, int cap, int reach, float scale, cudaStream_t s) {
  auto kern = chunk_attention_kernel<TQ, TC>;
  const size_t smem = smem_bytes(hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((L * G + RT - 1) / RT, KV, B);
  kern<<<grid, NTHREADS, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(kn),
      static_cast<const TQ*>(vn), static_cast<const TC*>(kr),
      static_cast<const TC*>(vr), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(pos_buf),
      static_cast<const int*>(positions), static_cast<const int*>(lengths),
      static_cast<float*>(out), L, KV, G, hd, cap, reach, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t by_ring(int ring_int8, const void* q, const void* kn,
                    const void* vn, const void* kr, const void* vr,
                    const void* ksc, const void* vsc, const void* pb,
                    const void* pos, const void* len, void* out, int B, int L,
                    int KV, int G, int hd, int cap, int reach, float scale,
                    cudaStream_t s) {
  return ring_int8
             ? launch<TQ, int8_t>(q, kn, vn, kr, vr, ksc, vsc, pb, pos, len, out,
                                  B, L, KV, G, hd, cap, reach, scale, s)
             : launch<TQ, TQ>(q, kn, vn, kr, vr, nullptr, nullptr, pb, pos, len,
                              out, B, L, KV, G, hd, cap, reach, scale, s);
}

}  // namespace

extern "C" {

// q_bf16: 0 -> q/k_new/v_new are f32, 1 -> bf16.
// ring_int8: 0 -> the ring has q's dtype, 1 -> int8 ring with scales.
// hd <= 128 (one thread per head dim) and a multiple of 16 (16-byte rows
// of an int8 ring).
int chunk_attention_launch(const void* q, const void* k_new, const void* v_new,
                           int q_bf16, const void* k_ring, const void* v_ring,
                           int ring_int8, const void* k_scale,
                           const void* v_scale, const void* pos_buf,
                           const void* positions, const void* lengths, void* out,
                           int B, int L, int KV, int G, int hd, int cap,
                           int reach, float scale, void* stream) {
  if (hd > 128 || hd % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      q_bf16 ? by_ring<__nv_bfloat16>(ring_int8, q, k_new, v_new, k_ring, v_ring,
                                      k_scale, v_scale, pos_buf, positions,
                                      lengths, out, B, L, KV, G, hd, cap, reach,
                                      scale, s)
             : by_ring<float>(ring_int8, q, k_new, v_new, k_ring, v_ring, k_scale,
                              v_scale, pos_buf, positions, lengths, out, B, L,
                              KV, G, hd, cap, reach, scale, s);
  return static_cast<int>(e);
}

}  // extern "C"
