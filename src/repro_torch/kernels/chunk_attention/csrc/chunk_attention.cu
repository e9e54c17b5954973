// Chunk attention over the KV ring for Hopper (sm_90a), contiguous (B2)
// or paged (B4), and one-token decode attention over an int8 ring (B5).
//
// B2 replaces chunk_attention_pallas (src/repro/kernels/chunk_attention/
// kernel.py:197): online-softmax GQA of a chunk's queries against the ring
// *before* this chunk is written, plus the chunk's own keys as the last
// tile(s). It serves every attention read of the ring serving path:
// prefill chunks (L = bucket length) and decode (L = 1).
//
// B4 replaces chunk_attention_paged_pallas (same file, kernel.py:149): the
// same op over a paged ring, whose logical slot s of row b lives in
// physical page table[b, s / ps] at offset s % ps of one pool shared by
// every row. It serves every attention read of the paged serving path.
//
// B5 replaces decode_attention_pallas (src/repro/kernels/decode_attention/
// kernel.py:63): one query token per row over an int8 ring *after* its own
// write, reached through its op only (no serving path uses it, as in the
// reference). Its mask rule is the same visibility with reach = window or
// S + 1, but it has no chunk keys and, as the reference, no re-mask after
// exp: a masked logit is -1e30, so a row that sees nothing gets exp(0) = 1
// for every slot and returns the uniform mean of v over the whole ring
// (empty slots included). Skipping an all-masked tile is then exact only
// for rows that see something, so B5 skips none; slots past the ring (a
// ragged last tile) get -inf and take no part.
//
// Layouts (the reference's public ones):
//   q        (B, L, KV, G, hd)  f32 or bf16, query head h = kv*G + g
//   k_new/v_new (B, L, KV, hd)  same dtype as q
//   ring k/v (B, cap, KV, hd)   q's dtype, or int8 with per-(slot, kv-head)
//            scales (B, cap, KV) f32; pos_buf (B, cap) i32 absolute
//            position per slot (-1 = empty)
//   paged:   pools (P, ps, KV, hd) with scales (P, ps, KV), pos_pool
//            (P, ps) i32, table (B, n_pages) i32 (cap = n_pages * ps);
//            page 0 is the null page (pos = -1), never written
//   positions (B, L) i32, lengths (B,) i32
//   out      (B, L, KV, G, hd) f32
// Visible iff 0 <= qpos - kpos < reach; ring slots also need pos >= 0,
// chunk keys also need j < length. A row that sees nothing gives 0 (B2,
// B4; B5 as above).
//   decode (B5): q (B, KV, G, hd) = (B, 1, KV, G, hd), int8 ring and
//            scales as above, pos (B,) = positions (B, 1), out (B, KV, G,
//            hd) f32
//
// Bound on an H100 SXM: memory. The work is reading the ring once per kv
// head (2·cap·hd elements per (b, kv)) plus q, the chunk and the output;
// the score and PV products are ~4·G·L·cap·hd flops, far below the tensor
// rate at these sizes. In practice the walk is bound by the latency of its
// serial tiles. Design: one block of 128 threads per (batch, kv-head, tile
// of 16 query rows of the G·L that share the kv head). The block walks the
// (logical) ring in tiles of 32 slots. The positions and storage rows of
// tile t+1 load while tile t is processed; a tile that no row of the block
// can see is skipped (exact: an all-masked tile leaves m, l and acc
// unchanged). Otherwise its K and V come in 16-byte loads, all in flight at
// once, and are dequantized into shared memory in f32. Scores run lane =
// slot / warp = rows (padding rows skipped), the online-softmax update uses
// warp shuffles (with the explicit re-mask after exp), and P·V accumulates
// with one thread per head dim. The chunk's own keys fold in as the final
// tiles through the same code. Output is acc / max(l, 1e-30). At L = 1 the
// grid is B·KV blocks (16 at the main path's B = 8, KV = 2: 16 of 132 SMs
// busy, one block of 4 warps each); split-KV is later work.
//
// B2, B4 and B5 are one kernel. A template parameter maps a logical slot
// to its storage row (ring: b*cap + s; paged: table[b, s/ps]*ps + s%ps),
// resolved per key slot (lane), not per tile, so a 32-slot tile may span
// two 16-slot pages. Everything else — tile order, loads, arithmetic — is
// the same code, so B4 over a pool equals B2 over the gathered ring bit for
// bit. A pool row is KV*hd elements, so every 16-byte vector stays aligned.
// A second template parameter, kChunk, picks the chunk op's rule (B2, B4:
// chunk keys as the last tiles, re-mask after exp, all-masked tiles
// skipped) or the decode op's (B5: ring tiles only, no re-mask, no skip;
// an empty slot still loads its v, which a row that sees nothing averages).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RT = 16;       // query rows per block
constexpr int TK = 32;       // key slots per tile (one per lane)
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr int NO_KEY = INT_MIN;  // slot holds nothing visible to anyone
constexpr int EMPTY = INT_MIN + 1;  // B5: an empty ring slot (pos < 0), in
                                    // the softmax of a row that sees nothing

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int reach) {
  if (kpos == NO_KEY || kpos == EMPTY || qpos == NO_KEY) return false;
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
// vs [TK][hd]. Slot s of the tile is storage row krow_s[s] (its head `kv`
// sits at element ((row*KV + kv) * hd) of k/v); slots whose kpos is NO_KEY
// are zeroed, never read, and EMPTY slots read v only. Scales (int8 rings)
// are per (row, kv). All of a thread's loads are in flight before the
// first is converted.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           const float* __restrict__ k_scale,
                                           const float* __restrict__ v_scale,
                                           float* ks, float* vs,
                                           const int* kpos_s,
                                           const long long* krow_s, int kv,
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
    const int kp = e < nvec ? kpos_s[e / vpr] : NO_KEY;
    if (kp != NO_KEY) {
      const size_t off = ((size_t)krow_s[e / vpr] * KV + kv) * hd +
                         (size_t)(e % vpr) * EPV;
      if (kp != EMPTY) kr[i] = __ldg(reinterpret_cast<const uint4*>(k + off));
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
      const size_t si = (size_t)krow_s[ss] * KV + kv;
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

// Where logical ring slot s of row b is stored: its storage row, whose
// position is pos[row] and whose head kv is at ((row*KV + kv) * hd).
struct RingSlots {  // B2: contiguous (B, cap, ...) ring
  const int* pos;   // pos_buf (B, cap)
  int cap;
  __device__ __forceinline__ long long row(int b, int s) const {
    return (long long)b * cap + s;
  }
};
struct PagedSlots {  // B4: (P, ps, ...) pool through a (B, n_pages) table
  const int* pos;    // pos_pool (P, ps)
  const int* table;
  int ps, n_pages;
  __device__ __forceinline__ long long row(int b, int s) const {
    return (long long)table[(size_t)b * n_pages + s / ps] * ps + s % ps;
  }
};

template <typename TQ, typename TC, typename Slots, bool kChunk>
__global__ void __launch_bounds__(NTHREADS)
    chunk_attention_kernel(const TQ* __restrict__ q,
                           const TQ* __restrict__ k_new,
                           const TQ* __restrict__ v_new,
                           const TC* __restrict__ k_ring,
                           const TC* __restrict__ v_ring,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale, Slots slots,
                           const int* __restrict__ positions,
                           const int* __restrict__ lengths,
                           float* __restrict__ out, int L, int KV, int G,
                           int hd, int cap, int reach, float scale) {
  extern __shared__ __align__(16) float smem[];
  long long* krow_s = reinterpret_cast<long long*>(smem);  // [TK]
  float* qs = smem + 2 * TK;               // [RT][hd]
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
  const int length = kChunk ? lengths[b] : 0;

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
  const int n_tiles = n_ring + (kChunk ? (L + TK - 1) / TK : 0);
  // key position and storage row of slot `tid` of tile t (NO_KEY if
  // nothing is there): ring rows through `slots` (from_ring set), chunk
  // rows b*L + j. The position comes back as loaded, so nothing waits for
  // the load until the next tile is published.
  auto key_slot = [&](int t, long long& krow, bool& from_ring) {
    const bool ring = t < n_ring;
    const int s = (ring ? t : t - n_ring) * TK + tid;
    krow = 0;
    from_ring = false;
    if (s >= (ring ? cap : min(L, length))) return NO_KEY;
    if (!ring) {
      krow = (long long)b * L + s;
      return positions[(size_t)b * L + s];
    }
    krow = slots.row(b, s);
    from_ring = true;
    return slots.pos[krow];
  };
  long long kr_next = 0;
  bool ring_next = false;
  int kp_next = tid < TK ? key_slot(0, kr_next, ring_next) : NO_KEY;
  for (int t = 0; t < n_tiles; ++t) {
    const bool ring = t < n_ring;
    __syncthreads();  // previous tile fully consumed
    if (tid < TK) {
      // an empty ring slot (pos < 0) holds nothing (B2, B4) or is EMPTY (B5)
      kpos_s[tid] = ring_next && kp_next < 0 ? (kChunk ? NO_KEY : EMPTY)
                                             : kp_next;
      krow_s[tid] = kr_next;
      // the next tile's positions load while this tile is processed
      if (t + 1 < n_tiles) kp_next = key_slot(t + 1, kr_next, ring_next);
    }
    __syncthreads();
    if constexpr (kChunk) {
      int any = 0;
#pragma unroll
      for (int i = 0; i < RT / NWARPS; ++i)
        any |= visible(qpos_s[warp + NWARPS * i], kpos_s[lane], reach);
      if (!__syncthreads_or(any)) continue;  // all-masked tile: exact no-op
    }

    // K and V of the tile in 16-byte vectors: every load is issued before
    // any is used, then dequantized to f32 in shared memory
    if (ring)
      stage_tile<TC>(k_ring, v_ring, k_scale, v_scale, ks, vs, kpos_s, krow_s,
                     kv, KV, hd);
    else
      stage_tile<TQ>(k_new, v_new, nullptr, nullptr, ks, vs, kpos_s, krow_s,
                     kv, KV, hd);
    __syncthreads();

    // scores: lane = slot, warp w owns rows w, w+4, w+8, w+12
#pragma unroll
    for (int i = 0; i < RT / NWARPS; ++i) {
      const int rr = warp + NWARPS * i;
      if (rr >= rows_here) continue;  // padding rows of the last row tile
      const int kp = kpos_s[lane];
      const bool ok = visible(qpos_s[rr], kp, reach);
      float logit = 0.0f;
      const float* qr = qs + rr * hd;
      const float* kr = ks + lane * (hd + 1);
      for (int dd = 0; dd < hd; ++dd) logit = fmaf(qr[dd], kr[dd], logit);
      // masked: -1e30; B5's slots past the ring: -inf, out of max and sum
      logit = ok ? logit : (kChunk || kp != NO_KEY ? NEG_INF : -INFINITY);
      float mx = logit;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[rr];
      const float m_new = fmaxf(m_old, mx);
      // B2/B4 re-mask explicitly: while a row has seen nothing, m_new ==
      // NEG_INF and exp(logit - m_new) would be 1 for masked slots. B5 keeps
      // that 1 (the reference's rule); once the row has seen a slot, a
      // masked slot's exp(-1e30 - m_new) is 0.
      const float p = (ok || !kChunk) ? expf(logit - m_new) : 0.0f;
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
  return sizeof(long long) * TK + sizeof(float) * ((size_t)RT * hd + (size_t)TK * (hd + 1) + (size_t)TK * hd +
                          (size_t)RT * TK + 3 * RT) +
         sizeof(int) * (RT + TK);
}

template <typename TQ, typename TC, typename Slots, bool kChunk = true>
cudaError_t launch(const void* q, const void* kn, const void* vn, const void* kr,
                   const void* vr, const void* ksc, const void* vsc, Slots slots,
                   const void* positions, const void* lengths, void* out, int B,
                   int L, int KV, int G, int hd, int cap, int reach, float scale,
                   cudaStream_t s) {
  auto kern = chunk_attention_kernel<TQ, TC, Slots, kChunk>;
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
      static_cast<const float*>(vsc), slots,
      static_cast<const int*>(positions), static_cast<const int*>(lengths),
      static_cast<float*>(out), L, KV, G, hd, cap, reach, scale);
  return cudaGetLastError();
}

template <typename TQ, typename Slots>
cudaError_t by_ring(int ring_int8, const void* q, const void* kn,
                    const void* vn, const void* kr, const void* vr,
                    const void* ksc, const void* vsc, Slots slots,
                    const void* pos, const void* len, void* out, int B, int L,
                    int KV, int G, int hd, int cap, int reach, float scale,
                    cudaStream_t s) {
  return ring_int8
             ? launch<TQ, int8_t>(q, kn, vn, kr, vr, ksc, vsc, slots, pos, len,
                                  out, B, L, KV, G, hd, cap, reach, scale, s)
             : launch<TQ, TQ>(q, kn, vn, kr, vr, nullptr, nullptr, slots, pos,
                              len, out, B, L, KV, G, hd, cap, reach, scale, s);
}

template <typename Slots>
int by_dtype(int q_bf16, int ring_int8, const void* q, const void* kn,
             const void* vn, const void* kr, const void* vr, const void* ksc,
             const void* vsc, Slots slots, const void* pos, const void* len,
             void* out, int B, int L, int KV, int G, int hd, int cap,
             int reach, float scale, void* stream) {
  if (hd > 128 || hd % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      q_bf16 ? by_ring<__nv_bfloat16>(ring_int8, q, kn, vn, kr, vr, ksc, vsc,
                                      slots, pos, len, out, B, L, KV, G, hd,
                                      cap, reach, scale, s)
             : by_ring<float>(ring_int8, q, kn, vn, kr, vr, ksc, vsc, slots,
                              pos, len, out, B, L, KV, G, hd, cap, reach,
                              scale, s);
  return static_cast<int>(e);
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
  const RingSlots slots{static_cast<const int*>(pos_buf), cap};
  return by_dtype(q_bf16, ring_int8, q, k_new, v_new, k_ring, v_ring, k_scale,
                  v_scale, slots, positions, lengths, out, B, L, KV, G, hd,
                  cap, reach, scale, stream);
}

// The paged form (B4): pools (P, ps, KV, hd), scales (P, ps, KV), pos_pool
// (P, ps), table (B, n_pages) of physical page ids in [0, P).
int chunk_attention_paged_launch(const void* q, const void* k_new,
                                 const void* v_new, int q_bf16,
                                 const void* k_pool, const void* v_pool,
                                 int ring_int8, const void* k_scale,
                                 const void* v_scale, const void* pos_pool,
                                 const void* table, const void* positions,
                                 const void* lengths, void* out, int B, int L,
                                 int KV, int G, int hd, int ps, int n_pages,
                                 int reach, float scale, void* stream) {
  const PagedSlots slots{static_cast<const int*>(pos_pool),
                         static_cast<const int*>(table), ps, n_pages};
  return by_dtype(q_bf16, ring_int8, q, k_new, v_new, k_pool, v_pool, k_scale,
                  v_scale, slots, positions, lengths, out, B, L, KV, G, hd,
                  ps * n_pages, reach, scale, stream);
}

// The decode op (B5): q (B, KV, G, hd) f32 (q_bf16 0) or bf16 (1); int8
// ring k8/v8 (B, S, KV, hd) with scales (B, S, KV), pos_buf (B, S), pos
// (B,); out (B, KV, G, hd) f32; w_eff = window, or S + 1 for none.
int decode_attention_launch(const void* q, int q_bf16, const void* k8,
                            const void* v8, const void* k_scale,
                            const void* v_scale, const void* pos_buf,
                            const void* pos, void* out, int B, int S, int KV,
                            int G, int hd, int w_eff, float scale,
                            void* stream) {
  if (hd > 128 || hd % 16) return static_cast<int>(cudaErrorInvalidValue);
  const RingSlots slots{static_cast<const int*>(pos_buf), S};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      q_bf16 ? launch<__nv_bfloat16, int8_t, RingSlots, false>(
                   q, nullptr, nullptr, k8, v8, k_scale, v_scale, slots, pos,
                   nullptr, out, B, 1, KV, G, hd, S, w_eff, scale, s)
             : launch<float, int8_t, RingSlots, false>(
                   q, nullptr, nullptr, k8, v8, k_scale, v_scale, slots, pos,
                   nullptr, out, B, 1, KV, G, hd, S, w_eff, scale, s);
  return static_cast<int>(e);
}

}  // extern "C"
