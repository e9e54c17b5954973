// Chunk attention over the KV ring for Hopper (sm_90a), contiguous (B2)
// or paged (B4), and one-token decode attention over an int8 ring (B5).
//
// B2 replaces chunk_attention_pallas (src/repro/kernels/chunk_attention/
// kernel.py:197): online-softmax GQA of a chunk's queries against the ring
// *before* this chunk is written, plus the chunk's own keys. It serves
// every attention read of the ring serving path: prefill chunks (L =
// bucket length) and decode (L = 1).
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
// (empty slots included); slots past the ring get -inf and take no part.
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
// Bound on an H100 SXM: bytes. The work is reading each visible ring slot's
// k and v once per kv head, plus q, the chunk and the output; the score and
// P·V products are ~4·G·L·cap·hd flops, far below the tensor rate at these
// sizes. At the main path's decode that is a few MB a read, ~1 µs at the
// HBM rate, so a read is in practice bound by the latency of its chain of
// dependent steps (a slot's position, the copies, scores, softmax, P·V, the
// arrival atomic, the last block's combine): the design spreads the ring
// over the card and keeps each step's loads in flight together.
// ``launch/attention_stages.py`` stamps the steps (build with
// CHUNK_ATTENTION_STAGES defined; the stamps compile out otherwise).
//
// Split-KV (flash-decoding) with one fixed order per row:
//
//   Partition. The logical ring [0, cap) is cut into parts of `part` slots
//   (the wrapper's ``split_ranges``: 128, the last part ragged), the
//   chunk's keys [0, L) into parts of the same size after them. The
//   partition depends on cap (and, for the chunk, on L) alone; never on B,
//   lengths, the fill or the window. The grid is (n_part, ceil(L·G/RT),
//   KV·B): one block of 4 warps per (part, tile of RT = 32 query rows of
//   the G·L that share a kv head, kv head, batch row) — 144 blocks at the
//   main path's decode (8 ring parts + 1 chunk part, 2 kv heads, 8 rows).
//
//   A part. One thread per slot resolves the slot's storage row (through
//   the `Slots` map: ring b*cap + s, paged table[b, s/ps]*ps + s%ps, per
//   slot, so a part may span pages) and its position, and marks whether
//   any row of the block sees it. Needed K and V rows arrive by cp.async
//   (16 B each, in their storage type: int8 stays int8) in two stages, K
//   with q, then V, so the scores and the softmax run while V is in
//   flight; slots that no row sees are zero-filled, not read. A part that
//   no row sees is skipped (B2, B4: an exact no-op). Scores: bf16 q runs
//   mma.sync.m16n8k16 (f32 accumulate) with K as A (16 slots × 16 hd; int8
//   codes are exact in bf16) and q as B (16 hd × 8 rows, so L = 1's G = 6
//   heads pad to 8 rows), then the logit is the f32 sum times the k scale
//   and hd^-0.5; f32 q runs one f32 FMA chain per (row, slot). Each row's
//   max and sum over the part use warp shuffles in a fixed pattern (a warp
//   takes two rows at a time); p is re-masked after exp (B2, B4) or not
//   (B5), and the v scale multiplies p in f32. P·V is an f32 FMA chain per
//   (row, head dim) over the slots in order, so P is never rounded to
//   bf16; lane l owns dims 4l .. 4l+3 and warp w rows w, w+4, ..., so each
//   p is read from shared memory by one warp. The part writes (m, l,
//   acc[hd]) per row to the wrapper's scratch.
//
//   Combine. The last block of a (b, kv, row tile) to arrive (a fence and
//   an atomicAdd on a counter in a zeroed per-device buffer, which that
//   block resets) combines the parts in one order: ring parts 0, 1, ...,
//   then the chunk's parts: m = max m_i; l = Σ l_i·exp(m_i − m) and acc =
//   Σ acc_i·exp(m_i − m), each summed in that order (a skipped part wrote
//   (-1e30, 0, 0), which adds exactly 0); out = acc / max(l, 1e-30). The
//   partials come to shared memory by cp.async, the (m, l) of every (part,
//   row) with the first acc chunk (8 rows by as many parts as a buffer
//   holds), later chunks double-buffered: nothing branches on the data.
//   One launch per call, no second pass.
//
//   Why a row's bits do not depend on B, L, its neighbours or on which
//   block combines: every part's inputs are the row's own q and the part's
//   slots; an mma.sync element depends only on its A row and B column
//   (the ternary kernels' probe, tests/test_torch_cuda.py), every other sum
//   has a fixed order, and a slot or part that a row does not see adds
//   exactly 0 to that row (p = 0, and a skipped sub-tile adds nothing),
//   whichever other rows share the block. The partition and the combine
//   order are the same at every L, so a request's last prefill chunk at
//   bucket 1 alone and in a wider bucket give the same bits.
//
// Head dims: any multiple of 8 up to 256 (gemma3-27b's 168 among them).
// K and q rows are padded by 16 bytes in shared memory; when hd is not a
// multiple of 16 the MMA's last k16 chunk reads 8 elements of that padding,
// which are zeroed, so they add exactly 0. int8 rows of such a head dim are
// copied in 8-byte pieces (their 16-byte vectors would straddle rows); P·V
// runs in passes of 128 head dims and the combine gives a thread the dims
// tid and tid + 128. A head dim of 128 keeps its partition, copies and
// every sum order. f32 K/V rows past hd ~176 outgrow a block's shared
// memory and are refused.
//
// B2, B4 and B5 are this one kernel. `Slots` maps a logical slot to its
// storage row, so B4 over a pool equals B2 over the gathered ring bit for
// bit (a pool row is KV*hd elements: every 16-byte vector stays aligned);
// kChunk picks the chunk op's rule (B2, B4: chunk parts, re-mask after exp,
// unseen parts skipped) or the decode op's (B5: ring parts only, no
// re-mask, no skip; an empty slot still loads its v, which a row that sees
// nothing averages).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int RT = 32;          // query rows per block
constexpr int MAX_HD = 256;     // head dim at most (a multiple of 8)
constexpr int DPT = MAX_HD / 128;  // head dims per thread in the combine
constexpr int MAX_SMEM = 232448;   // dynamic shared memory of a block
constexpr int MAX_PART = 128;   // key slots per part at most: one per thread
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int SUB = 32;         // slots per sub-tile: one warp's, the skip unit
constexpr int NSUB = MAX_PART / SUB;
constexpr int SC_STRIDE = MAX_PART + 4;  // floats per score row (no bank clash)
constexpr float NEG_INF = -1e30f;
constexpr int NO_KEY = INT_MIN;     // slot holds nothing visible to anyone
constexpr int EMPTY = INT_MIN + 1;  // B5: an empty ring slot (pos < 0), in
                                    // the softmax of a row that sees nothing

#ifdef CHUNK_ATTENTION_STAGES
// Thread 0 of block i writes clock64() at stage k to g_stages[i][k] (k <
// 11) and %globaltimer at stages 0, 7 and 10 to g_stages[i][11..13].
constexpr int STAGE_BLOCKS = 65536, STAGE_SLOTS = 16;
__device__ unsigned long long g_stages[STAGE_BLOCKS * STAGE_SLOTS];
__device__ __forceinline__ void stage_stamp(int k) {
  const unsigned i =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (threadIdx.x != 0 || i >= STAGE_BLOCKS) return;
  unsigned long long* p = g_stages + (size_t)i * STAGE_SLOTS;
  p[k] = clock64();
  if (k == 0 || k == 7 || k == 10) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p[k == 0 ? 11 : k == 7 ? 12 : 13] = t;
  }
}
#define STAGE(k) stage_stamp(k)
#else
#define STAGE(k)
#endif

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

__device__ __forceinline__ bool visible(int qpos, int kpos, int reach) {
  if (kpos == NO_KEY || kpos == EMPTY || qpos == NO_KEY) return false;
  const long long dd = (long long)qpos - (long long)kpos;
  return dd >= 0 && dd < reach;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {  // zero-fills when !ok
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool ok) {  // zero-fills when !ok
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most N of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {  // committed or not
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One m16n8k16 MMA with f32 accumulation: d = A·B + d, A 16x16 bf16 (row),
// B 16x8 bf16 (col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds_u32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two adjacent elements of a K row in shared memory as one bf16x2 register
// (the lower index in the low half): bf16 as stored, int8 codes converted
// (exact: |c| <= 127).
__device__ __forceinline__ uint32_t pair_bf16x2(const __nv_bfloat16* p) {
  return lds_u32(reinterpret_cast<const unsigned char*>(p));
}
__device__ __forceinline__ uint32_t pair_bf16x2(const int8_t* p) {
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)p[0], (float)p[1]);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Four adjacent elements of a V row in shared memory as f32.
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  o[0] = u.x;
  o[1] = u.y;
  o[2] = u.z;
  o[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // bf16 -> f32: exact
  o[0] = __uint_as_float(u.x << 16);
  o[1] = __uint_as_float(u.x & 0xffff0000u);
  o[2] = __uint_as_float(u.y << 16);
  o[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const int8_t* p, float (&o)[4]) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int c = 0; c < 4; ++c) o[c] = (float)(int8_t)((u >> (8 * c)) & 0xffu);
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

template <typename TQ, typename TC, typename Slots>
struct Params {
  const TQ* q;
  const TQ* k_new;
  const TQ* v_new;
  const TC* k_ring;
  const TC* v_ring;
  const float* k_scale;  // int8 rings only
  const float* v_scale;
  Slots slots;
  const int* positions;  // (B, L)
  const int* lengths;    // (B,), chunk op only
  float* out;
  float2* part_ml;       // scratch: (m, l) per (b, kv, row tile, part, row)
  float* part_acc;       // scratch: acc[hd] per (b, kv, row tile, part, row)
  int* counters;         // arrivals per (b, kv, row tile), zero between calls
  int L, KV, G, hd, cap, part, reach;
  float scale;
};

// Shared memory, byte offsets; every region starts 16-byte aligned. The
// combine's region `cmb` (m, l and the weight of every (part, row)) reuses
// the part's K, V, q and score rows, which are dead by then.
struct Layout {
  int ks, vs, qs, sc, cmb, krow, kpos, kmul, vmul, need, qpos, m, l, sub, total;
};
// Where the combine's two acc buffers start in its region: after the (m, l)
// float2 and the weight of every (part, row).
__host__ __device__ inline int combine_acc_offset(int n_parts) {
  return (n_parts * RT * 12 + 15) / 16 * 16;
}
// kbytes: the widest K/V element a block of this instantiation stages;
// qbytes: 2 for bf16 q (MMA operand), 4 for f32 q (pre-scaled f32).
__host__ __device__ inline Layout layout(int hd, int kbytes, int qbytes,
                                         int n_parts) {
  Layout s;
  int o = 0;
  s.ks = o;   o += MAX_PART * (hd * kbytes + 16);  // K rows, padded
  s.vs = o;   o += MAX_PART * hd * kbytes;         // V rows
  s.qs = o;   o += RT * (hd * qbytes + 16);        // query rows, padded
  s.sc = o;   o += RT * SC_STRIDE * 4;             // logits, then p·v_scale
  s.cmb = 0;  // (m, l) and weight per (part, row), then two acc buffers
  o = max(o, combine_acc_offset(n_parts) + 2 * 8 * hd * 4);
  s.krow = o; o += MAX_PART * 8;                   // storage row per slot
  s.kpos = o; o += MAX_PART * 4;                   // position / NO_KEY / EMPTY
  s.kmul = o; o += MAX_PART * 4;                   // logit multiplier per slot
  s.vmul = o; o += MAX_PART * 4;                   // v scale per slot
  s.need = o; o += MAX_PART * 4;                   // bit 0: load k, bit 1: v
  s.qpos = o; o += RT * 4;
  s.m = o;    o += RT * 4;
  s.l = o;    o += RT * 4;
  s.sub = o;  o += 16 * NSUB;                      // per sub-tile: k, v needed
  s.total = o;
  return s;
}

template <typename TQ, typename TC, bool kChunk>
__host__ __device__ inline Layout layout_of(int hd, int n_parts) {
  constexpr int kq = std::is_same<TQ, float>::value ? 4 : 2;
  constexpr int kc = (int)sizeof(TC);
  constexpr int kbytes = kChunk && (int)sizeof(TQ) > kc ? (int)sizeof(TQ) : kc;
  return layout(hd, kbytes, kq, n_parts);
}

// Parts of a call: ceil(cap/part) ring parts, then ceil(L/part) chunk parts.
template <bool kChunk>
__host__ __device__ inline int parts_of(int cap, int L, int part) {
  return (cap + part - 1) / part + (kChunk ? (L + part - 1) / part : 0);
}

// One P·V pass over R rows of a warp (rows row0, row0 + NWARPS, ...): lane
// l owns head dims dbase + 4l .. +3, and each (row, dim) is one f32 FMA chain
// over the part's slots in ascending order. Sub-tiles that no row needs
// add nothing and are passed over.
template <int R, typename TK>
__device__ __forceinline__ void pv_pass(const float* sc, const unsigned char* vs,
                                        int vstride, const int* sub_s,
                                        int row0, float* acc_out, int hd,
                                        int dbase) {
  const int d0 = dbase + 4 * (threadIdx.x % 32);
  float acc[R][4];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
  for (int w = 0; w < NSUB; ++w) {
    if (!(sub_s[w] & 2)) continue;
#pragma unroll 2
    for (int s = w * SUB; s < (w + 1) * SUB; s += 4) {
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load4(reinterpret_cast<const TK*>(vs + (s + i) * vstride) + d0, v[i]);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(
            sc + (row0 + NWARPS * j) * SC_STRIDE + s);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[j][c] = fmaf(p.x, v[0][c], acc[j][c]);
          acc[j][c] = fmaf(p.y, v[1][c], acc[j][c]);
          acc[j][c] = fmaf(p.z, v[2][c], acc[j][c]);
          acc[j][c] = fmaf(p.w, v[3][c], acc[j][c]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
    __stcg(reinterpret_cast<float4*>(acc_out + (size_t)(row0 + NWARPS * j) * hd + d0),
           make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
}

// The partial (m, l, acc) of one part for the block's rows. TK is the
// part's K/V storage type (TC for a ring part, TQ for a chunk part).
template <typename TK, bool kRing, bool kChunk, typename TQ, typename TC,
          typename Slots>
__device__ __forceinline__ void part_partial(const Params<TQ, TC, Slots>& P,
                                             unsigned char* smem,
                                             const Layout& S, int b, int kv,
                                             int start, int n_keys,
                                             int rows_here, size_t slot0) {
  constexpr bool kMMA = std::is_same<TQ, __nv_bfloat16>::value;
  constexpr bool kInt8 = kRing && std::is_same<TK, int8_t>::value;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hd = P.hd, KV = P.KV;
  const TK* kg;
  const TK* vg;
  if constexpr (kRing) {
    kg = reinterpret_cast<const TK*>(P.k_ring);
    vg = reinterpret_cast<const TK*>(P.v_ring);
  } else {
    kg = reinterpret_cast<const TK*>(P.k_new);
    vg = reinterpret_cast<const TK*>(P.v_new);
  }
  long long* krow_s = reinterpret_cast<long long*>(smem + S.krow);
  int* kpos_s = reinterpret_cast<int*>(smem + S.kpos);
  float* kmul_s = reinterpret_cast<float*>(smem + S.kmul);
  float* vmul_s = reinterpret_cast<float*>(smem + S.vmul);
  int* need_s = reinterpret_cast<int*>(smem + S.need);
  const int* qpos_s = reinterpret_cast<const int*>(smem + S.qpos);
  float* sc = reinterpret_cast<float*>(smem + S.sc);
  float* m_s = reinterpret_cast<float*>(smem + S.m);
  float* l_s = reinterpret_cast<float*>(smem + S.l);
  int* sub_s = reinterpret_cast<int*>(smem + S.sub);
  unsigned char* ks = smem + S.ks;
  unsigned char* vs = smem + S.vs;
  const int kstride = hd * (int)sizeof(TK) + 16;  // bytes per K row
  const int vstride = hd * (int)sizeof(TK);       // bytes per V row

  // slot `tid` of the part: storage row, position, scales (loads in flight
  // together with the caller's q and qpos loads)
  {
    int kp = NO_KEY;
    long long row = 0;
    float ksc = 1.0f, vsc = 1.0f;
    if (tid < n_keys) {
      const int s = start + tid;
      if constexpr (kRing) {
        row = P.slots.row(b, s);
        kp = P.slots.pos[row];
        if constexpr (kInt8) {
          ksc = P.k_scale[row * KV + kv];
          vsc = P.v_scale[row * KV + kv];
        }
        // an empty ring slot holds nothing (B2, B4) or is EMPTY (B5)
        if (kp < 0) kp = kChunk ? NO_KEY : EMPTY;
      } else {
        row = (long long)b * P.L + s;
        kp = P.positions[row];
      }
    }
    __syncthreads();  // qpos_s (and f32 q) published
    STAGE(1);
    bool need_k = false;
    if (kp != NO_KEY && kp != EMPTY)
      for (int r = 0; r < rows_here; ++r)
        need_k |= visible(qpos_s[r], kp, P.reach);
    // B5 averages every in-ring v for a row that sees nothing
    const bool need_v = kChunk ? need_k : kp != NO_KEY;
    kpos_s[tid] = kp;
    krow_s[tid] = row;
    kmul_s[tid] = kMMA ? ksc * P.scale : ksc;  // f32 q is pre-scaled
    vmul_s[tid] = vsc;
    need_s[tid] = (need_k ? 1 : 0) | (need_v ? 2 : 0);
    const unsigned bk = __ballot_sync(0xffffffffu, need_k);
    const unsigned bv = __ballot_sync(0xffffffffu, need_v);
    if (lane == 0) sub_s[warp] = (bk ? 1 : 0) | (bv ? 2 : 0);
    if (!__syncthreads_or(need_v)) {  // no row sees the part (B2, B4):
      for (int dd = tid; dd < hd; dd += NTHREADS)  // (-1e30, 0, 0), an
        for (int r = 0; r < rows_here; ++r)        // exact no-op
          __stcg(&P.part_acc[(slot0 + r) * hd + dd], 0.0f);
      if (tid < rows_here)
        __stcg(&P.part_ml[slot0 + tid], make_float2(NEG_INF, 0.0f));
      return;
    }
  }

  // The MMA's last k16 chunk of a head dim that is not a multiple of 16
  // reads 8 elements past each K and q row: zeros (the K rows' here, q's
  // by the caller), so they add exactly 0.
  if (kMMA && hd % 16)
    for (int s = tid; s < MAX_PART; s += NTHREADS)
#pragma unroll
      for (int i = 0; i < (int)sizeof(TK); ++i)
        reinterpret_cast<uint2*>(ks + s * kstride + hd * (int)sizeof(TK))[i] =
            make_uint2(0u, 0u);

  // K (with q, issued by the caller) and V of the part: cp.async of 16
  // bytes (8 for int8 rows whose bytes are not a multiple of 16) in the
  // storage type, zero-filled where no row needs the slot, in two groups so
  // the scores and softmax run while V is in flight. Vector e = s*kvec + c
  // (slot s, chunk c) is stepped without a division.
  const int vb = vstride % 16 ? 8 : 16;  // bytes of one copy
  const int kvec = vstride / vb;         // copies per row
  const int s_step = NTHREADS / kvec, c_step = NTHREADS - s_step * kvec;
  const int epv = vb / (int)sizeof(TK);
  auto copy_rows = [&](const TK* g, unsigned char* dst, int stride, int bit) {
    int s = tid / kvec, c = tid - s * kvec;
    for (int e = tid; e < MAX_PART * kvec; e += NTHREADS) {
      const bool ok = need_s[s] & bit;
      const TK* src = ok ? g + ((size_t)krow_s[s] * KV + kv) * hd + c * epv : g;
      if (vb == 16)
        cp_async16(dst + s * stride + c * 16, src, ok);
      else
        cp_async8(dst + s * stride + c * 8, src, ok);
      s += s_step;
      c += c_step;
      if (c >= kvec) {
        c -= kvec;
        ++s;
      }
    }
    cp_async_commit();
  };
  copy_rows(kg, ks, kstride, 1);
  copy_rows(vg, vs, vstride, 2);
  STAGE(2);
  cp_async_wait<1>();  // q and K have landed (this thread's copies)
  __syncthreads();
  STAGE(3);

  // scores into sc[row][slot]; a masked logit is -1e30, B5's slots past the
  // ring -inf (out of max and sum)
  auto masked = [&](float x, int r, int s) {
    const int kp = kpos_s[s];
    if (visible(qpos_s[r], kp, P.reach)) return x;
    return (kChunk || kp != NO_KEY) ? NEG_INF : -INFINITY;
  };
  if constexpr (kMMA) {
    // warp w: slots 32w .. 32w+31 as two m16 tiles (A = K), rows as up to
    // four n8 tiles (B = q), hd in k16 chunks in order
    const int gid = lane / 4, tig = lane % 4;
    const int n_tiles = (rows_here + 7) / 8;
    const bool any_k = sub_s[warp] & 1;
    const unsigned char* qs = smem + S.qs;
    const int qstride = hd * 2 + 16;
    float c[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.0f;
    if (any_k) {
      // per k16 chunk: the A fragments of both m tiles and the B fragments
      // of all four n tiles (rows past the block's are zero) are loaded
      // before the MMAs, so the loads of a chunk overlap
#pragma unroll 2
      for (int k0 = 0; k0 < hd; k0 += 16) {
        uint32_t a[2][4], bq[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int s0 = warp * SUB + mt * 16;
          const TK* r_lo =
              reinterpret_cast<const TK*>(ks + (s0 + gid) * kstride) + k0;
          const TK* r_hi =
              reinterpret_cast<const TK*>(ks + (s0 + gid + 8) * kstride) + k0;
          a[mt][0] = pair_bf16x2(r_lo + 2 * tig);
          a[mt][1] = pair_bf16x2(r_hi + 2 * tig);
          a[mt][2] = pair_bf16x2(r_lo + 2 * tig + 8);
          a[mt][3] = pair_bf16x2(r_hi + 2 * tig + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const unsigned char* qr =
              qs + (nt * 8 + gid) * qstride + (k0 + 2 * tig) * 2;
          bq[nt][0] = lds_u32(qr);
          bq[nt][1] = lds_u32(qr + 16);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < n_tiles) {
            mma_bf16(c[0][nt], a[0], bq[nt][0], bq[nt][1]);
            mma_bf16(c[1][nt], a[1], bq[nt][0], bq[nt][1]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int s0 = warp * SUB + mt * 16;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < n_tiles) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = s0 + gid + (e >= 2 ? 8 : 0);
            const int r = nt * 8 + 2 * tig + (e & 1);
            if (r < rows_here)
              sc[r * SC_STRIDE + s] = masked(c[mt][nt][e] * kmul_s[s], r, s);
          }
        }
      }
    }
  } else {
    // f32 q: thread = slot, one FMA chain over hd per row
    const float* qs = reinterpret_cast<const float*>(smem + S.qs);
    const int qstride = hd + 4;
    const TK* kr = reinterpret_cast<const TK*>(ks + tid * kstride);
    const bool kneed = need_s[tid] & 1;
    for (int r = 0; r < rows_here; ++r) {
      float x = 0.0f;
      if (kneed) {
        const float* qr = qs + r * qstride;
        for (int d = 0; d < hd; ++d) x = fmaf(qr[d], to_f32(kr[d]), x);
      }
      sc[r * SC_STRIDE + tid] = masked(x * kmul_s[tid], r, tid);
    }
  }
  __syncthreads();
  STAGE(4);

  // softmax over the part, warp w owns rows w, w+4, ...: lane l holds slots
  // l + 32j; p (re-masked after exp for B2/B4) times the v scale replaces
  // the logit. Two rows at a time (the second may repeat the first, whose
  // results it then does not write), so their chains overlap.
  for (int r = warp; r < rows_here; r += 2 * NWARPS) {
    const bool two = r + NWARPS < rows_here;
    const int rw[2] = {r, two ? r + NWARPS : r};
    float x[2][NSUB], mx[2], sum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = -INFINITY;
#pragma unroll
      for (int j = 0; j < NSUB; ++j) {
        x[h][j] = sc[rw[h] * SC_STRIDE + lane + SUB * j];
        mx[h] = fmaxf(mx[h], x[h][j]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = 0.0f;
#pragma unroll
      for (int j = 0; j < NSUB; ++j) {
        const int s = lane + SUB * j;
        const float p =
            (!kChunk || visible(qpos_s[rw[h]], kpos_s[s], P.reach))
                ? expf(x[h][j] - mx[h])
                : 0.0f;
        sum[h] += p;
        x[h][j] = p * vmul_s[s];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], off);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !two) break;
#pragma unroll
      for (int j = 0; j < NSUB; ++j) sc[rw[h] * SC_STRIDE + lane + SUB * j] = x[h][j];
      if (lane == 0) {
        m_s[rw[h]] = mx[h];
        l_s[rw[h]] = sum[h];
      }
    }
  }
  cp_async_wait<0>();  // V has landed
  __syncthreads();
  STAGE(5);

  // acc[r][d] = Σ_s p'[r][s] · v[s][d]: warp w owns rows w, w+4, ... in
  // passes of up to 4 rows, so each p is read by one warp only
  // passes of 128 head dims (a warp's 32 lanes x 4)
  for (int dc = 0; dc < hd; dc += 128) {
    if (dc + 4 * lane >= hd) continue;
    float* acc_out = P.part_acc + slot0 * hd;
    const int nr = (rows_here - warp + NWARPS - 1) / NWARPS;  // this warp's
    for (int j0 = 0; j0 < nr; j0 += 4) {
      const int row0 = warp + NWARPS * j0;
      switch (min(4, nr - j0)) {
        case 1: pv_pass<1, TK>(sc, vs, vstride, sub_s, row0, acc_out, hd, dc); break;
        case 2: pv_pass<2, TK>(sc, vs, vstride, sub_s, row0, acc_out, hd, dc); break;
        case 3: pv_pass<3, TK>(sc, vs, vstride, sub_s, row0, acc_out, hd, dc); break;
        default: pv_pass<4, TK>(sc, vs, vstride, sub_s, row0, acc_out, hd, dc);
      }
    }
  }
  if (tid < rows_here)
    __stcg(&P.part_ml[slot0 + tid], make_float2(m_s[tid], l_s[tid]));
  STAGE(6);
}

template <typename TQ, typename TC, typename Slots, bool kChunk>
__global__ void __launch_bounds__(NTHREADS)
    chunk_attention_kernel(const Params<TQ, TC, Slots> P) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;
  constexpr bool kMMA = std::is_same<TQ, __nv_bfloat16>::value;
  const int n_parts = parts_of<kChunk>(P.cap, P.L, P.part);
  const Layout S = layout_of<TQ, TC, kChunk>(P.hd, n_parts);
  const int tid = threadIdx.x;
  const int p = blockIdx.x, rt = blockIdx.y;
  const int kv = blockIdx.z % P.KV, b = blockIdx.z / P.KV;
  const int hd = P.hd, G = P.G, L = P.L;
  const int rows = L * G, r0 = rt * RT, rows_here = min(RT, rows - r0);
  const int n_ring = (P.cap + P.part - 1) / P.part;
  const int idx = blockIdx.z * gridDim.y + rt;  // (b, kv, row tile)
  const size_t slot0 = ((size_t)idx * n_parts + p) * RT;
  int* qpos_s = reinterpret_cast<int*>(smem + S.qpos);
  STAGE(0);

  // the block's query rows r = l*G + g of this (b, kv): bf16 by cp.async
  // (the MMA's B operand, in the K stage's group), f32 pre-scaled by hd^-0.5
  auto q_row = [&](int r) {
    return P.q + ((((size_t)b * L + r / G) * P.KV + kv) * G + r % G) * hd;
  };
  if constexpr (kMMA) {
    const int vpr = hd / 8;
    for (int e = tid; e < RT * vpr; e += NTHREADS) {
      const int r = e / vpr, c = e - r * vpr;
      const bool ok = r < rows_here;
      cp_async16(smem + S.qs + r * (hd * 2 + 16) + c * 16,
                 ok ? q_row(r0 + r) + c * 8 : P.q, ok);
    }
    if (hd % 16 && tid < RT)  // the last k16 chunk's 8 elements past hd
      *reinterpret_cast<uint4*>(smem + S.qs + tid * (hd * 2 + 16) + hd * 2) =
          make_uint4(0u, 0u, 0u, 0u);
  } else {
    float* qs = reinterpret_cast<float*>(smem + S.qs);
    for (int e = tid; e < RT * hd; e += NTHREADS) {
      const int r = e / hd, d = e - r * hd;
      qs[r * (hd + 4) + d] =
          r < rows_here ? to_f32(q_row(r0 + r)[d]) * P.scale : 0.0f;
    }
  }
  if (tid < RT)
    qpos_s[tid] = tid < rows_here ? P.positions[(size_t)b * L + (r0 + tid) / G]
                                  : NO_KEY;

  if (p < n_ring) {
    const int start = p * P.part;
    part_partial<TC, true, kChunk>(P, smem, S, b, kv, start,
                                   min(P.part, P.cap - start), rows_here,
                                   slot0);
  } else if constexpr (kChunk) {
    const int start = (p - n_ring) * P.part;
    const int keys = min(L, P.lengths[b]);
    part_partial<TQ, false, kChunk>(P, smem, S, b, kv, start,
                                    max(0, min(P.part, keys - start)),
                                    rows_here, slot0);
  }
  cp_async_wait_all();  // a skipped part leaves q's copies uncommitted

  // arrival: the last block of this (b, kv, row tile) combines
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&P.counters[idx], 1) == n_parts - 1;
  __syncthreads();
  STAGE(7);
  if (!last_s) return;
  __threadfence();

  // The partials come to shared memory by cp.async: first every (part,
  // row)'s (m, l) with the first acc chunk, then acc in chunks of 8 rows by
  // as many parts as a buffer holds, double-buffered so the next chunk is
  // in flight while this one is summed. Each row's sums run over parts 0,
  // 1, ... in order; nothing branches on the data.
  const float* pacc = P.part_acc + (size_t)idx * n_parts * RT * hd;
  float2* ml_c = reinterpret_cast<float2*>(smem + S.cmb);  // [part][RT]
  float* w_c = reinterpret_cast<float*>(ml_c + n_parts * RT);
  float* lg_s = reinterpret_cast<float*>(smem + S.l);
  float* abuf = reinterpret_cast<float*>(smem + S.cmb +
                                         combine_acc_offset(n_parts));
  const int slab = 8 * hd;  // floats of one part's 8 rows
  const int per_buf = (S.krow - S.cmb - combine_acc_offset(n_parts)) /
                      (2 * slab * 4);  // parts a buffer holds (>= 1)
  const int n_groups = (rows_here + 7) / 8;
  const int n_chunks_g = (n_parts + per_buf - 1) / per_buf;  // a row group's
  const int vec = hd / 4;  // 16-byte vectors of a row
  auto issue = [&](int k) {  // chunk k into buffer k % 2
    const int rb = (k / n_chunks_g) * 8, i0 = (k % n_chunks_g) * per_buf;
    const int np = min(per_buf, n_parts - i0);
    float* dst = abuf + (k % 2) * per_buf * slab;
    const int q_step = NTHREADS / vec, c_step = NTHREADS - q_step * vec;
    int q = tid / vec, c = tid - q * vec;  // q = u*8 + j: part i0+u, row rb+j
    for (int e = tid; e < np * 8 * vec; e += NTHREADS) {
      const int u = q >> 3, j = q & 7;
      const bool ok = rb + j < rows_here;
      cp_async16(dst + q * hd + c * 4,
                 ok ? pacc + ((size_t)(i0 + u) * RT + rb + j) * hd + c * 4
                    : pacc,
                 ok);
      q += q_step;
      c += c_step;
      if (c >= vec) {
        c -= vec;
        ++q;
      }
    }
    cp_async_commit();
  };
  {
    const float* src = reinterpret_cast<const float*>(P.part_ml) +
                       (size_t)idx * n_parts * RT * 2;
    for (int e = tid; e < n_parts * RT / 2; e += NTHREADS)  // 2 rows a vector
      cp_async16(reinterpret_cast<float*>(ml_c) + e * 4, src + e * 4, true);
  }
  issue(0);
  cp_async_wait<0>();
  __syncthreads();
  STAGE(8);
  if (tid < rows_here) {
    float mg = -INFINITY;
#pragma unroll 4
    for (int i = 0; i < n_parts; ++i) mg = fmaxf(mg, ml_c[i * RT + tid].x);
    float l = 0.0f;
#pragma unroll 4
    for (int i = 0; i < n_parts; ++i) {
      const float w = expf(ml_c[i * RT + tid].x - mg);
      w_c[i * RT + tid] = w;
      l = fmaf(ml_c[i * RT + tid].y, w, l);
    }
    lg_s[tid] = l;
  } else if (tid < RT) {  // rows past the block's weigh 0 (their acc is 0)
    for (int i = 0; i < n_parts; ++i) w_c[i * RT + tid] = 0.0f;
  }
  __syncthreads();
  STAGE(9);
  const int n_chunks = n_groups * n_chunks_g;
  float a[DPT][8];  // thread: head dims tid, tid + NTHREADS
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) issue(k + 1);
    const int rb = (k / n_chunks_g) * 8, i0 = (k % n_chunks_g) * per_buf;
    const int np = min(per_buf, n_parts - i0);
    if (i0 == 0)
#pragma unroll
      for (int h = 0; h < DPT; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) a[h][j] = 0.0f;
#pragma unroll
    for (int h = 0; h < DPT; ++h) {
      const int dd = tid + h * NTHREADS;
      if (dd >= hd) break;
      const float* buf = abuf + (k % 2) * per_buf * slab + dd;
#pragma unroll 4
      for (int u = 0; u < np; ++u) {
        const float4* wu =
            reinterpret_cast<const float4*>(w_c + (i0 + u) * RT + rb);
        const float4 w0 = wu[0], w1 = wu[1];
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          a[h][j] = fmaf(buf[(u * 8 + j) * hd], w[j], a[h][j]);
      }
      if (i0 + np == n_parts) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = r0 + rb + j;
          if (rb + j < rows_here)
            P.out[((((size_t)b * L + r / G) * P.KV + kv) * G + r % G) * hd +
                  dd] = a[h][j] / fmaxf(lg_s[rb + j], 1e-30f);
        }
      }
    }
    if (k + 1 < n_chunks) {
      cp_async_wait<0>();  // chunk k+1 has landed (this thread's copies)
      __syncthreads();     // ... everyone's, and buffer k % 2 is free
    }
  }
  if (tid == 0) P.counters[idx] = 0;  // ready for the next launch
  STAGE(10);
}

template <typename TQ, typename TC, typename Slots, bool kChunk>
cudaError_t launch(Params<TQ, TC, Slots> P, int B, float* scratch,
                   cudaStream_t s) {
  auto kern = chunk_attention_kernel<TQ, TC, Slots, kChunk>;
  const int n_parts = parts_of<kChunk>(P.cap, P.L, P.part);
  const int smem = layout_of<TQ, TC, kChunk>(P.hd, n_parts).total;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;  // f32 rows, large hd
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
  const int n_rt = (P.L * P.G + RT - 1) / RT;
  const size_t n_ml = (size_t)B * P.KV * n_rt * n_parts * RT;
  P.part_ml = reinterpret_cast<float2*>(scratch);
  P.part_acc = scratch + 2 * n_ml;
  dim3 grid(n_parts, n_rt, P.KV * B);
  kern<<<grid, NTHREADS, smem, s>>>(P);
  return cudaGetLastError();
}

template <typename TQ, typename TC, typename Slots>
Params<TQ, TC, Slots> params(const void* q, const void* kn, const void* vn,
                             const void* kr, const void* vr, const void* ksc,
                             const void* vsc, Slots slots,
                             const void* positions, const void* lengths,
                             void* out, void* counters, int L, int KV, int G,
                             int hd, int cap, int part, int reach,
                             float scale) {
  Params<TQ, TC, Slots> P;
  P.q = static_cast<const TQ*>(q);
  P.k_new = static_cast<const TQ*>(kn);
  P.v_new = static_cast<const TQ*>(vn);
  P.k_ring = static_cast<const TC*>(kr);
  P.v_ring = static_cast<const TC*>(vr);
  P.k_scale = static_cast<const float*>(ksc);
  P.v_scale = static_cast<const float*>(vsc);
  P.slots = slots;
  P.positions = static_cast<const int*>(positions);
  P.lengths = static_cast<const int*>(lengths);
  P.out = static_cast<float*>(out);
  P.part_ml = nullptr;
  P.part_acc = nullptr;
  P.counters = static_cast<int*>(counters);
  P.L = L;
  P.KV = KV;
  P.G = G;
  P.hd = hd;
  P.cap = cap;
  P.part = part;
  P.reach = reach;
  P.scale = scale;
  return P;
}

bool bad_shape(int hd, int part, int rt) {
  return hd < 8 || hd > MAX_HD || hd % 8 || part < 1 || part > MAX_PART ||
         rt != RT;
}

template <typename TQ, typename Slots>
cudaError_t by_ring(int ring_int8, const void* q, const void* kn,
                    const void* vn, const void* kr, const void* vr,
                    const void* ksc, const void* vsc, Slots slots,
                    const void* pos, const void* len, void* out,
                    void* scratch, void* counters, int B, int L, int KV, int G,
                    int hd, int cap, int part, int reach, float scale,
                    cudaStream_t s) {
  float* w = static_cast<float*>(scratch);
  if (ring_int8)
    return launch<TQ, int8_t, Slots, true>(
        params<TQ, int8_t, Slots>(q, kn, vn, kr, vr, ksc, vsc, slots,
                                        pos, len, out, counters, L, KV, G, hd,
                                        cap, part, reach, scale),
        B, w, s);
  return launch<TQ, TQ, Slots, true>(
      params<TQ, TQ, Slots>(q, kn, vn, kr, vr, nullptr, nullptr, slots,
                                  pos, len, out, counters, L, KV, G, hd, cap,
                                  part, reach, scale),
      B, w, s);
}

template <typename Slots>
int by_dtype(int q_bf16, int ring_int8, const void* q, const void* kn,
             const void* vn, const void* kr, const void* vr, const void* ksc,
             const void* vsc, Slots slots, const void* pos, const void* len,
             void* out, void* scratch, void* counters, int B, int L, int KV,
             int G, int hd, int cap, int part, int rt, int reach, float scale,
             void* stream) {
  if (bad_shape(hd, part, rt)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      q_bf16 ? by_ring<__nv_bfloat16>(ring_int8, q, kn, vn, kr, vr, ksc, vsc,
                                      slots, pos, len, out, scratch, counters,
                                      B, L, KV, G, hd, cap, part, reach, scale,
                                      s)
             : by_ring<float>(ring_int8, q, kn, vn, kr, vr, ksc, vsc, slots,
                              pos, len, out, scratch, counters, B, L, KV, G,
                              hd, cap, part, reach, scale, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

#ifdef CHUNK_ATTENTION_STAGES
// Copy the stage stamps (STAGE_BLOCKS x STAGE_SLOTS u64) to host memory
// `dst`, then zero them.
int chunk_attention_stages(void* dst) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, g_stages, sizeof(g_stages));
  void* p = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_stages);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_stages));
  return static_cast<int>(e);
}
#endif

// q_bf16: 0 -> q/k_new/v_new are f32, 1 -> bf16.
// ring_int8: 0 -> the ring has q's dtype, 1 -> int8 ring with scales.
// hd <= 256 and a multiple of 8 (f32 rows past hd ~176 outgrow the shared
// memory and are refused); part: the
// slots of a part (<= 128); rt: the wrapper's query rows per block, which
// must equal RT. scratch: B*KV*ceil(L*G/RT)*n_part*RT*(hd + 2) f32, n_part
// = ceil(cap/part) + ceil(L/part); counters: B*KV*ceil(L*G/RT) int32,
// zero, and zero again when the kernel ends.
int chunk_attention_launch(const void* q, const void* k_new, const void* v_new,
                           int q_bf16, const void* k_ring, const void* v_ring,
                           int ring_int8, const void* k_scale,
                           const void* v_scale, const void* pos_buf,
                           const void* positions, const void* lengths, void* out,
                           void* scratch, void* counters, int B, int L, int KV,
                           int G, int hd, int cap, int part, int rt, int reach,
                           float scale, void* stream) {
  const RingSlots slots{static_cast<const int*>(pos_buf), cap};
  return by_dtype(q_bf16, ring_int8, q, k_new, v_new, k_ring, v_ring, k_scale,
                  v_scale, slots, positions, lengths, out, scratch, counters,
                  B, L, KV, G, hd, cap, part, rt, reach, scale, stream);
}

// The paged form (B4): pools (P, ps, KV, hd), scales (P, ps, KV), pos_pool
// (P, ps), table (B, n_pages) of physical page ids in [0, P).
int chunk_attention_paged_launch(const void* q, const void* k_new,
                                 const void* v_new, int q_bf16,
                                 const void* k_pool, const void* v_pool,
                                 int ring_int8, const void* k_scale,
                                 const void* v_scale, const void* pos_pool,
                                 const void* table, const void* positions,
                                 const void* lengths, void* out, void* scratch,
                                 void* counters, int B, int L, int KV, int G,
                                 int hd, int ps, int n_pages, int part, int rt,
                                 int reach, float scale, void* stream) {
  const PagedSlots slots{static_cast<const int*>(pos_pool),
                         static_cast<const int*>(table), ps, n_pages};
  return by_dtype(q_bf16, ring_int8, q, k_new, v_new, k_pool, v_pool, k_scale,
                  v_scale, slots, positions, lengths, out, scratch, counters,
                  B, L, KV, G, hd, ps * n_pages, part, rt, reach, scale,
                  stream);
}

// The decode op (B5): q (B, KV, G, hd) f32 (q_bf16 0) or bf16 (1); int8
// ring k8/v8 (B, S, KV, hd) with scales (B, S, KV), pos_buf (B, S), pos
// (B,); out (B, KV, G, hd) f32; w_eff = window, or S + 1 for none.
// scratch: B*KV*ceil(G/RT)*ceil(S/part)*RT*(hd + 2) f32; counters as above.
int decode_attention_launch(const void* q, int q_bf16, const void* k8,
                            const void* v8, const void* k_scale,
                            const void* v_scale, const void* pos_buf,
                            const void* pos, void* out, void* scratch,
                            void* counters, int B, int S, int KV, int G,
                            int hd, int part, int rt, int w_eff, float scale,
                            void* stream) {
  if (bad_shape(hd, part, rt)) return static_cast<int>(cudaErrorInvalidValue);
  const RingSlots slots{static_cast<const int*>(pos_buf), S};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(scratch);
  cudaError_t e =
      q_bf16
          ? launch<__nv_bfloat16, int8_t, RingSlots, false>(
                params<__nv_bfloat16, int8_t, RingSlots>(
                    q, nullptr, nullptr, k8, v8, k_scale, v_scale, slots, pos,
                    nullptr, out, counters, 1, KV, G, hd, S, part, w_eff,
                    scale),
                B, w, s)
          : launch<float, int8_t, RingSlots, false>(
                params<float, int8_t, RingSlots>(
                    q, nullptr, nullptr, k8, v8, k_scale, v_scale, slots, pos,
                    nullptr, out, counters, 1, KV, G, hd, S, part, w_eff,
                    scale),
                B, w, s);
  return static_cast<int>(e);
}

}  // extern "C"
