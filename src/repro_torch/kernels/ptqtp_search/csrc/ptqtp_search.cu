// The PTQTP 9-candidate trit search for Hopper (sm_90a).
//
// Replaces ptqtp_search_pallas (src/repro/kernels/ptqtp_search/kernel.py:53):
// for each element of the group-rows w (R, G) f32 with scales alpha (R, 2)
// f32, pick the pair (c1, c2) in {-1, 0, 1}^2 minimizing
// (w - alpha1*c1 - alpha2*c2)^2, candidates in the reference's order with
// (0, 0) first and a strict `<`, so the first candidate wins ties. Writes
// both planes, t1 and t2 (R, G) f32, in one pass. It is the quantizer's
// trit step (core/ptqtp.py, PTQTPConfig.use_search_kernel).
//
// The outputs are integers and must equal the reference's on every tie, so
// the arithmetic is pinned: the candidate value is __fadd_rn of two exact
// products, the residual __fsub_rn, its square __fmul_rn — no contraction
// into an FMA can move a rounding.
//
// Bound on an H100 SXM: memory. Each element reads 4 bytes and writes 8
// (two f32 planes); the 9 candidates are ~45 f32 operations per element,
// far below the 67 TFLOP/s f32 rate for 12 bytes at 3.35 TB/s. Design: one
// thread per element, consecutive threads on consecutive elements
// (coalesced); a block of 256 threads covers ROWS whole group-rows, whose
// scales it loads once into shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 256;

__constant__ float C1[9] = {0.f, 0.f, 0.f, 1.f, -1.f, 1.f, -1.f, 1.f, -1.f};
__constant__ float C2[9] = {0.f, 1.f, -1.f, 0.f, 0.f, 1.f, -1.f, -1.f, 1.f};

__global__ void __launch_bounds__(NTHREADS)
    ptqtp_search_kernel(const float* __restrict__ w,
                        const float* __restrict__ alpha,
                        float* __restrict__ t1, float* __restrict__ t2,
                        long long R, int G, int rows_per_block) {
  extern __shared__ float a_s[];  // [rows_per_block][2]
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const int nrows = (int)min((long long)rows_per_block, R - r0);
  for (int i = threadIdx.x; i < 2 * nrows; i += NTHREADS)
    a_s[i] = alpha[2 * r0 + i];
  __syncthreads();
  const long long base = r0 * G;
  const int n = nrows * G;
  for (int e = threadIdx.x; e < n; e += NTHREADS) {
    const int rr = e / G;
    const float a1 = a_s[2 * rr], a2 = a_s[2 * rr + 1];
    const float x = w[base + e];
    float best = INFINITY, b1 = 0.f, b2 = 0.f;
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const float v = __fadd_rn(__fmul_rn(a1, C1[c]), __fmul_rn(a2, C2[c]));
      const float r = __fsub_rn(x, v);
      const float err = __fmul_rn(r, r);
      if (err < best) {  // strict: the first candidate wins ties
        best = err;
        b1 = C1[c];
        b2 = C2[c];
      }
    }
    t1[base + e] = b1;
    t2[base + e] = b2;
  }
}

}  // namespace

extern "C" {

// w (R, G), alpha (R, 2), t1/t2 (R, G); all f32, contiguous.
int ptqtp_search_launch(const void* w, const void* alpha, void* t1, void* t2,
                        long long R, int G, void* stream) {
  if (R <= 0 || G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // whole group-rows per block, about 4 elements per thread
  const int rows = G >= 4 * NTHREADS ? 1 : (4 * NTHREADS) / G;
  const long long blocks = (R + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ptqtp_search_kernel<<<(unsigned)blocks, NTHREADS,
                        2 * rows * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(alpha),
      static_cast<float*>(t1), static_cast<float*>(t2), R, G, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
