// K6p — a polynomial's grid evaluation as an f32 pair plane, on Hopper.
//
// Replaces: the x-axis accumulation of sfft_tpu/core/pexact.py
// pair_poly_plane (:71), an XLA stage on the TPU: with U[s, x] = c0(x)^s and
// M[s, y] = sum_t C[s, t] c1(y)^t (a tiny f64 product the wrapper's caller
// forms), both split into f32 (hi, lo) pairs,
//
//   plane[x, y] = sum_s (Uh + Ul)[s, x] (Mh + Ml)[s, y]
//
// per term TwoProd(Uh, Mh), lo = (e + Uh Ml) + Ul Mh; the terms summed into
// hi by TwoSum and into lo as (lo + lo_s) + e2, in s's order (SP ~5-10
// terms). Run op by op it is ~25 eager launches per term. The plain twin is
// sfft_tpu_torch/core/pairs.py pair_poly_plain; the kernel follows it term
// for term (pair_arith.cuh), bit for bit.
//
// What bounds it: bytes. It reads only the small tables (SP x (N0 + N1)
// pairs, from cache) and writes 2 f32 planes. Design (simple first): one
// thread per output element, consecutive threads on consecutive columns y,
// so M's loads and the stores coalesce and U's value is one broadcast per
// warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_arith.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    pair_poly_kernel(const float* __restrict__ Uh, const float* __restrict__ Ul,
                     const float* __restrict__ Mh, const float* __restrict__ Ml,
                     float* __restrict__ hi, float* __restrict__ lo, int SP, int N0, int N1) {
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= static_cast<unsigned>(N0) * static_cast<unsigned>(N1)) return;
  const unsigned x = e / static_cast<unsigned>(N1);
  const unsigned y = e - x * static_cast<unsigned>(N1);
  float h = 0.0f, l = 0.0f;
  for (int s = 0; s < SP; ++s) {
    const float uh = __ldg(Uh + static_cast<long long>(s) * N0 + x);
    const float ul = __ldg(Ul + static_cast<long long>(s) * N0 + x);
    const float mh = __ldg(Mh + static_cast<long long>(s) * N1 + y);
    const float ml = __ldg(Ml + static_cast<long long>(s) * N1 + y);
    float p, t;
    pairs::mul_rr(uh, ul, mh, ml, p, t);
    if (s == 0) {
      h = p;
      l = t;
    } else {
      float e2;
      pairs::two_sum(h, p, h, e2);
      l = pairs::add(pairs::add(l, t), e2);
    }
  }
  hi[e] = h;
  lo[e] = l;
}

}  // namespace

extern "C" int sfft_pair_poly(const void* Uh, const void* Ul, const void* Mh, const void* Ml,
                              void* hi, void* lo, int SP, int N0, int N1, void* stream_ptr) {
  const unsigned n = static_cast<unsigned>(N0) * static_cast<unsigned>(N1);
  if (n == 0) return cudaSuccess;
  pair_poly_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(Uh), static_cast<const float*>(Ul),
      static_cast<const float*>(Mh), static_cast<const float*>(Ml), static_cast<float*>(hi),
      static_cast<float*>(lo), SP, N0, N1);
  return cudaGetLastError();
}
