// K3 — skinny f64 moment contraction M = W @ G on Hopper.
//
// Replaces: sfft_tpu/core/pallas_moments.py, moments_pallas / _make_kernel
// (the Pallas kernel called from sfft_tpu/core/peel.py _exact_skinny_matmul).
// The TPU has no fast exact f64, so that kernel carried the product in
// compensated double-float on f32 (hi, lo) splits. Hopper has native FP64,
// so this kernel computes the same M directly in f64 arithmetic (one fused
// multiply-add per term), with no splitting.
//
// Shapes: W (S, N0) f64 with S <= 16 per launch (the wrapper chunks larger
// S), G (N0, N1) f64, both row-major and contiguous; M (S, N1) f64. On the
// peeled path S = 8 and N0 = N1 = 4096.
//
// What bounds it: bytes. Every element of G is read once (134 MB at 4096^2)
// and feeds only 2*S flops, far below the card's flop-per-byte balance.
// Design: one thread per output column y, so the loads of a G row coalesce
// across a warp; S f64 accumulators live in registers; W[:, x-chunk] is
// staged in shared memory and read as broadcasts. The contraction axis is
// split over gridDim.y so that enough blocks are in flight to keep the
// memory system busy (a 4096-wide G gives only 32 column blocks). Each split
// writes its partial sums to scratch, and a second pass adds the partials in
// a fixed order: the result is deterministic (no atomics). Ragged N0 and N1
// are masked inside the kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // threads per block = output columns per block
constexpr int kRows = 64;   // contraction rows per shared-memory tile

template <int S>
__global__ void __launch_bounds__(kCols)
moments_partial(const double* __restrict__ W, const double* __restrict__ G,
                double* __restrict__ part, int N0, int N1, int rows_per_split) {
  __shared__ double Ws[S][kRows];
  const int y = blockIdx.x * kCols + threadIdx.x;
  const int x_begin = blockIdx.y * rows_per_split;
  const int x_end = min(N0, x_begin + rows_per_split);
  double acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.0;

  for (int x0 = x_begin; x0 < x_end; x0 += kRows) {
    const int n = min(kRows, x_end - x0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < S * kRows; i += kCols) {
      const int s = i / kRows, k = i % kRows;
      Ws[s][k] = (k < n) ? W[(size_t)s * N0 + x0 + k] : 0.0;
    }
    __syncthreads();
    if (y < N1) {
      const double* g = G + (size_t)x0 * N1 + y;
      int k = 0;
      for (; k + 4 <= n; k += 4) {  // four loads in flight per thread
        const double g0 = __ldg(g + (size_t)(k + 0) * N1);
        const double g1 = __ldg(g + (size_t)(k + 1) * N1);
        const double g2 = __ldg(g + (size_t)(k + 2) * N1);
        const double g3 = __ldg(g + (size_t)(k + 3) * N1);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          acc[s] = fma(Ws[s][k + 0], g0, acc[s]);
          acc[s] = fma(Ws[s][k + 1], g1, acc[s]);
          acc[s] = fma(Ws[s][k + 2], g2, acc[s]);
          acc[s] = fma(Ws[s][k + 3], g3, acc[s]);
        }
      }
      for (; k < n; ++k) {
        const double gk = __ldg(g + (size_t)k * N1);
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] = fma(Ws[s][k], gk, acc[s]);
      }
    }
  }
  if (y < N1) {
    double* p = part + (size_t)blockIdx.y * S * N1 + y;
#pragma unroll
    for (int s = 0; s < S; ++s) p[(size_t)s * N1] = acc[s];
  }
}

// out[i] = sum_k part[k, i] over the splits, in split order.
__global__ void moments_reduce(const double* __restrict__ part,
                               double* __restrict__ out, int n, int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double acc = 0.0;
  for (int k = 0; k < nsplit; ++k) acc += part[(size_t)k * n + i];
  out[i] = acc;
}

}  // namespace

// W (S, N0), G (N0, N1), part (nsplit, S, N1) scratch, out (S, N1); all f64
// device pointers. rows_per_split * nsplit >= N0. Returns cudaGetLastError().
extern "C" int sfft_moments_f64(const void* W, const void* G, void* part,
                                void* out, int S, int N0, int N1, int nsplit,
                                int rows_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* w = static_cast<const double*>(W);
  const double* g = static_cast<const double*>(G);
  double* p = static_cast<double*>(part);
  const dim3 grid((N1 + kCols - 1) / kCols, nsplit);
  switch (S) {
#define SFFT_MOMENTS_CASE(s_)                                                  \
  case s_:                                                                     \
    moments_partial<s_><<<grid, kCols, 0, st>>>(w, g, p, N0, N1, rows_per_split); \
    break;
    SFFT_MOMENTS_CASE(1) SFFT_MOMENTS_CASE(2) SFFT_MOMENTS_CASE(3)
    SFFT_MOMENTS_CASE(4) SFFT_MOMENTS_CASE(5) SFFT_MOMENTS_CASE(6)
    SFFT_MOMENTS_CASE(7) SFFT_MOMENTS_CASE(8) SFFT_MOMENTS_CASE(9)
    SFFT_MOMENTS_CASE(10) SFFT_MOMENTS_CASE(11) SFFT_MOMENTS_CASE(12)
    SFFT_MOMENTS_CASE(13) SFFT_MOMENTS_CASE(14) SFFT_MOMENTS_CASE(15)
    SFFT_MOMENTS_CASE(16)
#undef SFFT_MOMENTS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = S * N1;
  moments_reduce<<<(n + 255) / 256, 256, 0, st>>>(p, static_cast<double*>(out), n, nsplit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sfft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
