// K8 — the FFT-free windowed circular cross-correlation, on Hopper.
//
// Replaces: the XLA convolution of sfft_tpu/core/greek.py corr_window_conv
// (:152-176), the greek 'corr' backend's tables (Comg, Cgam, Cthe and, under
// SEPARATE-VARYING scaling, Pbs):
//
//   C[p, rho + wx, eps + wy] = sum_xy A[a_p, x, y] * B[b_p, (x + rho) % N0, (y + eps) % N1]
//
// for |rho| <= wx, |eps| <= wy and a list of plane pairs p = (a_p, b_p), in
// float64. sfft_tpu lowers it to a VALID lax.conv of the wrap-padded B stack
// against the full-image A planes. The same formulation is one PyTorch call
// on the card (F.conv2d with the planes as its weight: cuDNN's f64 route,
// which builds no im2col matrix); chip_smoke.py phase 13a times it beside
// this kernel.
//
// What bounds it: FP64 operations, one multiply-add per pixel and distinct
// pair-lag. At 4096^2 the Comg table (6 x 6 pairs, 33 x 33 lags) has
// 15 x 1089 + 6 x 545 = 19,605 of them (the pairs a < b at every lag, the
// pairs a = a at half the lags, which mirror), 3.29e11 multiply-adds: 9.8 ms
// at the card's FP64 peak of 67 TFLOP/s (the tensor cores' DMMA rate; 19.4
// ms at the 34 TFLOP/s outside them). This kernel computes Comg's 21 pairs
// at every lag (3.84e11). The planes themselves are a few hundred MB (under
// 0.3 ms).
//
// Design. A block owns one pair, a band of kRows image rows and a range of
// at most 64 lags rho (the grid's z); it walks the band's columns in tiles
// of TY = S * kChunks. Per tile it stages the A tile (kRows x TY, zero
// outside the image) and the B tile with its halo ((kRows + R0c - 1) x
// (TY + nstrips * S)) in shared memory, reading B with the wrap in its own
// indices (no padded copy). A thread keeps one lag rho and a strip of S
// consecutive lags eps in f64 registers and takes every K-th row of the
// band; per row it walks the tile in chunks of S columns: S A values
// (broadcast loads), S new B values, S * S FMAs, so that one A value feeds S
// FMAs and one B value S more (the chunk loop is unrolled, so the sliding
// window costs no register moves). The K row groups meet in shared memory
// in a fixed order, and the block writes one partial per (band, pair, lag);
// a second launch adds the bands in a fixed order. No atomics: two launches
// on the same input give the same bits. The symmetry of Comg (21 of 36
// pairs, mirrored lags) is the caller's: it passes the pair list.
// Later work (not here): DMMA (the FP64 tensor cores, 67 TFLOP/s) and TMA
// for the halo tiles.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;     // image rows of a band (one block)
constexpr int kChunks = 6;    // S-column chunks of a column tile
constexpr int kThreads = 256;

__device__ __forceinline__ int wrap_index(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// grid (nbands, npairs, nrho); K row groups of NI = R0c * nstrips threads
template <int S>
__global__ void __launch_bounds__(kThreads)
corr_band(const double* __restrict__ A, const double* __restrict__ B,
          const int* __restrict__ pairs, double* __restrict__ part, int npairs,
          int N0, int N1, int R0, int R1, int nstrips, int R0c, int K) {
  extern __shared__ double smem[];
  constexpr int TY = S * kChunks;
  const int BW = TY + nstrips * S;          // B tile width
  const int BH = kRows + R0c - 1;           // B tile height
  double* As = smem;                        // kRows x TY
  double* Bs = smem + kRows * TY;           // BH x BW
  const int band = blockIdx.x, p = blockIdx.y;
  const int rho0 = blockIdx.z * R0c;        // first lag row (index) of this block
  const int nr = min(R0c, R0 - rho0);       // lag rows of this block
  const int x0 = band * kRows;
  const int wx = R0 / 2, wy = R1 / 2;
  const long long plane = static_cast<long long>(N0) * N1;
  const double* Ap = A + pairs[2 * p] * plane;
  const double* Bp = B + pairs[2 * p + 1] * plane;
  const int NI = nr * nstrips;
  const int t = threadIdx.x;
  const int item = t % NI, sub = t / NI;
  const bool active = sub < K;
  const int ri = item / nstrips;            // lag row within the block
  const int e0 = (item % nstrips) * S;      // first lag column of the strip
  double acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.0;

  for (int y0 = 0; y0 < N1; y0 += TY) {
    __syncthreads();  // the previous tile is consumed
    for (int k = t; k < kRows * TY; k += blockDim.x) {
      const int x = x0 + k / TY, y = y0 + k % TY;
      As[k] = (x < N0 && y < N1) ? Ap[static_cast<long long>(x) * N1 + y] : 0.0;
    }
    // tile row r <-> image row (x0 - wx + rho0 + r) mod N0, column c <->
    // (y0 - wy + c) mod N1
    for (int k = t; k < BH * BW; k += blockDim.x) {
      const int r = k / BW, c = k % BW;
      const int x = wrap_index(x0 - wx + rho0 + r, N0);
      const int y = wrap_index(y0 - wy + c, N1);
      Bs[k] = Bp[static_cast<long long>(x) * N1 + y];
    }
    __syncthreads();
    if (active) {
      for (int xr = sub; xr < kRows; xr += K) {
        const double* arow = As + xr * TY;
        const double* brow = Bs + (xr + ri) * BW + e0;
        double lo[S], hi[S];
#pragma unroll
        for (int s = 0; s < S; ++s) lo[s] = brow[s];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int y = c * S;
          double a[S];
#pragma unroll
          for (int j = 0; j < S; ++j) a[j] = arow[y + j];
#pragma unroll
          for (int s = 0; s < S; ++s) hi[s] = brow[y + S + s];
#pragma unroll
          for (int j = 0; j < S; ++j) {
#pragma unroll
            for (int s = 0; s < S; ++s) {
              const int k = j + s;
              acc[s] = fma(a[j], k < S ? lo[k] : hi[k - S], acc[s]);
            }
          }
#pragma unroll
          for (int s = 0; s < S; ++s) lo[s] = hi[s];
        }
      }
    }
  }
  // the K row groups, in a fixed order
  __syncthreads();
  double* red = smem;  // K * NI * S <= kThreads * S doubles, within the tiles
  if (active) {
#pragma unroll
    for (int s = 0; s < S; ++s) red[(sub * NI + item) * S + s] = acc[s];
  }
  __syncthreads();
  if (active && sub == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      double v = red[item * S + s];
      for (int k = 1; k < K; ++k) v += red[(k * NI + item) * S + s];
      const int ei = e0 + s;
      if (ei < R1)
        part[((static_cast<long long>(band) * npairs + p) * R0 + rho0 + ri) * R1 + ei] = v;
    }
  }
}

// out[i] = sum over bands of part[band, i], bands in order
__global__ void sum_bands(const double* __restrict__ part, double* __restrict__ out,
                          long long n, int nbands) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double v = 0.0;
  for (int b = 0; b < nbands; ++b) v += part[b * n + i];
  out[i] = v;
}

template <int S>
cudaError_t launch(const double* A, const double* B, const int* pairs, double* part,
                   int npairs, int N0, int N1, int R0, int R1, int nstrips, int R0c,
                   cudaStream_t stream) {
  const int NI = R0c * nstrips;
  const int K = NI > kThreads ? 0 : (kThreads / NI < kRows ? kThreads / NI : kRows);
  if (K < 1) return cudaErrorInvalidValue;
  const int threads = (NI * K + 31) / 32 * 32;
  const int TY = S * kChunks;
  const size_t smem = sizeof(double) *
      (static_cast<size_t>(kRows) * TY + static_cast<size_t>(kRows + R0c - 1) * (TY + nstrips * S));
  cudaError_t err = cudaFuncSetAttribute(corr_band<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N0 + kRows - 1) / kRows, npairs, (R0 + R0c - 1) / R0c);
  corr_band<S><<<grid, threads, smem, stream>>>(A, B, pairs, part, npairs, N0, N1, R0, R1,
                                                 nstrips, R0c, K);
  return cudaGetLastError();
}

}  // namespace

// A (Fa, N0, N1), B (Fb, N0, N1) f64 contiguous; pairs (npairs, 2) int32
// device indices; part (nbands, npairs, R0, R1) f64 scratch with nbands =
// ceil(N0 / 32); out (npairs, R0, R1) f64. S, nstrips and R0c come from the
// wrapper's plan (greek._k8_plan): S in 1..12, nstrips * S >= R1, R0c *
// nstrips <= 256.
extern "C" int sfft_corr_direct(const double* A, const double* B, const int* pairs, double* part,
                                double* out, int npairs, int N0, int N1, int wx, int wy, int S,
                                int nstrips, int R0c, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int R0 = 2 * wx + 1, R1 = 2 * wy + 1;
  if (npairs < 1 || npairs > 65535 || N0 < 1 || N1 < 1 || wx < 0 || wy < 0 || S < 1 ||
      S > 12 || nstrips * S < R1 || R0c < 1 || R0c * nstrips > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (S) {
#define SFFT_K8_CASE(s) \
    case s: err = launch<s>(A, B, pairs, part, npairs, N0, N1, R0, R1, nstrips, R0c, stream); break;
    SFFT_K8_CASE(1) SFFT_K8_CASE(2) SFFT_K8_CASE(3) SFFT_K8_CASE(4) SFFT_K8_CASE(5)
    SFFT_K8_CASE(6) SFFT_K8_CASE(7) SFFT_K8_CASE(8) SFFT_K8_CASE(9) SFFT_K8_CASE(10)
    SFFT_K8_CASE(11) SFFT_K8_CASE(12)
#undef SFFT_K8_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(npairs) * R0 * R1;
  const int nbands = (N0 + kRows - 1) / kRows;
  sum_bands<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(part, out, n, nbands);
  return static_cast<int>(cudaGetLastError());
}
