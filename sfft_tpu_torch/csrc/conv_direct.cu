// K9 — direct convolution of a plane stack with small kernels, summed, plus
// background planes, subtracted from J; on Hopper.
//
// Replaces: the XLA grouped convolution of sfft_tpu/core/fdiff.py fdiff_conv
// (:107-147), the fdiff 'conv' backend's difference, and the convolutions of
// sfft_tpu/utils/convolve.py convolve2d (:54-67, :93-107), its one-plane case:
//
//   model[x, y] = scale * sum_i sum_ab T_i[a, b] * P_i[x - (a - w0), y - (b - w1)]
//                 + sum_q b_q ST_q[x, y] + scale * sum_s a00_s SS_s[x, y]
//   out = J - model        (fdiff)        or        out = model   (no J)
//
// P_i read with the indices mod the plane's size (wrap: fdiff's circular
// convolution, convolve2d's 'wrap'), or from a plane the caller padded by
// (w0, w1) on each side (convolve2d's 'extend' / 'fill'). In float64.
//
// What bounds it: FP64 operations, one multiply-add per pixel, plane and
// tap: at 4096^2, 6 planes of 17 x 17 taps, 2.91e10 (0.87 ms at the card's
// FP64 peak of 67 TFLOP/s, which needs the tensor cores; 1.71 ms at the 34
// TFLOP/s outside them) against ~1.9 GB of planes read and written (0.56
// ms); 31 x 31 taps on one 2046 x 4094 plane, 8.0e9 (0.24 ms).
//
// Design. A block owns an output tile of 32 rows x 64 columns: 256 threads,
// a lane per column (conflict-free shared loads), 4 row groups of 8 rows.
// Per plane it stages the tile with its halo ((32 + L0 - 1) x (64 + L1 - 1))
// and the plane's taps, flipped, in shared memory; a kernel with a side
// over kSide = 63 is walked in chunks of at most 63 x 63 taps, each with
// its own halo tile, so the shared memory stays under 127 KB for any side. A thread keeps its 8
// outputs in f64 registers across all planes; per tap column b it walks the
// tap rows with a window of 8 tile values in registers, indexed mod 8 in a
// loop unrolled by 8, so each step loads one tile value and one tap (a
// broadcast) for 8 FMAs and moves no register. The background and scaling
// planes and J are read once per pixel in the epilogue. Every sum has a
// fixed order: two launches on the same input give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;   // output columns of a tile, a lane each
constexpr int kGroups = 4;  // row groups
constexpr int kPX = 8;      // output rows a thread keeps
constexpr int kTileRows = kGroups * kPX;
constexpr int kThreads = kCols * kGroups;
constexpr int kSide = 63;   // most taps along an axis staged at once

__device__ __forceinline__ int wrap_index(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

struct ConvArgs {
  const double* planes;  // (F, H, W)
  const double* taps;    // (F, L0, L1), unflipped
  const double* J;       // (N0, N1) or null
  const double* ST;      // (Q, N0, N1) or null
  const double* bq;      // (Q,)
  const double* SS;      // (NS, N0, N1) or null
  const double* a00;     // (NS,)
  double* out;           // (N0, N1)
  int F, H, W, L0, L1, wrap, N0, N1, Q, NS;
  double scale;
};

__global__ void __launch_bounds__(kThreads) conv_tile(const ConvArgs g) {
  extern __shared__ double smem[];
  const int C0 = min(g.L0, kSide), C1 = min(g.L1, kSide);
  double* tile = smem;                                       // th x tw of a chunk
  double* taps = smem + (kTileRows + C0 - 1) * (kCols + C1 - 1);   // c0 x c1, flipped
  const int x0 = blockIdx.y * kTileRows, y0 = blockIdx.x * kCols;
  const int w0 = g.L0 / 2, w1 = g.L1 / 2;
  const int t = threadIdx.x;
  const int j = t % kCols, grp = t / kCols;
  const long long plane = static_cast<long long>(g.H) * g.W;
  double acc[kPX];
#pragma unroll
  for (int p = 0; p < kPX; ++p) acc[p] = 0.0;

  for (int f = 0; f < g.F; ++f) {
    const double* P = g.planes + f * plane;
    const double* T = g.taps + static_cast<long long>(f) * g.L0 * g.L1;
    // the flipped taps taps'[a'][b'] = T[L0-1-a'][L1-1-b'] in chunks of at
    // most kSide x kSide from (A0, B0); a kernel of sides <= kSide is one
    // chunk
    for (int A0 = 0; A0 < g.L0; A0 += kSide) {
      const int c0 = min(kSide, g.L0 - A0), th = kTileRows + c0 - 1;
      for (int B0 = 0; B0 < g.L1; B0 += kSide) {
        const int c1 = min(kSide, g.L1 - B0), tw = kCols + c1 - 1;
        __syncthreads();  // the previous chunk is consumed
        // tile row r <-> plane row (x0 - w0 + A0 + r) mod H (wrap) or
        // x0 + A0 + r (padded); columns alike from B0
        for (int k = t; k < th * tw; k += kThreads) {
          const int r = k / tw, c = k % tw;
          double v = 0.0;
          if (g.wrap) {
            v = P[static_cast<long long>(wrap_index(x0 - w0 + A0 + r, g.H)) * g.W +
                  wrap_index(y0 - w1 + B0 + c, g.W)];
          } else if (x0 + A0 + r < g.H && y0 + B0 + c < g.W) {
            v = P[static_cast<long long>(x0 + A0 + r) * g.W + y0 + B0 + c];
          }
          tile[k] = v;
        }
        for (int k = t; k < c0 * c1; k += kThreads) {
          const int a = k / c1, b = k % c1;
          taps[k] = T[static_cast<long long>(g.L0 - 1 - A0 - a) * g.L1 + g.L1 - 1 - B0 - b];
        }
        __syncthreads();
        for (int b = 0; b < c1; ++b) {
          const double* col = tile + grp * kPX * tw + j + b;
          const double* kcol = taps + b;
          double win[kPX];
          // the value of relative row q sits in slot q % kPX
#pragma unroll
          for (int q = 0; q < kPX - 1; ++q) win[q] = col[q * tw];
          for (int a0 = 0; a0 < c0; a0 += kPX) {
#pragma unroll
            for (int u = 0; u < kPX; ++u) {
              const int a = a0 + u;
              if (a < c0) {
                win[(u + kPX - 1) % kPX] = col[(a + kPX - 1) * tw];
                const double k = kcol[a * c1];
#pragma unroll
                for (int p = 0; p < kPX; ++p) acc[p] = fma(k, win[(u + p) % kPX], acc[p]);
              }
            }
          }
        }
      }
    }
  }
  const int y = y0 + j;
  if (y >= g.N1) return;
  const long long n = static_cast<long long>(g.N0) * g.N1;
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
    const int x = x0 + grp * kPX + p;
    if (x >= g.N0) continue;
    const long long i = static_cast<long long>(x) * g.N1 + y;
    double bg = 0.0, sc = 0.0;
    for (int q = 0; q < g.Q; ++q) bg = fma(g.bq[q], g.ST[q * n + i], bg);
    for (int s = 0; s < g.NS; ++s) sc = fma(g.a00[s], g.SS[s * n + i], sc);
    const double model = g.scale * acc[p] + bg + g.scale * sc;
    g.out[i] = g.J ? g.J[i] - model : model;
  }
}

}  // namespace

// The wrapper (core/fdiff.conv_direct) checks shapes, types and devices:
// planes (F, H, W) with H = N0, W = N1 when wrap, else H = N0 + L0 - 1, W =
// N1 + L1 - 1; L0, L1 odd; every tensor f64 contiguous.
extern "C" int sfft_conv_direct(const double* planes, const double* taps, const double* J,
                                const double* ST, const double* bq, const double* SS,
                                const double* a00, double* out, int F, int H, int W, int L0,
                                int L1, int wrap, int N0, int N1, int Q, int NS, double scale,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (F < 1 || L0 < 1 || L1 < 1 || N0 < 1 || N1 < 1 || Q < 0 || NS < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvArgs g{planes, taps, J, ST, bq, SS, a00, out, F, H, W, L0, L1, wrap, N0, N1, Q, NS,
                   scale};
  const int C0 = L0 < kSide ? L0 : kSide, C1 = L1 < kSide ? L1 : kSide;
  const size_t smem = sizeof(double) *
      (static_cast<size_t>(kTileRows + C0 - 1) * (kCols + C1 - 1) + static_cast<size_t>(C0) * C1);
  cudaError_t err = cudaFuncSetAttribute(conv_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N1 + kCols - 1) / kCols, (N0 + kTileRows - 1) / kTileRows);
  conv_tile<<<grid, kThreads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}
