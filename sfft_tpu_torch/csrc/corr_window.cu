// K1 — windowed cross-correlation from rfft2 half-spectra on Hopper.
//
// Replaces: sfft_tpu/core/greek.py, corr_window_fft with method="matmul"
// (greek.py:94-130), a stage that XLA compiled on the TPU. For each pair c
// of the list (ia, ib) it computes
//
//   CC[c, r, e] = Re sum_u E0[r, u] * sum_v (A[ia_c, u, v] * conj B[ib_c, u, v]) * E1[v, e]
//
// with E0 (R0, N0) and E1 (N1h, R1) the partial inverse-DFT matrices of
// greek._partial_idft_mats (E1 carries the Hermitian fold weight 2). The
// spectra are (F, N0, N1h) complex, row-major and contiguous; B is
// conjugated here (the wrapper hands in plain data, never a lazy conj view).
// Templated on float (complex64, the peeled path's fluctuation spectra) and
// double (complex128, the f64 'fft' greek backend).
//
// What bounds it: the first stage does R1 complex multiply-adds per element
// of the Hadamard product (4096 x 2049 x 33 per pair on the 4096^2 OMG
// window), and it reads both spectra once per pair. The design keeps the
// Hadamard product out of device memory: stage 1 loads a (64 x VT) tile of
// A and B, forms H = A * conj(B) straight into shared memory, stages the
// matching VT rows of E1 in shared memory (E1 as a whole, 541 KB in c64 at
// 4096^2, does not fit), and contracts over v in registers: each thread owns
// 2 rows u and ceil(R1 / 8) lags e, so one H load from shared memory feeds
// ceil(R1 / 8) complex FMAs and the E1 loads are warp-wide broadcasts. Stage
// 1 writes T1 (pairs, N0, R1), about R1 / N1h (1.6%) of the product's bytes;
// stage 2 contracts T1 over u with E0 and keeps the real part. Sums run
// in two levels (a tile-local sum folded into the running sum) to keep the
// f32 rounding growth small; no atomics, so results are deterministic.
// Reading each spectrum row once for all pairs is left for later.

#include <cuda_runtime.h>

namespace {

template <typename R> struct CplxOf;
template <> struct CplxOf<float> { using T = float2; };
template <> struct CplxOf<double> { using T = double2; };

template <typename C>
__device__ __forceinline__ C czero() { C z; z.x = 0; z.y = 0; return z; }

// acc + h * e
template <typename C>
__device__ __forceinline__ C cmac(C acc, C h, C e) {
  acc.x = fma(h.x, e.x, fma(-h.y, e.y, acc.x));
  acc.y = fma(h.x, e.y, fma(h.y, e.x, acc.y));
  return acc;
}

constexpr int kTX = 32;          // threads along u (two rows each)
constexpr int kTY = 8;           // threads along the lag axis e
constexpr int kUT = 2 * kTX;     // spectrum rows per block
constexpr int kMaxNE = 8;        // lags per thread: R1 <= kTY * kMaxNE = 64

template <typename R, int NE>
__global__ void __launch_bounds__(kTX * kTY)
corr_stage1(const typename CplxOf<R>::T* __restrict__ A,
            const typename CplxOf<R>::T* __restrict__ B,
            const int* __restrict__ ia, const int* __restrict__ ib,
            const typename CplxOf<R>::T* __restrict__ E1,
            typename CplxOf<R>::T* __restrict__ T1, int N0, int N1h, int R1) {
  using C = typename CplxOf<R>::T;
  constexpr int VT = 256 / sizeof(C);  // 32 columns (c64) or 16 (c128)
  constexpr int NEW = NE * kTY;        // lags staged per E1 row
  __shared__ C Hs[kUT][VT + 1];        // +1: conflict-free column reads
  __shared__ C Es[VT][NEW];

  const int c = blockIdx.y;
  const int u0 = blockIdx.x * kUT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * kTX + tx;
  const C* a = A + (size_t)ia[c] * N0 * N1h;
  const C* b = B + (size_t)ib[c] * N0 * N1h;

  C acc[2][NE];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NE; ++j) acc[i][j] = czero<C>();

  for (int v0 = 0; v0 < N1h; v0 += VT) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = t; i < kUT * VT; i += kTX * kTY) {
      const int r = i / VT, col = i % VT;
      const int u = u0 + r, v = v0 + col;
      C h = czero<C>();
      if (u < N0 && v < N1h) {
        const C x = a[(size_t)u * N1h + v];
        const C y = b[(size_t)u * N1h + v];
        h.x = fma(x.x, y.x, x.y * y.y);   // x * conj(y)
        h.y = fma(x.y, y.x, -x.x * y.y);
      }
      Hs[r][col] = h;
    }
    for (int i = t; i < VT * NEW; i += kTX * kTY) {
      const int k = i / NEW, e = i % NEW;
      const int v = v0 + k;
      Es[k][e] = (v < N1h && e < R1) ? E1[(size_t)v * R1 + e] : czero<C>();
    }
    __syncthreads();

    C part[2][NE];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NE; ++j) part[i][j] = czero<C>();
#pragma unroll 4
    for (int k = 0; k < VT; ++k) {
      const C h0 = Hs[tx][k];
      const C h1 = Hs[tx + kTX][k];
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        const C e = Es[k][ty + kTY * j];
        part[0][j] = cmac(part[0][j], h0, e);
        part[1][j] = cmac(part[1][j], h1, e);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        acc[i][j].x += part[i][j].x;
        acc[i][j].y += part[i][j].y;
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = u0 + tx + kTX * i;
    if (u >= N0) continue;
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int e = ty + kTY * j;
      if (e < R1) T1[((size_t)c * N0 + u) * R1 + e] = acc[i][j];
    }
  }
}

// Stage 2 is small (R0 * R1 outputs per pair), so a block is wide along u
// to keep enough threads in flight: 64 lanes along e times 16 phases along u.
constexpr int kRG = 4;       // output rows r per stage-2 block
constexpr int kLanes = 64;   // threads along e (R1 <= 64)
constexpr int kPhases = 16;  // threads along u
constexpr int kUChunk = 16;  // u steps per tile-local partial sum

// out[c, r, e] = Re sum_u E0[r, u] * T1[c, u, e]
template <typename R>
__global__ void __launch_bounds__(kLanes * kPhases)
corr_stage2(const typename CplxOf<R>::T* __restrict__ T1,
            const typename CplxOf<R>::T* __restrict__ E0,
            R* __restrict__ out, int N0, int R0, int R1) {
  using C = typename CplxOf<R>::T;
  __shared__ R red[kPhases][kRG][kLanes];
  const int c = blockIdx.y;
  const int r0 = blockIdx.x * kRG;
  const int e = threadIdx.x, p = threadIdx.y;
  R acc[kRG];
#pragma unroll
  for (int j = 0; j < kRG; ++j) acc[j] = 0;
  if (e < R1) {
    const C* tc = T1 + (size_t)c * N0 * R1 + e;
    for (int ub = p; ub < N0; ub += kPhases * kUChunk) {
      R part[kRG];
#pragma unroll
      for (int j = 0; j < kRG; ++j) part[j] = 0;
      const int uend = min(N0, ub + kPhases * kUChunk);
      for (int u = ub; u < uend; u += kPhases) {
        const C tv = tc[(size_t)u * R1];
#pragma unroll
        for (int j = 0; j < kRG; ++j) {
          const int r = r0 + j;
          if (r < R0) {
            const C w = E0[(size_t)r * N0 + u];
            part[j] = fma(w.x, tv.x, fma(-w.y, tv.y, part[j]));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRG; ++j) acc[j] += part[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kRG; ++j) red[p][j][e] = acc[j];
  __syncthreads();
  if (p == 0 && e < R1) {
#pragma unroll
    for (int j = 0; j < kRG; ++j) {
      const int r = r0 + j;
      if (r < R0) {
        R s = red[0][j][e];
#pragma unroll
        for (int q = 1; q < kPhases; ++q) s += red[q][j][e];
        out[((size_t)c * R0 + r) * R1 + e] = s;
      }
    }
  }
}

template <typename R>
int launch(const void* A, const void* B, const void* ia, const void* ib,
           const void* E0, const void* E1, void* T1, void* out, int npairs,
           int N0, int N1h, int R0, int R1, void* stream) {
  using C = typename CplxOf<R>::T;
  if (R1 < 1 || R1 > kTY * kMaxNE || R0 < 1 || npairs < 1 || npairs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const C* a = static_cast<const C*>(A);
  const C* b = static_cast<const C*>(B);
  const int* pa = static_cast<const int*>(ia);
  const int* pb = static_cast<const int*>(ib);
  const C* e1 = static_cast<const C*>(E1);
  C* t1 = static_cast<C*>(T1);
  const dim3 grid1((N0 + kUT - 1) / kUT, npairs);
  const dim3 block1(kTX, kTY);
  switch ((R1 + kTY - 1) / kTY) {
#define SFFT_CORR_CASE(ne_)                                                    \
  case ne_:                                                                    \
    corr_stage1<R, ne_><<<grid1, block1, 0, st>>>(a, b, pa, pb, e1, t1, N0, N1h, R1); \
    break;
    SFFT_CORR_CASE(1) SFFT_CORR_CASE(2) SFFT_CORR_CASE(3) SFFT_CORR_CASE(4)
    SFFT_CORR_CASE(5) SFFT_CORR_CASE(6) SFFT_CORR_CASE(7) SFFT_CORR_CASE(8)
#undef SFFT_CORR_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((R0 + kRG - 1) / kRG, npairs);
  const dim3 block2(kLanes, kPhases);
  corr_stage2<R><<<grid2, block2, 0, st>>>(t1, static_cast<const C*>(E0),
                                           static_cast<R*>(out), N0, R0, R1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (Fa, N0, N1h), B (Fb, N0, N1h) complex; ia, ib (npairs,) int32 plane
// indices; E0 (R0, N0), E1 (N1h, R1) complex; T1 (npairs, N0, R1) complex
// scratch; out (npairs, R0, R1) real. Returns cudaGetLastError().
extern "C" int sfft_corr_window_c64(const void* A, const void* B, const void* ia,
                                    const void* ib, const void* E0, const void* E1,
                                    void* T1, void* out, int npairs, int N0, int N1h,
                                    int R0, int R1, void* stream) {
  return launch<float>(A, B, ia, ib, E0, E1, T1, out, npairs, N0, N1h, R0, R1, stream);
}

extern "C" int sfft_corr_window_c128(const void* A, const void* B, const void* ia,
                                     const void* ib, const void* E0, const void* E1,
                                     void* T1, void* out, int npairs, int N0, int N1h,
                                     int R0, int R1, void* stream) {
  return launch<double>(A, B, ia, ib, E0, E1, T1, out, npairs, N0, N1h, R0, R1, stream);
}
