// K2 — the fused model spectrum of the Fourier-space difference, on Hopper.
//
// Replaces: the XLA stage of sfft_tpu/core/fdiff.py fdiff_fft (:90-103),
// which sits between the forward rfft2 of the plane stack and the inverse:
//
//   K'_ij    = W0 . A'_ij . W1              center-zeroed kernel spectrum
//   factor_ij = SCALE * (K'_ij - s_nc_ij)
//   FDIFF    = FJ - sum_ij factor_ij * FI_ij - sum_pq b_pq FT_pq
//                 - SCALE * sum_ij a00_ij FX_ij
//
// with FX = FS = rfft2(SSc) under SEPARATE-VARYING scaling and FX = FI
// otherwise. W0 (N0, L0) and W1 (L1, N1h) are the static phase matrices,
// A'_ij (L0, L1) the solution's kernel coefficients with the center zeroed,
// a00_ij the centers, s_nc_ij the sums of the non-center coefficients, b_pq
// the background coefficients. Templated on the real type: float (complex64,
// the 'fft32' difference) and double (complex128, the 'fft' difference).
//
// What bounds it: bytes. At 4096^2 with Fij = Fpq = 6 the stage reads FJ, FI
// and FT once and writes FDIFF once (14 half-spectrum planes, ~940 MB,
// 0.28 ms at 3.35 TB/s); its 6 x 17 complex multiply-adds per element for
// K' are ~7 GFLOP (0.10 ms of FP32). The XLA / eager version materialises
// the (Fij, N0, N1h) complex K' tensor and the products, and reads FI twice.
//
// Design (simple first). Launch 1 forms T_ij = A'_ij . W1 (Fij x L0 x N1h,
// 1.7 MB at 4096^2, so it stays in L2) and, in block 0, the Fij sums s_nc
// in a fixed order. Launch 2 gives each thread one column v of the half
// spectrum and U consecutive rows u; the U rows of W0 sit in shared memory
// (broadcast reads). Per ij the thread forms K'_ij[u, v] = sum_a W0[u, a]
// T_ij[a, v] for its U rows in registers (each T element loaded once per U
// rows), scales it, and accumulates factor * FI into U complex sums; then
// the background and the center terms; then writes FJ - model. Without
// scaling planes the center term rides the same FI load (factor + SCALE
// a00). K' is never written. Every sum has a fixed order, so two launches
// on the same input give the same bits.

#include <cuda_runtime.h>

namespace {

template <typename R> struct Cx;
template <> struct Cx<float> { using T = float2; };
template <> struct Cx<double> { using T = double2; };

template <typename C>
__device__ __forceinline__ C cmul_add(C acc, C x, C y) {
  acc.x = fma(x.x, y.x, fma(-x.y, y.y, acc.x));
  acc.y = fma(x.x, y.y, fma(x.y, y.x, acc.y));
  return acc;
}

// T[i, a, v] = sum_b A'[i, a, b] W1[b, v]; block 0 also writes
// snc[i] = sum_ab A[i, a, b] - A[i, w0, w1] (row-major order).
template <typename R>
__global__ void kernel_spectrum_rows(const R* __restrict__ sol,
                                     const typename Cx<R>::T* __restrict__ W1,
                                     typename Cx<R>::T* __restrict__ T,
                                     R* __restrict__ snc, int Fij, int L0, int L1,
                                     int w0, int w1, int N1h) {
  using C = typename Cx<R>::T;
  const int ia = blockIdx.y;  // i * L0 + a
  const int a = ia % L0;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v < N1h) {
    const R* row = sol + static_cast<long long>(ia) * L1;
    C acc;
    acc.x = 0;
    acc.y = 0;
    for (int b = 0; b < L1; ++b) {
      const R c = (a == w0 && b == w1) ? R(0) : __ldg(row + b);
      const C w = W1[static_cast<long long>(b) * N1h + v];
      acc.x = fma(c, w.x, acc.x);
      acc.y = fma(c, w.y, acc.y);
    }
    T[static_cast<long long>(ia) * N1h + v] = acc;
  }
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (int i = threadIdx.x; i < Fij; i += blockDim.x) {
      const R* A = sol + static_cast<long long>(i) * L0 * L1;
      R s = 0;
      for (int k = 0; k < L0 * L1; ++k) s += A[k];
      snc[i] = s - A[w0 * L1 + w1];
    }
  }
}

template <typename R, int U>
__global__ void model_spectrum(const typename Cx<R>::T* __restrict__ specs,
                               const typename Cx<R>::T* __restrict__ FS,
                               const R* __restrict__ sol,
                               const typename Cx<R>::T* __restrict__ W0,
                               const typename Cx<R>::T* __restrict__ T,
                               const R* __restrict__ snc, typename Cx<R>::T* __restrict__ out,
                               int Fij, int Fpq, int nS, int L0, int L1, int w0, int w1,
                               int N0, int N1h, R scale) {
  using C = typename Cx<R>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* W0s = reinterpret_cast<C*>(smem_raw);  // [U][L0]
  const int u0 = blockIdx.y * U;
  for (int k = threadIdx.x; k < U * L0; k += blockDim.x) {
    const int r = k / L0, a = k % L0;
    C w;
    w.x = 0;
    w.y = 0;
    if (u0 + r < N0) w = W0[static_cast<long long>(u0 + r) * L0 + a];
    W0s[k] = w;
  }
  __syncthreads();
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= N1h) return;
  const int nrow = min(U, N0 - u0);
  const long long plane = static_cast<long long>(N0) * N1h;
  const long long base = static_cast<long long>(u0) * N1h + v;
  const int LL = L0 * L1;

  C acc[U];
#pragma unroll
  for (int r = 0; r < U; ++r) {
    acc[r].x = 0;
    acc[r].y = 0;
  }
  for (int i = 0; i < Fij; ++i) {
    C K[U];
#pragma unroll
    for (int r = 0; r < U; ++r) {
      K[r].x = 0;
      K[r].y = 0;
    }
    const C* Ti = T + static_cast<long long>(i) * L0 * N1h + v;
    for (int a = 0; a < L0; ++a) {
      const C t = Ti[static_cast<long long>(a) * N1h];
#pragma unroll
      for (int r = 0; r < U; ++r) K[r] = cmul_add(K[r], W0s[r * L0 + a], t);
    }
    // the center dof rides FI's load when it acts on the sigma planes
    const R shift = nS ? snc[i] : snc[i] - __ldg(sol + static_cast<long long>(i) * LL +
                                                  w0 * L1 + w1);
    const C* FI = specs + (1 + i) * plane + base;
#pragma unroll
    for (int r = 0; r < U; ++r) {
      if (r < nrow) {
        C f;
        f.x = scale * (K[r].x - shift);
        f.y = scale * K[r].y;
        acc[r] = cmul_add(acc[r], f, FI[static_cast<long long>(r) * N1h]);
      }
    }
  }
  for (int p = 0; p < Fpq; ++p) {
    const R bp = __ldg(sol + static_cast<long long>(Fij) * LL + p);
    const C* FT = specs + (1 + Fij + p) * plane + base;
#pragma unroll
    for (int r = 0; r < U; ++r) {
      if (r < nrow) {
        const C t = FT[static_cast<long long>(r) * N1h];
        acc[r].x = fma(bp, t.x, acc[r].x);
        acc[r].y = fma(bp, t.y, acc[r].y);
      }
    }
  }
  for (int i = 0; i < nS; ++i) {
    const R c = scale * __ldg(sol + static_cast<long long>(i) * LL + w0 * L1 + w1);
    const C* F = FS + i * plane + base;
#pragma unroll
    for (int r = 0; r < U; ++r) {
      if (r < nrow) {
        const C t = F[static_cast<long long>(r) * N1h];
        acc[r].x = fma(c, t.x, acc[r].x);
        acc[r].y = fma(c, t.y, acc[r].y);
      }
    }
  }
  const C* FJ = specs + base;
#pragma unroll
  for (int r = 0; r < U; ++r) {
    if (r < nrow) {
      const C j = FJ[static_cast<long long>(r) * N1h];
      C d;
      d.x = j.x - acc[r].x;
      d.y = j.y - acc[r].y;
      out[base + static_cast<long long>(r) * N1h] = d;
    }
  }
}

constexpr int kThreads = 64;

template <typename R, int U>
int launch(const void* specs, const void* FS, const void* sol, const void* W0,
           const void* W1, void* T, void* snc, void* out, int Fij, int Fpq, int nS, int L0,
           int L1, int w0, int w1, int N0, int N1h, double scale, void* stream) {
  using C = typename Cx<R>::T;
  if (Fij < 1 || Fpq < 0 || nS < 0 || nS > Fij || L0 < 1 || L1 < 1 || w0 < 0 ||
      w0 >= L0 || w1 < 0 || w1 >= L1 || N0 < 1 || N1h < 1 || (nS > 0 && FS == nullptr) ||
      Fij * L0 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vblocks = (N1h + kThreads - 1) / kThreads;
  kernel_spectrum_rows<R><<<dim3(vblocks, Fij * L0), kThreads, 0, st>>>(
      static_cast<const R*>(sol), static_cast<const C*>(W1), static_cast<C*>(T),
      static_cast<R*>(snc), Fij, L0, L1, w0, w1, N1h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ublocks = (N0 + U - 1) / U;
  if (ublocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(C) * U * L0;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  model_spectrum<R, U><<<dim3(vblocks, ublocks), kThreads, smem, st>>>(
      static_cast<const C*>(specs), static_cast<const C*>(FS), static_cast<const R*>(sol),
      static_cast<const C*>(W0), static_cast<const C*>(T), static_cast<const R*>(snc),
      static_cast<C*>(out), Fij, Fpq, nS, L0, L1, w0, w1, N0, N1h, static_cast<R>(scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// specs (1 + Fij + Fpq, N0, N1h) complex: FJ, the FI planes, the FT planes;
// FS (nS, N0, N1h) complex or null when nS = 0; sol the solution vector
// (Fij * L0 * L1 kernel coefficients, then Fpq background ones); W0
// (N0, L0), W1 (L1, N1h) complex; scratch T (Fij, L0, N1h) complex and snc
// (Fij) real; out (N0, N1h) complex. All contiguous device pointers of one
// precision. Two launches on `stream`. Returns cudaGetLastError().
extern "C" int sfft_fdiff_model_c64(const void* specs, const void* FS, const void* sol,
                                    const void* W0, const void* W1, void* T, void* snc,
                                    void* out, int Fij, int Fpq, int nS, int L0, int L1,
                                    int w0, int w1, int N0, int N1h, double scale,
                                    void* stream) {
  return launch<float, 16>(specs, FS, sol, W0, W1, T, snc, out, Fij, Fpq, nS, L0, L1, w0, w1,
                           N0, N1h, scale, stream);
}

extern "C" int sfft_fdiff_model_c128(const void* specs, const void* FS, const void* sol,
                                     const void* W0, const void* W1, void* T, void* snc,
                                     void* out, int Fij, int Fpq, int nS, int L0, int L1,
                                     int w0, int w1, int N0, int N1h, double scale,
                                     void* stream) {
  return launch<double, 8>(specs, FS, sol, W0, W1, T, snc, out, Fij, Fpq, nS, L0, L1, w0, w1,
                           N0, N1h, scale, stream);
}
