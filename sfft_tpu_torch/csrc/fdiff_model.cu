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
// Design. Launch 1 forms T_ij = A'_ij . W1 (Fij x L0 x N1h, 1.7 MB at
// 4096^2, so it stays in L2) and, in Fij more blocks, the sums s_nc (a
// fixed-order tree over each block; with one thread summing 529 values
// serially the launch took 0.024 ms at the v2 widths, now 0.009).
// Launch 2 (redesigned for Hopper) gives each block a tile of 32 or 64
// rows x 32 columns of the half spectrum: 256 threads, a lane per column,
// a warp per 4 rows, or per 8 where K' dominates (Fij L0 >= kDenseK: half
// the W0 loads per FFMA). The tile's rows of W0 sit in shared memory
// (a-major, so a thread's rows at one a are 16-byte broadcast loads), and
// T_ij's tile (L0 x 32) too, double-buffered: cp.async brings T_{i+1} in
// while K'_i is computed, and each thread's FI_i values are loaded into
// registers before the wait, so the HBM stream of FI overlaps the K'
// arithmetic. Per ij the thread forms K'_ij for its rows from shared
// memory, scales it, and accumulates factor * FI into its sums; then the
// background and the center terms; then writes FJ - model. Without scaling
// planes the center term rides the same FI load (factor + SCALE a00). K' is
// never written. (The first design gave a thread one column and 16 rows at
// 64 threads a block, each walking Fij L0 serial L2 loads of T: 40% of the
// bound at 4096^2, 10.6% at the v2 widths.) Every sum has a fixed order
// (launch 2's the first design's, term for term), so two launches on the
// same input give the same bits.
//
// A batch of pairs (the batched step's difference: one pair of launches for
// the batch) puts the pair on gridDim.z of both launches: a pair's spectra,
// solution, scratch and output are those of its single launch, offset by
// the pair, so its bits do not depend on B or on its place in the batch.

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

constexpr int kRowThreads = 64;   // launch 1

// T[i, a, v] = sum_b A'[i, a, b] W1[b, v] (blocks y < Fij L0); the blocks
// y = Fij L0 + i, x = 0 write snc[i] = sum_ab A[i, a, b] - A[i, w0, w1]:
// kRowThreads partial sums over a fixed stride, added in a fixed tree.
template <typename R>
__global__ void kernel_spectrum_rows(const R* __restrict__ sol,
                                     const typename Cx<R>::T* __restrict__ W1,
                                     typename Cx<R>::T* __restrict__ T,
                                     R* __restrict__ snc, int Fij, int L0, int L1,
                                     int w0, int w1, int N1h, int neq) {
  using C = typename Cx<R>::T;
  // this block's pair
  sol += static_cast<long long>(blockIdx.z) * neq;
  T += static_cast<long long>(blockIdx.z) * Fij * L0 * N1h;
  snc += static_cast<long long>(blockIdx.z) * Fij;
  const int ia = blockIdx.y;  // i * L0 + a
  if (ia >= Fij * L0) {
    __shared__ R part[kRowThreads];
    if (blockIdx.x != 0) return;
    const int i = ia - Fij * L0;
    const R* A = sol + static_cast<long long>(i) * L0 * L1;
    R s = 0;
    for (int k = threadIdx.x; k < L0 * L1; k += kRowThreads) s += A[k];
    part[threadIdx.x] = s;
    __syncthreads();
    for (int h = kRowThreads / 2; h > 0; h /= 2) {
      if (threadIdx.x < h) part[threadIdx.x] += part[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) snc[i] = part[0] - A[w0 * L1 + w1];
    return;
  }
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
}

constexpr int kCols = 32;     // tile columns: a warp's lanes
constexpr int kWarps = 8;     // warps per block, each on ROWS rows
constexpr int kThreads = kCols * kWarps;
// rows per thread: 8 where K' dominates (Fij L0 complex multiply-adds an
// element at or above kDenseK, the v2 widths' 575): half the W0 loads per
// FFMA; 4 elsewhere (the fast slice's 102), where 8 rows cost a quarter of
// the blocks that keep the FI stream in flight
constexpr int kDenseK = 256;

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// T_i's tile (L0 x kCols, columns past N1h clamped: never written) into Ts.
template <typename C>
__device__ __forceinline__ void stage_T(C* Ts, const C* __restrict__ T, int i, int L0, int N1h,
                                        int v0) {
  for (int k = threadIdx.x; k < L0 * kCols; k += kThreads) {
    const int a = k / kCols, c = k % kCols;
    const int v = min(v0 + c, N1h - 1);
    cp_async<sizeof(C)>(Ts + k, T + (static_cast<long long>(i) * L0 + a) * N1h + v);
  }
}

// A thread's ROWS consecutive rows of W0 at lag a (a-major tile).
template <int ROWS>
__device__ __forceinline__ void load_w(const float2* W0s, int a, int r0, float2 (&w)[ROWS]) {
  const float4* p = reinterpret_cast<const float4*>(W0s + a * kWarps * ROWS + r0);
#pragma unroll
  for (int r = 0; r < ROWS; r += 2) {
    const float4 q = p[r / 2];
    w[r] = make_float2(q.x, q.y);
    w[r + 1] = make_float2(q.z, q.w);
  }
}

template <int ROWS>
__device__ __forceinline__ void load_w(const double2* W0s, int a, int r0, double2 (&w)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) w[r] = W0s[a * kWarps * ROWS + r0 + r];
}

template <typename R, int ROWS>
__global__ void __launch_bounds__(kThreads)
    model_spectrum(const typename Cx<R>::T* __restrict__ specs,
                   const typename Cx<R>::T* __restrict__ FS, const R* __restrict__ sol,
                   const typename Cx<R>::T* __restrict__ W0,
                   const typename Cx<R>::T* __restrict__ T, const R* __restrict__ snc,
                   typename Cx<R>::T* __restrict__ out, int Fij, int Fpq, int nS, int L0,
                   int L1, int w0, int w1, int N0, int N1h, R scale) {
  using C = typename Cx<R>::T;
  constexpr int kTileRows = kWarps * ROWS;
  {  // this block's pair
    const long long z = blockIdx.z, plane = static_cast<long long>(N0) * N1h;
    specs += z * (1 + Fij + Fpq) * plane;
    FS += z * nS * plane;
    sol += z * (static_cast<long long>(Fij) * L0 * L1 + Fpq);
    T += z * Fij * L0 * N1h;
    snc += z * Fij;
    out += z * plane;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* W0s = reinterpret_cast<C*>(smem_raw);       // [L0][kTileRows]
  C* Ts = W0s + L0 * kTileRows;                  // [2][L0][kCols]
  const int tid = threadIdx.x;
  const int lane = tid % kCols, r0 = (tid / kCols) * ROWS;
  const int u0 = blockIdx.y * kTileRows, v0 = blockIdx.x * kCols;

  stage_T(Ts, T, 0, L0, N1h, v0);
  cp_async_commit();
  for (int k = tid; k < kTileRows * L0; k += kThreads) {
    const int r = k / L0, a = k % L0;
    W0s[a * kTileRows + r] = W0[static_cast<long long>(min(u0 + r, N0 - 1)) * L0 + a];
  }

  const int v = v0 + lane;
  const bool col_ok = v < N1h;
  const int nrow = col_ok ? max(0, min(ROWS, N0 - u0 - r0)) : 0;
  const long long plane = static_cast<long long>(N0) * N1h;
  const long long base = static_cast<long long>(u0 + r0) * N1h + v;
  const int LL = L0 * L1;

  C acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    acc[r].x = 0;
    acc[r].y = 0;
  }
  for (int i = 0; i < Fij; ++i) {
    if (i + 1 < Fij) stage_T(Ts + ((i + 1) & 1) * L0 * kCols, T, i + 1, L0, N1h, v0);
    cp_async_commit();
    // FI_i's values for this thread's rows, in flight during the wait and K'
    const C* FI = specs + (1 + i) * plane + base;
    C f[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      f[r].x = 0;
      f[r].y = 0;
      if (r < nrow) f[r] = FI[static_cast<long long>(r) * N1h];
    }
    cp_async_wait_one();
    __syncthreads();
    const C* Tc = Ts + (i & 1) * L0 * kCols + lane;
    C K[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      K[r].x = 0;
      K[r].y = 0;
    }
    for (int a = 0; a < L0; ++a) {
      const C t = Tc[a * kCols];
      C w[ROWS];
      load_w(W0s, a, r0, w);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) K[r] = cmul_add(K[r], w[r], t);
    }
    // the center dof rides FI's load when it acts on the sigma planes
    const R shift = nS ? snc[i] : snc[i] - __ldg(sol + static_cast<long long>(i) * LL +
                                                  w0 * L1 + w1);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      C fac;
      fac.x = scale * (K[r].x - shift);
      fac.y = scale * K[r].y;
      acc[r] = cmul_add(acc[r], fac, f[r]);
    }
    __syncthreads();  // Ts[i & 1] is refilled by iteration i + 1
  }
  for (int p = 0; p < Fpq; ++p) {
    const R bp = __ldg(sol + static_cast<long long>(Fij) * LL + p);
    const C* FT = specs + (1 + Fij + p) * plane + base;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
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
    for (int r = 0; r < ROWS; ++r) {
      if (r < nrow) {
        const C t = F[static_cast<long long>(r) * N1h];
        acc[r].x = fma(c, t.x, acc[r].x);
        acc[r].y = fma(c, t.y, acc[r].y);
      }
    }
  }
  const C* FJ = specs + base;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < nrow) {
      const C j = FJ[static_cast<long long>(r) * N1h];
      C d;
      d.x = j.x - acc[r].x;
      d.y = j.y - acc[r].y;
      out[base + static_cast<long long>(r) * N1h] = d;
    }
  }
}

constexpr size_t kSmemMax = 232448;

template <typename R, int ROWS>
int launch_model(const void* specs, const void* FS, const void* sol, const void* W0,
                 const void* T, const void* snc, void* out, int Fij, int Fpq, int nS, int L0,
                 int L1, int w0, int w1, int N0, int N1h, int npairs, double scale,
                 cudaStream_t st) {
  using C = typename Cx<R>::T;
  constexpr int kTileRows = kWarps * ROWS;
  const int ublocks = (N0 + kTileRows - 1) / kTileRows;
  if (ublocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(C) * L0 * (kTileRows + 2 * kCols);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        model_spectrum<R, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  model_spectrum<R, ROWS><<<dim3((N1h + kCols - 1) / kCols, ublocks, npairs), kThreads, smem,
                            st>>>(
      static_cast<const C*>(specs), static_cast<const C*>(FS), static_cast<const R*>(sol),
      static_cast<const C*>(W0), static_cast<const C*>(T), static_cast<const R*>(snc),
      static_cast<C*>(out), Fij, Fpq, nS, L0, L1, w0, w1, N0, N1h, static_cast<R>(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch(const void* specs, const void* FS, const void* sol, const void* W0,
           const void* W1, void* T, void* snc, void* out, int Fij, int Fpq, int nS, int L0,
           int L1, int w0, int w1, int N0, int N1h, int npairs, double scale, void* stream) {
  using C = typename Cx<R>::T;
  if (Fij < 1 || Fpq < 0 || nS < 0 || nS > Fij || L0 < 1 || L1 < 1 || w0 < 0 ||
      w0 >= L0 || w1 < 0 || w1 >= L1 || N0 < 1 || N1h < 1 || (nS > 0 && FS == nullptr) ||
      Fij * (L0 + 1) > 65535 || npairs < 1 || npairs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel_spectrum_rows<R><<<dim3((N1h + kRowThreads - 1) / kRowThreads, Fij * (L0 + 1),
                                 npairs),
                            kRowThreads, 0, st>>>(
      static_cast<const R*>(sol), static_cast<const C*>(W1), static_cast<C*>(T),
      static_cast<R*>(snc), Fij, L0, L1, w0, w1, N1h, Fij * L0 * L1 + Fpq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return Fij * L0 >= kDenseK
             ? launch_model<R, 8>(specs, FS, sol, W0, T, snc, out, Fij, Fpq, nS, L0, L1, w0, w1,
                                  N0, N1h, npairs, scale, st)
             : launch_model<R, 4>(specs, FS, sol, W0, T, snc, out, Fij, Fpq, nS, L0, L1, w0, w1,
                                  N0, N1h, npairs, scale, st);
}

}  // namespace

// For each of npairs pairs: specs (1 + Fij + Fpq, N0, N1h) complex: FJ, the
// FI planes, the FT planes; FS (nS, N0, N1h) complex or null when nS = 0;
// sol the solution vector (Fij * L0 * L1 kernel coefficients, then Fpq
// background ones); scratch T (Fij, L0, N1h) complex and snc (Fij) real;
// out (N0, N1h) complex; each the pair's block of a contiguous (npairs,
// ...) array. W0 (N0, L0), W1 (L1, N1h) complex, shared. All device
// pointers of one precision. Two launches on `stream`. Returns
// cudaGetLastError().
extern "C" int sfft_fdiff_model_c64(const void* specs, const void* FS, const void* sol,
                                    const void* W0, const void* W1, void* T, void* snc,
                                    void* out, int Fij, int Fpq, int nS, int L0, int L1,
                                    int w0, int w1, int N0, int N1h, int npairs, double scale,
                                    void* stream) {
  return launch<float>(specs, FS, sol, W0, W1, T, snc, out, Fij, Fpq, nS, L0, L1, w0, w1,
                       N0, N1h, npairs, scale, stream);
}

extern "C" int sfft_fdiff_model_c128(const void* specs, const void* FS, const void* sol,
                                     const void* W0, const void* W1, void* T, void* snc,
                                     void* out, int Fij, int Fpq, int nS, int L0, int L1,
                                     int w0, int w1, int N0, int N1h, int npairs, double scale,
                                     void* stream) {
  return launch<double>(specs, FS, sol, W0, W1, T, snc, out, Fij, Fpq, nS, L0, L1, w0, w1,
                        N0, N1h, npairs, scale, stream);
}
