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
// and feeds only 2*S flops (0.27 GFLOP, 0.008 ms of FP64), so the only thing
// that matters is how many bytes of G are in flight on every SM, all the
// time.
//
// Design. A thread owns VEC output columns (VEC = 2: one 16-byte load per
// row; VEC = 1, 8-byte loads, when N1 is odd or a pointer is not 16-byte
// aligned) and S * VEC accumulators in registers. A block is WX warps along
// the columns times WY warps along the rows; the contraction axis is split
// over gridDim.y, planned by the wrapper so that the grid is one wave of
// blocks (two of 256 threads per SM). A warp walks its rows in groups of U
// (4: with the next group's loads that is 128 bytes per thread, 64 KB per
// SM): the U loads of the next group are started before the multiply-adds of
// the current one, so every thread keeps U * 16 bytes in flight all the time,
// also across the staging of W and from the block's first instruction. The
// W values of 128 rows sit in shared memory, transposed to [row][s] so that
// a row's S weights are a few 16-byte broadcast loads; the next 128 are
// fetched into registers meanwhile and stored into the other buffer, with
// one barrier per 128 rows. The WY row groups of a block are added through
// shared memory in a fixed order; each block writes its partial sums to
// scratch, and the last block to finish a column block (found with
// __threadfence() and an integer ticket, the kernel's only atomic) adds the
// partials in split order with all its threads and sets the ticket back to
// 0. One launch, and every f64 sum has a fixed order: two launches on the
// same input give the same bits. Ragged N0 and N1 are masked inside the
// kernel (rows past the end load as zeros).
//
// A batch of pairs: M_b = W @ G_b for B images G_b sharing W (the batched
// step's moment sets, one launch for the batch). The pair is gridDim.z; a
// pair's blocks, splits, scratch and tickets are those of its single
// launch, offset by the pair, so its bits do not depend on B or on its
// place in the batch.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;  // contraction rows per staging of W

template <int VEC> struct Cols;
template <> struct Cols<1> {
  double c[1];
  __device__ __forceinline__ void zero() { c[0] = 0.0; }
  __device__ __forceinline__ void load_shared(const double* p) { c[0] = p[0]; }
  __device__ __forceinline__ void load(const double* p) { c[0] = __ldg(p); }
  __device__ __forceinline__ void load_l2(const double* p) { c[0] = __ldcg(p); }
  __device__ __forceinline__ void store(double* p) const { p[0] = c[0]; }
};
template <> struct Cols<2> {
  double c[2];
  __device__ __forceinline__ void zero() { c[0] = 0.0; c[1] = 0.0; }
  __device__ __forceinline__ void load_shared(const double* p) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    c[0] = v.x; c[1] = v.y;
  }
  __device__ __forceinline__ void load(const double* p) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    c[0] = v.x; c[1] = v.y;
  }
  __device__ __forceinline__ void load_l2(const double* p) {
    const double2 v = __ldcg(reinterpret_cast<const double2*>(p));
    c[0] = v.x; c[1] = v.y;
  }
  __device__ __forceinline__ void store(double* p) const {
    *reinterpret_cast<double2*>(p) = make_double2(c[0], c[1]);
  }
};

// S accumulator rows (the launch's Sw <= S moment rows; the others carry
// zeros and are not stored), VEC columns per thread, WX x WY warps per block,
// U rows of G in flight per thread. grid = (column blocks, splits of the
// contraction, pairs).
template <int S, int VEC, int WX, int WY, int U>
__global__ void __launch_bounds__(32 * WX * WY, 512 / (32 * WX * WY) > 0 ? 512 / (32 * WX * WY) : 1)
moments_kernel(const double* __restrict__ W, const double* __restrict__ G,
               double* part, double* __restrict__ out, unsigned int* ticket,
               int Sw, int N0, int N1, int rows_per_split, long long g_stride,
               long long o_stride) {
  constexpr int T = 32 * WX * WY;
  // this block's pair
  G += blockIdx.z * g_stride;
  out += blockIdx.z * o_stride;
  part += (size_t)blockIdx.z * gridDim.y * Sw * N1;
  ticket += (size_t)blockIdx.z * gridDim.x;
  constexpr int CV = 32 * WX;                    // column vectors per block
  constexpr int GPC = kChunk / (WY * U);         // row groups per warp and chunk
  constexpr int WPT = (S * kChunk + T - 1) / T;  // W values staged per thread
  static_assert(GPC * WY * U == kChunk, "a chunk is a whole number of row groups");
  static_assert(CV * VEC <= 2 * kChunk, "the block's sums fit the W buffers");
  __shared__ __align__(16) double Ws[2][kChunk * S];  // [row][s], double buffered
  __shared__ bool last;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wx = warp % WX, wy = warp / WX;
  const int cv = wx * 32 + lane;
  const long long y = ((long long)blockIdx.x * CV + cv) * VEC;
  const bool live = y < N1;
  const int x_begin = blockIdx.y * rows_per_split;
  const int x_end = min(N0, x_begin + rows_per_split);
  const int nchunks = (x_end - x_begin + kChunk - 1) / kChunk;

  // rows of group g of chunk c, for this warp: interleaved over the WY warps
  auto load_group = [&](int c, int g, Cols<VEC> (&v)[U]) {
    const int row0 = x_begin + c * kChunk + (g * WY + wy) * U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (live && row0 + u < x_end) v[u].load(G + (size_t)(row0 + u) * N1 + y);
      else v[u].zero();
    }
  };
  auto fetch_w = [&](int c, double (&w)[WPT]) {
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int idx = threadIdx.x + i * T;
      const int s = idx / kChunk, row = x_begin + c * kChunk + idx % kChunk;
      w[i] = (s < Sw && row < x_end) ? __ldg(W + (size_t)s * N0 + row) : 0.0;
    }
  };
  auto store_w = [&](int buf, const double (&w)[WPT]) {
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int idx = threadIdx.x + i * T;
      if (idx < S * kChunk) Ws[buf][(idx % kChunk) * S + idx / kChunk] = w[i];
    }
  };

  Cols<VEC> acc[S], v[U], vnext[U];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s].zero();
  double w[WPT];
  load_group(0, 0, vnext);
  fetch_w(0, w);
  store_w(0, w);
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    const bool more = c + 1 < nchunks;
    if (more) fetch_w(c + 1, w);
    const double* ws = Ws[c & 1];
#pragma unroll
    for (int g = 0; g < GPC; ++g) {
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = vnext[u];
      if (g + 1 < GPC) load_group(c, g + 1, vnext);
      else if (more) load_group(c + 1, 0, vnext);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const double wv = ws[((g * WY + wy) * U + u) * S + s];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[s].c[j] = fma(wv, v[u].c[j], acc[s].c[j]);
        }
    }
    if (more) store_w((c + 1) & 1, w);  // last read in chunk c - 1
    __syncthreads();
  }

  // the block's WY row groups, added in warp-row order
  double* red = &Ws[0][0];  // [s][CV * VEC]
  for (int r = 1; r < WY; ++r) {
    if (wy == r) {
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s].store(red + (s * CV + cv) * VEC);
    }
    __syncthreads();
    if (wy == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        Cols<VEC> t;
        t.load_shared(red + (s * CV + cv) * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[s].c[j] += t.c[j];
      }
    }
    __syncthreads();
  }

  const int nsplit = gridDim.y;
  if (nsplit == 1) {
    if (live && wy == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s < Sw) acc[s].store(out + (size_t)s * N1 + y);
    }
    return;
  }
  if (live && wy == 0) {
    double* p = part + (size_t)blockIdx.y * Sw * N1 + y;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s < Sw) acc[s].store(p + (size_t)s * N1);
  }
  // the last block of this column block to get here adds the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int t = atomicAdd(&ticket[blockIdx.x], 1u);
    last = (t == (unsigned int)(nsplit - 1));
    if (last) ticket[blockIdx.x] = 0u;  // ready for the next launch on this stream
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < Sw * CV; i += T) {
    const int s = i / CV;
    const long long yy = ((long long)blockIdx.x * CV + i % CV) * VEC;
    if (yy >= N1) continue;
    const double* p = part + (size_t)s * N1 + yy;
    Cols<VEC> sum;
    sum.zero();
#pragma unroll 8
    for (int k = 0; k < nsplit; ++k) {  // split order: a fixed order of the f64 sums
      Cols<VEC> t;
      t.load_l2(p + (size_t)k * Sw * N1);
#pragma unroll
      for (int j = 0; j < VEC; ++j) sum.c[j] += t.c[j];
    }
    sum.store(out + (size_t)s * N1 + yy);
  }
}

struct Args {
  const double* W;
  const double* G;
  double* part;
  double* out;
  unsigned int* ticket;
  int S, N0, N1, nsplit, rows, npairs;
  long long g_stride, o_stride;
  cudaStream_t st;
};

template <int S, int VEC, int WX, int WY, int U>
void run(const Args& a) {
  const int cols = 32 * WX * VEC;
  const dim3 grid((a.N1 + cols - 1) / cols, a.nsplit, a.npairs);
  moments_kernel<S, VEC, WX, WY, U><<<grid, 32 * WX * WY, 0, a.st>>>(
      a.W, a.G, a.part, a.out, a.ticket, a.S, a.N0, a.N1, a.rows, a.g_stride, a.o_stride);
}

// any S <= 16: the next of 2, 4, 8, 16 accumulator rows (the surplus rows
// cost FP64 time the kernel has to spare, not bytes). The block is 2 warps
// along the columns by 4 along the rows with 4 rows in flight per thread,
// which takes every S <= 16 within the 128 registers that two blocks per SM
// leave a thread.
template <int VEC>
bool run_any_s(const Args& a) {
  if (a.S <= 2) run<2, VEC, 2, 4, 4>(a);
  else if (a.S <= 4) run<4, VEC, 2, 4, 4>(a);
  else if (a.S <= 8) run<8, VEC, 2, 4, 4>(a);
  else if (a.S <= 16) run<16, VEC, 2, 4, 4>(a);
  else return false;
  return true;
}

}  // namespace

// W (S, N0); npairs images G_b (N0, N1) at G + b * g_stride, rows of
// length N1; results M_b (S, N1) at out + b * o_stride, rows of length N1;
// part (npairs, nsplit, S, N1) scratch: f64 device pointers; ticket: one
// zeroed unsigned int per column block and pair, left zeroed. rows *
// nsplit >= N0. vec = 2 needs an even N1, even strides and 16-byte aligned
// G, part and out. Returns cudaGetLastError().
extern "C" int sfft_moments_f64(const void* W, const void* G, void* part, void* out,
                                void* ticket, int S, int N0, int N1, int nsplit,
                                int rows, int vec, int npairs, long long g_stride,
                                long long o_stride, void* stream) {
  const Args a{static_cast<const double*>(W), static_cast<const double*>(G),
               static_cast<double*>(part), static_cast<double*>(out),
               static_cast<unsigned int*>(ticket), S, N0, N1, nsplit, rows, npairs,
               g_stride, o_stride, static_cast<cudaStream_t>(stream)};
  if (S < 1 || nsplit < 1 || nsplit > 65535 || rows < 1 || npairs < 1 || npairs > 65535 ||
      (vec != 1 && vec != 2) ||
      (vec == 2 && (N1 % 2 != 0 || g_stride % 2 != 0 || o_stride % 2 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!((vec == 2) ? run_any_s<2>(a) : run_any_s<1>(a)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sfft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
