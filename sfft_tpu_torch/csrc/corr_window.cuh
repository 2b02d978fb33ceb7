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
// Sums are f64 in both instantiations: the c64 spectra's products are formed
// in f32 and widened, stage 1's register sums and stage 2's are f64, and
// T1 and the output are rounded to the spectra's type once. The window
// values are small differences of the sums' terms (the images' power sits
// at low frequencies), and f32 sums there made the v2 fft32 mode five times
// worse than the irfft twin on the NIRCam configuration (0.63 against 0.12
// RMS from f64); with f64 sums it is 0.073, and the 4096^2 fast slice
// 2.3e-4 against the twins' 4.6e-4 (PERF.md).
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W; measured with
// chip_smoke.py --kernels on the 4096^2 windows of the peeled path). Stage
// 1, T1[c, u, e] = sum_v H[c, u, v] E1[v, e], is R1 complex multiply-adds per
// element of the Hadamard product for general weights. With the window's
// conjugate-pair weights (below) it is 17 rather than 33 sets of four
// multiply-adds for the 21 pairs of the 33 x 33 OMG window: 25 GFLOP, 0.37
// ms of FP32 at the card's 67 TFLOP/s (0.74 ms at FP64's 34), the yardstick
// of the launches the port makes. The 6 pairs of the 17 x 17 THE window are
// bound by their 470 MB of spectra (0.14 ms). The kernel takes 2.49 ms
// (OMG) and 0.62 ms (THE): the DFMAs of the f64 sums run at half the FFMA
// rate, 36 f64 accumulators hold a thread at 168 registers (three blocks
// per SM), and the warps wait on the shared-memory loads that feed them
// (per column a warp runs 36 multiply-adds against 12 shared-memory
// wavefronts, two for each 16-byte weight load).
//
// Design of stage 1:
//  * Half the multiply-adds. The window's weights come in conjugate pairs,
//    E1[v, w + d] = conj(E1[v, w - d]) (w the middle column), so the four
//    real products of h = a * conj(b) with e = E1[v, w + d] give both lags:
//    with P1 = sum hx ex, P2 = sum hy ey, P3 = sum hx ey, P4 = sum hy ex,
//    T1[w + d] = (P1 - P2, P3 + P4) and T1[w - d] = (P1 + P2, P4 - P3).
//    Four multiply-adds into four accumulators serve two lags. A caller with other
//    weights (sym = 0) gets the plain complex multiply-add.
//  * A quarter to a half of the bytes. A block works on a group of up to 4
//    pairs that share up to 4 planes (2 x 2, 3 x 1; the wrapper's schedule),
//    one warp set per pair: each plane tile is copied once for all pairs of
//    the group that use it, and one E1 tile serves them all. Blocks are
//    numbered group-fastest, so the groups of a row tile run together and
//    find each other's planes in L2.
//  * The raw tiles (UT rows x VT columns per plane) and the VT matching rows
//    of E1 arrive through an ST-stage ring in dynamic shared memory, filled
//    by the TMA's bulk copies (cp.async.bulk, one per row piece, counted on
//    an mbarrier per stage), which cost the threads one instruction per row
//    and no registers; one block barrier per tile. A bulk copy needs 16-byte
//    alignment on both sides, and c64 rows are only 8-byte aligned (2049
//    elements): a row piece is copied from the 16-byte boundary at or before
//    its first column, and the thread that reads it skips the row's phase
//    (0 or 1 element). E1 is repacked once per launch into rows of padded lag
//    groups (the layout the threads read, zero rows up to a whole tile) and
//    arrives as one copy per tile. Rows past N0 stay zero from the start.
//    Two stages of 32 columns (16 in c128) were the fastest ring: deeper and
//    narrower ones cost more in blocks per SM than they hid.
//  * A thread owns RU rows u and NE lag slots (a slot is a lag, or a pair
//    of lags with sym); a warp is 16 row lanes x 2 lag groups, so a raw load
//    is one wavefront and a weight load two 16-byte broadcasts; TY lag
//    groups (TY / 2 warps per pair) cover the slots. With sym RU = 1 (36
//    f64 accumulators at NE = 9): more warps per SM hid more latency than a
//    second row's reuse of the weights saved (with f32 sums). Without, RU =
//    2.
//  * Sums: one running f64 sum per accumulator, written to T1 once. No
//    atomics and a fixed order: two launches give the same bits.
// Stage 1 leaves T1 (pairs, N0, R1), about R1 / N1h (1.6%) of the product's
// bytes; stage 2 contracts T1 over u with E0 and keeps the real part, with
// 8 independent loads in flight per thread, R0 * R1 * N0 f64 multiply-adds
// per pair, a few percent of stage 1's.

#pragma once
#include <cuda_runtime.h>

namespace {

template <typename R> struct CplxOf;
template <> struct CplxOf<float> { using T = float2; };
template <> struct CplxOf<double> { using T = double2; };

template <typename C>
__device__ __forceinline__ C czero() { C z; z.x = 0; z.y = 0; return z; }

// x * conj(y)
template <typename C>
__device__ __forceinline__ C cmul_conj(C x, C y) {
  C h;
  h.x = fma(x.x, y.x, x.y * y.y);
  h.y = fma(x.y, y.x, -x.x * y.y);
  return h;
}

__device__ __forceinline__ unsigned int smem_u32(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// one arrival that also announces `bytes` of bulk copies to wait for
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar, unsigned int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of the given parity is complete
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// TMA: `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned; completion is counted on the mbarrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// NE lag weights of one column: 16-byte shared loads (two c64 or one c128)
template <int NE>
__device__ __forceinline__ void load_lags(const float2* p, float2 (&e)[NE]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < NE / 2; ++j) {
    const float4 w = q[j];
    e[2 * j] = make_float2(w.x, w.y);
    e[2 * j + 1] = make_float2(w.z, w.w);
  }
  if (NE % 2) e[NE - 1] = p[NE - 1];
}
template <int NE>
__device__ __forceinline__ void load_lags(const double2* p, double2 (&e)[NE]) {
#pragma unroll
  for (int j = 0; j < NE; ++j) e[j] = p[j];
}

constexpr int kRL = 16;          // row lanes of a warp (the other factor 2: lag groups)
constexpr int kMaxTY = 8;        // lag groups per pair: at most 4 warps
constexpr int kMaxWarps = 4;     // warps per block
constexpr int kSlots = 4;        // planes per group
constexpr int kMaxVT = 64;       // E1 is packed to a multiple of this many rows
constexpr int kGroupInts = 18;   // ints per row of the group table

// rows per thread: one with sym, two without
template <typename R, bool SYM>
__host__ __device__ constexpr int rows_per_thread() { return SYM ? 1 : 2; }

// lag slots per group in shared memory: c64 groups start 16-byte aligned
template <typename R, int NE>
__host__ __device__ constexpr int lag_slots() { return sizeof(R) == 4 ? (NE + 1) / 2 * 2 : NE; }

// slots of one packed E1 row: an even number of groups (two per warp)
template <typename R, int NE>
__host__ __device__ constexpr int row_slots(int TY) { return (TY + TY % 2) * lag_slots<R, NE>(); }

// row stride of a raw tile in elements: c64 rows are whole 16-byte units with
// room for the row's phase; c128 rows an odd number of units (conflict-free)
template <typename R, int VT>
__host__ __device__ constexpr int row_stride() { return sizeof(R) == 4 ? VT + 2 : VT + 1; }

template <typename R, int NE, int VT, int ST, bool SYM>
size_t stage1_smem(int TY) {
  using C = typename CplxOf<R>::T;
  return sizeof(C) * (size_t)ST * (kSlots * kRL * rows_per_thread<R, SYM>() * row_stride<R, VT>()
                                   + VT * row_slots<R, NE>(TY)) + 8 * ST;
}

// E1 (N1h, R1) -> E1p (rows, row_slots), rows >= N1h a whole number of tiles:
// slot j of group g holds column g * NE + j of E1, or with sym column w + g *
// NE + j (w = R1 / 2, the middle one); masked slots and the rows past N1h are
// zero.
template <typename R, int NE>
__global__ void corr_pack_e1(const typename CplxOf<R>::T* __restrict__ E1,
                             typename CplxOf<R>::T* __restrict__ E1p, int N1h, int R1,
                             int EW, int rows, int sym) {
  using C = typename CplxOf<R>::T;
  constexpr int NEP = lag_slots<R, NE>();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * EW) return;
  const int v = i / EW, slot = i % EW;
  const int j = slot % NEP, e = (slot / NEP) * NE + j + (sym ? R1 / 2 : 0);
  E1p[i] = (v < N1h && j < NE && e < R1) ? E1[(size_t)v * R1 + e] : czero<C>();
}

// One block: a row tile of one group of pairs. groups: (ngroups, kGroupInts)
// ints per group: npairs, nslots, the slots' planes [4] and stacks [4] (0: A,
// 1: B), the pairs' slots sa + 4 * sb [4] and output indices c [4].
template <typename R, int NE, int VT, int ST, bool SYM>
__global__ void __launch_bounds__(32 * kMaxWarps, 3)
corr_stage1(const typename CplxOf<R>::T* __restrict__ A,
            const typename CplxOf<R>::T* __restrict__ B,
            const int* __restrict__ groups,
            const typename CplxOf<R>::T* __restrict__ E1p,
            typename CplxOf<R>::T* __restrict__ T1, int N0, int N1h, int R1,
            int ngroups, int TY) {
  using C = typename CplxOf<R>::T;
  constexpr int RU = rows_per_thread<R, SYM>();
  constexpr int UT = kRL * RU;             // spectrum rows per block
  constexpr int NEP = lag_slots<R, NE>();
  constexpr int LD = row_stride<R, VT>();
  constexpr int NACC = SYM ? 4 : 2;        // f64 accumulators per row and lag slot
  static_assert(kMaxVT % VT == 0, "tiles divide the pack period");
  static_assert(VT % 2 == 0, "tiles keep a row's phase");
  extern __shared__ __align__(16) unsigned char smem[];
  const int EW = row_slots<R, NE>(TY);     // lag slots per E1 row
  C* Raw = reinterpret_cast<C*>(smem);     // [ST][kSlots][UT][LD]
  C* Es = Raw + ST * kSlots * UT * LD;     // [ST][VT][EW]
  unsigned long long* full = reinterpret_cast<unsigned long long*>(Es + ST * VT * EW);  // [ST]

  const int* grp = groups + (size_t)(blockIdx.x % ngroups) * kGroupInts;  // group-fastest
  const int u0 = (blockIdx.x / ngroups) * UT;
  const int t = threadIdx.y * 32 + threadIdx.x;
  const int nthreads = 32 * blockDim.y;
  const int wpp = (TY + 1) / 2;                       // warps per pair
  const int pair = threadIdx.y / wpp;                 // this warp's pair of the group
  const int rl = threadIdx.x % kRL;                   // row lane
  const int g = 2 * (threadIdx.y % wpp) + threadIdx.x / kRL;  // lag group
  const int nslots = grp[1];
  const bool active = pair < grp[0] && g < TY;
  const int ntiles = (N1h + VT - 1) / VT;

  if (t == 0) {
    for (int i = 0; i < ST; ++i) mbar_init(full + i, nthreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // rows past N0, unused slots and the phase elements are never copied to:
  // zero the tiles once
  for (int i = t; i < ST * kSlots * UT * LD; i += nthreads) Raw[i] = czero<C>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  auto plane = [&](int s) -> const C* {
    return (grp[6 + s] ? B : A) + (size_t)grp[2 + s] * N0 * N1h;
  };
  // first column of row r of a plane within its shared-memory row: 1 where
  // the row's first column of a tile is not 16-byte aligned in device memory
  // (VT is even, so it holds for every tile)
  auto row_phase = [&](const C* p, int r) -> int {
    if (sizeof(R) != 4) return 0;
    const int u = min(u0 + r, N0 - 1);
    return (int)((reinterpret_cast<size_t>(p + (size_t)u * N1h) >> 3) & 1);
  };
  // The copy of row idx (slot idx / UT, row idx % UT) of tile `it`: from the
  // 16-byte boundary at or before its first column to the one at or after
  // its last, where the element beyond is this plane's own; start = false
  // only counts the bytes.
  auto row_copy = [&](int idx, int it, bool start) -> unsigned int {
    const int s = idx / UT, r = idx % UT, u = u0 + r;
    if (s >= nslots || u >= N0) return 0;
    const int buf = it % ST, v0 = it * VT;
    const int ncols = min(VT, N1h - v0);
    const C* src = plane(s) + (size_t)u * N1h + v0;
    const size_t lo = reinterpret_cast<size_t>(src) & ~(size_t)15;
    size_t hi = reinterpret_cast<size_t>(src + ncols);
    const bool tail = (hi & 15) && !(v0 + ncols < N1h || u + 1 < N0);
    if ((hi & 15) && !tail) hi += 8;
    const unsigned int n = (unsigned int)((hi & ~(size_t)15) - lo);
    if (start) {
      C* dst = Raw + ((buf * kSlots + s) * UT + r) * LD;
      if (n) bulk_copy(dst, reinterpret_cast<const void*>(lo), n, full + buf);
      // the last element of a plane, where the 16-byte copy would pass its
      // end: by hand (seen by all after the next barrier, before it is read)
      if (tail) dst[row_phase(plane(s), r) + ncols - 1] = src[ncols - 1];
    }
    return n;
  };
  // Tile `it` into its buffer: every thread announces and starts the copies
  // of its rows (thread 0 the weights' too: the packed rows reach a whole
  // tile past N1h, so that is one copy)
  auto load_tile = [&](int it) {
    if (it >= ntiles) return;
    const int buf = it % ST;
    unsigned int bytes = t == 0 ? (unsigned int)(VT * EW * sizeof(C)) : 0u;
    for (int idx = t; idx < kSlots * UT; idx += nthreads) bytes += row_copy(idx, it, false);
    mbar_arrive_expect(full + buf, bytes);
    for (int idx = t; idx < kSlots * UT; idx += nthreads) row_copy(idx, it, true);
    if (t == 0)
      bulk_copy(Es + buf * VT * EW, E1p + (size_t)it * VT * EW,
                (unsigned int)(VT * EW * sizeof(C)), full + buf);
  };

  double acc[RU][NE][NACC];
#pragma unroll
  for (int i = 0; i < RU; ++i)
#pragma unroll
    for (int j = 0; j < NE; ++j)
#pragma unroll
      for (int q = 0; q < NACC; ++q) acc[i][j][q] = 0;
  // this warp's pair: its two slots, and its rows of T1
  const int code = grp[10 + (active ? pair : 0)];
  int offa[RU], offb[RU];   // this thread's rows of the pair's two planes in a tile buffer
#pragma unroll
  for (int i = 0; i < RU; ++i) {
    const int r = rl + kRL * i;
    offa[i] = ((code % 4) * UT + r) * LD + row_phase(plane(code % 4), r);
    offb[i] = ((code / 4) * UT + r) * LD + row_phase(plane(code / 4), r);
  }
  C* t1 = T1 + ((size_t)grp[14 + (active ? pair : 0)] * N0 + u0 + rl) * R1;  // row i: + kRL * i * R1
  const int w = R1 / 2;

  // the register sums into T1, rounded to R once. Lag slot j of group g is
  // column d = g * NE + j, or with sym the columns w + d and (d > 0) w - d.
  auto store = [&]() {
    if (!active) return;
#pragma unroll
    for (int i = 0; i < RU; ++i) {
      if (u0 + rl + kRL * i >= N0) continue;
      C* p = t1 + (size_t)kRL * i * R1;
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        const int d = g * NE + j;
        C v;
        if constexpr (SYM) {
          v.x = static_cast<R>(acc[i][j][0] - acc[i][j][1]);
          v.y = static_cast<R>(acc[i][j][2] + acc[i][j][3]);
          if (d <= w) p[w + d] = v;
          v.x = static_cast<R>(acc[i][j][0] + acc[i][j][1]);
          v.y = static_cast<R>(acc[i][j][3] - acc[i][j][2]);
          if (d <= w && d > 0) p[w - d] = v;
        } else {
          v.x = static_cast<R>(acc[i][j][0]);
          v.y = static_cast<R>(acc[i][j][1]);
          if (d < R1) p[d] = v;
        }
      }
    }
  };

  for (int it = 0; it < ST - 1; ++it) load_tile(it);
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it % ST;
    mbar_wait(full + buf, (it / ST) & 1);  // tile `it` has landed
    __syncthreads();                       // and tile it - 1 is no longer read
    load_tile(it + ST - 1);                // into the buffer of tile it - 1
    const C* raw = Raw + buf * kSlots * UT * LD;
    const C* es = Es + buf * VT * EW + (active ? g : 0) * NEP;
    if (!active) continue;   // a warp without a pair only helps with the copies
#pragma unroll 8
    for (int k = 0; k < VT; ++k) {
      double hx[RU], hy[RU];   // the product in R, widened
#pragma unroll
      for (int i = 0; i < RU; ++i) {
        const C h = cmul_conj(raw[offa[i] + k], raw[offb[i] + k]);
        hx[i] = h.x;
        hy[i] = h.y;
      }
      C e[NE];
      load_lags<NE>(es + k * EW, e);
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        const double ex = e[j].x, ey = e[j].y;
#pragma unroll
        for (int i = 0; i < RU; ++i) {
          if constexpr (SYM) {
            acc[i][j][0] = fma(hx[i], ex, acc[i][j][0]);
            acc[i][j][1] = fma(hy[i], ey, acc[i][j][1]);
            acc[i][j][2] = fma(hx[i], ey, acc[i][j][2]);
            acc[i][j][3] = fma(hy[i], ex, acc[i][j][3]);
          } else {
            acc[i][j][0] = fma(hx[i], ex, fma(-hy[i], ey, acc[i][j][0]));
            acc[i][j][1] = fma(hx[i], ey, fma(hy[i], ex, acc[i][j][1]));
          }
        }
      }
    }
  }
  store();
}

// Stage 2 is small (R0 * R1 outputs per pair, N0 terms each) and all latency:
// the u axis is cut into kUSplit ranges, one block each, a thread per
// output with 8 independent loads in flight; a second pass adds the ranges'
// partial sums in order (deterministic).
constexpr int kLanes = 64;    // R1 <= 64
constexpr int kUSplit = 32;   // ranges of u
constexpr int kInFlight = 8;  // u steps loaded before the first is used
constexpr int kRG = 4;        // output rows r per thread

// part[c, s, r, e] = Re sum_{u in range s} E0[r, u] * T1[c, u, e], summed in
// f64; a thread owns kRG rows r of one e, so a T1 value serves kRG products
// and the E0 values are warp-wide broadcasts
template <typename R>
__global__ void __launch_bounds__(256)
corr_stage2(const typename CplxOf<R>::T* __restrict__ T1,
            const typename CplxOf<R>::T* __restrict__ E0,
            double* __restrict__ part, int N0, int R0, int R1) {
  using C = typename CplxOf<R>::T;
  const int o = blockIdx.z * blockDim.x + threadIdx.x;
  const int nrg = (R0 + kRG - 1) / kRG;
  if (o >= nrg * R1) return;
  const int r0 = (o / R1) * kRG, e = o % R1;
  const int c = blockIdx.y, s = blockIdx.x;
  const int chunk = (N0 + kUSplit - 1) / kUSplit;
  const int ub = s * chunk, ue = min(N0, ub + chunk);
  const C* tc = T1 + (size_t)c * N0 * R1 + e;
  const C* w0[kRG];   // rows past R0 read row R0 - 1 and are not stored
#pragma unroll
  for (int j = 0; j < kRG; ++j) w0[j] = E0 + (size_t)min(r0 + j, R0 - 1) * N0;
  double acc[kRG];
#pragma unroll
  for (int j = 0; j < kRG; ++j) acc[j] = 0;
  int u = ub;
  for (; u + kInFlight <= ue; u += kInFlight) {
    C tv[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) tv[k] = tc[(size_t)(u + k) * R1];
#pragma unroll
    for (int j = 0; j < kRG; ++j)
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const C w = w0[j][u + k];
        acc[j] = fma((double)w.x, (double)tv[k].x, fma(-(double)w.y, (double)tv[k].y, acc[j]));
      }
  }
  for (; u < ue; ++u) {
    const C tv = tc[(size_t)u * R1];
#pragma unroll
    for (int j = 0; j < kRG; ++j) {
      const C w = w0[j][u];
      acc[j] = fma((double)w.x, (double)tv.x, fma(-(double)w.y, (double)tv.y, acc[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < kRG; ++j)
    if (r0 + j < R0) part[(((size_t)c * kUSplit + s) * R0 + r0 + j) * R1 + e] = acc[j];
}

// out[c, r, e] = sum_s part[c, s, r, e], in range order, in f64
template <typename R>
__global__ void corr_stage2_sum(const double* __restrict__ part, R* __restrict__ out, int n_out,
                                int per_pair) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const double* p = part + (size_t)(i / per_pair) * kUSplit * per_pair + i % per_pair;
  double acc = 0;
#pragma unroll 8
  for (int s = 0; s < kUSplit; ++s) acc += p[(size_t)s * per_pair];
  out[i] = static_cast<R>(acc);
}

template <typename R, int NE, int VT, int ST, bool SYM>
cudaError_t run_stage1(const typename CplxOf<R>::T* a, const typename CplxOf<R>::T* b,
                       const int* groups, const typename CplxOf<R>::T* e1,
                       typename CplxOf<R>::T* e1p, typename CplxOf<R>::T* t1, int N0, int N1h,
                       int R1, int ngroups, int TY, cudaStream_t st) {
  const int EW = row_slots<R, NE>(TY);
  const int rows = (N1h + kMaxVT - 1) / kMaxVT * kMaxVT;
  corr_pack_e1<R, NE><<<(rows * EW + 255) / 256, 256, 0, st>>>(e1, e1p, N1h, R1, EW, rows,
                                                               SYM ? 1 : 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = stage1_smem<R, NE, VT, ST, SYM>(TY);
  auto kernel = corr_stage1<R, NE, VT, ST, SYM>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int UT = kRL * rows_per_thread<R, SYM>();
  const long long blocks = (long long)((N0 + UT - 1) / UT) * ngroups;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const int wpp = (TY + 1) / 2;
  kernel<<<static_cast<unsigned int>(blocks), dim3(32, wpp * (kMaxWarps / wpp)), smem, st>>>(
      a, b, groups, e1p, t1, N0, N1h, R1, ngroups, TY);
  return cudaGetLastError();
}

// The ring per type: VT columns per tile, ST stages.
template <typename R> struct Ring;
template <> struct Ring<float> { static constexpr int VT = 32, ST = 2; };
template <> struct Ring<double> { static constexpr int VT = 16, ST = 2; };

// (TY, NE): lag groups per pair and lag slots per thread, TY * NE >= the
// slots (R1, or R1 / 2 + 1 with sym; the wrapper's plan).
template <typename R>
int launch(const void* A, const void* B, const void* groups, const void* E0, const void* E1,
           void* E1p, void* T1, void* part, void* out, int npairs, int ngroups, int N0, int N1h,
           int R0, int R1, int TY, int NE, int sym, void* stream) {
  using C = typename CplxOf<R>::T;
  const int slots = sym ? R1 / 2 + 1 : R1;
  if (R1 < 1 || R0 < 1 || npairs < 1 || npairs > 65535 || ngroups < 1 || ngroups > npairs ||
      TY < 1 || TY > kMaxTY || NE < 1 || TY * NE < slots || (TY - 1) * NE >= slots ||
      R1 > kLanes || (sym && R1 % 2 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const C* a = static_cast<const C*>(A);
  const C* b = static_cast<const C*>(B);
  const int* gr = static_cast<const int*>(groups);
  const C* e1 = static_cast<const C*>(E1);
  C* e1p = static_cast<C*>(E1p);
  C* t1 = static_cast<C*>(T1);
  cudaError_t err = cudaErrorInvalidValue;
  switch (NE * 2 + (sym ? 1 : 0)) {
#define SFFT_CORR_CASE(ne_)                                                              \
  case ne_ * 2:                                                                          \
    err = run_stage1<R, ne_, Ring<R>::VT, Ring<R>::ST, false>(a, b, gr, e1, e1p, t1, N0, \
                                                              N1h, R1, ngroups, TY, st); \
    break;                                                                               \
  case ne_ * 2 + 1:                                                                      \
    err = run_stage1<R, ne_, Ring<R>::VT, Ring<R>::ST, true>(a, b, gr, e1, e1p, t1, N0,  \
                                                             N1h, R1, ngroups, TY, st);  \
    break;
    SFFT_CORR_CASE(5) SFFT_CORR_CASE(9)
#undef SFFT_CORR_CASE
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2(kUSplit, npairs, ((R0 + kRG - 1) / kRG * R1 + 255) / 256);
  corr_stage2<R><<<grid2, 256, 0, st>>>(t1, static_cast<const C*>(E0),
                                        static_cast<double*>(part), N0, R0, R1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_out = npairs * R0 * R1;
  corr_stage2_sum<R><<<(n_out + 255) / 256, 256, 0, st>>>(
      static_cast<const double*>(part), static_cast<R*>(out), n_out, R0 * R1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
