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
// in f32 and widened, stage 1's sums and stage 2's are f64, and T1 and the
// output are rounded to the spectra's type once. The window values are
// small differences of the sums' terms (the images' power sits at low
// frequencies), and f32 sums there made the v2 fft32 mode five times worse
// than the irfft twin on the NIRCam configuration (0.63 against 0.12 RMS
// from f64); with f64 sums it is 0.073, and the 4096^2 fast slice 2.3e-4
// against the twins' 4.6e-4 (PERF.md).
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W). Stage 1,
// T1[c, u, e] = sum_v H[c, u, v] E1[v, e], is a product with K = N1h. With
// the window's conjugate-pair weights (below) the 21 pairs of the 4096^2
// OMG window (33 x 33) need 17 rather than 33 sets of four multiply-adds an
// element of H: 25 GFLOP, 0.37 ms at 67 TFLOP/s, which for f64 sums only
// the FP64 tensor cores reach (DMMA; 34 TFLOP/s of DFMA outside them). The
// 6 pairs of the 17 x 17 THE window are bound by their 470 MB of spectra
// (0.14 ms). The previous design, on DFMA accumulators, took 2.49 ms on OMG: half
// the FFMA rate, 36 f64 accumulators a thread, the warps waiting on the
// shared-memory loads that fed them.
//
// Design of stage 1: the product on mma.sync.m16n8k4 in f64 (DMMA; on this
// card m8n8k4 runs at half the rate of the m16 shapes).
//  * Conjugate-pair lags. The window's weights come in conjugate pairs,
//    E1[v, w + d] = conj(E1[v, w - d]) (w the middle column), so the four
//    real products of h = a * conj(b) with e = E1[v, w + d] give both lags:
//    with P1 = sum hx ex, P2 = sum hy ey, P3 = sum hx ey, P4 = sum hy ex,
//    T1[w + d] = (P1 - P2, P3 + P4) and T1[w - d] = (P1 + P2, P4 - P3). A
//    lag slot is d = 0..w (sym) or a column of E1 (the general route of
//    the public corr_window, any weights: T1[d] = (P1 - P2, P3 + P4)). The
//    two routes share the product and differ only in the store.
//  * Fragments. A (16 x 4): rows g and g + 8 are Re h and Im h at spectrum
//    row u_g, the 4 columns are 4 consecutive v. Lane (g, t) forms its own
//    h at (u_g, v_t) from the staged tiles (c64: the f32 product widened
//    exactly; c128: DFMAs), a0 = Re h, a1 = Im h. B (4 x 8): row t is v_t,
//    columns 2s and 2s + 1 are Re e and Im e of lag slot s of an n-tile (4
//    slots); E1 is packed once per launch, by the wrapper
//    (greek._k1_pack_e1), as f64 in fragment order, so a B fragment is one
//    8-byte load of 32 consecutive doubles. C: lane (g, t) holds D[g][2t],
//    D[g][2t+1], D[g+8][2t], D[g+8][2t+1] = P1, P3, P4, P2 of row u_g and
//    slot t: the two lags form in the thread, with no shuffles.
//  * A warp owns kMT = 2 m-tiles (16 spectrum rows) of one pair and NT
//    n-tiles (a template argument: no DMMA under a branch). Per k-step it
//    loads NT B fragments and 2 x 2 raw elements for 2 x NT DMMAs. The
//    m-tile's fragment row g is tile row 2 (g % 4) + g / 4, so that each
//    half-warp of an 8-byte load reads rows of one parity, whose c64 row
//    phase (below) is one; with a row stride of VT + 2 elements the raw
//    loads are free of bank conflicts in both types. Lag slots past 4 x 6
//    (the general route's wide windows) split into up to 3 n-groups, a warp
//    each, of equal NT (padded slots are computed and not written).
//  * Bytes. A block works on a group of up to 4 pairs that share up to 4
//    planes (2 x 2, 3 x 1; the wrapper's schedule), one warp (per n-group)
//    per pair: each plane tile is copied once for all pairs of the group
//    that use it, and one E1 tile serves them all. Blocks are numbered
//    group-fastest, so the groups of a row tile run together and find each
//    other's planes in L2.
//  * Staging. The raw tiles (16 rows x VT columns per plane) and the packed
//    E1 of their VT columns arrive through an ST-stage ring in dynamic
//    shared memory, filled by the TMA and counted on an mbarrier per stage;
//    one block barrier per tile. A c128 plane's tile is one tensor copy (a
//    3-D map of the stack, its box kUT rows x VT + 2 elements: the staged
//    layout itself, rows past N0 and columns past N1h read as zeros). A
//    tensor map needs 16-byte row strides, which c64 rows lack (2049
//    elements): c64 rows are bulk copies (cp.async.bulk), one per row piece,
//    from the 16-byte boundary at or before its first column, and the lanes
//    that read a row skip its phase (0 or 1 element); rows past N0 stay
//    zero from the start. Columns past N1h meet zero rows of the packed E1.
//    The TMA's rate of small operations, not bytes, set the staging's cost:
//    with a bulk copy per row c128 took 1.33 ms on OMG, with a tensor copy
//    per plane 0.96 ms (chip_smoke.py phase 3 and a sweep of variants); 16-byte
//    cp.async per row piece was slower than the bulk copies, deeper rings
//    and wider tiles slower than more blocks (4 an SM at NT <= 5).
//  * Sums: the DMMAs' f64 accumulators, one per element of D, written to T1
//    once. No atomics and a fixed order: two launches give the same bits.
// Stage 1 leaves T1 (pairs, N0, R1), about R1 / N1h (1.6%) of the product's
// bytes; stage 2 contracts T1 over u with E0 and keeps the real part, with
// 8 independent loads in flight per thread, R0 * R1 * N0 f64 multiply-adds
// per pair, a few percent of stage 1's.

#pragma once
#include <cuda.h>
#include <cuda_runtime.h>

namespace {
// a namespace of its own, so that a tool can include this header beside
// corr_direct.cu (tools/dmma_rates.cu)
namespace k1 {

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

// TMA: the box of a 3-D tensor map at (x, y, z) to shared memory (128-byte
// aligned); completion is counted on the mbarrier
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int x, int y, int z,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

// D (16 x 8) += A (16 x 4) B (4 x 8) in f64: lane (g, t) = (lane / 4, lane % 4)
// holds a0 = A[g][t], a1 = A[g + 8][t], b = B[t][g], c = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

constexpr int kMT = 2;          // m-tiles (8 spectrum rows each) of a warp
constexpr int kUT = 8 * kMT;    // spectrum rows of a block
constexpr int kMaxNT = 6;       // n-tiles (4 lag slots each) of a warp
constexpr int kMaxNG = 3;       // n-groups: warps of a pair
constexpr int kWarps = 4;       // warps of a block
constexpr int kSlots = 4;       // planes of a group
constexpr int kMaxVT = 64;      // E1 is packed to a multiple of this many rows
constexpr int kGroupInts = 18;  // ints per row of the group table

// row stride of a raw tile in elements: c64 rows are whole 16-byte units
// with room for the row's phase; the tile rows of two neighbouring fragment
// rows (two apart) start 4 elements apart mod 16 (c64) or mod 8 (c128), so
// a half-warp's (c64) or a quarter-warp's (c128) raw loads hit distinct
// banks; c128's box (tensor_copy) is this layout
template <int VT>
__host__ __device__ constexpr int row_stride() { return VT + 2; }

// the tile row of fragment row g of m-tile mt: rows of one parity in each
// half-warp
__host__ __device__ constexpr int tile_row(int mt, int g) { return 8 * mt + 2 * (g & 3) + (g >> 2); }

template <typename R, int VT, int ST>
size_t stage1_smem(int NTP) {
  using C = typename CplxOf<R>::T;
  return sizeof(C) * (size_t)ST * kSlots * kUT * row_stride<VT>() +
         sizeof(double) * (size_t)ST * (VT / 4) * NTP * 32 + 8 * ST;
}

// One tile of a warp's product: KS k-steps of 4 columns. raw: the staged
// tiles; offa / offb: this lane's element of its two planes' rows (phase and
// column t included) per m-tile; es: the packed E1 of the tile at this
// warp's first n-tile and this lane, EW doubles a k-step.
template <typename C, int NT, int KS>
__device__ __forceinline__ void warp_tile(double (&acc)[kMT][NT][4], const C* raw,
                                          const int (&offa)[kMT], const int (&offb)[kMT],
                                          const double* es, int EW) {
  // k-steps unrolled: all, or 2 where NT >= 5 (at the 128 registers of
  // min_blocks' 4 blocks a full unroll spills 68-96 bytes; 2 spills 8 or 0)
  constexpr int kU = NT >= 5 ? 2 : KS;
#pragma unroll kU
  for (int ks = 0; ks < KS; ++ks) {
    double bf[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) bf[nt] = es[ks * EW + nt * 32];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const C h = cmul_conj(raw[offa[mt] + 4 * ks], raw[offb[mt] + 4 * ks]);
      const double hx = h.x, hy = h.y;   // the product in R, widened
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) dmma(acc[mt][nt], hx, hy, bf[nt]);
    }
  }
}

// blocks of kWarps warps an SM that the launch bound asks for: 4 (128
// registers a thread), 3 at NT 6 (168; 128 spilled over 100 bytes)
__host__ __device__ constexpr int min_blocks(int NT) { return NT <= 5 ? 4 : 3; }

// One block: a row tile of one group of pairs. groups: (ngroups, kGroupInts)
// ints per group: npairs, nslots, the slots' planes [4] and stacks [4] (0: A,
// 1: B), the pairs' slots sa + 4 * sb [4] and output indices c [4]. E1p:
// (rows / 4, NT * nng, 32) f64, E1 in fragment order (greek._k1_pack_e1).
// Warp y works on pair y / nng of the group and n-group y % nng. mapA /
// mapB: the c128 stacks' tensor maps (stack_map; unused in c64).
template <typename R, int NT, int VT, int ST>
__global__ void __launch_bounds__(32 * kWarps, min_blocks(NT))
corr_stage1(const typename CplxOf<R>::T* __restrict__ A,
            const typename CplxOf<R>::T* __restrict__ B,
            const int* __restrict__ groups, const double* __restrict__ E1p,
            typename CplxOf<R>::T* __restrict__ T1, int N0, int N1h, int R1,
            int ngroups, int nng, int sym, const __grid_constant__ CUtensorMap mapA,
            const __grid_constant__ CUtensorMap mapB) {
  using C = typename CplxOf<R>::T;
  constexpr int LD = row_stride<VT>();
  // c128 rows are 16-byte aligned: a plane's tile is one tensor copy (the
  // maps' box, kUT rows x LD elements, is the staged layout); c64 rows are
  // copied one by one
  constexpr bool kTensor = sizeof(R) == 8;
  constexpr int KS = VT / 4;               // k-steps of a tile
  static_assert(kMaxVT % VT == 0, "tiles divide the pack period");
  static_assert(VT % 4 == 0, "tiles keep a row's phase and whole k-steps");
  extern __shared__ __align__(128) unsigned char smem[];
  const int EW = NT * nng * 32;            // packed E1 doubles of a k-step
  C* Raw = reinterpret_cast<C*>(smem);     // [ST][kSlots][kUT][LD]
  double* Es = reinterpret_cast<double*>(Raw + ST * kSlots * kUT * LD);  // [ST][KS][EW]
  unsigned long long* full = reinterpret_cast<unsigned long long*>(Es + ST * KS * EW);  // [ST]

  const int* grp = groups + (size_t)(blockIdx.x % ngroups) * kGroupInts;  // group-fastest
  const int u0 = (blockIdx.x / ngroups) * kUT;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int nthreads = 32 * blockDim.y;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int pair = threadIdx.y / nng, ng = threadIdx.y % nng;
  const int nslots = grp[1];
  const bool active = pair < grp[0];
  const int ntiles = (N1h + VT - 1) / VT;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) mbar_init(full + i, kTensor ? 1 : nthreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // rows past N0, unused slots and the phase elements are never copied to:
  // zero the tiles once
  for (int i = tid; i < ST * kSlots * kUT * LD; i += nthreads) Raw[i] = czero<C>();
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
  // The copy of row idx (slot idx / kUT, row idx % kUT) of tile `it`: from
  // the 16-byte boundary at or before its first column to the one at or
  // after its last, where the element beyond is this plane's own; start =
  // false only counts the bytes.
  auto row_copy = [&](int idx, int it, bool start) -> unsigned int {
    const int s = idx / kUT, r = idx % kUT, u = u0 + r;
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
      C* dst = Raw + ((buf * kSlots + s) * kUT + r) * LD;
      if (n) bulk_copy(dst, reinterpret_cast<const void*>(lo), n, full + buf);
      // the last element of a plane, where the 16-byte copy would pass its
      // end: by hand (seen by all after the next barrier, before it is read)
      if (tail) dst[row_phase(plane(s), r) + ncols - 1] = src[ncols - 1];
    }
    return n;
  };
  // Tile `it` into its buffer: c64, every thread announces and starts the
  // copies of its rows (thread 0 the packed E1's too: its rows reach a whole
  // tile past N1h, so that is one copy); c128, thread 0 the planes' boxes
  // (rows past N0 and columns past N1h read as zeros) and E1
  auto load_tile = [&](int it) {
    if (it >= ntiles) return;
    const int buf = it % ST;
    const unsigned int ebytes = (unsigned int)(KS * EW * sizeof(double));
    if constexpr (kTensor) {
      if (tid != 0) return;
      mbar_arrive_expect(full + buf, ebytes + nslots * (unsigned int)(kUT * LD * sizeof(C)));
      for (int s = 0; s < nslots; ++s)
        tensor_copy(Raw + (buf * kSlots + s) * kUT * LD, grp[6 + s] ? &mapB : &mapA,
                    2 * it * VT, u0, grp[2 + s], full + buf);
    } else {
      unsigned int bytes = tid == 0 ? ebytes : 0u;
      for (int idx = tid; idx < kSlots * kUT; idx += nthreads) bytes += row_copy(idx, it, false);
      mbar_arrive_expect(full + buf, bytes);
      for (int idx = tid; idx < kSlots * kUT; idx += nthreads) row_copy(idx, it, true);
    }
    if (tid == 0) bulk_copy(Es + buf * KS * EW, E1p + (size_t)it * KS * EW, ebytes, full + buf);
  };

  double acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0;
  // this warp's pair: its two slots; this lane's element of their rows
  const int code = grp[10 + (active ? pair : 0)];
  int offa[kMT], offb[kMT];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int r = tile_row(mt, g);
    offa[mt] = ((code % 4) * kUT + r) * LD + row_phase(plane(code % 4), r) + t;
    offb[mt] = ((code / 4) * kUT + r) * LD + row_phase(plane(code / 4), r) + t;
  }

  for (int it = 0; it < ST - 1; ++it) load_tile(it);
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it % ST;
    mbar_wait(full + buf, (it / ST) & 1);  // tile `it` has landed
    __syncthreads();                       // and tile it - 1 is no longer read
    load_tile(it + ST - 1);                // into the buffer of tile it - 1
    if (!active) continue;                 // a warp without a pair only joins copies and barriers
    warp_tile<C, NT, KS>(acc, Raw + buf * kSlots * kUT * LD, offa, offb,
                         Es + buf * KS * EW + ng * NT * 32 + lane, EW);
  }
  if (!active) return;

  // the sums into T1, rounded to R once: lane (g, t) holds P1, P3, P4, P2 of
  // row u_g and slot s of each n-tile; slot s is column s, or with sym the
  // columns w + s and (s > 0) w - s
  const int nslot = sym ? R1 / 2 + 1 : R1, w = sym ? R1 / 2 : 0;
  C* t1 = T1 + (size_t)grp[14 + pair] * N0 * R1;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int u = u0 + tile_row(mt, g);
    if (u >= N0) continue;
    C* p = t1 + (size_t)u * R1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int s = (ng * NT + nt) * 4 + t;
      if (s >= nslot) continue;
      const double* c = acc[mt][nt];
      C v;
      v.x = static_cast<R>(c[0] - c[3]);
      v.y = static_cast<R>(c[1] + c[2]);
      p[w + s] = v;
      if (sym && s > 0) {
        v.x = static_cast<R>(c[0] + c[3]);
        v.y = static_cast<R>(c[2] - c[1]);
        p[w - s] = v;
      }
    }
  }
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

// The ring per type: VT columns per tile, ST stages.
template <typename R> struct Ring;
template <> struct Ring<float> { static constexpr int VT = 32, ST = 2; };
template <> struct Ring<double> { static constexpr int VT = 16, ST = 2; };

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against the driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the 3-D map of a (F, N0, N1h) complex128 stack as f64 (2 N1h, N0, F), its
// box kUT rows x LD elements of one plane
inline EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
          cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

template <int VT>
cudaError_t stack_map(CUtensorMap* map, const void* base, int F, int N0, int N1h) {
  static const EncodeTiled encode = encode_tiled();   // once, thread-safe
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {2 * (cuuint64_t)N1h, (cuuint64_t)N0, (cuuint64_t)F};
  const cuuint64_t strides[2] = {16 * (cuuint64_t)N1h, 16 * (cuuint64_t)N1h * N0};
  const cuuint32_t box[3] = {2 * (cuuint32_t)row_stride<VT>(), (cuuint32_t)kUT, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename R, int NT>
cudaError_t run_stage1(const typename CplxOf<R>::T* a, const typename CplxOf<R>::T* b,
                       const int* groups, const double* e1p, typename CplxOf<R>::T* t1,
                       int Fa, int Fb, int N0, int N1h, int R1, int ngroups, int nng, int sym,
                       cudaStream_t st) {
  constexpr int VT = Ring<R>::VT, ST = Ring<R>::ST;
  const size_t smem = stage1_smem<R, VT, ST>(NT * nng);
  auto kernel = corr_stage1<R, NT, VT, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((N0 + kUT - 1) / kUT) * ngroups;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  CUtensorMap mapA{}, mapB{};
  if (sizeof(R) == 8) {
    err = stack_map<VT>(&mapA, a, Fa, N0, N1h);
    if (err == cudaSuccess) err = stack_map<VT>(&mapB, b, Fb, N0, N1h);
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned int>(blocks), dim3(32, kWarps), smem, st>>>(
      a, b, groups, e1p, t1, N0, N1h, R1, ngroups, nng, sym, mapA, mapB);
  return cudaGetLastError();
}

// (NT, nng): n-tiles of a warp and n-groups of a pair (the wrapper's plan,
// greek._k1_plan); 4 * NT * nng covers the lag slots (R1, or R1 / 2 + 1
// with sym) and 4 * NT * (nng - 1) does not.
template <typename R>
int launch(const void* A, const void* B, const void* groups, const void* E0, const void* E1p,
           void* T1, void* part, void* out, int npairs, int ngroups, int Fa, int Fb, int N0,
           int N1h, int R0, int R1, int NT, int nng, int sym, void* stream) {
  using C = typename CplxOf<R>::T;
  const int slots = sym ? R1 / 2 + 1 : R1;
  if (R1 < 1 || R0 < 1 || Fa < 1 || Fb < 1 || N0 < 1 || N1h < 1 || npairs < 1 || npairs > 65535 || ngroups < 1 ||
      ngroups > npairs || NT < 1 || NT > kMaxNT || nng < 1 || nng > kMaxNG ||
      4 * NT * nng < slots || 4 * NT * (nng - 1) >= slots || R1 > kLanes ||
      (sym && R1 % 2 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const C* a = static_cast<const C*>(A);
  const C* b = static_cast<const C*>(B);
  const int* gr = static_cast<const int*>(groups);
  const double* e1p = static_cast<const double*>(E1p);
  C* t1 = static_cast<C*>(T1);
  cudaError_t err = cudaErrorInvalidValue;
  switch (NT) {
#define SFFT_K1_CASE(nt_)                                                                    \
  case nt_:                                                                                  \
    err = run_stage1<R, nt_>(a, b, gr, e1p, t1, Fa, Fb, N0, N1h, R1, ngroups, nng, sym, st); \
    break;
    SFFT_K1_CASE(1) SFFT_K1_CASE(2) SFFT_K1_CASE(3) SFFT_K1_CASE(4) SFFT_K1_CASE(5)
    SFFT_K1_CASE(6)
#undef SFFT_K1_CASE
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

}  // namespace k1
}  // namespace
