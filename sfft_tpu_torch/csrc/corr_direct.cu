// K8 — the FFT-free windowed circular cross-correlation, on Hopper's FP64
// tensor cores.
//
// Replaces: the XLA convolution of sfft_tpu/core/greek.py corr_window_conv
// (:152-176), the greek 'corr' backend's tables (Comg, Cgam, Cthe and, under
// SEPARATE-VARYING scaling, Pbs):
//
//   C[a, b, i, e] = sum_xy A[a, x, y] * B[b, (x + rho_lo + i) % N0, (y + e - wy) % N1]
//
// for every plane pair (a, b), nrho lag rows rho = rho_lo + i and the 2 wy + 1
// lags eps = e - wy along axis 1, in float64. sfft_tpu lowers it to a VALID
// lax.conv of the wrap-padded B stack against the full-image A planes. The
// same formulation is one PyTorch call on the card (F.conv2d with the planes
// as its weight: cuDNN's f64 route); chip_smoke.py phase 13a times it beside
// this kernel. The wrapper (core/greek.py) asks for half the lag rows of a
// symmetric table (B is A: C[a, b, -d] = C[b, a, d]) and mirrors the rest.
//
// What bounds it: FP64 operations, one multiply-add per pixel and distinct
// pair-lag. At 4096^2 the Comg table (6 x 6 pairs, 33 x 33 lags) has 15 x
// 1089 + 6 x 545 = 19,605 of them, 3.29e11 multiply-adds: 9.8 ms at the
// card's FP64 peak of 67 TFLOP/s, which only the tensor cores reach (DMMA;
// 34 TFLOP/s outside them). The planes are a few hundred MB (under 0.3 ms).
//
// Design. The table is a matrix product per B row r: for the lag rows rho
// whose A row is r - rho,
//
//   D[(a, rho), (b, e)] += sum_y A[a, r - rho, y] * B[b, r, y + e - wy],
//
// run on mma.sync.m16n8k4 in f64 (DMMA: on this card m8n8k4 reaches half the
// rate of the m16 shapes). M = 16 rows are two lag rows x 8 A planes (an
// m-tile; planes past Fa read zeros), N = 8 columns are 8 consecutive (b, e)
// of the flattened B side (b * R1 + e, so 6 planes x 33 lags pad 198 to
// 200), K = 4 image columns y. The N operand is a Hankel slice of one staged
// B row (element (k, n) = row[y + k + e_n], read by index: no Hankel matrix
// is written out). A warp owns kP = 6 lag rows (three lag pairs) and NT = 5
// or 4 n-tiles (two instantiations; the plan picks), up to 15 accumulator
// tiles in registers, and walks the staged B rows: per row it loads the 6 A
// and NT B fragments straight into the DMMAs' operand registers, for up to
// 15 DMMAs. (A ring of A fragments kept across the rows loads one A
// fragment a row instead of 6, but the lag pairs that form each DMMA's
// operand shift by one row at each row, and the register moves that
// assemble them cost as much as the loads saved.) Units of work are (lag
// group, n-group) pairs, lag group fastest, the n-groups splitting the
// tiles evenly; a block of W compute warps takes W consecutive units (W =
// the lag groups, so that its warps share one n-group's B planes and every
// A row it stages), and one more warp, the producer, stages its tiles. A
// block owns one m-tile, one band of RT staged B rows and a range of column
// tiles (CS splits a small table's columns over more blocks) and walks its
// columns in tiles of kTY = 16: the producer copies the A rows of the
// units' lags (zero outside the image) and the B rows of their planes (RT
// x (16 + R1 - 1) columns, indices wrapped) into one of two shared-memory
// buffers with cp.async while the compute warps take the other, and the
// two sides hand the buffers over with named barriers (the compute warps
// issue no copy: the inner loop alone runs near the DMMA peak, and copies
// issued between its rows held it well below). With 3 lag groups (17 lag
// rows) the block's 4 warps sit one on each SM sub-partition.
// The block writes one partial per (band, column split, a, b, lag); a
// second launch adds the partials in a fixed order. No atomics: two
// launches on the same input give the same bits. A lag pair or n-tile past
// the table is skipped by its warp (the unit's tile count is a template
// argument of its walk, the lag pairs a uniform branch); the lag row that
// pads an odd count and the padded planes and columns are computed and not
// written.
//
// What bounds it now: the DMMAs of the padded work (Comg at 4096^2: 8
// planes x 18 lag rows x 200 columns a pixel, 1.47 times the bound's
// pair-lags) at the rate the compute warps sustain with their
// shared-memory loads (11 fragment loads a row for 15 DMMAs) and the
// hand-over of the staged tiles; the -Xptxas -v report gives the
// registers (chip_smoke.py prints them and the SASS's DMMA count).
// Later work (not here): the m-tile's padding (6 of 8 planes at 4096^2,
// 25 of 32 at v2) and the small tables' staging, which feeds fewer DMMAs a
// copied byte (Cgam, Cthe); TMA for the staged tiles.

#include <cuda_runtime.h>

namespace {

constexpr int kP = 6;        // lag rows of a warp (three DMMA lag pairs)
constexpr int kTY = 16;      // image columns of a staged tile (four k-steps)
constexpr int kMT = 8;       // A planes of an m-tile
constexpr int kWMax = 4;     // compute warps of a block (and one producer warp)
constexpr int kSmemMax = 232448;
constexpr long long kNaN = 0x7ff8000000000000LL;  // a quiet NaN's bits

__device__ __forceinline__ int wrap_index(int v, int n) {
  if (v >= 0 && v < n) return v;
  v %= n;
  return v < 0 ? v + n : v;
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

// 8 bytes global -> shared without a register round trip; zero-filled when
// !ok (src then is any valid address and is not read)
__device__ __forceinline__ void cp_async8(double* dst, const double* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 8 : 0));
}

// waits until this thread's cp.async copies are done
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// named barriers between the producer warp and the compute warps: buffer b
// is full (kFull + b) or released (kEmpty + b); bar.sync waits for the
// barrier's n threads, bar.arrive counts this warp and goes on (its prior
// writes, the copies it waited for, are visible to the threads that sync)
constexpr int kFull = 1, kEmpty = 3;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the launch plan (core/greek.py _k8_layout computes it; make_plan takes its
// block-walk numbers)
struct Plan {
  int Fa, Fb, N0, N1, rho_lo, nrho, R1, wy;
  int NT, RT, W, CS;         // n-tiles a warp at most, staged B rows (a band), compute warps
                             // a block, column splits
  int nmt, nA, nrg, NN, ntiles, nng, nunits, bpb, nchunks;
  int span, RA, SA, BW, SB, nbp, nbands, buf;
  long long smem;
};

// the first n-tile of n-group ng: the groups split the tiles evenly
__device__ inline int group_tile(int ng, int ntiles, int nng) {
  return static_cast<int>(static_cast<long long>(ng) * ntiles / nng);
}

// unit u is lag group rg x n-group ng, lag group fastest
__device__ inline void unit_of(const Plan& p, int u, int& rg, int& ng) {
  ng = u / p.nrg;
  rg = u - ng * p.nrg;
}

// the lag groups and n-groups that block blk's units span
struct Span {
  int rg_lo, rg_hi, ng_lo, ng_hi;
};

__device__ inline Span block_span(const Plan& p, int blk) {
  Span r{p.nrg, -1, p.nng, -1};
  const int u_hi = (blk * p.W + p.W < p.nunits ? blk * p.W + p.W : p.nunits);
  for (int u = blk * p.W; u < u_hi; ++u) {
    int rg, ng;
    unit_of(p, u, rg, ng);
    r.rg_lo = rg < r.rg_lo ? rg : r.rg_lo;
    r.rg_hi = rg > r.rg_hi ? rg : r.rg_hi;
    r.ng_lo = ng < r.ng_lo ? ng : r.ng_lo;
    r.ng_hi = ng > r.ng_hi ? ng : r.ng_hi;
  }
  return r;
}

// the first and last (plane, lag) column of a block's n-groups
__device__ inline void block_columns(const Plan& p, const Span& r, int& n_lo, int& n_hi) {
  n_lo = group_tile(r.ng_lo, p.ntiles, p.nng) * 8;
  const int n_end = group_tile(r.ng_hi + 1, p.ntiles, p.nng) * 8;
  n_hi = (n_end < p.NN ? n_end : p.NN) - 1;
}

// the plan's layout from the wrapper's numbers: span (the most lag rows a
// block stages), nbp (the most B planes) and nbands are core/greek.py
// _k8_layout's, which walks the blocks; this side derives the buffers'
// layout from them, and each block checks that it fits (corr_mma)
Plan make_plan(int Fa, int Fb, int N0, int N1, int rho_lo, int nrho, int wy, int NT, int RT,
               int W, int CS, int span, int nbp, int nbands) {
  Plan p{};
  p.Fa = Fa; p.Fb = Fb; p.N0 = N0; p.N1 = N1; p.rho_lo = rho_lo; p.nrho = nrho;
  p.R1 = 2 * wy + 1; p.wy = wy; p.NT = NT; p.RT = RT; p.W = W; p.CS = CS;
  p.nmt = (Fa + kMT - 1) / kMT;
  p.nA = Fa < kMT ? Fa : kMT;  // A planes staged (an m-tile's real planes, at most)
  p.nrg = (nrho + kP - 1) / kP;
  p.NN = Fb * p.R1;
  p.ntiles = (p.NN + 7) / 8;
  p.nng = (p.ntiles + NT - 1) / NT;
  p.nunits = p.nrg * p.nng;
  p.bpb = (p.nunits + W - 1) / W;
  p.nchunks = (N1 + kTY - 1) / kTY;
  p.span = span;
  p.nbp = nbp;
  p.RA = RT + p.span - 1;
  p.SA = p.RA * kTY + 4;  // = 4 mod 16 doubles: a fragment load's 8 planes hit distinct banks
  p.BW = kTY + p.R1 - 1;
  p.SB = RT * p.BW;
  p.nbands = nbands;
  p.buf = p.nA * p.SA + p.nbp * p.SB;  // doubles of one of the two buffers
  p.smem = 16LL * p.buf;
  return p;
}

// one staged column tile of a warp: for each k-step, the walk over the RT
// staged B rows, for its TV n-tiles (a template argument, so that no DMMA
// sits under a branch) and its lag pairs (all three when kAllPairs, else
// jv). The A fragment of lag j at B row lr is As row lr + base + kP - 1 -
// j (Aw's row lr + kP - 1 - j), loaded straight into the DMMA's operand
// registers: a ring of fragments kept over the rows (one load a row
// instead of kP) pairs its slots anew at each row, and the register moves
// that assemble the operand pairs cost as much as the loads they save.
template <int NT, int TV, bool kAllPairs>
__device__ __forceinline__ void warp_tile(double (&acc)[kP / 2][NT][4], const double* Aw0,
                                          bool gv, const double* Bs, const int (&boff)[NT],
                                          int RT, int BW, int jv) {
#pragma unroll 1
  for (int y = 0; y < kTY; y += 4) {
    const double* Aw = Aw0 + y + (kP - 1) * kTY;
    const double* Bw = Bs + y;
#pragma unroll 2
    for (int lr = 0; lr < RT; ++lr) {
      double bf[TV];
#pragma unroll
      for (int nt = 0; nt < TV; ++nt) bf[nt] = Bw[boff[nt] + lr * BW];
#pragma unroll
      for (int jp = 0; jp < kP / 2; ++jp) {
        if (kAllPairs || jp < jv) {
          const double a0 = gv ? Aw[(lr - 2 * jp) * kTY] : 0.0;
          const double a1 = gv ? Aw[(lr - 2 * jp - 1) * kTY] : 0.0;
#pragma unroll
          for (int nt = 0; nt < TV; ++nt) dmma(acc[jp][nt], a0, a1, bf[nt]);
        }
      }
    }
  }
}

// grid (nmt * bpb, nbands, CS); W compute warps and a producer warp. Two
// blocks of kWMax + 1 warps an SM put three warps on a sub-partition, whose
// register file (a quarter of the SM's) then holds 168 registers a thread:
// the bound keeps the register count there (a few spill; more registers
// would leave one block an SM, or one of 4 + 1 warps a sub-partition short)
template <int NT>
__global__ void __launch_bounds__(32 * (kWMax + 1), 2) corr_mma(const double* __restrict__ A,
                                                       const double* __restrict__ B,
                                                       double* __restrict__ part, const Plan p) {
  extern __shared__ double smem[];  // two buffers: nA planes x SA (A), nbp planes x SB (B)
  const int mt = blockIdx.x / p.bpb, blk = blockIdx.x % p.bpb, band = blockIdx.y, z = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // the block's units: lag rows i_lo .. i_lo + span - 1 staged, B planes from b_lo
  const Span r = block_span(p, blk);
  int n_lo, n_hi;
  block_columns(p, r, n_lo, n_hi);
  const int i_lo = r.rg_lo * kP, span = (r.rg_hi - r.rg_lo + 1) * kP, ra = p.RT + span - 1;
  const int b_lo = n_lo / p.R1, nbp = n_hi / p.R1 - b_lo + 1;
  const int na = min(kMT, p.Fa - mt * kMT);  // real planes of the m-tile
  // As row ia <-> A row xa0 + ia; Bs row lr <-> B row rb0 + lr (wrapped)
  const int xa0 = band * p.RT - i_lo - span + 1;
  const int rb0 = p.rho_lo + band * p.RT;
  // the block's column tiles; a block whose lag rows or B planes the
  // wrapper's plan did not size the buffers for stages nothing and writes
  // NaN partials
  const bool fits = span <= p.span && nbp <= p.nbp;
  const int c_lo = z * p.nchunks / p.CS, c_hi = fits ? (z + 1) * p.nchunks / p.CS : c_lo;

  // the warp's unit: lags i = rg * kP + j, n-tiles t0 + nt (nt < tv)
  const int u = blk * p.W + warp;
  const bool active = u < min(blk * p.W + p.W, p.nunits);
  int rg, ng;
  unit_of(p, u, rg, ng);
  const int t0 = group_tile(ng, p.ntiles, p.nng);
  const int jv = min(kP / 2, (p.nrho - rg * kP + 1) / 2);
  const int tv = group_tile(ng + 1, p.ntiles, p.nng) - t0;
  // lag j of B row lr reads As row lr + base + kP - 1 - j; lanes of the
  // m-tile's padded planes read zeros
  const int base = i_lo + span - kP - rg * kP;
  const bool gv = g < na;
  int boff[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    int n = (t0 + nt) * 8 + g;
    if (nt >= tv || n >= p.NN) n = n_lo;  // a padded column: any staged value, not written
    const int b = n / p.R1;
    boff[nt] = (b - b_lo) * p.SB + (n - b * p.R1) + t;
  }
  double acc[kP / 2][NT][4];
#pragma unroll
  for (int jp = 0; jp < kP / 2; ++jp)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[jp][nt][q] = fits ? 0.0 : __longlong_as_double(kNaN);

  const long long plane = static_cast<long long>(p.N0) * p.N1;
  const int nthr = blockDim.x;
  if (warp == p.W) {
    // the producer warp: copies column tile ci into buffer bi (A: na planes
    // x ra rows, a half-warp a row of kTY columns, zero outside the image;
    // B: nbp planes x RT rows of BW columns, indices wrapped) once the
    // compute warps have released it, and marks it full
    for (int ci = c_lo; ci < c_hi; ++ci) {
      const int bi = (ci - c_lo) & 1;
      if (ci - c_lo >= 2) bar_sync(kEmpty + bi, nthr);
      double* As = smem + bi * p.buf;
      double* Bs = As + p.nA * p.SA;
      const int y0 = ci * kTY;
      for (int row = lane >> 4; row < na * ra; row += 2) {
        const int q = row / ra, ia = row - q * ra, c = lane & 15;
        const int a = mt * kMT + q, x = xa0 + ia, y = y0 + c;
        const bool ok = x >= 0 && x < p.N0 && y < p.N1;
        cp_async8(As + q * p.SA + ia * kTY + c,
                  ok ? A + a * plane + static_cast<long long>(x) * p.N1 + y : A, ok);
      }
      for (int row = 0; row < nbp * p.RT; ++row) {
        const int q = row / p.RT, lr = row - q * p.RT;
        const double* src = B + (b_lo + q) * plane +
                            static_cast<long long>(wrap_index(rb0 + lr, p.N0)) * p.N1;
        for (int c = lane; c < p.BW; c += 32)
          cp_async8(Bs + q * p.SB + lr * p.BW + c, src + wrap_index(y0 - p.wy + c, p.N1), true);
      }
      cp_async_wait_all();
      __threadfence_block();
      bar_arrive(kFull + bi, nthr);
    }
    return;
  }
  // the compute warps: each full buffer in turn, released for the tile after
  // next
  for (int ci = c_lo; ci < c_hi; ++ci) {
    const int bi = (ci - c_lo) & 1;
    bar_sync(kFull + bi, nthr);
    if (active) {
      const double* As = smem + bi * p.buf;
      const double* Aw0 = As + (gv ? g : 0) * p.SA + base * kTY + t;
      const double* Bs = As + p.nA * p.SA;
      switch (tv) {
#define SFFT_K8_TILES(n)                                                                   \
        case n:                                                                            \
          if constexpr (n <= NT) {                                                         \
            if (jv == kP / 2) warp_tile<NT, n, true>(acc, Aw0, gv, Bs, boff, p.RT, p.BW, jv); \
            else warp_tile<NT, n, false>(acc, Aw0, gv, Bs, boff, p.RT, p.BW, jv);           \
          }                                                                                \
          break;
        SFFT_K8_TILES(1) SFFT_K8_TILES(2) SFFT_K8_TILES(3) SFFT_K8_TILES(4) SFFT_K8_TILES(5)
#undef SFFT_K8_TILES
        default: break;
      }
    }
    if (ci + 2 < c_hi) bar_arrive(kEmpty + bi, nthr);
  }
  if (!active) return;
  const int a = mt * kMT + g;
  if (a >= p.Fa) return;
  const long long pz = static_cast<long long>(band) * p.CS + z;
#pragma unroll
  for (int jp = 0; jp < kP / 2; ++jp)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = rg * kP + 2 * jp + (q >> 1);
        const int n = (t0 + nt) * 8 + 2 * t + (q & 1);
        if (i < p.nrho && nt < tv && n < p.NN) {
          const int b = n / p.R1;
          part[(((pz * p.Fa + a) * p.Fb + b) * p.nrho + i) * p.R1 + (n - b * p.R1)] =
              acc[jp][nt][q];
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

template <int NT>
cudaError_t launch(const double* A, const double* B, double* part, const Plan& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(corr_mma<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nmt * p.bpb, p.nbands, p.CS);
  corr_mma<NT><<<grid, 32 * (p.W + 1), p.smem, stream>>>(A, B, part, p);
  return cudaGetLastError();
}

}  // namespace

// A (Fa, N0, N1), B (Fb, N0, N1) f64 contiguous; part (nbands * CS, Fa, Fb,
// nrho, 2wy+1) f64 scratch; out (Fa, Fb, nrho, 2wy+1) f64: lag rows rho_lo ..
// rho_lo + nrho - 1 and lags -wy .. wy. NT (n-tiles a warp, 4 or 5), RT
// (staged B rows), W (compute warps a block), CS (column splits), span,
// nbp and nbands are the wrapper's plan (greek._k8_plan), which sizes part
// with the same nbands and chose the shared memory; this side checks them.
extern "C" int sfft_corr_direct(const double* A, const double* B, double* part, double* out,
                                int Fa, int Fb, int N0, int N1, int rho_lo, int nrho, int wy,
                                int NT, int RT, int W, int CS, int span, int nbp, int nbands,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (Fa < 1 || Fb < 1 || N0 < 1 || N1 < 1 || nrho < 1 || wy < 0 || RT < 1 || W < 1 ||
      W > kWMax || CS < 1 || (NT != 4 && NT != 5) || span < kP || span % kP != 0 ||
      nbp < 1 || nbp > Fb)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(Fa, Fb, N0, N1, rho_lo, nrho, wy, NT, RT, W, CS, span, nbp, nbands);
  // the bands cover the N0 + nrho - 1 staged B rows exactly
  if (span > p.nrg * kP ||
      static_cast<long long>(nbands - 1) * RT >= N0 + nrho - 1 ||
      static_cast<long long>(nbands) * RT < N0 + nrho - 1 || p.smem > kSmemMax ||
      nbands > 65535 || CS > 65535 || CS > p.nchunks ||
      static_cast<long long>(p.nmt) * p.bpb > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = NT == 4 ? launch<4>(A, B, part, p, stream) : launch<5>(A, B, part, p, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(Fa) * Fb * nrho * p.R1;
  sum_bands<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(part, out, n,
                                                                         nbands * CS);
  return static_cast<int>(cudaGetLastError());
}
