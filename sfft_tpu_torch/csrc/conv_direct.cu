// K9 — direct convolution of a plane stack with small kernels, summed, plus
// background planes, subtracted from J; on Hopper's FP64 tensor cores.
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
// FP64 peak of 67 TFLOP/s, which only the tensor cores reach; 1.71 ms at
// the 34 TFLOP/s outside them) against ~1.9 GB of planes read and written
// (0.56 ms); 31 x 31 taps on one 2046 x 4094 plane, 8.0e9 (0.24 ms).
//
// Design. With the flipped taps tf_i[a', b'] = T_i[L0-1-a', L1-1-b'], an
// output pixel gains sum tf_i[s - x][b'] * tile_i[s][y + b'] over the staged
// plane rows s; for one staged row s of one plane that is a matrix product
//
//   D[y, x] += sum_b' tile[s][y + b'] * tf[s - x][b']
//
// run on mma.sync.m16n8k4 in f64 (DMMA; on this card m8n8k4 reaches half the
// rate of the m16 shapes): M = 16 output columns y, N = 8 output rows x, K
// = 4 tap columns b' (17 padded to 20). The M operand is a Hankel slice of
// the staged row (element (m, k) = row[y_m + b'_k], read by index); the N
// operand is a band of the flipped taps, staged with 7 zero rows on each
// side, so that a row tile that the staged row reaches only in part reads
// zeros. A warp owns 3 row tiles x 2 column tiles (24 x 32 outputs, 6
// accumulator tiles in registers) and walks the staged rows that reach
// them in runs of one reach (the row tiles a row reaches, a template
// argument, so no DMMA is predicated): per row and k-step it loads 2 M
// fragments and one N fragment per reached row tile (up to 3 with 17 taps),
// for up to 6 DMMAs. A block of 2 x 2 warps owns 48 x 64 outputs; per plane
// it copies the tile with its halo ((48 + L0 - 1) x (64 + L1 - 1)) into
// shared memory with cp.async and the plane's taps as the band. A kernel
// with a side over kSide = 63 is walked in chunks of at most 63 x 63 taps,
// each with its own halo tile. Planes are finite (the wrapper's contract,
// fdiff.conv_direct): a non-finite value would reach every row of an 8-row
// tile through the band's zeros, where the plain convolution keeps it to
// its window; convolve2d zero-fills NaN in the image and pads a
// non-finite fill with zeros, adding its terms after. The background and
// scaling planes and J are read once per pixel in the epilogue. Every sum
// has a fixed order: two launches on the same input give the same bits.
//
// What the design chose, on the card: one plane a staged tile and one
// buffer, since the blocks an SM (four at 17 taps) hide the copies and the
// loads better than K running over two planes together (less K padding) or
// a second buffer, which each halve them.
//
// Where the waste is: an 8-row tile takes every staged row that reaches any
// of its rows, (8 + L0 - 1) / L0 = 1.41 times the taps at L0 = 17, and K
// pads 17 tap columns to 20. Later work (not here): the row tiles' reach
// (N = 8 rows is the DMMA shape's least), and the epilogue's reads, which
// overlap other blocks' products only.

#include <cuda_runtime.h>

namespace {

constexpr int kRT = 3;                  // row tiles (8 output rows) of a warp
constexpr int kCT = 2;                  // column tiles (16 output columns) of a warp
constexpr int kWR = 2;                  // warps of a block along rows
constexpr int kWC = 2;                  // and along columns
constexpr int kBR = kWR * kRT * 8;      // 48 output rows of a block
constexpr int kBC = kWC * kCT * 16;     // 64 output columns of a block
constexpr int kThreads = 32 * kWR * kWC;
constexpr int kSide = 63;               // most taps along an axis staged at once
constexpr int kSmemMax = 232448;
static_assert(kRT <= 3, "conv_mma's reach masks cover three row tiles");

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// width of a staged tap band: c0 + 14 rows rounded up to 8 mod 16 doubles,
// so that the four k rows of an N fragment load hit distinct banks
__host__ __device__ inline int band_width(int c0) {
  const int w = c0 + 14;
  return w + ((8 - w % 16) + 16) % 16;
}

// doubles of a block's shared memory: the halo tile and the band of the
// c1 tap columns padded to 4, at the largest chunk
__host__ __device__ inline long long smem_doubles(int L0, int L1) {
  const int c0 = L0 < kSide ? L0 : kSide, c1 = L1 < kSide ? L1 : kSide;
  return static_cast<long long>(kBR + c0 - 1) * (kBC + c1 - 1) +
         static_cast<long long>((c1 + 3) / 4 * 4) * band_width(c0);
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

// the staged rows s in [s0, s1), which reach the row tiles in kMask: for each
// row and each k-step, a lane's M fragment (tile row s at its tap column
// k0 + t, the warp's 16-column tiles) and the N fragment of every reached
// row tile (its band row k0 + t at s - its first row). tile and band come
// offset by the lane (yw + gr; t * bw + 7 - gr - xw); a padded tap column
// (k0 + t >= c1) reads the last real one against zero taps.
template <int kMask>
__device__ __forceinline__ void conv_rows(double (&acc)[kRT][kCT][4], const double* tile,
                                          const double* band, int s0, int s1, int tw, int bw,
                                          int c1, int t) {
  const int kp = (c1 + 3) / 4 * 4;
  for (int s = s0; s < s1; ++s) {
    const double* trow = tile + s * tw;
    const double* brow = band + s;
#pragma unroll 2
    for (int k0 = 0; k0 < kp; k0 += 4) {
      const int ko = min(k0 + t, c1 - 1);
      double a0[kCT], a1[kCT];
#pragma unroll
      for (int ct = 0; ct < kCT; ++ct) {
        a0[ct] = trow[ko + ct * 16];
        a1[ct] = trow[ko + ct * 16 + 8];
      }
#pragma unroll
      for (int rt = 0; rt < kRT; ++rt) {
        if (kMask >> rt & 1) {
          const double bv = brow[k0 * bw - rt * 8];
#pragma unroll
          for (int ct = 0; ct < kCT; ++ct) dmma(acc[rt][ct], a0[ct], a1[ct], bv);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) conv_mma(const ConvArgs g) {
  extern __shared__ double smem[];
  const int x0 = blockIdx.y * kBR, y0 = blockIdx.x * kBC;
  const int w0 = g.L0 / 2, w1 = g.L1 / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int xw = (warp / kWC) * kRT * 8, yw = (warp % kWC) * kCT * 16;  // the warp's outputs
  const long long plane = static_cast<long long>(g.H) * g.W;
  double acc[kRT][kCT][4];
#pragma unroll
  for (int rt = 0; rt < kRT; ++rt)
#pragma unroll
    for (int ct = 0; ct < kCT; ++ct)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[rt][ct][q] = 0.0;

  // the flipped taps in chunks of at most kSide x kSide from (A0, B0); a
  // kernel of sides <= kSide is one chunk
  for (int A0 = 0; A0 < g.L0; A0 += kSide) {
    const int c0 = min(kSide, g.L0 - A0), th = kBR + c0 - 1;
    const int bw = band_width(c0);
    for (int B0 = 0; B0 < g.L1; B0 += kSide) {
      const int c1 = min(kSide, g.L1 - B0), tw = kBC + c1 - 1, kp = (c1 + 3) / 4 * 4;
      double* tile = smem;                          // th x tw
      double* band = smem + th * tw;                // kp rows of bw: tf[k][a'' + 7]
      for (int f = 0; f < g.F; ++f) {
        const double* P = g.planes + f * plane;
        const double* T = g.taps + static_cast<long long>(f) * g.L0 * g.L1;
        __syncthreads();  // the previous plane is consumed
        // tile row r <-> plane row (x0 - w0 + A0 + r) mod H (wrap) or x0 +
        // A0 + r (padded, zero past the plane); columns alike from B0
        for (int r = warp; r < th; r += kThreads / 32) {
          int xr = x0 + A0 + r;
          bool rok = true;
          if (g.wrap) xr = wrap_index(xr - w0, g.H);
          else rok = xr < g.H;
          for (int c = lane; c < tw; c += 32) {
            int yc = y0 + B0 + c;
            bool ok = rok;
            if (g.wrap) yc = wrap_index(yc - w1, g.W);
            else ok = ok && yc < g.W;
            cp_async8(tile + r * tw + c, ok ? P + static_cast<long long>(xr) * g.W + yc : P, ok);
          }
        }
        // the band: tf[k][a''] = T[L0-1-A0-a''][L1-1-B0-k] at column a'' + 7,
        // zero outside 0 <= a'' < c0 and for k >= c1
        for (int idx = threadIdx.x; idx < kp * bw; idx += kThreads) {
          const int k = idx / bw, d = idx - k * bw - 7;
          band[idx] = k < c1 && d >= 0 && d < c0
                          ? T[static_cast<long long>(g.L0 - 1 - A0 - d) * g.L1 + g.L1 - 1 - B0 - k]
                          : 0.0;
        }
        cp_async_wait_all();
        __syncthreads();
        // the staged rows that reach the warp's rows, in runs of one reach:
        // row tile rt takes s - xw - 8 rt in [0, c0 + 6]
        const double* tl = tile + yw + gr;
        const double* bd = band + t * bw + 7 - gr - xw;
        const int s_end = xw + kRT * 8 + c0 - 1;
        for (int s = xw; s < s_end;) {
          int mask = 0, next = s_end;
#pragma unroll
          for (int rt = 0; rt < kRT; ++rt) {
            const int lo = xw + 8 * rt, hi = lo + c0 + 7;
            if (s >= lo && s < hi) mask |= 1 << rt;
            if (lo > s && lo < next) next = lo;
            if (hi > s && hi < next) next = hi;
          }
          switch (mask) {
#define SFFT_K9_ROWS(m) \
            case m: conv_rows<m>(acc, tl, bd, s, next, tw, bw, c1, t); break;
            SFFT_K9_ROWS(1) SFFT_K9_ROWS(2) SFFT_K9_ROWS(3) SFFT_K9_ROWS(4) SFFT_K9_ROWS(5)
            SFFT_K9_ROWS(6) SFFT_K9_ROWS(7)
#undef SFFT_K9_ROWS
            default: break;
          }
          s = next;
        }
      }
    }
  }
  // lane (gr, t): acc[rt][ct][q] is output row xw + 8 rt + 2t + (q & 1),
  // column yw + 16 ct + gr + 8 (q >> 1)
  const long long n = static_cast<long long>(g.N0) * g.N1;
#pragma unroll
  for (int rt = 0; rt < kRT; ++rt)
#pragma unroll
    for (int ct = 0; ct < kCT; ++ct)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int x = x0 + xw + rt * 8 + 2 * t + (q & 1);
        const int y = y0 + yw + ct * 16 + gr + 8 * (q >> 1);
        if (x >= g.N0 || y >= g.N1) continue;
        const long long i = static_cast<long long>(x) * g.N1 + y;
        double bg = 0.0, sc = 0.0;
        for (int j = 0; j < g.Q; ++j) bg = fma(g.bq[j], g.ST[j * n + i], bg);
        for (int j = 0; j < g.NS; ++j) sc = fma(g.a00[j], g.SS[j * n + i], sc);
        const double model = g.scale * acc[rt][ct][q] + bg + g.scale * sc;
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
  const long long smem = 8LL * smem_doubles(L0, L1);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(conv_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N1 + kBC - 1) / kBC, (N0 + kBR - 1) / kBR);
  conv_mma<<<grid, kThreads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}
