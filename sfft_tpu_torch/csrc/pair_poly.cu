// K6p — the polynomial-plane stage of the pexact paths, on Hopper.
//
// Replaces: sfft_tpu/core/pexact.py pair_poly_plane (:71) together with the
// pass that consumes it, one XLA fusion on the TPU (:75-79): with
// U[s, x] = c0(x)^s and M[s, y] = sum_t C[s, t] c1(y)^t (a tiny f64 product
// the caller forms), both split into f32 (hi, lo) pairs,
//
//   plane[x, y] = sum_s (Uh + Ul)[s, x] (Mh + Ml)[s, y]
//
// per term TwoProd(Uh, Mh), lo = (e + Uh Ml) + Ul Mh; the terms summed into
// hi by TwoSum and into lo as (lo + lo_s) + e2, in s's order; then, by mode,
//
//   plane:  the pair (hi, lo)                                  (8 B written)
//   sub:    pair(I) - plane for an f64 image I (:185-186):      (8 B read, 8 B written)
//           ih = f32(I), il = f32(I - ih); TwoSum(ih, -hi); lo' = (il - lo) + e
//   add64:  Dfl + plane as f64 for a pair Dfl (:485-489):      (8 B read, 8 B written)
//           TwoSum(Dfl.hi, hi); D = f64(h) + f64((Dfl.lo + lo) + e)
//
// The plain twins are sfft_tpu_torch/core/pairs.py pair_poly_plain,
// pair_poly_sub_plain and pair_poly_add64_plain; the kernel follows them
// operation for operation (pair_arith.cuh's rules: _rn intrinsics, no FMA,
// no flush to zero), bit for bit.
//
// What bounds it: bytes in the sub and add64 modes (the image or Dfl read,
// the output written; the tables are a few hundred KB from cache), and
// nearly so in the plane mode. Unhoisted, a term is ~42 instructions
// (Dekker's TwoProd with both Veltkamp splits, four table loads and their
// addresses), which made the one-thread-per-element kernel issue-bound at
// 2.5x the byte time. Design:
//   * the splits are hoisted: the split of U[s, x] is shared by a row, that
//     of M[s, y] by a column. A block's 32 rows and 128 columns x SP table
//     values and their splits go to shared memory once, as float4s (a row's
//     a broadcast, a column's one conflict-free read a lane); the main loop
//     reads no global memory. A term is then 21 f32 operations (13 for the
//     first), the same _rn operations in the same order as the twin's, so
//     the bits are the same;
//   * a warp owns 8 rows of the block's 32 and a thread 4 columns (2t,
//     2t+1, 64+2t, 64+2t+1 of the block's 128); it sums 4 rows at a time
//     (16 accumulators, s the inner loop) and stores them before the next
//     4, so that a block's stores spread over its run;
//   * the image or Dfl tile (32 x 128 elements, 32 KB) is copied into
//     shared memory by the Tensor Memory Accelerator when the block starts
//     (one bulk copy a row and plane, issued by one thread, an mbarrier for
//     each group of 4 rows), so its load overlaps the arithmetic and costs
//     the other threads nothing; stores are float2 / double2, a warp writing
//     256 or 512 contiguous bytes;
//   * the image or Dfl may lie row-major or transposed (an image in FITS
//     order): the kernel walks memory rows either way, with U or M as the
//     row table, and writes its output in the same layout;
//   * widths not a multiple of 4, or unaligned pointers, take a scalar
//     epilogue with direct loads (same arithmetic);
//   * a batch of image pairs (the batched step) runs in one launch, the
//     pair on the grid's z axis: each pair has its own image or Dfl and
//     output plane (a pair stride) and its own tables where they differ
//     (pexact's M, from each pair's polynomial; U is shared), so each
//     pair's plane is its single launch's.
// On the H100 its arithmetic and its memory traffic (about a copy of the
// same bytes) add more than they overlap: PERF.md, K6p.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_arith.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kTileRows = kWarps * kRowsPerWarp;  // 32
constexpr int kChunk = 4;                         // rows a warp sums and stores at a time
constexpr int kChunks = kRowsPerWarp / kChunk;
constexpr int kTileCols = 128;                    // two halves of 64, 2 columns a thread in each
constexpr int kTileBytes = kTileRows * kTileCols * 8;
constexpr int kMaxSP = 32;                        // tables + tile <= 112 KB of shared memory

enum Mode : int { kPlane = 0, kSub = 1, kAdd64 = 2 };

struct Args {
  const float *Uh, *Ul, *Mh, *Ml;
  const void *in0, *in1;  // sub: the f64 image; add64: Dfl's hi and lo planes
  void *out0, *out1;      // plane / sub: hi and lo; add64: the f64 plane
  int SP, N0, N1;
  long long in_ps, out_ps;  // bytes from one pair's input / output plane to the next
  long long u_ps, m_ps;     // floats from one pair's U / M table to the next (0: shared)
};

// a table value (hi, lo) with the Veltkamp split of hi by 4097
struct Val {
  float h, l, sh, sl;
};

__device__ __forceinline__ Val make_val(float h, float l) {
  const float a1 = pairs::mul(h, 4097.0f);
  Val v;
  v.h = h;
  v.l = l;
  v.sh = pairs::sub(a1, pairs::sub(a1, h));
  v.sl = pairs::sub(h, v.sh);
  return v;
}

// one term u * m: p = TwoProd(u.h, m.h)'s product, lo = (e + u.h m.l) + u.l m.h
// (pair_arith.cuh two_prod and mul_rr on the precomputed splits)
__device__ __forceinline__ void term(const Val& u, const Val& m, float& p, float& lo) {
  using namespace pairs;
  p = mul(u.h, m.h);
  const float e = add(add(add(sub(mul(u.sh, m.sh), p), mul(u.sh, m.sl)), mul(u.sl, m.sh)),
                      mul(u.sl, m.sl));
  lo = add(add(e, mul(u.h, m.l)), mul(u.l, m.h));
}

// term s of the sum for a chunk of a thread's rows (their table values at
// rv) and its 4 columns (cv): the first sets (hi, lo), the others add by
// TwoSum into hi and as (lo + lo_s) + e2 into lo
template <bool FIRST, bool TR>
__device__ __forceinline__ void accumulate(const float4* rv, const Val (&cv)[4],
                                           float (&hi)[kChunk][4], float (&lo)[kChunk][4]) {
#pragma unroll
  for (int r = 0; r < kChunk; ++r) {
    const float4 q = rv[r];
    const Val row = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float p, t;
      if (TR)
        term(cv[c], row, p, t);
      else
        term(row, cv[c], p, t);
      if (FIRST) {
        hi[r][c] = p;
        lo[r][c] = t;
      } else {
        float e2;
        pairs::two_sum(hi[r][c], p, hi[r][c], e2);
        lo[r][c] = pairs::add(pairs::add(lo[r][c], t), e2);
      }
    }
  }
}

// a lane's 4 column values at term s (shared memory [SP][4][32])
__device__ __forceinline__ void col_vals(const float4* colv, int s, int lane, Val (&cv)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 q = colv[(s * 4 + j) * 32 + lane];
    cv[j] = {q.x, q.y, q.z, q.w};
  }
}

// sub: pair(x) - (h, l)
__device__ __forceinline__ void finish_sub(double x, float h, float l, float& oh, float& ol) {
  const float ih = __double2float_rn(x);
  const float il = __double2float_rn(__dsub_rn(x, static_cast<double>(ih)));
  float e;
  pairs::two_sum(ih, -h, oh, e);
  ol = pairs::add(pairs::sub(il, l), e);
}

// add64: (dh, dl) + (h, l) as one f64
__device__ __forceinline__ double finish_add64(float dh, float dl, float h, float l) {
  float s, e;
  pairs::two_sum(dh, h, s, e);
  const float t = pairs::add(pairs::add(dl, l), e);
  return __dadd_rn(static_cast<double>(s), static_cast<double>(t));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the Tensor Memory Accelerator's bulk copy of `bytes` (a multiple of 16,
// both ends 16-byte aligned) from global to shared memory; its completion
// counts on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// the one arrival of the barrier's phase, which then completes when `bytes`
// have landed
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// until the barrier's first phase has completed (its copies landed)
__device__ __forceinline__ void bar_wait(unsigned long long* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  }
}

// the epilogue of a chunk of rows (tile rows tr0 .. tr0 + kChunk - 1; a
// thread's columns 2t, 2t+1, 64+2t, 64+2t+1 of the tile) by mode: vector
// loads from the staged tile and vector stores, or (VEC false) element by
// element from global memory
template <int MODE, bool VEC>
__device__ __forceinline__ void epilogue(const Args& a, const char* tile,
                                         const float (&hi)[kChunk][4],
                                         const float (&lo)[kChunk][4], int row0, int col0,
                                         int tr0, int lane, int nrow, int ncol) {
#pragma unroll
  for (int r = 0; r < kChunk; ++r) {
    const int tr = tr0 + r;
    const long long gr = row0 + tr;
    if (gr >= nrow) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int tc = q * 64 + 2 * lane;
      const long long gc = col0 + tc;
      const long long o = gr * ncol + gc;
      const float h0 = hi[r][2 * q], h1 = hi[r][2 * q + 1];
      const float l0 = lo[r][2 * q], l1 = lo[r][2 * q + 1];
      if (VEC) {
        if (gc >= ncol) continue;
        if (MODE == kPlane) {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out0) + o) = make_float2(h0, h1);
          *reinterpret_cast<float2*>(static_cast<float*>(a.out1) + o) = make_float2(l0, l1);
        } else if (MODE == kSub) {
          const double2 x = reinterpret_cast<const double2*>(tile)[(tr * kTileCols + tc) / 2];
          float2 oh, ol;
          finish_sub(x.x, h0, l0, oh.x, ol.x);
          finish_sub(x.y, h1, l1, oh.y, ol.y);
          *reinterpret_cast<float2*>(static_cast<float*>(a.out0) + o) = oh;
          *reinterpret_cast<float2*>(static_cast<float*>(a.out1) + o) = ol;
        } else {
          const float* th = reinterpret_cast<const float*>(tile);
          const float* tl = reinterpret_cast<const float*>(tile + kTileBytes / 2);
          const float2 dh = *reinterpret_cast<const float2*>(th + tr * kTileCols + tc);
          const float2 dl = *reinterpret_cast<const float2*>(tl + tr * kTileCols + tc);
          *reinterpret_cast<double2*>(static_cast<double*>(a.out0) + o) =
              make_double2(finish_add64(dh.x, dl.x, h0, l0), finish_add64(dh.y, dl.y, h1, l1));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (gc + j >= ncol) continue;
          const float h = j ? h1 : h0, l = j ? l1 : l0;
          if (MODE == kPlane) {
            static_cast<float*>(a.out0)[o + j] = h;
            static_cast<float*>(a.out1)[o + j] = l;
          } else if (MODE == kSub) {
            float oh, ol;
            finish_sub(static_cast<const double*>(a.in0)[o + j], h, l, oh, ol);
            static_cast<float*>(a.out0)[o + j] = oh;
            static_cast<float*>(a.out1)[o + j] = ol;
          } else {
            static_cast<double*>(a.out0)[o + j] =
                finish_add64(static_cast<const float*>(a.in0)[o + j],
                             static_cast<const float*>(a.in1)[o + j], h, l);
          }
        }
      }
    }
  }
}

// TR: memory rows run along y (a transposed image), so M is the row table
// and U the column table. VEC: the memory row width is a multiple of 4 and
// every pointer aligned (vector loads and stores, the staged tile).
template <int MODE, bool TR, bool VEC>
__global__ void __launch_bounds__(kThreads, 4) pair_poly_kernel(Args a) {
  extern __shared__ float4 smem[];
  if (blockIdx.z) {   // the pair of a batch: its planes and tables
    const long long z = blockIdx.z;
    a.Uh += z * a.u_ps;
    a.Ul += z * a.u_ps;
    a.Mh += z * a.m_ps;
    a.Ml += z * a.m_ps;
    if (a.in0) a.in0 = static_cast<const char*>(a.in0) + z * a.in_ps;
    if (a.in1) a.in1 = static_cast<const char*>(a.in1) + z * a.in_ps;
    a.out0 = static_cast<char*>(a.out0) + z * a.out_ps;
    if (a.out1) a.out1 = static_cast<char*>(a.out1) + z * a.out_ps;
  }
  const int nrow = TR ? a.N1 : a.N0;
  const int ncol = TR ? a.N0 : a.N1;
  const float* rH = TR ? a.Mh : a.Uh;
  const float* rL = TR ? a.Ml : a.Ul;
  const float* cH = TR ? a.Uh : a.Mh;
  const float* cL = TR ? a.Ul : a.Ml;
  const int SP = a.SP;
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* rows = smem;                        // [SP][kTileRows]
  float4* colv = smem + SP * kTileRows;       // [SP][4][32]: (s, j, lane), lane's column j
  char* tile = reinterpret_cast<char*>(colv + SP * kTileCols);  // the staged input

  // 1. the input tile, by the TMA: one bulk copy a row and plane, issued by
  // one thread, in a group (and an mbarrier) for each chunk of rows (the
  // chunk's rows of every warp), in the order the epilogues consume them;
  // no other thread spends an instruction on it
  __shared__ unsigned long long bars[kChunks];
  if (VEC && MODE != kPlane && threadIdx.x == 0) {
    for (int g = 0; g < kChunks; ++g) bar_init(&bars[g]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the elements of the tile's rows (the last column tile may be narrower)
    const int width = min(kTileCols, ncol - col0);
    const unsigned row_bytes = width * 8;  // f64, or two f32 planes
    for (int g = 0; g < kChunks; ++g) {
      unsigned bytes = 0;
      for (int w = 0; w < kWarps; ++w)
        bytes += row_bytes * max(0, min(kChunk, nrow - row0 - w * kRowsPerWarp - g * kChunk));
      bar_expect(&bars[g], bytes);
      for (int w = 0; w < kWarps; ++w) {
        for (int rr = 0; rr < kChunk; ++rr) {
          const int tr = w * kRowsPerWarp + g * kChunk + rr;
          const long long gr = row0 + tr;
          if (gr >= nrow) break;
          if (MODE == kSub) {
            bulk_copy(tile + tr * kTileCols * 8,
                      static_cast<const double*>(a.in0) + gr * ncol + col0, row_bytes, &bars[g]);
          } else {
            for (int plane = 0; plane < 2; ++plane)
              bulk_copy(tile + plane * (kTileBytes / 2) + tr * kTileCols * 4,
                        static_cast<const float*>(plane ? a.in1 : a.in0) + gr * ncol + col0,
                        row_bytes / 2, &bars[g]);
          }
        }
      }
    }
  }

  // 2. the tables and their splits, every s: the tile's rows, and its
  // columns in the order the lanes read them (conflict-free float4s)
  for (int k = threadIdx.x; k < SP * kTileRows; k += kThreads) {
    const int s = k / kTileRows, r = k - s * kTileRows;
    const long long gr = row0 + r;
    float h = 0.0f, l = 0.0f;
    if (gr < nrow) {
      h = __ldg(rH + static_cast<long long>(s) * nrow + gr);
      l = __ldg(rL + static_cast<long long>(s) * nrow + gr);
    }
    const Val v = make_val(h, l);
    rows[k] = make_float4(v.h, v.l, v.sh, v.sl);
  }
  for (int k = threadIdx.x; k < SP * kTileCols; k += kThreads) {
    const int s = k / kTileCols, j = (k >> 5) & 3, t = k & 31;
    const long long gc = col0 + (j >> 1) * 64 + 2 * t + (j & 1);
    float h = 0.0f, l = 0.0f;
    if (gc < ncol) {
      h = __ldg(cH + static_cast<long long>(s) * ncol + gc);
      l = __ldg(cL + static_cast<long long>(s) * ncol + gc);
    }
    const Val v = make_val(h, l);
    colv[k] = make_float4(v.h, v.l, v.sh, v.sl);
  }
  __syncthreads();

  // 3. a chunk of rows at a time: the sum over s, then its epilogue (so
  // that a block's stores spread over its run)
  const float4* myrows = rows + warp * kRowsPerWarp;
#pragma unroll 1
  for (int g = 0; g < kChunks; ++g) {
    float hi[kChunk][4], lo[kChunk][4];
    Val cv[4];
    col_vals(colv, 0, lane, cv);
    accumulate<true, TR>(myrows + g * kChunk, cv, hi, lo);
#pragma unroll 1
    for (int s = 1; s < SP; ++s) {
      col_vals(colv, s, lane, cv);
      accumulate<false, TR>(myrows + s * kTileRows + g * kChunk, cv, hi, lo);
    }
    // this chunk's rows have landed (the later ones may not)
    if (VEC && MODE != kPlane) bar_wait(&bars[g]);
    epilogue<MODE, VEC>(a, tile, hi, lo, row0, col0, warp * kRowsPerWarp + g * kChunk, lane,
                        nrow, ncol);
  }
}

bool aligned(const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0; }

template <int MODE, bool TR>
int launch(const Args& a, int pairs, bool vec, cudaStream_t stream) {
  const int nrow = TR ? a.N1 : a.N0, ncol = TR ? a.N0 : a.N1;
  const dim3 grid((ncol + kTileCols - 1) / kTileCols, (nrow + kTileRows - 1) / kTileRows, pairs);
  const size_t tables = static_cast<size_t>(a.SP) * (kTileRows + kTileCols) * sizeof(float4);
  const size_t bytes = tables + (vec && MODE != kPlane ? kTileBytes : 0);
  void (*kernel)(Args) = vec ? pair_poly_kernel<MODE, TR, true> : pair_poly_kernel<MODE, TR, false>;
  if (bytes + kChunks * sizeof(unsigned long long) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 plane (out0/out1 = hi/lo), 1 sub (in0 = the f64 image), 2 add64
// (in0/in1 = Dfl's hi/lo, out0 = the f64 plane). transposed: the input and
// the output lie with strides (1, N0) instead of (N1, 1). The tables are
// contiguous (SP, N0) and (SP, N1) f32. pairs: a batch of image pairs in
// one launch (1 without one), at most 65535: pair z's input and output
// planes lie in_ps and out_ps bytes, its U and M tables u_ps and m_ps
// floats (0 for a table the pairs share) past pair z - 1's.
extern "C" int sfft_pair_poly(int mode, int transposed, const void* Uh, const void* Ul,
                              const void* Mh, const void* Ml, const void* in0, const void* in1,
                              void* out0, void* out1, int SP, int N0, int N1, int pairs,
                              long long in_ps, long long out_ps, long long u_ps, long long m_ps,
                              void* stream_ptr) {
  if (N0 <= 0 || N1 <= 0) return cudaSuccess;
  if (SP < 1 || SP > kMaxSP || mode < kPlane || mode > kAdd64 || (mode == kPlane && transposed) ||
      pairs < 1 || pairs > 65535)
    return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(Uh), static_cast<const float*>(Ul),
         static_cast<const float*>(Mh), static_cast<const float*>(Ml), in0, in1, out0, out1,
         SP, N0, N1, in_ps, out_ps, u_ps, m_ps};
  const int ncol = transposed ? N0 : N1;
  const void* col_tables[2] = {transposed ? Uh : Mh, transposed ? Ul : Ml};
  const long long col_ps = transposed ? u_ps : m_ps;
  // every pair's planes 16-byte aligned and its column tables 8-byte aligned
  const bool vec = ncol % 4 == 0 && aligned(in0, 16) && aligned(in1, 16) && aligned(out0, 16) &&
                   aligned(out1, 16) && aligned(col_tables[0], 8) && aligned(col_tables[1], 8) &&
                   in_ps % 16 == 0 && out_ps % 16 == 0 && col_ps % 2 == 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (mode * 2 + (transposed ? 1 : 0)) {
    case 0: return launch<kPlane, false>(a, pairs, vec, stream);
    case 2: return launch<kSub, false>(a, pairs, vec, stream);
    case 3: return launch<kSub, true>(a, pairs, vec, stream);
    case 4: return launch<kAdd64, false>(a, pairs, vec, stream);
    default: return launch<kAdd64, true>(a, pairs, vec, stream);
  }
}
