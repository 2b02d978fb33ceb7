// K4 — the integer slicing stage of f32 (hi, lo) pairs on Hopper.
//
// Replaces: sfft_tpu/core/pallas_slice.py, slice_pair_real / _mk_kernel, the
// Pallas twin of sfft_tpu/core/exact_fft.py _slice_pair_real(int8=True)
// (whose scale, max|hi| per row or over the operand rounded up to a power of
// two, belongs to the same function); and with it the TPU timing prototypes
// of tools/diag_slice_cost.py and tools/diag_slice_cost2.py, which compute
// the same function. The sliced exact engine
// (sfft_tpu_torch/core/exact_fft.py) writes every f32 pair operand of its
// int8 matrix products as nsl 6-bit slices under a power-of-two scale s:
//
//   s = 2^(exponent(max |hi|) + 1)       (rowwise: over the row; else global)
//   canonicalise  h2 = hi + lo,  l2 = lo - (h2 - hi)        (TwoSum, |lo|<=|hi|)
//   r = h2 / s;   for q < nsl:  p = rint(r * 2^(6(q+1)));  out[q] = p;
//                               r -= p / 2^(6(q+1));
//                               after slice kInject: r += l2 / s
//
// Every product is by a power of two and every subtraction is exact
// (Sterbenz), so the slices are bit-identical to the plain twin
// (core/slicing.py slice_pairs_plain) and to sfft_tpu's XLA chain. That
// needs IEEE rounding of the two additions and round-half-to-even: the
// arithmetic goes through the _rn intrinsics and rintf (never roundf), and
// the build takes no fast-math flag (which would flush denormal remainders
// to zero). The divisions by s and by 2^(6(q+1)) are multiplications by
// the exact reciprocal powers of two: the same real quotient, rounded once,
// so the same bits as the twin's division (also where it underflows). The
// scale comes from the device (computed here, or by the caller), so
// nothing synchronises with the host.
//
// The stage. One launch takes an operand as its producer left it: one or
// two pairs (a complex operand's real and imaginary parts, blockIdx.y), each
// a 3-D view (outer, inner, K) with any element strides, the contraction
// axis K last in the logical layout (a transposed view has a large K
// stride). It writes (nsl, rows, Kp) int8 with the pad columns K..Kp-1 as
// zeros (the depth an int8 product wants), and with a rowwise scale it takes
// max|hi| over each row itself and writes the scales. A global scale needs
// the whole operand's max before any slice: a first small launch
// (absmax_kernel, both parts) reduces it, the last of its blocks (integer
// ticket after __threadfence()) rounds it to the power of two. An operand
// that stacks a batch of independent pairs on its leading axis (the batched
// step) takes one global scale per pair, as sfft_tpu's jax.vmap does: both
// launches take the pair on gridDim.z (its part of the operand at a pair
// stride, its output rows after the previous pairs'), the max launch
// reduces each pair's part on its own, and the slicing launch reads the
// pair's scale and writes it to each of the pair's rows, so the consumers
// see per-row scales. The max is exact, so a pair's scale and slices are
// those of its single call. Nothing else runs: no pad copy, no transpose
// copy, no elementwise scale kernels.
//
// What bounds it: bytes. Each live element reads 8 bytes and each padded
// element writes nsl bytes (17 B at nsl = 9), for ~4 nsl + 6 f32 operations.
// Two layouts:
//   * row mode (K stride 1): G threads per row (G * 8 >= Kp up to G = 512),
//     each owning 8 neighbouring columns: two 16-byte loads of hi and of lo
//     where the rows are 16-byte aligned (4-byte loads elsewhere), one
//     8-byte store per plane. A rowwise scale is reduced over the G threads
//     (shuffles, then shared memory) from the registers that hold the row,
//     which are then sliced: one read. (16 columns per thread needed 128
//     registers, two blocks per SM, and ran 15-20% slower on the paths'
//     rows.)
//   * tile mode (K strided): lane = inner row, warps along K, so the loads
//     are coalesced along the stored (inner) axis; the tile's shape follows
//     Kp (32 rows x 128 columns down to 256 rows x 16), and each plane's 16
//     bytes per thread go through a double-buffered shared tile and leave as
//     16-byte stores along K. A rowwise scale over more than one tile comes
//     from a first launch (rowmax_tile_kernel) that splits K over many
//     blocks, so the slicing launch is never short of blocks.
// Row offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNB = 6;                          // bits per slice
constexpr int kInject = (24 + kNB - 1) / kNB;   // f32 hi consumed after 4 slices
constexpr float kStep = float(1 << kNB);        // 2^NB
constexpr int kThreads = 256;
constexpr int kCols = 16;                       // tile mode: columns per thread
constexpr int kRowCols = 8;                     // row mode: columns per thread
constexpr int kRowThreads = 512;                // row mode: most threads per block
constexpr int kTileWords = 512;                 // tile mode: 16-byte words per plane buffer

// One part of a stage launch. Strides are in elements: [0] outer, [1] inner,
// [2] along K.
struct Part {
  const float* hi;
  const float* lo;
  long long hs[3];
  long long ls[3];
  const float* scale_in;   // scale_mode 0: one value; 1: one per output row
  float* scale_out;        // scale_mode 2 and 3: one per output row
  int8_t* out;             // (nsl, rows, Kp)
  long long mn[3];         // absmax: hi's sizes ordered by ascending stride (of one pair)
  long long ms[3];         //         and those strides
  float* pair_scale;       // absmax: one value per pair (gridDim.z); scale_mode 3 reads it
  long long pair_stride;   // hi's stride from one pair (gridDim.z) to the next
  long long pair_stride_lo;  // lo's
};

struct Stage {
  Part part[2];
  long long n_outer, n_inner;   // rows = n_outer * n_inner
  long long o_outer, o_inner;   // output row of (o, i) = o * o_outer + i * o_inner
  long long K, Kp;
  int nsl;
  int scale_mode;               // 0 given global, 1 given per row, 2 computed per row,
                                // 3 one per pair (pair_scale), written to every row
};

__device__ __forceinline__ float pow2ceil(float m) {
  // core/slicing.py _pow2ceil_scalar: clamp, then 2^(biased exponent - 126)
  m = fmaxf(m, 1e-30f);
  const int e = (__float_as_int(m) >> 23) & 0xFF;
  return __int_as_float((e + 1) << 23);
}

__device__ __forceinline__ uint32_t pack4(const int8_t* p) {
  return (uint32_t)(uint8_t)p[0] | ((uint32_t)(uint8_t)p[1] << 8) |
         ((uint32_t)(uint8_t)p[2] << 16) | ((uint32_t)(uint8_t)p[3] << 24);
}

// The N columns a thread owns: canonicalise, scale, then plane by plane the
// remainder chain; emit(q, words) receives each plane's N bytes as N / 4
// little-endian words.
template <int N, typename Emit>
__device__ __forceinline__ void slice_cols(const float (&h)[N], const float (&l)[N],
                                           float inv_s, int nsl, Emit emit) {
  float r[N], lr[N];
#pragma unroll
  for (int v = 0; v < N; ++v) {
    const float h2 = __fadd_rn(h[v], l[v]);
    const float l2 = __fsub_rn(l[v], __fsub_rn(h2, h[v]));
    r[v] = __fmul_rn(h2, inv_s);
    lr[v] = __fmul_rn(l2, inv_s);
  }
  float sc = 1.0f, inv_sc = 1.0f;
  for (int q = 0; q < nsl; ++q) {
    sc = __fmul_rn(sc, kStep);
    inv_sc = __fmul_rn(inv_sc, 1.0f / kStep);
    int8_t p8[N];
#pragma unroll
    for (int v = 0; v < N; ++v) {
      const float p = rintf(__fmul_rn(r[v], sc));
      p8[v] = static_cast<int8_t>(static_cast<int>(p));
      r[v] = __fsub_rn(r[v], __fmul_rn(p, inv_sc));
      if (q == kInject - 1) r[v] = __fadd_rn(r[v], lr[v]);
    }
    uint32_t w[N / 4];
#pragma unroll
    for (int k = 0; k < N / 4; ++k) w[k] = pack4(p8 + 4 * k);
    emit(q, w);
  }
}

// 16 bytes at column c of an output row of Kp columns. ST = 16: one store
// (Kp % 16 == 0); 8: two (Kp % 8 == 0); 1: byte by byte.
template <int ST>
__device__ __forceinline__ void store16(int8_t* row, long long c, long long Kp, uint4 w) {
  if (ST == 16) {
    *reinterpret_cast<uint4*>(row + c) = w;
  } else if (ST == 8) {
    *reinterpret_cast<uint2*>(row + c) = make_uint2(w.x, w.y);
    if (c + 8 < Kp) *reinterpret_cast<uint2*>(row + c + 8) = make_uint2(w.z, w.w);
  } else {
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int v = 0; v < kCols; ++v)
      if (c + v < Kp) row[c + v] = (int8_t)(ws[v / 4] >> (8 * (v % 4)));
  }
}

// Row mode: K stride 1. grid = (row blocks, parts, pairs); G threads per row:
// a power of two up to 32 (blocks of 256 threads, 256 / G rows), or a
// multiple of 32 up to 512 (one row per block of G threads).
template <bool VIN, bool ST8>
__global__ void __launch_bounds__(kRowThreads, 2)
pairs_row_kernel(const __grid_constant__ Stage st, int G) {
  const Part& p = st.part[blockIdx.y];
  const long long z = blockIdx.z;                       // the pair (0 without a batch)
  const int g = G <= 32 ? (threadIdx.x & (G - 1)) : threadIdx.x;
  const long long rows = st.n_outer * st.n_inner;       // a pair's
  const long long prow = (long long)blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool live = prow < rows;
  const long long o = live ? prow / st.n_inner : 0;
  const long long i = live ? prow - o * st.n_inner : 0;
  const long long row = z * rows + prow;                // the output row
  const float* hrow = p.hi + z * p.pair_stride + o * p.hs[0] + i * p.hs[1];
  const float* lrow = p.lo + z * p.pair_stride_lo + o * p.ls[0] + i * p.ls[1];
  const long long K = st.K, Kp = st.Kp;
  const long long span = (long long)G * kRowCols;
  const int ntiles = (int)((Kp + span - 1) / span);
  float h[kRowCols], l[kRowCols];

  // the thread's columns from c0
  auto load = [&](long long c0, bool with_lo) {
    if (VIN && live && c0 + kRowCols <= K) {
#pragma unroll
      for (int v = 0; v < kRowCols; v += 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(hrow + c0 + v));
        h[v] = a.x; h[v + 1] = a.y; h[v + 2] = a.z; h[v + 3] = a.w;
        if (with_lo) {
          const float4 b = __ldg(reinterpret_cast<const float4*>(lrow + c0 + v));
          l[v] = b.x; l[v + 1] = b.y; l[v + 2] = b.z; l[v + 3] = b.w;
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < kRowCols; ++v) {
        const bool in = live && c0 + v < K;
        h[v] = in ? __ldg(hrow + c0 + v) : 0.0f;
        if (with_lo) l[v] = in ? __ldg(lrow + c0 + v) : 0.0f;
      }
    }
  };

  float s;
  if (st.scale_mode == 2) {
    float m = 0.0f;
    for (int t = 0; t < ntiles; ++t) {
      load((long long)t * span + (long long)g * kRowCols, ntiles == 1);
#pragma unroll
      for (int v = 0; v < kRowCols; ++v) m = fmaxf(m, fabsf(h[v]));
    }
    // max over the row's G threads
    for (int off = (G < 32 ? G : 32) / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (G > 32) {
      __shared__ float red[kRowThreads / 32];
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
      __syncthreads();
      m = 0.0f;
      for (int w = 0; w < G / 32; ++w) m = fmaxf(m, red[w]);
    }
    s = pow2ceil(m);
    if (live && g == 0) p.scale_out[row] = s;
  } else if (st.scale_mode == 3) {
    s = __ldg(p.pair_scale + z);
    if (live && g == 0) p.scale_out[row] = s;
  } else {
    s = __ldg(p.scale_in + (st.scale_mode == 1 && live ? row : 0));
  }
  if (!live) return;
  const float inv_s = __frcp_rn(s);
  int8_t* orow = p.out + row * Kp;
  const long long plane = gridDim.z * rows * Kp;
  for (int t = 0; t < ntiles; ++t) {
    const long long c0 = (long long)t * span + (long long)g * kRowCols;
    if (c0 >= Kp) break;
    if (!(st.scale_mode == 2 && ntiles == 1)) load(c0, true);
    slice_cols<kRowCols>(h, l, inv_s, st.nsl, [&](int q, const uint32_t (&w)[kRowCols / 4]) {
      int8_t* oq = orow + q * plane;
      if (ST8) {
        *reinterpret_cast<uint2*>(oq + c0) = make_uint2(w[0], w[1]);
      } else {
#pragma unroll
        for (int v = 0; v < kRowCols; ++v)
          if (c0 + v < Kp) oq[c0 + v] = (int8_t)(w[v / 4] >> (8 * (v % 4)));
      }
    });
  }
}

// Tile mode: K strided. grid = (outer x inner tiles x column blocks, parts,
// pairs).
// WC warps along K (16 columns each) and RG groups of 32 rows (blockDim.x =
// 32 WC RG <= 256; RG below 8 / WC when the inner axis is short): a tile of
// 32 RG inner rows x 16 WC columns; lane = inner row, so the loads are
// coalesced along the stored axis. Each plane's 16 bytes per thread go
// through a double-buffered shared tile and leave as 16-byte stores along K.
// A rowwise scale is computed here only when K fits one tile (from the
// registers); longer rows take their scales from rowmax_tile_kernel.
template <int ST>
__global__ void __launch_bounds__(kThreads)
pairs_tile_kernel(const __grid_constant__ Stage st, long long tiles_inner, int kblocks, int WC) {
  __shared__ uint4 buf[2][kTileWords];
  __shared__ float red[kThreads / 32][33];
  const Part& p = st.part[blockIdx.y];
  const long long z = blockIdx.z;                 // the pair (0 without a batch)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wcol = warp % WC, rgrp = warp / WC;
  const int TR = (int)blockDim.x / WC, TC = kCols * WC;
  const long long bx = blockIdx.x;
  const int kb = (int)(bx % kblocks);
  const long long rest = bx / kblocks;
  const long long it = rest % tiles_inner;
  const long long o = rest / tiles_inner;
  const int r = rgrp * 32 + lane;                 // this thread's row in the tile
  const long long i = it * TR + r;
  const bool live = i < st.n_inner;
  const float* hrow = p.hi + z * p.pair_stride + o * p.hs[0] + (live ? i : 0) * p.hs[1];
  const float* lrow = p.lo + z * p.pair_stride_lo + o * p.ls[0] + (live ? i : 0) * p.ls[1];
  const long long K = st.K, Kp = st.Kp;
  const long long hk = p.hs[2], lk = p.ls[2];
  const long long rows = st.n_outer * st.n_inner;   // a pair's
  const long long ntiles = (Kp + TC - 1) / TC;
  const long long my_row = z * rows + o * st.o_outer + i * st.o_inner;
  // the write-out: thread -> (row of the tile, 16 columns)
  const int wr = threadIdx.x / WC, wc = threadIdx.x % WC;
  const long long wi = it * TR + wr;
  int8_t* wrow = p.out + (z * rows + o * st.o_outer + wi * st.o_inner) * Kp;
  const long long plane = gridDim.z * rows * Kp;
  const int pitch = WC + 1;                       // uint4 words per tile row
  int b = 0;
  for (long long t = kb; t < ntiles; t += kblocks) {
    const long long c0 = t * TC + wcol * kCols;
    float h[kCols], l[kCols];
#pragma unroll
    for (int v = 0; v < kCols; ++v) {
      const bool in = live && c0 + v < K;
      h[v] = in ? __ldg(hrow + (c0 + v) * hk) : 0.0f;
      l[v] = in ? __ldg(lrow + (c0 + v) * lk) : 0.0f;
    }
    float s;
    if (st.scale_mode == 2) {
      // the whole row is in this tile (ntiles == 1): max over its WC warps
      float m = 0.0f;
#pragma unroll
      for (int v = 0; v < kCols; ++v) m = fmaxf(m, fabsf(h[v]));
      red[warp][lane] = m;
      __syncthreads();
      m = 0.0f;
      for (int w = 0; w < WC; ++w) m = fmaxf(m, red[rgrp * WC + w][lane]);
      s = pow2ceil(m);
      if (live && wcol == 0) p.scale_out[my_row] = s;
    } else if (st.scale_mode == 3) {
      s = __ldg(p.pair_scale + z);
      if (live && wcol == 0 && t == 0) p.scale_out[my_row] = s;
    } else {
      s = __ldg(p.scale_in + (st.scale_mode == 1 && live ? my_row : 0));
    }
    const long long wcol0 = t * TC + wc * kCols;
    slice_cols<kCols>(h, l, __frcp_rn(s), st.nsl, [&](int q, const uint32_t (&ws)[kCols / 4]) {
      const uint4 w = make_uint4(ws[0], ws[1], ws[2], ws[3]);
      // double-buffered: the buffer written here was last read two planes
      // ago, before the barrier that the previous plane passed
      buf[b][r * pitch + wcol] = w;
      __syncthreads();
      if (wi < st.n_inner && wcol0 < Kp)
        store16<ST>(wrow + q * plane, wcol0, Kp, buf[b][wr * pitch + wc]);
      b ^= 1;
    });
  }
}

// The rowwise scales of a tile-mode view whose rows span several tiles:
// grid = (outer x inner tiles x K chunks, parts); a block takes 32 rows
// (lane = row, coalesced along the stored axis) over one chunk of K, its 8
// warps striding over the chunk's columns; the last block of a row tile
// (integer ticket after __threadfence()) reduces the chunks' maxima and
// writes each row's power of two. partial: parts x tiles x kchunks x 32
// floats; ticket: parts x tiles zeroed unsigned ints, left zeroed.
__global__ void __launch_bounds__(kThreads)
rowmax_tile_kernel(const __grid_constant__ Stage st, long long tiles_inner, int kchunks,
                   float* partial, unsigned int* ticket) {
  __shared__ float red[kThreads / 32][33];
  __shared__ bool last;
  const Part& p = st.part[blockIdx.y];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long bx = blockIdx.x;
  const int kc = (int)(bx % kchunks);
  const long long tile = bx / kchunks;            // o * tiles_inner + it
  const long long it = tile % tiles_inner;
  const long long o = tile / tiles_inner;
  const long long i = it * 32 + lane;
  const bool live = i < st.n_inner;
  const float* hrow = p.hi + o * p.hs[0] + (live ? i : 0) * p.hs[1];
  const long long hk = p.hs[2];
  const long long cw = (st.K + kchunks - 1) / kchunks;
  const long long c1 = min(st.K, (kc + 1) * cw);
  float m = 0.0f;
  if (live)
    for (long long c = kc * cw + warp; c < c1; c += kThreads / 32)
      m = fmaxf(m, fabsf(__ldg(hrow + c * hk)));
  red[warp][lane] = m;
  __syncthreads();
  const long long ntile = st.n_outer * tiles_inner;
  float* part = partial + ((long long)blockIdx.y * ntile + tile) * kchunks * 32;
  if (warp == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w][lane]);
    part[kc * 32 + lane] = m;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int* tk = ticket + (long long)blockIdx.y * ntile + tile;
    last = atomicAdd(tk, 1u) == (unsigned)kchunks - 1;
    if (last) *tk = 0u;   // ready for the next launch on this stream
  }
  __syncthreads();
  if (!last || warp != 0) return;
  __threadfence();
  m = 0.0f;
  for (int k = 0; k < kchunks; ++k) m = fmaxf(m, __ldcg(part + k * 32 + lane));
  if (live) p.scale_out[o * st.o_outer + i * st.o_inner] = pow2ceil(m);
}

// max |hi| of each part over its whole view (or over each pair's part of it:
// gridDim.z pairs, pair z at hi + z * pair_stride), rounded up to the scale,
// written to pair_scale[z]; grid = (blocks per part and pair, parts, pairs).
// partial: gridDim.x floats per part and pair; ticket: one zeroed unsigned
// int per part and pair, left zeroed.
template <bool DENSE4>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const __grid_constant__ Stage st, float* partial, unsigned int* ticket) {
  __shared__ float red[kThreads / 32];
  __shared__ bool last;
  const Part& p = st.part[blockIdx.y];
  const float* hi = p.hi + (long long)blockIdx.z * p.pair_stride;
  const long long seg = (long long)blockIdx.y * gridDim.z + blockIdx.z;   // part and pair
  const long long n0 = p.mn[0], n1 = p.mn[1], n2 = p.mn[2];
  const long long total = n0 * n1 * n2;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  float m = 0.0f;
  if (DENSE4) {
    // one contiguous, 16-byte aligned run of n0 elements
    const float4* h4 = reinterpret_cast<const float4*>(hi);
    const long long nv = n0 / 4;
    for (long long j = tid; j < nv; j += stride) {
      const float4 a = __ldg(h4 + j);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)), fmaxf(fabsf(a.z), fabsf(a.w))));
    }
    for (long long j = 4 * nv + tid; j < n0; j += stride) m = fmaxf(m, fabsf(__ldg(hi + j)));
  } else {
    for (long long e = tid; e < total; e += stride) {
      const long long r = e / n0;
      const long long a0 = e - r * n0;
      const long long a2 = r / n1;
      const long long a1 = r - a2 * n1;
      m = fmaxf(m, fabsf(__ldg(hi + a0 * p.ms[0] + a1 * p.ms[1] + a2 * p.ms[2])));
    }
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
    partial[seg * gridDim.x + blockIdx.x] = m;
    __threadfence();
    const unsigned int t = atomicAdd(ticket + seg, 1u);
    last = t == gridDim.x - 1;
    if (last) ticket[seg] = 0u;   // ready for the next launch on this stream
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  m = 0.0f;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads)
    m = fmaxf(m, __ldcg(partial + seg * gridDim.x + j));
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
    p.pair_scale[blockIdx.z] = pow2ceil(m);
  }
}

}  // namespace

// The stage (see above). st: host pointer to a Stage (copied into the
// launch). mode: 0 row mode, 1 tile mode. vec_in = 1: row mode's 16-byte
// loads (16-byte aligned hi and lo with row strides % 4 == 0). store: 16, 8
// or 1 bytes (Kp % 16 == 0, Kp % 8 == 0, any). G: row mode's threads per
// row (a power of two <= 32, or a multiple of 32 <= 256), tile mode's
// threads per block (32 WC RG); WC: tile mode's warps along K (1, 2, 4 or
// 8), with tiles_inner and kblocks. nparts: 1 or 2. pairs: a batch's pairs
// (gridDim.z; 1 without one): the stage's sizes are one pair's, pair z's
// operand lies Part.pair_stride (lo: pair_stride_lo) elements past pair
// z - 1's, and its rows follow theirs. Returns cudaGetLastError().
extern "C" int sfft_slice_pairs(const void* st, int mode, int vec_in, int store, int G, int WC,
                                long long tiles_inner, int kblocks, long long blocks,
                                int nparts, int pairs, void* stream) {
  const Stage& a = *static_cast<const Stage*>(st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || blocks > 0x7fffffffLL || nparts < 1 || nparts > 2 || pairs < 1 ||
      pairs > 65535 || a.nsl < 1 || a.nsl > 16 || a.Kp < a.K)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)blocks, (unsigned)nparts, (unsigned)pairs);
  if (mode == 0) {
    const bool ok = G >= 1 && (G <= 32 ? (G & (G - 1)) == 0 : (G % 32 == 0 && G <= kRowThreads));
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = G <= 32 ? kThreads : G;
    const bool st8 = store >= 8;   // row mode: one 8-byte store per plane
#define ROW(V, S) pairs_row_kernel<V, S><<<grid, threads, 0, s>>>(a, G)
    if (vec_in && st8) ROW(true, true);
    else if (vec_in) ROW(true, false);
    else if (st8) ROW(false, true);
    else ROW(false, false);
#undef ROW
  } else {
    if ((WC != 1 && WC != 2 && WC != 4 && WC != 8) || G < 32 * WC || G > kThreads ||
        G % (32 * WC))
      return static_cast<int>(cudaErrorInvalidValue);
    if (store == 16) pairs_tile_kernel<16><<<grid, G, 0, s>>>(a, tiles_inner, kblocks, WC);
    else if (store == 8) pairs_tile_kernel<8><<<grid, G, 0, s>>>(a, tiles_inner, kblocks, WC);
    else pairs_tile_kernel<1><<<grid, G, 0, s>>>(a, tiles_inner, kblocks, WC);
  }
  return static_cast<int>(cudaGetLastError());
}

// The global scale of each part, or of each pair's part of it: max |hi|
// over the view (of one pair: hi's sizes and strides in Part.mn / Part.ms,
// ascending strides; dense4 = 1 when the view is one contiguous 16-byte
// aligned run, mn = (numel, 1, 1); pair z at hi + z * Part.pair_stride),
// rounded up to the power of two, written to Part.pair_scale[z]. partial:
// blocks * nparts * pairs floats; ticket: nparts * pairs zeroed unsigned ints
// (left zeroed).
extern "C" int sfft_slice_pairs_absmax(const void* st, int dense4, int blocks, int nparts,
                                       int pairs, void* partial, void* ticket, void* stream) {
  const Stage& a = *static_cast<const Stage*>(st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || nparts < 1 || nparts > 2 || pairs < 1 || pairs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)blocks, (unsigned)nparts, (unsigned)pairs);
  float* pa = static_cast<float*>(partial);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  if (dense4) absmax_kernel<true><<<grid, kThreads, 0, s>>>(a, pa, tk);
  else absmax_kernel<false><<<grid, kThreads, 0, s>>>(a, pa, tk);
  return static_cast<int>(cudaGetLastError());
}

// The rowwise scales of a tile-mode view (rowmax_tile_kernel; 32-row tiles,
// tiles_inner of them per outer index, K in kchunks chunks), written to each
// Part.scale_out. partial: nparts * n_outer * tiles_inner * kchunks * 32
// floats; ticket: nparts * n_outer * tiles_inner zeroed unsigned ints (left
// zeroed).
extern "C" int sfft_slice_pairs_rowmax(const void* st, long long tiles_inner, int kchunks,
                                       int nparts, void* partial, void* ticket, void* stream) {
  const Stage& a = *static_cast<const Stage*>(st);
  const long long blocks = a.n_outer * tiles_inner * kchunks;
  if (kchunks < 1 || blocks < 1 || blocks > 0x7fffffffLL || nparts < 1 || nparts > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  rowmax_tile_kernel<<<dim3((unsigned)blocks, (unsigned)nparts), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, tiles_inner, kchunks, static_cast<float*>(partial), static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}
