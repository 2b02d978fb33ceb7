// K7 — the epilogue of the exact-grade int8 sliced product, on Hopper.
//
// Replaces: the XLA stage of sfft_tpu/core/exact_fft.py that follows the
// int8 slice products of one _cmatmul_sliced call: _sliced_dot_multi (:392;
// the deep route's per-group combo sums) -> _accum (:372) -> _chain (:139),
// the scale, and the complex recombination of _cmatmul_sliced (:512-578).
// On the TPU XLA fused it into one pass; run op by op it is ~100-220 launches
// per call. Its plain twin is sfft_tpu_torch/core/exact_fft.py
// sliced_epilogue_plain (the chain the port ran before).
//
// For every output element (row, col) and every term t of the complex
// product (rr = dr.wr, ri = dr.wi, ir = di.wr, ii = di.wi; a real operand
// or table has fewer):
//
//   x_g = sum over the combos (slab, offset) of group g of
//         prod[d_t][slab][row][base_t + offset + col]      (int32, exact)
//   split (sums past f32's exact-integer range): x_g -> (x_g >> 12) << 12
//         and the remainder, both exact in f32
//   chain: the f32 values times the power-of-two weight of their group, in
//         group order; the groups whose weight exceeds 2^-24 of the first
//         one through TwoSum (h, and the errors summed into lo from +0), the
//         rest summed plainly into a tail that joins lo; then h2 = h + lo,
//         l2 = lo - (h2 - h)
//   scale: sc = s_d (one value, or the row's) * s_w (a value, or a device
//         scalar); (h2 sc, l2 sc)
//   recombine: re = rr - ii, im = ri + ir by TwoSum (lo parts added, then
//         the TwoSum's error); or re only (real_out); or (rr, ri) as they are
//         for real data.
//
// Bit for bit with the twin: every operation is one IEEE f32 operation
// rounded to nearest, in the twin's order, through the _rn intrinsics, which
// nvcc never contracts into an FMA; the build takes no fast-math flag and no
// -ftz. Products by the power-of-two weights (down to 2^-60) and scales are
// exact. Absent terms are +0, as the twin's zeros_like.
//
// What bounds it: bytes. An element reads G (shallow route) or the combos of
// every group (deep route) int32 values per term and writes 2 or 4 f32
// values, for ~10 f32 operations per value read. Design (simple first): one
// thread per output element, consecutive threads on consecutive columns of
// a row, so each term's loads are coalesced along the row. The kernel is
// instantiated per number of weight groups (1-9) and split, so the group
// loop unrolls to exactly the loads and chain steps the call needs: a thread
// has all of a term's loads in flight before its chain needs the first. (The
// first version unrolled 9 groups x 9 combos under predicates, ~2,000
// instructions an element for the 28 loads of a shallow complex call, and
// ran at a third of its bound.) Element indices are 32-bit (rows * M <
// 2^31), product offsets 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroups = 9;   // weight groups s = 0..kmax, kmax <= 8
constexpr int kMaxCombos = 9;   // slice combos of one group (<= min(nsl_d, nsl_w))
constexpr int kThreads = 256;

// The plan of one call; sfft_tpu_torch/core/exact_fft.py _EpiArgs mirrors it.
struct Epi {
  const int32_t* prod[2];        // per data part: the int32 slice products
  const float* sd[2];            // per data part: its scale (one, or one per row)
  const float* swp[4];           // per term: its static scale on the device, or null
  float* out[4];                 // output planes (rows, M)
  long long off[kMaxGroups][kMaxCombos];   // element offset of each combo's slab column
  long long row_stride;          // elements between product rows
  long long rows;
  float w[kMaxGroups];           // the groups' power-of-two weights
  float swv[4];                  // per term: its static scale given by value
  int ncombo[kMaxGroups];
  int term_d[4];                 // per term (rr, ri, ir, ii): data part, or -1 if absent
  int term_base[4];              // per term: first column of its static part
  int M;
  int ngroups;
  int nbig;                      // leading groups in the compensated part
  int split;
  int sd_rowwise;
  int mode;                      // 0 real data, 1 complex, 2 complex real_out
};

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float v = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, v)), __fsub_rn(b, v));
}

// The int32 sum of group g at one element: its one slab value (the shallow
// route) or its combos in order (the deep route; a warp-uniform branch).
__device__ __forceinline__ int32_t group_sum(const Epi& a, const int32_t* p, int g) {
  if (a.ncombo[g] == 1) return __ldg(p + a.off[g][0]);
  int32_t s = 0;
  for (int k = 0; k < a.ncombo[g]; ++k) s += __ldg(p + a.off[g][k]);
  return s;
}

// One term's (hi, lo) at (row, col), scaled; NG weight groups, SPLIT the
// 2^12 split. The loads of all groups are issued before the chain needs
// the first.
template <int NG, bool SPLIT>
__device__ __forceinline__ void term_value(const Epi& a, int t, unsigned row, unsigned col,
                                           float& hi, float& lo) {
  const int d = a.term_d[t];
  const int32_t* p = a.prod[d] + static_cast<long long>(row) * a.row_stride + a.term_base[t] +
                     col;
  int32_t x[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) x[g] = group_sum(a, p, g);
  // the first big term starts h, the first small one the tail (nbig >= 1)
  float h = 0.0f, l = 0.0f, tail = 0.0f;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    float v[2];
    if (SPLIT) {
      const int32_t top = (x[g] >> 12) << 12;
      v[0] = __int2float_rn(top);
      v[1] = __int2float_rn(x[g] - top);
    } else {
      v[0] = __int2float_rn(x[g]);
      v[1] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < (SPLIT ? 2 : 1); ++k) {
      const float gw = __fmul_rn(v[k], a.w[g]);
      if (g < a.nbig) {
        if (g == 0 && k == 0) {
          h = gw;
        } else {
          float e;
          two_sum(h, gw, h, e);
          l = __fadd_rn(l, e);
        }
      } else if (g == a.nbig && k == 0) {
        tail = gw;
      } else {
        tail = __fadd_rn(tail, gw);
      }
    }
  }
  if (NG > a.nbig) l = __fadd_rn(l, tail);
  const float h2 = __fadd_rn(h, l);
  const float l2 = __fsub_rn(l, __fsub_rn(h2, h));
  const float* sdp = a.sd[d] + (a.sd_rowwise ? row : 0u);
  const float sw = a.swp[t] ? *a.swp[t] : a.swv[t];
  const float sc = __fmul_rn(*sdp, sw);
  hi = __fmul_rn(h2, sc);
  lo = __fmul_rn(l2, sc);
}

template <int NG, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    sliced_epilogue_kernel(const __grid_constant__ Epi a) {
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= static_cast<unsigned>(a.rows) * static_cast<unsigned>(a.M)) return;
  const unsigned row = e / static_cast<unsigned>(a.M);
  const unsigned col = e - row * static_cast<unsigned>(a.M);
  float h[4], l[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    h[t] = 0.0f;
    l[t] = 0.0f;
    if (a.term_d[t] >= 0) term_value<NG, SPLIT>(a, t, row, col, h[t], l[t]);
  }
  // terms: 0 rr, 1 ri, 2 ir, 3 ii
  if (a.mode == 0) {
    a.out[0][e] = h[0];
    a.out[1][e] = l[0];
    a.out[2][e] = h[1];
    a.out[3][e] = l[1];
    return;
  }
  float zr, e1;
  two_sum(h[0], -h[3], zr, e1);
  a.out[0][e] = zr;
  a.out[1][e] = __fadd_rn(__fsub_rn(l[0], l[3]), e1);
  if (a.mode == 2) return;
  float zi, e2;
  two_sum(h[1], h[2], zi, e2);
  a.out[2][e] = zi;
  a.out[3][e] = __fadd_rn(__fadd_rn(l[1], l[2]), e2);
}

template <int NG>
void launch_ng(const Epi& a, unsigned blocks, cudaStream_t st) {
  if (a.split)
    sliced_epilogue_kernel<NG, true><<<blocks, kThreads, 0, st>>>(a);
  else
    sliced_epilogue_kernel<NG, false><<<blocks, kThreads, 0, st>>>(a);
}

}  // namespace

// epi: a host pointer to the call's Epi (copied into the launch's
// parameters). One launch on `stream`; returns cudaGetLastError().
extern "C" int sfft_sliced_epilogue(const void* epi, void* stream) {
  const Epi& a = *static_cast<const Epi*>(epi);
  if (a.rows < 1 || a.M < 1 || a.rows * a.M >= (1LL << 31) || a.ngroups < 1 ||
      a.ngroups > kMaxGroups || a.nbig < 1 || a.nbig > a.ngroups || a.mode < 0 ||
      a.mode > 2 || a.term_d[0] < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int g = 0; g < a.ngroups; ++g)
    if (a.ncombo[g] < 1 || a.ncombo[g] > kMaxCombos)
      return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((a.rows * a.M + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.ngroups) {
    case 1: launch_ng<1>(a, blocks, st); break;
    case 2: launch_ng<2>(a, blocks, st); break;
    case 3: launch_ng<3>(a, blocks, st); break;
    case 4: launch_ng<4>(a, blocks, st); break;
    case 5: launch_ng<5>(a, blocks, st); break;
    case 6: launch_ng<6>(a, blocks, st); break;
    case 7: launch_ng<7>(a, blocks, st); break;
    case 8: launch_ng<8>(a, blocks, st); break;
    default: launch_ng<9>(a, blocks, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
