// K4 — integer slicing of f32 (hi, lo) pairs on Hopper.
//
// Replaces: sfft_tpu/core/pallas_slice.py, slice_pair_real / _mk_kernel, the
// Pallas twin of sfft_tpu/core/exact_fft.py _slice_pair_real(int8=True); and
// with it the TPU timing prototypes of tools/diag_slice_cost.py and
// tools/diag_slice_cost2.py, which compute the same function. The sliced
// exact engine (sfft_tpu_torch/core/exact_fft.py) writes every f32 pair
// operand of its int8 matrix products as nsl 6-bit slices under a
// power-of-two scale s:
//
//   canonicalise  h2 = hi + lo,  l2 = lo - (h2 - hi)        (TwoSum, |lo|<=|hi|)
//   r = h2 / s;   for q < nsl:  p = rint(r * 2^(6(q+1)));  out[q] = p;
//                               r -= p / 2^(6(q+1));
//                               after slice kInject: r += l2 / s
//
// Every product is by a power of two and every subtraction is exact
// (Sterbenz), so the slices are bit-identical to the plain twin
// (core/slicing.py slice_pair_plain) and to sfft_tpu's XLA chain. That
// needs IEEE rounding of the two additions and round-half-to-even: the
// arithmetic goes through the _rn intrinsics and rintf (never roundf), and
// the build takes no fast-math flag (which would flush denormal remainders
// to zero). The divisions by s and by 2^(6(q+1)) are multiplications by
// the exact reciprocal powers of two: the same real quotient, rounded once,
// so the same bits as the twin's division (also where it underflows).
//
// Shapes: hi, lo contiguous f32 with n elements, rows of K elements; scale
// f32 with one value per row (rowwise) or one value; out (nsl, n) int8.
//
// What bounds it: bytes. Each element reads 8 bytes and writes nsl bytes
// (16 B at nsl = 8: 134 MB for a (4096, 2049) lane set), for ~4 nsl + 6 f32
// operations. Design: a grid-stride loop; with V = 4 a thread loads float4s
// of hi and lo and stores one char4 per slice plane, so every access is a
// coalesced 16- or 4-byte transaction. Indices are 32-bit when the operand
// has fewer than 2^31 elements (the row of an element is then one 32-bit
// division). The scale is read from device memory (computed beforehand on
// the device), so nothing synchronises with the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNB = 6;                          // bits per slice
constexpr int kInject = (24 + kNB - 1) / kNB;   // f32 hi consumed after 4 slices
constexpr float kStep = float(1 << kNB);        // 2^NB
constexpr int kThreads = 256;

template <int V, typename Idx>
__global__ void __launch_bounds__(kThreads)
slice_pair_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                  const float* __restrict__ scale, int8_t* __restrict__ out,
                  Idx n, Idx K, int rowwise, int nsl) {
  const Idx nv = n / V;
  const Idx stride = (Idx)gridDim.x * blockDim.x;
  for (Idx j = (Idx)blockIdx.x * blockDim.x + threadIdx.x; j < nv; j += stride) {
    const Idx i0 = j * V;
    float h[V], l[V];
    if (V == 4) {
      const float4 a = reinterpret_cast<const float4*>(hi)[j];
      const float4 b = reinterpret_cast<const float4*>(lo)[j];
      h[0] = a.x; h[1] = a.y; h[2] = a.z; h[3] = a.w;
      l[0] = b.x; l[1] = b.y; l[2] = b.z; l[3] = b.w;
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) { h[v] = hi[i0 + v]; l[v] = lo[i0 + v]; }
    }
    // with V = 4 the wrapper guarantees K % 4 == 0 for rowwise scales, so
    // the V elements share one row
    const float inv_s = __frcp_rn(__ldg(scale + (rowwise ? i0 / K : 0)));
    float r[V], lr[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float h2 = __fadd_rn(h[v], l[v]);
      const float l2 = __fsub_rn(l[v], __fsub_rn(h2, h[v]));
      r[v] = __fmul_rn(h2, inv_s);
      lr[v] = __fmul_rn(l2, inv_s);
    }
    float sc = 1.0f, inv_sc = 1.0f;
    for (int q = 0; q < nsl; ++q) {
      sc = __fmul_rn(sc, kStep);
      inv_sc = __fmul_rn(inv_sc, 1.0f / kStep);
      int8_t p8[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float p = rintf(__fmul_rn(r[v], sc));
        p8[v] = static_cast<int8_t>(static_cast<int>(p));
        r[v] = __fsub_rn(r[v], __fmul_rn(p, inv_sc));
        if (q == kInject - 1) r[v] = __fadd_rn(r[v], lr[v]);
      }
      int8_t* o = out + (size_t)q * (size_t)n + i0;
      if (V == 4) {
        *reinterpret_cast<char4*>(o) = make_char4(p8[0], p8[1], p8[2], p8[3]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = p8[v];
      }
    }
  }
}

}  // namespace

// hi, lo (n) f32, scale (n / K rows, or 1) f32, out (nsl, n) int8: device
// pointers. vec = 4 needs n % 4 == 0, 16-byte aligned hi and lo, and
// K % 4 == 0 when rowwise; vec = 1 takes any layout. Returns
// cudaGetLastError().
extern "C" int sfft_slice_pair_f32(const void* hi, const void* lo, const void* scale,
                                   void* out, long long n, long long K, int rowwise,
                                   int nsl, int vec, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hi);
  const float* l = static_cast<const float*>(lo);
  const float* s = static_cast<const float*>(scale);
  int8_t* o = static_cast<int8_t*>(out);
  const bool narrow = n < (1LL << 31);  // j + stride stays below 2^32
  if (vec == 4 && narrow) {
    slice_pair_kernel<4, unsigned><<<blocks, kThreads, 0, st>>>(
        h, l, s, o, (unsigned)n, (unsigned)K, rowwise, nsl);
  } else if (vec == 4) {
    slice_pair_kernel<4, long long><<<blocks, kThreads, 0, st>>>(h, l, s, o, n, K, rowwise, nsl);
  } else if (vec == 1 && narrow) {
    slice_pair_kernel<1, unsigned><<<blocks, kThreads, 0, st>>>(
        h, l, s, o, (unsigned)n, (unsigned)K, rowwise, nsl);
  } else if (vec == 1) {
    slice_pair_kernel<1, long long><<<blocks, kThreads, 0, st>>>(h, l, s, o, n, K, rowwise, nsl);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
