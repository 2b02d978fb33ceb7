// K5 — integer slicing of exact f32 (hi, mid, lo) triples on Hopper.
//
// Replaces: sfft_tpu/core/pallas_slice.py, slice_triple_real /
// _mk_kernel_triple, the Pallas twin of sfft_tpu/core/exact_fft.py
// _slice_triple_real. The large f64 solve (sfft_tpu_torch/core/solve.py,
// _refined_solve_f64) writes its equilibrated matrix and every refinement
// vector as an exact three-way f32 split of the f64 values (~72 bits) and
// slices it into nsl >= 8 (12 on the path) 6-bit integer planes under a
// power-of-two scale s:
//
//   r = hi / s;  carry = 0
//   for q < nsl:  p = rint(r * 2^(6(q+1)));  out[q] = p;  r -= p / 2^(6(q+1))
//     after slice 4:  b = mid / s;  (t, carry) = TwoSum(r, b);  r = t
//     after slice 8:  r += lo / s + carry
//
// The TwoSum keeps the rounding of r + mid/s (~2^-48 s) as a carry and
// defers it to the lo injection, where the sum rounds at 2^-72 s; a plain
// add at slice 4 would floor the representation at 2^-48 s. That needs
// IEEE rounding and the written order of every operation: the arithmetic
// goes through the _rn intrinsics (never contracted into an FMA, never
// reassociated) and rintf (round half to even), and the build takes no
// fast-math flag, so the subnormal lo parts of an exact split are not
// flushed to zero. Divisions by s and by 2^(6(q+1)) are multiplications by
// the exact reciprocal powers of two (the same real quotient rounded once:
// the twin's bits). The result is bit-identical to the plain twin
// (core/slicing.py slice_triple_plain) and to sfft_tpu's XLA chain. A row
// of zeros has the scale the caller clamps away from zero, so its slices
// are zeros, not NaN.
//
// Shapes: hi, mid, lo contiguous f32 (rows, K); scale f32 with one value
// per row (rowwise) or one value; out (nsl, rows, ldo) int8 with ldo >= K:
// the output row stride lets the slices land in the zero-padded buffer the
// int8 product reads (depth a multiple of 8), without a 2 GB pad copy at
// (13207, 13207) -> 13208.
//
// What bounds it: bytes. Each element reads 12 bytes and writes nsl bytes
// (24 B at nsl = 12: 4.19 GB for the (13207, 13207) matrix) for ~4 nsl + 12
// f32 operations. Design: one thread takes 4 neighbouring columns of one
// row. The path's row width is odd (13207), so its input rows are not
// 16-byte aligned: those loads are 4-byte loads (a warp still covers one
// contiguous 512-byte span per operand); aligned inputs load float4. The
// output row stride is the caller's choice, and with a multiple of 4 every
// plane takes one aligned char4 store per thread, the group's pad columns
// written as zeros. Indices are 32-bit when rows * groups fits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNB = 6;                          // bits per slice
constexpr int kInject = (24 + kNB - 1) / kNB;   // an f32 part is consumed after 4 slices
constexpr float kStep = float(1 << kNB);        // 2^NB
constexpr int kThreads = 256;
constexpr int kV = 4;                           // columns per thread

template <bool VIN, bool VOUT, typename Idx>
__global__ void __launch_bounds__(kThreads)
slice_triple_kernel(const float* __restrict__ hi, const float* __restrict__ mid,
                    const float* __restrict__ lo, const float* __restrict__ scale,
                    int8_t* __restrict__ out, Idx rows, Idx K, Idx ldo, int rowwise,
                    int nsl) {
  const Idx groups = (K + kV - 1) / kV;
  const Idx total = rows * groups;
  const Idx stride = (Idx)gridDim.x * blockDim.x;
  const size_t plane = (size_t)rows * (size_t)ldo;
  for (Idx j = (Idx)blockIdx.x * blockDim.x + threadIdx.x; j < total; j += stride) {
    const Idx row = j / groups;
    const Idx c0 = (j - row * groups) * kV;
    const size_t in0 = (size_t)row * (size_t)K + c0;
    const int nv = (K - c0) < (Idx)kV ? (int)(K - c0) : kV;   // live columns
    float h[kV], m[kV], l[kV];
    if (VIN) {
      // K % 4 == 0 and 16-byte aligned operands: the group is whole
      const float4 a = *reinterpret_cast<const float4*>(hi + in0);
      const float4 b = *reinterpret_cast<const float4*>(mid + in0);
      const float4 c = *reinterpret_cast<const float4*>(lo + in0);
      h[0] = a.x; h[1] = a.y; h[2] = a.z; h[3] = a.w;
      m[0] = b.x; m[1] = b.y; m[2] = b.z; m[3] = b.w;
      l[0] = c.x; l[1] = c.y; l[2] = c.z; l[3] = c.w;
    } else {
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const bool live = v < nv;
        h[v] = live ? hi[in0 + v] : 0.0f;
        m[v] = live ? mid[in0 + v] : 0.0f;
        l[v] = live ? lo[in0 + v] : 0.0f;
      }
    }
    const float inv_s = __frcp_rn(__ldg(scale + (rowwise ? row : 0)));
    float r[kV], carry[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      r[v] = __fmul_rn(h[v], inv_s);
      carry[v] = 0.0f;
    }
    float sc = 1.0f, inv_sc = 1.0f;
    int8_t* o = out + (size_t)row * (size_t)ldo + c0;
    for (int q = 0; q < nsl; ++q) {
      sc = __fmul_rn(sc, kStep);
      inv_sc = __fmul_rn(inv_sc, 1.0f / kStep);
      int8_t p8[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const float p = rintf(__fmul_rn(r[v], sc));
        p8[v] = static_cast<int8_t>(static_cast<int>(p));
        float rr = __fsub_rn(r[v], __fmul_rn(p, inv_sc));
        if (q == kInject - 1) {
          // TwoSum(rr, mid / s): t + carry == rr + b exactly
          const float b = __fmul_rn(m[v], inv_s);
          const float t = __fadd_rn(rr, b);
          const float w = __fsub_rn(t, rr);
          carry[v] = __fadd_rn(__fsub_rn(rr, __fsub_rn(t, w)), __fsub_rn(b, w));
          rr = t;
        }
        if (q == 2 * kInject - 1) {
          rr = __fadd_rn(rr, __fadd_rn(__fmul_rn(l[v], inv_s), carry[v]));
        }
        r[v] = rr;
      }
      if (VOUT) {
        // ldo % 4 == 0: the group's 4 bytes are aligned and inside the row
        // (dead columns carry zeros: they are pad columns of the output)
        *reinterpret_cast<char4*>(o) = make_char4(p8[0], p8[1], p8[2], p8[3]);
      } else {
#pragma unroll
        for (int v = 0; v < kV; ++v)
          if (v < nv) o[v] = p8[v];
      }
      o += plane;
    }
  }
}

template <typename Idx>
void launch(const float* h, const float* m, const float* l, const float* s, int8_t* o,
            long long rows, long long K, long long ldo, int rowwise, int nsl, int vec_in,
            int vec_out, int blocks, cudaStream_t st) {
  const Idx r = (Idx)rows, k = (Idx)K, d = (Idx)ldo;
  if (vec_in == 4 && vec_out == 4)
    slice_triple_kernel<true, true, Idx><<<blocks, kThreads, 0, st>>>(h, m, l, s, o, r, k, d, rowwise, nsl);
  else if (vec_in == 4)
    slice_triple_kernel<true, false, Idx><<<blocks, kThreads, 0, st>>>(h, m, l, s, o, r, k, d, rowwise, nsl);
  else if (vec_out == 4)
    slice_triple_kernel<false, true, Idx><<<blocks, kThreads, 0, st>>>(h, m, l, s, o, r, k, d, rowwise, nsl);
  else
    slice_triple_kernel<false, false, Idx><<<blocks, kThreads, 0, st>>>(h, m, l, s, o, r, k, d, rowwise, nsl);
}

}  // namespace

// hi, mid, lo (rows, K) f32, scale (rows or 1) f32, out (nsl, rows, ldo) int8:
// device pointers. vec_in = 4 needs K % 4 == 0 and 16-byte aligned hi, mid and
// lo; vec_out = 4 needs ldo % 4 == 0 and a 4-byte aligned out, and then writes
// zeros to columns K .. 4 ceil(K / 4) - 1; 1 takes any layout. Returns
// cudaGetLastError().
extern "C" int sfft_slice_triple_f32(const void* hi, const void* mid, const void* lo,
                                     const void* scale, void* out, long long rows,
                                     long long K, long long ldo, int rowwise, int nsl,
                                     int vec_in, int vec_out, int blocks, void* stream) {
  if ((vec_in != 1 && vec_in != 4) || (vec_out != 1 && vec_out != 4) || K < 1 || ldo < K ||
      nsl < 2 * kInject)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hi);
  const float* m = static_cast<const float*>(mid);
  const float* l = static_cast<const float*>(lo);
  const float* s = static_cast<const float*>(scale);
  int8_t* o = static_cast<int8_t*>(out);
  const long long groups = (K + kV - 1) / kV;
  // j + stride must stay below 2^32, and K and ldo fit 32 bits
  if (rows * groups < (1LL << 31) && ldo < (1LL << 31))
    launch<unsigned>(h, m, l, s, o, rows, K, ldo, rowwise, nsl, vec_in, vec_out, blocks, st);
  else
    launch<long long>(h, m, l, s, o, rows, K, ldo, rowwise, nsl, vec_in, vec_out, blocks, st);
  return static_cast<int>(cudaGetLastError());
}
