// K6a — the exact paths' elementwise pair products, on Hopper.
//
// Replaces: the f32 pair products of sfft_tpu/core/exact_fft.py, which XLA
// fused into the passes around them on the TPU: _pair_hadamard_conj (:963;
// A * conj(B) of two spectra in exact_corr_window), _pair_mul_static (:609;
// the twiddles between the two stages of exact_dft_axis and
// exact_idft_halfin_real), _pair_mul_static_rr (:629; basis rows, the row
// weighting of exact_sep_weighted_spectra, a scalar) and pair_sep_mul (:644;
// two of those chained). Run op by op they are ~15 eager launches per
// TwoProd. The plain twin is sfft_tpu_torch/core/pairs.py
// pair_products_plain.
//
// Modes (PP.mode): 0 A * conj(B), both complex pairs; 1 complex A times a
// static complex table B; 2 real A times a real table B; 3 both lanes of a
// complex A times a real table B; 4 (real A * B) * C with real tables B, C
// (the intermediate pair is f32 in registers, as it is between the twin's
// two launches, so the bits are the same).
//
// Operands: each operand's planes (hi, lo[, imaginary hi, lo]) share one
// set of element strides, broadcast into the output shape (stride 0 along a
// broadcast axis); the wrapper drops extent-1 axes and merges the axes along
// which every operand runs on, so most calls index one or two axes. The
// output planes are fresh and dense, in A's layout where A spans them (the
// axes are ordered as they lie in memory, so element e is written at e);
// nothing is written in place.
//
// What bounds it: bytes. An element reads 8 f32 values and writes 4 (modes
// 0, 1; a broadcast table is read from cache), for ~94 f32 operations; the
// real modes read 4 and write 2 for 21 (42). Design (simple first): one
// thread per output element, consecutive threads on consecutive elements,
// so loads along the innermost axis and all stores coalesce; every load of
// a thread is independent of the arithmetic and issued first. Element
// indices are 32-bit (the output has fewer than 2^31 elements), offsets
// 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_arith.cuh"

namespace {

constexpr int kThreads = 256;

// The launch of one call; sfft_tpu_torch/core/pairs.py _PPArgs mirrors it.
struct PP {
  const float* a[4];      // A: rh, rl, ih, il (ih, il null for a real pair)
  const float* b[4];      // B likewise
  const float* c[2];      // C (mode 4): hi, lo
  float* out[4];          // dense output planes, element e at e
  long long sa[4];        // per axis (innermost first): element strides of A
  long long sb[4];
  long long sc[4];
  unsigned size[4];       // the collapsed output shape, innermost first
  unsigned n;             // output elements
  int nd;                 // axes in use (1-4)
  int mode;
};

template <int MODE, int ND>
__global__ void __launch_bounds__(kThreads) pair_products_kernel(const PP p) {
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= p.n) return;
  long long oa = 0, ob = 0, oc = 0;
  unsigned r = e;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    unsigned i = r;
    if (d < ND - 1) {
      i = r % p.size[d];
      r /= p.size[d];
    }
    oa += static_cast<long long>(i) * p.sa[d];
    ob += static_cast<long long>(i) * p.sb[d];
    if (MODE == 4) oc += static_cast<long long>(i) * p.sc[d];
  }
  using pairs::Cx;
  if (MODE == 0 || MODE == 1) {
    const Cx A = {__ldg(p.a[0] + oa), __ldg(p.a[1] + oa), __ldg(p.a[2] + oa),
                  __ldg(p.a[3] + oa)};
    const Cx B = {__ldg(p.b[0] + ob), __ldg(p.b[1] + ob), __ldg(p.b[2] + ob),
                  __ldg(p.b[3] + ob)};
    const Cx h = MODE == 0 ? pairs::hadamard_conj(A, B) : pairs::mul_static(A, B);
    p.out[0][e] = h.rh;
    p.out[1][e] = h.rl;
    p.out[2][e] = h.ih;
    p.out[3][e] = h.il;
  } else if (MODE == 2 || MODE == 4) {
    const float h = __ldg(p.a[0] + oa), l = __ldg(p.a[1] + oa);
    const float wh = __ldg(p.b[0] + ob), wl = __ldg(p.b[1] + ob);
    float ph, pl;
    pairs::mul_rr(h, l, wh, wl, ph, pl);
    if (MODE == 4) {
      const float vh = __ldg(p.c[0] + oc), vl = __ldg(p.c[1] + oc);
      const float qh = ph, ql = pl;
      pairs::mul_rr(qh, ql, vh, vl, ph, pl);
    }
    p.out[0][e] = ph;
    p.out[1][e] = pl;
  } else {  // MODE 3: both lanes by one real factor
    const float rh = __ldg(p.a[0] + oa), rl = __ldg(p.a[1] + oa);
    const float ih = __ldg(p.a[2] + oa), il = __ldg(p.a[3] + oa);
    const float wh = __ldg(p.b[0] + ob), wl = __ldg(p.b[1] + ob);
    float h, l;
    pairs::mul_rr(rh, rl, wh, wl, h, l);
    p.out[0][e] = h;
    p.out[1][e] = l;
    pairs::mul_rr(ih, il, wh, wl, h, l);
    p.out[2][e] = h;
    p.out[3][e] = l;
  }
}

template <int MODE>
cudaError_t launch_mode(const PP& p, cudaStream_t stream) {
  const unsigned blocks = (p.n + kThreads - 1) / kThreads;
  switch (p.nd) {
    case 1: pair_products_kernel<MODE, 1><<<blocks, kThreads, 0, stream>>>(p); break;
    case 2: pair_products_kernel<MODE, 2><<<blocks, kThreads, 0, stream>>>(p); break;
    case 3: pair_products_kernel<MODE, 3><<<blocks, kThreads, 0, stream>>>(p); break;
    case 4: pair_products_kernel<MODE, 4><<<blocks, kThreads, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int sfft_pair_products(const void* args, void* stream_ptr) {
  const PP& p = *static_cast<const PP*>(args);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (p.n == 0) return cudaSuccess;
  switch (p.mode) {
    case 0: return launch_mode<0>(p, stream);
    case 1: return launch_mode<1>(p, stream);
    case 2: return launch_mode<2>(p, stream);
    case 3: return launch_mode<3>(p, stream);
    case 4: return launch_mode<4>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}
