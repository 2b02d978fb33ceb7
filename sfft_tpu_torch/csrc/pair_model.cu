// K6m — the exact difference's model spectrum, on Hopper.
//
// Replaces: the model loop of the exact differences, an XLA stage on the TPU
// (sfft_tpu/core/pexact.py:371-409 in fdiff_pexact, sfft_tpu/core/fdiff.py:217-261
// in fdiff_exact): for each element (u, v) of the half spectrum
//
//   acc = sum_i  sp[1+i] * conj(conj(K_i + c_i))      i < Fk, in i's order
//       + sum_s  sp[1+Fk+s] * a00_s                  s < nss (SEPARATE-VARYING)
//   FD  = (sp[0] - SCALE * acc) * fold[v]
//
// in f32 pair arithmetic: K_i + c_i by TwoSum on the real hi lane (c_i an
// f64 scalar split into an f32 pair), the product by pairs::hadamard_conj
// with the conjugate's lanes negated, the sums by compensated pair addition,
// a00_s and SCALE by TwoProd on each hi lane, the subtraction by TwoSum, the
// fold (1 or 2) exact. Run op by op it is ~100 eager launches per ij. The
// plain twin is sfft_tpu_torch/core/pairs.py pair_model_spectrum_plain; the
// kernel follows it term for term (pair_arith.cuh), bit for bit.
//
// The scalars stay on the device: c and a00 are read as f64 and split with
// __double2float_rn as the twin's .to(float32) rounds, SCALE's (hi, lo) and
// the fold weights are read from their tensors; nothing goes to the host.
//
// A batch of image pairs (the batched step) runs in one launch: the pair is
// the grid's y index, with its own planes (a pair stride on sp and K), its
// own scalars c and a00 and its own output plane; each pair's spectrum is
// its single launch's.
//
// What bounds it: bytes. An element reads (1 + Fk + nss) plane-spectrum
// pairs and Fk kernel-spectrum pairs, 16 bytes each, and writes 16, for
// ~120 f32 operations per ij. Design (simple first): one thread per element
// loops over ij in registers, so every plane is read once and the
// accumulator never leaves the thread; consecutive threads on consecutive
// columns, so each plane's loads coalesce along the row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_arith.cuh"

namespace {

constexpr int kThreads = 256;

// The launch of one call; sfft_tpu_torch/core/pairs.py _PMArgs mirrors it.
struct PM {
  const float* sp[4];       // plane spectra ([B,] P, N0, N1h): rh, rl, ih, il
  const float* k[4];        // kernel spectra ([B,] Fk, N0, N1h)
  const double* c;          // ([B,] Fk) shifts of K_i
  const double* a00;        // ([B,] nss) weights of the scaling planes, or null
  const float* scale[2];    // SCALE as (hi, lo), 0-d tensors
  const float* fold;        // (N1h,) fold weights, or null
  float* out[4];            // contiguous ([B,] N0, N1h)
  long long sps[4];         // element strides of sp: pair, plane, row, column
  long long ks[4];          // of K
  int N0, N1h, Fk, nss;
};

__device__ __forceinline__ void split64(double c, float& c32, float& cres) {
  c32 = __double2float_rn(c);
  cres = __double2float_rn(__dsub_rn(c, static_cast<double>(c32)));
}

__device__ __forceinline__ pairs::Cx load(const float* const* P, long long off) {
  return {__ldg(P[0] + off), __ldg(P[1] + off), __ldg(P[2] + off), __ldg(P[3] + off)};
}

__global__ void __launch_bounds__(kThreads) pair_model_kernel(const PM m) {
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  const unsigned plane = static_cast<unsigned>(m.N0) * static_cast<unsigned>(m.N1h);
  if (e >= plane) return;
  const long long z = blockIdx.y;   // the pair of a batch
  const unsigned u = e / static_cast<unsigned>(m.N1h);
  const unsigned v = e - u * static_cast<unsigned>(m.N1h);
  const long long osp = z * m.sps[0] + u * m.sps[2] + v * m.sps[3];
  const long long ok = z * m.ks[0] + u * m.ks[2] + v * m.ks[3];
  const double* c = m.c + z * m.Fk;
  const double* a00 = m.a00 + z * m.nss;
  using pairs::Cx;
  Cx acc;
  for (int i = 0; i < m.Fk; ++i) {
    const Cx A = load(m.sp, osp + (1 + i) * m.sps[1]);
    const Cx K = load(m.k, ok + i * m.ks[1]);
    float c32, cres;
    split64(__ldg(c + i), c32, cres);
    // B = conj(K + c): the shift on the real hi lane, lanes of the
    // imaginary part negated (exact)
    Cx B;
    float es;
    pairs::two_sum(K.rh, c32, B.rh, es);
    B.rl = pairs::add(pairs::add(K.rl, es), cres);
    B.ih = -K.ih;
    B.il = -K.il;
    const Cx t = pairs::hadamard_conj(A, B);
    if (i == 0) {
      acc = t;
    } else {
      pairs::addp(acc, t);
    }
  }
  for (int s = 0; s < m.nss; ++s) {
    const Cx P = load(m.sp, osp + (1 + m.Fk + s) * m.sps[1]);
    float a32, ares;
    split64(__ldg(a00 + s), a32, ares);
    Cx t;
    pairs::scale_rr(P.rh, P.rl, a32, ares, t.rh, t.rl);
    pairs::scale_rr(P.ih, P.il, a32, ares, t.ih, t.il);
    pairs::addp(acc, t);
  }
  const float s32 = __ldg(m.scale[0]), sres = __ldg(m.scale[1]);
  Cx md;
  pairs::scale_rr(acc.rh, acc.rl, s32, sres, md.rh, md.rl);
  pairs::scale_rr(acc.ih, acc.il, s32, sres, md.ih, md.il);
  const Cx J = load(m.sp, osp);
  float dr, er, di, ei;
  pairs::two_sum(J.rh, -md.rh, dr, er);
  pairs::two_sum(J.ih, -md.ih, di, ei);
  float out[4] = {dr, pairs::add(pairs::sub(J.rl, md.rl), er), di,
                  pairs::add(pairs::sub(J.il, md.il), ei)};
  if (m.fold != nullptr) {
    const float w = __ldg(m.fold + v);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = pairs::mul(out[k], w);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) m.out[k][z * plane + e] = out[k];
}

}  // namespace

// pairs: the batch's image pairs (1 without a pair axis), at most 65535.
extern "C" int sfft_pair_model(const void* args, int pairs, void* stream_ptr) {
  const PM& m = *static_cast<const PM*>(args);
  const unsigned n = static_cast<unsigned>(m.N0) * static_cast<unsigned>(m.N1h);
  if (n == 0) return cudaSuccess;
  if (pairs < 1 || pairs > 65535) return cudaErrorInvalidValue;
  pair_model_kernel<<<dim3((n + kThreads - 1) / kThreads, pairs), kThreads, 0,
                      static_cast<cudaStream_t>(stream_ptr)>>>(m);
  return cudaGetLastError();
}
