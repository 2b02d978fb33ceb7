// The f32 pair arithmetic of the exact paths (K6), shared by
// pair_products.cu, pair_model.cu and pair_poly.cu.
//
// Every operation is one IEEE f32 operation rounded to nearest, written as a
// _rn intrinsic, which nvcc never contracts into a fused multiply-add; the
// build takes no fast-math flag and no -ftz, so subnormals stay as the eager
// twins keep them. Each function follows its twin in
// sfft_tpu_torch/core/pairs.py term for term and in its order of additions
// (Python's a + b + c is (a + b) + c), which makes the kernels bit for bit
// with the twins. Negation is exact and is applied in registers.

#pragma once

namespace pairs {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// Knuth TwoSum: a + b = s + e exactly.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = add(a, b);
  const float v = sub(s, a);
  e = add(sub(a, sub(s, v)), sub(b, v));
}

// Dekker TwoProd with Veltkamp's split by 4097 (no FMA): a * b = p + e exactly.
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  const float C = 4097.0f;
  p = mul(a, b);
  const float a1 = mul(a, C);
  const float b1 = mul(b, C);
  const float ah = sub(a1, sub(a1, a));
  const float al = sub(a, ah);
  const float bh = sub(b1, sub(b1, b));
  const float bl = sub(b, bh);
  e = add(add(add(sub(mul(ah, bh), p), mul(ah, bl)), mul(al, bh)), mul(al, bl));
}

// A complex pair: real (hi, lo), imaginary (hi, lo).
struct Cx {
  float rh, rl, ih, il;
};

// A * conj(B) (pairs.py pair_products_plain 'hadamard_conj').
__device__ __forceinline__ Cx hadamard_conj(const Cx& A, const Cx& B) {
  float prr, err, pii, eii, pri, eri, pir, eir;
  two_prod(A.rh, B.rh, prr, err);
  two_prod(A.ih, B.ih, pii, eii);
  two_prod(A.rh, B.ih, pri, eri);
  two_prod(A.ih, B.rh, pir, eir);
  const float cr = add(add(add(add(add(err, eii), mul(A.rh, B.rl)), mul(A.rl, B.rh)),
                           mul(A.ih, B.il)), mul(A.il, B.ih));
  const float ci = sub(sub(add(add(sub(eir, eri), mul(A.ih, B.rl)), mul(A.il, B.rh)),
                           mul(A.rh, B.il)), mul(A.rl, B.ih));
  Cx h;
  float e1, e2;
  two_sum(prr, pii, h.rh, e1);
  two_sum(pir, -pri, h.ih, e2);
  h.rl = add(cr, e1);
  h.il = add(ci, e2);
  return h;
}

// A * W for a static complex W = (wr, wr_l, wi, wi_l) ('mul_static').
__device__ __forceinline__ Cx mul_static(const Cx& A, const Cx& W) {
  float prr, err, pii, eii, pri, eri, pir, eir;
  two_prod(A.rh, W.rh, prr, err);
  two_prod(A.ih, W.ih, pii, eii);
  two_prod(A.rh, W.ih, pri, eri);
  two_prod(A.ih, W.rh, pir, eir);
  const float cr = sub(sub(add(add(sub(err, eii), mul(A.rh, W.rl)), mul(A.rl, W.rh)),
                           mul(A.ih, W.il)), mul(A.il, W.ih));
  const float ci = add(add(add(add(add(eri, eir), mul(A.rh, W.il)), mul(A.rl, W.ih)),
                           mul(A.ih, W.rl)), mul(A.il, W.rh));
  Cx u;
  float e1, e2;
  two_sum(prr, -pii, u.rh, e1);
  two_sum(pri, pir, u.ih, e2);
  u.rl = add(cr, e1);
  u.il = add(ci, e2);
  return u;
}

// (h, l) * (wh, wl), a real pair times a real factor ('mul_static_rr'):
// p, e = TwoProd(h, wh); lo = (e + h wl) + l wh.
__device__ __forceinline__ void mul_rr(float h, float l, float wh, float wl, float& p,
                                       float& lo) {
  float e;
  two_prod(h, wh, p, e);
  lo = add(add(e, mul(h, wl)), mul(l, wh));
}

// pair * (c32 + cres), TwoProd on the hi lane, lo = (e + lo c32) + hi cres
// (pairs.py _scale_pair: the other order than mul_rr's).
__device__ __forceinline__ void scale_rr(float h, float l, float c32, float cres, float& p,
                                         float& lo) {
  float e;
  two_prod(h, c32, p, e);
  lo = add(add(e, mul(l, c32)), mul(h, cres));
}

// acc + term, compensated on each lane: hi by TwoSum, lo = (lo + lo') + e.
__device__ __forceinline__ void addp(Cx& acc, const Cx& t) {
  float er, ei;
  two_sum(acc.rh, t.rh, acc.rh, er);
  acc.rl = add(add(acc.rl, t.rl), er);
  two_sum(acc.ih, t.ih, acc.ih, ei);
  acc.il = add(add(acc.il, t.il), ei);
}

}  // namespace pairs
