// K1 in complex64 (the peeled path's fluctuation spectra): the C entry of
// corr_window.cuh, which holds the kernel and its notes.

#include "corr_window.cuh"

// A (Fa, N0, N1h), B (Fb, N0, N1h) complex; groups (ngroups, 18) int32: the
// wrapper's schedule of the npairs pairs (see corr_stage1); E0 (R0, N0)
// complex; E1p (N1h rounded up to a multiple of 64, / 4, NT * nng, 32) f64:
// E1 (N1h, R1) in the DMMAs' fragment order (greek._k1_pack_e1); scratch:
// T1 (npairs, N0, R1) complex, part (npairs, 32, R0, R1) f64; out (npairs,
// R0, R1) real; Fa and Fb planes in A and B. sym: E1's columns are conjugate-symmetric about the middle
// one (R1 odd). NT (1..6) n-tiles a warp and nng (1..3) n-groups a pair:
// 4 * NT * nng covers the lag slots (R1, or R1 / 2 + 1 with sym) and
// 4 * NT * (nng - 1) does not. Returns the first CUDA error.
extern "C" int sfft_corr_window_c64(const void* A, const void* B, const void* groups,
                                    const void* E0, const void* E1p, void* T1, void* part,
                                    void* out, int npairs, int ngroups, int Fa, int Fb, int N0,
                                    int N1h, int R0, int R1, int NT, int nng, int sym,
                                    void* stream) {
  return k1::launch<float>(A, B, groups, E0, E1p, T1, part, out, npairs, ngroups, Fa, Fb,
                          N0, N1h, R0, R1, NT, nng, sym, stream);
}
