// K5 — integer slicing of f64 values as exact f32 (hi, mid, lo) triples on
// Hopper.
//
// Replaces: sfft_tpu/core/pallas_slice.py, slice_triple_real /
// _mk_kernel_triple, the Pallas twin of sfft_tpu/core/exact_fft.py
// _slice_triple_real, and with it the chain around it in
// sfft_tpu/core/solve.py _sliced_residual_setup (slice_rows: equilibration,
// exact split, row scales) and _sliced_matvec (the vector's split and
// scale). The large f64 solve (sfft_tpu_torch/core/solve.py,
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
// the twin's bits). The results are bit-identical to the plain twins
// (core/slicing.py) and to sfft_tpu's XLA chain. A row of zeros has the
// scale clamped away from zero, so its slices are zeros, not NaN.
//
// Three entries share that chain:
//   * rows_f64: the solve's setup in one launch, from A (n, K) f64 and the
//     equilibration vector d to Ah = f32((A[i,j] * d[i]) * d[j]) (the f32
//     Cholesky's input), the row scales and the slices (nsl, n, ldo) with
//     pad columns zeroed. One block per row: the row is staged in shared
//     memory with 16-byte cp.async copies from the 16-byte boundary before
//     it (rows of an odd width alternate between 16- and 8-byte phases; the
//     reader skips the phase), equilibrated in place (d[j] read once), its
//     max |hi| reduced, then written as Ah (coalesced 4-byte stores) and as
//     slices (8 columns per thread: one 8-byte store per plane). A row too
//     wide for shared memory is read twice from device memory instead.
//   * vec_f64: a residual's vector (one global scale) in one single-block
//     launch, straight into rows 0..nsl-1 of the product's int8 operand.
//   * triple_f32: a given (hi, mid, lo) triple under a given scale.
//
// What bounds rows_f64: bytes. Each element reads 8 bytes and writes 4 + nsl
// (24 B at nsl = 12: 4.19 GB for the (13207, 13207) matrix), for ~30
// operations and 4 per slice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNB = 6;                          // bits per slice
constexpr int kInject = (24 + kNB - 1) / kNB;   // an f32 part is consumed after 4 slices
constexpr float kStep = float(1 << kNB);        // 2^NB
constexpr int kThreads = 256;
constexpr int kV = 4;                           // triple_f32: columns per thread
constexpr int kRowThreads = 512;                // rows_f64: threads per row
constexpr int kVecThreads = 1024;               // vec_f64: the one block
constexpr int kGroup = 8;                       // rows_f64 / vec_f64: columns per store

__device__ __forceinline__ float pow2ceil(float m) {
  // core/slicing.py _pow2ceil_scalar: clamp, then 2^(biased exponent - 126)
  m = fmaxf(m, 1e-30f);
  const int e = (__float_as_int(m) >> 23) & 0xFF;
  return __int_as_float((e + 1) << 23);
}

// exact three-way split of an f64 value (core/slicing.py split3)
__device__ __forceinline__ void split3(double x, float& h, float& m, float& l) {
  h = __double2float_rn(x);
  const double r = __dsub_rn(x, (double)h);
  m = __double2float_rn(r);
  l = __double2float_rn(__dsub_rn(r, (double)m));
}

// The remainder chain of V values; emit(q, bytes) receives each plane.
template <int V, typename Emit>
__device__ __forceinline__ void slice_chain(const float (&h)[V], const float (&m)[V],
                                            const float (&l)[V], float inv_s, int nsl,
                                            Emit emit) {
  float r[V], carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    r[v] = __fmul_rn(h[v], inv_s);
    carry[v] = 0.0f;
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
    emit(q, p8);
  }
}

__device__ __forceinline__ uint32_t pack4(const int8_t* p) {
  return (uint32_t)(uint8_t)p[0] | ((uint32_t)(uint8_t)p[1] << 8) |
         ((uint32_t)(uint8_t)p[2] << 16) | ((uint32_t)(uint8_t)p[3] << 24);
}

// kGroup bytes at column c0 of a row of ldo columns: one 8-byte store when
// ldo % 8 == 0 (ST8), else byte by byte inside the row
template <bool ST8>
__device__ __forceinline__ void store_group(int8_t* row, long long c0, long long ldo,
                                            const int8_t* p8) {
  if (ST8) {
    *reinterpret_cast<uint2*>(row + c0) = make_uint2(pack4(p8), pack4(p8 + 4));
  } else {
#pragma unroll
    for (int v = 0; v < kGroup; ++v)
      if (c0 + v < ldo) row[c0 + v] = p8[v];
  }
}

template <typename T>
__device__ __forceinline__ T block_max(T m, T* red, int nwarps) {
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// rows_f64: grid = rows. STAGED: the row (from the 16-byte boundary before
// it) in dynamic shared memory; else read twice from device memory.
template <bool STAGED, bool ST8>
__global__ void __launch_bounds__(kRowThreads, 2)
rows_f64_kernel(const double* __restrict__ A, long long lda, const double* __restrict__ d,
                float* __restrict__ Ah, float* __restrict__ scale, int8_t* __restrict__ out,
                long long rows, int K, int ldo, int nsl) {
  extern __shared__ double sm[];
  __shared__ float red[kRowThreads / 32];
  const long long row = blockIdx.x;
  const double* arow = A + row * lda;
  const double di = __ldg(d + row);
  int phase = 0;
  if (STAGED) {
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(arow) & ~static_cast<uintptr_t>(15);
    phase = (int)((reinterpret_cast<uintptr_t>(arow) - a0) / 8);
    const int nchunks = (phase + K + 1) / 2;
    const char* src = reinterpret_cast<const char*>(a0);
    for (int c = threadIdx.x; c < nchunks; c += kRowThreads)
      cp_async16(sm + 2 * c, src + 16 * (size_t)c);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  // As = (A[i, j] * d[i]) * d[j]: the twin's two f64 roundings, in order
  float mx = 0.0f;
  for (int j = threadIdx.x; j < K; j += kRowThreads) {
    const double a = STAGED ? sm[phase + j] : __ldg(arow + j);
    const double v = __dmul_rn(__dmul_rn(a, di), __ldg(d + j));
    if (STAGED) sm[phase + j] = v;
    mx = fmaxf(mx, fabsf(__double2float_rn(v)));
  }
  const float s = pow2ceil(block_max(mx, red, kRowThreads / 32));
  if (threadIdx.x == 0) scale[row] = s;
  const float inv_s = __frcp_rn(s);
  auto value = [&](int j) -> double {
    return STAGED ? sm[phase + j] : __dmul_rn(__dmul_rn(__ldg(arow + j), di), __ldg(d + j));
  };
  float* hrow = Ah + row * (long long)K;
  for (int j = threadIdx.x; j < K; j += kRowThreads) hrow[j] = __double2float_rn(value(j));
  const long long plane = rows * (long long)ldo;
  int8_t* orow = out + row * (long long)ldo;
  for (int c0 = threadIdx.x * kGroup; c0 < ldo; c0 += kRowThreads * kGroup) {
    float h[kGroup], m[kGroup], l[kGroup];
#pragma unroll
    for (int v = 0; v < kGroup; ++v) {
      if (c0 + v < K) {
        split3(value(c0 + v), h[v], m[v], l[v]);
      } else {
        h[v] = m[v] = l[v] = 0.0f;
      }
    }
    slice_chain<kGroup>(h, m, l, inv_s, nsl,
                        [&](int q, const int8_t* p8) { store_group<ST8>(orow + q * plane, c0, ldo, p8); });
  }
}

// vec_f64: one block; x (n,) -> rows 0..nsl-1 of out (., ldo), scale (1).
template <bool ST8>
__global__ void __launch_bounds__(kVecThreads)
vec_f64_kernel(const double* __restrict__ x, float* __restrict__ scale,
               int8_t* __restrict__ out, int n, int ldo, int nsl) {
  __shared__ float red[kVecThreads / 32];
  float mx = 0.0f;
  for (int j = threadIdx.x; j < n; j += kVecThreads)
    mx = fmaxf(mx, fabsf(__double2float_rn(__ldg(x + j))));
  const float s = pow2ceil(block_max(mx, red, kVecThreads / 32));
  if (threadIdx.x == 0) *scale = s;
  const float inv_s = __frcp_rn(s);
  for (int c0 = threadIdx.x * kGroup; c0 < ldo; c0 += kVecThreads * kGroup) {
    float h[kGroup], m[kGroup], l[kGroup];
#pragma unroll
    for (int v = 0; v < kGroup; ++v) {
      if (c0 + v < n) {
        split3(__ldg(x + c0 + v), h[v], m[v], l[v]);
      } else {
        h[v] = m[v] = l[v] = 0.0f;
      }
    }
    slice_chain<kGroup>(h, m, l, inv_s, nsl, [&](int q, const int8_t* p8) {
      store_group<ST8>(out + (long long)q * ldo, c0, ldo, p8);
    });
  }
}

// triple_f32: a given triple under a given scale; one thread takes 4
// neighbouring columns of one row (float4 loads when the rows are 16-byte
// aligned; one char4 store per plane when ldo % 4 == 0, the group's pad
// columns written as zeros).
template <bool VIN, bool VOUT, typename Idx>
__global__ void __launch_bounds__(kThreads)
triple_f32_kernel(const float* __restrict__ hi, const float* __restrict__ mid,
                  const float* __restrict__ lo, const float* __restrict__ scale,
                  int8_t* __restrict__ out, Idx rows, Idx K, Idx ldo, int rowwise, int nsl) {
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
    int8_t* o = out + (size_t)row * (size_t)ldo + c0;
    slice_chain<kV>(h, m, l, inv_s, nsl, [&](int q, const int8_t* p8) {
      int8_t* oq = o + (size_t)q * plane;
      if (VOUT) {
        *reinterpret_cast<char4*>(oq) = make_char4(p8[0], p8[1], p8[2], p8[3]);
      } else {
#pragma unroll
        for (int v = 0; v < kV; ++v)
          if (v < nv) oq[v] = p8[v];
      }
    });
  }
}

template <typename Idx>
void launch_triple(const float* h, const float* m, const float* l, const float* s, int8_t* o,
                   long long rows, long long K, long long ldo, int rowwise, int nsl, int vec_in,
                   int vec_out, int blocks, cudaStream_t st) {
  const Idx r = (Idx)rows, k = (Idx)K, d = (Idx)ldo;
  if (vec_in == 4 && vec_out == 4)
    triple_f32_kernel<true, true, Idx><<<blocks, kThreads, 0, st>>>(h, m, l, s, o, r, k, d, rowwise, nsl);
  else if (vec_in == 4)
    triple_f32_kernel<true, false, Idx><<<blocks, kThreads, 0, st>>>(h, m, l, s, o, r, k, d, rowwise, nsl);
  else if (vec_out == 4)
    triple_f32_kernel<false, true, Idx><<<blocks, kThreads, 0, st>>>(h, m, l, s, o, r, k, d, rowwise, nsl);
  else
    triple_f32_kernel<false, false, Idx><<<blocks, kThreads, 0, st>>>(h, m, l, s, o, r, k, d, rowwise, nsl);
}

}  // namespace

// A (rows, K) f64 with row stride lda, d (>= max(rows, K)) f64, Ah (rows, K)
// f32, scale (rows) f32, out (nsl, rows, ldo) int8: device pointers, ldo >=
// K. staged = 1 keeps each row in smem_bytes (8 (K + 2)) of dynamic shared
// memory. Returns cudaGetLastError() (or the attribute call's error).
extern "C" int sfft_slice_rows_f64(const void* A, long long lda, const void* d, void* Ah,
                                   void* scale, void* out, long long rows, long long K,
                                   long long ldo, int nsl, int staged, long long smem_bytes,
                                   void* stream) {
  if (K < 1 || ldo < K || ldo >= (1LL << 31) || rows < 1 || rows >= (1LL << 31) ||
      nsl < 2 * kInject || nsl > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* a = static_cast<const double*>(A);
  const double* dd = static_cast<const double*>(d);
  float* h = static_cast<float*>(Ah);
  float* sc = static_cast<float*>(scale);
  int8_t* o = static_cast<int8_t*>(out);
  const bool st8 = ldo % kGroup == 0;
#define ROWS(S, B)                                                                        \
  do {                                                                                    \
    auto kern = rows_f64_kernel<S, B>;                                                    \
    if (S) {                                                                              \
      const cudaError_t e = cudaFuncSetAttribute(                                         \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes)); \
      if (e != cudaSuccess) return static_cast<int>(e);                                   \
    }                                                                                     \
    kern<<<(unsigned)rows, kRowThreads, S ? smem_bytes : 0, st>>>(a, lda, dd, h, sc, o,   \
                                                                  rows, (int)K, (int)ldo, nsl); \
  } while (0)
  if (staged && st8) ROWS(true, true);
  else if (staged) ROWS(true, false);
  else if (st8) ROWS(false, true);
  else ROWS(false, false);
#undef ROWS
  return static_cast<int>(cudaGetLastError());
}

// x (n) f64, scale (1) f32, out (>= nsl, ldo) int8 with ldo >= n: device
// pointers. Writes rows 0..nsl-1 of out (pad columns as zeros). Returns
// cudaGetLastError().
extern "C" int sfft_slice_vec_f64(const void* x, void* scale, void* out, long long n,
                                  long long ldo, int nsl, void* stream) {
  if (n < 1 || ldo < n || ldo >= (1LL << 31) || nsl < 2 * kInject || nsl > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* xx = static_cast<const double*>(x);
  float* sc = static_cast<float*>(scale);
  int8_t* o = static_cast<int8_t*>(out);
  if (ldo % kGroup == 0)
    vec_f64_kernel<true><<<1, kVecThreads, 0, st>>>(xx, sc, o, (int)n, (int)ldo, nsl);
  else
    vec_f64_kernel<false><<<1, kVecThreads, 0, st>>>(xx, sc, o, (int)n, (int)ldo, nsl);
  return static_cast<int>(cudaGetLastError());
}

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
    launch_triple<unsigned>(h, m, l, s, o, rows, K, ldo, rowwise, nsl, vec_in, vec_out, blocks, st);
  else
    launch_triple<long long>(h, m, l, s, o, rows, K, ldo, rowwise, nsl, vec_in, vec_out, blocks, st);
  return static_cast<int>(cudaGetLastError());
}
