// The FP64 tensor-core (DMMA) rates that K8, K9 and K1 are designed around,
// on the card itself: mma.sync f64 by shape with its operands in registers;
// K8's inner loop (warp_tile of csrc/corr_direct.cu, included below: per
// staged row, 6 A and NT B fragment loads from shared memory for 3 x NT
// m16n8k4 DMMAs) on a tile staged once, with no staging in the loop; and
// K1's (k1::warp_tile of csrc/corr_window.cuh: per k-step NT B fragments and
// 2 x 2 raw spectrum elements, two products a * conj(b), for 2 x NT DMMAs)
// on two tile buffers filled once, read in turn.
// Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o "$TMPDIR/dmma_rates" tools/dmma_rates.cu
//   "$TMPDIR/dmma_rates"
//
// Each line is the rate over one timed launch (after a warm-up) of 132 SMs'
// worth of blocks; the FP64 peak of an H100 SXM is 67 TFLOP/s.

#include <cstdio>
#include <cuda_runtime.h>

#include "../sfft_tpu_torch/csrc/corr_direct.cu"
#include "../sfft_tpu_torch/csrc/corr_window.cuh"

// SHAPE 0: m8n8k4, 1: m16n8k4, 2: m16n8k8, 3: m16n8k16; NACC independent
// accumulator tiles a warp
template <int SHAPE, int NACC>
__global__ void shapes(double* out, int iters, double seed) {
  const int lane = threadIdx.x & 31;
  double a[8], b[4], c[NACC][4];
  for (int i = 0; i < 8; ++i) a[i] = seed * (lane + i + 1);
  for (int i = 0; i < 4; ++i) b[i] = seed * (lane - i);
  for (int j = 0; j < NACC; ++j)
    for (int i = 0; i < 4; ++i) c[j][i] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      if (SHAPE == 0) {
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                     : "+d"(c[j][0]), "+d"(c[j][1]) : "d"(a[j & 7]), "d"(b[j & 3]));
      } else if (SHAPE == 1) {
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                     : "+d"(c[j][0]), "+d"(c[j][1]), "+d"(c[j][2]), "+d"(c[j][3])
                     : "d"(a[0]), "d"(a[1]), "d"(b[j & 3]));
      } else if (SHAPE == 2) {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+d"(c[j][0]), "+d"(c[j][1]), "+d"(c[j][2]), "+d"(c[j][3])
                     : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[j & 1]));
      } else {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
                     : "+d"(c[j][0]), "+d"(c[j][1]), "+d"(c[j][2]), "+d"(c[j][3])
                     : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
                       "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[j & 3]));
      }
    }
  }
  double s = 0.0;
  for (int j = 0; j < NACC; ++j)
    for (int i = 0; i < 4; ++i) s += c[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// K8's inner loop on a shared-memory tile filled once: warp_tile over RT
// staged rows x 4 k-steps a pass, 3 lag pairs x NT n-tiles of accumulators
// a warp, B rows of 16 + 33 - 1 columns (Comg's 33 lags)
template <int NT>
__global__ void k8_loop(double* out, int iters, int RT) {
  extern __shared__ double sm[];
  const int SA = 49 * kTY + 4, BW = kTY + 33 - 1;
  double* As = sm;
  double* Bs = sm + 8 * SA;
  for (int i = threadIdx.x; i < 8 * SA + 3 * 32 * BW; i += blockDim.x) sm[i] = 1e-3 * (i % 97);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
  int boff[NT];
  for (int nt = 0; nt < NT; ++nt) boff[nt] = ((warp * NT + nt) * 8 + g) % 100 + t;
  double acc[kP / 2][NT][4];
  for (int jp = 0; jp < kP / 2; ++jp)
    for (int nt = 0; nt < NT; ++nt)
      for (int q = 0; q < 4; ++q) acc[jp][nt][q] = 0.0;
  for (int it = 0; it < iters; ++it)
    warp_tile<NT, NT, true>(acc, As + g * SA + t, true, Bs, boff, RT, BW, kP / 2);
  double s = 0;
  for (int jp = 0; jp < kP / 2; ++jp)
    for (int nt = 0; nt < NT; ++nt)
      for (int q = 0; q < 4; ++q) s += acc[jp][nt][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// K1's inner loop: warp_tile over one tile (VT columns) of two buffers of
// staged tiles (4 planes x 16 rows, the c64 rows' phases as on a 2049-column
// spectrum) and packed E1, in turn (so that no load leaves the loop); warp
// w takes the planes w and w + 1; the kernel's launch bound (min_blocks blocks of
// kWarps warps an SM)
template <typename R, int NT>
__global__ void __launch_bounds__(32 * k1::kWarps, k1::min_blocks(NT)) k1_loop(double* out, int iters) {
  using C = typename k1::CplxOf<R>::T;
  constexpr int VT = k1::Ring<R>::VT, LD = k1::row_stride<VT>(), KS = VT / 4;
  constexpr int NRAW = k1::kSlots * k1::kUT * LD, NES = KS * NT * 32;
  extern __shared__ __align__(16) unsigned char sm1[];
  C* raw = reinterpret_cast<C*>(sm1);                       // [2][kSlots][kUT][LD]
  double* es = reinterpret_cast<double*>(raw + 2 * NRAW);   // [2][KS][NT * 32]
  for (int i = threadIdx.x; i < 2 * NRAW; i += blockDim.x) {
    raw[i].x = 1e-3 * (i % 97);
    raw[i].y = 1e-3 * (i % 89);
  }
  for (int i = threadIdx.x; i < 2 * NES; i += blockDim.x) es[i] = 1e-3 * (i % 83);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
  int offa[k1::kMT], offb[k1::kMT];
  for (int mt = 0; mt < k1::kMT; ++mt) {
    const int r = k1::tile_row(mt, g), ph = sizeof(R) == 4 ? (r & 1) : 0;
    offa[mt] = ((warp % k1::kSlots) * k1::kUT + r) * LD + ph + t;
    offb[mt] = (((warp + 1) % k1::kSlots) * k1::kUT + r) * LD + ph + t;
  }
  double acc[k1::kMT][NT][4];
  for (int mt = 0; mt < k1::kMT; ++mt)
    for (int nt = 0; nt < NT; ++nt)
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0;
  for (int it = 0; it < iters; ++it)
    k1::warp_tile<C, NT, KS>(acc, raw + (it & 1) * NRAW, offa, offb, es + (it & 1) * NES + lane,
                             NT * 32);
  double s = 0;
  for (int mt = 0; mt < k1::kMT; ++mt)
    for (int nt = 0; nt < NT; ++nt)
      for (int q = 0; q < 4; ++q) s += acc[mt][nt][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

float timed(void (*launch)(double*, int), double* out) {
  launch(out, 5);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  launch(out, 0);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}

template <int SHAPE, int NACC, int WARPS>
void run_shape(const char* name, double* out) {
  const int iters = 8000 >> (SHAPE >= 2 ? SHAPE - 1 : 0);
  const int fma[4] = {8 * 8 * 4, 16 * 8 * 4, 16 * 8 * 8, 16 * 8 * 16};
  auto launch = [](double* o, int warm) {
    shapes<SHAPE, NACC><<<132, 32 * WARPS>>>(o, warm ? warm : 8000 >> (SHAPE >= 2 ? SHAPE - 1 : 0), 1e-3);
  };
  const float ms = timed(launch, out);
  printf("%-9s %2d accumulators, %2d warps an SM: %5.1f TFLOP/s (%s)\n", name, NACC, WARPS,
         2.0 * fma[SHAPE] * NACC * iters * 132.0 * WARPS / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
}

template <int NT, int WARPS, int BLOCKS>
void run_loop(double* out) {
  constexpr int smem = (8 * (49 * kTY + 4) + 3 * 32 * (kTY + 32)) * 8, iters = 2000, RT = 16;
  cudaFuncSetAttribute(k8_loop<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  auto launch = [](double* o, int warm) {
    k8_loop<NT><<<132 * BLOCKS, 32 * WARPS, smem>>>(o, warm ? warm : iters, RT);
  };
  const float ms = timed(launch, out);
  printf("K8 inner loop, NT %d, %d warps x %d blocks an SM: %5.1f TFLOP/s (%s)\n", NT, WARPS,
         BLOCKS, 2.0 * 512 * (kP / 2) * NT * 4.0 * RT * iters * 132 * BLOCKS * WARPS / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
}

template <typename R, int NT, int BLOCKS>
void run_k1_loop(const char* name, double* out) {
  constexpr int VT = k1::Ring<R>::VT, KS = VT / 4;
  constexpr int smem = 2 * (k1::kSlots * k1::kUT * k1::row_stride<VT>() *
                            (int)sizeof(typename k1::CplxOf<R>::T) + KS * NT * 32 * 8);
  constexpr int iters = 4000 / KS;
  cudaFuncSetAttribute(k1_loop<R, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  auto launch = [](double* o, int warm) {
    k1_loop<R, NT><<<132 * BLOCKS, 32 * k1::kWarps, smem>>>(o, warm ? warm : iters);
  };
  const float ms = timed(launch, out);
  printf("K1 inner loop, %s NT %d, %d warps x %d blocks an SM: %5.1f TFLOP/s of DMMA (%s)\n", name,
         NT, k1::kWarps, BLOCKS,
         2.0 * 512 * k1::kMT * NT * KS * (double)iters * 132 * BLOCKS * k1::kWarps / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  double* out;
  cudaMalloc(&out, 132 * 2 * 256 * sizeof(double));
  run_shape<0, 16, 8>("m8n8k4", out);
  run_shape<1, 8, 8>("m16n8k4", out);
  run_shape<2, 8, 8>("m16n8k8", out);
  run_shape<3, 8, 8>("m16n8k16", out);
  run_loop<5, 4, 2>(out);
  run_loop<5, 4, 1>(out);
  run_loop<4, 4, 2>(out);
  run_k1_loop<float, 5, 4>("c64", out);
  run_k1_loop<float, 3, 4>("c64", out);
  run_k1_loop<float, 6, 3>("c64", out);
  run_k1_loop<double, 5, 4>("c128", out);
  run_k1_loop<double, 3, 4>("c128", out);
  cudaFree(out);
  return 0;
}
