// Throughput probe of the deformable alignment's bin scan on Hopper (sm_90a).
//
// Replaces the Pallas TPU probe scripts/exp_vpu_binscan.py make_kernel: for
// each of `bins` row shifts s and each of `taps` taps k,
//
//   acc[p, c] += w(p, g(c), k, s) * x[p + s, c],
//   w = (1 - wy) where y0 == s, wy where y0 == s - 1, else 0,
//
// over tiles of P rows with their own (P + pad)-row source block, channels in
// the probe's cg-major order (g(c) = c % G: the TPU kernel lane-replicates a
// (P, G) weight cg times). It is the inner operation of scanning displacement
// bins instead of gathering; the probe measures the multiply-add rate it
// reaches, from which the scan's time for one alignment call is projected
// and set beside the gather kernel's (csrc/deform_align.cu).
//
// What bounds it on the H100: operations. 4 tiles x 512 rows x 128 bins x
// 9 taps x 256 channels are 0.6 G multiply-adds over 7 MB of inputs and
// outputs. The design keeps the TPU kernel's economy, one selection weight
// for the cg channels of a group: a thread owns one (row, group), holds its
// 9 taps' (y0, wy) and its cg accumulators in registers, and per shift loads
// the cg source values of its group (stride G floats; the 16 threads of a
// row cover each 64-byte segment between them) and issues 9 x cg fused
// multiply-adds, one per tap as the TPU probe does (the taps are not summed
// first: the real scan keeps an accumulator per tap). The source block of a
// tile (P + pad rows of 1 KB) is re-read from L1 / L2 by every shift.
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 9;

template <int CG>
__global__ void __launch_bounds__(kThreads)
binscan_kernel(const float* __restrict__ x, const int* __restrict__ y0,
               const float* __restrict__ wy, float* __restrict__ out,
               int n_tiles, int P, int rows_in, int G, int taps, int bins) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long total = static_cast<long long>(n_tiles) * P * G;
  if (tid >= total) return;
  const int g = static_cast<int>(tid % G);
  const long long row = tid / G;               // tile * P + p
  const int p = static_cast<int>(row % P);
  const long long tile = row / P;
  const int cin = G * CG;

  int y0k[kMaxTaps];
  float wyk[kMaxTaps];
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {
    if (k < taps) {
      y0k[k] = y0[row * (taps * G) + k * G + g];     // tap-major fields
      wyk[k] = wy[row * (taps * G) + k * G + g];
    } else {
      y0k[k] = -2;                                    // never selected
      wyk[k] = 0.f;
    }
  }
  float acc[CG];
#pragma unroll
  for (int j = 0; j < CG; ++j) acc[j] = 0.f;

  const float* xt = x + (tile * rows_in + p) * cin + g;
  for (int s = 0; s < bins; ++s) {
    float xs[CG];
#pragma unroll
    for (int j = 0; j < CG; ++j) xs[j] = __ldg(xt + static_cast<long long>(s) * cin + j * G);
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      const float w = (y0k[k] == s ? 1.0f - wyk[k] : 0.0f) + (y0k[k] == s - 1 ? wyk[k] : 0.0f);
#pragma unroll
      for (int j = 0; j < CG; ++j) acc[j] = fmaf(w, xs[j], acc[j]);
    }
  }
  float* o = out + row * cin + g;
#pragma unroll
  for (int j = 0; j < CG; ++j) o[j * G] = acc[j];
}

}  // namespace

// x (n_tiles, rows_in, G * cg), y0 int32 and wy fp32 (n_tiles, P, taps * G),
// out (n_tiles, P, G * cg), contiguous; rows_in >= P + bins - 1; taps <= 9;
// cg one of 1, 2, 4, 8, 16.
extern "C" int vosesam_binscan_probe(
    const float* x, const int* y0, const float* wy, float* out,
    int n_tiles, int P, int rows_in, int G, int cg, int taps, int bins, void* stream_ptr) {
  if (n_tiles < 0 || P < 1 || G < 1 || taps < 1 || taps > kMaxTaps || bins < 0 ||
      rows_in < P + bins - 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long total = static_cast<long long>(n_tiles) * P * G;
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
#define LAUNCH(CG_)                                                              \
  binscan_kernel<CG_><<<grid, kThreads, 0, stream>>>(x, y0, wy, out, n_tiles, P, \
                                                     rows_in, G, taps, bins)
  switch (cg) {
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 4: LAUNCH(4); break;
    case 8: LAUNCH(8); break;
    case 16: LAUNCH(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
