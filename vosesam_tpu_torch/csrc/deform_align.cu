// Modulated deformable 3x3 bilinear sampling for Hopper (sm_90a): the
// patches of E2FGVI's second-order deformable alignment,
//
//   patches[b, y, x, k, c] = mask[b, y, x, g(c), k] * bilinear(x[b, :, :, c],
//                              y + (off_y[g(c), k] + dy_k), x + (off_x[g(c), k] + dx_k))
//
// over k = 9 taps and G deform groups of cg = Cin / G channels, zero outside
// the field. With radius >= 0 a corner whose integer displacement from the
// output pixel lies outside [-radius, radius] (rows and columns each on their
// own) contributes nothing.
//
// Replaces the Pallas TPU kernel vosesam_tpu/ops/pallas/deform_align.py
// deform_patches_bounded. That kernel scans every displacement bin of the
// window with dense shifted multiply-adds because a TPU has no gather unit;
// this card gathers well, so the function is one gather kernel and the
// window is only the drop rule. The contraction with the 3x3 conv weight
// stays a torch.matmul in the wrapper's caller, as it is a jnp.dot in JAX.
//
// What bounds it on the H100: bytes. At the model's shape (60 x 108 x 256
// fp32, G 16) it reads 6.6 MB of features, 7.5 MB of offsets and 3.7 MB of
// mask and writes 59.7 MB of patches, and does ~12 operations per output
// value. The design therefore spends its care on the write: a thread owns
// one 16-byte vector of one (pixel, tap, group), threads are ordered
// (pixel, tap, group, vector) exactly as the output is laid out, so every
// store instruction of a warp covers 512 contiguous bytes. The four corner
// reads are 16-byte loads of the group's contiguous channels (NHWC input);
// the field (6.6 MB) stays in L2 across the nine taps. Corner indices and
// weights are recomputed by the cg / 4 threads that share them: cheaper than
// exchanging them. A scalar instance covers cg not a multiple of 4 and
// unaligned tensors.
//
// Arithmetic: (offset + tap) first, the pixel coordinate second, each
// rounded to fp32 on its own (no fused multiply-add across them), as both JAX
// forms compute it: a sample on an integer coordinate must floor to the same
// cell. The weights and the four-corner sum are rounded step by step in the
// plain PyTorch version's order, so the two agree to the last bit on finite
// inputs.
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 9;

template <int VEC> struct Vec;
template <> struct Vec<4> { using type = float4; };
template <> struct Vec<1> { using type = float; };

__device__ __forceinline__ float4 ldv(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float ldv(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 zero_v(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float zero_v(float) { return 0.f; }

// ((v00 * wx0) * wy0 + (v01 * wx1) * wy0 + (v10 * wx0) * wy1 + (v11 * wx1) * wy1) * m,
// every step rounded on its own.
__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11,
                                       float wx0, float wx1, float wy0, float wy1, float m) {
  float a = __fmul_rn(__fmul_rn(v00, wx0), wy0);
  float b = __fmul_rn(__fmul_rn(v01, wx1), wy0);
  float c = __fmul_rn(__fmul_rn(v10, wx0), wy1);
  float d = __fmul_rn(__fmul_rn(v11, wx1), wy1);
  return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d), m);
}

__device__ __forceinline__ float4 blend(float4 v00, float4 v01, float4 v10, float4 v11,
                                        float wx0, float wx1, float wy0, float wy1, float m) {
  return make_float4(blend(v00.x, v01.x, v10.x, v11.x, wx0, wx1, wy0, wy1, m),
                     blend(v00.y, v01.y, v10.y, v11.y, wx0, wx1, wy0, wy1, m),
                     blend(v00.z, v01.z, v10.z, v11.z, wx0, wx1, wy0, wy1, m),
                     blend(v00.w, v01.w, v10.w, v11.w, wx0, wx1, wy0, wy1, m));
}

// One axis of one sample: floor cell, fractional weight, and for each of the
// two corners whether it lies in the field and inside the window.
struct Axis {
  int i0, i1;        // clamped corner indices
  float w0, w1;      // corner weights, 0 where the radius rule drops the corner
  bool in0, in1;     // corner inside the field
};

__device__ __forceinline__ Axis make_axis(int p, float off, float tap, int extent, int radius) {
  const float pf = static_cast<float>(p);
  const float a = __fadd_rn(pf, __fadd_rn(off, tap));
  const float f0 = floorf(a);
  const float f1 = __fadd_rn(f0, 1.0f);
  const float frac = __fsub_rn(a, f0);
  const float hi = static_cast<float>(extent - 1);
  Axis ax;
  ax.in0 = (f0 >= 0.0f) && (f0 <= hi);
  ax.in1 = (f1 >= 0.0f) && (f1 <= hi);
  ax.i0 = static_cast<int>(fminf(fmaxf(f0, 0.0f), hi));
  ax.i1 = static_cast<int>(fminf(fmaxf(f1, 0.0f), hi));
  ax.w0 = __fsub_rn(1.0f, frac);
  ax.w1 = frac;
  if (radius >= 0) {
    const float r = static_cast<float>(radius);
    const float d0 = __fsub_rn(f0, pf);
    const float d1 = __fadd_rn(d0, 1.0f);
    if (!(d0 >= -r && d0 <= r)) ax.w0 = __fmul_rn(ax.w0, 0.0f);
    if (!(d1 >= -r && d1 <= r)) ax.w1 = __fmul_rn(ax.w1, 0.0f);
  }
  return ax;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
deform_patches_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                      const float* __restrict__ mask, float* __restrict__ out,
                      long long total, int H, int W, int Cin, int G, int radius) {
  using V = typename Vec<VEC>::type;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid >= total) return;
  const int cg = Cin / G;
  const int vecs = cg / VEC;                 // vectors per group
  // thread order == output order: (b, y, x, k, g, v)
  long long t = tid;
  const int v = static_cast<int>(t % vecs); t /= vecs;
  const int g = static_cast<int>(t % G); t /= G;
  const int k = static_cast<int>(t % kTaps); t /= kTaps;
  const long long pix = t;                   // b * H * W + y * W + x
  const int px = static_cast<int>(pix % W);
  const int py = static_cast<int>((pix / W) % H);
  const long long b = pix / (static_cast<long long>(W) * H);

  const int gk = g * kTaps + k;
  const float off_y = __ldg(offset + pix * (2LL * G * kTaps) + 2 * gk);
  const float off_x = __ldg(offset + pix * (2LL * G * kTaps) + 2 * gk + 1);
  const float m = __ldg(mask + pix * (static_cast<long long>(G) * kTaps) + gk);
  const float dy = static_cast<float>(k / 3 - 1);
  const float dx = static_cast<float>(k % 3 - 1);

  const Axis ay = make_axis(py, off_y, dy, H, radius);
  const Axis ax = make_axis(px, off_x, dx, W, radius);

  const int ch = g * cg + v * VEC;
  const float* xb = x + b * (static_cast<long long>(H) * W * Cin) + ch;
  auto corner = [&](int yi, int xi, bool inb) -> V {
    if (!inb) return zero_v(V());
    return ldv(reinterpret_cast<const V*>(xb + (static_cast<long long>(yi) * W + xi) * Cin));
  };
  const V v00 = corner(ay.i0, ax.i0, ay.in0 && ax.in0);
  const V v01 = corner(ay.i0, ax.i1, ay.in0 && ax.in1);
  const V v10 = corner(ay.i1, ax.i0, ay.in1 && ax.in0);
  const V v11 = corner(ay.i1, ax.i1, ay.in1 && ax.in1);

  const V r = blend(v00, v01, v10, v11, ax.w0, ax.w1, ay.w0, ay.w1, m);
  *reinterpret_cast<V*>(out + (pix * kTaps + k) * Cin + ch) = r;
}

}  // namespace

// x (B, H, W, Cin), offset (B, H, W, 2 * G * 9), mask (B, H, W, G * 9),
// out (B, H, W, 9, Cin), all contiguous fp32. radius < 0: unbounded.
// vec: 4 for 16-byte accesses (cg % 4 == 0 and 16-byte aligned x / out), else 1.
extern "C" int vosesam_deform_patches(
    const float* x, const float* offset, const float* mask, float* out,
    int B, int H, int W, int Cin, int G, int radius, int vec, void* stream_ptr) {
  if (B < 0 || H < 1 || W < 1 || G < 1 || Cin < G || Cin % G != 0) return (int)cudaErrorInvalidValue;
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  if (vec == 4 && (Cin / G) % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long total = static_cast<long long>(B) * H * W * kTaps * (Cin / vec);
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec == 4) {
    deform_patches_kernel<4><<<grid, kThreads, 0, stream>>>(
        x, offset, mask, out, total, H, W, Cin, G, radius);
  } else {
    deform_patches_kernel<1><<<grid, kThreads, 0, stream>>>(
        x, offset, mask, out, total, H, W, Cin, G, radius);
  }
  return (int)cudaGetLastError();
}
