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
// value. The four corner reads of every output vector come from L2 (the
// field stays there across the nine taps): 4x the patch bytes of L2
// traffic. What held the first design (a thread per output vector,
// 2.6x its byte bound) was the work around the copy: every thread decoded
// its index with five 64-bit divides, and the cg / 4 threads of one
// (pixel, tap, group) each reloaded the same offsets and mask and
// recomputed the same corners. This design:
//
//   a block of 256 threads owns P consecutive pixels (P * 9 * Cin / 4
//   output vectors; P = 2 at the model's shape, 3240 blocks). Phase 1: one thread per
//   (pixel, group, tap) reads its offset pair and mask in their own layout
//   (a warp reads 256 contiguous bytes of offsets and 128 of mask) and
//   computes the sampling geometry once: the four corners' pixel indices
//   (-1 outside the field) and the weights, with the floor rule of C18 and
//   the radius drop rule. The records go to shared memory in output order
//   (16-byte index and weight loads, conflict-free). Phase 2: threads in
//   output order, so every store instruction of a warp covers 512
//   contiguous bytes; each reads its record (broadcast to the cg / 4
//   threads that share it), gathers the four corners as 16-byte loads of
//   the group's contiguous channels (NHWC input), blends and stores with
//   the streaming hint (__stcs: the patch tensor is read once, by the
//   contraction right after; 4% faster than the plain store at the model's
//   shape on the H100).
//   All index arithmetic is 32-bit: the wrapper refuses tensors of 2^31 or
//   more elements. A scalar instance covers cg not a multiple of 4 and
//   unaligned tensors.
//
// Arithmetic: (offset + tap) first, the pixel coordinate second, each
// rounded to fp32 on its own (no fused multiply-add across them), as both JAX
// forms compute it: a sample on an integer coordinate must floor to the same
// cell. The weights and the four-corner sum are rounded step by step in the
// plain PyTorch version's order, so the two agree to the last bit on finite
// inputs.
//
// The backward (vosesam_deform_patches_backward) is no TPU kernel: the Pallas
// kernel has no VJP and JAX differentiates the gather form. Given
// grad (B, H, W, 9, Cin) it writes grad_x (B, H, W, Cin), grad_offset
// (B, H, W, 2 G 9) in the (y, x) pair layout and grad_mask (B, H, W, G 9),
// the gradients autograd of the plain PyTorch version gives:
//
//   ds        = grad * m                      (per channel)
//   grad_x    += ((ds * wy) * wx) at each in-field corner
//   grad_mask = sum_c grad * bilinear        (the four-corner sum before m)
//   grad_off  = -(d w0 * r0) + d w1 * r1 per axis, d w the sums over c of
//               ds times the other axis's weight times the corner value;
//               r the radius rule's 0 / 1 factors (1 without a radius);
//               the derivative of floor is 0, so at an integer position
//               both corners still count, as in autograd.
//
// What bounds it: at the trainer's shape it reads the 59.7 MB grad once and
// x, offsets and mask, and writes the three gradients (~95 MB: ~0.028 ms at
// 3.35 TB/s); it adds 4 x 9 x 256 x 6480 = 59.7 M values into grad_x, a
// 6.6 MB target that stays in L2. grad_x is a scatter to data-dependent
// addresses, so it is accumulated with fp32 atomics whose order changes
// from call to call: grad_x agrees with the plain version to rounding, not
// bit for bit (the wrapper zeroes it; the kernel allocates nothing). The
// time tracks the atomic traffic to L2, not the bytes (PERF.md: scalar
// atomics 0.69 ms, one 16-byte atomic per corner and 4 channels 0.26 ms).
//
// The design: cg / 4 lanes per (pixel, tap, group) sample, one 4-channel
// chunk each, samples in the grad's order (deform_bwd_lanes_kernel). Each
// lane recomputes the sample's geometry in the forward's order (C18: the
// same floor cell), loads its 16-byte chunk of the grad and of the four
// corners, and adds its four corner terms with 16-byte vector atomics; the
// cg / 4 lanes of a corner cover its cg contiguous floats in one warp
// instruction, so L2 sees a sample's 64 bytes as whole 32-byte sectors
// instead of scattered 16-byte pieces (2.3x the thread-per-sample kernel on
// the H100). Each lane sums its four channels in order and the lanes meet
// in a fixed-order shuffle butterfly, so grad_offset and grad_mask are the
// same bits in every call. A corner the radius rule drops adds an exact
// zero and is skipped. 48 registers, no shared memory: full occupancy.
// Where cg / 4 is no power of two up to 32 (cg 2, 12, 256, ...) or a
// tensor is not 16-byte aligned, one thread per sample walks the channels
// one by one (deform_bwd_sample_kernel).
//
// Why not a window of grad_x in shared memory per tile of output pixels,
// flushed once (the design first planned for it): on sm_90 an fp32 add to
// shared memory is a compare-and-swap loop (ATOMS.CAST.SPIN;
// red.shared.add.f32 compiles to the same), which costs more than the
// global vector atomics it saves. Measured on the H100 with a 16 x 16 tile
// and a 32 x 32 window: 0.42 ms at the trainer's shape, 4.8% of the corner
// terms falling back to global atomics (PERF.md).
//
// vosesam_deform_occupancy and vosesam_deform_backward_occupancy report
// the instances' registers, shared memory and resident blocks per SM on the
// card. Built with -DVOSESAM_PROFILE, thread 0 of every block stamps the
// global timer at the ends of its phases (python -m
// vosesam_tpu_torch.ops.kernels.phases).
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 9;

#ifdef VOSESAM_PROFILE
// per block: start, geometry done, done (ns)
__device__ unsigned long long g_prof[1 << 16][4];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define PROF(slot)                                                            \
  do {                                                                        \
    if (threadIdx.x == 0 && blockIdx.x < (1 << 16)) g_prof[blockIdx.x][slot] = now_ns(); \
  } while (0)
#else
#define PROF(slot) do {} while (0)
#endif

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
  float frac;        // the position's fraction above the floor cell
  bool in0, in1;     // corner inside the field
  bool r0, r1;       // corner kept by the radius rule (the backward's factors)
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
  ax.frac = frac;
  ax.w0 = __fsub_rn(1.0f, frac);
  ax.w1 = frac;
  ax.r0 = ax.r1 = true;
  if (radius >= 0) {
    const float r = static_cast<float>(radius);
    const float d0 = __fsub_rn(f0, pf);
    const float d1 = __fadd_rn(d0, 1.0f);
    ax.r0 = d0 >= -r && d0 <= r;
    ax.r1 = d1 >= -r && d1 <= r;
    if (!ax.r0) ax.w0 = __fmul_rn(ax.w0, 0.0f);
    if (!ax.r1) ax.w1 = __fmul_rn(ax.w1, 0.0f);
  }
  return ax;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
deform_patches_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                      const float* __restrict__ mask, float* __restrict__ out,
                      int n_pix, int P, int H, int W, int Cin, int G, int radius) {
  using V = typename Vec<VEC>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tg = kTaps * G;              // (tap, group) samples per pixel
  const int R = P * tg;                  // records of the block
  int4* sIdx = reinterpret_cast<int4*>(smem);         // corner pixels, -1 outside
  float4* sWt = reinterpret_cast<float4*>(sIdx + R);  // wx0, wx1, wy0, wy1
  float* sM = reinterpret_cast<float*>(sWt + R);      // modulation
  const int pix0 = blockIdx.x * P;
  const int np = min(P, n_pix - pix0);
  const int hw = H * W;
  PROF(0);

  // phase 1: the geometry of every (pixel, group, tap) of the block, once
  const float2* off2 = reinterpret_cast<const float2*>(offset) + pix0 * tg;
  const float* mk = mask + pix0 * tg;
  for (int j = threadIdx.x; j < np * tg; j += kThreads) {
    const int p = j / tg, rem = j - p * tg;  // rem = g * 9 + k, the input layout
    const int g = rem / kTaps, k = rem - g * kTaps;
    const int pix = pix0 + p;
    const int img = pix / hw, yx = pix - img * hw;
    const int py = yx / W, px = yx - py * W;
    const float2 o = __ldg(off2 + j);        // (y, x)
    const Axis ay = make_axis(py, o.x, static_cast<float>(k / 3 - 1), H, radius);
    const Axis ax = make_axis(px, o.y, static_cast<float>(k % 3 - 1), W, radius);
    const int base = img * hw;
    int4 id;
    id.x = (ay.in0 && ax.in0) ? base + ay.i0 * W + ax.i0 : -1;
    id.y = (ay.in0 && ax.in1) ? base + ay.i0 * W + ax.i1 : -1;
    id.z = (ay.in1 && ax.in0) ? base + ay.i1 * W + ax.i0 : -1;
    id.w = (ay.in1 && ax.in1) ? base + ay.i1 * W + ax.i1 : -1;
    const int r = (p * kTaps + k) * G + g;   // output order: (pixel, tap, group)
    sIdx[r] = id;
    sWt[r] = make_float4(ax.w0, ax.w1, ay.w0, ay.w1);
    sM[r] = __ldg(mk + j);
  }
  __syncthreads();
  PROF(1);

  // phase 2: output vectors in output order, (pixel, tap, group, vector)
  const int vecs = Cin / G / VEC;        // vectors per group
  const int row = Cin / VEC;             // vectors per (pixel, tap)
  V* ob = reinterpret_cast<V*>(out + pix0 * kTaps * Cin);
  for (int u = threadIdx.x; u < np * tg * vecs; u += kThreads) {
    const int r = u / vecs;
    const int ch = (u - (u / row) * row) * VEC;
    const int4 id = sIdx[r];
    const float4 wt = sWt[r];
    const float* xc = x + ch;
    const V zero = zero_v(V());
    const V v00 = id.x >= 0 ? ldv(reinterpret_cast<const V*>(xc + id.x * Cin)) : zero;
    const V v01 = id.y >= 0 ? ldv(reinterpret_cast<const V*>(xc + id.y * Cin)) : zero;
    const V v10 = id.z >= 0 ? ldv(reinterpret_cast<const V*>(xc + id.z * Cin)) : zero;
    const V v11 = id.w >= 0 ? ldv(reinterpret_cast<const V*>(xc + id.w * Cin)) : zero;
    const V res = blend(v00, v01, v10, v11, wt.x, wt.y, wt.z, wt.w, sM[r]);
    __stcs(ob + u, res);  // streaming: the patches are read once, by the contraction
  }
  PROF(2);
}

// ---------------------------------------------------------------- backward

// The per-sample sums of the backward, each over the group's channels in
// channel order: the two products that make up each corner weight's
// gradient (kept apart, as autograd reduces each product on its own) and
// the modulation's.
struct BwdSums {
  float x0a, x0b, x1a, x1b;   // d wx0 = x0a + x0b, d wx1 = x1a + x1b
  float y0a, y0b, y1a, y1b;   // d wy0 = y0a + y0b, d wy1 = y1a + y1b
  float m;                    // d m
};

// One channel: accumulate into s; returns the four corners' grad_x terms.
__device__ __forceinline__ float4 bwd_channel(float g, float v00, float v01, float v10, float v11,
                                              float wx0, float wx1, float wy0, float wy1, float m,
                                              BwdSums& s) {
  const float ds = __fmul_rn(g, m);
  const float ta = __fmul_rn(ds, wy0);     // d (v00 * wx0) and d (v01 * wx1)
  const float tc = __fmul_rn(ds, wy1);     // d (v10 * wx0) and d (v11 * wx1)
  s.x0a = __fadd_rn(s.x0a, __fmul_rn(ta, v00));
  s.x0b = __fadd_rn(s.x0b, __fmul_rn(tc, v10));
  s.x1a = __fadd_rn(s.x1a, __fmul_rn(ta, v01));
  s.x1b = __fadd_rn(s.x1b, __fmul_rn(tc, v11));
  s.y0a = __fadd_rn(s.y0a, __fmul_rn(ds, __fmul_rn(v00, wx0)));
  s.y0b = __fadd_rn(s.y0b, __fmul_rn(ds, __fmul_rn(v01, wx1)));
  s.y1a = __fadd_rn(s.y1a, __fmul_rn(ds, __fmul_rn(v10, wx0)));
  s.y1b = __fadd_rn(s.y1b, __fmul_rn(ds, __fmul_rn(v11, wx1)));
  const float a = __fmul_rn(__fmul_rn(v00, wx0), wy0);
  const float b = __fmul_rn(__fmul_rn(v01, wx1), wy0);
  const float c = __fmul_rn(__fmul_rn(v10, wx0), wy1);
  const float d = __fmul_rn(__fmul_rn(v11, wx1), wy1);
  s.m = __fadd_rn(s.m, __fmul_rn(g, __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d)));
  return make_float4(__fmul_rn(ta, wx0), __fmul_rn(ta, wx1), __fmul_rn(tc, wx0),
                     __fmul_rn(tc, wx1));
}

// -(d w0 * r0) + d w1 * r1: the gradient of the axis's position (and so of
// its offset), frac's derivative being 1 and floor's 0.
__device__ __forceinline__ float axis_grad(float dw0, float dw1, const Axis& a) {
  const float t0 = a.r0 ? dw0 : __fmul_rn(dw0, 0.0f);
  const float t1 = a.r1 ? dw1 : __fmul_rn(dw1, 0.0f);
  return __fadd_rn(-t0, t1);
}

#ifdef VOSESAM_PROFILE
// per backward block: start, geometry and loads done, grad_x's atomics
// issued, done (ns)
__device__ unsigned long long g_prof_bwd[1 << 16][4];
#define PROF_BWD(slot)                                                        \
  do {                                                                        \
    const unsigned blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); \
    if (threadIdx.x == 0 && blk < (1u << 16)) g_prof_bwd[blk][slot] = now_ns(); \
  } while (0)
#else
#define PROF_BWD(slot) do {} while (0)
#endif

// The fixed-order butterfly over the VECS lanes of one sample: every lane
// ends with the same bits, the same in every call.
template <int VECS>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 1; o < VECS; o <<= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int VECS>
__device__ __forceinline__ void lane_sums(BwdSums& s) {
  s.x0a = lane_sum<VECS>(s.x0a); s.x0b = lane_sum<VECS>(s.x0b);
  s.x1a = lane_sum<VECS>(s.x1a); s.x1b = lane_sum<VECS>(s.x1b);
  s.y0a = lane_sum<VECS>(s.y0a); s.y0b = lane_sum<VECS>(s.y0b);
  s.y1a = lane_sum<VECS>(s.y1a); s.y1b = lane_sum<VECS>(s.y1b);
  s.m = lane_sum<VECS>(s.m);
}

// VECS = cg / 4 lanes per (pixel, tap, group) sample,
// one 4-channel chunk each, samples in the grad's order. Each lane
// recomputes the sample's geometry (make_axis, the forward's cell), loads
// its chunk of the grad and of the four corners, sums its four channels in
// order and adds its corner terms to grad_x with 16-byte vector atomics;
// the lanes' partial sums meet in a fixed-order butterfly, so grad_offset /
// grad_mask are the same bits in every call.
template <int VECS>
__global__ void __launch_bounds__(kThreads)
deform_bwd_lanes_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                        const float* __restrict__ mask, const float* __restrict__ grad,
                        float* __restrict__ grad_x, float* __restrict__ grad_offset,
                        float* __restrict__ grad_mask, int n_samples, int H, int W, int Cin,
                        int G, int radius) {
  PROF_BWD(0);
  const int u = blockIdx.x * kThreads + threadIdx.x;
  const int s0 = u / VECS, cv = u % VECS;
  const bool active = s0 < n_samples;
  const int s_id = active ? s0 : n_samples - 1;   // the tail's lanes still shuffle
  const int g = s_id % G, pk = s_id / G;
  const int pix = pk / kTaps, k = pk - pix * kTaps;
  const int hw = H * W, img = pix / hw, yx = pix - img * hw;
  const int py = yx / W, px = yx - py * W;
  const int j = (pix * G + g) * kTaps + k;                  // the offsets' and mask's layout
  const float2 o = __ldg(reinterpret_cast<const float2*>(offset) + j);   // (y, x)
  const float m = __ldg(mask + j);
  const Axis ay = make_axis(py, o.x, static_cast<float>(k / 3 - 1), H, radius);
  const Axis ax = make_axis(px, o.y, static_cast<float>(k % 3 - 1), W, radius);
  const int cg = Cin / G, c = cv * 4;
  const int at = img * hw;
  int id[4];                                                // corner element offsets, -1 outside
  id[0] = (ay.in0 && ax.in0) ? (at + ay.i0 * W + ax.i0) * Cin + g * cg + c : -1;
  id[1] = (ay.in0 && ax.in1) ? (at + ay.i0 * W + ax.i1) * Cin + g * cg + c : -1;
  id[2] = (ay.in1 && ax.in0) ? (at + ay.i1 * W + ax.i0) * Cin + g * cg + c : -1;
  id[3] = (ay.in1 && ax.in1) ? (at + ay.i1 * W + ax.i1) * Cin + g * cg + c : -1;
  // a corner the radius rule drops adds an exact zero to grad_x: skipped
  const bool kept[4] = {ay.r0 && ax.r0, ay.r0 && ax.r1, ay.r1 && ax.r0, ay.r1 && ax.r1};
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 gv = __ldg(reinterpret_cast<const float4*>(grad + s_id * cg + c));
  float4 v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = id[q] >= 0 ? __ldg(reinterpret_cast<const float4*>(x + id[q])) : zero;
  PROF_BWD(1);
  const float gs[4] = {gv.x, gv.y, gv.z, gv.w};
  const float a[4] = {v[0].x, v[0].y, v[0].z, v[0].w}, b[4] = {v[1].x, v[1].y, v[1].z, v[1].w};
  const float cc[4] = {v[2].x, v[2].y, v[2].z, v[2].w}, d[4] = {v[3].x, v[3].y, v[3].z, v[3].w};
  BwdSums s = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float t[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 r = bwd_channel(gs[e], a[e], b[e], cc[e], d[e], ax.w0, ax.w1, ay.w0, ay.w1, m, s);
    t[0][e] = r.x; t[1][e] = r.y; t[2][e] = r.z; t[3][e] = r.w;
  }
  if (active) {
    // sm_90: a 16-byte vector atomic in global memory (atomic per element);
    // the VECS lanes of a corner cover its cg contiguous floats
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (id[q] >= 0 && kept[q])
        atomicAdd(reinterpret_cast<float4*>(grad_x + id[q]),
                  make_float4(t[q][0], t[q][1], t[q][2], t[q][3]));
  }
  PROF_BWD(2);
  lane_sums<VECS>(s);
  if (active && cv == 0) {
    const float dy = axis_grad(__fadd_rn(s.y0a, s.y0b), __fadd_rn(s.y1a, s.y1b), ay);
    const float dx = axis_grad(__fadd_rn(s.x0a, s.x0b), __fadd_rn(s.x1a, s.x1b), ax);
    reinterpret_cast<float2*>(grad_offset)[j] = make_float2(dy, dx);
    grad_mask[j] = s.m;
  }
  PROF_BWD(3);
}

// cg / 4 no power of two up to 32, or unaligned tensors: one thread per
// sample walks the group's channels one by one, with scalar loads and
// atomics.
__global__ void __launch_bounds__(kThreads)
deform_bwd_sample_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                         const float* __restrict__ mask, const float* __restrict__ grad,
                         float* __restrict__ grad_x, float* __restrict__ grad_offset,
                         float* __restrict__ grad_mask, int n_samples, int H, int W, int Cin,
                         int G, int radius) {
  const int s_id = blockIdx.x * kThreads + threadIdx.x;   // (pixel, tap, group)
  if (s_id >= n_samples) return;
  const int g = s_id % G;
  const int pk = s_id / G;
  const int pix = pk / kTaps, k = pk - pix * kTaps;
  const int hw = H * W;
  const int img = pix / hw, yx = pix - img * hw;
  const int py = yx / W, px = yx - py * W;
  const int j = (pix * G + g) * kTaps + k;
  const float2 o = __ldg(reinterpret_cast<const float2*>(offset) + j);
  const float m = __ldg(mask + j);
  const Axis ay = make_axis(py, o.x, static_cast<float>(k / 3 - 1), H, radius);
  const Axis ax = make_axis(px, o.y, static_cast<float>(k % 3 - 1), W, radius);
  const int at = img * hw;
  const int cg = Cin / G;
  int id[4];
  id[0] = (ay.in0 && ax.in0) ? (at + ay.i0 * W + ax.i0) * Cin + g * cg : -1;
  id[1] = (ay.in0 && ax.in1) ? (at + ay.i0 * W + ax.i1) * Cin + g * cg : -1;
  id[2] = (ay.in1 && ax.in0) ? (at + ay.i1 * W + ax.i0) * Cin + g * cg : -1;
  id[3] = (ay.in1 && ax.in1) ? (at + ay.i1 * W + ax.i1) * Cin + g * cg : -1;
  const bool kept[4] = {ay.r0 && ax.r0, ay.r0 && ax.r1, ay.r1 && ax.r0, ay.r1 && ax.r1};
  BwdSums s = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float* gp = grad + s_id * cg;
  for (int c = 0; c < cg; ++c) {
    const float v00 = id[0] >= 0 ? __ldg(x + id[0] + c) : 0.f;
    const float v01 = id[1] >= 0 ? __ldg(x + id[1] + c) : 0.f;
    const float v10 = id[2] >= 0 ? __ldg(x + id[2] + c) : 0.f;
    const float v11 = id[3] >= 0 ? __ldg(x + id[3] + c) : 0.f;
    const float4 r = bwd_channel(__ldg(gp + c), v00, v01, v10, v11, ax.w0, ax.w1, ay.w0, ay.w1,
                                 m, s);
    const float t[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (id[q] >= 0 && kept[q]) atomicAdd(grad_x + id[q] + c, t[q]);
  }
  const float dy = axis_grad(__fadd_rn(s.y0a, s.y0b), __fadd_rn(s.y1a, s.y1b), ay);
  const float dx = axis_grad(__fadd_rn(s.x0a, s.x0b), __fadd_rn(s.x1a, s.x1b), ax);
  reinterpret_cast<float2*>(grad_offset)[j] = make_float2(dy, dx);
  grad_mask[j] = s.m;
}

size_t smem_bytes(int P, int G) { return (size_t)P * kTaps * G * 36; }

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// info: registers per thread, static shared bytes, dynamic shared bytes,
// resident blocks per SM, threads per block, local (spill) bytes per thread.
template <typename K>
int occupancy(K kernel, size_t smem, int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = (cudaError_t)prepare(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = fa.numRegs;
  info[1] = (int)fa.sharedSizeBytes;
  info[2] = (int)smem;
  info[3] = blocks;
  info[4] = kThreads;
  info[5] = (int)fa.localSizeBytes;
  return 0;
}

}  // namespace

// x (B, H, W, Cin), offset (B, H, W, 2 * G * 9), mask (B, H, W, G * 9),
// out (B, H, W, 9, Cin), all contiguous fp32, offset 8-byte aligned, fewer
// than 2^31 elements each. radius < 0: unbounded. vec: 4 for 16-byte
// accesses (cg % 4 == 0 and 16-byte aligned x / out), else 1.
// pixels: pixels per block (P).
extern "C" int vosesam_deform_patches(
    const float* x, const float* offset, const float* mask, float* out,
    int B, int H, int W, int Cin, int G, int radius, int vec, int pixels,
    void* stream_ptr) {
  if (B < 0 || H < 1 || W < 1 || G < 1 || Cin < G || Cin % G != 0 || pixels < 1)
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  if (vec == 4 && (Cin / G) % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)B * H * W;
  if (n_pix * kTaps * Cin > 2147483647LL || n_pix * 2 * kTaps * G > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return (int)cudaSuccess;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = smem_bytes(pixels, G);
  const unsigned blocks = (unsigned)((n_pix + pixels - 1) / pixels);
  if (vec == 4) {
    const int err = prepare(deform_patches_kernel<4>, smem);
    if (err != 0) return err;
    deform_patches_kernel<4><<<blocks, kThreads, smem, stream>>>(
        x, offset, mask, out, (int)n_pix, pixels, H, W, Cin, G, radius);
  } else {
    const int err = prepare(deform_patches_kernel<1>, smem);
    if (err != 0) return err;
    deform_patches_kernel<1><<<blocks, kThreads, smem, stream>>>(
        x, offset, mask, out, (int)n_pix, pixels, H, W, Cin, G, radius);
  }
  return (int)cudaGetLastError();
}

// The occupancy of the instance that a launch at (vec, pixels, G) selects,
// as the card reports it; info gets six ints (see occupancy()).
extern "C" int vosesam_deform_occupancy(int vec, int pixels, int G, int* info) {
  if (pixels < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(pixels, G);
  return vec == 4 ? occupancy(deform_patches_kernel<4>, smem, info)
                  : occupancy(deform_patches_kernel<1>, smem, info);
}

namespace {

template <int VECS>
void launch_lanes(const float* x, const float* offset, const float* mask, const float* grad,
                  float* grad_x, float* grad_offset, float* grad_mask, int n_samples, int H,
                  int W, int Cin, int G, int radius, cudaStream_t stream) {
  const long long threads = (long long)n_samples * VECS;
  deform_bwd_lanes_kernel<VECS><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                                  stream>>>(x, offset, mask, grad, grad_x, grad_offset, grad_mask,
                                            n_samples, H, W, Cin, G, radius);
}

// The backward's lanes per sample: cg / 4 where that is a power of two
// up to 32 and the accesses can be 16 bytes wide; 0 for the scalar kernel.
int lanes_for(int vec, int cg) {
  if (vec != 4 || cg % 4 != 0) return 0;
  const int v = cg / 4;
  return (v <= 32 && (v & (v - 1)) == 0) ? v : 0;
}

}  // namespace

// x (B, H, W, Cin), offset (B, H, W, 2 * G * 9), mask (B, H, W, G * 9),
// grad (B, H, W, 9, Cin): contiguous fp32, offset 8-byte aligned; grad_x
// (zeroed by the caller), grad_offset and grad_mask of the inputs' shapes.
// vec: 4 for 16-byte accesses (cg % 4 == 0 and 16-byte aligned x, grad,
// grad_x), else 1. The same 32-bit limits as the forward. lanes_for picks
// the lanes kernel, else the scalar one.
extern "C" int vosesam_deform_patches_backward(
    const float* x, const float* offset, const float* mask, const float* grad,
    float* grad_x, float* grad_offset, float* grad_mask,
    int B, int H, int W, int Cin, int G, int radius, int vec, void* stream_ptr) {
  if (B < 0 || H < 1 || W < 1 || G < 1 || Cin < G || Cin % G != 0)
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  if (vec == 4 && (Cin / G) % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)B * H * W;
  if (n_pix * kTaps * Cin > 2147483647LL || n_pix * 2 * kTaps * G > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return (int)cudaSuccess;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_samples = (int)(n_pix * kTaps * G);
  switch (lanes_for(vec, Cin / G)) {
    case 1: launch_lanes<1>(x, offset, mask, grad, grad_x, grad_offset, grad_mask, n_samples, H, W, Cin, G, radius, stream); break;
    case 2: launch_lanes<2>(x, offset, mask, grad, grad_x, grad_offset, grad_mask, n_samples, H, W, Cin, G, radius, stream); break;
    case 4: launch_lanes<4>(x, offset, mask, grad, grad_x, grad_offset, grad_mask, n_samples, H, W, Cin, G, radius, stream); break;
    case 8: launch_lanes<8>(x, offset, mask, grad, grad_x, grad_offset, grad_mask, n_samples, H, W, Cin, G, radius, stream); break;
    case 16: launch_lanes<16>(x, offset, mask, grad, grad_x, grad_offset, grad_mask, n_samples, H, W, Cin, G, radius, stream); break;
    case 32: launch_lanes<32>(x, offset, mask, grad, grad_x, grad_offset, grad_mask, n_samples, H, W, Cin, G, radius, stream); break;
    default:
      deform_bwd_sample_kernel<<<(unsigned)((n_samples + kThreads - 1) / kThreads), kThreads, 0,
                                 stream>>>(x, offset, mask, grad, grad_x, grad_offset,
                                           grad_mask, n_samples, H, W, Cin, G, radius);
  }
  return (int)cudaGetLastError();
}

// The occupancy of the instance a launch at (vec, cg) selects; info as above.
extern "C" int vosesam_deform_backward_occupancy(int vec, int cg, int* info) {
  if (cg < 1) return (int)cudaErrorInvalidValue;
  switch (lanes_for(vec, cg)) {
    case 1: return occupancy(deform_bwd_lanes_kernel<1>, 0, info);
    case 2: return occupancy(deform_bwd_lanes_kernel<2>, 0, info);
    case 4: return occupancy(deform_bwd_lanes_kernel<4>, 0, info);
    case 8: return occupancy(deform_bwd_lanes_kernel<8>, 0, info);
    case 16: return occupancy(deform_bwd_lanes_kernel<16>, 0, info);
    case 32: return occupancy(deform_bwd_lanes_kernel<32>, 0, info);
    default: return occupancy(deform_bwd_sample_kernel, 0, info);
  }
}

#ifdef VOSESAM_PROFILE
extern "C" int vosesam_deform_profile(void* dst, int n_blocks) {
  return (int)cudaMemcpyFromSymbol(dst, g_prof, (size_t)n_blocks * 4 * 8);
}

extern "C" int vosesam_deform_backward_profile(void* dst, int n_blocks) {
  return (int)cudaMemcpyFromSymbol(dst, g_prof_bwd, (size_t)n_blocks * 4 * 8);
}
#endif
