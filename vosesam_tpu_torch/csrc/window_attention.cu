// Whole-window attention with a factorised relative-position bias, for
// Hopper (sm_90a):
//
//   out = softmax(scale * q.k^T + bh[q, k / ww] + bw[q, k % ww]) . v
//
// over (W, heads, T, D) tensors, T = wh * ww tokens of one window on a
// row-major grid (SAM's ViT: 14 x 14 = 196 tokens, D = 80, 16 heads).
//
// Replaces the two Pallas TPU kernels of
// vosesam_tpu/ops/pallas/flash_attention.py, window_attention_relpos (one
// grid step per (window, head)) and window_attention_relpos_mh (one step per
// window, heads looped inside). They compute one function and differ only
// in how the TPU grid amortises its per-step cost; here one kernel with one
// block per (window, head) serves both, so that even a single frame (15
// windows x 16 heads) puts 240 blocks on the 132 SMs.
//
// What bounds it on the H100: bytes. Per (window, head) the two products
// are 4 * T^2 * D = 12.3 MFLOP against 4 * T * D * 2 + T * (wh + ww) * 4 =
// 147 KB of q/k/v/out/bh/bw: 84 operations per byte, below the card's ~295
// for bf16. So the design reads every input from device memory exactly
// once: the whole window's Q, K, V (bf16) and the rows' bias factors go
// into shared memory by 16-byte asynchronous copies (cp.async, all in
// flight at once) and sit there together (~130 KB at T 196, D 80, above
// the 48 KB default, hence the opt-in below), and nothing but the output is
// written. With all T keys present the softmax is one pass: no running
// maximum, no rescaling of the accumulator.
//
//   bf16 (window_relpos_bf16): 8 warps; a warp owns 16 query rows at a time
//     and keeps their whole score rows (16 x T) in registers as mma.sync
//     m16n8k16 accumulators. Scores, bias add, maximum, exponent and row sum
//     are fp32; the probabilities are rounded to bf16 for P.V while the row
//     sum keeps the fp32 values; out = acc / max(l, 1e-30), as the TPU
//     kernels do (flash_attention.py:153-158). V stays row-major in shared
//     memory; ldmatrix.trans turns its 8x8 tiles into B-fragments.
//   fp32 (window_relpos_f32): one thread per query row on FFMA, 32-key
//     tiles through shared memory with an online softmax, for fp32 checks.
//
// q, k, v and out are addressed through (window, head, token) element
// strides with a dense last axis, so the encoder hands in the views of its
// fused qkv projection and gets (W, T, heads * D) back without copies.
// Keys past T score -inf, rows past T are not stored, padded rows and
// channels are zero in shared memory (D need not be a multiple of 16).
// What the card showed (PERF.md): with 8 warps of ~230 registers on an SM
// the kernel is bound by its instruction stream, not by its loads; a 4-warp block
// that reads Q straight from device memory, so that two blocks fit an SM,
// was no faster. Fewer registers per warp (a split of the key axis), TMA
// staging and wgmma are later work.
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

using vosesam::cp_async16;
using vosesam::cp_async_wait_all;
using vosesam::ldmatrix_x4_trans;
using vosesam::mma_bf16;
using vosesam::pack_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;          // bf16 row padding: conflict-free fragment loads
constexpr int kMaxTokens = 256;  // largest window (score rows live in registers)
constexpr int kKeyTile = 32;     // fp32 kernel: keys per shared-memory tile

struct Strides {
  long long w, h, t;  // elements between windows, heads, tokens
};

// Rows [0, rows) x channels [0, DP) of one (T, D) matrix into shared memory
// with row stride LD; zero outside (T, D).
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long st, int T, int D, int rows, int DP,
                                           int LD, bool vec, int tid) {
  if (vec) {  // D % 8 == 0, every stride % 8 == 0, base 16-byte aligned
    const int cpr = DP / 8;
    for (int i = tid; i < rows * cpr; i += kThreads) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      const bool ok = r < T && c < D;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)r * st + c : src, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < rows * DP; i += kThreads) {
      const int r = i / DP, c = i - r * DP;
      dst[r * LD + c] = (r < T && c < D) ? src[(size_t)r * st + c] : zero;
    }
  }
}

// n floats of one (window, head)'s bias factor into shared memory, zeros up
// to n_pad.
__device__ __forceinline__ void stage_bias(float* dst, const float* src, int n, int n_pad,
                                           int tid) {
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int i = tid * 4; i < n; i += kThreads * 4) cp_async16(dst + i, src + i, true);
    for (int i = n + tid; i < n_pad; i += kThreads) dst[i] = 0.f;
  } else {
    for (int i = tid; i < n_pad; i += kThreads) dst[i] = (i < n) ? src[i] : 0.f;
  }
}

template <int NK16>  // 16-key steps held in registers: NK16 * 16 >= T
__global__ void __launch_bounds__(kThreads) window_relpos_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bh,
    const float* __restrict__ bw, __nv_bfloat16* __restrict__ out,
    Strides qs, Strides ks, Strides vs, Strides os,
    int heads, int T, int D, int wh, int ww, float scale, int vec) {
  constexpr int KEYS = NK16 * 16;
  const int DP = (D + 15) & ~15;   // D padded to the mma k-step
  const int LD = DP + kPad;
  const int MT = (T + 15) / 16;    // 16-row query tiles
  const int ROWS = MT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + ROWS * LD;
  __nv_bfloat16* sV = sK + KEYS * LD;
  float* sBh = reinterpret_cast<float*>(sV + KEYS * LD);
  float* sBw = sBh + ROWS * wh;
  int* sRC = reinterpret_cast<int*>(sBw + ROWS * ww);  // key j -> (j / ww) << 16 | j % ww

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group: fragment row
  const int t4 = lane & 3;   // thread in group: fragment column pair
  const long long win = blockIdx.x / heads, head = blockIdx.x % heads;

  stage_bf16(sQ, q + win * qs.w + head * qs.h, qs.t, T, D, ROWS, DP, LD, vec, tid);
  stage_bf16(sK, k + win * ks.w + head * ks.h, ks.t, T, D, KEYS, DP, LD, vec, tid);
  stage_bf16(sV, v + win * vs.w + head * vs.h, vs.t, T, D, KEYS, DP, LD, vec, tid);
  const float* bhp = bh + (size_t)blockIdx.x * T * wh;
  const float* bwp = bw + (size_t)blockIdx.x * T * ww;
  stage_bias(sBh, bhp, T * wh, ROWS * wh, tid);
  stage_bias(sBw, bwp, T * ww, ROWS * ww, tid);
  for (int j = tid; j < KEYS; j += kThreads) sRC[j] = ((j / ww) << 16) | (j % ww);
  cp_async_wait_all();
  __syncthreads();

  __nv_bfloat16* ob = out + win * os.w + head * os.h;
  for (int mt = warp; mt < MT; mt += kWarps) {
    const int r0 = mt * 16;
    // S = Q.K^T for 16 rows x KEYS keys
    float s[2 * NK16][4];
#pragma unroll
    for (int nt = 0; nt < 2 * NK16; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int kd = 0; kd < DP; kd += 16) {
      uint32_t a[4];
      const __nv_bfloat16* qa = sQ + (r0 + g) * LD + kd + t4 * 2;
      a[0] = *reinterpret_cast<const uint32_t*>(qa);
      a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
      a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
      const __nv_bfloat16* kb = sK + g * LD + kd + t4 * 2;
#pragma unroll
      for (int nt = 0; nt < 2 * NK16; ++nt) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb + nt * 8 * LD);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + nt * 8 * LD + 8);
        mma_bf16(s[nt], a, b0, b1);
      }
    }
    // scale, add the factorised bias, mask the keys past T; row maxima
    const float* bh0 = sBh + (r0 + g) * wh;
    const float* bh1 = bh0 + 8 * wh;
    const float* bw0 = sBw + (r0 + g) * ww;
    const float* bw1 = bw0 + 8 * ww;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2 * NK16; ++nt) {
      const int2 rc = *reinterpret_cast<const int2*>(sRC + nt * 8 + t4 * 2);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + t4 * 2 + e;
        if (j < T) {
          const int code = e ? rc.y : rc.x;
          const int jr = code >> 16, jc = code & 0xffff;
          s[nt][e] = s[nt][e] * scale + (bh0[jr] + bw0[jc]);
          s[nt][e + 2] = s[nt][e + 2] * scale + (bh1[jr] + bw1[jc]);
        } else {
          s[nt][e] = -INFINITY;
          s[nt][e + 2] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][e + 2]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // P = exp(S - max) with its fp32 row sum; two score n-tiles make one
    // bf16 A-fragment of 16 keys
    float l0 = 0.f, l1 = 0.f;
    uint32_t pa[NK16][4];
#pragma unroll
    for (int kk = 0; kk < NK16; ++kk) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int nt = 2 * kk + h2;
        // __expf: one ex2.approx on the special-function unit (relative
        // error ~2^-21, far below the bf16 rounding of P that follows)
        const float p0 = __expf(s[nt][0] - mx0), p1 = __expf(s[nt][1] - mx0);
        const float p2 = __expf(s[nt][2] - mx1), p3 = __expf(s[nt][3] - mx1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[kk][2 * h2] = pack_bf16(p0, p1);
        pa[kk][2 * h2 + 1] = pack_bf16(p2, p3);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    // O = P.V, 16 output channels at a time
    const int mrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // key row of this lane's ldmatrix address
    const int mcol = (lane >> 4) * 8;                     // channel offset of its 8x8 tile
    const int row0 = r0 + g, row1 = row0 + 8;
    for (int dc = 0; dc < DP; dc += 16) {
      float o[2][4];
      o[0][0] = o[0][1] = o[0][2] = o[0][3] = 0.f;
      o[1][0] = o[1][1] = o[1][2] = o[1][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK16; ++kk) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sV + (kk * 16 + mrow) * LD + dc + mcol);
        mma_bf16(o[0], pa[kk], b[0], b[1]);
        mma_bf16(o[1], pa[kk], b[2], b[3]);
      }
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        const int c = dc + n2 * 8 + t4 * 2;
        if (vec) {  // D % 8 == 0: the pair lies inside D, 4-byte aligned
          if (c < D) {
            if (row0 < T)
              *reinterpret_cast<uint32_t*>(ob + row0 * os.t + c) =
                  pack_bf16(o[n2][0] * inv0, o[n2][1] * inv0);
            if (row1 < T)
              *reinterpret_cast<uint32_t*>(ob + row1 * os.t + c) =
                  pack_bf16(o[n2][2] * inv1, o[n2][3] * inv1);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (c + e < D) {
              if (row0 < T) ob[row0 * os.t + c + e] = __float2bfloat16(o[n2][e] * inv0);
              if (row1 < T) ob[row1 * os.t + c + e] = __float2bfloat16(o[n2][e + 2] * inv1);
            }
          }
        }
      }
    }
  }
}

// fp32: one thread per query row; 32-key K / V tiles through shared memory,
// each read from device memory once per (window, head); online softmax,
// output accumulator in registers.
template <int DP>
__global__ void __launch_bounds__(kMaxTokens) window_relpos_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bh,
    const float* __restrict__ bw, float* __restrict__ out,
    Strides qs, Strides ks, Strides vs, Strides os,
    int heads, int T, int D, int wh, int ww, float scale) {
  constexpr int LDQ = DP + 1;
  constexpr int LDS = kKeyTile + 1;
  const int nthreads = blockDim.x;   // >= T
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + nthreads * LDQ;
  float* sV = sK + kKeyTile * DP;
  float* sS = sV + kKeyTile * DP;

  const int t = threadIdx.x;
  const long long win = blockIdx.x / heads, head = blockIdx.x % heads;
  const float* qb = q + win * qs.w + head * qs.h;
  const float* kb = k + win * ks.w + head * ks.h;
  const float* vb = v + win * vs.w + head * vs.h;
  for (int i = t; i < nthreads * DP; i += nthreads) {
    const int r = i / DP, c = i - r * DP;
    sQ[r * LDQ + c] = (r < T && c < D) ? qb[(size_t)r * qs.t + c] : 0.f;
  }
  const bool live = t < T;
  const float* bhr = bh + ((size_t)blockIdx.x * T + (live ? t : 0)) * wh;
  const float* bwr = bw + ((size_t)blockIdx.x * T + (live ? t : 0)) * ww;
  const float* qrow = sQ + t * LDQ;
  float* srow = sS + t * LDS;

  float m = -1e30f, l = 0.f;
  float o[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) o[d] = 0.f;

  for (int k0 = 0; k0 < T; k0 += kKeyTile) {
    __syncthreads();  // every thread is done with the previous K / V tile
    for (int i = t; i < kKeyTile * DP; i += nthreads) {
      const int r = i / DP, c = i - r * DP;
      const bool ok = k0 + r < T && c < D;
      sK[i] = ok ? kb[(size_t)(k0 + r) * ks.t + c] : 0.f;
      sV[i] = ok ? vb[(size_t)(k0 + r) * vs.t + c] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    float mx = -1e30f;
    for (int j = 0; j < kKeyTile; ++j) {
      float sc = -INFINITY;
      const int jj = k0 + j;
      if (jj < T) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DP; ++d) acc = fmaf(qrow[d], sK[j * DP + d], acc);
        const int jr = jj / ww, jc = jj - jr * ww;
        sc = acc * scale + (bhr[jr] + bwr[jc]);
      }
      srow[j] = sc;
      mx = fmaxf(mx, sc);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DP; ++d) o[d] *= alpha;
    for (int j = 0; j < kKeyTile; ++j) {
      const float p = expf(srow[j] - mn);
      l += p;
#pragma unroll
      for (int d = 0; d < DP; ++d) o[d] = fmaf(p, sV[j * DP + d], o[d]);
    }
  }
  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = out + win * os.w + head * os.h + (size_t)t * os.t;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) orow[d] = o[d] * inv;
  }
}

struct Args {
  const void *q, *k, *v;
  const float *bh, *bw;
  void* out;
  Strides qs, ks, vs, os;
  int W, heads, T, D, wh, ww;
  float scale;
  cudaStream_t stream;
};

template <int NK16>
int launch_bf16(const Args& a) {
  const int DP = (a.D + 15) & ~15, LD = DP + kPad;
  const int rows = (a.T + 15) / 16 * 16, keys = NK16 * 16;
  const size_t smem = (size_t)(rows + 2 * keys) * LD * 2 +
                      (size_t)rows * (a.wh + a.ww) * 4 + (size_t)keys * 4;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  auto by8 = [](const Strides& s) { return s.w % 8 == 0 && s.h % 8 == 0 && s.t % 8 == 0; };
  const int vec = a.D % 8 == 0 && aligned(a.q) && aligned(a.k) && aligned(a.v) &&
                  aligned(a.out) && by8(a.qs) && by8(a.ks) && by8(a.vs) && by8(a.os);
  cudaError_t err = cudaFuncSetAttribute(
      window_relpos_bf16<NK16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_relpos_bf16<NK16><<<a.W * a.heads, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.bh, a.bw, static_cast<__nv_bfloat16*>(a.out),
      a.qs, a.ks, a.vs, a.os, a.heads, a.T, a.D, a.wh, a.ww, a.scale, vec);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_f32(const Args& a) {
  constexpr int DP = 16 * KS;
  const int nthreads = (a.T + 31) / 32 * 32;
  const size_t smem = (size_t)(nthreads * (DP + 1) + 2 * kKeyTile * DP +
                               nthreads * (kKeyTile + 1)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      window_relpos_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_relpos_f32<DP><<<a.W * a.heads, nthreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bh, a.bw, static_cast<float*>(a.out),
      a.qs, a.ks, a.vs, a.os, a.heads, a.T, a.D, a.wh, a.ww, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: (W, heads, T, D) bf16 (is_bf16) or fp32, addressed by their
// (window, head, token) element strides, last axis dense; bh: (W, heads, T,
// wh) fp32 contiguous; bw: (W, heads, T, ww) fp32 contiguous; T == wh * ww,
// 1 <= T <= 256, 1 <= D <= 128.
extern "C" int vosesam_window_attention_relpos(
    const void* q, const void* k, const void* v, const float* bh, const float* bw,
    void* out, int is_bf16, int W, int heads, int T, int D, int wh, int ww,
    const long long* strides,  // q, k, v, out: (window, head, token) each
    float scale, void* stream_ptr) {
  if (W < 1 || heads < 1 || T < 1 || T > kMaxTokens || D < 1 || D > 128 || wh < 1 ||
      ww < 1 || wh * ww != T || (long long)W * heads > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.bh = bh; a.bw = bw; a.out = out;
  a.qs = {strides[0], strides[1], strides[2]};
  a.ks = {strides[3], strides[4], strides[5]};
  a.vs = {strides[6], strides[7], strides[8]};
  a.os = {strides[9], strides[10], strides[11]};
  a.W = W; a.heads = heads; a.T = T; a.D = D; a.wh = wh; a.ww = ww;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16) {
    const int need = (T + 15) / 16;
    if (need <= 2) return launch_bf16<2>(a);
    if (need <= 4) return launch_bf16<4>(a);
    if (need <= 8) return launch_bf16<8>(a);
    if (need <= 13) return launch_bf16<13>(a);
    return launch_bf16<16>(a);
  }
  switch ((D + 15) / 16) {
    case 1: return launch_f32<1>(a);
    case 2: return launch_f32<2>(a);
    case 3: return launch_f32<3>(a);
    case 4: return launch_f32<4>(a);
    case 5: return launch_f32<5>(a);
    case 6: return launch_f32<6>(a);
    case 7: return launch_f32<7>(a);
    default: return launch_f32<8>(a);
  }
}
