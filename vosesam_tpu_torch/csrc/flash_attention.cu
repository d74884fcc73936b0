// Flash attention with a factorised relative-position bias, for Hopper
// (sm_90a):
//
//   out = softmax(scale * q.k^T + bh[q, k / gw] + bw[q, k % gw]) . v
//
// over (BH, N, D) tensors, N = gh * gw keys on a row-major token grid.
//
// Replaces the Pallas TPU kernel vosesam_tpu/ops/pallas/flash_attention.py
// flash_attention_relpos (the SAM ViT's global-attention blocks). The TPU
// kernel rebuilt each bias tile with one-hot matmuls because Mosaic cannot
// slice lanes; here a block stages its query rows' bh (64 x gh) and bw
// (64 x gw) fp32 factors in shared memory and adds bh[r][j / gw] +
// bw[r][j % gw] to each score, so the (N, N) bias never exists.
//
// What bounds it on the H100: the two products, 4 * BH * N^2 * D operations
// (85.9 GFLOP for vit_h's square grid, 16 heads, N = 4096, D = 80: 0.087 ms
// at 989 TFLOP/s bf16) against ~55 MB of q/k/v/o/bh/bw (0.016 ms at
// 3.35 TB/s), and a second floor of the same order in the BH * N^2 exps on
// the special-function units. The design keeps every score in registers:
//
//   bf16 (flash_relpos_bf16): one block of 4 warps owns (b*head, 64-query
//     tile); each warp 16 query rows. Q stays in registers as mma.sync
//     A-fragments; 64-key K and V tiles (V transposed) loop through shared
//     memory; Q.K^T and P.V are mma.sync m16n8k16 bf16 with fp32
//     accumulation (D = 80 is five k-steps). The softmax is online and in
//     fp32; the probabilities are cast to bf16 before the P.V product (as
//     the TPU kernel, flash_attention.py:106-110); out = acc / max(l, 1e-30).
//   fp32 (flash_relpos_f32): the same blocking on FFMA, one thread per
//     query row, for the fp32 checks.
//
// The ragged N is masked (keys past N score -inf, rows past N are not
// stored); a D that is not a multiple of 16 is zero-padded in shared
// memory. wgmma, TMA and warp specialisation are later work.
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

constexpr int kTile = 64;           // queries per block and keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;             // bf16 row padding against bank conflicts
constexpr float kNegInit = -1e30f;  // the TPU kernel's running-max start

using vosesam::mma_bf16;
using vosesam::pack_bf16;

// Stage the block's bias factor rows: sB[r][c] = b[(q0 + r) * g + c].
__device__ __forceinline__ void stage_bias(float* sB, const float* b, int q0,
                                           int N, int g, int tid, int nthreads) {
  for (int i = tid; i < kTile * g; i += nthreads) {
    const int r = i / g;
    sB[i] = (q0 + r < N) ? b[(size_t)(q0 + r) * g + (i - r * g)] : 0.f;
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads) flash_relpos_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bh,
    const float* __restrict__ bw, __nv_bfloat16* __restrict__ out,
    int N, int D, int gh, int gw, float scale) {
  constexpr int DP = 16 * KS;        // D padded to the mma k-step
  constexpr int LD = DP + kPad;      // sQ / sK row stride
  constexpr int LDV = kTile + kPad;  // sVt row stride
  constexpr int NTO = DP / 8;        // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kTile * LD;
  __nv_bfloat16* sVt = sK + kTile * LD;
  float* sBh = reinterpret_cast<float*>(sVt + DP * LDV);
  float* sBw = sBh + kTile * gh;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group: fragment row
  const int t4 = lane & 3;   // thread in group: fragment column pair
  const int q0 = blockIdx.x * kTile;
  const size_t head = blockIdx.y;
  const __nv_bfloat16* qh = q + head * N * D;
  const __nv_bfloat16* kh = k + head * N * D;
  const __nv_bfloat16* vh = v + head * N * D;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < kTile * DP; i += kThreads) {
    const int r = i / DP, c = i - r * DP;
    sQ[r * LD + c] = (q0 + r < N && c < D) ? qh[(size_t)(q0 + r) * D + c] : zero;
  }
  stage_bias(sBh, bh + head * N * gh, q0, N, gh, tid, kThreads);
  stage_bias(sBw, bw + head * N * gw, q0, N, gw, tid, kThreads);
  __syncthreads();

  // this warp's 16 query rows as A-fragments, one per 16-wide k-step
  uint32_t qf[KS][4];
  const int wr = warp * 16;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + t4 * 2;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(&sQ[(wr + g) * LD + c]);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(&sQ[(wr + g + 8) * LD + c]);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(&sQ[(wr + g) * LD + c + 8]);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(&sQ[(wr + g + 8) * LD + c + 8]);
  }
  const float* bh_r0 = sBh + (wr + g) * gh;
  const float* bh_r1 = sBh + (wr + g + 8) * gh;
  const float* bw_r0 = sBw + (wr + g) * gw;
  const float* bw_r1 = sBw + (wr + g + 8) * gw;

  float m0 = kNegInit, m1 = kNegInit;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;            // this thread's share of the row sums
  float o[NTO][4];
#pragma unroll
  for (int i = 0; i < NTO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  const int n_tiles = (N + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K / V tile
    for (int i = tid; i < kTile * DP; i += kThreads) {
      const int r = i / DP, c = i - r * DP;
      const bool ok = k0 + r < N && c < D;
      const size_t off = (size_t)(k0 + r) * D + c;
      sK[r * LD + c] = ok ? kh[off] : zero;
      sVt[c * LDV + r] = ok ? vh[off] : zero;
    }
    __syncthreads();

    // S = Q.K^T for 16 rows x 64 keys: eight m16n8 accumulators
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = sK + (nt * 8 + g) * LD + t4 * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + ks * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 8);
        mma_bf16(s[nt], qf[ks], b0, b1);
      }
    }
    // scale, add the factorised bias, mask the ragged keys; row maxima
    float mx0 = kNegInit, mx1 = kNegInit;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + nt * 8 + t4 * 2 + e;
        if (j < N) {
          const int jr = j / gw, jc = j - jr * gw;
          s[nt][e] = s[nt][e] * scale + (bh_r0[jr] + bw_r0[jc]);
          s[nt][e + 2] = s[nt][e + 2] * scale + (bh_r1[jr] + bw_r1[jc]);
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
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int i = 0; i < NTO; ++i) {
      o[i][0] *= a0;
      o[i][1] *= a0;
      o[i][2] *= a1;
      o[i][3] *= a1;
    }
    // O += P.V: two score n-tiles make one A-fragment of 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < NTO; ++dn) {
        const __nv_bfloat16* vrow = sVt + (dn * 8 + g) * LDV + kk * 16 + t4 * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8);
        mma_bf16(o[dn], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  __nv_bfloat16* oh = out + head * N * D;
#pragma unroll
  for (int dn = 0; dn < NTO; ++dn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = dn * 8 + t4 * 2 + e;
      if (c < D) {
        if (r0 < N) oh[(size_t)r0 * D + c] = __float2bfloat16(o[dn][e] * inv0);
        if (r1 < N) oh[(size_t)r1 * D + c] = __float2bfloat16(o[dn][e + 2] * inv1);
      }
    }
  }
}

// fp32: one thread per query row, scores of a 64-key tile through shared
// memory, output accumulator in registers.
template <int DP>
__global__ void __launch_bounds__(kTile) flash_relpos_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bh,
    const float* __restrict__ bw, float* __restrict__ out,
    int N, int D, int gh, int gw, float scale) {
  constexpr int LDQ = DP + 1;
  constexpr int LDS = kTile + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + kTile * LDQ;
  float* sV = sK + kTile * DP;
  float* sS = sV + kTile * DP;
  float* sBh = sS + kTile * LDS;
  float* sBw = sBh + kTile * gh;

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kTile;
  const size_t head = blockIdx.y;
  const float* qh = q + head * N * D;
  const float* kh = k + head * N * D;
  const float* vh = v + head * N * D;
  for (int i = t; i < kTile * DP; i += kTile) {
    const int r = i / DP, c = i - r * DP;
    sQ[r * LDQ + c] = (q0 + r < N && c < D) ? qh[(size_t)(q0 + r) * D + c] : 0.f;
  }
  stage_bias(sBh, bh + head * N * gh, q0, N, gh, t, kTile);
  stage_bias(sBw, bw + head * N * gw, q0, N, gw, t, kTile);

  float m = kNegInit, l = 0.f;
  float o[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) o[d] = 0.f;
  const float* qrow = sQ + t * LDQ;
  float* srow = sS + t * LDS;
  const float* bhr = sBh + t * gh;
  const float* bwr = sBw + t * gw;

  const int n_tiles = (N + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    for (int i = t; i < kTile * DP; i += kTile) {
      const int r = i / DP, c = i - r * DP;
      const bool ok = k0 + r < N && c < D;
      const size_t off = (size_t)(k0 + r) * D + c;
      sK[i] = ok ? kh[off] : 0.f;
      sV[i] = ok ? vh[off] : 0.f;
    }
    __syncthreads();
    float mx = kNegInit;
    for (int j = 0; j < kTile; ++j) {
      float sc = -INFINITY;
      const int jj = k0 + j;
      if (jj < N) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DP; ++d) acc = fmaf(qrow[d], sK[j * DP + d], acc);
        const int jr = jj / gw, jc = jj - jr * gw;
        sc = acc * scale + (bhr[jr] + bwr[jc]);
      }
      srow[j] = sc;
      mx = fmaxf(mx, sc);
    }
    const float mn = fmaxf(m, mx);
    const float a = expf(m - mn);
    m = mn;
    l *= a;
#pragma unroll
    for (int d = 0; d < DP; ++d) o[d] *= a;
    for (int j = 0; j < kTile; ++j) {
      const float p = expf(srow[j] - mn);
      l += p;
#pragma unroll
      for (int d = 0; d < DP; ++d) o[d] = fmaf(p, sV[j * DP + d], o[d]);
    }
  }
  const int r = q0 + t;
  if (r < N) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = out + head * N * D + (size_t)r * D;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) orow[d] = o[d] * inv;
  }
}

template <int KS>
int launch_bf16(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                const void* v, const float* bh, const float* bw, void* out,
                int N, int D, int gh, int gw, float scale) {
  constexpr int DP = 16 * KS;
  const size_t smem = (size_t)(2 * kTile * (DP + kPad) + DP * (kTile + kPad)) * 2 +
                      (size_t)kTile * (gh + gw) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_relpos_bf16<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_relpos_bf16<KS><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bh, bw,
      static_cast<__nv_bfloat16*>(out), N, D, gh, gw, scale);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_f32(dim3 grid, cudaStream_t stream, const void* q, const void* k,
               const void* v, const float* bh, const float* bw, void* out,
               int N, int D, int gh, int gw, float scale) {
  constexpr int DP = 16 * KS;
  const size_t smem = (size_t)(kTile * (DP + 1) + 2 * kTile * DP + kTile * (kTile + 1) +
                               kTile * (gh + gw)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_relpos_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_relpos_f32<DP><<<grid, kTile, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bh, bw, static_cast<float*>(out),
      N, D, gh, gw, scale);
  return (int)cudaGetLastError();
}

template <int KS>
int dispatch(int is_bf16, dim3 grid, cudaStream_t s, const void* q, const void* k,
             const void* v, const float* bh, const float* bw, void* out,
             int N, int D, int gh, int gw, float scale) {
  return is_bf16 ? launch_bf16<KS>(grid, s, q, k, v, bh, bw, out, N, D, gh, gw, scale)
                 : launch_f32<KS>(grid, s, q, k, v, bh, bw, out, N, D, gh, gw, scale);
}

}  // namespace

// q, k, v, out: (BH, N, D) contiguous, bf16 (is_bf16) or fp32;
// bh: (BH, N, gh) fp32; bw: (BH, N, gw) fp32; N == gh * gw; 1 <= D <= 128.
extern "C" int vosesam_flash_attention_relpos(
    const void* q, const void* k, const void* v, const float* bh, const float* bw,
    void* out, int is_bf16, int BH, int N, int D, int gh, int gw, float scale,
    void* stream_ptr) {
  if (BH < 1 || N < 1 || D < 1 || D > 128 || gh < 1 || gw < 1 || gh * gw != N ||
      BH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((N + kTile - 1) / kTile, BH);
  switch ((D + 15) / 16) {
    case 1: return dispatch<1>(is_bf16, grid, s, q, k, v, bh, bw, out, N, D, gh, gw, scale);
    case 2: return dispatch<2>(is_bf16, grid, s, q, k, v, bh, bw, out, N, D, gh, gw, scale);
    case 3: return dispatch<3>(is_bf16, grid, s, q, k, v, bh, bw, out, N, D, gh, gw, scale);
    case 4: return dispatch<4>(is_bf16, grid, s, q, k, v, bh, bw, out, N, D, gh, gw, scale);
    case 5: return dispatch<5>(is_bf16, grid, s, q, k, v, bh, bw, out, N, D, gh, gw, scale);
    case 6: return dispatch<6>(is_bf16, grid, s, q, k, v, bh, bw, out, N, D, gh, gw, scale);
    case 7: return dispatch<7>(is_bf16, grid, s, q, k, v, bh, bw, out, N, D, gh, gw, scale);
    default: return dispatch<8>(is_bf16, grid, s, q, k, v, bh, bw, out, N, D, gh, gw, scale);
  }
}
