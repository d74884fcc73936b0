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
// in how the TPU grid amortises its per-step cost; here one kernel serves
// both names.
//
// What bounds it on the H100: bytes. Per (window, head) the two products
// are 4 * T^2 * D = 12.3 MFLOP against 4 * T * D * 2 + T * (wh + ww) * 4 =
// 147 KB of q/k/v/out/bh/bw: 84 operations per byte, below the card's ~295
// for bf16. What held the first design (one block of 8 warps per
// (window, head), all of Q/K/V in 134 KB of shared memory, whole 16 x 208
// score rows in ~230 registers a thread) at 4x that bound was latency: one
// block an SM, every load finished before the first product. This design:
//
//   bf16 (window_relpos_bf16): a block of 8 warps owns (window, head, 128
//     query rows): every warp one 16-row query tile, 2 blocks per
//     (window, head) at T 196, launched next to each other so that the
//     second reads K / V from L2. Keys stream in chunks of 64 through a
//     three-stage cp.async ring (chunks i + 1 and i + 2 fly while chunk i is
//     computed; the last chunk is ragged: 196 = 3 * 64 + 4), each chunk in
//     pieces of 32 keys with the running maximum and rescale of an online
//     softmax (the ragged piece one masked 16-key step). A warp holds 16 x 32
//     scores, its 16 x D output and its Q fragments: at most 128 registers a
//     thread (launch bounds 256 x 2; ptxas still spills 20 bytes at D 80);
//     95 KB of shared memory, so 2 blocks (16 warps) are resident per SM.
//     Q goes from device memory straight into mma A-fragments; K fragments
//     come by ldmatrix.x4, V's by ldmatrix.x4.trans. The bias factors of the
//     block's rows arrive by cp.async with chunk 0 and are turned into
//     (row g, row g + 8) float2 pairs, so each pair of scores costs one int2
//     code load and two float2 loads.
//     Numerics: fp32 scores, scale and bias, fp32 running max and row sum;
//     P rounded to bf16 for P.V (mma.sync m16n8k16, fp32 accumulation);
//     out = acc / max(l, 1e-30), as the TPU kernels do
//     (flash_attention.py:153-158). The online rescale is the only change
//     from the one-pass softmax of the first design.
//   fp32 (window_relpos_f32): one thread per query row on FFMA, 32-key
//     tiles through shared memory with an online softmax, for fp32 checks.
//
// q, k, v and out are addressed through (window, head, token) element
// strides with a dense last axis, so the encoder hands in the views of its
// fused qkv projection and gets (W, T, heads * D) back without copies.
// Keys past T score -inf, rows past T are not stored, padded rows and
// channels are zero (D need not be a multiple of 16).
// vosesam_window_attention_occupancy reports each instance's registers,
// shared memory and resident blocks per SM on the card.
// Built with -DVOSESAM_PROFILE, thread 0 of every block stamps the global
// timer at the ends of its phases (python -m vosesam_tpu_torch.ops.kernels.phases).
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
using vosesam::cp_async_commit;
using vosesam::cp_async_wait;
using vosesam::ldmatrix_x4;
using vosesam::ldmatrix_x4_trans;
using vosesam::mma_bf16;
using vosesam::pack_bf16;

constexpr int kWarps = 8;        // bf16: warps (= 16-row query tiles) per block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;       // bf16: keys per streamed K / V chunk
constexpr int kStages = 3;       // bf16: K / V chunks in flight or in use
constexpr int kPad = 8;          // bf16 row padding: conflict-free ldmatrix rows
constexpr int kMaxTokens = 256;  // largest window
constexpr int kKeyTile = 32;     // fp32 kernel: keys per shared-memory tile
constexpr float kNegInit = -1e30f;

#ifdef VOSESAM_PROFILE
// per block: start, chunk 0 ready, end of each of up to 6 chunks, done (ns)
__device__ unsigned long long g_prof[1 << 16][8];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define PROF(slot)                                                            \
  do {                                                                        \
    if (threadIdx.x == 0 && blockIdx.x < (1 << 16))  \
      g_prof[blockIdx.x][slot] = now_ns();           \
  } while (0)
#else
#define PROF(slot) do {} while (0)
#endif

struct Strides {
  long long w, h, t;  // elements between windows, heads, tokens
};

// Keys [k0, k0 + kChunk) x channels [0, DP) of one (T, D) matrix into shared
// memory with row stride LD; zero outside (T, D). vec: 16-byte cp.async.
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            long long st, int k0, int T, int D, int DP,
                                            int LD, bool vec, int tid) {
  if (vec) {  // D % 8 == 0, every stride % 8 == 0, base 16-byte aligned
    const int cpr = DP / 8;
    for (int i = tid; i < kChunk * cpr; i += kThreads) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      const bool ok = k0 + r < T && c < D;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)(k0 + r) * st + c : src, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < kChunk * DP; i += kThreads) {
      const int r = i / DP, c = i - r * DP;
      dst[r * LD + c] = (k0 + r < T && c < D) ? src[(size_t)(k0 + r) * st + c] : zero;
    }
  }
}

// n floats of device memory into shared memory (16-byte copies where the
// source is aligned), zeros up to n_pad.
__device__ __forceinline__ void stage_bias(float* dst, const float* src, int n, int n_pad,
                                           int tid) {
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int i = tid * 4; i < n; i += kThreads * 4) {
      if (i + 4 <= n) {
        cp_async16(dst + i, src + i, true);
      } else {
        for (int j = i; j < n; ++j) dst[j] = src[j];
      }
    }
  } else {
    for (int i = tid; i < n; i += kThreads) dst[i] = src[i];
  }
  for (int i = n + tid; i < n_pad; i += kThreads) dst[i] = 0.f;
}

// The bf16 pair (row, c), (row, c + 1) of q as one mma A-fragment register;
// zero outside (T, D).
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, long long st,
                                              int row, int c, int T, int D, bool vec) {
  if (row >= T || c >= D) return 0u;
  const __nv_bfloat16* p = base + (size_t)row * st + c;
  if (vec) return *reinterpret_cast<const uint32_t*>(p);  // c even, D % 8 == 0
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = (c + 1 < D) ? p[1] : __float2bfloat16(0.f);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One key chunk of one warp's 16 query rows: NK 16-key steps (4 for a full
// chunk), TAIL masks the keys past T. Updates the running max (m0, m1), the
// thread's share of the row sums (l0, l1) and the output accumulators.
template <int KS, int NK, bool TAIL>
__device__ __forceinline__ void window_chunk(
    const __nv_bfloat16* sK, const __nv_bfloat16* sV, const int* sRC,
    const float2* bh2, const float2* bw2, int k0, int T, int LD, float scale,
    const uint32_t (&qf)[KS][4], float (&o)[2 * KS][4],
    float& m0, float& m1, float& l0, float& l1, int lane) {
  const int t4 = lane & 3;
  // S = Q.K^T for 16 rows x 16 NK keys; ldmatrix lane address: matrix
  // lane / 8 = (key half, channel half), row lane % 8
  const int krow = ((lane >> 4) << 3) + (lane & 7);
  const int kcol = ((lane >> 3) & 1) * 8;
  float s[2 * NK][4];
#pragma unroll
  for (int nt = 0; nt < 2 * NK; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int np = 0; np < NK; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, sK + (np * 16 + krow) * LD + ks * 16 + kcol);
      mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
    }
  }
  // scale, add the factorised bias, mask the keys past T; chunk maxima
  float mx0 = kNegInit, mx1 = kNegInit;
#pragma unroll
  for (int nt = 0; nt < 2 * NK; ++nt) {
    const int jl = nt * 8 + t4 * 2;
    const int2 rc = *reinterpret_cast<const int2*>(sRC + k0 + jl);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (TAIL && k0 + jl + e >= T) {
        s[nt][e] = -INFINITY;
        s[nt][e + 2] = -INFINITY;
      } else {
        const int code = e ? rc.y : rc.x;
        const float2 hb = bh2[code >> 16], wb = bw2[code & 0xffff];
        s[nt][e] = s[nt][e] * scale + (hb.x + wb.x);
        s[nt][e + 2] = s[nt][e + 2] * scale + (hb.y + wb.y);
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
  // __expf: one ex2.approx on the special-function unit (relative error
  // ~2^-21, far below the bf16 rounding of P that follows)
  const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  l0 *= a0;
  l1 *= a1;
#pragma unroll
  for (int i = 0; i < 2 * KS; ++i) {
    o[i][0] *= a0;
    o[i][1] *= a0;
    o[i][2] *= a1;
    o[i][3] *= a1;
  }
  // P = exp(S - max) with its fp32 row sum; two score n-tiles make one bf16
  // A-fragment of 16 keys; O += P.V, 16 output channels per ldmatrix
  const int mrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // key row of this lane's address
  const int mcol = (lane >> 4) * 8;                     // channel offset of its 8x8 tile
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t pa[4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int nt = 2 * kk + h2;
      const float p0 = __expf(s[nt][0] - mn0), p1 = __expf(s[nt][1] - mn0);
      const float p2 = __expf(s[nt][2] - mn1), p3 = __expf(s[nt][3] - mn1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[2 * h2] = pack_bf16(p0, p1);
      pa[2 * h2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int dc = 0; dc < KS; ++dc) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sV + (kk * 16 + mrow) * LD + dc * 16 + mcol);
      mma_bf16(o[2 * dc], pa, b[0], b[1]);
      mma_bf16(o[2 * dc + 1], pa, b[2], b[3]);
    }
  }
}

template <int KS>  // D padded to KS * 16
__global__ void __launch_bounds__(kThreads, (KS <= 6 ? 16 : 8) / kWarps) window_relpos_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bh,
    const float* __restrict__ bw, __nv_bfloat16* __restrict__ out,
    Strides qs, Strides ks, Strides vs, Strides os,
    int heads, int T, int D, int wh, int ww, float scale, int vec) {
  constexpr int DP = 16 * KS;
  constexpr int LD = DP + kPad;
  constexpr int STAGE = kChunk * LD;  // bf16 elements of one K (or V) chunk
  const int n_chunks = (T + kChunk - 1) / kChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // [kStages][STAGE]
  __nv_bfloat16* sV = sK + kStages * STAGE;                    // [kStages][STAGE]
  float2* sBh = reinterpret_cast<float2*>(sV + kStages * STAGE);  // [kWarps * 8][wh]
  float2* sBw = sBh + kWarps * 8 * wh;                            // [kWarps * 8][ww]
  float* sRawH = reinterpret_cast<float*>(sBw + kWarps * 8 * ww);  // [kWarps * 16][wh]
  float* sRawW = sRawH + kWarps * 16 * wh;                         // [kWarps * 16][ww]
  int* sRC = reinterpret_cast<int*>(sRawW + kWarps * 16 * ww);     // key -> jr << 16 | jc

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // the query-row groups of one (window, head) are neighbouring blocks, so
  // that they run together and the second reads K / V from L2
  const int groups = (T + kWarps * 16 - 1) / (kWarps * 16);
  const long long wh_idx = blockIdx.x / groups;
  const long long win = wh_idx / heads, head = wh_idx % heads;
  const int r0 = (int)(blockIdx.x % groups) * (kWarps * 16);  // first query row of the block
  const bool active = r0 + warp * 16 < T;     // this warp owns a query tile
  const __nv_bfloat16* kb = k + win * ks.w + head * ks.h;
  const __nv_bfloat16* vb = v + win * vs.w + head * vs.h;

  PROF(0);
  // the block's rows of the bias factors, as they lie in device memory,
  // with chunk 0 in the first copy group, chunk 1 in the second
  const float* bhp = bh + ((size_t)wh_idx * T + r0) * wh;
  const float* bwp = bw + ((size_t)wh_idx * T + r0) * ww;
  const int rows_in = min(kWarps * 16, T - r0);
  stage_bias(sRawH, bhp, rows_in * wh, kWarps * 16 * wh, tid);
  stage_bias(sRawW, bwp, rows_in * ww, kWarps * 16 * ww, tid);
  stage_chunk(sK, kb, ks.t, 0, T, D, DP, LD, vec, tid);
  stage_chunk(sV, vb, vs.t, 0, T, D, DP, LD, vec, tid);
  cp_async_commit();
  if (n_chunks > 1) {
    stage_chunk(sK + STAGE, kb, ks.t, kChunk, T, D, DP, LD, vec, tid);
    stage_chunk(sV + STAGE, vb, vs.t, kChunk, T, D, DP, LD, vec, tid);
    cp_async_commit();
  }
  for (int j = tid; j < n_chunks * kChunk; j += kThreads)
    sRC[j] = j < T ? ((j / ww) << 16) | (j % ww) : 0;

  // this warp's 16 query rows as A-fragments, one per 16-wide k-step
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  const __nv_bfloat16* qb = q + win * qs.w + head * qs.h;
  uint32_t qf[KS][4];
#pragma unroll
  for (int kd = 0; kd < KS; ++kd) {
    const int c = kd * 16 + t4 * 2;
    qf[kd][0] = load_pair(qb, qs.t, ra, c, T, D, vec);
    qf[kd][1] = load_pair(qb, qs.t, rb, c, T, D, vec);
    qf[kd][2] = load_pair(qb, qs.t, ra, c + 8, T, D, vec);
    qf[kd][3] = load_pair(qb, qs.t, rb, c + 8, T, D, vec);
  }
  const float2* bh2 = sBh + (warp * 8 + g) * wh;
  const float2* bw2 = sBw + (warp * 8 + g) * ww;

  float m0 = kNegInit, m1 = kNegInit;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;            // this thread's share of the row sums
  float o[2 * KS][4];
#pragma unroll
  for (int i = 0; i < 2 * KS; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    // chunks c + 1 and c + 2 fly while chunk c is computed
    if (c + 2 < n_chunks) {
      const int nb = (c + 2) % kStages;
      stage_chunk(sK + nb * STAGE, kb, ks.t, (c + 2) * kChunk, T, D, DP, LD, vec, tid);
      stage_chunk(sV + nb * STAGE, vb, vs.t, (c + 2) * kChunk, T, D, DP, LD, vec, tid);
      cp_async_commit();
      cp_async_wait<2>();
    } else if (c + 1 < n_chunks) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (c == 0) {
      // the bias factors as (row g, row g + 8) pairs of each tile
      for (int i = tid; i < kWarps * 16 * wh; i += kThreads) {
        const int lr = i / wh, jr = i - lr * wh;
        const int pair = (lr >> 4) * 8 + (lr & 7);
        reinterpret_cast<float*>(sBh)[(pair * wh + jr) * 2 + ((lr >> 3) & 1)] = sRawH[i];
      }
      for (int i = tid; i < kWarps * 16 * ww; i += kThreads) {
        const int lr = i / ww, jc = i - lr * ww;
        const int pair = (lr >> 4) * 8 + (lr & 7);
        reinterpret_cast<float*>(sBw)[(pair * ww + jc) * 2 + ((lr >> 3) & 1)] = sRawW[i];
      }
      __syncthreads();
      PROF(1);
    }
    if (active) {
      const __nv_bfloat16* cK = sK + (c % kStages) * STAGE;
      const __nv_bfloat16* cV = sV + (c % kStages) * STAGE;
      // the chunk in pieces of 32 keys, each one online-softmax step: a
      // warp holds 16 x 32 scores at a time (registers); the piece that
      // reaches T masks the keys past it
      const int c_keys = min(kChunk, T - c * kChunk);
      for (int kp = 0; kp < c_keys; kp += 32) {
        const int k0 = c * kChunk + kp;
        const __nv_bfloat16* pK = cK + kp * LD;
        const __nv_bfloat16* pV = cV + kp * LD;
        if (kp + 32 <= c_keys) {
          window_chunk<KS, 2, false>(pK, pV, sRC, bh2, bw2, k0, T, LD, scale, qf, o,
                                     m0, m1, l0, l1, lane);
        } else if (kp + 16 >= c_keys) {
          window_chunk<KS, 1, true>(pK, pV, sRC, bh2, bw2, k0, T, LD, scale, qf, o,
                                    m0, m1, l0, l1, lane);
        } else {
          window_chunk<KS, 2, true>(pK, pV, sRC, bh2, bw2, k0, T, LD, scale, qf, o,
                                    m0, m1, l0, l1, lane);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    if (c < 5) PROF(2 + c);
  }
  if (!active) return;

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + win * os.w + head * os.h;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    const int c = n * 8 + t4 * 2;
    if (vec) {  // D % 8 == 0: the pair lies inside D, 4-byte aligned
      if (c < D) {
        if (ra < T)
          *reinterpret_cast<uint32_t*>(ob + (size_t)ra * os.t + c) =
              pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
        if (rb < T)
          *reinterpret_cast<uint32_t*>(ob + (size_t)rb * os.t + c) =
              pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e < D) {
          if (ra < T) ob[(size_t)ra * os.t + c + e] = __float2bfloat16(o[n][e] * inv0);
          if (rb < T) ob[(size_t)rb * os.t + c + e] = __float2bfloat16(o[n][e + 2] * inv1);
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

size_t bf16_smem(int KS, int T, int wh, int ww) {
  const int LD = 16 * KS + kPad;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  return (size_t)2 * kStages * kChunk * LD * 2 + (size_t)kWarps * 8 * (wh + ww) * 8 +
         (size_t)kWarps * 16 * (wh + ww) * 4 + (size_t)n_chunks * kChunk * 4;
}

size_t f32_smem(int DP, int T) {
  const int nthreads = (T + 31) / 32 * 32;
  return (size_t)(nthreads * (DP + 1) + 2 * kKeyTile * DP + nthreads * (kKeyTile + 1)) * 4;
}

template <int KS>
int launch_bf16(const Args& a) {
  const size_t smem = bf16_smem(KS, a.T, a.wh, a.ww);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  auto by8 = [](const Strides& s) { return s.w % 8 == 0 && s.h % 8 == 0 && s.t % 8 == 0; };
  const int vec = a.D % 8 == 0 && aligned(a.q) && aligned(a.k) && aligned(a.v) &&
                  aligned(a.out) && by8(a.qs) && by8(a.ks) && by8(a.vs) && by8(a.os);
  cudaError_t err = cudaFuncSetAttribute(
      window_relpos_bf16<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.W * a.heads * ((a.T + kWarps * 16 - 1) / (kWarps * 16)));
  window_relpos_bf16<KS><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.bh, a.bw, static_cast<__nv_bfloat16*>(a.out),
      a.qs, a.ks, a.vs, a.os, a.heads, a.T, a.D, a.wh, a.ww, a.scale, vec);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_f32(const Args& a) {
  constexpr int DP = 16 * KS;
  const int nthreads = (a.T + 31) / 32 * 32;
  const size_t smem = f32_smem(DP, a.T);
  cudaError_t err = cudaFuncSetAttribute(
      window_relpos_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_relpos_f32<DP><<<a.W * a.heads, nthreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bh, a.bw, static_cast<float*>(a.out),
      a.qs, a.ks, a.vs, a.os, a.heads, a.T, a.D, a.wh, a.ww, a.scale);
  return (int)cudaGetLastError();
}

// info: registers per thread, static shared bytes, dynamic shared bytes,
// resident blocks per SM, threads per block, local (spill) bytes per thread.
template <typename K>
int occupancy(K kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = fa.numRegs;
  info[1] = (int)fa.sharedSizeBytes;
  info[2] = (int)smem;
  info[3] = blocks;
  info[4] = threads;
  info[5] = (int)fa.localSizeBytes;
  return 0;
}

template <int KS>
int occupancy_at(int is_bf16, int T, int wh, int ww, int* info) {
  if (is_bf16)
    return occupancy(window_relpos_bf16<KS>, kThreads, bf16_smem(KS, T, wh, ww), info);
  return occupancy(window_relpos_f32<16 * KS>, (T + 31) / 32 * 32, f32_smem(16 * KS, T), info);
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
      ww < 1 || wh * ww != T || (long long)W * heads * 2 > 2147483647LL)
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
  switch ((D + 15) / 16) {
    case 1: return is_bf16 ? launch_bf16<1>(a) : launch_f32<1>(a);
    case 2: return is_bf16 ? launch_bf16<2>(a) : launch_f32<2>(a);
    case 3: return is_bf16 ? launch_bf16<3>(a) : launch_f32<3>(a);
    case 4: return is_bf16 ? launch_bf16<4>(a) : launch_f32<4>(a);
    case 5: return is_bf16 ? launch_bf16<5>(a) : launch_f32<5>(a);
    case 6: return is_bf16 ? launch_bf16<6>(a) : launch_f32<6>(a);
    case 7: return is_bf16 ? launch_bf16<7>(a) : launch_f32<7>(a);
    default: return is_bf16 ? launch_bf16<8>(a) : launch_f32<8>(a);
  }
}

// The occupancy of the instance that a launch at (is_bf16, T, D, wh, ww)
// selects, as the card reports it; info gets six ints (see occupancy()).
extern "C" int vosesam_window_attention_occupancy(int is_bf16, int T, int D, int wh, int ww,
                                                  int* info) {
  if (T < 1 || T > kMaxTokens || D < 1 || D > 128 || wh * ww != T)
    return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16) {
    case 1: return occupancy_at<1>(is_bf16, T, wh, ww, info);
    case 2: return occupancy_at<2>(is_bf16, T, wh, ww, info);
    case 3: return occupancy_at<3>(is_bf16, T, wh, ww, info);
    case 4: return occupancy_at<4>(is_bf16, T, wh, ww, info);
    case 5: return occupancy_at<5>(is_bf16, T, wh, ww, info);
    case 6: return occupancy_at<6>(is_bf16, T, wh, ww, info);
    case 7: return occupancy_at<7>(is_bf16, T, wh, ww, info);
    default: return occupancy_at<8>(is_bf16, T, wh, ww, info);
  }
}

#ifdef VOSESAM_PROFILE
extern "C" int vosesam_window_attention_profile(void* dst, int n_blocks) {
  return (int)cudaMemcpyFromSymbol(dst, g_prof, (size_t)n_blocks * 8 * 8);
}
#endif
