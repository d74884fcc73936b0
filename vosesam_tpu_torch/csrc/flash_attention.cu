// Flash attention with a factorised relative-position bias, for Hopper
// (sm_90a):
//
//   out = softmax(scale * q.k^T + bh[q, k / gw] + bw[q, k % gw]) . v
//
// over (B, heads, N, D) tensors, N = gh * gw keys on a row-major token grid.
//
// Replaces the Pallas TPU kernel vosesam_tpu/ops/pallas/flash_attention.py
// flash_attention_relpos (the SAM ViT's global-attention blocks). The TPU
// kernel rebuilt each bias tile with one-hot matmuls because Mosaic cannot
// slice lanes; here a block stages its query rows' bh (rows x gh) and bw
// (rows x gw) fp32 factors in shared memory and adds bh[r][j / gw] +
// bw[r][j % gw] to each score, so the (N, N) bias never exists.
//
// What bounds it on the H100: operations. The two products are
// 4 * B * heads * N^2 * D operations (27.2 GFLOP at vit_h's rect grid,
// 16 heads, N = 2304, D = 80: 0.027 ms at 989 TFLOP/s bf16) against 23.6 MB
// of q/k/v/o and 14.7 MB of bias factors (0.011 ms at 3.35 TB/s); a second
// floor of the same order is the B * heads * N^2 exponentials on the
// special-function units. What held
// the first design (a block of 4 warps per 64 queries, ~31x its bound) was
// everything around the products: 2-byte K / V loads with an integer divide
// per element, V transposed by scalar stores, two barriers and no copy in
// flight per key tile, an integer divide per score, 4 warps a block. This
// design:
//
//   bf16 (flash_relpos_bf16): a block of two warpgroups (8 warps) owns
//     (b, head, 128 query rows), a warpgroup 64 rows, a warp 16; the blocks
//     of one (b, head) are neighbours in the 1-D grid, so co-resident blocks
//     read K / V from L2. 64-key K and V tiles arrive by TMA into a
//     two-stage ring: thread 0 starts one 5-D bulk tensor copy per matrix
//     and tile (a box of 8 channels x 64 tokens x D / 8 chunks, the 16-byte
//     chunk a map dimension of stride 16 bytes, so the box lands chunk-major:
//     wgmma's no-swizzle core matrices, chunk c of row r at byte
//     (c * rows + r) * 16); the copies complete on the stage's mbarrier and
//     the hardware zero-fills rows past N; one block barrier per tile frees
//     the stage the next copy refills. (One copy per 16-byte chunk, 20 a
//     tile, kept thread 0 issuing for several times as long, and the
//     barrier made that wait every warp's.) (Tensors TMA cannot
//     describe, D % 8 != 0, unaligned or with a stride-0 axis, are staged
//     by plain loads in the same layout.) Q.K^T and P.V are wgmma products read straight from
//     shared memory: D / 16 m64n64k16 for the scores (Q from registers, K
//     K-major) and 4 x D / 16 m64n16k16 for the output (P from registers in
//     the m16n8k16 A-fragment layout, V MN-major, transposed by the
//     hardware). Q and the block's bias factor rows arrive first (Q by TMA
//     into the second stage's buffer, which tile 1 takes over once Q is in
//     registers; the factors by cp.async, each thread scaling what it
//     copied by log2(e)), and the scale carries log2(e) too, so the softmax
//     runs on ex2. A tile's first key has its grid row and column in
//     running counters: no integer divide per score; for gw even and >= 64
//     a thread's key pairs share a grid row and the pair's bw is one
//     float2. Only the last, ragged tile masks keys past N. The softmax is
//     online and in fp32, its maxima and sums as trees; P is rounded to
//     bf16 for P.V as the TPU kernel does (flash_attention.py:106-110);
//     out = acc / max(l, 1e-30). Two blocks per SM (launch bounds 256 x 2:
//     128 registers, no spill at D 80; 94 KB of shared memory at rect, 110
//     KB square), so four warpgroups share an SM and one's softmax overlaps
//     another's products; the same blocks with mma.sync products fed by
//     ldmatrix, or one block per SM, measured slower.
//   fp32 (flash_relpos_f32): one thread per query row on FFMA, 64-key tiles
//     through shared memory, for the fp32 checks.
//
// q, k, v and out are addressed through (batch, head, token) element strides
// with a dense last axis, so the encoder hands in the views of its fused qkv
// projection and gets (B, N, heads * D) memory back without copies. Keys
// past N score -inf, rows past N are not stored, padded rows and channels
// are zero (D need not be a multiple of 16).
// vosesam_flash_attention_occupancy reports each instance's registers,
// shared memory and resident blocks per SM on the card.
// Built with -DVOSESAM_PROFILE, thread 0 of every block stamps the global
// timer at the ends of its phases and counts the clock cycles of each part
// of a tile (python -m vosesam_tpu_torch.ops.kernels.phases).
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

using vosesam::cp_async16;
using vosesam::cp_async_commit;
using vosesam::cp_async_wait;
using vosesam::ldmatrix_x4;
using vosesam::pack_bf16;

constexpr int kWarps = 8;            // bf16: warps per block (two warpgroups)
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;   // bf16: query rows per block
constexpr int kTile = 64;            // keys per K / V tile; fp32: query rows per block
constexpr int kStages = 2;           // bf16: K / V tiles in the ring
constexpr float kNegInit = -1e30f;   // the TPU kernel's running-max start
constexpr float kLog2e = 1.4426950408889634f;

#ifdef VOSESAM_PROFILE
// per block (thread 0): start, Q ready, summed wait at the tile barriers,
// summed tile compute, tiles, end of the loop, done (global timer, ns);
// then summed SM clock cycles of the tiles' parts: issuing the next tile's
// copies, Q.K^T, the softmax, P.V. Sums run in shared memory and reach
// device memory once, at the end.
__device__ unsigned long long g_prof[1 << 16][12];
__shared__ unsigned long long s_prof[12];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define PROF_SET(slot, v)                     \
  do {                                        \
    if (threadIdx.x == 0) s_prof[slot] = (v); \
  } while (0)
#define PROF_ADD(slot, v)                      \
  do {                                         \
    if (threadIdx.x == 0) s_prof[slot] += (v); \
  } while (0)
#define PROF_FLUSH()                                                       \
  do {                                                                     \
    if (threadIdx.x == 0 && blockIdx.x < (1 << 16))                        \
      for (int i = 0; i < 12; ++i) g_prof[blockIdx.x][i] = s_prof[i];      \
  } while (0)
#define PROF_NOW() now_ns()
#define PROF_CLOCK() clock64()
#else
#define PROF_SET(slot, v) do {} while (0)
#define PROF_ADD(slot, v) do {} while (0)
#define PROF_FLUSH() do {} while (0)
#define PROF_NOW() 0ull
#define PROF_CLOCK() 0ll
#endif

struct Strides {
  long long b, h, t;  // elements between batch items, heads, tokens
};

// The TMA views of q, k and v (make_map); head_first: the map's fourth
// dimension is the head, its fifth the batch (else the other way round).
struct Maps {
  CUtensorMap q, k, v;
  int head_first_q, head_first_k, head_first_v;
};

// Row strides (fp32 words) of the staged bias factors. bh: 4 x an odd
// number, so the 8 rows a warp reads at one grid row fall on 8 banks;
// bw: 8 mod 32, so a half-warp's float2 pairs (4 rows x 4 column pairs)
// cover the 32 banks once. Both keep rows 16-byte aligned for cp.async.
__host__ __device__ inline int bh_stride(int gh) {
  const int s = (gh + 3) & ~3;
  return ((s >> 2) & 1) ? s : s + 4;
}
__host__ __device__ inline int bw_stride(int gw) { return gw + ((8 - gw) & 31); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------- mbarrier and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)) : "memory");
}

// The one arrival of this phase, expecting `bytes` of copies to complete.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// The map's box of rows from r0 on of one (b, head) matrix, every chunk,
// by one TMA bulk copy: the map's second dimension is the token, its third
// the 16-byte chunk, so the box lands chunk-major, as the core matrices
// want it.
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst, const CUtensorMap* map,
                                         int head_first, int r0, int head, int b,
                                         uint64_t* bar) {
  const int c3 = head_first ? head : b, c4 = head_first ? b : head;
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(0), "r"(r0), "r"(0), "r"(c3), "r"(c4),
         "r"(smem_u32(bar))
      : "memory");
}

// The same rows by plain loads (all threads), where TMA cannot describe the
// tensor; zero outside (N, D).
template <int ROWS, int DP>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long st, int r0, int N, int D, int tid) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < ROWS * DP; i += kThreads) {
    const int r = i / DP, c = i - r * DP;
    dst[((c >> 3) * ROWS + r) * 8 + (c & 7)] =
        (r0 + r < N && c < D) ? src[(r0 + r) * st + c] : zero;
  }
}

// The block's kRows rows of one (N, g) bias factor into shared memory with
// row stride ld (zeros past rows_in). vec (g % 4 == 0, src 16-byte aligned):
// cp.async, and scale_factor() multiplies by log2(e) what this thread copied
// once its copies have landed; else plain loads, scaled on the way.
__device__ __forceinline__ void stage_factor(float* dst, int ld, const float* src, int g,
                                             int rows_in, bool vec, int tid) {
  if (vec) {
    const int cpr = g >> 2;
    for (int i = tid; i < kRows * cpr; i += kThreads) {
      const int r = i / cpr, c = (i - r * cpr) * 4;
      cp_async16(dst + r * ld + c, r < rows_in ? src + r * g + c : src, r < rows_in);
    }
  } else {
    for (int i = tid; i < kRows * g; i += kThreads) {
      const int r = i / g, c = i - r * g;
      dst[r * ld + c] = r < rows_in ? src[r * g + c] * kLog2e : 0.f;
    }
  }
}

__device__ __forceinline__ void scale_factor(float* dst, int ld, int g, bool vec, int tid) {
  if (!vec) return;
  const int cpr = g >> 2;
  for (int i = tid; i < kRows * cpr; i += kThreads) {
    const int r = i / cpr, c = (i - r * cpr) * 4;
    float4* p = reinterpret_cast<float4*>(dst + r * ld + c);
    float4 x = *p;
    x.x *= kLog2e; x.y *= kLog2e; x.z *= kLog2e; x.w *= kLog2e;
    *p = x;
  }
}

// Maximum and sum of eight values as trees: three dependent steps, not seven.
__device__ __forceinline__ float max8(const float (&r)[8]) {
  return fmaxf(fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3])),
               fmaxf(fmaxf(r[4], r[5]), fmaxf(r[6], r[7])));
}
__device__ __forceinline__ float sum8(const float (&r)[8]) {
  return ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
}

// The scores of one 64-key tile, 16 rows x 64 keys per warp (this thread:
// rows g, g + 8, in mma accumulator layout), turned into bf16
// probabilities. (jr0, c0): grid row and column of the tile's first key;
// TAIL masks the keys past N. WIDE (gw even and >= 64): the tile wraps into
// the next grid row at most once, a thread's key pair never straddles it,
// and the pair's bw factors are one float2; else a general walk with one
// factor load per key. Scores live in the log2 domain: scale2 and the
// staged factors carry log2(e). Updates the running max (m0, m1), the
// thread's share of the row sums (l0, l1) and rescales the output
// accumulators; pa gets P as four A-fragments of 16 keys.
template <int KS, bool TAIL, bool WIDE>
__device__ __forceinline__ void softmax_tile(
    float (&s)[8][4], const float* bh0, const float* bh1, const float* bw0, const float* bw1,
    int jr0, int c0, int gw, int k0, int N, float scale2, float (&o)[2 * KS][4],
    float& m0, float& m1, float& l0, float& l1, uint32_t (&pa)[4][4], int lane) {
  const int t4 = lane & 3;
  // scale, add the factorised bias, mask the keys past N
  float r0[8], r1[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int jl = nt * 8 + t4 * 2;  // the thread's first key of the pair
    if (WIDE) {
      int jc = c0 + jl, jr = jr0;
      if (jc >= gw) {
        jc -= gw;
        ++jr;
      }
      const float hb0 = bh0[jr], hb1 = bh1[jr];
      const float2 wb0 = *reinterpret_cast<const float2*>(bw0 + jc);
      const float2 wb1 = *reinterpret_cast<const float2*>(bw1 + jc);
      s[nt][0] = fmaf(s[nt][0], scale2, hb0 + wb0.x);
      s[nt][1] = fmaf(s[nt][1], scale2, hb0 + wb0.y);
      s[nt][2] = fmaf(s[nt][2], scale2, hb1 + wb1.x);
      s[nt][3] = fmaf(s[nt][3], scale2, hb1 + wb1.y);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int jc = c0 + jl + e, jr = jr0;
        while (jc >= gw) {
          jc -= gw;
          ++jr;
        }
        s[nt][e] = fmaf(s[nt][e], scale2, bh0[jr] + bw0[jc]);
        s[nt][e + 2] = fmaf(s[nt][e + 2], scale2, bh1[jr] + bw1[jc]);
      }
    }
    if (TAIL) {
      if (k0 + jl >= N) s[nt][0] = s[nt][2] = -INFINITY;
      if (k0 + jl + 1 >= N) s[nt][1] = s[nt][3] = -INFINITY;
    }
    r0[nt] = fmaxf(s[nt][0], s[nt][1]);
    r1[nt] = fmaxf(s[nt][2], s[nt][3]);
  }
  // tile maxima of rows g, g + 8 over the quad's 64 keys
  float mx0 = max8(r0), mx1 = max8(r1);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  // ex2.approx: one special-function op (relative error ~2^-22, far below
  // the bf16 rounding of P that follows)
  const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int i = 0; i < 2 * KS; ++i) {
    o[i][0] *= a0;
    o[i][1] *= a0;
    o[i][2] *= a1;
    o[i][3] *= a1;
  }
  // P = 2^(S - max) with its fp32 row sums; two score n-tiles make one
  // bf16 A-fragment of 16 keys
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float p0 = ex2(s[nt][0] - mn0), p1 = ex2(s[nt][1] - mn0);
    const float p2 = ex2(s[nt][2] - mn1), p3 = ex2(s[nt][3] - mn1);
    r0[nt] = p0 + p1;
    r1[nt] = p2 + p3;
    pa[nt >> 1][2 * (nt & 1)] = pack_bf16(p0, p1);
    pa[nt >> 1][2 * (nt & 1) + 1] = pack_bf16(p2, p3);
  }
  l0 = l0 * a0 + sum8(r0);
  l1 = l1 * a1 + sum8(r1);
}

// One 64-key tile for this warp's warpgroup (64 query rows): S = Q.K^T as
// D / 16 m64n64k16 products, the softmax, O += P.V as 4 x D / 16 m64n16k16
// products. K and V tiles lie as core matrices, chunk c of row r at byte
// (c * 64 + r) * 16: for K (K-major) the two core matrices of a 16-channel
// k-step are 1 KB apart (LBO) and 8-row groups 128 bytes (SBO); for V
// (MN-major) 8-channel groups are 1 KB apart (SBO) and 8-key groups 128
// bytes (LBO).
template <int KS, bool TAIL, bool WIDE>
__device__ __forceinline__ void attend_tile(
    const __nv_bfloat16* sK, const __nv_bfloat16* sV, const float* bh0, const float* bh1,
    const float* bw0, const float* bw1, int jr0, int c0, int gw, int k0, int N,
    float scale2, const uint32_t (&qf)[KS][4], float (&o)[2 * KS][4], float& m0, float& m1,
    float& l0, float& l1, int lane) {
  constexpr uint32_t kChunk = kTile * 16;  // bytes between 8-channel chunks
  [[maybe_unused]] const long long c_0 = PROF_CLOCK();
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  vosesam::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    vosesam::wgmma_m64n64k16_rs(s, qf[ks], vosesam::smem_desc(sK + 2 * ks * kTile * 8, kChunk, 128),
                                ks > 0);
  vosesam::wgmma_commit();
  vosesam::wgmma_wait<0>();
  vosesam::fence_operands(s);
  [[maybe_unused]] const long long c_1 = PROF_CLOCK();
  uint32_t pa[4][4];
  softmax_tile<KS, TAIL, WIDE>(s, bh0, bh1, bw0, bw1, jr0, c0, gw, k0, N, scale2, o, m0, m1,
                               l0, l1, pa, lane);
  vosesam::fence_operands(o);
  [[maybe_unused]] const long long c_2 = PROF_CLOCK();
  vosesam::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dc = 0; dc < KS; ++dc)
      vosesam::wgmma_m64n16k16_rs(o[2 * dc], o[2 * dc + 1], pa[kk],
                                  vosesam::smem_desc(sV + (2 * dc * kTile + 16 * kk) * 8, 128,
                                                     kChunk),
                                  1);
  }
  vosesam::wgmma_commit();
  vosesam::wgmma_wait<0>();
  vosesam::fence_operands(o);
  PROF_ADD(8, c_1 - c_0);
  PROF_ADD(9, c_2 - c_1);
  PROF_ADD(10, PROF_CLOCK() - c_2);
}

// D padded to KS * 16; WIDE: gw even and >= 64. Two blocks per SM up to D
// 112; at D 128 one block's shared memory exceeds half an SM's, so the
// registers are not capped there.
template <int KS, bool WIDE>
__global__ void __launch_bounds__(kThreads, KS <= 7 ? 2 : 1) flash_relpos_bf16(
    const __grid_constant__ Maps maps, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ bh, const float* __restrict__ bw, __nv_bfloat16* __restrict__ out,
    Strides qs, Strides ks, Strides vs, Strides os,
    int heads, int N, int D, int gh, int gw, float scale2, int tma, int vec, int hvec,
    int wvec) {  // vec: paired output stores (D % 8 == 0, out 16-byte aligned)
  constexpr int DP = 16 * KS;
  constexpr int TILE = kTile * DP;   // bf16 elements of one K (or V) tile
  constexpr int STAGE = 2 * TILE;    // K tile, then V tile
  static_assert(kRows * DP == STAGE, "Q rows fill one stage's buffer");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[kStages + 1];  // the stages' mbarriers, then Q's
  __nv_bfloat16* sKV = reinterpret_cast<__nv_bfloat16*>(smem);  // [kStages][K | V]
  __nv_bfloat16* sQ = sKV + STAGE;  // Q in the second stage, until tile 1 takes it
  const int SH = bh_stride(gh), SW = bw_stride(gw);
  float* sBh = reinterpret_cast<float*>(sKV + kStages * STAGE);  // [kRows][SH]
  float* sBw = sBh + kRows * SH;                                 // [kRows][SW]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  // the query-row blocks of one (b, head) are neighbours in the grid
  const int n_qt = (N + kRows - 1) / kRows;
  const int bhi = blockIdx.x / n_qt;  // b * heads + head
  const int q0 = (blockIdx.x - bhi * n_qt) * kRows;
  const int bi = bhi / heads, hi = bhi - bi * heads;
  const __nv_bfloat16* kb = k + bi * ks.b + hi * ks.h;
  const __nv_bfloat16* vb = v + bi * vs.b + hi * vs.h;
  const int rows_in = min(kRows, N - q0);
  const int n_tiles = (N + kTile - 1) / kTile;
  constexpr uint32_t kTileBytes = STAGE * 2;

  // tile t of K and V into stage t % kStages: one TMA copy each, started by
  // thread 0, or plain loads by every thread
  auto load_tile = [&](int t) {
    __nv_bfloat16* dst = sKV + (t % kStages) * STAGE;
    if (tma) {
      if (tid == 0) {
        if (t == 1) vosesam::fence_proxy_async();  // Q's reads of the stage (generic) first
        mbar_expect(&bars[t % kStages], kTileBytes);
        tma_tile(dst, &maps.k, maps.head_first_k, t * kTile, hi, bi, &bars[t % kStages]);
        tma_tile(dst + TILE, &maps.v, maps.head_first_v, t * kTile, hi, bi, &bars[t % kStages]);
      }
    } else {
      copy_rows<kTile, DP>(dst, kb, ks.t, t * kTile, N, D, tid);
      copy_rows<kTile, DP>(dst + TILE, vb, vs.t, t * kTile, N, D, tid);
    }
  };

  PROF_SET(0, PROF_NOW());
  for (int i = 2; i < 12; ++i) PROF_SET(i, 0);
  if (tma && tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(&maps.q) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(&maps.k) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(&maps.v) : "memory");
  }
  __syncthreads();
  // first: Q and the block's rows of the bias factors, then tile 0
  if (tma) {
    if (tid == 0) {
      mbar_expect(&bars[kStages], kRows * DP * 2);
      tma_tile(sQ, &maps.q, maps.head_first_q, q0, hi, bi, &bars[kStages]);
    }
  } else {
    copy_rows<kRows, DP>(sQ, q + bi * qs.b + hi * qs.h, qs.t, q0, N, D, tid);
  }
  stage_factor(sBh, SH, bh + ((long long)bhi * N + q0) * gh, gh, rows_in, hvec, tid);
  stage_factor(sBw, SW, bw + ((long long)bhi * N + q0) * gw, gw, rows_in, wvec, tid);
  cp_async_commit();
  load_tile(0);
  cp_async_wait<0>();
  scale_factor(sBh, SH, gh, hvec, tid);  // what this thread copied has landed
  scale_factor(sBw, SW, gw, wvec, tid);
  if (tma) mbar_wait(&bars[kStages], 0);
  __syncthreads();

  // this warp's 16 query rows as A-fragments, one per 16-wide k-step
  const int mrow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  uint32_t qf[KS][4];
#pragma unroll
  for (int kd = 0; kd < KS; ++kd)
    ldmatrix_x4(qf[kd], sQ + ((2 * kd + (lane >> 4)) * kRows + mrow) * 8);
  const float* bh0 = sBh + (warp * 16 + g) * SH;
  const float* bh1 = bh0 + 8 * SH;
  const float* bw0 = sBw + (warp * 16 + g) * SW;
  const float* bw1 = bw0 + 8 * SW;
  PROF_SET(1, PROF_NOW());

  float m0 = kNegInit, m1 = kNegInit;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;            // this thread's share of the row sums
  float o[2 * KS][4];
#pragma unroll
  for (int i = 0; i < 2 * KS; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  int jr0 = 0, c0 = 0;  // grid row and column of the tile's first key
  for (int c = 0; c < n_tiles; ++c) {
    [[maybe_unused]] const unsigned long long t_in = PROF_NOW();
    if (tma) {
      mbar_wait(&bars[c % kStages], (c / kStages) & 1);
    } else {
      vosesam::fence_proxy_async();  // this thread's stores, visible to wgmma's reads
    }
    // tile c has landed for every thread, and every warp is done with tile
    // c - 1 (at c = 0: with Q), whose stage the next copy refills
    __syncthreads();
    [[maybe_unused]] const unsigned long long t_ready = PROF_NOW();
    PROF_ADD(2, t_ready - t_in);
    [[maybe_unused]] const long long c_copy = PROF_CLOCK();
    if (c + 1 < n_tiles) load_tile(c + 1);
    PROF_ADD(7, PROF_CLOCK() - c_copy);
    const __nv_bfloat16* cK = sKV + (c % kStages) * STAGE;
    const int k0 = c * kTile;
    if (k0 + kTile <= N) {
      attend_tile<KS, false, WIDE>(cK, cK + TILE, bh0, bh1, bw0, bw1, jr0, c0, gw, k0, N,
                                   scale2, qf, o, m0, m1, l0, l1, lane);
    } else {
      attend_tile<KS, true, WIDE>(cK, cK + TILE, bh0, bh1, bw0, bw1, jr0, c0, gw, k0, N,
                                  scale2, qf, o, m0, m1, l0, l1, lane);
    }
    c0 += kTile;
    while (c0 >= gw) {
      c0 -= gw;
      ++jr0;
    }
    PROF_ADD(3, PROF_NOW() - t_ready);
  }
  PROF_SET(4, n_tiles);
  PROF_SET(5, PROF_NOW());

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int t4 = lane & 3;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  __nv_bfloat16* ob = out + bi * os.b + hi * os.h;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    const int c = n * 8 + t4 * 2;
    if (vec) {  // D % 8 == 0: the pair lies inside D, 4-byte aligned
      if (c < D) {
        if (ra < N)
          *reinterpret_cast<uint32_t*>(ob + ra * os.t + c) =
              pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
        if (rb < N)
          *reinterpret_cast<uint32_t*>(ob + rb * os.t + c) =
              pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e < D) {
          if (ra < N) ob[ra * os.t + c + e] = __float2bfloat16(o[n][e] * inv0);
          if (rb < N) ob[rb * os.t + c + e] = __float2bfloat16(o[n][e + 2] * inv1);
        }
      }
    }
  }
  PROF_SET(6, PROF_NOW());
  PROF_FLUSH();
}

// fp32: one thread per query row, scores of a 64-key tile through shared
// memory, output accumulator in registers.
template <int DP>
__global__ void __launch_bounds__(kTile) flash_relpos_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bh,
    const float* __restrict__ bw, float* __restrict__ out,
    Strides qs, Strides ks, Strides vs, Strides os,
    int heads, int N, int D, int gh, int gw, float scale) {
  constexpr int LDQ = DP + 1;
  constexpr int LDS = kTile + 1;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + kTile * LDQ;
  float* sV = sK + kTile * DP;
  float* sS = sV + kTile * DP;
  float* sBh = sS + kTile * LDS;
  float* sBw = sBh + kTile * gh;

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kTile;
  const long long bhi = blockIdx.y;
  const long long bi = bhi / heads, hi = bhi - bi * heads;
  const float* qb = q + bi * qs.b + hi * qs.h;
  const float* kb = k + bi * ks.b + hi * ks.h;
  const float* vb = v + bi * vs.b + hi * vs.h;
  for (int i = t; i < kTile * DP; i += kTile) {
    const int r = i / DP, c = i - r * DP;
    sQ[r * LDQ + c] = (q0 + r < N && c < D) ? qb[(q0 + r) * qs.t + c] : 0.f;
  }
  for (int i = t; i < kTile * gh; i += kTile) {
    const int r = i / gh;
    sBh[i] = (q0 + r < N) ? bh[(bhi * N + q0 + r) * gh + (i - r * gh)] : 0.f;
  }
  for (int i = t; i < kTile * gw; i += kTile) {
    const int r = i / gw;
    sBw[i] = (q0 + r < N) ? bw[(bhi * N + q0 + r) * gw + (i - r * gw)] : 0.f;
  }

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
      sK[i] = ok ? kb[(k0 + r) * ks.t + c] : 0.f;
      sV[i] = ok ? vb[(k0 + r) * vs.t + c] : 0.f;
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
    float* orow = out + bi * os.b + hi * os.h + r * os.t;
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
  int B, heads, N, D, gh, gw;
  float scale;
  cudaStream_t stream;
};

size_t bf16_smem(int KS, int gh, int gw) {
  return (size_t)kStages * 2 * kTile * 16 * KS * 2 +
         (size_t)kRows * (bh_stride(gh) + bw_stride(gw)) * 4;
}

size_t f32_smem(int DP, int gh, int gw) {
  return (size_t)(kTile * (DP + 1) + 2 * kTile * DP + kTile * (kTile + 1) +
                  kTile * (gh + gw)) * 4;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// gw even and >= 64: the instance whose tiles wrap into the next grid row
// at most once, with float2 bw loads
bool wide_grid(int gw) { return gw % 2 == 0 && gw >= kTile; }

// cuTensorMapEncodeTiled from the libcuda the runtime has loaded (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The TMA view of one (B, heads, N, D) bf16 tensor, 5-D: 8 channels, the
// token, the 16-byte chunk (stride 16 bytes), then head and batch in the
// order of their strides; a box of (8, rows, D / 8 rounded up to the tile's
// chunks) lands chunk-major in shared memory, the core-matrix layout.
// head_first: whether the head comes before the batch. Returns false where
// TMA cannot describe the tensor (an axis of stride 0, no libcuda entry
// point).
bool make_map(CUtensorMap* map, int* head_first_out, const void* base, const Strides& st,
              int B, int heads, int N, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || st.t <= 0 || (heads > 1 && st.h <= 0) || (B > 1 && st.b <= 0))
    return false;
  const bool head_first = B == 1 || (heads > 1 && st.h <= st.b);
  const long long hs = heads > 1 ? st.h : 8, bs = B > 1 ? st.b : 8;  // size 1: any stride
  *head_first_out = head_first;
  const cuuint64_t dims[5] = {8, (cuuint64_t)N, (cuuint64_t)((D + 7) / 8),
                              (cuuint64_t)(head_first ? heads : B),
                              (cuuint64_t)(head_first ? B : heads)};
  const cuuint64_t bytes[4] = {(cuuint64_t)st.t * 2, 16,
                               (cuuint64_t)(head_first ? hs : bs) * 2,
                               (cuuint64_t)(head_first ? bs : hs) * 2};
  // every chunk of the padded tile, those past D zero-filled: the box's
  // bytes are what the mbarrier expects
  const cuuint32_t box[5] = {8, (cuuint32_t)rows, (cuuint32_t)(2 * ((D + 15) / 16)), 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, bytes, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool by8(const Strides& s) { return s.b % 8 == 0 && s.h % 8 == 0 && s.t % 8 == 0; }

// Whether q / k / v reach shared memory by TMA (D % 8 == 0, strides % 8 ==
// 0, bases 16-byte aligned, and libcuda encodes their views: returns 1 and
// fills maps), else by plain loads.
int plan_copies(const Args& a, Maps* maps) {
  return a.D % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && by8(a.qs) &&
         by8(a.ks) && by8(a.vs) &&
         make_map(&maps->q, &maps->head_first_q, a.q, a.qs, a.B, a.heads, a.N, a.D, kRows) &&
         make_map(&maps->k, &maps->head_first_k, a.k, a.ks, a.B, a.heads, a.N, a.D, kTile) &&
         make_map(&maps->v, &maps->head_first_v, a.v, a.vs, a.B, a.heads, a.N, a.D, kTile);
}

template <int KS, bool WIDE>
int launch_bf16(const Args& a) {
  const size_t smem = bf16_smem(KS, a.gh, a.gw);
  const int hvec = a.gh % 4 == 0 && aligned16(a.bh);
  const int wvec = a.gw % 4 == 0 && aligned16(a.bw);
  const int vec = a.D % 8 == 0 && aligned16(a.out) && by8(a.os);
  Maps maps;
  const int tma = plan_copies(a, &maps);
  cudaError_t err = cudaFuncSetAttribute(
      flash_relpos_bf16<KS, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.B * a.heads * ((a.N + kRows - 1) / kRows);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_relpos_bf16<KS, WIDE><<<(unsigned)blocks, kThreads, smem, a.stream>>>(
      maps, static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.bh, a.bw, static_cast<__nv_bfloat16*>(a.out),
      a.qs, a.ks, a.vs, a.os, a.heads, a.N, a.D, a.gh, a.gw, a.scale * kLog2e, tma, vec, hvec,
      wvec);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_bf16(const Args& a) {
  return wide_grid(a.gw) ? launch_bf16<KS, true>(a) : launch_bf16<KS, false>(a);
}

template <int KS>
int launch_f32(const Args& a) {
  constexpr int DP = 16 * KS;
  const size_t smem = f32_smem(DP, a.gh, a.gw);
  cudaError_t err = cudaFuncSetAttribute(
      flash_relpos_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)a.B * a.heads > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.N + kTile - 1) / kTile, a.B * a.heads);
  flash_relpos_f32<DP><<<grid, kTile, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bh, a.bw, static_cast<float*>(a.out),
      a.qs, a.ks, a.vs, a.os, a.heads, a.N, a.D, a.gh, a.gw, a.scale);
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
int occupancy_at(int is_bf16, int gh, int gw, int* info) {
  if (is_bf16)
    return wide_grid(gw)
               ? occupancy(flash_relpos_bf16<KS, true>, kThreads, bf16_smem(KS, gh, gw), info)
               : occupancy(flash_relpos_bf16<KS, false>, kThreads, bf16_smem(KS, gh, gw), info);
  return occupancy(flash_relpos_f32<16 * KS>, kTile, f32_smem(16 * KS, gh, gw), info);
}

}  // namespace

// q, k, v, out: (B, heads, N, D) bf16 (is_bf16) or fp32, addressed by their
// (batch, head, token) element strides, last axis dense; bh: (B, heads, N,
// gh) fp32 contiguous; bw: (B, heads, N, gw) fp32 contiguous; N == gh * gw;
// 1 <= D <= 128.
extern "C" int vosesam_flash_attention_relpos(
    const void* q, const void* k, const void* v, const float* bh, const float* bw,
    void* out, int is_bf16, int B, int heads, int N, int D, int gh, int gw,
    const long long* strides,  // q, k, v, out: (batch, head, token) each
    float scale, void* stream_ptr) {
  if (B < 1 || heads < 1 || N < 1 || D < 1 || D > 128 || gh < 1 || gw < 1 || gh * gw != N)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.bh = bh; a.bw = bw; a.out = out;
  a.qs = {strides[0], strides[1], strides[2]};
  a.ks = {strides[3], strides[4], strides[5]};
  a.vs = {strides[6], strides[7], strides[8]};
  a.os = {strides[9], strides[10], strides[11]};
  a.B = B; a.heads = heads; a.N = N; a.D = D; a.gh = gh; a.gw = gw;
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

// The occupancy of the instance that a launch at (is_bf16, D, gh, gw)
// selects, as the card reports it; info gets six ints (see occupancy()).
extern "C" int vosesam_flash_attention_occupancy(int is_bf16, int D, int gh, int gw,
                                                 int* info) {
  if (D < 1 || D > 128 || gh < 1 || gw < 1) return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16) {
    case 1: return occupancy_at<1>(is_bf16, gh, gw, info);
    case 2: return occupancy_at<2>(is_bf16, gh, gw, info);
    case 3: return occupancy_at<3>(is_bf16, gh, gw, info);
    case 4: return occupancy_at<4>(is_bf16, gh, gw, info);
    case 5: return occupancy_at<5>(is_bf16, gh, gw, info);
    case 6: return occupancy_at<6>(is_bf16, gh, gw, info);
    case 7: return occupancy_at<7>(is_bf16, gh, gw, info);
    default: return occupancy_at<8>(is_bf16, gh, gw, info);
  }
}

// 1 where a bf16 launch with these tensors would stage q / k / v by TMA, 0
// where by plain loads.
extern "C" int vosesam_flash_attention_uses_tma(const void* q, const void* k, const void* v,
                                                const void* out, int B, int heads, int N,
                                                int D, const long long* strides) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = const_cast<void*>(out);
  a.qs = {strides[0], strides[1], strides[2]};
  a.ks = {strides[3], strides[4], strides[5]};
  a.vs = {strides[6], strides[7], strides[8]};
  a.os = {strides[9], strides[10], strides[11]};
  a.B = B; a.heads = heads; a.N = N; a.D = D;
  Maps maps;
  return plan_copies(a, &maps);
}

#ifdef VOSESAM_PROFILE
extern "C" int vosesam_flash_attention_profile(void* dst, int n_blocks) {
  return (int)cudaMemcpyFromSymbol(dst, g_prof, (size_t)n_blocks * 12 * 8);
}
#endif
