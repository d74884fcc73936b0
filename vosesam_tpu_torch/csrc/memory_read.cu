// Fused XMem memory read for Hopper (sm_90a): an exact top-k threshold, the
// sparse softmax and the value readout over a (Q, M) similarity matrix,
// plus the per-slot usage column sums.
//
// Replaces the Pallas TPU kernels in vosesam_tpu/ops/pallas/memory_read.py:
//   fused_memory_read_shared (one validity row shared by every object)
//   fused_memory_read        (one validity row per object)
// Both are one set of kernels here: R validity rows, R = 1 (shared mode,
// every object read out against one threshold) or R = O (per-object mode,
// validity row r reads out object r).
//
// The input contract is the JAX kernel's: the kernels stream the fp32
// similarity that ops/memory_attention.py:get_similarity computed once,
//   sim = (-sum_c qe mk^2 + 2 sum_c qe qk mk - sum_c qe qk^2) * ms / sqrt(Ck),
// for every input dtype. The kernels and the plain chain (topk_softmax on
// the same matrix) therefore select their top k from the same values, bit
// for bit. (An earlier design rebuilt the similarity on the tensor cores
// for bf16 keys; its own summation order admitted other slots than the
// plain chain on 0.13% of a rollout's query rows at near-ties.)
//
// What bounds it on the H100: bytes. The matrix is (Q, M) fp32, 111 MB at
// DAVIS 480p (Q = 1620, M = 17 200), and the select and apply kernels each
// stream it once (it does not fit in L2). A block of 4 warps owns 16 query
// rows, one or two validity rows and one of S splits of the memory axis (S
// as large as keeps every block in one round of the card's resident
// blocks), and streams its slots in chunks of 64 through a three-stage
// cp.async ring (the chunk's 16 x 64 similarities, its validity bytes), one
// block barrier a chunk. A lane holds rows g and g + 8 of the chunk's
// slots warp * 16 + (0..15 by its t4), read from shared memory as float2
// (the row pitch of 72 floats makes those reads conflict-free):
//   memory_read_pass<select>  every lane keeps top-12 lists of its slots for
//     its two rows (an insertion only when a warp has a value that beats a
//     list's last); at the end the 4 lanes, then the 4 warps of a row merge
//     them into the split's exact top 32, written to a (R, Q, S, 32)
//     scratch. If a lane's list filled up with values that reach the split's
//     32nd, the split is scanned again with top-32 lists.
//   memory_read_pass<apply>  merges the S lists of each row (one list a
//     lane) into the row max and the exact k-th value (duplicates counted as
//     lax.top_k), and the softmax denominator from the picks and the
//     remaining ties (if a split's list ended in a tie of the threshold, one
//     scan over the whole memory recomputes the denominator); then streams
//     its tiles again, admits sim >= threshold && valid, writes the
//     normalised affinity's column sums (lane shuffles in a fixed order) as
//     this (row tile, validity rows)'s usage partial, and keeps the admitted
//     (slot, affinity) entries of each (row, warp) in shared memory, 16 at
//     most before they are read out into a readout partial; the entries go
//     to a small scratch at the end.
//   memory_read_finish  reads out the kept entries (fp32 weights times bf16
//     or fp32 values) and adds the partials, in split and warp order.
//   memory_read_usage  adds the usage partials over the row tiles in a
//     fixed order.
// Deterministic throughout, no float atomics, so consolidation's prototype
// choice (memory/manager.py) does not change from run to run. Rows with
// fewer than k valid slots get a NEG_INF threshold and admit every valid
// slot; a row with no valid slot reads out zeros.
// vosesam_memory_read_occupancy reports each kernel's registers, shared
// memory and resident blocks per SM on the card.
// Built with -DVOSESAM_PROFILE, thread 0 of every block stamps the global
// timer at the ends of its phases (python -m vosesam_tpu_torch.ops.kernels.phases).
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_helpers.cuh"

namespace {

using vosesam::cp_async16;
using vosesam::cp_async_commit;
using vosesam::cp_async_wait;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;               // query rows per block
constexpr int kChunk = 64;              // memory slots per streamed chunk
constexpr int kPitch = kChunk + 8;      // floats per staged row: conflict-free float2 reads
constexpr int kSub = kThreads / kRows;  // threads per query row in the selection
constexpr int kMaxK = 32;               // list length: top_k <= 32
constexpr int kLane = 12;               // a lane's list in the select scan's first try
constexpr int kMaxSplits = 8;           // one split list per lane of a row in the merge
constexpr int kCap = 16;                // admitted entries per (row, warp) before a flush
constexpr int kBlocksPerSm = 4;         // launch bounds: registers for 4 blocks an SM
constexpr int kStages = 3;              // chunks in flight or in use
constexpr float kNegInf = -1e30f;       // ops/memory_attention.py NEG_INF

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

#ifdef VOSESAM_PROFILE
// per block of the apply kernel (select: + 8): start, threshold ready, pass
// done, gather done, ns waiting for chunks, ns in tiles, chunks (ns)
__device__ unsigned long long g_prof[1 << 16][16];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define PROF_ID (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))
#define PROF_SET(slot, v)                                        \
  do {                                                           \
    if (threadIdx.x == 0 && PROF_ID < (1 << 16)) g_prof[PROF_ID][slot] = (v); \
  } while (0)
#define PROF_ADD(slot, v)                                        \
  do {                                                           \
    if (threadIdx.x == 0 && PROF_ID < (1 << 16)) g_prof[PROF_ID][slot] += (v); \
  } while (0)
#define PROF_NOW() now_ns()
#else
#define PROF_SET(slot, v) do {} while (0)
#define PROF_ADD(slot, v) do {} while (0)
#define PROF_NOW() 0ull
#endif

struct Params {
  const float* sim;          // (Q, M) fp32 similarity (get_similarity)
  const uint8_t* valid;      // (R, M) 0/1
  const void* mv;            // (O, M, Cv)
  float* out;                // (O, Q, Cv) fp32
  float* lists;              // (R, Q, S, 32) split top-32 lists
  int* ecount;               // (R, S, Q, warps) admitted entries kept per (row, warp)
  int* eslot;                // (R, S, Q, warps, kCap) their slots
  float* eaff;               // (R, S, Q, warps, kCap) their affinities
  float* rpart;              // (R, S, Q, warps, n_feat) readout partials of flushed lists
  int* rflag;                // (R, S, Q, warps) 1 where a readout partial was written
  float* upart;              // (R, Q tiles, M) usage partials
  int Q, M, live_end, O, Cv, k, R, shared_mode, n_feat, splits, cps, n_chunks;
};

// Shared-memory layout of one block (bytes from the start).
struct Layout {
  int stage, vd, rows, work, total;
};

__host__ __device__ inline Layout layout(int rg) {
  Layout L;
  int off = 0;
  L.stage = off;  // the similarity tiles: [kStages][kRows][kPitch] fp32
  off += kStages * kRows * kPitch * 4;
  L.vd = off;     // validity bytes of the block's validity rows, a stage each
  off += kStages * rg * kChunk;
  L.rows = off;   // threshold, max, denominator per (validity row, row)
  off += 3 * rg * kRows * 4;
  L.work = off;   // select: the warps' per-row lists; apply: the admitted entries
  const int lists = kWarps * kRows * kMaxK * 4 + kWarps * kRows * 4 * 4;
  const int entries = rg * kWarps * kRows * kCap * 8;
  off += lists > entries ? lists : entries;
  L.total = off;
  return L;
}

template <typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = 1; off < kSub; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Insert s into a descending register list (compare-exchange down the list).
template <int N>
__device__ __forceinline__ void insert(float (&top)[N], float s) {
  if (s > top[N - 1]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float h = fmaxf(top[i], s);
      s = fminf(top[i], s);
      top[i] = h;
    }
  }
}


// W-lane group argmax of (v, id) among adjacent lanes: the larger value
// wins, ties go to the smaller id.
template <int W>
__device__ __forceinline__ void lanes_argmax(float& v, int& id) {
#pragma unroll
  for (int off = 1; off < W; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oid = __shfl_xor_sync(0xffffffffu, id, off);
    if (ov > v || (ov == v && oid < id)) {
      v = ov;
      id = oid;
    }
  }
}

// The head of the W adjacent lanes' lists (all of them get it); the lane
// that held it pops it.
template <int W, int N>
__device__ __forceinline__ float lanes_pop(float (&top)[N], int me) {
  float v = top[0];
  int id = me;
  lanes_argmax<W>(v, id);
  if (id == me) {
#pragma unroll
    for (int i = 0; i < N - 1; ++i) top[i] = top[i + 1];
    top[N - 1] = kNegInf;
  }
  return v;
}

// RG validity rows per block (1, or 2 in per-object mode): they share every
// similarity tile. A lane's similarities of a chunk: rows g and g + 8 of the
// block, slots warp * 16 + (j / 2) * 8 + t4 * 2 + j % 2, sim[h][j].
template <typename TV, bool APPLY, int RG>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) memory_read_pass(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(RG);
  float* sSim = reinterpret_cast<float*>(smem + L.stage);  // [kStages][kRows][kPitch]
  uint8_t* sVd = smem + L.vd;                               // [kStages][RG][kChunk]
  float* sTh = reinterpret_cast<float*>(smem + L.rows);     // [RG][kRows]
  float* sMx = sTh + RG * kRows;                            // [RG][kRows]
  float* sDen = sMx + RG * kRows;                           // [RG][kRows]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;        // tile layout
  const int row = tid / kSub, sub = tid % kSub;  // row layout: 8 lanes a row
  const int q0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int r0 = blockIdx.z * RG;  // first validity row of the block
  const bool row_live = q0 + row < p.Q;
  const bool live_h[2] = {q0 + g < p.Q, q0 + g + 8 < p.Q};
  const int c_begin = split * p.cps;
  const int c_end = min(p.n_chunks, c_begin + p.cps);
  auto slot_of = [&](int j) { return warp * 16 + (j >> 1) * 8 + t4 * 2 + (j & 1); };

  // chunk c into stage c % kStages, two chunks ahead of its use, in one
  // cp.async group: its 16 x 64 similarities and its validity bytes. Slots
  // at or past live_end and rows past Q are zero (and invalid); pieces that
  // are not 16-byte aligned or straddle live_end are copied by plain loads.
  const bool sim_async = p.M % 4 == 0 && reinterpret_cast<uintptr_t>(p.sim) % 16 == 0;
  const bool vd_async = p.M % 16 == 0 && reinterpret_cast<uintptr_t>(p.valid) % 16 == 0;
  auto issue_chunk = [&](int c) {
    const int buf = c % kStages;
    const int m0 = c * kChunk;
    // the similarities: 16 rows x 16 pieces of 4 floats, two pieces a thread
#pragma unroll
    for (int it = 0; it < (kRows * kChunk / 4) / kThreads; ++it) {
      const int piece = tid + it * kThreads;
      const int rr = piece / (kChunk / 4), v = piece % (kChunk / 4);
      const int q = q0 + rr, m = m0 + v * 4;
      float* dst = sSim + (buf * kRows + rr) * kPitch + v * 4;
      const float* src = p.sim + (size_t)min(q, p.Q - 1) * p.M + min(m, p.M - 1);
      const int n = q < p.Q ? max(0, min(4, p.live_end - m)) : 0;
      if (sim_async && (n == 4 || n == 0)) {
        cp_async16(dst, n == 4 ? src : p.sim, n == 4);
      } else {
        for (int e = 0; e < 4; ++e) dst[e] = e < n ? src[e] : 0.f;
      }
    }
    if (tid < RG * (kChunk / 16)) {  // validity: 4 pieces a row
      const int i = tid / (kChunk / 16), piece = tid % (kChunk / 16);
      uint8_t* dst = sVd + (buf * RG + i) * kChunk + piece * 16;
      const int m = m0 + piece * 16;
      const int n = (r0 + i < p.R) ? max(0, min(16, p.live_end - m)) : 0;
      const uint8_t* src = p.valid + (size_t)min(r0 + i, p.R - 1) * p.M + (n > 0 ? m : 0);
      if (vd_async && (n == 16 || n == 0)) {
        cp_async16(dst, src, n == 16);
      } else {
        for (int e = 0; e < 16; ++e) dst[e] = e < n ? src[e] : 0;
      }
    }
    cp_async_commit();
  };
  // before the first tile() of a pass over chunks [c, last)
  auto begin = [&](int c, int last) {
    issue_chunk(c);
    if (c + 1 < last) issue_chunk(c + 1);
  };

  // The similarities of chunk c into sim (begin() or the tile() before has
  // issued chunks c and c + 1; chunk c + 2 is issued here). Called by all
  // threads. One barrier: chunk c's data is in, every warp is done with
  // chunk c - 1.
  auto tile = [&](int c, int last, float (&sim)[2][4]) {
    const int buf = c % kStages;
    [[maybe_unused]] const unsigned long long t_in = PROF_NOW();
    if (c + 1 < last) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    if (c + 2 < last) issue_chunk(c + 2);
    [[maybe_unused]] const unsigned long long t_ready = PROF_NOW();
    PROF_ADD(APPLY ? 4 : 12, t_ready - t_in);
    PROF_ADD(APPLY ? 6 : 14, 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* sr = sSim + (buf * kRows + g + 8 * h) * kPitch;
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const float2 v = *reinterpret_cast<const float2*>(sr + slot_of(2 * jp));
        sim[h][2 * jp] = v.x;
        sim[h][2 * jp + 1] = v.y;
      }
    }
    PROF_ADD(APPLY ? 5 : 13, PROF_NOW() - t_ready);
  };
  // valid in validity row i at slot j of the lane's row h in chunk c
  auto valid_at = [&](int c, int i, int h, int j) {
    return live_h[h] && sVd[((c % kStages) * RG + i) * kChunk + slot_of(j)] != 0;
  };
  // any slot of the block's split valid in one of its validity rows
  auto split_live = [&]() {
    int any = 0;
    for (int i = 0; i < RG; ++i) {
      if (r0 + i >= p.R) break;
      const uint8_t* v = p.valid + (size_t)(r0 + i) * p.M;
      for (int m = c_begin * kChunk + tid; m < min(c_end * kChunk, p.live_end); m += kThreads)
        any |= v[m];
    }
    return __syncthreads_or(any) != 0;
  };

  PROF_SET(APPLY ? 0 : 8, PROF_NOW());
  PROF_SET(APPLY ? 4 : 12, 0);
  PROF_SET(APPLY ? 5 : 13, 0);
  PROF_SET(APPLY ? 6 : 14, 0);
  if constexpr (!APPLY) {
    // ---- select: the split's exact top 32 of each row. Each lane keeps
    // top-12 lists of its slots for its two rows (an insertion costs 24
    // instructions, not 64): 16 lists a row (4 lanes x 4 warps), merged at
    // the end. That is exact unless a lane's list filled up with values that
    // reach the split's 32nd; then the scan runs again with top-32 lists.
    auto list_of = [&](int i) {
      return p.lists + (((size_t)(r0 + i) * p.Q + q0 + row) * p.splits + split) * kMaxK;
    };
    // the apply kernel writes usage partials only where it admits: zeros first
    float* up = p.upart + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * p.M;
    for (int m = c_begin * kChunk + tid; m < min(c_end * kChunk, p.M); m += kThreads) up[m] = 0.f;
    if (!split_live()) {  // nothing valid here: empty lists
      for (int i = 0; i < RG; ++i)
        if (r0 + i < p.R && row_live)
          for (int j = sub; j < kMaxK; j += kSub) list_of(i)[j] = kNegInf;
      return;
    }
    float* sW = reinterpret_cast<float*>(smem + L.work);  // [kWarps][kRows][kMaxK]
    float* sLast = sW + kWarps * kRows * kMaxK;          // [kRows][kWarps * 4]
    // scan validity rows [i0, i0 + NI) with lists of N; true where a list
    // may have dropped one of the split's top 32
    auto scan = [&](auto list_len, auto rows, int i0) {
      constexpr int N = decltype(list_len)::value;
      constexpr int NI = decltype(rows)::value;
      float top[NI][2][N];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < N; ++j) top[i][h][j] = kNegInf;
      if (c_begin < c_end) begin(c_begin, c_end);
      for (int c = c_begin; c < c_end; ++c) {
        float sim[2][4];
        tile(c, c_end, sim);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float v[2][4];
          bool any = false;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              v[h][j] = valid_at(c, i0 + i, h, j) ? sim[h][j] : kNegInf;
              any |= v[h][j] > top[i][h][N - 1];
            }
          if (__any_sync(0xffffffffu, any)) {  // later chunks: most warps insert nothing
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int j = 0; j < 4; ++j) insert(top[i][h], v[h][j]);
          }
        }
      }
      bool short_list = false;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        // each warp's top 32 of each row (its 4 lanes' lists), then the
        // row's 8 lanes merge the 4 warps' lists
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sLast[(g + 8 * h) * kWarps * 4 + warp * 4 + t4] = top[i][h][N - 1];
          for (int j = 0; j < kMaxK; ++j) {
            const float v = lanes_pop<4>(top[i][h], t4);
            if (t4 == 0) sW[(warp * kRows + g + 8 * h) * kMaxK + j] = v;
          }
        }
        __syncthreads();
        float merged[kMaxK];
#pragma unroll
        for (int j = 0; j < kMaxK; ++j)
          merged[j] = sub < kWarps ? sW[(sub * kRows + row) * kMaxK + j] : kNegInf;
        float v32 = kNegInf;
        for (int j = 0; j < kMaxK; ++j) {
          v32 = lanes_pop<kSub>(merged, sub);
          if (sub == 0 && row_live && r0 + i0 + i < p.R) list_of(i0 + i)[j] = v32;
        }
        for (int s = sub; s < kWarps * 4; s += kSub) {
          const float last = sLast[row * kWarps * 4 + s];
          short_list |= row_live && last > kNegInf && last >= v32;
        }
      }
      return short_list;
    };
    if (__syncthreads_or(scan(std::integral_constant<int, kLane>(),
                              std::integral_constant<int, RG>(), 0))) {
      for (int i = 0; i < RG; ++i)
        scan(std::integral_constant<int, kMaxK>(), std::integral_constant<int, 1>(), i);
    }
    PROF_SET(9, PROF_NOW());
    return;
  } else {
    // ---- apply: the threshold of each (row, validity row) from its S lists
    bool sat = false;
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      // lane `sub` holds split `sub`'s list, already sorted: the k rounds
      // below merge the S lists
      float top[kMaxK];
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) top[j] = kNegInf;
      const bool live = row_live && r0 + i < p.R;
      const float* lst = p.lists + ((size_t)(r0 + i) * p.Q + q0 + row) * p.splits * kMaxK;
      if (live && sub < p.splits) {
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) top[j] = lst[sub * kMaxK + j];
      }
      float mx = kNegInf, th = kNegInf, den = 0.f;
      for (int round = 0; round < p.k; ++round) {
        const float v = lanes_pop<kSub>(top, sub);
        if (round == 0) mx = v;
        th = v;
        if (v > kNegInf) den += expf(v - mx);
      }
      // ties of the threshold beyond the k picks are admitted too
      int ties = 0;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) ties += (th > kNegInf && top[j] == th);
      ties = group_sum(ties);
      for (int j = 0; j < ties; ++j) den += expf(th - mx);
      // a split list that ends in the threshold may have dropped more ties
      if (live && th > kNegInf)
        for (int t = sub; t < p.splits; t += kSub) sat |= lst[t * kMaxK + kMaxK - 1] == th;
      if (sub == 0) {
        sTh[i * kRows + row] = th;
        sMx[i * kRows + row] = mx;
        sDen[i * kRows + row] = den;
      }
    }
    if (__syncthreads_or(sat)) {
      // the exact denominators by one scan over the whole memory: lanes'
      // sums, then the row's 4 lanes, then the 4 warps in order
      float th[RG][2], mx[RG][2], d[RG][2];
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          th[i][h] = sTh[i * kRows + g + 8 * h];
          mx[i][h] = sMx[i * kRows + g + 8 * h];
          d[i][h] = 0.f;
        }
      if (p.n_chunks > 0) begin(0, p.n_chunks);
      for (int c = 0; c < p.n_chunks; ++c) {
        float sim[2][4];
        tile(c, p.n_chunks, sim);
#pragma unroll
        for (int i = 0; i < RG; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (valid_at(c, i, h, j) && sim[h][j] >= th[i][h]) d[i][h] += expf(sim[h][j] - mx[i][h]);
      }
      float* sDw = reinterpret_cast<float*>(smem + L.work);  // [RG][kRows][kWarps]
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = d[i][h];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t4 == 0) sDw[(i * kRows + g + 8 * h) * kWarps + warp] = v;
        }
      __syncthreads();
      if (tid < RG * kRows) {
        float v = 0.f;
        for (int w = 0; w < kWarps; ++w) v += sDw[tid * kWarps + w];
        sDen[tid] = v;
      }
    }
    __syncthreads();
    float th[RG][2], mx[RG][2], den[RG][2];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        th[i][h] = sTh[i * kRows + g + 8 * h];
        mx[i][h] = sMx[i * kRows + g + 8 * h];
        den[i][h] = fmaxf(sDen[i * kRows + g + 8 * h], 1e-30f);
      }
    PROF_SET(1, PROF_NOW());

    // ---- admit, usage partials, admitted entries per (validity row, row, warp)
    const TV* mv = static_cast<const TV*>(p.mv);
    int* sEm = reinterpret_cast<int*>(smem + L.work);                 // [RG][kWarps][kRows][kCap]
    float* sEw = reinterpret_cast<float*>(sEm + RG * kWarps * kRows * kCap);
    float* up = p.upart + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * p.M;
    auto at_of = [&](int i, int h) {  // (validity row, split, query, warp)
      return (((size_t)(r0 + i) * p.splits + split) * p.Q + q0 + g + 8 * h) * kWarps + warp;
    };
    auto list_at = [&](int i, int h) { return ((i * kWarps + warp) * kRows + g + 8 * h) * kCap; };
    int cnt[RG][2];        // entries of (i, row h) (uniform over the row's 4 lanes)
    bool flushed[RG][2];   // its readout partial already holds a flush
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cnt[i][h] = 0;
        flushed[i][h] = false;
      }
    // the entries of (i, h) into its readout partial, by the row's 4 lanes
    auto flush = [&](int i, int h) {
      const int* em = sEm + list_at(i, h);
      const float* ew = sEw + list_at(i, h);
      float* rp = p.rpart + at_of(i, h) * p.n_feat;
      const int o0 = p.shared_mode ? 0 : r0 + i;
      for (int f = t4; f < p.n_feat; f += 4) {
        const size_t base = (size_t)(o0 + f / p.Cv) * p.M * p.Cv + f % p.Cv;
        float acc = flushed[i][h] ? rp[f] : 0.f;
        for (int e = 0; e < cnt[i][h]; ++e)
          acc += ew[e] * to_float(mv[base + (size_t)em[e] * p.Cv]);
        rp[f] = acc;
      }
      flushed[i][h] = true;
      cnt[i][h] = 0;
    };
    if (split_live()) {  // else nothing valid here: no usage, no readout
      if (c_begin < c_end) begin(c_begin, c_end);
      for (int c = c_begin; c < c_end; ++c) {
        float sim[2][4];
        tile(c, c_end, sim);
        const int c0 = c * kChunk;
        unsigned admit = 0;  // bit (i * 2 + h) * 4 + j
#pragma unroll
        for (int i = 0; i < RG; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (valid_at(c, i, h, j) && sim[h][j] >= th[i][h]) admit |= 1u << ((i * 2 + h) * 4 + j);
        // most warps admit nothing in most chunks: the usage partial
        // (zero-filled by the select kernel) stays as it is
        if (!__any_sync(0xffffffffu, admit != 0)) continue;
        float a[RG][2][4];
        float u[4] = {0.f, 0.f, 0.f, 0.f};  // the slot's affinity over rows and validity rows
#pragma unroll
        for (int i = 0; i < RG; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              a[i][h][j] = 0.f;
              if ((admit >> ((i * 2 + h) * 4 + j)) & 1u)
                a[i][h][j] = expf(sim[h][j] - mx[i][h]) / den[i][h];
              u[j] += a[i][h][j];
            }
        // column sums over the warp's 8 row pairs (lanes of one t4), fixed order
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          u[j] += __shfl_xor_sync(0xffffffffu, u[j], 4);
          u[j] += __shfl_xor_sync(0xffffffffu, u[j], 8);
          u[j] += __shfl_xor_sync(0xffffffffu, u[j], 16);
          if (g == 0 && c0 + slot_of(j) < p.M) up[c0 + slot_of(j)] = u[j];
        }
        // the admitted (slot, affinity) entries of each (i, row, warp)
#pragma unroll
        for (int i = 0; i < RG; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bool ok = (admit >> ((i * 2 + h) * 4 + j)) & 1u;
              const unsigned mine = (__ballot_sync(0xffffffffu, ok) >> (4 * g)) & 0xfu;
              if (cnt[i][h] + __popc(mine) > kCap) flush(i, h);
              if (ok) {
                const int pos = list_at(i, h) + cnt[i][h] + __popc(mine & ((1u << t4) - 1u));
                sEm[pos] = c0 + slot_of(j);
                sEw[pos] = a[i][h][j];
              }
              cnt[i][h] += __popc(mine);
              __syncwarp();
            }
      }
    }
    PROF_SET(2, PROF_NOW());
    // the kept entries and the flags of each (validity row, row, warp), by
    // the row's 4 lanes
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r0 + i >= p.R || !live_h[h]) continue;
        const size_t at = at_of(i, h);
        for (int e = t4; e < cnt[i][h]; e += 4) {
          p.eslot[at * kCap + e] = sEm[list_at(i, h) + e];
          p.eaff[at * kCap + e] = sEw[list_at(i, h) + e];
        }
        if (t4 == 0) {
          p.ecount[at] = cnt[i][h];
          p.rflag[at] = flushed[i][h];
        }
      }
    PROF_SET(3, PROF_NOW());
  }
}

// out[o, q, c] = sum over the splits and the warps, in order, of the
// (validity row, q) readout partial where a list overflowed, then of its
// kept entries: affinity * mv[o, slot, c]. One thread per (validity row, q,
// feature).
template <typename TV>
__global__ void memory_read_finish(Params p, int R) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_r = (size_t)p.Q * p.n_feat;
  if (i >= per_r * R) return;
  const int r = (int)(i / per_r);
  const int q = (int)((i % per_r) / p.n_feat), f = (int)(i % p.n_feat);
  const int o = (p.shared_mode ? 0 : r) + f / p.Cv, c = f % p.Cv;
  const TV* mv = static_cast<const TV*>(p.mv) + (size_t)o * p.M * p.Cv + c;
  float acc = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    for (int w = 0; w < kWarps; ++w) {
      const size_t rs = (((size_t)r * p.splits + s) * p.Q + q) * kWarps + w;
      if (p.rflag[rs]) acc += p.rpart[rs * p.n_feat + f];
      const int n = p.ecount[rs];
      const int* slot = p.eslot + rs * kCap;
      const float* aff = p.eaff + rs * kCap;
#pragma unroll 4
      for (int e = 0; e < n; ++e) acc += aff[e] * to_float(mv[(size_t)slot[e] * p.Cv]);
    }
  }
  p.out[((size_t)o * p.Q + q) * p.Cv + c] = acc;
}

// usage[m] = scale * sum over (validity row, query tile) of the partials,
// in a fixed order; slots at or past the scanned range are 0.
__global__ void memory_read_usage(const float* __restrict__ partial, float* __restrict__ usage,
                                  int n_parts, int M, int scan_end, float scale) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float u = 0.f;
  if (m < scan_end)
    for (int i = 0; i < n_parts; ++i) u += partial[(size_t)i * M + m];
  usage[m] = u * scale;
}

template <typename TV, int RG>
int launch_rg(const Params& p, int q_tiles, cudaStream_t s) {
  const dim3 grid(q_tiles, p.splits, (p.R + RG - 1) / RG);
  const size_t smem = layout(RG).total;
  cudaError_t err = cudaFuncSetAttribute(memory_read_pass<TV, false, RG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(memory_read_pass<TV, true, RG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  memory_read_pass<TV, false, RG><<<grid, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  memory_read_pass<TV, true, RG><<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// validity rows per block: 2 in per-object mode, so that two objects share
// each similarity tile
inline int rows_per_block(const Params& p) { return (!p.shared_mode && p.R >= 2) ? 2 : 1; }

template <typename TV>
int launch(const Params& p, int q_tiles, cudaStream_t s) {
  return rows_per_block(p) == 2 ? launch_rg<TV, 2>(p, q_tiles, s)
                                : launch_rg<TV, 1>(p, q_tiles, s);
}

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

template <typename TV>
int occupancy_pass(int kernel, int* info) {
  const bool apply = kernel % 2 == 1;
  const int rg = kernel >= 4 ? 2 : 1;
  const size_t smem = layout(rg).total;
  if (rg == 2)
    return apply ? occupancy(memory_read_pass<TV, true, 2>, kThreads, smem, info)
                 : occupancy(memory_read_pass<TV, false, 2>, kThreads, smem, info);
  return apply ? occupancy(memory_read_pass<TV, true, 1>, kThreads, smem, info)
               : occupancy(memory_read_pass<TV, false, 1>, kThreads, smem, info);
}

}  // namespace

// sim (Q, M) fp32, the similarity get_similarity computed; valid (R, M)
// uint8; mv (O, M, Cv) bf16 (mv_is_bf16) or fp32; out (O, Q, Cv) fp32.
// Scratch, splits S <= 8: lists R * Q * S * 32 floats; ecount and rflag R *
// S * Q * 4 ints, eslot and eaff R * S * Q * 4 * 16 ints / floats; rpart R *
// S * Q * 4 * n_feat floats (n_feat = O * Cv shared, Cv per object); upart
// ceil(R / rows per block) * ceil(Q / 16) * M floats; usage (M,) or null.
extern "C" int vosesam_memory_read(
    const float* sim, const uint8_t* valid, const void* mv, int mv_is_bf16, float* out,
    float* lists, int* ecount, int* eslot, float* eaff, float* rpart, int* rflag, float* upart,
    float* usage, int Q, int M, int live_end, int O, int Cv, int k, int R, int shared_mode,
    int splits, float usage_scale, void* stream_ptr) {
  if (k < 1 || k > kMaxK || live_end < 0 || live_end > M || Cv < 1 || R < 1 ||
      splits < 1 || splits > kMaxSplits || sim == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Params p;
  p.sim = sim;
  p.valid = valid; p.mv = mv; p.out = out;
  p.lists = lists; p.ecount = ecount; p.eslot = eslot; p.eaff = eaff;
  p.rpart = rpart; p.rflag = rflag; p.upart = upart;
  p.Q = Q; p.M = M; p.live_end = live_end; p.O = O; p.Cv = Cv; p.k = k;
  p.shared_mode = shared_mode;
  p.R = R;
  p.n_feat = (shared_mode ? O : 1) * Cv;
  p.splits = splits;
  p.n_chunks = (live_end + kChunk - 1) / kChunk;
  p.cps = (p.n_chunks + splits - 1) / splits;
  const int q_tiles = (Q + kRows - 1) / kRows;
  const int groups = (R + rows_per_block(p) - 1) / rows_per_block(p);
  if (Q > 0 && p.n_feat > 0) {
    const int rc = mv_is_bf16 ? launch<__nv_bfloat16>(p, q_tiles, stream)
                              : launch<float>(p, q_tiles, stream);
    if (rc != 0) return rc;
    const size_t n = (size_t)R * Q * p.n_feat;
    if (mv_is_bf16)
      memory_read_finish<__nv_bfloat16><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(p, R);
    else
      memory_read_finish<float><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(p, R);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (usage != nullptr && M > 0) {
    const int scan_end = Q > 0 && p.n_feat > 0 ? p.n_chunks * kChunk : 0;
    memory_read_usage<<<(M + 255) / 256, 256, 0, stream>>>(upart, usage, groups * q_tiles, M,
                                                           scan_end, usage_scale);
  }
  return (int)cudaGetLastError();
}

// The occupancy of one kernel as the card reports it: kernel 0 select, 1
// apply (one validity row per block), 2 finish, 3 usage, 4 select, 5 apply
// (two validity rows per block), with bf16 (mv_is_bf16) or fp32 values; info
// gets registers, static and dynamic shared bytes, resident blocks per SM,
// threads per block, local (spill) bytes per thread.
extern "C" int vosesam_memory_read_occupancy(int mv_is_bf16, int kernel, int* info) {
  if (kernel == 2)
    return mv_is_bf16 ? occupancy(memory_read_finish<__nv_bfloat16>, 256, 0, info)
                      : occupancy(memory_read_finish<float>, 256, 0, info);
  if (kernel == 3) return occupancy(memory_read_usage, 256, 0, info);
  if (kernel < 0 || kernel > 5) return (int)cudaErrorInvalidValue;
  return mv_is_bf16 ? occupancy_pass<__nv_bfloat16>(kernel, info)
                    : occupancy_pass<float>(kernel, info);
}

#ifdef VOSESAM_PROFILE
extern "C" int vosesam_memory_read_profile(void* dst, int n_blocks) {
  return (int)cudaMemcpyFromSymbol(dst, g_prof, (size_t)n_blocks * 16 * 8);
}
#endif
