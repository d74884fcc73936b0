// Fused XMem memory read for Hopper (sm_90a): exact top-k threshold ->
// sparse softmax -> value readout, plus the per-slot usage column sums.
//
// Replaces the Pallas TPU kernels in vosesam_tpu/ops/pallas/memory_read.py:
//   fused_memory_read_shared (one validity row shared by every object)
//   fused_memory_read        (one validity row per object)
// Both are one kernel here: R validity rows, R = 1 (shared mode, the block
// reads out all O objects against one threshold) or R = O (per-object mode,
// the block reads out object r only). The (Q, M) fp32 similarity comes from
// a torch.matmul in the Python wrapper, as the JAX package leaves it to XLA.
//
// What bounds it on the H100: the similarity, (Q, M) fp32 = 111 MB at DAVIS
// 480p (Q = 1620, M = 17 200), which this design streams three times (top-k
// scan, admission scan, usage column sums) — about 0.1 ms of HBM traffic at
// 3.35 TB/s, against 35 MB of bf16 values of which only ~k rows per query
// are touched. The design therefore never forms the dense (Q, M) affinity
// and never multiplies by it:
//   memory_read_rows, one block per (query row, validity row):
//     phase A  each thread keeps a sorted top-32 of its strided slice of the
//              row in registers; k rounds of a block-wide argmax merge give
//              the exact k-th value (counting duplicates, as lax.top_k) and
//              the row max. Slots >= live_end are never read.
//     phase B  a second scan admits sim >= threshold && valid, compacts the
//              admitted (index, exp(sim - max)) pairs into shared memory
//              with a warp ballot, and gathers those ~k rows of the values
//              into the fp32 output. The denominator is the sum of the
//              admitted weights (ops/memory_attention.py:topk_softmax).
//   memory_read_usage, one thread column per memory slot: sums
//     exp(sim - max) / denominator over the query rows in a fixed order —
//     deterministic, no float atomics, so consolidation's prototype choice
//     (memory/manager.py) does not change from run to run.
// Rows with fewer than k valid slots get a NEG_INF threshold and admit every
// valid slot; a row with no valid slot reads out zeros.
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;
constexpr float kNegInf = -1e30f;  // ops/memory_attention.py NEG_INF
constexpr int kColTile = 32;
constexpr int kRowGroups = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Warp argmax of (v, id): the larger value wins, ties go to the smaller id.
__device__ __forceinline__ void warp_argmax(float& v, int& id) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oid = __shfl_down_sync(0xffffffffu, id, off);
    if (ov > v || (ov == v && oid < id)) {
      v = ov;
      id = oid;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) memory_read_rows(
    const float* __restrict__ sim,      // (Q, M) fp32
    const uint8_t* __restrict__ valid,  // (R, M) 0/1
    const T* __restrict__ mv,           // (O, M, Cv)
    float* __restrict__ out,            // (O, Q, Cv) fp32
    float* __restrict__ th_out,         // (R, Q) threshold
    float* __restrict__ max_out,        // (R, Q) row max
    float* __restrict__ linv_out,       // (R, Q) 1 / denominator
    int Q, int M, int live_end, int O, int Cv, int k, int shared_mode) {
  __shared__ float s_val[kWarps];
  __shared__ int s_id[kWarps];
  __shared__ float s_pick;
  __shared__ int s_winner;
  __shared__ int s_cnt[kWarps];
  __shared__ int s_idx[kThreads];
  __shared__ float s_w[kThreads];

  const int q = blockIdx.x;
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* srow = sim + (size_t)q * M;
  const uint8_t* vrow = valid + (size_t)r * M;

  // ---- phase A: per-thread sorted top-32, descending, in registers.
  float top[kMaxK];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) top[i] = kNegInf;
  for (int m = tid; m < live_end; m += kThreads) {
    float s = vrow[m] ? srow[m] : kNegInf;
    if (s > top[kMaxK - 1]) {
#pragma unroll
      for (int i = 0; i < kMaxK; ++i) {  // insertion by compare-exchange
        float hi = fmaxf(top[i], s);
        s = fminf(top[i], s);
        top[i] = hi;
      }
    }
  }
  // k rounds of a block-wide argmax over the threads' heads; the winner
  // pops its head. Round 0 yields the row max, round k-1 the threshold.
  float row_max = kNegInf;
  float th = kNegInf;
  for (int round = 0; round < k; ++round) {
    float v = top[0];
    int id = tid;
    warp_argmax(v, id);
    if (lane == 0) {
      s_val[warp] = v;
      s_id[warp] = id;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? s_val[lane] : -INFINITY;
      id = lane < kWarps ? s_id[lane] : 0x7fffffff;
      warp_argmax(v, id);
      if (lane == 0) {
        s_pick = v;
        s_winner = id;
      }
    }
    __syncthreads();
    const float pick = s_pick;
    if (tid == s_winner) {
#pragma unroll
      for (int i = 0; i < kMaxK - 1; ++i) top[i] = top[i + 1];
      top[kMaxK - 1] = kNegInf;
    }
    if (round == 0) row_max = pick;
    th = pick;
  }

  // ---- phase B: admit, compact, gather the admitted value rows.
  const int o_begin = shared_mode ? 0 : r;
  const int n_feat = (shared_mode ? O : 1) * Cv;
  for (int f = tid; f < n_feat; f += kThreads) {
    const int o = o_begin + f / Cv;
    out[((size_t)o * Q + q) * Cv + f % Cv] = 0.f;
  }
  float denom = 0.f;
  for (int base = 0; base < live_end; base += kThreads) {
    const int m = base + tid;
    bool admit = false;
    float w = 0.f;
    if (m < live_end && vrow[m]) {
      const float s = srow[m];
      if (s >= th) {
        admit = true;
        w = expf(s - row_max);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, admit);
    if (lane == 0) s_cnt[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0;
    int total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int c = s_cnt[i];
      offset += (i < warp) ? c : 0;
      total += c;
    }
    if (admit) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
      s_idx[pos] = m;
      s_w[pos] = w;
    }
    __syncthreads();
    if (total > 0) {  // uniform over the block
      for (int j = 0; j < total; ++j) denom += s_w[j];
      for (int f = tid; f < n_feat; f += kThreads) {
        const int o = o_begin + f / Cv;
        const int c = f % Cv;
        const T* col = mv + (size_t)o * M * Cv + c;
        float acc = 0.f;
        for (int j = 0; j < total; ++j) acc += s_w[j] * to_float(col[(size_t)s_idx[j] * Cv]);
        out[((size_t)o * Q + q) * Cv + c] += acc;
      }
    }
    // No trailing barrier: the next round writes s_cnt after this round's
    // second __syncthreads (every read of s_cnt comes before it) and
    // s_idx/s_w after its own first one (every gather above comes before
    // that).
  }
  const float linv = 1.f / fmaxf(denom, 1e-30f);
  for (int f = tid; f < n_feat; f += kThreads) {
    const int o = o_begin + f / Cv;
    out[((size_t)o * Q + q) * Cv + f % Cv] *= linv;
  }
  if (tid == 0) {
    th_out[(size_t)r * Q + q] = th;
    max_out[(size_t)r * Q + q] = row_max;
    linv_out[(size_t)r * Q + q] = linv;
  }
}

// usage[m] = scale * sum_r sum_q [valid(r, m) && sim(q, m) >= th(r, q)]
//            * exp(sim(q, m) - max(r, q)) * linv(r, q)
// Block (kColTile, kRowGroups): each thread sums a strided set of rows of
// one column, then the row groups are added in a fixed order.
__global__ void __launch_bounds__(kColTile * kRowGroups) memory_read_usage(
    const float* __restrict__ sim, const uint8_t* __restrict__ valid,
    const float* __restrict__ th, const float* __restrict__ mx,
    const float* __restrict__ linv, float* __restrict__ usage,
    int Q, int M, int live_end, int R, float scale) {
  __shared__ float part[kRowGroups][kColTile + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int m = blockIdx.x * kColTile + tx;
  float u = 0.f;
  if (m < live_end) {
    for (int r = 0; r < R; ++r) {
      if (!valid[(size_t)r * M + m]) continue;
      const float* th_r = th + (size_t)r * Q;
      const float* mx_r = mx + (size_t)r * Q;
      const float* li_r = linv + (size_t)r * Q;
      for (int q = ty; q < Q; q += kRowGroups) {
        const float s = sim[(size_t)q * M + m];
        if (s >= th_r[q]) u += expf(s - mx_r[q]) * li_r[q];
      }
    }
  }
  part[ty][tx] = u;
  __syncthreads();
  if (ty == 0 && m < M) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kRowGroups; ++i) t += part[i][tx];
    usage[m] = t * scale;
  }
}

}  // namespace

extern "C" int vosesam_memory_read(
    const float* sim, const uint8_t* valid, const void* mv, int mv_is_bf16,
    float* out, float* th, float* mx, float* linv, float* usage,
    int Q, int M, int live_end, int O, int Cv, int k, int R, int shared_mode,
    float usage_scale, void* stream_ptr) {
  if (k < 1 || k > kMaxK || live_end < 0 || live_end > M) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (Q > 0) {
    const dim3 grid(Q, R);
    if (mv_is_bf16) {
      memory_read_rows<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
          sim, valid, static_cast<const __nv_bfloat16*>(mv), out, th, mx, linv,
          Q, M, live_end, O, Cv, k, shared_mode);
    } else {
      memory_read_rows<float><<<grid, kThreads, 0, stream>>>(
          sim, valid, static_cast<const float*>(mv), out, th, mx, linv,
          Q, M, live_end, O, Cv, k, shared_mode);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (usage != nullptr && M > 0) {
    const dim3 grid((M + kColTile - 1) / kColTile);
    const dim3 block(kColTile, kRowGroups);
    memory_read_usage<<<grid, block, 0, stream>>>(
        sim, valid, th, mx, linv, usage, Q, M, live_end, R, usage_scale);
  }
  return (int)cudaGetLastError();
}
