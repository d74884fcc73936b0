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
// outputs: 0.018 ms at the fp32 rate. The scan stays dense, as the TPU probe
// is: every (shift, tap) multiply-add is issued, zero weights included.
//
// Design. A thread owns one (row, group) and all cg channels of the group,
// so that one selection weight feeds cg fused multiply-adds; it holds its
// taps' (y0, 1 - wy, wy) and its cg accumulators in registers. The weight
// of a tap at shift s is one integer compare and two selects: a tap selects
// 1 - wy where s == y0, else what the shift before left for it (wy one
// shift after y0, else 0).
// A block owns R rows of one tile (R x G threads, 16 x 16 at the probe's
// shape) and walks the shifts in windows of SW: the window's source rows
// (R + SW - 1 of them) are staged in shared memory by 4-byte cp.async,
// transposed to group-major order (each group's cg channels contiguous,
// groups padded to an odd number of 16-byte chunks), into one of two
// buffers, while the block scans the window before it from the other. A
// thread reads its cg values of one source row as cg / 4 16-byte loads
// (conflict-free: the 8 threads of a load phase hit 8 distinct chunks), and
// the loop issues the next shift's loads before this shift's multiply-adds.
// Per shift and thread: cg / 4 loads, 3 x taps weight instructions and
// cg x taps multiply-adds (144 of 175 issue slots at the probe's shape).
// The multiply-adds of an accumulator run in the plain version's order
// (shift, then tap), each fused: kernel and plain agree within 1e-5.
//
// The first design (one thread per (row, group), 16 strided __ldg a shift,
// six instructions a weight, no staging) reached 23% of the bound; PERF.md
// has both designs' times.
//
// vosesam_binscan_occupancy reports the instance's registers, shared memory
// and resident blocks per SM on the card. Built with -DVOSESAM_PROFILE,
// thread 0 of every block stamps the global timer at the ends of its phases
// (python -m vosesam_tpu_torch.ops.kernels.phases).
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads a block, at most
constexpr int kMaxTaps = 9;
constexpr int kWindow = 32;       // shifts a staged window, at most
constexpr int kSmemBudget = 200 * 1024;

#ifdef VOSESAM_PROFILE
// per block: start, first window staged, scan done, stored (ns), ns waited
// for the later windows' staging, SM id
__device__ unsigned long long g_prof[1 << 16][6];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %smid;" : "=r"(s));
  return s;
}
#define PROF(slot)                                                                   \
  do {                                                                               \
    if (threadIdx.x == 0 && blockIdx.x < (1 << 16)) g_prof[blockIdx.x][slot] = now_ns(); \
  } while (0)
#else
#define PROF(slot) do {} while (0)
#endif

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Floats from a group's start to the next group's in shared memory: the cg
// channels, padded to an odd number of 16-byte chunks where a thread reads
// 16-byte vectors, so that 8 neighbouring groups start in 8 distinct chunks.
__host__ __device__ constexpr int group_stride(int cg) {
  return cg >= 8 ? cg + 4 : cg;
}

// cg values of one group from shared memory, as wide loads as cg allows.
template <int CG>
__device__ __forceinline__ void load_group(float (&v)[CG], const float* p) {
  if constexpr (CG % 4 == 0) {
#pragma unroll
    for (int q = 0; q < CG / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
    }
  } else if constexpr (CG == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

struct Plan {
  int rows;      // rows a block (R)
  int window;    // shifts a staged window (SW)
  int threads;   // R x G
  size_t smem;   // two buffers of R + SW rows (one spare row for the look-ahead load)
};

__host__ __device__ inline size_t buffer_floats(int rows, int window, int G, int cg) {
  return static_cast<size_t>(rows + window) * G * group_stride(cg);
}

Plan plan_for(int P, int G, int cg, int bins) {
  Plan pl;
  pl.rows = kThreads / G;
  if (pl.rows > P) pl.rows = P;
  if (pl.rows < 1) pl.rows = 1;
  pl.window = bins < kWindow ? (bins > 0 ? bins : 1) : kWindow;
  while (pl.window > 1 && 2 * buffer_floats(pl.rows, pl.window, G, cg) * 4 > kSmemBudget)
    pl.window /= 2;
  while (pl.rows > 1 && 2 * buffer_floats(pl.rows, pl.window, G, cg) * 4 > kSmemBudget)
    pl.rows /= 2;
  pl.threads = pl.rows * G;
  pl.smem = 2 * buffer_floats(pl.rows, pl.window, G, cg) * 4;
  return pl;
}

// Stage source rows [row0, row0 + n) of a tile (n <= the buffer's rows) into
// `buf`, group-major; rows at or past rows_in are left as they are (no
// thread reads them for a shift it scans).
__device__ __forceinline__ void stage(float* buf, const float* xt, int row0, int n,
                                      int rows_in, int cin, int G, int gs) {
  if (row0 + n > rows_in) n = rows_in - row0;
  const int t = threadIdx.x, T = blockDim.x;
  if (cin >= T) {
    for (int c = t; c < cin; c += T) {
      float* d = buf + (c % G) * gs + c / G;
      const float* s = xt + static_cast<long long>(row0) * cin + c;
      for (int r = 0; r < n; ++r) cp_async4(d + r * G * gs, s + static_cast<long long>(r) * cin);
    }
  } else {
    const int c = t % cin, rstep = T / cin;
    if (t / cin < rstep) {
      float* d = buf + (c % G) * gs + c / G;
      const float* s = xt + static_cast<long long>(row0) * cin + c;
      for (int r = t / cin; r < n; r += rstep)
        cp_async4(d + r * G * gs, s + static_cast<long long>(r) * cin);
    }
  }
}

template <int CG>
__global__ void __launch_bounds__(kThreads)
binscan_kernel(const float* __restrict__ x, const int* __restrict__ y0,
               const float* __restrict__ wy, float* __restrict__ out,
               int P, int rows_in, int G, int taps, int bins, int R, int SW) {
  extern __shared__ __align__(16) float smem[];
  constexpr int GS = group_stride(CG);
  const int cin = G * CG;
  const int n_row_blocks = (P + R - 1) / R;
  const int tile = blockIdx.x / n_row_blocks;
  const int p0 = (blockIdx.x % n_row_blocks) * R;
  const int g = threadIdx.x % G;
  const int r = threadIdx.x / G;
  const int p = p0 + r;
  const bool active = p < P;
  const long long row = static_cast<long long>(tile) * P + p;
  const float* xt = x + static_cast<long long>(tile) * rows_in * cin;
  const int buf_floats = (R + SW) * G * GS;
  const int rs = G * GS;                         // floats a staged row
  PROF(0);

  // the first window's copies go out before the taps' loads
  const int n_windows = (bins + SW - 1) / SW;
  if (n_windows > 0) stage(smem, xt, p0, R + SW - 1, rows_in, cin, G, GS);
  cp_async_commit();

  // this thread's taps: the shift that selects 1 - wy, the two weights, and
  // q = the weight the next shift takes where this one selected nothing
  // (wy one shift after y0, else 0): a weight costs one compare and two
  // selects, w = (y0 == s) ? 1 - wy : q, q = (y0 == s) ? wy : 0
  int y0k[kMaxTaps];
  float ak[kMaxTaps], bk[kMaxTaps], qk[kMaxTaps];
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {
    if (active && k < taps) {
      const long long f = row * (taps * G) + k * G + g;   // tap-major fields
      y0k[k] = __ldg(y0 + f);
      const float w = __ldg(wy + f);
      ak[k] = 1.0f - w;
      bk[k] = w;
      qk[k] = y0k[k] == -1 ? w : 0.f;             // the weight of shift 0 where y0 == -1
    } else {
      y0k[k] = -2;                                // never selected
      ak[k] = bk[k] = qk[k] = 0.f;
    }
  }
  float acc[CG];
#pragma unroll
  for (int j = 0; j < CG; ++j) acc[j] = 0.f;

#ifdef VOSESAM_PROFILE
  unsigned long long waited = 0;
#endif
  for (int wi = 0; wi < n_windows; ++wi) {
    const int w0 = wi * SW;
    const int sw = bins - w0 < SW ? bins - w0 : SW;
    if (wi + 1 < n_windows)                       // the next window, into the other buffer
      stage(smem + ((wi + 1) & 1) * buf_floats, xt, p0 + w0 + SW, R + SW - 1, rows_in, cin,
            G, GS);
    cp_async_commit();
#ifdef VOSESAM_PROFILE
    const unsigned long long t_wait = now_ns();
#endif
    cp_async_wait<1>();
    __syncthreads();
#ifdef VOSESAM_PROFILE
    if (wi == 0) PROF(1);
    else waited += now_ns() - t_wait;
#endif
    if (active) {
      const float* src = smem + (wi & 1) * buf_floats + r * rs + g * GS;
      float cur[CG];
      load_group<CG>(cur, src);
#pragma unroll 2
      for (int i = 0; i < sw; ++i) {
        float nxt[CG];
        load_group<CG>(nxt, src + (i + 1) * rs);  // the spare row keeps this in bounds
        const int s = w0 + i;
        float wk[kMaxTaps];
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) {
          const bool hit = y0k[k] == s;
          wk[k] = hit ? ak[k] : qk[k];
          qk[k] = hit ? bk[k] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) {
#pragma unroll
          for (int j = 0; j < CG; ++j) acc[j] = fmaf(wk[k], cur[j], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < CG; ++j) cur[j] = nxt[j];
      }
    }
    __syncthreads();                              // the buffer is staged into again next
  }
  PROF(2);
  if (active) {
    float* o = out + row * cin + g;
#pragma unroll
    for (int j = 0; j < CG; ++j) o[j * G] = acc[j];
  }
  PROF(3);
#ifdef VOSESAM_PROFILE
  if (threadIdx.x == 0 && blockIdx.x < (1 << 16)) {
    g_prof[blockIdx.x][4] = waited;
    g_prof[blockIdx.x][5] = smid();
  }
#endif
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// info: registers per thread, static shared bytes, dynamic shared bytes,
// resident blocks per SM, threads per block, local (spill) bytes per thread,
// rows per block, shifts per staged window.
template <typename K>
int occupancy(K kernel, const Plan& pl, int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = (cudaError_t)prepare(kernel, pl.smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, pl.threads, pl.smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = fa.numRegs;
  info[1] = (int)fa.sharedSizeBytes;
  info[2] = (int)pl.smem;
  info[3] = blocks;
  info[4] = pl.threads;
  info[5] = (int)fa.localSizeBytes;
  info[6] = pl.rows;
  info[7] = pl.window;
  return 0;
}

bool valid_shape(int n_tiles, int P, int rows_in, int G, int cg, int taps, int bins) {
  if (n_tiles < 0 || P < 1 || G < 1 || G > kThreads || taps < 1 || taps > kMaxTaps ||
      bins < 0 || rows_in < P + bins - 1)
    return false;
  if (cg != 1 && cg != 2 && cg != 4 && cg != 8 && cg != 16) return false;
  if (static_cast<long long>(n_tiles) * rows_in * G * cg > 2147483647LL) return false;
  const Plan pl = plan_for(P, G, cg, bins);
  return pl.smem <= kSmemBudget;
}

}  // namespace

// x (n_tiles, rows_in, G * cg), y0 int32 and wy fp32 (n_tiles, P, taps * G),
// out (n_tiles, P, G * cg), contiguous; rows_in >= P + bins - 1; taps <= 9;
// G <= 256; cg one of 1, 2, 4, 8, 16.
extern "C" int vosesam_binscan_probe(
    const float* x, const int* y0, const float* wy, float* out,
    int n_tiles, int P, int rows_in, int G, int cg, int taps, int bins, void* stream_ptr) {
  if (!valid_shape(n_tiles, P, rows_in, G, cg, taps, bins)) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Plan pl = plan_for(P, G, cg, bins);
  const long long blocks = static_cast<long long>(n_tiles) * ((P + pl.rows - 1) / pl.rows);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
#define LAUNCH(CG_)                                                                     \
  do {                                                                                  \
    const int err = prepare(binscan_kernel<CG_>, pl.smem);                              \
    if (err != 0) return err;                                                           \
    binscan_kernel<CG_><<<grid, pl.threads, pl.smem, stream>>>(                         \
        x, y0, wy, out, P, rows_in, G, taps, bins, pl.rows, pl.window);                 \
  } while (0)
  switch (cg) {
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 4: LAUNCH(4); break;
    case 8: LAUNCH(8); break;
    default: LAUNCH(16); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

// The occupancy of the instance that a launch at (P, G, cg, bins) selects,
// as the card reports it; info gets eight ints (see occupancy()).
extern "C" int vosesam_binscan_occupancy(int P, int G, int cg, int bins, int* info) {
  if (!valid_shape(1, P, P + bins, G, cg, 1, bins)) return (int)cudaErrorInvalidValue;
  const Plan pl = plan_for(P, G, cg, bins);
  switch (cg) {
    case 1: return occupancy(binscan_kernel<1>, pl, info);
    case 2: return occupancy(binscan_kernel<2>, pl, info);
    case 4: return occupancy(binscan_kernel<4>, pl, info);
    case 8: return occupancy(binscan_kernel<8>, pl, info);
    default: return occupancy(binscan_kernel<16>, pl, info);
  }
}

#ifdef VOSESAM_PROFILE
extern "C" int vosesam_binscan_profile(void* dst, int n_blocks) {
  return (int)cudaMemcpyFromSymbol(dst, g_prof, (size_t)n_blocks * 6 * 8);
}
#endif
