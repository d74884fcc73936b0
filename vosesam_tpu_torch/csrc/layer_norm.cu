// LayerNorm over the channel axis, with an optional residual added first,
// for Hopper (sm_90a):
//
//   s      = x + residual                (rounded to x's dtype)
//   mu     = mean(s),  var = mean((s - mu)^2)
//   normed = (s - mu) * rsqrt(var + eps) * w + b      (fp32, rounded once)
//
// over rows of C channels, bf16 or fp32 activations, fp32 weight and bias.
// The sum is rounded to the activations' dtype before its statistics are
// taken, as `shortcut + y` rounds it in the plain chain, so the `sum` output
// is the plain chain's residual stream bit for bit; only the order of the
// two reductions differs from it.
//
// Replaces no TPU kernel. In the JAX package XLA fuses LayerNorm
// (vosesam_tpu/models/layers.py layer_norm) and the residual add before it
// into one or two loop fusions; run eagerly, the same expression is ~12
// kernels with fp32 intermediates (x.float(), two means, three broadcast
// subtracts and multiplies, rsqrt, the affine, the cast back), and the SAM
// ViT runs it twice in each of its 32 blocks.
//
// What bounds it on the H100: bytes. At the encoder's shape (8 frames of
// 64 x 64 tokens, C 1280, bf16: 84 MB an activation) the norm without a
// residual reads x and writes normed (168 MB, 0.050 ms at 3.35 TB/s); with
// the residual it reads x and the residual and writes the sum and normed
// (336 MB, 0.100 ms). The chain it replaces moves ~30x that through its
// fp32 intermediates. ~8 operations a value: far below the card's ratio.
//
// Design: a warp per row; each lane holds NV packs of VEC values (16
// bytes: 8 bf16 or 4 fp32) in fp32 registers, pack i at channel (i * 32 +
// lane) * VEC, so every load and store instruction of a warp covers 512
// contiguous bytes. At most 40 values a lane (kMaxValues): C up to 1,280,
// vit_h's width and the port's widest (bf16 NV 1-5, fp32 NV 1-10; 15
// instances). The row is read once; the mean and then the variance of the
// centred values are summed from the registers (two-pass, as the chain
// computes them) with warp shuffles. The affine is a multiply and then an
// add, each rounded (no fused multiply-add), as the chain's `y * w + b` is.
// 128 threads a block: four rows. x and the residual may be strided views
// with a dense channel axis: the wrapper describes their rows as up to
// three leading dimensions with a stride each (the encoder's residual is
// the `window_unpartition` slice of a padded grid, which goes in without a
// copy). Outputs are contiguous. C, every stride and every pointer must
// allow 16-byte packs; the wrapper raises for tensors that do not.

// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxValues = 40;   // fp32 registers of the row a lane

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N values loaded or stored by 16-byte instructions.
template <typename T, int N>
struct alignas(16) Pack {
  T v[N];
};

// The rows' leading dimensions (d0, d1, d2), d0 implied by the row count,
// and the strides in elements of x and of the residual along them.
struct Rows {
  long long d1, d2;
  long long xs[3], rs[3];
};

__device__ __forceinline__ long long row_offset(long long r, const Rows& g, const long long* s) {
  const long long i2 = r % g.d2;
  const long long q = r / g.d2;
  return (q / g.d1) * s[0] + (q % g.d1) * s[1] + i2 * s[2];
}

// The sum of v over the warp, in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ w,
    const float* __restrict__ b, T* __restrict__ out, T* __restrict__ sum_out,
    long long rows, int C, Rows g, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;       // a whole warp
  const T* xr = x + row_offset(row, g, g.xs);
  const T* rr = res == nullptr ? nullptr : res + row_offset(row, g, g.rs);
  const long long dense = row * C;

  float v[NV][VEC];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * VEC;
    if (c < C) {
      Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + c);
      if (rr != nullptr) {
        const Pack<T, VEC> q = *reinterpret_cast<const Pack<T, VEC>*>(rr + c);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          p.v[j] = from_float<T>(to_float(p.v[j]) + to_float(q.v[j]));
        *reinterpret_cast<Pack<T, VEC>*>(sum_out + dense + c) = p;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[i][j] = to_float(p.v[j]);
        s += v[i][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] = 0.f;
    }
  }
  const float mu = warp_sum(s) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if ((i * 32 + lane) * VEC < C) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[i][j] -= mu;
        q += v[i][j] * v[i][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)C + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * VEC;
    if (c < C) {
      const Pack<float, VEC> wp = *reinterpret_cast<const Pack<float, VEC>*>(w + c);
      const Pack<float, VEC> bp = *reinterpret_cast<const Pack<float, VEC>*>(b + c);
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = from_float<T>(__fadd_rn(__fmul_rn(__fmul_rn(v[i][j], rstd), wp.v[j]), bp.v[j]));
      *reinterpret_cast<Pack<T, VEC>*>(out + dense + c) = o;
    }
  }
}

// The instance with nv packs a lane (1 <= nv <= NV), or null.
template <typename T, int NV>
const void* pick_packs(int nv) {
  if constexpr (NV == 0) {
    return nullptr;
  } else {
    return nv == NV ? reinterpret_cast<const void*>(layer_norm_kernel<T, NV>)
                    : pick_packs<T, NV - 1>(nv);
  }
}

const void* pick(int bf16, int nv) {
  return bf16 ? pick_packs<__nv_bfloat16, kMaxValues / 8>(nv)
              : pick_packs<float, kMaxValues / 4>(nv);
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x, residual (or null): rows of C values, bf16 (bf16 = 1) or fp32, with a
// dense channel axis; the rows are (rows / (d1 * d2), d1, d2) with strides
// strides[0..2] (x) and strides[3..5] (residual), in elements. weight and
// bias: C contiguous fp32. out, sum_out: contiguous (rows, C); sum_out is
// written only with a residual. C and every stride a multiple of 16 bytes
// of values, every pointer 16-byte aligned. nv: the instance, the packs a
// lane (nv * 32 * vec >= C > (nv - 1) * 32 * vec).
extern "C" int vosesam_layer_norm(const void* x, const void* residual, const float* weight,
                                  const float* bias, void* out, void* sum_out, int bf16,
                                  long long rows, int C, long long d1, long long d2,
                                  const long long* strides, float eps, int nv,
                                  void* stream_ptr) {
  const int vec = bf16 ? 8 : 4;
  if (rows < 0 || C < 1 || d1 < 1 || d2 < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  if ((long long)nv * 32 * vec < C || (long long)(nv - 1) * 32 * vec >= C)
    return (int)cudaErrorInvalidValue;
  if (residual != nullptr && sum_out == nullptr) return (int)cudaErrorInvalidValue;
  if (C % vec != 0) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 6; ++k)
    if (strides[k] % vec != 0) return (int)cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(residual, 16) || !aligned(out, 16) || !aligned(sum_out, 16) ||
      !aligned(weight, 16) || !aligned(bias, 16))
    return (int)cudaErrorInvalidValue;
  const void* fn = pick(bf16, nv);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  Rows g;
  g.d1 = d1;
  g.d2 = d2;
  for (int k = 0; k < 3; ++k) {
    g.xs[k] = strides[k];
    g.rs[k] = strides[3 + k];
  }
  void* args[] = {&x, &residual, &weight, &bias, &out, &sum_out, &rows, &C, &g, &eps};
  const cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(kThreads), args, 0,
                                           static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Registers, static shared memory and resident blocks per SM of one
// instance, as the card reports them; info gets three ints.
extern "C" int vosesam_layer_norm_occupancy(int bf16, int nv, int* info) {
  const void* fn = pick(bf16, nv);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = blocks;
  return (int)cudaSuccess;
}
