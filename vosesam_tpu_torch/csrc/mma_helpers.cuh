// Tensor-core helpers shared by the attention kernels (flash_attention.cu,
// window_attention.cu): the warp-level mma.sync m16n8k16 bf16 product with
// fp32 accumulation, the moves that feed its fragments, the asynchronous
// copy into shared memory, and the warpgroup-level wgmma products (sm_90a)
// with their shared-memory descriptors and fences.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row):  a0 = A[g][2t..], a1 = A[g+8][2t..],
//                      a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]   (bf16 pairs)
//   B (16 x 8, col):   b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16 x 8):        c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vosesam {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 bf16 matrices from shared memory, each transposed on the way:
// lane l gives the 16-byte-aligned address of row (l % 8) of matrix (l / 8);
// register i then holds M_i[2t..2t+1][g], which is a B-fragment half when
// M_i is a row-major (key, channel) tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes from device memory straight into shared memory, without a stop in
// registers (both addresses 16-byte aligned); with `valid` false nothing is
// read and the 16 bytes are zero-filled. Completion: cp_async_wait_all().
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Pipelined form: close the group of copies issued since the last commit,
// then wait until at most N groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory, untransposed: lane l gives the
// address of row (l % 8) of matrix (l / 8); register i then holds
// M_i[g][2t..2t+1], which is a B-fragment half when M_i is a row-major
// (key, channel) tile of K for Q.K^T.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ---------------------------------------------------------------- wgmma
// A warpgroup (4 warps) computes a 64-row product; warp w % 4 holds rows
// 16 (w % 4) .. + 15 in the layouts above: A from registers as the m16n8k16
// A-fragment of its 16 rows, D as one m16n8 C-fragment per 8 columns. B
// comes from shared memory through a descriptor of no-swizzle core
// matrices (8 rows x 16 bytes, 128 contiguous bytes each): for a K-major B
// (k contiguous) LBO is the byte stride between the two core matrices along
// k and SBO the stride between 8-row groups along n; for an MN-major B (n
// contiguous, tnsp 1) SBO is the stride between core matrices along n and
// LBO the stride between 8-row groups along k (CUTLASS's canonical layouts,
// cute/atom/mma_traits_sm90_gmma.hpp).

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Order this thread's register writes before the wgmma that reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Generic-proxy writes (cp.async, st.shared) of this thread made visible to
// the async proxy that wgmma reads shared memory through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving accesses of wgmma's registers across the
// asynchronous product's start and wait.
__device__ __forceinline__ void fence_operands(float (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int M>
__device__ __forceinline__ void fence_operands(float (&r)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i) fence_operands(r[i]);
}

// D (64 x 64, fp32) = A (64 x 16, bf16, registers) . B (16 x 64, K-major)
// + (accumulate ? D : 0); d[j] is the C-fragment of columns 8j .. 8j + 7.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 16, fp32) += A (64 x 16, bf16, registers) . B (16 x 16, MN-major:
// tnsp 1); d0, d1 the C-fragments of columns 0..7 and 8..15.
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d0)[4], float (&d1)[4],
                                                   const uint32_t (&a)[4], uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

}  // namespace vosesam
