// Warp-level tensor-core helpers shared by the attention kernels
// (flash_attention.cu, window_attention.cu): the mma.sync m16n8k16 bf16
// product with fp32 accumulation, the moves that feed its fragments and
// the asynchronous copy into shared memory.
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

}  // namespace vosesam
