// Device helpers for the tensor-core kernels of tpuspmm_torch (sm_90a):
// asynchronous 16-byte copies into shared memory, ldmatrix fragment loads,
// the bf16 m16n8k16 product with f32 accumulation, and the bf16 term split
// of kernels/common.py::split_bf16, two values at a time.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4·gid + tid4):
//   A (16 x 16, row-major): reg 0 = row gid, k 2·tid4 + {0, 1}; reg 1 = row
//     gid + 8; regs 2, 3 as 0, 1 at k + 8.
//   B (16 x 8, "col"): reg 0 = k 2·tid4 + {0, 1}, column gid; reg 1 = k + 8.
//   C (16 x 8, f32): c0, c1 = row gid, columns 2·tid4 + {0, 1}; c2, c3 =
//     row gid + 8.
// A 32-bit fragment register holds its lower-index element in its low half.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; the bytes past src_bytes are
// zero-filled (src_bytes = 0 reads nothing and writes 16 zero bytes)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// as ldmatrix_x4, each matrix transposed: from a row-major K x N tile it
// gives B fragments (two k-consecutive elements of one column per register)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a @ b on the tensor cores: bf16 operands, f32 accumulators.  Not
// volatile: it touches registers only, so the compiler may interleave
// independent products
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the next bf16 terms of two values (round to nearest even, one
// cvt.rn.bf16x2.f32), taken off both: split_bf16's step on a pair, so
// successive calls give its terms in order.  Returns them as one fragment
// register, lo at the lower index
__device__ __forceinline__ uint32_t bf16x2_term(float& lo, float& hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  lo -= __low2float(h);
  hi -= __high2float(h);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace tc
