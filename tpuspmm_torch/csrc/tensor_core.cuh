// Device helpers for the tensor-core kernels of tpuspmm_torch (sm_90a):
// asynchronous 16-byte copies into shared memory, ldmatrix fragment loads,
// the bf16 m16n8k16 product with f32 accumulation, the bf16 term split
// of kernels/common.py::split_bf16, two values at a time, and the
// mbarriers, bulk copies (the TMA unit, 1-D: no tensor map) and thread
// block clusters that K6 (bsr_spmm.cu) and the C-resident cluster kernel
// (chunk_spmm.cu) stage with.
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

// ldmatrix_x4_trans's first two matrices: one n8 tile's B fragment (its
// rows' addresses from lanes 0-15)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// ---- mbarriers, bulk copies, clusters -----------------------------------

// an mbarrier whose phases complete after `count` arrivals (and the bytes
// they expect)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// make the barriers this thread initialised visible to the cluster and to
// the copy unit
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// one arrival on the barrier at bar's offset in the shared memory of CTA
// `rank` of this cluster (mapa), with mbarrier.arrive's default semantics,
// release at CTA scope, as CUTLASS's ClusterBarrier arrives: the callers
// release no data through it, only a stage their block has read, and a
// release at cluster scope (.release.cluster) cost the C-resident cluster
// launch 4-14% of its time on the dense operands (strip_sweep.py --chunk,
// cluster2_release_cluster; NVIDIA H100 80GB HBM3, 700 W)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// one arrival on this CTA's barrier (release at CTA scope)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one arrival on `bar` once every cp.async this thread issued before it
// has landed; .noinc: the barrier's count includes these arrivals
__device__ __forceinline__ void cp_async_mbar_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// order this thread's view of shared memory written through the generic
// proxy (cp.async, stores) before its asynchronous-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` global -> shared by the TMA unit, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bulk_copy into the same offsets of every CTA of the cluster in `mask`
// (bit r: CTA rank r), each completing on its own barrier at bar's offset:
// one read of the source for all of them
__device__ __forceinline__ void bulk_copy_multicast(void* dst,
                                                    const void* src,
                                                    int bytes, uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// every thread of every CTA of the cluster: arrive (release), then wait for
// all of them (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

}  // namespace tc
