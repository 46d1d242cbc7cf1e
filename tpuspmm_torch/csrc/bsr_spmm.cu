// Block-streaming BSR SpMM for Hopper (sm_90a): kernel K6 of tpuspmm_torch.
//
// Replaces tpuspmm/kernels/bsr_spmm.py::_kernel (launch _bsr_spmm).  The TPU
// kernel's grid is (n tile, stored block) over the stored blocks sorted by
// block row, an empty block row holding one zero block; step i computes
// blocks[i] @ B[kt[i]*bw : +bw, n tile] at HIGHEST precision and stores it
// into block row rt[i] on that row's first block (first[i]), adding it
// otherwise.  That relies on grid steps running in order.
//
// Here block (block row br, row sub-tile, column tile) owns output rows
// [br*bh + sub*RT, +RT) and TN = 64 columns.  It walks block row br's stored
// blocks in stored order (from indptr: the order of JAX's stable-sorted rt),
// KC = 64 block columns a step, keeps the sums in registers and stores once:
// no atomics, no first flag, no zero pass, the same sums on every run, and
// an empty block row is written as zeros (JAX's zero block, without storing
// one).  Block rows are launched most stored blocks first (row_order, built
// on the host), so the owners of the heaviest rows start in the first wave.
//
// Tensor cores through wgmma, with the product transposed, C^T = B^T A^T:
// wgmma's M is the 64 output columns of a warpgroup, its N the RT rows of
// the sub-tile and its K 16 block columns a step.  M is fixed at 64 while N
// may be any multiple of 8, so block rows map to N: RT is the largest of
// ROW_TILES that divides bh (128, 32 or 8; bh > 128 splits into 128-row
// sub-tiles, which keeps the accumulators at RT / 2 = 64 registers a
// thread), and every block height the admission takes (bh % 8 == 0) runs
// without padding block rows.
//   - B^T is wgmma's A operand, from registers: each thread reads its
//     fragment's values from the staged B tile and, for an f32 B, splits
//     them into three bf16 terms as it loads them (tc::bf16x2_term); a bf16
//     B is loaded as it is (ldmatrix.trans).
//   - A^T is wgmma's B operand, from shared memory by descriptor.  The
//     blocks are static, so their three bf16 terms (split_bf16's, in order)
//     are built once per matrix on the host (kernels/bsr_spmm.py::
//     term_planes) in this kernel's shared-memory byte order: for each
//     (block, sub-tile, k-step) the three RT x 64 term planes, each row 128
//     bytes, K-major, in the 128-byte swizzle the descriptor names.  One
//     bulk copy (cp.async.bulk, the TMA unit, completing on an mbarrier)
//     moves a step's planes: the planes are stored as the tile wants them,
//     so no tensor map is needed (no cuTensorMapEncodeTiled, no -lcuda).
// Precision ("highest"): with f32 B the products of A term i and B term j
// with i + j < 3, six a k-step: the strip routine's ladder (strip_spmm.cu);
// with bf16 B, B is exact and A's three terms make three products.  Each
// bf16 product is exact, but each wgmma loses low bits at its f32
// accumulator's magnitude, as truncation would.  One accumulator carried
// through a block row (432 wgmmas on weight (a)'s heaviest row with f32 B,
// 216 with bf16) read 8.8e-6·max|C| from the plain version with f32 B and
// 4.6e-6 with bf16, growing with the wgmmas it took: three f32-B products
// read 5.9e-6, no worse than six (PERF.md).  So each step (KC block
// columns) runs its products into a fresh accumulator (`part`, at the
// step's magnitude) and adds it into the row's f32 sums (`acc`) in
// registers, rounded to nearest.  chip_smoke.py holds the result to K6_TOL
// (2e-6·max|C|) of the plain version, a limit that the three f32-B
// products (0,0), (0,1), (1,0) miss even when summed exactly: what they
// drop is 4.4-4.6e-6·max|C| in the CPU tests (tests/test_torch_bsr.py),
// and chip_smoke.py's control checks that it misses on the card.
//
// Staging: a ring of STAGES steps in dynamic shared memory (3 at RT 128, 2
// below), each the step's A planes (bulk copy, mbarrier) and its 64 x TN B
// tile.  B changes every call, so it is staged by 16-byte cp.async (rows >=
// K and columns >= N zero-filled) where its rows are 16-byte aligned, and
// by plain loads and stores into the same ring where they are not (f32 N %
// 4, bf16 N % 8, or an unaligned base: the wrapper picks the build, and
// chip_smoke.py holds both).  Each step: wait for its copies, one
// __syncthreads (the stage last read is then free), start the copies
// STAGES - 1 steps ahead, load and split the step's B fragments, then issue
// its wgmmas (24 with f32 B, 12 with bf16), wait for them and add them into
// the sums.
//
// What bounds it: the products.  At the pruned-weight cell (96 blocks of
// 128 x 128, B 4096 x 512) that is 9.7 GFLOP with f32 B (six products) or
// 4.8 with bf16 B: 0.0098 / 0.0049 ms at 989 TFLOP/s, above the 0.0069 ms of
// its 23 MB at 3.35 TB/s.  The block rows hold 0-9 blocks, so the owners of
// the heaviest row set the floor: 9 blocks x 64 columns at one SM's share
// of the rate, 0.015 / 0.0076 ms.  Measured (PERF.md; H100 SXM, 700 W):
// about 0.038 / 0.025-0.030 ms, so the heaviest row's owner spends 2.5-4x
// its products' time: a step's B split, its wait for copies and its
// products run one after another on one warpgroup (copying 1 KB of a
// step's planes instead of 48 KB is no faster).
//
// Left for later: a producer warpgroup that writes B's bf16 terms into
// shared memory, so that wgmma reads both operands by descriptor while the
// consumer multiplies the previous step; cluster multicast of the planes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

// Tuning constants (PERF.md; strip_sweep.py --bsr times other values on
// patched copies of this file).  kernels/bsr_cuda.py holds equal values,
// which a CPU test checks.
constexpr int KC = 64;           // block columns a step: one 128-byte row
constexpr int TERMS = 3;         // bf16 term planes of A
constexpr int COLS = 64;         // output columns a warpgroup (wgmma's M)
constexpr int WARPGROUPS = 1;    // warpgroups a block: TN = COLS * this
constexpr int MAX_STAGES = 3;    // ring stages at most (128-row tiles)
// ring stages below 128 rows: a step's products are short there (N = 8 or
// 32), and a shallow ring, which fits more blocks an SM, hides the copies
// better than a deep one
constexpr int SMALL_STAGES = 2;
constexpr int F32_PRODUCTS = 6;  // ladder products a k-step with f32 B
constexpr int SMEM_LIMIT = 232448;  // opt-in shared memory per block
// row sub-tiles (wgmma's N): the first that divides bh
constexpr int ROW_TILES[] = {128, 32, 8};

// shared memory of one instantiation: the ring's A planes (1024-byte
// aligned for the swizzle), its B tiles (rows padded by 16 bytes, so a
// warp's fragment loads hit 32 banks), a barrier a stage, and 1 KB to align
// the dynamic base
template <int RT, typename TB>
struct Geo {
  static constexpr int THREADS = 128 * WARPGROUPS;
  static constexpr int TN = COLS * WARPGROUPS;
  static constexpr int PLANE_BYTES = RT * KC * 2;
  static constexpr int A_BYTES = TERMS * PLANE_BYTES;
  static constexpr int B_LD = TN + 16 / (int)sizeof(TB);  // elements
  static constexpr int B_BYTES = KC * B_LD * (int)sizeof(TB);
  static constexpr int FIT = (SMEM_LIMIT - 1024) / (A_BYTES + B_BYTES + 8);
  static constexpr int STAGES = RT < ROW_TILES[0] ? SMALL_STAGES
                               : FIT < MAX_STAGES  ? FIT
                                                   : MAX_STAGES;
  static constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES + 8);
  static constexpr int ACC = RT / 2;  // f32 accumulators a thread
  static_assert(A_BYTES % 1024 == 0 && STAGES >= 2 && STAGES <= FIT,
                "geometry");
};

// ---- wgmma helpers -------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across wgmma issue
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a K-major bf16 tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), leading offset unused (1)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (64 x N, f32) = a (64 x 16 bf16, registers) @ desc (16 x N bf16),
// plus d where `add` is nonzero
template <int N>
__device__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                      uint64_t desc, int add);

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)
#define A_DESC \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add)

template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : ACC4(0)
      : A_DESC);
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : ACC16(0)
      : A_DESC);
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : ACC16(0), ACC16(16), ACC16(32), ACC16(48)
      : A_DESC);
}

#undef ACC4
#undef ACC16
#undef A_DESC

// mbarriers and bulk copies: tc:: (tensor_core.cuh)

// ---- the kernel -------------------------------------------------------------

// VEC: B's rows are 16-byte aligned and staged by cp.async; else by plain
// loads and stores
template <int RT, typename TB, bool VEC>
__global__ void __launch_bounds__(Geo<RT, TB>::THREADS)
bsr_wgmma_kernel(const int* __restrict__ indptr,
                 const int* __restrict__ indices,
                 const int* __restrict__ row_order,
                 const uint8_t* __restrict__ planes,
                 const TB* __restrict__ b, float* __restrict__ out, int m,
                 int k, int n, int bh, int bw, int ncol) {
  using G = Geo<RT, TB>;
  using Raw = std::conditional_t<sizeof(TB) == 4, uint32_t, uint16_t>;
  constexpr int S = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - tc::smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* a_s = smem;  // S x A_BYTES
  Raw* b_s = reinterpret_cast<Raw*>(smem + S * G::A_BYTES);  // S x KC x B_LD
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S * (G::A_BYTES +
                                                          G::B_BYTES));
  const int tid = threadIdx.x;
  const int subs = bh / RT;
  const int unit = blockIdx.x / ncol;
  const int br = row_order[unit / subs];
  const int sub = unit % subs;
  const int c0 = (blockIdx.x % ncol) * G::TN;
  const int j0 = indptr[br];
  const int kq = bw / KC;
  const int steps = (indptr[br + 1] - j0) * kq;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) tc::mbar_init(&bar[s]);
    tc::fence_mbarrier_init();
  }
  __syncthreads();

  // start the copies of step t into its stage
  auto issue = [&](int t) {
    const int st = t % S;
    const int j = j0 + t / kq, q = t % kq;
    if (tid == 0) {
      tc::mbar_expect_tx(&bar[st], G::A_BYTES);
      tc::bulk_copy(a_s + st * G::A_BYTES,
                planes + ((int64_t)(j * subs + sub) * kq + q) * G::A_BYTES,
                G::A_BYTES, &bar[st]);
    }
    const int64_t krow0 = (int64_t)indices[j] * bw + q * KC;
    Raw* dst = b_s + st * KC * G::B_LD;
    const Raw* src = reinterpret_cast<const Raw*>(b);
    if constexpr (VEC) {
      constexpr int PER = 16 / (int)sizeof(TB);  // elements a copy
      constexpr int CPR = G::TN / PER;           // copies a row
#pragma unroll
      for (int c = tid; c < KC * CPR; c += G::THREADS) {
        const int r = c / CPR, col = (c % CPR) * PER;
        const int64_t krow = krow0 + r;
        const bool ok = krow < k && c0 + col < n;
        tc::cp_async16(dst + r * G::B_LD + col,
                       ok ? src + krow * n + c0 + col : src, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < KC * G::TN; e += G::THREADS) {
        const int r = e / G::TN, col = e % G::TN;
        const int64_t krow = krow0 + r;
        dst[r * G::B_LD + col] =
            (krow < k && c0 + col < n) ? src[krow * n + c0 + col] : Raw(0);
      }
    }
  };

  // acc: the sums, f32, rounded to nearest; part: one step's products,
  // wgmma's accumulator, started afresh each step (see the note above)
  float acc[G::ACC], part[G::ACC];
#pragma unroll
  for (int i = 0; i < G::ACC; ++i) acc[i] = part[i] = 0.f;

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int gid = lane / 4, t4 = lane % 4;
  const int mcol = wg * COLS + warp * 16;  // this warp's 16 tile columns

#pragma unroll 1
  for (int p = 0; p < S - 1; ++p) {
    if (p < steps) issue(p);
    tc::cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int st = t % S;
    tc::cp_async_wait<S - 2>();
    tc::mbar_wait(&bar[st], (t / S) & 1);
    __syncthreads();  // B visible to all; the stage of step t - 1 is free
    if (t + S - 1 < steps) issue(t + S - 1);
    tc::cp_async_commit();

    // the step's B^T fragments (a thread's 8 values of each 16-deep
    // slice), split into their bf16 terms for an f32 B
    constexpr int BT = sizeof(TB) == 4 ? TERMS : 1;
    uint32_t frag[KC / 16][BT][4];
    const Raw* bs = b_s + st * KC * G::B_LD;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      if constexpr (sizeof(TB) == 4) {
        const float* p = reinterpret_cast<const float*>(bs) +
                         (kk * 16 + 2 * t4) * G::B_LD + mcol + gid;
        float v[4][2];  // fragment register r: (lower, upper) k
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* q = p + (r / 2) * 8 * G::B_LD + (r % 2) * 8;
          v[r][0] = q[0];
          v[r][1] = q[G::B_LD];
        }
#pragma unroll
        for (int term = 0; term < TERMS; ++term)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            frag[kk][term][r] = tc::bf16x2_term(v[r][0], v[r][1]);
      } else {
        tc::ldmatrix_x4_trans(
            frag[kk][0], bs + (kk * 16 + lane % 8 + (lane / 16) * 8) * G::B_LD +
                             mcol + ((lane / 8) % 2) * 8);
      }
    }

    // the step's products: A term i (shared memory) x B term j, the first
    // overwriting part
    const uint32_t a_base = tc::smem_addr(a_s + st * G::A_BYTES);
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      if constexpr (sizeof(TB) == 4) {
        constexpr int I[6] = {0, 0, 1, 0, 1, 2}, J[6] = {0, 1, 0, 2, 1, 0};
#pragma unroll
        for (int pr = 0; pr < F32_PRODUCTS; ++pr)
          wgmma<RT>(part, frag[kk][J[pr]],
                    sw128_desc(a_base + I[pr] * G::PLANE_BYTES + kk * 32),
                    kk + pr > 0);
      } else {
#pragma unroll
        for (int i = 0; i < TERMS; ++i)
          wgmma<RT>(part, frag[kk][0],
                    sw128_desc(a_base + i * G::PLANE_BYTES + kk * 32),
                    kk + i > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < G::ACC; ++i) acc[i] += part[i];
  }

  // acc[4i + 2h + e]: output column mcol + gid + 8h, row 8i + 2·t4 + e of
  // the sub-tile (wgmma's accumulator layout, transposed back)
  const int64_t row0 = (int64_t)br * bh + sub * RT;
  const int col = c0 + mcol + gid;
#pragma unroll
  for (int i = 0; i < RT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int64_t row = row0 + 8 * i + 2 * t4 + e;
      if (row >= m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (col + 8 * h < n) out[row * n + col + 8 * h] = acc[4 * i + 2 * h + e];
    }
}

template <int RT, typename TB, bool VEC>
cudaError_t launch(const int* indptr, const int* indices,
                   const int* row_order, const uint8_t* planes, const void* b,
                   float* out, int num_block_rows, int m, int k, int n,
                   int bh, int bw, cudaStream_t stream) {
  using G = Geo<RT, TB>;
  auto kernel = bsr_wgmma_kernel<RT, TB, VEC>;
  // the kernel's shared-memory limit is raised once on each device (one
  // bit each; devices past 64 set it at every launch)
  static std::atomic<unsigned long long> raised{0};
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  const int ncol = (n + G::TN - 1) / G::TN;
  const long long grid = (long long)num_block_rows * (bh / RT) * ncol;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, G::THREADS, G::SMEM, stream>>>(
      indptr, indices, row_order, planes, static_cast<const TB*>(b), out, m,
      k, n, bh, bw, ncol);
  return cudaGetLastError();
}

template <int RT>
cudaError_t launch_rt(const int* indptr, const int* indices,
                      const int* row_order, const uint8_t* planes,
                      const void* b, int b_bf16, int b_vec, float* out,
                      int num_block_rows, int m, int k, int n, int bh, int bw,
                      cudaStream_t s) {
#define K6_ARGS indptr, indices, row_order, planes, b, out, num_block_rows, \
                m, k, n, bh, bw, s
  if (b_bf16)
    return b_vec ? launch<RT, __nv_bfloat16, true>(K6_ARGS)
                 : launch<RT, __nv_bfloat16, false>(K6_ARGS);
  return b_vec ? launch<RT, float, true>(K6_ARGS)
               : launch<RT, float, false>(K6_ARGS);
#undef K6_ARGS
}

}  // namespace

extern "C" {

// K6 (bsr_spmm.py::_kernel).  C (m, n) f32 from the BSR arrays (indptr,
// indices int32), row_order (the block rows, most stored blocks first),
// the blocks' bf16 term planes in the kernel's layout (bsr_spmm.py::
// term_planes, 16-byte aligned) and a row-major (k, n) f32 or bf16 B, on
// `stream`.  b_vec asks for the cp.async staging of B, which needs 16-byte
// aligned rows.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// what the kernel does not take.
int bsr_block_spmm(const void* indptr, const void* indices,
                   const void* row_order, const void* planes, const void* b,
                   int b_bf16, int b_vec, void* out, int num_block_rows,
                   int m, int k, int n, int bh, int bw, void* stream) {
  const int size = b_bf16 ? 2 : 4;
  if (num_block_rows <= 0 || n <= 0 || bh <= 0 || bw <= 0 || bh % 8 ||
      bw % KC || (uintptr_t)planes % 16 ||
      (b_vec && ((uintptr_t)b % 16 || ((long long)n * size) % 16)))
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(indptr);
  const int* ix = static_cast<const int*>(indices);
  const int* order = static_cast<const int*>(row_order);
  const uint8_t* pl = static_cast<const uint8_t*>(planes);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh % ROW_TILES[0] == 0)
    return (int)launch_rt<ROW_TILES[0]>(p, ix, order, pl, b, b_bf16, b_vec,
                                        o, num_block_rows, m, k, n, bh, bw,
                                        s);
  if (bh % ROW_TILES[1] == 0)
    return (int)launch_rt<ROW_TILES[1]>(p, ix, order, pl, b, b_bf16, b_vec,
                                        o, num_block_rows, m, k, n, bh, bw,
                                        s);
  return (int)launch_rt<ROW_TILES[2]>(p, ix, order, pl, b, b_bf16, b_vec, o,
                                      num_block_rows, m, k, n, bh, bw, s);
}

const char* bsr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
