// Block-streaming BSR SpMM for Hopper (sm_90a): kernel K6 of tpuspmm_torch.
//
// Replaces tpuspmm/kernels/bsr_spmm.py::_kernel (launch _bsr_spmm).  The TPU
// kernel's grid is (n tile, stored block) over the stored blocks sorted by
// block row, an empty block row holding one zero block; step i computes
// blocks[i] @ B[kt[i]*bw : +bw, n tile] at HIGHEST precision and stores it
// into block row rt[i] on that row's first block (first[i]), adding it
// otherwise.  That relies on grid steps running in order.
//
// Here one block owns each tile (block row br, row sub-tile, column tile):
// output rows [br*bh + sub*RT, +RT) and TN columns (64 in the register
// builds; 64 or 128 in the warp-specialised build, 64 a consumer, where a
// block may own many tiles in turn, below).  It walks block row br's stored
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
//   - B^T is wgmma's A operand, from registers in the register builds:
//     each thread reads its fragment's values from the staged B tile and,
//     for an f32 B, splits them into three bf16 terms as it loads them
//     (tc::bf16x2_term); a bf16 B is loaded as it is (ldmatrix.trans).  The
//     warp-specialised build (below) reads it by descriptor.
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
// Staging, f32 B and bf16 B whose rows are not 16-byte aligned (the
// register builds): a ring of STAGES steps in dynamic shared memory (3 at
// RT 128, 2 below), each the step's A planes (bulk copy, mbarrier) and its
// 64 x TN B tile, staged by 16-byte cp.async where B's rows are 16-byte
// aligned (f32) and by plain loads and stores where they are not (f32 N %
// 4, bf16 N % 8, or an unaligned base: the wrapper picks the build, and
// chip_smoke.py holds both).  One warpgroup does everything in turn: wait
// for the step's copies, one __syncthreads (the stage last read is then
// free), start the copies STAGES - 1 steps ahead, load (and for f32 B
// split) the step's B fragments, issue its wgmmas (24 with f32 B, 12 with
// bf16), wait for them and add them into the sums.
//
// bf16 B with 16-byte aligned rows takes the warp-specialised build
// (bsr_ws_kernel): a producer warpgroup bulk-copies each step's planes and
// cp.asyncs B's tiles, already in the 128-byte swizzle, into a ring of up
// to WS_STAGES stages with a full and an empty mbarrier each and no
// __syncthreads in the loop; one or two consumer warpgroups read B^T as
// wgmma's A operand by descriptor (MN-major, the transpose bit) and A^T as
// the register build does, so no fragment passes through registers.  Two
// consumers share each step's planes over a 128-column tile, which halves
// the plane bytes a product, and give the tensor cores two chains of
// dependent wgmmas; a 128-column tile doubles a block row's products a
// step, so the binding (kernels/bsr_cuda.py) gives grids of few tiles one
// consumer (Olmo's down weight at w512, every width-16 call).  The
// products, their order and their fresh accumulator a step are the
// register build's: the output is the same bits (chip_smoke.py
// --k6-parent).
//
// Where the binding asks for it (kernels/bsr_cuda.py: 128-row tiles, many
// an SM), the warp-specialised build is persistent: `grid` blocks, each
// owning one tile of every round of `grid` consecutive tiles, in block
// order on even rounds and in reverse on odd ones (a static schedule: no
// counter to reset, one owner a tile; the reversal keeps the blocks given
// the heaviest rows of one round from getting the heaviest of the next,
// which a plain c, c + grid, ... did, losing to the hardware's own
// scheduling on Olmo's and DeepSeek-V3's gate weights).  Its producer runs the
// ring straight across a tile boundary, so the next tile's stages land
// while the consumers store the last tile's sums, and those stores drain
// while the next tile's products run: a one-tile block pays an empty ring
// and an epilogue with the tensor cores idle, one SM at a time.  Below 128
// rows several blocks fit an SM and overlap each other's ends already, so
// the grid stays one block a tile.
//
// What bounds it (strip_sweep.py --bsr; NVIDIA H100 80GB HBM3, 700 W;
// one Olmo-Hybrid-7B gate weight 11008 x 3840 and one down weight
// 3840 x 11008, 258 blocks of 128 x 128, four weights launched in turn, bf16
// B).  The register build at w512: 48.0 / 42.8 us a call (gate / down);
// its copies alone 35.0 / 27.8, its chain alone on staged data 42.0 /
// 30.2: each step's chain, not the bytes, set its pace.  Copying the
// planes once for a cluster of 4 or 8 column tiles (multicast) cut the L2
// reads 4-8x and no copy time (40.1 / 42.3 / 43.2 us at 1 / 4 / 8): a
// step's 56 KB reach each SM either way.  The warp-specialised build:
// 32.4 / 31.9 us at w512 and 19.0 / 25.7 at w16 (register build 47.9 /
// 42.4 and 21.0 / 34.5 in the same run); its products alone on staged
// data take 31.4 / 29.1 and its copies alone 25.2 / 24.8, so the
// consumers' wgmma chains now set the pace (a wgmma of m64n128k16 every
// ~50 ns against the 35 ns of one SM's share of the peak).  DeepSeek-V3's
// expert weights at w4096 (gate 2048 x 7168, down 7168 x 2048; 512 and
// 1,792 tiles of 128 x 128): one block a tile took 71.1 / 101.6 us, the
// persistent grid 69.2 / 85.6, against its products alone 62.2 / 78.4 and
// its copies alone 49.3 / 71.4.  The persistent grid lost where the tiles
// fill the SMs fewer than 3 times (Olmo's gate at w512, 344 tiles: 36.3
// against 33.0 us), and with c, c + grid, ... in place of the reversed odd
// rounds (gate / down 73.8 / 92.8).
//
// Left for later: the f32-B build's producer split (its B fragments are
// split into bf16 terms in registers, so its B cannot be staged for wgmma
// by descriptor without three B planes a step); interleaving two steps'
// products a consumer (two accumulators: reading one while the other's
// group runs made ptxas serialise the wgmmas, C7514, in some builds);
// width 16, where 86 / 30 blocks of one consumer leave most of the 132
// SMs idle; multicast of the planes, which did not pay on a cool card but
// may under the 700 W cap that a long run of w4096 calls holds the card
// at (its L2 reads cost clock there).

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
// the warp-specialised build (bf16 B with 16-byte aligned rows): a
// producer warpgroup and up to CONSUMER_WARPGROUPS consumers, each on its
// own COLS columns of the block's tile, and a ring of at most WS_STAGES
// stages.  Its consumers and its grid are decided by the caller
// (kernels/bsr_cuda.py, at the bind) and checked by the entry
constexpr int PRODUCER_WARPGROUPS = 1;
constexpr int CONSUMER_WARPGROUPS = 2;
constexpr int WS_STAGES = 4;
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

// shared memory of the warp-specialised build with C consumers: a stage is
// the step's A planes and, for each consumer, its KC x COLS bf16 B tile,
// 128-byte rows in the 128-byte swizzle (1024-byte aligned, no padding),
// then a full and an empty barrier a stage, and 1 KB to align the dynamic
// base
template <int RT, int C>
struct WsGeo {
  static constexpr int THREADS = 128 * (PRODUCER_WARPGROUPS + C);
  static constexpr int TN = COLS * C;  // the block's columns
  static constexpr int PLANE_BYTES = RT * KC * 2;
  static constexpr int A_BYTES = TERMS * PLANE_BYTES;
  static constexpr int B_BYTES = KC * COLS * 2;  // one consumer's tile
  static constexpr int STAGE = A_BYTES + C * B_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 1024) / (STAGE + 16);
  static constexpr int STAGES = FIT < WS_STAGES ? FIT : WS_STAGES;
  static constexpr int SMEM = 1024 + STAGES * (STAGE + 16);
  static constexpr int ACC = RT / 2;  // f32 accumulators a thread
  static_assert(COLS * 2 == 128 && STAGE % 1024 == 0 && STAGES >= 2 &&
                    C >= 1 && C <= CONSUMER_WARPGROUPS,
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

// d (64 x N, f32) = a (64 x 16 bf16) @ b (16 x N bf16), plus d where `add`
// is nonzero; both by descriptor: a MN-major (transposed: the 64 rows
// contiguous, a row-major B tile read as B^T), b K-major
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a_desc, uint64_t b_desc,
                         int add);

#define SS_DESC "l"(a_desc), "l"(b_desc), "r"(add)

template <>
__device__ __forceinline__ void wgmma_ss<8>(float (&d)[4], uint64_t a_desc,
                                            uint64_t b_desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : ACC4(0)
      : SS_DESC);
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a_desc,
                                             uint64_t b_desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : ACC16(0)
      : SS_DESC);
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64],
                                              uint64_t a_desc,
                                              uint64_t b_desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : ACC16(0), ACC16(16), ACC16(32), ACC16(48)
      : SS_DESC);
}

#undef ACC4
#undef ACC16
#undef A_DESC
#undef SS_DESC

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

// the tile that block blockIdx.x takes in its r-th round, or -1 past its
// last: rounds of gridDim.x consecutive tiles, taken in block order on
// even rounds and in reverse on odd ones, so that a block given one of a
// round's heaviest tiles (row_order: heaviest first) gets one of the next
// round's lightest.  With one block a tile, block x takes tile x alone
__device__ __forceinline__ int ws_tile_index(int r, int tiles) {
  const int g = gridDim.x, base = r * g;
  if (base >= tiles) return -1;
  const int x = base + ((r & 1) ? g - 1 - (int)blockIdx.x : (int)blockIdx.x);
  return x < tiles ? x : -1;
}

// one tile of the warp-specialised build: tile x is unit x / ncol (block
// row row_order[unit / subs], its sub-tile unit % subs) and the TN columns
// from c0 of column tile x % ncol; its stored blocks from j0, kq k-steps
// each
struct WsTile {
  int br, sub, c0, j0, steps;
};

__device__ __forceinline__ WsTile ws_tile(int x, const int* indptr,
                                          const int* row_order, int subs,
                                          int ncol, int tn, int kq) {
  const int unit = x / ncol;
  WsTile t;
  t.br = row_order[unit / subs];
  t.sub = unit % subs;
  t.c0 = (x % ncol) * tn;
  t.j0 = indptr[t.br];
  t.steps = (indptr[t.br + 1] - t.j0) * kq;
  return t;
}

// The warp-specialised build (bf16 B, rows 16-byte aligned), with C
// consumers.  Block c owns one tile of each round of gridDim.x tiles
// (ws_tile_index; tiles in units' order, column tile fastest, as the
// register build's blocks take them; one each where the grid is `tiles`).
// Its steps are counted across its tiles: step t sits in ring stage t % S.
//   - Producer (warpgroup 0): for each step of each of its tiles in turn,
//     waits until stage t is free (its empty barrier: one arrival from
//     each consumer), arrives on the stage's full barrier expecting the
//     planes' bytes, bulk-copies the step's planes into the stage, and
//     copies the consumers' B tiles by cp.async into the swizzled layout
//     (rows >= k and columns >= n zero-filled), each thread arriving on the
//     full barrier when its copies land.  It never waits on a tile's
//     stores: the next tile's stages fill while they run.
//   - Consumers (warpgroups 1..C): for each tile, for each step, each
//     waits for step t's stage, issues its products (its B^T tile and the
//     A^T planes, both by descriptor) into a fresh accumulator, waits for
//     them, frees their stage and adds them into its sums.  The products
//     and their order are the register build's, so the sums are the same
//     bits.  Then each stores the tile's sums (zeros for an empty block
//     row) and starts the next tile from zero.
template <int RT, int C>
__global__ void __launch_bounds__(WsGeo<RT, C>::THREADS, 1)
bsr_ws_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
              const int* __restrict__ row_order,
              const uint8_t* __restrict__ planes,
              const __nv_bfloat16* __restrict__ b, float* __restrict__ out,
              int m, int k, int n, int bh, int bw, int ncol, int tiles) {
  using G = WsGeo<RT, C>;
  constexpr int S = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - tc::smem_addr(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * G::STAGE);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  const int subs = bh / RT;
  const int kq = bw / KC;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      tc::mbar_init(&full[s], 1 + 128);  // the expect_tx arrival, 128 copiers'
      tc::mbar_init(&empty[s], C);
    }
    tc::fence_mbarrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    const int ch = tid % 8;
    int t = 0;  // the block's running step
#pragma unroll 1
    for (int r = 0, x; (x = ws_tile_index(r, tiles)) >= 0; ++r) {
      const WsTile tl = ws_tile(x, indptr, row_order, subs, ncol, G::TN, kq);
#pragma unroll 1
      for (int s = 0; s < tl.steps; ++s, ++t) {
        const int st = t % S;
        const int j = tl.j0 + s / kq, q = s % kq;
        if (t >= S) tc::mbar_wait(&empty[st], (t / S - 1) & 1);
        uint8_t* stage = smem + st * G::STAGE;
        if (tid == 0) {
          tc::mbar_expect_tx(&full[st], G::A_BYTES);
          tc::bulk_copy(
              stage,
              planes + ((int64_t)(j * subs + tl.sub) * kq + q) * G::A_BYTES,
              G::A_BYTES, &full[st]);
        }
        // consumer w's KC x COLS tile: row r's 16-byte chunk c at chunk
        // c ^ (r % 8)
        const int64_t krow0 = (int64_t)indices[j] * bw + q * KC;
#pragma unroll
        for (int w = 0; w < C; ++w) {
          uint8_t* bs = stage + G::A_BYTES + w * G::B_BYTES;
          const int col = tl.c0 + w * COLS + ch * 8;
#pragma unroll
          for (int r = tid / 8; r < KC; r += 16) {
            const int64_t krow = krow0 + r;
            const bool ok = krow < k && col < n;
            tc::cp_async16(bs + r * 128 + ((ch ^ (r % 8)) << 4),
                           ok ? b + krow * n + col : b, ok ? 16 : 0);
          }
        }
        tc::cp_async_mbar_arrive_noinc(&full[st]);
      }
    }
    return;
  }

  // consumer wg
  const int wg = tid / 128 - PRODUCER_WARPGROUPS;
  const int ctid = tid % 128;
  const int warp = ctid / 32, lane = ctid % 32;
  const int gid = lane / 4, t4 = lane % 4;
  // acc: a tile's sums, f32, rounded to nearest; part: one step's
  // products, wgmma's accumulator, started afresh each step
  float acc[G::ACC], part[G::ACC];
#pragma unroll
  for (int i = 0; i < G::ACC; ++i) part[i] = 0.f;
  int t = 0;  // the block's running step, as the producer's
#pragma unroll 1
  for (int r = 0, x; (x = ws_tile_index(r, tiles)) >= 0; ++r) {
    const WsTile tl = ws_tile(x, indptr, row_order, subs, ncol, G::TN, kq);
#pragma unroll
    for (int i = 0; i < G::ACC; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int s = 0; s < tl.steps; ++s, ++t) {
      const int st = t % S;
      tc::mbar_wait(&full[st], (t / S) & 1);
      tc::fence_proxy_async();  // B landed through cp.async, wgmma reads it
      const uint32_t a_base = tc::smem_addr(smem + st * G::STAGE);
      const uint32_t b_base = a_base + G::A_BYTES + wg * G::B_BYTES;
      fence_acc(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
        for (int i = 0; i < TERMS; ++i)
          wgmma_ss<RT>(part, sw128_desc(b_base + kk * 16 * 128),
                       sw128_desc(a_base + i * G::PLANE_BYTES + kk * 32),
                       kk + i > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(part);
      if (ctid == 0) tc::mbar_arrive(&empty[st]);  // the stage is free
#pragma unroll
      for (int i = 0; i < G::ACC; ++i) acc[i] += part[i];
    }

    // acc[4i + 2h + e]: output column c0 + 64·wg + 16·warp + gid + 8h,
    // row 8i + 2·t4 + e of the sub-tile (as the register build stores)
    const int64_t row0 = (int64_t)tl.br * bh + tl.sub * RT;
    const int col = tl.c0 + wg * COLS + warp * 16 + gid;
#pragma unroll
    for (int r = 0; r < RT / 8; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t row = row0 + 8 * r + 2 * t4 + e;
        if (row >= m) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (col + 8 * h < n)
            out[row * n + col + 8 * h] = acc[4 * r + 2 * h + e];
      }
  }
}

// the warp-specialised build with C consumers on `grid` blocks, which
// must be 1 to its tiles
template <int RT, int C>
cudaError_t launch_ws_c(const int* indptr, const int* indices,
                        const int* row_order, const uint8_t* planes,
                        const __nv_bfloat16* b, float* out,
                        int num_block_rows, int m, int k, int n, int bh,
                        int bw, int grid, cudaStream_t stream) {
  using G = WsGeo<RT, C>;
  auto kernel = bsr_ws_kernel<RT, C>;
  const int ncol = (n + G::TN - 1) / G::TN;
  const long long tiles = (long long)num_block_rows * (bh / RT) * ncol;
  if (tiles > 0x7fffffffLL || grid < 1 || grid > tiles)
    return cudaErrorInvalidValue;
  // the kernel's shared-memory limit is raised once on each device, as
  // the register build's
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
  kernel<<<(unsigned)grid, G::THREADS, G::SMEM, stream>>>(
      indptr, indices, row_order, planes, b, out, m, k, n, bh, bw, ncol,
      (int)tiles);
  return cudaGetLastError();
}

// consumers > 0: the warp-specialised build with that many (bf16 B with
// b_vec, the entry checks); else the register build b_vec asks for (bf16
// B only with plain loads)
template <int RT>
cudaError_t launch_rt(const int* indptr, const int* indices,
                      const int* row_order, const uint8_t* planes,
                      const void* b, int b_bf16, int b_vec, int consumers,
                      int grid, float* out, int num_block_rows, int m, int k,
                      int n, int bh, int bw, cudaStream_t s) {
#define K6_ARGS indptr, indices, row_order, planes, b, out, num_block_rows, \
                m, k, n, bh, bw, s
  if (consumers) {
    const __nv_bfloat16* bt = static_cast<const __nv_bfloat16*>(b);
#define WS_ARGS indptr, indices, row_order, planes, bt, out, num_block_rows, \
                m, k, n, bh, bw, grid, s
    return consumers == CONSUMER_WARPGROUPS
               ? launch_ws_c<RT, CONSUMER_WARPGROUPS>(WS_ARGS)
               : launch_ws_c<RT, 1>(WS_ARGS);
#undef WS_ARGS
  }
  if (b_bf16) return launch<RT, __nv_bfloat16, false>(K6_ARGS);
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
// aligned rows.  consumers (0, 1 or 2) and grid are the warp-specialised
// build's, which takes a bf16 B with b_vec and consumers > 0, on grid
// blocks (1 to its tiles); with consumers 0 the register build runs and
// grid is not read.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for what the kernel does not take.
int bsr_block_spmm(const void* indptr, const void* indices,
                   const void* row_order, const void* planes, const void* b,
                   int b_bf16, int b_vec, int consumers, int grid, void* out,
                   int num_block_rows, int m, int k, int n, int bh, int bw,
                   void* stream) {
  const int size = b_bf16 ? 2 : 4;
  if (num_block_rows <= 0 || n <= 0 || bh <= 0 || bw <= 0 || bh % 8 ||
      bw % KC || (uintptr_t)planes % 16 ||
      (b_vec && ((uintptr_t)b % 16 || ((long long)n * size) % 16)) ||
      consumers < 0 || consumers > CONSUMER_WARPGROUPS ||
      (consumers && !(b_bf16 && b_vec)))
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(indptr);
  const int* ix = static_cast<const int*>(indices);
  const int* order = static_cast<const int*>(row_order);
  const uint8_t* pl = static_cast<const uint8_t*>(planes);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_ARGS p, ix, order, pl, b, b_bf16, b_vec, consumers, grid, o, \
                num_block_rows, m, k, n, bh, bw, s
  if (bh % ROW_TILES[0] == 0) return (int)launch_rt<ROW_TILES[0]>(RT_ARGS);
  if (bh % ROW_TILES[1] == 0) return (int)launch_rt<ROW_TILES[1]>(RT_ARGS);
  return (int)launch_rt<ROW_TILES[2]>(RT_ARGS);
#undef RT_ARGS
}

const char* bsr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
