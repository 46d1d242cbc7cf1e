// Strip-owner SpMM for Hopper (sm_90a): the panel (K1) and pair (K2)
// kernels of tpuspmm_torch, one routine on the tensor cores.
//
// Replaces two TPU kernels that share one arithmetic:
//   panel_strip_spmm  <- tpuspmm/kernels/panel_spmm.py::_kernel
//                        (launcher _panel_spmm, tiers panel_matmul)
//   pair_strip_spmm   <- tpuspmm/kernels/pair_spmm.py::_pair_kernel
//                        (launcher _pair_spmm)
// Both compute C = A @ B from a plan that stores A as dense tm x tk strips
// (a_dense), each strip tagged with a k-tile and an output row strip.  The
// TPU kernels walk the plan in grid order and add every strip product into
// a VMEM-resident output slab; that relies on grid steps running in order.
//
// The plan is read through a group index built on the host from the
// unchanged plan arrays (PanelPlan.group_index / PairPlan.group_index):
// GR / tm consecutive output strips form a group of GR = 64 output rows
// (8, 4 or 2 strips), and each (group, k-tile) entry lists the group's
// source slots at that k-tile, -1 for a strip absent there.  One block
// owns a unit: a group's rows [group·GR, +GR) and TN columns.  It walks
// the group's entries in ascending k-tile, accumulates GR x TN in f32
// registers and stores once.  One owner per output tile: no atomics, no
// zero-fill pass, the same sum order on every run, and rows no plan strip
// touches are written as zeros.  Padding and trash slots are not in the
// index.  Groups index global output strips, so a group may straddle
// supertiles.
//
// What bounded the earlier design (one block per output strip, f32 FMAs
// on the CUDA cores): every strip re-read its 128-row B tile from L2 and
// ran dense FMAs over a strip ~1.3% nonzero.  On large_25605 at width 256
// (tm 8, tk 128, bf16 plan) that is 6,893 strips: 903 MB of f32 B from L2
// per call and 1.81 G FMAs.  This design:
//   - B-tile reuse: one B tile per (group, k-tile) entry and column tile,
//     shared by the group's strips: 1,412 entries at 64 rows, 185 MB of
//     f32 B per call (92 MB of bf16 B);
//   - tensor cores: bf16 mma.sync.m16n8k16 with f32 accumulators, skipping
//     the m16 row tiles with no strip present: 3,797 of 5,648 run, 11.9
//     GFLOP with f32 B (three passes), 4.0 with bf16 B (one), 12 and 4 us
//     at 989 TFLOP/s;
//   - asynchronous copies: cp.async (16 bytes, zero-filling rows >= K and
//     columns >= N) into a ring of shared-memory stages, each one k-chunk
//     of KC = 64: the group's A strips in their rows of a GR-row tile
//     (absent strips zeroed) and the KC x TN B tile.  Two blocks share an
//     SM, so the ring holds as many stages as fit in half of its shared
//     memory: 4 for bf16 operands, 3 for an f32 plan with bf16 B, 2 with
//     f32 B.  A width whose rows are not 16-byte aligned (f32: N % 4, bf16:
//     N % 8) loads B with plain loads into the same ring: no copy or pad
//     of B is made;
//   - balance: units are launched longest group first, and when every
//     block is resident at once the second round starts from the shortest,
//     so the longest unit shares its SM with the shortest; a grid of
//     128-column units smaller than the SM count (large_21074: 44 groups)
//     runs 64-column units instead.
// What bounds it now (strip_sweep.py, PERF.md): the operand traffic from
// L2 and the SM's issue of the mma.sync path, not the copies' latency (a
// deeper ring, or more smaller stages, is slower).  On large_25605 w256
// the kernel moves 213 MB from L2 with f32 B (B 185, A 28) in 0.105 ms and
// 121 MB with bf16 B in 0.045 ms of device time (H100 SXM, 700 W), 2.0 and
// 2.7 TB/s.  Each copy address is computed once a stage and each term
// split converts two values at a time, to spare issue.  The issue goes
// to fragment loads from shared memory, the bf16 term splits for an f32
// operand, and what is left of the imbalance of groups of 8-20 entries.
//
// Why mma.sync and not wgmma: an f32 operand enters the tensor cores as
// bf16 terms, and mma.sync takes its operands from registers, so each
// thread splits the f32 values of its own fragments (split_bf16's terms,
// in order) with no term planes in shared memory, and one routine serves
// the four operand types, both tile widths and ragged widths.  wgmma (A
// and B read from shared memory by a whole warpgroup, async) would cut the
// fragment loads named above: the next step for this kernel.
//
// Precision: a bf16 operand is one term, an f32 operand 3 bf16 terms
// ("highest") or 2 ("split2"); the products kept are those of terms (i, j)
// with i + j < max(terms of A, terms of B): bf16 x bf16 one pass, bf16 x
// f32 and f32 x bf16 3 (split2: 2), f32 x f32 6 (split2: hi·hi + hi·lo +
// lo·hi).  That is panel_matmul's ladder (kernels/panel_spmm.py) term for
// term, but for f32 x f32 at "highest", which panel_matmul runs as one f32
// product and this routine as 6 bf16 products (error ~2^-24 relative, well
// inside 1e-4·max|C|).  Each bf16 product is exact; sums are f32 on the
// tensor cores, so "split2" holds 2^-20·max|C| against its plain version
// on this routine.
//
// Left for later: wgmma; cluster multicast of B tiles to the groups that
// share a k-tile; persistent blocks balancing groups of unequal length; a
// skip of all-zero 16-column k slices inside a strip.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

// Tuning constants, chosen on the card (PERF.md; strip_sweep.py times
// other values on patched copies of this file).
constexpr int KC = 64;          // k-chunk of one ring stage
constexpr int MAX_STAGES = 8;   // ring stages at most
constexpr int BLOCKS = 2;       // blocks an SM holds at once
// output rows of a block; kernels/strip_cuda.py's GROUP_ROWS, against
// which the wrapper checks the group index
constexpr int GROUP_ROWS = 64;
constexpr int META = 64;  // entries whose index a block holds at a time
constexpr int SMEM_LIMIT = 232448;  // opt-in shared memory per block
constexpr int SM_SMEM = 233472;     // shared memory of one SM

// shared-memory geometry of one instantiation: the ring of stages, then
// each stage's m16-tile mask, then a window of META entries of the index.
// The ring takes as many stages (up to MAX_STAGES, at least 2) as fit in
// an SM's shared memory shared by BLOCKS blocks (1 KB of each reserved).
template <int GR, int TN, typename TA, typename TB>
struct Tile {
  // a warp's tile: 64 x 16 when A is bf16 and B f32, so that one warp
  // splits each B fragment into its terms; else 32 x 32, which loads fewer
  // fragments from shared memory and splits an f32 A fragment in 4 warps,
  // not 8
  static constexpr bool SPLIT_B = sizeof(TA) == 2 && sizeof(TB) == 4;
  static constexpr int WTM = SPLIT_B ? 64 : 32;
  static constexpr int WTN = SPLIT_B ? 16 : 32;
  static constexpr int WMT = WTM / 16;  // m16 tiles of a warp
  static constexpr int WNT = WTN / 8;   // n8 tiles of a warp
  static_assert(WNT % 2 == 0, "bf16 B fragments load two n8 tiles at once");
  static constexpr int WARPS_N = TN / WTN;
  static constexpr int THREADS = GR / WTM * WARPS_N * 32;
  // row strides in elements, padded so fragment loads are conflict-free
  static constexpr int A_LD = KC + 8;
  static constexpr int B_LD = TN + (sizeof(TB) == 4 ? 4 : 8);
  static constexpr int A_BYTES = GR * A_LD * (int)sizeof(TA);
  static constexpr int B_BYTES = KC * B_LD * (int)sizeof(TB);
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int META_INTS = META * (GR / 8 + 2) + MAX_STAGES;
  static constexpr int BUDGET = SM_SMEM / BLOCKS - 1024 < SMEM_LIMIT
                                    ? SM_SMEM / BLOCKS - 1024
                                    : SMEM_LIMIT;
  static constexpr int FIT = (BUDGET - META_INTS * 4) / STAGE_BYTES;
  static constexpr int STAGES =
      FIT < 2 ? 2 : FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + META_INTS * 4;
  static_assert(SMEM <= SMEM_LIMIT, "two stages exceed a block's memory");
  static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0, "16-byte stages");
};

template <int GR, int TN, typename TA, typename TB>
__global__ void __launch_bounds__(Tile<GR, TN, TA, TB>::THREADS, BLOCKS)
group_owner_kernel(const TA* __restrict__ a_dense,
                   const TB* __restrict__ b,
                   const int* __restrict__ group_ptr,
                   const int* __restrict__ group_kt,
                   const int* __restrict__ group_slot,
                   const int* __restrict__ group_order,
                   float* __restrict__ out, int out_rows, int tm, int tk,
                   int k, int n, int terms, int b_async, int sms) {
  using T = Tile<GR, TN, TA, TB>;
  constexpr int WTM = T::WTM, WTN = T::WTN, WMT = T::WMT, WNT = T::WNT;
  using BBits = std::conditional_t<sizeof(TB) == 2, uint16_t, uint32_t>;
  constexpr bool A_BF16 = sizeof(TA) == 2;
  constexpr bool B_BF16 = sizeof(TB) == 2;
  constexpr int VA = 16 / sizeof(TA);  // elements per 16-byte copy
  constexpr int VB = 16 / sizeof(TB);
  constexpr int A_COPIES = GR * KC / VA;
  constexpr int B_COPIES = KC * TN / VB;

  extern __shared__ __align__(16) unsigned char smem[];
  int* stage_mask = reinterpret_cast<int*>(smem + T::STAGES * T::STAGE_BYTES);
  int* meta_kt = stage_mask + MAX_STAGES;
  int* meta_mask = meta_kt + META;
  int* meta_slot = meta_mask + META;  // [META][G]

  const int tid = threadIdx.x;
  const int tm_shift = tm == 8 ? 3 : tm == 16 ? 4 : 5;
  const int G = GR >> tm_shift;  // output strips per group
  // unit (group, column tile) of this block.  group_order lists the
  // groups by entries, most first; blocks go to the SMs in launch order,
  // so when every block is resident at once (up to BLOCKS a SM) the
  // second round takes the shortest units first: the longest unit shares
  // its SM with the shortest.  Beyond that, longest first.
  const int ncol = (n + TN - 1) / TN;
  int unit = blockIdx.x;
  if (unit >= sms && (int)gridDim.x <= BLOCKS * sms)
    unit = gridDim.x - 1 - (unit - sms);
  const int group = group_order[unit / ncol];
  const int n0 = unit % ncol * TN;
  const int e0 = group_ptr[group];
  const int n_entries = group_ptr[group + 1] - e0;
  const int chunks = tk / KC;  // ring items per entry
  const int items = n_entries * chunks;

  auto stage_a = [&](int s) {
    return reinterpret_cast<TA*>(smem + s * T::STAGE_BYTES);
  };
  auto stage_b = [&](int s) {
    return reinterpret_cast<TB*>(smem + s * T::STAGE_BYTES + T::A_BYTES);
  };

  // copy entries [w·META, +META) of the group's index into shared memory,
  // with each entry's mask of m16 tiles that hold a strip: read once, so
  // no index load waits behind the ring's copies.  Every thread calls it.
  auto load_window = [&](int w) {
    const int first = w * META;
    const int count = min(META, n_entries - first);
    const int* src = group_slot + (size_t)(e0 + first) * G;
    for (int i = tid; i < count * G; i += T::THREADS) meta_slot[i] = src[i];
    for (int i = tid; i < count; i += T::THREADS)
      meta_kt[i] = group_kt[e0 + first + i];
    __syncthreads();
    for (int i = tid; i < count; i += T::THREADS) {
      int mask = 0;
      for (int j = 0; j < G; ++j)
        if (meta_slot[i * G + j] >= 0)
          mask |= ((1 << ((tm + 15) >> 4)) - 1) << ((j << tm_shift) >> 4);
      meta_mask[i] = mask;
    }
    __syncthreads();
  };

  // fill ring stage s with item (entry, k-chunk): the group's A strips
  // and the B tile, and the entry's mask.  Every thread calls it.
  // each thread's copies sit at fixed places in a stage: A_PER copies of
  // A rows a_row0 + j·A_STEP at column a_col, B_PER copies of B rows
  // b_row0 + j·B_STEP at column b_col (the tile widths divide THREADS·16
  // bytes), so a stage costs one address per copy
  static_assert(A_COPIES % T::THREADS == 0 && B_COPIES % T::THREADS == 0 &&
                    T::THREADS % (KC / VA) == 0 && T::THREADS % (TN / VB) == 0,
                "copies spread evenly over the threads");
  constexpr int A_PER = A_COPIES / T::THREADS, A_STEP = T::THREADS / (KC / VA);
  constexpr int B_PER = B_COPIES / T::THREADS, B_STEP = T::THREADS / (TN / VB);
  const int a_row0 = tid / (KC / VA), a_col = tid % (KC / VA) * VA;
  const int b_row0 = tid / (TN / VB), b_col = tid % (TN / VB) * VB;
  const bool b_col_in = n0 + b_col < n;  // b_async: all VB columns or none
  const TB* b_src = b + n0 + b_col;

  auto issue = [&](int item, int s) {
    const int entry = item / chunks;
    if (entry % META == 0 && item % chunks == 0) load_window(entry / META);
    const int local = entry % META;
    const int kc = (item - entry * chunks) * KC;
    const int* slots = meta_slot + local * G;
    TA* sa = stage_a(s) + a_row0 * T::A_LD + a_col;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int row = a_row0 + j * A_STEP;
      const int slot = slots[row >> tm_shift];
      TA* dst = sa + j * A_STEP * T::A_LD;
      if (slot >= 0)
        tc::cp_async16(dst,
                       a_dense +
                           (((size_t)slot << tm_shift) + (row & (tm - 1))) *
                               tk +
                           kc + a_col,
                       16);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    const int krow = meta_kt[local] * tk + kc + b_row0;
    TB* sb = stage_b(s) + b_row0 * T::B_LD + b_col;
    if (b_async) {  // n % VB == 0: a copy is wholly inside or outside
#pragma unroll
      for (int j = 0; j < B_PER; ++j) {
        const int gr = krow + j * B_STEP;
        const bool in = b_col_in && gr < k;
        tc::cp_async16(sb + j * B_STEP * T::B_LD,
                       in ? b_src + (size_t)gr * n : b, in ? 16 : 0);
      }
    } else {
      const BBits* src = reinterpret_cast<const BBits*>(b_src);
#pragma unroll
      for (int j = 0; j < B_PER; ++j) {
        const int gr = krow + j * B_STEP;
        BBits* d = reinterpret_cast<BBits*>(sb + j * B_STEP * T::B_LD);
#pragma unroll
        for (int v = 0; v < VB; ++v)
          d[v] = gr < k && n0 + b_col + v < n ? src[(size_t)gr * n + v] : 0;
      }
    }
    if (tid == 0) stage_mask[s] = meta_mask[local];
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int gid = lane / 4, t4 = lane % 4;
  const int na = A_BF16 ? 1 : terms;
  const int nb = B_BF16 ? 1 : terms;
  const int nprod = na > nb ? na : nb;  // keep products (i, j), i + j < nprod

  float acc[WMT][WNT][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  auto compute = [&](int s) {
    const TA* sa = stage_a(s) + wm * WTM * T::A_LD;
    const TB* sb = stage_b(s) + wn * WTN;
    const int mask = stage_mask[s] >> (wm * WMT);
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t bf[3][WNT][2];  // [term][n8 tile][register]
      if constexpr (B_BF16) {
#pragma unroll
        for (int p = 0; p < WNT / 2; ++p) {
          uint32_t r[4];
          tc::ldmatrix_x4_trans(
              r, sb + (ks + lane % 16) * T::B_LD + p * 16 + (lane / 16) * 8);
          bf[0][2 * p][0] = r[0];
          bf[0][2 * p][1] = r[1];
          bf[0][2 * p + 1][0] = r[2];
          bf[0][2 * p + 1][1] = r[3];
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < WNT; ++nt) {
          const float* c = reinterpret_cast<const float*>(sb) + nt * 8 + gid;
          float v[4] = {c[(ks + 2 * t4) * T::B_LD],
                        c[(ks + 2 * t4 + 1) * T::B_LD],
                        c[(ks + 2 * t4 + 8) * T::B_LD],
                        c[(ks + 2 * t4 + 9) * T::B_LD]};
#pragma unroll
          for (int ib = 0; ib < 3; ++ib) {
            if (ib < nb) {
              bf[ib][nt][0] = tc::bf16x2_term(v[0], v[1]);
              bf[ib][nt][1] = tc::bf16x2_term(v[2], v[3]);
            }
          }
        }
      }
      uint32_t af[A_BF16 ? 1 : 3][WMT][4];  // [term][m16 tile][register]
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt) {
        if (!((mask >> mt) & 1)) continue;  // no strip in these 16 rows
        if constexpr (A_BF16) {
          tc::ldmatrix_x4(af[0][mt], sa + (mt * 16 + lane % 16) * T::A_LD +
                                         ks + (lane / 16) * 8);
        } else {
          const float* r0 = reinterpret_cast<const float*>(sa) +
                            (mt * 16 + gid) * T::A_LD + ks + 2 * t4;
          const float2 x0 = *reinterpret_cast<const float2*>(r0);
          const float2 x1 =
              *reinterpret_cast<const float2*>(r0 + 8 * T::A_LD);
          const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8);
          const float2 x3 =
              *reinterpret_cast<const float2*>(r0 + 8 * T::A_LD + 8);
          float v[8] = {x0.x, x0.y, x1.x, x1.y, x2.x, x2.y, x3.x, x3.y};
#pragma unroll
          for (int ia = 0; ia < 3; ++ia)
            if (ia < na)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                af[ia][mt][q] = tc::bf16x2_term(v[2 * q], v[2 * q + 1]);
        }
      }
      // term pairs outermost: consecutive products go to different
      // accumulators, so no product waits on the one before it
#pragma unroll
      for (int ia = 0; ia < (A_BF16 ? 1 : 3); ++ia)
#pragma unroll
        for (int ib = 0; ib < (B_BF16 ? 1 : 3); ++ib)
          if (ia < na && ib < nb && ia + ib < nprod)
#pragma unroll
            for (int mt = 0; mt < WMT; ++mt)
              if ((mask >> mt) & 1)
#pragma unroll
                for (int nt = 0; nt < WNT; ++nt)
                  tc::mma_bf16(acc[mt][nt], af[ia][mt], bf[ib][nt][0],
                               bf[ib][nt][1]);
    }
  };

  // the ring: STAGES - 1 items in flight while one is consumed
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < items) issue(s, s);
    tc::cp_async_commit();
  }
  for (int it = 0; it < items; ++it) {
    tc::cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // item it landed; every warp is done with it - 1
    const int next = it + T::STAGES - 1;
    if (next < items) issue(next, next % T::STAGES);
    tc::cp_async_commit();
    compute(it % T::STAGES);
  }

  const int row0 = group * GR + wm * WTM;
  const bool pairs = n % 2 == 0;  // (row·n + even column) is 8-byte aligned
#pragma unroll
  for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < WNT; ++nt) {
      const int col = n0 + wn * WTN + nt * 8 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mt * 16 + gid + 8 * h;
        if (row >= out_rows || col >= n) continue;
        float* o = out + (size_t)row * n + col;
        if (pairs) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        } else {
          o[0] = acc[mt][nt][2 * h];
          if (col + 1 < n) o[1] = acc[mt][nt][2 * h + 1];
        }
      }
    }
}

// the group index on the device (PanelPlan / PairPlan.group_index, and
// the groups by entries, most first)
struct GroupIndex {
  const int* ptr;
  const int* kt;
  const int* slot;
  const int* order;
};

template <int TN, typename TA, typename TB>
cudaError_t launch(const void* a, const void* b, GroupIndex ix, float* out,
                   int n_groups, int out_rows, int tm, int tk, int k, int n,
                   int terms, int sms, cudaStream_t stream) {
  using T = Tile<GROUP_ROWS, TN, TA, TB>;
  auto kernel = group_owner_kernel<GROUP_ROWS, TN, TA, TB>;
  // the kernel's shared-memory limit is raised once on each device (one
  // bit each; devices past 64 set it at every launch)
  static std::atomic<unsigned long long> raised{0};
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  const int b_async = reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                      n % (16 / (int)sizeof(TB)) == 0;
  const int units = n_groups * ((n + TN - 1) / TN);
  kernel<<<units, T::THREADS, T::SMEM, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), ix.ptr, ix.kt,
      ix.slot, ix.order, out, out_rows, tm, tk, k, n, terms, b_async, sms);
  return cudaGetLastError();
}

template <typename TA, typename TB>
cudaError_t launch_width(const void* a, const void* b, GroupIndex ix,
                         float* out, int n_groups, int out_rows, int tm,
                         int tk, int k, int n, int terms, int sms,
                         cudaStream_t stream) {
  // output columns per block: 128, or 64 when a grid of 128-column blocks
  // would leave SMs idle
  const bool narrow = (long long)n_groups * ((n + 127) / 128) < sms;
  if (narrow)
    return launch<64, TA, TB>(a, b, ix, out, n_groups, out_rows, tm, tk, k,
                              n, terms, sms, stream);
  return launch<128, TA, TB>(a, b, ix, out, n_groups, out_rows, tm, tk, k, n,
                             terms, sms, stream);
}

int strip_spmm(const void* a, int a_bf16, const void* b, int b_bf16,
               GroupIndex ix, void* out, int n_groups, int out_rows, int tm,
               int tk, int k, int n, int sms, int split2, void* stream) {
  if (n_groups <= 0 || n <= 0 || sms <= 0 || tk % KC != 0 ||
      (tm != 8 && tm != 16 && tm != 32) ||
      (long long)n_groups * ((n + 63) / 64) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int terms = split2 ? 2 : 3;
  if (a_bf16 && b_bf16)
    return (int)launch_width<__nv_bfloat16, __nv_bfloat16>(
        a, b, ix, o, n_groups, out_rows, tm, tk, k, n, terms, sms, s);
  if (a_bf16)
    return (int)launch_width<__nv_bfloat16, float>(
        a, b, ix, o, n_groups, out_rows, tm, tk, k, n, terms, sms, s);
  if (b_bf16)
    return (int)launch_width<float, __nv_bfloat16>(
        a, b, ix, o, n_groups, out_rows, tm, tk, k, n, terms, sms, s);
  return (int)launch_width<float, float>(a, b, ix, o, n_groups, out_rows, tm,
                                         tk, k, n, terms, sms, s);
}

}  // namespace

extern "C" {

// Panel layout (K1).  Replaces tpuspmm/kernels/panel_spmm.py::_kernel
// (one grid step per panel of P strips sharing a k-tile, each strip added
// into a VMEM slab at offs; padding strips into a trash strip).  Plan slot
// = panel * P + strip; padding slots (offset sm) are not in the group
// index, so they cost nothing here.  out is (out_rows = n_out_strips·tm) x
// n f32; the group index is over GROUP_ROWS / tm output strips a group;
// sms is the device's SM count; split2 != 0 runs the verified-only 2-term
// tier.  Returns cudaGetLastError() after the launch.
int panel_strip_spmm(const void* a, int a_bf16, const void* b, int b_bf16,
                     const int* group_ptr, const int* group_kt,
                     const int* group_slot, const int* group_order,
                     void* out, int n_groups, int out_rows, int tm, int tk,
                     int k, int n, int sms, int split2, void* stream) {
  return strip_spmm(a, a_bf16, b, b_bf16,
                    {group_ptr, group_kt, group_slot, group_order}, out,
                    n_groups, out_rows, tm, tk, k, n, sms, split2, stream);
}

// Pair layout (K2).  Replaces tpuspmm/kernels/pair_spmm.py::_pair_kernel
// (one grid step per CH-strip chunk of a pair's run, DMA'd ping-pong at an
// arbitrary strip offset; strips past the chunk's count masked to trash).
// Plan slot = strip index of a pair's run; the CH-strip zero tail and the
// strips a chunk reads past its pair are not in the group index, so the
// over-read costs nothing here; the ring of cp.async stages takes the
// place of the ping-pong DMA.  Arguments as panel_strip_spmm.
int pair_strip_spmm(const void* a, int a_bf16, const void* b, int b_bf16,
                    const int* group_ptr, const int* group_kt,
                    const int* group_slot, const int* group_order,
                    void* out, int n_groups, int out_rows, int tm, int tk,
                    int k, int n, int sms, int split2, void* stream) {
  return strip_spmm(a, a_bf16, b, b_bf16,
                    {group_ptr, group_kt, group_slot, group_order}, out,
                    n_groups, out_rows, tm, tk, k, n, sms, split2, stream);
}

const char* strip_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
