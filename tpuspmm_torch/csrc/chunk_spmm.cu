// Tile-owner SpMM for Hopper (sm_90a): the tile-plan kernels of
// tpuspmm_torch, one routine on the CUDA cores and the tensor cores, and
// its cluster launch for the C-resident kernels.
//
// Replaces four TPU kernels that read one plan (formats/tiles.py: chunks of
// E nonzeros, each inside one tm x tk tile, row -1 = padding), each
// launched by its own Python entry, which passes its name for messages:
//   tile_chunk_spmm        <- tpuspmm/kernels/tile_spmm.py::_kernel (K3)
//   staged_chunk_spmm      <- tpuspmm/kernels/csr_vmem.py::_kernel (K4)
//     (both through the C entry tile_owner_spmm)
//   cres_chunk_spmm        <- tpuspmm/kernels/cres_spmm.py::_kernel (K5a)
//   cres_kloop_chunk_spmm  <- tpuspmm/kernels/cres_spmm.py::_kernel_kloop
//     (K5b; both through the C entry cres_cluster_spmm)
// and any of the four, on an index with no dense tile at "split" /
// "highest", through the gather build (C entry gather_spmm, below;
// chunk_cuda.bind picks the build and its launch shape).
// Each TPU kernel densifies a chunk with one-hot matmuls on the MXU (Mosaic
// could not lower an in-kernel gather) and adds the product into an output
// block that later grid steps revisit: K3 through first[c], K4 across
// slabs, K5 into the whole VMEM-resident C.  That relies on grid steps
// running in order.  K5 walks its chunks k-major, so one DMA of a k-tile's
// B panel serves every chunk of that k-tile in every row tile.
//
// The plan is read through a tile index built once on the host from the
// unchanged plan arrays (kernels/tile_spmm.py::build_tile_index), each row
// tile's chunks in ascending k-tile; every entry reads that one index, so
// all four give the same bits.
// Each non-empty (row tile, k-tile) tile is one of two kinds:
//   - dense (at least 8·tile_k nonzeros, tile_spmm.dense_min: below that
//     the tile's tm·tk products a column on the tensor cores cost more
//     than gathering one B row per nonzero, though a staged panel moves
//     fewer bytes from tile_k nonzeros on): its A tile, densified on the
//     host in f32 with duplicates added, is multiplied on the tensor
//     cores;
//   - sparse: its nonzeros join a CSR over the output rows (row_ptr, g_col
//     = global k, g_val), each row's in ascending k-tile; padding slots are
//     dropped there, once.
// Block (rt, column tile) owns output rows [rt*tm, +tm) and TN columns (128
// or 64, as the caller passes: chunk_cuda.column_tile), launched longest
// row tile first.  Warp w owns the 16 rows [w*16, +16) of the tile: a
// block runs ceil(tm / 16) warps, at most 8 (tm <= 128).
//   1. Dense tiles, ascending k-tile: a ring stages each KC-deep chunk of
//      the tile's A (tm x KC f32, cp.async) and of its B panel (KC x TN) in
//      shared memory once, for all of the block's warps; each warp runs
//      bf16 mma.sync m16n8k16 on its 16 rows with f32 accumulators in
//      registers, f32 values split into bf16 terms in registers
//      (tc::bf16x2_term): A 3 terms, B 3 (f32) or 1 (bf16), products (i, j)
//      with i + j < 3 -- the strip routine's ladder (strip_spmm.cu).  A
//      k-step's products go into a fresh accumulator, smallest first, and
//      are then added into the sums in f32: the tensor cores do not round
//      their sums to nearest, and the running sums would take a biased
//      error of their own size from every product.  The sums go to shared
//      memory, each warp its own rows.
//   2. Sparse nonzeros: the warp's 16 rows are one contiguous range of
//      the CSR, walked as one stream: a lane holds TN / 32 columns of the
//      current row in registers (starting from its dense sum), the lanes
//      load 32 (column, value) pairs at once (the next 32 while these are
//      used) and broadcast them with shuffles, and UNROLL B rows are
//      loaded (float2 / float4, bf16x2 / bf16x4) before their FMAs, across
//      row ends.  Each row is stored once, when the stream passes its end.
// One owner per output tile: no atomics, no zero pass, one store, the same
// sum order on every run (dense sum, then the gathered products in order),
// and a row tile with no nonzero is written as zeros.
//
// K5's mechanism, a k-tile's B panel fetched once for many row tiles, is
// the cluster launch (cres_cluster_spmm).  CLUSTER consecutive row tiles of
// one column tile are the blocks of one thread-block cluster
// (kernels/cres_spmm.py::cluster_schedule, built once per plan); the
// clusters are launched most nonzeros first.  Their ring walks the
// ascending union of the members' dense k-tiles.  For each KC-row chunk,
// the leader (rank 0) waits until every member freed the ring stage (its
// empty barrier, one remote arrival from each member), then its first warp
// copies the chunk's KC rows, one bulk copy of TN·esize bytes each,
// multicast into that stage of every member, which counts the bytes on its
// own full barrier.  A chunk with rows past k, columns past n or B rows
// that are not 16-byte aligned (widths 77 and 130) cannot be bulk copied
// (no zero fill, 16-byte sizes): there each member that has a tile at the
// step copies its own chunk with cp.async, as the owner routine does, and
// the leader's remote arrival releases the stage.  A member that has no
// tile at a step (or no row tile: the last cluster's padding) still waits
// and frees, so the ring never stalls.  Each member stages its own A chunk
// and runs the owner's products on its own tiles in ascending k-tile, then
// the same gather: the output equals the owner routine's bit for bit.  A
// barrier.cluster before the sums are stored keeps every CTA alive while a
// peer's copy or arrival may still target its shared memory.  At "split2"
// the index has no dense tile, so there is no panel to share: the launch
// runs the gather phase alone.
//
// The gather build (gather_kernel) replaces the TPU kernels' one-hot
// densify of gathered chunks wherever the index has no dense tile (at
// "split" / "highest"; large_25605 and the other corpus operands have
// none): no shared memory, no cluster, and warps shaped for loads in
// flight rather than for mma.sync.  A warp owns 1 or 2 output rows and
// walks all of B's width for them: a lane loads 16 bytes of a B row a
// nonzero (4 f32 or 8 bf16 columns; two passes over f32 B wider than 128
// columns, their columns in registers), so each (column, value) is read
// and shuffled once a row and each B row is read as one run of 512 bytes
// or more.  Registers capped at 64 hold 32 warps an SM, each with
// GATHER_LOADS 16-byte loads a lane in flight: 64 KB of B loads an SM, where
// the owner routine's gather phase held 12-24 KB (16-row warps, 8-byte
// lanes, 12 warps an SM at large_25605 w256).  What bounds it is B's bytes
// from HBM: 26.2 / 13.1 MB of f32 / bf16 B at large_25605 w256, read about
// once, as the output's 6.5 MB is written once.  The sum order is the
// owner routine's where no tile is dense (0, then fmaf over the row's
// nonzeros in CSR order), so the two give the same bits.
//
// Tiers: "split" / "highest" take both paths (f32 FMAs when gathered, the
// 6- or 3-product ladder on dense tiles: at least as faithful as the TPU's
// 3-term split and HIGHEST passes).  "split2" reproduces the TPU's
// arithmetic per nonzero: v = s2(b) * val, s2(x) being the f32 sum of x's
// two bf16 terms, and v's two bf16 terms summed apart (the TPU's one
// matmul per term), added at the row's end; its index has no dense tile.
// bf16 B is converted to f32 exactly.
//
// What bounds the owner routine on this card (PERF.md §5-6): gathered tiles
// move one B row (TN columns) from L2 per nonzero and column tile -- no
// reuse across nonzeros, with UNROLL loads in flight a warp (on an index
// with no dense tile the gather build keeps more in flight, in half the
// time at large_25605 w256); dense tiles move one A chunk
// per (row tile, k-tile, column tile) and one B chunk per owner or per
// cluster, and are bound by the ring and the term ladder's products (10x
// the bf16 floor with f32 B on a pruned weight).  The cluster cuts the B
// chunks read by up to CLUSTER times, not the A chunks, and makes a
// cluster's members walk their union of k-tiles in step.  On the H100 it
// is slower than the owner routine wherever it shares a panel (2048²
// w1024, bf16 B: 0.179 against 0.120 ms): the ring's barriers cost the
// owner's protocol-free loop about a sixth, and the KC one-row bulk copies
// of a chunk (128-512 bytes each) more than members copying their own
// chunks (PERF.md §6).  Left for later: one 2-D tensor-map copy a
// chunk; a producer warp; A re-read per column tile; wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "tensor_core.cuh"

namespace {

// Tuning constants, chosen on the card (PERF.md; strip_sweep.py times
// other values on patched copies of this file).
constexpr int WARP_ROWS = 16;   // output rows of a warp (chunk_cuda.WARP_ROWS)
constexpr int MAX_ROWS = 128;   // row tile of a block at most
constexpr int THREADS = MAX_ROWS / WARP_ROWS * 32;
constexpr int NARROW_TN = 64;   // column tiles (chunk_cuda.COLUMN_TILES)
constexpr int WIDE_TN = 128;
constexpr int KC = 32;          // k-chunk of a dense ring stage (chunk_cuda.KC)
constexpr int MAX_STAGES = 4;   // ring stages at most
constexpr int BLOCKS = 2;       // blocks an SM holds at once
constexpr int UNROLL = 8;       // gathered B rows a warp loads ahead
// row tiles of a C-resident cluster (chunk_cuda.CLUSTER; at most 8, the
// portable cluster size).  2: the H100 holds 132 clusters of 2 at once
// (cudaOccupancyMaxActiveClusters), every grid of the sweep in one wave,
// but 62 of 4 and 30 of 8, so the 256-block grids of 2048² and pruned
// weight (a) take two waves there; and the members walk the union of
// their k-tiles in step, which costs more the wider the cluster.  Device
// ms at R = 1 (the owner routine) / 2 / 4 / 8 on pruned (a) w512 f32:
// 0.0986 / 0.1150 / 0.1560 / 0.2606; 2048² w1024 f32: 0.2450 / 0.2793 /
// 0.4480 / 0.4482; no dense tile (large_25605 w256): 0.0379 / 0.0384 /
// 0.0376 / 0.0383 (strip_sweep.py --chunk, NVIDIA H100 80GB HBM3, 700 W)
constexpr int CLUSTER = 2;
// the gather build (gather_kernel): warps of a block at most, the warps an
// SM is to hold at once (its registers are capped to fit them), 16-byte B
// loads a lane issues before their FMAs, and output rows of a warp at most
// (chunk_cuda.GATHER_WARPS_MAX / GATHER_MAX_ROWS; the binding picks each
// launch's rows a warp, warps a block and passes)
constexpr int GATHER_WARPS_MAX = 8;
constexpr int GATHER_SM_WARPS = 32;
constexpr int GATHER_LOADS = 4;
constexpr int GATHER_MAX_ROWS = 16;
constexpr int SMEM_LIMIT = 232448;  // opt-in shared memory per block
constexpr int SM_SMEM = 233472;     // shared memory of one SM
constexpr unsigned FULL = 0xffffffffu;

// shared-memory geometry of the dense path: a ring of stages (A chunk,
// f32, MAX_ROWS x KC; B chunk KC x TN), then reused for the warps' dense
// sums (MAX_ROWS x TN f32).  As many stages as fit in an SM's shared
// memory shared by BLOCKS blocks (1 KB of each reserved), 2 to MAX_STAGES.
template <int TN, typename TB>
struct Geo {
  static constexpr int A_LD = KC + 8;  // row strides in elements, padded
  static constexpr int B_LD = TN + (sizeof(TB) == 4 ? 4 : 8);
  static constexpr int D_LD = TN + 4;
  static constexpr int A_BYTES = MAX_ROWS * A_LD * 4;
  static constexpr int B_BYTES = KC * B_LD * (int)sizeof(TB);
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int D_BYTES = MAX_ROWS * D_LD * 4;
  static constexpr int BUDGET = SM_SMEM / BLOCKS - 1024 < SMEM_LIMIT
                                    ? SM_SMEM / BLOCKS - 1024
                                    : SMEM_LIMIT;
  static constexpr int FIT = BUDGET / STAGE_BYTES;
  static constexpr int STAGES =
      FIT < 2 ? 2 : FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int SMEM = RING > D_BYTES ? RING : D_BYTES;
  static_assert(SMEM <= SMEM_LIMIT, "two stages exceed a block's memory");
  static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0, "16-byte stages");
};

// the tile index on the device (tile_spmm.build_tile_index)
struct TileIndex {
  const int* row_ptr;  // (m_pad + 1,) sparse nonzeros of each output row
  const int* g_col;    // global k of each sparse nonzero
  const float* g_val;
  const int* d_ptr;    // (row tiles + 1,) dense tiles of each row tile
  const int* d_kt;     // k-tile of each dense tile
  const float* d_a;    // (dense tiles, round_up(tm, 16), tk) f32
  const int* order;    // row tiles, most work first
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x's two bf16 terms, summed in f32 (the sum is exact)
__device__ __forceinline__ float split2(float x) {
  const float hi = bf16_round(x);
  return __fadd_rn(hi, bf16_round(__fsub_rn(x, hi)));
}

// VEC values of B row r from column col as loaded, zero past n: f32
// values, or bf16 pairs in 32 bits (the lower address in the low half).
// One vector load through the read-only path when the row's VEC columns
// are in range and aligned (vec).  The bits are converted later
// (to_f32): a conversion inside the load's branch would wait for the load
// there, so the UNROLL loads of a warp would not be in flight together.
template <typename TB, int VEC>
struct Raw {
  float x[VEC];
};
template <int VEC>
struct Raw<__nv_bfloat16, VEC> {
  uint32_t x[VEC / 2];
};

template <int VEC>
__device__ __forceinline__ void load_b(Raw<float, VEC>& v, const float* r,
                                       int col, int n, bool vec) {
  if (vec && col + VEC <= n) {
    if constexpr (VEC == 2) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(r + col));
      v.x[0] = x.x, v.x[1] = x.y;
    } else {
      const float4 x = __ldg(reinterpret_cast<const float4*>(r + col));
      v.x[0] = x.x, v.x[1] = x.y, v.x[2] = x.z, v.x[3] = x.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    v.x[e] = col + e < n ? __ldg(r + col + e) : 0.f;
}

template <int VEC>
__device__ __forceinline__ void load_b(Raw<__nv_bfloat16, VEC>& v,
                                       const __nv_bfloat16* r, int col, int n,
                                       bool vec) {
  if (vec && col + VEC <= n) {
    if constexpr (VEC == 2) {
      v.x[0] = __ldg(reinterpret_cast<const unsigned int*>(r + col));
    } else {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(r + col));
      v.x[0] = x.x, v.x[1] = x.y;
    }
    return;
  }
  const unsigned short* h = reinterpret_cast<const unsigned short*>(r);
#pragma unroll
  for (int e = 0; e < VEC / 2; ++e) {
    const int c = col + 2 * e;
    v.x[e] = (c < n ? (uint32_t)h[c] : 0u) |
             (c + 1 < n ? (uint32_t)h[c + 1] << 16 : 0u);
  }
}

template <int VEC>
__device__ __forceinline__ void to_f32(float (&v)[VEC],
                                       const Raw<float, VEC>& raw) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = raw.x[e];
}

// a bf16 is the high half of an f32
template <int VEC>
__device__ __forceinline__ void to_f32(float (&v)[VEC],
                                       const Raw<__nv_bfloat16, VEC>& raw) {
#pragma unroll
  for (int e = 0; e < VEC / 2; ++e) {
    v[2 * e] = __uint_as_float(raw.x[e] << 16);
    v[2 * e + 1] = __uint_as_float(raw.x[e] & 0xffff0000u);
  }
}

template <typename TB>
__device__ __forceinline__ TB zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// the cluster schedule on the device (kernels/cres_spmm.py::
// cluster_schedule): CLUSTER consecutive row tiles a cluster, its steps the
// ascending union of its members' dense k-tiles
struct ClusterSchedule {
  const int* c_rt;     // (clusters, CLUSTER) member row tiles, -1: padding
  const int* c_ptr;    // (clusters + 1,) steps of each cluster
  const int* s_kt;     // k-tile of each step
  const int* s_tile;   // (steps, CLUSTER) each member's dense tile, or -1
  const int* c_order;  // clusters, most work first
  int* issues;         // multicast issues, counted where not null
};

// CLUSTERED: the C-resident kernels' launch (cres_cluster_spmm), a block
// per member of a cluster; else the owner routine (tile_owner_spmm), a
// block per (row tile, column tile)
template <int TN, typename TB, bool SPLIT2, bool CLUSTERED>
__global__ void __launch_bounds__(THREADS, BLOCKS)
tile_owner_kernel(TileIndex ix, ClusterSchedule cs, const TB* __restrict__ b,
                  float* __restrict__ out, int m, int k, int n, int tm,
                  int tk, int b_async, int b_vec) {
  using G = Geo<TN, TB>;
  constexpr int VEC = TN / 32;  // columns of a lane in the gather path
  extern __shared__ __align__(16) unsigned char smem[];
  const float* dsum = reinterpret_cast<const float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ncol = (n + TN - 1) / TN;
  // the block's row tile (-1: a cluster's padding member) and columns
  // [n0, +TN).  A cluster is CLUSTER consecutive blocks, its CTA ranks
  // (the launch's cluster is (CLUSTER, 1, 1)), over one column tile
  int rt, n0, rank = 0, cl = 0;
  if constexpr (CLUSTERED) {
    rank = blockIdx.x % CLUSTER;
    const int q = blockIdx.x / CLUSTER;
    cl = cs.c_order[q / ncol];
    n0 = q % ncol * TN;
    rt = cs.c_rt[cl * CLUSTER + rank];
  } else {
    rt = ix.order[blockIdx.x / ncol];
    n0 = blockIdx.x % ncol * TN;
  }
  bool dense = false;

  if constexpr (!SPLIT2) {
    int d0 = 0, d1 = 0;
    if (rt >= 0) d0 = ix.d_ptr[rt], d1 = ix.d_ptr[rt + 1];
    dense = d1 > d0;  // the same for every thread of the block
    // ring steps: the owner's dense tiles, or its cluster's union of dense
    // k-tiles (the same for every CTA of the cluster)
    int s0 = 0, steps = d1 - d0;
    if constexpr (CLUSTERED) {
      s0 = cs.c_ptr[cl];
      steps = cs.c_ptr[cl + 1] - s0;
    }
    if (steps > 0) {
      constexpr bool B_BF16 = sizeof(TB) == 2;
      constexpr int VB = 16 / sizeof(TB);  // B elements per 16-byte copy
      constexpr int B_ROW = TN * (int)sizeof(TB);  // bytes of a chunk row
      static_assert(KC == 32, "a warp's lanes copy a B chunk's rows");
      const int nthreads = blockDim.x;
      const int tm16 = (tm + 15) & ~15;
      const int chunks = tk / KC;  // ring items per dense tile
      const int items = steps * chunks;
      auto stage_a = [&](int s) {
        return reinterpret_cast<float*>(smem + s * G::STAGE_BYTES);
      };
      auto stage_b = [&](int s) {
        return reinterpret_cast<TB*>(smem + s * G::STAGE_BYTES + G::A_BYTES);
      };
      // a cluster's barriers, past the ring: full[s], this CTA's stage s
      // landed (one arrival and, for a multicast, its bytes); empty[s], the
      // leader's (rank 0), every member freed stage s (CLUSTER arrivals)
      uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::SMEM);
      uint64_t* empty = full + G::STAGES;
      // the block's dense tile at ring step `step` (-1: none there)
      auto tile_of = [&](int step) {
        if constexpr (CLUSTERED)
          return cs.s_tile[(s0 + step) * CLUSTER + rank];
        else
          return d0 + step;
      };
      // fill ring stage s with item (step, k-chunk): the tile's A rows and
      // the B panel's KC x TN chunk (rows >= k and columns >= n
      // zero-filled).  Every thread calls it.  In a cluster the leader
      // refills its stage once every member freed it; it then copies a
      // chunk that lies inside B with 16-byte rows (b_async) to every
      // member's stage at once (one bulk copy a row, multicast), and
      // otherwise each member that has a tile at the step copies its own,
      // the leader's arrival releasing the stage
      auto fetch = [&](int item, int s) {
        const int step = item / chunks;
        const int t = tile_of(step);
        const int kc = item % chunks * KC;
        int kt;
        if constexpr (CLUSTERED)
          kt = cs.s_kt[s0 + step];
        else
          kt = ix.d_kt[t];
        const int krow0 = kt * tk + kc;
        bool own_b = true;
        if constexpr (CLUSTERED) {
          const bool bulk = b_async && n0 + TN <= n && krow0 + KC <= k;
          if (bulk && tid == 0) tc::mbar_expect_tx(&full[s], KC * B_ROW);
          if (rank == 0 && warp == 0) {
            if (item >= G::STAGES) {
              if (lane == 0)
                tc::mbar_wait(&empty[s], (item / G::STAGES - 1) & 1);
              __syncwarp();
            }
            if (bulk) {  // lane r: panel row krow0 + r
              tc::bulk_copy_multicast(
                  stage_b(s) + lane * G::B_LD,
                  b + (size_t)(krow0 + lane) * n + n0, B_ROW, &full[s],
                  (uint16_t)((1u << CLUSTER) - 1));
              if (lane == 0 && cs.issues) atomicAdd(cs.issues, 1);
            } else if (lane < CLUSTER) {
              tc::mbar_arrive_cluster(&full[s], lane);
            }
          }
          own_b = !bulk;
          if (t < 0) return;  // this member has no tile at the step
        }
        const float* a_src = ix.d_a + (size_t)t * tm16 * tk + kc;
        float* sa = stage_a(s);
        for (int i = tid; i < tm16 * (KC / 4); i += nthreads) {
          const int row = i / (KC / 4), c = i % (KC / 4) * 4;
          tc::cp_async16(sa + row * G::A_LD + c, a_src + (size_t)row * tk + c,
                         16);
        }
        if (!own_b) return;
        TB* sb = stage_b(s);
        for (int i = tid; i < KC * (TN / VB); i += nthreads) {
          const int r = i / (TN / VB), c = i % (TN / VB) * VB;
          const int gr = krow0 + r, gc = n0 + c;
          TB* dst = sb + r * G::B_LD + c;
          if (b_async) {  // n % VB == 0: a copy is wholly inside or outside
            const bool in = gr < k && gc < n;
            tc::cp_async16(dst, in ? b + (size_t)gr * n + gc : b,
                           in ? 16 : 0);
          } else {
#pragma unroll
            for (int v = 0; v < VB; ++v)
              dst[v] = gr < k && gc + v < n ? b[(size_t)gr * n + gc + v]
                                            : zero_of<TB>();
          }
        }
      };

      const int gid = lane / 4, t4 = lane % 4;
      float acc[TN / 8][4];  // [n8 tile][fragment] of the warp's 16 rows
#pragma unroll
      for (int nt = 0; nt < TN / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;

      auto compute = [&](int s) {
        const float* sa = stage_a(s) + warp * WARP_ROWS * G::A_LD;
        const TB* sb = stage_b(s);
#pragma unroll 1  // one k-step's fragments live at a time
        for (int ks = 0; ks < KC; ks += 16) {
          uint32_t af[3][4];  // [term][register]
          {
            const float* r0 = sa + gid * G::A_LD + ks + 2 * t4;
            const float2 x0 = *reinterpret_cast<const float2*>(r0);
            const float2 x1 =
                *reinterpret_cast<const float2*>(r0 + 8 * G::A_LD);
            const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8);
            const float2 x3 =
                *reinterpret_cast<const float2*>(r0 + 8 * G::A_LD + 8);
            float v[8] = {x0.x, x0.y, x1.x, x1.y, x2.x, x2.y, x3.x, x3.y};
#pragma unroll
            for (int ia = 0; ia < 3; ++ia)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                af[ia][q] = tc::bf16x2_term(v[2 * q], v[2 * q + 1]);
          }
          if constexpr (B_BF16) {
#pragma unroll
            for (int nt = 0; nt < TN / 8; ++nt) {
              uint32_t r[2];
              tc::ldmatrix_x2_trans(r, sb + (ks + lane % 16) * G::B_LD +
                                           nt * 8);
              float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int ia = 2; ia >= 0; --ia)  // smallest term first
                tc::mma_bf16(part, af[ia], r[0], r[1]);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[nt][q] += part[q];
            }
          } else {
#pragma unroll
            for (int nt = 0; nt < TN / 8; ++nt) {
              const float* c =
                  reinterpret_cast<const float*>(sb) + nt * 8 + gid;
              float v[4] = {c[(ks + 2 * t4) * G::B_LD],
                            c[(ks + 2 * t4 + 1) * G::B_LD],
                            c[(ks + 2 * t4 + 8) * G::B_LD],
                            c[(ks + 2 * t4 + 9) * G::B_LD]};
              uint32_t bt[3][2];  // B's terms, in order
#pragma unroll
              for (int ib = 0; ib < 3; ++ib) {
                bt[ib][0] = tc::bf16x2_term(v[0], v[1]);
                bt[ib][1] = tc::bf16x2_term(v[2], v[3]);
              }
              // products (i, j) with i + j < 3, smallest first
              float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int d = 2; d >= 0; --d)
#pragma unroll
                for (int ia = 0; ia <= d; ++ia)
                  tc::mma_bf16(part, af[ia], bt[d - ia][0], bt[d - ia][1]);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[nt][q] += part[q];
            }
          }
        }
      };

      if constexpr (CLUSTERED) {
        if (tid == 0) {
          for (int s = 0; s < G::STAGES; ++s) {
            tc::mbar_init(&full[s], 1);
            tc::mbar_init(&empty[s], CLUSTER);
          }
          tc::fence_mbarrier_init();
        }
        tc::cluster_sync();  // every member's barriers are set up
      }
      // the ring: STAGES - 1 items in flight while one is consumed
#pragma unroll
      for (int s = 0; s < G::STAGES - 1; ++s) {
        if (s < items) fetch(s, s);
        tc::cp_async_commit();
      }
      for (int it = 0; it < items; ++it) {
        tc::cp_async_wait<G::STAGES - 2>();
        if constexpr (CLUSTERED)
          tc::mbar_wait(&full[it % G::STAGES], it / G::STAGES & 1);
        __syncthreads();  // item it landed; every warp is done with it - 1
        // a member with no tile at a step still waits and frees, so the
        // leader's ring moves on
        if constexpr (CLUSTERED)
          if (it > 0 && tid == 0)
            tc::mbar_arrive_cluster(&empty[(it - 1) % G::STAGES], 0);
        const int next = it + G::STAGES - 1;
        if (next < items) fetch(next, next % G::STAGES);
        tc::cp_async_commit();
        if (!CLUSTERED || tile_of(it / chunks) >= 0)
          compute(it % G::STAGES);
      }
      tc::cp_async_wait<0>();
      __syncthreads();  // the ring is free: it now holds the dense sums
      // no copy or arrival targets a CTA's shared memory past this point:
      // no CTA of a cluster leaves before all of them are here
      if constexpr (CLUSTERED) tc::cluster_sync();
      float* d = reinterpret_cast<float*>(smem) + warp * WARP_ROWS * G::D_LD;
#pragma unroll
      for (int nt = 0; nt < TN / 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(d + (gid + 8 * h) * G::D_LD + nt * 8 +
                                     2 * t4) =
              make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      __syncwarp();  // each warp reads back its own rows only
    }
  }
  if constexpr (CLUSTERED)
    if (rt < 0) return;  // a padding member owns no rows

  // sparse nonzeros.  The warp's rows hold one contiguous range of the
  // CSR, walked as one stream in batches of 32 (each lane loads one
  // (column, value) pair, the next batch's while this one is used); a row
  // is stored when the stream passes its end, so the B loads run ahead
  // across rows.  Every branch below is the same for the whole warp.
  const int col = n0 + lane * VEC;
  const bool vec = b_vec != 0;
  const int local0 = warp * WARP_ROWS;
  const int rows =
      max(0, min(WARP_ROWS, min(tm - local0, m - rt * tm - local0)));
  if (rows == 0) return;
  const int row0 = rt * tm + local0;
  const int my_ptr = lane <= rows ? ix.row_ptr[row0 + lane] : 0;
  const int p_end = __shfl_sync(FULL, my_ptr, rows);
  // the row's sums; at "split2" acc holds the high bf16 terms of the
  // products and lo the low ones, each summed apart as the TPU's one
  // matmul per term does, and added at the row's end
  float acc[VEC], lo[VEC];
  int cur = 0;                                // the row being summed
  int bound = __shfl_sync(FULL, my_ptr, 1);   // its end in the stream
  auto begin_row = [&]() {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = lo[e] = 0.f;
    if (dense)  // shared memory is read only where the dense path wrote it
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] = dsum[(local0 + cur) * G::D_LD + lane * VEC + e];
  };
  auto end_row = [&]() {
    float* o = out + (size_t)(row0 + cur) * n;
    if constexpr (SPLIT2)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], lo[e]);
    if (vec && col + VEC <= n) {
      if constexpr (VEC == 2)
        *reinterpret_cast<float2*>(o + col) = make_float2(acc[0], acc[1]);
      else
        *reinterpret_cast<float4*>(o + col) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (col + e < n) o[col + e] = acc[e];
    }
    if (++cur < rows) {
      bound = __shfl_sync(FULL, my_ptr, cur + 1);
      begin_row();
    }
  };
  begin_row();
  int p = __shfl_sync(FULL, my_ptr, 0);
  int next_col = 0;
  float next_val = 0.f;
  if (p + lane < p_end) {
    next_col = ix.g_col[p + lane];
    next_val = ix.g_val[p + lane];
  }
  for (; p < p_end; p += 32) {
    const int cnt = min(32, p_end - p);
    const int my_col = next_col;
    const float my_val = next_val;
    if (p + 32 + lane < p_end) {
      next_col = ix.g_col[p + 32 + lane];
      next_val = ix.g_val[p + 32 + lane];
    }
    for (int j = 0; j < cnt; j += UNROLL) {
      // the shuffles first, then the UNROLL loads back to back, converted
      // only when used
      int kr[UNROLL];
      float vv[UNROLL];
      Raw<TB, VEC> raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        kr[u] = __shfl_sync(FULL, my_col, (j + u) & 31);
        vv[u] = __shfl_sync(FULL, my_val, (j + u) & 31);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (j + u < cnt)
          load_b<VEC>(raw[u], b + (size_t)kr[u] * n, col, n, vec);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (j + u >= cnt) break;
        while (p + j + u >= bound) end_row();
        float bv[VEC];
        to_f32(bv, raw[u]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if constexpr (SPLIT2) {  // v = s2(b) * val, then its two terms
            const float v = __fmul_rn(split2(bv[e]), vv[u]);
            const float hi = bf16_round(v);
            acc[e] = __fadd_rn(acc[e], hi);
            lo[e] = __fadd_rn(lo[e], bf16_round(__fsub_rn(v, hi)));
          } else {
            acc[e] = fmaf(vv[u], bv[e], acc[e]);
          }
        }
      }
    }
  }
  while (cur < rows) end_row();
}

// 16 bytes of B row r from column col (VEC16 = 16 / sizeof(TB) columns;
// col a multiple of VEC16), zero past n.  ALIGNED (B's address and its
// row stride are multiples of 16 bytes, so a lane's 16 bytes lie wholly
// inside or outside the row): one 16-byte load.  Else by align, the
// largest of 8 and 4 that divides both: two 8-byte or four 4-byte loads,
// and one element at a time for bf16 rows of odd width or the row's last
// columns.  The aligned build keeps no register for the other paths.
template <typename TB>
constexpr int VEC16 = 16 / (int)sizeof(TB);

__device__ __forceinline__ void set_word(Raw<float, 4>& v, int w,
                                         uint32_t x) {
  v.x[w] = __uint_as_float(x);
}
__device__ __forceinline__ void set_word(Raw<__nv_bfloat16, 8>& v, int w,
                                         uint32_t x) {
  v.x[w] = x;
}

template <typename TB, bool ALIGNED>
__device__ __forceinline__ void load_b16(Raw<TB, VEC16<TB>>& v, const TB* r,
                                         int col, int n, int align) {
  constexpr int VEC = VEC16<TB>;
  if constexpr (ALIGNED) {
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (col < n) x = __ldg(reinterpret_cast<const uint4*>(r + col));
    set_word(v, 0, x.x), set_word(v, 1, x.y);
    set_word(v, 2, x.z), set_word(v, 3, x.w);
    return;
  }
  if (col + VEC <= n) {
    if (align == 8) {
      const uint2* p = reinterpret_cast<const uint2*>(r + col);
      const uint2 x = __ldg(p), y = __ldg(p + 1);
      set_word(v, 0, x.x), set_word(v, 1, x.y);
      set_word(v, 2, y.x), set_word(v, 3, y.y);
      return;
    }
    if (align == 4) {
      const unsigned int* p = reinterpret_cast<const unsigned int*>(r + col);
#pragma unroll
      for (int w = 0; w < 4; ++w) set_word(v, w, __ldg(p + w));
      return;
    }
  }
  if constexpr (sizeof(TB) == 4) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      v.x[e] = col + e < n ? __ldg(reinterpret_cast<const float*>(r) + col +
                                   e)
                           : 0.f;
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(r);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int c = col + 2 * w;
      v.x[w] = (c < n ? (uint32_t)__ldg(h + c) : 0u) |
               (c + 1 < n ? (uint32_t)__ldg(h + c + 1) << 16 : 0u);
    }
  }
}

// The gather build (gather_spmm): an index with no dense tile.  Warp w owns
// the rows_per_warp output rows [w * rows_per_warp, +rows_per_warp) and,
// in PASSES passes of 32 lanes x 16 bytes, the PASSES * 32 * VEC16
// columns of its column span (blockIdx.y).  It walks its rows' CSR range
// as one stream, as the gather phase above does: the lanes load 32
// (column, value) pairs at once (the next 32 while these are used) and
// broadcast them with shuffles; each round issues GATHER_LOADS 16-byte
// loads a lane (GATHER_LOADS / PASSES nonzeros) back to back, then their
// FMAs; a row is stored once, when the stream passes its end.  An output
// element starts at 0 and takes fmaf(val, b, acc) over its row's
// nonzeros in CSR order: the owner routine's bits where no tile is dense.
// ALIGNED: B's rows are 16-byte aligned (load_b16).
template <typename TB, int PASSES, bool ALIGNED>
__global__ void __launch_bounds__(GATHER_WARPS_MAX * 32,
                                  GATHER_SM_WARPS / GATHER_WARPS_MAX)
gather_kernel(const int* __restrict__ row_ptr, const int* __restrict__ g_col,
              const float* __restrict__ g_val, const TB* __restrict__ b,
              float* __restrict__ out, int m, int n, int rows_per_warp,
              int b_align, int c_vec) {
  constexpr int VEC = VEC16<TB>;
  constexpr int PASS = 32 * VEC;  // columns of a warp in one pass
  constexpr int NZ = GATHER_LOADS / PASSES;  // nonzeros a round
  static_assert(NZ >= 1 && GATHER_LOADS % PASSES == 0, "whole rounds");
  const int lane = threadIdx.x % 32;
  const long long first =
      ((long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) *
      rows_per_warp;
  if (first >= m) return;
  const int row0 = (int)first;
  const int rows = min(rows_per_warp, m - row0);
  const int col0 = blockIdx.y * PASSES * PASS + lane * VEC;
  const int my_ptr = lane <= rows ? row_ptr[row0 + lane] : 0;
  const int p_end = __shfl_sync(FULL, my_ptr, rows);
  float acc[PASSES][VEC];
  int cur = 0;                               // the row being summed
  int bound = __shfl_sync(FULL, my_ptr, 1);  // its end in the stream
  auto begin_row = [&]() {
#pragma unroll
    for (int q = 0; q < PASSES; ++q)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[q][e] = 0.f;
  };
  auto end_row = [&]() {
    float* o = out + (size_t)(row0 + cur) * n;
#pragma unroll
    for (int q = 0; q < PASSES; ++q) {
      const int col = col0 + q * PASS;
      if (c_vec && col + VEC <= n) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(o + col + e) = make_float4(
              acc[q][e], acc[q][e + 1], acc[q][e + 2], acc[q][e + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (col + e < n) o[col + e] = acc[q][e];
      }
    }
    if (++cur < rows) {
      bound = __shfl_sync(FULL, my_ptr, cur + 1);
      begin_row();
    }
  };
  begin_row();
  int p = __shfl_sync(FULL, my_ptr, 0);
  int next_col = 0;
  float next_val = 0.f;
  if (p + lane < p_end) {
    next_col = g_col[p + lane];
    next_val = g_val[p + lane];
  }
  for (; p < p_end; p += 32) {
    const int cnt = min(32, p_end - p);
    const int my_col = next_col;
    const float my_val = next_val;
    if (p + 32 + lane < p_end) {
      next_col = g_col[p + 32 + lane];
      next_val = g_val[p + 32 + lane];
    }
    for (int j = 0; j < cnt; j += NZ) {
      // the round's B rows are loaded first, each value shuffled only
      // when its FMAs run: no register holds it while the loads fly
      Raw<TB, VEC> raw[NZ][PASSES];
#pragma unroll
      for (int u = 0; u < NZ; ++u) {
        const int kr = __shfl_sync(FULL, my_col, (j + u) & 31);
        if (j + u < cnt)
#pragma unroll
          for (int q = 0; q < PASSES; ++q)
            load_b16<TB, ALIGNED>(raw[u][q], b + (size_t)kr * n,
                                  col0 + q * PASS, n, b_align);
      }
#pragma unroll
      for (int u = 0; u < NZ; ++u) {
        if (j + u >= cnt) break;
        const float v = __shfl_sync(FULL, my_val, (j + u) & 31);
        while (p + j + u >= bound) end_row();
#pragma unroll
        for (int q = 0; q < PASSES; ++q) {
          float bv[VEC];
          to_f32(bv, raw[u][q]);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[q][e] = fmaf(v, bv[e], acc[q][e]);
        }
      }
    }
  }
  while (cur < rows) end_row();
}

template <typename TB_, int PASSES_, bool ALIGNED_>
struct GatherCfg {
  using TB = TB_;
  static constexpr int PASSES = PASSES_;
  static constexpr bool ALIGNED = ALIGNED_;
};

// fn(GatherCfg<...>{}) for the gather build of B's dtype, passes and
// alignment
template <bool ALIGNED, typename Fn>
cudaError_t select_gather(int b_bf16, int passes, Fn fn) {
  if (b_bf16) return fn(GatherCfg<__nv_bfloat16, 1, ALIGNED>{});
  return passes == 2 ? fn(GatherCfg<float, 2, ALIGNED>{})
                     : fn(GatherCfg<float, 1, ALIGNED>{});
}

template <int TN_, typename TB_, bool SPLIT2_, bool CLUSTERED_>
struct Cfg {
  static constexpr int TN = TN_;
  using TB = TB_;
  static constexpr bool SPLIT2 = SPLIT2_;
  static constexpr bool CLUSTERED = CLUSTERED_;
  // the ring (or the dense sums), then a cluster's full and empty barriers
  static constexpr int SMEM =
      SPLIT2_ ? 0
              : Geo<TN_, TB_>::SMEM +
                    (CLUSTERED_ ? 2 * Geo<TN_, TB_>::STAGES * 8 : 0);
};

template <typename C>
using KernelOf = decltype(&tile_owner_kernel<C::TN, typename C::TB,
                                             C::SPLIT2, C::CLUSTERED>);

// fn(Cfg<...>{}) for the instantiation these arguments select
template <bool CLUSTERED, typename Fn>
cudaError_t select(int b_bf16, int wide, int split2, Fn fn) {
  using bf16 = __nv_bfloat16;
  if (b_bf16) {
    if (wide)
      return split2 ? fn(Cfg<WIDE_TN, bf16, true, CLUSTERED>{})
                    : fn(Cfg<WIDE_TN, bf16, false, CLUSTERED>{});
    return split2 ? fn(Cfg<NARROW_TN, bf16, true, CLUSTERED>{})
                  : fn(Cfg<NARROW_TN, bf16, false, CLUSTERED>{});
  }
  if (wide)
    return split2 ? fn(Cfg<WIDE_TN, float, true, CLUSTERED>{})
                  : fn(Cfg<WIDE_TN, float, false, CLUSTERED>{});
  return split2 ? fn(Cfg<NARROW_TN, float, true, CLUSTERED>{})
                : fn(Cfg<NARROW_TN, float, false, CLUSTERED>{});
}

// the kernel of C with its shared-memory limit raised, once on each device
// (one bit each; devices past 64 set it at every call)
template <typename C>
cudaError_t prepared(KernelOf<C>* out) {
  auto kernel =
      tile_owner_kernel<C::TN, typename C::TB, C::SPLIT2, C::CLUSTERED>;
  *out = kernel;
  if (C::SMEM <= 48 * 1024) return cudaSuccess;
  static std::atomic<unsigned long long> raised{0};
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (raised.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// a launch of clusters of CLUSTER blocks along x
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int blocks, int threads, int smem, cudaStream_t s) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// launch the routine over `units` row-tile places: the owner routine's
// num_tiles row tiles, or clusters x CLUSTER members, on column tiles of
// tn columns (NARROW_TN or WIDE_TN, chosen by the caller:
// chunk_cuda.column_tile)
template <bool CLUSTERED>
int launch_routine(TileIndex ix, ClusterSchedule cs, int units, const void* b,
                   int b_bf16, void* out, int num_tiles, int m, int k, int n,
                   int tm, int tk, int n_dense, int split2, int tn,
                   void* stream) {
  const int ncol64 = (n + NARROW_TN - 1) / NARROW_TN;
  if (num_tiles <= 0 || units < num_tiles || m <= 0 || k <= 0 || n <= 0 ||
      tm <= 0 || tm > MAX_ROWS || tk <= 0 ||
      (tn != NARROW_TN && tn != WIDE_TN) ||
      (long long)units * ncol64 > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int esize = b_bf16 ? 2 : 4;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(b);
  const int wide = tn == WIDE_TN;
  const int vec = (wide ? WIDE_TN : NARROW_TN) / 32;
  const int b_async = addr % 16 == 0 && n % (16 / esize) == 0;
  const int b_vec = addr % (vec * esize) == 0 && n % vec == 0;
  const int threads = (tm + WARP_ROWS - 1) / WARP_ROWS * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)select<CLUSTERED>(b_bf16, wide, split2, [&](auto c) {
    using C = decltype(c);
    using TB = typename C::TB;
    KernelOf<C> kernel;
    cudaError_t err = prepared<C>(&kernel);
    if (err != cudaSuccess) return err;
    const int blocks = units * ((n + C::TN - 1) / C::TN);
    // an index with no dense tile never touches shared memory: launched
    // without it, the SM keeps it as L1 cache for the gathered B rows
    const int smem = n_dense > 0 ? C::SMEM : 0;
    const TB* bt = static_cast<const TB*>(b);
    float* o = static_cast<float*>(out);
    if constexpr (C::CLUSTERED) {
      ClusterLaunch launch(blocks, threads, smem, s);
      err = cudaLaunchKernelEx(&launch.cfg, kernel, ix, cs, bt, o, m, k, n,
                               tm, tk, b_async, b_vec);
      if (err != cudaSuccess) return err;
    } else {
      kernel<<<blocks, threads, smem, s>>>(ix, cs, bt, o, m, k, n, tm, tk,
                                           b_async, b_vec);
    }
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// C (m x n f32, out) = A @ B from a tile index (row_ptr, g_col, g_val over
// the m_pad output rows; d_ptr, d_kt, d_a for the dense tiles of each of
// num_tiles row tiles; order, the row tiles by work, most first); B is
// k x n f32 or bf16 (b_bf16); n_dense the index's dense tiles; split2 != 0
// runs the verified-only 2-term tier (its index has no dense tile); tk a
// multiple of 32 wherever the index has a dense tile; tm <= 128; tn the
// column tile, 64 or 128.  Returns cudaGetLastError() after the launch.
//
// The one entry of K3 (tile_spmm.py::_kernel, grid (n tile, chunk), out
// tile stored on first[c] else added) and K4 (csr_vmem.py::_kernel, grid
// (row tile, slab), B whole or one slab_k stripe resident, written at s =
// 0 and added after): both read the index of the row-major plan.  K4
// stages only the panels of the k-tiles that hold a dense tile, a KC-row
// chunk at a time: no whole-slab stripe.
int tile_owner_spmm(const int* row_ptr, const int* g_col, const float* g_val,
                    const int* d_ptr, const int* d_kt, const float* d_a,
                    const int* order, const void* b, int b_bf16, void* out,
                    int num_tiles, int m, int k, int n, int tm, int tk,
                    int n_dense, int split2, int tn, void* stream) {
  return launch_routine<false>(
      {row_ptr, g_col, g_val, d_ptr, d_kt, d_a, order}, ClusterSchedule{},
      num_tiles, b, b_bf16, out, num_tiles, m, k, n, tm, tk, n_dense, split2,
      tn, stream);
}

// K5a (cres_spmm.py::_kernel, grid over 8-chunk k-major blocks, each
// block's B panel fetched once for all of them, whole C resident in VMEM)
// and K5b (cres_spmm.py::_kernel_kloop, grid over k-tiles): the same index
// read through a cluster schedule (c_rt, c_ptr, s_kt, s_tile, c_order over
// num_clusters clusters of `cluster` row tiles, which must be CLUSTER),
// launched as clusters of CLUSTER blocks.  Each k-tile's B chunk is read
// once for the row tiles of a cluster; issues, where not null, counts the
// multicast chunks.  The output equals tile_owner_spmm's bit for bit.
int cres_cluster_spmm(const int* row_ptr, const int* g_col,
                      const float* g_val, const int* d_ptr, const int* d_kt,
                      const float* d_a, const int* order, const int* c_rt,
                      const int* c_ptr, const int* s_kt, const int* s_tile,
                      const int* c_order, int* issues, int cluster,
                      int num_clusters, const void* b, int b_bf16, void* out,
                      int num_tiles, int m, int k, int n, int tm, int tk,
                      int n_dense, int split2, int tn, void* stream) {
  if (cluster != CLUSTER || num_clusters <= 0 ||
      (long long)num_clusters * CLUSTER > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return launch_routine<true>(
      {row_ptr, g_col, g_val, d_ptr, d_kt, d_a, order},
      {c_rt, c_ptr, s_kt, s_tile, c_order, issues}, num_clusters * CLUSTER,
      b, b_bf16, out, num_tiles, m, k, n, tm, tk, n_dense, split2, tn,
      stream);
}

// The gather build, for an index with no dense tile at "split" / "highest"
// (chunk_cuda.bind takes it for K3, K4, K5a and K5b alike): C (m x n f32,
// out) from the index's CSR (row_ptr, g_col, g_val); B k x n f32 or bf16
// (b_bf16).  The launch shape is the caller's: rows_per_warp output rows a
// warp (1 to GATHER_MAX_ROWS), warps a block (1 to GATHER_WARPS_MAX),
// passes of 32 lanes x 16 bytes a warp (1 or 2 with f32 B, 1 with bf16), a
// grid_x x grid_y grid that covers the m rows and the n columns.  The
// output equals tile_owner_spmm's bit for bit.  Returns
// cudaGetLastError() after the launch.
int gather_spmm(const int* row_ptr, const int* g_col, const float* g_val,
                const void* b, int b_bf16, void* out, int m, int k, int n,
                int rows_per_warp, int warps, int passes, int grid_x,
                int grid_y, void* stream) {
  const int esize = b_bf16 ? 2 : 4;
  const long long span = (long long)passes * 32 * (16 / esize);
  if (m <= 0 || k <= 0 || n <= 0 || rows_per_warp < 1 ||
      rows_per_warp > GATHER_MAX_ROWS || warps < 1 ||
      warps > GATHER_WARPS_MAX || passes < 1 || passes > (b_bf16 ? 1 : 2) ||
      grid_x < 1 || grid_y < 1 || grid_y > 65535 ||
      (long long)grid_x * warps * rows_per_warp < m || grid_y * span < n)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(b) | (uintptr_t)n * esize;
  const int b_align = bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8
                      : bits % 4 == 0 ? 4 : 0;
  const int c_vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 && n % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto c) {
    using C = decltype(c);
    using TB = typename C::TB;
    gather_kernel<TB, C::PASSES, C::ALIGNED>
        <<<dim3(grid_x, grid_y), warps * 32, 0, s>>>(
            row_ptr, g_col, g_val, static_cast<const TB*>(b),
            static_cast<float*>(out), m, n, rows_per_warp, b_align, c_vec);
    return cudaGetLastError();
  };
  return (int)(b_align == 16 ? select_gather<true>(b_bf16, passes, launch)
                             : select_gather<false>(b_bf16, passes, launch));
}

// Blocks of the owner routine one SM holds at once (the occupancy
// calculator), for a record; 0 with the error in *err.
int chunk_spmm_blocks_per_sm(int b_bf16, int wide, int split2, int* err) {
  int blocks = 0;
  *err = (int)select<false>(b_bf16, wide, split2, [&](auto c) {
    using C = decltype(c);
    KernelOf<C> kernel;
    cudaError_t e = prepared<C>(&kernel);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                         THREADS, C::SMEM);
  });
  return blocks;
}

// Clusters of the C-resident launch the card holds at once
// (cudaOccupancyMaxActiveClusters), for a record; 0 with the error in *err.
int cres_cluster_max_active(int b_bf16, int wide, int split2, int* err) {
  int clusters = 0;
  *err = (int)select<true>(b_bf16, wide, split2, [&](auto c) {
    using C = decltype(c);
    KernelOf<C> kernel;
    cudaError_t e = prepared<C>(&kernel);
    if (e != cudaSuccess) return e;
    ClusterLaunch launch(CLUSTER, THREADS, C::SMEM, nullptr);
    return cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.cfg);
  });
  return clusters;
}

// Blocks of `warps` warps of the gather build (B's dtype, passes; B's
// rows 16-byte aligned) one SM holds at once (the occupancy calculator),
// for a record; 0 with the error in *err.
int gather_blocks_per_sm(int b_bf16, int passes, int warps, int* err) {
  int blocks = 0;
  *err = (int)select_gather<true>(b_bf16, passes, [&](auto c) {
    using C = decltype(c);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, gather_kernel<typename C::TB, C::PASSES, C::ALIGNED>,
        warps * 32, 0);
  });
  return blocks;
}

const char* chunk_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
