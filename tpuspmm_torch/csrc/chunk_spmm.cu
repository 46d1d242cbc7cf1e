// Tile-owner SpMM for Hopper (sm_90a): the tile-plan kernels of
// tpuspmm_torch, one routine on the CUDA cores and the tensor cores.
//
// Replaces four TPU kernels that read one plan (formats/tiles.py: chunks of
// E nonzeros, each inside one tm x tk tile, row -1 = padding), each
// launched through tile_owner_spmm by its own Python entry:
//   tile_chunk_spmm        <- tpuspmm/kernels/tile_spmm.py::_kernel (K3)
//   staged_chunk_spmm      <- tpuspmm/kernels/csr_vmem.py::_kernel (K4)
//   cres_chunk_spmm        <- tpuspmm/kernels/cres_spmm.py::_kernel (K5a)
//   cres_kloop_chunk_spmm  <- tpuspmm/kernels/cres_spmm.py::_kernel_kloop (K5b)
// Each TPU kernel densifies a chunk with one-hot matmuls on the MXU (Mosaic
// could not lower an in-kernel gather) and adds the product into an output
// block that later grid steps revisit: K3 through first[c], K4 across
// slabs, K5 into the whole VMEM-resident C.  That relies on grid steps
// running in order.
//
// The plan is read through a tile index built once on the host from the
// unchanged plan arrays (kernels/tile_spmm.py::build_tile_index), each row
// tile's chunks in ascending k-tile.  The four kernels are one C entry,
// tile_owner_spmm, over that one index, so they give the same bits.
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
// Block (rt, column tile) owns output rows [rt*tm, +tm) and TN columns (128;
// 64 when a 128-column grid has fewer blocks than SMs), launched longest
// row tile first.  Warp w owns the 16 rows [w*16, +16) of the tile: a
// block runs ceil(tm / 16) warps, at most 8 (tm <= 128).
//   1. Dense tiles, ascending k-tile: a cp.async ring stages each KC-deep
//      chunk of the tile's A (tm x KC f32) and of its B panel (KC x TN) in
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
// Tiers: "split" / "highest" take both paths (f32 FMAs when gathered, the
// 6- or 3-product ladder on dense tiles: at least as faithful as the TPU's
// 3-term split and HIGHEST passes).  "split2" reproduces the TPU's
// arithmetic per nonzero: v = s2(b) * val, s2(x) being the f32 sum of x's
// two bf16 terms, and v's two bf16 terms summed apart (the TPU's one
// matmul per term), added at the row's end; its index has no dense tile.
// bf16 B is converted to f32 exactly.
//
// What bounds it on this card (PERF.md §5-6): gathered tiles move one B
// row (TN columns) from L2 per nonzero and column tile -- no reuse across
// nonzeros, but every warp of every block in flight with UNROLL loads
// each (2.3 TB/s on large_25605 with f32 B); dense tiles move one B panel
// per (row tile, k-tile, column tile) and are bound by the ring and the
// term ladder's products (10x the bf16 floor with f32 B on a pruned
// weight).  Left for later: cluster multicast of a k-tile's B panel to the
// row tiles that share it; wgmma.

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

template <int TN, typename TB, bool SPLIT2>
__global__ void __launch_bounds__(THREADS, BLOCKS)
tile_owner_kernel(TileIndex ix, const TB* __restrict__ b,
                  float* __restrict__ out, int m, int k, int n, int tm,
                  int tk, int b_async, int b_vec) {
  using G = Geo<TN, TB>;
  constexpr int VEC = TN / 32;  // columns of a lane in the gather path
  extern __shared__ __align__(16) unsigned char smem[];
  const float* dsum = reinterpret_cast<const float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ncol = (n + TN - 1) / TN;
  const int rt = ix.order[blockIdx.x / ncol];
  const int n0 = blockIdx.x % ncol * TN;
  bool dense = false;

  if constexpr (!SPLIT2) {
    const int d0 = ix.d_ptr[rt], d1 = ix.d_ptr[rt + 1];
    dense = d1 > d0;  // the same for every thread of the block
    if (dense) {
      constexpr bool B_BF16 = sizeof(TB) == 2;
      constexpr int VB = 16 / sizeof(TB);  // B elements per 16-byte copy
      const int nthreads = blockDim.x;
      const int tm16 = (tm + 15) & ~15;
      const int chunks = tk / KC;  // ring items per dense tile
      const int items = (d1 - d0) * chunks;
      auto stage_a = [&](int s) {
        return reinterpret_cast<float*>(smem + s * G::STAGE_BYTES);
      };
      auto stage_b = [&](int s) {
        return reinterpret_cast<TB*>(smem + s * G::STAGE_BYTES + G::A_BYTES);
      };
      // fill ring stage s with item (dense tile, k-chunk): the tile's A
      // rows and the B panel's KC x TN chunk (rows >= k and columns >= n
      // zero-filled).  Every thread calls it.
      auto fetch = [&](int item, int s) {
        const int t = d0 + item / chunks;
        const int kc = item % chunks * KC;
        const float* a_src = ix.d_a + (size_t)t * tm16 * tk + kc;
        float* sa = stage_a(s);
        for (int i = tid; i < tm16 * (KC / 4); i += nthreads) {
          const int row = i / (KC / 4), c = i % (KC / 4) * 4;
          tc::cp_async16(sa + row * G::A_LD + c, a_src + (size_t)row * tk + c,
                         16);
        }
        const int krow0 = ix.d_kt[t] * tk + kc;
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

      // the ring: STAGES - 1 items in flight while one is consumed
#pragma unroll
      for (int s = 0; s < G::STAGES - 1; ++s) {
        if (s < items) fetch(s, s);
        tc::cp_async_commit();
      }
      for (int it = 0; it < items; ++it) {
        tc::cp_async_wait<G::STAGES - 2>();
        __syncthreads();  // item it landed; every warp is done with it - 1
        const int next = it + G::STAGES - 1;
        if (next < items) fetch(next, next % G::STAGES);
        tc::cp_async_commit();
        compute(it % G::STAGES);
      }
      tc::cp_async_wait<0>();
      __syncthreads();  // the ring is free: it now holds the dense sums
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

template <int TN_, typename TB_, bool SPLIT2_>
struct Cfg {
  static constexpr int TN = TN_;
  using TB = TB_;
  static constexpr bool SPLIT2 = SPLIT2_;
  static constexpr int SMEM = SPLIT2_ ? 0 : Geo<TN_, TB_>::SMEM;
};

// fn(Cfg<...>{}) for the instantiation these arguments select
template <typename Fn>
cudaError_t select(int b_bf16, int wide, int split2, Fn fn) {
  using bf16 = __nv_bfloat16;
  if (b_bf16) {
    if (wide)
      return split2 ? fn(Cfg<WIDE_TN, bf16, true>{})
                    : fn(Cfg<WIDE_TN, bf16, false>{});
    return split2 ? fn(Cfg<NARROW_TN, bf16, true>{})
                  : fn(Cfg<NARROW_TN, bf16, false>{});
  }
  if (wide)
    return split2 ? fn(Cfg<WIDE_TN, float, true>{})
                  : fn(Cfg<WIDE_TN, float, false>{});
  return split2 ? fn(Cfg<NARROW_TN, float, true>{})
                : fn(Cfg<NARROW_TN, float, false>{});
}

// the kernel of C with its shared-memory limit raised, once on each device
// (one bit each; devices past 64 set it at every call)
template <typename C>
cudaError_t prepared(decltype(&tile_owner_kernel<C::TN, typename C::TB,
                                                 C::SPLIT2>)* out) {
  auto kernel = tile_owner_kernel<C::TN, typename C::TB, C::SPLIT2>;
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

int owner_spmm(TileIndex ix, const void* b, int b_bf16, void* out,
               int num_tiles, int m, int k, int n, int tm, int tk,
               int n_dense, int split2, int sms, void* stream) {
  const int ncol64 = (n + NARROW_TN - 1) / NARROW_TN;
  if (num_tiles <= 0 || m <= 0 || k <= 0 || n <= 0 || tm <= 0 ||
      tm > MAX_ROWS || tk <= 0 || sms <= 0 ||
      (long long)num_tiles * ncol64 > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int esize = b_bf16 ? 2 : 4;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(b);
  // column tile: 128, or 64 when a grid of 128-column blocks would leave
  // SMs idle
  const int wide = (long long)num_tiles * ((n + WIDE_TN - 1) / WIDE_TN) >= sms;
  const int vec = (wide ? WIDE_TN : NARROW_TN) / 32;
  const int b_async = addr % 16 == 0 && n % (16 / esize) == 0;
  const int b_vec = addr % (vec * esize) == 0 && n % vec == 0;
  const int threads = (tm + WARP_ROWS - 1) / WARP_ROWS * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)select(b_bf16, wide, split2, [&](auto c) {
    using C = decltype(c);
    decltype(&tile_owner_kernel<C::TN, typename C::TB, C::SPLIT2>) kernel;
    cudaError_t err = prepared<C>(&kernel);
    if (err != cudaSuccess) return err;
    const int blocks = num_tiles * ((n + C::TN - 1) / C::TN);
    // an index with no dense tile never touches shared memory: launched
    // without it, the SM keeps it as L1 cache for the gathered B rows
    kernel<<<blocks, threads, n_dense > 0 ? C::SMEM : 0, s>>>(
        ix, static_cast<const typename C::TB*>(b), static_cast<float*>(out),
        m, k, n, tm, tk, b_async, b_vec);
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
// multiple of 32 wherever the index has a dense tile; tm <= 128; sms the
// device's SM count.  Returns cudaGetLastError() after the launch.
//
// The one entry of K3 (tile_spmm.py::_kernel, grid (n tile, chunk), out
// tile stored on first[c] else added), K4 (csr_vmem.py::_kernel, grid (row
// tile, slab), B whole or one slab_k stripe resident, written at s = 0 and
// added after), K5a (cres_spmm.py::_kernel, grid over 8-chunk k-major
// blocks sharing a B panel, whole C resident in VMEM) and K5b
// (cres_spmm.py::_kernel_kloop, grid over k-tiles): all four read the
// index of the row-major plan.  K5's mechanism, one B panel read serving
// the chunks of its k-tile, lands here at the scale of one owner: a dense
// tile's panel is staged once for all of its chunks.  K4 stages only the
// panels of the k-tiles that hold a dense tile, a KC-row chunk at a time:
// no whole-slab stripe.
int tile_owner_spmm(const int* row_ptr, const int* g_col, const float* g_val,
                    const int* d_ptr, const int* d_kt, const float* d_a,
                    const int* order, const void* b, int b_bf16, void* out,
                    int num_tiles, int m, int k, int n, int tm, int tk,
                    int n_dense, int split2, int sms, void* stream) {
  return owner_spmm({row_ptr, g_col, g_val, d_ptr, d_kt, d_a, order}, b,
                    b_bf16, out, num_tiles, m, k, n, tm, tk, n_dense, split2,
                    sms, stream);
}

// Blocks of the routine one SM holds at once (the occupancy calculator),
// for a record; 0 with the error in *err.
int chunk_spmm_blocks_per_sm(int b_bf16, int wide, int split2, int* err) {
  int blocks = 0;
  *err = (int)select(b_bf16, wide, split2, [&](auto c) {
    using C = decltype(c);
    decltype(&tile_owner_kernel<C::TN, typename C::TB, C::SPLIT2>) kernel;
    cudaError_t e = prepared<C>(&kernel);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                         THREADS, C::SMEM);
  });
  return blocks;
}

const char* chunk_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
