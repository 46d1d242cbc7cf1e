// Chunk-owner SpMM for Hopper (sm_90a): the tile-plan kernels of
// tpuspmm_torch.
//
// Replaces four TPU kernels that read one plan (formats/tiles.py: chunks of
// E nonzeros, each inside one tm x tk tile, row -1 = padding):
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
// Here block (rt, y) owns output rows [rt*tm, +tm) and columns [y*TN, +TN).
// It walks its row tile's chunks in plan order (ascending k-tile), gathers
// the B row of each nonzero directly, accumulates the tm x TN tile in
// shared memory and stores it once: no atomics, no zero pass, the same sum
// order on every run, and a row tile with no nonzero is written as zeros.
//   K3, K5a, K5b  one kernel: the row-major plan, row tile rt's chunks
//       being [tile_ptr[rt], tile_ptr[rt+1]).  The TPU's k-major layouts
//       (K5a padded per k-tile to 8 chunks with rt -1 sentinels, K5b
//       without) list each row tile's chunks in this same order, so the
//       three entries give bit-identical outputs.  K5's own mechanism, one
//       B panel shared by the chunks of a k-tile, does not carry over yet.
//   K4  the slab layout (_slab_arrays): per slab s, the block stages the
//       B stripe rows [s*slab_k, +slab_k) x its TN columns in shared
//       memory and runs the (rt, s) chunk range from there.
// Each thread owns one output column, so the accumulator and the staged
// stripe are read and written by their own thread only: the walk needs no
// barrier.  Chunk payloads are read by all threads at the same address
// (one broadcast load).
//
// Tiers: "split" / "highest" are f32 FMAs (at least as faithful as the
// TPU's 3-term split and HIGHEST passes); "split2" reproduces the TPU's
// arithmetic per nonzero: contrib = s2(s2(b) * val), s2(x) being the f32
// sum of x's two bf16 terms.  bf16 B is converted to f32 exactly.
//
// What bounds it on this card: each nonzero costs one B load from L2 (or,
// for K4, shared memory) and one shared-memory read-modify-write per
// column, on the CUDA cores; no B reuse across row tiles.  Tensor cores,
// TMA and B reuse are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TN = 64;  // output columns per block (one per thread)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x's two bf16 terms, summed in f32 (the sum is exact)
__device__ __forceinline__ float split2(float x) {
  const float hi = bf16_round(x);
  return __fadd_rn(hi, bf16_round(__fsub_rn(x, hi)));
}

template <bool SPLIT2>
__device__ __forceinline__ float accumulate(float acc, float val, float b) {
  if constexpr (SPLIT2)
    return __fadd_rn(acc, split2(__fmul_rn(split2(b), val)));
  return fmaf(val, b, acc);
}

// Adds chunk c's nonzeros into this thread's accumulator column; BAT(kk)
// reads B at row kk of the chunk's k-tile (kk = krow0 + col offset).
template <bool SPLIT2, typename BAt>
__device__ __forceinline__ void walk_chunk(float* acc, const int* rows,
                                           const int* cols,
                                           const float* vals, int64_t c,
                                           int E, int64_t krow0, BAt bat) {
  const int* r_c = rows + c * E;
  const int* c_c = cols + c * E;
  const float* v_c = vals + c * E;
#pragma unroll 4
  for (int e = 0; e < E; ++e) {
    const int r = r_c[e];
    if (r < 0) continue;  // padding slot: never indexed
    const float bv = bat(krow0 + c_c[e]);
    acc[r * TN + threadIdx.x] =
        accumulate<SPLIT2>(acc[r * TN + threadIdx.x], v_c[e], bv);
  }
}

__device__ __forceinline__ void store_tile(const float* acc, float* out,
                                           int rt, int tm, int m, int n,
                                           int col) {
  for (int r = 0; r < tm; ++r) {
    const int64_t row = (int64_t)rt * tm + r;
    if (row < m) out[row * n + col] = acc[r * TN + threadIdx.x];
  }
}

// K3, K5a, K5b: B read from device memory (L2) per nonzero.
template <typename TB, bool SPLIT2>
__global__ void __launch_bounds__(TN)
owner_walk_kernel(const int* __restrict__ tile_ptr,
                  const int* __restrict__ kt, const int* __restrict__ rows,
                  const int* __restrict__ cols,
                  const float* __restrict__ vals, const TB* __restrict__ b,
                  float* __restrict__ out, int m, int n, int tm, int tk,
                  int E) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int rt = blockIdx.x;
  const int col = blockIdx.y * TN + threadIdx.x;
  if (col >= n) return;  // no barrier below: a dead column may leave
  for (int r = 0; r < tm; ++r) acc[r * TN + threadIdx.x] = 0.f;
  const TB* bcol = b + col;
  auto bat = [&](int64_t krow) { return to_f32(bcol[krow * n]); };
  for (int64_t c = tile_ptr[rt]; c < tile_ptr[rt + 1]; ++c)
    walk_chunk<SPLIT2>(acc, rows, cols, vals, c, E, (int64_t)kt[c] * tk,
                       bat);
  store_tile(acc, out, rt, tm, m, n, col);
}

// K4: per slab, the block's B stripe staged in shared memory (f32).
template <typename TB, bool SPLIT2>
__global__ void __launch_bounds__(TN)
staged_kernel(const int* __restrict__ start, const int* __restrict__ end,
              const int* __restrict__ kt, const int* __restrict__ rows,
              const int* __restrict__ cols, const float* __restrict__ vals,
              const TB* __restrict__ b, float* __restrict__ out, int m,
              int k, int n, int tm, int tk, int E, int num_slabs,
              int slab_k) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  float* b_s = acc + tm * TN;  // b_s[kk * TN + t]
  const int rt = blockIdx.x;
  const int col = blockIdx.y * TN + threadIdx.x;
  if (col >= n) return;
  for (int r = 0; r < tm; ++r) acc[r * TN + threadIdx.x] = 0.f;
  const int kts_per_slab = slab_k / tk;
  for (int s = 0; s < num_slabs; ++s) {
    const int g = rt * num_slabs + s;
    const int j0 = start[g], j1 = end[g];
    if (j0 == j1) continue;  // nothing of this row tile in the slab
    const int64_t k0 = (int64_t)s * slab_k;
    for (int kk = 0; kk < slab_k; ++kk) {
      const int64_t krow = k0 + kk;
      b_s[kk * TN + threadIdx.x] =
          krow < k ? to_f32(b[krow * n + col]) : 0.f;
    }
    auto bat = [&](int64_t kk) { return b_s[kk * TN + threadIdx.x]; };
    for (int j = j0; j < j1; ++j)
      walk_chunk<SPLIT2>(acc, rows, cols, vals, j, E,
                         (int64_t)(kt[j] - s * kts_per_slab) * tk, bat);
  }
  store_tile(acc, out, rt, tm, m, n, col);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename TB, bool SPLIT2>
cudaError_t launch_walk(const int* ptr, const int* kt,
                        const int* rows, const int* cols, const float* vals,
                        const void* b, float* out, int num_tiles, int m,
                        int n, int tm, int tk, int E, cudaStream_t stream) {
  const size_t smem = (size_t)tm * TN * sizeof(float);
  auto kernel = owner_walk_kernel<TB, SPLIT2>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(num_tiles, (n + TN - 1) / TN);
  kernel<<<grid, TN, smem, stream>>>(ptr, kt, rows, cols, vals,
                                     static_cast<const TB*>(b), out, m, n,
                                     tm, tk, E);
  return cudaGetLastError();
}

template <typename TB, bool SPLIT2>
cudaError_t launch_staged(const int* start, const int* end, const int* kt,
                          const int* rows, const int* cols,
                          const float* vals, const void* b, float* out,
                          int num_tiles, int m, int k, int n, int tm, int tk,
                          int E, int num_slabs, int slab_k,
                          cudaStream_t stream) {
  const size_t smem = (size_t)(tm + slab_k) * TN * sizeof(float);
  auto kernel = staged_kernel<TB, SPLIT2>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(num_tiles, (n + TN - 1) / TN);
  kernel<<<grid, TN, smem, stream>>>(start, end, kt, rows, cols, vals,
                                     static_cast<const TB*>(b), out, m, k,
                                     n, tm, tk, E, num_slabs, slab_k);
  return cudaGetLastError();
}

bool bad_shape(int num_tiles, int n, int tm, int tk, int E) {
  return num_tiles <= 0 || n <= 0 || tm <= 0 || tk <= 0 || E <= 0;
}

int walk(const void* ptr, const void* kt, const void* rows,
         const void* cols, const void* vals, const void* b, int b_bf16,
         void* out, int num_tiles, int m, int n, int tm, int tk, int E,
         int split2, void* stream) {
  if (bad_shape(num_tiles, n, tm, tk, E)) return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(ptr);
  const int* t = static_cast<const int*>(kt);
  const int* r = static_cast<const int*>(rows);
  const int* c = static_cast<const int*>(cols);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_bf16)
    return (int)(split2 ? launch_walk<__nv_bfloat16, true>(
                              p, t, r, c, v, b, o, num_tiles, m, n, tm,
                              tk, E, s)
                        : launch_walk<__nv_bfloat16, false>(
                              p, t, r, c, v, b, o, num_tiles, m, n, tm,
                              tk, E, s));
  return (int)(split2 ? launch_walk<float, true>(p, t, r, c, v, b, o,
                                                 num_tiles, m, n, tm, tk, E,
                                                 s)
                      : launch_walk<float, false>(p, t, r, c, v, b, o,
                                                  num_tiles, m, n, tm, tk,
                                                  E, s));
}

}  // namespace

extern "C" {

// K3 (tile_spmm.py::_kernel, grid (n tile, chunk), out tile stored on
// first[c] else added).  Row tile rt owns chunks [tile_ptr[rt],
// tile_ptr[rt+1]) of the row-major plan.  Bound by one L2 read of B per
// nonzero and column.  Returns cudaGetLastError().
int tile_chunk_spmm(const void* tile_ptr, const void* kt, const void* rows,
                    const void* cols, const void* vals, const void* b,
                    int b_bf16, void* out, int num_tiles, int m, int n,
                    int tm, int tk, int chunk, int split2, void* stream) {
  return walk(tile_ptr, kt, rows, cols, vals, b, b_bf16, out, num_tiles, m,
              n, tm, tk, chunk, split2, stream);
}

// K5a (cres_spmm.py::_kernel, grid over 8-chunk k-major blocks sharing a
// B panel, rt -1 sentinels skipped, whole C resident in VMEM).  The same
// walk as K3 over the row-major plan: each row tile's chunks come in the
// k-major layout's order, so the output is K3's, bit for bit.
int cres_chunk_spmm(const void* tile_ptr, const void* kt, const void* rows,
                    const void* cols, const void* vals, const void* b,
                    int b_bf16, void* out, int num_tiles, int m, int n,
                    int tm, int tk, int chunk, int split2, void* stream) {
  return walk(tile_ptr, kt, rows, cols, vals, b, b_bf16, out, num_tiles, m,
              n, tm, tk, chunk, split2, stream);
}

// K5b (cres_spmm.py::_kernel_kloop, grid over k-tiles, loop over each
// tile's chunks, split tiers only).  The same walk as K3 and K5a.
int cres_kloop_chunk_spmm(const void* tile_ptr, const void* kt,
                          const void* rows, const void* cols,
                          const void* vals, const void* b, int b_bf16,
                          void* out, int num_tiles, int m, int n, int tm,
                          int tk, int chunk, int split2, void* stream) {
  return walk(tile_ptr, kt, rows, cols, vals, b, b_bf16, out, num_tiles, m,
              n, tm, tk, chunk, split2, stream);
}

// K4 (csr_vmem.py::_kernel, grid (row tile, slab), B whole or one slab_k
// stripe resident, written at s = 0 and added after).  start/end index the
// slab layout per (rt, s); kt is global.  Bound by the stripe staging
// (slab_k x TN B reads per slab that holds a chunk of the row tile) and
// one shared-memory B read per nonzero and column.
int staged_chunk_spmm(const void* start, const void* end, const void* kt,
                      const void* rows, const void* cols, const void* vals,
                      const void* b, int b_bf16, void* out, int num_tiles,
                      int m, int k, int n, int tm, int tk, int chunk,
                      int split2, int num_slabs, int slab_k, void* stream) {
  if (bad_shape(num_tiles, n, tm, tk, chunk) || num_slabs <= 0 ||
      slab_k <= 0 || slab_k % tk)
    return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(start);
  const int* en = static_cast<const int*>(end);
  const int* t = static_cast<const int*>(kt);
  const int* r = static_cast<const int*>(rows);
  const int* c = static_cast<const int*>(cols);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_bf16)
    return (int)(split2
                     ? launch_staged<__nv_bfloat16, true>(
                           st, en, t, r, c, v, b, o, num_tiles, m, k, n, tm,
                           tk, chunk, num_slabs, slab_k, s)
                     : launch_staged<__nv_bfloat16, false>(
                           st, en, t, r, c, v, b, o, num_tiles, m, k, n, tm,
                           tk, chunk, num_slabs, slab_k, s));
  return (int)(split2 ? launch_staged<float, true>(
                            st, en, t, r, c, v, b, o, num_tiles, m, k, n, tm,
                            tk, chunk, num_slabs, slab_k, s)
                      : launch_staged<float, false>(
                            st, en, t, r, c, v, b, o, num_tiles, m, k, n, tm,
                            tk, chunk, num_slabs, slab_k, s));
}

const char* chunk_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
