// Block-streaming BSR SpMM for Hopper (sm_90a): kernel K6 of tpuspmm_torch.
//
// Replaces tpuspmm/kernels/bsr_spmm.py::_kernel (launch _bsr_spmm).  The TPU
// kernel's grid is (n tile, stored block) over the stored blocks sorted by
// block row, an empty block row holding one zero block; step i computes
// blocks[i] @ B[kt[i]*bw : +bw, n tile] at HIGHEST precision and stores it
// into block row rt[i] on that row's first block (first[i]), adding it
// otherwise.  That relies on grid steps running in order.
//
// Here block (br, sub, y) owns output rows [br*bh + sub*RT, +RT) and columns
// [y*TN, +TN).  It walks block row br's stored blocks in stored order (from
// indptr: the order of JAX's stable-sorted rt), and for each block stages,
// KC block columns at a time, the RT x KC slice of the block and the
// matching KC x TN slice of B in shared memory, then runs f32 FMAs into
// registers (each thread RPT rows x 4 columns).  It stores once: no atomics,
// no first flag, the same sums on every run, and an empty block row is
// written as zeros (JAX's zero block, without storing one).  Per output
// element the block products are summed in stored order, each over k
// ascending.
//
// B rows >= K read as zero (JAX's pad_b) and columns >= N are masked, so B
// is not padded on the host.  A bf16 B is loaded as bf16 and widened
// exactly.  Block shapes: bh % 8 == 0 and bw % KC == 0, which covers every
// shape mxu_friendly admits (bh % 8, bw % 128); RT is 32 when it divides
// bh, else 8.  Shared memory: (KC*(RT+1) + KC*TN) floats, 12.4 KB at RT 32.
//
// What bounds it on this card: the f32 FMAs on the CUDA cores
// (2*nblocks*bh*bw*N operations; at the pruned-weight cell, 96 blocks of
// 128 x 128 against a 4096 x 512 B, 1.61 GFLOP or 0.024 ms at 67 TFLOP/s,
// above the 0.0069 ms of its 23 MB at 3.35 TB/s), and the shared-memory
// reads that feed them (one float4 of B and RPT values of A per 4*RPT
// FMAs).  Each B slice is read from L2 once per (block row, row sub-tile)
// that stores a block in its block column.  Tensor cores (3-pass bf16 or
// 3xTF32 through wgmma), TMA-fed shared memory and B-panel reuse across
// block rows are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TN = 64;  // output columns per block
constexpr int KC = 32;  // block columns staged per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int RT>
struct Geometry {
  static constexpr int TY = RT < 16 ? RT : 16;  // thread rows
  static constexpr int THREADS = 16 * TY;       // 16 threads x 4 columns = TN
  static constexpr int RPT = RT / TY;           // output rows per thread
};

template <typename TB, int RT>
__global__ void __launch_bounds__(Geometry<RT>::THREADS)
bsr_block_kernel(const int* __restrict__ indptr,
                 const int* __restrict__ indices,
                 const float* __restrict__ blocks, const TB* __restrict__ b,
                 float* __restrict__ out, int m, int k, int n, int bh,
                 int bw) {
  using G = Geometry<RT>;
  __shared__ float a_s[KC][RT + 1];  // block[r0 + r][kc + kk] at [kk][r]
  __shared__ __align__(16) float b_s[KC][TN];  // B[krow + kk][c0 + c]
  const int subs = bh / RT;
  const int br = blockIdx.x / subs;
  const int r0 = (blockIdx.x % subs) * RT;  // first row within the block row
  const int c0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[G::RPT][4];
#pragma unroll
  for (int i = 0; i < G::RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  const int j1 = indptr[br + 1];
  for (int j = indptr[br]; j < j1; ++j) {
    const float* blk = blocks + (int64_t)j * bh * bw + (int64_t)r0 * bw;
    const int64_t kbase = (int64_t)indices[j] * bw;
    for (int kc = 0; kc < bw; kc += KC) {
      for (int idx = tid; idx < RT * KC; idx += G::THREADS) {
        const int r = idx / KC, kk = idx % KC;
        a_s[kk][r] = blk[(int64_t)r * bw + kc + kk];
      }
      for (int idx = tid; idx < KC * TN; idx += G::THREADS) {
        const int kk = idx / TN, c = idx % TN;
        const int64_t krow = kbase + kc + kk;
        const int col = c0 + c;
        b_s[kk][c] = (krow < k && col < n) ? to_f32(b[krow * n + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < G::RPT; ++i) {
          const float av = a_s[kk][ty + i * G::TY];
          acc[i][0] = fmaf(av, bv.x, acc[i][0]);
          acc[i][1] = fmaf(av, bv.y, acc[i][1]);
          acc[i][2] = fmaf(av, bv.z, acc[i][2]);
          acc[i][3] = fmaf(av, bv.w, acc[i][3]);
        }
      }
      __syncthreads();  // the next step overwrites the staged slices
    }
  }

#pragma unroll
  for (int i = 0; i < G::RPT; ++i) {
    const int64_t row = (int64_t)br * bh + r0 + ty + i * G::TY;
    if (row >= m) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + tx * 4 + c;
      if (col < n) out[row * n + col] = acc[i][c];
    }
  }
}

template <typename TB, int RT>
cudaError_t launch(const int* indptr, const int* indices, const float* blocks,
                   const void* b, float* out, int num_block_rows, int m,
                   int k, int n, int bh, int bw, cudaStream_t stream) {
  dim3 grid(num_block_rows * (bh / RT), (n + TN - 1) / TN);
  bsr_block_kernel<TB, RT><<<grid, Geometry<RT>::THREADS, 0, stream>>>(
      indptr, indices, blocks, static_cast<const TB*>(b), out, m, k, n, bh,
      bw);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t launch_rows(const int* indptr, const int* indices,
                        const float* blocks, const void* b, float* out,
                        int num_block_rows, int m, int k, int n, int bh,
                        int bw, cudaStream_t stream) {
  if (bh % 32 == 0)
    return launch<TB, 32>(indptr, indices, blocks, b, out, num_block_rows, m,
                          k, n, bh, bw, stream);
  return launch<TB, 8>(indptr, indices, blocks, b, out, num_block_rows, m, k,
                       n, bh, bw, stream);
}

}  // namespace

extern "C" {

// K6 (bsr_spmm.py::_kernel).  C (m, n) f32 from the BSR arrays (indptr,
// indices int32; blocks (nblocks, bh, bw) f32, row-major) and a row-major
// (k, n) f32 or bf16 B, on `stream`.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int bsr_block_spmm(const void* indptr, const void* indices,
                   const void* blocks, const void* b, int b_bf16, void* out,
                   int num_block_rows, int m, int k, int n, int bh, int bw,
                   void* stream) {
  if (num_block_rows <= 0 || n <= 0 || bh <= 0 || bw <= 0 || bh % 8 ||
      bw % KC || (n + TN - 1) / TN > 65535)
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(indptr);
  const int* ix = static_cast<const int*>(indices);
  const float* blk = static_cast<const float*>(blocks);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_bf16)
    return (int)launch_rows<__nv_bfloat16>(p, ix, blk, b, o, num_block_rows,
                                           m, k, n, bh, bw, s);
  return (int)launch_rows<float>(p, ix, blk, b, o, num_block_rows, m, k, n,
                                 bh, bw, s);
}

const char* bsr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
