// Strip-owner SpMM for Hopper (sm_90a): the panel (K1) and pair (K2)
// kernels of tpuspmm_torch.
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
// Here the plan is read through a CSR index over the OUTPUT strips, built
// on the host from the unchanged plan arrays (strip_ptr, src_slot, src_kt;
// see PanelPlan.strip_index / PairPlan.strip_index): block (g, y) owns
// output rows [g*TM, +TM) and columns [y*TN, +TN), walks its strip's
// entries in plan order (ascending k-tile), accumulates TM x TN in f32 and
// stores once.  One owner per output strip: no atomics, no zero-fill pass,
// the same sum order on every run, and rows no plan strip touches are
// written as zeros by their owner.  Padding and trash slots are not in the
// index, so the TPU's trash strip does not exist here.
//
// Types: A is f32, or bf16 for a plan whose values round-trip bf16
// losslessly; B is f32 or bf16.  Products are formed and summed in f32, so
// the "highest" tier is met or exceeded, and bf16 x bf16 is exact.
//
// What bounds it on this card: every entry re-reads a tk x TN tile of B
// (from L2 in the common case) and the f32 FMAs run on the CUDA cores, not
// the tensor cores.  The design keeps each A strip chunk in shared memory,
// reused by all TN columns, and each thread's B loads coalesced across the
// warp.  Tiling B for reuse across strips, wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;  // output columns per block (one per thread)
constexpr int KC = 128;  // k-chunk of an A strip staged in shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int TM, typename TA, typename TB>
__global__ void __launch_bounds__(TN)
strip_owner_kernel(const TA* __restrict__ a_dense,
                   const TB* __restrict__ b,
                   const int* __restrict__ strip_ptr,
                   const int* __restrict__ src_slot,
                   const int* __restrict__ src_kt,
                   float* __restrict__ out,
                   int tk, int k, int n) {
  __shared__ __align__(16) float a_s[TM * KC];  // a_s[r * KC + kk]

  const int g = blockIdx.x;
  const int col = blockIdx.y * TN + threadIdx.x;
  const bool live = col < n;
  float acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0.f;

  const int e0 = strip_ptr[g];
  const int e1 = strip_ptr[g + 1];
  for (int e = e0; e < e1; ++e) {
    const TA* a = a_dense + (size_t)src_slot[e] * TM * tk;
    const int krow0 = src_kt[e] * tk;
    for (int k0 = 0; k0 < tk; k0 += KC) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = threadIdx.x; i < TM * KC; i += TN) {
        const int r = i / KC, kk = i % KC;
        a_s[i] = to_f32(a[(size_t)r * tk + k0 + kk]);
      }
      __syncthreads();
      if (live) {
        const TB* bp = b + (size_t)(krow0 + k0) * n + col;
        // B rows at or past k are padding of the last k-tile: the plan
        // holds zeros there, and the rows are not read
        const int kk_end = min(KC, k - (krow0 + k0));
#pragma unroll 4
        for (int kk = 0; kk < kk_end; kk += 4) {
          float bv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = kk + j < kk_end ? to_f32(bp[(size_t)(kk + j) * n]) : 0.f;
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float4 a4 =
                *reinterpret_cast<const float4*>(&a_s[r * KC + kk]);
            acc[r] = fmaf(a4.x, bv[0], acc[r]);
            acc[r] = fmaf(a4.y, bv[1], acc[r]);
            acc[r] = fmaf(a4.z, bv[2], acc[r]);
            acc[r] = fmaf(a4.w, bv[3], acc[r]);
          }
        }
      }
    }
  }
  if (live) {
    float* o = out + (size_t)g * TM * n + col;
#pragma unroll
    for (int r = 0; r < TM; ++r) o[(size_t)r * n] = acc[r];
  }
}

template <int TM, typename TA, typename TB>
cudaError_t launch_tm(const void* a, const void* b, const int* strip_ptr,
                      const int* src_slot, const int* src_kt, float* out,
                      int n_out_strips, int tk, int k, int n,
                      cudaStream_t stream) {
  dim3 grid(n_out_strips, (n + TN - 1) / TN);
  strip_owner_kernel<TM, TA, TB><<<grid, TN, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), strip_ptr,
      src_slot, src_kt, out, tk, k, n);
  return cudaGetLastError();
}

template <typename TA, typename TB>
cudaError_t launch_types(int tm, const void* a, const void* b,
                         const int* strip_ptr, const int* src_slot,
                         const int* src_kt, float* out, int n_out_strips,
                         int tk, int k, int n, cudaStream_t stream) {
  switch (tm) {
    case 8:
      return launch_tm<8, TA, TB>(a, b, strip_ptr, src_slot, src_kt, out,
                                  n_out_strips, tk, k, n, stream);
    case 16:
      return launch_tm<16, TA, TB>(a, b, strip_ptr, src_slot, src_kt, out,
                                   n_out_strips, tk, k, n, stream);
    case 32:
      return launch_tm<32, TA, TB>(a, b, strip_ptr, src_slot, src_kt, out,
                                   n_out_strips, tk, k, n, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int strip_spmm(const void* a, int a_bf16, const void* b, int b_bf16,
               const void* strip_ptr, const void* src_slot,
               const void* src_kt, void* out, int n_out_strips, int tm,
               int tk, int k, int n, void* stream) {
  if (n_out_strips <= 0 || n <= 0 || tk % KC != 0)
    return (int)cudaErrorInvalidValue;
  const int* sp = static_cast<const int*>(strip_ptr);
  const int* ss = static_cast<const int*>(src_slot);
  const int* sk = static_cast<const int*>(src_kt);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_bf16 && b_bf16)
    err = launch_types<__nv_bfloat16, __nv_bfloat16>(
        tm, a, b, sp, ss, sk, o, n_out_strips, tk, k, n, s);
  else if (a_bf16)
    err = launch_types<__nv_bfloat16, float>(tm, a, b, sp, ss, sk, o,
                                             n_out_strips, tk, k, n, s);
  else if (b_bf16)
    err = launch_types<float, __nv_bfloat16>(tm, a, b, sp, ss, sk, o,
                                             n_out_strips, tk, k, n, s);
  else
    err = launch_types<float, float>(tm, a, b, sp, ss, sk, o, n_out_strips,
                                     tk, k, n, s);
  return (int)err;
}

}  // namespace

extern "C" {

// Panel layout (K1).  Replaces tpuspmm/kernels/panel_spmm.py::_kernel
// (one grid step per panel of P strips sharing a k-tile, each strip added
// into a VMEM slab at offs; padding strips into a trash strip).  Plan slot
// = panel * P + strip; padding slots (offset sm) are not in the index, so
// they cost nothing here.  Bound on this card by the per-strip B re-reads
// from L2 and the dense f32 FMAs over each strip (see the file note).
// Returns cudaGetLastError() after the launch.
int panel_strip_spmm(const void* a, int a_bf16, const void* b, int b_bf16,
                     const void* strip_ptr, const void* src_slot,
                     const void* src_kt, void* out, int n_out_strips, int tm,
                     int tk, int k, int n, void* stream) {
  return strip_spmm(a, a_bf16, b, b_bf16, strip_ptr, src_slot, src_kt, out,
                    n_out_strips, tm, tk, k, n, stream);
}

// Pair layout (K2).  Replaces tpuspmm/kernels/pair_spmm.py::_pair_kernel
// (one grid step per CH-strip chunk of a pair's run, DMA'd ping-pong at an
// arbitrary strip offset; strips past the chunk's count masked to trash).
// Plan slot = strip index of a pair's run; the CH-strip zero tail and the
// strips a chunk reads past its pair are not in the index, so the
// over-read costs nothing here and no DMA pipeline is needed: each block
// loads its own strips.  Bound as the panel entry is.  Returns
// cudaGetLastError() after the launch.
int pair_strip_spmm(const void* a, int a_bf16, const void* b, int b_bf16,
                    const void* strip_ptr, const void* src_slot,
                    const void* src_kt, void* out, int n_out_strips, int tm,
                    int tk, int k, int n, void* stream) {
  return strip_spmm(a, a_bf16, b, b_bf16, strip_ptr, src_slot, src_kt, out,
                    n_out_strips, tm, tk, k, n, stream);
}

const char* strip_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
