// Streaming control for Hopper (sm_90a): y = 2x + 1 over an f32 array, one
// read and one write of every element, no other work.
//
// Replaces the stream control of bench/hbm_control.py (`2.0 * xx + 1.0`,
// one fused XLA op there; a TPU kernel was never written for it).  Eager
// PyTorch runs that expression as two kernels and four array passes, which
// would halve the ceiling it measures, so it is one kernel here.
//
// Bound by bytes: 8 bytes of device memory a value against one FMA.  Each
// thread moves UNROLL 16-byte vectors a trip (the loads issued together,
// so enough bytes are in flight to cover the memory's latency), with the
// streaming cache hints (ld.global.cs / st.global.cs: the data is touched
// once); the grid strides over the array, and the n % 4 tail is done by
// the first threads of block 0.  2x is exact in f32, so fmaf(2, x, 1)
// rounds once, as `2 * x + 1` does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
// blocks per SM at most: more only lengthens the grid's last wave
constexpr int BLOCKS_PER_SM = 16;

__device__ __forceinline__ float4 affine(float4 v) {
  return make_float4(fmaf(2.f, v.x, 1.f), fmaf(2.f, v.y, 1.f),
                     fmaf(2.f, v.z, 1.f), fmaf(2.f, v.w, 1.f));
}

__global__ void __launch_bounds__(THREADS)
    stream_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                  long long n4, const float* __restrict__ x_tail,
                  float* __restrict__ y_tail, int tail) {
  const long long stride = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (; i + (UNROLL - 1) * stride < n4; i += UNROLL * stride) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) __stcs(y + i + u * stride, affine(v[u]));
  }
  for (; i < n4; i += stride) __stcs(y + i, affine(__ldcs(x + i)));
  if (blockIdx.x == 0 && threadIdx.x < tail)
    y_tail[threadIdx.x] = fmaf(2.f, x_tail[threadIdx.x], 1.f);
}

}  // namespace

extern "C" {

// y = 2x + 1 over n floats on `stream`; x and y 16-byte aligned.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
int stream_2x_plus_1(const void* x, void* y, long long n, int sm_count,
                     void* stream) {
  if (n < 0 || sm_count <= 0 || (uintptr_t)x % 16 || (uintptr_t)y % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long n4 = n / 4;
  const int tail = (int)(n - 4 * n4);
  long long blocks = (n4 + (long long)THREADS * UNROLL - 1) /
                     ((long long)THREADS * UNROLL);
  if (blocks > (long long)sm_count * BLOCKS_PER_SM)
    blocks = (long long)sm_count * BLOCKS_PER_SM;
  if (blocks < 1) blocks = 1;
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  stream_kernel<<<(unsigned)blocks, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(xf), reinterpret_cast<float4*>(yf), n4,
      xf + 4 * n4, yf + 4 * n4, tail);
  return (int)cudaGetLastError();
}

const char* stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
