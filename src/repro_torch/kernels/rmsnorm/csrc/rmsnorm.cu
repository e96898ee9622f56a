// RMSNorm and fused residual-add RMSNorm for Hopper (sm_90a), bound to
// Python via ctypes.
//
// Replaces the Pallas TPU kernels src/repro/kernels/rmsnorm/kernel.py
// (_rmsnorm_kernel, entry rmsnorm; _rmsnorm_add_kernel, entry rmsnorm_add):
//
//   rmsnorm:      out = x * rsqrt(mean(x^2) + eps) * (1 + gamma)
//   rmsnorm_add:  s = x + r (fp32);  out = rmsnorm(s);  sum = s
//
// over the rows of a (rows, D) input: mean-square and scaling in fp32, out
// and sum rounded once to x's type.  rmsnorm_add normalises the unrounded
// fp32 sum (as the TPU kernel does), so in bf16 its normed output differs
// from "round x + r to bf16, then normalise" by at most a bf16 rounding,
// while its sum output is bitwise that rounding.
//
// Design.  One block of 256 threads per row (the TPU kernel's row tile is
// a block of rows; here a row is the unit of parallel work, and the rows
// of a prefill — hundreds — fill the SMs).  Pass 1 reads the row with
// coalesced strided loads, accumulating the fp32 sum of squares (and, for
// the add, writing the rounded sum); a warp-shuffle reduction and one
// shared-memory exchange give the row's mean.  Pass 2 reads the row again
// (from L1/L2: a row is at most 16 KB) and writes the normed output.
//
// What bounds it on the H100.  A few operations per element against 4-12
// bytes moved: far below the card's balance point, so the bound is bytes
// at 3.35 TB/s.  On the serving path the rows are (512, 2048) or
// (512, 4096) per prefill and (8, 2048) or (8, 4096) per decode step: a
// few MB at most, so a launch is microseconds and the decode step's rows
// take the launch overhead, not the memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename G, bool ADD>
__global__ void __launch_bounds__(NTHREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r, const G* __restrict__ gamma,
               T* __restrict__ out, T* __restrict__ sum, int D, float eps) {
  __shared__ float partial[NWARPS];
  const long long base = (long long)blockIdx.x * D;
  const T* xr = x + base;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += NTHREADS) {
    float v = to_f(xr[i]);
    if (ADD) {
      v += to_f(r[base + i]);
      sum[base + i] = from_f<T>(v);
    }
    ss += v * v;
  }
  ss = warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < NWARPS ? partial[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(partial[0] / (float)D + eps);

  for (int i = threadIdx.x; i < D; i += NTHREADS) {
    float v = to_f(xr[i]);
    if (ADD) v += to_f(r[base + i]);
    out[base + i] = from_f<T>((v * inv) * (1.f + to_f(gamma[i])));
  }
}

template <typename T, typename G, bool ADD>
int launch(const void* x, const void* r, const void* gamma, void* out, void* sum,
           long long rows, int D, float eps, cudaStream_t s) {
  rmsnorm_kernel<T, G, ADD><<<(unsigned)rows, NTHREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const G*>(gamma),
      static_cast<T*>(out), static_cast<T*>(sum), D, eps);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = fp32, 1 = bf16
template <bool ADD>
int dispatch(const void* x, const void* r, const void* gamma, void* out, void* sum,
             int x_dtype, int g_dtype, long long rows, int D, float eps, void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && g_dtype == 0)
    return launch<float, float, ADD>(x, r, gamma, out, sum, rows, D, eps, s);
  if (x_dtype == 0 && g_dtype == 1)
    return launch<float, __nv_bfloat16, ADD>(x, r, gamma, out, sum, rows, D, eps, s);
  if (x_dtype == 1 && g_dtype == 0)
    return launch<__nv_bfloat16, float, ADD>(x, r, gamma, out, sum, rows, D, eps, s);
  if (x_dtype == 1 && g_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, ADD>(x, r, gamma, out, sum, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: (rows, D) contiguous of x_dtype; gamma: (D,) of g_dtype.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int rmsnorm_fwd(const void* x, const void* gamma, void* out, int x_dtype,
                           int g_dtype, long long rows, int D, float eps, void* stream) {
  return dispatch<false>(x, nullptr, gamma, out, nullptr, x_dtype, g_dtype, rows, D, eps,
                         stream);
}

// x, r, out, sum: (rows, D) contiguous of x_dtype; gamma: (D,) of g_dtype.
extern "C" int rmsnorm_add_fwd(const void* x, const void* r, const void* gamma, void* out,
                               void* sum, int x_dtype, int g_dtype, long long rows, int D,
                               float eps, void* stream) {
  return dispatch<true>(x, r, gamma, out, sum, x_dtype, g_dtype, rows, D, eps, stream);
}
