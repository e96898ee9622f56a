// Flash attention forward for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fwd_kernel, entry flash_attention_fwd): blocked attention with an fp32
// online softmax, scale D**-0.5, GQA (q-head h reads KV head h / rep),
// causal or not, a sliding window, a logit softcap, KV tiles outside
// [lo, hi) skipped, NEG_INF = -2e38 and max(l, 1e-30) as the reference.
//
// Layout: the model layout the wrapper is called with — q and o are
// (B, Sq, H, D), k and v (B, Sk, Hk, D), all contiguous — so no transpose
// is ever materialised.  Inputs are bf16 or fp32; accumulation is fp32.
//
// Design.  One block per (q-tile of 32 rows, q-head, batch); 128 threads,
// four per query row, each owning D/4 of the row's dimensions in float4
// groups (the four threads of a row read four consecutive float4s of a
// shared-memory row: no bank conflicts, and the eight rows of a warp read
// the same key, a broadcast).  K and V tiles of 32 keys are staged in
// shared memory as fp32; a row's score is the sum of its four partial dots
// (two warp shuffles).  Arbitrary Sq and Sk are handled by masking, so the
// Pallas version's halving of block_q until it divides S is not needed.
//
// What bounds it on the H100.  At the serving path's prefill shapes
// (S <= 1024, D = 64, 15 heads) the attention itself moves a few MB and
// does a few GFLOP: the roofline bound is ~1-2 us, on bytes below S ~ 700
// and on tensor-core operations above.  This first kernel does its dot
// products on the fp32 FMA pipes (67 TFLOP/s, not the 989 TFLOP/s of the
// bf16 tensor cores), so it is bound by those pipes and by shared-memory
// reads, far above the roofline.  wgmma tiles, TMA staging and a
// producer/consumer split are the later PR that closes that gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int TPR = 4;                 // threads per query row
constexpr int BQ = 32;                 // query rows per block
constexpr int BK = 32;                 // keys per KV tile
constexpr int NTHREADS = BQ * TPR;     // 128

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int H, int Hk, int Sq, int Sk, int causal, int window,
                 float softcap, float scale) {
  static_assert(D % (4 * TPR) == 0, "D must be a multiple of 16");
  constexpr int NV = D / (4 * TPR);    // float4 groups per thread
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int t = tid % TPR;
  const int q_start = qt * BQ;
  const int qpos = q_start + row;
  const bool row_ok = qpos < Sq;

  // thread t of a row owns dims 4*(t + TPR*i) .. +3 for i < NV
  float qr[4 * NV], acc[4 * NV];
  const long q_row = ((long)b * Sq + (row_ok ? qpos : 0)) * H * D + (long)h * D;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * (t + TPR * i) + c;
      qr[4 * i + c] = row_ok ? to_f(q[q_row + d]) : 0.f;
      acc[4 * i + c] = 0.f;
    }
  }

  // dynamic KV-tile bounds, as kernel.py: causal skips tiles above the
  // diagonal of the block's last row, a window skips tiles below the band
  // of its first row
  const int nk = (Sk + BK - 1) / BK;
  const int hi = causal ? min((q_start + BQ - 1) / BK + 1, nk) : nk;
  const int lo = (causal && window) ? max((q_start - window + 1) / BK, 0) : 0;

  float m = NEG_INF, l = 0.f;
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();                   // the previous tile is consumed
    for (int e = tid; e < BK * D; e += NTHREADS) {
      const int r = e / D, c = e % D;
      const int kp = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk) {
        const long off = ((long)b * Sk + kp) * Hk * D + (long)hk * D + c;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[r][c] = kx;
      vs[r][c] = vx;
    }
    __syncthreads();

    float s[BK];
    float tile_max = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[jj][4 * (t + TPR * i)]);
        part += qr[4 * i] * kk.x + qr[4 * i + 1] * kk.y
              + qr[4 * i + 2] * kk.z + qr[4 * i + 3] * kk.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      float sc = part * scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      const int kp = k0 + jj;
      bool ok = kp < Sk;
      if (causal) ok = ok && (kp <= qpos);
      if (window) ok = ok && (kp > qpos - window);
      sc = ok ? sc : NEG_INF;
      s[jj] = sc;
      tile_max = fmaxf(tile_max, sc);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      s[jj] = expf(s[jj] - m_new);
      psum += s[jj];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < 4 * NV; ++i) acc[i] *= alpha;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float p = s[jj];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[jj][4 * (t + TPR * i)]);
        acc[4 * i] += p * vv.x;
        acc[4 * i + 1] += p * vv.y;
        acc[4 * i + 2] += p * vv.z;
        acc[4 * i + 3] += p * vv.w;
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * (t + TPR * i) + c;
        o[q_row + d] = from_f<T>(acc[4 * i + c] / denom);
      }
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int B, int H,
            int Hk, int Sq, int Sk, int causal, int window, float softcap,
            float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hk, Sq, Sk, causal,
      window, softcap, scale);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H,
             int Hk, int Sq, int Sk, int D, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  // head dim 64 only, the one the ported configs use; other head dims are
  // instantiated with the family that needs them
  if (D != 64) return (int)cudaErrorInvalidValue;
  launch<T, 64>(q, k, v, o, B, H, Hk, Sq, Sk, causal, window, softcap, scale, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point.  dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaGetLastError() (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int H, int Hk,
                                   int Sq, int Sk, int D, int causal,
                                   int window, float softcap, float scale,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, Hk, Sq, Sk, D, causal, window, softcap, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, Hk, Sq, Sk, D, causal, window, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}
