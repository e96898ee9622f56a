// Mamba2 SSD chunk scan for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py
// (_ssd_kernel, entry ssd_fwd).  For one (batch, head) stream with scalar
// decay rate A < 0, inputs x_t (P), dt_t, B_t and C_t (N, shared by the
// H / G heads of a group), the scan is
//
//   S_t = exp(dt_t A) S_{t-1} + B_t (dt_t x_t)^T        y_t = C_t . S_t
//
// computed in chunks as the TPU kernel and models/ssm.py:ssd_chunked do:
// within a chunk, cum = cumsum(dt A) and
//
//   y[q]  = sum_{k<=q} exp(cum_q - cum_k) (C_q . B_k) dt_k x_k   (intra)
//         + exp(cum_q) C_q . S                                   (inter)
//   S'    = exp(cum_last) S + sum_k exp(cum_last - cum_k) B_k (dt_k x_k)^T
//
// with the (N, P) fp32 state S carried from chunk to chunk.
//
// Output contract.  The model layout's entry writes y in fp32 and the final
// state (B, H, N, P) in fp32 (ssd_chunked(..., return_state=True), which
// the serving prefill snapshots into a lane); the TPU layout's entry writes
// y in x's type and no state, as the TPU kernel.  x, dt, B, C and y are
// read and written through the strides the wrapper passes, so both layouts
// — x (B,T,H,P) or (B,H,T,P), B/C (B,T,G,N) or (B,G,T,N) — go in without a
// transpose, and B/C are read per group, never expanded per head.
//
// Blocking.  The config's chunk is 256, but one 256-row chunk's C.B^T
// scores alone are 256 KB of fp32, more than an SM's 227 KB of shared
// memory.  The chunk is a blocking choice (the result is the same up to
// fp32 summation order), so this kernel uses an internal chunk of QC = 64
// positions: per chunk, C, B^T, dt*x, the decayed scores and the state are
// five 64 x 64 fp32 tiles in shared memory (rows padded to 68 floats: 87 KB,
// two blocks per SM).  N and P may be anything up to 64 (zero-padded); a
// ragged T is masked as dt = 0 steps, an identity on the state, so the
// final state equals the exact-length scan's.
//
// Overflow.  Above the diagonal exp(cum_q - cum_k) has a positive exponent
// and can reach inf; inf * 0 would be NaN.  The decay is computed only
// where k <= q, and every other exponent (cum_q, cum_last - cum_k,
// cum_last) is <= 0.
//
// Design.  One block per (head, batch), 256 threads as a 16 x 16 grid, each
// owning a 4 x 4 tile of every 64 x 64 product; a product reads its left
// operand as broadcast scalars (padded rows: no bank conflicts between the
// two row groups of a warp) and its right operand as float4 rows.  Per
// chunk: warp 0 scans dt A (shuffles); the block stages the tiles;
// phase A forms the masked, decayed scores and the inter-chunk term
// C.S; phase B adds scores . (dt x) for k <= q, writes y, and updates the
// state tile in place (each thread owns its tile of S).
//
// What bounds it on the H100.  At the serving prefill shape (T = 512,
// H = 64, N = P = 64) the scan moves ~14 MB (bf16 x in, fp32 y out) and
// does ~0.8 GFLOP of fp32 products: ~4 us of bytes, ~12 us of the FMA
// pipes' 67 TFLOP/s, so operations bound it.  This first kernel does its
// products on the FMA pipes from shared memory and has 64 blocks (one per
// head) for 132 SMs at one prompt, so it sits well above that bound;
// tensor-core tiles (wgmma over bf16 inputs with fp32 accumulation) and
// splitting T across blocks with a second pass over chunk states are the
// later PR that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int QC = 64;               // internal chunk (positions)
constexpr int MAXD = 64;             // N and P at most
constexpr int LD = 68;               // shared-memory row stride, floats
constexpr int NTHREADS = 256;        // 16 x 16 threads, a 4 x 4 tile each
constexpr int TILE = QC * LD;        // floats per tile (QC == MAXD)
constexpr size_t SMEM_BYTES = (5 * TILE + 3 * QC) * sizeof(float);

static_assert(QC == MAXD, "the tiles share one shape");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// element strides (batch, position, head-or-group); the last dim (P or N)
// is contiguous
struct Strides {
  long long b, t, h;
};

struct Args {
  Strides x, dt, bm, cm, y;
  int H, G, T, N, P;
};

template <typename T, typename O>
__global__ void __launch_bounds__(NTHREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm, O* __restrict__ y,
           float* __restrict__ state, Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                  // C[q][n]
  float* Bt = Cs + TILE;             // B^T: Bt[n][k] = B[k][n]
  float* Xs = Bt + TILE;             // dt_k x_k: Xs[k][p]
  float* Ss = Xs + TILE;             // masked, decayed scores[q][k]
  float* St = Ss + TILE;             // the carried state S[n][p]
  float* cum = St + TILE;            // [QC] inclusive cumsum of dt A
  float* dts = cum + QC;             // [QC] dt
  float* wk = dts + QC;              // [QC] exp(cum_last - cum_k)

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const float rate = A[h];
  const int tid = threadIdx.x;
  const int r0 = (tid / 16) * 4;     // the thread's 4 rows of a product
  const int c0 = (tid % 16) * 4;     // and its 4 columns

  const T* xb = x + b * a.x.b + h * a.x.h;
  const float* db = dt + b * a.dt.b + h * a.dt.h;
  const T* Bb = Bm + b * a.bm.b + g * a.bm.h;
  const T* Cb = Cm + b * a.cm.b + g * a.cm.h;
  O* yb = y + b * a.y.b + h * a.y.h;

  for (int e = tid; e < TILE; e += NTHREADS) St[e] = 0.f;

  for (int t0 = 0; t0 < a.T; t0 += QC) {
    const int nv = min(QC, a.T - t0);            // real positions in the chunk
    __syncthreads();                             // the previous chunk is consumed

    // cum: warp 0, two positions a lane, an inclusive shuffle scan
    if (tid < 32) {
      const int k0 = 2 * tid;
      const float d0 = k0 < nv ? db[(long long)(t0 + k0) * a.dt.t] : 0.f;
      const float d1 = k0 + 1 < nv ? db[(long long)(t0 + k0 + 1) * a.dt.t] : 0.f;
      const float l0 = d0 * rate, l1 = d1 * rate;
      float incl = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      cum[k0] = excl + l0;
      cum[k0 + 1] = excl + l0 + l1;
      dts[k0] = d0;
      dts[k0 + 1] = d1;
    }
    __syncthreads();

    // stage C, B^T and dt x (zero past the chunk's real positions and past
    // N / P); consecutive threads read consecutive n / p of a row
    for (int e = tid; e < QC * MAXD; e += NTHREADS) {
      const int k = e / MAXD, c = e % MAXD;
      const long long t = t0 + k;
      const bool okn = k < nv && c < a.N;
      const bool okp = k < nv && c < a.P;
      Cs[k * LD + c] = okn ? to_f(Cb[t * a.cm.t + c]) : 0.f;
      Bt[c * LD + k] = okn ? to_f(Bb[t * a.bm.t + c]) : 0.f;
      Xs[k * LD + c] = okp ? to_f(xb[t * a.x.t + c]) * dts[k] : 0.f;
    }
    const float seg = cum[QC - 1];               // dt = 0 past nv: cum stays put
    if (tid < QC) wk[tid] = expf(seg - cum[tid]);
    __syncthreads();

    // phase A: scores = C . B^T under the decay mask, and the inter-chunk
    // term C . S (scaled by exp(cum_q) below)
    float sc[4][4] = {}, yo[4][4] = {};
    for (int j = 0; j < a.N; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(&Bt[j * LD + c0]);
      const float4 sv = *reinterpret_cast<const float4*>(&St[j * LD + c0]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float cv = Cs[(r0 + i) * LD + j];
        sc[i][0] += cv * bv.x; sc[i][1] += cv * bv.y; sc[i][2] += cv * bv.z; sc[i][3] += cv * bv.w;
        yo[i][0] += cv * sv.x; yo[i][1] += cv * sv.y; yo[i][2] += cv * sv.z; yo[i][3] += cv * sv.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = r0 + i;
      const float eq = expf(cum[q]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int k = c0 + jj;
        Ss[q * LD + k] = k <= q ? sc[i][jj] * expf(cum[q] - cum[k]) : 0.f;
        yo[i][jj] *= eq;
      }
    }
    __syncthreads();

    // phase B: y += scores . (dt x) over k <= q, then write y
    const int kend = min(r0 + 4, nv);
    for (int j = 0; j < kend; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(&Xs[j * LD + c0]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = Ss[(r0 + i) * LD + j];
        yo[i][0] += s * xv.x; yo[i][1] += s * xv.y; yo[i][2] += s * xv.z; yo[i][3] += s * xv.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = r0 + i;
      if (q >= nv) continue;
      O* row = yb + (long long)(t0 + q) * a.y.t;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (c0 + jj < a.P) row[c0 + jj] = from_f<O>(yo[i][jj]);
    }

    // state: S = exp(seg) S + sum_k (B_k exp(seg - cum_k)) (dt_k x_k)^T,
    // in place on the thread's own 4 x 4 tile of S
    float ds[4][4] = {};
    for (int j = 0; j < nv; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(&Xs[j * LD + c0]);
      const float w = wk[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float bw = Bt[(r0 + i) * LD + j] * w;
        ds[i][0] += bw * xv.x; ds[i][1] += bw * xv.y; ds[i][2] += bw * xv.z; ds[i][3] += bw * xv.w;
      }
    }
    const float eg = expf(seg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float* s = &St[(r0 + i) * LD + c0 + jj];
        *s = *s * eg + ds[i][jj];
      }
  }

  if (state != nullptr) {
    __syncthreads();
    float* out = state + ((long long)b * a.H + h) * a.N * a.P;
    for (int e = tid; e < a.N * a.P; e += NTHREADS) out[e] = St[(e / a.P) * LD + e % a.P];
  }
}

template <typename T, typename O>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* state, int batch, const Args& a, cudaStream_t s) {
  // opt in to > 48 KB of shared memory (per device, so at every launch)
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.H, batch);
  ssd_kernel<T, O><<<grid, NTHREADS, SMEM_BYTES, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<O*>(y),
      static_cast<float*>(state), a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: in_dtype, element strides xs[3] (batch, position, head), P contiguous;
// dt: fp32, strides dts[3]; A: (H,) fp32; Bm / Cm: in_dtype, strides
// bs[3] / cs[3] (batch, position, group), N contiguous; y: out_dtype,
// strides ys[3], P contiguous; state: (batch, H, N, P) fp32 contiguous, or
// null.  dtype codes 0 = fp32, 1 = bf16; (in, out) must be (0, 0), (1, 0)
// or (1, 1).  N, P <= 64 and H % G == 0 (the wrapper checks).  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, void* y, void* state, int in_dtype, int out_dtype,
                        int batch, int H, int G, int T, int N, int P, const long long* xs,
                        const long long* dts, const long long* bs, const long long* cs,
                        const long long* ys, void* stream) {
  if (batch <= 0 || H <= 0) return 0;
  if (N > MAXD || P > MAXD || G <= 0 || H % G) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = {xs[0], xs[1], xs[2]};
  a.dt = {dts[0], dts[1], dts[2]};
  a.bm = {bs[0], bs[1], bs[2]};
  a.cm = {cs[0], cs[1], cs[2]};
  a.y = {ys[0], ys[1], ys[2]};
  a.H = H; a.G = G; a.T = T; a.N = N; a.P = P;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, dt, A, Bm, Cm, y, state, batch, a, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, dt, A, Bm, Cm, y, state, batch, a, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, Bm, Cm, y, state, batch, a, s);
  return (int)cudaErrorInvalidValue;
}
