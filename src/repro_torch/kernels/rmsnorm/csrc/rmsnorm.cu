// RMSNorm, fused residual-add RMSNorm and the Mamba2 gated RMSNorm for
// Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the Pallas TPU kernels src/repro/kernels/rmsnorm/kernel.py
// (_rmsnorm_kernel, entry rmsnorm; _rmsnorm_add_kernel, entry rmsnorm_add),
// and folds into the same kernel the skip and gate that the reference's
// Mamba2 block computes in jnp before its out-norm
// (src/repro/models/ssm.py:244-246 and :286-288):
//
//   rmsnorm:        v = x
//   rmsnorm_add:    v = x + r (fp32);                     sum = v rounded
//   rmsnorm_gated:  v = c(c(y + D[col / head_dim] x) * c(silu(z)))
//   then            out = v * rsqrt(mean(v^2) + eps) * (1 + gamma)
//
// over the rows of a (rows, D) input: mean-square and scaling in fp32, out
// (and sum) rounded once to the compute type T.  c() rounds to T: the gated
// prologue reproduces the three eager ops of the plain path (the fp32 skip
// rounded to T, silu rounded to T, their product rounded to T), with the
// skip's multiply and add kept apart (no FMA contraction), as the plain
// path computes them.  rmsnorm_add normalises the unrounded fp32 sum (as
// the TPU kernel does), so in bf16 its normed output differs from "round
// x + r to bf16, then normalise" by at most a bf16 rounding, while its sum
// output is bitwise that rounding.
//
// What bounds it on the H100.  A few operations per element against 4-14
// bytes moved: far below the card's balance point, so the bound is bytes
// at 3.35 TB/s.  On the serving path the rows are (512, 2048) or
// (512, 4096) per prefill and (8, 2048) or (8, 4096) per decode step: a
// few MB at most, so a call is one DRAM latency and a reduction deep, and
// an 8-row decode call is that latency and nothing else.
//
// Design.  One template for the three prologues.
// - Every input row is read from device memory once, 16 bytes a load where
//   the row is 16-byte aligned (else element by element; a width that is
//   not a multiple of the vector runs its last partial vector element by
//   element).  gamma (and D) are loaded in the same pass, before the
//   reduction, so the call has one dependent memory round trip.  The
//   prologue's values stay in registers (at most 32 fp32 a thread) until
//   the scaled output is written: no second pass over memory.
// - Threads map to rows from the shape: the wrapper (ops.py, plan) picks
//   the fewest threads per row that keep a thread at 32 values, then more
//   while the grid holds fewer than eight warps an SM and each thread still
//   has a vector, and passes threads per row and vectors per thread; the
//   launcher checks that they cover the row.  A decode call (8 rows)
//   spreads each row over a whole block; a prefill (512 rows) packs two to
//   eight rows a block.  A row of at most 32 threads reduces by warp
//   shuffles alone, a wider one through one shared-memory exchange.
// - Inputs are read through a row stride each (inner stride 1), so the
//   Mamba2 block's x and z, views into its projections, need no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;                  // a block (ops.THREADS)
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_VALUES = 32;                 // fp32 values a thread holds
enum Mode { PLAIN = 0, ADD = 1, GATED = 2 };

struct Params {
  const void* a;        // x (plain, add) or y (gated)
  const void* b;        // r (add) or z (gated)
  const void* c;        // x of the gated form's skip, or null
  long long sa, sb, sc; // row strides, elements
  const void* gamma;    // (D,)
  const void* dskip;    // (D / head_dim,), with c
  void* out;            // (rows, D) contiguous, T
  void* sum;            // (rows, D) contiguous, T (add)
  long long rows;
  int D, head_dim, tpr; // tpr: threads per row, a power of two <= NTHREADS
  int a_bf16, g_bf16, d_bf16;
  float eps;
};

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// a rounding to T, as the plain path's eager op in T would round
template <typename T> __device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16(x));
  return x;
}

__device__ __forceinline__ float ld1(const void* p, bool bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// VEC consecutive elements from element i of p (aligned to VEC elements)
template <int VEC>
__device__ __forceinline__ void ldv(const void* p, bool bf16, long long i, float* f) {
  if (bf16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + i;
    if constexpr (VEC == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(q));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) f[2 * k] = bf_lo(w[k]), f[2 * k + 1] = bf_hi(w[k]);
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(q));
      f[0] = bf_lo(u.x), f[1] = bf_hi(u.x), f[2] = bf_lo(u.y), f[3] = bf_hi(u.y);
    }
  } else {
    const float* q = static_cast<const float*>(p) + i;
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(q + k));
      f[k] = u.x, f[k + 1] = u.y, f[k + 2] = u.z, f[k + 3] = u.w;
    }
  }
}

// VEC elements of T to p (16 bytes, aligned)
template <typename T, int VEC>
__device__ __forceinline__ void stv(T* p, const float* f) {
  if constexpr (sizeof(T) == 2) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (uintptr_t)(bytes - 1)) == 0;
}

__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }

template <typename T, int MODE, int NV>
__global__ void __launch_bounds__(NTHREADS) rmsnorm_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(T);          // elements of T in 16 bytes
  constexpr int TS = sizeof(T);
  static_assert(NV * VEC <= MAX_VALUES, "a thread holds at most MAX_VALUES values");
  __shared__ float partial[NWARPS];

  const int tpr = p.tpr, D = p.D;
  const int t = threadIdx.x % tpr;             // this thread's place in its row
  const long long row = (long long)blockIdx.x * (NTHREADS / tpr) + threadIdx.x / tpr;
  const bool live = row < p.rows;
  const long long r = live ? row : 0;

  const bool abf = MODE == GATED ? p.a_bf16 : TS == 2;
  const int as = abf ? 2 : 4, gs = p.g_bf16 ? 2 : 4;
  const char* arow = static_cast<const char*>(p.a) + r * p.sa * as;
  const char* brow = MODE != PLAIN ? static_cast<const char*>(p.b) + r * p.sb * TS : nullptr;
  const bool skip = MODE == GATED && p.c != nullptr;
  const char* crow = skip ? static_cast<const char*>(p.c) + r * p.sc * TS : nullptr;
  T* orow = static_cast<T*>(p.out) + r * D;
  T* srow = MODE == ADD ? static_cast<T*>(p.sum) + r * D : nullptr;
  // a vector of fp32 y or gamma beside bf16 rows is two 16-byte loads, one
  // of bf16 gamma beside fp32 rows is 8 bytes
  const bool vec = aligned(arow, 16) && aligned(p.gamma, VEC * gs < 16 ? VEC * gs : 16) &&
                   aligned(orow, 16) && (MODE == PLAIN || aligned(brow, 16)) &&
                   (!skip || aligned(crow, 16)) && (MODE != ADD || aligned(srow, 16));

  // one pass over the row: the prologue's value and gamma for each slot
  float v[NV][VEC], g[NV][VEC];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int e0 = (t + k * tpr) * VEC;
    float a[VEC], b[VEC], c[VEC];
    const bool full = live && vec && e0 + VEC <= D;
    if (full) {
      ldv<VEC>(arow, abf, e0, a);
      ldv<VEC>(p.gamma, p.g_bf16, e0, g[k]);
      if (MODE != PLAIN) ldv<VEC>(brow, TS == 2, e0, b);
      if (skip) ldv<VEC>(crow, TS == 2, e0, c);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const bool in = live && e0 + e < D;
        a[e] = in ? ld1(arow, abf, e0 + e) : 0.f;
        g[k][e] = in ? ld1(p.gamma, p.g_bf16, e0 + e) : 0.f;
        b[e] = in && MODE != PLAIN ? ld1(brow, TS == 2, e0 + e) : 0.f;
        c[e] = in && skip ? ld1(crow, TS == 2, e0 + e) : 0.f;
      }
    }
    float d[VEC];
    if (skip) {
      // D per element, one head lookup for a vector inside one head
      const int h0 = e0 / p.head_dim;
      const bool one_head = e0 - h0 * p.head_dim + VEC <= p.head_dim;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int h = one_head ? h0 : (e0 + e) / p.head_dim;
        d[e] = live && e0 + e < D ? ld1(p.dskip, p.d_bf16, h) : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float x = a[e];
      if constexpr (MODE == ADD) x = __fadd_rn(a[e], b[e]);
      if constexpr (MODE == GATED) {
        const float s = skip ? __fadd_rn(a[e], __fmul_rn(d[e], c[e])) : a[e];
        x = round_to<T>(__fmul_rn(round_to<T>(s), round_to<T>(silu(b[e]))));
      }
      v[k][e] = x;
      ss += x * x;
    }
    if constexpr (MODE == ADD) {
      if (full) {
        stv<T, VEC>(srow + e0, v[k]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (live && e0 + e < D) srow[e0 + e] = from_f<T>(v[k][e]);
      }
    }
  }

  // the row's sum of squares over its tpr threads
  if (tpr <= 32) {
    for (int off = tpr / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  } else {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
    __syncthreads();
    const int w0 = threadIdx.x / tpr * (tpr / 32);
    ss = 0.f;
    for (int w = 0; w < tpr / 32; ++w) ss += partial[w0 + w];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / (float)D + p.eps);

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int e0 = (t + k * tpr) * VEC;
    float o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o[e] = __fmul_rn(__fmul_rn(v[k][e], inv), __fadd_rn(1.f, g[k][e]));
    if (vec && e0 + VEC <= D) {
      stv<T, VEC>(orow + e0, o);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (e0 + e < D) orow[e0 + e] = from_f<T>(o[e]);
    }
  }
}

// nv vectors per thread over p.tpr threads per row: refused unless tpr is
// a power of two of at most a block and the threads cover the row
template <typename T, int MODE>
int launch(Params p, int nv, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int tpr = p.tpr;
  if (p.D <= 0 || tpr <= 0 || tpr > NTHREADS || (tpr & (tpr - 1)) ||
      (long long)tpr * nv * VEC < p.D)
    return (int)cudaErrorInvalidValue;
  const long long rpb = NTHREADS / tpr;
  const dim3 grid((unsigned)((p.rows + rpb - 1) / rpb));
  switch (nv) {
    case 1: rmsnorm_kernel<T, MODE, 1><<<grid, NTHREADS, 0, s>>>(p); break;
    case 2: rmsnorm_kernel<T, MODE, 2><<<grid, NTHREADS, 0, s>>>(p); break;
    case 4: rmsnorm_kernel<T, MODE, 4><<<grid, NTHREADS, 0, s>>>(p); break;
    case 8:
      if constexpr (sizeof(T) == 4) {
        rmsnorm_kernel<T, MODE, 8><<<grid, NTHREADS, 0, s>>>(p);
        break;
      }
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype codes: 0 = fp32, 1 = bf16; t_dtype is the compute (output) type
template <int MODE>
int dispatch(Params p, int t_dtype, int nv, void* stream) {
  if (p.rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_dtype == 0) return launch<float, MODE>(p, nv, s);
  if (t_dtype == 1) return launch<__nv_bfloat16, MODE>(p, nv, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every entry takes the thread mapping as tpr threads per row and nv
// vectors of 16 bytes per thread (ops.plan), launches on `stream` and
// returns cudaGetLastError() (0 = launched).

// x: (rows, D) at row stride sx (inner stride 1); out: (rows, D) contiguous
// of x's type; gamma: (D,) contiguous.
extern "C" int rmsnorm_fwd(const void* x, long long sx, const void* gamma, void* out,
                           int x_dtype, int g_dtype, long long rows, int D, float eps,
                           int tpr, int nv, void* stream) {
  Params p{x, nullptr, nullptr, sx, 0, 0, gamma, nullptr, out, nullptr, rows, D, 1, tpr,
           x_dtype, g_dtype, 0, eps};
  return dispatch<PLAIN>(p, x_dtype, nv, stream);
}

// x, r: (rows, D) at row strides sx, sr; out, sum: (rows, D) contiguous.
extern "C" int rmsnorm_add_fwd(const void* x, long long sx, const void* r, long long sr,
                               const void* gamma, void* out, void* sum, int x_dtype,
                               int g_dtype, long long rows, int D, float eps, int tpr, int nv,
                               void* stream) {
  Params p{x, r, nullptr, sx, sr, 0, gamma, nullptr, out, sum, rows, D, 1, tpr,
           x_dtype, g_dtype, 0, eps};
  return dispatch<ADD>(p, x_dtype, nv, stream);
}

// y: (rows, D) fp32 or z's type at row stride sy; z, x: (rows, D) of the
// compute type at strides sz, sx (x null: no skip); dskip: (D / head_dim,);
// out: (rows, D) contiguous of z's type.
extern "C" int rmsnorm_gated_fwd(const void* y, long long sy, const void* z, long long sz,
                                 const void* x, long long sx, const void* gamma,
                                 const void* dskip, void* out, int y_dtype, int z_dtype,
                                 int g_dtype, int d_dtype, long long rows, int D,
                                 int head_dim, float eps, int tpr, int nv, void* stream) {
  if (x != nullptr && head_dim <= 0) return (int)cudaErrorInvalidValue;
  Params p{y, z, x, sy, sz, sx, gamma, dskip, out, nullptr, rows, D, head_dim > 0 ? head_dim : 1,
           tpr, y_dtype, g_dtype, d_dtype, eps};
  return dispatch<GATED>(p, z_dtype, nv, stream);
}
