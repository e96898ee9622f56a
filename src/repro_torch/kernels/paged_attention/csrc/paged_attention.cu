// Paged decode attention for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/kernel.py
// (_paged_kernel, entry paged_attention_fwd): one decode step per (lane,
// KV head) against the block-table KV cache.  It walks the lane's
// min(length // bs + 1, nb) table-mapped blocks, masks pos <= length and
// the window, applies the softcap, and keeps an fp32 online softmax.
//
// Layout: q and o are (B, Hk, rep, D); the pools (NB, bs, Hk, D); lengths
// (B,) and tables (B, nb) int32.  Inputs are bf16 or fp32; accumulation is
// fp32.
//
// Design.  One block per (lane, KV head) with four warps.  The block reads
// lengths[b] and its table row itself (the TPU kernel's scalar prefetch).
// Unlike the Pallas version, which stages the whole pool for its head in
// VMEM, the pool stays in HBM: warp w walks table blocks lo+w, lo+w+4, ...,
// and loads each (bs, D) K/V block of its head straight from the pool into
// its own shared-memory slice (padded rows: conflict-free), so a lane reads
// exactly the blocks it attends, once.  Each warp keeps its own online
// softmax (m, l, acc) for the rep queries (lane = key for the scores,
// lane = dimension for P.V); the four warps' states are combined with a
// log-sum-exp rescale at the end.  Stale lanes whose table rows are nulled
// read the sink block 0; the engine discards their output.
//
// What bounds it on the H100.  A decode step does ~4 FLOPs per KV byte it
// reads, two orders of magnitude below the card's ~295 FLOP/byte balance
// point: the bound is the bytes of the attended K/V at 3.35 TB/s.  This
// first kernel keeps every byte read exactly once, but with max_slots x Hk
// blocks (40 at the serving shape) it occupies under a third of the 132
// SMs and each warp waits on one block's load at a time, so it reaches a
// small fraction of the memory rate.  Splitting long lanes across blocks
// (flash-decoding) and keeping several block loads in flight (cp.async/TMA)
// are the later PR that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_REP = 8;             // query heads per KV head
constexpr int MAX_BS = 32;             // block size: one key per lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// shared memory, in floats: q (rep*D) | per warp K (bs*(D+1)) + V (bs*D) |
// per-warp softmax state m, l (NWARPS*rep each) and acc (NWARPS*rep*D)
__host__ __device__ inline long smem_floats(int rep, int bs, int D) {
  return (long)rep * D + (long)NWARPS * bs * (2 * D + 1) + 2L * NWARPS * rep
       + (long)NWARPS * rep * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ o, int Hk,
                    int rep, int bs, int nb, int window, float softcap,
                    float scale) {
  constexpr int DPL = (D + 31) / 32;   // P.V dims per lane
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float* qs = smem;
  float* kw = qs + rep * D + (long)warp * bs * (2 * D + 1);
  float* vw = kw + bs * (D + 1);
  float* cm = qs + rep * D + (long)NWARPS * bs * (2 * D + 1);
  float* cl = cm + NWARPS * rep;
  float* cacc = cl + NWARPS * rep;

  const long q_base = ((long)b * Hk + h) * rep * D;
  for (int e = threadIdx.x; e < rep * D; e += NTHREADS) qs[e] = to_f(q[q_base + e]);
  __syncthreads();

  // positions [0, length] -> length // bs + 1 blocks; a window also skips
  // the blocks wholly below it
  const int length = lengths[b];
  const int hi = min(length / bs + 1, nb);
  const int lo = window > 0 ? max((length - window + 1) / bs, 0) : 0;
  const int* row = tables + (long)b * nb;

  float m[MAX_REP], l[MAX_REP], acc[MAX_REP][DPL], p[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
    p[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int j = lo + warp; j < hi; j += NWARPS) {
    const long blk = row[j];
    for (int e = lane; e < bs * D; e += 32) {
      const int r = e / D, c = e % D;
      const long off = ((blk * bs + r) * Hk + h) * D + c;
      kw[r * (D + 1) + c] = to_f(kpool[off]);
      vw[r * D + c] = to_f(vpool[off]);
    }
    __syncwarp();

    const int pos = j * bs + lane;
    bool ok = lane < bs && pos <= length;
    if (window > 0) ok = ok && pos > length - window;
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r < rep) {
        float sc = NEG_INF;
        if (lane < bs) {
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += qs[r * D + d] * kw[lane * (D + 1) + d];
          sc = dot * scale;
          if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
          if (!ok) sc = NEG_INF;
        }
        const float m_new = fmaxf(m[r], warp_max(sc));
        const float pr = lane < bs ? expf(sc - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(pr);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
        m[r] = m_new;
        p[r] = pr;
      }
    }
    for (int kk = 0; kk < bs; ++kk) {
      float vrow[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vrow[i] = d < D ? vw[kk * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r < rep) {
          const float pk = __shfl_sync(0xffffffffu, p[r], kk);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] += pk * vrow[i];
        }
      }
    }
    __syncwarp();                      // the slice is free for the next block
  }

#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r < rep) {
      if (lane == 0) {
        cm[warp * rep + r] = m[r];
        cl[warp * rep + r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) cacc[((long)warp * rep + r) * D + d] = acc[r][i];
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < rep * D; e += NTHREADS) {
    const int r = e / D, d = e % D;
    float mg = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mg = fmaxf(mg, cm[w * rep + r]);
    float lg = 0.f, og = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float c = expf(cm[w * rep + r] - mg);
      lg += cl[w * rep + r] * c;
      og += cacc[((long)w * rep + r) * D + d] * c;
    }
    o[q_base + e] = from_f<T>(og / fmaxf(lg, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* lengths,
           const int* tables, void* o, int B, int Hk, int rep, int bs, int nb,
           int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(rep, bs, D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B, Hk);
  paged_decode_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), lengths, tables, static_cast<T*>(o), Hk, rep,
      bs, nb, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const int* lengths,
             const int* tables, void* o, int B, int Hk, int rep, int D, int bs,
             int nb, int window, float softcap, float scale,
             cudaStream_t stream) {
  // head dim 64 only, the one the ported configs use; other head dims are
  // instantiated with the family that needs them
  if (D != 64) return (int)cudaErrorInvalidValue;
  return launch<T, 64>(q, kp, vp, lengths, tables, o, B, Hk, rep, bs, nb, window, softcap, scale, stream);
}

}  // namespace

// C entry point.  dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaGetLastError() (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const int* lengths,
                                   const int* tables, void* o, int dtype,
                                   int B, int Hk, int rep, int D, int bs,
                                   int nb, int window, float softcap,
                                   float scale, void* stream) {
  if (rep < 1 || rep > MAX_REP || bs < 1 || bs > MAX_BS || nb < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k_pool, v_pool, lengths, tables, o, B, Hk, rep, D, bs, nb, window, softcap, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k_pool, v_pool, lengths, tables, o, B, Hk, rep, D, bs, nb, window, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}
