// Paged decode attention for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/kernel.py
// (_paged_kernel, entry paged_attention_fwd): one decode step per (lane,
// KV head) against the block-table KV cache.  A lane attends positions
// [0, length] (and, with a window, only those > length - window) through
// its min(length // bs + 1, nb) table-mapped blocks, with the softcap and
// an fp32 softmax.
//
// Layout: q and o are (B, Hk, rep, D); the pools (NB, bs, Hk, D); lengths
// (B,) and tables (B, nb) int32.  Inputs are bf16 or fp32; accumulation is
// fp32.  Head dims 64, 128 and 160 (one template instantiation each), rep
// up to 16 (gemma2-27b's decode has rep 2 at D 128, deepseek-67b's and
// qwen3-moe-30b's rep 8, qwen3-moe-235b's rep 16; stablelm-12b's rep 4 at
// D 160).
//
// What bounds it on the H100.  A decode step does ~4 FLOPs per KV byte it
// reads, two orders of magnitude below the card's ~295 FLOP/byte balance
// point: the bound is the bytes of the attended K/V at 3.35 TB/s, and at
// the serving shape (8 lanes, 5 KV heads, up to 1024 positions) those are a
// few MB, so the kernel lives on how many loads it keeps in flight and on
// how short its longest chain of dependent work is.
//
// Design (split lanes, two device kernels per call).
//   * paged_split_kernel, grid (B, Hk, n_split): split s of a lane holds
//     table blocks [s * bps, (s + 1) * bps), bps * bs <= 64 positions.
//     n_split = ceil(nb / bps) comes from the table's width, a shape, never
//     from the values of `lengths`: the grid is the same every step and the
//     call makes no host sync.  A split that begins past its lane's length,
//     or lies wholly below the window, returns at once.  A live split issues
//     cp.async 16-byte copies of all its K and V rows (2 D contiguous bytes
//     per position and head in bf16) before it computes, so every load of
//     the split is in flight together; they land in dynamic shared memory
//     (2 x 64 positions x D elements: 16-80 KB, then q and the scores),
//     rows swizzled (chunk c of position p at c ^ (p % 8) within its group
//     of 8 chunks; a bf16 row at D 160 is 20 chunks, and its last 4 swizzle
//     as c ^ (p % 4)), so the score pass, one position per thread, reads
//     shared memory with few bank conflicts.  It computes the
//     rep scores per position in fp32, its softmax partial (m, l, acc) over
//     its positions, and writes the partial to fp32 scratch shaped (B, Hk,
//     n_split, rep[, D]).  Masked positions get weight 0, so a split whose
//     keys are all masked writes m = NEG_INF, l = 0.
//   * paged_combine_kernel, grid (B, Hk), one thread per output element
//     up to rep * D = 1024, else EPT = 2 or 4 elements a thread (rep * D /
//     EPT threads), each merged in the same order: works out the lane's
//     live splits from lengths[b] and the window
//     itself (splits no CTA wrote are never read), merges them by
//     log-sum-exp with weight 0 for l = 0, and writes o in q's dtype.
// Stale lanes (table rows nulled to the sink block 0) read block 0; the
// engine discards their output.  At the serving shape (nb 64 of 16
// positions, bps 4) that is 640 split CTAs, where the first kernel had 40.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NTHREADS = 128;
constexpr int MAX_REP = 16;            // query heads per KV head
constexpr int MAX_BS = 32;             // positions per table block
constexpr int SPLIT_POS = 64;          // positions a split holds at most

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// E floats from one 16-byte chunk of shared memory
__device__ __forceinline__ void chunk_f(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void chunk_f(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ float2 pair_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
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

// The table blocks [lo, hi) a lane attends: positions [0, length] are
// length // bs + 1 blocks; a window also skips the blocks wholly below it.
__device__ __forceinline__ void lane_blocks(int length, int bs, int nb, int window,
                                            int& lo, int& hi) {
  hi = min(length / bs + 1, nb);
  lo = window > 0 ? max((length - window + 1) / bs, 0) : 0;
}

// Chunk c of position p's row after the swizzle: c ^ (p % 8) within whole
// groups of 8 chunks, c ^ (p % 4) in a last group of 4 (D 160 in bf16).
template <int CPR>
__device__ __forceinline__ int swizzle(int c, int p) {
  constexpr int WHOLE = CPR & ~7;
  static_assert(CPR >= 8 && (CPR - WHOLE == 0 || CPR - WHOLE == 4),
                "rows of whole groups of 8 chunks, then at most one group of 4");
  return (WHOLE == CPR || c < WHOLE) ? c ^ (p & 7) : c ^ (p & 3);
}

// Dynamic shared memory of a split: K and V of SPLIT_POS positions, q in
// fp32 and the scores
template <typename T, int D> constexpr int split_smem(int rep) {
  return 2 * SPLIT_POS * D * (int)sizeof(T) + rep * D * 4 + rep * SPLIT_POS * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                   const T* __restrict__ vpool, const int* __restrict__ lengths,
                   const int* __restrict__ tables, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc, int Hk,
                   int rep, int bs, int nb, int bps, int n_split, int window,
                   float softcap, float scale) {
  constexpr int E = 16 / sizeof(T);    // elements per 16-byte chunk
  constexpr int CPR = D / E;           // chunks per row (8-20 bf16, 16-40 fp32)
  constexpr int DP = D / 2;            // dim pairs: P.V work items per rep
  extern __shared__ __align__(16) unsigned char kv_smem[];
  T* ks = reinterpret_cast<T*>(kv_smem);          // SPLIT_POS * D
  T* vs = ks + SPLIT_POS * D;                      // SPLIT_POS * D
  float* qs = reinterpret_cast<float*>(vs + SPLIT_POS * D);   // rep * D
  float* ps = qs + rep * D;                        // rep * SPLIT_POS: (rep, position)

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int length = lengths[b];
  int lo, hi;
  lane_blocks(length, bs, nb, window, lo, hi);
  const int j0 = max(s * bps, lo), j1 = min((s + 1) * bps, hi);
  if (j0 >= j1) return;                // nothing of this lane in the split
  const int tid = threadIdx.x;
  const int p0 = (j0 - s * bps) * bs, p1 = (j1 - s * bps) * bs;   // positions held
  const int* row = tables + (long)b * nb;

  // every K and V chunk of the split in flight at once
  for (int e = tid; e < (p1 - p0) * CPR; e += NTHREADS) {
    const int p = p0 + e / CPR, c = e % CPR;
    const long src = (((long)row[s * bps + p / bs] * bs + p % bs) * Hk + h) * D + c * E;
    const int dst = p * D + swizzle<CPR>(c, p) * E;
    cp_async16(&ks[dst], kpool + src);
    cp_async16(&vs[dst], vpool + src);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const long q_base = ((long)b * Hk + h) * rep * D;
  for (int e = tid; e < rep * D; e += NTHREADS) qs[e] = to_f(q[q_base + e]);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // scores: thread (position p, rep group g) takes reps g, g + 2, ... <
  // rep; the rep test is warp-uniform and outside the dot products
  {
    const int p = tid % SPLIT_POS, g = tid / SPLIT_POS;
    const bool held = p >= p0 && p < p1;
    const int pos = s * bps * bs + p;
    bool ok = held && pos <= length;
    if (window > 0) ok = ok && pos > length - window;
    const T* krow = &ks[p * D];
    for (int r = g; r < rep; r += 2) {
      float dot = 0.f;
      if (held) {
#pragma unroll
        for (int c = 0; c < CPR; ++c) {
          float kf[E];
          chunk_f(&krow[swizzle<CPR>(c, p) * E], kf);
#pragma unroll
          for (int x = 0; x < E; ++x) dot += qs[r * D + c * E + x] * kf[x];
        }
      }
      float sc = dot * scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      ps[r * SPLIT_POS + p] = ok ? sc : NEG_INF;
    }
  }
  __syncthreads();

  // softmax partial per rep: warp w takes reps w, w + 4
  const int warp = tid / 32, lane = tid % 32;
  const long part = ((long)(b * Hk + h) * n_split + s) * rep;
  for (int r = warp; r < rep; r += NTHREADS / 32) {
    float* pr = ps + r * SPLIT_POS;
    const float a = pr[lane], c = pr[lane + 32];
    const float mr = warp_max(fmaxf(a, c));
    const float pa = a > NEG_INF ? expf(a - mr) : 0.f;
    const float pc = c > NEG_INF ? expf(c - mr) : 0.f;
    pr[lane] = pa;
    pr[lane + 32] = pc;
    const float lr = warp_sum(pa + pc);
    if (lane == 0) {
      part_m[part + r] = mr;
      part_l[part + r] = lr;
    }
  }
  __syncthreads();

  // P.V: work item e = (rep r, dim pair 2dp, 2dp + 1), e = r * DP + dp,
  // thread tid takes items tid, tid + NTHREADS, ... (at D 64 and 128 that
  // is dim pair tid % DP of reps tid / DP, + NTHREADS / DP, ...)
  for (int e = tid; e < rep * DP; e += NTHREADS) {
    const int r = e / DP, d = 2 * (e % DP);
    const int c = d / E, x = d % E;
    const float* pr = ps + r * SPLIT_POS;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int p = p0; p < p1; ++p) {
      const float2 vv = pair_f(&vs[p * D + swizzle<CPR>(c, p) * E + x]);
      const float w = pr[p];
      a0 += w * vv.x;
      a1 += w * vv.y;
    }
    *reinterpret_cast<float2*>(&part_acc[(part + r) * D + d]) = make_float2(a0, a1);
  }
}

// Output element tid + u * blockDim.x (u < EPT) of the lane's rep * D, with
// rep * D / EPT <= 1024 threads: one element a thread (EPT 1) up to rep * D
// = 1024, two or four past it.  The live splits' m and l are staged in
// shared memory SB splits at a time (all the loads in flight together) and
// merged online across batches; each element's merge is the same sequence
// of operations whatever EPT is.
template <typename T, int D, int EPT>
__global__ void __launch_bounds__(1024)
paged_combine_kernel(const int* __restrict__ lengths, const float* __restrict__ part_m,
                     const float* __restrict__ part_l, const float* __restrict__ part_acc,
                     T* __restrict__ o, int Hk, int rep, int bs, int nb, int bps,
                     int n_split, int window) {
  constexpr int SB = D;                // splits staged at once
  __shared__ float sm[SB * MAX_REP], sl[SB * MAX_REP];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  int lo, hi;
  lane_blocks(lengths[b], bs, nb, window, lo, hi);
  // the splits the split kernel wrote: those that meet [lo, hi)
  const int s0 = lo / bps, s1 = hi > lo ? (hi - 1) / bps + 1 : s0;
  const long part = (long)(b * Hk + h) * n_split;
  float mg[EPT], lg[EPT], og[EPT];
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    mg[u] = NEG_INF;
    lg[u] = 0.f;
    og[u] = 0.f;
  }
  for (int sb = s0; sb < s1; sb += SB) {
    const int n = min(SB, s1 - sb);
    __syncthreads();                   // the previous batch is read
    for (int i = tid; i < n * rep; i += nt) {
      sm[i] = part_m[(part + sb) * rep + i];
      sl[i] = part_l[(part + sb) * rep + i];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int r = (tid + u * nt) / D, d = (tid + u * nt) % D;
      float bm = NEG_INF;
      for (int s = 0; s < n; ++s)
        if (sl[s * rep + r] > 0.f) bm = fmaxf(bm, sm[s * rep + r]);
      const float m_new = fmaxf(mg[u], bm);
      const float alpha = expf(mg[u] - m_new);
      lg[u] *= alpha;
      og[u] *= alpha;
      mg[u] = m_new;
      const float* acc = part_acc + ((part + sb) * rep + r) * D + d;
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        const float l = sl[s * rep + r];
        const float w = l > 0.f ? expf(sm[s * rep + r] - m_new) : 0.f;
        lg[u] += l * w;
        og[u] += acc[(long)s * rep * D] * w;   // written by every live split
      }
    }
  }
#pragma unroll
  for (int u = 0; u < EPT; ++u)
    o[((long)b * Hk + h) * rep * D + tid + u * nt] = from_f<T>(og[u] / fmaxf(lg[u], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* lengths,
           const int* tables, void* o, float* scratch, int B, int Hk, int rep, int bs,
           int nb, int bps, int n_split, int window, float softcap, float scale,
           cudaStream_t stream) {
  if (Hk > 65535 || n_split > 65535) return (int)cudaErrorInvalidValue;
  static bool smem_set[64] = {};       // once per process, device and instantiation
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(paged_split_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               split_smem<T, D>(MAX_REP));
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  const long n = (long)B * Hk * n_split * rep;
  float* part_m = scratch;
  float* part_l = scratch + n;
  float* part_acc = scratch + 2 * n;
  const int smem = split_smem<T, D>(rep);
  paged_split_kernel<T, D><<<dim3(B, Hk, n_split), NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      lengths, tables, part_m, part_l, part_acc, Hk, rep, bs, nb, bps, n_split, window,
      softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int elems = rep * D;
#define COMBINE(EPT)                                                                         \
  paged_combine_kernel<T, D, EPT><<<dim3(B, Hk), elems / EPT, 0, stream>>>(                  \
      lengths, part_m, part_l, part_acc, static_cast<T*>(o), Hk, rep, bs, nb, bps, n_split,  \
      window)
  if (elems <= 1024)
    COMBINE(1);
  else if (elems <= 2048)
    COMBINE(2);
  else
    COMBINE(4);
#undef COMBINE
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point.  dtype: 0 = float32, 1 = bfloat16; head dim 64, 128 or 160,
// the ones the ported configs use, and rep up to 16.  `scratch` holds B * Hk
// * n_split * rep * (D + 2) floats: the splits' m, then l, then acc.  Two device kernels per call
// (split, combine).  Returns the launches' cudaGetLastError() (0 =
// launched).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const int* lengths,
                                   const int* tables, void* o, float* scratch,
                                   int dtype, int B, int Hk, int rep, int D, int bs,
                                   int nb, int bps, int n_split, int window,
                                   float softcap, float scale, void* stream) {
  if ((D != 64 && D != 128 && D != 160) || rep < 1 || rep > MAX_REP || bs < 1 || bs > MAX_BS
      || nb < 1 || bps < 1 || bps * bs > SPLIT_POS || n_split != (nb + bps - 1) / bps)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_LAUNCH(T, DD)                                                                  \
  launch<T, DD>(q, k_pool, v_pool, lengths, tables, o, scratch, B, Hk, rep, bs, nb, bps,     \
                n_split, window, softcap, scale, st)
  if (dtype == 0)
    return D == 64    ? PAGED_LAUNCH(float, 64)
           : D == 128 ? PAGED_LAUNCH(float, 128)
                      : PAGED_LAUNCH(float, 160);
  if (dtype == 1)
    return D == 64    ? PAGED_LAUNCH(__nv_bfloat16, 64)
           : D == 128 ? PAGED_LAUNCH(__nv_bfloat16, 128)
                      : PAGED_LAUNCH(__nv_bfloat16, 160);
#undef PAGED_LAUNCH
  return (int)cudaErrorInvalidValue;
}
