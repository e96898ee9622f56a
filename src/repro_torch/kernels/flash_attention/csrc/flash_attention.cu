// Flash attention forward for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fwd_kernel, entry flash_attention_fwd): blocked attention with an fp32
// online softmax, scale D**-0.5, GQA (q-head h reads KV head h / rep),
// causal or not, a sliding window, a logit softcap, KV tiles outside
// [lo, hi) skipped, NEG_INF = -2e38 and max(l, 1e-30) as the reference.
//
// Layout: the model layout the wrapper is called with -- q and o are
// (B, Sq, H, D), k and v (B, Sk, Hk, D), all contiguous -- so no transpose
// is ever materialised.  Inputs are bf16 or fp32; accumulation is fp32.
//
// Head dims: 64 (smollm, zamba) and 128 (gemma2, deepseek), one template
// instantiation each.
//
// What bounds it on the H100.  At the serving path's prefill shapes
// (S <= 1024, D = 64, 15 heads) the attention moves a few MB and does a
// few GFLOP: the roofline bound is ~1-2 us, on bytes below S ~ 700 and on
// bf16 tensor-core operations (989 TFLOP/s) above.  What a kernel loses
// against that is latency: a q tile walks up to S/64 KV tiles in turn.
// gemma2-27b's long prefills (S 8192, 32 heads, D 128) do ~1 TFLOP of
// attention (half of it under the local layers' window) and are bound by
// operations.
//
// bf16 design (tensor cores).  One CTA of one warpgroup (128 threads) per
// (64-row q tile, q-head, batch); grid (H, B, q tiles) with the q tile
// reversed, so that the longest tiles (most KV tiles under causality) of
// every head start first and the tail is short.
//   * Both products are wgmma.mma_async m64n64k16, bf16 in, fp32
//     accumulate.  A 64-row tile is D / 64 panels of 64 columns, 8 KB
//     each: rows of 64 bf16 = 128 bytes under the 128-byte swizzle
//     (16-byte chunk c of row r at chunk c ^ (r % 8)), the layout the
//     wgmma descriptor's B128 mode reads.  S = Q.K^T: Q (loaded once) and
//     K are K-major; k16 step kk over D starts in panel kk / 4, 32 * (kk %
//     4) bytes along its rows.  O += P.V: P comes from registers as the A
//     operand -- the fp32 accumulator fragment of S is, element for
//     element, the A fragment of P -- and V is the B operand in the
//     transposed (MN-major) form, read from the same swizzled panels (the
//     four k16 steps over keys advance the start by 16 rows).  Each panel
//     of V is one swizzle atom wide in N, so a k16 step is one m64n64k16
//     product per panel into that panel's 32 accumulators: D = 128 holds
//     64 fp32 of O a thread and issues 16 P.V products a tile.
//   * P is split into two bf16 terms, hi = bf16(p) and lo = bf16(p - hi),
//     and both are multiplied into O (8 wgmmas per tile instead of 4), so
//     P.V carries ~16 bits of P, not 8.  With one bf16 rounding of P the
//     output moves by up to 2**-8 of max|v| wherever few keys dominate,
//     which the card's bf16 gate (1e-3 + 1e-2 of the value) does not
//     allow where such outputs cancel towards 0.  The extra products cost
//     little: at these shapes the kernel is bound by latency.
//   * The next tile's S = Q.K^T is issued before this tile's softmax, so
//     the tensor cores compute it while the ALUs run the softmax.
//   * The online softmax (m, l, the rescale of O) stays in fp32 registers,
//     in the log2 domain (scores scaled by scale * log2(e) once, one ex2
//     MUFU op per score); each thread holds two rows, reduced across its
//     quad by shuffles.
//   * K/V tiles of 64 keys arrive by cp.async 16-byte copies into a
//     3-stage shared-memory ring (dynamic: Q and the ring are 56 KB at D
//     64, 112 KB at D 128): tile j+1 has landed when
//     tile j's softmax starts (its Q.K^T is issued then), and tile j+2's
//     copy flies during tile j.  Ragged Sq/Sk edges are zero-filled copies
//     (src-size 0) plus the masks; only edge, diagonal and window-edge
//     tiles are masked.

// fp32 design.  The fp32 gates (3e-5, TF32 off) need true fp32 products,
// which the tensor cores do not take, so fp32 inputs keep the first
// kernel: one block per (q-tile of 32 rows, q-head, batch), four threads
// per query row, K/V tiles of 32 keys staged in shared memory as fp32 and
// dot products on the FMA pipes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;

// ---------------------------------------------------------------------------
// fp32: FMA pipes
// ---------------------------------------------------------------------------

namespace simt {

constexpr int TPR = 4;                 // threads per query row
constexpr int BQ = 32;                 // query rows per block
constexpr int BK = 32;                 // keys per KV tile
constexpr int NTHREADS = BQ * TPR;     // 128

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
      qr[4 * i + c] = row_ok ? q[q_row + d] : 0.f;
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
        kx = k[off];
        vx = v[off];
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
        o[q_row + d] = acc[4 * i + c] / denom;
      }
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B, int H,
           int Hk, int Sq, int Sk, int causal, int window, float softcap,
           float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, 0, stream>>>(q, k, v, o, H, Hk, Sq, Sk, causal,
                                                      window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: wgmma tensor cores, cp.async ring
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int BM = 64;                 // query rows per CTA (one warpgroup)
constexpr int BN = 64;                 // keys per KV tile
constexpr int NTHREADS = 128;
constexpr int STAGES = 3;              // depth of the K/V ring
constexpr int PANEL = 64 * 64 * 2;     // bytes of 64 rows x 64 bf16 columns: 8 KB
constexpr float LOG2E = 1.4426950408889634f;

// A tile of 64 rows at head dim D: D / 64 panels; Q | K, V per stage
template <int D> struct Tiles {
  static_assert(D % 64 == 0, "head dim must be a multiple of 64");
  static constexpr int PANELS = D / 64;
  static constexpr int TILE = PANELS * PANEL;
  static constexpr int SMEM = (1 + 2 * STAGES) * TILE;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy rows [row0, row0 + 64) of a (rows, D) matrix whose row r starts at
// base + r * stride into a swizzled tile (chunk c of a row in panel c / 8);
// rows at or past n are zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base, long stride,
                                          int row0, int n, int tid) {
  constexpr int CPR = D / 8;           // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < 64 * CPR / NTHREADS; ++i) {
    const int e = tid + i * NTHREADS;
    const int r = e / CPR, c = e % CPR;
    const bool ok = row0 + r < n;
    cp_async16(dst + (c >> 3) * PANEL + swz(r, c & 7),
               base + (ok ? (row0 + r) * stride : 0) + c * 8, ok);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle: start >> 4, leading and
// stride byte offsets >> 4, layout type 1 (B128) in bits 62-63
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo & 0x3FFF) << 16)
       | ((uint64_t)(sbo & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving register reads or writes across the
// asynchronous wgmma window.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define WG_D32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
  "+f"(d[30]), "+f"(d[31])

// d (+)= A.B, m64n64k16, A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A.B, m64n64k16, A from registers, B from shared memory MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q.K^T for one K tile: D / 16 k16 steps over D; step kk starts in
// panel kk / 4, 32 * (kk % 4) bytes along its swizzled rows.  SBO = 1024
// bytes, the stride of 8-row groups.
template <int D>
__device__ __forceinline__ void qk(float (&s)[32], uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * PANEL + 32 * (kk & 3);
    wgmma_ss(s, desc(sq + off, 1, 64), desc(sk + off, 1, 64), kk > 0);
  }
}

// O += P.V for one V tile, P as 16 registers of bf16 pairs (the accumulator
// fragment of S): four k16 steps over keys, each 16 rows (2 KB) further,
// one product per 64-column panel of V into that panel's accumulators;
// MN-major B128, 8-key groups 1024 bytes apart (N = 64 is one swizzle
// atom wide, so the MN stride is not used).
template <int P>
__device__ __forceinline__ void pv(float (&o)[P][32], const uint32_t (&p)[16], uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int pn = 0; pn < P; ++pn)
      wgmma_rs(o[pn], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               desc(sv + pn * PANEL + 2048 * kk, 64, 64));
}

// 2**x in one MUFU op; results under 2**-126 flush to 0, far below any
// softmax weight that counts against the row's maximum (weight 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The softmax runs in the log2 domain: scores are scaled by scale *
// log2(e) once, and exp(x - m) is ex2(x' - m').
//
// Accumulator fragment of m64nNk16 (f32): element i of thread (warp w, lane
// l) of a warpgroup is row 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2)
// + 2 (l % 4) + (i & 1); O's panel pn holds columns 64 pn + that column.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Hk,
                 int Sq, int Sk, int causal, int window, float softcap, float scale) {
  constexpr int P = Tiles<D>::PANELS, TILE = Tiles<D>::TILE;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;   // swizzle atoms 1024-aligned
  const uint32_t skv = sq + TILE;                // stage i: K at + 2i TILE, V at + (2i + 1) TILE
  const int tid = threadIdx.x, lane = tid & 31;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;     // longest tiles first
  const int hk = h / (H / Hk);
  const int q0 = qt * BM;
  const int row0 = q0 + (tid >> 5) * 16 + (lane >> 2);   // this thread's rows: row0, row0 + 8

  // KV tiles to visit, as kernel.py: causal skips tiles above the block's
  // last row, a causal window the tiles below its first row's band
  const int nk = (Sk + BN - 1) / BN;
  const int hi = causal ? min((q0 + BM - 1) / BN + 1, nk) : nk;
  const int lo = (causal && window) ? max((q0 - window + 1) / BN, 0) : 0;

  const long kv_stride = (long)Hk * D;
  const bf16* kb = k + ((long)b * Sk * Hk + hk) * D;
  const bf16* vb = v + ((long)b * Sk * Hk + hk) * D;
  auto kv_stage = [&](int j) { return skv + 2 * ((j - lo) % STAGES) * TILE; };
  auto copy_kv = [&](int j) {
    load_tile<D>(kv_stage(j), kb, kv_stride, j * BN, Sk, tid);
    load_tile<D>(kv_stage(j) + TILE, vb, kv_stride, j * BN, Sk, tid);
  };
  load_tile<D>(sq, q + ((long)b * Sq * H + h) * D, (long)H * D, q0, Sq, tid);
  if (lo < hi) copy_kv(lo);
  cp_async_commit();
  if (lo + 1 < hi) copy_kv(lo + 1);
  cp_async_commit();

  // sc: the scores of the tile being reduced; sn: the next tile's, whose
  // Q.K^T runs on the tensor cores while sc's softmax runs on the ALUs
  float acc[P][32], sc[32], sn[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sn[i] = 0.f;
#pragma unroll
    for (int pn = 0; pn < P; ++pn) acc[pn][i] = 0.f;
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = scale * LOG2E;
  if (lo < hi) {
    cp_async_wait<1>();                          // Q and tile lo have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    fence_regs(sn);
    wg_fence();
    qk<D>(sn, sq, kv_stage(lo));
    wg_commit();
    wg_wait0();
    fence_regs(sn);
  }

  for (int j = lo; j < hi; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = sn[i];
    cp_async_wait<0>();                          // tile j + 1 has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                             // ... for all threads, and tile j - 1 is consumed
    if (j + 2 < hi) copy_kv(j + 2);              // into tile j - 1's stage; flies during tile j
    cp_async_commit();
    if (j + 1 < hi) {
      fence_regs(sn);
      wg_fence();
      qk<D>(sn, sq, kv_stage(j + 1));
      wg_commit();
    }
    fence_regs(sc);                              // the softmax begins after that issue

    // scores to the log2 domain, masks on edge tiles only; the branches
    // are CTA-uniform and sit outside the element loops
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = softcap * tanhf(sc[i] * scale / softcap) * LOG2E;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= sl2;
    }
    const int k0 = j * BN;
    if (k0 + BN > Sk || (causal && k0 + BN - 1 > q0) || (window && k0 <= q0 + BM - 1 - window)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = row0 + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        bool ok = col < Sk;
        if (causal) ok = ok && col <= row;
        if (window) ok = ok && col > row - window;
        if (!ok) sc[i] = NEG_INF;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int r = t & 1;                       // elements 2t, 2t + 1 share a row
      const float p0 = ex2(sc[2 * t] - mx[r]);
      const float p1 = ex2(sc[2 * t + 1] - mx[r]);
      ps[r] += p0 + p1;
      const __nv_bfloat162 hi2 = __floats2bfloat162_rn(p0, p1);
      const float2 back = __bfloat1622float2(hi2);
      ph[t] = bits(hi2);
      pl[t] = bits(__floats2bfloat162_rn(p0 - back.x, p1 - back.y));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
#pragma unroll
    for (int pn = 0; pn < P; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pn][i] *= alpha[(i >> 1) & 1];

#pragma unroll
    for (int pn = 0; pn < P; ++pn) fence_regs(acc[pn]);
    fence_regs(ph);
    fence_regs(pl);
    wg_fence();
    pv<P>(acc, ph, kv_stage(j) + TILE);
    pv<P>(acc, pl, kv_stage(j) + TILE);
    wg_commit();
    wg_wait0();                                  // the next Q.K^T and this P.V
#pragma unroll
    for (int pn = 0; pn < P; ++pn) fence_regs(acc[pn]);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(sn);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = o + (((long)b * Sq + row) * H + h) * D + 2 * (lane & 3);
#pragma unroll
    for (int pn = 0; pn < P; ++pn)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * pn + 8 * n) = __floats2bfloat162_rn(
            acc[pn][4 * n + 2 * r] * inv, acc[pn][4 * n + 2 * r + 1] * inv);
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Hk,
           int Sq, int Sk, int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  const int nq = (Sq + BM - 1) / BM;
  if (B > 65535 || nq > 65535) return (int)cudaErrorInvalidValue;
  constexpr int smem = Tiles<D>::SMEM + 1024;    // 1024 for the alignment of the atoms
  static bool smem_set[64] = {};                 // once per process, device and D
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  flash_fwd_kernel<D><<<dim3(H, B, nq), NTHREADS, smem, stream>>>(q, k, v, o, H, Hk, Sq, Sk,
                                                                  causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C entry point.  dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma
// kernel); head dim 64 or 128, the ones the ported configs use.  One
// device kernel per call.  Returns the launch's cudaGetLastError() (0 =
// launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int H, int Hk,
                                   int Sq, int Sk, int D, int causal,
                                   int window, float softcap, float scale,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((D != 64 && D != 128) || Hk < 1 || H % Hk) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
    return D == 64 ? simt::launch<64>(qf, kf, vf, of, B, H, Hk, Sq, Sk, causal, window,
                                      softcap, scale, st)
                   : simt::launch<128>(qf, kf, vf, of, B, H, Hk, Sq, Sk, causal, window,
                                       softcap, scale, st);
  }
  if (dtype == 1) {
    typedef __nv_bfloat16 bf16;
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v);
    bf16* ob = static_cast<bf16*>(o);
    return D == 64 ? tc::launch<64>(qb, kb, vb, ob, B, H, Hk, Sq, Sk, causal, window, softcap,
                                    scale, st)
                   : tc::launch<128>(qb, kb, vb, ob, B, H, Hk, Sq, Sk, causal, window, softcap,
                                     scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
