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
// within a chunk, cum = cumsum(dt A), seg = cum_last and
//
//   y[q]  = sum_{k<=q} exp(cum_q - cum_k) (C_q . B_k) dt_k x_k   (intra)
//         + exp(cum_q) C_q . S_prev                              (inter)
//   S_c   = sum_k exp(seg - cum_k) dt_k B_k x_k^T                (chunk state)
//   S_prev[c + 1] = exp(seg_c) S_prev[c] + S_c                   (state pass)
//
// Output contract.  The model layout's entry writes y in fp32 and the final
// state (B, H, N, P) in fp32 (ssd_chunked(..., return_state=True), which
// the serving prefill snapshots into a lane); the TPU layout's entry writes
// y in x's type and no state, as the TPU kernel.  x, dt, B, C and y are
// read and written through the strides the wrapper passes, so both layouts
// -- x (B,T,H,P) or (B,H,T,P), B/C (B,T,G,N) or (B,G,T,N) -- go in without a
// transpose, and B/C are read per group, never expanded per head.
//
// Blocking.  The config's chunk is 256, but the result is the same up to
// fp32 summation order for any chunk, so the kernels use an internal chunk
// of QC = 64 positions: one wgmma M tile, and a 64 x 64 bf16 operand tile
// is 8 KB of shared memory.  N and P may be anything up to 64 (tiles are
// zero-padded to 64); a ragged T is masked as dt = 0 steps, an identity on
// the state, so the final state equals the exact-length scan's.
//
// Overflow.  Above the diagonal exp(cum_q - cum_k) has a positive exponent
// and can reach inf; inf * 0 would be NaN.  The decay is computed only
// where k <= q, and every other exponent (cum_q, seg - cum_k, seg) is <= 0.
//
// What bounds it on the H100.  At the serving prefill shape (T = 512,
// H = 64, N = P = 64, bf16 in, fp32 y and state out) the function moves
// ~13.9 MB: 4.2 us at 3.35 TB/s.  Its products are 2 N P FMAs per position
// and head, ~0.54 GFLOP: 8.0 us on the fp32 FMA pipes (67 TFLOP/s), 0.5 us
// on the bf16 tensor cores (989).  On tensor cores bytes bound it.  The
// first kernel sat at 22x the FMA bound: one block per (head,
// batch) walking every chunk in turn (64 blocks for 132 SMs), all four
// products as fp32 FMAs from shared memory, one block per SM with nothing
// in flight while it computed.
//
// bf16 design (tensor cores, three device kernels a call).
//   1. ssd_chunk_state_kernel, grid (chunks, H, batch), one warpgroup:
//      stages the chunk's B and x tiles by cp.async into 128-byte-swizzled
//      shared memory and its dt by 4-byte cp.async, computes cum (a warp
//      shuffle scan) and w_k = exp(seg - cum_k) dt_k, and takes
//      S_c = (B w)^T x as a wgmma m64n64k16 product with both operands
//      MN-major.  It writes S_c (fp32) and seg to a scratch the wrapper
//      allocates: (B, H, chunks, 64 * 64) in the accumulator's fragment
//      order, so each thread stores its 32 values as eight 16-byte
//      vectors, each contiguous across the warp, and (B, H, chunks).
//   2. ssd_state_pass_kernel, grid (4, H, batch): each thread walks the
//      chunks in order for four state elements, replacing S_c in the
//      scratch by S_prev[c] (the state before chunk c) and writing the
//      final state in (N, P) order: linear in the chunk count, its loads
//      loaded eight chunks ahead of the serial FMA chain.
//   3. ssd_chunk_scan_kernel, grid (chunks, H, batch): stages C, B, x and dt
//      by cp.async while its threads load S_prev[c] (their own fragment's
//      32 values) and write it as bf16 terms into a swizzled tile, then
//      runs three wgmma products: C.S_prev (C K-major, S MN-major), C.B^T
//      (both K-major), then (scores o decay o dt_k).x with the left operand
//      from registers (the accumulator fragment of C.B^T is, element for
//      element, its A fragment) and x MN-major; exp(cum_q) scales the first
//      product's rows before the third accumulates onto it.  Writes y.
//   At the serving shape that is 512 + 256 + 512 blocks, not 64, all
//   resident at once; the blocks of a pass are independent, so no block
//   waits on another's progress.  x, B and C are exact in bf16.  The three
//   operands that are not -- B_k w_k (pass 1), the carried state S (pass 3)
//   and scores o decay o dt_k (pass 3) -- enter their products as two bf16
//   terms, hi = bf16(v) and lo = bf16(v - hi), so each product carries ~16
//   bits of them (twice the wgmmas).  One bf16 rounding of them leaves the
//   fp32 outputs' 1e-4 tolerance
//   (tests/test_torch_kernels.py::test_ssd_split_keeps_card_tolerance).
//   A row whose base or stride is not 16-byte aligned, or whose width is
//   not a multiple of 8, is staged with scalar loads into the same
//   swizzled tile.
//
// fp32 design.  The fp32 tolerance needs true fp32 products, which the
// tensor cores do not take, so fp32 inputs keep the first FMA kernel
// (namespace simt below): one block per (head, batch), 256 threads each
// owning a 4 x 4 tile of every 64 x 64 product, the chunk's tiles in fp32
// shared memory (rows padded to 68 floats, 87 KB), the state carried in
// shared memory from chunk to chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// element strides (batch, position, head-or-group); the last dim (P or N)
// is contiguous
struct Strides {
  long long b, t, h;
};

struct Args {
  Strides x, dt, bm, cm, y;
  int H, G, T, N, P;
};

constexpr int QC = 64;               // internal chunk (positions)
constexpr int MAXD = 64;             // N and P at most

// warp 0 (the caller's tid < 32): cum[k] = inclusive cumsum of dt_k A over
// the chunk's 64 positions, lane l holding dt of positions 2l and 2l + 1
// (0 past the real positions, so cum stays put there)
__device__ __forceinline__ void chunk_cum(float d0, float d1, float rate, float* cum, int lane) {
  const float l0 = d0 * rate, l1 = d1 * rate;
  float incl = l0 + l1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  cum[2 * lane] = excl + l0;
  cum[2 * lane + 1] = excl + l0 + l1;
}

// ---------------------------------------------------------------------------
// fp32: FMA pipes (the first kernel)
// ---------------------------------------------------------------------------

namespace simt {

constexpr int LD = 68;               // shared-memory row stride, floats
constexpr int NTHREADS = 256;        // 16 x 16 threads, a 4 x 4 tile each
constexpr int TILE = QC * LD;        // floats per tile (QC == MAXD)
constexpr size_t SMEM_BYTES = (5 * TILE + 3 * QC) * sizeof(float);

static_assert(QC == MAXD, "the tiles share one shape");

__global__ void __launch_bounds__(NTHREADS)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
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

  const float* xb = x + b * a.x.b + h * a.x.h;
  const float* db = dt + b * a.dt.b + h * a.dt.h;
  const float* Bb = Bm + b * a.bm.b + g * a.bm.h;
  const float* Cb = Cm + b * a.cm.b + g * a.cm.h;
  float* yb = y + b * a.y.b + h * a.y.h;

  for (int e = tid; e < TILE; e += NTHREADS) St[e] = 0.f;

  for (int t0 = 0; t0 < a.T; t0 += QC) {
    const int nv = min(QC, a.T - t0);            // real positions in the chunk
    __syncthreads();                             // the previous chunk is consumed
    if (tid < 32) {                              // dt of positions 2 tid, 2 tid + 1
      const int k0 = 2 * tid;
      const float d0 = k0 < nv ? db[(long long)(t0 + k0) * a.dt.t] : 0.f;
      const float d1 = k0 + 1 < nv ? db[(long long)(t0 + k0 + 1) * a.dt.t] : 0.f;
      chunk_cum(d0, d1, rate, cum, tid);
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
      Cs[k * LD + c] = okn ? Cb[t * a.cm.t + c] : 0.f;
      Bt[c * LD + k] = okn ? Bb[t * a.bm.t + c] : 0.f;
      Xs[k * LD + c] = okp ? xb[t * a.x.t + c] * dts[k] : 0.f;
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
      float* row = yb + (long long)(t0 + q) * a.y.t;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (c0 + jj < a.P) row[c0 + jj] = yo[i][jj];
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

int launch(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
           float* y, float* state, int batch, const Args& a, cudaStream_t s) {
  // opt in to > 48 KB of shared memory (per device, so at every launch)
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  ssd_kernel<<<dim3(a.H, batch), NTHREADS, SMEM_BYTES, s>>>(x, dt, A, Bm, Cm, y, state, a);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: wgmma tensor cores, three passes over chunks
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int NTHREADS = 128;          // one warpgroup
constexpr int TILE = QC * MAXD * 2;    // bytes of a 64 x 64 bf16 tile: 8 KB
constexpr int STATE = MAXD * MAXD;     // floats of a chunk state in the scratch
constexpr int PASS_THREADS = 256;      // state pass: threads a block, 4 elements each
// shared memory: the tiles, then fp32 vectors of QC, plus 1024 bytes to
// align the swizzle atoms; both under the 48 KB default (no opt-in)
constexpr int SMEM_STATE = 4 * TILE + 3 * QC * 4 + 1024;   // B | x | Bw hi | Bw lo
constexpr int SMEM_SCAN = 5 * TILE + 2 * QC * 4 + 1024;    // C | B | x | S hi | S lo
static_assert(SMEM_STATE <= 48 * 1024 && SMEM_SCAN <= 48 * 1024, "no opt-in needed");

// The wgmma, cp.async and swizzle helpers below are the flash kernel's
// (flash_attention.cu), with the transposes of both shared-memory operands
// as parameters.

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) become
// visible to the wgmma (async proxy) reads after this and a barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage rows [0, 64) of a (rows, width) bf16 matrix whose row r starts at
// base + r * ts into a swizzled 64 x 64 tile at (generic) sm / (shared) dst;
// rows at or past nv and columns at or past width are zeros.  vec: base
// and ts 16-byte aligned and width % 8 == 0, so each 16-byte chunk is one
// cp.async; else scalar loads.
__device__ __forceinline__ void load_tile(uint8_t* sm, uint32_t dst, const bf16* base,
                                          long long ts, int nv, int width, bool vec, int tid) {
#pragma unroll
  for (int i = 0; i < QC * 8 / NTHREADS; ++i) {
    const int e = tid + i * NTHREADS;
    const int r = e >> 3, c = e & 7;
    const bool ok = r < nv && 8 * c < width;
    if (vec) {
      cp_async16(dst + swz(r, c), base + (ok ? r * ts + 8 * c : 0), ok);
    } else {
      const uint16_t* row = reinterpret_cast<const uint16_t*>(base) + r * ts;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n0 = 8 * c + 2 * j;
        const uint32_t lo = ok && n0 < width ? row[n0] : 0u;
        const uint32_t hi = ok && n0 + 1 < width ? row[n0 + 1] : 0u;
        w[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(sm + swz(r, c)) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle: start >> 4, leading and
// stride byte offsets >> 4, layout type 1 (B128) in bits 62-63
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo & 0x3FFF) << 16)
       | ((uint64_t)(sbo & 0x3FFF) << 32) | (1ull << 62);
}
// K-major tile (rows = M or N, 64 k-values a 128-byte row): the k16 step
// kk starts 32 bytes along the rows; 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + 32 * kk, 1, 64);
}
// MN-major tile (rows = k, 64 M- or N-values a row, one swizzle atom wide):
// the k16 step kk starts 16 rows (2 KB) further; 8-row groups 1024 apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + 2048 * kk, 64, 64);
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

// d (+)= A.B, m64n64k16, A and B from shared memory; TA / TB: 0 K-major,
// 1 MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
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

// v0, v1 as hi + lo bf16 pairs: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
  const float2 back = __bfloat1622float2(h2);
  hi = bits(h2);
  lo = bits(__floats2bfloat162_rn(v0 - back.x, v1 - back.y));
}

// 8 fp32 values as one 16-byte chunk of hi terms and one of lo terms
__device__ __forceinline__ void split8(const float (&v)[8], uint4& hi, uint4& lo) {
  split2(v[0], v[1], hi.x, lo.x);
  split2(v[2], v[3], hi.y, lo.y);
  split2(v[4], v[5], hi.z, lo.z);
  split2(v[6], v[7], hi.w, lo.w);
}

// Accumulator fragment of m64n64k16 (f32): element i of thread (warp w,
// lane l) of the warpgroup is row 16 w + l / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (l % 4) + (i & 1).  A chunk state in the scratch is kept
// in that order, interleaved by 16-byte vectors: elements 4j .. 4j + 3 of
// thread t are float4 number 128 j + t of its 64 x 64 fp32 block, so pass 1
// writes and pass 3 reads eight float4 a thread, 512 contiguous bytes a
// warp each.
__device__ __forceinline__ int frag_row(int tid, int i) {
  return (tid >> 5) * 16 + ((tid & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int tid, int i) {
  return 8 * (i >> 2) + 2 * (tid & 3) + (i & 1);
}

// dt of the chunk's 64 positions into dts by 4-byte cp.async (0 past nv)
__device__ __forceinline__ void load_dt(float* dts, const float* db, long long dt_t, int nv,
                                        int tid) {
  if (tid < QC) {
    const bool ok = tid < nv;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dts + tid)), "l"(db + (ok ? tid * dt_t : 0)),
                    "r"(ok ? 4 : 0) : "memory");
  }
}

// Pass 1: S_c = sum_k (B_k w_k) x_k^T, w_k = exp(seg - cum_k) dt_k, into
// states[b, h, c] (fragment order), and seg into segs[b, h, c].
__global__ void __launch_bounds__(NTHREADS)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ segs, Args a, int nc,
                       int vec_x, int vec_b) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_addr(sm);             // B | x | Bw hi | Bw lo
  float* cum = reinterpret_cast<float*>(sm + 4 * TILE);
  float* dts = cum + QC;
  float* wk = dts + QC;
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int t0 = c * QC, nv = min(QC, a.T - t0);

  load_tile(sm, s0, Bm + b * a.bm.b + g * a.bm.h + t0 * a.bm.t, a.bm.t, nv, a.N, vec_b, tid);
  load_tile(sm + TILE, s0 + TILE, x + b * a.x.b + h * a.x.h + t0 * a.x.t, a.x.t, nv, a.P,
            vec_x, tid);
  load_dt(dts, dt + b * a.dt.b + h * a.dt.h + t0 * a.dt.t, a.dt.t, nv, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (tid < 32) {
    chunk_cum(dts[2 * lane], dts[2 * lane + 1], A[h], cum, lane);
    __syncwarp();
    const float seg = cum[QC - 1];
    wk[2 * lane] = expf(seg - cum[2 * lane]) * dts[2 * lane];
    wk[2 * lane + 1] = expf(seg - cum[2 * lane + 1]) * dts[2 * lane + 1];
  }
  __syncthreads();

  // Bw = B w_k as hi + lo terms, at B's own swizzled places
#pragma unroll
  for (int i = 0; i < QC * 8 / NTHREADS; ++i) {
    const int e = tid + i * NTHREADS;
    const int r = e >> 3;
    const uint32_t off = swz(r, e & 7);
    const uint4 raw = *reinterpret_cast<const uint4*>(sm + off);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float w = wk[r];
    float v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(b2[j]);
      v[2 * j] = f.x * w;
      v[2 * j + 1] = f.y * w;
    }
    uint4 hi, lo;
    split8(v, hi, lo);
    *reinterpret_cast<uint4*>(sm + 2 * TILE + off) = hi;
    *reinterpret_cast<uint4*>(sm + 3 * TILE + off) = lo;
  }
  fence_async_smem();
  __syncthreads();

  // D[n][p] = sum_k Bw[k][n] x[k][p]: A = Bw MN-major (M = n), B = x MN-major
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_regs(d);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < QC / 16; ++kk)
    wgmma_ss<1, 1>(d, desc_mn(s0 + 2 * TILE, kk), desc_mn(s0 + TILE, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < QC / 16; ++kk)
    wgmma_ss<1, 1>(d, desc_mn(s0 + 3 * TILE, kk), desc_mn(s0 + TILE, kk), 1);
  wg_commit();
  wg_wait0();
  fence_regs(d);

  // rows n >= N and columns p >= P are 0: B and x were zero-filled there
  const long long bhc = ((long long)b * a.H + h) * nc + c;
  float4* out = reinterpret_cast<float4*>(states + bhc * STATE) + tid;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    out[NTHREADS * j] = make_float4(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]);
  if (tid == 0) segs[bhc] = cum[QC - 1];
}

// Pass 2: for each (b, h) and state element, walk the chunks in order:
// states[c] <- S_prev[c] (the state before chunk c, 0 for c = 0) and
// S_prev[c + 1] = exp(seg_c) S_prev[c] + S_c; the last one is the final
// state, written (where final_state is not null) from fragment order to
// (N, P).  Four elements a thread: float4 number f of the block, a
// fragment thread's elements 4j .. 4j + 3.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ segs,
                      float* __restrict__ final_state, int H, int nc, int N, int P) {
  constexpr int AHEAD = 8;                       // chunks loaded before the FMA chain
  const int e = (blockIdx.x * PASS_THREADS + threadIdx.x) * 4;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  float4* st = reinterpret_cast<float4*>(states + bh * nc * STATE + e);
  const float* sg = segs + bh * nc;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float4 v[AHEAD];
    float dec[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (c0 + u >= nc) break;
      dec[u] = expf(sg[c0 + u]);
      v[u] = st[(long long)(c0 + u) * (STATE / 4)];
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (c0 + u >= nc) break;
      st[(long long)(c0 + u) * (STATE / 4)] = S;
      S.x = S.x * dec[u] + v[u].x;
      S.y = S.y * dec[u] + v[u].y;
      S.z = S.z * dec[u] + v[u].z;
      S.w = S.w * dec[u] + v[u].w;
    }
  }
  if (final_state != nullptr) {
    const int t = (e >> 2) % NTHREADS, i = 4 * ((e >> 2) / NTHREADS);   // fragment thread, element
    const float vals[4] = {S.x, S.y, S.z, S.w};
    float* out = final_state + bh * N * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = frag_row(t, i + j), p = frag_col(t, i + j);
      if (n < N && p < P) out[n * P + p] = vals[j];
    }
  }
}

// Pass 3: y[q] = exp(cum_q) C_q . S_prev[c] + sum_{k<=q} exp(cum_q - cum_k)
// (C_q . B_k) dt_k x_k for the chunk's rows.
template <typename O>
__global__ void __launch_bounds__(NTHREADS, 4)     // 4 blocks an SM: one wave at 512 blocks
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm, O* __restrict__ y,
                      const float* __restrict__ states, Args a, int nc, int vec_x, int vec_b,
                      int vec_c, int vec_y) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sC = smem_addr(sm), sB = sC + TILE, sX = sB + TILE;
  const uint32_t sShi = sX + TILE, sSlo = sShi + TILE;
  float* cum = reinterpret_cast<float*>(sm + 5 * TILE);
  float* dts = cum + QC;
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int t0 = c * QC, nv = min(QC, a.T - t0);

  load_tile(sm, sC, Cm + b * a.cm.b + g * a.cm.h + t0 * a.cm.t, a.cm.t, nv, a.N, vec_c, tid);
  load_tile(sm + TILE, sB, Bm + b * a.bm.b + g * a.bm.h + t0 * a.bm.t, a.bm.t, nv, a.N, vec_b,
            tid);
  load_tile(sm + 2 * TILE, sX, x + b * a.x.b + h * a.x.h + t0 * a.x.t, a.x.t, nv, a.P, vec_x,
            tid);
  load_dt(dts, dt + b * a.dt.b + h * a.dt.h + t0 * a.dt.t, a.dt.t, nv, tid);
  cp_async_commit();

  // S_prev[c] (fragment order: this thread's 32 elements) as hi + lo bf16
  // tiles, MN-major for C.S (rows = n, the k of that product); its loads
  // fly with the copies above
  if (c > 0) {
    const float4* sp = reinterpret_cast<const float4*>(
        states + (((long long)b * a.H + h) * nc + c) * STATE) + tid;
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = sp[NTHREADS * j];
    const int n = frag_row(tid, 0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {                // (n, p), (n, p + 1), (n + 8, p), (n + 8, p + 1)
      const uint32_t off = swz(n, j) + 4 * (lane & 3);
      const uint32_t off8 = swz(n + 8, j) + 4 * (lane & 3);
      uint32_t hi, lo;
      split2(v[j].x, v[j].y, hi, lo);
      *reinterpret_cast<uint32_t*>(sm + 3 * TILE + off) = hi;
      *reinterpret_cast<uint32_t*>(sm + 4 * TILE + off) = lo;
      split2(v[j].z, v[j].w, hi, lo);
      *reinterpret_cast<uint32_t*>(sm + 3 * TILE + off8) = hi;
      *reinterpret_cast<uint32_t*>(sm + 4 * TILE + off8) = lo;
    }
  }
  cp_async_wait_all();
  __syncthreads();                               // dt has landed
  if (tid < 32) chunk_cum(dts[2 * lane], dts[2 * lane + 1], A[h], cum, lane);
  fence_async_smem();
  __syncthreads();

  // acc = C.S_prev (C K-major, S MN-major); sc = C.B^T (both K-major)
  float acc[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sc[i] = 0.f;
  fence_regs(acc);
  fence_regs(sc);
  wg_fence();
  if (c > 0) {
#pragma unroll
    for (int kk = 0; kk < MAXD / 16; ++kk)
      wgmma_ss<0, 1>(acc, desc_k(sC, kk), desc_mn(sShi, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < MAXD / 16; ++kk)
      wgmma_ss<0, 1>(acc, desc_k(sC, kk), desc_mn(sSlo, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < MAXD / 16; ++kk)
    wgmma_ss<0, 0>(sc, desc_k(sC, kk), desc_k(sB, kk), kk > 0);
  wg_commit();
  wg_wait0();
  fence_regs(acc);
  fence_regs(sc);

  // this thread's rows row0 and row0 + 8: scale the inter term by
  // exp(cum_q), and form the intra product's left operand
  // scores o exp(cum_q - cum_k) o dt_k (only where k <= q) as hi + lo, in
  // registers: the accumulator fragment of C.B^T is, element for element,
  // the A fragment of that product.  The decay's exponent is a difference
  // within one chunk, so __expf (one ex2 of it times log2 e) keeps its
  // relative error ~1e-6.
  const int row0 = frag_row(tid, 0);
  float cq[2], eq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    cq[r] = cum[row0 + 8 * r];
    eq[r] = expf(cq[r]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= eq[(i >> 1) & 1];
  uint32_t ph[16], pl[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int r = t & 1;                         // elements 2t, 2t + 1 share a row
    const int q = row0 + 8 * r;
    const int k = frag_col(tid, 2 * t);
    const float v0 = k <= q ? sc[2 * t] * __expf(cq[r] - cum[k]) * dts[k] : 0.f;
    const float v1 = k + 1 <= q ? sc[2 * t + 1] * __expf(cq[r] - cum[k + 1]) * dts[k + 1] : 0.f;
    split2(v0, v1, ph[t], pl[t]);
  }

  // acc += (scores o decay o dt_k).x, x MN-major
  fence_regs(acc);
  fence_regs(ph);
  fence_regs(pl);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < QC / 16; ++kk)
    wgmma_rs(acc, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], desc_mn(sX, kk));
#pragma unroll
  for (int kk = 0; kk < QC / 16; ++kk)
    wgmma_rs(acc, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], desc_mn(sX, kk));
  wg_commit();
  wg_wait0();
  fence_regs(acc);
  fence_regs(ph);
  fence_regs(pl);

  O* yb = y + b * a.y.b + h * a.y.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    if (q >= nv) continue;
    O* row = yb + (long long)(t0 + q) * a.y.t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int p = frag_col(tid, 4 * n);
      const float v0 = acc[4 * n + 2 * r], v1 = acc[4 * n + 2 * r + 1];
      if (vec_y && p + 1 < a.P) {
        if constexpr (sizeof(O) == 4)
          *reinterpret_cast<float2*>(row + p) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(row + p) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (p < a.P) row[p] = static_cast<O>(v0);
        if (p + 1 < a.P) row[p + 1] = static_cast<O>(v1);
      }
    }
  }
}

bool aligned(const void* p, const Strides& s, int width, int bytes) {
  const int el = bytes / 2;                      // bf16 elements in `bytes`
  return reinterpret_cast<uintptr_t>(p) % bytes == 0 && s.b % el == 0 && s.t % el == 0
         && s.h % el == 0 && width % el == 0;
}

template <typename O>
int launch(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm,
           O* y, float* state, float* scratch, int batch, const Args& a, cudaStream_t s) {
  if (a.H > 65535 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int nc = (a.T + QC - 1) / QC;
  float* states = scratch;                       // (batch, H, nc, 64 * 64), fragment order
  float* segs = scratch + (long long)batch * a.H * nc * STATE;   // (batch, H, nc)
  const int vx = aligned(x, a.x, a.P, 16), vb = aligned(Bm, a.bm, a.N, 16);
  const int vc = aligned(Cm, a.cm, a.N, 16);
  // y pairs: 2 elements of O at once
  const int vy = reinterpret_cast<uintptr_t>(y) % (2 * sizeof(O)) == 0 && a.y.b % 2 == 0
                 && a.y.t % 2 == 0 && a.y.h % 2 == 0;
  const dim3 chunks(nc, a.H, batch);
  if (nc > 0) {
    ssd_chunk_state_kernel<<<chunks, NTHREADS, SMEM_STATE, s>>>(x, dt, A, Bm, states, segs, a,
                                                                 nc, vx, vb);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ssd_state_pass_kernel<<<dim3(STATE / (4 * PASS_THREADS), a.H, batch), PASS_THREADS, 0, s>>>(
      states, segs, state, a.H, nc, a.N, a.P);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nc == 0) return (int)e;
  ssd_chunk_scan_kernel<O><<<chunks, NTHREADS, SMEM_SCAN, s>>>(x, dt, A, Bm, Cm, y, states, a,
                                                               nc, vx, vb, vc, vy);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x: in_dtype, dt: fp32, A: (H,) fp32, Bm / Cm: in_dtype, y: out_dtype;
// strides[15]: element strides (batch, position, head-or-group) of x, dt,
// Bm, Cm and y in that order, the last dim (P or N) contiguous; state:
// (batch, H, N, P) fp32 contiguous, or null; scratch: fp32, batch * H *
// ceil(T / 64) * (N * P + 1) floats for bf16 inputs (the chunk states,
// then the chunks' seg), unused (may be null) for fp32.  dtype codes 0 =
// fp32, 1 = bf16; (in, out) must be (0, 0), (1, 0) or (1, 1).  N, P <= 64
// and H % G == 0.  fp32 runs one device kernel, bf16 three.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, void* y, void* state, void* scratch, int in_dtype,
                        int out_dtype, int batch, int H, int G, int T, int N, int P,
                        const long long* strides, void* stream) {
  if (batch <= 0 || H <= 0) return 0;
  if (N > MAXD || P > MAXD || N <= 0 || P <= 0 || T < 0 || G <= 0 || H % G)
    return (int)cudaErrorInvalidValue;
  Args a;
  Strides* ss[5] = {&a.x, &a.dt, &a.bm, &a.cm, &a.y};
  for (int i = 0; i < 5; ++i) *ss[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.H = H; a.G = G; a.T = T; a.N = N; a.P = P;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  if (in_dtype == 0 && out_dtype == 0)
    return simt::launch(static_cast<const float*>(x), dtp, Ap, static_cast<const float*>(Bm),
                        static_cast<const float*>(Cm), static_cast<float*>(y),
                        static_cast<float*>(state), batch, a, s);
  if (in_dtype != 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(Bm);
  const auto* cb = static_cast<const __nv_bfloat16*>(Cm);
  float* sp = static_cast<float*>(state);
  float* scr = static_cast<float*>(scratch);
  if (out_dtype == 0)
    return tc::launch(xb, dtp, Ap, bb, cb, static_cast<float*>(y), sp, scr, batch, a, s);
  if (out_dtype == 1)
    return tc::launch(xb, dtp, Ap, bb, cb, static_cast<__nv_bfloat16*>(y), sp, scr, batch, a, s);
  return (int)cudaErrorInvalidValue;
}
