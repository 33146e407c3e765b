// Fused grouped expert FFN for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/grouped_ffn/kernel.py,
// grouped_ffn_kernel (bodies _kernel and _kernel_gated): per expert e,
//   out[e] = act(x[e] @ w_up[e]) @ w_down[e]                     (plain)
//   out[e] = (act(x[e] @ w_gate[e]) * (x[e] @ w_up[e])) @ w_down[e] (gated)
// act in {silu, gelu (tanh form), relu}. The hidden tile is taken in fp32,
// the activation applied in fp32, the tile rounded to x's dtype (as the TPU
// kernel's h.astype(x.dtype)) and multiplied into an fp32 accumulator of
// the output. x [E, C, M]; w_up, w_gate [E, M, H]; w_down [E, H, M];
// out [E, C, M] in x's dtype (the fp32 accumulator rounded once).
//
// Bound: HBM bytes at the shapes MoE runs. Every expert's weights are read
// once per call: 2 (or 3) * E * M * H elements, 604 MB in bf16 for
// moe-gpt3-s (E 64, M 768, H 3072), ~0.18 ms at 3.35 TB/s, while its
// 4 * E * C * M * H = 24 GFLOP at C = 40 take ~0.025 ms on the tensor
// cores. Few tokens reach an expert, so the weights, not the products, are
// the cost.
//
// Design (simple first; wgmma, TMA, split-H over more blocks are later
// work):
//  * One 256-thread block per (expert, token tile of TC rows): TC = 32 for
//    M <= 1024, TC = 16 for 1024 < M <= 2048. For C = 40 and TC = 32 that
//    is 2 blocks an expert, 128 blocks in all. The blocks of one expert are
//    neighbours in the grid and run together, so all but the first read
//    the expert's weights mostly from L2.
//  * The block stages its x tile [TC, M] in shared memory once, then walks
//    H in 64-column tiles. GEMM1 streams w_up (and w_gate) in K-chunks
//    through a two-stage cp.async ring; each warp owns one 16x16 piece of
//    the [TC, 64] hidden tile (at TC = 16 four warps have one, the other
//    four wait). The hidden tile goes through shared memory in fp32 for
//    the activation, is rounded to x's dtype, and GEMM2 streams w_down's
//    [64, M] slab in column chunks through the same kind of ring into the
//    fp32 output accumulator, which stays in registers for the whole H
//    loop: [TC, M] is 16 16x16 fragments a warp at most, hence M <= 1024
//    at TC = 32 and M <= 2048 at TC = 16 (DeepSeek-V2-Lite and moe-gpt3-xl
//    have d_model 2048). The fp32 x tile [16, 2048] takes 128 KB of shared
//    memory, so the fp32 TC = 16 tiling streams w_up in 16-row K-chunks
//    and w_down in 128-column chunks to stay within 227 KB. T_M never
//    reaches device memory.
//  * bf16 runs on the tensor cores through WMMA (16x16x16, fp32
//    accumulation). fp32 runs the same tiling with FMAs on the CUDA cores
//    (no TF32: it would not hold a 1e-5 limit).
//  * Any C works: rows past C are zero-filled in shared memory and never
//    stored. M and H must be multiples of 16 (16-byte copies); the wrapper
//    checks, and raises above the card's shared-memory limit, which
//    grouped_ffn_smem_bytes states for a shape.
//  * Plain C interface, loaded with ctypes; the launch goes on the caller's
//    stream; the return value is the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBH = 64;      // hidden columns per H tile
constexpr int kLdf = kBH + 4;
constexpr int kAccFrags = 16;  // output accumulator fragments a warp

// Tiling of one block holding TC token rows.
template <typename T, int TC>
struct Tile;
template <>
struct Tile<__nv_bfloat16, 32> {
  static constexpr int BK = 64;   // GEMM1 K-chunk (rows of w_up)
  static constexpr int WN = 128;  // GEMM2 column chunk (of w_down)
  static constexpr int PAD = 8;   // row padding, elements
};
template <>
struct Tile<__nv_bfloat16, 16> {
  static constexpr int BK = 64;
  static constexpr int WN = 128;
  static constexpr int PAD = 8;
};
template <>
struct Tile<float, 32> {
  static constexpr int BK = 32;
  static constexpr int WN = 64;
  static constexpr int PAD = 4;
};
template <>
struct Tile<float, 16> {
  static constexpr int BK = 16;
  static constexpr int WN = 128;
  static constexpr int PAD = 4;
};

// The most M a block of TC rows takes: its [TC, M] fp32 output
// accumulator is kAccFrags 16x16 fragments a warp.
template <int TC>
__host__ __device__ constexpr int max_m() {
  return kAccFrags * kWarps * 256 / TC;
}
constexpr int kMaxM = max_m<16>();  // 2048

// 16x16x16 multiply-accumulate on shared-memory tiles, row-major A and B.
template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  __device__ static void zero(Acc& c) { wmma::fill_fragment(c, 0.f); }
  __device__ static void mma(Acc& c, const __nv_bfloat16* a, int lda,
                             const __nv_bfloat16* b, int ldb) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fb;
    wmma::load_matrix_sync(fa, a, lda);
    wmma::load_matrix_sync(fb, b, ldb);
    wmma::mma_sync(c, fa, fb, c);
  }
  __device__ static void store(float* p, const Acc& c, int ldm) {
    wmma::store_matrix_sync(p, c, ldm, wmma::mem_row_major);
  }
};
template <>
struct Mma<float> {
  struct Acc {
    float v[8];
  };  // lane l: row l / 2, columns (l % 2) * 8 .. + 8
  __device__ static void zero(Acc& c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) c.v[i] = 0.f;
  }
  __device__ static void mma(Acc& c, const float* a, int lda, const float* b,
                             int ldb) {
    const int lane = threadIdx.x & 31;
    const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float av = a[r * lda + k];
#pragma unroll
      for (int i = 0; i < 8; ++i) c.v[i] = fmaf(av, b[k * ldb + c0 + i], c.v[i]);
    }
  }
  __device__ static void store(float* p, const Acc& c, int ldm) {
    const int lane = threadIdx.x & 31;
    const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) p[r * ldm + c0 + i] = c.v[i];
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 0) return v / (1.f + expf(-v));                        // silu
  if (act == 1)                                                      // gelu
    return 0.5f * v *
           (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return fmaxf(v, 0.f);                                              // relu
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy a rows x cols tile of a row-major matrix (row stride ldg, origin g)
// into shared memory (row stride lds) with 16-byte cp.async; elements at
// or past (rmax, cmax) from the origin are written as zeros instead.
template <typename T>
__device__ __forceinline__ void load_tile(T* s, int lds, const T* g,
                                          int64_t ldg, int rows, int cols,
                                          int rmax, int cmax) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * V;
    T* dst = s + r * lds + c;
    if (r < rmax && c < cmax)
      cp_async16(dst, g + r * ldg + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

// Shared-memory layout of one block; the kernel and the size query both
// read it from here.
template <typename T, int TC>
struct Layout {
  size_t xs, wu, wg, wd, hf, hs, total;
  __host__ __device__ Layout(int m, bool gated) {
    using C = Tile<T, TC>;
    const size_t wu_bytes = align128(2 * C::BK * (kBH + C::PAD) * sizeof(T));
    xs = 0;
    wu = xs + align128(size_t(TC) * (m + C::PAD) * sizeof(T));
    wg = wu + wu_bytes;
    wd = wg + (gated ? wu_bytes : 0);
    hf = wd + align128(2 * kBH * (C::WN + C::PAD) * sizeof(T));
    hs = hf + align128(2 * TC * kLdf * sizeof(float));
    total = hs + align128(TC * (kBH + C::PAD) * sizeof(T));
  }
};

template <typename T, bool Gated, int TC>
__global__ void __launch_bounds__(kThreads, 1)
    grouped_ffn_kernel(const T* __restrict__ x, const T* __restrict__ w_up,
                       const T* __restrict__ w_gate,
                       const T* __restrict__ w_down, T* __restrict__ out,
                       int c, int m, int h, int act) {
  using C = Tile<T, TC>;
  using MM = Mma<T>;
  constexpr int BK = C::BK, WN = C::WN, PAD = C::PAD;
  constexpr int NFC = WN / 16;             // column fragments per chunk
  constexpr int PER = (TC / 16) * NFC / kWarps;  // accumulators a warp,
                                                 // a chunk
  constexpr int MAXCH = max_m<TC>() / WN;  // column chunks at most
  constexpr int NF1 = (TC / 16) * (kBH / 16);  // GEMM1 fragments
  static_assert(PER * MAXCH == kAccFrags && PER * kWarps == (TC / 16) * NFC,
                "every warp holds kAccFrags output fragments");
  static_assert(NF1 <= kWarps && kWarps * 256 <= 2 * TC * kLdf,
                "GEMM1 fragments and the epilogue scratch fit");
  extern __shared__ __align__(128) unsigned char smem[];

  const Layout<T, TC> lay(m, Gated);
  T* xs = reinterpret_cast<T*>(smem + lay.xs);
  T* wus = reinterpret_cast<T*>(smem + lay.wu);
  T* wgs = reinterpret_cast<T*>(smem + lay.wg);
  T* wds = reinterpret_cast<T*>(smem + lay.wd);
  float* hf = reinterpret_cast<float*>(smem + lay.hf);
  T* hs = reinterpret_cast<T*>(smem + lay.hs);
  const int ldx = m + PAD, ldu = kBH + PAD, ldd = WN + PAD, ldh = kBH + PAD;

  const int e = blockIdx.y, row0 = blockIdx.x * TC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t mh = int64_t(m) * h;
  const T* wue = w_up + e * mh;
  const T* wge = Gated ? w_gate + e * mh : nullptr;
  const T* wde = w_down + e * mh;

  load_tile(xs, ldx, x + (int64_t(e) * c + row0) * m, m, TC, m, c - row0,
            m);
  cp_commit();

  typename MM::Acc acc[MAXCH * PER];
#pragma unroll
  for (int i = 0; i < MAXCH * PER; ++i) MM::zero(acc[i]);

  const int nk = (m + BK - 1) / BK, nh = (h + kBH - 1) / kBH;
  const int nch = (m + WN - 1) / WN;
  const int fr = warp / 4, fc = warp % 4;  // this warp's GEMM1 fragment
  const bool g1 = NF1 == kWarps || warp < NF1;  // the warp has one
  for (int ht = 0; ht < nh; ++ht) {
    const int h0 = ht * kBH;
    // ---- GEMM1: [TC, M] x [M, 64] -> fp32 hidden tile -----------------
    typename MM::Acc up, gt;
    MM::zero(up);
    MM::zero(gt);
    load_tile(wus, ldu, wue + h0, h, BK, kBH, m, h - h0);
    if (Gated) load_tile(wgs, ldu, wge + h0, h, BK, kBH, m, h - h0);
    cp_commit();
    for (int kc = 0; kc < nk; ++kc) {
      const int st = kc & 1;
      if (kc + 1 < nk) {
        const int64_t off = int64_t(kc + 1) * BK * h + h0;
        load_tile(wus + (st ^ 1) * BK * ldu, ldu, wue + off, h, BK, kBH,
                  m - (kc + 1) * BK, h - h0);
        if (Gated)
          load_tile(wgs + (st ^ 1) * BK * ldu, ldu, wge + off, h, BK, kBH,
                    m - (kc + 1) * BK, h - h0);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int k = kc * BK + kk * 16;
        if (k >= m || !g1) break;
        const T* a = xs + fr * 16 * ldx + k;
        const int boff = st * BK * ldu + kk * 16 * ldu + fc * 16;
        MM::mma(up, a, ldx, wus + boff, ldu);
        if (Gated) MM::mma(gt, a, ldx, wgs + boff, ldu);
      }
      __syncthreads();
    }
    // ---- activation in fp32, rounded to x's dtype -----------------------
    if (g1) {
      MM::store(hf + fr * 16 * kLdf + fc * 16, up, kLdf);
      if (Gated)
        MM::store(hf + TC * kLdf + fr * 16 * kLdf + fc * 16, gt, kLdf);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TC * kBH; i += kThreads) {
      const int r = i / kBH, col = i % kBH;
      const float u = hf[r * kLdf + col];
      const float v = Gated ? activate(hf[TC * kLdf + r * kLdf + col], act) * u
                            : activate(u, act);
      hs[r * ldh + col] = from_float<T>(v);
    }
    __syncthreads();
    // ---- GEMM2: [TC, 64] x [64, M] into the fp32 output accumulator ----
    const T* wdt = wde + int64_t(h0) * m;
    load_tile(wds, ldd, wdt, m, kBH, WN, h - h0, m);
    cp_commit();
#pragma unroll
    for (int j = 0; j < MAXCH; ++j) {
      if (j >= nch) break;
      const int st = j & 1;
      if (j + 1 < nch) {
        load_tile(wds + (st ^ 1) * kBH * ldd, ldd, wdt + (j + 1) * WN, m, kBH,
                  WN, h - h0, m - (j + 1) * WN);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const T* ws = wds + st * kBH * ldd;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int f = warp * PER + i, r = f / NFC, cf = f % NFC;
        if (j * WN + cf * 16 < m) {
#pragma unroll
          for (int kk = 0; kk < kBH / 16; ++kk)
            MM::mma(acc[j * PER + i], hs + r * 16 * ldh + kk * 16, ldh,
                    ws + kk * 16 * ldd + cf * 16, ldd);
        }
      }
      __syncthreads();
    }
  }

  // ---- epilogue: each fragment through a per-warp 16x16 scratch ---------
  float* scr = hf + warp * 256;
#pragma unroll
  for (int j = 0; j < MAXCH; ++j) {
    if (j >= nch) break;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int f = warp * PER + i, r = f / NFC, cf = f % NFC;
      const int col0 = j * WN + cf * 16;
      if (col0 < m) {
        MM::store(scr, acc[j * PER + i], 16);
        __syncwarp();
        for (int q = lane; q < 256; q += 32) {
          const int row = row0 + r * 16 + q / 16;
          if (row < c)
            out[(int64_t(e) * c + row) * m + col0 + q % 16] =
                from_float<T>(scr[q]);
        }
        __syncwarp();
      }
    }
  }
}

// Token rows a block holds at this M: 32 while the accumulator allows it.
int rows_for(int m) { return m <= max_m<32>() ? 32 : 16; }

template <typename T>
size_t smem_bytes(int m, bool gated) {
  return rows_for(m) == 32 ? Layout<T, 32>(m, gated).total
                           : Layout<T, 16>(m, gated).total;
}

template <typename T, bool Gated, int TC>
int launch_rows(const void* x, const void* wu, const void* wg,
                const void* wd, void* out, int e, int c, int m, int h,
                int act, cudaStream_t stream) {
  static size_t opted_in = 0;      // dynamic shared memory already allowed
  const size_t smem = Layout<T, TC>(m, Gated).total;
  auto kernel = grouped_ffn_kernel<T, Gated, TC>;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid((c + TC - 1) / TC, e);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wu),
      static_cast<const T*>(wg), static_cast<const T*>(wd),
      static_cast<T*>(out), c, m, h, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool Gated>
int launch(const void* x, const void* wu, const void* wg, const void* wd,
           void* out, int e, int c, int m, int h, int act,
           cudaStream_t stream) {
  if (rows_for(m) == 32)
    return launch_rows<T, Gated, 32>(x, wu, wg, wd, out, e, c, m, h, act,
                                     stream);
  return launch_rows<T, Gated, 16>(x, wu, wg, wd, out, e, c, m, h, act,
                                   stream);
}

}  // namespace

extern "C" {

int grouped_ffn_max_m() { return kMaxM; }

// Dynamic shared memory a block needs for this shape (dtype: 0 float32,
// 1 bfloat16).
size_t grouped_ffn_smem_bytes(int m, int gated, int dtype) {
  return dtype == 0 ? smem_bytes<float>(m, gated != 0)
                    : smem_bytes<__nv_bfloat16>(m, gated != 0);
}

size_t grouped_ffn_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return static_cast<size_t>(v);
}

// x [E, C, M]; w_up, w_gate [E, M, H] (w_gate null when not gated);
// w_down [E, H, M]; out [E, C, M]; all of one dtype, contiguous.
// act: 0 silu, 1 gelu (tanh form), 2 relu.
int grouped_ffn(const void* x, const void* w_up, const void* w_gate,
                const void* w_down, void* out, int e, int c, int m, int h,
                int act, int dtype, void* stream) {
  if (m % 16 || h % 16 || m > kMaxM || m <= 0 || h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (e <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool gated = w_gate != nullptr;
  if (dtype == 0)
    return gated ? launch<float, true>(x, w_up, w_gate, w_down, out, e, c, m,
                                       h, act, s)
                 : launch<float, false>(x, w_up, w_gate, w_down, out, e, c,
                                        m, h, act, s);
  return gated ? launch<__nv_bfloat16, true>(x, w_up, w_gate, w_down, out, e,
                                             c, m, h, act, s)
               : launch<__nv_bfloat16, false>(x, w_up, w_gate, w_down, out,
                                              e, c, m, h, act, s);
}

}  // extern "C"
