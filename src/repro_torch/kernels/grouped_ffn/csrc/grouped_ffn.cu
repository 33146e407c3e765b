// Grouped expert FFN for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/grouped_ffn/kernel.py,
// grouped_ffn_kernel (bodies _kernel and _kernel_gated): per expert e,
//   out[e] = act(x[e] @ w_up[e]) @ w_down[e]                     (plain)
//   out[e] = (act(x[e] @ w_gate[e]) * (x[e] @ w_up[e])) @ w_down[e] (gated)
// act in {silu, gelu (tanh form), relu}. The hidden activation T_M is
// taken in fp32, the activation applied in fp32, T_M rounded to x's dtype
// (as the TPU kernel's h.astype(x.dtype)) and multiplied into an fp32
// accumulator of the output, rounded once. x [E, C, M]; w_up, w_gate
// [E, M, H]; w_down [E, H, M]; out [E, C, M] in x's dtype.
//
// Bound: HBM bytes. Every weight byte of an expert that has tokens is
// read once: 2 (or 3) * E * M * H elements, 604 MB in bf16 for moe-gpt3-s
// (E 64, M 768, H 3072: ~0.18 ms at 3.35 TB/s) and 1.1 GB for
// DeepSeek-V2-Lite (E 64, M 2048, H 1408, gated: ~0.33 ms), while the
// products (4 * E * C * M * H = 24 GFLOP at C = 40) take ~0.025 ms on the
// tensor cores. Few tokens reach an expert, so the weights, not the
// products, are the cost: the kernel has to spread them over all 132 SMs
// and keep enough bytes in flight on each.
//
// Design (bf16), three launches on the caller's stream:
//  * Zero-expert skip. A first launch reads each x[e] (at decode <= 32 KB
//    an expert) and flags the experts with a non-zero element (a NaN is
//    non-zero). An expert with no tokens has all-zero dispatch rows, so
//    its output is exactly 0 in the plain version (x W = 0, act(0) = 0,
//    act(0) * 0 = 0, and rounding keeps 0): the later launches read none
//    of its weights and write its output rows as 0. This rests on every
//    activation mapping 0 to 0; the wrapper raises for one that does not.
//  * Phase 1, h = act(x w_up) (gated: act(x w_gate) * (x w_up)), one block
//    per (expert, tile of NB hidden columns), written rounded to x's dtype
//    into a transient [E, C, H] T_M buffer that the wrapper allocates and
//    frees. Phase 2, out = h w_down, one block per (expert, tile of NB
//    output columns), fp32 accumulation over all of H and one rounding.
//    No reduction crosses blocks, so the result does not depend on the
//    schedule, and every weight byte is read once. The TPU kernel keeps
//    T_M on chip; the buffer costs 3 MB at C = 8 (15.7 MB at C = 40)
//    against 604 MB of weights.
//  * Tokens on the N side: each phase computes y^T = W^T x^T on
//    mma.sync.m16n8k16 (bf16 in, fp32 accumulators), the weights as A
//    (ldmatrix.trans of their [K, N] rows) and the tokens as B, so C = 8
//    fills an n8 tile with no waste. One block takes all C rows of its
//    item (CT = 16, 64 or 128 rows a pass, by C); past 128 it loops over
//    row groups.
//  * Tile widths fill the card: a block is 64 columns wide (a warp per 16
//    columns), or 32 at C <= 16 where N < 1056 (its 4 warps split K in
//    two, and the halves are added in a fixed order through shared
//    memory), so 8 fed experts keep at least 132 blocks busy in each
//    phase: 384 and 192 at moe-gpt3-s (H 3072, M 768), 176 and 256 at
//    DeepSeek-V2-Lite (H 1408, M 2048). At C = 40 (all 64 experts fed)
//    that is 3072 and 768 blocks.
//  * Bytes in flight: weight K-chunks of 64 rows and the matching token
//    columns stream through a ring of 16-byte cp.async groups with a
//    128-byte L2 prefetch hint, 8 stages deep for 32-column blocks, 6 for
//    64 columns at C <= 16, 4 at C <= 64 and 3 past it (16-40 KB of
//    weights in flight a block, twice that gated); several blocks share
//    an SM, and a deeper ring, which leaves room for fewer of them, was
//    slower. Shared-memory rows are padded by 16 bytes so ldmatrix meets
//    no bank conflict.
//
// fp32 runs on the CUDA cores (TF32 would not hold a 1e-5 limit) in one
// fused launch: one 256-thread block per (expert, 32- or 16-row token
// tile), the x tile in shared memory, w_up (and w_gate) streamed in
// K-chunks and w_down in column chunks through a two-stage cp.async ring,
// T_M on chip, the [TC, M] output accumulator in registers (M <= 2048).
// It has no zero skip: an idle expert's rows come out exactly 0 all the
// same, as products of zeros.
//
// M and H must be multiples of 16 (16-byte copies); any C. Plain C
// interface, loaded with ctypes; the return value is the cudaError_t of
// the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

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
// 16 bytes from gmem, or (full false) 16 zero bytes and no read
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(s),
      "l"(gmem), "r"(full ? 16 : 0));
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

// ---------------------------------------------------------------------------
// The zero-expert flags (bf16): active[e] = x[e] holds a non-zero element
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
    grouped_ffn_active_kernel(const uint4* __restrict__ x, int64_t vecs,
                              int* __restrict__ active) {
  const uint4* xe = x + blockIdx.x * vecs;
  int any = 0;
  for (int64_t i = threadIdx.x; i < vecs && !any; i += blockDim.x) {
    const uint4 u = xe[i];
    // two bf16 a word, sign bits dropped: -0 is zero, a NaN is not
    any = ((u.x | u.y | u.z | u.w) & 0x7fff7fffu) != 0u;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) active[blockIdx.x] = any;
}

// ---------------------------------------------------------------------------
// bf16: y[e] = epilogue(x[e] @ w[e]) on mma.sync, weights as A
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBK = 64;        // K rows a stage
// Columns from which a block is 64 wide: 8 fed experts then still give
// n / 64 * 8 >= 132 blocks, one an SM.
constexpr int kWideN = 1056;

// Ring depth of a block of CT token rows and NB columns (measured on the
// H100: a deeper ring takes shared memory from the blocks that share the
// SM, and fewer blocks move fewer bytes).
template <int CT, int NB>
struct Ring;
template <>
struct Ring<16, 32> {
  static constexpr int STAGES = 8;
};
template <>
struct Ring<16, 64> {
  static constexpr int STAGES = 6;
};
template <>
struct Ring<64, 64> {
  static constexpr int STAGES = 4;
};
template <>
struct Ring<128, 64> {
  static constexpr int STAGES = 3;
};

int rows_cfg(int c) { return c <= 16 ? 16 : c <= 64 ? 64 : 128; }

template <int CT, int NB, bool Gated>
__host__ __device__ constexpr size_t stage_elems() {
  return size_t(Gated ? 2 : 1) * kBK * (NB + 8) + size_t(CT) * (kBK + 8);
}
template <int CT, int NB, bool Gated>
__host__ __device__ constexpr size_t bf16_smem() {
  return Ring<CT, NB>::STAGES * stage_elems<CT, NB, Gated>() * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += A B: A 16x16 bf16, B 16x8 bf16, c 16x8 fp32. Lane l (g = l / 4,
// t = l % 4) holds c[0..1] at row g, columns 2t, 2t + 1; c[2..3] at row
// g + 8.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ROWS x COLS tile of a row-major matrix (row stride ldg, origin g) into
// shared memory (row stride lds) with 16-byte cp.async; elements at or
// past (rmax, cmax) from the origin are zeros (a copy of 0 source bytes
// fills them), so the products past K or C add zeros and the loops over
// them need no guard.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* s, int lds, const bf16* g,
                                          int64_t ldg, int rmax, int cmax) {
  constexpr int VPR = COLS / 8, N = ROWS * VPR;
#pragma unroll
  for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (N % kThreads != 0 && i >= N) break;
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool in = r < rmax && c < cmax;
    cp_async16_zfill(s + r * lds + c, in ? g + r * ldg + c : g, in);
  }
}

// xin [E, C, K], w and wg [E, K, N], y [E, C, N]. act >= 0 applies the
// activation (phase 1; gated: act(x wg) * (x w)); act < 0 writes the sum
// (phase 2). zero_idle: write the output rows of an idle expert as 0.
// The 4 warps cover the block's NB / 16 column tiles: one a warp, or
// (NB = 32) one per pair of warps, which split each stage's K rows and
// add their sums in a fixed order at the end.
template <int CT, int NB, bool Gated>
__global__ void __launch_bounds__(kThreads)
    grouped_ffn_gemm_kernel(const bf16* __restrict__ xin,
                            const bf16* __restrict__ w,
                            const bf16* __restrict__ wg, bf16* __restrict__ y,
                            const int* __restrict__ active, int c, int kdim,
                            int n, int act, int zero_idle) {
  constexpr int STAGES = Ring<CT, NB>::STAGES;
  constexpr int WN = NB / 16;              // 16-column A tiles, a warp each
  constexpr int KSPLIT = 4 / WN;           // warps that share a tile
  constexpr int KSTEPS = kBK / 16 / KSPLIT;  // a warp's k-steps a stage
  constexpr int NT = CT / 8;               // token n-tiles
  constexpr int NW = Gated ? 2 : 1;
  constexpr int LDW = NB + 8, LDX = kBK + 8;
  constexpr int WSZ = kBK * LDW;
  constexpr int STAGE = int(stage_elems<CT, NB, Gated>());
  static_assert(WN * KSPLIT == 4, "4 warps cover the columns");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);   // a stage: w, [wg], x

  const int e = blockIdx.y, n0 = blockIdx.x * NB;
  if (!active[e]) {
    if (zero_idle) {
      constexpr int VPR = NB / 8;
      for (int i = threadIdx.x; i < c * VPR; i += kThreads) {
        const int r = i / VPR, col = n0 + (i % VPR) * 8;
        if (col < n)
          *reinterpret_cast<uint4*>(y + (int64_t(e) * c + r) * n + col) =
              make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % WN, ks = warp / WN;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t kn = int64_t(kdim) * n;
  const bf16* we = w + e * kn + n0;
  const bf16* wge = Gated ? wg + e * kn + n0 : nullptr;
  const int nk = (kdim + kBK - 1) / kBK;
  // per-lane ldmatrix offsets: A from w's [k][n] rows (trans), B from the
  // token rows [c][k]
  const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * LDW + wn * 16 +
                    ((lane >> 3) & 1) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LDX +
                    ((lane >> 3) & 1) * 8;

  for (int r0 = 0; r0 < c; r0 += CT) {
    const bf16* xe = xin + (int64_t(e) * c + r0) * kdim;
    const int rows = min(CT, c - r0);
    float acc[NT][4], accg[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = accg[j][i] = 0.f;

    auto load_stage = [&](int kc) {
      bf16* st = ring + (kc % STAGES) * STAGE;
      const int k0 = kc * kBK;
      load_tile<kBK, NB>(st, LDW, we + int64_t(k0) * n, n, kdim - k0,
                         n - n0);
      if (Gated)
        load_tile<kBK, NB>(st + WSZ, LDW, wge + int64_t(k0) * n, n, kdim - k0,
                           n - n0);
      load_tile<CT, kBK>(st + NW * WSZ, LDX, xe + k0, kdim, rows, kdim - k0);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load_stage(s);
      cp_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + STAGES - 1 < nk) load_stage(kc + STAGES - 1);
      cp_commit();
      cp_wait<STAGES - 1>();    // chunk kc has landed
      __syncthreads();
      const bf16* st = ring + (kc % STAGES) * STAGE;
      const bf16* xs = st + NW * WSZ;
#pragma unroll
      for (int i = 0; i < KSTEPS; ++i) {
        const int kk = (ks + i * KSPLIT) * 16;
        uint32_t a[4], ag[4];
        ldsm_x4_t(a, smem_u32(st + kk * LDW + a_off));
        if (Gated) ldsm_x4_t(ag, smem_u32(st + WSZ + kk * LDW + a_off));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, smem_u32(xs + np * 16 * LDX + kk + b_off));
          mma16816(acc[2 * np], a, b[0], b[1]);
          mma16816(acc[2 * np + 1], a, b[2], b[3]);
          if (Gated) {
            mma16816(accg[2 * np], ag, b[0], b[1]);
            mma16816(accg[2 * np + 1], ag, b[2], b[3]);
          }
        }
      }
      __syncthreads();   // the stage is refilled next
    }
    cp_wait<0>();
    __syncthreads();

    // K-split partials: warps ks > 0 leave theirs in shared memory, the
    // ks == 0 warp of the tile adds them in order
    float* red = reinterpret_cast<float*>(smem);
    constexpr int RED = NT * 4 * NW * 32;    // floats a warp leaves
    if (KSPLIT > 1) {
      if (ks > 0) {
        float* mine = red + ((ks - 1) * WN + wn) * RED;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mine[(j * 4 + i) * 32 + lane] = acc[j][i];
            if (Gated) mine[((NT + j) * 4 + i) * 32 + lane] = accg[j][i];
          }
      }
      __syncthreads();
      if (ks == 0) {
        for (int s = 1; s < KSPLIT; ++s) {
          const float* part = red + ((s - 1) * WN + wn) * RED;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[j][i] += part[(j * 4 + i) * 32 + lane];
              if (Gated) accg[j][i] += part[((NT + j) * 4 + i) * 32 + lane];
            }
        }
      }
    }
    // epilogue: activation in fp32, rounded, through a [CT, NB] tile
    constexpr int LDO = NB + 8;
    bf16* os = reinterpret_cast<bf16*>(
        smem + align128(size_t(KSPLIT - 1) * WN * RED * sizeof(float)));
    if (ks == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = acc[j][i];
          if (act >= 0) v = Gated ? activate(accg[j][i], act) * v
                                  : activate(v, act);
          const int tok = j * 8 + t4 * 2 + (i & 1);
          const int col = wn * 16 + g + (i >> 1) * 8;
          os[tok * LDO + col] = __float2bfloat16(v);
        }
    }
    __syncthreads();
    constexpr int VPR = NB / 8;
    for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
      const int r = i / VPR, cc = (i % VPR) * 8;
      if (n0 + cc < n)
        *reinterpret_cast<uint4*>(y + (int64_t(e) * c + r0 + r) * n + n0 +
                                  cc) =
            *reinterpret_cast<const uint4*>(os + r * LDO + cc);
    }
    __syncthreads();   // the ring and the tile are reused by the next pass
  }
}

template <int CT, int NB, bool Gated>
int launch_gemm(const bf16* xin, const bf16* w, const bf16* wg, bf16* y,
                const int* active, int e, int c, int kdim, int n, int act,
                int zero_idle, cudaStream_t stream) {
  static size_t opted_in = 0;      // dynamic shared memory already allowed
  constexpr size_t smem = bf16_smem<CT, NB, Gated>();
  auto kernel = grouped_ffn_gemm_kernel<CT, NB, Gated>;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid((n + NB - 1) / NB, e);
  kernel<<<grid, kThreads, smem, stream>>>(xin, w, wg, y, active, c, kdim, n,
                                           act, zero_idle);
  return static_cast<int>(cudaGetLastError());
}

// The block width for CT rows and n columns: 32 at decode capacity where
// 64 would leave SMs idle with 8 fed experts, else 64.
int cols_cfg(int ct, int n) { return ct == 16 && n < kWideN ? 32 : 64; }

template <int CT, bool Gated>
int launch_cols(const bf16* xin, const bf16* w, const bf16* wg, bf16* y,
                const int* active, int e, int c, int kdim, int n, int act,
                int zero_idle, cudaStream_t stream) {
  if constexpr (CT == 16) {
    if (cols_cfg(CT, n) == 32)
      return launch_gemm<CT, 32, Gated>(xin, w, wg, y, active, e, c, kdim, n,
                                        act, zero_idle, stream);
  }
  return launch_gemm<CT, 64, Gated>(xin, w, wg, y, active, e, c, kdim, n, act,
                                    zero_idle, stream);
}

template <int CT>
int launch_bf16(const bf16* x, const bf16* wu, const bf16* wg,
                const bf16* wd, bf16* out, bf16* hidden, const int* active,
                int e, int c, int m, int h, int act, cudaStream_t stream) {
  const int err =
      wg != nullptr
          ? launch_cols<CT, true>(x, wu, wg, hidden, active, e, c, m, h, act,
                                  0, stream)
          : launch_cols<CT, false>(x, wu, nullptr, hidden, active, e, c, m, h,
                                   act, 0, stream);
  if (err != 0) return err;
  return launch_cols<CT, false>(hidden, wd, nullptr, out, active, e, c, h, m,
                                -1, 1, stream);
}

template <int CT, bool Gated>
size_t smem_cols(int n) {
  if constexpr (CT == 16) {
    if (cols_cfg(CT, n) == 32) return bf16_smem<CT, 32, Gated>();
  }
  return bf16_smem<CT, 64, Gated>();
}

// Shared memory of the larger of the two phases' blocks.
template <int CT>
size_t smem_bf16(int m, int h, bool gated) {
  const size_t one =
      gated ? smem_cols<CT, true>(h) : smem_cols<CT, false>(h);
  const size_t two = smem_cols<CT, false>(m);
  return one > two ? one : two;
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernel, T_M on chip
// ---------------------------------------------------------------------------

constexpr int kThreads32 = 256;
constexpr int kWarps32 = kThreads32 / 32;
constexpr int kBH = 64;      // hidden columns per H tile
constexpr int kLdf = kBH + 4;
constexpr int kAccFrags = 16;  // output accumulator fragments a warp
constexpr int kPad32 = 4;      // row padding, elements

// Tiling of one block holding TC token rows: GEMM1 K-chunk BK (rows of
// w_up), GEMM2 column chunk WN (of w_down).
template <int TC>
struct Tile32;
template <>
struct Tile32<32> {
  static constexpr int BK = 32, WN = 64;
};
template <>
struct Tile32<16> {
  static constexpr int BK = 16, WN = 128;
};

// The most M a block of TC rows takes: its [TC, M] fp32 output
// accumulator is kAccFrags 16x16 fragments a warp.
template <int TC>
__host__ __device__ constexpr int max_m() {
  return kAccFrags * kWarps32 * 256 / TC;
}
constexpr int kMaxM = max_m<16>();  // 2048

// 16x16 fp32 accumulator; lane l: row l / 2, columns (l % 2) * 8 .. + 8.
struct Fma {
  float v[8];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
  }
  // += A B, A and B row-major in shared memory
  __device__ void mma(const float* a, int lda, const float* b, int ldb) {
    const int lane = threadIdx.x & 31;
    const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float av = a[r * lda + k];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = fmaf(av, b[k * ldb + c0 + i], v[i]);
    }
  }
  __device__ void store(float* p, int ldm) const {
    const int lane = threadIdx.x & 31;
    const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) p[r * ldm + c0 + i] = v[i];
  }
};

// rows x cols fp32 tile (row stride ldg) into shared memory (row stride
// lds); elements at or past (rmax, cmax) are zeros.
__device__ __forceinline__ void load_tile32(float* s, int lds, const float* g,
                                            int64_t ldg, int rows, int cols,
                                            int rmax, int cmax) {
  const int vpr = cols / 4;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads32) {
    const int r = i / vpr, c = (i % vpr) * 4;
    float* dst = s + r * lds + c;
    if (r < rmax && c < cmax)
      cp_async16(dst, g + r * ldg + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

template <int TC>
struct Layout32 {
  size_t xs, wu, wg, wd, hf, hs, total;
  __host__ __device__ Layout32(int m, bool gated) {
    using C = Tile32<TC>;
    const size_t wu_bytes =
        align128(2 * C::BK * (kBH + kPad32) * sizeof(float));
    xs = 0;
    wu = xs + align128(size_t(TC) * (m + kPad32) * sizeof(float));
    wg = wu + wu_bytes;
    wd = wg + (gated ? wu_bytes : 0);
    hf = wd + align128(2 * kBH * (C::WN + kPad32) * sizeof(float));
    hs = hf + align128(2 * TC * kLdf * sizeof(float));
    total = hs + align128(TC * (kBH + kPad32) * sizeof(float));
  }
};

template <bool Gated, int TC>
__global__ void __launch_bounds__(kThreads32, 1)
    grouped_ffn_fp32_kernel(const float* __restrict__ x,
                            const float* __restrict__ w_up,
                            const float* __restrict__ w_gate,
                            const float* __restrict__ w_down,
                            float* __restrict__ out, int c, int m, int h,
                            int act) {
  using C = Tile32<TC>;
  constexpr int BK = C::BK, WN = C::WN, PAD = kPad32;
  constexpr int NFC = WN / 16;             // column fragments per chunk
  constexpr int PER = (TC / 16) * NFC / kWarps32;  // accumulators a warp,
                                                   // a chunk
  constexpr int MAXCH = max_m<TC>() / WN;  // column chunks at most
  constexpr int NF1 = (TC / 16) * (kBH / 16);  // GEMM1 fragments
  static_assert(PER * MAXCH == kAccFrags && PER * kWarps32 == (TC / 16) * NFC,
                "every warp holds kAccFrags output fragments");
  static_assert(NF1 <= kWarps32 && kWarps32 * 256 <= 2 * TC * kLdf,
                "GEMM1 fragments and the epilogue scratch fit");
  extern __shared__ __align__(128) unsigned char smem[];

  const int e = blockIdx.y, row0 = blockIdx.x * TC;
  const Layout32<TC> lay(m, Gated);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  float* wus = reinterpret_cast<float*>(smem + lay.wu);
  float* wgs = reinterpret_cast<float*>(smem + lay.wg);
  float* wds = reinterpret_cast<float*>(smem + lay.wd);
  float* hf = reinterpret_cast<float*>(smem + lay.hf);
  float* hs = reinterpret_cast<float*>(smem + lay.hs);
  const int ldx = m + PAD, ldu = kBH + PAD, ldd = WN + PAD, ldh = kBH + PAD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t mh = int64_t(m) * h;
  const float* wue = w_up + e * mh;
  const float* wge = Gated ? w_gate + e * mh : nullptr;
  const float* wde = w_down + e * mh;

  load_tile32(xs, ldx, x + (int64_t(e) * c + row0) * m, m, TC, m, c - row0,
              m);
  cp_commit();

  Fma acc[MAXCH * PER];
#pragma unroll
  for (int i = 0; i < MAXCH * PER; ++i) acc[i].zero();

  const int nk = (m + BK - 1) / BK, nh = (h + kBH - 1) / kBH;
  const int nch = (m + WN - 1) / WN;
  const int fr = warp / 4, fc = warp % 4;  // this warp's GEMM1 fragment
  const bool g1 = NF1 == kWarps32 || warp < NF1;  // the warp has one
  for (int ht = 0; ht < nh; ++ht) {
    const int h0 = ht * kBH;
    // ---- GEMM1: [TC, M] x [M, 64] -> fp32 hidden tile -----------------
    Fma up, gt;
    up.zero();
    gt.zero();
    load_tile32(wus, ldu, wue + h0, h, BK, kBH, m, h - h0);
    if (Gated) load_tile32(wgs, ldu, wge + h0, h, BK, kBH, m, h - h0);
    cp_commit();
    for (int kc = 0; kc < nk; ++kc) {
      const int st = kc & 1;
      if (kc + 1 < nk) {
        const int64_t off = int64_t(kc + 1) * BK * h + h0;
        load_tile32(wus + (st ^ 1) * BK * ldu, ldu, wue + off, h, BK, kBH,
                    m - (kc + 1) * BK, h - h0);
        if (Gated)
          load_tile32(wgs + (st ^ 1) * BK * ldu, ldu, wge + off, h, BK, kBH,
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
        const float* a = xs + fr * 16 * ldx + k;
        const int boff = st * BK * ldu + kk * 16 * ldu + fc * 16;
        up.mma(a, ldx, wus + boff, ldu);
        if (Gated) gt.mma(a, ldx, wgs + boff, ldu);
      }
      __syncthreads();
    }
    // ---- activation in fp32 ----------------------------------------------
    if (g1) {
      up.store(hf + fr * 16 * kLdf + fc * 16, kLdf);
      if (Gated) gt.store(hf + TC * kLdf + fr * 16 * kLdf + fc * 16, kLdf);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TC * kBH; i += kThreads32) {
      const int r = i / kBH, col = i % kBH;
      const float u = hf[r * kLdf + col];
      hs[r * ldh + col] = Gated
          ? activate(hf[TC * kLdf + r * kLdf + col], act) * u
          : activate(u, act);
    }
    __syncthreads();
    // ---- GEMM2: [TC, 64] x [64, M] into the fp32 output accumulator ----
    const float* wdt = wde + int64_t(h0) * m;
    load_tile32(wds, ldd, wdt, m, kBH, WN, h - h0, m);
    cp_commit();
#pragma unroll
    for (int j = 0; j < MAXCH; ++j) {
      if (j >= nch) break;
      const int st = j & 1;
      if (j + 1 < nch) {
        load_tile32(wds + (st ^ 1) * kBH * ldd, ldd, wdt + (j + 1) * WN, m,
                    kBH, WN, h - h0, m - (j + 1) * WN);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const float* ws = wds + st * kBH * ldd;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int f = warp * PER + i, r = f / NFC, cf = f % NFC;
        if (j * WN + cf * 16 < m) {
#pragma unroll
          for (int kk = 0; kk < kBH / 16; ++kk)
            acc[j * PER + i].mma(hs + r * 16 * ldh + kk * 16, ldh,
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
        acc[j * PER + i].store(scr, 16);
        __syncwarp();
        for (int q = lane; q < 256; q += 32) {
          const int row = row0 + r * 16 + q / 16;
          if (row < c) out[(int64_t(e) * c + row) * m + col0 + q % 16] = scr[q];
        }
        __syncwarp();
      }
    }
  }
}

// Token rows an fp32 block holds at this M: 32 while the accumulator
// allows it.
int rows_fp32(int m) { return m <= max_m<32>() ? 32 : 16; }

size_t smem_fp32(int m, bool gated) {
  return rows_fp32(m) == 32 ? Layout32<32>(m, gated).total
                            : Layout32<16>(m, gated).total;
}

template <bool Gated, int TC>
int launch_fp32_rows(const float* x, const float* wu, const float* wg,
                     const float* wd, float* out, int e, int c, int m, int h,
                     int act, cudaStream_t stream) {
  static size_t opted_in = 0;
  const size_t smem = Layout32<TC>(m, Gated).total;
  auto kernel = grouped_ffn_fp32_kernel<Gated, TC>;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid((c + TC - 1) / TC, e);
  kernel<<<grid, kThreads32, smem, stream>>>(x, wu, wg, wd, out, c, m, h,
                                             act);
  return static_cast<int>(cudaGetLastError());
}

template <bool Gated>
int launch_fp32(const float* x, const float* wu, const float* wg,
                const float* wd, float* out, int e, int c, int m, int h,
                int act, cudaStream_t stream) {
  if (rows_fp32(m) == 32)
    return launch_fp32_rows<Gated, 32>(x, wu, wg, wd, out, e, c, m, h, act,
                                       stream);
  return launch_fp32_rows<Gated, 16>(x, wu, wg, wd, out, e, c, m, h, act,
                                     stream);
}

size_t flags_bytes(int e) {
  return (size_t(e) * sizeof(int) + 255) / 256 * 256;
}

}  // namespace

extern "C" {

int grouped_ffn_max_m() { return kMaxM; }

// Dynamic shared memory the largest block of this shape needs (dtype:
// 0 float32, 1 bfloat16).
size_t grouped_ffn_smem_bytes(int c, int m, int h, int gated, int dtype) {
  if (dtype == 0) return smem_fp32(m, gated != 0);
  const int ct = rows_cfg(c);
  return ct == 16   ? smem_bf16<16>(m, h, gated != 0)
         : ct == 64 ? smem_bf16<64>(m, h, gated != 0)
                    : smem_bf16<128>(m, h, gated != 0);
}

size_t grouped_ffn_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return static_cast<size_t>(v);
}

// Scratch the wrapper allocates for a call: none in fp32; in bf16 the
// expert flags, then the [E, C, H] T_M buffer.
size_t grouped_ffn_workspace_bytes(int e, int c, int h, int dtype) {
  return dtype == 0 ? 0 : flags_bytes(e) + size_t(e) * c * h * sizeof(bf16);
}

// x [E, C, M]; w_up, w_gate [E, M, H] (w_gate null when not gated);
// w_down [E, H, M]; out [E, C, M]; all of one dtype, contiguous, 16-byte
// aligned; workspace of grouped_ffn_workspace_bytes, 256-byte aligned.
// act: 0 silu, 1 gelu (tanh form), 2 relu.
int grouped_ffn(const void* x, const void* w_up, const void* w_gate,
                const void* w_down, void* out, void* workspace, int e, int c,
                int m, int h, int act, int dtype, void* stream) {
  if (m % 16 || h % 16 || m > kMaxM || m <= 0 || h <= 0 || act < 0 ||
      act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (e <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float *xf = static_cast<const float*>(x),
                *wu = static_cast<const float*>(w_up),
                *wg = static_cast<const float*>(w_gate),
                *wd = static_cast<const float*>(w_down);
    float* of = static_cast<float*>(out);
    return wg != nullptr
               ? launch_fp32<true>(xf, wu, wg, wd, of, e, c, m, h, act, s)
               : launch_fp32<false>(xf, wu, wg, wd, of, e, c, m, h, act, s);
  }
  int* active = static_cast<int*>(workspace);
  grouped_ffn_active_kernel<<<e, 256, 0, s>>>(
      static_cast<const uint4*>(x), int64_t(c) * m / 8, active);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16 *xb = static_cast<const bf16*>(x),
             *wu = static_cast<const bf16*>(w_up),
             *wg = static_cast<const bf16*>(w_gate),
             *wd = static_cast<const bf16*>(w_down);
  bf16* ob = static_cast<bf16*>(out);
  bf16* hidden = reinterpret_cast<bf16*>(static_cast<char*>(workspace) +
                                         flags_bytes(e));
  switch (rows_cfg(c)) {
    case 16:
      return launch_bf16<16>(xb, wu, wg, wd, ob, hidden, active, e, c, m, h,
                             act, s);
    case 64:
      return launch_bf16<64>(xb, wu, wg, wd, ob, hidden, active, e, c, m, h,
                             act, s);
    default:
      return launch_bf16<128>(xb, wu, wg, wd, ob, hidden, active, e, c, m, h,
                              act, s);
  }
}

}  // extern "C"
