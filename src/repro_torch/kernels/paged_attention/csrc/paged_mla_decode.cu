// Paged MLA latent decode for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py,
// paged_mla_decode_kernel (body _mla_kernel): DeepSeek-V2's absorbed
// multi-head latent attention for one decode query per slot over a page
// table. For slot b and head h, over the key positions t <= lens[b]
// (lens is the slot's position *before* this step's token, whose latent
// was scattered already, so t = 0 is always visible):
//   s[h, t] = (q_abs[b, h] . c_kv[t] + q_rope[b, h] . k_rope[t]) * scale
//   p = softmax_t(s[h]);  ctx[b, h] = sum_t p[h, t] * c_kv[t]
// The latent c_kv serves as both key and value, and one page of it is
// shared by all H heads. q_abs [B, H, R], q_rope [B, H, E] and the pools
// ckv [P, ps, R], kr [P, ps, E] are of one dtype (float32 or bfloat16);
// the context [B, H, R] is float32, as the TPU kernel's.
//
// Bound: HBM bytes, sum_b (lens_b + 1) * (R + E) * itemsize plus q and
// out: a latent row is 1,152 bytes in bf16 at R 512, E 64. At the serving
// engine's shape (8 slots, at most 512 tokens, 1,541 visible) that is
// 1.8 MB, 0.65 us at 3.35 TB/s, so the fixed cost of a launch and of its
// DRAM round trips sets the time; at 32 slots x 4096 tokens it is ~151 MB,
// 45.6 us.
//
// Design:
//  * Split T. Block (b, split) takes the tokens [split * ts, (split + 1) *
//    ts) of slot b that are visible; paged_mla_decode_splits picks the
//    splits so that the grid fits the card's resident blocks (one a SM)
//    with at least kMinSplitTokens a split: 32 slots x 4096 take 4 splits
//    (128 blocks on 132 SMs, one wave), the engine's 8 slots x 512 take 8
//    (64 blocks of two tiles, 2 MB of workspace). A block past lens writes
//    an empty partial.
//  * One block holds all H <= 16 heads of its slot and walks its tokens in
//    tiles (32 tokens in bf16, 16 in fp32) through a 3-stage cp.async
//    ring; each tile's latent and rotary rows are copied into shared
//    memory once, by 8 (bf16) or 16 (fp32) threads a row, and all heads
//    read them there. That sharing is MLA's point. Rows past the visible
//    tokens are zero-filled, never read from the pools, so the sink page
//    and stale pages never reach the arithmetic. Three block barriers a
//    tile: the tile has landed, the scores are in, the probabilities are
//    in. The second stays because a warp holds only a quarter of the depth
//    (its query fragments for all 36 k-steps would take 144 registers), so
//    every score is a sum over four warps; the third because PV reads
//    every head's probabilities.
//  * bf16 scores on the tensor cores: mma.sync.m16n8k16 (heads x tokens),
//    fp32 accumulation. Warp w owns 16 tokens (w % 2) and a quarter of the
//    R + E depth (w / 2); its query fragments stay in registers for the
//    whole block (36 registers at DeepSeek-V2's widths); the four depth
//    quarters are summed once a tile. Products of bf16 values are exact in
//    fp32, as in the plain version's fp32 einsum.
//  * Online softmax per head, all in fp32 (log2 domain, the scale folded
//    into one multiply): 16 lanes per head.
//  * bf16 PV on the tensor cores, exact in P: each fp32 probability p is
//    split into three bf16 terms hi = bf16(p), mid = bf16(p - hi), lo =
//    bf16(p - hi - mid), with hi + mid + lo == p for p above ~1e-33, and
//    mma.sync multiplies each plane by the bf16 latents (exact) into fp32
//    accumulators: warp w owns latent columns [64 w, 64 w + 64), 32
//    accumulators a thread.
//  * fp32 on the CUDA cores, register-tiled (no TF32): scores by 4 heads x
//    4 tokens a thread over 1/16 of the depth (float4 loads of q and k,
//    64 FMAs per 8 loads), the 16 depth slices summed once a tile; PV with
//    thread i owning latent columns 2i, 2i + 1 for all 16 heads.
//  * Merging. With one split the block normalises and writes the output.
//    With more, each block writes its unnormalised context and (m, l) per
//    head to a workspace, and a second launch of B x H blocks merges the
//    splits, each thread reading its first contexts before the weights
//    are in. A partial is 32 KB (16 heads x 512 fp32): merging a slot in
//    the last of its blocks to finish, as the GQA kernel does, leaves one
//    SM reading 128-256 KB, which was slower at the engine shape.
//  * DeepSeek-V2's widths (R 512, E 64) get an instantiation of their own
//    with both as constants, so the bf16 loops carry no guard; every other
//    shape takes the generic one.
//  * Plain C interface, loaded with ctypes. The wrapper allocates the
//    output and the workspace; the launches go on the caller's stream; the
//    return value is the cudaError_t of the launches.
//
// Measured (chip_smoke.py and tools/torch_kernel_bench.py; NVIDIA H100
// 80GB HBM3, 700.00 W; device ms): the engine shape 0.0089 in bf16
// (bound 0.00065; 8 splits: the decode launch 0.0066, the merge 0.0024);
// 32 slots x 4096 0.069, 66% of its 0.0456 bound; fp32 engine 0.0183 and
// 32 x 4096 0.224, where the plain version takes 0.670. The generic
// instantiation at the same widths, in the same call: bf16 0.0103 and
// 0.0925, fp32 0.0196 and 0.234.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kH = 16;                // heads a block holds (mma rows)
constexpr int kStages = 3;            // cp.async ring
constexpr int kMaxR = 512;
constexpr int kMaxE = 128;
constexpr int kMaxKs = (kMaxR + kMaxE) / 16;   // depth k-steps
constexpr int kMinSplitTokens = 64;   // fewest tokens worth a block
constexpr int kMaxSplits = 256;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kH * 16 == kThreads, "softmax: 16 lanes a head");

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}
__host__ __device__ constexpr int round16(int d) { return (d + 15) / 16 * 16; }

// Per dtype: tokens a tile, row padding (16 bytes: rows of a tile start on
// distinct bank groups), and the scores' partial sums in shared memory.
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int kTile = 32;
  static constexpr int kPad = 8;
  static constexpr int kLdS = kTile + 8;        // [4 quarters, kH, kLdS]
  static constexpr size_t kSBytes = sizeof(float) * 4 * kH * kLdS;
  static constexpr int kLdP = kTile + 8;        // [3 planes, kH, kLdP] bf16
  static constexpr size_t kPBytes = sizeof(bf16) * 3 * kH * kLdP;
};
template <>
struct Cfg<float> {
  static constexpr int kTile = 16;
  static constexpr int kPad = 4;
  static constexpr int kSlice = kH * kTile + 4;  // [16 slices, kH, kTile]
  static constexpr size_t kSBytes = sizeof(float) * 16 * kSlice;
  static constexpr size_t kPBytes = sizeof(float) * kTile * kH;  // [t, h]
};

// Shared-memory layout of one block; the kernel and the host both read it.
template <typename T>
struct Layout {
  int dp, ld;   // depth rounded up to 16; row stride of q and tiles
  size_t q, kv, s, p, alpha, ml, total;
  __host__ __device__ Layout(int r, int e) {
    dp = round16(r + e);
    ld = dp + Cfg<T>::kPad;
    q = 0;                                                     // [kH, ld]
    kv = q + align128(size_t(kH) * ld * sizeof(T));
    s = kv + align128(size_t(kStages) * Cfg<T>::kTile * ld * sizeof(T));
    p = s + align128(Cfg<T>::kSBytes);
    alpha = p + align128(Cfg<T>::kPBytes);
    ml = alpha + align128(kH * sizeof(float));                 // [2, kH]
    total = ml + align128(2 * kH * sizeof(float));
  }
};

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i receives lane l's share of matrix i: row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 (.trans: column l / 4, rows 2 (l % 4)
// and 2 (l % 4) + 1).
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

// c += A B: A 16x16 row-major bf16 (4 registers), B 16x8 column-major
// (2 registers), c 16x8 fp32: lane l holds rows l / 4 and l / 4 + 8,
// columns 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void set_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void set_zero(bf16* p) {
  *p = __float2bfloat16(0.f);
}

// ---------------------------------------------------------------------------
// bf16: scores and PV on mma.sync
// ---------------------------------------------------------------------------

// Scores of one tile, S[h, j] = q[h] . kv[j] over the depth: warp w takes
// tokens [16 (w % 2), +16) and depth k-steps [k0, k0 + nk), quarter w / 2;
// the quarters' sums go to s_s [4, kH, kLdS] and read() adds them. kFull:
// every quarter holds exactly kKq k-steps, so the loop needs no guard.
template <int kKq, bool kFull>
struct ScoresBf16 {
  using C = Cfg<bf16>;
  uint32_t qf[kKq][4];   // this warp's query fragments
  int k0, nk;

  __device__ void init(const bf16* qs, int ld, int ks) {
    const int lane = threadIdx.x & 31, quarter = threadIdx.x >> 6;
    const int kq = (ks + 3) / 4;
    k0 = quarter * kq;
    nk = kFull ? kKq : min(kq, ks - k0);
#pragma unroll
    for (int kk = 0; kk < kKq; ++kk)
      if (kFull || kk < nk)
        ldsm_x4(qf[kk], smem_u32(qs + (lane & 15) * ld + (k0 + kk) * 16 +
                                 (lane >> 4) * 8));
  }

  __device__ void run(const bf16* kt, int ld, float* s_s) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int pair = warp & 1, quarter = warp >> 1;
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const bf16* rows =
        kt + (pair * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
        ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kKq; ++kk) {
      if (kFull || kk < nk) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(rows + (k0 + kk) * 16));
        mma16816(c[0], qf[kk], b[0], b[1]);
        mma16816(c[1], qf[kk], b[2], b[3]);
      }
    }
    const int g = lane >> 2, t4 = lane & 3;
    float* sq = s_s + quarter * kH * C::kLdS;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = pair * 16 + n * 8 + 2 * t4;
      *reinterpret_cast<float2*>(sq + g * C::kLdS + col) =
          make_float2(c[n][0], c[n][1]);
      *reinterpret_cast<float2*>(sq + (g + 8) * C::kLdS + col) =
          make_float2(c[n][2], c[n][3]);
    }
  }

  __device__ static float read(const float* s_s, int h, int j) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) s += s_s[(q * kH + h) * C::kLdS + j];
    return s;
  }
};

// Probabilities of head h, token j as three bf16 planes [3, kH, kLdP]:
// hi + mid + lo == p.
__device__ __forceinline__ void put_p(bf16* planes, int h, int j, float p) {
  using C = Cfg<bf16>;
  const bf16 hi = __float2bfloat16_rn(p);
  const float r1 = p - __bfloat162float(hi);
  const bf16 mid = __float2bfloat16_rn(r1);
  const bf16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
  planes[h * C::kLdP + j] = hi;
  planes[(kH + h) * C::kLdP + j] = mid;
  planes[(2 * kH + h) * C::kLdP + j] = lo;
}

// ctx += P V on the tensor cores: warp w owns the latent column pairs (16
// columns each) [w * kPairs, ...); 4 pairs at R 512. kFull: every warp
// owns exactly kPairs.
template <int kPairs, bool kFull>
struct PvBf16 {
  using C = Cfg<bf16>;
  float acc[kPairs][2][4];
  int pr0, npr;

  __device__ void init(int R) {
    const int warp = threadIdx.x >> 5;
    const int pairs = R / 16, per = (pairs + kWarps - 1) / kWarps;
    pr0 = kFull ? warp * kPairs : warp * per;
    npr = kFull ? kPairs : min(per, pairs - pr0);
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
  }

  __device__ void rescale(const float* alpha_s) {
    const int g = (threadIdx.x & 31) >> 2;
    const float a0 = alpha_s[g], a1 = alpha_s[g + 8];
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        acc[i][n][0] *= a0;
        acc[i][n][1] *= a0;
        acc[i][n][2] *= a1;
        acc[i][n][3] *= a1;
      }
  }

  // rows past the tile's live tokens are zero with p = 0
  __device__ void run(const bf16* kt, int ld, const bf16* planes, int) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < C::kTile / 16; ++kk) {
      uint32_t pa[3][4];
#pragma unroll
      for (int x = 0; x < 3; ++x)
        ldsm_x4(pa[x], smem_u32(planes + (x * kH + (lane & 15)) * C::kLdP +
                                kk * 16 + (lane >> 4) * 8));
      const bf16* vrow =
          kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
          (lane >> 4) * 8;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        if (kFull || i < npr) {
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(vrow + (pr0 + i) * 16));
#pragma unroll
          for (int x = 0; x < 3; ++x) {
            mma16816(acc[i][0], pa[x], b[0], b[1]);
            mma16816(acc[i][1], pa[x], b[2], b[3]);
          }
        }
      }
    }
  }

  // dst[h, c] = acc[h, c] * f[h] for h < H (dst rows of R floats)
  __device__ void store(float* dst, int R, int H, const float* f) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (kFull || i < npr) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = (pr0 + i) * 16 + n * 8 + 2 * t4;
          if (g < H)
            *reinterpret_cast<float2*>(dst + g * R + col) =
                make_float2(acc[i][n][0] * f[g], acc[i][n][1] * f[g]);
          if (g + 8 < H)
            *reinterpret_cast<float2*>(dst + (g + 8) * R + col) = make_float2(
                acc[i][n][2] * f[g + 8], acc[i][n][3] * f[g + 8]);
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// fp32: scores and PV on the CUDA cores
// ---------------------------------------------------------------------------

// Thread (slice ds = tid % 16, heads 4 hg.., tokens 4 tg..) sums its 4 x 4
// block over the depth's float4 chunks ds, ds + 16, ...; s_s [16, kSlice].
struct ScoresF32 {
  using C = Cfg<float>;
  const float* qs;
  int dp;

  __device__ void init(const float* q, int, int ks) {
    qs = q;
    dp = ks * 16;
  }

  __device__ void run(const float* kt, int ld, float* s_s) const {
    const int tid = threadIdx.x, ds = tid & 15, mt = tid >> 4;
    const int hg = mt >> 2, tg = mt & 3;
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
    for (int c = ds; c < dp / 4; c += 16) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] =
            *reinterpret_cast<const float4*>(qs + (4 * hg + i) * ld + 4 * c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] =
            *reinterpret_cast<const float4*>(kt + (4 * tg + j) * ld + 4 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[i][j] = fmaf(qv[i].x, kv[j].x, a[i][j]);
          a[i][j] = fmaf(qv[i].y, kv[j].y, a[i][j]);
          a[i][j] = fmaf(qv[i].z, kv[j].z, a[i][j]);
          a[i][j] = fmaf(qv[i].w, kv[j].w, a[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(s_s + ds * C::kSlice +
                                 (4 * hg + i) * C::kTile + 4 * tg) =
          make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
  }

  __device__ static float read(const float* s_s, int h, int j) {
    float s = 0.f;
#pragma unroll
    for (int ds = 0; ds < 16; ++ds) s += s_s[ds * C::kSlice + h * C::kTile + j];
    return s;
  }
};

// Thread i owns latent columns 2i, 2i + 1 for all kH heads.
struct PvF32 {
  using C = Cfg<float>;
  float acc[kH][2];
  int c0;
  bool own;

  __device__ void init(int R) {
    c0 = 2 * threadIdx.x;
    own = c0 < R;
#pragma unroll
    for (int h = 0; h < kH; ++h) acc[h][0] = acc[h][1] = 0.f;
  }

  __device__ void rescale(const float* alpha_s) {
    if (!own) return;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float a = alpha_s[h];
      acc[h][0] *= a;
      acc[h][1] *= a;
    }
  }

  __device__ void run(const float* kt, int ld, const float* p_s, int nv) {
    if (!own) return;
    for (int j = 0; j < nv; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(kt + j * ld + c0);
      const float4* pj = reinterpret_cast<const float4*>(p_s + j * kH);
#pragma unroll
      for (int q4 = 0; q4 < kH / 4; ++q4) {
        const float4 p4 = pj[q4];
        acc[4 * q4][0] = fmaf(p4.x, v.x, acc[4 * q4][0]);
        acc[4 * q4][1] = fmaf(p4.x, v.y, acc[4 * q4][1]);
        acc[4 * q4 + 1][0] = fmaf(p4.y, v.x, acc[4 * q4 + 1][0]);
        acc[4 * q4 + 1][1] = fmaf(p4.y, v.y, acc[4 * q4 + 1][1]);
        acc[4 * q4 + 2][0] = fmaf(p4.z, v.x, acc[4 * q4 + 2][0]);
        acc[4 * q4 + 2][1] = fmaf(p4.z, v.y, acc[4 * q4 + 2][1]);
        acc[4 * q4 + 3][0] = fmaf(p4.w, v.x, acc[4 * q4 + 3][0]);
        acc[4 * q4 + 3][1] = fmaf(p4.w, v.y, acc[4 * q4 + 3][1]);
      }
    }
  }

  __device__ void store(float* dst, int R, int H, const float* f) const {
    if (!own) return;
#pragma unroll
    for (int h = 0; h < kH; ++h)
      if (h < H)
        *reinterpret_cast<float2*>(dst + h * R + c0) =
            make_float2(acc[h][0] * f[h], acc[h][1] * f[h]);
  }
};

// Per dtype and width: the scores, PV and probability store above. kFixed:
// DeepSeek-V2's R 512, E 64 as constants.
template <typename T, bool kFixed>
struct Parts;
template <bool kFixed>
struct Parts<bf16, kFixed> {
  using Scores = ScoresBf16<kFixed ? 9 : (kMaxKs + 3) / 4, kFixed>;
  using Pv = PvBf16<kMaxR / 16 / kWarps, kFixed>;
  __device__ static void put(void* p_s, int h, int j, float p) {
    put_p(static_cast<bf16*>(p_s), h, j, p);
  }
  using PArg = const bf16*;
};
template <bool kFixed>
struct Parts<float, kFixed> {
  using Scores = ScoresF32;
  using Pv = PvF32;
  __device__ static void put(void* p_s, int h, int j, float p) {
    static_cast<float*>(p_s)[j * kH + h] = p;
  }
  using PArg = const float*;
};

// Block (b, h): out[b, h] = sum_s w_s ctx_s / sum_s w_s l_s over the
// splits of slot b, w_s = 2^(m_s - max m); an empty split (l = 0) weighs
// 0. The workspace holds the contexts [B, splits, H, R], then (m, l) [B,
// splits, H, 2].
__global__ void __launch_bounds__(kThreads)
    paged_mla_combine_kernel(const float* __restrict__ ws,
                             float* __restrict__ out, int H, int R,
                             int splits) {
  constexpr int kPre = 8;   // contexts read before the weights are in
  extern __shared__ float w_s[];   // [splits]
  const int b = blockIdx.x, h = blockIdx.y, B = gridDim.x;
  const float* ctx = ws + size_t(b) * splits * H * R;
  const float* ml =
      ws + size_t(B) * splits * H * R + size_t(b) * splits * H * 2;
  const int c = 2 * threadIdx.x;   // R <= 2 * kThreads: one pair a thread
  const bool own = c < R;
  float2 pre[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k)
    pre[k] = own && k < splits ? *reinterpret_cast<const float2*>(
                                     ctx + (size_t(k) * H + h) * R + c)
                               : make_float2(0.f, 0.f);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mx = -INFINITY;
    for (int s = lane; s < splits; s += 32) {
      const float2 v =
          *reinterpret_cast<const float2*>(ml + (size_t(s) * H + h) * 2);
      if (v.y > 0.f) mx = fmaxf(mx, v.x);
    }
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float2 v =
          *reinterpret_cast<const float2*>(ml + (size_t(s) * H + h) * 2);
      const float f = v.y > 0.f ? exp2f(v.x - mx) : 0.f;
      w_s[s] = f;
      l += f * v.y;
    }
    const float inv = 1.f / fmaxf(warp_sum(l), 1e-30f);
    for (int s = lane; s < splits; s += 32) w_s[s] *= inv;
  }
  __syncthreads();
  if (!own) return;
  float2 v = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    if (k < splits) {
      v.x = fmaf(w_s[k], pre[k].x, v.x);
      v.y = fmaf(w_s[k], pre[k].y, v.y);
    }
  }
  for (int s = kPre; s < splits; ++s) {
    const float2 x =
        *reinterpret_cast<const float2*>(ctx + (size_t(s) * H + h) * R + c);
    v.x = fmaf(w_s[s], x.x, v.x);
    v.y = fmaf(w_s[s], x.y, v.y);
  }
  *reinterpret_cast<float2*>(out + (size_t(b) * H + h) * R + c) = v;
}

template <typename T, bool kFixed>
__global__ void __launch_bounds__(kThreads, 1)
    paged_mla_decode_kernel(const T* __restrict__ q_abs,
                      const T* __restrict__ q_rope,
                      const T* __restrict__ ckv, const T* __restrict__ kr,
                      const int* __restrict__ page_table,
                      const int* __restrict__ lens, float* __restrict__ out,
                      float* __restrict__ ws, int H, int R_, int E_, int ps,
                      int NP, int ts, float scale_log2) {
  using P = Parts<T, kFixed>;
  constexpr int kTile = Cfg<T>::kTile;
  constexpr int V = 16 / sizeof(T);                 // elements a copy
  constexpr int kTpr = kThreads / kTile;            // copy threads a row
  const int R = kFixed ? 512 : R_, E = kFixed ? 64 : E_;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> lay(R, E);
  const int ld = lay.ld, D = R + E, ks = lay.dp / 16;
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  T* kvs = reinterpret_cast<T*>(smem + lay.kv);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  void* p_s = smem + lay.p;
  float* alpha_s = reinterpret_cast<float*>(smem + lay.alpha);
  float* ml_s = reinterpret_cast<float*>(smem + lay.ml);   // m [kH], l [kH]

  const int b = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x;
  const int t0 = split * ts;
  const int* pt = page_table + size_t(b) * NP;
  const uint32_t pmagic = ps > 1 ? 0xffffffffu / uint32_t(ps) + 1u : 0u;
  // Pool row of this thread's row j_row = tid / kTpr of tile it, its
  // position clamped into the table, so the read needs no lens: the first
  // tiles' page ids are read beside lens, and the loop asks a tile ahead.
  const int j_row = tid / kTpr;
  auto row_of = [&](int it) -> int {
    const int t = min(t0 + it * kTile + j_row, NP * ps - 1);
    const int pi = ps > 1 ? int(__umulhi(uint32_t(t), pmagic)) : t;
    return __ldg(pt + pi) * ps + (t - pi * ps);
  };
  int rows[kStages - 1];
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) rows[k] = row_of(k);
  const int last = min(max(lens[b], 0), NP * ps - 1);   // visible: t <= last
  const int n = min(t0 + ts, last + 1) - t0;          // may be <= 0

  // softmax state of head hs = tid / 16, the same in its 16 lanes
  const int hs = tid >> 4, js = tid & 15;
  float m_run = -INFINITY, l_run = 0.f;
  typename P::Pv pv;
  pv.init(R);
  typename P::Scores sc;

  if (n > 0) {
    const int va = R / V, vr = D / V;   // copies a row: latent, both
    // zero q's rows past H and the depth's tail past R + E in q and every
    // stage; the copies below never write there
    const int tail = lay.dp - D;
    for (int i = tid; i < (kH + kStages * kTile) * tail; i += kThreads) {
      const int row = i / tail;
      set_zero((row < kH ? qs + row * ld : kvs + (row - kH) * ld) + D +
               i % tail);
    }
    for (int i = tid; i < kH * vr; i += kThreads) {
      const int h = i / vr, c = i % vr;
      T* d = qs + h * ld + (c < va ? c * V : R + (c - va) * V);
      if (h < H)
        cp_async16(d, c < va ? q_abs + (size_t(b) * H + h) * R + c * V
                             : q_rope + (size_t(b) * H + h) * E + (c - va) * V);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
    // Tile it into stage st from pool row `row`: row j_row takes copies
    // tid % kTpr, + kTpr, ... of its latent and rotary rows; rows past the
    // visible tokens are zero-filled.
    auto load_tile = [&](int it, int row, int st) {
      T* dst = kvs + (st * kTile + j_row) * ld;
      if (it * kTile + j_row < n) {
        const T* a = ckv + size_t(row) * R;
        const T* r = kr + size_t(row) * E;
        for (int c = tid % kTpr; c < vr; c += kTpr)
          cp_async16(dst + (c < va ? c * V : R + (c - va) * V),
                     c < va ? a + c * V : r + (c - va) * V);
      } else {
        for (int c = tid % kTpr; c < vr; c += kTpr)
          *reinterpret_cast<uint4*>(dst + (c < va ? c * V : R + (c - va) * V)) =
              make_uint4(0, 0, 0, 0);
      }
    };
    const int ntiles = (n + kTile - 1) / kTile;
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {   // q rides with tile 0
      if (k < ntiles) load_tile(k, rows[k], k);
      cp_commit();
    }
    int row_next = row_of(kStages - 1);
    for (int it = 0; it < ntiles; ++it) {
      cp_wait<kStages - 2>();
      __syncthreads();   // tile it has landed; every warp is past tile it - 1
      if (it == 0) sc.init(qs, ld, ks);
      if (it + kStages - 1 < ntiles) {
        load_tile(it + kStages - 1, row_next, (it + kStages - 1) % kStages);
        row_next = row_of(it + kStages);
      }
      cp_commit();
      const T* kt = kvs + (it % kStages) * kTile * ld;
      const int nv = min(kTile, n - it * kTile);   // live tokens, >= 1

      sc.run(kt, ld, s_s);
      __syncthreads();

      {  // online softmax: 16 lanes per head
        float sv[kTile / 16];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < kTile / 16; ++u) {
          const int j = js + 16 * u;
          sv[u] = j < nv ? P::Scores::read(s_s, hs, j) * scale_log2
                         : -INFINITY;
          mx = fmaxf(mx, sv[u]);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mn = fmaxf(m_run, mx);   // finite: token 0 is live
        const float alpha = exp2f(m_run - mn);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < kTile / 16; ++u) {
          const float p = exp2f(sv[u] - mn);
          P::put(p_s, hs, js + 16 * u, p);
          psum += p;
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, o);
        l_run = l_run * alpha + psum;
        m_run = mn;
        if (js == 0) alpha_s[hs] = alpha;
      }
      __syncthreads();

      pv.rescale(alpha_s);
      pv.run(kt, ld, static_cast<typename P::PArg>(p_s), nv);
    }
    cp_wait<0>();
  }

  if (js == 0) {
    ml_s[hs] = m_run;
    ml_s[kH + hs] = l_run;
  }
  __syncthreads();
  if (splits == 1) {   // n >= 1 here: the one split holds t = 0
    float* inv = alpha_s;   // free now
    if (tid < kH) inv[tid] = 1.f / fmaxf(ml_s[kH + tid], 1e-30f);
    __syncthreads();
    pv.store(out + size_t(b) * H * R, R, H, inv);
    return;
  }
  float* one = alpha_s;
  if (tid < kH) one[tid] = 1.f;
  const size_t row = size_t(b) * splits + split;
  if (tid < H) {
    float* wml = ws + size_t(gridDim.x) * splits * H * R + (row * H + tid) * 2;
    wml[0] = ml_s[tid];
    wml[1] = ml_s[kH + tid];
  }
  __syncthreads();
  pv.store(ws + row * H * R, R, H, one);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Tokens a split takes: a whole number of 32-token tiles (both dtypes').
int tokens_per_split(int t, int splits) {
  return ceil_div(ceil_div(t, splits), 32) * 32;
}

// R a multiple of 16 (PV column pairs), E of 8 (16-byte copies in bf16),
// R <= 512, E <= 128.
bool shape_ok(int H, int R, int E, int ps, int NP) {
  return H >= 1 && H <= kH && R >= 16 && R <= kMaxR && R % 16 == 0 &&
         E >= 8 && E <= kMaxE && E % 8 == 0 && ps >= 1 && NP >= 1;
}

constexpr int kMaxDevices = 64;

// Makes `device` current until the guard goes, where it was not.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    int cur = -1;
    err = cudaGetDevice(&cur);
    if (err != cudaSuccess || cur == device) return;
    err = cudaSetDevice(device);
    if (err == cudaSuccess) prev = cur;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Opts the kernel in to `smem` bytes of shared memory on the current
// device where it asks above 48 KB: the attribute is set per device, and
// each device keeps the highest size it was set to.
template <typename T, bool kFixed>
cudaError_t prepare(size_t smem) {
  static size_t opted[kMaxDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(paged_mla_decode_kernel<T, kFixed>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err == cudaSuccess && dev < kMaxDevices) opted[dev] = smem;
  return err;
}

template <typename T, bool kFixed>
int occupancy(int R, int E) {
  const size_t smem = Layout<T>(R, E).total;
  int n = 0;
  if (prepare<T, kFixed>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, paged_mla_decode_kernel<T, kFixed>, kThreads, smem) !=
          cudaSuccess)
    return 0;
  return n;
}

template <typename T, bool kFixed>
int launch(const void* q_abs, const void* q_rope, const void* ckv,
           const void* kr, const void* page_table, const void* lens,
           float* out, float* ws, int B, int H, int R, int E, int ps, int NP,
           int splits, float scale, cudaStream_t stream) {
  const size_t smem = Layout<T>(R, E).total;
  cudaError_t err = prepare<T, kFixed>(smem);
  if (err != cudaSuccess) return int(err);
  paged_mla_decode_kernel<T, kFixed>
      <<<dim3(B, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q_abs), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(kr),
      static_cast<const int*>(page_table), static_cast<const int*>(lens), out,
      ws, H, R, E, ps, NP, tokens_per_split(ps * NP, splits),
      scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  paged_mla_combine_kernel<<<dim3(B, H), kThreads, sizeof(float) * splits,
                       stream>>>(ws, out, H, R, splits);
  return int(cudaGetLastError());
}

bool fixed(int R, int E) { return R == 512 && E == 64; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.

// How many splits of the table's ps * NP positions the launch takes for B
// slots on `device`: as many as fill the SMs' resident blocks, with at
// least kMinSplitTokens positions a split (whole 32-token tiles). 0 when
// the kernel does not take the shape (H > 16, R not a multiple of 16 up
// to 512, E not a multiple of 8 up to 128) or the query fails. With more
// than one split the launch needs a workspace of B * splits * H * (R + 2)
// floats.
int paged_mla_decode_splits(int B, int H, int R, int E, int ps, int NP,
                            int dtype, int device) {
  if (B < 1 || !shape_ok(H, R, E, ps, NP) || (dtype != 0 && dtype != 1))
    return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return 0;
  const int per_sm =
      dtype == 0 ? (fixed(R, E) ? occupancy<float, true>(R, E)
                                : occupancy<float, false>(R, E))
                 : (fixed(R, E) ? occupancy<bf16, true>(R, E)
                                : occupancy<bf16, false>(R, E));
  int sms = 0;
  if (per_sm <= 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  const int t = ps * NP;
  int s = std::min(ceil_div(t, kMinSplitTokens),
                   std::max(1, sms * per_sm / B));
  s = std::max(1, std::min(s, kMaxSplits));
  return ceil_div(t, tokens_per_split(t, s));
}

// q_abs [B, H, R], q_rope [B, H, E], ckv [P, ps, R], kr [P, ps, E] of one
// dtype, contiguous, 16-byte aligned; page_table [B, NP] and lens [B]
// int32; out [B, H, R] float32; ws as paged_mla_decode_splits says
// (unused with one split); every pointer and the stream on `device`.
// Returns the cudaError_t of the launches.
int paged_mla_decode(const void* q_abs, const void* q_rope, const void* ckv,
                     const void* kr, const void* page_table, const void* lens,
                     void* out, void* ws, int B, int H, int R, int E, int ps,
                     int NP, int splits, float scale, int dtype, int device,
                     void* stream) {
  if (!shape_ok(H, R, E, ps, NP) || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && ws == nullptr))
    return int(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  const bool fx = fixed(R, E);
  if (dtype == 0)
    return fx ? launch<float, true>(q_abs, q_rope, ckv, kr, page_table, lens,
                                    o, w, B, H, R, E, ps, NP, splits, scale, s)
              : launch<float, false>(q_abs, q_rope, ckv, kr, page_table, lens,
                                     o, w, B, H, R, E, ps, NP, splits, scale,
                                     s);
  if (dtype == 1)
    return fx ? launch<bf16, true>(q_abs, q_rope, ckv, kr, page_table, lens, o,
                                   w, B, H, R, E, ps, NP, splits, scale, s)
              : launch<bf16, false>(q_abs, q_rope, ckv, kr, page_table, lens,
                                    o, w, B, H, R, E, ps, NP, splits, scale, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
