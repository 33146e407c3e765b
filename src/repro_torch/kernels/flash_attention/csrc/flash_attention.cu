// Flash attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (body _kernel): online-softmax attention with
// causal and/or sliding-window masking and GQA (query head h reads KV head
// h / group). Scores q.k * D^-0.5 in fp32, masked entries set to
// NEG = -1e30, running (m, l, acc) in fp32, p rounded to v's dtype for the
// PV product (l sums the unrounded p), the output divided by
// max(l, 1e-30) and written in q's dtype. q [B, Sq, Hq, D], k and v
// [B, Sk, Kv, D], any strides with a unit last stride (the model's
// [B, S, H, D] tensors as they are, no transposes); out [B, Sq, Hq, D]
// contiguous. Query and key positions both start at 0.
//
// Bound: at moe-gpt3-s's training shape (B 8, S 1024, H 8, D 96, causal,
// bf16) q, k, v and o are 50 MB, ~0.015 ms at 3.35 TB/s; the causal half
// of 4 * B * H * S^2 * D is 12.9 GFLOP, ~0.013 ms at the tensor cores'
// 989 TFLOP/s. Both are close, so the kernel has to keep the tensor cores
// fed and touch every byte of q, k, v and o about once from HBM.
//
// bf16 design (FlashAttention-2 on mma.sync.m16n8k16, D a multiple of 16
// up to 192, and 256):
//  * One 128-thread block (4 warps) per (batch * query head, 128-row query
//    tile); each warp owns 32 query rows as two 16-row m-tiles, so every
//    K and V fragment it loads from shared memory feeds two products.
//    Above D 128 (MLA's expanded prefill runs D 192: nope 128 + rope 64,
//    v padded to match) a warp owns one m-tile and a block 64 rows: two
//    m-tiles would hold 2 x 24 x 4 output accumulators a thread at D 192,
//    which with the scores would spill. At D 256 (gemma3) a warp keeps 32
//    x 4 output accumulators a thread, so its key tiles are 32 rows, not
//    64: 16 score accumulators a thread in place of 32. The grid's first
//    dimension is batch * head and its second runs the query
//    tiles from the last (the longest under causal masking) to the first,
//    so the longest tiles start first and the short ones fill the tail.
//  * Registers hold what a warp computes: the 32 x 64 scores S = Q K^T and
//    the 32 x D output O as m16n8 fp32 accumulators (2 x 12 n-tiles x 4
//    floats for O at D 96); Q fragments are reloaded from shared memory at
//    each k-step, which leaves room for both. Row max and row sum reduce
//    over the 4 lanes of a quad with __shfl_xor_sync. P is rounded to bf16
//    in registers and repacked as the A fragment of the PV product: the
//    m16n8 accumulator layout of two neighbouring key n-tiles is the
//    m16k16 A layout. Neither S, P nor O makes a round trip through shared
//    memory; O goes through it once at the end, to leave as 16-byte
//    stores.
//  * Q and K fragments come in with ldmatrix, V fragments with
//    ldmatrix.trans, from shared-memory rows padded by 16 bytes, which
//    keeps the eight rows of every 8x8 load on distinct banks.
//  * K and V tiles (64 rows, 32 at D 256) are double-buffered in cp.async groups of
//    their own: K(j + 1) is copied under the softmax and PV product of
//    tile j, V(j + 1) under the scores of tile j + 1.
//  * The block visits only the KV tiles its mask reaches (up to its last
//    query under causal masking, from its first query's window start
//    under a window); a warp skips a tile none of its rows sees, and
//    evaluates the mask only on tiles that a causal, window or sequence
//    edge crosses.
//
// fp32 runs on the CUDA cores (FMAs; TF32 would not hold the 1e-5 limit):
// 64-query blocks, scores, P and the running output in shared memory,
// 64-row key tiles up to D 192 and 32-row ones above (D 256: 208,896 B
// of shared memory; 64-row tiles would take 283,648 B). Only the tests
// and the fp32 comparisons run it.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream; the return value is the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16 * kWarps;   // query rows per fp32 block
// bf16: 16-row m-tiles a warp at head dim d, and query rows a block
__host__ __device__ constexpr int bf16_wm(int d) { return d > 128 ? 1 : 2; }
__host__ __device__ constexpr int bf16_bq(int d) {
  return 16 * bf16_wm(d) * kWarps;
}
// KV rows per tile at head dim d, both dtypes: 32 above D 192 (registers
// in bf16, shared memory in fp32)
__host__ __device__ constexpr int tile_bk(int d) { return d > 192 ? 32 : 64; }
constexpr float kNeg = -1e30f;     // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxD = 256;         // the bf16 kernel's largest head dim
constexpr int kKVStages = 2;       // bf16 K and V ring depth

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

// rows x d tile whose row i starts at g + i * ldg, into shared memory with
// row stride lds; rows at or past rmax are zero-filled.
template <typename T>
__device__ __forceinline__ void load_rows(T* s, int lds, const T* g,
                                          int64_t ldg, int rows, int d,
                                          int rmax) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = d / V;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * V;
    T* dst = s + r * lds + c;
    if (r < rmax)
      cp_async16(dst, g + r * ldg + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync.m16n8k16 with register-resident scores and output
// ---------------------------------------------------------------------------

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
// (2 registers), c 16x8 fp32. Lane l (g = l / 4, t = l % 4) holds c[0..1]
// at row g, columns 2t, 2t + 1 and c[2..3] at row g + 8.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (relative error ~2^-22, 0 for very
// negative x).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory of the bf16 kernel for head dim d: the Q tile (reused to
// stage O at the end) and the K and V rings, rows padded by 8 elements
// (D 192: (64 + 256) x 200 x 2 = 128,000 B; D 256: (64 + 128) x 264 x 2 =
// 101,376 B).
__host__ __device__ constexpr size_t bf16_smem_bytes(int d) {
  return size_t(bf16_bq(d) + 2 * kKVStages * tile_bk(d)) * (d + 8) *
         sizeof(bf16);
}

// One instantiation per head dim D (a multiple of 16), so that every loop
// over D unrolls without a guard and every shared-memory offset is a
// constant.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bf16_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, bf16* __restrict__ out, int hq, int group,
        int sq, int sk, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
        int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
        float scale_log2, int causal, int window) {
  constexpr int kBK = tile_bk(D);  // KV rows per tile
  constexpr int KQ = D / 16;    // k-steps over D
  constexpr int NO = D / 8;     // output n-tiles
  constexpr int NS = kBK / 8;   // score n-tiles
  constexpr int WM = bf16_wm(D);   // m-tiles a warp
  constexpr int kBQ2 = bf16_bq(D);  // query rows a block
  constexpr int KVS = kKVStages;
  constexpr int ld = D + 8;
  constexpr int d = D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ2 * ld;    // the K ring, then the V ring
  bf16* vs = ks + KVS * kBK * ld;

  const int bh = blockIdx.x, b = bh / hq, h = bh % hq, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ2;   // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + b * qsb + h * qsh + int64_t(q0) * qss;
  const bf16* kb = k + b * ksb + kvh * ksh;
  const bf16* vb = v + b * vsb + kvh * vsh;

  // the KV tiles this query tile's mask reaches
  int k_lo = 0, k_hi = sk;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  if (causal) k_hi = min(sk, min(sq, q0 + kBQ2));
  const int j_lo = k_lo / kBK, j_hi = (k_hi + kBK - 1) / kBK;

  // K and V travel in cp.async groups of their own, KVS - 1 tiles ahead:
  // K(j + KVS - 1) is copied from the end of tile j's scores on, V(j +
  // KVS - 1) from the end of its PV product on
  load_rows(qs, ld, qb, qss, kBQ2, d, sq - q0);
#pragma unroll
  for (int i = 0; i < KVS - 1; ++i) {
    const int j = j_lo + i;
    if (j < j_hi)
      load_rows(ks + i * kBK * ld, ld, kb + int64_t(j) * kBK * kss, kss, kBK,
                d, sk - j * kBK);
    cp_commit();
    if (j < j_hi)
      load_rows(vs + i * kBK * ld, ld, vb + int64_t(j) * kBK * vss, vss, kBK,
                d, sk - j * kBK);
    cp_commit();
  }

  float o[WM][NO][4];
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
#pragma unroll
    for (int n = 0; n < NO; ++n)
      o[mi][n][0] = o[mi][n][1] = o[mi][n][2] = o[mi][n][3] = 0.f;
  float mrow[WM][2], lrow[WM][2];   // rows g and g + 8 of each m-tile
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
    mrow[mi][0] = mrow[mi][1] = kNeg, lrow[mi][0] = lrow[mi][1] = 0.f;
  const int w_lo = q0 + warp * 16 * WM, w_hi = w_lo + 16 * WM - 1;
  // A rows lane % 16, columns 8 (lane / 16) of this warp's first m-tile
  const uint32_t q_addr = smem_u32(qs + (warp * 16 * WM + (lane & 15)) * ld +
                                   (lane >> 4) * 8);

  for (int j = j_lo; j < j_hi; ++j) {
    const bf16* kt = ks + (j - j_lo) % KVS * kBK * ld;
    const bf16* vt = vs + (j - j_lo) % KVS * kBK * ld;
    const int jn = j + KVS - 1;   // the tile copied during this one
    bf16* kn = ks + (jn - j_lo) % KVS * kBK * ld;
    bf16* vn = vs + (jn - j_lo) % KVS * kBK * ld;
    const int kv0 = j * kBK;
    const bool unseen = (causal && kv0 > w_hi) ||
                        (window > 0 && kv0 + kBK - 1 <= w_lo - window);
    cp_wait<2 * KVS - 3>();   // Q and K(j) have landed
    __syncthreads();
    float s[WM][NS][4];
    if (!unseen) {
      // S = Q K^T: K rows are B's columns, so plain ldmatrix gives B; each
      // K fragment serves both m-tiles
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
#pragma unroll
        for (int n = 0; n < NS; ++n)
          s[mi][n][0] = s[mi][n][1] = s[mi][n][2] = s[mi][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t qa[WM][4];
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
          ldsm_x4(qa[mi], q_addr + (mi * 16 * ld + kk * 16) * 2);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bfr[4];
          ldsm_x4(bfr, smem_u32(kt + (np * 16 + (lane & 7) +
                                      ((lane >> 4) << 3)) * ld +
                                kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
          for (int mi = 0; mi < WM; ++mi) {
            mma16816(s[mi][2 * np], qa[mi], bfr[0], bfr[1]);
            mma16816(s[mi][2 * np + 1], qa[mi], bfr[2], bfr[3]);
          }
        }
      }
    }
    if (jn < j_hi)   // K(j - 1)'s stage: every warp is past its scores
      load_rows(kn, ld, kb + int64_t(jn) * kBK * kss, kss, kBK, d,
                sk - jn * kBK);
    cp_commit();
    if (!unseen) {
      // Where an edge crosses the tile, the scores are scaled into the
      // log2 domain and masked to NEG here (sc = 1 below); elsewhere the
      // scale is folded into the one FFMA before ex2 (sc = the scale).
      const bool edge = kv0 + kBK > sk ||
                        (causal && kv0 + kBK - 1 > w_lo) ||
                        (window > 0 && kv0 <= w_hi - window);
      const float sc = edge ? 1.f : scale_log2;
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {
        if (edge) {
#pragma unroll
          for (int n = 0; n < NS; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = kv0 + n * 8 + t4 * 2 + (e & 1);
              const int qpos = w_lo + mi * 16 + g + (e >> 1) * 8;
              bool ok = kpos < sk;
              if (causal) ok = ok && qpos >= kpos;
              if (window > 0) ok = ok && qpos - kpos < window;
              s[mi][n][e] = ok ? s[mi][n][e] * scale_log2 : kNeg;
            }
          }
        }
        // online softmax: row statistics over the quad's 4 lanes
        float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          mx0 = fmaxf(mx0, fmaxf(s[mi][n][0], s[mi][n][1]));
          mx1 = fmaxf(mx1, fmaxf(s[mi][n][2], s[mi][n][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        mx0 = fmaxf(mrow[mi][0], mx0 * sc);
        mx1 = fmaxf(mrow[mi][1], mx1 * sc);
        const float a0 = ex2(mrow[mi][0] - mx0);
        const float a1 = ex2(mrow[mi][1] - mx1);
        mrow[mi][0] = mx0;
        mrow[mi][1] = mx1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          s[mi][n][0] = ex2(fmaf(s[mi][n][0], sc, -mx0));
          s[mi][n][1] = ex2(fmaf(s[mi][n][1], sc, -mx0));
          s[mi][n][2] = ex2(fmaf(s[mi][n][2], sc, -mx1));
          s[mi][n][3] = ex2(fmaf(s[mi][n][3], sc, -mx1));
          ps0 += s[mi][n][0] + s[mi][n][1];
          ps1 += s[mi][n][2] + s[mi][n][3];
        }
        // this lane's columns only; the quad sums at the end
        lrow[mi][0] = lrow[mi][0] * a0 + ps0;
        lrow[mi][1] = lrow[mi][1] * a1 + ps1;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[mi][n][0] *= a0;
          o[mi][n][1] *= a0;
          o[mi][n][2] *= a1;
          o[mi][n][3] *= a1;
        }
      }
    }
    cp_wait<2 * KVS - 3>();   // V(j) has landed
    __syncthreads();
    if (!unseen) {
      // O += P V: P's accumulators of key n-tiles 2t and 2t + 1 are the A
      // fragment of key k-step t; V rows are B's k, so ldmatrix.trans;
      // each V fragment serves both m-tiles
#pragma unroll
      for (int t = 0; t < kBK / 16; ++t) {
        uint32_t pa[WM][4];
#pragma unroll
        for (int mi = 0; mi < WM; ++mi) {
          pa[mi][0] = pack_bf16(s[mi][2 * t][0], s[mi][2 * t][1]);
          pa[mi][1] = pack_bf16(s[mi][2 * t][2], s[mi][2 * t][3]);
          pa[mi][2] = pack_bf16(s[mi][2 * t + 1][0], s[mi][2 * t + 1][1]);
          pa[mi][3] = pack_bf16(s[mi][2 * t + 1][2], s[mi][2 * t + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, smem_u32(vt + (t * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * ld +
                                  dp * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int mi = 0; mi < WM; ++mi) {
            mma16816(o[mi][2 * dp], pa[mi], bfr[0], bfr[1]);
            mma16816(o[mi][2 * dp + 1], pa[mi], bfr[2], bfr[3]);
          }
        }
      }
    }
    if (jn < j_hi)   // V(j - 1)'s stage: every warp is past its PV product
      load_rows(vn, ld, vb + int64_t(jn) * kBK * vss, vss, kBK, d,
                sk - jn * kBK);
    cp_commit();
  }
  cp_wait<0>();   // nothing may land in the Q tile while O is staged there

  // out = O / max(l, 1e-30) in bf16, staged through this warp's Q rows
  // (which only this warp reads) to leave as 16-byte stores
  bf16* ow = qs + warp * 16 * WM * ld;
#pragma unroll
  for (int mi = 0; mi < WM; ++mi) {
    float l0 = lrow[mi][0], l1 = lrow[mi][1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
    bf16* om = ow + mi * 16 * ld;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(om + g * ld + n * 8 + t4 * 2) =
          pack_bf16(o[mi][n][0] * i0, o[mi][n][1] * i0);
      *reinterpret_cast<uint32_t*>(om + (g + 8) * ld + n * 8 + t4 * 2) =
          pack_bf16(o[mi][n][2] * i1, o[mi][n][3] * i1);
    }
  }
  __syncwarp();
  constexpr int vpr = d / 8;
#pragma unroll
  for (int i = lane; i < 16 * WM * vpr; i += 32) {
    const int r = i / vpr, c = (i % vpr) * 8, qpos = w_lo + r;
    if (qpos < sq)
      *reinterpret_cast<uint4*>(out + ((int64_t(b) * sq + qpos) * hq + h) * d +
                                c) =
          *reinterpret_cast<const uint4*>(ow + r * ld + c);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int b, int hq, int group, int sq, int sk, const int64_t* st,
                float scale, int causal, int window, cudaStream_t stream) {
  static size_t opted_in = 0;      // dynamic shared memory already allowed
  constexpr size_t smem = bf16_smem_bytes(D);
  auto kernel = flash_attention_bf16_kernel<D>;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  constexpr int bq = bf16_bq(D);
  const dim3 grid(b * hq, (sq + bq - 1) / bq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), hq, group, sq, sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core tiling (scores, P and the running output in shared
// memory; lanes 2r and 2r + 1 own row r of a warp's 16)
// ---------------------------------------------------------------------------

constexpr int kPad32 = 4;          // fp32 tile and score row padding

// c (16x16, lane l: row l / 2, columns (l % 2) * 8 .. + 8) += A B, with
// A and B row-major in shared memory; mma_bt takes B^T row-major.
struct Fma {
  float v[8];
  __device__ static int row() { return (threadIdx.x & 31) >> 1; }
  __device__ static int col() { return (threadIdx.x & 1) * 8; }
  __device__ void load(const float* p, int ldm) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = p[row() * ldm + col() + i];
  }
  __device__ void store(float* p, int ldm) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[row() * ldm + col() + i] = v[i];
  }
  __device__ void mma(const float* a, int lda, const float* b, int ldb) {
    const int r = row(), c0 = col();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float av = a[r * lda + k];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = fmaf(av, b[k * ldb + c0 + i], v[i]);
    }
  }
  __device__ void mma_bt(const float* a, int lda, const float* bt, int ldbt) {
    const int r = row(), c0 = col();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float av = a[r * lda + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = fmaf(av, bt[(c0 + i) * ldbt + k], v[i]);
    }
  }
};

// Above D 128 P overwrites S in place (each lane reads its score row's
// columns into registers before it writes their probabilities, and no
// other lane touches them; S and P share the stride bk + kPad32), which
// keeps D 192 at 218,112 B, under the H100's 232,448 B a block; separate,
// S and P would need 235,520 B. bk: the key tile's rows (tile_bk).
struct Layout32 {
  size_t q, k, v, s, p, o, total;
  __host__ __device__ Layout32(int d, int bk) {
    const size_t tile = align128(size_t(kBQ) * (d + kPad32) * sizeof(float));
    const size_t kvt = align128(size_t(bk) * (d + kPad32) * sizeof(float));
    const size_t st = align128(size_t(kBQ) * (bk + kPad32) * sizeof(float));
    q = 0;
    k = q + tile;
    v = k + kvt;
    s = v + kvt;
    p = d > 128 ? s : s + st;
    o = p + st;
    total = o + align128(size_t(kBQ) * (d + 4) * sizeof(float));
  }
};

template <int BK>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fp32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ out, int hq, int group,
        int sq, int sk, int d, int64_t qsb, int64_t qss, int64_t qsh,
        int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
        int64_t vsh, float scale, int causal, int window) {
  constexpr int kLds = BK + kPad32;   // score (and P) row stride
  constexpr int kHalf = BK / 2;       // score columns a lane
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout32 lay(d, BK);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* ks = reinterpret_cast<float*>(smem + lay.k);
  float* vs = reinterpret_cast<float*>(smem + lay.v);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  float* ps = reinterpret_cast<float*>(smem + lay.p);
  float* os = reinterpret_cast<float*>(smem + lay.o);
  const int ldt = d + kPad32, ldp = kLds, ldo = d + 4;

  const int bh = blockIdx.y, b = bh / hq, h = bh % hq, kvh = h / group;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = q + b * qsb + h * qsh + int64_t(q0) * qss;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;

  load_rows(qs, ldt, qb, qss, kBQ, d, sq - q0);
  cp_commit();
  for (int i = threadIdx.x; i < kBQ * ldo; i += kThreads) os[i] = 0.f;
  __syncthreads();

  int k_lo = 0, k_hi = sk;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  if (causal) k_hi = min(sk, q0 + kBQ);
  const int j_lo = k_lo / BK, j_hi = (k_hi + BK - 1) / BK;

  const int r = lane >> 1, half = lane & 1;
  const int qpos = q0 + warp * 16 + r;
  float m_run = kNeg, l_run = 0.f;
  float* sw = ss + warp * 16 * kLds;
  float* pw = ps + warp * 16 * ldp;
  float* ow = os + warp * 16 * ldo;
  const float* qw = qs + warp * 16 * ldt;

  for (int j = j_lo; j < j_hi; ++j) {
    const int kv0 = j * BK;
    load_rows(ks, ldt, kb + int64_t(kv0) * kss, kss, BK, d, sk - kv0);
    load_rows(vs, ldt, vb + int64_t(kv0) * vss, vss, BK, d, sk - kv0);
    cp_commit();
    cp_wait<0>();
    __syncthreads();

#pragma unroll
    for (int f = 0; f < BK / 16; ++f) {
      Fma acc = {};
      for (int kk = 0; kk < d; kk += 16)
        acc.mma_bt(qw + kk, ldt, ks + f * 16 * ldt + kk, ldt);
      acc.store(sw + f * 16, kLds);
    }
    __syncwarp();

    float sv[kHalf];
    float mx = kNeg;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      const int col = half * kHalf + c, kpos = kv0 + col;
      bool ok = kpos < sk;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      sv[c] = ok ? sw[r * kLds + col] * scale : kNeg;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      const float p = expf(sv[c] - m_new);
      psum += p;
      pw[r * ldp + half * kHalf + c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    const int dh = d / 2;
    for (int c = half * dh; c < (half + 1) * dh; ++c) ow[r * ldo + c] *= alpha;
    __syncwarp();

    for (int f = 0; f < d; f += 16) {
      Fma acc;
      acc.load(ow + f, ldo);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16)
        acc.mma(pw + kk, ldp, vs + kk * ldt + f, ldt);
      acc.store(ow + f, ldo);
    }
    __syncwarp();
    __syncthreads();   // K/V tiles are overwritten next
  }

  if (qpos < sq) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    float* orow = out + ((int64_t(b) * sq + qpos) * hq + h) * d;
    const int dh = d / 2;
    for (int c = half * dh; c < (half + 1) * dh; ++c)
      orow[c] = ow[r * ldo + c] * inv;
  }
}

template <int BK>
int launch_fp32(const void* q, const void* k, const void* v, void* out,
                int b, int hq, int group, int sq, int sk, int d,
                const int64_t* st, float scale, int causal, int window,
                cudaStream_t stream) {
  static size_t opted_in = 0;
  const size_t smem = Layout32(d, BK).total;
  auto kernel = flash_attention_fp32_kernel<BK>;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), hq, group, sq,
      sk, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory a block needs for head dim d (dtype: 0 float32,
// 1 bfloat16).
size_t flash_attention_smem_bytes(int d, int dtype) {
  return dtype == 0 ? Layout32(d, tile_bk(d)).total : bf16_smem_bytes(d);
}

size_t flash_attention_smem_limit(int device) {
  int val = 0;
  if (cudaDeviceGetAttribute(&val, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return static_cast<size_t>(val);
}

// Whether the kernel has a variant for head dim d in this dtype: fp32
// any multiple of 16 (shared memory permitting), bf16 the multiples of
// 16 up to 192 and 256.
int flash_attention_takes_d(int d, int dtype) {
  if (d <= 0 || d % 16) return 0;
  return dtype == 0 || d <= 192 || d == kMaxD;
}

// q [B, Sq, Hq, D], k/v [B, Sk, Kv, D] (Hq = Kv * group), strides in
// elements: strides[0..2] = q's (batch, seq, head), [3..5] k's, [6..8]
// v's; the last dim is contiguous. out [B, Sq, Hq, D] contiguous.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int b, int hq, int group, int sq, int sk, int d,
                    const int64_t* strides, float scale, int causal,
                    int window, int dtype, void* stream) {
  if (!flash_attention_takes_d(d, dtype) || group <= 0 || hq % group)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tile_bk(d) == 64
               ? launch_fp32<64>(q, k, v, out, b, hq, group, sq, sk, d,
                                 strides, scale, causal, window, s)
               : launch_fp32<32>(q, k, v, out, b, hq, group, sq, sk, d,
                                 strides, scale, causal, window, s);
#define FLASH_BF16(D)                                                      \
  case D:                                                                  \
    return launch_bf16<D>(q, k, v, out, b, hq, group, sq, sk, strides,     \
                          scale, causal, window, s);
  switch (d) {
    FLASH_BF16(16)
    FLASH_BF16(32)
    FLASH_BF16(48)
    FLASH_BF16(64)
    FLASH_BF16(80)
    FLASH_BF16(96)
    FLASH_BF16(112)
    FLASH_BF16(128)
    FLASH_BF16(144)
    FLASH_BF16(160)
    FLASH_BF16(176)
    FLASH_BF16(192)
    FLASH_BF16(256)
  }
#undef FLASH_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
