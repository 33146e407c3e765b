// Paged-attention decode for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py,
// paged_decode_attention_kernel (body _decode_kernel): single-query GQA
// decode over a page table. Scores q.k * D^-0.5 in fp32, masked to
// idx < lens (and idx >= lens - window), one softmax, PV summed in fp32,
// the output written in q's dtype. lens counts this step's token.
//
// Bound: HBM bytes. The work is ~4 flops per K/V element read, far below
// the card's ~295 flops/byte balance point, so the floor is the K and V
// bytes the live tokens occupy: sum_b lens_b * Kv * D * 2 (K and V) *
// itemsize. At moe-gpt3-s's engine shape (8 slots, Kv 8, G 1, D 96,
// 16-token pages, 32 pages a slot, 1,538 live tokens) that is 4.7 MB,
// 1.4 us at 3.35 TB/s, so the fixed cost of a launch and of one DRAM
// round trip sets the time there; at 32 slots x 4096 tokens (Kv 8, G 4,
// D 128) it is 537 MB, 0.160 ms.
//
// Design:
//  * Split the keys. Block (split, KV head, slot) takes the tokens
//    [lo + split * tps, lo + (split + 1) * tps) of [lo, L), L = min(lens,
//    NP * ps), lo = L - window when window > 0, else 0. tps is a whole
//    number of pages; paged_decode_splits picks the split count from B *
//    Kv, the table's length and the blocks the card holds at once, so
//    that the grid fills whole waves. A block past L writes an empty
//    partial (m = -inf, l = 0).
//  * One pass. Each of the block's 4 warps walks its own tiles of 8
//    tokens (16 where a row is under four 16-byte chunks, bf16 at D 16;
//    tile i of the block goes to warp i % 4) through its own 3-stage
//    cp.async ring of K and V rows, so no block barrier sits in the loop:
//    a warp waits only for its own copies (cp.async.wait_group +
//    __syncwarp). The page ids of a warp's next tile are read a tile
//    ahead, so no copy waits on the page table. Rows past the block's
//    range are zero-filled, never read from the pools, so sink and stale
//    pages never reach the arithmetic. The G query heads of the group
//    share every row.
//  * Scores: 4 lanes per token (2 at bf16 D 16), each reading 16-byte
//    chunks of its K row from rows padded so that the 8 lanes of a
//    quarter-warp hit 8 distinct bank groups, then a 2-step shuffle. An
//    online softmax per warp in the log2 domain (the scale folded into one
//    multiply): the tile max and sum over the tile's tokens by shuffles,
//    the probabilities to a per-warp [tile, G] row in shared memory. PV:
//    lane l owns columns l, l + 32, ... and adds p * v over the tile's
//    rows in fp32. Scores, probabilities and PV stay fp32 in both dtypes.
//  * Shared memory is fixed by (dtype, G, D): 4 rings of 3 stages, the
//    query rows and the probability rows; 66 KB at bf16 D 128 and 113 KB
//    at fp32 D 128. It does not grow with the context length.
//  * Merging. The warps of a block merge in shared memory. With one
//    split the block normalises and writes the output. With more, each
//    block writes its unnormalised [G, D] context and (m, l) per head to a
//    workspace, and the last block of a (slot, KV head) to finish (an
//    atomic counter after __threadfence, reset by that block) merges the
//    splits in the same launch. A second launch for the merge took more
//    device time at the engine shape, and far more where few (slot, KV
//    head) pairs have many splits, whose merge it spreads over too few
//    blocks (PERF.md, PR 15).
//  * Plain C interface, loaded with ctypes. The wrapper allocates the
//    output, the workspace and the zeroed counters; the launches go on the
//    caller's stream; the return value is the cudaError_t of the launches.
//
// Measured (chip_smoke.py and tools/torch_kernel_bench.py; NVIDIA H100
// 80GB HBM3, 700.00 W; device ms, bf16 unless named): the engine shape
// 0.0082 (bound 0.0014; 8 splits), with a window of 100 0.0062; 32 slots
// x 4096 tokens (Kv 8, G 4, D 128) 0.209, 77% of its 0.160 bound; G 8,
// D 128 at 16,384 tokens a slot 0.062 (bound 0.020); fp32 engine 0.0108,
// 32 x 4096 0.383 (bound 0.321). At the engine shape the in-launch merge
// took 0.0082 against 0.0093 (0.0053 + 0.0039) with a second launch, in
// the same call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;            // cp.async ring of each warp
constexpr int kMaxG = 8;              // query heads per KV head
constexpr int kMinSplitTokens = 64;   // fewest tokens worth a block
constexpr int kMaxSplits = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kVec = 4;    // elements in 16 bytes
  __device__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

// Compile-time shape of one kernel variant: dtype T, kG query heads (G
// rounded up to a power of two), head dim kD.
template <typename T, int kG, int kD>
struct Shape {
  static constexpr int kVec = Elem<T>::kVec;
  static constexpr int kChunks = kD / kVec;           // 16-byte chunks a row
  // tokens in a warp's tile: 8, so 4 lanes share a K row (16 where a row
  // is under 4 chunks)
  static constexpr int kTile = kChunks >= 4 ? 8 : 16;
  static constexpr int kLpt = 32 / kTile;             // lanes a token
  static constexpr int kLaneChunks = kChunks / kLpt;  // a lane's, scores
  // row stride in 16-byte units, == kLpt (mod 8): lane l of token j reads
  // unit j * stride + l + kLpt * i, distinct mod 8 in a quarter-warp
  static constexpr int kStride = kChunks + (kLpt - kChunks % 8 + 8) % 8;
  static constexpr int kLd = kStride * kVec;          // row stride, elements
  static constexpr int kCols = (kD + 31) / 32;        // PV columns a lane
  static constexpr int kStageElems = 2 * kTile * kLd;  // K rows, V rows
  static constexpr size_t kQBytes = sizeof(float) * kG * kD;
  static constexpr size_t kPBytes = sizeof(float) * kWarps * kTile * kG;
  static constexpr size_t kRingBytes =
      sizeof(T) * kWarps * kStages * kStageElems;
  static constexpr size_t kMergeBytes = sizeof(float) * kWarps * kG * (kD + 2);
  static constexpr size_t kSmem =
      kQBytes + kPBytes + (kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes);
  static_assert(kD % 16 == 0 && kChunks % kLpt == 0, "head dim");
  // the in-launch merge keeps its [splits, G] weights in the ring
  static_assert(kRingBytes >= sizeof(float) * kMaxSplits * kMaxG, "ring");
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

// out[bh] = sum_s w_s ctx_s / sum_s w_s l_s over the splits of one (slot,
// KV head), w_s = 2^(m_s - max m); an empty split (l = 0) weighs 0. The
// workspace holds the contexts [B * Kv, splits, G, D], then (m, l) [B *
// Kv, splits, G, 2]. w_s: [splits, G] floats of shared memory. Every
// thread of the block calls it.
template <typename T>
__device__ void merge_splits(const float* ws, T* out, int bh, int nbh,
                             int splits, int G, int D, float* w_s) {
  const float* ctx = ws + size_t(bh) * splits * G * D;
  const float* ml = ws + size_t(nbh) * splits * G * D +
                    size_t(bh) * splits * G * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int g = warp; g < G; g += nw) {
    float mx = -INFINITY;
    for (int s = lane; s < splits; s += 32) {
      const float2 v =
          __ldcg(reinterpret_cast<const float2*>(ml + (s * G + g) * 2));
      if (v.y > 0.f) mx = fmaxf(mx, v.x);
    }
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float2 v =
          __ldcg(reinterpret_cast<const float2*>(ml + (s * G + g) * 2));
      const float f = v.y > 0.f ? exp2f(v.x - mx) : 0.f;
      w_s[s * G + g] = f;
      l += f * v.y;
    }
    const float inv = 1.f / fmaxf(warp_sum(l), 1e-30f);
    for (int s = lane; s < splits; s += 32) w_s[s * G + g] *= inv;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    float v = 0.f;
    for (int s = 0; s < splits; ++s)
      v = fmaf(w_s[s * G + g], __ldcg(ctx + size_t(s) * G * D + i), v);
    Elem<T>::store(out + size_t(bh) * G * D + i, v);
  }
}

template <typename T, int kG, int kD>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ page_table,
                  const int* __restrict__ lens, T* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int G,
                  int ps, int NP, int window, int tps, float scale_log2) {
  using Sh = Shape<T, kG, kD>;
  constexpr int kTile = Sh::kTile, kLpt = Sh::kLpt, kVec = Sh::kVec;
  constexpr int kLd = Sh::kLd, kCols = Sh::kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  float* q_s = reinterpret_cast<float*>(smem);                 // [kG, kD]
  float* p_all = reinterpret_cast<float*>(smem + Sh::kQBytes);  // [4, tile, kG]
  T* ring = reinterpret_cast<T*>(smem + Sh::kQBytes + Sh::kPBytes);

  const int split = blockIdx.x, splits = gridDim.x;
  const int h = blockIdx.y, Kv = gridDim.y, b = blockIdx.z;
  const int bh = b * Kv + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = min(lens[b], NP * ps);
  const int lo = window > 0 ? max(0, L - window) : 0;
  const int s0 = lo + split * tps;
  const int s1 = min(s0 + tps, L);             // [s0, s1) may be empty
  const int ntiles = s1 > s0 ? (s1 - s0 + kTile - 1) / kTile : 0;
  const int nt = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;

  const int* pt = page_table + size_t(b) * NP;
  // t / ps as a multiply-high: exact for t * ps < 2^32
  const uint32_t pmagic = ps > 1 ? 0xffffffffu / uint32_t(ps) + 1u : 0u;
  const size_t tok_stride = size_t(Kv) * kD;   // elements between tokens
  T* wring = ring + warp * kStages * Sh::kStageElems;
  float* p_w = p_all + warp * kTile * kG;      // [tile, kG]

  // Lane r < kTile's pool row for row r of this warp's tile k (-1 past
  // s1); the loop asks for it a tile ahead, so no copy waits on the page
  // table.
  auto row_of = [&](int k) -> int {
    const int t = s0 + (warp + k * kWarps) * kTile + lane;
    if (lane >= kTile || k >= nt || t >= s1) return -1;
    const int pi = ps > 1 ? int(__umulhi(uint32_t(t), pmagic)) : t;
    return __ldg(pt + pi) * ps + (t - pi * ps);
  };
  // Copy this warp's tile into stage st; the lanes take the rows by
  // shuffle.
  auto load_tile = [&](int row, int st) {
    T* ks = wring + st * Sh::kStageElems;
    T* vs = ks + kTile * kLd;
#pragma unroll
    for (int i = 0; i < Sh::kLaneChunks; ++i) {
      const int idx = lane + 32 * i;
      const int r = idx / Sh::kChunks, c = idx % Sh::kChunks;
      const int pr = __shfl_sync(0xffffffffu, row, r);
      T* dk = ks + r * kLd + c * kVec;
      T* dv = vs + r * kLd + c * kVec;
      if (pr >= 0) {
        const size_t off = size_t(pr) * tok_stride + size_t(h) * kD + c * kVec;
        cp_async16(dk, k_pool + off);
        cp_async16(dv, v_pool + off);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  float m[kG], l[kG], acc[kG][kCols];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.f;
  }

  int rows[kStages - 1];
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) rows[k] = row_of(k);
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nt) load_tile(rows[k], k);
    cp_commit();
  }
  int row_next = row_of(kStages - 1);

  // q [B, Kv, G, D] as fp32 rows, under the first copies; rows g >= G
  // are zero
  const T* qb = q + size_t(bh) * G * kD;
  for (int i = tid; i < kG * kD; i += kThreads)
    q_s[i] = i < G * kD ? Elem<T>::load(qb + i) : 0.f;
  __syncthreads();

  const int j = lane / kLpt, jl = lane % kLpt;  // scores: token j, part jl
  for (int k = 0; k < nt; ++k) {
    cp_wait<kStages - 2>();   // this lane's copies of tile k have landed
    __syncwarp();             // ...and every lane's; tile k - 1 is done
    if (k + kStages - 1 < nt) {
      load_tile(row_next, (k + kStages - 1) % kStages);
      row_next = row_of(k + kStages);
    }
    cp_commit();
    const T* ks = wring + (k % kStages) * Sh::kStageElems;
    const T* vs = ks + kTile * kLd;
    const int t0 = s0 + (warp + k * kWarps) * kTile;

    // scores of token j: the kLpt lanes of the token split its row
    float s[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) s[g] = 0.f;
#pragma unroll
    for (int i = 0; i < Sh::kLaneChunks; ++i) {
      const int c = jl + kLpt * i;
      float kv[kVec];
      Elem<T>::unpack(*reinterpret_cast<const uint4*>(ks + j * kLd + c * kVec),
                      kv);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4* qv =
            reinterpret_cast<const float4*>(q_s + g * kD + c * kVec);
#pragma unroll
        for (int e = 0; e < kVec / 4; ++e) {
          const float4 qq = qv[e];
          s[g] = fmaf(qq.x, kv[4 * e], s[g]);
          s[g] = fmaf(qq.y, kv[4 * e + 1], s[g]);
          s[g] = fmaf(qq.z, kv[4 * e + 2], s[g]);
          s[g] = fmaf(qq.w, kv[4 * e + 3], s[g]);
        }
      }
    }

    // online softmax over the tile (log2 domain); every processed tile
    // holds a live token, so the new max is finite
    const bool live = t0 + j < s1;
    float alpha[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int o = 1; o < kLpt; o <<= 1)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      const float sg = live ? s[g] * scale_log2 : -INFINITY;
      float mx = sg;
#pragma unroll
      for (int o = kLpt; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[g], mx);
      alpha[g] = exp2f(m[g] - mn);
      const float p = exp2f(sg - mn);
      float psum = p;
#pragma unroll
      for (int o = kLpt; o < 32; o <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[g] = l[g] * alpha[g] + psum;
      m[g] = mn;
      if (jl == 0) p_w[j * kG + g] = p;
    }
    __syncwarp();

    // PV: rows past s1 are zero with p = 0
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[g][c] *= alpha[g];
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pr[kG];
      if constexpr (kG % 4 == 0) {
#pragma unroll
        for (int g = 0; g < kG; g += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(p_w + r * kG + g);
          pr[g] = p4.x;
          pr[g + 1] = p4.y;
          pr[g + 2] = p4.z;
          pr[g + 3] = p4.w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < kG; ++g) pr[g] = p_w[r * kG + g];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        if (kD % 32 == 0 || col < kD) {
          const float v = Elem<T>::load(vs + r * kLd + col);
#pragma unroll
          for (int g = 0; g < kG; ++g) acc[g][c] = fmaf(pr[g], v, acc[g][c]);
        }
      }
    }
  }
  cp_wait<0>();

  // merge the block's warps in shared memory (the rings are free now)
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(ring);   // [4, kG, kD]
  float* ml_s = o_s + kWarps * kG * kD;          // [4, kG, 2]
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (kD % 32 == 0 || col < kD)
        o_s[(warp * kG + g) * kD + col] = acc[g][c];
    }
    if (lane == 0) {
      ml_s[(warp * kG + g) * 2] = m[g];
      ml_s[(warp * kG + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  const int nbh = gridDim.z * Kv;
  float* ws_o = ws + (size_t(bh) * splits + split) * G * kD;
  float* ws_ml = ws + size_t(nbh) * splits * G * kD +
                 (size_t(bh) * splits + split) * G * 2;
  for (int i = tid; i < G * kD; i += kThreads) {
    const int g = i / kD, col = i % kD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (ml_s[(w * kG + g) * 2 + 1] > 0.f)
        mx = fmaxf(mx, ml_s[(w * kG + g) * 2]);
    float o = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = ml_s[(w * kG + g) * 2 + 1];
      if (lw > 0.f) {
        const float f = exp2f(ml_s[(w * kG + g) * 2] - mx);
        o = fmaf(f, o_s[(w * kG + g) * kD + col], o);
        lsum = fmaf(f, lw, lsum);
      }
    }
    if (splits == 1) {
      Elem<T>::store(out + size_t(bh) * G * kD + i, o / fmaxf(lsum, 1e-30f));
    } else {
      ws_o[i] = o;
      if (col == 0) {
        ws_ml[2 * g] = mx;
        ws_ml[2 * g + 1] = lsum;
      }
    }
  }
  if (splits == 1) return;
  // the last block of this (slot, KV head) to finish merges its splits
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + bh, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  merge_splits(ws, out, bh, nbh, splits, G, kD,
               reinterpret_cast<float*>(ring));
  if (tid == 0) counters[bh] = 0;   // ready for the next launch
}

// Runs f.template run<T, kG, kD>() for the variant that takes (G, D);
// -1 when none does.
template <typename T, int kG, typename F>
int by_d(int D, F& f) {
  switch (D) {
    case 16: return f.template run<T, kG, 16>();
    case 32: return f.template run<T, kG, 32>();
    case 64: return f.template run<T, kG, 64>();
    case 96: return f.template run<T, kG, 96>();
    case 128: return f.template run<T, kG, 128>();
    default: return -1;
  }
}
template <typename T, typename F>
int by_shape(int G, int D, F& f) {
  if (G == 1) return by_d<T, 1>(D, f);
  if (G == 2) return by_d<T, 2>(D, f);
  if (G >= 3 && G <= 4) return by_d<T, 4>(D, f);
  if (G >= 5 && G <= kMaxG) return by_d<T, 8>(D, f);
  return -1;
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

// Opts the variant in above 48 KB of shared memory on the current device,
// once per device (the attribute is set per device).
template <typename T, int kG, int kD>
cudaError_t prepare() {
  static bool opted[kMaxDevices] = {};
  constexpr size_t smem = Shape<T, kG, kD>::kSmem;
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(paged_decode_kernel<T, kG, kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err == cudaSuccess && dev < kMaxDevices) opted[dev] = true;
  return err;
}

// Blocks of the variant one SM holds at once; 0 on error.
struct Occupancy {
  template <typename T, int kG, int kD>
  int run() {
    if (prepare<T, kG, kD>() != cudaSuccess) return 0;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, paged_decode_kernel<T, kG, kD>, kThreads,
            Shape<T, kG, kD>::kSmem) != cudaSuccess)
      return 0;
    return n;
  }
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Attended span of a slot at most: the window, or the whole table.
int span_of(int ps, int NP, int window) {
  const int t = ps * NP;
  return window > 0 && window < t ? window : t;
}

// Tokens a split takes: a whole number of pages.
int tokens_per_split(int ps, int NP, int window, int splits) {
  return ceil_div(ceil_div(span_of(ps, NP, window), ps), splits) * ps;
}

// The split count: the fewest splits whose grid fills at least 90% of
// its last wave (cap blocks a wave), else the best filled; at least
// kMinSplitTokens tokens and one page a split.
int choose_splits(int bh, int ps, int NP, int window, int cap) {
  const int span = span_of(ps, NP, window);
  const int pages = ceil_div(span, ps);
  const int most =
      std::max(1, std::min({pages, ceil_div(span, kMinSplitTokens),
                            kMaxSplits}));
  int best = 1;
  double best_fill = -1.0;
  for (int s = 1; s <= most; ++s) {
    if (ceil_div(span, tokens_per_split(ps, NP, window, s)) != s) continue;
    const long blocks = long(bh) * s;
    const long waves = (blocks + cap - 1) / cap;
    const double fill = double(blocks) / double(waves * cap);
    if (fill >= 0.9) return s;
    if (fill > best_fill) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

struct Launch {
  const void *q, *k_pool, *v_pool, *page_table, *lens;
  void* out;
  float* ws;
  int* counters;
  int B, Kv, G, ps, NP, window, splits;
  float scale;
  cudaStream_t stream;

  template <typename T, int kG, int kD>
  int run() {
    cudaError_t err = prepare<T, kG, kD>();
    if (err != cudaSuccess) return int(err);
    const dim3 grid(splits, Kv, B);
    paged_decode_kernel<T, kG, kD><<<grid, kThreads, Shape<T, kG, kD>::kSmem,
                               stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
        static_cast<const int*>(lens), static_cast<T*>(out), ws, counters, G,
        ps, NP, window, tokens_per_split(ps, NP, window, splits),
        scale * kLog2e);
    return int(cudaGetLastError());
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.

// How many splits of each slot's keys the launch takes for this shape on
// `device`: a whole number of pages each, filling whole waves of the
// card. 0 when the kernel does not take the shape (G above 8, D not one
// of 16, 32, 64, 96, 128) or the query fails. With more than one split
// the launch needs a workspace of B * Kv * splits * G * (D + 2) floats
// and B * Kv zeroed int32 counters.
int paged_decode_splits(int B, int Kv, int G, int D, int ps, int NP,
                        int window, int dtype, int device) {
  if (B < 1 || Kv < 1 || ps < 1 || NP < 1 || (dtype != 0 && dtype != 1))
    return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return 0;
  Occupancy occ;
  const int per_sm = dtype == 0 ? by_shape<float>(G, D, occ)
                                : by_shape<__nv_bfloat16>(G, D, occ);
  int sms = 0;
  if (per_sm <= 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return choose_splits(B * Kv, ps, NP, window, sms * per_sm);
}

// q [B, Kv, G, D], pools [P, ps, Kv, D] of one dtype, contiguous, 16-byte
// aligned; page_table [B, NP] and lens [B] int32; out [B, Kv, G, D] in
// q's dtype; ws and counters as paged_decode_splits says (unused with
// one split); every pointer and the stream on `device`. Returns the
// cudaError_t of the launch.
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const void* page_table,
                           const void* lens, void* out, void* ws,
                           void* counters, int B, int Kv, int G, int D,
                           int ps, int NP, int window, int splits,
                           float scale, int dtype, int device, void* stream) {
  if (splits < 1 || splits > kMaxSplits || ps < 1 || NP < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return int(cudaErrorInvalidValue);
  if (B <= 0 || Kv <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  Launch f{q, k_pool, v_pool, page_table, lens, out,
           static_cast<float*>(ws), static_cast<int*>(counters), B, Kv, G,
           ps, NP, window, splits, scale, static_cast<cudaStream_t>(stream)};
  const int err = dtype == 0 ? by_shape<float>(G, D, f)
                  : dtype == 1 ? by_shape<__nv_bfloat16>(G, D, f)
                               : -1;
  return err < 0 ? int(cudaErrorInvalidValue) : err;
}

}  // extern "C"
