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
// itemsize. At moe-gpt3-s's engine shapes (8 slots, Kv 8, D 96, 16-token
// pages, 32 pages a slot) that is at most 12.6 MB per launch, about 4 us
// at 3.35 TB/s, so launch latency, not bandwidth, sets its time there.
//
// Design (simple first; wgmma, TMA and split-K over pages are later work):
//  * One 256-thread block per (slot, KV head). The G query heads of the
//    group share every K/V row the block reads.
//  * The block stages q and its own page-table row in shared memory and
//    walks only the tokens it attends: [lens - window, lens) or [0, lens).
//    It never reads a page past lens, so the sink page and grown-ahead
//    pages are never touched.
//  * Staged score row, not an online softmax. Phase 1: a group of 4
//    lanes per token (64 tokens in flight per block) reads the K row in
//    16-byte vectors, each lane a quarter of it, and two shuffles finish
//    the dot product; scores go to shared memory. Phase 2 takes the exact
//    row max, exponentiates and normalises in place, as the TPU kernel and
//    the gather path do. Phase 3: thread (r, c) takes 16-byte chunk c of
//    V rows r, r + R, ... (R = 256 / chunks per row), accumulates p * V in
//    fp32 registers, and the R partial sums are added through shared
//    memory. Shared memory grows with the attended length (G *
//    min(window or NP*ps) floats). smem_bytes below is the one place that
//    knows the layout; the wrapper asks paged_decode_smem_bytes and
//    paged_decode_smem_limit and raises above the card's opt-in limit.
//  * A first version gave each warp one token row at a time (lanes over
//    D, a 5-step shuffle reduction per row): 0.155 ms at the engine shape
//    in bf16 against a 1.4 us bound (H100 SXM, 700 W, chip_smoke.py);
//    issuing instructions per row, not memory, was its limit.
//  * Plain C interface, loaded with ctypes. The wrapper allocates the
//    output; the launch goes on the caller's stream; the return value is
//    the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 4;                    // lanes per token in phase 1
constexpr int kGroups = kThreads / kLanes;   // tokens in flight in phase 1
constexpr int kMaxG = 8;                     // query heads per KV head
constexpr int kMaxChunks = 8;                // 16-byte chunks per lane/row

// 16-byte vector of a row: E elements, unpacked to fp32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
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
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// Block-wide max (kMax) or sum; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();  // scratch may be reused right after
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lens, T* __restrict__ out,
                    int Kv, int G, int D, int ps, int NP, int t_cap,
                    int window, float scale) {
  constexpr int E = Vec<T>::E;
  const int C = D / E;                // 16-byte chunks per row
  const int R = kThreads / C;         // V rows in flight in phase 3
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [G, D]
  float* s_s = q_s + G * D;           // [G, t_cap] scores -> probabilities
  float* o_s = s_s + G * t_cap;       // [R, G, D] partial PV sums
  float* red = o_s + R * G * D;       // [kWarps] reduction scratch
  int* pt = reinterpret_cast<int*>(red + kWarps);  // [NP] page-table row

  const int L = min(lens[b], NP * ps);
  const int lo = window > 0 ? max(0, L - window) : 0;
  const int n = max(L - lo, 0);       // attended tokens, n <= t_cap

  const T* qb = q + ((size_t)b * Kv + h) * G * D;  // q: [B, Kv, G, D]
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f(qb[i]);
  for (int i = tid; i < NP; i += kThreads)
    pt[i] = page_table[(size_t)b * NP + i];
  __syncthreads();

  const size_t tok = (size_t)Kv * D;  // stride between tokens of a page
  auto row_of = [&](const T* pool, int i) {
    const int t = lo + i;
    return pool + ((size_t)pt[t / ps] * ps + t % ps) * tok + (size_t)h * D;
  };

  // Phase 1: scores, one group of kLanes lanes per token. Every lane runs
  // the same number of iterations, so the group shuffles are full-warp.
  const int grp = tid / kLanes, gl = tid % kLanes;
  for (int i0 = 0; i0 < n; i0 += kGroups) {
    const int i = i0 + grp;
    const bool live = i < n;
    uint4 raw[kMaxChunks];
    if (live) {
      const T* row = row_of(k_pool, i);
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k) {
        const int c = gl + k * kLanes;
        if (c < C) raw[k] = *reinterpret_cast<const uint4*>(row + c * E);
      }
    }
    float part[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
    if (live) {
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k) {
        const int c = gl + k * kLanes;
        if (c < C) {
          float v[E];
          Vec<T>::unpack(raw[k], v);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float4* qv =
                  reinterpret_cast<const float4*>(q_s + g * D + c * E);
#pragma unroll
              for (int e4 = 0; e4 < E / 4; ++e4) {
                const float4 qq = qv[e4];
                part[g] += qq.x * v[4 * e4] + qq.y * v[4 * e4 + 1] +
                           qq.z * v[4 * e4 + 2] + qq.w * v[4 * e4 + 3];
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float s = part[g];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (live && gl == 0) s_s[g * t_cap + i] = s * scale;
      }
    }
  }
  __syncthreads();

  // Phase 2: one softmax per query head over the staged row.
  for (int g = 0; g < G; ++g) {
    float* sg = s_s + g * t_cap;
    float m = -INFINITY;
    for (int i = tid; i < n; i += kThreads) m = fmaxf(m, sg[i]);
    m = block_reduce<true>(m, red);
    float l = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float p = expf(sg[i] - m);
      sg[i] = p;
      l += p;
    }
    l = block_reduce<false>(l, red);
    const float denom = fmaxf(l, 1e-30f);
    for (int i = tid; i < n; i += kThreads) sg[i] = sg[i] / denom;
  }
  __syncthreads();

  // Phase 3: PV. Thread (r, c) takes chunk c of rows r, r + R, ...
  const int r = tid / C, c = tid % C;
  if (r < R) {
    float acc[kMaxG][E];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    for (int i = r; i < n; i += R) {
      float v[E];
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(row_of(v_pool, i) +
                                                     c * E),
                     v);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float p = s_s[g * t_cap + i];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += p * v[e];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          o_s[(r * G + g) * D + c * E + e] = acc[g][e];
      }
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * Kv + h) * G * D;  // out: [B, Kv, G, D]
  for (int idx = tid; idx < G * D; idx += kThreads) {
    float s = 0.f;
    for (int rr = 0; rr < R; ++rr) s += o_s[rr * G * D + idx];
    store(ob + idx, s);
  }
}

// Attended-token capacity of a block's score row.
int t_cap_of(int ps, int NP, int window) {
  const int t = ps * NP;
  return window > 0 && window < t ? window : t;
}

// Dynamic shared memory of one block, in bytes, laid out as the kernel
// reads it: q [G, D] | scores [G, t_cap] | PV partials [R, G, D] |
// reduction scratch [kWarps] | page-table row [NP], all 4-byte words.
// 0 when the kernel does not take the shape.
template <typename T>
size_t smem_bytes(int G, int D, int ps, int NP, int window) {
  constexpr int E = Vec<T>::E;
  if (G < 1 || G > kMaxG || D < E || D % E != 0 ||
      D / E > kLanes * kMaxChunks || ps < 1 || NP < 1)
    return 0;
  const size_t R = kThreads / (D / E);
  const size_t t_cap = t_cap_of(ps, NP, window);
  return sizeof(float) *
         ((size_t)G * D + G * t_cap + R * G * D + kWarps + (size_t)NP);
}

size_t smem_bytes_of(int dtype, int G, int D, int ps, int NP, int window) {
  if (dtype == 0) return smem_bytes<float>(G, D, ps, NP, window);
  if (dtype == 1) return smem_bytes<__nv_bfloat16>(G, D, ps, NP, window);
  return 0;
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lens, void* out, int B,
           int Kv, int G, int D, int ps, int NP, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(G, D, ps, NP, window);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  // opt in above 48 KB once per size high-water mark (the attribute
  // sticks to the function; one device per process); a size above the
  // card's opt-in limit fails here
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  dim3 grid(B, Kv);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lens), static_cast<T*>(out), Kv, G, D, ps, NP,
      t_cap_of(ps, NP, window), window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.

// Dynamic shared memory one block needs for this shape, in bytes; 0 when
// the kernel does not take it (G > kMaxG, rows not whole 16-byte vectors
// or more than kLanes * kMaxChunks of them).
extern "C" size_t paged_decode_smem_bytes(int G, int D, int ps, int NP,
                                          int window, int dtype) {
  return smem_bytes_of(dtype, G, D, ps, NP, window);
}

// The most dynamic shared memory a block may opt into on ``device``; 0 if
// the query fails.
extern "C" size_t paged_decode_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return (size_t)v;
}

// Returns the cudaError_t of the launch.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lens, void* out, int B, int Kv,
    int G, int D, int ps, int NP, int window, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, page_table, lens, out, B, Kv, G,
                         D, ps, NP, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, lens, out, B,
                                 Kv, G, D, ps, NP, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
