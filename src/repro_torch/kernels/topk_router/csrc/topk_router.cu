// Top-k MoE router for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/topk_router/kernel.py,
// topk_router_kernel (body _kernel): an fp32 softmax over the E expert
// logits of each token, then k rounds of argmax-and-mask with ties to the
// lowest index, and the k probabilities renormalised to sum 1 when k > 1.
// logits [T, E] (fp32 or bf16) -> probs [T, k] fp32, idx [T, k] int32.
//
// Bound: HBM bytes. Per token the kernel reads E logits and writes 2k
// words; it does ~5 operations per logit. At the training shape (T 2048
// tokens a chunk, E 64, fp32) that is 0.54 MB, ~0.16 us at 3.35 TB/s, so
// launch latency sets its time.
//
// Design: one warp per token row, 8 rows per 256-thread block. Lane l
// holds logits l, l + 32, ... in registers (E <= 32 * kMaxPerLane), so the
// row is read once, coalesced. The row max, the exp-sum and each argmax are
// warp shuffles; an argmax keeps the larger value and, on equal values, the
// lower index, which is the TPU kernel's (and lax.top_k's) tie rule. No
// shared memory, no atomics: a row's result never depends on another row.
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream; the return value is the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 8;      // E <= 256
constexpr int kMaxK = 8;
constexpr float kNeg = -1e30f;      // the TPU kernel's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    topk_router_kernel(const T* __restrict__ logits, float* __restrict__ probs,
                       int32_t* __restrict__ idx, int t, int e, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= t) return;
  const T* x = logits + static_cast<int64_t>(row) * e;

  float v[kMaxPerLane];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < e ? to_float(x[c]) : -INFINITY;
    m = fmaxf(m, v[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < e ? expf(v[i] - m) : 0.f;
    s += v[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  // probabilities; padding lanes get kNeg so they never win an argmax
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i)
    v[i] = (lane + 32 * i) < e ? v[i] / s : kNeg;

  float top_p[kMaxK];
  int top_i[kMaxK];
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    if (r >= k) break;
    float best = kNeg;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {   // columns ascend with i
      const int c = lane + 32 * i;
      if (c < e && v[i] > best) { best = v[i]; bi = c; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i)       // mask the winner
      if (lane + 32 * i == bi) v[i] = kNeg;
    top_p[r] = best;
    top_i[r] = bi;
    total += best;
  }
  if (lane == 0) {
    const float denom = fmaxf(total, 1e-9f);
    for (int r = 0; r < k; ++r) {
      probs[static_cast<int64_t>(row) * k + r] =
          k > 1 ? top_p[r] / denom : top_p[r];
      idx[static_cast<int64_t>(row) * k + r] = top_i[r];
    }
  }
}

}  // namespace

extern "C" {

// Largest E and k the kernel takes (the wrapper raises above them).
int topk_router_max_experts() { return 32 * kMaxPerLane; }
int topk_router_max_k() { return kMaxK; }

// dtype: 0 float32, 1 bfloat16 logits.
int topk_router(const void* logits, void* probs, void* idx, int t, int e,
                int k, int dtype, void* stream) {
  if (t <= 0) return 0;
  const dim3 grid((t + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    topk_router_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(logits), static_cast<float*>(probs),
        static_cast<int32_t*>(idx), t, e, k);
  else
    topk_router_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(probs),
        static_cast<int32_t*>(idx), t, e, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
