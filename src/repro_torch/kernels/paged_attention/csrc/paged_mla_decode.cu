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
// engine's shape (8 slots, at most 512 tokens) that is a few MB, so
// launch latency sets the time; at 32 slots x 4096 tokens it is ~151 MB,
// ~45 us at 3.35 TB/s. The PV sum, 2 * H * R flops a token in fp32 on the
// CUDA cores, comes next: ~32 us at that shape.
//
// Design (simple first; wgmma, TMA and a deeper copy ring are later work):
//  * Split T. Block (b, split) takes the tokens [split * ts, (split + 1) *
//    ts) of slot b that are visible, so the 8 slots of a decode step fill
//    the card; paged_mla_decode_splits picks the splits from the slot
//    count, the table's length and the SM count. A block past lens writes
//    an empty partial. With more than one split each block leaves its
//    unnormalised context and its (max, sum) per head in a workspace and
//    a second kernel combines them; with one split the block normalises
//    and writes the output itself.
//  * One block holds all H <= 16 heads of its slot. It stages q = [q_abs |
//    q_rope] in shared memory once, then walks its tokens in tiles of 16:
//    each tile's latent and rotary rows are copied into shared memory
//    once (16-byte cp.async, two stages so the next tile's copy runs
//    under this tile's compute), and all heads read them there. That
//    sharing is MLA's point. Rows past the visible tokens are zero-filled,
//    never read from the pools, so the sink page and stale pages never
//    reach the arithmetic.
//  * Scores: bf16 on the tensor cores (WMMA 16x16x16: heads x tile tokens,
//    the R + E depth split across the 8 warps, fp32 accumulation; the
//    products of bf16 values are exact in fp32, as in the plain version's
//    fp32-accumulated einsum). fp32 on the CUDA cores: a warp per token,
//    lanes across R + E, one warp sum per head (no TF32: it would not hold
//    the fp32 limit).
//  * Online softmax per head, all in fp32: 16 lanes per head find the
//    tile's max and sum; the probabilities stay fp32 and the PV sum runs
//    in fp32 on the CUDA cores (thread i owns latent columns 2i, 2i + 1
//    for all 16 heads: 32 accumulators), so bf16 and fp32 differ from the
//    plain version only in the order of fp32 sums.
//  * Plain C interface, loaded with ctypes. The wrapper allocates the
//    output and the workspace; both launches go on the caller's stream;
//    the return value is the cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kH = 16;                // heads a block holds (WMMA rows)
constexpr int kTile = 16;             // tokens a tile (WMMA columns)
constexpr int kMaxR = 2 * kThreads;   // PV: two latent columns a thread
constexpr int kMaxE = 128;
constexpr int kMaxD = kMaxR + kMaxE;
constexpr int kMinSplitTokens = 32;   // fewest tokens worth a block
constexpr int kMaxSplits = 1024;
constexpr int kCombineThreads = 128;

template <typename T>
struct Pad;  // row padding of the shared tiles, elements
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int value = 8;  // 16 bytes: rows start on 16-byte lines
};
template <>
struct Pad<float> {
  static constexpr int value = 4;
};

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

// Shared-memory layout of one block; the kernel and the size query both
// read it from here.
__host__ __device__ constexpr int round16(int d) { return (d + 15) / 16 * 16; }

template <typename T>
struct Layout {
  int ld;  // row stride of q and the tiles, elements
  size_t q, kv, part, p, alpha, ml, total;
  __host__ __device__ Layout(int r, int e) {
    // rows [q_abs | q_rope] or [c_kv | k_rope], zero up to a multiple of
    // 16 (the WMMA depth), then padding
    ld = round16(r + e) + Pad<T>::value;
    q = 0;                                                  // [kH, ld]
    kv = q + align128(size_t(kH) * ld * sizeof(T));         // [2, kTile, ld]
    part = kv + align128(2 * size_t(kTile) * ld * sizeof(T));
    p = part + align128(size_t(kWarps) * kH * kTile * sizeof(float));
    alpha = p + align128(size_t(kTile) * kH * sizeof(float));  // p [t, h]
    ml = alpha + align128(kH * sizeof(float));
    total = ml + align128(2 * kH * sizeof(float));          // max, sum
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

__device__ __forceinline__ void set_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16* p) {
  *p = __float2bfloat16(0.f);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Copy `rows` rows of [a (ra elements) | b (rb elements)] into shared
// memory (row stride ld), row j's halves at a_of(j) and b_of(j); rows at
// or past `live` are zero-filled instead.
template <typename T, typename A, typename B>
__device__ __forceinline__ void load_rows(T* dst, int ld, int rows, int live,
                                          int ra, int rb, A a_of, B b_of) {
  constexpr int V = 16 / sizeof(T);
  const int va = ra / V, vr = va + rb / V;
  for (int i = threadIdx.x; i < rows * vr; i += kThreads) {
    const int j = i / vr, c = i % vr;
    T* d = dst + j * ld + (c < va ? c * V : ra + (c - va) * V);
    if (j < live)
      cp_async16(d, c < va ? a_of(j) + c * V : b_of(j) + (c - va) * V);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// Scores of one tile: S[h, j] = q[h] . kv[j] over the R + E depth, left in
// `part` for read() below.
template <typename T>
struct Scores;
template <>
struct Scores<__nv_bfloat16> {
  // part: [kWarps, kH, kTile], one partial product per warp
  __device__ static void run(const __nv_bfloat16* qs,
                             const __nv_bfloat16* kt, int ld, int d, int,
                             float* part) {
    const int warp = threadIdx.x >> 5;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::col_major> fb;  // (k, j) at kt[j * ld + k]
    for (int k = warp * 16; k < d; k += kWarps * 16) {
      wmma::load_matrix_sync(fa, qs + k, ld);
      wmma::load_matrix_sync(fb, kt + k, ld);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(part + warp * kH * kTile, acc, kTile,
                            wmma::mem_row_major);
  }
  __device__ static float read(const float* part, int h, int j) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[(w * kH + h) * kTile + j];
    return s;
  }
};
template <>
struct Scores<float> {
  // part: [kH, kTile]; warp w takes tokens 2w and 2w + 1 of the tile
  __device__ static void run(const float* qs, const float* kt, int ld, int d,
                             int H, float* part) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    constexpr int kPer = kMaxD / 32;
#pragma unroll
    for (int jj = 0; jj < kTile / kWarps; ++jj) {
      const int j = warp * (kTile / kWarps) + jj;
      float kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = lane + 32 * i;
        kv[i] = c < d ? kt[j * ld + c] : 0.f;
      }
      for (int h = 0; h < H; ++h) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int c = lane + 32 * i;
          if (c < d) s = fmaf(qs[h * ld + c], kv[i], s);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) part[h * kTile + j] = s;
      }
    }
  }
  __device__ static float read(const float* part, int h, int j) {
    return part[h * kTile + j];
  }
};

static_assert(kH * kTile == kThreads, "softmax: one thread a (head, token)");

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    mla_decode_kernel(const T* __restrict__ q_abs,
                      const T* __restrict__ q_rope,
                      const T* __restrict__ ckv, const T* __restrict__ kr,
                      const int* __restrict__ page_table,
                      const int* __restrict__ lens, float* __restrict__ out,
                      float* __restrict__ ws, int H, int R, int E, int ps,
                      int NP, int ts, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> lay(R, E);
  const int ld = lay.ld, D = R + E;
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  T* kvs = reinterpret_cast<T*>(smem + lay.kv);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* p_s = reinterpret_cast<float*>(smem + lay.p);   // [kTile, kH]
  float* alpha_s = reinterpret_cast<float*>(smem + lay.alpha);
  float* ml_s = reinterpret_cast<float*>(smem + lay.ml);  // [2, kH]

  const int b = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x;
  const int last = min(max(lens[b], 0), NP * ps - 1);  // visible: t <= last
  const int t0 = split * ts;
  const int n = min(t0 + ts, last + 1) - t0;          // may be <= 0
  const int* pt = page_table + size_t(b) * NP;

  // softmax state of head hs = tid / 16, the same in its 16 lanes
  const int hs = tid >> 4, js = tid & 15;
  float m_run = -INFINITY, l_run = 0.f;
  // PV: this thread's latent columns c0, c0 + 1, for every head
  const int c0 = 2 * tid;
  float acc[kH][2];
#pragma unroll
  for (int h = 0; h < kH; ++h) acc[h][0] = acc[h][1] = 0.f;

  if (n > 0) {
    // zero the depth's tail past R + E in q and both tile stages once; the
    // copies below never write there
    const int tail = round16(D) - D;
    for (int i = tid; i < (kH + 2 * kTile) * tail; i += kThreads) {
      const int row = i / tail;
      set_zero((row < kH ? qs + row * ld : kvs + (row - kH) * ld) + D +
               i % tail);
    }
    const T* qa = q_abs + size_t(b) * H * R;
    const T* qr = q_rope + size_t(b) * H * E;
    load_rows(qs, ld, kH, H, R, E, [&](int h) { return qa + h * R; },
              [&](int h) { return qr + h * E; });
    auto load_tile = [&](int it, int st) {
      const int first = t0 + it * kTile;
      load_rows(
          kvs + st * kTile * ld, ld, kTile, min(kTile, n - it * kTile), R, E,
          [&](int j) {
            const int t = first + j;
            return ckv + (size_t(pt[t / ps]) * ps + t % ps) * R;
          },
          [&](int j) {
            const int t = first + j;
            return kr + (size_t(pt[t / ps]) * ps + t % ps) * E;
          });
    };
    load_tile(0, 0);
    cp_commit();
    const int ntiles = (n + kTile - 1) / kTile;
    for (int it = 0; it < ntiles; ++it) {
      const int st = it & 1;
      if (it + 1 < ntiles) {
        load_tile(it + 1, st ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const T* kt = kvs + st * kTile * ld;
      const int nv = min(kTile, n - it * kTile);  // live tokens, >= 1

      Scores<T>::run(qs, kt, ld, D, H, part);
      __syncthreads();

      {  // online softmax: 16 lanes per head, one token each
        const bool live = hs < H && js < nv;
        const float s =
            live ? Scores<T>::read(part, hs, js) * scale : -INFINITY;
        float tmax = s;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        const float m_new = fmaxf(m_run, tmax);
        const float p = live ? expf(s - m_new) : 0.f;
        float psum = p;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, o);
        // heads past H keep m = -inf, l = 0 and are never written out
        const float alpha = hs < H ? expf(m_run - m_new) : 1.f;
        l_run = l_run * alpha + psum;
        if (hs < H) m_run = m_new;
        p_s[js * kH + hs] = p;
        if (js == 0) alpha_s[hs] = alpha;
      }
      __syncthreads();

      if (c0 < R) {  // PV in fp32
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          const float a = alpha_s[h];
          acc[h][0] *= a;
          acc[h][1] *= a;
        }
        for (int j = 0; j < nv; ++j) {
          const float2 v = load2(kt + j * ld + c0);
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
      __syncthreads();  // the next copy overwrites this stage
    }
  }

  if (js == 0) {
    ml_s[hs] = m_run;
    ml_s[kH + hs] = l_run;
  }
  __syncthreads();
  if (splits == 1) {  // n >= 1 here: the one split holds t = 0
    if (c0 >= R) return;
    float* ob = out + size_t(b) * H * R;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      if (h < H) {
        const float inv = 1.f / fmaxf(ml_s[kH + h], 1e-30f);
        *reinterpret_cast<float2*>(ob + h * R + c0) =
            make_float2(acc[h][0] * inv, acc[h][1] * inv);
      }
    }
    return;
  }
  // workspace: contexts [B, splits, H, R], then (max, sum) [B, splits, H, 2]
  const size_t row = size_t(b) * splits + split;
  if (tid < H) {
    float* wml = ws + size_t(gridDim.x) * splits * H * R + row * H * 2;
    wml[2 * tid] = ml_s[tid];
    wml[2 * tid + 1] = ml_s[kH + tid];
  }
  if (c0 >= R) return;
  float* wc = ws + row * H * R;
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    if (h < H)
      *reinterpret_cast<float2*>(wc + h * R + c0) =
          make_float2(acc[h][0], acc[h][1]);
  }
}

// out[b, h] = sum_s w_s ctx_s / sum_s w_s l_s, w_s = exp(m_s - max_s m_s).
// An empty split has m = -inf, l = 0 and weight 0; split 0 is never empty.
__global__ void __launch_bounds__(kCombineThreads)
    mla_combine_kernel(const float* __restrict__ ws, float* __restrict__ out,
                       int H, int R, int splits) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float inv_s;
  const int b = blockIdx.x, h = blockIdx.y;
  const float* wml = ws + size_t(gridDim.x) * splits * H * R;
  if (threadIdx.x == 0) {
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, wml[((size_t(b) * splits + s) * H + h) * 2]);
    float l = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ml = wml + ((size_t(b) * splits + s) * H + h) * 2;
      const float w = ml[1] > 0.f ? expf(ml[0] - mx) : 0.f;
      w_s[s] = w;
      l += w * ml[1];
    }
    inv_s = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < R; c += kCombineThreads) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s)
      v = fmaf(w_s[s], ws[((size_t(b) * splits + s) * H + h) * R + c], v);
    out[(size_t(b) * H + h) * R + c] = v * inv_s;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Tokens a split takes: a whole number of tiles.
int tokens_per_split(int t, int splits) {
  return ceil_div(ceil_div(t, splits), kTile) * kTile;
}

template <typename T>
int launch(const void* q_abs, const void* q_rope, const void* ckv,
           const void* kr, const void* page_table, const void* lens,
           float* out, float* ws, int B, int H, int R, int E, int ps, int NP,
           int splits, float scale, cudaStream_t stream) {
  const size_t smem = Layout<T>(R, E).total;
  // opt in above 48 KB once per size high-water mark (the attribute
  // sticks to the function; one device per process)
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const dim3 grid(B, splits);
  mla_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q_abs), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(kr),
      static_cast<const int*>(page_table), static_cast<const int*>(lens), out,
      ws, H, R, E, ps, NP, tokens_per_split(ps * NP, splits), scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  mla_combine_kernel<<<dim3(B, H), kCombineThreads, 0, stream>>>(ws, out, H,
                                                                 R, splits);
  return static_cast<int>(cudaGetLastError());
}

// R and E whole 16-byte copies in bf16 (8 elements), R <= 512, E <= 128.
bool shape_ok(int H, int R, int E, int ps, int NP) {
  return H >= 1 && H <= kH && R >= 8 && R <= kMaxR && R % 8 == 0 &&
         E >= 8 && E <= kMaxE && E % 8 == 0 && ps >= 1 && NP >= 1;
}

}  // namespace

extern "C" {

// How many splits of the table's ps * NP positions the launch takes for B
// slots on a card with `sms` SMs: about two blocks an SM, at least
// kMinSplitTokens positions a split. The workspace holds B * splits * H *
// (R + 2) floats when this is above 1, none otherwise.
int paged_mla_decode_splits(int B, int ps, int NP, int sms) {
  const int t = ps * NP;
  int s = std::min(ceil_div(t, kMinSplitTokens),
                   ceil_div(2 * sms, std::max(B, 1)));
  s = std::max(1, std::min(s, kMaxSplits));
  return ceil_div(t, tokens_per_split(t, s));
}

// Dynamic shared memory one block needs (dtype: 0 float32, 1 bfloat16);
// 0 when the kernel does not take the shape (H > 16, R or E not a multiple
// of 8, R > 512 or E > 128).
size_t paged_mla_decode_smem_bytes(int H, int R, int E, int dtype) {
  if (!shape_ok(H, R, E, 1, 1)) return 0;
  return dtype == 0 ? Layout<float>(R, E).total
                    : Layout<__nv_bfloat16>(R, E).total;
}

size_t paged_mla_decode_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return static_cast<size_t>(v);
}

// q_abs [B, H, R], q_rope [B, H, E], ckv [P, ps, R], kr [P, ps, E] of one
// dtype, contiguous, 16-byte aligned; page_table [B, NP] and lens [B]
// int32; out [B, H, R] float32; ws as paged_mla_decode_splits says.
// Returns the cudaError_t of the launches.
int paged_mla_decode(const void* q_abs, const void* q_rope, const void* ckv,
                     const void* kr, const void* page_table, const void* lens,
                     void* out, void* ws, int B, int H, int R, int E, int ps,
                     int NP, int splits, float scale, int dtype,
                     void* stream) {
  if (!shape_ok(H, R, E, ps, NP) || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return launch<float>(q_abs, q_rope, ckv, kr, page_table, lens, o, w, B,
                         H, R, E, ps, NP, splits, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q_abs, q_rope, ckv, kr, page_table, lens, o,
                                 w, B, H, R, E, ps, NP, splits, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
