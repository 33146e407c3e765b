// Flash attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (body _kernel): online-softmax attention with
// causal and/or sliding-window masking and GQA (query head h reads KV head
// h // group). Scores q.k * D^-0.5 in fp32, masked entries set to
// NEG = -1e30, running (m, l, acc) in fp32, p rounded to v's dtype for the
// PV product, the output divided by max(l, 1e-30) and written in q's
// dtype. q [B, Sq, Hq, D], k and v [B, Sk, Kv, D], any strides with a
// unit last stride (the model's [B, S, H, D] tensors as they are, no
// transposes); out [B, Sq, Hq, D] contiguous.
//
// Bound: at moe-gpt3-s's training shape (B 8, S 1024, H 8, D 96, causal,
// bf16) q, k, v and o are 50 MB, ~0.015 ms at 3.35 TB/s; the causal half
// of 4 * B * H * S^2 * D is 12.9 GFLOP, ~0.013 ms on the tensor cores. The
// two are close; a simple kernel is far from both.
//
// Design (simple first; wgmma, TMA, double-buffered K/V and a persistent
// schedule are later work):
//  * One 128-thread block (4 warps) per (batch * query head, 64-row query
//    tile). Each warp owns 16 query rows. The block loops over only the
//    64-row KV tiles its mask reaches: up to the tile's last query under
//    causal, from its first query's window start under a window. The TPU
//    grid visited every KV tile.
//  * Q is staged once; each K/V tile is copied into shared memory with
//    16-byte cp.async. bf16 products run on the tensor cores through WMMA
//    (16x16x16, fp32 accumulation); fp32 runs the same tiling with FMAs
//    (no TF32: it would not hold a 1e-5 limit).
//  * WMMA hides which lane holds which accumulator element, so the
//    running output of each warp lives in shared memory in fp32: per KV
//    tile the warp stores its 16x64 scores, two lanes a row take the
//    online-softmax step (row max by shuffle, rescale of the row's output
//    by alpha, p written in v's dtype), and the PV product is loaded onto,
//    accumulated into and stored back from that output.
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

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16 * kWarps;   // query rows per block
constexpr int kBK = 64;            // KV rows per tile
constexpr int kLds = kBK + 4;      // fp32 score row stride
constexpr float kNeg = -1e30f;     // the TPU kernel's mask value

template <typename T>
struct Pad;
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int v = 8;
};
template <>
struct Pad<float> {
  static constexpr int v = 4;
};

// 16x16x16 products on shared-memory tiles. Accumulators are kept in
// shared memory between steps (load_acc / store_acc), fp32 row-major.
template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  __device__ static void zero(Acc& c) { wmma::fill_fragment(c, 0.f); }
  __device__ static void load_acc(Acc& c, const float* p, int ldm) {
    wmma::load_matrix_sync(c, p, ldm, wmma::mem_row_major);
  }
  __device__ static void store_acc(float* p, const Acc& c, int ldm) {
    wmma::store_matrix_sync(p, c, ldm, wmma::mem_row_major);
  }
  // c += A B, A and B row-major
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
  // c += A B^T, with B^T given row-major as bt (bt[n][k])
  __device__ static void mma_bt(Acc& c, const __nv_bfloat16* a, int lda,
                                const __nv_bfloat16* bt, int ldbt) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::col_major> fb;
    wmma::load_matrix_sync(fa, a, lda);
    wmma::load_matrix_sync(fb, bt, ldbt);
    wmma::mma_sync(c, fa, fb, c);
  }
};
template <>
struct Mma<float> {
  struct Acc {
    float v[8];
  };  // lane l: row l / 2, columns (l % 2) * 8 .. + 8
  __device__ static int row() { return (threadIdx.x & 31) >> 1; }
  __device__ static int col() { return (threadIdx.x & 1) * 8; }
  __device__ static void zero(Acc& c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) c.v[i] = 0.f;
  }
  __device__ static void load_acc(Acc& c, const float* p, int ldm) {
#pragma unroll
    for (int i = 0; i < 8; ++i) c.v[i] = p[row() * ldm + col() + i];
  }
  __device__ static void store_acc(float* p, const Acc& c, int ldm) {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[row() * ldm + col() + i] = c.v[i];
  }
  __device__ static void mma(Acc& c, const float* a, int lda, const float* b,
                             int ldb) {
    const int r = row(), c0 = col();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float av = a[r * lda + k];
#pragma unroll
      for (int i = 0; i < 8; ++i) c.v[i] = fmaf(av, b[k * ldb + c0 + i], c.v[i]);
    }
  }
  __device__ static void mma_bt(Acc& c, const float* a, int lda,
                                const float* bt, int ldbt) {
    const int r = row(), c0 = col();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float av = a[r * lda + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        c.v[i] = fmaf(av, bt[(c0 + i) * ldbt + k], c.v[i]);
    }
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// rows x D tile whose row i starts at g + i * ldg; rows at or past rmax
// are zero-filled.
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

template <typename T>
struct Layout {
  size_t q, k, v, s, p, o, total;
  __host__ __device__ Layout(int d) {
    const size_t tile = align128(size_t(kBQ) * (d + Pad<T>::v) * sizeof(T));
    q = 0;
    k = q + tile;
    v = k + align128(size_t(kBK) * (d + Pad<T>::v) * sizeof(T));
    s = v + align128(size_t(kBK) * (d + Pad<T>::v) * sizeof(T));
    p = s + align128(size_t(kBQ) * kLds * sizeof(float));
    o = p + align128(size_t(kBQ) * (kBK + Pad<T>::v) * sizeof(T));
    total = o + align128(size_t(kBQ) * (d + 4) * sizeof(float));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int hq, int group, int sq, int sk, int d,
                           int64_t qsb, int64_t qss, int64_t qsh,
                           int64_t ksb, int64_t kss, int64_t ksh,
                           int64_t vsb, int64_t vss, int64_t vsh,
                           float scale, int causal, int window) {
  using MM = Mma<T>;
  constexpr int PAD = Pad<T>::v;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> lay(d);
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  T* ks = reinterpret_cast<T*>(smem + lay.k);
  T* vs = reinterpret_cast<T*>(smem + lay.v);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  T* ps = reinterpret_cast<T*>(smem + lay.p);
  float* os = reinterpret_cast<float*>(smem + lay.o);
  const int ldt = d + PAD, ldp = kBK + PAD, ldo = d + 4;

  const int bh = blockIdx.y, b = bh / hq, h = bh % hq, kvh = h / group;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = q + b * qsb + h * qsh + int64_t(q0) * qss;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  load_rows(qs, ldt, qb, qss, kBQ, d, sq - q0);
  cp_commit();
  for (int i = threadIdx.x; i < kBQ * ldo; i += kThreads) os[i] = 0.f;
  __syncthreads();

  // the KV tiles this query tile's mask reaches
  int k_lo = 0, k_hi = sk;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  if (causal) k_hi = min(sk, q0 + kBQ);
  const int j_lo = k_lo / kBK, j_hi = (k_hi + kBK - 1) / kBK;

  // online-softmax state of this lane's row: lanes 2r and 2r+1 own row r
  // of the warp's 16, each half of its score columns and of its output
  const int r = lane >> 1, half = lane & 1;
  const int qpos = q0 + warp * 16 + r;
  float m_run = kNeg, l_run = 0.f;
  float* sw = ss + warp * 16 * kLds;
  T* pw = ps + warp * 16 * ldp;
  float* ow = os + warp * 16 * ldo;
  const T* qw = qs + warp * 16 * ldt;

  for (int j = j_lo; j < j_hi; ++j) {
    const int kv0 = j * kBK;
    load_rows(ks, ldt, kb + int64_t(kv0) * kss, kss, kBK, d, sk - kv0);
    load_rows(vs, ldt, vb + int64_t(kv0) * vss, vss, kBK, d, sk - kv0);
    cp_commit();
    cp_wait_all();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: 4 fragments of 16 KV columns
#pragma unroll
    for (int f = 0; f < kBK / 16; ++f) {
      typename MM::Acc acc;
      MM::zero(acc);
      for (int kk = 0; kk < d; kk += 16)
        MM::mma_bt(acc, qw + kk, ldt, ks + f * 16 * ldt + kk, ldt);
      MM::store_acc(sw + f * 16, acc, kLds);
    }
    __syncwarp();

    // online softmax step on row r, columns [half * 32, half * 32 + 32)
    float sv[32];
    float mx = kNeg;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c, kpos = kv0 + col;
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
    for (int c = 0; c < 32; ++c) {
      const float p = expf(sv[c] - m_new);
      psum += p;
      pw[r * ldp + half * 32 + c] = from_float<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    const int dh = d / 2;
    for (int c = half * dh; c < (half + 1) * dh; ++c) ow[r * ldo + c] *= alpha;
    __syncwarp();

    // O += P V
    for (int f = 0; f < d; f += 16) {
      typename MM::Acc acc;
      MM::load_acc(acc, ow + f, ldo);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16)
        MM::mma(acc, pw + kk, ldp, vs + kk * ldt + f, ldt);
      MM::store_acc(ow + f, acc, ldo);
    }
    __syncwarp();
    __syncthreads();   // K/V tiles are overwritten next
  }

  // out = O / max(l, 1e-30), in q's dtype, [B, Sq, Hq, D] contiguous
  if (qpos < sq) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    T* orow = out + ((int64_t(b) * sq + qpos) * hq + h) * d;
    const int dh = d / 2;
    for (int c = half * dh; c < (half + 1) * dh; ++c)
      orow[c] = from_float<T>(ow[r * ldo + c] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int group, int sq, int sk, int d, const int64_t* st,
           float scale, int causal, int window, cudaStream_t stream) {
  static size_t opted_in = 0;      // dynamic shared memory already allowed
  const size_t smem = Layout<T>(d).total;
  auto kernel = flash_attention_kernel<T>;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, group, sq, sk, d,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory a block needs for head dim d (dtype: 0 float32,
// 1 bfloat16).
size_t flash_attention_smem_bytes(int d, int dtype) {
  return dtype == 0 ? Layout<float>(d).total : Layout<__nv_bfloat16>(d).total;
}

size_t flash_attention_smem_limit(int device) {
  int val = 0;
  if (cudaDeviceGetAttribute(&val, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return static_cast<size_t>(val);
}

// q [B, Sq, Hq, D], k/v [B, Sk, Kv, D] (Hq = Kv * group), strides in
// elements: strides[0..2] = q's (batch, seq, head), [3..5] k's, [6..8]
// v's; the last dim is contiguous. out [B, Sq, Hq, D] contiguous.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int b, int hq, int group, int sq, int sk, int d,
                    const int64_t* strides, float scale, int causal,
                    int window, int dtype, void* stream) {
  if (d % 16 || d <= 0 || group <= 0 || hq % group)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, b, hq, group, sq, sk, d, strides,
                         scale, causal, window, s);
  return launch<__nv_bfloat16>(q, k, v, out, b, hq, group, sq, sk, d,
                               strides, scale, causal, window, s);
}

}  // extern "C"
