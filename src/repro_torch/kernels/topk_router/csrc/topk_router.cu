// Top-k MoE router and dispatch plan in one launch, for NVIDIA Hopper
// (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/topk_router/kernel.py,
// topk_router_kernel (body _kernel): an fp32 softmax over the E expert
// logits of each token, then k rounds of argmax-and-mask with ties to the
// lowest index, and the k probabilities renormalised to sum 1 when k > 1.
// logits [T, E] (fp32 or bf16) -> probs [T, k] fp32, idx [T, k] int32.
// The same launch also computes what the MoE chunk needs next, which the
// JAX package leaves to XLA around the Pallas call:
//   * the dispatch plan of moe/dispatch.py::dispatch_plan for capacity C:
//     route j of token t gets rank r = the number of routes at flat
//     positions < t*k + j that go to the same expert, and
//     dest[t*k + j] = e*C + r if r < C else E*C, valid = r < C;
//   * on request, the aux statistics of moe/router.py::route: per expert
//     the sum over tokens of its softmax probability and its count of
//     primary routes (idx[:, 0]), the sum over tokens of logsumexp^2, and
//     from them aux_loss = (E * sum_e f_e p_e) * w_aux and
//     z_loss = mean(logsumexp^2) * w_z.
//
// Bound: HBM bytes, and in practice the launch. Per token the kernel
// reads E logits and writes k probabilities, indices and destinations
// and k flags; ~5 operations per logit. At the training chunk (T 2048,
// E 64, fp32) that is ~0.55 MB, ~0.16 us at 3.35 TB/s: well under the
// ~2 us a launch takes, so what this kernel saves is the small launches
// of the plan and the aux terms that ran after it.
//
// Design. One warp per token row, the row in registers (lane l holds
// columns l, l + 32, ...); max, exp-sum and each argmax are warp shuffles,
// and an argmax keeps the lower index on equal values (the TPU kernel's
// and lax.top_k's tie rule). A warp takes up to 4 consecutive rows, a
// block `warps * rpw`, so a block's routes are one contiguous run of flat
// positions; lane j keeps route j of each of its warp's rows (expert and
// rank) in registers until it writes the destination. Ranks:
//   1. a warp counts, row by row, the routes it has sent to each expert
//      (a histogram in shared memory): a route's rank within its warp;
//   2. the block scans its warps' histograms per expert: the rank within
//      the block;
//   3. one block: that is the rank. With several, a block takes its rows
//      in the order it starts (an atomic counter), publishes its
//      histogram with a release flag, waits for the flags of the blocks
//      before it (all started, so all resident: no block waits on one
//      that cannot run) and sums their histograms: its offset per expert.
// No block runs the others' routes, so no serial tail: the last block to
// start only reads more histograms. Statistics: each block writes its
// partial sums; the last block in order, which has waited for all, sums
// them. The counter only grows: launch n of a workspace (one shape, so
// one grid of B blocks) draws n*B .. n*B + B-1, and its flags carry the
// tag n + 1, so nothing is reset and the next launch on the stream, or a
// captured launch replayed, needs no host step. Every float sum
// (probabilities, logsumexp^2) is in fp64 in an order fixed by the shape:
// no float atomics, the same result every run. A batch that fits one block
// of up to 16 warps (every decode step) runs as one and needs no
// workspace. Without a plan and stats (the `topk_router` entry) blocks are
// independent. Plain C interface, loaded with ctypes; launches on the
// caller's stream; returns the cudaError_t of the launch.
//
// Where the time goes (NVIDIA H100 80GB HBM3, 700 W; globaltimer marks per
// block, PERF.md, PR 16): one block at T 8, k 1 takes ~4.2 us, the top-k
// alone ~2.3 (rows 1.8 us, the block's scan 0.7, destinations and stats
// 0.8). Several blocks at T 2048 take ~9 us, ~5 of them in the cross-block
// steps, each a trip through L2: the ticket ~0.7 us, the release fence
// ~0.7, the flags reaching the pollers ~1-2, the earlier histograms ~1.5.
// Sharing the histograms through a thread-block cluster's distributed
// shared memory would replace those trips; it is not built.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kMaxExperts = 256;
constexpr int kMaxDevices = 64;
constexpr int kWarps = 8;            // warps a block of a several-block grid
constexpr int kMaxRowsPerWarp = 4;   // rows whose routes a lane holds
constexpr int kSingleWarps = 16;     // warps (one row each) of one block
constexpr int kSingleCells = 2048;   // ... and warps * E at most
constexpr int kBatch = 32;           // histograms a thread reads at once
constexpr int kMaxSpin = 1 << 22;    // flag polls before a trap, not a hang
constexpr float kNeg = -1e30f;       // the TPU kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

struct Args {
  const void* logits;
  float* probs;          // [T, k]
  int32_t* idx;          // [T, k]
  int32_t* dest;         // [T*k], or null: no plan
  uint8_t* valid;        // [T*k]
  int32_t* stats;        // [2E + 3] or null: prob sums (f32) [E] | primary
                         // counts [E] | z_sq_sum, aux_loss, z_loss (f32)
  int32_t* ws;           // several blocks: see Workspace
  int t, e, k, cap, rpw;
  float aux_w, z_w;
};

// int32 words of the several-block workspace: the order counter (u64),
// flags [B], (pad to 8 bytes), with stats: prob sums (f64) [B, E] and
// logsumexp^2 sums (f64) [B]; histograms [B, E]; with stats: primary
// counts [B, E].
__host__ __device__ inline size_t flags_end(int b) {
  return (2 + size_t(b) + 1) & ~size_t(1);
}
__host__ __device__ inline size_t workspace_words(int b, int e, bool stats) {
  const size_t be = size_t(b) * e;
  return flags_end(b) + (stats ? 2 * (be + b) + be : 0) + be;
}

struct Workspace {
  unsigned long long* order;
  int *flags, *hist, *cnt;
  double *psum, *z;
  __device__ Workspace(int32_t* ws, int b, int e, bool stats) {
    order = reinterpret_cast<unsigned long long*>(ws);
    flags = ws + 2;
    psum = reinterpret_cast<double*>(ws + flags_end(b));
    z = psum + (stats ? size_t(b) * e : 0);
    hist = reinterpret_cast<int*>(z + (stats ? b : 0));
    cnt = hist + size_t(b) * e;
  }
};

// Warp 0: z_sq_sum and the two aux losses from the totals (primary
// counts, fp64 probability sums rounded to the fp32 the stats hold),
// summed over the experts in a fixed order (lane-strided, then a shuffle
// tree): aux = E * sum_e (c_e / T) (p_e / T) * w_aux, z = zsum / T * w_z.
__device__ void finalize_aux(const Args& a, const int* cnt,
                             const double* psum, double zsum) {
  const int lane = threadIdx.x & 31;
  double s = 0.0;
  for (int ex = lane; ex < a.e; ex += 32)
    s += double(cnt[ex]) * double(static_cast<float>(psum[ex]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) {
    const double t = a.t;
    float* out = reinterpret_cast<float*>(a.stats + 2 * a.e);
    out[0] = static_cast<float>(zsum);
    out[1] = static_cast<float>(a.e * (s / (t * t)) * a.aux_w);
    out[2] = static_cast<float>(double(out[0]) / t * a.z_w);
  }
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kSingleWarps * 32)
    route_plan_kernel(const Args a) {
  extern __shared__ __align__(16) int smem[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int E = a.e, K = a.k, B = gridDim.x;
  const bool plan = a.dest != nullptr, stats = a.stats != nullptr;
  const bool cross = plan || stats, multi = cross && B > 1;

  // shared memory: per warp and expert, probability sums (then, in row 0,
  // the totals), routes sent (then the warp's offset within the block)
  // and primary routes; per warp its logsumexp^2 sum; the block's offset
  // per expert; per thread, partial sums over blocks (several blocks)
  double* psum = reinterpret_cast<double*>(smem);       // [nw, E]
  double* zs = psum + nw * E;                           // [nw]
  double* part_p = zs + nw;                             // [blockDim]
  int* hist = reinterpret_cast<int*>(part_p + (multi ? blockDim.x : 0));
  int* cnt = hist + nw * E;                             // [nw, E]
  int* off = cnt + nw * E;                              // [E]
  int* part_h = off + E;                                // [blockDim]
  int* part_c = part_h + blockDim.x;                    // [blockDim]
  __shared__ unsigned long long s_ticket;

  const Workspace ws(a.ws, B, E, stats);
  int order = blockIdx.x, tag = 0;
  if (multi) {   // rows in the order blocks start; this launch's flag tag
    if (threadIdx.x == 0) s_ticket = atomicAdd(ws.order, 1ull);
    __syncthreads();
    order = static_cast<int>(s_ticket % B);
    tag = static_cast<int>((s_ticket / B) % 0x7fffffff) + 1;
  }
  const int row0 = order * nw * a.rpw;
  const int rows = min(nw * a.rpw, a.t - row0);
  // every row's logits, loaded up front
  const T* logits = static_cast<const T*>(a.logits);
  float xs[kMaxRowsPerWarp][kPer];
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    const int lrow = warp * a.rpw + rr;
    const bool live = rr < a.rpw && lrow < rows;
    const T* x = logits + static_cast<int64_t>(row0 + lrow) * E;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      xs[rr][i] = live && c < E ? to_float(x[c]) : -INFINITY;
    }
  }
  int* my_hist = hist + warp * E;
  int* my_cnt = cnt + warp * E;
  if (cross) {
    for (int i = lane; i < E; i += 32) my_hist[i] = my_cnt[i] = 0;
    __syncwarp();
  }

  double acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.0;
  double zacc = 0.0;
  // lane j: route j of each of the warp's rows, written with its
  // destination once the plan is known
  float r_p[kMaxRowsPerWarp];
  int r_e[kMaxRowsPerWarp], r_rank[kMaxRowsPerWarp];

#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    r_p[rr] = 0.f;
    r_e[rr] = r_rank[rr] = 0;
    const int lrow = warp * a.rpw + rr;
    if (rr >= a.rpw || lrow >= rows) continue;

    float v[kPer];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      v[i] = xs[rr][i];
      m = fmaxf(m, v[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < E ? expf(v[i] - m) : 0.f;
      s += v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    // probabilities; padding columns get kNeg so they never win an argmax
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < E ? v[i] / s : kNeg;
      if (stats && c < E) acc[i] += v[i];
    }
    if (stats) {
      const double z = m + logf(s);
      zacc += z * z;
    }

    float top_p[kMaxK];
    int top_i[kMaxK];
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      top_p[r] = 0.f;
      top_i[r] = 0;
      if (r >= K) continue;
      float best = kNeg;
      int bi = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {   // columns ascend with i
        const int c = lane + 32 * i;
        if (c < E && v[i] > best) { best = v[i]; bi = c; }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, o);
        const int oi = __shfl_xor_sync(kFull, bi, o);
        if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)       // mask the winner
        if (lane + 32 * i == bi) v[i] = kNeg;
      top_p[r] = best;
      top_i[r] = bi;
      total += best;
    }
    float my_p = 0.f;
    int my_e = 0;
#pragma unroll
    for (int r = 0; r < kMaxK; ++r)
      if (r == lane) { my_p = top_p[r]; my_e = top_i[r]; }
    if (lane < K) {
      r_p[rr] = K > 1 ? my_p / fmaxf(total, 1e-9f) : my_p;
      r_e[rr] = my_e;
      if (plan) {   // a row's k experts differ: no two lanes share a cell
        r_rank[rr] = my_hist[my_e];
        my_hist[my_e] = r_rank[rr] + 1;
      }
    }
    if (stats && lane == 0) my_cnt[top_i[0]] += 1;
    __syncwarp();
  }
  // lane j writes route j of each of the warp's rows
  auto write_routes = [&] {
    if (lane >= K) return;
#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      const int lrow = warp * a.rpw + rr;
      if (rr >= a.rpw || lrow >= rows) continue;
      const int64_t p = static_cast<int64_t>(row0 + lrow) * K + lane;
      a.probs[p] = r_p[rr];
      a.idx[p] = r_e[rr];
      if (plan) {
        const int ex = r_e[rr];
        const int r = r_rank[rr] + hist[warp * E + ex] + off[ex];
        a.dest[p] = r < a.cap ? ex * a.cap + r : E * a.cap;
        a.valid[p] = r < a.cap;
      }
    }
  };
  if (!cross) {
    write_routes();
    return;
  }
  if (stats) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (lane + 32 * i < E) psum[warp * E + lane + 32 * i] = acc[i];
    if (lane == 0) zs[warp] = zacc;
  }
  __syncthreads();

  // the block: each warp's offset within it, the block's totals
  for (int ex = threadIdx.x; ex < E; ex += blockDim.x) {
    int run = 0, c = 0;
    double ps = 0.0;
    for (int w = 0; w < nw; ++w) {
      if (plan) {
        const int h = hist[w * E + ex];
        hist[w * E + ex] = run;
        run += h;
      }
      if (stats) {
        c += cnt[w * E + ex];
        ps += psum[w * E + ex];
      }
    }
    off[ex] = 0;
    if (multi) {
      if (plan) ws.hist[order * E + ex] = run;
      if (stats) {
        ws.cnt[order * E + ex] = c;
        ws.psum[order * E + ex] = ps;
      }
    } else {          // one block: its totals are the totals
      cnt[ex] = c;
      psum[ex] = ps;
    }
  }
  if (stats && warp == 0) {
    double z = 0.0;
    for (int w = lane; w < nw; w += 32) z += zs[w];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
    if (lane == 0) {
      zs[0] = z;
      if (multi) ws.z[order] = z;
    }
  }

  if (multi) {
    // publish, then wait for every block before this one in order
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      st_release(ws.flags + order, tag);
    }
    const bool last = order == B - 1;
    if (plan || (stats && last))
      for (int p = threadIdx.x; p < order; p += blockDim.x)
        for (int spin = 0; ld_acquire(ws.flags + p) != tag; ++spin)
          if (spin > kMaxSpin) __trap();
    __syncthreads();
    // thread (part, ex) sums expert ex over blocks [lo, hi) of the
    // blocks before this one (and, for the last block's statistics, of
    // all blocks)
    const int tpe = max(1, static_cast<int>(blockDim.x) / E);
    const int ex = threadIdx.x % E, part = threadIdx.x / E;
    const bool mine = part < tpe;
    if (plan) {
      const int chunk = (order + tpe - 1) / tpe;
      const int lo = min(order, part * chunk), hi = min(order, lo + chunk);
      int sum = 0;
      for (int b0 = lo; mine && b0 < hi; b0 += kBatch) {
        int h[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          h[j] = b0 + j < hi ? __ldcg(ws.hist + (b0 + j) * E + ex) : 0;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) sum += h[j];
      }
      if (mine) part_h[part * E + ex] = sum;
      __syncthreads();
      if (mine && part == 0) {
        int o = 0;
        for (int q = 0; q < tpe; ++q) o += part_h[q * E + ex];
        off[ex] = o;
      }
    }
    if (stats && last) {
      const int chunk = (B + tpe - 1) / tpe;
      const int lo = min(B, part * chunk), hi = min(B, lo + chunk);
      int c = 0;
      double ps = 0.0;
      for (int b0 = lo; mine && b0 < hi; b0 += kBatch / 4) {
        int cb[kBatch / 4];
        double pb[kBatch / 4];
#pragma unroll
        for (int j = 0; j < kBatch / 4; ++j) {
          cb[j] = b0 + j < hi ? __ldcg(ws.cnt + (b0 + j) * E + ex) : 0;
          pb[j] = b0 + j < hi ? __ldcg(ws.psum + (b0 + j) * E + ex) : 0.0;
        }
#pragma unroll
        for (int j = 0; j < kBatch / 4; ++j) {   // in block order
          c += cb[j];
          ps += pb[j];
        }
      }
      if (mine) {
        part_c[part * E + ex] = c;
        part_p[part * E + ex] = ps;
      }
      double z = 0.0;
      if (warp == 0) {
        for (int b = lane; b < B; b += 32) z += __ldcg(ws.z + b);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
        if (lane == 0) zs[0] = z;
      }
      __syncthreads();
      if (mine && part == 0) {   // the totals, in row 0
        c = 0;
        ps = 0.0;
        for (int q = 0; q < tpe; ++q) {
          c += part_c[q * E + ex];
          ps += part_p[q * E + ex];
        }
        cnt[ex] = c;
        psum[ex] = ps;
      }
    }
  }
  __syncthreads();

  write_routes();
  if (stats && (!multi || order == B - 1)) {
    for (int ex = threadIdx.x; ex < E; ex += blockDim.x) {
      reinterpret_cast<float*>(a.stats)[ex] = static_cast<float>(psum[ex]);
      a.stats[E + ex] = cnt[ex];
    }
    if (warp == 0) finalize_aux(a, cnt, psum, zs[0]);
  }
}

struct Geometry {
  int warps, rpw, blocks;
};

int sm_count(int device) {
  static int sms[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 0;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    sms[device] = 0;
  return sms[device];
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Warps a block, rows a warp and blocks. With neither plan nor stats, a
// row a warp over as many blocks as it takes. Otherwise one block of a
// row a warp when T fits kSingleWarps warps (and warps * E fits
// kSingleCells, for shared memory); else 8-warp blocks of up to
// kMaxRowsPerWarp rows a warp, about one block an SM where T allows.
Geometry geometry(int t, int e, bool cross, int device) {
  if (!cross) return {kWarps, 1, cdiv(t, kWarps)};
  if (t <= min(kSingleWarps, kSingleCells / e)) return {t, 1, 1};
  const int sms = max(1, sm_count(device));
  const int rpw = min(kMaxRowsPerWarp, cdiv(t, kWarps * sms));
  return {kWarps, rpw, cdiv(t, kWarps * rpw)};
}

// Shared memory of route_plan_kernel's layout (fp64 sums first).
size_t smem_bytes(const Geometry& g, int e) {
  const size_t cells = size_t(g.warps) * e;
  const size_t part = g.blocks > 1 ? 32 * size_t(g.warps) : 0;
  return (cells + g.warps + part) * 8 + (2 * cells + e + 2 * part) * 4;
}

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

template <typename T>
cudaError_t launch(const Args& a, const Geometry& g, cudaStream_t s) {
  const size_t smem = a.dest || a.stats ? smem_bytes(g, a.e) : 0;
  const dim3 grid(g.blocks), block(g.warps * 32);
  switch (cdiv(a.e, 32)) {
    case 1: route_plan_kernel<T, 1><<<grid, block, smem, s>>>(a); break;
    case 2: route_plan_kernel<T, 2><<<grid, block, smem, s>>>(a); break;
    case 3:
    case 4: route_plan_kernel<T, 4><<<grid, block, smem, s>>>(a); break;
    default: route_plan_kernel<T, 8><<<grid, block, smem, s>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest E and k the kernel takes (the wrapper raises above them).
int topk_router_max_experts() { return kMaxExperts; }
int topk_router_max_k() { return kMaxK; }

// int32 words of workspace route_plan takes for this shape on `device`:
// 0 when it runs as one block. A workspace serves one shape (one grid) on
// one stream; it is zeroed before its first launch and needs nothing
// between launches.
int route_plan_workspace(int t, int e, int k, int stats, int device) {
  if (t <= 0 || e <= 0 || e > kMaxExperts || k <= 0 || k > kMaxK) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return -1;
  const Geometry g = geometry(t, e, true, device);
  return g.blocks == 1 ? 0 : int(workspace_words(g.blocks, e, stats != 0));
}

// logits [T, E] (dtype: 0 float32, 1 bfloat16); probs [T, k] f32; idx
// [T, k] int32; dest [T*k] int32 and valid [T*k] uint8, or both null (no
// plan); stats [2E + 3] int32 words or null; ws as route_plan_workspace
// says (null when it says 0). Every pointer and the stream on `device`.
int route_plan(const void* logits, void* probs, void* idx, void* dest,
               void* valid, void* stats, void* ws, int t, int e, int k,
               int cap, float aux_w, float z_w, int dtype, int device,
               void* stream) {
  if (e <= 0 || e > kMaxExperts || k <= 0 || k > kMaxK || k > e ||
      (dtype != 0 && dtype != 1) || ((dest == nullptr) != (valid == nullptr))
      || (dest != nullptr && cap <= 0))
    return int(cudaErrorInvalidValue);
  if (t <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  const bool cross = dest != nullptr || stats != nullptr;
  const Geometry g = geometry(t, e, cross, device);
  if ((cross && g.blocks > 1 && ws == nullptr) || int64_t(t) * k > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  Args a{logits, static_cast<float*>(probs), static_cast<int32_t*>(idx),
         static_cast<int32_t*>(dest), static_cast<uint8_t*>(valid),
         static_cast<int32_t*>(stats), static_cast<int32_t*>(ws),
         t, e, k, cap, g.rpw, aux_w, z_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? launch<float>(a, g, s)
                        : launch<__nv_bfloat16>(a, g, s));
}

// The top-k alone: route_plan with neither plan nor stats.
int topk_router(const void* logits, void* probs, void* idx, int t, int e,
                int k, int dtype, void* stream) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return int(err);
  return route_plan(logits, probs, idx, nullptr, nullptr, nullptr, nullptr,
                    t, e, k, 0, 0.f, 0.f, dtype, device, stream);
}

}  // extern "C"
