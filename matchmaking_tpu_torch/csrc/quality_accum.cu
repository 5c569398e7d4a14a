// quality_accum: folds one window's matches into the device-resident
// match-quality state, in place.
//
// Replaces the XLA step of the JAX package's quality accumulator,
// matchmaking_tpu/engine/kernels.py: QualityAccumKernel._accum (there is no
// Pallas kernel for it). For a window result out = f32[3, B] (q_slot, c_slot,
// dist; unmatched lanes hold slot `capacity` and dist +inf) it takes two
// samples per matched lane, one per side, and for each:
//
//   limit   = min(eff(q side), eff(c side)),  eff(s) = thr[s], or with
//             widening min(max_thr, thr[s] + widen * max(0, now - enq[s]))
//   quality = limit > 0 ? clip(1 - d / max(limit, 1e-30), 0, 1) : 0
//   wait    = max(0, now - enq[s])
//   rating bucket  = searchsorted(rating_edges, rating[s], side="right")
//   quality bucket = clip(floor(quality * n_quality), 0, n_quality - 1)
//   wait bucket    = searchsorted(wait_edges, wait, side="right")
//
// and adds one to q_hist[rb][qb], w_hist[rb][wb] and count[rb], and quality,
// wait and d to q_sum[rb], w_sum[rb] and d_sum[rb]. rating, enq and thr are
// the post-step pool's columns: eviction clears only `active`, so a matched
// slot still holds its player's values.
//
// What bounds it on an H100: nothing but latency. A window of B = 1,024 lanes
// reads 12 KB of results and 2,048 x 3 gathered words and writes ~1.5 KB of
// state: well under a microsecond of memory time. The kernel sits at launch
// latency; its point is to be one launch per window instead of the ~30
// eager PyTorch launches the same arithmetic takes.
//
// The design, and why:
//   * One CTA of 512 threads per launch, over tiles of 512 lanes (1,024
//     samples): one thread per lane computes both of its samples, so the
//     pair's limit needs no exchange.
//   * The integer histograms and counts go to shared memory with shared
//     atomics (integer sums are exact in any order) and are added to the
//     state once at the end. One CTA is the state's only writer, and
//     launches on one stream run in order, so the final adds need no
//     atomics.
//   * The three float sums are reduced in a fixed order, so that two runs on
//     the same inputs give the same bits: the tile's samples are staged in
//     shared memory, warp k sums bucket k (lanes over a fixed stride, then a
//     fixed butterfly of shuffles), tile after tile, and the window's sum is
//     added to the state's value once, as the JAX step adds its window sum.
//   * Every float op the plain PyTorch version performs is an explicitly
//     rounded intrinsic and the file is built with --fmad=false, so the
//     buckets equal the plain version's bit for bit; only the float sums'
//     order differs from it.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;          // lanes per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxEdges = 32;
constexpr int kMaxBuckets = kMaxEdges + 1;

struct Edges {
  float rating[kMaxEdges];
  float wait[kMaxEdges];
  int n_rating, n_wait;
};

// searchsorted(edges[:n], x, side="right"): the number of edges not above x
// (NaN sorts last, as in numpy and PyTorch).
__device__ __forceinline__ int bucket_right(const float* edges, int n, float x) {
  int b = 0;
  for (int i = 0; i < n; ++i) b += !(edges[i] > x);
  return b;
}

__device__ __forceinline__ float effective(float thr, float enq, float now,
                                           float widen, float max_thr) {
  if (widen <= 0.0f) return thr;
  const float waited = fmaxf(0.0f, __fadd_rn(now, -enq));
  return fminf(max_thr, __fadd_rn(thr, __fmul_rn(widen, waited)));
}

struct Params {
  const float* out;  // f32[3, B]
  const float* rating;
  const float* enq;
  const float* thr;
  int32_t* q_hist;  // [R, NQ]
  int32_t* w_hist;  // [R, NW]
  int32_t* count;   // [R]
  float* q_sum;     // [R]
  float* w_sum;
  float* d_sum;
  int b, capacity, n_quality;
  float now, widen, max_thr;
};

__global__ void __launch_bounds__(kThreads)
quality_accum_kernel(const __grid_constant__ Params p,
                     const __grid_constant__ Edges e) {
  extern __shared__ int32_t s_hist[];  // q_hist, w_hist, count
  __shared__ int8_t s_rb[2 * kThreads];  // -1: no sample
  __shared__ float s_val[3][2 * kThreads];  // quality, wait, d
  __shared__ float s_sum[3][kMaxBuckets];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_r = e.n_rating + 1;
  const int n_w = e.n_wait + 1;
  const int nq = p.n_quality;
  int32_t* h_q = s_hist;
  int32_t* h_w = s_hist + n_r * nq;
  int32_t* h_c = h_w + n_r * n_w;
  const int n_hist = n_r * (nq + n_w + 1);
  for (int i = tid; i < n_hist; i += kThreads) s_hist[i] = 0;
  if (tid < 3 * kMaxBuckets) s_sum[tid / kMaxBuckets][tid % kMaxBuckets] = 0.0f;
  __syncthreads();

  for (int base = 0; base < p.b; base += kThreads) {
    const int l = base + tid;
    int rb[2] = {-1, -1};
    if (l < p.b) {
      const int q_slot = static_cast<int>(p.out[l]);
      const int c_slot = static_cast<int>(p.out[p.b + l]);
      if (q_slot < p.capacity) {  // a matched lane: both sides are samples
        // Gathers clipped into the pool, as the JAX step's are.
        const int slot[2] = {min(max(q_slot, 0), p.capacity - 1),
                             min(max(c_slot, 0), p.capacity - 1)};
        float enq[2], eff[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          enq[s] = p.enq[slot[s]];
          eff[s] = effective(p.thr[slot[s]], enq[s], p.now, p.widen, p.max_thr);
        }
        const float limit = fminf(eff[0], eff[1]);
        const float d = p.out[2 * p.b + l];
        float quality = 0.0f;
        if (limit > 0.0f) {
          const float frac = __fdiv_rn(d, fmaxf(limit, 1e-30f));
          quality = fminf(fmaxf(__fadd_rn(1.0f, -frac), 0.0f), 1.0f);
        }
        int qb = __float2int_rz(__fmul_rn(quality, static_cast<float>(nq)));
        qb = min(max(qb, 0), nq - 1);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float wait = fmaxf(0.0f, __fadd_rn(p.now, -enq[s]));
          rb[s] = bucket_right(e.rating, e.n_rating, p.rating[slot[s]]);
          const int wb = bucket_right(e.wait, e.n_wait, wait);
          atomicAdd(&h_q[rb[s] * nq + qb], 1);
          atomicAdd(&h_w[rb[s] * n_w + wb], 1);
          atomicAdd(&h_c[rb[s]], 1);
          s_val[0][2 * tid + s] = quality;
          s_val[1][2 * tid + s] = wait;
          s_val[2][2 * tid + s] = d;
        }
      }
    }
    s_rb[2 * tid] = static_cast<int8_t>(rb[0]);
    s_rb[2 * tid + 1] = static_cast<int8_t>(rb[1]);
    __syncthreads();
    // The tile's float sums, one warp per rating bucket, in a fixed order.
    for (int k = warp; k < n_r; k += kWarps) {
      float acc[3] = {0.0f, 0.0f, 0.0f};
      for (int j = lane; j < 2 * kThreads; j += 32) {
        if (s_rb[j] == k) {
#pragma unroll
          for (int v = 0; v < 3; ++v) acc[v] = __fadd_rn(acc[v], s_val[v][j]);
        }
      }
#pragma unroll
      for (int v = 0; v < 3; ++v) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc[v] = __fadd_rn(acc[v], __shfl_xor_sync(0xffffffffu, acc[v], off));
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int v = 0; v < 3; ++v) s_sum[v][k] = __fadd_rn(s_sum[v][k], acc[v]);
      }
    }
    __syncthreads();  // the tile's samples are summed: the next may overwrite
  }

  // One CTA writes the state: plain read-modify-writes.
  const int n_q_cells = n_r * nq, n_w_cells = n_r * n_w;
  for (int i = tid; i < n_q_cells; i += kThreads) p.q_hist[i] += h_q[i];
  for (int i = tid; i < n_w_cells; i += kThreads) p.w_hist[i] += h_w[i];
  if (tid < n_r) {
    p.count[tid] += h_c[tid];
    p.q_sum[tid] = __fadd_rn(p.q_sum[tid], s_sum[0][tid]);
    p.w_sum[tid] = __fadd_rn(p.w_sum[tid], s_sum[1][tid]);
    p.d_sum[tid] = __fadd_rn(p.d_sum[tid], s_sum[2][tid]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches quality_accum_kernel on
// `stream`, does not synchronise, and returns the first CUDA error
// (cudaGetLastError() after the launch). Arguments the kernel does not take
// (more than 32 edges, a histogram above the shared memory it may use) are
// refused with cudaErrorInvalidValue before anything is launched.
extern "C" int quality_accum_launch(
    const void* out, int b, const void* rating, const void* enq,
    const void* thr, int capacity, float now, float widen, float max_thr,
    int n_quality, const float* rating_edges, int n_rating_edges,
    const float* wait_edges, int n_wait_edges, void* q_hist, void* w_hist,
    void* count, void* q_sum, void* w_sum, void* d_sum, void* stream) {
  if (b <= 0) return 0;
  if (n_rating_edges < 0 || n_rating_edges > kMaxEdges || n_wait_edges < 0 ||
      n_wait_edges > kMaxEdges || n_quality < 1 || capacity <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t hist_bytes = sizeof(int32_t) * (n_rating_edges + 1) *
                            (n_quality + n_wait_edges + 2);
  if (hist_bytes > 32 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  Edges e;
  for (int i = 0; i < kMaxEdges; ++i) {
    e.rating[i] = i < n_rating_edges ? rating_edges[i] : 0.0f;
    e.wait[i] = i < n_wait_edges ? wait_edges[i] : 0.0f;
  }
  e.n_rating = n_rating_edges;
  e.n_wait = n_wait_edges;
  Params p;
  p.out = static_cast<const float*>(out);
  p.rating = static_cast<const float*>(rating);
  p.enq = static_cast<const float*>(enq);
  p.thr = static_cast<const float*>(thr);
  p.q_hist = static_cast<int32_t*>(q_hist);
  p.w_hist = static_cast<int32_t*>(w_hist);
  p.count = static_cast<int32_t*>(count);
  p.q_sum = static_cast<float*>(q_sum);
  p.w_sum = static_cast<float*>(w_sum);
  p.d_sum = static_cast<float*>(d_sum);
  p.b = b;
  p.capacity = capacity;
  p.n_quality = n_quality;
  p.now = now;
  p.widen = widen;
  p.max_thr = max_thr;
  quality_accum_kernel<<<1, kThreads, hist_bytes,
                         static_cast<cudaStream_t>(stream)>>>(p, e);
  return static_cast<int>(cudaGetLastError());
}
