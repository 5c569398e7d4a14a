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
// slot still holds its player's values. `now` is read from the device: it is
// the packed window's `now` row, so the launch takes no host time value.
//
// What bounds it on an H100: nothing but latency. A window of B = 1,024 lanes
// reads 12 KB of results and 2,048 x 3 gathered words and writes ~1.5 KB of
// state: well under a microsecond of memory time. The floor is the launch,
// then one dependent chain (result -> slot -> gathered columns -> state).
//
// The design, and why:
//   * One wave: 1,024 threads, one per lane, so every lane of a window of up
//     to 1,024 is in flight at once and the pair's limit needs no exchange
//     (larger windows loop over tiles of 1,024 lanes). They are one CTA for
//     a window of up to 256 lanes, which has the least fixed cost, and a
//     thread block cluster of 8 CTAs above, which spreads the per-sample
//     work over 8 SMs (a template instance each; clusters of 2 and 4 were
//     timed at every window bucket and beat neither). Each CTA adds into
//     rank 0's shared histograms and
//     partials through distributed shared memory; a split cluster barrier
//     (arrive once rank 0's histograms are zero, wait just before the first
//     add) keeps the first barrier off the dependent chain, and a second
//     one lets rank 0 read everything before anyone exits.
//   * The dependent chain is short: the window's time, this thread's first
//     lane of the result and (rank 0) the state words it will update are
//     all loaded before the first barrier; then the gathers at both slots;
//     then the shared adds; then the state stores.
//   * Integer histograms and counts: shared memory, one atomic per group of
//     lanes with the same cell (__match_any_sync, the group's size added
//     once), then added to the state at the end. Integer sums are exact in
//     any order. Rank 0 is the state's only writer and launches on one
//     stream run in order, so the final adds are plain read-modify-writes.
//   * Float sums that cost what the samples cost, in a fixed order: each warp
//     finds the rating buckets present among its 64 samples (an OR-reduce
//     of each lane's two bucket bits) and, per present bucket, runs a fixed
//     butterfly of shuffles over the lanes' masked values (a lane outside
//     the bucket adds +0.0, which changes no bit: every addend is >= 0).
//     Lane k keeps bucket k's running sum (lane 0 also bucket 32) across
//     tiles, and writes it to a fixed slot per (warp of the cluster,
//     bucket); rank 0 then adds the 32 warps' slots in warp order and adds
//     the window's sum to the state once, as the JAX step adds its window
//     sum. The same inputs give the same bits on every run, at either
//     cluster size.
//   * Edges in shared memory, searched with a branch-free binary search (six
//     probes for up to 32 edges, where a linear count costs up to 32 loads
//     and compares per search and four searches run per lane).
//   * One state pointer: the state is one flat i32 buffer, laid out as
//     q_hist [R, NQ], w_hist [R, NW], count [R], then the f32 sums q_sum,
//     w_sum, d_sum [R] each; the kernel derives the offsets from R, NQ, NW.
//   * Every float op the plain PyTorch version performs is an explicitly
//     rounded intrinsic and the file is built with --fmad=false, so the
//     buckets equal the plain version's bit for bit; only the float sums'
//     order differs from it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int kQualityMaxEdges = 32;

// What stays fixed for an engine's state and pool: bound once on the host
// and passed by value (grid-constant parameter space).
struct QualityAccumParams {
  const float* rating;  // pool columns, [capacity]
  const float* enq;
  const float* thr;
  int32_t* state;  // the flat state buffer (layout above)
  int capacity, n_quality, n_rating_edges, n_wait_edges;
  float widen, max_thr;
  float rating_edges[kQualityMaxEdges];  // ascending; entries past n_* unused
  float wait_edges[kQualityMaxEdges];
};

namespace {

using Params = QualityAccumParams;
constexpr int kThreads = 1024;  // lanes per tile: one cluster, one wave
constexpr int kWarps = kThreads / 32;  // over the cluster's CTAs
constexpr int kMaxEdges = kQualityMaxEdges;
constexpr int kMaxBuckets = kMaxEdges + 1;
constexpr unsigned kFull = 0xffffffffu;
// Windows of up to kOneCtaMaxB lanes launch one CTA; larger ones a cluster
// of kClusterCtas.
constexpr int kOneCtaMaxB = 256;
constexpr int kClusterCtas = 8;

// searchsorted(edges[:n], x, side="right") over ascending edges: the number
// of edges not above x (NaN sorts last, as in numpy and PyTorch). Binary
// lifting with a select per probe: no branch, six probes.
__device__ __forceinline__ int bucket_right(const float* edges, int n, float x) {
  int lo = 0;
#pragma unroll
  for (int step = kMaxEdges; step > 0; step >>= 1) {
    const int probe = lo + step;
    const float e = edges[min(probe, kMaxEdges) - 1];
    lo = (probe <= n && !(e > x)) ? probe : lo;
  }
  return lo;
}

__device__ __forceinline__ float effective(float thr, float enq, float now,
                                           float widen, float max_thr) {
  if (widen <= 0.0f) return thr;
  const float waited = fmaxf(0.0f, __fadd_rn(now, -enq));
  return fminf(max_thr, __fadd_rn(thr, __fmul_rn(widen, waited)));
}

// One shared atomic per group of lanes that hit the same cell (cell < 0: no
// sample).
__device__ __forceinline__ void add_grouped(int32_t* hist, int cell) {
  const unsigned grp = __match_any_sync(kFull, cell);
  if (cell >= 0 && (threadIdx.x & 31) == __ffs(grp) - 1) {
    atomicAdd(&hist[cell], __popc(grp));
  }
}

// The cluster barrier, split: arrive early, wait where the data is needed
// (a CTA's __syncthreads when the cluster is one CTA).
template <int CL>
__device__ __forceinline__ void cluster_arrive() {
  if constexpr (CL > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

template <int CL>
__device__ __forceinline__ void cluster_wait() {
  if constexpr (CL > 1) {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// Rank 0's shared memory at `local` (the local pointer itself when the
// cluster is one CTA, so the atomics stay shared-memory atomics).
template <int CL, typename T>
__device__ __forceinline__ T* leader(T* local) {
  if constexpr (CL > 1) {
    return cg::this_cluster().map_shared_rank(local, 0);
  } else {
    return local;
  }
}

// Prefetched state words per thread of rank 0 (the rest is read at the end).
constexpr int kPrefetch = 4;

template <int CL>
__global__ void __launch_bounds__(kThreads / CL)
quality_accum_kernel(const float* __restrict__ out, int b,
                     const float* __restrict__ now_p,
                     const __grid_constant__ Params p) {
  extern __shared__ int32_t s_hist[];  // q_hist, w_hist, count (rank 0's)
  __shared__ float s_edges[2][kMaxEdges];
  __shared__ float s_part[3][kWarps][kMaxBuckets];  // quality, wait, d

  constexpr int kCta = kThreads / CL;  // threads per CTA
  const unsigned rank = CL > 1 ? cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = rank * (kCta / 32) + (tid >> 5);  // in the cluster
  const int n_r = p.n_rating_edges + 1;
  const int n_w = p.n_wait_edges + 1;
  const int nq = p.n_quality;
  const int n_hist = n_r * (nq + n_w + 1);
  const int n_state = n_hist + 3 * n_r;

  // The loads that start the dependent chain go out first: the window's
  // time and this thread's first lane; rank 0 also prefetches the state
  // words it will update at the end.
  const float now = *now_p;
  int l = rank * kCta + tid;
  int q_slot = l < b ? static_cast<int>(out[l]) : p.capacity;
  int c_slot = 0;
  float d = 0.0f;
  if (q_slot < p.capacity) {
    c_slot = static_cast<int>(out[b + l]);
    d = out[2 * b + l];
  }
  int32_t pre[kPrefetch];
  if (rank == 0) {
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int i = tid + j * kCta;
      pre[j] = i < n_state ? p.state[i] : 0;
    }
    for (int i = tid; i < n_hist; i += kCta) s_hist[i] = 0;
  }
  for (int i = tid; i < 2 * kMaxEdges; i += kCta) {
    s_edges[i / kMaxEdges][i % kMaxEdges] =
        i < kMaxEdges ? p.rating_edges[i] : p.wait_edges[i - kMaxEdges];
  }
  // Rank 0's histograms are zero before anyone adds to them; each CTA's
  // edges are in place before it searches them.
  cluster_arrive<CL>();
  if constexpr (CL > 1) __syncthreads();
  int32_t* h_q = leader<CL>(&s_hist[0]);
  int32_t* h_w = h_q + n_r * nq;
  int32_t* h_c = h_w + n_r * n_w;
  float* part = leader<CL>(&s_part[0][0][0]);

  // Lane k's running sums of rating bucket k over this warp's samples (lane
  // 0 also keeps bucket 32's).
  float mine[3] = {0.0f, 0.0f, 0.0f};
  float mine_top[3] = {0.0f, 0.0f, 0.0f};
  for (int base = 0; base < b; base += kThreads) {
    if (base > 0) {
      l = base + rank * kCta + tid;
      q_slot = l < b ? static_cast<int>(out[l]) : p.capacity;
      if (q_slot < p.capacity) {
        c_slot = static_cast<int>(out[b + l]);
        d = out[2 * b + l];
      }
    }
    int rb[2] = {-1, -1};
    int q_cell[2] = {-1, -1}, w_cell[2] = {-1, -1};
    float val[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
    if (q_slot < p.capacity) {  // a matched lane: both sides are samples
      // Gathers clipped into the pool, as the JAX step's are.
      const int slot[2] = {min(max(q_slot, 0), p.capacity - 1),
                           min(max(c_slot, 0), p.capacity - 1)};
      float enq[2], eff[2], rating[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        enq[s] = p.enq[slot[s]];
        rating[s] = p.rating[slot[s]];
        eff[s] = effective(p.thr[slot[s]], enq[s], now, p.widen, p.max_thr);
      }
      const float limit = fminf(eff[0], eff[1]);
      float quality = 0.0f;
      if (limit > 0.0f) {
        const float frac = __fdiv_rn(d, fmaxf(limit, 1e-30f));
        quality = fminf(fmaxf(__fadd_rn(1.0f, -frac), 0.0f), 1.0f);
      }
      int qb = __float2int_rz(__fmul_rn(quality, static_cast<float>(nq)));
      qb = min(max(qb, 0), nq - 1);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float wait = fmaxf(0.0f, __fadd_rn(now, -enq[s]));
        rb[s] = bucket_right(s_edges[0], p.n_rating_edges, rating[s]);
        const int wb = bucket_right(s_edges[1], p.n_wait_edges, wait);
        q_cell[s] = rb[s] * nq + qb;
        w_cell[s] = rb[s] * n_w + wb;
        val[s][0] = quality;
        val[s][1] = wait;
        val[s][2] = d;
      }
    }
    if (base == 0) cluster_wait<CL>();  // before the first add into rank 0
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      add_grouped(h_q, q_cell[s]);
      add_grouped(h_w, w_cell[s]);
    }
    // The rating buckets present among the warp's 64 samples.
    unsigned bits = 0u, top = 0u;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (rb[s] >= 0 && rb[s] < 32) bits |= 1u << rb[s];
      if (rb[s] == 32) top = 1u;
    }
    unsigned present = __reduce_or_sync(kFull, bits);
    const bool has_top = __any_sync(kFull, top);
    while (present != 0u || has_top) {
      const int k = present != 0u ? __ffs(present) - 1 : 32;
      const bool in0 = rb[0] == k, in1 = rb[1] == k;
      float x[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        x[v] = __fadd_rn(in0 ? val[0][v] : 0.0f, in1 ? val[1][v] : 0.0f);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          x[v] = __fadd_rn(x[v], __shfl_xor_sync(kFull, x[v], off));
        }
      }
      const int n = __popc(__ballot_sync(kFull, in0)) +
                    __popc(__ballot_sync(kFull, in1));
      if (lane == (k & 31)) {
        if (k < 32) {
#pragma unroll
          for (int v = 0; v < 3; ++v) mine[v] = __fadd_rn(mine[v], x[v]);
        } else {
#pragma unroll
          for (int v = 0; v < 3; ++v) mine_top[v] = __fadd_rn(mine_top[v], x[v]);
        }
        atomicAdd(&h_c[k], n);
      }
      if (k == 32) break;  // bucket 32 comes last
      present &= present - 1u;
    }
  }
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    float* slot = part + (v * kWarps + warp) * kMaxBuckets;
    slot[lane] = mine[v];
    if (lane == 0) slot[32] = mine_top[v];
  }
  // Every rank's adds and partials are in rank 0 (release/acquire); the
  // other ranks may then exit.
  cluster_arrive<CL>();
  cluster_wait<CL>();
  if (rank != 0) return;

  // Rank 0 writes the state: the prefetched words (and, past them, words
  // read now) plus the window's histograms, and the sums plus the window's
  // sums, added over the 32 warps in warp order.
  auto update = [&](int i, int32_t old) {
    if (i < n_hist) {
      p.state[i] = old + s_hist[i];
    } else {
      const int v = (i - n_hist) / n_r, k = (i - n_hist) % n_r;
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc = __fadd_rn(acc, s_part[v][w][k]);
      p.state[i] = __float_as_int(__fadd_rn(__int_as_float(old), acc));
    }
  };
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
    const int i = tid + j * kCta;
    if (i < n_state) update(i, pre[j]);
  }
  for (int i = tid + kPrefetch * kCta; i < n_state; i += kCta) {
    update(i, p.state[i]);
  }
}

template <int CL>
__global__ void __launch_bounds__(kThreads / CL)
empty_kernel(const float*, int, const float*, const __grid_constant__ Params) {}

using Kernel = void (*)(const float*, int, const float*, const Params);

// One cluster of CL CTAs of kThreads / CL threads each.
template <int CL>
int launch(bool empty, const void* out, int b, const void* now,
           const Params& p, size_t smem, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(kThreads / CL, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  const Kernel kernel = empty ? empty_kernel<CL> : quality_accum_kernel<CL>;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(out), b,
                         static_cast<const float*>(now), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_for(bool empty, const void* out, int b, const void* now,
               const Params& p, size_t smem, void* stream) {
  return b <= kOneCtaMaxB
             ? launch<1>(empty, out, b, now, p, smem, stream)
             : launch<kClusterCtas>(empty, out, b, now, p, smem, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches quality_accum_kernel (one
// CTA, or a cluster of 8 above 256 lanes) on `stream` for the window result
// `out` (f32[3, b]) at the device time *now,
// with the state, pool columns, edges and constants of `params`; does not
// synchronise, and returns the first CUDA error (cudaGetLastError() after
// the launch). Parameters the kernel does not take (more than 32 edges, a
// histogram above the shared memory it may use) are refused with
// cudaErrorInvalidValue before anything is launched.
extern "C" int quality_accum_launch(const void* out, int b, const void* now,
                                    const QualityAccumParams* params,
                                    void* stream) {
  if (b <= 0) return 0;
  const QualityAccumParams& p = *params;
  if (p.n_rating_edges < 0 || p.n_rating_edges > kMaxEdges ||
      p.n_wait_edges < 0 || p.n_wait_edges > kMaxEdges || p.n_quality < 1 ||
      p.capacity <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t hist_bytes = sizeof(int32_t) * (p.n_rating_edges + 1) *
                            (p.n_quality + p.n_wait_edges + 2);
  if (hist_bytes > 32 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  return launch_for(false, out, b, now, p, hist_bytes, stream);
}

// An empty kernel launched the same way (the same cluster, CTAs and
// parameters): the launch-latency floor that chip_smoke.py times beside
// quality_accum.
extern "C" int quality_accum_empty_launch(const void* out, int b,
                                          const void* now,
                                          const QualityAccumParams* params,
                                          void* stream) {
  return launch_for(true, out, b, now, *params, 0, stream);
}
