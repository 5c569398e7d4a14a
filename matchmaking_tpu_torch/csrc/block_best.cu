// block_best: fused masked scoring + best candidate per pool block, for Hopper.
//
// Replaces the TPU kernel matchmaking_tpu/engine/pallas_kernels.py:
// pallas_block_best (body _kernel). For every request row r of a window and
// every pool block j (pool_block slots wide) it writes
//
//   out_v[r, j] = max over slots c in block j of  -d(r, c)  among valid c
//   out_i[r, j] = the lowest such slot reaching that max, or `capacity`
//                 when no slot of the block is valid (out_v = -inf),
//
// where d = |rating_r - rating_c|, times 1 / sqrt(1 + g * (rd_r^2 + rd_c^2))
// under Glicko-2, and c is valid iff it is active, row r is valid, region and
// mode are wildcard (0) or equal (when `filters`), c is not r's own slot, and
// d <= q_thr_eff[r] and d <= min(max_thr, thr_c + widen * max(0, now - enq_c)).
// These are the candidate lists of the JAX engine's dense step
// (kernels.KernelSet._candidates); the tie rule is jnp.argmax's first index.
//
// What bounds it on an H100: at the main path's width (B = 1024 rows against
// P = 131,072 slots, 16 blocks of 8,192) the kernel evaluates 1.34e8 pairs
// against slot records of 1-3 MB that stay in the 50 MB L2. The ELO pair is
// 5.75 issued instructions (SASS, with the loop's share), four of them
// compares and selects, which an SM issues at 64 lanes per clock, not 128:
// it is bound by that pipe, not by memory. At the small window buckets
// (B = 16, 64) it is bound by latency: two launches, the first copies, the
// merges.
//
// The design, and why:
//   * Two kernels on the stream. `prep_kernel` writes one packed record per
//     slot into scratch that the wrapper allocates: (rating, widened
//     threshold) as 8 B, the threshold -inf for an inactive slot so that
//     `d <= thr` alone rejects it; and, for Glicko-2 or filters, a second
//     16 B record (rd^2, region, mode). So the widening, the active test and
//     rd^2 are done once per slot per launch, not once per row-group CTA, and
//     each block's records start 16-slot aligned whatever pool_block is,
//     which the bulk copies need. `block_best_kernel` is launched with
//     programmatic dependent launch: its CTAs load their rows and set up
//     their barriers while prep_kernel runs, and wait (griddepcontrol.wait)
//     only before the first copy of records.
//   * One instance per variant: template <GLICKO2, FILTERS>, dispatched on
//     the host. Each stages and holds only what it reads; the ELO instance
//     stages 8 B per slot and keeps 4 values per row in registers.
//   * Fewest tests per pair. The row's threshold is folded into its running
//     best (see Rounding below), and the own-slot test runs only in the
//     tiles that hold one of the warp's own slots (a warp-uniform check per
//     tile), so the ELO pair is |Δ|, two compares and two selects.
//   * The grid is planned from the window (cuda_kernels.plan_grid): a CTA is
//     8 warps, each warp owns 8 request rows held in registers, and each
//     candidate read from shared memory feeds those 8 pair evaluations. A
//     CTA holds rows_per_cta in {8, 16, 32, 64} rows: rows_per_cta / 8 row
//     warps, and the other warps split the candidates, so at B = 16 every
//     warp is busy. Each pool block's slots can be split over the S CTAs of
//     a thread block cluster (S a power of two <= 8). The planner starts
//     from the fewest rows per CTA that hold the window and, until the grid
//     has two CTAs per SM, splits blocks in two, cuts rows per CTA to 16,
//     grows the cluster, then cuts rows to 8 (the order that timing every
//     plan on the H100 favoured: chip_smoke.py --plan-sweep).
//   * Staging overlaps the pairs: each CTA streams its slice of records
//     through a ring of kStages shared-memory tiles of kTile slots, filled by
//     1-D bulk copies (cp.async.bulk, completion counted on an mbarrier, no
//     tensor map). While the pairs of tile t are scored, tiles t+1..t+3 are
//     in flight. One __syncthreads per tile releases a ring slot for refill.
//   * Merging, exact and with no atomics: each lane walks its candidates in
//     ascending slot order keeping a running (distance, slot) with strict
//     `<`; a warp shuffle reduction, then the candidate-splitting warps
//     through shared memory, then the cluster's CTAs through distributed
//     shared memory each take the smaller distance or, on equal distances,
//     the lower slot. Each rank pushes its partials into rank 0's shared
//     memory (remote stores through cluster.map_shared_rank) before one
//     cluster.sync(), and rank 0 merges them locally: one cluster barrier,
//     and no remote load waited on. Minimising d with the lower slot on
//     ties is maximising -d with the first index, so every level keeps
//     jnp.argmax's rule.
//   * No tensor cores, TMA tensor maps or wgmma: the pair math is compares
//     and a few FP32 ops, which the tensor cores do not serve.
//
// The span launch, for the pruned step (kernels.KernelSet's rating-banded
// path; the JAX package's _candidates_pruned): with span_start set and the
// device flag *feasible nonzero, the rows of chunk c (rows [c * chunk_rows,
// (c + 1) * chunk_rows) of a rating-sorted window) score only the blocks
// [span_start[c], span_start[c] + span_blocks); every other (row, block)
// cell gets -inf / capacity. A CTA whose block lies outside the span of
// every chunk its rows belong to writes that and returns before any
// barrier (the planner makes rows_per_cta divide chunk_rows, so a CTA's
// rows share one chunk); a row outside its chunk's span is not live. With
// *feasible zero every CTA scores: the whole-window dense fallback, decided
// on the device, with no host read. The dense launch passes no span.
//
// Rounding: every float op the plain PyTorch version also performs is done
// with an explicitly rounded intrinsic (__fadd_rn, __fmul_rn, __fsqrt_rn,
// __frcp_rn: the correctly rounded 1/x, the same value as an IEEE 1.0f / x),
// and the file is built with --fmad=false, so no mul-add is contracted into
// an FMA. `d <= min(q_thr_eff, thr_c)` is tested as `d <= thr_c && d <
// best_d`, with the row's best_d starting at the next float above
// q_thr_eff: the same predicate as the plain version's torch.minimum for
// every input, NaN included, with one compare per pair fewer. The kernel is
// bit-identical to cuda_kernels.block_best_reference on the same CUDA
// tensors.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kMaxRowsPerCta = kWarps * kRowsPerWarp;
constexpr int kMaxCluster = 8;
constexpr int kTile = 512;     // slots per ring tile
constexpr int kStages = 4;     // ring depth
constexpr int kAlign = 16;     // slots: each block's records start 16-aligned

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// 1-D bulk copy global -> shared; `bytes` and both addresses 16-B aligned.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The second record of a slot (Glicko-2 and/or filters).
struct Extra {
  float rd2;
  int32_t region, mode, pad;
};

// ---- prep: one packed record per slot ---------------------------------------

template <bool GLICKO2, bool FILTERS>
__global__ void __launch_bounds__(256)
prep_kernel(const float* __restrict__ c_rating, const float* __restrict__ c_rd,
            const int32_t* __restrict__ c_region,
            const int32_t* __restrict__ c_mode,
            const float* __restrict__ c_thr, const float* __restrict__ c_enq,
            const uint8_t* __restrict__ c_active, float2* __restrict__ rec_a,
            Extra* __restrict__ rec_b, int capacity, int pool_block,
            int stride, const float* __restrict__ now, float widen,
            float max_thr) {
  // Let block_best_kernel's CTAs start their set-up now; they wait for this
  // grid to finish (griddepcontrol.wait) before they read a record.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= capacity) return;
  const int blk = g / pool_block;
  const int o = blk * stride + (g - blk * pool_block);
  float thr = c_thr[g];
  if (widen > 0.0f) {
    const float waited = fmaxf(0.0f, __fadd_rn(*now, -c_enq[g]));
    thr = fminf(max_thr, __fadd_rn(thr, __fmul_rn(widen, waited)));
  }
  rec_a[o] = make_float2(c_rating[g], c_active[g] != 0 ? thr : -CUDART_INF_F);
  if (GLICKO2 || FILTERS) {
    Extra e;
    const float rd = GLICKO2 ? c_rd[g] : 0.0f;
    e.rd2 = __fmul_rn(rd, rd);
    e.region = FILTERS ? c_region[g] : 0;
    e.mode = FILTERS ? c_mode[g] : 0;
    e.pad = 0;
    rec_b[o] = e;
  }
}

// ---- the scorer ------------------------------------------------------------

struct Params {
  const float2* rec_a;
  const Extra* rec_b;
  const int32_t* q_slot;
  const float* q_rating;
  const float* q_rd;
  const float* q_thr_eff;
  const int32_t* q_region;
  const int32_t* q_mode;
  const uint8_t* q_valid;
  float* out_v;
  int32_t* out_i;
  const int32_t* span_start;  // null: the dense launch
  const uint8_t* feasible;
  int n_rows, n_blocks, pool_block, stride, capacity;
  int rows_per_cta, cluster, slice;
  int chunk_rows, span_blocks;
  float g_coeff;
};

__device__ __forceinline__ bool in_span(const Params& p, int row, int blk) {
  const int s = p.span_start[row / p.chunk_rows];
  return blk >= s && blk < s + p.span_blocks;
}

__device__ __forceinline__ bool better(float od, int oi, float d, int i) {
  return od < d || (od == d && oi < i);
}

template <bool GLICKO2, bool FILTERS>
__global__ void __launch_bounds__(kThreads)
block_best_kernel(const __grid_constant__ Params p) {
  constexpr bool kExtra = GLICKO2 || FILTERS;
  extern __shared__ __align__(128) unsigned char smem[];
  float2* s_a = reinterpret_cast<float2*>(smem);                 // [kStages][kTile]
  Extra* s_b = reinterpret_cast<Extra*>(smem + kStages * kTile * sizeof(float2));
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float w_d[kWarps][kRowsPerWarp];
  __shared__ int w_i[kWarps][kRowsPerWarp];
  __shared__ float c_d[kMaxCluster][kMaxRowsPerCta];  // read in rank 0
  __shared__ int c_i[kMaxCluster][kMaxRowsPerCta];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int S = p.cluster;
  const int blk = blockIdx.x / S;
  const int rank = blockIdx.x - blk * S;
  const int row_warps = p.rows_per_cta / kRowsPerWarp;
  const int rw = warp % row_warps;          // which 8 rows
  const int sw = warp / row_warps;          // which share of the candidates
  const int slot_warps = kWarps / row_warps;
  const int row0 = blockIdx.y * p.rows_per_cta + rw * kRowsPerWarp;

  // The span launch of a feasible window: a block outside every span of
  // this CTA's rows has no candidate for them (uniform over the cluster,
  // whose CTAs share blk and blockIdx.y).
  const bool span = p.span_start != nullptr && *p.feasible != 0;
  if (span) {
    const int first = blockIdx.y * p.rows_per_cta;
    const int last = min(first + p.rows_per_cta, p.n_rows) - 1;
    bool any = false;
    for (int r = first; r <= last && !any; r += p.chunk_rows) {
      any = in_span(p, r, blk);
    }
    any = any || in_span(p, last, blk);
    if (!any) {
      const int row = first + tid;
      if (rank == 0 && tid < p.rows_per_cta && row < p.n_rows) {
        p.out_v[static_cast<size_t>(row) * p.n_blocks + blk] = -CUDART_INF_F;
        p.out_i[static_cast<size_t>(row) * p.n_blocks + blk] = p.capacity;
      }
      return;
    }
  }

  // This warp's rows, in registers. The row's own threshold is folded into
  // its running best: best_d starts at the next float above it, so
  // `d < best_d` alone also tests `d <= q_thr_eff` (for every d, NaN
  // included). An invalid or missing row gets the threshold -inf, which no
  // distance meets; "found" is best_i != capacity.
  float r_rating[kRowsPerWarp], r_rd2[kRowsPerWarp];
  int r_slot[kRowsPerWarp], r_region[kRowsPerWarp], r_mode[kRowsPerWarp];
  float best_d[kRowsPerWarp];
  int best_i[kRowsPerWarp];
  bool any_live = false;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    const bool live = row < p.n_rows && p.q_valid[row] != 0 &&
                      (!span || in_span(p, row, blk));
    const int src = row < p.n_rows ? row : 0;
    r_rating[r] = p.q_rating[src];
    r_slot[r] = p.q_slot[src];
    if (GLICKO2) {
      const float rd = p.q_rd[src];
      r_rd2[r] = __fmul_rn(rd, rd);
    }
    if (FILTERS) {
      r_region[r] = p.q_region[src];
      r_mode[r] = p.q_mode[src];
    }
    best_d[r] = nextafterf(live ? p.q_thr_eff[src] : -CUDART_INF_F,
                           CUDART_INF_F);
    best_i[r] = p.capacity;
    any_live = any_live || live;
  }

  const int k0 = rank * p.slice;            // first slot of the slice, in block
  const int n_tiles = (p.slice + kTile - 1) / kTile;
  const float2* g_a = p.rec_a + static_cast<size_t>(blk) * p.stride + k0;
  const Extra* g_b = p.rec_b + static_cast<size_t>(blk) * p.stride + k0;
  auto issue = [&](int t) {
    const int s = t % kStages;
    const int n = min(kTile, p.slice - t * kTile);
    const uint32_t bytes_a = ((n + 1) & ~1) * sizeof(float2);  // 16-B multiple
    const uint32_t bytes_b = kExtra ? n * sizeof(Extra) : 0;
    mbar_expect_tx(&full[s], bytes_a + bytes_b);
    bulk_g2s(s_a + s * kTile, g_a + t * kTile, bytes_a, &full[s]);
    if (kExtra) bulk_g2s(s_b + s * kTile, g_b + t * kTile, bytes_b, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // First phase of the cluster barrier: arrive now, wait before the first
  // DSMEM store, which then cannot reach a CTA that has not started.
  if (S > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // The records are prep_kernel's output: wait for that grid to complete.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid == 0) {
    for (int t = 0; t < min(kStages, n_tiles); ++t) issue(t);
  }

  const int base = blk * p.pool_block + k0;  // global slot of local index 0
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int n = min(kTile, p.slice - t * kTile);
    mbar_wait(&full[s], (t / kStages) & 1);
    if (any_live) {  // warp-uniform
      const float2* ta = s_a + s * kTile;
      const Extra* tb = s_b + s * kTile;
      const int g0 = base + t * kTile;
      // The candidate loop, with or without the test that a row does not
      // take its own slot: a row's own slot lies in one tile of one block,
      // so almost every (warp, tile) needs no such test.
      auto score = [&](auto check_self) {
        constexpr bool kSelf = decltype(check_self)::value;
#pragma unroll 2
        for (int j = sw * 32 + lane; j < n; j += slot_warps * 32) {
          const float2 a = ta[j];
          const int g = g0 + j;
          Extra e;
          if (kExtra) e = tb[j];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            float d = fabsf(__fadd_rn(r_rating[r], -a.x));
            if (GLICKO2) {
              const float rd2 = __fadd_rn(r_rd2[r], e.rd2);
              const float sq =
                  __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(p.g_coeff, rd2)));
              d = __fmul_rn(d, __frcp_rn(sq));
            }
            bool ok = d <= a.y && d < best_d[r] && (!kSelf || g != r_slot[r]);
            if (FILTERS) {
              ok = ok && (r_region[r] == 0 || e.region == 0 || r_region[r] == e.region)
                      && (r_mode[r] == 0 || e.mode == 0 || r_mode[r] == e.mode);
            }
            if (ok) {
              best_d[r] = d;
              best_i[r] = g;
            }
          }
        }
      };
      bool self_here = false;  // warp-uniform: the rows are the warp's
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        self_here = self_here || static_cast<unsigned>(r_slot[r] - g0) <
                                     static_cast<unsigned>(n);
      }
      if (self_here) {
        score(std::true_type{});
      } else {
        score(std::false_type{});
      }
    }
    __syncthreads();  // every warp is done with ring slot s
    if (tid == 0 && t + kStages < n_tiles) {
      // Order the generic-proxy reads of slot s before the async refill.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(t + kStages);
    }
  }

  // Warp, then the warps that split the candidates, then the cluster.
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float d = best_d[r];
    int i = best_i[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (better(od, oi, d, i)) {
        d = od;
        i = oi;
      }
    }
    if (lane == 0) {
      w_d[warp][r] = d;
      w_i[warp][r] = i;
    }
  }
  __syncthreads();
  if (S > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  if (tid < p.rows_per_cta) {
    const int w0 = tid / kRowsPerWarp, r = tid % kRowsPerWarp;
    float d = w_d[w0][r];
    int i = w_i[w0][r];
    for (int k = 1; k < slot_warps; ++k) {
      const int w = w0 + k * row_warps;
      if (better(w_d[w][r], w_i[w][r], d, i)) {
        d = w_d[w][r];
        i = w_i[w][r];
      }
    }
    // Push this CTA's partial into rank 0's shared memory (a remote store
    // through DSMEM when rank > 0), so that one cluster barrier suffices.
    *cluster.map_shared_rank(&c_d[rank][tid], 0) = d;
    *cluster.map_shared_rank(&c_i[rank][tid], 0) = i;
  }
  if (S > 1) {
    cluster.sync();  // release/acquire: every rank's partials are in rank 0
  } else {
    __syncthreads();
  }
  if (rank == 0 && tid < p.rows_per_cta) {
    float d = c_d[0][tid];
    int i = c_i[0][tid];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) {
      if (q < S && better(c_d[q][tid], c_i[q][tid], d, i)) {
        d = c_d[q][tid];
        i = c_i[q][tid];
      }
    }
    const int row = blockIdx.y * p.rows_per_cta + tid;
    if (row < p.n_rows) {
      const bool found = i != p.capacity;
      p.out_v[static_cast<size_t>(row) * p.n_blocks + blk] =
          found ? -d : -CUDART_INF_F;
      p.out_i[static_cast<size_t>(row) * p.n_blocks + blk] =
          found ? i : p.capacity;
    }
  }
}

size_t ring_bytes(bool extra) {
  return kStages * kTile * (sizeof(float2) + (extra ? sizeof(Extra) : 0));
}

// The ring of the Glicko-2 and filter instances is 48 KB, which with the
// static arrays is above the default limit. The limit is an attribute of
// the function on the current device: raise it once per instance and device,
// not on every launch.
template <bool G, bool F>
cudaError_t allow_ring(size_t smem) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];  // static: zero-initialised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(block_best_kernel<G, F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && cached) done[dev].store(true, std::memory_order_release);
  return err;
}

template <bool G, bool F>
int launch(const void* const* pool, const Params& p, const float* now,
           float widen, float max_thr, cudaStream_t stream) {
  const int threads = 256;
  prep_kernel<G, F><<<(p.capacity + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const float*>(pool[0]), static_cast<const float*>(pool[1]),
      static_cast<const int32_t*>(pool[2]), static_cast<const int32_t*>(pool[3]),
      static_cast<const float*>(pool[4]), static_cast<const float*>(pool[5]),
      static_cast<const uint8_t*>(pool[6]), const_cast<float2*>(p.rec_a),
      const_cast<Extra*>(p.rec_b), p.capacity, p.pool_block, p.stride, now,
      widen, max_thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = ring_bytes(G || F);
  err = allow_ring<G, F>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_blocks * p.cluster,
                     (p.n_rows + p.rows_per_cta - 1) / p.rows_per_cta, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, block_best_kernel<G, F>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches prep_kernel and
// block_best_kernel on `stream`, does not synchronise, and returns the first
// CUDA error (cudaGetLastError() after each launch), so that a refused
// launch is seen. The plan (rows_per_cta, cluster) comes from
// cuda_kernels.plan_grid; a plan the kernel does not take is refused with
// cudaErrorInvalidValue before anything is launched. `now` points at the
// window's time on the device (the packed window's now row), so that a
// launch captured into a CUDA graph reads each replay's own time.
extern "C" int block_best_launch(
    const void* c_rating, const void* c_rd, const void* c_region,
    const void* c_mode, const void* c_thr, const void* c_enq,
    const void* c_active, const void* q_slot, const void* q_rating,
    const void* q_rd, const void* q_thr_eff, const void* q_region,
    const void* q_mode, const void* q_valid, void* out_v, void* out_i,
    void* rec_a, void* rec_b, int n_rows, int n_blocks, int pool_block,
    int capacity, int rows_per_cta, int cluster, const void* now, int glicko2,
    int filters, float widen, float max_thr, float g_coeff,
    const void* span_start, const void* feasible, int chunk_rows,
    int span_blocks, void* stream) {
  if (n_rows <= 0 || n_blocks <= 0) return 0;
  const bool rows_ok = rows_per_cta == 8 || rows_per_cta == 16 ||
                       rows_per_cta == 32 || rows_per_cta == 64;
  const bool cluster_ok = (cluster == 1 || cluster == 2 || cluster == 4 ||
                           cluster == 8) && pool_block % cluster == 0 &&
                          (cluster == 1 || (pool_block / cluster) % kAlign == 0);
  if (!rows_ok || !cluster_ok || capacity != n_blocks * pool_block ||
      rec_a == nullptr || now == nullptr ||
      ((glicko2 || filters) && rec_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (span_start != nullptr &&
      (feasible == nullptr || chunk_rows <= 0 || n_rows % chunk_rows != 0 ||
       span_blocks < 1 || span_blocks > n_blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.rec_a = static_cast<const float2*>(rec_a);
  p.rec_b = static_cast<const Extra*>(rec_b);
  p.q_slot = static_cast<const int32_t*>(q_slot);
  p.q_rating = static_cast<const float*>(q_rating);
  p.q_rd = static_cast<const float*>(q_rd);
  p.q_thr_eff = static_cast<const float*>(q_thr_eff);
  p.q_region = static_cast<const int32_t*>(q_region);
  p.q_mode = static_cast<const int32_t*>(q_mode);
  p.q_valid = static_cast<const uint8_t*>(q_valid);
  p.out_v = static_cast<float*>(out_v);
  p.out_i = static_cast<int32_t*>(out_i);
  p.span_start = static_cast<const int32_t*>(span_start);
  p.feasible = static_cast<const uint8_t*>(feasible);
  p.chunk_rows = chunk_rows;
  p.span_blocks = span_blocks;
  p.n_rows = n_rows;
  p.n_blocks = n_blocks;
  p.pool_block = pool_block;
  // Slots per block in the record scratch (rec_a: float2, rec_b: 16 B, each
  // n_blocks * stride entries, allocated by the wrapper: RECORD_ALIGN).
  p.stride = (pool_block + kAlign - 1) / kAlign * kAlign;
  p.capacity = capacity;
  p.rows_per_cta = rows_per_cta;
  p.cluster = cluster;
  p.slice = pool_block / cluster;
  p.g_coeff = g_coeff;
  const void* pool[7] = {c_rating, c_rd, c_region, c_mode, c_thr, c_enq,
                         c_active};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(now);
  if (glicko2) {
    return filters ? launch<true, true>(pool, p, t, widen, max_thr, s)
                   : launch<true, false>(pool, p, t, widen, max_thr, s);
  }
  return filters ? launch<false, true>(pool, p, t, widen, max_thr, s)
                 : launch<false, false>(pool, p, t, widen, max_thr, s);
}
