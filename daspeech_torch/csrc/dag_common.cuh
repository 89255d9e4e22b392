// Cluster layout, row exchange and launch shared by the DAG dynamic-program
// kernels (dag_fb.cu, dag_viterbi.cu).
//
// A thread-block cluster of cs blocks (cs = 1, 2, 4 or 8, chosen by the
// wrapper's cluster_plan, ops/dag_kernels.py; the block's threads and
// shared memory follow from L and cs here) walks the T steps of one
// recursion over a graph of L <= kDagMaxL vertices. The vertex axis is cut
// into groups of 32 columns, and group g belongs to block g % cs of the
// cluster (interleaved, so that every block holds about as many columns of
// the triangle of finite links as the others). Each block keeps the whole
// previous row in its shared memory, twice (by the parity of t): at every
// step it computes its own columns of the new row and writes them into the
// other buffer of every block of the cluster (distributed shared memory),
// beside the (max, lo, hi) of each of its groups; one cluster barrier later
// every block holds the whole new row and merges the groups' triples into
// the row's stats (its maximum and the range [lo, hi] of its entries that
// are not -inf: only those rows of links contribute). A block writes at step
// t into the buffer that every block read at step t - 1, so one barrier a
// step suffices. The loops over t end with that barrier, so no block exits
// while a peer may still write into its shared memory.
//
// Inside a block, kDagSlices slices of threads split the rows of [lo, hi]
// in order and each thread owns kCols of the block's columns (1 for every
// shape but a cluster of one at L > 256); the slices' partial results are
// merged in slice order, so each column's first argmax is the one the
// kernels with one block a sample found.
//
// The log-sum-exp of a column (alpha) or a row (beta) is taken online, on
// terms measured from the previous row's maximum c: each thread keeps the
// running maximum m of its terms and the sum s of exp(x - m), rescaled when
// a batch of kDagLoads terms raises m (lse_add), and partial (m, s) pairs
// merge by lse_merge; exp is 2^((x - m) log2 e) on the SFU. No term within
// 87 nats of its column's maximum underflows. The reference's scan sums
// exp(x - c) instead: where c sits on a vertex whose links are all -inf (the
// graph's last), every term of the next row may lie far below c, and fp32
// loses them, so that entries within a few nats of the new row's maximum
// come out nats too small (chip_smoke.py's dp_numerics prints the fp32
// loop's error by distance below the row's maximum, at J-long's [14, 128,
// 700] too).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace daspeech {

namespace cg = cooperative_groups;

constexpr int kDagMaxL = 1024;                      // max_target_positions
constexpr int kDagGroup = 32;                       // columns of a group
constexpr int kDagMaxGroups = kDagMaxL / kDagGroup;
constexpr int kDagSlices = 4;                       // row slices
constexpr int kDagMaxSliceNT = 256;                 // most threads a slice
constexpr int kDagMaxCluster = 8;                   // the portable limit
constexpr int kDagLoads = 8;    // loads of links a thread has in flight

constexpr float kLog2e = 1.4426950408889634f;

struct alignas(16) RowStats {
  float max;   // -inf when every entry is -inf
  int lo, hi;  // first and last entry that is not -inf (lo > hi: none)
  int pad;
};

__host__ __device__ inline int dag_groups(int L) {
  return (L + kDagGroup - 1) / kDagGroup;
}

// groups of the block that holds the most: each block has room for them
__host__ __device__ inline int dag_max_block_groups(int L, int cs) {
  return (dag_groups(L) + cs - 1) / cs;
}

__host__ __device__ inline int dag_threads(int L, int cs) {
  const int cols = kDagGroup * dag_max_block_groups(L, cs);
  return kDagSlices * (cols < kDagMaxSliceNT ? cols : kDagMaxSliceNT);
}

// columns per thread: 1, 2 or 4 (3 rounds up)
__host__ __device__ inline int dag_cols_per_thread(int L, int cs) {
  const int cols = kDagGroup * dag_max_block_groups(L, cs);
  const int per = (cols + kDagMaxSliceNT - 1) / kDagMaxSliceNT;
  return per <= 2 ? per : 4;
}

// dynamic shared memory: the stats slots [2][kDagMaxGroups], the row
// [2][L] and per slice two words a column (a partial (m, s) or (max,
// argmax))
__host__ __device__ inline size_t dag_smem(int L, int cs) {
  return 2 * kDagMaxGroups * sizeof(RowStats) + 2 * sizeof(float) * L +
         2 * sizeof(float) * kDagSlices * kDagGroup *
             dag_max_block_groups(L, cs);
}

// this block's place in its cluster and the columns it owns
struct Layout {
  int cs, rank;   // cluster size and this block's rank in it
  int ncols;      // 32 x its groups
  int ncols_max;  // 32 x the most groups a block of the cluster holds
  int slice_nt;   // threads per slice

  __device__ Layout(int L, int cs_, int rank_)
      : cs(cs_), rank(rank_),
        ncols(kDagGroup * ((dag_groups(L) - rank_ + cs_ - 1) / cs_)),
        ncols_max(kDagGroup * dag_max_block_groups(L, cs_)),
        slice_nt(static_cast<int>(blockDim.x) / kDagSlices) {}

  // the vertex of local column lc (>= L on the last group's ragged edge)
  __device__ int col(int lc) const {
    return ((lc / kDagGroup) * cs + rank) * kDagGroup + lc % kDagGroup;
  }
};

__device__ __forceinline__ RowStats empty_stats(int L) {
  return RowStats{-INFINITY, L, -1, 0};
}

// the row's stats from the triples of its groups (parity buffer `slots`)
__device__ __forceinline__ RowStats merge_stats(const RowStats* slots, int L) {
  RowStats st = empty_stats(L);
  const int n = dag_groups(L);
  for (int g = 0; g < n; ++g) {
    const RowStats s = slots[g];
    st.max = fmaxf(st.max, s.max);
    st.lo = min(st.lo, s.lo);
    st.hi = max(st.hi, s.hi);
  }
  return st;
}

// the contiguous rows [*i0, *i1) of [lo, hi] that slice `slice` sums over;
// slices in order cover the rows in increasing order
__device__ __forceinline__ void slice_range(const RowStats& st, int slice,
                                            int* i0, int* i1) {
  const int n = st.hi - st.lo + 1;
  if (n <= 0) {
    *i0 = *i1 = 0;
    return;
  }
  const int chunk = (n + kDagSlices - 1) / kDagSlices;
  *i0 = min(st.lo + slice * chunk, st.hi + 1);
  *i1 = min(*i0 + chunk, st.hi + 1);
}

// The exchange of one step: every lane of a warp that finishes one of the
// block's groups calls it with its vertex j (>= L: none) and value x. x goes
// to column j of the row buffer `row` (a pointer into this block's shared
// memory) of every block of the cluster, and lane 0 writes the group's
// (max, lo, hi) into slot g of `slots` in every block.
__device__ __forceinline__ void push_group(cg::cluster_group& cluster,
                                           int cs, float* row,
                                           RowStats* slots, int g, int j,
                                           int L, float x) {
  float m = -INFINITY;
  int lo = L, hi = -1;
  if (j < L) {
    for (int r = 0; r < cs; ++r) cluster.map_shared_rank(row, r)[j] = x;
    if (x != -INFINITY) {
      m = x;
      lo = hi = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (threadIdx.x % 32 == 0) {
    for (int r = 0; r < cs; ++r) {
      cluster.map_shared_rank(slots, r)[g] = RowStats{m, lo, hi, 0};
    }
  }
}

// the reference's _finite_max: an all -inf row shifts by 0
__device__ __forceinline__ float finite_or_zero(float c) {
  return isfinite(c) ? c : 0.f;
}

// 2^x on the SFU (ex2.approx, denormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(x - m) for x <= m
__device__ __forceinline__ float exp_below(float x, float m) {
  return ex2((x - m) * kLog2e);
}

// adds the terms exp(v[0]), ..., exp(v[N-1]) to the online log-sum-exp
// (m, s) = m + log(s), (-inf, 0) standing for no mass: m rises to the
// batch's maximum first (one rescale of s), so the N exponentials depend on
// nothing but m and the loads; an -inf term adds nothing
template <int N>
__device__ __forceinline__ void lse_add(float& m, float& s,
                                        const float (&v)[N]) {
  float bm = -INFINITY;
#pragma unroll
  for (int r = 0; r < N; ++r) bm = fmaxf(bm, v[r]);
  if (bm == -INFINITY) return;
  if (bm > m) {
    s *= exp_below(m, bm);
    m = bm;
  }
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (v[r] != -INFINITY) s += exp_below(v[r], m);
  }
}

// (m, s) += (m2, s2)
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;              // neither has mass
  s = s * exp_below(m, mm) + s2 * exp_below(m2, mm);
  m = mm;
}

// m + log(s), -inf where there is no mass
__device__ __forceinline__ float lse_value(float m, float s) {
  return m == -INFINITY ? -INFINITY : m + logf(s);
}

// The configuration of a launch on clusters of cs blocks along x, each
// block of dag_threads(L, cs) threads and dag_smem(L, cs) bytes of dynamic
// shared memory (which may exceed the default 48 KB: the attribute is set
// on `kernel`); `attr` holds the cluster dimension and must outlive the
// configuration.
template <typename... Params>
inline cudaError_t cluster_config(void (*kernel)(Params...), dim3 grid, int L,
                                  int cs, cudaStream_t stream,
                                  cudaLaunchAttribute* attr,
                                  cudaLaunchConfig_t* cfg) {
  const size_t smem = dag_smem(L, cs);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(dag_threads(L, cs));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launches `kernel` on clusters of cs blocks along x. A cluster that cannot
// be placed is refused here, and the error goes back to the caller.
template <typename... Params, typename... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid,
                                   int L, int cs, cudaStream_t stream,
                                   Args... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(kernel, grid, L, cs, stream, &attr, &cfg);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// how many clusters of this launch the card can hold at once (0: none)
template <typename... Params>
inline cudaError_t max_active_clusters(void (*kernel)(Params...), dim3 grid,
                                       int L, int cs, int* out) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const cudaError_t e =
      cluster_config(kernel, grid, L, cs, nullptr, &attr, &cfg);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(kernel), &cfg);
}

// the cluster size the wrapper planned must be one the layout takes: a power
// of two, at most the portable limit and the number of column groups
inline bool dag_plan_ok(int B, int T, int L, int cs) {
  return L >= 1 && L <= kDagMaxL && T >= 1 && B >= 1 && cs >= 1 &&
         cs <= kDagMaxCluster && (cs & (cs - 1)) == 0 && cs <= dag_groups(L);
}

}  // namespace daspeech
