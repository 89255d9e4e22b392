// DAG Viterbi alignment for Hopper (sm_90a): max-plus forward pass with
// argmax traces, then the backtrace.
//
// Replaces the Pallas kernel daspeech_tpu/ops/dag_pallas.py:285
// (dag_best_alignment_pallas -> _viterbi_kernel, :231), with the semantics
// of the scan reference daspeech_tpu/ops/dag_ref.py:215-278:
//   f[0, j]  = (j == 0) ? match[0, 0] : -inf
//   f[t, j]  = max_i (f[t-1, i] + links[i, j]) + match[t, j]
//   tr[t, j] = the FIRST i that attains the max (an all -inf column: 0)
// then from (t = tl-1, j = ol-1) down to t = 0 along tr; path[j] is the
// smallest t whose step visits vertex j, -1 where none does. The sums are
// the reference's single fp32 adds, so on the same inputs the path equals
// the plain version's bit for bit, ties included.
//
// Design: one thread-block cluster per sample, laid out as the alpha sweep
// of dag_fb.cu (dag_common.cuh): the cs blocks of a cluster split the vertex
// axis in interleaved groups of 32; in each, a thread owns a column (reading
// links[i, j] row by row: coalesced, kDagLoads loads in flight), four slices
// of threads split the previous row's non -inf range of rows in order, and
// the slices' (max, first argmax) pairs are merged in slice order with a
// strict comparison, which keeps the first argmax. The new row is traded
// through distributed shared memory, one cluster barrier a step; the
// forward stops at tl-1, the last step the backtrace reads, in every block
// of the cluster alike. Each block writes the traces of its columns, [T, L]
// int32 per sample, to global scratch that the wrapper allocates; after the
// last step's cluster barrier (release and acquire at cluster scope) one
// thread of the cluster's first block walks them back.
//
// What bounds it on this card: one add and one compare per transition that
// is not -inf and step up to tl-1: ~0.13 G operations at B = 80, T = 64,
// L = 240 with graphs of L/2 to L vertices, against 23 MB of match and
// links read once, so the bound is the bytes (0.007 ms). What holds the
// kernel back is the chain of dependent steps of each cluster, each one
// read of the block's columns of links from L2 (1/cs of the sample's) and
// one cluster barrier, and the serial backtrace (tl dependent loads).
#include <cuda_runtime.h>
#include <math.h>

#include "dag_common.cuh"

namespace daspeech {

template <int kCols>
__global__ void __launch_bounds__(kDagSlices * kDagMaxSliceNT)
dag_viterbi_kernel(const float* __restrict__ match,
                   const float* __restrict__ links,
                   const int* __restrict__ out_len,
                   const int* __restrict__ target_len, int* __restrict__ traces,
                   int* __restrict__ path, int T, int L) {
  cg::cluster_group cluster = cg::this_cluster();
  const Layout lay(L, static_cast<int>(cluster.num_blocks()),
                   static_cast<int>(cluster.block_rank()));
  extern __shared__ float4 smem4[];
  RowStats* stats = reinterpret_cast<RowStats*>(smem4);  // [2][kDagMaxGroups]
  float* cur = reinterpret_cast<float*>(stats + 2 * kDagMaxGroups);  // [2][L]
  float* pbest = cur + 2 * L;                     // [kDagSlices][ncols_max]
  int* parg = reinterpret_cast<int*>(pbest + kDagSlices * lay.ncols_max);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32;
  const int slice = tid / lay.slice_nt, ct = tid % lay.slice_nt;
  const int b = blockIdx.x / lay.cs;
  const long long TL = static_cast<long long>(T) * L;
  const float* M = match + b * TL;
  const float* E = links + b * static_cast<long long>(L) * L;
  int* tr = traces + b * TL;
  const int tl = target_len[b];
  const int ol = out_len[b];
  const bool finisher = tid < lay.ncols;
  const int g_fin = warp * lay.cs + lay.rank;
  const int j_fin = finisher ? lay.col(tid) : L;

  const float x0 = M[0];
  for (int j = tid; j < L; j += nt) cur[j] = (j == 0) ? x0 : -INFINITY;
  for (int g = tid; g < 2 * kDagMaxGroups; g += nt) {
    stats[g] = (g == 0 && x0 != -INFINITY) ? RowStats{x0, 0, 0, 0}
                                           : empty_stats(L);
  }
  cluster.sync();   // every block's buffers are set before any remote write
  const int steps = min(tl, T);
  for (int t = 1; t < steps; ++t) {
    const float* prev = cur + ((t - 1) & 1) * L;
    int i0, i1;
    slice_range(merge_stats(stats + ((t - 1) & 1) * kDagMaxGroups, L), slice,
                &i0, &i1);
    int js[kCols];
    float best[kCols];
    int arg[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int lc = ct + u * lay.slice_nt;
      js[u] = lc < lay.ncols ? lay.col(lc) : L;
      best[u] = -INFINITY;
      arg[u] = 0;
    }
    // rows outside [lo, hi] hold -inf: an -inf candidate never beats the
    // running best (which starts at -inf with index 0), so leaving them out
    // keeps the first argmax
    for (int i = i0; i < i1; i += kDagLoads / kCols) {
      constexpr int kRows = kDagLoads / kCols;
      float v[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool in = i + r < i1;
        const float fi = in ? prev[i + r] : -INFINITY;
        const float* row = E + static_cast<long long>(i + r) * L;
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          v[r][u] = (in && js[u] < L) ? fi + row[js[u]] : -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          if (v[r][u] > best[u]) {
            best[u] = v[r][u];
            arg[u] = i + r;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int lc = ct + u * lay.slice_nt;
      if (lc < lay.ncols) {
        pbest[slice * lay.ncols_max + lc] = best[u];
        parg[slice * lay.ncols_max + lc] = arg[u];
      }
    }
    __syncthreads();   // partials written
    if (finisher) {
      float x = -INFINITY;
      if (j_fin < L) {
        float bv = pbest[tid];
        int ba = parg[tid];
#pragma unroll
        for (int s = 1; s < kDagSlices; ++s) {
          if (pbest[s * lay.ncols_max + tid] > bv) {   // later slices hold
            bv = pbest[s * lay.ncols_max + tid];       // later rows
            ba = parg[s * lay.ncols_max + tid];
          }
        }
        x = bv + M[t * L + j_fin];
        tr[t * L + j_fin] = ba;
      }
      push_group(cluster, lay.cs, cur + (t & 1) * L,
                 stats + (t & 1) * kDagMaxGroups, g_fin, j_fin, L, x);
    }
    cluster.sync();   // the new row, its stats and the traces are visible
  }

  // every block's traces are visible after the last cluster barrier; the
  // cluster's first block walks them back
  if (lay.rank != 0) return;
  int* P = path + b * static_cast<long long>(L);
  for (int j = tid; j < L; j += nt) P[j] = -1;
  __syncthreads();   // the -1 fill is visible to thread 0
  if (tid == 0) {
    int v = 0;
    for (int t = T - 1; t >= 0; --t) {
      if (t == tl - 1) v = ol - 1;
      if (t > tl - 1) continue;
      if (v < 0 || v >= L) break;
      P[v] = t;   // t descends: the last write is the smallest t
      if (t >= 1) v = tr[t * L + v];
    }
  }
}

// the instance for the columns a thread owns at this L and cs
using ViterbiKernel = void (*)(const float*, const float*, const int*,
                               const int*, int*, int*, int, int);
inline ViterbiKernel viterbi_kernel(int L, int cs) {
  switch (dag_cols_per_thread(L, cs)) {
    case 1: return dag_viterbi_kernel<1>;
    case 2: return dag_viterbi_kernel<2>;
    default: return dag_viterbi_kernel<4>;
  }
}

}  // namespace daspeech

// cs: the wrapper's cluster_plan (ops/dag_kernels.py); a cluster size the
// layout does not take is refused
extern "C" int daspeech_dag_viterbi_cluster(const float* match,
                                            const float* links,
                                            const int* out_len,
                                            const int* target_len, int* traces,
                                            int* path, int B, int T, int L,
                                            int cs, void* stream) {
  using namespace daspeech;
  if (!dag_plan_ok(B, T, L, cs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_clusters(
      viterbi_kernel(L, cs), dim3(B * cs), L, cs,
      static_cast<cudaStream_t>(stream), match, links, out_len, target_len,
      traces, path, T, L));
}

// the clusters of this launch the card holds at once, into *out
extern "C" int daspeech_dag_viterbi_max_clusters(int B, int L, int cs,
                                                 int* out) {
  using namespace daspeech;
  if (!dag_plan_ok(B, 1, L, cs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      max_active_clusters(viterbi_kernel(L, cs), dim3(B * cs), L, cs, out));
}
