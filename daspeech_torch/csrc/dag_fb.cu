// DAG alpha/beta forward-backward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas kernel daspeech_tpu/ops/dag_pallas.py:108
// (dag_loss_forward_pallas -> _fb_kernel, :40), with the semantics of the
// scan reference daspeech_tpu/ops/dag_ref.py:53-122:
//   alpha[0, j] = (j == 0) ? match[0, 0] : -inf
//   alpha[t, j] = logsumexp_i(alpha[t-1, i] + links[i, j]) + match[t, j]
//   beta[t, j]  = (t == tl-1) ? ((j == ol-1) ? match[t, j] : -inf)
//               : (t >  tl-1) ? -inf
//               : logsumexp_k(beta[t+1, k] + links[j, k]) + match[t, j]
// per sample, with match [B, T, L], links [B, L, L], out_len ol and
// target_len tl. logprob = beta[:, 0, 0] is read off by the caller. Each
// step measures its terms from the previous row's maximum c (0 when the row
// is all -inf), as the reference does, and takes each log-sum-exp online,
// shifted by its own running maximum (dag_common.cuh: the reference's shift
// by c alone loses mass in fp32 at long T); an infeasible graph gives -inf,
// never NaN.
//
// Design: one thread-block cluster per (sample, sweep) (dag_common.cuh):
// blockIdx.y = 0 runs the alpha sweep, 1 the beta sweep, and the cs blocks
// of a cluster split the vertex axis in interleaved groups of 32. The T-step
// recursion is a loop inside each block; the new row is traded through
// distributed shared memory, one cluster barrier a step. The alpha step is
// a column sweep: a thread owns a column (reading links[i, j] row by row,
// a warp's 32 columns side by side: coalesced) and four slices of threads
// split the rows of the previous row's finite range [lo, hi], their partial
// log-sum-exps merged in slice order. The beta step is a row sweep over the
// block's rows j (a warp per row, lanes over k: coalesced), so neither
// transposes links. Each thread issues kDagLoads loads of links before it
// uses them, and a term whose exponent is -inf (the links' empty triangle)
// costs no exponential. exp(links) is not kept: a sample's links are 1.96 MB at
// L = 700 and 4 MB at the L = 1024 cap, over the 227 KB of shared memory of
// a block, so each step reads the block's columns (or rows) of links again,
// from L2. Beta skips the steps past tl-1, whose rows are -inf; the skip is
// the same in every block of a cluster, which all work on one sample.
//
// What bounds it on this card: two operations (an exp and an add) per
// transition that is not -inf and step: ~0.3 G at B = 80, T = 64, L = 240
// with graphs of L/2 to L vertices, against 33 MB of match, links, alpha
// and beta read or written once, so the bound is the bytes (0.010 ms at
// 3.35 TB/s). What holds the kernel back is the chain of T dependent steps
// of each cluster, each one read of the block's columns of links from L2
// (1/cs of the sample's) and one cluster barrier.
#include <cuda_runtime.h>
#include <math.h>

#include "dag_common.cuh"

namespace daspeech {

template <int kCols>
__global__ void __launch_bounds__(kDagSlices * kDagMaxSliceNT)
dag_fb_kernel(const float* __restrict__ match, const float* __restrict__ links,
              const int* __restrict__ out_len,
              const int* __restrict__ target_len, float* __restrict__ alpha,
              float* __restrict__ beta, int T, int L) {
  cg::cluster_group cluster = cg::this_cluster();
  const Layout lay(L, static_cast<int>(cluster.num_blocks()),
                   static_cast<int>(cluster.block_rank()));
  extern __shared__ float4 smem4[];
  RowStats* stats = reinterpret_cast<RowStats*>(smem4);  // [2][kDagMaxGroups]
  float* cur = reinterpret_cast<float*>(stats + 2 * kDagMaxGroups);  // [2][L]
  // alpha: [kDagSlices][ncols_max] partial maxima, then as many sums;
  // beta: [ncols_max] new rows
  float* part = cur + 2 * L;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, warp = tid / 32;
  const int slice = tid / lay.slice_nt, ct = tid % lay.slice_nt;
  const int b = blockIdx.x / lay.cs;
  const long long TL = static_cast<long long>(T) * L;
  const float* M = match + b * TL;
  const float* E = links + b * static_cast<long long>(L) * L;
  // the group this warp finishes at each step (warps past the block's
  // groups finish none)
  const bool finisher = tid < lay.ncols;
  const int g_fin = warp * lay.cs + lay.rank;
  const int j_fin = finisher ? lay.col(tid) : L;

  if (blockIdx.y == 0) {
    float* A = alpha + b * TL;
    const float x0 = M[0];
    for (int j = tid; j < L; j += nt) cur[j] = (j == 0) ? x0 : -INFINITY;
    for (int g = tid; g < 2 * kDagMaxGroups; g += nt) {
      stats[g] = (g == 0 && x0 != -INFINITY) ? RowStats{x0, 0, 0, 0}
                                             : empty_stats(L);
    }
    if (finisher && j_fin < L) A[j_fin] = (j_fin == 0) ? x0 : -INFINITY;
    cluster.sync();   // every block's buffers are set before any remote write
    for (int t = 1; t < T; ++t) {
      const float* prev = cur + ((t - 1) & 1) * L;
      const RowStats st =
          merge_stats(stats + ((t - 1) & 1) * kDagMaxGroups, L);
      const float c = finite_or_zero(st.max);
      int i0, i1;
      slice_range(st, slice, &i0, &i1);
      int js[kCols];
      float mx[kCols], acc[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int lc = ct + u * lay.slice_nt;
        js[u] = lc < lay.ncols ? lay.col(lc) : L;
        mx[u] = -INFINITY;
        acc[u] = 0.f;
      }
      for (int i = i0; i < i1; i += kDagLoads / kCols) {
        constexpr int kRows = kDagLoads / kCols;
        float v[kRows][kCols];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const bool in = i + r < i1;
          const float base = in ? prev[i + r] - c : -INFINITY;
          const float* row = E + static_cast<long long>(i + r) * L;
#pragma unroll
          for (int u = 0; u < kCols; ++u) {
            v[r][u] = (in && js[u] < L) ? base + row[js[u]] : -INFINITY;
          }
        }
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          float w[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) w[r] = v[r][u];
          lse_add(mx[u], acc[u], w);
        }
      }
      const int pitch = kDagSlices * lay.ncols_max;   // maxima, then sums
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int lc = ct + u * lay.slice_nt;
        if (lc < lay.ncols) {
          part[slice * lay.ncols_max + lc] = mx[u];
          part[pitch + slice * lay.ncols_max + lc] = acc[u];
        }
      }
      __syncthreads();   // partial log-sum-exps written
      if (finisher) {
        float x = -INFINITY;
        if (j_fin < L) {
          float m = -INFINITY, sum = 0.f;
#pragma unroll
          for (int s = 0; s < kDagSlices; ++s) {
            lse_merge(m, sum, part[s * lay.ncols_max + tid],
                      part[pitch + s * lay.ncols_max + tid]);
          }
          x = lse_value(m, sum) + c + M[t * L + j_fin];
          A[t * L + j_fin] = x;
        }
        push_group(cluster, lay.cs, cur + (t & 1) * L,
                   stats + (t & 1) * kDagMaxGroups, g_fin, j_fin, L, x);
      }
      cluster.sync();   // the new row and its stats are in every block
    }
  } else {
    float* Bt = beta + b * TL;
    const int tl = target_len[b];
    const int ol = out_len[b];
    for (int j = tid; j < 2 * L; j += nt) cur[j] = -INFINITY;
    for (int g = tid; g < 2 * kDagMaxGroups; g += nt) {
      stats[g] = empty_stats(L);
    }
    cluster.sync();   // every block's buffers are set before any remote write
    for (int t = T - 1; t >= 0; --t) {
      if (t > tl - 1) {   // rows past the target stay -inf
        if (finisher && j_fin < L) Bt[t * L + j_fin] = -INFINITY;
        continue;
      }
      if (t == tl - 1) {
        if (finisher) {
          part[tid] = (j_fin == ol - 1) ? M[t * L + j_fin] : -INFINITY;
        }
      } else {
        const float* prev = cur + ((t + 1) & 1) * L;
        const RowStats st =
            merge_stats(stats + ((t + 1) & 1) * kDagMaxGroups, L);
        const float c = finite_or_zero(st.max);
        const int k0 = st.lo, k1 = st.hi + 1;   // empty when all -inf
        for (int lr = warp; lr < lay.ncols; lr += nt / 32) {
          const int j = lay.col(lr);
          if (j >= L) continue;               // the same in the whole warp
          const float* row = E + static_cast<long long>(j) * L;
          float m = -INFINITY, acc = 0.f;
          for (int k = k0 + lane; k < k1; k += 32 * kDagLoads) {
            float v[kDagLoads];
#pragma unroll
            for (int r = 0; r < kDagLoads; ++r) {
              const int kk = k + 32 * r;
              v[r] = kk < k1 ? prev[kk] - c + row[kk] : -INFINITY;
            }
            lse_add(m, acc, v);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            lse_merge(m, acc, __shfl_xor_sync(0xffffffffu, m, off),
                      __shfl_xor_sync(0xffffffffu, acc, off));
          }
          if (lane == 0) part[lr] = lse_value(m, acc) + c + M[t * L + j];
        }
      }
      __syncthreads();   // the block's rows of the new row are written
      if (finisher) {
        const float x = j_fin < L ? part[tid] : -INFINITY;
        if (j_fin < L) Bt[t * L + j_fin] = x;
        push_group(cluster, lay.cs, cur + (t & 1) * L,
                   stats + (t & 1) * kDagMaxGroups, g_fin, j_fin, L, x);
      }
      cluster.sync();   // the new row and its stats are in every block
    }
  }
}

// the instance for the columns a thread owns at this L and cs
using FbKernel = void (*)(const float*, const float*, const int*, const int*,
                          float*, float*, int, int);
inline FbKernel fb_kernel(int L, int cs) {
  switch (dag_cols_per_thread(L, cs)) {
    case 1: return dag_fb_kernel<1>;
    case 2: return dag_fb_kernel<2>;
    default: return dag_fb_kernel<4>;
  }
}

}  // namespace daspeech

// cs: the wrapper's cluster_plan (ops/dag_kernels.py); a cluster size the
// layout does not take is refused
extern "C" int daspeech_dag_fb_cluster(const float* match, const float* links,
                                       const int* out_len,
                                       const int* target_len, float* alpha,
                                       float* beta, int B, int T, int L,
                                       int cs, void* stream) {
  using namespace daspeech;
  if (!dag_plan_ok(B, T, L, cs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_clusters(
      fb_kernel(L, cs), dim3(B * cs, 2), L, cs,
      static_cast<cudaStream_t>(stream), match, links, out_len, target_len,
      alpha, beta, T, L));
}

// the clusters of this launch the card holds at once, into *out
extern "C" int daspeech_dag_fb_max_clusters(int B, int L, int cs, int* out) {
  using namespace daspeech;
  if (!dag_plan_ok(B, 1, L, cs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      max_active_clusters(fb_kernel(L, cs), dim3(B * cs, 2), L, cs, out));
}

// the threads and dynamic shared memory of a block of either DP kernel
// (dag_fb.cu, dag_viterbi.cu) on clusters of cs blocks at L vertices
extern "C" int daspeech_dag_block(int L, int cs, int* threads, int* smem) {
  using namespace daspeech;
  if (!dag_plan_ok(1, 1, L, cs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *threads = dag_threads(L, cs);
  *smem = static_cast<int>(dag_smem(L, cs));
  return static_cast<int>(cudaSuccess);
}
