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
// Design: one block of 1024 threads per sample, laid out as the alpha
// sweep of dag_fb.cu (dag_common.cuh): 256 threads own a column each
// (reading links[i, j] row by row: coalesced), four slices of threads split
// the previous row's non -inf range of rows in order, and the slices' (max,
// first argmax) pairs are merged in slice order with a strict comparison,
// which keeps the first argmax. The current row lives in shared memory; the
// forward stops at tl-1, the last step the backtrace reads. The traces,
// [T, L] int32 per sample, go to global scratch that the wrapper allocates;
// one thread walks them back after a block barrier.
//
// What bounds it on this card: one add and one compare per transition that
// is not -inf and step up to tl-1: ~0.13 G operations at B = 80, T = 64,
// L = 240 with graphs of L/2 to L vertices, against 23 MB of match and
// links read once, so the bound is the bytes (0.007 ms). The kernel is held
// back by its sequential steps, and by the serial backtrace (tl dependent
// loads).
#include <cuda_runtime.h>
#include <math.h>

#include "dag_common.cuh"

namespace daspeech {

__global__ void __launch_bounds__(kDagNT)
dag_viterbi_kernel(const float* __restrict__ match,
                   const float* __restrict__ links,
                   const int* __restrict__ out_len,
                   const int* __restrict__ target_len, int* __restrict__ traces,
                   int* __restrict__ path, int T, int L) {
  extern __shared__ float smem[];
  float* cur = smem;                               // [L] previous step's row
  float* pbest = cur + L;                          // [kDagSlices][L]
  int* parg = reinterpret_cast<int*>(pbest + kDagSlices * L);
  float* red = reinterpret_cast<float*>(parg + kDagSlices * L);  // [96]

  const int tid = threadIdx.x;
  const int slice = tid / kDagSliceNT, col = tid % kDagSliceNT;
  const int b = blockIdx.x;
  const long long TL = static_cast<long long>(T) * L;
  const float* M = match + b * TL;
  const float* E = links + b * static_cast<long long>(L) * L;
  int* tr = traces + b * TL;
  const int tl = target_len[b];
  const int ol = out_len[b];

  for (int j = tid; j < L; j += kDagNT) cur[j] = (j == 0) ? M[0] : -INFINITY;
  __syncthreads();
  for (int t = 1; t < tl; ++t) {
    const RowStats st = row_stats(cur, L, red);
    int i0, i1;
    slice_range(st, slice, &i0, &i1);
    float best[kDagCols];
    int arg[kDagCols];
#pragma unroll
    for (int u = 0; u < kDagCols; ++u) {
      best[u] = -INFINITY;
      arg[u] = 0;
    }
    // rows outside [lo, hi] hold -inf: an -inf candidate never beats the
    // running best (which starts at -inf with index 0), so leaving them out
    // keeps the first argmax
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const float fi = cur[i];
      const float* row = E + static_cast<long long>(i) * L;
#pragma unroll
      for (int u = 0; u < kDagCols; ++u) {
        const int j = col + u * kDagSliceNT;
        if (j < L) {
          const float v = fi + row[j];
          if (v > best[u]) {
            best[u] = v;
            arg[u] = i;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kDagCols; ++u) {
      const int j = col + u * kDagSliceNT;
      if (j < L) {
        pbest[slice * L + j] = best[u];
        parg[slice * L + j] = arg[u];
      }
    }
    __syncthreads();   // partials written, cur no longer read
    for (int j = tid; j < L; j += kDagNT) {
      float bv = pbest[j];
      int ba = parg[j];
#pragma unroll
      for (int s = 1; s < kDagSlices; ++s) {
        if (pbest[s * L + j] > bv) {   // later slices hold later rows
          bv = pbest[s * L + j];
          ba = parg[s * L + j];
        }
      }
      cur[j] = bv + M[t * L + j];
      tr[t * L + j] = ba;
    }
    __syncthreads();
  }

  int* P = path + b * static_cast<long long>(L);
  for (int j = tid; j < L; j += kDagNT) P[j] = -1;
  __syncthreads();   // traces and the -1 fill are visible to thread 0
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

}  // namespace daspeech

extern "C" int daspeech_dag_viterbi(const float* match, const float* links,
                                    const int* out_len, const int* target_len,
                                    int* traces, int* path, int B, int T,
                                    int L, void* stream) {
  using namespace daspeech;
  if (L < 1 || L > kDagMaxL || T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (1 + 2 * kDagSlices) * static_cast<size_t>(L) * 4 +
                      3 * 32 * sizeof(float);
  dag_viterbi_kernel<<<B, kDagNT, smem, static_cast<cudaStream_t>(stream)>>>(
      match, links, out_len, target_len, traces, path, T, L);
  return static_cast<int>(cudaGetLastError());
}
