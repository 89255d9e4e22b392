// Block layout and per-step reductions shared by the DAG dynamic-program
// kernels (dag_fb.cu, dag_viterbi.cu).
//
// One block of kDagNT threads per sample (and sweep) walks the T steps of a
// recursion over a graph of L <= kDagMaxL vertices. A column sweep gives
// each of kDagSliceNT threads up to kDagCols columns and lets kDagSlices
// slices of threads split the rows between them; before each step the
// block finds the previous row's maximum and the range [lo, hi] of its
// entries that are not -inf, since only those rows of links contribute.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace daspeech {

constexpr int kDagNT = 1024;                        // threads per block
constexpr int kDagSlices = 4;                       // row slices
constexpr int kDagSliceNT = kDagNT / kDagSlices;    // threads per slice
constexpr int kDagMaxL = 1024;                      // max_target_positions
constexpr int kDagCols = kDagMaxL / kDagSliceNT;    // columns per thread

struct RowStats {
  float max;   // -inf when every entry is -inf
  int lo, hi;  // first and last entry that is not -inf (lo > hi: none)
};

// every thread of the block must call it; red holds 3 * 32 floats
__device__ __forceinline__ RowStats row_stats(const float* row, int L,
                                              float* red) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float m = -INFINITY;
  int lo = L, hi = -1;
  for (int j = tid; j < L; j += kDagNT) {
    const float x = row[j];
    if (x != -INFINITY) {
      m = fmaxf(m, x);
      lo = min(lo, j);
      hi = max(hi, j);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  __syncthreads();  // red is free
  if (lane == 0) {
    red[warp] = m;
    red[32 + warp] = static_cast<float>(lo);
    red[64 + warp] = static_cast<float>(hi);
  }
  __syncthreads();
  RowStats st{-INFINITY, L, -1};
#pragma unroll
  for (int w = 0; w < kDagNT / 32; ++w) {
    st.max = fmaxf(st.max, red[w]);
    st.lo = min(st.lo, static_cast<int>(red[32 + w]));
    st.hi = max(st.hi, static_cast<int>(red[64 + w]));
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

// the reference's _finite_max: an all -inf row shifts by 0
__device__ __forceinline__ float finite_or_zero(float c) {
  return isfinite(c) ? c : 0.f;
}

}  // namespace daspeech
