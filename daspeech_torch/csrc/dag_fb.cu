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
// step subtracts the previous row's maximum c before the exponentials (c = 0
// when the row is all -inf), as the reference does, so an infeasible graph
// gives -inf, never NaN.
//
// Design: one block of 1024 threads per (sample, sweep): blockIdx.y = 0
// runs the alpha sweep, 1 the beta sweep; the T-step recursion is a loop
// inside the block, with the current row in shared memory and one
// block-wide reduction per step for its max and its finite range [lo, hi]
// (entries outside it are -inf and add nothing, so each step reads only
// those rows of links). The alpha step is a column sweep: 256 threads own a
// column each (reading links[i, j] row by row: coalesced) and four slices
// of threads split the rows i between them, so that four times as many
// loads are in flight, their partial sums added in shared memory. The beta
// step is a row sweep (a warp per row j, lanes over k: coalesced), so
// neither transposes links. exp(links) is not kept: one [L, L] fp32 matrix
// is 230 KB at L = 240, the whole of a block's shared memory, and 4 MB at
// the L = 1024 cap, so each step reads links again, from L2 (the batch's
// links, 18.4 MB at B = 80, L = 240, fit the 50 MB L2). Beta skips the
// steps past tl-1, whose rows are -inf.
//
// What bounds it on this card: two operations (an exp and an add) per
// transition that is not -inf and step: ~0.3 G at B = 80, T = 64, L = 240
// with graphs of L/2 to L vertices, against 33 MB of match, links, alpha
// and beta read or written once, so the bound is the bytes (0.010 ms at
// 3.35 TB/s). What holds the kernel back is the T sequential steps of each
// block, each a round of L2 loads and two block barriers.
#include <cuda_runtime.h>
#include <math.h>

#include "dag_common.cuh"

namespace daspeech {

__global__ void __launch_bounds__(kDagNT)
dag_fb_kernel(const float* __restrict__ match, const float* __restrict__ links,
              const int* __restrict__ out_len,
              const int* __restrict__ target_len, float* __restrict__ alpha,
              float* __restrict__ beta, int T, int L) {
  extern __shared__ float smem[];
  float* cur = smem;                  // [L] the previous step's row
  float* nxt = cur + L;               // [L] the beta step's new row
  float* part = nxt + L;              // [kDagSlices][L] partial sums
  float* red = part + kDagSlices * L; // [3 * 32] reduction scratch

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int slice = tid / kDagSliceNT, col = tid % kDagSliceNT;
  const int b = blockIdx.x;
  const long long TL = static_cast<long long>(T) * L;
  const float* M = match + b * TL;
  const float* E = links + b * static_cast<long long>(L) * L;

  if (blockIdx.y == 0) {
    float* A = alpha + b * TL;
    for (int j = tid; j < L; j += kDagNT) {
      const float x = (j == 0) ? M[0] : -INFINITY;
      cur[j] = x;
      A[j] = x;
    }
    __syncthreads();
    for (int t = 1; t < T; ++t) {
      const RowStats st = row_stats(cur, L, red);
      const float c = finite_or_zero(st.max);
      int i0, i1;
      slice_range(st, slice, &i0, &i1);
      float acc[kDagCols];
#pragma unroll
      for (int u = 0; u < kDagCols; ++u) acc[u] = 0.f;
#pragma unroll 4
      for (int i = i0; i < i1; ++i) {
        const float base = cur[i] - c;   // -inf adds exp(-inf) = 0
        const float* row = E + static_cast<long long>(i) * L;
#pragma unroll
        for (int u = 0; u < kDagCols; ++u) {
          const int j = col + u * kDagSliceNT;
          if (j < L) acc[u] += expf(base + row[j]);
        }
      }
#pragma unroll
      for (int u = 0; u < kDagCols; ++u) {
        const int j = col + u * kDagSliceNT;
        if (j < L) part[slice * L + j] = acc[u];
      }
      __syncthreads();   // partial sums written, cur no longer read
      for (int j = tid; j < L; j += kDagNT) {
        float sum = 0.f;
#pragma unroll
        for (int s = 0; s < kDagSlices; ++s) sum += part[s * L + j];
        const float x = logf(sum) + c + M[t * L + j];
        cur[j] = x;
        A[t * L + j] = x;
      }
      __syncthreads();
    }
  } else {
    float* Bt = beta + b * TL;
    const int tl = target_len[b];
    const int ol = out_len[b];
    for (int j = tid; j < L; j += kDagNT) cur[j] = -INFINITY;
    __syncthreads();
    for (int t = T - 1; t >= 0; --t) {
      if (t > tl - 1) {   // rows past the target stay -inf
        for (int j = tid; j < L; j += kDagNT) Bt[t * L + j] = -INFINITY;
        continue;
      }
      if (t == tl - 1) {
        for (int j = tid; j < L; j += kDagNT) {
          nxt[j] = (j == ol - 1) ? M[t * L + j] : -INFINITY;
        }
      } else {
        const RowStats st = row_stats(cur, L, red);
        const float c = finite_or_zero(st.max);
        const int k0 = st.lo, k1 = st.hi + 1;   // empty when all -inf
        for (int j = warp; j < L; j += kDagNT / 32) {
          const float* row = E + static_cast<long long>(j) * L;
          float acc = 0.f;
#pragma unroll 4
          for (int k = k0 + lane; k < k1; k += 32) {
            acc += expf(cur[k] - c + row[k]);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
          }
          if (lane == 0) nxt[j] = logf(acc) + c + M[t * L + j];
        }
      }
      __syncthreads();
      for (int j = tid; j < L; j += kDagNT) {
        cur[j] = nxt[j];
        Bt[t * L + j] = nxt[j];
      }
      __syncthreads();
    }
  }
}

}  // namespace daspeech

extern "C" int daspeech_dag_fb(const float* match, const float* links,
                               const int* out_len, const int* target_len,
                               float* alpha, float* beta, int B, int T, int L,
                               void* stream) {
  using namespace daspeech;
  if (L < 1 || L > kDagMaxL || T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      ((2 + kDagSlices) * static_cast<size_t>(L) + 3 * 32) * sizeof(float);
  dag_fb_kernel<<<dim3(B, 2), kDagNT, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      match, links, out_len, target_len, alpha, beta, T, L);
  return static_cast<int>(cudaGetLastError());
}
