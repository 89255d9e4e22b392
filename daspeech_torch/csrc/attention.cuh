// Flash-style fp32 attention forward shared by the packed multi-head
// attention kernel (fused_attention.cu) and the Conformer rel-pos attention
// kernel (fused_relpos.cu).
//
// One block per (query tile, head, batch row). TPR threads share one query
// row: each holds DQ/TPR of the row's score-side channels and DV/TPR of its
// output channels in registers, interleaved (thread `sub` owns channels
// sub, sub+TPR, ...) so that a warp's reads of a shared-memory key row hit
// TPR consecutive banks and broadcast across the rows. Keys stream through
// shared memory BN at a time with an online softmax in fp32, so no
// [Tq, Tk] score matrix is ever stored.
//
// The score side is the concatenation of two operand pairs:
//   s[i, j] = (q[i] . k[j] + a[i] . e[j]) * scale + bias[j]
// with depths D1 (q/k) and D2 (a/e). Plain attention is D2 = 0. Each operand
// is addressed by (batch, row, head) strides in elements, so the packed
// [B, T, H*d] projections are read in place with no transposes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace daspeech {

struct Operand {
  const float* ptr;
  long long sb, sr, sh;  // batch, row and head strides in elements
  __device__ __forceinline__ const float* at(int b, int r, int h) const {
    return ptr + b * sb + r * sr + h * sh;
  }
};

struct AttnArgs {
  Operand q, a, k, e, v;
  const float* bias;     // [B, Tk] additive column bias (0 or -1e30)
  long long bias_sb;
  float* o;
  long long o_sb, o_sr, o_sh;
  int Tq, Tk;
  float scale;
};

template <int D1, int D2, int DV, int TPR, int BM, int BN>
__global__ void __launch_bounds__(BM * TPR)
attn_fwd_kernel(const AttnArgs args) {
  constexpr int NT = BM * TPR;
  constexpr int DQ = D1 + D2;
  constexpr int QPT = DQ / TPR;
  constexpr int VPT = DV / TPR;
  static_assert(D1 % TPR == 0 && D2 % TPR == 0 && DV % TPR == 0,
                "channel counts must split evenly over a row's threads");
  static_assert(32 % TPR == 0, "a row's threads must share one warp");

  __shared__ float Ks[BN][DQ];
  __shared__ float Vs[BN][DV];
  __shared__ float Bs[BN];

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int i = blockIdx.x * BM + tid / TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool row_ok = i < args.Tq;

  float qr[QPT];
#pragma unroll
  for (int t = 0; t < QPT; ++t) {
    const int c = sub + TPR * t;
    float x = 0.f;
    if (row_ok) {
      x = (c < D1) ? args.q.at(b, i, h)[c] : args.a.at(b, i, h)[c - D1];
    }
    qr[t] = x;
  }

  float acc[VPT];
#pragma unroll
  for (int t = 0; t < VPT; ++t) acc[t] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int j0 = 0; j0 < args.Tk; j0 += BN) {
    const int nvalid = min(BN, args.Tk - j0);
    for (int idx = tid; idx < BN * DQ; idx += NT) {
      const int jj = idx / DQ, c = idx % DQ, j = j0 + jj;
      float x = 0.f;
      if (jj < nvalid) {
        x = (c < D1) ? args.k.at(b, j, h)[c] : args.e.at(b, j, h)[c - D1];
      }
      Ks[jj][c] = x;
    }
    for (int idx = tid; idx < BN * DV; idx += NT) {
      const int jj = idx / DV, c = idx % DV;
      Vs[jj][c] = (jj < nvalid) ? args.v.at(b, j0 + jj, h)[c] : 0.f;
    }
    for (int jj = tid; jj < BN; jj += NT) {
      Bs[jj] = (jj < nvalid) ? args.bias[b * args.bias_sb + j0 + jj] : 0.f;
    }
    __syncthreads();

    float s[BN];
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BN; ++jj) {
      float p = 0.f;
#pragma unroll
      for (int t = 0; t < QPT; ++t) p = fmaf(qr[t], Ks[jj][sub + TPR * t], p);
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, off);
      }
      const float sc = (jj < nvalid) ? p * args.scale + Bs[jj] : -INFINITY;
      s[jj] = sc;
      tile_max = fmaxf(tile_max, sc);
    }
    // nvalid >= 1, so tile_max and m_new are finite
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int t = 0; t < VPT; ++t) acc[t] *= corr;
#pragma unroll
    for (int jj = 0; jj < BN; ++jj) {
      const float p = expf(s[jj] - m_new);
      l += p;
#pragma unroll
      for (int t = 0; t < VPT; ++t) {
        acc[t] = fmaf(p, Vs[jj][sub + TPR * t], acc[t]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (row_ok) {
    float* out = args.o + b * args.o_sb + i * args.o_sr + h * args.o_sh;
    const float inv = 1.f / l;
#pragma unroll
    for (int t = 0; t < VPT; ++t) out[sub + TPR * t] = acc[t] * inv;
  }
}

template <int D1, int D2, int DV, int TPR, int BM, int BN>
cudaError_t launch_attn_fwd(const AttnArgs& args, int B, int H,
                            cudaStream_t stream) {
  dim3 grid((args.Tq + BM - 1) / BM, H, B);
  attn_fwd_kernel<D1, D2, DV, TPR, BM, BN><<<grid, BM * TPR, 0, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace daspeech
