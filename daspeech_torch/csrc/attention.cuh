// Flash-style fp32 attention on the CUDA cores: the training forward of
// every attention entry point (packed, head-major and full-bias in
// fused_attention.cu, rel-pos in fused_relpos.cu), which saves the softmax
// statistics that the tensor-core backward of attention_tc.cuh reads, and
// the argument structs both headers share.
//
// Forward: one block per (query tile, head, batch row). TPR threads share
// one query row: each holds DQ/TPR of the row's score-side channels and
// DV/TPR of its output channels in registers, interleaved (thread `sub`
// owns channels sub, sub+TPR, ...) so that a warp's reads of a shared-memory
// key row hit TPR consecutive banks and broadcast across the rows. Keys
// stream through shared memory BN at a time with an online softmax in fp32,
// so no [Tq, Tk] score matrix is ever stored. For training it also writes
// each row's softmax statistics (max m and sum l of exp(s - m)), which the
// backward reuses instead of a second softmax pass. They are kept apart, not
// as m + log(l): in a fully padded row every score is -1e30 plus O(1),
// which fp32 rounds to -1e30 exactly, and log(l) would vanish beside it.
//
// The score side is the concatenation of two operand pairs:
//   s[i, j] = (q[i] . k[j] + a[i] . e[j]) * scale + bias[j]
// with depths D1 (q/k) and D2 (a/e). Plain attention is D2 = 0. Each operand
// is addressed by (batch, row, head) strides in elements, so the packed
// [B, T, H*d] projections are read in place with no transposes.
//
// Dropout (philox.cuh) multiplies the softmax probabilities by keep/keep_p;
// the normalizer is taken before dropout, as in the Pallas kernels.
//
// Bias modes (template argument FULL): the column bias bias[b, j] of a
// padding mask, loaded one row per key tile, or a full additive bias
// bias4[b, h, i, j] (FULL), loaded as a [query tile, key tile] block into
// shared memory beside the keys. In FULL mode dropout is keyed by ONE seed
// (seeds[0]) with the batch row in the fourth counter word, as the Pallas
// kernel keys its stream by the program b·H + h.
//
// The backward, with P = softmax(s), Z the dropout multipliers, O the
// output, is attention_tc.cuh's:
//   dV[j]   = sum_i P[i,j] Z[i,j] dO[i]
//   dS[i,j] = P[i,j] (Z[i,j] dO[i].V[j] - delta[i]),  delta[i] = dO[i].O[i]
//   dQ[i]   = scale sum_j dS[i,j] K[j]    (and dA[i] = scale sum_j dS e[j])
//   dK[j]   = scale sum_i dS[i,j] Q[i]    (e is a constant: no dE)
// with P = exp(s - m) / l recomputed from the saved row statistics.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace daspeech {

template <typename T>
struct View {
  T* ptr;
  long long sb, sr, sh;  // batch, row and head strides in elements
  __device__ __forceinline__ T* at(int b, int r, int h) const {
    return ptr + b * sb + r * sr + h * sh;
  }
};
using Operand = View<const float>;

struct DropoutArgs {
  const uint32_t* seeds;  // [B] per-row Philox keys; nullptr = no dropout
  uint32_t thresh;        // keep where bits <= thresh
  float scale;            // 1 / keep_p
};

struct AttnArgs {
  Operand q, a, k, e, v;
  const float* bias;     // [B, Tk] additive column bias (0 or -1e30)
  long long bias_sb;
  const float* bias4 = nullptr;  // FULL: contiguous [B, H, Tq, Tk] bias
  View<float> o;
  float* stats;          // [B, H, Tq, 2] row (max, sum) out, or nullptr
  int H, Tq, Tk;
  float scale;
  DropoutArgs drop;
};

struct AttnBwdArgs {
  AttnArgs f;            // the forward's inputs, its output o and stats
  Operand dout;          // layout of o
  View<float> dq, da;    // layouts of q and a (da unused when D2 == 0)
  View<float> dk, dv;    // layouts of k and v
  float* delta;          // [B, H, Tq] scratch: rowsum(dout * o)
  // [B, H, Tq, Tk] dS out (the full bias's gradient; the rel-pos
  // backward's scratch) and P∘Z scratch, written by the tensor-core score
  // kernel of attention_tc.cuh
  float* dbias = nullptr;
  float* pz = nullptr;
};

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// one Philox draw per thread gives 4 keys' bits; the TPR threads of a row
// draw for 4 * TPR consecutive keys and share them by shuffles
template <int TPR>
__device__ __forceinline__ uint4 keys_bits(const DropoutArgs& d, uint32_t seed,
                                           int j_first, int i, int h,
                                           uint32_t c3, int sub) {
  if (d.seeds == nullptr) return make_uint4(0u, 0u, 0u, 0u);
  return philox4x32_10(make_uint4((j_first >> 2) + sub, i, h, c3), seed, 0u);
}

// the block's bias tile: row 0 holds the column bias of keys j0.., or (FULL)
// rows rr hold bias4[b, h, i0 + rr, j0..]; 0 outside [0, Tq) x [0, Tk)
template <bool FULL, int R, int W, int NT>
__device__ __forceinline__ void load_bias_tile(float (*tile)[FULL ? W + 1 : W],
                                               const AttnArgs& f, int b, int h,
                                               int i0, int j0) {
  for (int idx = threadIdx.x; idx < (FULL ? R : 1) * W; idx += NT) {
    const int rr = idx / W, jj = idx % W, j = j0 + jj;
    float x = 0.f;
    if (j < f.Tk) {
      if (!FULL) {
        x = f.bias[b * f.bias_sb + j];
      } else if (i0 + rr < f.Tq) {
        x = f.bias4[((static_cast<long long>(b) * f.H + h) * f.Tq + i0 + rr) *
                        f.Tk + j];
      }
    }
    tile[rr][jj] = x;
  }
}

template <int D1, int D2, int DV, int TPR, int BM, int BN, bool FULL>
__global__ void __launch_bounds__(BM * TPR)
attn_fwd_kernel(const AttnArgs args) {
  constexpr int NT = BM * TPR;
  constexpr int DQ = D1 + D2;
  constexpr int QPT = DQ / TPR;
  constexpr int VPT = DV / TPR;
  constexpr int G = 4 * TPR;   // keys per Philox round of the row's threads
  static_assert(D1 % TPR == 0 && D2 % TPR == 0 && DV % TPR == 0,
                "channel counts must split evenly over a row's threads");
  static_assert(32 % TPR == 0, "a row's threads must share one warp");
  static_assert(BN % G == 0, "key tiles must hold whole Philox groups");

  __shared__ float Ks[BN][DQ];
  __shared__ float Vs[BN][DV];
  __shared__ float Bs[FULL ? BM : 1][FULL ? BN + 1 : BN];

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int lane0 = (tid % 32) - sub;
  const int r = FULL ? tid / TPR : 0;   // the row's line of the bias tile
  const int i = blockIdx.x * BM + tid / TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool row_ok = i < args.Tq;
  const bool drop = args.drop.seeds != nullptr;
  const uint32_t seed = drop ? args.drop.seeds[FULL ? 0 : b] : 0u;
  const uint32_t c3 = FULL ? b : 0u;

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
    load_bias_tile<FULL, BM, BN, NT>(Bs, args, b, h, blockIdx.x * BM, j0);
    __syncthreads();

    float s[BN];
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BN; ++jj) {
      float p = 0.f;
#pragma unroll
      for (int t = 0; t < QPT; ++t) p = fmaf(qr[t], Ks[jj][sub + TPR * t], p);
      p = row_sum<TPR>(p);
      const float sc = (jj < nvalid) ? p * args.scale + Bs[r][jj] : -INFINITY;
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
    for (int g0 = 0; g0 < BN; g0 += G) {
      const uint4 bits =
          keys_bits<TPR>(args.drop, seed, j0 + g0, i, h, c3, sub);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int jj = g0 + u;
        const float p = expf(s[jj] - m_new);
        l += p;
        float pz = p;
        if (drop) {
          const uint32_t w = __shfl_sync(0xffffffffu, philox_word(bits, u & 3),
                                         lane0 + (u >> 2));
          pz = (w <= args.drop.thresh) ? p * args.drop.scale : 0.f;
        }
#pragma unroll
        for (int t = 0; t < VPT; ++t) {
          acc[t] = fmaf(pz, Vs[jj][sub + TPR * t], acc[t]);
        }
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (row_ok) {
    float* out = args.o.at(b, i, h);
    const float inv = 1.f / l;
#pragma unroll
    for (int t = 0; t < VPT; ++t) out[sub + TPR * t] = acc[t] * inv;
    if (args.stats != nullptr && sub == 0) {
      float* st = args.stats +
                  2 * ((static_cast<long long>(b) * args.H + h) * args.Tq + i);
      st[0] = m;
      st[1] = l;
    }
  }
}

template <int D1, int D2, int DV, int TPR, int BM, int BN, bool FULL = false>
cudaError_t launch_attn_fwd(const AttnArgs& args, int B,
                            cudaStream_t stream) {
  dim3 grid((args.Tq + BM - 1) / BM, args.H, B);
  attn_fwd_kernel<D1, D2, DV, TPR, BM, BN, FULL>
      <<<grid, BM * TPR, 0, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace daspeech
