// Flash-style fp32 attention, forward and backward, shared by the packed
// multi-head attention kernels (fused_attention.cu) and the Conformer
// rel-pos attention kernels (fused_relpos.cu).
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
// shared memory beside the keys. The full bias receives a gradient, dS; the
// dq kernel writes it (each element once), the dk/dv kernel recomputes P
// from its own tile of the bias. In FULL mode dropout is keyed by ONE seed
// (seeds[0]) with the batch row in the fourth counter word, as the Pallas
// kernel keys its stream by the program b·H + h.
//
// Backward, with P = softmax(s), Z the dropout multipliers, O the output:
//   dV[j]   = sum_i P[i,j] Z[i,j] dO[i]
//   dS[i,j] = P[i,j] (Z[i,j] dO[i].V[j] - delta[i]),  delta[i] = dO[i].O[i]
//   dQ[i]   = scale sum_j dS[i,j] K[j]    (and dA[i] = scale sum_j dS e[j])
//   dK[j]   = scale sum_i dS[i,j] Q[i]    (e is a constant: no dE)
// Two kernels: a row-parallel one for dQ/dA (it also writes delta) and a
// column-parallel one for dK/dV, each with the forward's thread layout, so
// neither needs atomics; P = exp(s - m) / l is recomputed from the saved
// row statistics.
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
  float* dbias = nullptr;  // FULL: [B, H, Tq, Tk] dS out, written by dq
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

template <int D1, int D2, int DV, int TPR, int BM, int BN, bool FULL>
__global__ void __launch_bounds__(BM * TPR)
attn_bwd_dq_kernel(const AttnBwdArgs args) {
  constexpr int NT = BM * TPR;
  constexpr int DQ = D1 + D2;
  constexpr int QPT = DQ / TPR;
  constexpr int VPT = DV / TPR;
  constexpr int G = 4 * TPR;
  static_assert(BN % G == 0, "key tiles must hold whole Philox groups");
  const AttnArgs& f = args.f;

  __shared__ float Ks[BN][DQ];
  __shared__ float Vs[BN][DV];
  // the bias tile; FULL: each entry is replaced by its dS once used
  __shared__ float Bs[FULL ? BM : 1][FULL ? BN + 1 : BN];

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int lane0 = (tid % 32) - sub;
  const int r = FULL ? tid / TPR : 0;
  const int i0 = blockIdx.x * BM;
  const int i = i0 + tid / TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool row_ok = i < f.Tq;
  const bool drop = f.drop.seeds != nullptr;
  const uint32_t seed = drop ? f.drop.seeds[FULL ? 0 : b] : 0u;
  const uint32_t c3 = FULL ? b : 0u;
  const long long stat = (static_cast<long long>(b) * f.H + h) * f.Tq + i;

  float qr[QPT], dqa[QPT];
#pragma unroll
  for (int t = 0; t < QPT; ++t) {
    const int c = sub + TPR * t;
    float x = 0.f;
    if (row_ok) x = (c < D1) ? f.q.at(b, i, h)[c] : f.a.at(b, i, h)[c - D1];
    qr[t] = x;
    dqa[t] = 0.f;
  }
  float dor[VPT];
  float delta = 0.f;
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    const int c = sub + TPR * t;
    dor[t] = row_ok ? args.dout.at(b, i, h)[c] : 0.f;
    delta = fmaf(dor[t], row_ok ? f.o.at(b, i, h)[c] : 0.f, delta);
  }
  delta = row_sum<TPR>(delta);
  const float rmax = row_ok ? f.stats[2 * stat] : 0.f;
  const float rinv = row_ok ? 1.f / f.stats[2 * stat + 1] : 0.f;
  if (row_ok && sub == 0) args.delta[stat] = delta;

  for (int j0 = 0; j0 < f.Tk; j0 += BN) {
    const int nvalid = min(BN, f.Tk - j0);
    for (int idx = tid; idx < BN * DQ; idx += NT) {
      const int jj = idx / DQ, c = idx % DQ, j = j0 + jj;
      float x = 0.f;
      if (jj < nvalid) {
        x = (c < D1) ? f.k.at(b, j, h)[c] : f.e.at(b, j, h)[c - D1];
      }
      Ks[jj][c] = x;
    }
    for (int idx = tid; idx < BN * DV; idx += NT) {
      const int jj = idx / DV, c = idx % DV;
      Vs[jj][c] = (jj < nvalid) ? f.v.at(b, j0 + jj, h)[c] : 0.f;
    }
    load_bias_tile<FULL, BM, BN, NT>(Bs, f, b, h, i0, j0);
    __syncthreads();

#pragma unroll
    for (int g0 = 0; g0 < BN; g0 += G) {
      const uint4 bits = keys_bits<TPR>(f.drop, seed, j0 + g0, i, h, c3, sub);
#pragma unroll 4
      for (int u = 0; u < G; ++u) {
        const int jj = g0 + u;
        const float bias = Bs[r][jj];
        float sdot = 0.f, pdot = 0.f;
#pragma unroll
        for (int t = 0; t < QPT; ++t) {
          sdot = fmaf(qr[t], Ks[jj][sub + TPR * t], sdot);
        }
#pragma unroll
        for (int t = 0; t < VPT; ++t) {
          pdot = fmaf(dor[t], Vs[jj][sub + TPR * t], pdot);
        }
        sdot = row_sum<TPR>(sdot);
        pdot = row_sum<TPR>(pdot);
        const float p =
            (jj < nvalid) ? expf(sdot * f.scale + bias - rmax) * rinv : 0.f;
        float z = 1.f;
        if (drop) {
          const uint32_t w = __shfl_sync(0xffffffffu, philox_word(bits, u & 3),
                                         lane0 + (u >> 2));
          z = (w <= f.drop.thresh) ? f.drop.scale : 0.f;
        }
        const float ds = p * (z * pdot - delta);
#pragma unroll
        for (int t = 0; t < QPT; ++t) {
          dqa[t] = fmaf(ds, Ks[jj][sub + TPR * t], dqa[t]);
        }
        if (FULL) {
          __syncwarp();   // the row's threads have read Bs[r][jj]
          if (sub == 0) Bs[r][jj] = ds;
        }
      }
    }
    __syncthreads();
    if (FULL) {         // the tile's dS, coalesced along the keys
      for (int idx = tid; idx < BM * BN; idx += NT) {
        const int rr = idx / BN, jj = idx % BN;
        if (i0 + rr < f.Tq && jj < nvalid) {
          args.dbias[((static_cast<long long>(b) * f.H + h) * f.Tq + i0 + rr) *
                         f.Tk + j0 + jj] = Bs[rr][jj];
        }
      }
      __syncthreads();
    }
  }

  if (row_ok) {
#pragma unroll
    for (int t = 0; t < QPT; ++t) {
      const int c = sub + TPR * t;
      const float g = dqa[t] * f.scale;
      if (c < D1) {
        args.dq.at(b, i, h)[c] = g;
      } else {
        args.da.at(b, i, h)[c - D1] = g;
      }
    }
  }
}

template <int D1, int D2, int DV, int TPR, int BMQ, int BNK, bool FULL>
__global__ void __launch_bounds__(BNK * TPR)
attn_bwd_dkdv_kernel(const AttnBwdArgs args) {
  constexpr int NT = BNK * TPR;
  constexpr int DQ = D1 + D2;
  constexpr int QPT = DQ / TPR;
  constexpr int KPT = D1 / TPR;   // the key channels that get a gradient
  constexpr int VPT = DV / TPR;
  static_assert(BMQ % TPR == 0, "query tiles must hold whole Philox groups");
  const AttnArgs& f = args.f;

  __shared__ float Qs[BMQ][DQ];
  __shared__ float Os[BMQ][DV];   // dout
  __shared__ float Ms[BMQ];    // row max
  __shared__ float Is[BMQ];    // 1 / row sum
  __shared__ float Ds[BMQ];
  // FULL: the bias of the query tile's rows at this block's keys
  __shared__ float Bq[FULL ? BMQ : 1][FULL ? BNK + 1 : 1];

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int lane0 = (tid % 32) - sub;
  const int cj = FULL ? tid / TPR : 0;   // the column's line of Bq
  const int j = blockIdx.x * BNK + tid / TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool col_ok = j < f.Tk;
  const bool drop = f.drop.seeds != nullptr;
  const uint32_t seed = drop ? f.drop.seeds[FULL ? 0 : b] : 0u;
  const uint32_t c3 = FULL ? b : 0u;

  float kr[QPT];
#pragma unroll
  for (int t = 0; t < QPT; ++t) {
    const int c = sub + TPR * t;
    float x = 0.f;
    if (col_ok) x = (c < D1) ? f.k.at(b, j, h)[c] : f.e.at(b, j, h)[c - D1];
    kr[t] = x;
  }
  float vr[VPT], dva[VPT], dka[KPT];
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    vr[t] = col_ok ? f.v.at(b, j, h)[sub + TPR * t] : 0.f;
    dva[t] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < KPT; ++t) dka[t] = 0.f;
  const float bj = (col_ok && !FULL) ? f.bias[b * f.bias_sb + j] : 0.f;
  const long long stat0 = (static_cast<long long>(b) * f.H + h) * f.Tq;

  for (int i0 = 0; i0 < f.Tq; i0 += BMQ) {
    const int nq = min(BMQ, f.Tq - i0);
    for (int idx = tid; idx < BMQ * DQ; idx += NT) {
      const int ii = idx / DQ, c = idx % DQ, i = i0 + ii;
      float x = 0.f;
      if (ii < nq) {
        x = (c < D1) ? f.q.at(b, i, h)[c] : f.a.at(b, i, h)[c - D1];
      }
      Qs[ii][c] = x;
    }
    for (int idx = tid; idx < BMQ * DV; idx += NT) {
      const int ii = idx / DV, c = idx % DV;
      Os[ii][c] = (ii < nq) ? args.dout.at(b, i0 + ii, h)[c] : 0.f;
    }
    for (int ii = tid; ii < BMQ; ii += NT) {
      const long long st = stat0 + i0 + ii;
      Ms[ii] = (ii < nq) ? f.stats[2 * st] : 0.f;
      Is[ii] = (ii < nq) ? 1.f / f.stats[2 * st + 1] : 0.f;
      Ds[ii] = (ii < nq) ? args.delta[st] : 0.f;
    }
    if (FULL) {
      for (int idx = tid; idx < BMQ * BNK; idx += NT) {
        const int ii = idx / BNK, cc = idx % BNK;
        const int jc = blockIdx.x * BNK + cc;
        Bq[FULL ? ii : 0][FULL ? cc : 0] =
            (ii < nq && jc < f.Tk)
                ? f.bias4[(stat0 + i0 + ii) * f.Tk + jc]
                : 0.f;
      }
    }
    __syncthreads();

    for (int g0 = 0; g0 < BMQ; g0 += TPR) {
      // thread `sub` draws the bits of query i0 + g0 + sub for this key
      uint32_t wbits = 0u;
      if (drop) {
        const uint4 r = philox4x32_10(
            make_uint4(j >> 2, i0 + g0 + sub, h, c3), seed, 0u);
        wbits = philox_word(r, j & 3);
      }
#pragma unroll
      for (int u = 0; u < TPR; ++u) {
        const int ii = g0 + u;
        float sdot = 0.f, pdot = 0.f;
#pragma unroll
        for (int t = 0; t < QPT; ++t) {
          sdot = fmaf(kr[t], Qs[ii][sub + TPR * t], sdot);
        }
#pragma unroll
        for (int t = 0; t < VPT; ++t) {
          pdot = fmaf(vr[t], Os[ii][sub + TPR * t], pdot);
        }
        sdot = row_sum<TPR>(sdot);
        pdot = row_sum<TPR>(pdot);
        const float bias = FULL ? Bq[FULL ? ii : 0][cj] : bj;
        const float p =
            (ii < nq) ? expf(sdot * f.scale + bias - Ms[ii]) * Is[ii] : 0.f;
        float z = 1.f;
        if (drop) {
          const uint32_t w = __shfl_sync(0xffffffffu, wbits, lane0 + u);
          z = (w <= f.drop.thresh) ? f.drop.scale : 0.f;
        }
        const float pz = p * z;
        const float ds = p * (z * pdot - Ds[ii]);
#pragma unroll
        for (int t = 0; t < VPT; ++t) {
          dva[t] = fmaf(pz, Os[ii][sub + TPR * t], dva[t]);
        }
#pragma unroll
        for (int t = 0; t < KPT; ++t) {
          dka[t] = fmaf(ds, Qs[ii][sub + TPR * t], dka[t]);
        }
      }
    }
    __syncthreads();
  }

  if (col_ok) {
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      args.dk.at(b, j, h)[sub + TPR * t] = dka[t] * f.scale;
    }
#pragma unroll
    for (int t = 0; t < VPT; ++t) args.dv.at(b, j, h)[sub + TPR * t] = dva[t];
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

template <int D1, int D2, int DV, int TPR, int BM, int BN, int BMQ, int BNK,
          bool FULL = false>
cudaError_t launch_attn_bwd(const AttnBwdArgs& args, int B,
                            cudaStream_t stream) {
  // the dq kernel writes delta, which the dk/dv kernel reads: same stream
  dim3 grid_q((args.f.Tq + BM - 1) / BM, args.f.H, B);
  attn_bwd_dq_kernel<D1, D2, DV, TPR, BM, BN, FULL>
      <<<grid_q, BM * TPR, 0, stream>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_k((args.f.Tk + BNK - 1) / BNK, args.f.H, B);
  attn_bwd_dkdv_kernel<D1, D2, DV, TPR, BMQ, BNK, FULL>
      <<<grid_k, BNK * TPR, 0, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace daspeech
