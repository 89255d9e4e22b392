// The Conformer macaron FFN, forward and backward, for Hopper (sm_90a), fp32:
//   out = dropout2(swish(LN(x) W1^T + b1) * m1 W2^T + b2)
// with LN's eps 1e-6, W1 = w_1.weight [F, C] and W2 = w_2.weight [C, F]
// (nn.Linear's layout, read in place).
//
// Replaces the Pallas kernels of daspeech_tpu/ops/fused_ffn.py:175
// fused_ffn (forward _ffn_fwd_kernel, :59; backward _ffn_bwd_kernel, :84).
// The TPU kernel runs one batch row per program with the whole [T, F]
// intermediate in VMEM and carries dW across its sequential grid.
//
// What bounds it on this card: operations. At N = B T = 9600 rows, C = 256,
// F = 2048 the forward is 2 products, 20.1 GFLOP, against 20 MB of x,
// weights and output (0.12 ms at the tensor cores' 3xTF32 rate of 165
// TFLOP/s, 0.30 ms at the fp32 FMA pipes' 67); the backward 5 products,
// 50 GFLOP. Every product runs on the tensor cores, 3xTF32 mma.sync with
// each operand element split into its TF32 hi and lo parts once
// (gemm_tc.cuh). A row tile alone is little work (a block that walks all
// of F for 64 rows filled 15 of 132 SMs at serving's 960 rows), so F is
// split across the blocks of a thread-block cluster.
//
// Forward (ffn_fwd_kernel): a cluster of cs = min(8, ceil(F / 256)) blocks
// owns BM = 32 rows; block `rank` takes the 256-column F slices rank,
// rank + cs, ... For a slice it normalizes the rows into planes, takes
// pre = y W1[slice]^T on the tensor cores, applies + b1, swish and mask 1
// into planes, and adds h W2[:, slice]^T into its [32, 256] partial sum.
// The weight slices stream in 16-deep chunks by cp.async through a ring of
// kRing raw fp32 tiles, kRing - 1 chunks ahead of the products; each
// weight element feeds one warp only, so that warp splits it as it loads
// its fragment (gemm::RawOp), once, with no plane pass. The
// partials are summed through distributed shared memory in rank order
// (each block sums a share of ceil(32 / cs) rows over the cluster, RowShare),
// then + b2 and mask 2. The [T, F] intermediate never leaves the cluster.
//
// Backward, three launches, no atomics (two runs give the same bits):
//  1. ffn_bwd_rows_kernel, clustered as the forward: g = dout * m2 into
//     planes; per slice, pre = y W1[slice]^T and gh = g W2[:, slice] on the
//     tensor cores, gpre = gh * m1 * swish'(pre) into planes (and, with
//     h * m1, to scratch [N, F] for the weight gradients), then
//     gy += gpre W1[slice]; the gy partials are summed through distributed
//     shared memory in rank order and each block runs LayerNorm's backward
//     on its row share into dx. Column sums (db1, db2, dgamma, dbeta) go to
//     partial rows.
//  2. ffn_wgrad_kernel: dW1 = gpre^T y and dW2 = g^T (h * m1), a [128, 128]
//     output tile per block over one of S fixed slices of the N rows, on the
//     tensor cores, into per-slice partial sums.
//  3. ffn_reduce_kernel adds the partial sums in a fixed order.
//
// bf16 (daspeech_ffn_fwd_bf16, daspeech_ffn_bwd_bf16; x, W1, b1, W2, b2,
// out, dout and dx bf16 in device memory, gamma, beta and the weight and
// bias gradients fp32): ffn_bf16.cuh's kernels on the bf16 tensor cores,
// which read the bf16 tensors in place. The fp32 kernels' `lp` (round each
// product's operands to bf16) is always 0 now; it stays so that these
// kernels compile as before.
//
// Dropout (philox.cuh): element (t, j) of batch row b at site s (1: after
// the swish, width F; 2: after the second product, width C) is kept when
// word j % 4 of philox4x32_10((j / 4, t, 0, s), (seed[b], 0)) <= thresh,
// then scaled by 1 / keep_p; ops/philox.py ffn_keep draws the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_tc.cuh"
#include "philox.cuh"

namespace {

using namespace daspeech;
namespace cg = cooperative_groups;

constexpr int C = 256;         // model width the kernels are built for
constexpr int NT = 256;        // threads per block: 8 warps of 32 columns
constexpr int BM = 32;         // rows of a cluster
constexpr int FS = 256;        // F columns of a slice
constexpr int KC = 16;         // depth of a streamed weight chunk
constexpr int kRing = 4;       // raw weight chunks in flight
constexpr int kMaxCluster = 8; // the portable cluster limit
constexpr int AP = C + 4;      // pitch of [BM][256] planes (≡ 4 mod 32)
constexpr int APLANE = BM * AP;
constexpr int NKP = KC + 4;    // pitch of [256][KC] chunks (k inner)
constexpr int KNP = 256 + 8;   // pitch of [KC][256] chunks (k outer)
constexpr int WRAW = 256 * NKP;    // words of a raw weight chunk
constexpr float kEps = 1e-6f;
static_assert(FS == C && KC * KNP <= WRAW, "slice and chunk shapes");
static_assert(NT == C, "the column sums give each thread one column");
// forward: one [BM][256] plane pair (y, then h), the ring of raw weight
// chunks, mean and 1/std; backward: two [BM][256] plane pairs (y, then
// gpre; g), the ring, mean and 1/std
constexpr size_t kFwdSmem =
    sizeof(uint32_t) * (2 * APLANE + kRing * WRAW) + sizeof(float) * 2 * BM;
constexpr size_t kBwdSmem =
    sizeof(uint32_t) * (4 * APLANE + kRing * WRAW) + sizeof(float) * 2 * BM;

struct FfnArgs {
  const float *x, *gamma, *beta, *w1, *b1, *w2, *b2;
  const uint32_t* seeds;  // [B] per-row Philox keys, or nullptr
  int drop1, drop2;       // sites on
  uint32_t thresh1, thresh2;
  float scale1, scale2;
  int N, T, F;            // N = B * T rows
  int lp;                 // round the products' operands to bf16
};

struct FfnScratch {
  float *y, *g;           // [N, C]: LN output, dout * m2
  float *hd, *gpre;       // [N, F]: swish(pre) * m1, its pre-activation grad
  float* part;            // [ntiles, F + 3C]: db1 | db2 | dgamma | dbeta
};

__host__ __device__ inline int cluster_size(int F) {
  const int slices = (F + FS - 1) / FS;
  return slices < kMaxCluster ? slices : kMaxCluster;
}

// The rows of a cluster's tile that block `rank` of cs reduces over the
// cluster: ceil(BM / cs) from r0 on, the last share shorter (cs = 3:
// 11, 11, 10), so every row has one block at every cluster size.
struct RowShare {
  int r0, rows;
  __device__ RowShare(int cs, int rank) {
    const int per = (BM + cs - 1) / cs;
    r0 = rank * per;
    rows = max(0, min(per, BM - r0));
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Philox words of the 4 columns 4 * col4 .. of row n at `site`
__device__ __forceinline__ uint4 site_bits(const FfnArgs& a, int n, int col4,
                                           uint32_t site) {
  const int b = n / a.T;
  return philox4x32_10(make_uint4(col4, n - b * a.T, 0u, site), a.seeds[b],
                       0u);
}

__device__ __forceinline__ float keep(uint32_t w, uint32_t thresh,
                                      float scale) {
  return w <= thresh ? scale : 0.f;
}

// LayerNorm of rows n0 .. n0 + BM into the plane pair ys (0 for rows >= N),
// one warp a row (each warp's rows loaded together); each row's mean and
// 1/std into mu, rs; with y_out, y is also written there
__device__ void layer_norm_rows(const FfnArgs& a, int n0, uint32_t* ys,
                                float* mu, float* rs, float* y_out) {
  constexpr int RW = BM / (NT / 32);     // rows of a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float v[RW][C / 32];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int n = n0 + warp + i * (NT / 32);
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      v[i][t] = n < a.N ? a.x[static_cast<long long>(n) * C + lane + 32 * t]
                        : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + i * (NT / 32), n = n0 + r;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) s += v[i][t];
    const float mean = warp_sum(s) * (1.f / C);
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      const float d = v[i][t] - mean;
      q = fmaf(d, d, q);
    }
    const float rstd = rsqrtf(warp_sum(q) * (1.f / C) + kEps);
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      const int c = lane + 32 * t;
      const float y = n < a.N
                          ? gemm::bf16_if(fmaf((v[i][t] - mean) * rstd,
                                               a.gamma[c], a.beta[c]),
                                          a.lp)
                          : 0.f;
      gemm::put(ys, APLANE, r * AP + c, y);
      if (y_out != nullptr && n < a.N) {
        y_out[static_cast<long long>(n) * C + c] = y;
      }
    }
    if (lane == 0) {
      mu[r] = mean;
      rs[r] = rstd;
    }
  }
}

// The first kRing - 1 chunks of a streamed product (see product): issued
// before the work that precedes the product, so that their latency hides
// behind it; the ring must be free (the last product has ended)
template <class Copy>
__device__ __forceinline__ void prefetch(float* ring, Copy copy) {
#pragma unroll
  for (int kc = 0; kc < kRing - 1; ++kc) {
    copy(kc, ring + kc * WRAW);
    cp_async_commit();
  }
}

// acc (this warp's 32 rows x 32 columns at column 32 warp) += A · B over
// K = 256: A resident in the plane pair `as` ([BM][AP], k from 0), B
// streamed in 16-deep chunks that copy(kc, tile) brings by cp.async into
// the ring at `ring`, kRing - 1 chunks ahead (the first ones by prefetch);
// BK: B's chunks are [KC][256] (k outer), else [256][KC]. Ends with a
// barrier: the caller may restage `as` or the ring.
template <bool BK, class Copy>
__device__ __forceinline__ void product(float (&acc)[2][4][4],
                                        const uint32_t* as, float* ring,
                                        Copy copy) {
  constexpr int pitch = BK ? KNP : NKP, nk = 256 / KC;
  const int n0 = (threadIdx.x / 32) * 32;
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kRing - 2>();      // chunk kc: this thread's copies
    __syncthreads();                 // everyone's; the oldest tile is free
    if (kc + kRing - 1 < nk) {
      copy(kc + kRing - 1, ring + ((kc + kRing - 1) % kRing) * WRAW);
    }
    cp_async_commit();
    gemm::warp_mma<2, 4, KC / 8, false, BK>(
        acc, gemm::Op{as, APLANE, AP, 0, kc * KC},
        gemm::RawOp{ring + (kc % kRing) * WRAW, pitch, n0, 0});
  }
  __syncthreads();
}

// the copy of chunk kc of a [256][KC] (k inner) or [KC][256] (k outer)
// weight tile
using NKChunk = gemm::RawChunk<256, KC, NT>;
using KNChunk = gemm::RawChunk<KC, 256, NT>;

// The accumulator element (m, h, n, e) of this thread: row 16 m + gid + 8 h,
// column 32 warp + 8 n + 2 t + e (gemm_tc.cuh's C fragment)
struct Frag {
  int gid, tq, col0;
  __device__ Frag()
      : gid((threadIdx.x % 32) >> 2), tq(threadIdx.x & 3),
        col0((threadIdx.x / 32) * 32) {}
  __device__ int row(int m, int h) const { return 16 * m + gid + 8 * h; }
  __device__ int col(int n) const { return col0 + 8 * n + 2 * tq; }
};

__global__ void __launch_bounds__(NT, 1) ffn_fwd_kernel(const FfnArgs a,
                                                        float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 smem4[];
  // y, then h * m1 (pre is in registers when h is written), then the
  // partial sum
  uint32_t* ys = reinterpret_cast<uint32_t*>(smem4);
  float* ring = reinterpret_cast<float*>(ys + 2 * APLANE);
  float* mu = ring + kRing * WRAW;
  float* rs = mu + BM;
  const int n0 = blockIdx.y * BM;
  const int nslices = (a.F + FS - 1) / FS;
  const bool vecF = a.F % 4 == 0;   // W2's rows allow 16-byte copies
  const Frag fr;

  float acc[2][4][4];
  gemm::zero(acc);
  for (int s = rank; s < nslices; s += cs) {
    const int f0 = s * FS;
    auto w1_chunk = [&](int kc, float* t) {   // W1[f0 .., kc KC ..]
      NKChunk::copy(t, NKP, a.w1, C, f0, kc * KC, a.F, C, true);
    };
    auto w2_chunk = [&](int kc, float* t) {   // W2[:, f0 + kc KC ..]
      NKChunk::copy(t, NKP, a.w2, a.F, 0, f0 + kc * KC, C, a.F, vecF);
    };
    prefetch(ring, w1_chunk);
    layer_norm_rows(a, n0, ys, mu, rs, nullptr);
    __syncthreads();
    float pre[2][4][4];
    gemm::zero(pre);
    product<false>(pre, ys, ring, w1_chunk);
    prefetch(ring, w2_chunk);
    // h = swish(pre + b1) * m1 into ys (y is dead), 0 beyond F
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = fr.row(m, h), n = n0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int f = f0 + fr.col(j);
          uint4 bits = make_uint4(0u, 0u, 0u, 0u);
          if (a.drop1 && n < a.N && f < a.F) bits = site_bits(a, n, f >> 2, 1u);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float hv = 0.f;
            if (f + e < a.F) {
              const float p = pre[m][j][2 * h + e] + a.b1[f + e];
              hv = p / (1.f + expf(-p));
              if (a.drop1) {
                hv *= n < a.N ? keep(philox_word(bits, (f + e) & 3),
                                     a.thresh1, a.scale1)
                              : 0.f;
              }
            }
            gemm::put(ys, APLANE, r * AP + fr.col(j) + e,
                      gemm::bf16_if(hv, a.lp));
          }
        }
      }
    }
    __syncthreads();
    product<false>(acc, ys, ring, w2_chunk);
  }

  // the partial sum into ys as fp32 [BM][AP]; each block then sums its row
  // share over the cluster in rank order: + b2, mask 2, store
  float* part = reinterpret_cast<float*>(ys);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float2*>(part + fr.row(m, h) * AP + fr.col(j)) =
            make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
      }
    }
  }
  cluster.sync();
  const RowShare sh(cs, rank);
  for (int g = threadIdx.x; g < sh.rows * (C / 4); g += NT) {
    const int r = sh.r0 + g / (C / 4), q = g % (C / 4), n = n0 + r;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < cs; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, k) + r * AP + 4 * q);
      o.x += v.x;
      o.y += v.y;
      o.z += v.z;
      o.w += v.w;
    }
    if (n >= a.N) continue;
    const float4 bb = *reinterpret_cast<const float4*>(a.b2 + 4 * q);
    o.x += bb.x;
    o.y += bb.y;
    o.z += bb.z;
    o.w += bb.w;
    if (a.drop2) {
      const uint4 bits = site_bits(a, n, q, 2u);
      o.x *= keep(bits.x, a.thresh2, a.scale2);
      o.y *= keep(bits.y, a.thresh2, a.scale2);
      o.z *= keep(bits.z, a.thresh2, a.scale2);
      o.w *= keep(bits.w, a.thresh2, a.scale2);
    }
    *reinterpret_cast<float4*>(out + static_cast<long long>(n) * C + 4 * q) =
        o;
  }
  cluster.sync();   // no block leaves while a peer reads its partial
}

__global__ void __launch_bounds__(NT, 1)
    ffn_bwd_rows_kernel(const FfnArgs a, const float* dout, float* dx,
                        const FfnScratch sc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 smem4[];
  uint32_t* ys = reinterpret_cast<uint32_t*>(smem4);  // y, then gpre
  uint32_t* gs = ys + 2 * APLANE;                     // g, then gy partial
  float* ring = reinterpret_cast<float*>(gs + 2 * APLANE);
  float* mu = ring + kRing * WRAW;
  float* rs = mu + BM;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BM;
  const int nslices = (a.F + FS - 1) / FS;
  const int width = a.F + 3 * C;
  float* part = sc.part + static_cast<long long>(blockIdx.y) * width;
  const bool vecF = a.F % 4 == 0;
  const Frag fr;

  // g = dout * m2 into gs (0 for rows >= N); rank 0 also to scratch
  for (int g = tid; g < BM * C / 4; g += NT) {
    const int r = g / (C / 4), q = g % (C / 4), n = n0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < a.N) {
      v = *reinterpret_cast<const float4*>(dout + static_cast<long long>(n) * C +
                                           4 * q);
      if (a.drop2) {
        const uint4 bits = site_bits(a, n, q, 2u);
        v.x *= keep(bits.x, a.thresh2, a.scale2);
        v.y *= keep(bits.y, a.thresh2, a.scale2);
        v.z *= keep(bits.z, a.thresh2, a.scale2);
        v.w *= keep(bits.w, a.thresh2, a.scale2);
      }
      if (rank == 0) {
        *reinterpret_cast<float4*>(sc.g + static_cast<long long>(n) * C +
                                   4 * q) = v;
      }
    }
    gemm::put(gs, APLANE, r * AP + 4 * q, gemm::bf16_if(v.x, a.lp));
    gemm::put(gs, APLANE, r * AP + 4 * q + 1, gemm::bf16_if(v.y, a.lp));
    gemm::put(gs, APLANE, r * AP + 4 * q + 2, gemm::bf16_if(v.z, a.lp));
    gemm::put(gs, APLANE, r * AP + 4 * q + 3, gemm::bf16_if(v.w, a.lp));
  }

  float gy[2][4][4];
  gemm::zero(gy);
  for (int s = rank; s < nslices; s += cs) {
    const int f0 = s * FS;
    auto w1_chunk = [&](int kc, float* t) {   // W1[f0 .., kc KC ..]
      NKChunk::copy(t, NKP, a.w1, C, f0, kc * KC, a.F, C, true);
    };
    auto w2_chunk = [&](int kc, float* t) {   // W2[kc KC .., f0 ..]
      KNChunk::copy(t, KNP, a.w2, a.F, kc * KC, f0, C, a.F, vecF);
    };
    auto w1t_chunk = [&](int kc, float* t) {  // W1[f0 + kc KC .., :]
      KNChunk::copy(t, KNP, a.w1, C, f0 + kc * KC, 0, a.F, C, true);
    };
    prefetch(ring, w1_chunk);
    layer_norm_rows(a, n0, ys, mu, rs, s == 0 ? sc.y : nullptr);
    __syncthreads();
    float pre[2][4][4], gh[2][4][4];
    gemm::zero(pre);
    gemm::zero(gh);
    product<false>(pre, ys, ring, w1_chunk);
    prefetch(ring, w2_chunk);
    product<true>(gh, gs, ring, w2_chunk);
    prefetch(ring, w1t_chunk);
    // gpre = gh * m1 * swish'(pre) into ys (0 beyond F and N), and with
    // h * m1 to scratch
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = fr.row(m, h), n = n0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int f = f0 + fr.col(j);
          uint4 bits = make_uint4(0u, 0u, 0u, 0u);
          if (a.drop1 && n < a.N && f < a.F) bits = site_bits(a, n, f >> 2, 1u);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float gp = 0.f;
            if (f + e < a.F && n < a.N) {
              const float p = pre[m][j][2 * h + e] + a.b1[f + e];
              const float sg = 1.f / (1.f + expf(-p));
              const float z = a.drop1 ? keep(philox_word(bits, (f + e) & 3),
                                             a.thresh1, a.scale1)
                                      : 1.f;
              gp = gh[m][j][2 * h + e] * z * (sg * (1.f + p * (1.f - sg)));
              const long long o = static_cast<long long>(n) * a.F + f + e;
              sc.hd[o] = p * sg * z;
              sc.gpre[o] = gp;
            }
            gemm::put(ys, APLANE, r * AP + fr.col(j) + e,
                      gemm::bf16_if(gp, a.lp));
          }
        }
      }
    }
    __syncthreads();
    if (f0 + tid < a.F) {                              // db1
      float sum = 0.f;
      for (int r = 0; r < BM && n0 + r < a.N; ++r) {
        sum += __ldcg(sc.gpre + static_cast<long long>(n0 + r) * a.F + f0 +
                      tid);
      }
      part[f0 + tid] = sum;
    }
    product<true>(gy, ys, ring, w1t_chunk);
  }
  if (rank == 0) {                                     // db2
    float sum = 0.f;
    for (int r = 0; r < BM && n0 + r < a.N; ++r) {
      sum += __ldcg(sc.g + static_cast<long long>(n0 + r) * C + tid);
    }
    part[a.F + tid] = sum;
  }

  // the gy partial into gs as fp32 [BM][AP]; each block sums its row share
  // over the cluster in rank order and runs LayerNorm's backward on it
  float* pg = reinterpret_cast<float*>(gs);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float2*>(pg + fr.row(m, h) * AP + fr.col(j)) =
            make_float2(gy[m][j][2 * h], gy[m][j][2 * h + 1]);
      }
    }
  }
  cluster.sync();
  const RowShare sh(cs, rank);
  const int rows = sh.rows, r0 = sh.r0;
  const int warp = tid / 32, lane = tid % 32;
  float* cols = reinterpret_cast<float*>(ys);   // [2][rows][C]: gy, xhat
  for (int rl = warp; rl < rows; rl += NT / 32) {
    const int r = r0 + rl, n = n0 + r;
    float xh[C / 32], dxh[C / 32];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      const int c = lane + 32 * t;
      float v = 0.f;
      for (int k = 0; k < cs; ++k) {
        v += cluster.map_shared_rank(pg, k)[r * AP + c];
      }
      xh[t] = n < a.N
                  ? (a.x[static_cast<long long>(n) * C + c] - mu[r]) * rs[r]
                  : 0.f;
      dxh[t] = v * a.gamma[c];
      s1 += dxh[t];
      s2 = fmaf(dxh[t], xh[t], s2);
      cols[rl * C + c] = v;
      cols[(rows + rl) * C + c] = xh[t];
    }
    const float m1 = warp_sum(s1) * (1.f / C);
    const float m2 = warp_sum(s2) * (1.f / C);
    if (n < a.N) {
#pragma unroll
      for (int t = 0; t < C / 32; ++t) {
        dx[static_cast<long long>(n) * C + lane + 32 * t] =
            rs[r] * (dxh[t] - m1 - xh[t] * m2);
      }
    }
  }
  cluster.sync();   // the partials are read; cols is visible block-wide
  // dgamma and dbeta: this block's rows into gs, then block 0 of the
  // cluster adds the blocks' sums in rank order into the tile's row
  float sg = 0.f, sb = 0.f;
  for (int rl = 0; rl < rows; ++rl) {
    const float v = cols[rl * C + tid];
    sg = fmaf(v, cols[(rows + rl) * C + tid], sg);
    sb += v;
  }
  pg[tid] = sg;
  pg[C + tid] = sb;
  cluster.sync();
  if (rank == 0) {
    sg = sb = 0.f;
    for (int k = 0; k < cs; ++k) {
      const float* q = cluster.map_shared_rank(pg, k);
      sg += q[tid];
      sb += q[C + tid];
    }
    part[a.F + C + tid] = sg;                          // dgamma
    part[a.F + 2 * C + tid] = sb;                      // dbeta
  }
  cluster.sync();   // block 0 has read every block's sums
}

// out[m][p] = sum over the rows n of one slice of A[n][m] Bm[n][p]
struct WgradJob {
  const float* A;    // [N, M]
  const float* Bm;   // [N, P]
  float* part;       // [S, M, P]
  int M, P;
};

struct WgradArgs {
  WgradJob job[2];   // dW1 = gpre^T y, dW2 = g^T (h * m1)
  int N, rows;       // rows per slice
  int lp;            // round the operands to bf16 as they are split
};

constexpr int WT = 128;          // output tile of the weight gradients
constexpr int WTP = WT + 8;      // pitch of [KC][128] planes (k outer)
constexpr int WTPLANE = KC * WTP;
constexpr int WTRAW = KC * WT;   // a raw [KC][128] chunk
// A's and B's planes [2][2][KC][WTP] and raw rings [kRing][KC][WT]
constexpr size_t kWgradSmem =
    sizeof(uint32_t) * (8 * WTPLANE + 2 * kRing * WTRAW);

// 8 warps: 4 along the output's rows x 2 along its columns, 32 x 64 each.
// A chunk's rows are shared by 2 warps and B's by 4, so each thread splits
// what its own cp.async brought into planes (one barrier a chunk).
__global__ void __launch_bounds__(NT) ffn_wgrad_kernel(const WgradArgs a) {
  using Ch = gemm::RawChunk<KC, WT, NT>;
  const WgradJob jb = (blockIdx.z & 1) ? a.job[1] : a.job[0];
  const int s = blockIdx.z >> 1;
  const int tiles_p = (jb.P + WT - 1) / WT;
  const int m0 = (blockIdx.x / tiles_p) * WT, p0 = (blockIdx.x % tiles_p) * WT;
  const int nb = s * a.rows, ne = min(a.N, nb + a.rows);
  extern __shared__ float4 smem4[];
  uint32_t* as = reinterpret_cast<uint32_t*>(smem4);  // [2][2][KC][WTP]
  uint32_t* bs = as + 4 * WTPLANE;
  float* araw = reinterpret_cast<float*>(bs + 4 * WTPLANE);
  float* braw = araw + kRing * WTRAW;
  const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
  const bool vec = jb.M % 4 == 0 && jb.P % 4 == 0;

  float acc[2][8][4];
  gemm::zero(acc);
  const int nk = (ne - nb + KC - 1) / KC;
  auto copy = [&](int kc) {
    const int slot = (kc % kRing) * WTRAW;
    Ch::copy(araw + slot, WT, jb.A, jb.M, nb + kc * KC, m0, ne, jb.M, vec);
    Ch::copy(braw + slot, WT, jb.Bm, jb.P, nb + kc * KC, p0, ne, jb.P, vec);
  };
#pragma unroll
  for (int kc = 0; kc < kRing - 1; ++kc) {
    if (kc < nk) copy(kc);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kRing - 2>();
    uint32_t* ab = as + (kc & 1) * 2 * WTPLANE;
    uint32_t* bb = bs + (kc & 1) * 2 * WTPLANE;
    Ch::split(araw + (kc % kRing) * WTRAW, WT, ab, WTPLANE, WTP, a.lp);
    Ch::split(braw + (kc % kRing) * WTRAW, WT, bb, WTPLANE, WTP, a.lp);
    __syncthreads();
    if (kc + kRing - 1 < nk) copy(kc + kRing - 1);
    cp_async_commit();
    gemm::warp_mma<2, 8, KC / 8, true, true>(
        acc, gemm::Op{ab, WTPLANE, WTP, wm * 32, 0},
        gemm::Op{bb, WTPLANE, WTP, wn * 64, 0});
  }
  cp_async_wait<0>();
  float* out = jb.part + static_cast<long long>(s) * jb.M * jb.P;
  const int lane = threadIdx.x % 32, gid = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + 16 * m + gid + 8 * h;
      if (row >= jb.M) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = p0 + wn * 64 + 8 * n + 2 * tq + e;
          if (p < jb.P) {
            out[static_cast<long long>(row) * jb.P + p] = acc[m][n][2 * h + e];
          }
        }
      }
    }
  }
}

// out[i] = sum over k < S, in order, of part[k * stride + i], i < n
struct ReduceJob {
  const float* part;
  float* out;
  long long n, stride;
  int S;
};

struct ReduceArgs {
  ReduceJob job[6];
};

__global__ void ffn_reduce_kernel(const ReduceArgs a) {
  const ReduceJob& jb = a.job[blockIdx.y];
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= jb.n) return;
  // the terms in order, kLoads of them loaded before they are added
  constexpr int kLoads = 8;
  float s = 0.f;
  for (int k0 = 0; k0 < jb.S; k0 += kLoads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      v[u] = k0 + u < jb.S ? jb.part[(k0 + u) * jb.stride + i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (k0 + u < jb.S) s += v[u];
    }
  }
  jb.out[i] = s;
}

FfnArgs ffn_args(const float* x, const float* gamma, const float* beta,
                 const float* w1, const float* b1, const float* w2,
                 const float* b2, const uint32_t* seeds, int drop1,
                 uint32_t thresh1, float scale1, int drop2, uint32_t thresh2,
                 float scale2, int B, int T, int F) {
  FfnArgs a;
  a.x = x;
  a.gamma = gamma;
  a.beta = beta;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.seeds = seeds;
  a.drop1 = seeds != nullptr && drop1;
  a.drop2 = seeds != nullptr && drop2;
  a.thresh1 = thresh1;
  a.thresh2 = thresh2;
  a.scale1 = scale1;
  a.scale2 = scale2;
  a.N = B * T;
  a.T = T;
  a.F = F;
  a.lp = 0;
  return a;
}

// a row kernel on clusters of cluster_size(F) blocks along x, one cluster
// per BM-row tile along y, `smem` bytes of shared memory a block
template <typename... Params, typename... Args>
cudaError_t launch_rows(void (*kernel)(Params...), size_t smem, int F, int N,
                        cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int cs = cluster_size(F);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (N + BM - 1) / BM);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the fixed-order sums of the weight gradients' slices (part_w [2, S, F C])
// and of the row tiles' column sums (part_rows [ntiles, F + 3C])
cudaError_t reduce(const float* part_w, const float* part_rows, float* dw1,
                   float* dw2, float* db1, float* db2, float* dgamma,
                   float* dbeta, int F, int ntiles, int S, cudaStream_t st) {
  const long long FC_ = static_cast<long long>(F) * C;
  const long long width = F + 3 * C;
  ReduceArgs r;
  r.job[0] = {part_w, dw1, FC_, FC_, S};
  r.job[1] = {part_w + S * FC_, dw2, FC_, FC_, S};
  r.job[2] = {part_rows, db1, F, width, ntiles};
  r.job[3] = {part_rows + F, db2, C, width, ntiles};
  r.job[4] = {part_rows + F + C, dgamma, C, width, ntiles};
  r.job[5] = {part_rows + F + 2 * C, dbeta, C, width, ntiles};
  ffn_reduce_kernel<<<dim3(static_cast<unsigned>((FC_ + 255) / 256), 6), 256,
                      0, st>>>(r);
  return cudaGetLastError();
}

#include "ffn_bf16.cuh"

bf::Args bf_args(const void* x, const float* gamma, const float* beta,
                 const void* w1, const void* b1, const void* w2,
                 const void* b2, const uint32_t* seeds, int drop1,
                 uint32_t thresh1, float scale1, int drop2, uint32_t thresh2,
                 float scale2, int B, int T, int F) {
  bf::Args a;
  a.x = static_cast<const uint16_t*>(x);
  a.gamma = gamma;
  a.beta = beta;
  a.w1 = static_cast<const uint16_t*>(w1);
  a.b1 = static_cast<const uint16_t*>(b1);
  a.w2 = static_cast<const uint16_t*>(w2);
  a.b2 = static_cast<const uint16_t*>(b2);
  a.seeds = seeds;
  a.drop1 = seeds != nullptr && drop1;
  a.drop2 = seeds != nullptr && drop2;
  a.thresh1 = thresh1;
  a.thresh2 = thresh2;
  a.scale1 = scale1;
  a.scale2 = scale2;
  a.N = B * T;
  a.T = T;
  a.F = F;
  a.Fp = (F + 7) / 8 * 8;
  a.vec_w2 = F % 8 == 0 && bf::aligned16(w2);
  return a;
}

cudaError_t ffn_fwd(const FfnArgs& a, float* out, cudaStream_t st) {
  return launch_rows(ffn_fwd_kernel, kFwdSmem, a.F, a.N, st, a, out);
}

cudaError_t ffn_bwd(const FfnArgs& a, const float* dout, float* dx,
                    float* dgamma, float* dbeta, float* dw1, float* db1,
                    float* dw2, float* db2, float* y, float* g, float* hd,
                    float* gpre, float* part_rows, float* part_w, int S,
                    cudaStream_t st) {
  const int F = a.F;
  const int ntiles = (a.N + BM - 1) / BM;
  cudaError_t err = launch_rows(ffn_bwd_rows_kernel, kBwdSmem, a.F, a.N, st,
                                a, dout, dx,
                                FfnScratch{y, g, hd, gpre, part_rows});
  if (err != cudaSuccess) return err;

  const long long FC_ = static_cast<long long>(F) * C;
  WgradArgs w;
  w.job[0] = {gpre, y, part_w, F, C};
  w.job[1] = {g, hd, part_w + S * FC_, C, F};
  w.N = a.N;
  w.rows = (a.N + S - 1) / S;
  w.lp = a.lp;
  err = cudaFuncSetAttribute(ffn_wgrad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kWgradSmem));
  if (err != cudaSuccess) return err;
  const int tiles = ((F + WT - 1) / WT) * ((C + WT - 1) / WT);
  ffn_wgrad_kernel<<<dim3(tiles, 1, 2 * S), NT, kWgradSmem, st>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  return reduce(part_w, part_rows, dw1, dw2, db1, db2, dgamma, dbeta, F,
                ntiles, S, st);
}

}  // namespace

extern "C" int daspeech_ffn_fwd(const float* x, const float* gamma,
                                const float* beta, const float* w1,
                                const float* b1, const float* w2,
                                const float* b2, const uint32_t* seeds,
                                int drop1, uint32_t thresh1, float scale1,
                                int drop2, uint32_t thresh2, float scale2,
                                float* out, int B, int T, int Cw, int F,
                                void* stream) {
  if (Cw != C || B < 1 || T < 1 || F < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FfnArgs a = ffn_args(x, gamma, beta, w1, b1, w2, b2, seeds, drop1,
                             thresh1, scale1, drop2, thresh2, scale2, B, T,
                             F);
  return static_cast<int>(
      ffn_fwd(a, out, static_cast<cudaStream_t>(stream)));
}

// bf16 x, w1, b1, w2, b2 and out (x, w1 and out 16-byte aligned); gamma
// and beta fp32
extern "C" int daspeech_ffn_fwd_bf16(const void* x, const float* gamma,
                                     const float* beta, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const uint32_t* seeds,
                                     int drop1, uint32_t thresh1,
                                     float scale1, int drop2,
                                     uint32_t thresh2, float scale2,
                                     void* out, int B, int T, int Cw, int F,
                                     void* stream) {
  if (Cw != C || B < 1 || T < 1 || F < 1 || !bf::aligned16(x) ||
      !bf::aligned16(w1) || !bf::aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf::Args a = bf_args(x, gamma, beta, w1, b1, w2, b2, seeds, drop1,
                             thresh1, scale1, drop2, thresh2, scale2, B, T,
                             F);
  return static_cast<int>(bf::fwd(a, static_cast<uint16_t*>(out),
                                  static_cast<cudaStream_t>(stream)));
}

// scratch: y, g [N, C]; hd, gpre [N, F]; part_rows [ceil(N / 32),
// F + 3 C]; part_w [2, S, F * C] (the S row slices of dW1, then of dW2)
extern "C" int daspeech_ffn_bwd(
    const float* x, const float* gamma, const float* beta, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* dout,
    const uint32_t* seeds, int drop1, uint32_t thresh1, float scale1,
    int drop2, uint32_t thresh2, float scale2, float* dx, float* dgamma,
    float* dbeta, float* dw1, float* db1, float* dw2, float* db2, float* y,
    float* g, float* hd, float* gpre, float* part_rows, float* part_w, int B,
    int T, int Cw, int F, int S, void* stream) {
  if (Cw != C || B < 1 || T < 1 || F < 1 || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FfnArgs a = ffn_args(x, gamma, beta, w1, b1, w2, b2, seeds, drop1,
                             thresh1, scale1, drop2, thresh2, scale2, B, T,
                             F);
  return static_cast<int>(ffn_bwd(a, dout, dx, dgamma, dbeta, dw1, db1, dw2,
                                  db2, y, g, hd, gpre, part_rows, part_w, S,
                                  static_cast<cudaStream_t>(stream)));
}

// bf16 x, w1, b1, w2, b2, dout and dx (x, w1, dout and dx 16-byte
// aligned); the parameter gradients fp32; scratch: y, g bf16 [N, C], hd,
// gpre bf16 [N, Fp] (Fp = F rounded up to 8), part_rows and part_w fp32 as
// daspeech_ffn_bwd's
extern "C" int daspeech_ffn_bwd_bf16(
    const void* x, const float* gamma, const float* beta, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* dout,
    const uint32_t* seeds, int drop1, uint32_t thresh1, float scale1,
    int drop2, uint32_t thresh2, float scale2, void* dx, float* dgamma,
    float* dbeta, float* dw1, float* db1, float* dw2, float* db2, void* y,
    void* g, void* hd, void* gpre, float* part_rows, float* part_w, int B,
    int T, int Cw, int F, int S, void* stream) {
  if (Cw != C || B < 1 || T < 1 || F < 1 || S < 1 || !bf::aligned16(x) ||
      !bf::aligned16(w1) || !bf::aligned16(dout) || !bf::aligned16(dx) ||
      !bf::aligned16(y) || !bf::aligned16(g) || !bf::aligned16(hd) ||
      !bf::aligned16(gpre)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf::Args a = bf_args(x, gamma, beta, w1, b1, w2, b2, seeds, drop1,
                             thresh1, scale1, drop2, thresh2, scale2, B, T,
                             F);
  const bf::Scratch sc{static_cast<uint16_t*>(y), static_cast<uint16_t*>(g),
                       static_cast<uint16_t*>(hd),
                       static_cast<uint16_t*>(gpre), part_rows};
  return static_cast<int>(bf::bwd(a, static_cast<const uint16_t*>(dout),
                                  static_cast<uint16_t*>(dx), dgamma, dbeta,
                                  dw1, db1, dw2, db2, sc, part_w, S,
                                  static_cast<cudaStream_t>(stream)));
}
