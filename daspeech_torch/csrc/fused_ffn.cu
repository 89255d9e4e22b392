// The Conformer macaron FFN, forward and backward, for Hopper (sm_90a), fp32:
//   out = dropout2(swish(LN(x) W1^T + b1) * m1 W2^T + b2)
// with LN's eps 1e-6, W1 = w_1.weight [F, C] and W2 = w_2.weight [C, F]
// (nn.Linear's layout, read in place).
//
// Replaces the Pallas kernels of daspeech_tpu/ops/fused_ffn.py:175
// fused_ffn (forward _ffn_fwd_kernel, :59; backward _ffn_bwd_kernel, :84).
// The TPU kernel runs one batch row per program with the whole [T, F]
// intermediate in VMEM and carries dW across its sequential grid; here:
//
// Forward (ffn_fwd_kernel): a block owns BM = 64 rows of the [B*T, C] input.
// It normalizes them into shared memory, then walks F in chunks of FC = 64:
// pre = y W1[f0:f0+FC]^T (the first product, K = C, weights staged in K
// slices), then + b1, swish and mask 1 in shared memory, then
// acc += h W2[:, f0:f0+FC]^T into a [BM, C] accumulator held in registers
// (8 x 8 per thread). The [T, F] intermediate never leaves the block. The
// epilogue adds b2, applies mask 2 and writes the rows.
//
// Backward, three launches, no atomics (two runs give the same bits):
//  1. ffn_bwd_rows_kernel, row-tiled as the forward: recomputes y, pre and
//     the masks; per F chunk gh = g W2 (g = dout * m2) beside pre in one K
//     loop, gpre = gh * m1 * swish'(pre), and gy += gpre W1 (registers);
//     the epilogue runs LayerNorm's backward into dx. It writes y, g, h * m1
//     and gpre to scratch ([N, C] and [N, F]) for the weight gradients, and
//     each block's column sums (db1, db2, dgamma, dbeta) to partial rows.
//  2. ffn_wgrad_kernel: dW1 = gpre^T y and dW2 = g^T (h * m1), each a
//     [64 x 64] output tile per block over one of S fixed slices of the
//     N rows, into per-slice partial sums. The TPU's per-row dW products
//     contracted over only K = T' (~120) and lost to XLA's one big product
//     (daspeech_tpu/models/conformer.py:325-330); here every tile contracts
//     over N / S rows (~1000).
//  3. ffn_reduce_kernel adds the partial sums in a fixed order.
// Writing the [N, F] intermediates in the backward (2 x 78.6 MB at the
// training shape, N = 9600, F = 2048) costs ~0.05 ms of bandwidth and
// spares recomputing both first products in a dW kernel.
//
// What bounds it on this card: operations. At N = 9600, C = 256, F = 2048
// the forward is 2 products, 20.1 GFLOP (0.30 ms at 67 TFLOP/s fp32), against
// 20 MB of x, weights and output; the backward 5 products, 50 GFLOP. The
// products are SIMT fp32 FMAs on register tiles fed from shared memory
// (4 x 4 per thread for the [64 x 64] tiles, 8 x 8 for [64 x 256]); tensor
// cores (TF32 or bf16 wgmma) are where speed would come from.
//
// Dropout (philox.cuh): element (t, j) of batch row b at site s (1: after
// the swish, width F; 2: after the second product, width C) is kept when
// word j % 4 of philox4x32_10((j / 4, t, 0, s), (seed[b], 0)) <= thresh,
// then scaled by 1 / keep_p; ops/philox.py ffn_keep draws the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using namespace daspeech;

constexpr int C = 256;      // model width the kernels are built for
constexpr int NT = 256;     // threads per block (one per channel)
constexpr int BM = 64;      // rows per block
constexpr int FC = 64;      // F columns per chunk
constexpr int KT = 32;      // K slice of the products over C
constexpr int KF = 16;      // K slice of the products over F
constexpr int YP = C + 4;   // row pitch of [BM, C] tiles (16-byte rows)
constexpr int HP = FC + 4;  // row pitch of [BM, FC] tiles
constexpr int WP = FC + 1;  // row pitch of [KT, FC] weight slices
constexpr int CP = C + 1;   // row pitch of [KF, C] weight slices
constexpr int STAGE = (2 * KT * WP > KF * CP) ? 2 * KT * WP : KF * CP;
constexpr float kEps = 1e-6f;
static_assert(NT == C, "column sums give each thread one channel");

struct FfnArgs {
  const float *x, *gamma, *beta, *w1, *b1, *w2, *b2;
  const uint32_t* seeds;  // [B] per-row Philox keys, or nullptr
  int drop1, drop2;       // sites on
  uint32_t thresh1, thresh2;
  float scale1, scale2;
  int N, T, F;            // N = B * T rows
};

struct FfnScratch {
  float *y, *g;           // [N, C]: LN output, dout * m2
  float *hd, *gpre;       // [N, F]: swish(pre) * m1, its pre-activation grad
  float* part;            // [ntiles, F + 3C]: db1 | db2 | dgamma | dbeta
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

// LayerNorm of rows n0 .. n0 + BM into Ys (0 for rows >= N), one warp a row;
// each row's mean and 1/std into mu, rs; with y_out, y is also written there
__device__ void layer_norm_tile(const FfnArgs& a, int n0, float (*Ys)[YP],
                                float* mu, float* rs, float* y_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += NT / 32) {
    const int n = n0 + r;
    float v[C / 32];
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      v[t] = n < a.N ? a.x[static_cast<long long>(n) * C + lane + 32 * t] : 0.f;
      s += v[t];
    }
    const float mean = warp_sum(s) * (1.f / C);
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      const float d = v[t] - mean;
      q = fmaf(d, d, q);
    }
    const float rstd = rsqrtf(warp_sum(q) * (1.f / C) + kEps);
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      const int c = lane + 32 * t;
      const float y =
          n < a.N ? fmaf((v[t] - mean) * rstd, a.gamma[c], a.beta[c]) : 0.f;
      Ys[r][c] = y;
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

// stage W1[f0 + f, k0 + kk] as W1s[kk][f] (0 beyond F)
__device__ __forceinline__ void stage_w1t(const FfnArgs& a, int f0, int k0,
                                          float (*W1s)[WP]) {
  for (int idx = threadIdx.x; idx < KT * FC; idx += NT) {
    const int kk = idx % KT, f = idx / KT;
    W1s[kk][f] = (f0 + f < a.F)
                     ? a.w1[static_cast<long long>(f0 + f) * C + k0 + kk]
                     : 0.f;
  }
}

// stage W2[k0 + kk, f0 + f] as W2s[kk][f] (0 beyond F)
__device__ __forceinline__ void stage_w2(const FfnArgs& a, int f0, int k0,
                                         float (*W2s)[WP]) {
  for (int idx = threadIdx.x; idx < KT * FC; idx += NT) {
    const int f = idx % FC, kk = idx / FC;
    W2s[kk][f] = (f0 + f < a.F)
                     ? a.w2[static_cast<long long>(k0 + kk) * a.F + f0 + f]
                     : 0.f;
  }
}

// acc[BM, C] (8 x 8 a thread: rows ty + 8i, columns tx + 32j) +=
// As[BM, f0 .. f0 + FC] Wk[FC, C], with Wk[f][c] = w[c * ldc + f0 + f]
// (w2: the forward's second product) or w[(f0 + f) * C + c] (w1: gy)
template <bool W_IS_W1>
__device__ __forceinline__ void chunk_times_w(const FfnArgs& a, int f0,
                                              float (*As)[HP],
                                              float (*Ws)[CP],
                                              float (&acc)[8][8]) {
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  for (int k0 = 0; k0 < FC; k0 += KF) {
    for (int idx = tid; idx < KF * C; idx += NT) {
      int kk, c;
      if (W_IS_W1) {
        c = idx % C;
        kk = idx / C;
      } else {
        kk = idx % KF;
        c = idx / KF;
      }
      const int f = f0 + k0 + kk;
      float w = 0.f;
      if (f < a.F) {
        w = W_IS_W1 ? a.w1[static_cast<long long>(f) * C + c]
                    : a.w2[static_cast<long long>(c) * a.F + f];
      }
      Ws[kk][c] = w;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KF; ++kk) {
      float hv[8], wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) hv[i] = As[ty + 8 * i][k0 + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = Ws[kk][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT) ffn_fwd_kernel(const FfnArgs a,
                                                     float* out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float(*Ys)[YP] = reinterpret_cast<float(*)[YP]>(smem);
  float(*Hs)[HP] = reinterpret_cast<float(*)[HP]>(smem + BM * YP);
  float* stage = smem + BM * YP + BM * HP;
  float* mu = stage + STAGE;
  float* rs = mu + BM;
  float(*W1s)[WP] = reinterpret_cast<float(*)[WP]>(stage);
  float(*W2s)[CP] = reinterpret_cast<float(*)[CP]>(stage);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BM;
  layer_norm_tile(a, n0, Ys, mu, rs, nullptr);
  __syncthreads();

  const int ty1 = tid / 16, tx1 = tid % 16;   // first product: 4 x 4
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int f0 = 0; f0 < a.F; f0 += FC) {
    float pre[4][4] = {};
    for (int k0 = 0; k0 < C; k0 += KT) {
      stage_w1t(a, f0, k0, W1s);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KT; ++kk) {
        float yv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = Ys[ty1 + 16 * i][k0 + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = W1s[kk][tx1 + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) pre[i][j] = fmaf(yv[i], wv[j], pre[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) Hs[ty1 + 16 * i][tx1 + 16 * j] = pre[i][j];
    }
    __syncthreads();
    // + b1, swish, mask 1, four columns (one Philox draw) a step
    for (int g = tid; g < BM * FC / 4; g += NT) {
      const int r = g / (FC / 4), q = g % (FC / 4), n = n0 + r;
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (a.drop1 && n < a.N) bits = site_bits(a, n, f0 / 4 + q, 1u);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = f0 + 4 * q + u;
        float h = 0.f;
        if (f < a.F && n < a.N) {
          const float p = Hs[r][4 * q + u] + a.b1[f];
          h = p / (1.f + expf(-p));
          if (a.drop1) h *= keep(philox_word(bits, u), a.thresh1, a.scale1);
        }
        Hs[r][4 * q + u] = h;
      }
    }
    __syncthreads();
    chunk_times_w<false>(a, f0, Hs, W2s, acc);
  }

  // epilogue: + b2 into Ys, then mask 2 and the store, four columns a step
  const int ty = tid / 32, tx = tid % 32;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Ys[ty + 8 * i][tx + 32 * j] = acc[i][j] + a.b2[tx + 32 * j];
    }
  }
  __syncthreads();
  for (int g = tid; g < BM * C / 4; g += NT) {
    const int r = g / (C / 4), q = g % (C / 4), n = n0 + r;
    if (n >= a.N) continue;
    float4 o = *reinterpret_cast<const float4*>(&Ys[r][4 * q]);
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
}

__global__ void __launch_bounds__(NT)
    ffn_bwd_rows_kernel(const FfnArgs a, const float* dout, float* dx,
                        const FfnScratch sc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float(*Ys)[YP] = reinterpret_cast<float(*)[YP]>(smem);
  float(*Gs)[YP] = reinterpret_cast<float(*)[YP]>(smem + BM * YP);
  float(*Hs)[HP] = reinterpret_cast<float(*)[HP]>(smem + 2 * BM * YP);
  float(*Ps)[HP] = reinterpret_cast<float(*)[HP]>(smem + 2 * BM * YP +
                                                   BM * HP);
  float* stage = smem + 2 * BM * YP + 2 * BM * HP;
  float* mu = stage + STAGE;
  float* rs = mu + BM;
  float(*W1s)[WP] = reinterpret_cast<float(*)[WP]>(stage);
  float(*W2s)[WP] = reinterpret_cast<float(*)[WP]>(stage + KT * WP);
  float(*Wn)[CP] = reinterpret_cast<float(*)[CP]>(stage);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BM;
  const int width = a.F + 3 * C;
  float* part = sc.part + static_cast<long long>(blockIdx.x) * width;

  layer_norm_tile(a, n0, Ys, mu, rs, sc.y);
  // g = dout * m2 into Gs (0 for rows >= N), and to scratch
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
      *reinterpret_cast<float4*>(sc.g + static_cast<long long>(n) * C +
                                 4 * q) = v;
    }
    *reinterpret_cast<float4*>(&Gs[r][4 * q]) = v;
  }
  __syncthreads();
  {
    float s = 0.f;
    for (int r = 0; r < BM; ++r) s += Gs[r][tid];
    part[a.F + tid] = s;                               // db2
  }

  const int ty1 = tid / 16, tx1 = tid % 16;
  float acc[8][8];   // gy
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int f0 = 0; f0 < a.F; f0 += FC) {
    // pre = y W1^T and gh = g W2 over the chunk, one K loop
    float pre[4][4] = {}, gh[4][4] = {};
    for (int k0 = 0; k0 < C; k0 += KT) {
      stage_w1t(a, f0, k0, W1s);
      stage_w2(a, f0, k0, W2s);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        float yv[4], gv[4], w1v[4], w2v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          yv[i] = Ys[ty1 + 16 * i][k0 + kk];
          gv[i] = Gs[ty1 + 16 * i][k0 + kk];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w1v[j] = W1s[kk][tx1 + 16 * j];
          w2v[j] = W2s[kk][tx1 + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pre[i][j] = fmaf(yv[i], w1v[j], pre[i][j]);
            gh[i][j] = fmaf(gv[i], w2v[j], gh[i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Hs[ty1 + 16 * i][tx1 + 16 * j] = pre[i][j];
        Ps[ty1 + 16 * i][tx1 + 16 * j] = gh[i][j];
      }
    }
    __syncthreads();
    // swish and its derivative, mask 1: h * m1 and gpre to scratch, gpre
    // into Ps
    for (int g = tid; g < BM * FC / 4; g += NT) {
      const int r = g / (FC / 4), q = g % (FC / 4), n = n0 + r;
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (a.drop1 && n < a.N) bits = site_bits(a, n, f0 / 4 + q, 1u);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = f0 + 4 * q + u;
        float gp = 0.f;
        if (f < a.F && n < a.N) {
          const float p = Hs[r][4 * q + u] + a.b1[f];
          const float s = 1.f / (1.f + expf(-p));
          const float z =
              a.drop1 ? keep(philox_word(bits, u), a.thresh1, a.scale1) : 1.f;
          gp = Ps[r][4 * q + u] * z * (s * (1.f + p * (1.f - s)));
          const long long o = static_cast<long long>(n) * a.F + f;
          sc.hd[o] = p * s * z;
          sc.gpre[o] = gp;
        }
        Ps[r][4 * q + u] = gp;
      }
    }
    __syncthreads();
    if (tid < FC && f0 + tid < a.F) {                  // db1
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += Ps[r][tid];
      part[f0 + tid] = s;
    }
    chunk_times_w<true>(a, f0, Ps, Wn, acc);           // gy += gpre W1
  }

  // epilogue: gy into Ys; LayerNorm's backward a row a warp, xhat into Gs
  const int ty = tid / 32, tx = tid % 32;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) Ys[ty + 8 * i][tx + 32 * j] = acc[i][j];
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BM; r += NT / 32) {
    const int n = n0 + r;
    float xh[C / 32], dxh[C / 32];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      const int c = lane + 32 * t;
      xh[t] = n < a.N
                  ? (a.x[static_cast<long long>(n) * C + c] - mu[r]) * rs[r]
                  : 0.f;
      dxh[t] = Ys[r][c] * a.gamma[c];
      s1 += dxh[t];
      s2 = fmaf(dxh[t], xh[t], s2);
      Gs[r][c] = xh[t];
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
  __syncthreads();
  float sg = 0.f, sb = 0.f;
  for (int r = 0; r < BM; ++r) {
    sg = fmaf(Ys[r][tid], Gs[r][tid], sg);
    sb += Ys[r][tid];
  }
  part[a.F + C + tid] = sg;                            // dgamma
  part[a.F + 2 * C + tid] = sb;                        // dbeta
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
};

__global__ void __launch_bounds__(NT) ffn_wgrad_kernel(const WgradArgs a) {
  constexpr int TM = 64, TK = 16;
  const WgradJob jb = (blockIdx.z & 1) ? a.job[1] : a.job[0];
  const int s = blockIdx.z >> 1;
  const int tiles_p = (jb.P + TM - 1) / TM;
  const int m0 = (blockIdx.x / tiles_p) * TM, p0 = (blockIdx.x % tiles_p) * TM;
  const int nb = s * a.rows, ne = min(a.N, nb + a.rows);
  __shared__ float As[TK][TM];
  __shared__ float Bs[TK][TM];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int n = nb; n < ne; n += TK) {
    for (int idx = tid; idx < TK * TM; idx += NT) {
      const int kk = idx / TM, c = idx % TM;
      const bool row = n + kk < ne;
      As[kk][c] = (row && m0 + c < jb.M)
                      ? jb.A[static_cast<long long>(n + kk) * jb.M + m0 + c]
                      : 0.f;
      Bs[kk][c] = (row && p0 + c < jb.P)
                      ? jb.Bm[static_cast<long long>(n + kk) * jb.P + p0 + c]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* out = jb.part + static_cast<long long>(s) * jb.M * jb.P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx + 16 * j;
      if (m < jb.M && p < jb.P) {
        out[static_cast<long long>(m) * jb.P + p] = acc[i][j];
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
  float s = 0.f;
  for (int k = 0; k < jb.S; ++k) s += jb.part[k * jb.stride + i];
  jb.out[i] = s;
}

constexpr size_t kFwdSmem = sizeof(float) * (BM * YP + BM * HP + STAGE +
                                             2 * BM);
constexpr size_t kBwdSmem = sizeof(float) * (2 * BM * YP + 2 * BM * HP +
                                             STAGE + 2 * BM);

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
  return a;
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
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_fwd_kernel<<<(a.N + BM - 1) / BM, NT, kFwdSmem,
                   static_cast<cudaStream_t>(stream)>>>(a, out);
  return static_cast<int>(cudaGetLastError());
}

// scratch: y, g [N, C]; hd, gpre [N, F]; part_rows [ceil(N / 64), F + 3C];
// part_w [2, S, F * C] (the S row slices of dW1, then of dW2)
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FfnArgs a = ffn_args(x, gamma, beta, w1, b1, w2, b2, seeds, drop1,
                             thresh1, scale1, drop2, thresh2, scale2, B, T,
                             F);
  const int ntiles = (a.N + BM - 1) / BM;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_bwd_rows_kernel<<<ntiles, NT, kBwdSmem, st>>>(
      a, dout, dx, FfnScratch{y, g, hd, gpre, part_rows});
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const long long FC_ = static_cast<long long>(F) * C;
  WgradArgs w;
  w.job[0] = {gpre, y, part_w, F, C};
  w.job[1] = {g, hd, part_w + S * FC_, C, F};
  w.N = a.N;
  w.rows = (a.N + S - 1) / S;
  const int tiles = ((F + 63) / 64) * ((C + 63) / 64);
  ffn_wgrad_kernel<<<dim3(tiles, 1, 2 * S), NT, 0, st>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

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
  return static_cast<int>(cudaGetLastError());
}
