// Tensor-core fp32 attention for Hopper (sm_90a), head depth 64, Philox
// dropout: the backward, and the forward where no softmax statistics are
// asked for (inference), of every attention entry point. The packed and
// head-major attention (fused_attention.cu; a [B, Tk] column bias) run the
// kernels described first; the full-bias attention (fused_attention.cu; a
// [B, H, Tq, Tk] bias that receives a gradient) and the Conformer rel-pos
// attention (fused_relpos.cu; a 64 + 256-deep score) the chunked-score
// kernels at the end ("Chunked score depth"). The training forward of all
// four stays on the fp32 FMA pipes (attention_fma.cuh); see "Accumulation"
// for why. The argument structs (AttnArgs, AttnBwdArgs) and the cp.async
// helpers are attention.cuh's; the fragment and tile-product helpers this
// comment describes are tiles.cuh's.
//
// Precision: fp32 in and out; every matrix product runs on the tensor
// cores as 3xTF32. No bf16 entry point runs these kernels: the packed,
// head-major and full-bias ones run attention_bf16.cuh's bf16 kernels, the
// rel-pos ones relpos_bf16.cuh's. Their loads still take a bf16 view,
// widened to fp32 as it is loaded and rounded as it is stored
// (attention.cuh, "Element type"), which no caller reaches; on such
// operands the lo terms of the split would be 0 (a bf16 value is a TF32
// value), three mma.sync for one's worth.
// Each operand x is split into hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi), and a·b is taken as lo·hi + hi·lo + hi·hi
// (the small terms first), each an mma.sync m16n8k8 tf32 with fp32
// accumulation. The dropped lo·lo term and the rounding of lo leave about
// 2^-21 of relative error per product, fp32's order (plain 1xTF32 leaves
// 2^-11, which the 1e-4 bar against the plain version cannot absorb;
// tests/test_torch_tf32_split.py holds the choice). Softmax, its
// statistics, the bias and dropout stay in fp32 on the CUDA cores.
//
// Why mma.sync and not wgmma: tf32 wgmma reads both operands K-major from
// shared memory, which would need transposed copies of V (for P·V), of K
// (for dS·K) and of Q and dO in the backward; mma.sync takes A from
// registers, so P and dS feed the next product where they were computed.
// It is the instruction shape SDPA's memory-efficient fp32 kernel uses.
//
// Fragment layouts (m16n8k8, tf32; gid = lane / 4, t = lane % 4):
//   A 16x8:  a0 (gid, t)  a1 (gid+8, t)  a2 (gid, t+4)  a3 (gid+8, t+4)
//   B 8x8:   b0 (k=t, n=gid)  b1 (k=t+4, n=gid)
//   C 16x8:  c0 (gid, 2t)  c1 (gid, 2t+1)  c2 (gid+8, 2t)  c3 (gid+8, 2t+1)
// The accumulator's columns (2t, 2t+1) are not the A operand's (t, t+4). A
// product sums over k in any order, so when an accumulator (P, dS) becomes
// the A operand of the next product its k slots are relabelled instead of
// shuffled: slot t holds column 2t and slot t+4 column 2t+1, and the B
// operand reads the rows 2t and 2t+1 of its tile (mma_cols).
//
// Accumulation: the tensor cores' fp32 accumulation truncates rather than
// rounding each sum to nearest, so a product that chains all 24 MMAs of a
// 64-deep contraction (8 k-steps x 3) into one accumulator gathers an
// error biased toward zero that fp32 rounding would not. Every product
// here sums kGroup = 4 k-steps in a fresh accumulator and folds them into
// the result with an fp32 add: that halves dq's error against the plain
// version (the largest, |dq| up to ~20 at the training shapes) and keeps
// the kernels within 255 registers without spills
// (tools/torch_attention_accumulation.py measures it against the group
// size). The bias that remains is harmless in the backward, whose errors
// scale with the gradients they sit in, but not in a training forward:
// its output's coherent error moves gradients that are sums over the
// whole batch (FastSpeech 2's positional-embedding scale in the joint
// step's card-vs-CPU check) ten times past the fp32 noise, where the SIMT
// forward stays at it. So training runs an fp32 FMA forward, which writes
// the statistics this backward reads, and inference, where each output
// only has to match to 1e-4, runs this one.
//
// Shared-memory tiles are [64 rows][68 floats]. The pitch of 68 makes both
// reads conflict-free: mma_rows reads T[n = gid][k = t] (bank 4 gid + t),
// mma_cols reads T[k = 2t][n = gid] (bank 8 t + gid), and rows stay 16-byte
// aligned for cp.async.
//
// Forward (inference: no statistics): one block per (64-query tile, head,
// batch row), four warps of 16 query rows; each warp keeps its Q fragments
// in registers. 64-key tiles of
// K, V and the bias stream through dynamic shared memory by cp.async,
// double-buffered (the next tile's copy overlaps this tile's products).
// S = Q·Kᵀ, then the online softmax on the accumulator fragments (a row
// lives in the four threads of a quad: two quad shuffles per row and tile
// for the max; the sum stays per thread until the end), then O += P·V.
//
// Backward, two kernels and no atomics (the gradients are bit-identical
// from run to run): the dq kernel (one block per query tile; Q and dO tiles
// in shared memory) writes delta = rowsum(dO∘O), computes S and dP = dO·Vᵀ
// per key tile, dS = P∘(Z∘dP − delta), and dQ += dS·K; the dk/dv kernel
// (one block per 64-key tile; its K and V rows in shared memory) streams
// query tiles with their statistics and delta, computes Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ, then dV += (P∘Z)ᵀ·dO and dK += dSᵀ·Q. P is recomputed from
// the statistics the training forward saved.
//
// Dropout draws the bits the training forwards draw: word (j % 4) of
// philox4x32_10((j / 4, i, h, 0), (seed[b], 0)) for query i, key j. In the
// forward and dq kernels a quad's threads t = 0, 1 share one 4-key group of
// a row and t = 2, 3 the next: each thread draws one (row, group) per 8-key
// block and the pair swaps its keep bits by one shuffle. In the dk/dv
// kernel keys lie along the rows and a 4-key group spans four gid lanes:
// each of those lanes draws one of the four (group, query) pairs they need,
// and two shuffles gather the keep bits.
//
// Ragged tiles: keys past Tk are zero-filled by cp.async and get score
// -inf; query rows past Tq are zero-filled, get P = 0 and are never stored.
// A fully padded row (bias -1e30 on every key) rounds every score to
// -1e30, so its max is -1e30 and its probabilities uniform, as in the plain
// version.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "philox.cuh"
#include "tiles.cuh"

namespace daspeech {
namespace tc {
// internal linkage: fused_attention.cu and fused_relpos.cu each include
// this header, and a kernel with external linkage would be defined twice
namespace {

// ---------------------------------------------------------------- forward

// dynamic shared memory: two stages of [K tile, V tile, 64 biases]
constexpr int kFwdStage = 2 * kTile + kRows;
constexpr int kFwdSmem = 2 * kFwdStage * 4;

__device__ __forceinline__ void load_kv_stage(float* st, const AttnArgs& f,
                                              int b, int h, int j0) {
  load_tile(st, f.k, b, h, j0, f.Tk);
  load_tile(st + kTile, f.v, b, h, j0, f.Tk);
  if (threadIdx.x < kRows) {
    const int j = j0 + threadIdx.x;
    const bool ok = j < f.Tk;
    cp_async<4>(st + 2 * kTile + threadIdx.x,
                f.bias + b * f.bias_sb + (ok ? j : 0), ok);
  }
}

// in place, the forward fits three blocks an SM in registers (168 each);
// grouped, two (it needs more than 168)
__global__ void __launch_bounds__(kThreads, kGroup == 0 ? 3 : 2)
attn_tc_fwd_kernel(const AttnArgs args) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ia = blockIdx.x * kRows + warp * 16 + gid;   // rows ia, ia + 8
  const bool drop = args.drop.seeds != nullptr;
  const uint32_t seed = drop ? args.drop.seeds[b] : 0u;

  load_kv_stage(smem, args, b, h, 0);
  cp_async_commit();

  float qf[8][4];   // this warp's Q fragments, fp32
  {
    const bool ok0 = ia < args.Tq, ok1 = ia + 8 < args.Tq;
    const int i0 = ok0 ? ia : 0, i1 = ok1 ? ia + 8 : 0;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      qf[kk][0] = ok0 ? ld1(args.q, b, i0, h, kk * 8 + t) : 0.f;
      qf[kk][1] = ok1 ? ld1(args.q, b, i1, h, kk * 8 + t) : 0.f;
      qf[kk][2] = ok0 ? ld1(args.q, b, i0, h, kk * 8 + t + 4) : 0.f;
      qf[kk][3] = ok1 ? ld1(args.q, b, i1, h, kk * 8 + t + 4) : 0.f;
    }
  }

  float o[8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int ntiles = (args.Tk + kRows - 1) / kRows;
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) {
      load_kv_stage(smem + ((it + 1) & 1) * kFwdStage, args, b, h,
                    j0 + kRows);
      cp_async_commit();
    }
    const float* Ks = smem + (it & 1) * kFwdStage;
    const float* Vs = Ks + kTile;
    const float* Bs = Ks + 2 * kTile;

    float s[8][4];
    zero(s);
    mma_rows<kGroup>(s, [&](int kk, float a[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
    }, Ks, gid, t);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int jj = n * 8 + 2 * t;
      const float2 bias = *reinterpret_cast<const float2*>(Bs + jj);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        const float sc = (j0 + jj + c < args.Tk)
                             ? s[n][e] * args.scale + (c ? bias.y : bias.x)
                             : -INFINITY;
        s[n][e] = sc;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds a valid key, so the new max is finite
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      l[r] *= corr[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
      uint2 bits = make_uint2(0u, 0u);
      if (drop) bits = row_keep_bits(args.drop, seed, ia, j0 + n * 8, h, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[n][e] = !drop ? p
                  : row_keep(bits, e >> 1, e & 1, t) ? p * args.drop.scale
                                                     : 0.f;
      }
    }
    mma_cols<kGroup>(o, s, Vs, gid, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = ia + 8 * r;
    if (i >= args.Tq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      st2(args.o, b, i, h, n * 8 + 2 * t, o[n][2 * r] * inv,
          o[n][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- dq

// dynamic shared memory: Q and dO tiles, then two stages of [K, V, biases]
constexpr int kDqSmem = (2 * kTile + 2 * kFwdStage) * 4;

__global__ void __launch_bounds__(kThreads, 2)
attn_tc_bwd_dq_kernel(const AttnBwdArgs args) {
  extern __shared__ __align__(16) float smem[];
  const AttnArgs& f = args.f;
  float* Qs = smem;
  float* dOs = smem + kTile;
  float* stages = smem + 2 * kTile;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const int ia = i0 + warp * 16 + gid;
  const bool drop = f.drop.seeds != nullptr;
  const uint32_t seed = drop ? f.drop.seeds[b] : 0u;
  const long long stat0 = (static_cast<long long>(b) * f.H + h) * f.Tq;

  load_tile(Qs, f.q, b, h, i0, f.Tq);
  load_tile(dOs, args.dout, b, h, i0, f.Tq);
  load_kv_stage(stages, f, b, h, 0);
  cp_async_commit();

  // delta = rowsum(dO∘O) while the copies fly: lanes 2r, 2r + 1 take row r
  // of the warp's 16, 32 channels each
  float delta[2], rmax[2], rinv[2];
  {
    const int i = i0 + warp * 16 + (lane >> 1);
    const int c0 = (lane & 1) * 32;
    float acc = 0.f;
    if (i < f.Tq) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 x = ld4(args.dout, b, i, h, c0 + 4 * u);
        const float4 y = ld4(f.o, b, i, h, c0 + 4 * u);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (i < f.Tq && (lane & 1) == 0) args.delta[stat0 + i] = acc;
    delta[0] = __shfl_sync(0xffffffffu, acc, 2 * gid);
    delta[1] = __shfl_sync(0xffffffffu, acc, 2 * gid + 16);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ir = ia + 8 * r;
      rmax[r] = ir < f.Tq ? f.stats[2 * (stat0 + ir)] : 0.f;
      rinv[r] = ir < f.Tq ? 1.f / f.stats[2 * (stat0 + ir) + 1] : 0.f;
    }
  }

  const float* Aq = Qs + warp * 16 * kPitch;
  const float* Ad = dOs + warp * 16 * kPitch;
  float dq[8][4];
  zero(dq);
  const int ntiles = (f.Tk + kRows - 1) / kRows;
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) {
      load_kv_stage(stages + ((it + 1) & 1) * kFwdStage, f, b, h, j0 + kRows);
      cp_async_commit();
    }
    const float* Ks = stages + (it & 1) * kFwdStage;
    const float* Vs = Ks + kTile;
    const float* Bs = Ks + 2 * kTile;

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_rows<kGroup>(
        s, [&](int kk, float a[4]) { a_from_rows(Aq, kk, gid, t, a); }, Ks,
        gid, t);
    mma_rows<kGroup>(
        dp, [&](int kk, float a[4]) { a_from_rows(Ad, kk, gid, t, a); }, Vs,
        gid, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int jj = n * 8 + 2 * t;
      const float2 bias = *reinterpret_cast<const float2*>(Bs + jj);
      uint2 bits = make_uint2(0u, 0u);
      if (drop) bits = row_keep_bits(f.drop, seed, ia, j0 + n * 8, h, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = e & 1;
        const float p =
            (j0 + jj + c < f.Tk)
                ? expf(s[n][e] * f.scale + (c ? bias.y : bias.x) - rmax[r]) *
                      rinv[r]
                : 0.f;
        const float z = !drop ? 1.f
                        : row_keep(bits, r, c, t) ? f.drop.scale
                                                  : 0.f;
        s[n][e] = p * (z * dp[n][e] - delta[r]);   // dS
      }
    }
    mma_cols<kGroup>(dq, s, Ks, gid, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = ia + 8 * r;
    if (i >= f.Tq) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      st2(args.dq, b, i, h, n * 8 + 2 * t, dq[n][2 * r] * f.scale,
          dq[n][2 * r + 1] * f.scale);
    }
  }
}

// ---------------------------------------------------------------- dk/dv

// dynamic shared memory: the block's K and V tiles, then two stages of
// [Q tile, dO tile, 64 (max, sum) pairs, 64 deltas]
constexpr int kKvStage = 2 * kTile + 3 * kRows;
constexpr int kDkvSmem = (2 * kTile + 2 * kKvStage) * 4;

__device__ __forceinline__ void load_q_stage(float* st,
                                             const AttnBwdArgs& args, int b,
                                             int h, int i0) {
  const AttnArgs& f = args.f;
  load_tile(st, f.q, b, h, i0, f.Tq);
  load_tile(st + kTile, args.dout, b, h, i0, f.Tq);
  const long long stat0 = (static_cast<long long>(b) * f.H + h) * f.Tq;
  const int x = threadIdx.x % kRows, i = i0 + x;
  const bool ok = i < f.Tq;
  const long long si = stat0 + (ok ? i : 0);
  if (threadIdx.x < kRows) {
    cp_async<8>(st + 2 * kTile + 2 * x, f.stats + 2 * si, ok);
  } else {
    cp_async<4>(st + 2 * kTile + 2 * kRows + x, args.delta + si, ok);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
attn_tc_bwd_dkdv_kernel(const AttnBwdArgs args) {
  extern __shared__ __align__(16) float smem[];
  const AttnArgs& f = args.f;
  float* Ks = smem;
  float* Vs = smem + kTile;
  float* stages = smem + 2 * kTile;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kRows;
  const int ja = k0 + warp * 16 + gid;   // this thread's keys ja, ja + 8
  const bool drop = f.drop.seeds != nullptr;
  const uint32_t seed = drop ? f.drop.seeds[b] : 0u;

  load_tile(Ks, f.k, b, h, k0, f.Tk);
  load_tile(Vs, f.v, b, h, k0, f.Tk);
  load_q_stage(stages, args, b, h, 0);
  cp_async_commit();

  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = ja + 8 * r;
    bias[r] = j < f.Tk ? f.bias[b * f.bias_sb + j] : 0.f;
  }
  // dropout: the lanes of one t with gid = 4 g + w (w = 0..3) share their
  // draws; lane w draws (key group of half w / 2, query 2t + w % 2)
  const int w = gid & 3;
  const int group = (k0 + warp * 16) / 4 + (gid >> 2) + 2 * (w >> 1);

  const float* Ak = Ks + warp * 16 * kPitch;
  const float* Av = Vs + warp * 16 * kPitch;
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  const int ntiles = (f.Tq + kRows - 1) / kRows;
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = it * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) {
      load_q_stage(stages + ((it + 1) & 1) * kKvStage, args, b, h,
                   i0 + kRows);
      cp_async_commit();
    }
    const float* Qs = stages + (it & 1) * kKvStage;
    const float* dOs = Qs + kTile;
    const float* Ml = Qs + 2 * kTile;           // (max, sum) per query
    const float* Dl = Ml + 2 * kRows;           // delta per query

    float st[8][4], dpt[8][4];   // Sᵀ and dPᵀ: rows keys, columns queries
    zero(st);
    zero(dpt);
    mma_rows<kGroup>(
        st, [&](int kk, float a[4]) { a_from_rows(Ak, kk, gid, t, a); }, Qs,
        gid, t);
    mma_rows<kGroup>(
        dpt, [&](int kk, float a[4]) { a_from_rows(Av, kk, gid, t, a); }, dOs,
        gid, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bits = 0u;
      if (drop) {
        const int q = i0 + n * 8 + 2 * t + (w & 1);
        bits = keep4(philox4x32_10(make_uint4(group, q, h, 0u), seed, 0u),
                     f.drop.thresh)
               << (4 * w);
        bits |= __shfl_xor_sync(0xffffffffu, bits, 4);
        bits |= __shfl_xor_sync(0xffffffffu, bits, 8);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qq = n * 8 + 2 * t + c;
        const float2 ml = *reinterpret_cast<const float2*>(Ml + 2 * qq);
        const float rinv = (i0 + qq < f.Tq) ? 1.f / ml.y : 0.f;
        const float dl = Dl[qq];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float p = expf(st[n][e] * f.scale + bias[r] - ml.x) * rinv;
          const float z = !drop ? 1.f
                          : ((bits >> (4 * e + w)) & 1u) ? f.drop.scale
                                                         : 0.f;
          st[n][e] = p * z;
          dpt[n][e] = p * (z * dpt[n][e] - dl);
        }
      }
    }
    mma_cols<kGroup>(dv, st, dOs, gid, t);
    mma_cols<kGroup>(dk, dpt, Qs, gid, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = ja + 8 * r;
    if (j >= f.Tk) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      st2(args.dk, b, j, h, n * 8 + 2 * t, dk[n][2 * r] * f.scale,
          dk[n][2 * r + 1] * f.scale);
      st2(args.dv, b, j, h, n * 8 + 2 * t, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch

inline cudaError_t launch_attn_tc_fwd(const AttnArgs& args, int B,
                                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_tc_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFwdSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((args.Tq + kRows - 1) / kRows, args.H, B);
  attn_tc_fwd_kernel<<<grid, kThreads, kFwdSmem, stream>>>(args);
  return cudaGetLastError();
}

inline cudaError_t launch_attn_tc_bwd(const AttnBwdArgs& args, int B,
                                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_tc_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(attn_tc_bwd_dkdv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkvSmem);
  }
  if (err != cudaSuccess) return err;
  // the dq kernel writes delta, which the dk/dv kernel reads: same stream
  dim3 grid_q((args.f.Tq + kRows - 1) / kRows, args.f.H, B);
  attn_tc_bwd_dq_kernel<<<grid_q, kThreads, kDqSmem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_k((args.f.Tk + kRows - 1) / kRows, args.f.H, B);
  attn_tc_bwd_dkdv_kernel<<<grid_k, kThreads, kDkvSmem, stream>>>(args);
  return cudaGetLastError();
}

// ====================================================== chunked score depth
//
// The rel-pos (#5) and full-bias (#3) kernels. The score is a sum over NC
// chunk pairs of depth 64: s = (sum_c X_c · Y_cᵀ) · scale + bias, with
// (X_0, Y_0) = (q, k) and, for the rel-pos attention, (X_c, Y_c) = columns
// 64 (c - 1) .. of (a, e), c = 1 .. 4. Per key tile the block takes NC + 1
// steps, each one pair of 64 x 64 tiles streamed by cp.async into one of two
// stages: the NC score chunks, then the value step (the forward: V alone,
// for O += P·V; the backward: dO and V, for dP = dO·Vᵀ). The bias comes
// with the step at whose end the softmax is taken. The query side's tiles
// are re-read for every key tile (from L2), which keeps a stage at two
// tiles: a resident 64 x 320 query side and a 64 x 320 key side would not
// fit twice in one SM's shared memory.
//
// Backward, two launches and no atomics: the score kernel recomputes S and
// dP per key tile and writes dS = P∘(Z∘dP − delta) (the full bias's
// gradient) and P∘Z to [B, H, Tq, Tk] buffers, each element once; the
// gradient kernel then takes every gradient as a product with one of them,
// 64 output channels per block: dq = scale dS·k, da = scale dS·e,
// dk = scale dSᵀ·q, dv = (P∘Z)ᵀ·dO. This keeps the 320-deep score off the
// key side (no recomputed Sᵀ) and the 320 columns of [dq | da] out of one
// thread's registers.

// the [Tq, Tk] matrix of (b, h) in a contiguous [B, H, Tq, Tk] tensor
__device__ __forceinline__ long long matrix_at(const AttnArgs& f, int b,
                                               int h) {
  return (static_cast<long long>(b) * f.H + h) * f.Tq * f.Tk;
}

// a stage: the step's two tiles, then the bias (FULL: the [query tile, key
// tile] block of bias4; else the key tile's 64 column biases)
template <bool FULL>
constexpr int kChunkStage = 2 * kTile + (FULL ? kTile : kRows);

// step c of the key tile at j0 for the query tile at i0: c < NC loads
// score chunk c; c == NC the value step (the forward: V alone; BWD: dO and
// V). The bias comes with the forward's last score chunk and with the
// backward's value step.
template <int NC, bool FULL, bool BWD>
__device__ __forceinline__ void load_chunk_step(float* st, const AttnArgs& f,
                                                const Operand& dout, int b,
                                                int h, int i0, int j0,
                                                int c) {
  if (c < NC) {
    load_tile(st, c == 0 ? f.q : channels(f.a, 64 * (c - 1)), b, h, i0,
              f.Tq);
    load_tile(st + kTile, c == 0 ? f.k : channels(f.e, 64 * (c - 1)), b, h,
              j0, f.Tk);
  } else if (!BWD) {
    load_tile(st, f.v, b, h, j0, f.Tk);
  } else {
    load_tile(st, dout, b, h, i0, f.Tq);
    load_tile(st + kTile, f.v, b, h, j0, f.Tk);
  }
  if (c != (BWD ? NC : NC - 1)) return;
  float* bs = st + 2 * kTile;
  if constexpr (FULL) {
    load_matrix_tile(bs, f.bias4 + matrix_at(f, b, h), f.Tq, f.Tk, i0, j0);
  } else if (threadIdx.x < kRows) {
    const int j = j0 + threadIdx.x;
    const bool ok = j < f.Tk;
    cp_async<4>(bs + threadIdx.x, f.bias + b * f.bias_sb + (ok ? j : 0), ok);
  }
}

// the biases of keys jj, jj + 1 (of the tile) for the thread's row half r
template <bool FULL>
__device__ __forceinline__ float2 stage_bias(const float* bs, int wrow,
                                             int r, int jj) {
  return *reinterpret_cast<const float2*>(
      bs + (FULL ? (wrow + 8 * r) * kPitch : 0) + jj);
}

// ---------------------------------------------------------------- forward

template <int NC, bool FULL>
__global__ void __launch_bounds__(kThreads, 2)
attn_tc_chunk_fwd_kernel(const AttnArgs args) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = kChunkStage<FULL>;
  constexpr int S = NC + 1;                 // steps per key tile
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const int wrow = warp * 16 + gid;         // the thread's rows in a tile
  const int ia = i0 + wrow;                 // rows ia, ia + 8
  const bool drop = args.drop.seeds != nullptr;
  const uint32_t seed = drop ? args.drop.seeds[FULL ? 0 : b] : 0u;
  const uint32_t c3 = FULL ? static_cast<uint32_t>(b) : 0u;
  const int nsteps = (args.Tk + kRows - 1) / kRows * S;

  load_chunk_step<NC, FULL, false>(smem, args, args.v, b, h, i0, 0, 0);
  cp_async_commit();

  float s[8][4], o[8][4];
  zero(s);
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int st = 0; st < nsteps; ++st) {
    const int c = st % S, j0 = st / S * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < nsteps) {
      const int nx = st + 1;
      load_chunk_step<NC, FULL, false>(smem + (nx & 1) * kStage, args,
                                       args.v, b, h, i0, nx / S * kRows,
                                       nx % S);
      cp_async_commit();
    }
    const float* X = smem + (st & 1) * kStage;
    if (c == NC) {                          // O += P·V
      mma_cols<kGroup>(o, s, X, gid, t);
      continue;
    }
    if (c == 0) zero(s);
    const float* A = X + warp * 16 * kPitch;
    mma_rows<kGroup>(
        s, [&](int kk, float a[4]) { a_from_rows(A, kk, gid, t, a); },
        X + kTile, gid, t);
    if (c != NC - 1) continue;

    const float* Bs = X + 2 * kTile;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int jj = n * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 bias = stage_bias<FULL>(Bs, wrow, r, jj);
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int e = 2 * r + cc;
          const float sc = (j0 + jj + cc < args.Tk)
                               ? s[n][e] * args.scale + (cc ? bias.y : bias.x)
                               : -INFINITY;
          s[n][e] = sc;
          mx[r] = fmaxf(mx[r], sc);
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds a valid key, so the new max is finite
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      l[r] *= corr[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
      uint2 bits = make_uint2(0u, 0u);
      if (drop) {
        bits = row_keep_bits(args.drop, seed, ia, j0 + n * 8, h, t, c3);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[n][e] = !drop ? p
                  : row_keep(bits, e >> 1, e & 1, t) ? p * args.drop.scale
                                                     : 0.f;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = ia + 8 * r;
    if (i >= args.Tq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      st2(args.o, b, i, h, n * 8 + 2 * t, o[n][2 * r] * inv,
          o[n][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- dS

template <int NC, bool FULL>
__global__ void __launch_bounds__(kThreads, 2)
attn_tc_chunk_ds_kernel(const AttnBwdArgs args) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = kChunkStage<FULL>;
  constexpr int S = NC + 1;
  const AttnArgs& f = args.f;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const int wrow = warp * 16 + gid;
  const int ia = i0 + wrow;
  const bool drop = f.drop.seeds != nullptr;
  const uint32_t seed = drop ? f.drop.seeds[FULL ? 0 : b] : 0u;
  const uint32_t c3 = FULL ? static_cast<uint32_t>(b) : 0u;
  const long long stat0 = (static_cast<long long>(b) * f.H + h) * f.Tq;
  const long long mat0 = matrix_at(f, b, h);
  const int nsteps = (f.Tk + kRows - 1) / kRows * S;

  load_chunk_step<NC, FULL, true>(smem, f, args.dout, b, h, i0, 0, 0);
  cp_async_commit();

  // delta = rowsum(dO∘O) while the copies fly: lanes 2r, 2r + 1 take row r
  // of the warp's 16, 32 channels each
  float delta[2], rmax[2], rinv[2];
  {
    const int i = i0 + warp * 16 + (lane >> 1);
    const int c0 = (lane & 1) * 32;
    float acc = 0.f;
    if (i < f.Tq) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 x = ld4(args.dout, b, i, h, c0 + 4 * u);
        const float4 y = ld4(f.o, b, i, h, c0 + 4 * u);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (i < f.Tq && (lane & 1) == 0) args.delta[stat0 + i] = acc;
    delta[0] = __shfl_sync(0xffffffffu, acc, 2 * gid);
    delta[1] = __shfl_sync(0xffffffffu, acc, 2 * gid + 16);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ir = ia + 8 * r;
      rmax[r] = ir < f.Tq ? f.stats[2 * (stat0 + ir)] : 0.f;
      rinv[r] = ir < f.Tq ? 1.f / f.stats[2 * (stat0 + ir) + 1] : 0.f;
    }
  }

  float s[8][4], dp[8][4];
  zero(s);
  for (int st = 0; st < nsteps; ++st) {
    const int c = st % S, j0 = st / S * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < nsteps) {
      const int nx = st + 1;
      load_chunk_step<NC, FULL, true>(smem + (nx & 1) * kStage, f,
                                      args.dout, b, h, i0, nx / S * kRows,
                                      nx % S);
      cp_async_commit();
    }
    const float* X = smem + (st & 1) * kStage;
    const float* A = X + warp * 16 * kPitch;
    if (c < NC) {
      if (c == 0) zero(s);
      mma_rows<kGroup>(
          s, [&](int kk, float a[4]) { a_from_rows(A, kk, gid, t, a); },
          X + kTile, gid, t);
      continue;
    }
    zero(dp);
    mma_rows<kGroup>(
        dp, [&](int kk, float a[4]) { a_from_rows(A, kk, gid, t, a); },
        X + kTile, gid, t);
    const float* Bs = X + 2 * kTile;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int jj = n * 8 + 2 * t;
      uint2 bits = make_uint2(0u, 0u);
      if (drop) bits = row_keep_bits(f.drop, seed, ia, j0 + n * 8, h, t, c3);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 bias = stage_bias<FULL>(Bs, wrow, r, jj);
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int e = 2 * r + cc;
          const float p =
              (j0 + jj + cc < f.Tk)
                  ? expf(s[n][e] * f.scale + (cc ? bias.y : bias.x) -
                         rmax[r]) * rinv[r]
                  : 0.f;
          const float z = !drop ? 1.f
                          : row_keep(bits, r, cc, t) ? f.drop.scale
                                                     : 0.f;
          s[n][e] = p * (z * dp[n][e] - delta[r]);   // dS
          dp[n][e] = p * z;                          // P∘Z
        }
      }
    }
    // each element once, 32 contiguous bytes per row and quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = ia + 8 * r;
      if (i >= f.Tq) continue;
      float* ds_row = args.dbias + mat0 + static_cast<long long>(i) * f.Tk;
      float* pz_row = args.pz + mat0 + static_cast<long long>(i) * f.Tk;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int j = j0 + n * 8 + 2 * t;
        if (j >= f.Tk) continue;
        if ((f.Tk & 1) == 0) {              // j even: j + 1 < Tk, aligned
          *reinterpret_cast<float2*>(ds_row + j) =
              make_float2(s[n][2 * r], s[n][2 * r + 1]);
          *reinterpret_cast<float2*>(pz_row + j) =
              make_float2(dp[n][2 * r], dp[n][2 * r + 1]);
        } else {
          ds_row[j] = s[n][2 * r];
          pz_row[j] = dp[n][2 * r];
          if (j + 1 < f.Tk) {
            ds_row[j + 1] = s[n][2 * r + 1];
            pz_row[j + 1] = dp[n][2 * r + 1];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- gradients

// one gradient of the chunked backward: out = scale · M·Y (rows: queries,
// contraction over keys) or, trans, scale · Mᵀ·Y (rows: keys, contraction
// over queries), 64 channels of Y and out
struct TcGradJob {
  const float* m;        // [B, H, Tq, Tk]: dS or P∘Z
  Operand y;
  View<float> out;
  float scale;
  int trans;
};

constexpr int kMaxGradJobs = 7;   // rel-pos: dq, da (4 x 64), dk, dv

struct TcGradArgs {
  TcGradJob job[kMaxGradJobs];
  int njobs, H, Tq, Tk;
};

// dynamic shared memory: two stages of [M tile, Y tile]
constexpr int kGradStage = 2 * kTile;
constexpr int kGradSmem = 2 * kGradStage * 4;

__device__ __forceinline__ void load_grad_stage(float* st,
                                                const TcGradJob& job,
                                                const float* m, int Tq,
                                                int Tk, int b, int h, int r0,
                                                int k0) {
  if (job.trans) {
    load_matrix_tile(st, m, Tq, Tk, k0, r0);
    load_tile(st + kTile, job.y, b, h, k0, Tq);
  } else {
    load_matrix_tile(st, m, Tq, Tk, r0, k0);
    load_tile(st + kTile, job.y, b, h, k0, Tk);
  }
}

// grid: (64-row tiles of max(Tq, Tk), H x jobs, B)
__global__ void __launch_bounds__(kThreads, 2)
attn_tc_grad_kernel(const TcGradArgs args) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y % args.H, b = blockIdx.z;
  const int which = blockIdx.y / args.H;
  TcGradJob job = args.job[0];
#pragma unroll
  for (int u = 1; u < kMaxGradJobs; ++u) {   // constant indices: no local copy
    if (u == which) job = args.job[u];
  }
  const int rows = job.trans ? args.Tk : args.Tq;
  const int depth = job.trans ? args.Tq : args.Tk;
  const int r0 = blockIdx.x * kRows;
  if (r0 >= rows) return;
  const float* m =
      job.m + (static_cast<long long>(b) * args.H + h) * args.Tq * args.Tk;
  const int wrow = warp * 16 + gid;

  load_grad_stage(smem, job, m, args.Tq, args.Tk, b, h, r0, 0);
  cp_async_commit();
  float acc[8][4];
  zero(acc);
  const int ntiles = (depth + kRows - 1) / kRows;
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) {
      load_grad_stage(smem + ((it + 1) & 1) * kGradStage, job, m, args.Tq,
                      args.Tk, b, h, r0, (it + 1) * kRows);
      cp_async_commit();
    }
    const float* Ms = smem + (it & 1) * kGradStage;
    // the warp's 16 x 64 block of M (or Mᵀ) in accumulator layout: row
    // wrow + 8 (e / 2), column kk·8 + 2t + e % 2
    float x[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wrow + 8 * (e >> 1), col = kk * 8 + 2 * t + (e & 1);
        x[kk][e] = job.trans ? Ms[col * kPitch + row] : Ms[row * kPitch + col];
      }
    }
    mma_cols<kGroup>(acc, x, Ms + kTile, gid, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + wrow + 8 * r;
    if (i >= rows) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      st2(job.out, b, i, h, n * 8 + 2 * t, acc[n][2 * r] * job.scale,
          acc[n][2 * r + 1] * job.scale);
    }
  }
}

// ---------------------------------------------------------------- launch

template <int NC, bool FULL>
inline cudaError_t launch_attn_tc_chunk_fwd(const AttnArgs& args, int B,
                                            cudaStream_t stream) {
  constexpr int smem = 2 * kChunkStage<FULL> * 4;
  cudaError_t err = cudaFuncSetAttribute(
      attn_tc_chunk_fwd_kernel<NC, FULL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((args.Tq + kRows - 1) / kRows, args.H, B);
  attn_tc_chunk_fwd_kernel<NC, FULL><<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// args.delta [B, H, Tq], args.dbias and args.pz [B, H, Tq, Tk]: written
template <int NC, bool FULL>
inline cudaError_t launch_attn_tc_chunk_bwd(const AttnBwdArgs& args, int B,
                                            cudaStream_t stream) {
  static_assert(NC + 2 <= kMaxGradJobs, "too many gradient jobs");
  constexpr int smem = 2 * kChunkStage<FULL> * 4;
  const AttnArgs& f = args.f;
  cudaError_t err = cudaFuncSetAttribute(
      attn_tc_chunk_ds_kernel<NC, FULL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(attn_tc_grad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGradSmem);
  }
  if (err != cudaSuccess) return err;
  dim3 grid_s((f.Tq + kRows - 1) / kRows, f.H, B);
  attn_tc_chunk_ds_kernel<NC, FULL><<<grid_s, kThreads, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the gradient kernel reads dS and P∘Z: same stream
  TcGradArgs g{};
  g.H = f.H;
  g.Tq = f.Tq;
  g.Tk = f.Tk;
  g.job[0] = {args.dbias, f.k, args.dq, f.scale, 0};
  for (int c = 1; c < NC; ++c) {
    g.job[c] = {args.dbias, channels(f.e, 64 * (c - 1)),
                channels(args.da, 64 * (c - 1)), f.scale, 0};
  }
  g.job[NC] = {args.dbias, f.q, args.dk, f.scale, 1};
  g.job[NC + 1] = {args.pz, args.dout, args.dv, 1.f, 1};
  g.njobs = NC + 2;
  dim3 grid_g(((f.Tq > f.Tk ? f.Tq : f.Tk) + kRows - 1) / kRows,
              f.H * g.njobs, B);
  attn_tc_grad_kernel<<<grid_g, kThreads, kGradSmem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tc
}  // namespace daspeech
