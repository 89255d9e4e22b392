// bf16 attention on Hopper's bf16 tensor cores (sm_90a), head depth 64, a
// [B, Tk] column bias or a [B, H, Tq, Tk] full bias, Philox dropout: the
// kernels of the _bf16 entry points of the packed (#1), head-major (#2) and
// full-bias (#3) attention in fused_attention.cu, forward (training and
// inference) and backward. They replace the bf16 modes of three Pallas
// kernels of daspeech_tpu/ops/fused_attention.py: fused_attention_packed
// (:522; forward _attn_kernel_packed :285, backward _attn_bwd_kernel_packed
// :324), fused_attention (:189; forward _attn_kernel :76, backward
// _attn_bwd_kernel :103) and fused_attention_full_bias (:673; forward
// _attn_kernel_fb :573, backward _attn_bwd_kernel_fb :600), which upcast
// bf16 q, k, v (and dO) to f32, keep the softmax, P and dS in f32 and cast
// out, dq, dk and dv to bf16 (the full bias's dS, its gradient, stays f32).
// #3 runs the same three kernels in their full-bias mode (FULL; "The
// full-bias mode" below), under names of their own (attn_bf16_fb_*). The
// fp32 entry points keep attention_tc.cuh's 3xTF32 kernels and
// attention_fma.cuh's FMA training forward, and the rel-pos (#5) bf16 ones
// run relpos_bf16.cuh's kernels. The tile primitives, the forward's softmax
// and the backward's row statistics are tiles_bf16.cuh's.
//
// What bounds it on this card: at cell T's decoder self-attention (B=80,
// H=8, T=240, d=64) the forward and backward are 33 GFLOP (seven 2·T²·d
// products a head: two forward, five backward; 0.033 ms at the 989
// TFLOP/s of bf16) against 157 MB of bf16 traffic (q, k, v, dO, out, dq,
// dk, dv once each; 0.047 ms at 3.35 TB/s): the bytes, by a little; at
// J-long's FastSpeech 2 decoder (B=14, H=4, T=1040) the products (0.055
// ms). So the design keeps every product on the tensor cores at bf16
// rate, no score matrix in device memory, and the tiles in shared memory
// where ldmatrix feeds the MMAs. The softmax takes its exponentials as
// ex2.approx of x · log2 e (one SFU instruction).
//
// Products: every product is mma.sync.aligned.m16n8k16.row.col.f32.bf16.
// bf16.f32 with fp32 accumulators, chained in place (the accumulation's
// truncation bias, ~2^-23 relative per add, is far below bf16's rounding;
// attention_tc.cuh, "Accumulation"). Operands come from shared memory by
// ldmatrix, or from registers where an accumulator (P, dS) becomes the A
// operand of the next product: the m16n8 accumulator of two adjacent 8-key
// blocks is exactly the A fragment of one 16-deep k-step (a0 = keys 2t,
// 2t+1 of row gid from block 2kk, a2 = the same of block 2kk+1, a1 and a3
// row gid+8), so no shuffle moves it. The B operand that P·V, dS·K,
// (P∘Z)ᵀ·dO and dSᵀ·Q read with the contraction along the tile's rows
// comes from ldmatrix.trans, which transposes 8x8 blocks of 16-bit values
// as it loads them (the tf32 kernels could not do that: attention_tc.cuh,
// "Why mma.sync").
//
// Rounding of P and dS (tests/test_torch_bf16_split.py decides it and holds
// the constants below): Q·Kᵀ and dO·Vᵀ multiply bf16 inputs, exact in fp32.
// P and dS are fp32; a product that takes one takes it either one-term
// (rounded to bf16, one MMA, as SDPA does) or two-term (hi = bf16(x),
// lo = bf16(x − hi), lo·B then hi·B, two MMAs). A product is one-term where
// its outputs stay within a quarter of chip_smoke.py's bf16 bar (2^-7 of the
// output's largest magnitude) of float64 at cell T's packed [2, 240, 4·64]
// (dropout 0 and 0.1) and at a head-major [1, 2, 1040, 64]. Errors measured
// there (over the largest magnitude): P·V one-term out 8.4e-4 / 8.2e-4 /
// 1.26e-3 (bar 1.95e-3): one-term. dS·K one-term dq 2.08e-3 / 1.96e-3 /
// 2.67e-3, (P∘Z)ᵀ·dO dv 2.28e-3 / 1.64e-3 / 1.84e-3, dSᵀ·Q dk 2.03e-3 /
// 1.86e-3 / 2.78e-3: all three two-term (then dq 5.1e-4, dk 1.7e-4, dv
// 6.1e-6). So a pair of 64-row tiles costs the forward two products' MMAs,
// the dq kernel four (S, dP, dS·K twice) and the dk/dv kernel six (S, dP,
// and dV and dK twice each).
//
// The forward rounds p̃ = exp(s − m) (m the running max) to bf16 and sums
// the ROUNDED values into the output's normalizer lr, so that the output is
// an exact convex combination of V's rows: the backward's delta =
// rowsum(dO∘O) then differs from rowsum(P∘dP) only along V's spread, not
// along its mean, where it would cancel against dO·V in a near-uniform row
// (attention.cuh, "Element type"). The statistics saved for the backward
// hold the fp32 sum of the unrounded p̃, so the backward's recomputed P
// sums to one. Dropout selects the rounded p̃ by its keep bit; 1/keep_p
// multiplies the output once, at the end.
//
// Tiles: 64 rows x 64 bf16 channels in shared memory at a pitch of 72
// elements (144 bytes): the eight 16-byte rows an ldmatrix phase reads lie
// 4 banks apart, so every ldmatrix is free of bank conflicts, and each row
// stays 16-byte aligned for cp.async. A tile is 9 KiB (the fp32 kernels'
// is 17). Each block is four warps of 16 rows; 64-row tiles of K and V
// (forward, dq) or of Q and dO with their statistics and delta (dk/dv)
// stream by 16-byte cp.async into two stages, double-buffered: the next
// tile's copy overlaps this tile's products.
//
// Forward: one block per (64-query tile, head, batch row); the Q tile is
// copied with the first stage. Per key tile S = Q·Kᵀ, the online softmax on
// the accumulator fragments (a row lives in the four threads of a quad),
// then O += P·V. A training forward (stats given) writes each row's (max,
// sum) and, for the backward's delta, its output in fp32 (o32); the
// reasons the fp32 path keeps its training forward on the FMA pipes
// (attention_tc.cuh, "Accumulation") concern a 2^-23 bias, far below bf16's.
//
// Backward, two kernels and no atomics (bit-identical from run to run), as
// attention_tc.cuh's: the dq kernel (one block per query tile; Q and dO
// tiles resident) writes delta = rowsum(dO∘O32), recomputes S and
// dP = dO·Vᵀ per key tile, dS = P∘(Z∘dP − delta), dQ += dS·K; the dk/dv
// kernel (one block per key tile; K and V resident) streams query tiles,
// Pᵀ from Sᵀ = K·Qᵀ, dV += (P∘Z)ᵀ·dO, then dPᵀ = V·dOᵀ, dK += dSᵀ·Q. Both
// take the streamed tile 32 rows at a time (kHalf), so that S and dP hold
// 16 registers each: the dq kernel fits 128 registers (four blocks an SM),
// the dk/dv kernel 168 (three). Dropout draws the bits of every other
// attention kernel (attention_tc.cuh's helpers): word (j % 4) of
// philox4x32_10((j / 4, i, h, 0), (seed[b], 0)).
//
// Measured (chip_smoke.py and a driver of it, NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md §6): at cell T's shape the forward takes 0.119 ms of
// device time, the dq kernel 0.148 and the dk/dv kernel 0.202, about
// 110 TFLOP/s of products in all; dropout's Philox draws, three times per
// element (forward, dq, dk/dv), are about a fifth of it.
//
// The full-bias mode (#3): the same kernels with the [64 query x 64 key]
// fp32 tile of bias4 in each stage, streamed by 16-byte cp.async beside the
// K and V tiles (forward, dq) or the Q and dO tiles (dk/dv), and added to
// the scaled score before the row max. The alternative, each thread reading
// its biases straight into the m16n8 accumulator layout as float2 loads
// (attention_fma.cuh's FULL mode reads its 4 x 4 so), was not built: the
// staged tile's copy overlaps the previous key tile's products, where the
// direct loads would either stall the softmax on L2 latency once a tile or
// hold 32 more registers of bias in flight through the S product; and the
// 18 KB tile a stage costs occupancy only beyond two blocks an SM, which
// the ALiBi shape's 256 blocks do not reach on 132 SMs. The forward and the
// dq kernel read the tile at a pitch of 72 floats (accumulator-layout
// float2 reads, free of bank conflicts), the dk/dv kernel, whose
// accumulator rows are keys, at 68 (reads down a column). The dq kernel
// holds each (query tile, key tile) block of dS = P∘(Z∘dP − delta) in
// registers and writes it to dbias, fp32, each element once and no
// atomics; the dk/dv kernel recomputes P and dS from the statistics and
// reads bias4 a third time. Dropout keys the full bias as its plain version
// does (philox.full_bias_keep): seeds[0] for every batch row, the batch row
// in the counter's fourth word. The forms of P·V, dS·K, (P∘Z)ᵀ·dO and dSᵀ·Q
// (kTermsFb*) are decided at an ALiBi and a random bias
// (tests/test_torch_bf16_full_bias.py), whose rows are far more peaked than
// a column bias leaves them: P·V one-term read 9.3e-4 against its half bar
// of 9.8e-4 and stays one-term; the other three miss the bar one-term
// (2.2e-3 to 2.7e-3 against 1.95e-3) and are two-term, as #1's and #2's.
// Shared memory: 81 KB (forward), 90 KB (dq, dk/dv), two blocks an SM.
// A fully masked row (bias −1e30 on every key) scores −1e30 on every key in
// fp32, so its probabilities are uniform over its Tk keys, as in the plain
// version.
//
// What bounds the full-bias mode at chip_smoke.py's ALiBi shape [8, 8, 240,
// 64], p = 0.1, forward + backward: 3.3 GFLOP (0.0033 ms at 989 TFLOP/s)
// against 45.2 MB that the function must move (q, k, v, dO, out, dq, dk, dv
// in bf16 15.7 MB, bias4 14.7 MB once, dbias 14.7 MB): the bytes, 0.0135
// ms. This layout moves bias4 three times (44.2 MB), dbias once and out32
// twice (7.9 MB): about 83 MB. rel-pos's layout (relpos_bf16.cuh with one
// chunk: dS and P∘Z to fp32 scratch, then the products from there) moves
// bias4 twice, writes dS and P∘Z and reads dS twice and P∘Z once: about 127
// MB. Measured (chip_smoke.py's bf16 alternate rows, NVIDIA H100 80GB HBM3
// at 700 W; PERF.md §6): 0.0753 ms of device time (forward 0.0198, dq
// 0.0252, dk/dv 0.0303) against SDPA's 0.0987 on a bf16 mask, and the
// parent's fp32 kernels on widened tiles took 0.3301 ms a call against
// this mode's 0.2084 (CUDA events, the host's wrappers included).
//
// Ragged tiles: rows past Tq or Tk are zero-filled by cp.async (the bias
// tile too); keys past Tk get score −inf (forward) or P = 0 (dq); rows past
// Tq get P = 0 through their zero statistics (dk/dv) and are never stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "attention_tc.cuh"
#include "philox.cuh"
#include "tiles_bf16.cuh"

namespace daspeech {
namespace bf {
// internal linkage, as attention_tc.cuh's kernels
namespace {

// MMAs per product of an fp32 operand (1: one-term, 2: two-term); see
// "Rounding of P and dS"
constexpr int kTermsPV = 1;    // O += P·V
constexpr int kTermsDSK = 2;   // dQ += dS·K
constexpr int kTermsPDO = 2;   // dV += (P∘Z)ᵀ·dO
constexpr int kTermsDSQ = 2;   // dK += dSᵀ·Q
// the full-bias mode's (#3), decided at an ALiBi and a random bias
// (tests/test_torch_bf16_full_bias.py; "The full-bias mode")
constexpr int kTermsFbPV = 1;
constexpr int kTermsFbDSK = 2;
constexpr int kTermsFbPDO = 2;
constexpr int kTermsFbDSQ = 2;

// S and dP of the backward are taken 32 rows of the streamed tile at a
// time (keys in the dq kernel, queries in the dk/dv kernel): 4 blocks of 8
// in 16 registers each, which keeps the dq kernel within 128 registers
// (four blocks an SM) and the dk/dv kernel within 168 (three)
constexpr int kHalf = 32;

// the full-bias mode's [64 query x 64 key] fp32 tile of bias4 in a stage:
// at a pitch of 72 floats for the forward's and the dq kernel's float2
// reads in accumulator layout (a quad reads 8 consecutive floats of a row,
// the eight rows of a half-warp lie 8 banks apart), at 68 for the dk/dv
// kernel's reads down a column (its accumulator rows are keys: thread
// (gid, t) reads query 2t + c, key gid, bank 8t + gid)
constexpr int kFbPitch = 72;
constexpr int kFbPitchT = 68;

// ---------------------------------------------------------------- forward

// a stage: [K tile, V tile, the bias: 64 fp32 column biases or (FULL) the
// [query tile, key tile] block of bias4]
template <bool FULL>
constexpr int kKvStage =
    2 * kTileBytes + (FULL ? kRows * kFbPitch : kRows) * 4;
// dynamic shared memory: the Q tile, then two stages
template <bool FULL>
constexpr int kFwdSmem = kTileBytes + 2 * kKvStage<FULL>;

template <bool FULL>
__device__ __forceinline__ void load_kv_stage(unsigned char* st,
                                              const AttnArgs& f, int b,
                                              int h, int i0, int j0) {
  load_tile(reinterpret_cast<uint16_t*>(st), f.k, b, h, j0, f.Tk);
  load_tile(reinterpret_cast<uint16_t*>(st + kTileBytes), f.v, b, h, j0,
            f.Tk);
  float* bs = reinterpret_cast<float*>(st + 2 * kTileBytes);
  if constexpr (FULL) {
    load_f32_tile(bs, kFbPitch, f.bias4 + tc::matrix_at(f, b, h), f.Tq,
                  f.Tk, i0, j0);
  } else if (threadIdx.x < kRows) {
    const int j = j0 + threadIdx.x;
    const bool ok = j < f.Tk;
    cp_async<4>(bs + threadIdx.x, f.bias + b * f.bias_sb + (ok ? j : 0),
                ok);
  }
}

// dropout's key and the fourth word of its counter: the column-bias modes
// key each batch row by its own seed, the full bias by seeds[0] with the
// batch row in the counter (philox.full_bias_keep)
template <bool FULL>
__device__ __forceinline__ uint32_t drop_seed(const DropoutArgs& d, int b) {
  return d.seeds != nullptr ? d.seeds[FULL ? 0 : b] : 0u;
}

template <bool FULL>
__device__ __forceinline__ void attn_bf16_fwd(const AttnArgs& args) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PV = FULL ? kTermsFbPV : kTermsPV;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const int ia = i0 + warp * 16 + gid;   // this thread's rows ia, ia + 8
  const uint32_t seed = drop_seed<FULL>(args.drop, b);
  const uint32_t c3 = FULL ? static_cast<uint32_t>(b) : 0u;
  const uint16_t* Qw =
      reinterpret_cast<const uint16_t*>(smem) + warp * 16 * kPitch;
  unsigned char* stages = smem + kTileBytes;

  load_tile(reinterpret_cast<uint16_t*>(smem), args.q, b, h, i0, args.Tq);
  load_kv_stage<FULL>(stages, args, b, h, i0, 0);
  cp_async_commit();

  float o[8][4];
  tc::zero(o);
  // running max, fp32 sum of exp(s - m) (the saved statistic) and sum of
  // its bf16 roundings (the output's normalizer)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
        lr[2] = {0.f, 0.f};
  const int ntiles = (args.Tk + kRows - 1) / kRows;
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) {
      load_kv_stage<FULL>(stages + ((it + 1) & 1) * kKvStage<FULL>, args, b,
                          h, i0, j0 + kRows);
      cp_async_commit();
    }
    const unsigned char* st = stages + (it & 1) * kKvStage<FULL>;
    const uint16_t* Ks = reinterpret_cast<const uint16_t*>(st);
    const uint16_t* Vs = reinterpret_cast<const uint16_t*>(st + kTileBytes);
    // the biases of row ia: the column biases, or its row of the bias tile
    const float* Bs = reinterpret_cast<const float*>(st + 2 * kTileBytes) +
                      (FULL ? (warp * 16 + gid) * kFbPitch : 0);

    float s[8][4];
    tc::zero(s);
    mma_rows<8>(s, Qw, Ks, lane);

    softmax_tile<PV, FULL ? kFbPitch : 0>(
        s, o, m, l, lr, Bs, j0, args, seed, ia,
        tc::drop_head<FULL>(args, h), t, c3);
    mma_cols<PV, 4>(o, elems(s), Vs, lane);
  }

  finish_forward(args, b, h, ia, t, o, m, l, lr);
}

// held to 128 registers: four blocks an SM
__global__ void __launch_bounds__(kThreads, 4)
attn_bf16_fwd_kernel(const AttnArgs args) {
  attn_bf16_fwd<false>(args);
}

// the full-bias mode: 81 KiB of shared memory, two blocks an SM
__global__ void __launch_bounds__(kThreads, 2)
attn_bf16_fb_fwd_kernel(const AttnArgs args) {
  attn_bf16_fwd<true>(args);
}

// ---------------------------------------------------------------- dq

// dynamic shared memory: Q and dO tiles, then two [K, V, bias] stages
template <bool FULL>
constexpr int kDqSmem = 2 * kTileBytes + 2 * kKvStage<FULL>;

// dS of the thread's rows ia, ia + 8 and the 32 keys from j8 on (x in
// accumulator layout) into the [Tq, Tk] matrix ds: each element once, 32
// contiguous bytes per row and quad, keys past Tk and rows past Tq not
// written
__device__ __forceinline__ void store_ds(float* ds, const AttnArgs& f,
                                         int ia, int j8,
                                         const float (&x)[4][4], int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = ia + 8 * r;
    if (i >= f.Tq) continue;
    float* row = ds + static_cast<long long>(i) * f.Tk;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = j8 + n * 8 + 2 * t;
      if (j >= f.Tk) continue;
      if ((f.Tk & 1) == 0) {              // j even: j + 1 < Tk, aligned
        *reinterpret_cast<float2*>(row + j) =
            make_float2(x[n][2 * r], x[n][2 * r + 1]);
      } else {
        row[j] = x[n][2 * r];
        if (j + 1 < f.Tk) row[j + 1] = x[n][2 * r + 1];
      }
    }
  }
}

template <bool FULL>
__device__ __forceinline__ void attn_bf16_dq(const AttnBwdArgs& args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnArgs& f = args.f;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  // h: the layer's head, which indexes the tiles and counts the dropout.
  // With a head offset h0 (a tensor-parallel rank's heads) the grid spans
  // heads 0 .. h0 + H - 1, every per-head pointer starts h0 heads back
  // (launch_attn_bf16_bwd) and the blocks below h0 return; h0 is taken
  // from the grid, not read from AttnArgs: read here, it spilled 4 bytes
  const int h = blockIdx.y, b = blockIdx.z;
  if (!FULL && h < static_cast<int>(gridDim.y) - f.H) return;
  const int i0 = blockIdx.x * kRows;
  const int ia = i0 + warp * 16 + gid;
  const bool drop = f.drop.seeds != nullptr;
  const uint32_t seed = drop_seed<FULL>(f.drop, b);
  const uint32_t c3 = FULL ? static_cast<uint32_t>(b) : 0u;
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* dOs = reinterpret_cast<uint16_t*>(smem + kTileBytes);
  unsigned char* stages = smem + 2 * kTileBytes;

  load_tile(Qs, f.q, b, h, i0, f.Tq);
  load_tile(dOs, args.dout, b, h, i0, f.Tq);
  load_kv_stage<FULL>(stages, f, b, h, i0, 0);
  cp_async_commit();

  float delta[2], rmax[2], rinv[2];
  backward_rows(args, b, h, i0, warp, lane, delta, rmax, rinv);

  const uint16_t* Qw = Qs + warp * 16 * kPitch;
  const uint16_t* dOw = dOs + warp * 16 * kPitch;
  float dq[8][4];
  tc::zero(dq);
  const int ntiles = (f.Tk + kRows - 1) / kRows;
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) {
      load_kv_stage<FULL>(stages + ((it + 1) & 1) * kKvStage<FULL>, f, b, h,
                          i0, j0 + kRows);
      cp_async_commit();
    }
    const unsigned char* st = stages + (it & 1) * kKvStage<FULL>;
    const uint16_t* Ks = reinterpret_cast<const uint16_t*>(st);
    const uint16_t* Vs = reinterpret_cast<const uint16_t*>(st + kTileBytes);
    const float* Bs = reinterpret_cast<const float*>(st + 2 * kTileBytes) +
                      (FULL ? (warp * 16 + gid) * kFbPitch : 0);

#pragma unroll
    for (int half = 0; half < kRows / kHalf; ++half) {
      const int jh = half * kHalf;   // the half's first key in the tile
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      mma_rows<4>(s, Qw, Ks + jh * kPitch, lane);
      mma_rows<4>(dp, dOw, Vs + jh * kPitch, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int jj = jh + n * 8 + 2 * t;
        const float2 b0 = *reinterpret_cast<const float2*>(Bs + jj);
        const float2 b1 =
            FULL ? *reinterpret_cast<const float2*>(Bs + 8 * kFbPitch + jj)
                 : b0;
        uint2 bits = make_uint2(0u, 0u);
        if (drop) {
          bits = tc::row_keep_bits(f.drop, seed, ia, j0 + jh + n * 8, h, t,
                                   c3);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = e & 1;
          const float2 bias = r ? b1 : b0;
          const float p =
              (j0 + jj + c < f.Tk)
                  ? ex2((s[n][e] * f.scale + (c ? bias.y : bias.x) -
                         rmax[r]) * kLog2e) * rinv[r]
                  : 0.f;
          const float z = !drop ? 1.f
                          : tc::row_keep(bits, r, c, t) ? f.drop.scale
                                                        : 0.f;
          s[n][e] = p * (z * dp[n][e] - delta[r]);   // dS
        }
      }
      // the full bias's gradient is dS itself, written once from here
      if constexpr (FULL) {
        store_ds(args.dbias + tc::matrix_at(f, b, h), f, ia, j0 + jh, s, t);
      }
      mma_cols<FULL ? kTermsFbDSK : kTermsDSK, 2>(dq, elems(s),
                                                  Ks + jh * kPitch, lane);
    }
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

__global__ void __launch_bounds__(kThreads, 4)
attn_bf16_dq_kernel(const AttnBwdArgs args) {
  attn_bf16_dq<false>(args);
}

// the full-bias mode: 90 KiB of shared memory, two blocks an SM
__global__ void __launch_bounds__(kThreads, 2)
attn_bf16_fb_dq_kernel(const AttnBwdArgs args) {
  attn_bf16_dq<true>(args);
}

// ---------------------------------------------------------------- dk/dv

// a stage: [Q tile, dO tile, 64 (max, sum) pairs, 64 deltas, and (FULL)
// the [query tile, key tile] block of bias4 at pitch kFbPitchT]
template <bool FULL>
constexpr int kQStage =
    2 * kTileBytes + 3 * kRows * 4 + (FULL ? kRows * kFbPitchT * 4 : 0);
// dynamic shared memory: the block's K and V tiles, then two stages
template <bool FULL>
constexpr int kDkvSmem = 2 * kTileBytes + 2 * kQStage<FULL>;

template <bool FULL>
__device__ __forceinline__ void load_q_stage(unsigned char* st,
                                             const AttnBwdArgs& args, int b,
                                             int h, int i0, int k0) {
  const AttnArgs& f = args.f;
  load_tile(reinterpret_cast<uint16_t*>(st), f.q, b, h, i0, f.Tq);
  load_tile(reinterpret_cast<uint16_t*>(st + kTileBytes), args.dout, b, h,
            i0, f.Tq);
  float* stat = reinterpret_cast<float*>(st + 2 * kTileBytes);
  const long long stat0 = (static_cast<long long>(b) * f.H + h) * f.Tq;
  const int x = threadIdx.x % kRows, i = i0 + x;
  const bool ok = i < f.Tq;
  const long long si = stat0 + (ok ? i : 0);
  if (threadIdx.x < kRows) {
    cp_async<8>(stat + 2 * x, f.stats + 2 * si, ok);
  } else {
    cp_async<4>(stat + 2 * kRows + x, args.delta + si, ok);
  }
  if constexpr (FULL) {
    load_f32_tile(stat + 3 * kRows, kFbPitchT,
                  f.bias4 + tc::matrix_at(f, b, h), f.Tq, f.Tk, i0, k0);
  }
}

template <bool FULL>
__device__ __forceinline__ void attn_bf16_dkdv(const AttnBwdArgs& args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnArgs& f = args.f;
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Vs = reinterpret_cast<uint16_t*>(smem + kTileBytes);
  unsigned char* stages = smem + 2 * kTileBytes;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kRows;
  const int wk = warp * 16 + gid;        // this thread's keys in the tile
  const int ja = k0 + wk;                // this thread's keys ja, ja + 8
  const bool drop = f.drop.seeds != nullptr;
  const uint32_t seed = drop_seed<FULL>(f.drop, b);
  const uint32_t c3 = FULL ? static_cast<uint32_t>(b) : 0u;

  load_tile(Ks, f.k, b, h, k0, f.Tk);
  load_tile(Vs, f.v, b, h, k0, f.Tk);
  load_q_stage<FULL>(stages, args, b, h, 0, k0);
  cp_async_commit();

  // the column biases of the thread's keys (the full bias comes with each
  // query tile's stage)
  float bias[2] = {0.f, 0.f};
  if constexpr (!FULL) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = ja + 8 * r;
      bias[r] = j < f.Tk ? f.bias[b * f.bias_sb + j] : 0.f;
    }
  }
  // dropout: the lanes of one t with gid = 4 g + w (w = 0..3) share their
  // draws; lane w draws (key group of half w / 2, query 2t + w % 2)
  const int w = gid & 3;
  const int group = (k0 + warp * 16) / 4 + (gid >> 2) + 2 * (w >> 1);

  const uint16_t* Kw = Ks + warp * 16 * kPitch;
  const uint16_t* Vw = Vs + warp * 16 * kPitch;
  float dk[8][4], dv[8][4];
  tc::zero(dk);
  tc::zero(dv);
  const int ntiles = (f.Tq + kRows - 1) / kRows;
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = it * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) {
      load_q_stage<FULL>(stages + ((it + 1) & 1) * kQStage<FULL>, args, b, h,
                         i0 + kRows, k0);
      cp_async_commit();
    }
    const unsigned char* st = stages + (it & 1) * kQStage<FULL>;
    const uint16_t* Qs = reinterpret_cast<const uint16_t*>(st);
    const uint16_t* dOs = reinterpret_cast<const uint16_t*>(st + kTileBytes);
    const float* Ml = reinterpret_cast<const float*>(st + 2 * kTileBytes);
    const float* Dl = Ml + 2 * kRows;   // delta per query
    const float* Bt = Dl + kRows;       // FULL: the bias tile [query][key]

#pragma unroll
    for (int half = 0; half < kRows / kHalf; ++half) {
      const int ih = half * kHalf;   // the half's first query in the tile
      // Pᵀ (rows keys, columns the half's queries), then dV += (P∘Z)ᵀ·dO,
      // and only then dPᵀ and dK += dSᵀ·Q: P∘Z is formed as the dV product
      // reads it and dPᵀ is not yet live, which keeps the kernel within
      // 168 registers
      float p[4][4];
      uint32_t bits[4];   // keep bit of element e at bit 4e + w
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[n][e] = 0.f;
      }
      mma_rows<4>(p, Kw, Qs + ih * kPitch, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        bits[n] = 0u;
        if (drop) {
          const int q = i0 + ih + n * 8 + 2 * t + (w & 1);
          bits[n] = tc::keep4(
                        philox4x32_10(make_uint4(group, q,
                                                 tc::drop_head<FULL>(f, h), c3),
                                      seed, 0u),
                        f.drop.thresh)
                    << (4 * w);
          bits[n] |= __shfl_xor_sync(0xffffffffu, bits[n], 4);
          bits[n] |= __shfl_xor_sync(0xffffffffu, bits[n], 8);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qq = ih + n * 8 + 2 * t + c;
          const float2 ml = *reinterpret_cast<const float2*>(Ml + 2 * qq);
          const float rinv = (i0 + qq < f.Tq) ? 1.f / ml.y : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const float bb =
                FULL ? Bt[qq * kFbPitchT + wk + 8 * r] : bias[r];
            p[n][e] = ex2((p[n][e] * f.scale + bb - ml.x) * kLog2e) * rinv;
          }
        }
      }
      const auto z = [&](int n, int e) {
        return !drop ? 1.f
               : ((bits[n] >> (4 * e + w)) & 1u) ? f.drop.scale : 0.f;
      };
      mma_cols<FULL ? kTermsFbPDO : kTermsPDO, 2>(
          dv, [&](int n, int e) { return p[n][e] * z(n, e); },
          dOs + ih * kPitch, lane);

      float dpt[4][4];    // dPᵀ, then dSᵀ
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
      }
      mma_rows<4>(dpt, Vw, dOs + ih * kPitch, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dl = Dl[ih + n * 8 + 2 * t + (e & 1)];
          dpt[n][e] = p[n][e] * (z(n, e) * dpt[n][e] - dl);
        }
      }
      mma_cols<FULL ? kTermsFbDSQ : kTermsDSQ, 2>(dk, elems(dpt),
                                                  Qs + ih * kPitch, lane);
    }
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

__global__ void __launch_bounds__(kThreads, 3)
attn_bf16_dkdv_kernel(const AttnBwdArgs args) {
  attn_bf16_dkdv<false>(args);
}

// the full-bias mode: 90 KiB of shared memory, two blocks an SM
__global__ void __launch_bounds__(kThreads, 2)
attn_bf16_fb_dkdv_kernel(const AttnBwdArgs args) {
  attn_bf16_dkdv<true>(args);
}

// ---------------------------------------------------------------- launch

// FULL: the full-bias mode's kernels (#3), else the column-bias ones (#1,
// #2)
template <bool FULL>
inline cudaError_t launch_attn_bf16_fwd(const AttnArgs& args, int B,
                                        cudaStream_t stream) {
  const auto kernel = FULL ? attn_bf16_fb_fwd_kernel : attn_bf16_fwd_kernel;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem<FULL>);
  if (err != cudaSuccess) return err;
  dim3 grid((args.Tq + kRows - 1) / kRows, args.H, B);
  kernel<<<grid, kThreads, kFwdSmem<FULL>, stream>>>(args);
  return cudaGetLastError();
}

// args.delta [B, H, Tq] scratch; FULL: args.dbias [B, H, Tq, Tk] written
template <bool FULL>
inline cudaError_t launch_attn_bf16_bwd(const AttnBwdArgs& args, int B,
                                        cudaStream_t stream) {
  const auto dq = FULL ? attn_bf16_fb_dq_kernel : attn_bf16_dq_kernel;
  const auto dkdv = FULL ? attn_bf16_fb_dkdv_kernel : attn_bf16_dkdv_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      dq, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem<FULL>);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem<FULL>);
  }
  if (err != cudaSuccess) return err;
  // the dq kernel writes delta, which the dk/dv kernel reads: same stream.
  // With a head offset h0 (AttnArgs::h0, the first of a tensor-parallel
  // rank's heads) it runs over the layer's heads 0 .. h0 + H - 1 from
  // per-head pointers that start h0 heads back, and its blocks below h0
  // return: its key loop is the one without an offset (at its 128-register
  // bound the offset carried through the loop beside h spilled 16 bytes,
  // or took 5% of its time where h was read again from the grid)
  AttnBwdArgs qa = args;
  const long long h0 = FULL ? 0 : args.f.h0;
  if (h0) {
    qa.f.q = qa.f.q.plus(-h0 * qa.f.q.sh);
    qa.f.k = qa.f.k.plus(-h0 * qa.f.k.sh);
    qa.f.v = qa.f.v.plus(-h0 * qa.f.v.sh);
    qa.f.o = qa.f.o.plus(-h0 * qa.f.o.sh);
    qa.dout = qa.dout.plus(-h0 * qa.dout.sh);
    qa.dq = qa.dq.plus(-h0 * qa.dq.sh);
    qa.f.stats -= h0 * args.f.Tq * 2;
    qa.delta -= h0 * args.f.Tq;
  }
  dim3 grid_q((args.f.Tq + kRows - 1) / kRows, args.f.H + h0, B);
  dq<<<grid_q, kThreads, kDqSmem<FULL>, stream>>>(qa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_k((args.f.Tk + kRows - 1) / kRows, args.f.H, B);
  dkdv<<<grid_k, kThreads, kDkvSmem<FULL>, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bf
}  // namespace daspeech
