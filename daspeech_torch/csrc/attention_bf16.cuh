// bf16 attention on Hopper's bf16 tensor cores (sm_90a), head depth 64, a
// [B, Tk] column bias, Philox dropout: the kernels of the _bf16 entry points
// of the packed (#1) and head-major (#2) attention in fused_attention.cu,
// forward (training and inference) and backward. They replace the bf16
// modes of two Pallas kernels of daspeech_tpu/ops/fused_attention.py:
// fused_attention_packed (:522; forward _attn_kernel_packed :285, backward
// _attn_bwd_kernel_packed :324) and fused_attention (:189; forward
// _attn_kernel :76, backward _attn_bwd_kernel :103), which upcast bf16 q,
// k, v (and dO) to f32, keep the softmax, P and dS in f32 and cast out, dq,
// dk and dv to bf16. The fp32 entry points keep attention_tc.cuh's 3xTF32
// kernels and attention_fma.cuh's FMA training forward; the full-bias (#3)
// and rel-pos (#5) bf16 entry points keep theirs too.
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
// Ragged tiles: rows past Tq or Tk are zero-filled by cp.async; keys past
// Tk get score −inf (forward) or P = 0 (dq); rows past Tq get P = 0 through
// their zero statistics (dk/dv) and are never stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "attention_tc.cuh"
#include "philox.cuh"

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

constexpr int kRows = 64;                        // rows of a tile
constexpr int kThreads = 128;                    // four warps of 16 rows
constexpr int kPitch = 72;                       // bf16 per tile row
constexpr int kTileBytes = kRows * kPitch * 2;   // 9216

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t r[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t r[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a·b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (one MUFU.EX2; -inf gives 0); e^x is ex2(x · log2 e)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rows r0 .. r0 + 63 of a bf16 [rows, 64] operand view into a tile, one
// 16-byte cp.async per 8 channels; rows past `rows` zero-filled
__device__ __forceinline__ void load_tile(uint16_t* tile, const Operand& x,
                                          int b, int h, int r0, int rows) {
  const uint16_t* base = reinterpret_cast<const uint16_t*>(x.ptr);
#pragma unroll
  for (int u = 0; u < kRows * 8 / kThreads; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int rr = c >> 3, col = (c & 7) * 8, r = r0 + rr;
    const bool ok = r < rows;
    cp_async<16>(tile + rr * kPitch + col,
                 base + x.index(b, ok ? r : 0, h) + col, ok);
  }
}

// acc[n] (16 x 8 block n of a 16 x 8NB result) += A · Tᵀ: result[m][8n + c]
// = sum_k A[m][k] T[8n + c][k] over the 64 channels, A the warp's 16 rows
// of a tile, T 8NB rows of a tile (contraction along both tiles' rows:
// the natural ldmatrix)
template <int NB>
__device__ __forceinline__ void mma_rows(float (&acc)[NB][4],
                                         const uint16_t* A, const uint16_t* T,
                                         int lane) {
  // A: lane gives row lane % 16, channels 8 (lane / 16) ..; T: lane gives
  // row 8 (lane / 16) + lane % 8 of each 16-row pair, channels
  // 8 ((lane / 8) % 2) ..: b[0], b[1] feed block 2np, b[2], b[3] 2np + 1
  const uint16_t* pa = A + (lane & 15) * kPitch + (lane >> 4) * 8;
  const uint16_t* pt =
      T + ((lane >> 4) * 8 + (lane & 7)) * kPitch + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    ldsm4(a, pa + kk * 16);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];
      ldsm4(b, pt + np * 16 * kPitch + kk * 16);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// the A fragment (hi part, and with TERMS == 2 the lo part) of k-step kk
// of X, a 16-row fp32 matrix in accumulator layout: x(n, e) gives element
// e of its block n (columns 8n .. 8n + 7)
template <int TERMS, class X>
__device__ __forceinline__ void a_from_acc(X x, int kk, uint32_t hi[4],
                                           uint32_t lo[4]) {
  // a0, a1: rows gid, gid + 8 of block 2kk; a2, a3: those of 2kk + 1
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = 2 * kk + (r >> 1), e = 2 * (r & 1);
    const float v0 = x(n, e), v1 = x(n, e + 1);
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    if constexpr (TERMS == 2) {
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
      lo[r] = *reinterpret_cast<const uint32_t*>(&l);
    }
  }
}

// acc[n] += X · T[:, 8n ..]: result[m][8n + c] = sum_k X[m][k] T[k][8n + c]
// over KS k-steps of 16, with X (16 x 16KS, fp32) in accumulator layout
// (given element by element, as a_from_acc's x) and T 16KS rows of a tile
// that are the contraction (ldmatrix.trans); TERMS as kTerms*
template <int TERMS, int KS, class X>
__device__ __forceinline__ void mma_cols(float acc[8][4], X x,
                                         const uint16_t* T, int lane) {
  // lane gives row 16 kk + 8 ((lane / 8) % 2) + lane % 8, channels
  // 16 np + 8 (lane / 16) ..: b[0], b[1] feed block 2np, b[2], b[3] 2np + 1
  const uint16_t* pt =
      T + (((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t hi[4], lo[4];
    a_from_acc<TERMS>(x, kk, hi, lo);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm4_t(b, pt + kk * 16 * kPitch + np * 16);
      if constexpr (TERMS == 2) {
        mma(acc[2 * np], lo, b[0], b[1]);
        mma(acc[2 * np + 1], lo, b[2], b[3]);
      }
      mma(acc[2 * np], hi, b[0], b[1]);
      mma(acc[2 * np + 1], hi, b[2], b[3]);
    }
  }
}

// an accumulator array as a_from_acc's x
template <int N>
__device__ __forceinline__ auto elems(const float (&a)[N][4]) {
  return [&a](int n, int e) { return a[n][e]; };
}

// S and dP of the backward are taken 32 rows of the streamed tile at a
// time (keys in the dq kernel, queries in the dk/dv kernel): 4 blocks of 8
// in 16 registers each, which keeps the dq kernel within 128 registers
// (four blocks an SM) and the dk/dv kernel within 168 (three)
constexpr int kHalf = 32;

// ---------------------------------------------------------------- forward

// a stage: [K tile, V tile, 64 fp32 column biases]
constexpr int kKvStage = 2 * kTileBytes + kRows * 4;
// dynamic shared memory: the Q tile, then two stages
constexpr int kFwdSmem = kTileBytes + 2 * kKvStage;

__device__ __forceinline__ void load_kv_stage(unsigned char* st,
                                              const AttnArgs& f, int b,
                                              int h, int j0) {
  load_tile(reinterpret_cast<uint16_t*>(st), f.k, b, h, j0, f.Tk);
  load_tile(reinterpret_cast<uint16_t*>(st + kTileBytes), f.v, b, h, j0,
            f.Tk);
  if (threadIdx.x < kRows) {
    const int j = j0 + threadIdx.x;
    const bool ok = j < f.Tk;
    cp_async<4>(reinterpret_cast<float*>(st + 2 * kTileBytes) + threadIdx.x,
                f.bias + b * f.bias_sb + (ok ? j : 0), ok);
  }
}

// held to 128 registers: four blocks an SM
__global__ void __launch_bounds__(kThreads, 4)
attn_bf16_fwd_kernel(const AttnArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const int ia = i0 + warp * 16 + gid;   // this thread's rows ia, ia + 8
  const bool drop = args.drop.seeds != nullptr;
  const uint32_t seed = drop ? args.drop.seeds[b] : 0u;
  const uint16_t* Qw =
      reinterpret_cast<const uint16_t*>(smem) + warp * 16 * kPitch;
  unsigned char* stages = smem + kTileBytes;

  load_tile(reinterpret_cast<uint16_t*>(smem), args.q, b, h, i0, args.Tq);
  load_kv_stage(stages, args, b, h, 0);
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
      load_kv_stage(stages + ((it + 1) & 1) * kKvStage, args, b, h,
                    j0 + kRows);
      cp_async_commit();
    }
    const unsigned char* st = stages + (it & 1) * kKvStage;
    const uint16_t* Ks = reinterpret_cast<const uint16_t*>(st);
    const uint16_t* Vs = reinterpret_cast<const uint16_t*>(st + kTileBytes);
    const float* Bs = reinterpret_cast<const float*>(st + 2 * kTileBytes);

    float s[8][4];
    tc::zero(s);
    mma_rows<8>(s, Qw, Ks, lane);

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
      corr[r] = ex2((m[r] - m_new) * kLog2e);
      l[r] *= corr[r];
      lr[r] *= corr[r];
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
        bits = tc::row_keep_bits(args.drop, seed, ia, j0 + n * 8, h, t);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2((s[n][e] - m[e >> 1]) * kLog2e);
        const float pb = round_bf16(p);
        l[e >> 1] += p;
        lr[e >> 1] += pb;
        s[n][e] = (!drop || tc::row_keep(bits, e >> 1, e & 1, t)) ? pb : 0.f;
      }
    }
    mma_cols<kTermsPV, 4>(o, elems(s), Vs, lane);
  }

  const long long stat0 = (static_cast<long long>(b) * args.H + h) * args.Tq;
  const float keep_scale = drop ? args.drop.scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], x);
      lr[r] += __shfl_xor_sync(0xffffffffu, lr[r], x);
    }
    const int i = ia + 8 * r;
    if (i >= args.Tq) continue;
    if (args.stats != nullptr && t == 0) {
      args.stats[2 * (stat0 + i)] = m[r];
      args.stats[2 * (stat0 + i) + 1] = l[r];
    }
    const float inv = keep_scale / lr[r];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float v0 = o[n][2 * r] * inv, v1 = o[n][2 * r + 1] * inv;
      st2(args.o, b, i, h, n * 8 + 2 * t, v0, v1);
      if (args.o32.ptr != nullptr) st2(args.o32, b, i, h, n * 8 + 2 * t, v0,
                                       v1);
    }
  }
}

// ---------------------------------------------------------------- dq

// dynamic shared memory: Q and dO tiles, then two [K, V, biases] stages
constexpr int kDqSmem = 2 * kTileBytes + 2 * kKvStage;

__global__ void __launch_bounds__(kThreads, 4)
attn_bf16_dq_kernel(const AttnBwdArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnArgs& f = args.f;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const int ia = i0 + warp * 16 + gid;
  const bool drop = f.drop.seeds != nullptr;
  const uint32_t seed = drop ? f.drop.seeds[b] : 0u;
  const long long stat0 = (static_cast<long long>(b) * f.H + h) * f.Tq;
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* dOs = reinterpret_cast<uint16_t*>(smem + kTileBytes);
  unsigned char* stages = smem + 2 * kTileBytes;

  load_tile(Qs, f.q, b, h, i0, f.Tq);
  load_tile(dOs, args.dout, b, h, i0, f.Tq);
  load_kv_stage(stages, f, b, h, 0);
  cp_async_commit();

  // delta = rowsum(dO∘O32) while the copies fly: lanes 2r, 2r + 1 take row
  // r of the warp's 16, 32 channels each
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
      load_kv_stage(stages + ((it + 1) & 1) * kKvStage, f, b, h, j0 + kRows);
      cp_async_commit();
    }
    const unsigned char* st = stages + (it & 1) * kKvStage;
    const uint16_t* Ks = reinterpret_cast<const uint16_t*>(st);
    const uint16_t* Vs = reinterpret_cast<const uint16_t*>(st + kTileBytes);
    const float* Bs = reinterpret_cast<const float*>(st + 2 * kTileBytes);

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
        const float2 bias = *reinterpret_cast<const float2*>(Bs + jj);
        uint2 bits = make_uint2(0u, 0u);
        if (drop) {
          bits = tc::row_keep_bits(f.drop, seed, ia, j0 + jh + n * 8, h, t);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = e & 1;
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
      mma_cols<kTermsDSK, 2>(dq, elems(s), Ks + jh * kPitch, lane);
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

// ---------------------------------------------------------------- dk/dv

// a stage: [Q tile, dO tile, 64 (max, sum) pairs, 64 deltas]
constexpr int kQStage = 2 * kTileBytes + 3 * kRows * 4;
// dynamic shared memory: the block's K and V tiles, then two stages
constexpr int kDkvSmem = 2 * kTileBytes + 2 * kQStage;

__device__ __forceinline__ void load_q_stage(unsigned char* st,
                                             const AttnBwdArgs& args, int b,
                                             int h, int i0) {
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
}

__global__ void __launch_bounds__(kThreads, 3)
attn_bf16_dkdv_kernel(const AttnBwdArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnArgs& f = args.f;
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Vs = reinterpret_cast<uint16_t*>(smem + kTileBytes);
  unsigned char* stages = smem + 2 * kTileBytes;
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
      load_q_stage(stages + ((it + 1) & 1) * kQStage, args, b, h,
                   i0 + kRows);
      cp_async_commit();
    }
    const unsigned char* st = stages + (it & 1) * kQStage;
    const uint16_t* Qs = reinterpret_cast<const uint16_t*>(st);
    const uint16_t* dOs = reinterpret_cast<const uint16_t*>(st + kTileBytes);
    const float* Ml = reinterpret_cast<const float*>(st + 2 * kTileBytes);
    const float* Dl = Ml + 2 * kRows;   // delta per query

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
                        philox4x32_10(make_uint4(group, q, h, 0u), seed, 0u),
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
            p[n][e] =
                ex2((p[n][e] * f.scale + bias[r] - ml.x) * kLog2e) * rinv;
          }
        }
      }
      const auto z = [&](int n, int e) {
        return !drop ? 1.f
               : ((bits[n] >> (4 * e + w)) & 1u) ? f.drop.scale : 0.f;
      };
      mma_cols<kTermsPDO, 2>(
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
      mma_cols<kTermsDSQ, 2>(dk, elems(dpt), Qs + ih * kPitch, lane);
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

// ---------------------------------------------------------------- launch

inline cudaError_t launch_attn_bf16_fwd(const AttnArgs& args, int B,
                                        cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      attn_bf16_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFwdSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((args.Tq + kRows - 1) / kRows, args.H, B);
  attn_bf16_fwd_kernel<<<grid, kThreads, kFwdSmem, stream>>>(args);
  return cudaGetLastError();
}

inline cudaError_t launch_attn_bf16_bwd(const AttnBwdArgs& args, int B,
                                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_bf16_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(attn_bf16_dkdv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkvSmem);
  }
  if (err != cudaSuccess) return err;
  // the dq kernel writes delta, which the dk/dv kernel reads: same stream
  dim3 grid_q((args.f.Tq + kRows - 1) / kRows, args.f.H, B);
  attn_bf16_dq_kernel<<<grid_q, kThreads, kDqSmem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_k((args.f.Tk + kRows - 1) / kRows, args.f.H, B);
  attn_bf16_dkdv_kernel<<<grid_k, kThreads, kDkvSmem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bf
}  // namespace daspeech
