// Tensor-core fp32 attention for Hopper (sm_90a) for the packed and
// head-major multi-head attention entry points of fused_attention.cu (head
// depth 64, a [B, Tk] column bias, Philox dropout): the backward, and the
// forward where no softmax statistics are asked for (inference). The
// training forward, the full-bias and the rel-pos kernels keep the SIMT
// template of attention.cuh, whose argument structs (AttnArgs,
// AttnBwdArgs) this header shares; see "Accumulation" for why.
//
// Precision: fp32 in and out; every matrix product runs on the tensor cores
// as 3xTF32. Each operand x is split into hi = cvt.rna.tf32(x) and
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
// forward stays at it. So training runs attention.cuh's fp32 forward,
// which writes the statistics this backward reads, and inference, where
// each output only has to match to 1e-4, runs this one.
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
// Dropout draws the bits attention.cuh draws: word (j % 4) of
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

namespace daspeech {
namespace tc {

constexpr int kDepth = 64;            // head depth
constexpr int kRows = 64;             // rows of a tile (queries or keys)
constexpr int kWarps = 4;             // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kPitch = kDepth + 4;    // floats per shared-memory tile row
constexpr int kTile = kRows * kPitch; // floats in one tile

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in 3xTF32, a given split, b = (b0, b1) split here
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4],
                                     const uint32_t al[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void split4(const float a[4], uint32_t hi[4],
                                       uint32_t lo[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(a[e], hi[e], lo[e]);
}

// A fragment of k-step kk from 16 rows of a shared-memory tile (row pitch
// kPitch), k along the row
__device__ __forceinline__ void a_from_rows(const float* A, int kk, int gid,
                                            int t, float a[4]) {
  const float* r0 = A + gid * kPitch + kk * 8 + t;
  const float* r1 = r0 + 8 * kPitch;
  a[0] = r0[0];
  a[1] = r1[0];
  a[2] = r0[4];
  a[3] = r1[4];
}

// k-steps of a product summed in one fresh accumulator before an fp32 add
// folds them into the result; 0 would accumulate every k-step in place
// (see "Accumulation" at the top; tools/torch_attention_accumulation.py
// builds copies with other values)
constexpr int kGroup = 4;
static_assert(kGroup == 0 || 8 % kGroup == 0, "k-step groups must tile 8");

// c += a·b for the kGroup (or, G == 0, one) k-steps of a group: in place
// (G == 0) or in a fresh accumulator added to c afterwards
template <int G, class MmaStep>
__device__ __forceinline__ void mma_group(float c[4], MmaStep step) {
  if constexpr (G == 0) {
    step(c, 0);
  } else {
    float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < G; ++u) step(f, u);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += f[e];
  }
}

// acc[n] (16 x 8 block n of a 16 x 64 result) += A · Tᵀ over the 64 columns:
// result[m][n*8 + c] = sum_k A[m][k] T[n*8 + c][k]. load_a(kk, a) gives A's
// fragment of k-step kk. G: k-steps per fresh accumulator, 0 = in place.
template <int G, class LoadA>
__device__ __forceinline__ void mma_rows(float acc[8][4], LoadA load_a,
                                         const float* T, int gid, int t) {
  constexpr int S = G == 0 ? 1 : G;
#pragma unroll
  for (int k0 = 0; k0 < 8; k0 += S) {
    uint32_t ah[S][4], al[S][4];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      float a[4];
      load_a(k0 + u, a);
      split4(a, ah[u], al[u]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mma_group<G>(acc[n], [&](float c[4], int u) {
        const float* r = T + (n * 8 + gid) * kPitch + (k0 + u) * 8 + t;
        mma3(c, ah[u], al[u], r[0], r[4]);
      });
    }
  }
}

// acc[n] += X · T[:, n*8 ..]: result[m][n*8 + c] = sum_k X[m][k] T[k][n*8 + c]
// with X (16 x 64) held in accumulator layout x[kk][.] (columns kk*8 + 2t,
// 2t + 1), fed as A with relabelled k slots (see the note at the top)
template <int G>
__device__ __forceinline__ void mma_cols(float acc[8][4], const float x[8][4],
                                         const float* T, int gid, int t) {
  constexpr int S = G == 0 ? 1 : G;
#pragma unroll
  for (int k0 = 0; k0 < 8; k0 += S) {
    uint32_t ah[S][4], al[S][4];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int kk = k0 + u;
      const float a[4] = {x[kk][0], x[kk][2], x[kk][1], x[kk][3]};
      split4(a, ah[u], al[u]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mma_group<G>(acc[n], [&](float c[4], int u) {
        const float* r = T + ((k0 + u) * 8 + 2 * t) * kPitch + gid + n * 8;
        mma3(c, ah[u], al[u], r[0], r[kPitch]);
      });
    }
  }
}

__device__ __forceinline__ void zero(float x[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
  }
}

// cp.async of 16, 8 or 4 bytes; zero-fills the destination when !valid
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(N), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows r0 .. r0 + 63 of a [rows, 64] operand view into a tile; rows past
// `rows` are zero-filled
__device__ __forceinline__ void load_tile(float* tile, const Operand& x,
                                          int b, int h, int r0, int rows) {
  for (int c = threadIdx.x; c < kRows * 16; c += kThreads) {
    const int rr = c >> 4, col = (c & 15) * 4, r = r0 + rr;
    const bool ok = r < rows;
    cp_async<16>(tile + rr * kPitch + col, x.at(b, ok ? r : 0, h) + col, ok);
  }
}

// keep bits of one Philox draw: bit w = word w <= thresh
__device__ __forceinline__ uint32_t keep4(const uint4& r, uint32_t thresh) {
  return static_cast<uint32_t>(r.x <= thresh) |
         (static_cast<uint32_t>(r.y <= thresh) << 1) |
         (static_cast<uint32_t>(r.z <= thresh) << 2) |
         (static_cast<uint32_t>(r.w <= thresh) << 3);
}

// Forward and dq kernels: keep bits of 8-key block j8 (keys j8 .. j8 + 7)
// for this thread's rows ia (half 0) and ia + 8 (half 1). Thread t draws
// (row half t & 1, group j8 / 4 + t / 2); the pair t, t ^ 1 swaps draws.
// Returns (own, other): the draw of half t & 1 and of the other half; key
// j8 + 2t + c of either half is bit 2 (t & 1) + c.
__device__ __forceinline__ uint2 row_keep_bits(const DropoutArgs& d,
                                               uint32_t seed, int ia, int j8,
                                               int h, int t) {
  const int row = ia + 8 * (t & 1);
  const uint32_t own = keep4(
      philox4x32_10(make_uint4((j8 >> 2) + (t >> 1), row, h, 0u), seed, 0u),
      d.thresh);
  return make_uint2(own, __shfl_xor_sync(0xffffffffu, own, 1));
}

__device__ __forceinline__ bool row_keep(uint2 bits, int half, int c, int t) {
  const uint32_t m = (half == (t & 1)) ? bits.x : bits.y;
  return (m >> (2 * (t & 1) + c)) & 1u;
}

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
    const float* q0 = args.q.at(b, ok0 ? ia : 0, h);
    const float* q1 = args.q.at(b, ok1 ? ia + 8 : 0, h);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      qf[kk][0] = ok0 ? q0[kk * 8 + t] : 0.f;
      qf[kk][1] = ok1 ? q1[kk * 8 + t] : 0.f;
      qf[kk][2] = ok0 ? q0[kk * 8 + t + 4] : 0.f;
      qf[kk][3] = ok1 ? q1[kk * 8 + t + 4] : 0.f;
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
    float* out = args.o.at(b, i, h);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(out + n * 8 + 2 * t) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
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
      const float4* pd =
          reinterpret_cast<const float4*>(args.dout.at(b, i, h) + c0);
      const float4* po = reinterpret_cast<const float4*>(f.o.at(b, i, h) + c0);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 x = pd[u], y = po[u];
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
    float* out = args.dq.at(b, i, h);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(out + n * 8 + 2 * t) =
          make_float2(dq[n][2 * r] * f.scale, dq[n][2 * r + 1] * f.scale);
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
    float* gk = args.dk.at(b, j, h);
    float* gv = args.dv.at(b, j, h);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(gk + n * 8 + 2 * t) =
          make_float2(dk[n][2 * r] * f.scale, dk[n][2 * r + 1] * f.scale);
      *reinterpret_cast<float2*>(gv + n * 8 + 2 * t) =
          make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
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

}  // namespace tc
}  // namespace daspeech
