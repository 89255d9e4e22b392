// The bf16 tile primitives that the bf16 attention (#1, #2; attention_bf16.cuh),
// rel-pos attention (#5; relpos_bf16.cuh) and link extraction (#4;
// links_bf16.cuh) kernels share, for Hopper's bf16 tensor cores (sm_90a):
// 64-row bf16 tiles at a pitch of 72 elements copied by 16-byte cp.async,
// operands by ldmatrix (.trans for a contraction along a tile's rows),
// mma.sync m16n8k16 with bf16 operands and fp32 accumulators, four warps of
// 16 rows, and ex2.approx for the softmax's exponentials.
// attention_bf16.cuh's top comment sets out the fragment layouts, the
// pitch and the one-term and two-term forms of an fp32 operand.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention.cuh"
#include "tiles.cuh"   // tc::zero, the dropout keep bits

namespace daspeech {
namespace bf {
// internal linkage: several sources include this header
namespace {

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

// rows r0 .. r0 + 63, columns c0 .. c0 + 63 of a row-major fp32 [rows,
// cols] matrix into a [64][pitch] fp32 tile, zero outside: 16-byte copies
// where every row stays 16-byte aligned (cols % 4 == 0), else 8- or 4-byte
// ones. The pitch sets which reads are free of bank conflicts: 72 for the
// 8-byte reads of an accumulator-layout row (a quad's four threads take 8
// consecutive floats), 68 for reads down a column (a warp's eight rows
// then lie 8 banks apart per pair of rows)
__device__ __forceinline__ void load_f32_tile(float* tile, int pitch,
                                              const float* m, int rows,
                                              int cols, int r0, int c0) {
  if ((cols & 3) == 0) {
#pragma unroll
    for (int u = 0; u < kRows * 16 / kThreads; ++u) {
      const int c = threadIdx.x + u * kThreads;
      const int rr = c >> 4, cc = (c & 15) * 4, r = r0 + rr, j = c0 + cc;
      const bool ok = r < rows && j < cols;
      cp_async<16>(tile + rr * pitch + cc,
                   m + (ok ? static_cast<long long>(r) * cols + j : 0), ok);
    }
  } else if ((cols & 1) == 0) {
#pragma unroll 4
    for (int u = 0; u < kRows * 32 / kThreads; ++u) {
      const int c = threadIdx.x + u * kThreads;
      const int rr = c >> 5, cc = (c & 31) * 2, r = r0 + rr, j = c0 + cc;
      const bool ok = r < rows && j < cols;
      cp_async<8>(tile + rr * pitch + cc,
                  m + (ok ? static_cast<long long>(r) * cols + j : 0), ok);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < kRows * 64 / kThreads; ++u) {
      const int c = threadIdx.x + u * kThreads;
      const int rr = c >> 6, cc = c & 63, r = r0 + rr, j = c0 + cc;
      const bool ok = r < rows && j < cols;
      cp_async<4>(tile + rr * pitch + cc,
                  m + (ok ? static_cast<long long>(r) * cols + j : 0), ok);
    }
  }
}

// The forward's online softmax of one 64-key tile: s holds the warp's 16
// rows of the tile's scores (q·k, before scale and bias; keys past Tk are
// masked here), Bs the tile's 64 column biases. Rescales o, the running max
// m, the fp32 sum l of exp(s − m) (the saved statistic) and the sum lr of
// the values P·V takes (the output's normalizer), and leaves in s those
// values, dropped where dropout drops it: the A operand of O += P·V. With
// PV_TERMS == 1, P·V takes exp(s − m) rounded to bf16, so lr sums the
// rounded values; with 2 it takes hi + lo, within 2^-16 of exp(s − m),
// and lr sums the unrounded ones.
template <int PV_TERMS>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4],
                                             float (&o)[8][4], float (&m)[2],
                                             float (&l)[2], float (&lr)[2],
                                             const float* Bs, int j0,
                                             const AttnArgs& args,
                                             uint32_t seed, int ia, int h,
                                             int t) {
  const bool drop = args.drop.seeds != nullptr;
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
      const float pb = PV_TERMS == 1 ? round_bf16(p) : p;
      l[e >> 1] += p;
      lr[e >> 1] += pb;
      s[n][e] = (!drop || tc::row_keep(bits, e >> 1, e & 1, t)) ? pb : 0.f;
    }
  }
}

// The forward's end: each row's statistics (a training forward) and its
// output, o / lr times 1/keep_p, in bf16 and (o32 given) in fp32
__device__ __forceinline__ void finish_forward(const AttnArgs& args, int b,
                                               int h, int ia, int t,
                                               const float (&o)[8][4],
                                               const float (&m)[2],
                                               float (&l)[2], float (&lr)[2]) {
  const bool drop = args.drop.seeds != nullptr;
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

// The backward's row statistics of the warp's 16 rows of the query tile at
// i0: delta = rowsum(dO∘O32), written to args.delta and returned for this
// thread's rows ia, ia + 8 (lanes 2r, 2r + 1 take row r of the warp's 16,
// 32 channels each), with each row's saved max and 1 / sum
__device__ __forceinline__ void backward_rows(const AttnBwdArgs& args, int b,
                                              int h, int i0, int warp,
                                              int lane, float (&delta)[2],
                                              float (&rmax)[2],
                                              float (&rinv)[2]) {
  const AttnArgs& f = args.f;
  const int gid = lane >> 2, ia = i0 + warp * 16 + gid;
  const long long stat0 = (static_cast<long long>(b) * f.H + h) * f.Tq;
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

}  // namespace
}  // namespace bf
}  // namespace daspeech
