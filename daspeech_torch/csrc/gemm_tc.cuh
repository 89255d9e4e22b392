// GEMM-shaped tensor-core tiles for Hopper (sm_90a), shared by the fused
// Conformer FFN (fused_ffn.cu, ffn_bf16.cuh) and the HiFi-GAN MRF level
// (fused_mrf.cu, mrf_bf16.cuh). fp32 modes: operands staged into shared
// memory already split into TF32 hi/lo planes, warp products of 3xTF32
// mma.sync m16n8k8 over them, and the cp.async copy of a 2-D chunk of a
// row-major matrix into a ring of raw fp32 tiles, several chunks ahead of
// the products. bf16 modes (the section "bf16 tiles" below): bf16 tiles
// copied as they are by 16-byte cp.async, fragments by ldmatrix (.trans
// for a tile whose rows are the contraction), one mma.sync m16n8k16 a
// k-step of 16 with fp32 accumulators.
//
// Precision (attention_tc.cuh's top comment, "Precision"): x = hi + lo with
// hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), and a·b is taken as
// lo·hi + hi·lo + hi·hi, each an mma.sync with fp32 accumulation. Here the
// split happens ONCE per element: an operand that several warps read is
// split when its tile is staged (put, RawChunk::split: each thread splits
// the elements its own cp.async copied, so no barrier sits between the
// copy landing and the split), and every fragment of it is then two plain
// 32-bit shared loads; an operand that exactly one warp reads (RawOp) is
// split as that warp loads its fragment. Each k-step's three products go
// into a fresh accumulator that an fp32 add folds into the result: the tensor
// cores' accumulation truncates, and a product chained over a 1408-deep
// conv or a 2048-deep FFN contraction in one accumulator would gather a
// bias toward zero that the fp32 add's rounding to nearest does not.
//
// Layouts: a plane holds a tile as [outer][inner] with a row pitch; its lo
// plane sits `plane` words after its hi plane. An operand is "k-outer" when
// the contraction index is the outer one ([k][m] for A, [k][n] for B; pitch
// ≡ 8 mod 32 makes the fragment loads t·pitch + gid conflict-free) or
// "k-inner" ([m][k], [n][k]; pitch ≡ 4 mod 32: gid·pitch + t). Fragments
// (gid = lane / 4, t = lane % 4): A 16x8 a0 (gid, t) a1 (gid+8, t)
// a2 (gid, t+4) a3 (gid+8, t+4); B 8x8 b0 (k=t, n=gid) b1 (k=t+4, n=gid);
// C 16x8 c0 (gid, 2t) c1 (gid, 2t+1) c2 (gid+8, 2t) c3 (gid+8, 2t+1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace daspeech {
namespace gemm {
// internal linkage: fused_ffn.cu and fused_mrf.cu each include this header
namespace {

// x rounded to bf16 (round to nearest even) when `round`, else x: a bf16
// product's operand, which TF32 holds exactly
__device__ __forceinline__ float bf16_if(float x, bool round) {
  return round ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// the hi and lo TF32 parts of x at word idx of a plane pair
__device__ __forceinline__ void put(uint32_t* hi, int plane, int idx,
                                    float x) {
  uint32_t h, l;
  tc::split(x, h, l);
  hi[idx] = h;
  hi[idx + plane] = l;
}

template <bool KOuter>
__device__ __forceinline__ int at(int pitch, int r, int k) {
  return KOuter ? k * pitch + r : r * pitch + k;
}

// A fragment of rows r0 .. r0 + 15, k-step k0 .. k0 + 7
template <bool KOuter>
__device__ __forceinline__ void frag_a(const uint32_t* p, int plane,
                                       int pitch, int r0, int k0, int gid,
                                       int t, uint32_t h[4], uint32_t l[4]) {
  const int i0 = at<KOuter>(pitch, r0 + gid, k0 + t);
  const int i1 = at<KOuter>(pitch, r0 + gid + 8, k0 + t);
  const int i2 = at<KOuter>(pitch, r0 + gid, k0 + t + 4);
  const int i3 = at<KOuter>(pitch, r0 + gid + 8, k0 + t + 4);
  h[0] = p[i0];
  h[1] = p[i1];
  h[2] = p[i2];
  h[3] = p[i3];
  l[0] = p[i0 + plane];
  l[1] = p[i1 + plane];
  l[2] = p[i2 + plane];
  l[3] = p[i3 + plane];
}

// B fragment of columns n0 .. n0 + 7, k-step k0 .. k0 + 7
template <bool KOuter>
__device__ __forceinline__ void frag_b(const uint32_t* p, int plane,
                                       int pitch, int n0, int k0, int gid,
                                       int t, uint32_t h[2], uint32_t l[2]) {
  const int i0 = at<KOuter>(pitch, n0 + gid, k0 + t);
  const int i1 = at<KOuter>(pitch, n0 + gid, k0 + t + 4);
  h[0] = p[i0];
  h[1] = p[i1];
  l[0] = p[i0 + plane];
  l[1] = p[i1 + plane];
}

// A staged operand: planes, lo-plane offset, pitch and the origin of this
// warp's part of it (rows or columns r0, contraction index k0)
struct Op {
  const uint32_t* p;
  int plane, pitch, r0, k0;
};

// A B operand kept as fp32 and split as its fragments load: for a tile of
// which each element feeds one warp only
struct RawOp {
  const float* p;
  int pitch, r0, k0;
};

template <bool KOuter>
__device__ __forceinline__ void frag_b(const Op& b, int n0, int k0, int gid,
                                       int t, uint32_t h[2], uint32_t l[2]) {
  frag_b<KOuter>(b.p, b.plane, b.pitch, n0, k0, gid, t, h, l);
}

template <bool KOuter>
__device__ __forceinline__ void frag_b(const RawOp& b, int n0, int k0,
                                       int gid, int t, uint32_t h[2],
                                       uint32_t l[2]) {
  tc::split(b.p[at<KOuter>(b.pitch, n0 + gid, k0 + t)], h[0], l[0]);
  tc::split(b.p[at<KOuter>(b.pitch, n0 + gid, k0 + t + 4)], h[1], l[1]);
}

// d = a·b (m16n8k8, tf32, fp32 out) with a zero accumulator: the fresh
// accumulator of a group needs no zeroed registers
__device__ __forceinline__ void mma_tf32_0(float d[4], const uint32_t a[4],
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// acc[m][n] (the 16 x 8 block at rows a.r0 + 16 m, columns b.r0 + 8 n) +=
// A · B over KS k-steps, each k-step's 3xTF32 products in a fresh
// accumulator folded in by an fp32 add
template <int MT, int NT, int KS, bool AK, bool BK, class BOp>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const Op& a, const BOp& b) {
  const int lane = threadIdx.x % 32, gid = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < KS; ++u) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      frag_a<AK>(a.p, a.plane, a.pitch, a.r0 + 16 * m, a.k0 + 8 * u, gid, t,
                 ah[m], al[m]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bh[2], bl[2];
      frag_b<BK>(b, b.r0 + 8 * n, b.k0 + 8 * u, gid, t, bh, bl);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float f[4];
        mma_tf32_0(f, al[m], bh[0], bh[1]);
        tc::mma_tf32(f, ah[m], bl[0], bl[1]);
        tc::mma_tf32(f, ah[m], bh[0], bh[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] += f[e];
      }
    }
  }
}

// ---- bf16 tiles (ffn_bf16.cuh, mrf_bf16.cuh) ------------------------------
// A bf16 tile lies in shared memory row-major with a pitch (in elements) of
// 8 more than a multiple of 8 (tile width + 8): the eight 16-byte rows an
// ldmatrix phase reads then fall on distinct banks, and every row stays
// 16-byte aligned for cp.async. Fragments come by ldmatrix.x4, with .trans
// where the tile is stored with the contraction index as its rows.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t r[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t r[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a·b, m16n8k16, bf16 operands, fp32 accumulators (chained in place:
// the accumulation's truncation bias, ~2^-23 relative an add, is far below
// bf16's rounding)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m][n] (the 16 x 8 block at rows 16 m, columns 8 n of this warp's
// result) += A · B over KS k-steps of 16. A: the warp's 16 MT rows, at `a`
// (row 0, k 0) with pitch ap, stored [m][k] or, with AT, [k][m]; B: its
// 8 NB columns at `b` (column 0, k 0) with pitch bp, stored [n][k] or,
// with BT, [k][n]. Each k-step's sums chain in the accumulators in order.
template <int MT, int NB, int KS, bool AT, bool BT>
__device__ __forceinline__ void warp_mma_bf16(float (&acc)[MT][NB][4],
                                              const uint16_t* a, int ap,
                                              const uint16_t* b, int bp) {
  static_assert(NB % 2 == 0, "B fragments come two 8-column blocks a load");
  const int lane = threadIdx.x % 32;
  // ldmatrix.x4: lane l gives the address of row l % 8 of matrix l / 8;
  // A's matrices (a0 .. a3) are (rows 0-7, k 0-7), (8-15, 0-7), (0-7,
  // 8-15), (8-15, 8-15); B's (b0, b1 of block 2np, then of 2np + 1) are
  // (k 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  const uint16_t* pa =
      AT ? a + ((lane >> 4) * 8 + (lane & 7)) * ap + ((lane >> 3) & 1) * 8
         : a + (lane & 15) * ap + (lane >> 4) * 8;
  const uint16_t* pb =
      BT ? b + (((lane >> 3) & 1) * 8 + (lane & 7)) * bp + (lane >> 4) * 8
         : b + ((lane >> 4) * 8 + (lane & 7)) * bp + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int u = 0; u < KS; ++u) {
    uint32_t af[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if constexpr (AT) {
        ldsm4_t(af[m], pa + 16 * m + 16 * u * ap);
      } else {
        ldsm4(af[m], pa + 16 * m * ap + 16 * u);
      }
    }
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t bf[4];
      if constexpr (BT) {
        ldsm4_t(bf, pb + 16 * np + 16 * u * bp);
      } else {
        ldsm4(bf, pb + 16 * np * bp + 16 * u);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(acc[m][2 * np], af[m], bf[0], bf[1]);
        mma_bf16(acc[m][2 * np + 1], af[m], bf[2], bf[3]);
      }
    }
  }
}

// bf16 bits to fp32 (exact) and fp32 to bf16 bits (round to nearest even)
__device__ __forceinline__ float bf2f(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}
__device__ __forceinline__ uint16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
// two fp32 values as one word of bf16 bits, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(f2bf(lo)) |
         (static_cast<uint32_t>(f2bf(hi)) << 16);
}

// A ROWS x COLS chunk of a row-major bf16 matrix m (row stride ld
// elements) from row r0, column c0, into a tile [ROWS][pitch], zero outside
// [0, rmax) x [0, cmax). NT threads; thread tid owns the 8-column groups
// g = tid + i NT, (g / (COLS / 8), 8 (g % (COLS / 8))), each one 16-byte
// cp.async when `vec` (ld and cmax multiples of 8, m 16-byte aligned), else
// eight loads and stores of its own (visible, like the copies, after the
// barrier that precedes the tile's use).
template <int ROWS, int COLS, int NT>
struct BfChunk {
  static constexpr int kGroups = ROWS * COLS / 8;
  static constexpr int kIters = (kGroups + NT - 1) / NT;

  __device__ __forceinline__ static void copy(uint16_t* dst, int pitch,
                                              const uint16_t* m, long long ld,
                                              int r0, int c0, int rmax,
                                              int cmax, bool vec) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int g = static_cast<int>(threadIdx.x) + i * NT;
      if (kGroups % NT != 0 && g >= kGroups) break;
      const int r = g / (COLS / 8), c = 8 * (g % (COLS / 8));
      const int gr = r0 + r, gc = c0 + c;
      uint16_t* d = dst + r * pitch + c;
      if (vec) {
        const bool ok = gr < rmax && gc < cmax;
        cp_async<16>(d, ok ? m + gr * ld + gc : m, ok);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          d[u] = gr < rmax && gc + u < cmax ? m[gr * ld + gc + u]
                                            : uint16_t(0);
        }
      }
    }
  }
};

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    }
  }
}

// A ROWS x COLS chunk of a row-major matrix m (row stride ld) from row r0,
// column c0, copied by cp.async into a raw fp32 tile [ROWS][pitch], zero
// outside [0, rmax) x [0, cmax). NT threads; thread tid owns the 4-column
// groups g = tid + i NT, (g / (COLS / 4), 4 (g % (COLS / 4))), copied as
// one 16-byte cp.async each when `vec` (ld and cmax multiples of 4, m
// 16-byte aligned), else as four 4-byte ones.
template <int ROWS, int COLS, int NT>
struct RawChunk {
  static constexpr int kGroups = ROWS * COLS / 4;
  static constexpr int kIters = (kGroups + NT - 1) / NT;

  __device__ __forceinline__ static void copy(float* dst, int pitch,
                                              const float* m, long long ld,
                                              int r0, int c0, int rmax,
                                              int cmax, bool vec) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int g = static_cast<int>(threadIdx.x) + i * NT;
      if (kGroups % NT != 0 && g >= kGroups) break;
      const int r = g / (COLS / 4), c = 4 * (g % (COLS / 4));
      const int gr = r0 + r, gc = c0 + c;
      float* d = dst + r * pitch + c;
      if (vec) {
        const bool ok = gr < rmax && gc < cmax;
        cp_async<16>(d, ok ? m + gr * ld + gc : m, ok);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = gr < rmax && gc + u < cmax;
          cp_async<4>(d + u, ok ? m + gr * ld + gc + u : m, ok);
        }
      }
    }
  }

  // this thread's elements of a raw tile [ROWS][rpitch] split into the
  // plane pair at hi, [ROWS][pitch]; with `round`, each first rounded to
  // bf16 (round to nearest even), so its lo part is 0
  __device__ __forceinline__ static void split(const float* raw, int rpitch,
                                               uint32_t* hi, int plane,
                                               int pitch,
                                               bool round = false) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int g = static_cast<int>(threadIdx.x) + i * NT;
      if (kGroups % NT != 0 && g >= kGroups) break;
      const int r = g / (COLS / 4), c = 4 * (g % (COLS / 4));
      const float4 v = *reinterpret_cast<const float4*>(raw + r * rpitch + c);
      const int o = r * pitch + c;
      put(hi, plane, o, bf16_if(v.x, round));
      put(hi, plane, o + 1, bf16_if(v.y, round));
      put(hi, plane, o + 2, bf16_if(v.z, round));
      put(hi, plane, o + 3, bf16_if(v.w, round));
    }
  }
};

}  // namespace
}  // namespace gemm
}  // namespace daspeech
