// The 64-row tile primitives that the attention kernels and the DAG link
// kernels share, for Hopper (sm_90a), fp32:
//   - tc: the tensor-core side. Tiles of [64 rows][68 floats] copied by
//     cp.async, 3xTF32 mma.sync m16n8k8 fragments and the two tile products
//     (mma_rows: A·Tᵀ, k along the tile's rows; mma_cols: X·T with X in
//     accumulator layout), four warps of 16 rows. attention_tc.cuh's top
//     comment sets out the fragment layouts, the 3xTF32 split and why
//     kGroup k-steps share a fresh accumulator.
//     The dropout keep bits of a thread's accumulator fragments
//     (row_keep_bits, row_keep) are here too: the bf16 kernels
//     (tiles_bf16.cuh) draw them the same way.
//   - fma: the fp32 FMA side. 256 threads, thread (ty, tx) = (tid / 16,
//     tid % 16) owning a 4-row x 4-key micro-tile (rows 4 ty .., keys
//     tx + 16 u) of a 64 x 64 score tile, fed by 16-byte shared-memory
//     reads (attention_fma.cuh's top comment).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention.cuh"

namespace daspeech {
namespace tc {
// internal linkage: several sources include this header
namespace {

constexpr int kDepth = 64;            // head depth
constexpr int kRows = 64;             // rows of a tile (queries or keys)
constexpr int kWarps = 4;             // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kPitch = kDepth + 4;    // floats per shared-memory tile row
constexpr int kTile = kRows * kPitch; // floats in one tile

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
// (attention_tc.cuh, "Accumulation"; tools/torch_attention_accumulation.py
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
// 2t + 1), fed as A with relabelled k slots (attention_tc.cuh, "Fragment
// layouts")
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

// keep bits of one Philox draw: bit w = word w <= thresh
__device__ __forceinline__ uint32_t keep4(const uint4& r, uint32_t thresh) {
  return static_cast<uint32_t>(r.x <= thresh) |
         (static_cast<uint32_t>(r.y <= thresh) << 1) |
         (static_cast<uint32_t>(r.z <= thresh) << 2) |
         (static_cast<uint32_t>(r.w <= thresh) << 3);
}

// The head word of the dropout counter: local head h offset by the call's
// first head (AttnArgs::h0), except in the full-bias mode (FULL), whose
// counters stay its own.
template <bool FULL = false>
__device__ __forceinline__ int drop_head(const AttnArgs& f, int h) {
  return FULL ? h : h + static_cast<int>(f.h0);
}

// blockIdx.y read where it is used (a volatile read of %ctaid.y): the bf16
// rel-pos dS kernel, at its register bound, keeps the dropout counter's
// head (drop_head) in a register across its step loop and takes the tile's
// head from the grid at each load and store instead (one more live
// register spilled 16 bytes)
__device__ __forceinline__ int grid_head() {
  uint32_t y;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(y));
  return static_cast<int>(y);
}

// Forward, dq and dS kernels: keep bits of 8-key block j8 (keys j8 ..
// j8 + 7) for this thread's rows ia (half 0) and ia + 8 (half 1). Thread t
// draws (row half t & 1, group j8 / 4 + t / 2); the pair t, t ^ 1 swaps
// draws. Returns (own, other): the draw of half t & 1 and of the other
// half; key j8 + 2t + c of either half is bit 2 (t & 1) + c. c3 is the
// fourth counter word: the batch row in the full-bias mode, else 0.
__device__ __forceinline__ uint2 row_keep_bits(const DropoutArgs& d,
                                               uint32_t seed, int ia, int j8,
                                               int h, int t,
                                               uint32_t c3 = 0u) {
  const int row = ia + 8 * (t & 1);
  const uint32_t own = keep4(
      philox4x32_10(make_uint4((j8 >> 2) + (t >> 1), row, h, c3), seed, 0u),
      d.thresh);
  return make_uint2(own, __shfl_xor_sync(0xffffffffu, own, 1));
}

__device__ __forceinline__ bool row_keep(uint2 bits, int half, int c, int t) {
  const uint32_t m = (half == (t & 1)) ? bits.x : bits.y;
  return (m >> (2 * (t & 1) + c)) & 1u;
}

// rows r0 .. r0 + 63 of a [rows, 64] operand view into a tile; rows past
// `rows` are zero-filled
__device__ __forceinline__ void load_tile(float* tile, const Operand& x,
                                          int b, int h, int r0, int rows) {
  load_rows64<kThreads, kPitch>(tile, x, b, h, r0, rows);
}

// rows r0 .. r0 + 63, columns c0 .. c0 + 63 of a row-major [rows, cols]
// matrix into a tile, zero outside; 16-byte copies when rows stay aligned
__device__ __forceinline__ void load_matrix_tile(float* tile, const float* m,
                                                 int rows, int cols, int r0,
                                                 int c0) {
  if ((cols & 3) == 0) {
    for (int c = threadIdx.x; c < kRows * 16; c += kThreads) {
      const int rr = c >> 4, cc = (c & 15) * 4, r = r0 + rr, j = c0 + cc;
      const bool ok = r < rows && j < cols;
      cp_async<16>(tile + rr * kPitch + cc,
                   m + (ok ? static_cast<long long>(r) * cols + j : 0), ok);
    }
  } else {
    for (int c = threadIdx.x; c < kRows * kRows; c += kThreads) {
      const int rr = c >> 6, cc = c & 63, r = r0 + rr, j = c0 + cc;
      const bool ok = r < rows && j < cols;
      cp_async<4>(tile + rr * kPitch + cc,
                  m + (ok ? static_cast<long long>(r) * cols + j : 0), ok);
    }
  }
}

}  // namespace
}  // namespace tc

namespace fma {
namespace {

constexpr int kRows = 64;             // query rows of a block, keys of a tile
constexpr int kThreads = 256;         // 16 x 16 threads of 4 x 4 each
constexpr int kPitch = 64 + 4;        // floats per shared-memory tile row
constexpr int kTile = kRows * kPitch; // floats in one tile

__device__ __forceinline__ void load_tile(float* tile, const Operand& x,
                                          int b, int h, int r0, int rows) {
  load_rows64<kThreads, kPitch>(tile, x, b, h, r0, rows);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s[r][u] += X[4 ty + r] . Y[tx + 16 u] over one 64-deep chunk, channel by
// channel in order; X and Y point at the thread's first row and key
__device__ __forceinline__ void score_chunk(float s[4][4], const float* X,
                                            const float* Y) {
#pragma unroll
  for (int c = 0; c < 64; c += 4) {
    float4 q[4], k[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) q[r] = lds4(X + r * kPitch + c);
#pragma unroll
    for (int u = 0; u < 4; ++u) k[u] = lds4(Y + 16 * u * kPitch + c);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float acc = s[r][u];
        acc = fmaf(q[r].x, k[u].x, acc);
        acc = fmaf(q[r].y, k[u].y, acc);
        acc = fmaf(q[r].z, k[u].z, acc);
        acc = fmaf(q[r].w, k[u].w, acc);
        s[r][u] = acc;
      }
    }
  }
}

}  // namespace
}  // namespace fma
}  // namespace daspeech
