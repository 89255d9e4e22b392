// bf16 DAG link extraction (#4) on Hopper's bf16 tensor cores (sm_90a): the
// kernels of daspeech_links_{fwd,bwd}_bf16 in fused_links.cu, which
// includes this header after its shared pieces (LinksArgs, link_valid,
// graph_len, packed, the live-tile ranges, the floor). They replace the
// bf16 mode of the Pallas kernels of daspeech_tpu/ops/fused_links.py:141
// (fused_extract_links: forward _links_fwd_kernel :70, backward
// _links_bwd_kernel :91), which upcast bf16 q and k to f32, write f32 links
// and dgates and cast dq and dk to bf16 (fused_links.py:62-66, :177-199).
// The fp32 entry points keep fused_links.cu's kernels.
//
// The same four launches as fused_links.cu's, over the same live 64 x 64
// tiles (fused_links.cu, "Live tiles": the same -inf pattern, no
// [B, H, L, L] buffer, no atomics), with the head's score tile
// S_h = Q_h·K_hᵀ as one bf16 mma.sync m16n8k16 chain of four 16-deep
// k-steps with fp32 accumulators (tiles_bf16.cuh's mma_rows): the products
// of bf16 inputs are exact, and the one difference from the plain bf16
// version's fp32 sums is the tensor cores' truncating accumulation over 64
// terms (about 1e-6 of a score at these magnitudes), far inside the 1e-4
// the links are held to. So the forward, which the fp32 path keeps on the
// FMA pipes for the DAG loss (fused_links.cu), runs on the tensor cores
// here. Tiles are bf16 at a pitch of 72 elements by 16-byte cp.async,
// double-buffered; four warps of 16 rows (or, dk, keys) a block:
//   1. links_bf16_lse_kernel, one block per (row tile, head, batch row):
//      the Q_h tile resident, the live K_h tiles streamed; each thread an
//      online (max, sum) of its 16 columns of its rows ia, ia + 8 per tile,
//      merged over its quad at the end: lse_h [B, L, H];
//   2. links_bf16_fold_kernel, one block per (column tile, row tile, batch
//      row): a dead pair writes -inf; a live one streams (Q_h, K_h, lse_h,
//      log_gates_h) per head and folds s − lse_h + g_h into a per-entry
//      running (max, sum) over heads (one exp an entry and head);
//   3. links_bf16_dq_kernel, one block per (row tile, head, batch row): a
//      sweep over the live column tiles for r = dgates, a second for dS
//      and dq += dS·K (K_h by ldmatrix.trans);
//   4. links_bf16_dk_kernel, one block per (column tile, head, batch row):
//      per live row tile Sᵀ = K·Qᵀ, dSᵀ from the stored r, dk += dSᵀ·Q.
// The links and dlinks tiles of the backward are fp32, [64][72] where a
// quad reads 8 consecutive floats (dq) and [64][68] where a warp reads
// down a column (dk) (load_f32_tile). Measured (chip_smoke.py, NVIDIA H100
// 80GB HBM3 at 700 W; PERF.md §6): at cell T [80, 240] the lse kernel takes
// 0.035 ms of device time, the fold 0.056, dq 0.168 and dk 0.101; dq and
// dk read each live tile's fp32 links and dlinks once per head and sweep.
//
// Rounding of dS (tests/test_torch_bf16_links.py decides it and holds the
// constants below): dS is fp32; dS·K and dSᵀ·Q take it one-term (rounded
// to bf16, one MMA) or two-term (hi + lo, two MMAs), one-term wherever dq
// and dk stay within a quarter of the 2^-7 bar of float64 at the test's
// cases. r = dgates is an fp32 sum of fp32 terms and takes no rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "tiles.cuh"
#include "tiles_bf16.cuh"

namespace daspeech {
namespace bf {
namespace {

// MMAs per product of dS (1: one-term, 2: two-term); see "Rounding of dS"
constexpr int kTermsLinksDSK = 2;   // dq += dS·K
constexpr int kTermsLinksDSQ = 2;   // dk += dSᵀ·Q

// ----------------------------------------------------------- forward: lse

// dynamic shared memory: the row tile's Q_h, then two stages of K_h tiles
constexpr int kLinksLseSmem = 3 * kTileBytes;

__global__ void __launch_bounds__(kThreads, 4)
links_bf16_lse_kernel(const LinksArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* const Qs = reinterpret_cast<uint16_t*>(smem);
  unsigned char* const stages = smem + kTileBytes;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int ia = i0 + warp * 16 + gid;       // rows ia, ia + 8
  const int L = a.L, ol = graph_len(a, b);
  const Operand q = packed(a.q, a), k = packed(a.k, a);
  const int2 tiles = live_col_tiles(i0, L, ol, a.mtl);

  if (tiles.y > 0) {
    load_tile(Qs, q, b, h, i0, L);
    load_tile(reinterpret_cast<uint16_t*>(stages), k, b, h,
              tiles.x * kRows, L);
    cp_async_commit();
  }
  float m[2] = {kLinksNone, kLinksNone}, l[2] = {0.f, 0.f};
  for (int st = 0; st < tiles.y; ++st) {
    const int j0 = (tiles.x + st) * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < tiles.y) {
      load_tile(reinterpret_cast<uint16_t*>(stages +
                                            ((st + 1) & 1) * kTileBytes),
                k, b, h, j0 + kRows, L);
      cp_async_commit();
    }
    float s[8][4];
    tc::zero(s);
    mma_rows<8>(s, Qs + warp * 16 * kPitch,
                reinterpret_cast<const uint16_t*>(stages +
                                                  (st & 1) * kTileBytes),
                lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = ia + 8 * r;
      float x[16], mx = m[r];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = j0 + n * 8 + 2 * t + c;
          // columns past L take no part in the row's normalizer
          x[2 * n + c] = j >= L                         ? -INFINITY
                         : link_valid(i, j, ol, a.mtl) ? s[n][2 * r + c] *
                                                              a.scale
                                                        : kLinksFloor;
          mx = fmaxf(mx, x[2 * n + c]);
        }
      }
      float sum = l[r] * expf(m[r] - mx);
#pragma unroll
      for (int u = 0; u < 16; ++u) sum += expf(x[u] - mx);
      m[r] = mx;
      l[r] = sum;
    }
  }

  // merge the row's quad: (max, sum) of (m, l)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mr = m[r];
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    float sum = l[r] * expf(m[r] - mr);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int i = ia + 8 * r;
    if (t == 0 && i < L) {
      // a row of a live tile has a column < L, so mr >= the floor
      a.lse_out[(static_cast<long long>(b) * L + i) * a.H + h] =
          tiles.y > 0 ? logf(sum) + mr : kLinksFloor;
    }
  }
}

// ---------------------------------------------------------- forward: fold

// a stage: the Q_h and K_h tiles, then lse_h and log_gates_h of the 64 rows
constexpr int kLinksFoldStage = 2 * kTileBytes + 2 * kRows * 4;
constexpr int kLinksFoldSmem = 2 * kLinksFoldStage;

__device__ __forceinline__ void load_links_fold_stage(unsigned char* st,
                                                      const LinksArgs& a,
                                                      int b, int h, int i0,
                                                      int j0) {
  load_tile(reinterpret_cast<uint16_t*>(st), packed(a.q, a), b, h, i0, a.L);
  load_tile(reinterpret_cast<uint16_t*>(st + kTileBytes), packed(a.k, a), b,
            h, j0, a.L);
  const int x = threadIdx.x;   // 128 threads: lse_h (x < 64), then g_h
  const int i = i0 + (x & (kRows - 1));
  const bool ok = i < a.L;
  const long long at = (static_cast<long long>(b) * a.L + (ok ? i : 0)) *
                           a.H + h;
  cp_async<4>(reinterpret_cast<float*>(st + 2 * kTileBytes) + x,
              (x < kRows ? a.lse : a.g) + at, ok);
}

__global__ void __launch_bounds__(kThreads, 3)
links_bf16_fold_kernel(const LinksArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kRows, i0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int wrow = warp * 16 + gid;          // rows wrow, wrow + 8 of the tile
  const int L = a.L, ol = graph_len(a, b);
  float* const out = a.links_out + static_cast<long long>(b) * L * L;
  const int2 tiles = live_col_tiles(i0, L, ol, a.mtl);
  const int tile = j0 / kRows;
  if (tile < tiles.x || tile >= tiles.x + tiles.y) {
    for (int idx = threadIdx.x; idx < kRows * kRows; idx += kThreads) {
      const int i = i0 + idx / kRows, j = j0 + idx % kRows;
      if (i < L && j < L) out[static_cast<long long>(i) * L + j] = -INFINITY;
    }
    return;
  }

  load_links_fold_stage(smem, a, b, 0, i0, j0);
  cp_async_commit();
  // per entry (accumulator layout): running max and sum of exp(v - max)
  // over the heads
  float rmax[8][4], rsum[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rmax[n][e] = -INFINITY;
      rsum[n][e] = 0.f;
    }
  }
  for (int h = 0; h < a.H; ++h) {
    cp_async_wait_all();
    __syncthreads();
    if (h + 1 < a.H) {
      load_links_fold_stage(smem + ((h + 1) & 1) * kLinksFoldStage, a, b,
                            h + 1, i0, j0);
      cp_async_commit();
    }
    const unsigned char* st = smem + (h & 1) * kLinksFoldStage;
    float s[8][4];
    tc::zero(s);
    mma_rows<8>(s, reinterpret_cast<const uint16_t*>(st) + warp * 16 * kPitch,
                reinterpret_cast<const uint16_t*>(st + kTileBytes), lane);
    const float* lse = reinterpret_cast<const float*>(st + 2 * kTileBytes);
    const float* gate = lse + kRows;
    float lg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lg[r] = gate[wrow + 8 * r] - lse[wrow + 8 * r];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wrow + 8 * (e >> 1);
        const int j = j0 + n * 8 + 2 * t + (e & 1);
        if (!link_valid(i, j, ol, a.mtl)) continue;
        // logsumexp over heads, one exp: of the two terms the larger is 1
        const float v = s[n][e] * a.scale + lg[e >> 1];
        const float d = v - rmax[n][e];
        const float x = expf(-fabsf(d));
        rsum[n][e] = d > 0.f ? fmaf(rsum[n][e], x, 1.f) : rsum[n][e] + x;
        rmax[n][e] = fmaxf(rmax[n][e], v);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + wrow + 8 * r;
    if (i >= L) continue;
    float* row = out + static_cast<long long>(i) * L;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = j0 + n * 8 + 2 * t;
      if (j >= L) continue;
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * r + c;
        v[c] = link_valid(i, j + c, ol, a.mtl)
                   ? logf(rsum[n][e]) + rmax[n][e]
                   : -INFINITY;
      }
      if ((L & 1) == 0) {                  // j even: j + 1 < L, aligned
        *reinterpret_cast<float2*>(row + j) = make_float2(v[0], v[1]);
      } else {
        row[j] = v[0];
        if (j + 1 < L) row[j + 1] = v[1];
      }
    }
  }
}

// ------------------------------------------------------------ backward: dq

// a stage: the K_h tile (bf16), then the links and dlinks tiles (fp32,
// pitch 72)
constexpr int kLinksF32Tile = kRows * 72 * 4;
constexpr int kLinksDqStage = kTileBytes + 2 * kLinksF32Tile;
// dynamic shared memory: the row tile's Q_h, then two stages
constexpr int kLinksDqSmem = kTileBytes + 2 * kLinksDqStage;

__device__ __forceinline__ void load_links_dq_stage(unsigned char* st,
                                                    const LinksArgs& a, int b,
                                                    int h, int i0, int j0) {
  const long long mat = static_cast<long long>(b) * a.L * a.L;
  float* f = reinterpret_cast<float*>(st + kTileBytes);
  load_tile(reinterpret_cast<uint16_t*>(st), packed(a.k, a), b, h, j0, a.L);
  load_f32_tile(f, 72, a.links + mat, a.L, a.L, i0, j0);
  load_f32_tile(f + kRows * 72, 72, a.dlinks + mat, a.L, a.L, i0, j0);
}

__global__ void __launch_bounds__(kThreads, 2)
links_bf16_dq_kernel(const LinksArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int wrow = warp * 16 + gid;          // the thread's rows in the tile
  const int ia = i0 + wrow;                  // rows ia, ia + 8
  const int L = a.L, ol = graph_len(a, b);
  const int2 tiles = live_col_tiles(i0, L, ol, a.mtl);
  const int nsteps = 2 * tiles.y;            // a sweep for r, one for dq
  uint16_t* const Qs = reinterpret_cast<uint16_t*>(smem);
  unsigned char* const stages = smem + kTileBytes;

  if (nsteps > 0) {
    load_tile(Qs, packed(a.q, a), b, h, i0, L);
    load_links_dq_stage(stages, a, b, h, i0, tiles.x * kRows);
    cp_async_commit();
  }
  float lse[2], gate[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = ia + 8 * r;
    const long long at = (static_cast<long long>(b) * L + (i < L ? i : 0)) *
                             a.H + h;
    lse[r] = i < L ? a.lse[at] : 0.f;
    gate[r] = i < L ? a.g[at] : 0.f;
  }

  float rsum[2] = {0.f, 0.f};
  float dq[8][4];
  tc::zero(dq);
  for (int st = 0; st < nsteps; ++st) {
    const bool second = st >= tiles.y;
    const int j0 = (tiles.x + st % tiles.y) * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < nsteps) {
      load_links_dq_stage(stages + ((st + 1) & 1) * kLinksDqStage, a, b, h,
                          i0, (tiles.x + (st + 1) % tiles.y) * kRows);
      cp_async_commit();
    }
    if (st == tiles.y) {
      // the first sweep is done: r of the rows, summed over the quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      }
    }
    const unsigned char* sp = stages + (st & 1) * kLinksDqStage;
    const uint16_t* Ks = reinterpret_cast<const uint16_t*>(sp);
    const float* Ls = reinterpret_cast<const float*>(sp + kTileBytes);
    const float* Gs = Ls + kRows * 72;
    float s[8][4];
    tc::zero(s);
    mma_rows<8>(s, Qs + warp * 16 * kPitch, Ks, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = wrow + 8 * (e >> 1), cc = n * 8 + 2 * t + (e & 1);
        const bool ok = link_valid(i0 + rr, j0 + cc, ol, a.mtl);
        const float sc = s[n][e] * a.scale - lse[e >> 1];
        const float pg =
            ok ? __expf(sc + gate[e >> 1] - Ls[rr * 72 + cc]) *
                     Gs[rr * 72 + cc]
               : 0.f;
        if (!second) {
          rsum[e >> 1] += pg;
        } else {
          s[n][e] = ok ? (pg - __expf(sc) * rsum[e >> 1]) * a.scale : 0.f;
        }
      }
    }
    if (second) mma_cols<kTermsLinksDSK, 4>(dq, elems(s), Ks, lane);
  }

  const View<float> out = packed(a.dq, a);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = ia + 8 * r;
    if (i >= L) continue;
    const long long row = static_cast<long long>(b) * L + i;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      st2(out, b, i, h, n * 8 + 2 * t, dq[n][2 * r], dq[n][2 * r + 1]);
    }
    if (t == 0) a.dg[row * a.H + h] = rsum[r];
  }
}

// ------------------------------------------------------------ backward: dk

// a stage: the Q_h tile (bf16), the links and dlinks tiles (fp32, pitch
// 68), then lse_h, log_gates_h and r_h of the 64 rows
constexpr int kLinksDkStage = kTileBytes + 2 * kRows * 68 * 4 + 3 * kRows * 4;
// dynamic shared memory: the column tile's K_h, then two stages
constexpr int kLinksDkSmem = kTileBytes + 2 * kLinksDkStage;

__device__ __forceinline__ void load_links_dk_stage(unsigned char* st,
                                                    const LinksArgs& a, int b,
                                                    int h, int i0, int j0) {
  const long long mat = static_cast<long long>(b) * a.L * a.L;
  float* f = reinterpret_cast<float*>(st + kTileBytes);
  load_tile(reinterpret_cast<uint16_t*>(st), packed(a.q, a), b, h, i0, a.L);
  load_f32_tile(f, 68, a.links + mat, a.L, a.L, i0, j0);
  load_f32_tile(f + kRows * 68, 68, a.dlinks + mat, a.L, a.L, i0, j0);
  float* rows = f + 2 * kRows * 68;
  for (int x = threadIdx.x; x < 3 * kRows; x += kThreads) {
    const int i = i0 + x % kRows, which = x / kRows;
    const bool ok = i < a.L;
    const float* src = which == 0 ? a.lse : which == 1 ? a.g : a.dg;
    cp_async<4>(rows + x,
                src + (static_cast<long long>(b) * a.L + (ok ? i : 0)) *
                          a.H + h,
                ok);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
links_bf16_dk_kernel(const LinksArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int wrow = warp * 16 + gid;          // the thread's keys in the tile
  const int ja = j0 + wrow;                  // keys ja, ja + 8
  const int L = a.L, ol = graph_len(a, b);
  const int2 tiles = live_row_tiles(j0, ol, a.mtl);
  uint16_t* const Ks = reinterpret_cast<uint16_t*>(smem);
  unsigned char* const stages = smem + kTileBytes;

  if (tiles.y > 0) {
    load_tile(Ks, packed(a.k, a), b, h, j0, L);
    load_links_dk_stage(stages, a, b, h, tiles.x * kRows, j0);
    cp_async_commit();
  }
  float dk[8][4];
  tc::zero(dk);
  for (int st = 0; st < tiles.y; ++st) {
    const int i0 = (tiles.x + st) * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < tiles.y) {
      load_links_dk_stage(stages + ((st + 1) & 1) * kLinksDkStage, a, b, h,
                          i0 + kRows, j0);
      cp_async_commit();
    }
    const unsigned char* sp = stages + (st & 1) * kLinksDkStage;
    const uint16_t* Qs = reinterpret_cast<const uint16_t*>(sp);
    const float* Ls = reinterpret_cast<const float*>(sp + kTileBytes);
    const float* Gs = Ls + kRows * 68;
    const float* lse = Gs + kRows * 68;
    const float* gate = lse + kRows;
    const float* rr = gate + kRows;
    // Sᵀ: rows keys (wrow, wrow + 8), columns queries n * 8 + 2t + c
    float s[8][4];
    tc::zero(s);
    mma_rows<8>(s, Ks + warp * 16 * kPitch, Qs, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = wrow + 8 * (e >> 1), qq = n * 8 + 2 * t + (e & 1);
        const bool ok = link_valid(i0 + qq, j0 + jj, ol, a.mtl);
        const float sc = s[n][e] * a.scale - lse[qq];
        const float pg =
            ok ? __expf(sc + gate[qq] - Ls[qq * 68 + jj]) * Gs[qq * 68 + jj]
               : 0.f;
        s[n][e] = ok ? (pg - __expf(sc) * rr[qq]) * a.scale : 0.f;
      }
    }
    mma_cols<kTermsLinksDSQ, 4>(dk, elems(s), Qs, lane);
  }

  const View<float> out = packed(a.dk, a);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = ja + 8 * r;
    if (j >= L) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      st2(out, b, j, h, n * 8 + 2 * t, dk[n][2 * r], dk[n][2 * r + 1]);
    }
  }
}

}  // namespace
}  // namespace bf
}  // namespace daspeech
