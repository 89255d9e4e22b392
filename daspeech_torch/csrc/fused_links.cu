// DAG link extraction, forward and backward, for Hopper (sm_90a), fp32.
// The _bf16 entry points (the same arguments) take bf16 q and k and write
// bf16 dq and dk; log_gates, links, lse, dlinks and dgates stay fp32, as
// the Pallas kernel upcasts q and k and writes fp32 links
// (fused_links.py:62-66, :177-199). They run links_bf16.cuh's kernels, on
// the bf16 tensor cores with fp32 sums, over the same live tiles.
//
// Replaces the Pallas kernels of daspeech_tpu/ops/fused_links.py:141
// (fused_extract_links: forward _links_fwd_kernel, :70; backward
// _links_bwd_kernel, :91).
//
// Computes links [B, L, L] from packed q, k [B, L, H*64], log_gates
// [B, L, H] and out_len [B]:
//   valid(i, j) = j > i  &&  j < out_len[b]  &&  (mtl < 0 || j - i <= mtl)
//   s_h(i, j)   = valid ? q_h[i] . k_h[j] * scale : -1e9
//   lse_h(i)    = logsumexp_j s_h(i, j)
//   links(i, j) = valid ? logsumexp_h(s_h(i, j) - lse_h(i) + log_gates[i, h])
//                       : -inf
// Rows with no valid successor (i >= out_len - 1) come out all -inf, never
// NaN: the mask is applied on the final write only, and every intermediate
// stays finite. For training the forward also writes lse_h [B, L, H].
//
// Live tiles. Split [L, L] into 64 x 64 tiles. The valid entries of the
// row tile at i0 lie in the columns [i0 + 1, min(out_len, L, i_last + mtl
// + 1)), and every column tile that meets that range holds one; the other
// tiles (the lower triangle, the columns past out_len or past the band)
// are dead. Skipping them is exact: in a row with a valid entry every
// skipped entry is the -1e9 floor, whose exp underflows to 0.0f beside the
// row's maximum (a real score), so the row's maximum and sum, and with them
// lse_h and every finite link, come out bit for bit as over the whole row.
// A row with no valid entry needs only a finite lse_h, which the backward
// never reads at a valid entry. At cell T (out_len in [120, 240], L = 240)
// and at J-long (out_len in [350, 700], L = 700) over half of the tiles
// are dead.
//
// Forward, on the fp32 FMA pipes (tiles.cuh's fma side: 256 threads, each
// a 4-row x 4-column micro-tile of the 64 x 64 score tile, fed by 16-byte
// shared-memory reads). It feeds the DAG loss, so it stays off the
// truncating tensor-core accumulation (attention_fma.cuh, "Why the FMA
// pipes"). Two kernels, so that a small batch still fills the card:
//   1. links_lse_kernel, one block per (64-row tile, head, batch row): the
//      row tile's Q_h stays in shared memory and the live K_h tiles stream
//      through two cp.async stages; each thread keeps an online (max, sum)
//      of its own columns of its 4 rows, merged over the row's 16 threads
//      (a half-warp) by xor-shuffles at the end: lse_h to [B, L, H];
//   2. links_fold_kernel, one block per (column tile, row tile, batch
//      row): a dead pair writes -inf and returns; a live one streams
//      (Q_h, K_h, lse_h, log_gates_h) per head through two stages,
//      recomputes the head's score tile and folds s - lse_h + g_h into a
//      per-entry running (max, sum) over heads in registers (one exp an
//      entry and head: the larger of the two terms is 1), then writes the
//      links tile once.
// The [B, L, L, H] score tensor never reaches device memory; the [L, L]
// traffic is the single write of links.
//
// Backward, with G = dlinks masked to the valid entries and the head
// posterior p_h(i, j) = exp(s_h - lse_h(i) + log_gates[i, h] - links(i, j)):
//   dgates[i, h] = r_h(i) = sum_j p_h(i, j) G(i, j)
//   dS_h(i, j)   = valid ? (p_h G - exp(s_h - lse_h(i)) r_h(i)) * scale : 0
//   dq_h[i] = sum_j dS_h(i, j) k_h[j],  dk_h[j] = sum_i dS_h(i, j) q_h[i]
// The floor is a constant, so invalid entries carry no gradient. On the
// tensor cores in 3xTF32 (tiles.cuh's tc side, attention_tc.cuh's backward
// layout: four warps of 16 rows, the warp's A fragments in registers,
// 64 x 64 tiles by cp.async, double-buffered), over the live tiles only:
//   1. links_bwd_dq_kernel, one block per (64-row tile, head, batch row):
//      a first sweep over the live column tiles makes r = dgates (written),
//      a second recomputes S, forms dS and takes dq += dS·K;
//   2. links_bwd_dk_kernel, one block per (64-column tile, head, batch
//      row): per live row tile, Sᵀ = K·Qᵀ, dSᵀ from the stored r, and
//      dk += dSᵀ·Q.
// The backward's exps are __expf (ex2.approx of x·log2 e, a few ulp),
// faster than expf on the card; its gradients stay within 2e-5 of the
// plain version.
// Recomputing S in the column kernel (five 64-deep tile products a live
// tile, where writing dS once would take four) keeps a [B, H, L, L] dS
// buffer (147 MB at cell T, 219 MB at J-long; the C entry point takes no
// scratch) out of device memory, at the cost of one more tile product. No
// atomics: the gradients are bit-identical from run to run.
//
// What bounds it on this card: at cell T [80, 240] H = 8 the forward moves
// ~97 MB (q, k in, links out: 0.029 ms at 3.35 TB/s) against ~5 GFLOP of
// live-tile FMAs (two sweeps; 0.08 ms at 67 TFLOP/s); the backward ~194 MB
// (0.058 ms) against ~13 GFLOP of live-tile products (0.08 ms at 165
// TFLOP/s, the 3xTF32 rate). Both are bound by the work per live tile, not
// by the [L, L] traffic. The card's times are in PERF.md.
// L is capped at 1024 (max_target_positions) by the wrapper; the kernels
// have no limit of their own.
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"   // Operand, cp.async
#include "tiles.cuh"

namespace daspeech {
namespace {

constexpr int kLinksDK = 64;      // head depth
constexpr int kTileW = 64;        // rows and columns of a tile
constexpr float kLinksFloor = -1e9f;
// a thread's running maximum before it has seen a column < L: below the
// floor, so that a column of the row always replaces it
constexpr float kLinksNone = -2e9f;

struct LinksArgs {
  const float* q;        // [B, L, H*64], fp32 or (bf16) bf16
  const float* k;
  const float* g;        // log_gates [B, L, H]
  const int* out_len;    // [B]
  const float* links;    // backward: the forward's output [B, L, L]
  const float* lse;      // [B, L, H]: the fold's and the backward's input
  const float* dlinks;   // backward: [B, L, L]
  float* links_out;      // forward: [B, L, L]
  float* lse_out;        // forward: [B, L, H]
  float* dq;             // q's element type
  float* dk;
  float* dg;             // dgates [B, L, H]; the dk kernel reads it as r
  int L, H;
  float scale;
  int mtl;
  bool bf16;             // q, k, dq and dk are bf16
};

__device__ __forceinline__ bool link_valid(int i, int j, int ol, int mtl) {
  return j > i && j < ol && (mtl < 0 || j - i <= mtl);
}

// out_len of batch row b, at most L
__device__ __forceinline__ int graph_len(const LinksArgs& a, int b) {
  return min(a.out_len[b], a.L);
}

// head h of a packed [B, L, H*64] tensor (q, k, dq or dk)
template <typename T>
__device__ __forceinline__ View<T> packed(T* p, const LinksArgs& a) {
  const long long row = static_cast<long long>(a.H) * kLinksDK;
  return View<T>{p, a.L * row, row, kLinksDK, a.bf16};
}

// the live column tiles of the row tile at i0: the first tile's index and
// their count (see "Live tiles")
__device__ __forceinline__ int2 live_col_tiles(int i0, int L, int ol,
                                               int mtl) {
  const int lo = i0 + 1;
  int hi = ol;
  if (mtl >= 0) hi = min(hi, min(i0 + kTileW, L) - 1 + mtl + 1);
  return lo < hi ? make_int2(lo / kTileW, (hi - 1) / kTileW - lo / kTileW + 1)
                 : make_int2(0, 0);
}

// the live row tiles of the column tile at j0: rows i with a valid (i, j)
// for some j in [j0, min(j0 + 64, ol)), that is max(0, j0 - mtl) <= i <
// min(j0 + 64, ol) - 1
__device__ __forceinline__ int2 live_row_tiles(int j0, int ol, int mtl) {
  const int lo = mtl >= 0 ? max(0, j0 - mtl) : 0;
  const int hi = j0 < ol ? min(j0 + kTileW, ol) - 1 : 0;
  return lo < hi ? make_int2(lo / kTileW, (hi - 1) / kTileW - lo / kTileW + 1)
                 : make_int2(0, 0);
}

// ----------------------------------------------------------- forward: lse

// dynamic shared memory: the row tile's Q_h, then two stages of K_h tiles
constexpr int kLseSmem = 3 * fma::kTile * 4;

__global__ void __launch_bounds__(fma::kThreads, 2)
links_lse_kernel(const LinksArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* const Qs = smem;
  float* const stages = smem + fma::kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int i0 = blockIdx.x * kTileW, h = blockIdx.y, b = blockIdx.z;
  const int L = a.L, ol = graph_len(a, b);
  const Operand q = packed(a.q, a), k = packed(a.k, a);
  const int2 tiles = live_col_tiles(i0, L, ol, a.mtl);

  if (tiles.y > 0) {
    fma::load_tile(Qs, q, b, h, i0, L);
    fma::load_tile(stages, k, b, h, tiles.x * kTileW, L);
    cp_async_commit();
  }
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kLinksNone;
    l[r] = 0.f;
  }
  for (int st = 0; st < tiles.y; ++st) {
    const int j0 = (tiles.x + st) * kTileW;
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < tiles.y) {
      fma::load_tile(stages + ((st + 1) & 1) * fma::kTile, k, b, h,
                     j0 + kTileW, L);
      cp_async_commit();
    }
    float s[4][4] = {};
    fma::score_chunk(s, Qs + 4 * ty * fma::kPitch,
                     stages + (st & 1) * fma::kTile + tx * fma::kPitch);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * ty + r;
      float x[4], mx = m[r];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + tx + 16 * u;
        // columns past L take no part in the row's normalizer
        x[u] = j >= L                         ? -INFINITY
               : link_valid(i, j, ol, a.mtl) ? s[r][u] * a.scale
                                             : kLinksFloor;
        mx = fmaxf(mx, x[u]);
      }
      float sum = l[r] * expf(m[r] - mx);
#pragma unroll
      for (int u = 0; u < 4; ++u) sum += expf(x[u] - mx);
      m[r] = mx;
      l[r] = sum;
    }
  }

  // merge the row's 16 threads: (max, sum) of (m, l)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float mr = m[r];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, off));
    }
    float sum = l[r] * expf(m[r] - mr);
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    const int i = i0 + 4 * ty + r;
    if (tx == 0 && i < L) {
      // a row of a live tile has a column < L, so mr >= the floor
      a.lse_out[(static_cast<long long>(b) * L + i) * a.H + h] =
          tiles.y > 0 ? logf(sum) + mr : kLinksFloor;
    }
  }
}

// ---------------------------------------------------------- forward: fold

// dynamic shared memory: two stages of [Q_h tile, K_h tile, lse_h and
// log_gates_h of the 64 rows]
constexpr int kFoldStage = 2 * fma::kTile + 2 * kTileW;
constexpr int kFoldSmem = 2 * kFoldStage * 4;

__device__ __forceinline__ void load_fold_stage(float* st, const LinksArgs& a,
                                                int b, int h, int i0,
                                                int j0) {
  fma::load_tile(st, packed(a.q, a), b, h, i0, a.L);
  fma::load_tile(st + fma::kTile, packed(a.k, a), b, h, j0, a.L);
  const int x = threadIdx.x;
  if (x < 2 * kTileW) {
    const int i = i0 + (x & (kTileW - 1));
    const bool ok = i < a.L;
    const long long at = (static_cast<long long>(b) * a.L + (ok ? i : 0)) *
                             a.H + h;
    cp_async<4>(st + 2 * fma::kTile + x, (x < kTileW ? a.lse : a.g) + at, ok);
  }
}

__global__ void __launch_bounds__(fma::kThreads, 2)
links_fold_kernel(const LinksArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int j0 = blockIdx.x * kTileW, i0 = blockIdx.y * kTileW;
  const int b = blockIdx.z;
  const int L = a.L, ol = graph_len(a, b);
  float* const out = a.links_out + static_cast<long long>(b) * L * L;
  const int2 tiles = live_col_tiles(i0, L, ol, a.mtl);
  const int t = j0 / kTileW;
  if (t < tiles.x || t >= tiles.x + tiles.y) {
    for (int idx = tid; idx < kTileW * kTileW; idx += fma::kThreads) {
      const int i = i0 + idx / kTileW, j = j0 + idx % kTileW;
      if (i < L && j < L) out[static_cast<long long>(i) * L + j] = -INFINITY;
    }
    return;
  }

  load_fold_stage(smem, a, b, 0, i0, j0);
  cp_async_commit();
  // per entry (row 4 ty + r, column tx + 16 u): running max and sum of
  // exp(v - max) over the heads
  float rmax[4][4], rsum[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      rmax[r][u] = -INFINITY;
      rsum[r][u] = 0.f;
    }
  }
  bool ok[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ok[r][u] = link_valid(i0 + 4 * ty + r, j0 + tx + 16 * u, ol, a.mtl);
    }
  }
  for (int h = 0; h < a.H; ++h) {
    cp_async_wait_all();
    __syncthreads();
    if (h + 1 < a.H) {
      load_fold_stage(smem + ((h + 1) & 1) * kFoldStage, a, b, h + 1, i0,
                      j0);
      cp_async_commit();
    }
    const float* st = smem + (h & 1) * kFoldStage;
    float s[4][4] = {};
    fma::score_chunk(s, st + 4 * ty * fma::kPitch,
                     st + fma::kTile + tx * fma::kPitch);
    const float* lse = st + 2 * fma::kTile + 4 * ty;
    const float* gate = lse + kTileW;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!ok[r][u]) continue;
        // logsumexp over heads, one exp: of the two terms the larger is 1
        const float v = s[r][u] * a.scale - lse[r] + gate[r];
        const float d = v - rmax[r][u];
        const float e = expf(-fabsf(d));
        rsum[r][u] = d > 0.f ? fmaf(rsum[r][u], e, 1.f) : rsum[r][u] + e;
        rmax[r][u] = fmaxf(rmax[r][u], v);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= L) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + tx + 16 * u;
      if (j < L) {
        out[static_cast<long long>(i) * L + j] =
            ok[r][u] ? logf(rsum[r][u]) + rmax[r][u] : -INFINITY;
      }
    }
  }
}

// ------------------------------------------------------------ backward: dq

// dynamic shared memory: two stages of [K_h tile, links tile, dlinks tile]
constexpr int kDqStage = 3 * tc::kTile;
constexpr int kDqSmem = 2 * kDqStage * 4;

__device__ __forceinline__ void load_dq_stage(float* st, const LinksArgs& a,
                                              int b, int h, int i0, int j0) {
  const long long mat = static_cast<long long>(b) * a.L * a.L;
  tc::load_tile(st, packed(a.k, a), b, h, j0, a.L);
  tc::load_matrix_tile(st + tc::kTile, a.links + mat, a.L, a.L, i0, j0);
  tc::load_matrix_tile(st + 2 * tc::kTile, a.dlinks + mat, a.L, a.L, i0, j0);
}

// the A fragments (fp32) of rows ra, ra + 8 of head h of a packed tensor
__device__ __forceinline__ void row_fragments(float f[8][4], const float* p,
                                              const LinksArgs& a, int b,
                                              int h, int ra, int t) {
  const Operand x = packed(p, a);
  const bool ok0 = ra < a.L, ok1 = ra + 8 < a.L;
  const int r0 = ok0 ? ra : 0, r1 = ok1 ? ra + 8 : 0;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    f[kk][0] = ok0 ? ld1(x, b, r0, h, kk * 8 + t) : 0.f;
    f[kk][1] = ok1 ? ld1(x, b, r1, h, kk * 8 + t) : 0.f;
    f[kk][2] = ok0 ? ld1(x, b, r0, h, kk * 8 + t + 4) : 0.f;
    f[kk][3] = ok1 ? ld1(x, b, r1, h, kk * 8 + t + 4) : 0.f;
  }
}

__global__ void __launch_bounds__(tc::kThreads, 2)
links_bwd_dq_kernel(const LinksArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * kTileW, h = blockIdx.y, b = blockIdx.z;
  const int wrow = warp * 16 + gid;         // the thread's rows in the tile
  const int ia = i0 + wrow;                 // rows ia, ia + 8
  const int L = a.L, ol = graph_len(a, b);
  const int2 tiles = live_col_tiles(i0, L, ol, a.mtl);
  const int nsteps = 2 * tiles.y;           // a sweep for r, one for dq

  if (nsteps > 0) {
    load_dq_stage(smem, a, b, h, i0, tiles.x * kTileW);
    cp_async_commit();
  }
  float qf[8][4];
  row_fragments(qf, a.q, a, b, h, ia, t);
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
  float s[8][4], dq[8][4];
  tc::zero(dq);
  for (int st = 0; st < nsteps; ++st) {
    const bool second = st >= tiles.y;
    const int j0 = (tiles.x + st % tiles.y) * kTileW;
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < nsteps) {
      load_dq_stage(smem + ((st + 1) & 1) * kDqStage, a, b, h, i0,
                    (tiles.x + (st + 1) % tiles.y) * kTileW);
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
    const float* Ks = smem + (st & 1) * kDqStage;
    const float* Ls = Ks + tc::kTile;
    const float* Gs = Ls + tc::kTile;
    tc::zero(s);
    tc::mma_rows<tc::kGroup>(s, [&](int kk, float x[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = qf[kk][e];
    }, Ks, gid, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = wrow + 8 * (e >> 1), cc = n * 8 + 2 * t + (e & 1);
        const bool ok = link_valid(i0 + rr, j0 + cc, ol, a.mtl);
        const float sc = s[n][e] * a.scale - lse[e >> 1];
        const float pg =
            ok ? __expf(sc + gate[e >> 1] - Ls[rr * tc::kPitch + cc]) *
                     Gs[rr * tc::kPitch + cc]
               : 0.f;
        if (!second) {
          rsum[e >> 1] += pg;
        } else {
          s[n][e] = ok ? (pg - __expf(sc) * rsum[e >> 1]) * a.scale : 0.f;
        }
      }
    }
    if (second) tc::mma_cols<tc::kGroup>(dq, s, Ks, gid, t);
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

// dynamic shared memory: two stages of [Q_h tile, links tile, dlinks tile,
// lse_h, log_gates_h and r_h of the 64 rows]
constexpr int kDkStage = 3 * tc::kTile + 3 * kTileW;
constexpr int kDkSmem = 2 * kDkStage * 4;

__device__ __forceinline__ void load_dk_stage(float* st, const LinksArgs& a,
                                              int b, int h, int i0, int j0) {
  const long long mat = static_cast<long long>(b) * a.L * a.L;
  tc::load_tile(st, packed(a.q, a), b, h, i0, a.L);
  tc::load_matrix_tile(st + tc::kTile, a.links + mat, a.L, a.L, i0, j0);
  tc::load_matrix_tile(st + 2 * tc::kTile, a.dlinks + mat, a.L, a.L, i0, j0);
  for (int x = threadIdx.x; x < 3 * kTileW; x += tc::kThreads) {
    const int i = i0 + x % kTileW, which = x / kTileW;
    const bool ok = i < a.L;
    const float* src = which == 0 ? a.lse : which == 1 ? a.g : a.dg;
    cp_async<4>(st + 3 * tc::kTile + x,
                src + (static_cast<long long>(b) * a.L + (ok ? i : 0)) *
                          a.H + h,
                ok);
  }
}

__global__ void __launch_bounds__(tc::kThreads, 2)
links_bwd_dk_kernel(const LinksArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kTileW, h = blockIdx.y, b = blockIdx.z;
  const int wrow = warp * 16 + gid;         // the thread's keys in the tile
  const int ja = j0 + wrow;                 // keys ja, ja + 8
  const int L = a.L, ol = graph_len(a, b);
  const int2 tiles = live_row_tiles(j0, ol, a.mtl);

  if (tiles.y > 0) {
    load_dk_stage(smem, a, b, h, tiles.x * kTileW, j0);
    cp_async_commit();
  }
  float kf[8][4];
  row_fragments(kf, a.k, a, b, h, ja, t);
  float s[8][4], dk[8][4];
  tc::zero(dk);
  for (int st = 0; st < tiles.y; ++st) {
    const int i0 = (tiles.x + st) * kTileW;
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < tiles.y) {
      load_dk_stage(smem + ((st + 1) & 1) * kDkStage, a, b, h, i0 + kTileW,
                    j0);
      cp_async_commit();
    }
    const float* Qs = smem + (st & 1) * kDkStage;
    const float* Ls = Qs + tc::kTile;
    const float* Gs = Ls + tc::kTile;
    const float* lse = Gs + tc::kTile;
    const float* gate = lse + kTileW;
    const float* rr = gate + kTileW;
    // Sᵀ: rows keys (wrow, wrow + 8), columns queries n * 8 + 2t + c
    tc::zero(s);
    tc::mma_rows<tc::kGroup>(s, [&](int kk, float x[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = kf[kk][e];
    }, Qs, gid, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = wrow + 8 * (e >> 1), qq = n * 8 + 2 * t + (e & 1);
        const bool ok = link_valid(i0 + qq, j0 + jj, ol, a.mtl);
        const float sc = s[n][e] * a.scale - lse[qq];
        const float pg =
            ok ? __expf(sc + gate[qq] - Ls[qq * tc::kPitch + jj]) *
                     Gs[qq * tc::kPitch + jj]
               : 0.f;
        s[n][e] = ok ? (pg - __expf(sc) * rr[qq]) * a.scale : 0.f;
      }
    }
    tc::mma_cols<tc::kGroup>(dk, s, Qs, gid, t);
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
}  // namespace daspeech

// the bf16 entry points' kernels, on the bf16 tensor cores
#include "links_bf16.cuh"

namespace daspeech {
namespace {

template <class Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                   const LinksArgs& a, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// lse [B, L, H] is written (the fold reads it); the wrapper passes scratch
// when the caller does not keep it
int links_fwd(const void* q, const void* k, const float* log_gates,
              const int* out_len, float* links, float* lse, int B, int L,
              int H, int DK, float scale, int mtl, void* stream, bool bf16) {
  if (DK != kLinksDK || L < 1 || H < 1 || lse == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LinksArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.bf16 = bf16;
  a.g = log_gates;
  a.out_len = out_len;
  a.lse = lse;
  a.links_out = links;
  a.lse_out = lse;
  a.L = L;
  a.H = H;
  a.scale = scale;
  a.mtl = mtl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = (L + kTileW - 1) / kTileW;
  // the fold reads lse: same stream
  cudaError_t err =
      bf16 ? launch(bf::links_bf16_lse_kernel, dim3(nt, H, B), bf::kThreads,
                    bf::kLinksLseSmem, a, st)
           : launch(links_lse_kernel, dim3(nt, H, B), fma::kThreads,
                    kLseSmem, a, st);
  if (err == cudaSuccess) {
    err = bf16 ? launch(bf::links_bf16_fold_kernel, dim3(nt, nt, B),
                        bf::kThreads, bf::kLinksFoldSmem, a, st)
               : launch(links_fold_kernel, dim3(nt, nt, B), fma::kThreads,
                        kFoldSmem, a, st);
  }
  return static_cast<int>(err);
}

int links_bwd(const void* q, const void* k, const float* log_gates,
              const int* out_len, const float* links, const float* lse,
              const float* dlinks, void* dq, void* dk, float* dgates, int B,
              int L, int H, int DK, float scale, int mtl, void* stream,
              bool bf16) {
  if (DK != kLinksDK || L < 1 || H < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LinksArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.bf16 = bf16;
  a.g = log_gates;
  a.out_len = out_len;
  a.links = links;
  a.lse = lse;
  a.dlinks = dlinks;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dg = dgates;
  a.L = L;
  a.H = H;
  a.scale = scale;
  a.mtl = mtl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + kTileW - 1) / kTileW, H, B);
  // the dq kernel writes r (= dgates), which the dk kernel reads
  cudaError_t err =
      bf16 ? launch(bf::links_bf16_dq_kernel, grid, bf::kThreads,
                    bf::kLinksDqSmem, a, st)
           : launch(links_bwd_dq_kernel, grid, tc::kThreads, kDqSmem, a, st);
  if (err == cudaSuccess) {
    err = bf16 ? launch(bf::links_bf16_dk_kernel, grid, bf::kThreads,
                        bf::kLinksDkSmem, a, st)
               : launch(links_bwd_dk_kernel, grid, tc::kThreads, kDkSmem, a,
                        st);
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace daspeech

extern "C" int daspeech_links_fwd(const float* q, const float* k,
                                  const float* log_gates, const int* out_len,
                                  float* links, float* lse, int B, int L,
                                  int H, int DK, float scale, int mtl,
                                  void* stream) {
  return daspeech::links_fwd(q, k, log_gates, out_len, links, lse, B, L, H,
                             DK, scale, mtl, stream, false);
}

extern "C" int daspeech_links_fwd_bf16(const void* q, const void* k,
                                       const float* log_gates,
                                       const int* out_len, float* links,
                                       float* lse, int B, int L, int H,
                                       int DK, float scale, int mtl,
                                       void* stream) {
  return daspeech::links_fwd(q, k, log_gates, out_len, links, lse, B, L, H,
                             DK, scale, mtl, stream, true);
}

extern "C" int daspeech_links_bwd(const float* q, const float* k,
                                  const float* log_gates, const int* out_len,
                                  const float* links, const float* lse,
                                  const float* dlinks, float* dq, float* dk,
                                  float* dgates, int B, int L, int H, int DK,
                                  float scale, int mtl, void* stream) {
  return daspeech::links_bwd(q, k, log_gates, out_len, links, lse, dlinks,
                             dq, dk, dgates, B, L, H, DK, scale, mtl, stream,
                             false);
}

extern "C" int daspeech_links_bwd_bf16(const void* q, const void* k,
                                       const float* log_gates,
                                       const int* out_len, const float* links,
                                       const float* lse, const float* dlinks,
                                       void* dq, void* dk, float* dgates,
                                       int B, int L, int H, int DK,
                                       float scale, int mtl, void* stream) {
  return daspeech::links_bwd(q, k, log_gates, out_len, links, lse, dlinks,
                             dq, dk, dgates, B, L, H, DK, scale, mtl, stream,
                             true);
}
