// DAG link extraction, forward and backward, for Hopper (sm_90a), fp32.
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
// NaN: the -1e9 floor keeps every intermediate finite and the mask is
// applied on the final write only. For training the forward also writes
// lse_h [B, L, H].
//
// Forward design: one block per (tile of 4 rows i, batch row b), 256
// threads. A thread owns one column j of every 128-wide column chunk for two
// of the four rows, and keeps that entry's running (max, sum) over heads in
// registers while the head loop runs; each head's scores exist only in
// registers and its row log-sum-exp is one block reduction. The
// [B, L, L, H] score tensor the plain version builds never reaches device
// memory: the only [L, L] traffic is the single write of the result.
//
// Backward, with G = dlinks masked to the valid entries and the head
// posterior p_h(i, j) = exp(s_h - lse_h(i) + log_gates[i, h] - links(i, j)):
//   dgates[i, h] = r_h(i) = sum_j p_h(i, j) G(i, j)
//   dS_h(i, j)   = valid ? (p_h G - exp(s_h - lse_h(i)) r_h(i)) * scale : 0
//   dq_h[i] = sum_j dS_h(i, j) k_h[j],  dk_h[j] = sum_i dS_h(i, j) q_h[i]
// The floor is a constant, so invalid entries carry no gradient. Two kernels
// in the attention backward's layout (attention.cuh): a row-parallel one
// (one block per 32 rows and head; four threads per row) that makes r in a
// first sweep over the row's key tiles and dq in a second, writing r as
// dgates; and a column-parallel one for dk that reads r back. Tiles of
// links and G are staged through shared memory, and tiles that hold no
// valid entry (the lower triangle, columns past out_len) are skipped.
//
// What bounds it on this card: B*H*L*L*64 fp32 FMAs per product (2.9 GFLOP
// at B=8, L=600 forward; the backward does five such products over the
// upper triangle), each reading one shared-memory operand, plus the K
// chunks, which every forward block re-reads from L2 once per head
// (H*L*256 bytes per block). It is compute- and shared-memory-bound on the
// fp32 pipes; the [L, L] traffic (links out; links and dlinks in for the
// backward) is small beside that. Larger row tiles (fewer K re-reads) and
// tensor cores are later work. L is capped at 1024 (max_target_positions)
// by the forward's register arrays: eight chunks.
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"   // row_sum

namespace daspeech {

constexpr int kLinksDK = 64;    // head depth
constexpr int kLinksBI = 4;     // rows per block
constexpr int kLinksCW = 128;   // columns per chunk (one per thread pair)
constexpr int kLinksNT = 256;   // threads per block
constexpr float kLinksFloor = -1e9f;

template <int NC>
__global__ void __launch_bounds__(kLinksNT)
links_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ g, const int* __restrict__ out_len,
                 float* __restrict__ links, float* __restrict__ lse_out,
                 int L, int H, float scale, int mtl) {
  constexpr int DK = kLinksDK, BI = kLinksBI, CW = kLinksCW;
  constexpr int NW = kLinksNT / 32;  // warps; warps 0-3 hold rows 0 and 2,
                                     // warps 4-7 rows 1 and 3
  __shared__ float Ks[CW][DK + 1];   // +1: conflict-free column reads
  __shared__ float Qs[BI][DK];
  __shared__ float Gs[BI];
  __shared__ float red[NW][2];
  __shared__ float row_stat[BI];

  const int tid = threadIdx.x;
  const int c = tid % CW;
  const int rg = tid / CW;           // rows rg and rg + 2 of the tile
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * BI;
  const int ol = out_len[b];
  const long long HD = static_cast<long long>(H) * DK;

  float rmax[NC][2], rsum[NC][2];
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rmax[ch][r] = -INFINITY;
      rsum[ch][r] = 0.f;
    }
  }

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head is done with Qs, Gs, row_stat
    for (int idx = tid; idx < BI * DK; idx += kLinksNT) {
      const int r = idx / DK, d = idx % DK, i = i0 + r;
      Qs[r][d] = (i < L) ? q[(b * static_cast<long long>(L) + i) * HD +
                             h * DK + d]
                         : 0.f;
    }
    if (tid < BI) {
      const int i = i0 + tid;
      Gs[tid] = (i < L) ? g[(b * static_cast<long long>(L) + i) * H + h]
                        : 0.f;
    }

    float s[NC][2];
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      __syncthreads();  // Ks is free (and Qs, Gs are written)
      for (int idx = tid; idx < CW * DK; idx += kLinksNT) {
        const int jj = idx / DK, d = idx % DK, j = ch * CW + jj;
        Ks[jj][d] = (j < L) ? k[(b * static_cast<long long>(L) + j) * HD +
                                h * DK + d]
                            : 0.f;
      }
      __syncthreads();
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 16
      for (int d = 0; d < DK; ++d) {
        const float kd = Ks[c][d];
        acc0 = fmaf(Qs[rg][d], kd, acc0);
        acc1 = fmaf(Qs[rg + 2][d], kd, acc1);
      }
      const int j = ch * CW + c;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + rg + 2 * r;
        const bool valid = j > i && j < ol && (mtl < 0 || j - i <= mtl);
        const float dot = r == 0 ? acc0 : acc1;
        // columns past L take no part in the row normalizer
        s[ch][r] = (j >= L) ? -INFINITY : (valid ? dot * scale : kLinksFloor);
      }
    }

    // row max over j: thread-local, warp, then the four warps of a row
    float pm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = -INFINITY;
#pragma unroll
      for (int ch = 0; ch < NC; ++ch) x = fmaxf(x, s[ch][r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
      }
      pm[r] = x;
    }
    if (lane == 0) {
      red[warp][0] = pm[0];
      red[warp][1] = pm[1];
    }
    __syncthreads();
    if (tid < BI) {  // row tid = rg' + 2 r'
      const int rg_ = tid % 2, r_ = tid / 2;
      float x = -INFINITY;
      for (int w = rg_ * 4; w < rg_ * 4 + 4; ++w) x = fmaxf(x, red[w][r_]);
      row_stat[tid] = x;
    }
    __syncthreads();
    float rowmax[2] = {row_stat[rg], row_stat[rg + 2]};
    __syncthreads();  // row_stat and red are reused below

    // row sum of exp(s - max), then lse = log(sum) + max
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = 0.f;
#pragma unroll
      for (int ch = 0; ch < NC; ++ch) x += expf(s[ch][r] - rowmax[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
      }
      pm[r] = x;
    }
    if (lane == 0) {
      red[warp][0] = pm[0];
      red[warp][1] = pm[1];
    }
    __syncthreads();
    if (tid < BI) {
      const int rg_ = tid % 2, r_ = tid / 2;
      float x = 0.f;
      for (int w = rg_ * 4; w < rg_ * 4 + 4; ++w) x += red[w][r_];
      row_stat[tid] = x;
    }
    __syncthreads();
    const float lse[2] = {logf(row_stat[rg]) + rowmax[0],
                          logf(row_stat[rg + 2]) + rowmax[1]};
    const float gate[2] = {Gs[rg], Gs[rg + 2]};
    if (lse_out != nullptr && c == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + rg + 2 * r;
        if (i < L) lse_out[(b * static_cast<long long>(L) + i) * H + h] = lse[r];
      }
    }

    // fold this head into the running log-sum-exp over heads
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (ch * CW + c < L) {
          const float v = s[ch][r] - lse[r] + gate[r];
          const float nm = fmaxf(rmax[ch][r], v);
          rsum[ch][r] = rsum[ch][r] * expf(rmax[ch][r] - nm) + expf(v - nm);
          rmax[ch][r] = nm;
        }
      }
    }
  }

#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    const int j = ch * CW + c;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + rg + 2 * r;
      if (i < L && j < L) {
        const bool valid = j > i && j < ol && (mtl < 0 || j - i <= mtl);
        links[(b * static_cast<long long>(L) + i) * L + j] =
            valid ? logf(rsum[ch][r]) + rmax[ch][r] : -INFINITY;
      }
    }
  }
}

template <int NC>
cudaError_t launch_links(const float* q, const float* k, const float* g,
                         const int* ol, float* links, float* lse, int B,
                         int L, int H, float scale, int mtl,
                         cudaStream_t stream) {
  dim3 grid((L + kLinksBI - 1) / kLinksBI, B);
  links_fwd_kernel<NC><<<grid, kLinksNT, 0, stream>>>(q, k, g, ol, links, lse,
                                                      L, H, scale, mtl);
  return cudaGetLastError();
}

}  // namespace daspeech

extern "C" int daspeech_links_fwd(const float* q, const float* k,
                                  const float* log_gates, const int* out_len,
                                  float* links, float* lse, int B, int L,
                                  int H, int DK, float scale, int mtl,
                                  void* stream) {
  using namespace daspeech;
  if (DK != kLinksDK || L < 1 || L > 8 * kLinksCW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((L + kLinksCW - 1) / kLinksCW) {
    case 1: err = launch_links<1>(q, k, log_gates, out_len, links, lse, B, L, H, scale, mtl, st); break;
    case 2: err = launch_links<2>(q, k, log_gates, out_len, links, lse, B, L, H, scale, mtl, st); break;
    case 3: err = launch_links<3>(q, k, log_gates, out_len, links, lse, B, L, H, scale, mtl, st); break;
    case 4: err = launch_links<4>(q, k, log_gates, out_len, links, lse, B, L, H, scale, mtl, st); break;
    case 5: err = launch_links<5>(q, k, log_gates, out_len, links, lse, B, L, H, scale, mtl, st); break;
    case 6: err = launch_links<6>(q, k, log_gates, out_len, links, lse, B, L, H, scale, mtl, st); break;
    case 7: err = launch_links<7>(q, k, log_gates, out_len, links, lse, B, L, H, scale, mtl, st); break;
    default: err = launch_links<8>(q, k, log_gates, out_len, links, lse, B, L, H, scale, mtl, st); break;
  }
  return static_cast<int>(err);
}

namespace daspeech {

constexpr int kLbTPR = 4;     // threads per row (16 channels each)
constexpr int kLbOwn = 32;    // rows (dq) or columns (dk) a block owns
constexpr int kLbTile = 64;   // columns (dq) or rows (dk) per staged tile

struct LinksBwdArgs {
  const float* q;
  const float* k;
  const float* g;        // log_gates [B, L, H]
  const int* out_len;
  const float* links;    // forward output [B, L, L]
  const float* lse;      // forward per-head row lse [B, L, H]
  const float* dlinks;   // [B, L, L]
  float* dq;
  float* dk;
  float* dg;             // dgates [B, L, H]; the dk kernel reads it as r
  int L, H;
  float scale;
  int mtl;
};

__device__ __forceinline__ bool link_valid(int i, int j, int ol, int mtl) {
  return j > i && j < ol && (mtl < 0 || j - i <= mtl);
}

__global__ void __launch_bounds__(kLbOwn * kLbTPR)
links_bwd_dq_kernel(const LinksBwdArgs a) {
  constexpr int TPR = kLbTPR, BM = kLbOwn, BN = kLbTile;
  constexpr int NT = BM * TPR, DK = kLinksDK, KPT = DK / TPR;
  __shared__ float Ks[BN][DK];
  __shared__ float Ps[BM][BN + 1];   // links
  __shared__ float Gs[BM][BN + 1];   // dlinks

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int rl = tid / TPR;
  const int i0 = blockIdx.x * BM;
  const int i = i0 + rl;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = a.L;
  const int ol = a.out_len[b];
  const bool row_ok = i < L;
  const long long HD = static_cast<long long>(a.H) * DK;
  const long long rowL = b * static_cast<long long>(L);

  float qr[KPT], dqa[KPT];
#pragma unroll
  for (int t = 0; t < KPT; ++t) {
    qr[t] = row_ok ? a.q[(rowL + i) * HD + h * DK + sub + TPR * t] : 0.f;
    dqa[t] = 0.f;
  }
  const float gh = row_ok ? a.g[(rowL + i) * a.H + h] : 0.f;
  const float lh = row_ok ? a.lse[(rowL + i) * a.H + h] : 0.f;

  // columns that can be valid for some row of this tile
  const int i_last = min(L, i0 + BM) - 1;
  int j_hi = min(ol, L);
  if (a.mtl >= 0) j_hi = min(j_hi, i_last + a.mtl + 1);
  const int jt0 = ((i0 + 1) / BN) * BN;

  float r = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = jt0; j0 < j_hi; j0 += BN) {
      __syncthreads();  // the previous tile is consumed
      for (int idx = tid; idx < BN * DK; idx += NT) {
        const int jj = idx / DK, d = idx % DK, j = j0 + jj;
        Ks[jj][d] = (j < L) ? a.k[(rowL + j) * HD + h * DK + d] : 0.f;
      }
      for (int idx = tid; idx < BM * BN; idx += NT) {
        const int rr = idx / BN, cc = idx % BN;
        const int ii = i0 + rr, j = j0 + cc;
        const bool in = ii < L && j < L;
        Ps[rr][cc] = in ? a.links[(rowL + ii) * L + j] : 0.f;
        Gs[rr][cc] = in ? a.dlinks[(rowL + ii) * L + j] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < BN; ++jj) {
        const int j = j0 + jj;
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < KPT; ++t) s = fmaf(qr[t], Ks[jj][sub + TPR * t], s);
        s = row_sum<TPR>(s) * a.scale;
        const bool valid = row_ok && j < L && link_valid(i, j, ol, a.mtl);
        const float pg =
            valid ? expf(s - lh + gh - Ps[rl][jj]) * Gs[rl][jj] : 0.f;
        if (pass == 0) {
          r += pg;
        } else {
          const float ds = valid ? (pg - expf(s - lh) * r) * a.scale : 0.f;
#pragma unroll
          for (int t = 0; t < KPT; ++t) {
            dqa[t] = fmaf(ds, Ks[jj][sub + TPR * t], dqa[t]);
          }
        }
      }
    }
  }
  if (row_ok) {
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      a.dq[(rowL + i) * HD + h * DK + sub + TPR * t] = dqa[t];
    }
    if (sub == 0) a.dg[(rowL + i) * a.H + h] = r;
  }
}

__global__ void __launch_bounds__(kLbOwn * kLbTPR)
links_bwd_dk_kernel(const LinksBwdArgs a) {
  constexpr int TPR = kLbTPR, BN = kLbOwn, BM = kLbTile;
  constexpr int NT = BN * TPR, DK = kLinksDK, KPT = DK / TPR;
  __shared__ float Qs[BM][DK];
  __shared__ float Ps[BM][BN + 1];   // links
  __shared__ float Gs[BM][BN + 1];   // dlinks
  __shared__ float Ls[BM], Gt[BM], Rs[BM];

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int jl = tid / TPR;
  const int j0 = blockIdx.x * BN;
  const int j = j0 + jl;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = a.L;
  const int ol = a.out_len[b];
  const bool col_ok = j < L;
  const long long HD = static_cast<long long>(a.H) * DK;
  const long long rowL = b * static_cast<long long>(L);

  float kr[KPT], dka[KPT];
#pragma unroll
  for (int t = 0; t < KPT; ++t) {
    kr[t] = col_ok ? a.k[(rowL + j) * HD + h * DK + sub + TPR * t] : 0.f;
    dka[t] = 0.f;
  }

  // rows that can be valid for some column of this tile
  const int j_last = min(L, j0 + BN) - 1;
  const int i_lo = (a.mtl >= 0) ? max(0, j0 - a.mtl) : 0;
  const int i_hi = (j0 < ol) ? j_last : 0;   // i < j <= j_last
  for (int i0 = (i_lo / BM) * BM; i0 < i_hi; i0 += BM) {
    __syncthreads();
    for (int idx = tid; idx < BM * DK; idx += NT) {
      const int ii = idx / DK, d = idx % DK, i = i0 + ii;
      Qs[ii][d] = (i < L) ? a.q[(rowL + i) * HD + h * DK + d] : 0.f;
    }
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int ii = idx / BN, cc = idx % BN;
      const int i = i0 + ii, jj = j0 + cc;
      const bool in = i < L && jj < L;
      Ps[ii][cc] = in ? a.links[(rowL + i) * L + jj] : 0.f;
      Gs[ii][cc] = in ? a.dlinks[(rowL + i) * L + jj] : 0.f;
    }
    for (int ii = tid; ii < BM; ii += NT) {
      const int i = i0 + ii;
      const bool in = i < L;
      Ls[ii] = in ? a.lse[(rowL + i) * a.H + h] : 0.f;
      Gt[ii] = in ? a.g[(rowL + i) * a.H + h] : 0.f;
      Rs[ii] = in ? a.dg[(rowL + i) * a.H + h] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < BM; ++ii) {
      const int i = i0 + ii;
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < KPT; ++t) s = fmaf(kr[t], Qs[ii][sub + TPR * t], s);
      s = row_sum<TPR>(s) * a.scale;
      const bool valid = col_ok && i < L && link_valid(i, j, ol, a.mtl);
      const float pg =
          valid ? expf(s - Ls[ii] + Gt[ii] - Ps[ii][jl]) * Gs[ii][jl] : 0.f;
      const float ds =
          valid ? (pg - expf(s - Ls[ii]) * Rs[ii]) * a.scale : 0.f;
#pragma unroll
      for (int t = 0; t < KPT; ++t) {
        dka[t] = fmaf(ds, Qs[ii][sub + TPR * t], dka[t]);
      }
    }
  }
  if (col_ok) {
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      a.dk[(rowL + j) * HD + h * DK + sub + TPR * t] = dka[t];
    }
  }
}

}  // namespace daspeech

extern "C" int daspeech_links_bwd(const float* q, const float* k,
                                  const float* log_gates, const int* out_len,
                                  const float* links, const float* lse,
                                  const float* dlinks, float* dq, float* dk,
                                  float* dgates, int B, int L, int H, int DK,
                                  float scale, int mtl, void* stream) {
  using namespace daspeech;
  if (DK != kLinksDK || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const LinksBwdArgs args{q, k, log_gates, out_len, links, lse, dlinks,
                          dq, dk, dgates, L, H, scale, mtl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + kLbOwn - 1) / kLbOwn, H, B);
  // the dq kernel writes r (= dgates), which the dk kernel reads
  links_bwd_dq_kernel<<<grid, kLbOwn * kLbTPR, 0, st>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  links_bwd_dk_kernel<<<grid, kLbOwn * kLbTPR, 0, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}
