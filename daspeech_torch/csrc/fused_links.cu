// DAG link extraction forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas kernel daspeech_tpu/ops/fused_links.py:141
// (fused_extract_links -> _links_fwd_kernel, :70), forward only.
//
// Computes links [B, L, L] from packed q, k [B, L, H*64], log_gates
// [B, L, H] and out_len [B]:
//   valid(i, j) = j > i  &&  j < out_len[b]  &&  (mtl < 0 || j - i <= mtl)
//   s_h(i, j)   = valid ? q_h[i] . k_h[j] * scale : -1e9
//   links(i, j) = valid ? logsumexp_h(s_h(i, j) - logsumexp_j s_h(i, j)
//                                     + log_gates[i, h])
//                       : -inf
// Rows with no valid successor (i >= out_len - 1) come out all -inf, never
// NaN: the -1e9 floor keeps every intermediate finite and the mask is
// applied on the final write only.
//
// Design: one block per (tile of 4 rows i, batch row b), 256 threads. A
// thread owns one column j of every 128-wide column chunk for two of the
// four rows, and keeps that entry's running (max, sum) over heads in
// registers while the head loop runs; each head's scores exist only in
// registers and its row log-sum-exp is one block reduction. The
// [B, L, L, H] score tensor the plain version builds never reaches device
// memory: the only [L, L] traffic is the single write of the result.
//
// What bounds it on this card: B*H*L*L*64 fp32 FMAs (2.9 GFLOP at
// B=8, L=600), each reading one shared-memory operand, plus the K chunks,
// which every block re-reads from L2 once per head (H*L*256 bytes per
// block). It is compute- and shared-memory-bound on the fp32 pipes; the
// write of links (11.5 MB at B=8, L=600) is small beside that. Larger row
// tiles (fewer K re-reads) and tensor cores are later work. L is capped at
// 1024 (max_target_positions) by the register arrays: eight chunks.
#include <cuda_runtime.h>
#include <math.h>

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
                 float* __restrict__ links, int L, int H, float scale,
                 int mtl) {
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
                         const int* ol, float* links, int B, int L, int H,
                         float scale, int mtl, cudaStream_t stream) {
  dim3 grid((L + kLinksBI - 1) / kLinksBI, B);
  links_fwd_kernel<NC><<<grid, kLinksNT, 0, stream>>>(q, k, g, ol, links, L,
                                                      H, scale, mtl);
  return cudaGetLastError();
}

}  // namespace daspeech

extern "C" int daspeech_links_fwd(const float* q, const float* k,
                                  const float* log_gates, const int* out_len,
                                  float* links, int B, int L, int H, int DK,
                                  float scale, int mtl, void* stream) {
  using namespace daspeech;
  if (DK != kLinksDK || L < 1 || L > 8 * kLinksCW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((L + kLinksCW - 1) / kLinksCW) {
    case 1: err = launch_links<1>(q, k, log_gates, out_len, links, B, L, H, scale, mtl, st); break;
    case 2: err = launch_links<2>(q, k, log_gates, out_len, links, B, L, H, scale, mtl, st); break;
    case 3: err = launch_links<3>(q, k, log_gates, out_len, links, B, L, H, scale, mtl, st); break;
    case 4: err = launch_links<4>(q, k, log_gates, out_len, links, B, L, H, scale, mtl, st); break;
    case 5: err = launch_links<5>(q, k, log_gates, out_len, links, B, L, H, scale, mtl, st); break;
    case 6: err = launch_links<6>(q, k, log_gates, out_len, links, B, L, H, scale, mtl, st); break;
    case 7: err = launch_links<7>(q, k, log_gates, out_len, links, B, L, H, scale, mtl, st); break;
    default: err = launch_links<8>(q, k, log_gates, out_len, links, B, L, H, scale, mtl, st); break;
  }
  return static_cast<int>(err);
}
