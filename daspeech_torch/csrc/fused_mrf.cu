// One HiFi-GAN MRF level for Hopper (sm_90a), fp32, inference only.
//
// Replaces the Pallas kernel of daspeech_tpu/ops/fused_mrf.py:156
// (mrf_level; _mrf_kernel at :87, pallas_call at :182).
//
// A level is n_blocks ResBlock1 chains over the same input x [B, C, T],
// averaged. Each chain is n_dil "iterations"; iteration i of block k is
//   y   = lrelu(conv_{K_k, d_i}(lrelu(cur)) + b1)      (dilated conv)
//   cur = cur + conv_{K_k, 1}(y) + b2                   (plain conv)
// with SAME zero padding at EVERY conv: frames outside [0, T) of each
// conv's input read as zero, for the second conv of a pair as for the
// first. The level's output is the average of the blocks' final cur.
//
// Design: one launch per iteration (9 for config_v1's 3 x 3), each fusing
// lrelu -> dilated conv -> bias -> lrelu -> conv -> bias -> residual. A
// block owns TILE output frames of one batch row and all C channels; it
// stages lrelu(cur) for TILE + 2 (c + c d) frames (c = (K - 1) / 2), KC
// input channels at a time, with their weights for all K taps, and keeps
// the pair's intermediate y for TILE + 2c frames in shared memory
// (C x 16 (NF + 1) floats: 40 KB at C = 128 and TILE = 64). y is written
// as zero at frames outside [0, T): that is the second conv's SAME padding
// (the TPU kernel re-zeroes the same positions, fused_mrf.py:94-101, 141,
// 145). The halo is read from global memory with bounds checks, so
// neighbouring tiles re-read it from L2; nothing carries over between
// blocks. The running value ping-pongs between two scratch buffers; the
// last iteration of each block adds its result into the output, and the
// last block scales by 1 / n_blocks. Each thread computes RC = C / 16
// output channels for NF frames spaced 16 apart (register tile), reading
// the staged weights (two addresses a warp) and activations (consecutive
// frames) from shared memory.
//
// What bounds it on this card: operations. At serving A's level 1
// ([8, 128, 26624]) a level is 2 B T C^2 126 = 879 GFLOP of fp32 FMA
// against 218 MB of activations: 13 ms at 67 TFLOP/s, 0.07 ms of traffic.
// The register tile does RC x (NF + 1) FMAs per RC + NF + 1 shared-memory
// loads; the intermediate's frames at the tile's ends are recomputed by
// both neighbours (2c / TILE extra first-conv work), and the first conv
// computes 16 frames more than the TILE + 2c it needs. Tensor cores (TF32
// or bf16 wgmma over [C, K C] x [K C, TILE]) are later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreadsT = 16;   // threads along time in a block
constexpr int kMaxK = 17;       // 2 c <= 16 frames of first-conv headroom
constexpr float kSlope = 0.1f;  // HiFi-GAN's LRELU_SLOPE

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : kSlope * v;
}

template <int C>
struct Shape {
  static constexpr int CG = C < 16 ? C : 16;        // threads along channels
  static constexpr int RC = C / CG;                 // channels per thread
  static constexpr int KC = C < 4 ? C : 4;          // channels staged a step
  static constexpr int kThreads = kThreadsT * CG;
};

struct IterArgs {
  const float* xin;    // [B, C, T] cur
  float* xout;         // [B, C, T] next cur, or null (last iteration)
  float* acc;          // [B, C, T] level output
  const float* w1;     // [K, C, C] (tap, in, out) of the dilated conv
  const float* b1;     // [C]
  const float* w2;     // [K, C, C] of the plain conv
  const float* b2;     // [C]
  int K, d;
  int acc_mode;        // 0: none; 1: acc = v * scale; 2: acc = (acc + v) * scale
  float acc_scale;
};

// Stage the weights of input channels [ci0, ci0 + KC) for every tap.
template <int C>
__device__ __forceinline__ void stage_weights(float* ws, const float* w,
                                              int K, int ci0) {
  using S = Shape<C>;
  for (int e = threadIdx.x; e < K * S::KC * C; e += S::kThreads) {
    const int j = e / (S::KC * C), r = e % (S::KC * C);
    ws[e] = w[(static_cast<long long>(j) * C + ci0 + r / C) * C + r % C];
  }
}

template <int C, int NF>
__global__ void __launch_bounds__(Shape<C>::kThreads)
    mrf_iteration_kernel(IterArgs a, int T) {
  using S = Shape<C>;
  constexpr int RC = S::RC, KC = S::KC;
  constexpr int TILE = kThreadsT * NF;     // output frames of a block
  constexpr int NF1 = NF + 1;              // intermediate frames a thread
  constexpr int NY = kThreadsT * NF1;      // intermediate frames of a block

  extern __shared__ float smem[];
  const int K = a.K, d = a.d, c = (K - 1) / 2;
  const int nxw = NY + (K - 1) * d;        // staged input frames a channel
  float* ys = smem;                        // [C][NY]
  float* ws = ys + C * NY;                 // [K][KC][C]
  float* xs = ws + K * KC * C;             // [KC][nxw]

  const int tx = threadIdx.x % kThreadsT, ty = threadIdx.x / kThreadsT;
  const int t0 = blockIdx.x * TILE;
  const long long row0 = static_cast<long long>(blockIdx.y) * C;
  const int xbase = t0 - c - c * d;        // frame of xs[.][0]
  const int ybase = t0 - c;                // frame of ys[.][0]

  // ---- y = lrelu(conv_{K, d}(lrelu(cur)) + b1), zero outside [0, T)
  float acc1[RC][NF1];
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int i = 0; i < NF1; ++i) acc1[r][i] = 0.f;
  for (int ci0 = 0; ci0 < C; ci0 += KC) {
    stage_weights<C>(ws, a.w1, K, ci0);
    for (int e = threadIdx.x; e < KC * nxw; e += S::kThreads) {
      const int cl = e / nxw, g = xbase + e % nxw;
      xs[e] = (g >= 0 && g < T)
                  ? lrelu(a.xin[(row0 + ci0 + cl) * T + g]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int cl = 0; cl < KC; ++cl) {
      for (int j = 0; j < K; ++j) {
        const float* wr = ws + (j * KC + cl) * C + ty * RC;
        const float* xr = xs + cl * nxw + j * d + tx;
        float wv[RC], xv[NF1];
#pragma unroll
        for (int r = 0; r < RC; ++r) wv[r] = wr[r];
#pragma unroll
        for (int i = 0; i < NF1; ++i) xv[i] = xr[kThreadsT * i];
#pragma unroll
        for (int r = 0; r < RC; ++r)
#pragma unroll
          for (int i = 0; i < NF1; ++i)
            acc1[r][i] = fmaf(wv[r], xv[i], acc1[r][i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const int co = ty * RC + r;
    const float bias = a.b1[co];
#pragma unroll
    for (int i = 0; i < NF1; ++i) {
      const int s = tx + kThreadsT * i, g = ybase + s;
      ys[co * NY + s] = (g >= 0 && g < T) ? lrelu(acc1[r][i] + bias) : 0.f;
    }
  }

  // ---- cur + conv_{K, 1}(y) + b2 (the first stage_weights' barrier
  // makes ys visible)
  float acc2[RC][NF];
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int i = 0; i < NF; ++i) acc2[r][i] = 0.f;
  for (int ci0 = 0; ci0 < C; ci0 += KC) {
    stage_weights<C>(ws, a.w2, K, ci0);
    __syncthreads();
#pragma unroll
    for (int cl = 0; cl < KC; ++cl) {
      for (int j = 0; j < K; ++j) {
        const float* wr = ws + (j * KC + cl) * C + ty * RC;
        const float* yr = ys + (ci0 + cl) * NY + j + tx;
        float wv[RC], yv[NF];
#pragma unroll
        for (int r = 0; r < RC; ++r) wv[r] = wr[r];
#pragma unroll
        for (int i = 0; i < NF; ++i) yv[i] = yr[kThreadsT * i];
#pragma unroll
        for (int r = 0; r < RC; ++r)
#pragma unroll
          for (int i = 0; i < NF; ++i)
            acc2[r][i] = fmaf(wv[r], yv[i], acc2[r][i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const int co = ty * RC + r;
    const float bias = a.b2[co];
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int t = t0 + tx + kThreadsT * i;
      if (t >= T) continue;
      const long long idx = (row0 + co) * T + t;
      const float v = a.xin[idx] + (acc2[r][i] + bias);
      if (a.xout) a.xout[idx] = v;
      if (a.acc_mode == 1) a.acc[idx] = v * a.acc_scale;
      else if (a.acc_mode == 2) a.acc[idx] = (a.acc[idx] + v) * a.acc_scale;
    }
  }
}

template <int C, int NF>
cudaError_t launch_iteration(const IterArgs& a, int B, int T,
                             cudaStream_t stream) {
  using S = Shape<C>;
  constexpr int TILE = kThreadsT * NF, NY = kThreadsT * (NF + 1);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(C) * NY + static_cast<size_t>(a.K) * S::KC * C +
       static_cast<size_t>(S::KC) * (NY + (a.K - 1) * a.d));
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mrf_iteration_kernel<C, NF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TILE - 1) / TILE, B);
  mrf_iteration_kernel<C, NF><<<grid, S::kThreads, smem, stream>>>(a, T);
  return cudaGetLastError();
}

// All n_blocks x n_dil iterations of a level.
template <int C, int NF>
cudaError_t run_level(const float* x, const float* w, const float* bias,
                      float* out, float* tmp0, float* tmp1, int B, int T,
                      int n_blocks, const int* kernel_sizes, int n_dil,
                      const int* dilations, cudaStream_t stream) {
  long long tap = 0;
  int conv = 0;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int K = kernel_sizes[blk];
    const float* cur = x;
    for (int it = 0; it < n_dil; ++it) {
      const bool last = it == n_dil - 1;
      IterArgs a;
      a.xin = cur;
      a.xout = last ? nullptr : (it % 2 == 0 ? tmp0 : tmp1);
      a.acc = out;
      a.w1 = w + tap * C * C;
      a.b1 = bias + static_cast<long long>(conv) * C;
      a.w2 = w + (tap + K) * C * C;
      a.b2 = bias + static_cast<long long>(conv + 1) * C;
      a.K = K;
      a.d = dilations[blk * n_dil + it];
      a.acc_mode = !last ? 0 : (blk == 0 ? 1 : 2);
      a.acc_scale = last && blk == n_blocks - 1 ? 1.f / n_blocks : 1.f;
      const cudaError_t err = launch_iteration<C, NF>(a, B, T, stream);
      if (err != cudaSuccess) return err;
      cur = a.xout;
      tap += 2 * K;
      conv += 2;
    }
  }
  return cudaSuccess;
}

template <int NF>
cudaError_t dispatch_channels(int C, const float* x, const float* w,
                              const float* bias, float* out, float* tmp0,
                              float* tmp1, int B, int T, int n_blocks,
                              const int* ks, int n_dil, const int* ds,
                              cudaStream_t s) {
#define DASPEECH_MRF_CASE(c)                                               \
  case c:                                                                  \
    return run_level<c, NF>(x, w, bias, out, tmp0, tmp1, B, T, n_blocks,   \
                            ks, n_dil, ds, s);
  switch (C) {
    DASPEECH_MRF_CASE(1)
    DASPEECH_MRF_CASE(2)
    DASPEECH_MRF_CASE(4)
    DASPEECH_MRF_CASE(8)
    DASPEECH_MRF_CASE(16)
    DASPEECH_MRF_CASE(32)
    DASPEECH_MRF_CASE(64)
    DASPEECH_MRF_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DASPEECH_MRF_CASE
}

}  // namespace

// x [B, C, T] -> out [B, C, T]: the average over n_blocks of the ResBlock1
// chains with kernel sizes kernel_sizes[n_blocks] and dilations
// dilations[n_blocks * n_dil] (host arrays). w holds every conv's taps
// [K, C, C] (in, out) and bias [2 n_blocks n_dil, C] every conv's bias, in
// the order block, iteration, (dilated, plain). tmp0 and tmp1 are [B, C, T]
// scratch (unused when n_dil == 1; tmp1 unused when n_dil == 2). C is a
// power of two <= 128, each K odd and <= 17, tile 64 or 128 frames.
extern "C" int daspeech_mrf_level(const float* x, const float* w,
                                  const float* bias, float* out, float* tmp0,
                                  float* tmp1, int B, int C, int T,
                                  int n_blocks, const int* kernel_sizes,
                                  int n_dil, const int* dilations, int tile,
                                  void* stream) {
  if (B < 1 || T < 1 || n_blocks < 1 || n_dil < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int K = kernel_sizes[blk];
    if (K < 1 || K > kMaxK || K % 2 == 0)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int it = 0; it < n_dil; ++it)
      if (dilations[blk * n_dil + it] < 1)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 64)
    return static_cast<int>(dispatch_channels<4>(
        C, x, w, bias, out, tmp0, tmp1, B, T, n_blocks, kernel_sizes, n_dil,
        dilations, s));
  if (tile == 128)
    return static_cast<int>(dispatch_channels<8>(
        C, x, w, bias, out, tmp0, tmp1, B, T, n_blocks, kernel_sizes, n_dil,
        dilations, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
