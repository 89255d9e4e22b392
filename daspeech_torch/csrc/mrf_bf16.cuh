// The bf16 mode of the HiFi-GAN MRF level (#7) on Hopper's bf16 tensor
// cores (sm_90a): the kernels of daspeech_mrf_level_bf16 in fused_mrf.cu,
// which includes this header after its shared pieces (kMaxFrames, kSlope,
// lrelu). They replace the Pallas kernel of daspeech_tpu/ops/fused_mrf.py:156
// (mrf_level; _mrf_kernel at :87) in its own arithmetic: each conv's input
// lrelu'd, then rounded to bf16 (:120), one full-depth bf16 dot a tap with
// fp32 sums (:117-126 tap_conv, :175-178). The residual spine, the biases,
// the level average and the output stay fp32. The fp32 level keeps
// fused_mrf.cu's 3xTF32 kernel.
//
// What bounds it on this card: operations. At serving A's level 1 ([8, 128,
// 26624]) the level's 18 convs are 126 taps of 2 B T C^2 flops, 879 GFLOP:
// 0.89 ms at 989 TFLOP/s, against 218 MB of fp32 activations. So every tap
// is bf16 mma.sync m16n8k16 with fp32 accumulators, fed by ldmatrix from
// tiles that arrive by 16-byte cp.async and are read as they arrived.
//
// Layout: inside the level each conv's input is a bf16 [B, T, CP] tensor,
// channels contiguous (CP = C, or 16 for C < 16, the extra channels zero),
// holding bf16(lrelu(input)). mrf_bf16_act_kernel writes it once for the
// level's input x ([B, C, T] fp32); after that every conv's epilogue writes
// the next conv's: the dilated conv's y only as bf16(lrelu(y)) (the plain
// conv reads nothing else of it), the plain conv's running value both as
// the fp32 spine ([B, C, T]) and as bf16(lrelu(cur)) for the next dilated
// conv. The weights are the taps [K, CP, CP] (in, out), zero-padded to CP
// channels (ops/fused_mrf.py pack_bf16_taps).
//
// A block owns BN (64 or 128) output frames of one batch row and all CP
// output channels: warps of 32 frames x WC channels (WC = 64 for CP = 128,
// else CP). It stages the conv's input frames t0 - c d .. t0 + BN + c d
// (zero outside [0, T)) once, as a [BN + (K - 1) d][CP + 8] bf16 tile, and
// streams the taps' [CP][CP + 8] weight tiles through two stages, one tap
// ahead. A stage contracts a whole tap over all CP input channels (CP / 16
// k-steps between two barriers, 8 at C = 128): A is the activation tile
// read at the rows shifted by the tap's j d frames (plain ldmatrix: frames
// are its rows, channels its contraction), B the tap's weights [ci][co]
// (ldmatrix.trans). Sums stay in the accumulators across taps and k-steps.
// The epilogue adds the bias (and, in the plain conv, the residual) and
// writes as above.
//
// Sum order: every output (channel, frame) sums its taps in order, each
// tap's input channels in k-steps of 16 in order, chained in one fp32
// accumulator; it does not depend on the frame's place in its tile, on B or
// on T, so every tile gives the same bits and a chunked vocoder's windows
// reproduce the one-shot level.
#pragma once

namespace bf {

constexpr int kStages = 2;         // weight tiles in flight (one tap ahead)

template <int CP, int BN>
struct Conv {
  static constexpr int WN = CP >= 128 ? 2 : 1;  // warps along the channels
  static constexpr int WC = CP / WN;            // channels of a warp
  static constexpr int NB = WC / 8;             // its 8-channel blocks
  static constexpr int WM = BN / 32;            // warps along the frames
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int P = CP + 8;              // pitch (bf16) of the tiles
  static constexpr int kWTile = CP * P;         // elements of a tap's tile
  // at least 16 warps an SM where shared memory allows: 128 registers a
  // thread
  static constexpr int kMinBlocks = 512 / kThreads;
};

// shared memory of a block staging nx input frames
template <int CP, int BN>
__host__ inline size_t smem_bytes(int nx) {
  using S = Conv<CP, BN>;
  return 2 * (static_cast<size_t>(kStages) * S::kWTile +
              static_cast<size_t>(nx) * S::P);
}

struct ConvArgs {
  const uint16_t* in;   // [B, T, CP] bf16(lrelu(conv input))
  const uint16_t* w;    // [K, CP, CP] taps (in, out)
  const float* bias;    // [C]
  const float* res;     // [B, C, T] residual added to the output, or null
  float* out;           // [B, C, T] output, or null
  uint16_t* act;        // [B, T, CP] bf16(lrelu(output)), or null
  float* acc;           // [B, C, T] level output (acc_mode != 0)
  int K, d;
  int acc_mode;         // 0: none; 1: acc = v * scale; 2: acc = (acc + v) * scale
  float acc_scale;
};

// x [B, C, T] fp32 -> xa [B, T, CP] bf16(lrelu(x)), 0 for channels >= C:
// 32 x 32 tiles through shared memory (reads along T, writes along C)
__global__ void mrf_bf16_act_kernel(const float* x, uint16_t* xa, int C,
                                    int CP, int T) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;   // 32 x 8
  const int t0 = blockIdx.x * 32, c0 = blockIdx.y * 32, b = blockIdx.z;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 8 * i, t = t0 + tx;
    tile[ty + 8 * i][tx] =
        c < C && t < T ? x[(static_cast<long long>(b) * C + c) * T + t] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 8 * i, c = c0 + tx;
    if (t < T && c < CP) {
      xa[(static_cast<long long>(b) * T + t) * CP + c] =
          gemm::f2bf(lrelu(tile[tx][ty + 8 * i]));
    }
  }
}

template <int CP, int BN>
__global__ void __launch_bounds__(Conv<CP, BN>::kThreads,
                                  Conv<CP, BN>::kMinBlocks)
    mrf_bf16_conv_kernel(const ConvArgs a, int C, int T) {
  using S = Conv<CP, BN>;
  constexpr int NT = S::kThreads, P = S::P, NB = S::NB;
  extern __shared__ float4 smem4[];
  uint16_t* wt = reinterpret_cast<uint16_t*>(smem4);   // [kStages][CP][P]
  uint16_t* xt = wt + kStages * S::kWTile;             // [nx][P]
  const int K = a.K, d = a.d, c = (K - 1) / 2;
  const int nx = BN + (K - 1) * d;
  const int b = blockIdx.y, t0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, wm = warp % S::WM, wn = warp / S::WM;

  // the input frames t0 - c d .. of batch row b (zero outside [0, T)) and
  // tap 0's weights, one group; each later tap a group of its own
  {
    const uint16_t* in = a.in + static_cast<long long>(b) * T * CP;
    const int xbase = t0 - c * d;
    for (int g = threadIdx.x; g < nx * (CP / 8); g += NT) {
      const int r = g / (CP / 8), c8 = 8 * (g % (CP / 8)), t = xbase + r;
      const bool ok = t >= 0 && t < T;
      cp_async<16>(xt + r * P + c8,
                   ok ? in + static_cast<long long>(t) * CP + c8 : in, ok);
    }
  }
  auto copy_w = [&](int j) {   // tap j's [CP][CP] into stage j % kStages
    const uint16_t* src = a.w + static_cast<long long>(j) * CP * CP;
    uint16_t* dst = wt + (j % kStages) * S::kWTile;
    for (int g = threadIdx.x; g < CP * (CP / 8); g += NT) {
      const int r = g / (CP / 8), c8 = 8 * (g % (CP / 8));
      cp_async<16>(dst + r * P + c8, src + r * CP + c8, true);
    }
  };
  copy_w(0);
  cp_async_commit();

  float acc[2][NB][4];
  gemm::zero(acc);
  for (int j = 0; j < K; ++j) {
    cp_async_wait<0>();     // tap j (and, first, the input): this thread's
    __syncthreads();        // everyone's; tap j - 1's stage is free
    if (j + 1 < K) copy_w(j + 1);
    cp_async_commit();
    // A: the input at frame rows shifted by j d; B: tap j [ci][co]
    gemm::warp_mma_bf16<2, NB, CP / 16, false, true>(
        acc, xt + (wm * 32 + j * d) * P, P,
        wt + (j % kStages) * S::kWTile + wn * S::WC, P);
  }

  const int lane = threadIdx.x % 32, gid = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm * 32 + 16 * m + gid + 8 * h;
      if (t >= T) continue;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int co = wn * S::WC + 8 * n + 2 * tq;
        float v[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (co + e >= C) continue;
          const long long idx =
              (static_cast<long long>(b) * C + co + e) * T + t;
          v[e] = acc[m][n][2 * h + e] + a.bias[co + e];
          if (a.res) v[e] = a.res[idx] + v[e];
          if (a.out) a.out[idx] = v[e];
          if (a.acc_mode == 1) {
            a.acc[idx] = v[e] * a.acc_scale;
          } else if (a.acc_mode == 2) {
            a.acc[idx] = (a.acc[idx] + v[e]) * a.acc_scale;
          }
        }
        if (a.act) {
          *reinterpret_cast<uint32_t*>(
              a.act + (static_cast<long long>(b) * T + t) * CP + co) =
              gemm::pack_bf16(lrelu(v[0]), lrelu(v[1]));
        }
      }
    }
  }
}

template <int CP, int BN>
cudaError_t launch_conv(const ConvArgs& a, int B, int C, int T,
                        cudaStream_t stream) {
  using S = Conv<CP, BN>;
  if (a.d > kMaxFrames) return cudaErrorInvalidValue;
  const int nx = BN + (a.K - 1) * a.d;
  if (nx > kMaxFrames) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<CP, BN>(nx);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mrf_bf16_conv_kernel<CP, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BN - 1) / BN, B);
  mrf_bf16_conv_kernel<CP, BN><<<grid, S::kThreads, smem, stream>>>(a, C, T);
  return cudaGetLastError();
}

// All n_blocks x n_dil iterations of a level, two convs each; ws holds the
// three bf16 [B, T, CP] activations: the level input's (xa), the dilated
// conv's output's (ya) and the running value's (ca)
template <int CP, int BN>
cudaError_t run_level(const float* x, const uint16_t* w, const float* bias,
                      float* out, float* tmp0, float* tmp1, uint16_t* ws,
                      int B, int C, int T, int n_blocks,
                      const int* kernel_sizes, int n_dil,
                      const int* dilations, cudaStream_t stream) {
  const long long CC = static_cast<long long>(CP) * CP;
  const long long BTC = static_cast<long long>(B) * T * CP;
  uint16_t *xa = ws, *ya = ws + BTC, *ca = ws + 2 * BTC;
  mrf_bf16_act_kernel<<<dim3((T + 31) / 32, (CP + 31) / 32, B), dim3(32, 8),
                        0, stream>>>(x, xa, C, CP, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long long tap = 0;
  int conv = 0;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int K = kernel_sizes[blk];
    const float* cur = x;
    const uint16_t* cur_act = xa;
    for (int it = 0; it < n_dil; ++it) {
      const bool last = it == n_dil - 1;
      ConvArgs a{};
      a.in = cur_act;
      a.w = w + tap * CC;
      a.bias = bias + static_cast<long long>(conv) * C;
      a.act = ya;
      a.K = K;
      a.d = dilations[blk * n_dil + it];
      if ((err = launch_conv<CP, BN>(a, B, C, T, stream)) != cudaSuccess) {
        return err;
      }
      ConvArgs p{};
      p.in = ya;
      p.w = w + (tap + K) * CC;
      p.bias = bias + static_cast<long long>(conv + 1) * C;
      p.res = cur;
      p.out = last ? nullptr : (it % 2 == 0 ? tmp0 : tmp1);
      p.act = last ? nullptr : ca;
      p.acc = out;
      p.K = K;
      p.d = 1;
      p.acc_mode = !last ? 0 : (blk == 0 ? 1 : 2);
      p.acc_scale = last && blk == n_blocks - 1 ? 1.f / n_blocks : 1.f;
      if ((err = launch_conv<CP, BN>(p, B, C, T, stream)) != cudaSuccess) {
        return err;
      }
      cur = p.out;
      cur_act = ca;
      tap += 2 * K;
      conv += 2;
    }
  }
  return cudaSuccess;
}

template <int BN>
cudaError_t dispatch_channels(int C, const float* x, const uint16_t* w,
                              const float* bias, float* out, float* tmp0,
                              float* tmp1, uint16_t* ws, int B, int T,
                              int n_blocks, const int* ks, int n_dil,
                              const int* ds, cudaStream_t s) {
  if (C < 1 || C > 128 || (C & (C - 1))) return cudaErrorInvalidValue;
  if (C <= 16) {
    return run_level<16, BN>(x, w, bias, out, tmp0, tmp1, ws, B, C, T,
                             n_blocks, ks, n_dil, ds, s);
  }
  if (C == 32) {
    return run_level<32, BN>(x, w, bias, out, tmp0, tmp1, ws, B, C, T,
                             n_blocks, ks, n_dil, ds, s);
  }
  if (C == 64) {
    return run_level<64, BN>(x, w, bias, out, tmp0, tmp1, ws, B, C, T,
                             n_blocks, ks, n_dil, ds, s);
  }
  return run_level<128, BN>(x, w, bias, out, tmp0, tmp1, ws, B, C, T,
                            n_blocks, ks, n_dil, ds, s);
}

}  // namespace bf
