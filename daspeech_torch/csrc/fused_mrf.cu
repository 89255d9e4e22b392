// One HiFi-GAN MRF level for Hopper (sm_90a), inference only, in two
// modes: fp32 weights (daspeech_mrf_level, 3xTF32 products, this file's
// mrf_conv_kernel) and bf16 weights (daspeech_mrf_level_bf16, the TPU
// kernel's arithmetic: each conv's input activation rounded to bf16,
// fused_mrf.py:120, bf16 products with fp32 sums; mrf_bf16.cuh's kernels
// on the bf16 tensor cores). In both the biases, residual spine and output
// are fp32.
//
// Replaces the Pallas kernel of daspeech_tpu/ops/fused_mrf.py:156
// (mrf_level; _mrf_kernel at :87, pallas_call at :182).
//
// A level is n_blocks ResBlock1 chains over the same input x [B, C, T],
// averaged. Each chain is n_dil "iterations"; iteration i of block k is
//   y   = conv_{K_k, d_i}(lrelu(cur)) + b1              (dilated conv)
//   cur = cur + conv_{K_k, 1}(lrelu(y)) + b2            (plain conv)
// with SAME zero padding at EVERY conv: frames outside [0, T) of each
// conv's input read as zero, for the second conv of a pair as for the
// first (the TPU kernel re-zeroes the same positions, fused_mrf.py:94-101,
// 141, 145). The level's output is the average of the blocks' final cur.
//
// What bounds it on this card: operations. At serving A's level 1
// ([8, 128, 26624]) a level is 2 B T C^2 126 = 879 GFLOP against 218 MB of
// activations: 5.3 ms at the tensor cores' 3xTF32 rate (165 TFLOP/s), 13
// ms even at the full 67 TFLOP/s of the fp32 FMA pipes, so the products
// run on the tensor cores.
//
// Design: each conv is an implicit GEMM, one launch per conv (18 a level
// for config_v1), out[co, t] = sum_tap sum_ci W_tap[co, ci] x[ci, t + (tap -
// c) d] (c = (K - 1) / 2): M = C_out, N = a tile of BN frames, depth K C_in
// (up to 11 x 128 = 1408). A block owns BN (64 or 128)
// frames of one batch row and all C channels (padded to CP >= 32 with
// zeros); its CP / 32 x BN / 64 warps each hold a 32-channel x 64-frame
// accumulator (gemm_tc.cuh, 3xTF32 mma.sync m16n8k8). The input is taken
// 16 channels at a time: their activation tile, BN + (K - 1) d frames, is
// split into TF32 hi/lo planes with lrelu applied (zero outside [0, T) and
// past C) and serves every tap as a column-shifted view (no im2col copy).
// For each (channel chunk, tap) stage the 16 x C weight slice W[tap, ci0
// .., :] is split into the other of two plane buffers. Both arrive by
// cp.async into raw fp32 tiles ahead of use, the weights kRing - 1 stages
// ahead, the next channel chunk's activations one chunk ahead, and each
// thread splits what its own copies brought: one barrier a stage. Every
// operand element is split once. The epilogue adds the bias, and for the
// second conv the residual, and writes the running value or the level's
// average. The dilated conv's
// output y goes to a [B, C, T] scratch buffer and the plain conv stages
// lrelu(y) from it: keeping the pair's intermediate in shared memory would
// take ~140 KB of hi/lo planes at C = 128, against ~1.2 ms of traffic for
// the level's 18 x 2 passes over [B, C, T] at serving A (3.35 TB/s).
//
// Sum order: every output sums its ci chunks in order, each chunk's taps in
// order, each (chunk, tap) as two k-steps whose three products go into a
// fresh accumulator added in fp32; it does not depend on the frame's place
// in its tile, on B or on T, so a chunked vocoder's windows reproduce the
// one-shot level.
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_tc.cuh"

namespace {

using namespace daspeech;

constexpr int kMaxK = 17;       // largest kernel size taken
constexpr int KC = 16;          // input channels staged a step
constexpr int kRing = 4;        // raw weight tiles in flight
constexpr int kMaxFrames = 8192;  // most staged frames of a tile
constexpr float kSlope = 0.1f;  // HiFi-GAN's LRELU_SLOPE

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : kSlope * v;
}

struct ConvArgs {
  const float* in;     // [B, C, T] conv input (before lrelu)
  const float* w;      // [K, C, C] (tap, in, out)
  const float* bias;   // [C]
  const float* res;    // [B, C, T] residual added to the output, or null
  float* out;          // [B, C, T] output, or null
  float* acc;          // [B, C, T] level output (acc_mode != 0)
  int K, d;
  int acc_mode;        // 0: none; 1: acc = v * scale; 2: acc = (acc + v) * scale
  float acc_scale;
};

// the staged frames of a tile and their row pitch (>= frames, ≡ 8 mod 32)
__host__ __device__ inline int staged_frames(int BN, int K, int d) {
  return BN + (K - 1) * d;
}
__host__ __device__ inline int frame_pitch(int nx) {
  return nx + ((8 - nx % 32) % 32 + 32) % 32;
}

// a block of BN output frames and CP channels: WM x WN warps of 32
// channels x 64 frames (MT = 2 row blocks of 16, NTW = 8 column blocks of 8)
template <int CP, int BN>
struct Tile {
  static constexpr int MT = 2, NTW = 8;
  static constexpr int WM = CP / (16 * MT), WN = BN / (8 * NTW);
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int WP = CP + 8;          // weight plane pitch
  static constexpr int kWPlane = KC * WP;
  static constexpr int kWRaw = KC * CP;      // a raw weight tile
};

// shared memory of a block: the weight planes [2][2][KC][WP] and raw ring
// [kRing][KC][CP], x planes [2][KC][pitch] and raw [KC][nx]
template <int CP, int BN>
__host__ __device__ inline int smem_words(int nx) {
  using S = Tile<CP, BN>;
  return 2 * KC * frame_pitch(nx) + KC * nx + 4 * S::kWPlane +
         kRing * S::kWRaw;
}

// minimum blocks 1: a bound of two blocks an SM caps a thread at 128
// registers, and the 32 x 64 accumulator then spills
template <int CP, int BN>
__global__ void __launch_bounds__(Tile<CP, BN>::kThreads, 1)
    mrf_conv_kernel(const ConvArgs a, int C, int T) {
  using S = Tile<CP, BN>;
  constexpr int NT = S::kThreads, MT = S::MT, NTW = S::NTW, WP = S::WP;
  constexpr int WPLANE = S::kWPlane;
  using WChunk = gemm::RawChunk<KC, CP, NT>;
  extern __shared__ float4 smem4[];
  const int K = a.K, d = a.d, c = (K - 1) / 2;
  const int NX = staged_frames(BN, K, d), NXP = frame_pitch(NX);
  const int XPLANE = KC * NXP;
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem4);  // weight planes
  float* wraw = reinterpret_cast<float*>(ws + 4 * WPLANE);
  uint32_t* xs = reinterpret_cast<uint32_t*>(wraw + kRing * S::kWRaw);
  float* xraw = reinterpret_cast<float*>(xs + 2 * XPLANE);

  const int warp = threadIdx.x / 32, wm = warp % S::WM, wn = warp / S::WM;
  const int nchunk = CP / KC, nstage = nchunk * K;   // stage: (chunk, tap)
  // the batch row's input and the frame of staged column 0
  const float* in = a.in + static_cast<long long>(blockIdx.y) * C * T;
  const int xbase = static_cast<int>(blockIdx.x) * BN - c * d;

  // the cp.async copies of stage s's weights W[s % K, 16 (s / K) .., :]
  // and of chunk ch's activations; thread tid owns elements tid + i NT
  auto copy_w = [&](int s) {
    WChunk::copy(wraw + (s % kRing) * S::kWRaw, CP,
                 a.w + static_cast<long long>(s % K) * C * C, C,
                 (s / K) * KC, 0, C, C, C % 4 == 0);
  };
  auto copy_x = [&](int ch) {
    for (int e = threadIdx.x; e < KC * NX; e += NT) {
      const int r = e / NX, ci = ch * KC + r, g = xbase + e - r * NX;
      const bool ok = ci < C && g >= 0 && g < T;
      cp_async<4>(xraw + e,
                  ok ? in + static_cast<long long>(ci) * T + g : in, ok);
    }
  };

  float acc[MT][NTW][4];
  gemm::zero(acc);
  copy_x(0);
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < nstage) copy_w(s);
    cp_async_commit();
  }
  for (int s = 0; s < nstage; ++s) {
    const int j = s % K;
    if (j == 0) {
      if (s) __syncthreads();             // the last chunk's products are done
      cp_async_wait<0>();                 // this chunk's activations
      for (int e = threadIdx.x; e < KC * NX; e += NT) {
        const int r = e / NX;
        gemm::put(xs, XPLANE, r * NXP + e - r * NX, lrelu(xraw[e]));
      }
    } else {
      cp_async_wait<kRing - 2>();         // stage s's weights
    }
    uint32_t* wb = ws + (s & 1) * 2 * WPLANE;
    WChunk::split(wraw + (s % kRing) * S::kWRaw, CP, wb, WPLANE, WP);
    __syncthreads();
    if (j == 0 && s / K + 1 < nchunk) copy_x(s / K + 1);
    if (s + kRing - 1 < nstage) copy_w(s + kRing - 1);
    cp_async_commit();
    // A = W_tap [ci][co] (k outer), B = the tile shifted by j d frames
    gemm::warp_mma<MT, NTW, KC / 8, true, true>(
        acc, gemm::Op{wb, WPLANE, WP, wm * 16 * MT, 0},
        gemm::Op{xs, XPLANE, NXP, wn * 8 * NTW + j * d, 0});
  }
  const int lane = threadIdx.x % 32, gid = lane >> 2, tq = lane & 3;
  const int t0 = blockIdx.x * BN, b = blockIdx.y;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = wm * 16 * MT + 16 * m + gid + 8 * h;
      if (co >= C) continue;
      const float bias = a.bias[co];
      const long long row = (static_cast<long long>(b) * C + co) * T;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + wn * 8 * NTW + 8 * n + 2 * tq + e;
          if (t >= T) continue;
          const long long idx = row + t;
          float v = acc[m][n][2 * h + e] + bias;
          if (a.res) v = a.res[idx] + v;
          if (a.out) a.out[idx] = v;
          if (a.acc_mode == 1) {
            a.acc[idx] = v * a.acc_scale;
          } else if (a.acc_mode == 2) {
            a.acc[idx] = (a.acc[idx] + v) * a.acc_scale;
          }
        }
      }
    }
  }
}

template <int CP, int BN>
cudaError_t launch_conv(const ConvArgs& a, int B, int C, int T,
                        cudaStream_t stream) {
  using S = Tile<CP, BN>;
  if (a.d > kMaxFrames) return cudaErrorInvalidValue;
  const int nx = staged_frames(BN, a.K, a.d);
  if (nx > kMaxFrames) return cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * smem_words<CP, BN>(nx);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mrf_conv_kernel<CP, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BN - 1) / BN, B);
  mrf_conv_kernel<CP, BN><<<grid, S::kThreads, smem, stream>>>(a, C, T);
  return cudaGetLastError();
}

// All n_blocks x n_dil iterations of a level, two convs each
template <int CP, int BN>
cudaError_t run_level(const float* x, const float* w, const float* bias,
                      float* out, float* tmp0, float* tmp1, float* ybuf,
                      int B, int C, int T, int n_blocks,
                      const int* kernel_sizes, int n_dil,
                      const int* dilations, cudaStream_t stream) {
  const long long CC = static_cast<long long>(C) * C;
  long long tap = 0;
  int conv = 0;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int K = kernel_sizes[blk];
    const float* cur = x;
    for (int it = 0; it < n_dil; ++it) {
      const bool last = it == n_dil - 1;
      ConvArgs a{};
      a.in = cur;
      a.w = w + tap * CC;
      a.bias = bias + static_cast<long long>(conv) * C;
      a.out = ybuf;
      a.K = K;
      a.d = dilations[blk * n_dil + it];
      cudaError_t err = launch_conv<CP, BN>(a, B, C, T, stream);
      if (err != cudaSuccess) return err;
      ConvArgs p{};
      p.in = ybuf;
      p.w = w + (tap + K) * CC;
      p.bias = bias + static_cast<long long>(conv + 1) * C;
      p.res = cur;
      p.out = last ? nullptr : (it % 2 == 0 ? tmp0 : tmp1);
      p.acc = out;
      p.K = K;
      p.d = 1;
      p.acc_mode = !last ? 0 : (blk == 0 ? 1 : 2);
      p.acc_scale = last && blk == n_blocks - 1 ? 1.f / n_blocks : 1.f;
      if ((err = launch_conv<CP, BN>(p, B, C, T, stream)) !=
          cudaSuccess) {
        return err;
      }
      cur = p.out;
      tap += 2 * K;
      conv += 2;
    }
  }
  return cudaSuccess;
}

template <int BN>
cudaError_t dispatch_channels(int C, const float* x, const float* w,
                              const float* bias, float* out, float* tmp0,
                              float* tmp1, float* ybuf, int B, int T,
                              int n_blocks, const int* ks, int n_dil,
                              const int* ds, cudaStream_t s) {
  if (C < 1 || C > 128 || (C & (C - 1))) return cudaErrorInvalidValue;
  if (C <= 32) {
    return run_level<32, BN>(x, w, bias, out, tmp0, tmp1, ybuf, B, C, T,
                             n_blocks, ks, n_dil, ds, s);
  }
  if (C == 64) {
    return run_level<64, BN>(x, w, bias, out, tmp0, tmp1, ybuf, B, C, T,
                             n_blocks, ks, n_dil, ds, s);
  }
  return run_level<128, BN>(x, w, bias, out, tmp0, tmp1, ybuf, B, C, T,
                            n_blocks, ks, n_dil, ds, s);
}

#include "mrf_bf16.cuh"

// what both modes take: n_blocks >= 1 chains of n_dil >= 1 iterations,
// odd kernel sizes <= kMaxK, dilations >= 1, tile 64 or 128
bool level_ok(int B, int T, int n_blocks, const int* kernel_sizes, int n_dil,
              const int* dilations, int tile) {
  if (B < 1 || T < 1 || n_blocks < 1 || n_dil < 1) return false;
  if (tile != 64 && tile != 128) return false;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int K = kernel_sizes[blk];
    if (K < 1 || K > kMaxK || K % 2 == 0) return false;
    for (int it = 0; it < n_dil; ++it)
      if (dilations[blk * n_dil + it] < 1) return false;
  }
  return true;
}

}  // namespace

// x [B, C, T] -> out [B, C, T]: the average over n_blocks of the ResBlock1
// chains with kernel sizes kernel_sizes[n_blocks] and dilations
// dilations[n_blocks * n_dil] (host arrays). w holds every conv's taps
// [K, C, C] (in, out) and bias [2 n_blocks n_dil, C] every conv's bias, in
// the order block, iteration, (dilated, plain). tmp0 and tmp1 are [B, C, T]
// scratch for the running value (unused when n_dil == 1; tmp1 unused when
// n_dil == 2), ybuf [B, C, T] scratch for each dilated conv's output. C is
// a power of two <= 128, each K odd and <= 17, tile (output frames a
// block) 64 or 128.
extern "C" int daspeech_mrf_level(const float* x, const float* w,
                                  const float* bias, float* out, float* tmp0,
                                  float* tmp1, float* ybuf, int B, int C,
                                  int T, int n_blocks,
                                  const int* kernel_sizes, int n_dil,
                                  const int* dilations, int tile,
                                  void* stream) {
  if (!level_ok(B, T, n_blocks, kernel_sizes, n_dil, dilations, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      tile == 64 ? dispatch_channels<64>(C, x, w, bias, out, tmp0, tmp1,
                                         ybuf, B, T, n_blocks, kernel_sizes,
                                         n_dil, dilations, s)
                 : dispatch_channels<128>(C, x, w, bias, out, tmp0, tmp1,
                                          ybuf, B, T, n_blocks, kernel_sizes,
                                          n_dil, dilations, s));
}

// the same with bf16 w, the taps [n_taps, CP, CP] (in, out) zero-padded to
// CP = max(C, 16) channels (every conv's input rounded to bf16, bf16
// products, fp32 sums); x, bias, out, tmp0 and tmp1 stay fp32, and ws (the
// fp32 mode's ybuf) is bf16 [3, B, T, CP] scratch for the convs' inputs
extern "C" int daspeech_mrf_level_bf16(const float* x, const void* w,
                                       const float* bias, float* out,
                                       float* tmp0, float* tmp1, void* ws,
                                       int B, int C, int T, int n_blocks,
                                       const int* kernel_sizes, int n_dil,
                                       const int* dilations, int tile,
                                       void* stream) {
  if (!level_ok(B, T, n_blocks, kernel_sizes, n_dil, dilations, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* wb = static_cast<const uint16_t*>(w);
  uint16_t* wsb = static_cast<uint16_t*>(ws);
  return static_cast<int>(
      tile == 64 ? bf::dispatch_channels<64>(C, x, wb, bias, out, tmp0, tmp1,
                                             wsb, B, T, n_blocks,
                                             kernel_sizes, n_dil, dilations,
                                             s)
                 : bf::dispatch_channels<128>(C, x, wb, bias, out, tmp0,
                                              tmp1, wsb, B, T, n_blocks,
                                              kernel_sizes, n_dil, dilations,
                                              s));
}
