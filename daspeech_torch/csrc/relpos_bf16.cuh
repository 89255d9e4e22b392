// bf16 rel-pos attention (#5) on Hopper's bf16 tensor cores (sm_90a): the
// kernels of the _bf16 entry points of fused_relpos.cu, forward (training
// and inference) and backward. They replace the bf16 mode of the Pallas
// kernels of daspeech_tpu/ops/fused_relpos.py:373 (fused_attention_relpos:
// forward _relpos_fwd_kernel :90, backward _relpos_bwd_kernel :125), which
// upcast bf16 q, k, v, a, e (and dO) to f32, keep the softmax, P and dS in
// f32 and cast out, dq, dk, dv and da to bf16. The fp32 entry points keep
// attention_fma.cuh's FMA training forward and attention_tc.cuh's 3xTF32
// chunked-score kernels.
//
// The score is a 320-deep dot product of the extended query [q | a] with
// the extended key [k | e] (fused_relpos.cu), taken as five 64-deep chunk
// pairs: (q, k), then four of (a, e). Each pair's product is one bf16
// mma.sync m16n8k16 chain with fp32 accumulators (tiles_bf16.cuh), exact
// products of bf16 inputs, as is dP = dO·Vᵀ.
//
// What bounds it on this card: at cell T's encoder (B=80, H=4, T'=120) the
// forward reads 19.7 MB of a ([80, 120, 1024] bf16) and 4.9 MB each of q, k
// and v; forward and backward move about 84 MB of bf16 operands and
// outputs (0.025 ms at 3.35 TB/s) against 11.2 GFLOP of products (0.011 ms
// at 989 TFLOP/s): the bytes. e ([T, 256], the same for every row and
// head) stays in L2.
//
// Layout: as attention_tc.cuh's chunked-score kernels, with bf16 tiles. Per
// key tile a block takes six steps, each one pair of 64 x 64 bf16 tiles
// (9 KiB each at a pitch of 72) streamed by 16-byte cp.async into one of
// two stages: the five score chunks, then the value step (the forward: V
// alone, for O += P·V; the backward: dO and V, for dP = dO·Vᵀ). The bias
// comes with the step at whose end the softmax is taken. A stage is 18.3
// KiB and a block 37 KiB, so four blocks (the 128-register bound) share an
// SM; a resident 64 x 320 query side (45 KiB in bf16) with the same key
// stream would hold the forward to two. The query side's chunks are
// re-read for every key tile, from L2 after the first.
//
// The forward is attention_bf16.cuh's (tiles_bf16.cuh's softmax_tile and
// finish_forward), with P·V two-term: the online softmax on the
// accumulator fragments with ex2.approx, the fp32 sum of exp(s − m) saved
// as the statistic and normalizing the output, and a training forward's
// output also in fp32 (o32) for the backward's delta.
//
// Backward, two launches and no atomics (bit-identical from run to run):
//   1. relpos_bf16_ds_kernel, one block per (query tile, head, batch row):
//      delta = rowsum(dO∘O32), then per key tile S (five chunk pairs) and
//      dP, and dS = P∘(Z∘dP − delta) and P∘Z written in fp32 to the
//      [B, H, T, T] scratch the wrapper passes (each element once);
//   2. relpos_bf16_grad_kernel, one block per (64-row tile, output, head,
//      batch row), seven outputs of 64 channels: dq = scale dS·k, the four
//      64-column parts of da = scale dS·e, dk = scale dSᵀ·q and dv =
//      (P∘Z)ᵀ·dO, each a product of the fp32 scratch (its tiles read by
//      cp.async, made into bf16 A fragments as they are read) with a bf16
//      operand (ldmatrix.trans).
// Why not one dq kernel that keeps dS in registers, as attention_bf16.cuh
// does: [dq | da] is 320 columns, 160 fp32 accumulators a thread for a
// warp's 16 rows, which does not fit beside S and dP; taking da in column
// passes would recompute the 320-deep score five times (that layout was
// not built). The scratch costs 2 x 18.4 MB written and read back at cell
// T (about 22 us at 3.35 TB/s; much of it stays in the 50 MB L2).
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6):
// at cell T the forward takes 0.047 ms of device time, the dS kernel 0.067
// and the gradient kernel 0.056, 0.170 in all against SDPA's 0.328 on
// [q | a], [k | e] for the same forward and backward.
//
// Rounding of P, P∘Z and dS (tests/test_torch_bf16_relpos.py decides it and
// holds the constants below): each product that takes one of those fp32
// matrices takes it one-term (rounded to bf16, one MMA) or two-term (hi =
// bf16(x), lo = bf16(x − hi), two MMAs), one-term wherever the outputs stay
// within a quarter of the 2^-7 bar of float64 at the test's cases (P·V:
// within half of that, since the output passes through every later layer
// and, through delta, into every gradient). So every product is two-term,
// P·V too: one-term it reached 1.9e-3 of that 2^-7 bar's quarter (1.95e-3)
// and put da at 1.7e-3 (two-term 3.7e-6), and on the card it put the
// joint J-long bf16 step's loss 0.2557 from fp32's against chip_smoke.py's
// bar of 0.1861 (two-term 0.0954). The forward then takes P·V as hi + lo,
// and the output's normalizer is the fp32 sum of exp(s − m).
//
// Dropout draws the bits of every other attention kernel (tiles.cuh's
// row_keep_bits): word (j % 4) of philox4x32_10((j / 4, i, h, 0), (seed[b],
// 0)), once per element in the forward and once in the dS kernel.
//
// Ragged tiles: rows past Tq or Tk are zero-filled by cp.async (and the
// scratch tiles past T by load_f32_tile); keys past Tk get score −inf
// (forward) or P = 0 (dS); a fully padded row (every bias −1e30) averages
// over its Tk keys, as the plain version does.
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

// MMAs per product of an fp32 operand (1: one-term, 2: two-term); see
// "Rounding of P, P∘Z and dS"
constexpr int kTermsRelPV = 2;    // O += P·V
constexpr int kTermsRelDSK = 2;   // dq = scale dS·k
constexpr int kTermsRelDSE = 2;   // da = scale dS·e
constexpr int kTermsRelDSQ = 2;   // dk = scale dSᵀ·q
constexpr int kTermsRelPDO = 2;   // dv = (P∘Z)ᵀ·dO

// the gradient kernel takes every output's product in one form
static_assert(kTermsRelDSK == kTermsRelDSE && kTermsRelDSK == kTermsRelDSQ &&
                  kTermsRelDSK == kTermsRelPDO,
              "the gradient kernel's products share one form");

constexpr int kRelChunks = 5;              // (q, k), then four (a, e)
constexpr int kRelSteps = kRelChunks + 1;  // and the value step

// a stage: two bf16 tiles, then the key tile's 64 fp32 column biases
constexpr int kRelStage = 2 * kTileBytes + kRows * 4;
constexpr int kRelSmem = 2 * kRelStage;

// step c of the key tile at j0 for the query tile at i0: c < kRelChunks
// loads score chunk c; c == kRelChunks the value step (the forward: V
// alone; BWD: dO and V). The bias comes with the forward's last score chunk
// and with the backward's value step.
template <bool BWD>
__device__ __forceinline__ void rel_load_step(unsigned char* st,
                                              const AttnArgs& f,
                                              const Operand& dout, int b,
                                              int h, int i0, int j0, int c) {
  uint16_t* x = reinterpret_cast<uint16_t*>(st);
  uint16_t* y = reinterpret_cast<uint16_t*>(st + kTileBytes);
  if (c < kRelChunks) {
    load_tile(x, c == 0 ? f.q : channels(f.a, 64 * (c - 1)), b, h, i0, f.Tq);
    load_tile(y, c == 0 ? f.k : channels(f.e, 64 * (c - 1)), b, h, j0, f.Tk);
  } else if (!BWD) {
    load_tile(x, f.v, b, h, j0, f.Tk);
  } else {
    load_tile(x, dout, b, h, i0, f.Tq);
    load_tile(y, f.v, b, h, j0, f.Tk);
  }
  if (c != (BWD ? kRelChunks : kRelChunks - 1) || threadIdx.x >= kRows) {
    return;
  }
  const int j = j0 + threadIdx.x;
  const bool ok = j < f.Tk;
  cp_async<4>(reinterpret_cast<float*>(st + 2 * kTileBytes) + threadIdx.x,
              f.bias + b * f.bias_sb + (ok ? j : 0), ok);
}

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(kThreads, 4)
relpos_bf16_fwd_kernel(const AttnArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const int ia = i0 + warp * 16 + gid;   // this thread's rows ia, ia + 8
  const uint32_t seed =
      args.drop.seeds != nullptr ? args.drop.seeds[b] : 0u;
  const int nsteps = (args.Tk + kRows - 1) / kRows * kRelSteps;

  rel_load_step<false>(smem, args, args.v, b, h, i0, 0, 0);
  cp_async_commit();

  float s[8][4], o[8][4];
  tc::zero(s);
  tc::zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
        lr[2] = {0.f, 0.f};
  for (int st = 0; st < nsteps; ++st) {
    const int c = st % kRelSteps, j0 = st / kRelSteps * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < nsteps) {
      const int nx = st + 1;
      rel_load_step<false>(smem + (nx & 1) * kRelStage, args, args.v, b, h,
                           i0, nx / kRelSteps * kRows, nx % kRelSteps);
      cp_async_commit();
    }
    const unsigned char* X = smem + (st & 1) * kRelStage;
    const uint16_t* Xs = reinterpret_cast<const uint16_t*>(X);
    if (c == kRelChunks) {                  // O += P·V
      mma_cols<kTermsRelPV, 4>(o, elems(s), Xs, lane);
      continue;
    }
    if (c == 0) tc::zero(s);
    mma_rows<8>(s, Xs + warp * 16 * kPitch,
                reinterpret_cast<const uint16_t*>(X + kTileBytes), lane);
    if (c == kRelChunks - 1) {
      softmax_tile<kTermsRelPV>(s, o, m, l, lr,
                   reinterpret_cast<const float*>(X + 2 * kTileBytes), j0,
                   args, seed, ia, tc::drop_head(args, h), t);
    }
  }
  finish_forward(args, b, h, ia, t, o, m, l, lr);
}

// ---------------------------------------------------------------- dS

__global__ void __launch_bounds__(kThreads, 4)
relpos_bf16_ds_kernel(const AttnBwdArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnArgs& f = args.f;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const int ia = i0 + warp * 16 + gid;
  const bool drop = f.drop.seeds != nullptr;
  const uint32_t seed = drop ? f.drop.seeds[b] : 0u;
  const int nsteps = (f.Tk + kRows - 1) / kRows * kRelSteps;
  // the register the step loop keeps: the dropout counter's head; its
  // loads and stores take h from the grid (tc::grid_head)
  const int hd = tc::drop_head(f, h);

  rel_load_step<true>(smem, f, args.dout, b, h, i0, 0, 0);
  cp_async_commit();
  float delta[2], rmax[2], rinv[2];
  backward_rows(args, b, h, i0, warp, lane, delta, rmax, rinv);

  float s[8][4], dp[8][4];
  tc::zero(s);
  for (int st = 0; st < nsteps; ++st) {
    const int c = st % kRelSteps, j0 = st / kRelSteps * kRows;
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < nsteps) {
      const int nx = st + 1;
      rel_load_step<true>(smem + (nx & 1) * kRelStage, f, args.dout, b,
                          tc::grid_head(), i0, nx / kRelSteps * kRows,
                          nx % kRelSteps);
      cp_async_commit();
    }
    const unsigned char* X = smem + (st & 1) * kRelStage;
    const uint16_t* A =
        reinterpret_cast<const uint16_t*>(X) + warp * 16 * kPitch;
    const uint16_t* Y = reinterpret_cast<const uint16_t*>(X + kTileBytes);
    if (c < kRelChunks) {
      if (c == 0) tc::zero(s);
      mma_rows<8>(s, A, Y, lane);
      continue;
    }
    tc::zero(dp);
    mma_rows<8>(dp, A, Y, lane);            // dO·Vᵀ
    const float* Bs = reinterpret_cast<const float*>(X + 2 * kTileBytes);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int jj = n * 8 + 2 * t;
      const float2 bias = *reinterpret_cast<const float2*>(Bs + jj);
      uint2 bits = make_uint2(0u, 0u);
      if (drop) {
        bits = tc::row_keep_bits(f.drop, seed, ia, j0 + n * 8, hd, t);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, cc = e & 1;
        const float p =
            (j0 + jj + cc < f.Tk)
                ? ex2((s[n][e] * f.scale + (cc ? bias.y : bias.x) - rmax[r]) *
                      kLog2e) * rinv[r]
                : 0.f;
        const float z = !drop ? 1.f
                        : tc::row_keep(bits, r, cc, t) ? f.drop.scale
                                                       : 0.f;
        s[n][e] = p * (z * dp[n][e] - delta[r]);   // dS
        dp[n][e] = p * z;                          // P∘Z
      }
    }
    // each element once, 32 contiguous bytes per row and quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = ia + 8 * r;
      if (i >= f.Tq) continue;
      const long long row =
          ((static_cast<long long>(blockIdx.z) * f.H + tc::grid_head()) * f.Tq +
           i) * f.Tk;
      float* ds_row = args.dbias + row;
      float* pz_row = args.pz + row;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int j = j0 + n * 8 + 2 * t;
        if (j >= f.Tk) continue;
        if ((f.Tk & 1) == 0) {              // j even: j + 1 < Tk, aligned
          *reinterpret_cast<float2*>(ds_row + j) =
              make_float2(s[n][2 * r], s[n][2 * r + 1]);
          *reinterpret_cast<float2*>(pz_row + j) =
              make_float2(dp[n][2 * r], dp[n][2 * r + 1]);
        } else {
          ds_row[j] = s[n][2 * r];
          pz_row[j] = dp[n][2 * r];
          if (j + 1 < f.Tk) {
            ds_row[j + 1] = s[n][2 * r + 1];
            pz_row[j + 1] = dp[n][2 * r + 1];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- gradients

// one output of the gradient kernel: out = scale · M·Y (rows: queries,
// contraction over keys) or, trans, scale · Mᵀ·Y (rows: keys, contraction
// over queries), 64 channels of Y and out
struct RelGradJob {
  const float* m;        // [B, H, T, T]: dS or P∘Z
  Operand y;             // bf16
  View<float> out;       // bf16
  float scale;
  int trans;
};

constexpr int kRelJobs = 7;   // dq, da (4 x 64 channels), dk, dv

struct RelGradArgs {
  RelGradJob job[kRelJobs];
  int H, T;
};

// an fp32 M tile: 64 rows at a pitch of up to 72 floats (load_f32_tile:
// 72 read along its rows, 68 down its columns)
constexpr int kMTileBytes = kRows * 72 * 4;
// dynamic shared memory: two stages of [M tile, bf16 Y tile]
constexpr int kGradStage = kMTileBytes + kTileBytes;
constexpr int kGradSmem = 2 * kGradStage;

// acc += M (or Mᵀ) · Y over the contraction's tiles
__device__ __forceinline__ void grad_product(float (&acc)[8][4],
                                             const RelGradJob& job,
                                             const float* m, int T, int b,
                                             int h, int r0,
                                             unsigned char* smem, int lane) {
  const int warp = threadIdx.x / 32, gid = lane >> 2, t = lane & 3;
  const int wrow = warp * 16 + gid;
  const int pitch = job.trans ? 68 : 72;
  const auto load = [&](unsigned char* st, int k0) {
    load_f32_tile(reinterpret_cast<float*>(st), pitch, m, T, T,
                  job.trans ? k0 : r0, job.trans ? r0 : k0);
    load_tile(reinterpret_cast<uint16_t*>(st + kMTileBytes), job.y, b, h, k0,
              T);
  };
  load(smem, 0);
  cp_async_commit();
  const int ntiles = (T + kRows - 1) / kRows;
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) {
      load(smem + ((it + 1) & 1) * kGradStage, (it + 1) * kRows);
      cp_async_commit();
    }
    const unsigned char* st = smem + (it & 1) * kGradStage;
    const float* Ms = reinterpret_cast<const float*>(st);
    // the warp's 16 x 64 block of M (or Mᵀ) in accumulator layout: row
    // wrow + 8 (e / 2), column 8n + 2t + e % 2
    const auto x = [&](int n, int e) {
      const int row = wrow + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
      return job.trans ? Ms[col * 68 + row] : Ms[row * 72 + col];
    };
    mma_cols<kTermsRelDSK, 4>(acc, x,
                       reinterpret_cast<const uint16_t*>(st + kMTileBytes),
                       lane);
  }
}

// grid: (64-row tiles of T, H x jobs, B)
__global__ void __launch_bounds__(kThreads, 4)
relpos_bf16_grad_kernel(const RelGradArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, t = lane & 3;
  const int h = blockIdx.y % args.H, b = blockIdx.z;
  const int which = blockIdx.y / args.H;
  RelGradJob job = args.job[0];
#pragma unroll
  for (int u = 1; u < kRelJobs; ++u) {   // constant indices: no local copy
    if (u == which) job = args.job[u];
  }
  const int r0 = blockIdx.x * kRows;
  const float* m =
      job.m + (static_cast<long long>(b) * args.H + h) * args.T * args.T;
  float acc[8][4];
  tc::zero(acc);
  grad_product(acc, job, m, args.T, b, h, r0, smem, lane);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + warp * 16 + gid + 8 * r;
    if (i >= args.T) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      st2(job.out, b, i, h, n * 8 + 2 * t, acc[n][2 * r] * job.scale,
          acc[n][2 * r + 1] * job.scale);
    }
  }
}

// ---------------------------------------------------------------- launch

inline cudaError_t launch_relpos_bf16_fwd(const AttnArgs& args, int B,
                                          cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      relpos_bf16_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRelSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((args.Tq + kRows - 1) / kRows, args.H, B);
  relpos_bf16_fwd_kernel<<<grid, kThreads, kRelSmem, stream>>>(args);
  return cudaGetLastError();
}

// args.delta [B, H, T], args.dbias (dS) and args.pz [B, H, T, T]: written
inline cudaError_t launch_relpos_bf16_bwd(const AttnBwdArgs& args, int B,
                                          cudaStream_t stream) {
  const AttnArgs& f = args.f;
  cudaError_t err = cudaFuncSetAttribute(
      relpos_bf16_ds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRelSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(relpos_bf16_grad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGradSmem);
  }
  if (err != cudaSuccess) return err;
  const int nt = (f.Tq + kRows - 1) / kRows;
  relpos_bf16_ds_kernel<<<dim3(nt, f.H, B), kThreads, kRelSmem, stream>>>(
      args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the gradient kernel reads dS and P∘Z: same stream
  RelGradArgs g{};
  g.H = f.H;
  g.T = f.Tq;
  g.job[0] = {args.dbias, f.k, args.dq, f.scale, 0};
  for (int c = 1; c < kRelChunks; ++c) {
    g.job[c] = {args.dbias, channels(f.e, 64 * (c - 1)),
                channels(args.da, 64 * (c - 1)), f.scale, 0};
  }
  g.job[kRelChunks] = {args.dbias, f.q, args.dk, f.scale, 1};
  g.job[kRelChunks + 1] = {args.pz, args.dout, args.dv, 1.f, 1};
  relpos_bf16_grad_kernel<<<dim3(nt, f.H * kRelJobs, B), kThreads, kGradSmem,
                            stream>>>(g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bf
}  // namespace daspeech
