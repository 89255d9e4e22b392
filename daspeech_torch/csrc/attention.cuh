// What every attention entry point's kernels share: the argument structs
// (operands addressed by (batch, row, head) strides, dropout, the bias), the
// cp.async primitives and a 64-row tile copy; and the full-bias attention's
// training forward, a flash-style fp32 SIMT kernel.
//
// The score side is the concatenation of up to two operand pairs:
//   s[i, j] = (q[i] . k[j] + a[i] . e[j]) * scale + bias
// with the rel-pos attention's position pair (a, e) absent (null) elsewhere.
// Each operand is addressed by (batch, row, head) strides in elements, so
// the packed [B, T, H*d] projections are read in place with no transposes.
// The bias is the column bias bias[b, j] of a padding mask, or, for the
// full-bias attention, a full additive bias bias4[b, h, i, j]; there dropout
// is keyed by ONE seed (seeds[0]) with the batch row in the fourth counter
// word, as the Pallas kernel keys its stream by the program b·H + h.
//
// Every training forward writes each row's softmax statistics (max m and
// sum l of exp(s - m)), which the backward reuses instead of a second
// softmax pass. They are kept apart, not as m + log(l): in a fully padded
// row every score is -1e30 plus O(1), which fp32 rounds to -1e30 exactly,
// and log(l) would vanish beside it. Dropout (philox.cuh) multiplies the
// softmax probabilities by keep/keep_p; the normalizer is taken before
// dropout, as in the Pallas kernels.
//
// Where each kernel lives: the training forward of the packed, head-major
// and rel-pos attention is attention_fma.cuh's (fp32 FMA, register-tiled);
// the full-bias attention's is the SIMT kernel below; every backward and
// every inference forward is attention_tc.cuh's (tensor cores, 3xTF32).
//
// The full-bias SIMT forward: one block per (query tile, head, batch row).
// TPR threads share one query row: each holds D/TPR of the row's channels
// and of its output channels in registers, interleaved (thread `sub` owns
// channels sub, sub+TPR, ...) so that a warp's reads of a shared-memory key
// row hit TPR consecutive banks and broadcast across the rows. Keys stream
// through shared memory BN at a time with an online softmax in fp32, and
// the bias as a [query tile, key tile] block beside them.
//
// The backward, with P = softmax(s), Z the dropout multipliers, O the
// output, is attention_tc.cuh's:
//   dV[j]   = sum_i P[i,j] Z[i,j] dO[i]
//   dS[i,j] = P[i,j] (Z[i,j] dO[i].V[j] - delta[i]),  delta[i] = dO[i].O[i]
//   dQ[i]   = scale sum_j dS[i,j] K[j]    (and dA[i] = scale sum_j dS e[j])
//   dK[j]   = scale sum_i dS[i,j] Q[i]    (e is a constant: no dE)
// with P = exp(s - m) / l recomputed from the saved row statistics.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace daspeech {

template <typename T>
struct View {
  T* ptr;
  long long sb, sr, sh;  // batch, row and head strides in elements
  __device__ __forceinline__ T* at(int b, int r, int h) const {
    return ptr + b * sb + r * sr + h * sh;
  }
};
using Operand = View<const float>;

struct DropoutArgs {
  const uint32_t* seeds;  // [B] per-row Philox keys; nullptr = no dropout
  uint32_t thresh;        // keep where bits <= thresh
  float scale;            // 1 / keep_p
};

struct AttnArgs {
  Operand q, a, k, e, v;
  const float* bias;     // [B, Tk] additive column bias (0 or -1e30)
  long long bias_sb;
  const float* bias4 = nullptr;  // full bias: contiguous [B, H, Tq, Tk]
  View<float> o;
  float* stats;          // [B, H, Tq, 2] row (max, sum) out, or nullptr
  int H, Tq, Tk;
  float scale;
  DropoutArgs drop;
};

struct AttnBwdArgs {
  AttnArgs f;            // the forward's inputs, its output o and stats
  Operand dout;          // layout of o
  View<float> dq, da;    // layouts of q and a (da: rel-pos only)
  View<float> dk, dv;    // layouts of k and v
  float* delta;          // [B, H, Tq] scratch: rowsum(dout * o)
  // [B, H, Tq, Tk] dS out (the full bias's gradient; the rel-pos
  // backward's scratch) and P∘Z scratch, written by the tensor-core score
  // kernel of attention_tc.cuh
  float* dbias = nullptr;
  float* pz = nullptr;
};

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// an operand's (or gradient's) channels from c0 on
__host__ __device__ __forceinline__ Operand channels(const Operand& x,
                                                     int c0) {
  return Operand{x.ptr + c0, x.sb, x.sr, x.sh};
}

__host__ __device__ __forceinline__ View<float> channels(
    const View<float>& x, int c0) {
  return View<float>{x.ptr + c0, x.sb, x.sr, x.sh};
}

// cp.async of 16, 8 or 4 bytes; zero-fills the destination when !valid
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(N), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// rows r0 .. r0 + 63 of a [rows, 64] operand view into a [64][PITCH] shared
// tile, one 16-byte cp.async per 4 channels, spread over NT threads; rows
// past `rows` are zero-filled
template <int NT, int PITCH>
__device__ __forceinline__ void load_rows64(float* tile, const Operand& x,
                                            int b, int h, int r0, int rows) {
  for (int c = threadIdx.x; c < 64 * 16; c += NT) {
    const int rr = c >> 4, col = (c & 15) * 4, r = r0 + rr;
    const bool ok = r < rows;
    cp_async<16>(tile + rr * PITCH + col, x.at(b, ok ? r : 0, h) + col, ok);
  }
}

// the full-bias attention's training forward (fp32 SIMT; see the top)
template <int D, int TPR, int BM, int BN>
__global__ void __launch_bounds__(BM * TPR)
attn_fwd_kernel(const AttnArgs args) {
  constexpr int NT = BM * TPR;
  constexpr int QPT = D / TPR;
  constexpr int G = 4 * TPR;   // keys per Philox round of the row's threads
  static_assert(D % TPR == 0, "channels must split evenly over a row");
  static_assert(32 % TPR == 0, "a row's threads must share one warp");
  static_assert(BN % G == 0, "key tiles must hold whole Philox groups");

  __shared__ float Ks[BN][D];
  __shared__ float Vs[BN][D];
  __shared__ float Bs[BM][BN + 1];

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int lane0 = (tid % 32) - sub;
  const int r = tid / TPR;             // the row's line of the bias tile
  const int i0 = blockIdx.x * BM;
  const int i = i0 + r;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool row_ok = i < args.Tq;
  const bool drop = args.drop.seeds != nullptr;
  const uint32_t seed = drop ? args.drop.seeds[0] : 0u;
  const uint32_t c3 = b;
  const float* bias4 =
      args.bias4 + (static_cast<long long>(b) * args.H + h) * args.Tq *
                       args.Tk;

  float qr[QPT];
#pragma unroll
  for (int t = 0; t < QPT; ++t) {
    qr[t] = row_ok ? args.q.at(b, i, h)[sub + TPR * t] : 0.f;
  }

  float acc[QPT];
#pragma unroll
  for (int t = 0; t < QPT; ++t) acc[t] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int j0 = 0; j0 < args.Tk; j0 += BN) {
    const int nvalid = min(BN, args.Tk - j0);
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int jj = idx / D, c = idx % D;
      const bool ok = jj < nvalid;
      Ks[jj][c] = ok ? args.k.at(b, j0 + jj, h)[c] : 0.f;
      Vs[jj][c] = ok ? args.v.at(b, j0 + jj, h)[c] : 0.f;
    }
    // rows rr of the tile hold bias4[b, h, i0 + rr, j0..]; 0 outside
    // [0, Tq) x [0, Tk)
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int rr = idx / BN, jj = idx % BN;
      Bs[rr][jj] = (jj < nvalid && i0 + rr < args.Tq)
                       ? bias4[static_cast<long long>(i0 + rr) * args.Tk +
                               j0 + jj]
                       : 0.f;
    }
    __syncthreads();

    float s[BN];
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BN; ++jj) {
      float p = 0.f;
#pragma unroll
      for (int t = 0; t < QPT; ++t) p = fmaf(qr[t], Ks[jj][sub + TPR * t], p);
      p = row_sum<TPR>(p);
      const float sc = (jj < nvalid) ? p * args.scale + Bs[r][jj] : -INFINITY;
      s[jj] = sc;
      tile_max = fmaxf(tile_max, sc);
    }
    // nvalid >= 1, so tile_max and m_new are finite
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int t = 0; t < QPT; ++t) acc[t] *= corr;
#pragma unroll
    for (int g0 = 0; g0 < BN; g0 += G) {
      // one Philox draw per thread gives 4 keys' bits; the TPR threads of
      // a row draw for G consecutive keys and share them by shuffles
      const uint4 bits =
          drop ? philox4x32_10(
                     make_uint4(((j0 + g0) >> 2) + sub, i, h, c3), seed, 0u)
               : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int jj = g0 + u;
        const float p = expf(s[jj] - m_new);
        l += p;
        float pz = p;
        if (drop) {
          const uint32_t w = __shfl_sync(0xffffffffu, philox_word(bits, u & 3),
                                         lane0 + (u >> 2));
          pz = (w <= args.drop.thresh) ? p * args.drop.scale : 0.f;
        }
#pragma unroll
        for (int t = 0; t < QPT; ++t) {
          acc[t] = fmaf(pz, Vs[jj][sub + TPR * t], acc[t]);
        }
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (row_ok) {
    float* out = args.o.at(b, i, h);
    const float inv = 1.f / l;
#pragma unroll
    for (int t = 0; t < QPT; ++t) out[sub + TPR * t] = acc[t] * inv;
    if (args.stats != nullptr && sub == 0) {
      float* st = args.stats +
                  2 * ((static_cast<long long>(b) * args.H + h) * args.Tq + i);
      st[0] = m;
      st[1] = l;
    }
  }
}

template <int D, int TPR, int BM, int BN>
cudaError_t launch_attn_fwd(const AttnArgs& args, int B,
                            cudaStream_t stream) {
  dim3 grid((args.Tq + BM - 1) / BM, args.H, B);
  attn_fwd_kernel<D, TPR, BM, BN><<<grid, BM * TPR, 0, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace daspeech
