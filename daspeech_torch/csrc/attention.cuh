// What every attention entry point's kernels share: the argument structs
// (operands addressed by (batch, row, head) strides, dropout, the bias), the
// cp.async primitives and a 64-row tile copy.
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
// Where each kernel lives: every training forward (packed, head-major,
// rel-pos and full-bias attention) is attention_fma.cuh's (fp32 FMA,
// register-tiled); every backward and every inference forward is
// attention_tc.cuh's (tensor cores, 3xTF32); the tile primitives both use
// are tiles.cuh's.
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

}  // namespace daspeech
