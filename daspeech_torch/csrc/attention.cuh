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
// Where each kernel lives: every fp32 training forward (packed, head-major,
// rel-pos and full-bias attention) is attention_fma.cuh's (fp32 FMA,
// register-tiled); every fp32 backward and inference forward is
// attention_tc.cuh's (tensor cores, 3xTF32); the tile primitives both use
// are tiles.cuh's. The packed, head-major and full-bias bf16 entry points
// run attention_bf16.cuh's kernels (the full bias in their full-bias mode)
// and the rel-pos ones relpos_bf16.cuh's (bf16 tensor cores, bf16 tiles in
// shared memory; tiles_bf16.cuh), forward and backward.
//
// Element type: every operand, output and gradient view is fp32 or, with its
// bf16 flag set, bf16 in device memory (the _bf16 entry points). The bf16
// kernels copy bf16 tiles as they are (tiles_bf16.cuh) and read and write
// single rows through ld4 and st2, which widen a bf16 row to fp32 as it is
// loaded and round an output to bf16 (round to nearest even) as it is
// stored. The fp32 kernels take the same views: a bf16 view would be
// widened by load_rows64, ld1 and ld4 and rounded by st2 and st4, with its
// rows loaded by plain loads, not cp.async, which cannot convert; but no
// entry point hands an fp32 kernel a bf16 view, so those branches run only
// in the bf16 kernels' ld4 and st2. A bf16 training forward also writes its
// output in fp32 (o32), and the backward reads that for delta =
// rowsum(dO∘O): from the rounded bf16 O, delta cancels against dO.V where a
// softmax row is near uniform, and put the q and k gradients of cell T's
// deep decoder layers off by up to three times their norm. The Pallas
// kernels take delta = rowsum(P∘dP) in fp32, which is the same sum over the
// unrounded O.
//
// The backward, with P = softmax(s), Z the dropout multipliers, O the
// output, is attention_tc.cuh's:
//   dV[j]   = sum_i P[i,j] Z[i,j] dO[i]
//   dS[i,j] = P[i,j] (Z[i,j] dO[i].V[j] - delta[i]),  delta[i] = dO[i].O[i]
//   dQ[i]   = scale sum_j dS[i,j] K[j]    (and dA[i] = scale sum_j dS e[j])
//   dK[j]   = scale sum_i dS[i,j] Q[i]    (e is a constant: no dE)
// with P = exp(s - m) / l recomputed from the saved row statistics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

namespace daspeech {

template <typename T>
struct View {
  T* ptr;                // fp32 elements, or bf16 ones when bf16
  long long sb, sr, sh;  // batch, row and head strides in elements
  bool bf16 = false;
  __host__ __device__ __forceinline__ long long index(int b, int r,
                                                      int h) const {
    return b * sb + r * sr + h * sh;
  }
  // fp32 views only
  __device__ __forceinline__ T* at(int b, int r, int h) const {
    return ptr + index(b, r, h);
  }
  // the same view n elements further on
  __host__ __device__ __forceinline__ View plus(long long n) const {
    using Half = std::conditional_t<std::is_const_v<T>, const uint16_t,
                                    uint16_t>;
    View v = *this;
    v.ptr = bf16 ? reinterpret_cast<T*>(reinterpret_cast<Half*>(ptr) + n)
                 : ptr + n;
    return v;
  }
};
using Operand = View<const float>;

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// element c of row (b, r, h), widened to fp32
template <typename T>
__device__ __forceinline__ float ld1(const View<T>& x, int b, int r, int h,
                                     int c) {
  const long long i = x.index(b, r, h) + c;
  if (x.bf16) {
    return __uint_as_float(
        static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(x.ptr)[i])
        << 16);
  }
  return x.ptr[i];
}

// elements c .. c + 3 of row (b, r, h), widened to fp32 (c % 4 == 0)
template <typename T>
__device__ __forceinline__ float4 ld4(const View<T>& x, int b, int r, int h,
                                      int c) {
  const long long i = x.index(b, r, h) + c;
  if (x.bf16) {
    const uint2 u =
        *reinterpret_cast<const uint2*>(reinterpret_cast<const uint16_t*>(
                                            x.ptr) + i);
    return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                       bf16_hi(u.y));
  }
  return *reinterpret_cast<const float4*>(x.ptr + i);
}

// elements c, c + 1 of row (b, r, h) of an output view (c even)
__device__ __forceinline__ void st2(const View<float>& x, int b, int r, int h,
                                    int c, float v0, float v1) {
  const long long i = x.index(b, r, h) + c;
  if (x.bf16) {
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<uint16_t*>(x.ptr) +
                                       i) = __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(x.ptr + i) = make_float2(v0, v1);
  }
}

// elements c .. c + 3 of row (b, r, h) of an output view (c % 4 == 0)
__device__ __forceinline__ void st4(const View<float>& x, int b, int r, int h,
                                    int c, float4 v) {
  const long long i = x.index(b, r, h) + c;
  if (x.bf16) {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
        reinterpret_cast<uint16_t*>(x.ptr) + i);
    p[0] = __floats2bfloat162_rn(v.x, v.y);
    p[1] = __floats2bfloat162_rn(v.z, v.w);
  } else {
    *reinterpret_cast<float4*>(x.ptr + i) = v;
  }
}

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
  // a bf16 training forward: its output in fp32 as well (layout of o, fp32
  // elements), which the backward's delta reads (see "Element type")
  View<float> o32 = {nullptr, 0, 0, 0};
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
template <typename T>
__host__ __device__ __forceinline__ View<T> channels(const View<T>& x,
                                                     int c0) {
  return x.plus(c0);
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
// past `rows` are zero-filled. A bf16 view: one 8-byte load per 4
// channels, widened and stored by the thread (cp.async cannot convert),
// one load in flight at a time: unrolled, the loads' registers made the
// rel-pos FMA forward (128 registers a thread) spill
template <int NT, int PITCH>
__device__ __forceinline__ void load_rows64(float* tile, const Operand& x,
                                            int b, int h, int r0, int rows) {
  if (x.bf16) {
#pragma unroll 1
    for (int c = threadIdx.x; c < 64 * 16; c += NT) {
      const int rr = c >> 4, col = (c & 15) * 4, r = r0 + rr;
      *reinterpret_cast<float4*>(tile + rr * PITCH + col) =
          r < rows ? ld4(x, b, r, h, col) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  for (int c = threadIdx.x; c < 64 * 16; c += NT) {
    const int rr = c >> 4, col = (c & 15) * 4, r = r0 + rr;
    const bool ok = r < rows;
    cp_async<16>(tile + rr * PITCH + col, x.at(b, ok ? r : 0, h) + col, ok);
  }
}

}  // namespace daspeech
