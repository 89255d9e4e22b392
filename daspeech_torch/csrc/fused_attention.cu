// Multi-head attention, forward and backward, for Hopper (sm_90a), fp32, in
// two layouts and two bias modes. Every entry point has a _bf16 variant (the
// same arguments; a forward also takes out32) whose q, k, v, out, dout, dq,
// dk and dv are bf16 in device memory; the bias (the full bias and its
// gradient dS too), the statistics and delta stay fp32, and every sum is
// fp32, as the Pallas kernels upcast bf16 operands and cast their outputs
// (fused_attention.py:79-100, :305-321). Every bf16 entry point runs
// kernels of its own, on the bf16 tensor cores (attention_bf16.cuh: bf16
// mma.sync, ldmatrix, cp.async; P·V one-term, dS·K, (P∘Z)ᵀ·dO and dSᵀ·Q
// two-term): the packed and head-major ones its column-bias kernels, the
// full-bias ones the same three kernels in their full-bias mode
// (attn_bf16_fb_*: the bias4 tile streamed into each stage, dbias written
// by the dq kernel). At chip_smoke.py's ALiBi shape [8, 8, 240, 64], p =
// 0.1, the full-bias bf16 forward and backward took 0.0753 ms of device
// time on an NVIDIA H100 80GB HBM3 at 700 W (SDPA on a bf16 mask 0.0987;
// bound 0.0135, bytes), the fp32 kernels on widened tiles that they
// replace 0.3301 ms a call against their 0.2084 (attention_bf16.cuh, "The
// full-bias mode").
//
// Replaces three Pallas kernels of daspeech_tpu/ops/fused_attention.py:
//   - packed, fused_attention_packed (:522; forward _attn_kernel_packed,
//     :285; backward _attn_bwd_kernel_packed, :324): q [B, Tq, H*64],
//     k/v [B, Tk, H*64];
//   - head-major, fused_attention (:189; forward _attn_kernel, :76;
//     backward _attn_bwd_kernel, :103): q [B, H, Tq, 64], k/v [B, H, Tk, 64];
//   - head-major with a full bias, fused_attention_full_bias (:673; forward
//     _attn_kernel_fb, :573; backward _attn_bwd_kernel_fb, :600): a
//     [B, H, Tq, Tk] additive bias in place of the column bias, which
//     receives the gradient dS; one scalar dropout seed.
// The JAX layer takes the packed kernel while packed_fits_vmem holds and the
// head-major one for longer sequences; the port's layer mirrors that route
// (ops/fused_attention.py packed_route). Both layouts run the same kernels,
// which address every operand by (batch, row, head) strides: only the
// strides differ between the entry points below, so at a shape both routes
// take they compute the same sums in the same order. In fp32 the backward
// and the inference forward (no statistics) are the tensor-core kernels of
// attention_tc.cuh; the training forward, which saves the statistics the
// backward reads, is the register-tiled fp32 FMA kernel of
// attention_fma.cuh, because the tensor cores' accumulation bias in a
// training forward moves batch-wide gradient sums past fp32's noise
// (attention_tc.cuh, "Accumulation"). Dropout is keyed by (seed of the
// batch row, j/4, i, h) in both, so they also drop the same elements.
//
// Computes, per batch row b and head h,
//   out[b, h] = dropout(softmax(q[b, h] k[b, h]^T * scale + bias[b])) v[b, h]
// with bias [B, Tk] an additive column bias (0 or -1e30). q arrives
// pre-scaled (scale = 1 at the layer). The backward takes the forward's
// output and its row softmax statistics and returns dq, dk, dv; the dropout
// mask is regenerated from the same Philox counters.
//
// What bounds it on this card: the products. At the training decoder shape
// (B=80, H=8, T=240, d=64) the forward is 9.4 GFLOP against 157 MB of
// q/k/v/out traffic, the backward (five products) 23.6 GFLOP against
// 315 MB; at the long-utterance FastSpeech 2 decoder shape (B=14, H=4,
// T=1040) the forward is 15.5 GFLOP against 60 MB. The port keeps fp32
// accuracy, so the least time for these products is at the 3xTF32 rate of
// the tensor cores, 495 / 3 = 165 TFLOP/s on an H100 SXM (0.057 ms for the
// training forward), not the 67 TFLOP/s of the fp32 FMA pipes, which bound
// the training forward (0.14 ms at the decoder shape). The
// tensor-core design (attention_tc.cuh) runs every product as 3xTF32
// mma.sync, streams K/V (forward, dq) or Q/dO (dk/dv) tiles by cp.async,
// double-buffered, keeps the score matrix out of device memory (online
// softmax; the backward recomputes P from the saved row statistics) and
// draws dropout bits in registers, one Philox draw per 8-key block and
// thread. The FMA training forward (attention_fma.cuh) gives each thread a
// 4-query x 4-key micro-tile of the score and a 4-query x 4-channel one of
// the output, fed by 16-byte shared-memory reads.
//
// The full-bias fp32 entry points run the chunked-score tensor-core kernels
// of attention_tc.cuh with one chunk (NC = 1) and the bias as a
// [query tile, key tile] block per stage, streamed beside K by cp.async;
// their training forward is attention_fma.cuh's kernel in its full-bias
// mode (FULL), each thread reading its 4 x 4 biases from device memory.
// The backward's score kernel writes dS (the bias's gradient, each element
// once) and P∘Z; dq, dk and dv are products with them in a second launch.
// There bytes count as well as operations: bias4 is read once forward and
// once backward, dS and P∘Z written once and read back. At the Conformer
// shape the kernel once served, [80, 4, 120, 120], each is 18.4 MB against
// 1.2 GFLOP forward (the bytes bound it); at [14, 8, 700, 64] bias4 is
// 219 MB.
#include "attention.cuh"
#include "attention_bf16.cuh"
#include "attention_fma.cuh"
#include "attention_tc.cuh"

namespace {

using namespace daspeech;

constexpr long long kD = 64;

// (batch, row, head) strides of a [B, T, H*64] packed or a [B, H, T, 64]
// head-major tensor of `rows` rows; bf16: its elements are bf16
template <typename T>
View<T> view(const void* p, int rows, int H, bool head_major, bool bf16) {
  const long long n = static_cast<long long>(rows) * H * kD;
  T* ptr = static_cast<T*>(const_cast<void*>(p));
  return head_major ? View<T>{ptr, n, kD, rows * kD, bf16}
                    : View<T>{ptr, n, H * kD, kD, bf16};
}

AttnArgs attn_args(const void* q, const void* k, const void* v,
                   const float* bias, const uint32_t* seeds, uint32_t thresh,
                   float keep_scale, void* out, float* stats, int Tq, int Tk,
                   int H, float scale, bool head_major, bool bf16) {
  AttnArgs args;
  args.q = view<const float>(q, Tq, H, head_major, bf16);
  args.a = {nullptr, 0, 0, 0};
  args.k = view<const float>(k, Tk, H, head_major, bf16);
  args.e = {nullptr, 0, 0, 0};
  args.v = view<const float>(v, Tk, H, head_major, bf16);
  args.bias = bias;
  args.bias_sb = Tk;
  args.o = view<float>(out, Tq, H, head_major, bf16);
  args.stats = stats;
  args.H = H;
  args.Tq = Tq;
  args.Tk = Tk;
  args.scale = scale;
  args.drop = {seeds, thresh, keep_scale};
  return args;
}

int attention_fwd(const void* q, const void* k, const void* v,
                  const float* bias, const uint32_t* seeds, uint32_t thresh,
                  float keep_scale, void* out, float* stats, float* out32,
                  int B, int Tq, int Tk, int H, int D, float scale,
                  void* stream, bool head_major, bool bf16, int head0) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs args = attn_args(q, k, v, bias, seeds, thresh, keep_scale, out,
                            stats, Tq, Tk, H, scale, head_major, bf16);
  args.h0 = static_cast<uint32_t>(head0);
  if (out32 != nullptr) {
    args.o32 = view<float>(out32, Tq, H, head_major, false);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bf16: the bf16 tensor-core forward of attention_bf16.cuh, training and
  // inference; fp32 training (statistics asked for): the FMA forward of
  // attention_fma.cuh; fp32 inference: the 3xTF32 forward
  // (attention_tc.cuh, "Accumulation")
  if (bf16) {
    return static_cast<int>(bf::launch_attn_bf16_fwd<false>(args, B, s));
  }
  return static_cast<int>(stats != nullptr
                              ? fma::launch_attn_fma_fwd<1>(args, B, s)
                              : tc::launch_attn_tc_fwd(args, B, s));
}

int attention_bwd(const void* q, const void* k, const void* v,
                  const float* bias, const uint32_t* seeds, uint32_t thresh,
                  float keep_scale, const void* out, const float* stats,
                  const void* dout, void* dq, void* dk, void* dv,
                  float* delta, int B, int Tq, int Tk, int H, int D,
                  float scale, void* stream, bool head_major, bool bf16,
                  int head0) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  AttnBwdArgs args;
  args.f = attn_args(q, k, v, bias, seeds, thresh, keep_scale,
                     const_cast<void*>(out), const_cast<float*>(stats), Tq,
                     Tk, H, scale, head_major, bf16);
  args.f.h0 = static_cast<uint32_t>(head0);
  args.f.o.bf16 = false;   // the fp32 output (a bf16 forward's out32)
  args.dout = view<const float>(dout, Tq, H, head_major, bf16);
  args.dq = view<float>(dq, Tq, H, head_major, bf16);
  args.da = {nullptr, 0, 0, 0};
  args.dk = view<float>(dk, Tk, H, head_major, bf16);
  args.dv = view<float>(dv, Tk, H, head_major, bf16);
  args.delta = delta;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? bf::launch_attn_bf16_bwd<false>(args, B, s)
                               : tc::launch_attn_tc_bwd(args, B, s));
}

AttnArgs full_bias_args(const void* q, const void* k, const void* v,
                        const float* bias4, const uint32_t* seed,
                        uint32_t thresh, float keep_scale, void* out,
                        float* stats, int Tq, int Tk, int H, float scale,
                        bool bf16) {
  AttnArgs args = attn_args(q, k, v, nullptr, seed, thresh, keep_scale, out,
                            stats, Tq, Tk, H, scale, true, bf16);
  args.bias_sb = 0;
  args.bias4 = bias4;
  return args;
}

int full_bias_fwd(const void* q, const void* k, const void* v,
                  const float* bias4, const uint32_t* seed, uint32_t thresh,
                  float keep_scale, void* out, float* stats, float* out32,
                  int B, int Tq, int Tk, int H, int D, float scale,
                  void* stream, bool bf16) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs args = full_bias_args(q, k, v, bias4, seed, thresh, keep_scale,
                                 out, stats, Tq, Tk, H, scale, bf16);
  if (out32 != nullptr) {
    args.o32 = view<float>(out32, Tq, H, true, false);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bf16: attention_bf16.cuh's forward in its full-bias mode, training and
  // inference; fp32 training: the FMA forward's full-bias mode; fp32
  // inference: the chunked-score 3xTF32 forward
  if (bf16) {
    return static_cast<int>(bf::launch_attn_bf16_fwd<true>(args, B, s));
  }
  return static_cast<int>(
      stats != nullptr
          ? fma::launch_attn_fma_fwd<1, true>(args, B, s)
          : tc::launch_attn_tc_chunk_fwd<1, true>(args, B, s));
}

int full_bias_bwd(const void* q, const void* k, const void* v,
                  const float* bias4, const uint32_t* seed, uint32_t thresh,
                  float keep_scale, const void* out, const float* stats,
                  const void* dout, void* dq, void* dk, void* dv,
                  float* dbias, float* scratch, int B, int Tq, int Tk, int H,
                  int D, float scale, void* stream, bool bf16) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  AttnBwdArgs args;
  args.f = full_bias_args(q, k, v, bias4, seed, thresh, keep_scale,
                          const_cast<void*>(out), const_cast<float*>(stats),
                          Tq, Tk, H, scale, bf16);
  args.f.o.bf16 = false;   // the fp32 output (a bf16 forward's out32)
  args.dout = view<const float>(dout, Tq, H, true, bf16);
  args.dq = view<float>(dq, Tq, H, true, bf16);
  args.da = {nullptr, 0, 0, 0};
  args.dk = view<float>(dk, Tk, H, true, bf16);
  args.dv = view<float>(dv, Tk, H, true, bf16);
  // scratch: delta [B, H, Tq] (padded to 4 floats), then P∘Z
  // [B, H, Tq, Tk] (the fp32 kernels'; the bf16 ones recompute P∘Z)
  const long long rows = static_cast<long long>(B) * H * Tq;
  args.delta = scratch;
  args.dbias = dbias;
  args.pz = scratch + (rows + 3) / 4 * 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? bf::launch_attn_bf16_bwd<true>(args, B, s)
                               : tc::launch_attn_tc_chunk_bwd<1, true>(
                                     args, B, s));
}

}  // namespace

// head0 (the last argument): the first of the call's H heads among the
// layer's, the dropout counter's head offset (AttnArgs::h0): a
// tensor-parallel rank passes the first head it holds, every other
// caller 0
extern "C" int daspeech_attention_fwd(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      const uint32_t* seeds, uint32_t thresh,
                                      float keep_scale, float* out,
                                      float* stats, int B, int Tq, int Tk,
                                      int H, int D, float scale,
                                      void* stream, int head0) {
  return attention_fwd(q, k, v, bias, seeds, thresh, keep_scale, out, stats,
                       nullptr, B, Tq, Tk, H, D, scale, stream, false, false,
                       head0);
}

// bf16 q, k, v and out; out32 [B, Tq, H*64] fp32, written by a training
// forward (stats given) and read by the backward as its `out`
extern "C" int daspeech_attention_fwd_bf16(const void* q, const void* k,
                                           const void* v, const float* bias,
                                           const uint32_t* seeds,
                                           uint32_t thresh, float keep_scale,
                                           void* out, float* stats,
                                           float* out32, int B, int Tq,
                                           int Tk, int H, int D, float scale,
                                           void* stream, int head0) {
  return attention_fwd(q, k, v, bias, seeds, thresh, keep_scale, out, stats,
                       out32, B, Tq, Tk, H, D, scale, stream, false, true,
                       head0);
}

extern "C" int daspeech_attention_bwd(
    const float* q, const float* k, const float* v, const float* bias,
    const uint32_t* seeds, uint32_t thresh, float keep_scale,
    const float* out, const float* stats, const float* dout, float* dq,
    float* dk, float* dv, float* delta, int B, int Tq, int Tk, int H, int D,
    float scale, void* stream, int head0) {
  return attention_bwd(q, k, v, bias, seeds, thresh, keep_scale, out, stats,
                       dout, dq, dk, dv, delta, B, Tq, Tk, H, D, scale,
                       stream, false, false, head0);
}

extern "C" int daspeech_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const float* bias,
    const uint32_t* seeds, uint32_t thresh, float keep_scale,
    const void* out, const float* stats, const void* dout, void* dq,
    void* dk, void* dv, float* delta, int B, int Tq, int Tk, int H, int D,
    float scale, void* stream, int head0) {
  return attention_bwd(q, k, v, bias, seeds, thresh, keep_scale, out, stats,
                       dout, dq, dk, dv, delta, B, Tq, Tk, H, D, scale,
                       stream, false, true, head0);
}

extern "C" int daspeech_attention_hm_fwd(const float* q, const float* k,
                                         const float* v, const float* bias,
                                         const uint32_t* seeds,
                                         uint32_t thresh, float keep_scale,
                                         float* out, float* stats, int B,
                                         int Tq, int Tk, int H, int D,
                                         float scale, void* stream, int head0) {
  return attention_fwd(q, k, v, bias, seeds, thresh, keep_scale, out, stats,
                       nullptr, B, Tq, Tk, H, D, scale, stream, true, false,
                       head0);
}

extern "C" int daspeech_attention_hm_fwd_bf16(
    const void* q, const void* k, const void* v, const float* bias,
    const uint32_t* seeds, uint32_t thresh, float keep_scale, void* out,
    float* stats, float* out32, int B, int Tq, int Tk, int H, int D,
    float scale, void* stream, int head0) {
  return attention_fwd(q, k, v, bias, seeds, thresh, keep_scale, out, stats,
                       out32, B, Tq, Tk, H, D, scale, stream, true, true,
                       head0);
}

extern "C" int daspeech_attention_hm_bwd(
    const float* q, const float* k, const float* v, const float* bias,
    const uint32_t* seeds, uint32_t thresh, float keep_scale,
    const float* out, const float* stats, const float* dout, float* dq,
    float* dk, float* dv, float* delta, int B, int Tq, int Tk, int H, int D,
    float scale, void* stream, int head0) {
  return attention_bwd(q, k, v, bias, seeds, thresh, keep_scale, out, stats,
                       dout, dq, dk, dv, delta, B, Tq, Tk, H, D, scale,
                       stream, true, false, head0);
}

extern "C" int daspeech_attention_hm_bwd_bf16(
    const void* q, const void* k, const void* v, const float* bias,
    const uint32_t* seeds, uint32_t thresh, float keep_scale,
    const void* out, const float* stats, const void* dout, void* dq,
    void* dk, void* dv, float* delta, int B, int Tq, int Tk, int H, int D,
    float scale, void* stream, int head0) {
  return attention_bwd(q, k, v, bias, seeds, thresh, keep_scale, out, stats,
                       dout, dq, dk, dv, delta, B, Tq, Tk, H, D, scale,
                       stream, true, true, head0);
}

// full bias: bias4 [B, H, Tq, Tk] contiguous, seed a pointer to ONE int32
extern "C" int daspeech_attention_fb_fwd(const float* q, const float* k,
                                         const float* v, const float* bias4,
                                         const uint32_t* seed,
                                         uint32_t thresh, float keep_scale,
                                         float* out, float* stats, int B,
                                         int Tq, int Tk, int H, int D,
                                         float scale, void* stream) {
  return full_bias_fwd(q, k, v, bias4, seed, thresh, keep_scale, out, stats,
                       nullptr, B, Tq, Tk, H, D, scale, stream, false);
}

// bf16 q, k, v and out (bias4 fp32); out32 [B, H, Tq, 64] fp32, written by
// a training forward (stats given) and read by the backward as its `out`
extern "C" int daspeech_attention_fb_fwd_bf16(
    const void* q, const void* k, const void* v, const float* bias4,
    const uint32_t* seed, uint32_t thresh, float keep_scale, void* out,
    float* stats, float* out32, int B, int Tq, int Tk, int H, int D,
    float scale, void* stream) {
  return full_bias_fwd(q, k, v, bias4, seed, thresh, keep_scale, out, stats,
                       out32, B, Tq, Tk, H, D, scale, stream, true);
}

extern "C" int daspeech_attention_fb_bwd(
    const float* q, const float* k, const float* v, const float* bias4,
    const uint32_t* seed, uint32_t thresh, float keep_scale,
    const float* out, const float* stats, const float* dout, float* dq,
    float* dk, float* dv, float* dbias, float* scratch, int B, int Tq,
    int Tk, int H, int D, float scale, void* stream) {
  return full_bias_bwd(q, k, v, bias4, seed, thresh, keep_scale, out, stats,
                       dout, dq, dk, dv, dbias, scratch, B, Tq, Tk, H, D,
                       scale, stream, false);
}

// bf16 q, k, v, dout, dq, dk and dv; out the forward's fp32 out32; bias4
// and dbias fp32
extern "C" int daspeech_attention_fb_bwd_bf16(
    const void* q, const void* k, const void* v, const float* bias4,
    const uint32_t* seed, uint32_t thresh, float keep_scale,
    const float* out, const float* stats, const void* dout, void* dq,
    void* dk, void* dv, float* dbias, float* scratch, int B, int Tq, int Tk,
    int H, int D, float scale, void* stream) {
  return full_bias_bwd(q, k, v, bias4, seed, thresh, keep_scale, out, stats,
                       dout, dq, dk, dv, dbias, scratch, B, Tq, Tk, H, D,
                       scale, stream, true);
}
