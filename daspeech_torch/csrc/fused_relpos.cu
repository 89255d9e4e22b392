// Conformer relative-position self-attention, forward and backward, for
// Hopper (sm_90a), fp32. The _bf16 entry points (the same arguments) take
// bf16 q, k, v, a, e, out, dout, dq, dk, dv and da in device memory and
// run relpos_bf16.cuh's kernels on the bf16 tensor cores, every sum fp32,
// as the Pallas kernels upcast bf16 operands (fused_relpos.py:102-122).
//
// Replaces the Pallas kernels of daspeech_tpu/ops/fused_relpos.py:373
// (fused_attention_relpos: forward _relpos_fwd_kernel, :90; backward
// _relpos_bwd_kernel, :125), dropout included.
//
// Computes, per batch row b and head h,
//   out[b, :, h] = dropout(softmax((q_u[b, :, h] k[b, :, h]^T
//                                   + a[b, :, h] e^T) * scale + bias[b]))
//                  v[b, :, h]
// with q_u/k/v the packed [B, T, H*64] projections, a [B, T, H*C] the rotated
// position queries (depth C = 256 per head, four times d), e [T, C] the
// constant sin/cos basis shared by every row and head, and bias [B, T] an
// additive column bias (0 or -1e30). The backward returns dq, dk, dv and
// da = scale * dS e per head; e is a constant and gets no gradient.
//
// Design: the two score products are one dot product of depth 64 + 256 =
// 320 between the extended query [q_u | a] and the extended key [k | e].
// The inference forward and the backward run on the tensor cores in 3xTF32
// (attention_tc.cuh, "Chunked score depth", NC = 5): the score is summed
// over five 64-deep chunk pairs, (q, k) and four of (a, e), streamed two
// 64 x 64 tiles at a time, so neither side's 64 x 320 operand has to sit in
// shared memory or registers. The backward's score kernel writes dS and P∘Z
// to [B, H, T, T] scratch; one more launch takes dq = scale dS·k, the four
// 64-column parts of da = scale dS·e, dk = scale dSᵀ·q and dv = (P∘Z)ᵀ·dO
// as products with them, so the 320-deep score is recomputed once, not
// also transposed for dk, and [dq | da] (320 columns) never sits in one
// thread's registers. The training forward, which writes the softmax
// statistics, stays on the fp32 FMA pipes (attention_tc.cuh,
// "Accumulation"): attention_fma.cuh's register-tiled kernel, which sums
// the same five chunk pairs, streamed two 64 x 64 tiles a stage by
// cp.async. Neither the [T, T] position scores nor the [T, 2T-1] shift
// tensor of the reference form reach device memory in the forward.
//
// What bounds it on this card: five-sixths of the score FLOPs are the
// position product. At the training shape (B=80, H=4, T'=120) the forward
// is 3.5 GFLOP and the backward 7.7 GFLOP of matrix products, against
// 68 MB (forward) of device traffic: the operations bound it, at the
// tensor cores' 3xTF32 rate (the training forward at the FMA pipes' 67
// TFLOP/s: 0.052 ms). The backward adds 2 x 18 MB of dS and P∘Z
// written and read back (about 30 us at 3.35 TB/s), e (T x 1 KB) is the
// same for every (b, h) and stays in L2, and the query side's tiles are
// re-read from L2 for every key tile.
#include "attention.cuh"
#include "attention_fma.cuh"
#include "attention_tc.cuh"
#include "relpos_bf16.cuh"

namespace {

using namespace daspeech;

// a [B, T, H*w] packed operand (fp32, or bf16 when bf16)
template <typename T>
View<T> packed(const void* p, int T_, int H, long long w, bool bf16) {
  return View<T>{static_cast<T*>(const_cast<void*>(p)), T_ * H * w, H * w,
                 w, bf16};
}

AttnArgs relpos_args(const void* q, const void* k, const void* v,
                     const void* a, const void* e, const float* bias,
                     const uint32_t* seeds, uint32_t thresh, float keep_scale,
                     void* out, float* stats, int T, int H, float scale,
                     bool bf16) {
  constexpr long long D = 64, C = 256;
  AttnArgs args;
  args.q = packed<const float>(q, T, H, D, bf16);
  args.a = packed<const float>(a, T, H, C, bf16);
  args.k = packed<const float>(k, T, H, D, bf16);
  // e [T, C]: the same rows for every batch row and head
  args.e = Operand{static_cast<const float*>(e), 0, C, 0, bf16};
  args.v = packed<const float>(v, T, H, D, bf16);
  args.bias = bias;
  args.bias_sb = T;
  args.o = packed<float>(out, T, H, D, bf16);
  args.stats = stats;
  args.H = H;
  args.Tq = T;
  args.Tk = T;
  args.scale = scale;
  args.drop = {seeds, thresh, keep_scale};
  return args;
}

int relpos_fwd(const void* q, const void* k, const void* v, const void* a,
               const void* e, const float* bias, const uint32_t* seeds,
               uint32_t thresh, float keep_scale, void* out, float* stats,
               float* out32, int B, int T, int H, int D, int C, float scale,
               void* stream, bool bf16, int head0) {
  if (D != 64 || C != 256) return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs args = relpos_args(q, k, v, a, e, bias, seeds, thresh, keep_scale,
                              out, stats, T, H, scale, bf16);
  args.h0 = static_cast<uint32_t>(head0);
  if (out32 != nullptr) args.o32 = packed<float>(out32, T, H, D, false);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bf16: relpos_bf16.cuh's kernel (training and inference); fp32
  // training (statistics asked for): the FMA forward of attention_fma.cuh;
  // fp32 inference: the tensor cores (attention_tc.cuh)
  return static_cast<int>(
      bf16               ? bf::launch_relpos_bf16_fwd(args, B, s)
      : stats != nullptr ? fma::launch_attn_fma_fwd<5>(args, B, s)
                         : tc::launch_attn_tc_chunk_fwd<5, false>(args, B, s));
}

int relpos_bwd(const void* q, const void* k, const void* v, const void* a,
               const void* e, const float* bias, const uint32_t* seeds,
               uint32_t thresh, float keep_scale, const void* out,
               const float* stats, const void* dout, void* dq, void* dk,
               void* dv, void* da, float* scratch, int B, int T, int H, int D,
               int C, float scale, void* stream, bool bf16, int head0) {
  if (D != 64 || C != 256) return static_cast<int>(cudaErrorInvalidValue);
  AttnBwdArgs args;
  args.f = relpos_args(q, k, v, a, e, bias, seeds, thresh, keep_scale,
                       const_cast<void*>(out), const_cast<float*>(stats), T,
                       H, scale, bf16);
  args.f.h0 = static_cast<uint32_t>(head0);
  args.f.o.bf16 = false;   // the fp32 output (a bf16 forward's out32)
  args.dout = packed<const float>(dout, T, H, 64, bf16);
  args.dq = packed<float>(dq, T, H, 64, bf16);
  args.da = packed<float>(da, T, H, 256, bf16);
  args.dk = packed<float>(dk, T, H, 64, bf16);
  args.dv = packed<float>(dv, T, H, 64, bf16);
  // scratch: delta [B, H, T] (padded to 4 floats), then dS and P∘Z
  // [B, H, T, T] each
  const long long rows = static_cast<long long>(B) * H * T;
  args.delta = scratch;
  args.dbias = scratch + (rows + 3) / 4 * 4;
  args.pz = args.dbias + rows * T;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? bf::launch_relpos_bf16_bwd(args, B, s)
           : tc::launch_attn_tc_chunk_bwd<5, false>(args, B, s));
}

}  // namespace

// head0 (the last argument): the first of the call's H heads among the
// layer's, the dropout counter's head offset (AttnArgs::h0): a
// tensor-parallel rank passes the first head it holds, every other
// caller 0
extern "C" int daspeech_relpos_fwd(const float* q, const float* k,
                                   const float* v, const float* a,
                                   const float* e, const float* bias,
                                   const uint32_t* seeds, uint32_t thresh,
                                   float keep_scale, float* out, float* stats,
                                   int B, int T, int H, int D, int C,
                                   float scale, void* stream, int head0) {
  return relpos_fwd(q, k, v, a, e, bias, seeds, thresh, keep_scale, out,
                    stats, nullptr, B, T, H, D, C, scale, stream, false, head0);
}

// bf16 q, k, v, a, e and out; out32 [B, T, H*64] fp32, written by a
// training forward (stats given) and read by the backward as its `out`
extern "C" int daspeech_relpos_fwd_bf16(const void* q, const void* k,
                                        const void* v, const void* a,
                                        const void* e, const float* bias,
                                        const uint32_t* seeds,
                                        uint32_t thresh, float keep_scale,
                                        void* out, float* stats, float* out32,
                                        int B, int T, int H, int D, int C,
                                        float scale, void* stream, int head0) {
  return relpos_fwd(q, k, v, a, e, bias, seeds, thresh, keep_scale, out,
                    stats, out32, B, T, H, D, C, scale, stream, true, head0);
}

extern "C" int daspeech_relpos_bwd(
    const float* q, const float* k, const float* v, const float* a,
    const float* e, const float* bias, const uint32_t* seeds, uint32_t thresh,
    float keep_scale, const float* out, const float* stats, const float* dout,
    float* dq, float* dk, float* dv, float* da, float* scratch, int B, int T,
    int H, int D, int C, float scale, void* stream, int head0) {
  return relpos_bwd(q, k, v, a, e, bias, seeds, thresh, keep_scale, out,
                    stats, dout, dq, dk, dv, da, scratch, B, T, H, D, C, scale,
                    stream, false, head0);
}

extern "C" int daspeech_relpos_bwd_bf16(
    const void* q, const void* k, const void* v, const void* a,
    const void* e, const float* bias, const uint32_t* seeds, uint32_t thresh,
    float keep_scale, const void* out, const float* stats, const void* dout,
    void* dq, void* dk, void* dv, void* da, float* scratch, int B, int T,
    int H, int D, int C, float scale, void* stream, int head0) {
  return relpos_bwd(q, k, v, a, e, bias, seeds, thresh, keep_scale, out,
                    stats, dout, dq, dk, dv, da, scratch, B, T, H, D, C, scale,
                    stream, true, head0);
}
