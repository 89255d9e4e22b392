// Packed multi-head attention, forward and backward, for Hopper (sm_90a),
// fp32.
//
// Replaces the Pallas kernels of daspeech_tpu/ops/fused_attention.py:522
// (fused_attention_packed: forward _attn_kernel_packed, :285; backward
// _attn_bwd_kernel_packed, :324), dropout included, and with them the
// head-major dispatch of :189 (fused_attention) that the JAX layer takes
// when the packed kernel overflows its VMEM budget: these kernels stream
// keys (forward, dq) and queries (dk/dv), so one entry point serves every
// length.
//
// Computes, per batch row b and head h,
//   out[b, :, h] = dropout(softmax(q[b, :, h] k[b, :, h]^T * scale + bias[b]))
//                  v[b, :, h]
// on the packed [B, T, H*64] projections, with bias [B, Tk] an additive
// column bias (0 or -1e30). q arrives pre-scaled (scale = 1 at the caller).
// The backward takes the forward's output and its row softmax statistics
// and returns dq, dk, dv; the dropout mask is regenerated from the same
// Philox counters.
//
// What bounds it on this card: the port trains and serves in fp32 for
// parity with the JAX reference, so the products run on the fp32 FMA pipes
// (67 TFLOP/s peak on an H100 SXM), not the tensor cores; every FMA also
// reads one shared-memory operand, which makes shared-memory bandwidth the
// practical limit. At the training decoder shape (B=80, H=8, T=240, d=64)
// the forward is 9.4 GFLOP against 157 MB of q/k/v/out traffic, the
// backward (five products) 23.6 GFLOP against 315 MB: both compute-bound.
// The design keeps the score matrix out of device memory (online softmax
// over key tiles; the backward recomputes P from the saved row statistics)
// and draws dropout bits in registers; a tensor-core (TF32 or bf16 wgmma)
// version is where speed comes from.
#include "attention.cuh"

namespace {

using namespace daspeech;

AttnArgs packed_args(const float* q, const float* k, const float* v,
                     const float* bias, const uint32_t* seeds,
                     uint32_t thresh, float keep_scale, float* out,
                     float* stats, int Tq, int Tk, int H, float scale) {
  constexpr long long D = 64;
  const long long HD = H * D;
  AttnArgs args;
  args.q = {q, Tq * HD, HD, D};
  args.a = {nullptr, 0, 0, 0};
  args.k = {k, Tk * HD, HD, D};
  args.e = {nullptr, 0, 0, 0};
  args.v = {v, Tk * HD, HD, D};
  args.bias = bias;
  args.bias_sb = Tk;
  args.o = {out, Tq * HD, HD, D};
  args.stats = stats;
  args.H = H;
  args.Tq = Tq;
  args.Tk = Tk;
  args.scale = scale;
  args.drop = {seeds, thresh, keep_scale};
  return args;
}

}  // namespace

extern "C" int daspeech_attention_fwd(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      const uint32_t* seeds, uint32_t thresh,
                                      float keep_scale, float* out,
                                      float* stats, int B, int Tq, int Tk,
                                      int H, int D, float scale,
                                      void* stream) {
  using namespace daspeech;
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const AttnArgs args = packed_args(q, k, v, bias, seeds, thresh, keep_scale,
                                    out, stats, Tq, Tk, H, scale);
  return static_cast<int>(launch_attn_fwd<64, 0, 64, 4, 32, 64>(
      args, B, static_cast<cudaStream_t>(stream)));
}

extern "C" int daspeech_attention_bwd(
    const float* q, const float* k, const float* v, const float* bias,
    const uint32_t* seeds, uint32_t thresh, float keep_scale,
    const float* out, const float* stats, const float* dout, float* dq,
    float* dk, float* dv, float* delta, int B, int Tq, int Tk, int H, int D,
    float scale, void* stream) {
  using namespace daspeech;
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long HD = static_cast<long long>(H) * 64;
  AttnBwdArgs args;
  args.f = packed_args(q, k, v, bias, seeds, thresh, keep_scale,
                       const_cast<float*>(out), const_cast<float*>(stats), Tq,
                       Tk, H, scale);
  args.dout = {dout, Tq * HD, HD, 64};
  args.dq = {dq, Tq * HD, HD, 64};
  args.da = {nullptr, 0, 0, 0};
  args.dk = {dk, Tk * HD, HD, 64};
  args.dv = {dv, Tk * HD, HD, 64};
  args.delta = delta;
  return static_cast<int>(launch_attn_bwd<64, 0, 64, 4, 32, 64, 64, 32>(
      args, B, static_cast<cudaStream_t>(stream)));
}
