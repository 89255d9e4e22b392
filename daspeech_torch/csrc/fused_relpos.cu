// Conformer relative-position self-attention, forward and backward, for
// Hopper (sm_90a), fp32.
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
// 320 between the extended query [q_u | a] and the extended key [k | e], so
// the shared attention template (attention.cuh) runs with D1 = 64, D2 = 256
// for the forward and both backward kernels; the dq kernel's extended
// gradient is [dq | da], and the dk/dv kernel keeps only the first 64
// channels of the extended key's gradient. Neither the [T, T] position
// scores nor the [T, 2T-1] shift tensor of the reference form ever reach
// device memory.
//
// What bounds it on this card: five-sixths of the score FLOPs are the
// position product. At the training shape (B=80, H=4, T'=120) the forward
// is 3.5 GFLOP and the backward 7.7 GFLOP of fp32 FMA, each FMA reading one
// shared-memory operand, against 68 MB (forward) of device traffic:
// compute-bound on the fp32 pipes and on shared-memory bandwidth. Key tiles
// are 16 rows so the extended key tile (20 KB) and value tile fit static
// shared memory. The dq kernel holds the extended query and its gradient
// (2 x 80 floats a thread) and spills; splitting the 320 channels over
// more threads per row is later work.
#include "attention.cuh"

namespace {

using namespace daspeech;

AttnArgs relpos_args(const float* q, const float* k, const float* v,
                     const float* a, const float* e, const float* bias,
                     const uint32_t* seeds, uint32_t thresh, float keep_scale,
                     float* out, float* stats, int T, int H, float scale) {
  constexpr long long D = 64, C = 256;
  const long long HD = H * D, HC = H * C;
  AttnArgs args;
  args.q = {q, T * HD, HD, D};
  args.a = {a, T * HC, HC, C};
  args.k = {k, T * HD, HD, D};
  args.e = {e, 0, C, 0};
  args.v = {v, T * HD, HD, D};
  args.bias = bias;
  args.bias_sb = T;
  args.o = {out, T * HD, HD, D};
  args.stats = stats;
  args.H = H;
  args.Tq = T;
  args.Tk = T;
  args.scale = scale;
  args.drop = {seeds, thresh, keep_scale};
  return args;
}

}  // namespace

extern "C" int daspeech_relpos_fwd(const float* q, const float* k,
                                   const float* v, const float* a,
                                   const float* e, const float* bias,
                                   const uint32_t* seeds, uint32_t thresh,
                                   float keep_scale, float* out, float* stats,
                                   int B, int T, int H, int D, int C,
                                   float scale, void* stream) {
  using namespace daspeech;
  if (D != 64 || C != 256) return static_cast<int>(cudaErrorInvalidValue);
  const AttnArgs args = relpos_args(q, k, v, a, e, bias, seeds, thresh,
                                    keep_scale, out, stats, T, H, scale);
  return static_cast<int>(launch_attn_fwd<64, 256, 64, 4, 32, 16>(
      args, B, static_cast<cudaStream_t>(stream)));
}

extern "C" int daspeech_relpos_bwd(
    const float* q, const float* k, const float* v, const float* a,
    const float* e, const float* bias, const uint32_t* seeds, uint32_t thresh,
    float keep_scale, const float* out, const float* stats, const float* dout,
    float* dq, float* dk, float* dv, float* da, float* delta, int B, int T,
    int H, int D, int C, float scale, void* stream) {
  using namespace daspeech;
  if (D != 64 || C != 256) return static_cast<int>(cudaErrorInvalidValue);
  const long long HD = static_cast<long long>(H) * 64;
  const long long HC = static_cast<long long>(H) * 256;
  AttnBwdArgs args;
  args.f = relpos_args(q, k, v, a, e, bias, seeds, thresh, keep_scale,
                       const_cast<float*>(out), const_cast<float*>(stats), T, H,
                       scale);
  args.dout = {dout, T * HD, HD, 64};
  args.dq = {dq, T * HD, HD, 64};
  args.da = {da, T * HC, HC, 256};
  args.dk = {dk, T * HD, HD, 64};
  args.dv = {dv, T * HD, HD, 64};
  args.delta = delta;
  return static_cast<int>(launch_attn_bwd<64, 256, 64, 4, 32, 16, 16, 32>(
      args, B, static_cast<cudaStream_t>(stream)));
}
