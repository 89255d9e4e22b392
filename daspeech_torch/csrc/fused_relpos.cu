// Conformer relative-position self-attention forward for Hopper (sm_90a),
// fp32.
//
// Replaces the Pallas kernel daspeech_tpu/ops/fused_relpos.py:373
// (fused_attention_relpos -> _relpos_fwd_kernel, :90), forward only.
//
// Computes, per batch row b and head h,
//   out[b, :, h] = softmax((q_u[b, :, h] k[b, :, h]^T + a[b, :, h] e^T) * scale
//                          + bias[b]) v[b, :, h]
// with q_u/k/v the packed [B, T, H*64] projections, a [B, T, H*C] the rotated
// position queries (depth C = 256 per head, four times d), e [T, C] the
// constant sin/cos basis shared by every row and head, and bias [B, T] an
// additive column bias (0 or -1e30).
//
// Design: the two score products are one dot product of depth 64 + 256 =
// 320 between the extended query [q_u | a] and the extended key [k | e], so
// the shared attention template (attention.cuh) runs with D1 = 64, D2 = 256.
// Neither the [T, T] position scores nor the [T, 2T-1] shift tensor of the
// reference form ever reach device memory.
//
// What bounds it on this card: five-sixths of the score FLOPs are the
// position product, so at the encoder shape (B=8, H=4, T'=120) the call is
// ~0.35 GFLOP of fp32 FMA with each FMA reading one shared-memory operand;
// like the attention kernel it is compute-bound on the fp32 pipes and on
// shared-memory bandwidth, not on device memory. Key tiles are 16 rows so
// the extended key tile (20 KB) and value tile fit static shared memory.
#include "attention.cuh"

extern "C" int daspeech_relpos_fwd(const float* q, const float* k,
                                   const float* v, const float* a,
                                   const float* e, const float* bias,
                                   float* out, int B, int T, int H, int D,
                                   int C, float scale, void* stream) {
  using namespace daspeech;
  if (D != 64 || C != 256) return static_cast<int>(cudaErrorInvalidValue);
  const long long HD = static_cast<long long>(H) * D;
  const long long HC = static_cast<long long>(H) * C;
  AttnArgs args;
  args.q = {q, T * HD, HD, D};
  args.a = {a, T * HC, HC, C};
  args.k = {k, T * HD, HD, D};
  args.e = {e, 0, C, 0};
  args.v = {v, T * HD, HD, D};
  args.bias = bias;
  args.bias_sb = T;
  args.o = out;
  args.o_sb = T * HD;
  args.o_sr = HD;
  args.o_sh = D;
  args.Tq = T;
  args.Tk = T;
  args.scale = scale;
  return static_cast<int>(launch_attn_fwd<64, 256, 64, 4, 32, 16>(
      args, B, H, static_cast<cudaStream_t>(stream)));
}
