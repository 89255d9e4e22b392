// Packed multi-head attention forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas kernel daspeech_tpu/ops/fused_attention.py:522
// (fused_attention_packed -> _attn_kernel_packed, :285), forward only, and
// with it the head-major dispatch of :189 (fused_attention) that the JAX
// layer takes when the packed kernel overflows its VMEM budget: this kernel
// streams keys, so one entry point serves every length.
//
// Computes, per batch row b and head h,
//   out[b, :, h] = softmax(q[b, :, h] k[b, :, h]^T * scale + bias[b]) v[b, :, h]
// on the packed [B, T, H*64] projections, with bias [B, Tk] an additive
// column bias (0 or -1e30). q arrives pre-scaled (scale = 1 at the caller).
//
// What bounds it on this card: the serving path runs in fp32 for parity with
// the JAX reference, so the products run on the fp32 FMA pipes (67 TFLOP/s
// peak on an H100 SXM), not the tensor cores; every FMA also reads one
// shared-memory operand, which makes shared-memory bandwidth the practical
// limit. At the decoder shape (B=8, H=8, T=240, d=64) the whole call is
// 0.94 GFLOP against 16 MB of q/k/v/out traffic, far above the memory
// roofline, so it is compute-bound. The design keeps the score matrix out
// of device memory (online softmax over 64-key tiles) and reads each K/V
// tile once per 32 query rows; a later tensor-core (TF32 or bf16 wgmma)
// version is where speed comes from.
#include "attention.cuh"

extern "C" int daspeech_attention_fwd(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      float* out, int B, int Tq, int Tk,
                                      int H, int D, float scale,
                                      void* stream) {
  using namespace daspeech;
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long HD = static_cast<long long>(H) * D;
  AttnArgs args;
  args.q = {q, Tq * HD, HD, D};
  args.a = {nullptr, 0, 0, 0};
  args.k = {k, Tk * HD, HD, D};
  args.e = {nullptr, 0, 0, 0};
  args.v = {v, Tk * HD, HD, D};
  args.bias = bias;
  args.bias_sb = Tk;
  args.o = out;
  args.o_sb = Tq * HD;
  args.o_sr = HD;
  args.o_sh = D;
  args.Tq = Tq;
  args.Tk = Tk;
  args.scale = scale;
  return static_cast<int>(launch_attn_fwd<64, 0, 64, 4, 32, 64>(
      args, B, H, static_cast<cudaStream_t>(stream)));
}
