// The bf16 mode of the fused Conformer FFN (#6) on Hopper's bf16 tensor
// cores (sm_90a): the kernels of daspeech_ffn_fwd_bf16 and
// daspeech_ffn_bwd_bf16 in fused_ffn.cu, which includes this header after
// its shared pieces (the width C, the cluster's row tile BM and F slice FS,
// RowShare, Frag, warp_sum, keep, launch_rows and reduce).
// They replace the bf16 mode of the Pallas kernels of
// daspeech_tpu/ops/fused_ffn.py:175 fused_ffn (_ffn_fwd_kernel :59,
// _ffn_bwd_kernel :84), whose products take bf16 operands with fp32 sums
// (preferred_element_type=f32): y before W1 and h before W2 (:70-78); g,
// h·m1, gpre and y before theirs (:102-128). The fp32 entry points keep
// fused_ffn.cu's 3xTF32 kernels.
//
// What bounds it on this card: operations. At cell T (N = B T = 9600 rows,
// C = 256, F = 2048) the forward and backward are 7 products, 70 GFLOP
// (0.071 ms at 989 TFLOP/s), against 47 MB of bf16 and fp32 tensors. Every
// operand is bf16 already (the tensors in device memory, or an fp32 value
// the TPU kernel rounds before its product), so each product is one
// mma.sync m16n8k16 with fp32 accumulators, chained in place, with its
// operands from shared memory by ldmatrix (gemm_tc.cuh's bf16 tiles).
//
// Layout and design, as fused_ffn.cu's fp32 kernels: a cluster of
// cs = min(8, ceil(F / 256)) blocks owns BM = 32 rows; block `rank` takes
// the 256-column F slices rank, rank + cs, ...; 8 warps of 32 columns. The
// activations y, h, g and gpre lie in shared memory as [32][264] bf16 planes
// (the values the products consume); W1 and W2 stream as bf16 in 32-deep
// chunks by 16-byte cp.async through a ring of kBfRing tiles, kBfRing - 1
// chunks ahead, read in place: [256][40] chunks with the contraction inner
// (W1 for y·W1ᵀ, W2 for h·W2ᵀ: plain ldmatrix) and [32][264] chunks with
// it outer (W2 for g·W2, W1 for gpre·W1: ldmatrix.trans). The partial sums
// over the F slices meet in distributed shared memory in rank order.
//
// Both row kernels run two blocks an SM (at most 113 KB of shared memory
// and 128 registers a thread): only one F slice's product is held in
// registers at a time, and each slice's result is added into an fp32
// [32][260] partial in shared memory, in slice order, which the cluster's
// reduction then reads.
//
// Forward (ffn_bf16_fwd_kernel): per slice LayerNorm into the bf16 plane,
// pre = y·W1ᵀ, h = swish(pre + b1)·m1 into the plane (y is dead), h·W2ᵀ
// added into the partial; the partials' rank-order sum + b2, mask 2,
// written as bf16.
//
// Backward, three launches and no atomics (the same bits over two runs):
//  1. ffn_bf16_rows_kernel: g = dout·m2 into its plane (rank 0 also to
//     scratch, and db2 from the unrounded g); per slice LayerNorm into the
//     other plane, pre = y·W1ᵀ, gh = g·W2, gpre = gh·m1·swish'(pre) into
//     that plane (y is dead), with h·m1 and
//     gpre to bf16 scratch [N, Fp] (Fp = F rounded up to 8, so that their
//     rows take 16-byte copies; columns F .. Fp zero) and db1 from the
//     unrounded gpre (column sums over the warp's rows by shuffles);
//     gpre·W1 added into the gy partial; its rank-order sum, LayerNorm's backward
//     into dx (bf16), dgamma and dbeta summed over the warps, then the
//     cluster's blocks in rank order.
//  2. ffn_bf16_wgrad_kernel: dW1 = gpreᵀ·y and dW2 = gᵀ·(h·m1), a [128,
//     128] output tile a block over one of S fixed slices of the N rows,
//     both operands 32-row chunks [k][m] by ldmatrix.trans, into per-slice
//     partial sums.
//  3. fused_ffn.cu's ffn_reduce_kernel adds the partials in a fixed order.
// LayerNorm, the swish, the masks, the biases and the column sums stay
// fp32; db1 sums the unrounded gpre and db2 the unrounded g.
//
// Dropout: fused_ffn.cu's Philox bits (site 1 after the swish, site 2 after
// the second product), word j % 4 of philox4x32_10((j / 4, t, 0, s),
// (seed[b], 0)); at site 1 the two lanes whose accumulator columns share a
// 4-column group draw one row each and swap the words (pair_bits). The
// swish takes its exponential on the SFU (__expf); its result is rounded
// to bf16 before it is used.
#pragma once

namespace bf {

constexpr int PP = C + 8;         // pitch of a [BM][256] bf16 plane
constexpr int BPLANE = BM * PP;   // elements of a plane
constexpr int KNB = 256 + 8;      // pitch of [KD][256] chunks (k outer)
constexpr int PARTP = C + 4;      // pitch of the fp32 [BM][256] partial sums
constexpr int kWarps = NT / 32;
static_assert(FS == 256, "a slice is 256 columns");

// A ring of RING weight chunks KD deep: [256][KD + 8] (k inner) or
// [KD][256 + 8] (k outer) bf16 tiles
template <int KD, int RING>
struct Ring {
  static constexpr int kDepth = KD, kRing = RING;
  static constexpr int NKB = KD + 8;       // pitch of [256][KD] chunks
  static constexpr int SLOT = 256 * NKB;   // elements of a slot
  static constexpr int kBytes = 2 * RING * SLOT;
  static_assert(KD % 16 == 0 && KD * KNB <= SLOT, "chunk shapes");
};
// the forward's and the backward rows kernel's rings: two blocks an SM
// each (at most 113 KB of shared memory and 128 registers a thread)
using FwdRing = Ring<32, 3>;
using RowsRing = Ring<32, 2>;
// forward: one bf16 plane (y, then h), the ring and the fp32 partial sums
// over the block's F slices (the cluster's reduction reads them); backward
// rows: two bf16 planes (y, then gpre; g), the ring (the g column sums and
// the warps' and the block's dgamma and dbeta sums reuse it), the fp32 gy
// partial sums, mean and 1/std
constexpr size_t kPartBytes = sizeof(float) * BM * PARTP;
constexpr size_t kFwdSmem = 2 * BPLANE + FwdRing::kBytes + kPartBytes;
constexpr size_t kRowsSmem = 2 * 2 * BPLANE + RowsRing::kBytes + kPartBytes +
                             sizeof(float) * 2 * BM;
static_assert(sizeof(float) * 2 * C * (kWarps + 1) <= RowsRing::kBytes,
              "the backward's column sums fit in the ring");
static_assert(kFwdSmem <= 113 * 1024 && kRowsSmem <= 113 * 1024,
              "two blocks an SM");

struct Args {
  const uint16_t *x, *w1, *b1, *w2, *b2;   // bf16
  const float *gamma, *beta;
  const uint32_t* seeds;  // [B] per-row Philox keys, or nullptr
  int drop1, drop2;       // sites on
  uint32_t thresh1, thresh2;
  float scale1, scale2;
  int N, T, F, Fp;        // N = B * T rows; Fp = F rounded up to 8
  int vec_w2;             // W2's rows take 16-byte copies
};

struct Scratch {
  uint16_t *y, *g;        // [N, C]: LN output, dout * m2 (bf16)
  uint16_t *hd, *gpre;    // [N, Fp]: swish(pre) * m1, its pre-activation grad
  float* part;            // [ntiles, F + 3C]: db1 | db2 | dgamma | dbeta
};

// Philox words of the 4 columns 4 * col4 .. of row n at `site`
__device__ __forceinline__ uint4 site_bits(const Args& a, int n, int col4,
                                           uint32_t site) {
  const int b = n / a.T;
  return philox4x32_10(make_uint4(col4, n - b * a.T, 0u, site), a.seeds[b],
                       0u);
}

// the keep factor of word e of bits (e < 4)
__device__ __forceinline__ float keep_word(const uint4& bits, int e,
                                           uint32_t thresh, float scale) {
  const uint32_t w = e == 0 ? bits.x : e == 1 ? bits.y : e == 2 ? bits.z
                                                                : bits.w;
  return keep(w, thresh, scale);
}

// The site-1 Philox words of the 4-column group holding column f for this
// thread's rows 16 m + gid (b0) and 16 m + gid + 8 (b1) of the tile at n0:
// the two lanes that share the group (tq and tq ^ 1) each draw one row's
// words and swap them by a shuffle, so each word is drawn once
__device__ __forceinline__ void pair_bits(const Args& a, int n0, int m,
                                          int f, const Frag& fr, uint4& b0,
                                          uint4& b1) {
  const int hm = fr.tq & 1, n = n0 + fr.row(m, hm), g4 = f >> 2;
  uint4 mine = make_uint4(0u, 0u, 0u, 0u);
  if (n < a.N && 4 * g4 < a.F) mine = site_bits(a, n, g4, 1u);
  const uint4 other = make_uint4(__shfl_xor_sync(0xffffffffu, mine.x, 1),
                                 __shfl_xor_sync(0xffffffffu, mine.y, 1),
                                 __shfl_xor_sync(0xffffffffu, mine.z, 1),
                                 __shfl_xor_sync(0xffffffffu, mine.w, 1));
  b0 = hm ? other : mine;
  b1 = hm ? mine : other;
}

// swish(p) = p sigmoid(p) and sigmoid(p), on the SFU (ex2.approx); the
// operand of the next product is rounded to bf16 after
__device__ __forceinline__ float fast_sigmoid(float p) {
  return __fdividef(1.f, 1.f + __expf(-p));
}

__device__ __forceinline__ void unpack8(const uint4& u, float v[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = gemm::bf2f(static_cast<uint16_t>(w[i] & 0xffffu));
    v[2 * i + 1] = gemm::bf2f(static_cast<uint16_t>(w[i] >> 16));
  }
}

__device__ __forceinline__ uint4 pack8(const float v[8]) {
  return make_uint4(gemm::pack_bf16(v[0], v[1]), gemm::pack_bf16(v[2], v[3]),
                    gemm::pack_bf16(v[4], v[5]), gemm::pack_bf16(v[6], v[7]));
}

// LayerNorm of rows n0 .. n0 + BM into the y plane as bf16 (0 for rows >=
// N), one warp a row, lane l the 8 columns 8 l ..; with mu, each row's mean
// and 1/std; with y_out, y is also written there
__device__ void layer_norm_rows(const Args& a, int n0, uint16_t* ys,
                                float* mu, float* rs, uint16_t* y_out) {
  constexpr int RW = BM / kWarps;     // rows of a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c0 = 8 * lane;
  float v[RW][8];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int n = n0 + warp + i * kWarps;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (n < a.N) {
      u = *reinterpret_cast<const uint4*>(a.x + static_cast<long long>(n) * C +
                                          c0);
    }
    unpack8(u, v[i]);
  }
  float gm[8], bt[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    gm[j] = a.gamma[c0 + j];
    bt[j] = a.beta[c0 + j];
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + i * kWarps, n = n0 + r;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[i][j];
    const float mean = warp_sum(s) * (1.f / C);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = v[i][j] - mean;
      q = fmaf(d, d, q);
    }
    const float rstd = rsqrtf(warp_sum(q) * (1.f / C) + kEps);
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      y[j] = n < a.N ? fmaf((v[i][j] - mean) * rstd, gm[j], bt[j]) : 0.f;
    }
    const uint4 p = pack8(y);
    *reinterpret_cast<uint4*>(ys + r * PP + c0) = p;
    if (y_out != nullptr && n < a.N) {
      *reinterpret_cast<uint4*>(y_out + static_cast<long long>(n) * C + c0) =
          p;
    }
    if (mu != nullptr && lane == 0) {
      mu[r] = mean;
      rs[r] = rstd;
    }
  }
}

// The first RING - 1 chunks of a streamed product, issued before the work
// that precedes it; the ring must be free (the last product has ended)
template <class R, class Copy>
__device__ __forceinline__ void prefetch(uint16_t* ring, Copy copy) {
#pragma unroll
  for (int kc = 0; kc < R::kRing - 1; ++kc) {
    copy(kc, ring + kc * R::SLOT);
    cp_async_commit();
  }
}

// acc (this warp's 32 rows x 32 columns at column 32 warp) = A · B over
// K = 256: A the bf16 plane `as` ([BM][PP], k from 0), B streamed in
// KD-deep chunks that copy(kc, tile) brings by cp.async into the ring,
// RING - 1 chunks ahead (the first ones by prefetch); BT: B's chunks are
// [KD][256] (k outer, ldmatrix.trans), else [256][KD]. Ends with a barrier:
// the caller may restage the planes or the ring.
template <class R, bool BT, class Copy>
__device__ __forceinline__ void product(float (&acc)[2][4][4],
                                        const uint16_t* as, uint16_t* ring,
                                        Copy copy) {
  constexpr int KD = R::kDepth, RING = R::kRing;
  constexpr int pitch = BT ? KNB : R::NKB, nk = 256 / KD;
  const int n0 = (threadIdx.x / 32) * 32;
  gemm::zero(acc);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<RING - 2>();       // chunk kc: this thread's copies
    __syncthreads();                 // everyone's; the oldest slot is free
    if (kc + RING - 1 < nk) {
      copy(kc + RING - 1, ring + ((kc + RING - 1) % RING) * R::SLOT);
    }
    cp_async_commit();
    const uint16_t* slot = ring + (kc % RING) * R::SLOT;
    gemm::warp_mma_bf16<2, 4, KD / 16, false, BT>(
        acc, as + kc * KD, PP, BT ? slot + n0 : slot + n0 * R::NKB, pitch);
  }
  __syncthreads();
}

// this warp's 32 x 32 accumulator into the fp32 partial sums [BM][PARTP]:
// stored for a block's first F slice, added for the later ones (its own
// elements: no barrier)
__device__ __forceinline__ void to_partial(float* part,
                                           const float (&acc)[2][4][4],
                                           bool first) {
  const Frag fr;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2* q = reinterpret_cast<float2*>(part + fr.row(m, h) * PARTP +
                                              fr.col(j));
        float2 v = make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
        if (!first) {
          v.x += q->x;
          v.y += q->y;
        }
        *q = v;
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 2) ffn_bf16_fwd_kernel(const Args a,
                                                             uint16_t* out) {
  using R = FwdRing;
  using NKChunk = gemm::BfChunk<256, R::kDepth, NT>;   // [256][KD], k inner
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 smem4[];
  uint16_t* ys = reinterpret_cast<uint16_t*>(smem4);   // y, then h * m1
  uint16_t* ring = ys + BPLANE;
  float* part = reinterpret_cast<float*>(ring + R::kRing * R::SLOT);
  const int n0 = blockIdx.y * BM;
  const int nslices = (a.F + FS - 1) / FS;
  const Frag fr;

  for (int s = rank; s < nslices; s += cs) {
    const int f0 = s * FS;
    auto w1_chunk = [&](int kc, uint16_t* t) {   // W1[f0 .., kc KD ..]
      NKChunk::copy(t, R::NKB, a.w1, C, f0, kc * R::kDepth, a.F, C, true);
    };
    auto w2_chunk = [&](int kc, uint16_t* t) {   // W2[:, f0 + kc KD ..]
      NKChunk::copy(t, R::NKB, a.w2, a.F, 0, f0 + kc * R::kDepth, C, a.F,
                    a.vec_w2);
    };
    prefetch<R>(ring, w1_chunk);
    layer_norm_rows(a, n0, ys, nullptr, nullptr, nullptr);
    float acc[2][4][4];
    product<R, false>(acc, ys, ring, w1_chunk);   // pre
    prefetch<R>(ring, w2_chunk);
    // h = swish(pre + b1) * m1 into ys (y is dead), 0 beyond F
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + fr.col(j);
        uint4 bits[2] = {make_uint4(0u, 0u, 0u, 0u),
                         make_uint4(0u, 0u, 0u, 0u)};
        if (a.drop1) pair_bits(a, n0, m, f, fr, bits[0], bits[1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = fr.row(m, h), n = n0 + r;
          float hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            hv[e] = 0.f;
            if (f + e < a.F) {
              const float p = acc[m][j][2 * h + e] + gemm::bf2f(a.b1[f + e]);
              hv[e] = p * fast_sigmoid(p);
              if (a.drop1) {
                hv[e] *= n < a.N ? keep_word(bits[h], (f + e) & 3,
                                             a.thresh1, a.scale1)
                                 : 0.f;
              }
            }
          }
          *reinterpret_cast<uint32_t*>(ys + r * PP + fr.col(j)) =
              gemm::pack_bf16(hv[0], hv[1]);
        }
      }
    }
    product<R, false>(acc, ys, ring, w2_chunk);   // this slice's h W2ᵀ
    to_partial(part, acc, s == rank);
  }

  // each block sums its row share of the partials over the cluster in
  // rank order: + b2, mask 2, store
  cluster.sync();
  const RowShare sh(cs, rank);
  for (int g = threadIdx.x; g < sh.rows * (C / 4); g += NT) {
    const int r = sh.r0 + g / (C / 4), q = g % (C / 4), n = n0 + r;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < cs; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, k) + r * PARTP + 4 * q);
      o[0] += v.x;
      o[1] += v.y;
      o[2] += v.z;
      o[3] += v.w;
    }
    if (n >= a.N) continue;
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (a.drop2) bits = site_bits(a, n, q, 2u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] += gemm::bf2f(a.b2[4 * q + e]);
      if (a.drop2) o[e] *= keep_word(bits, e, a.thresh2, a.scale2);
    }
    *reinterpret_cast<uint2*>(out + static_cast<long long>(n) * C + 4 * q) =
        make_uint2(gemm::pack_bf16(o[0], o[1]), gemm::pack_bf16(o[2], o[3]));
  }
  cluster.sync();   // no block leaves while a peer reads its partial
}

__global__ void __launch_bounds__(NT, 2)
    ffn_bf16_rows_kernel(const Args a, const uint16_t* dout, uint16_t* dx,
                         const Scratch sc) {
  using R = RowsRing;
  using NKChunk = gemm::BfChunk<256, R::kDepth, NT>;   // [256][KD], k inner
  using KNChunk = gemm::BfChunk<R::kDepth, 256, NT>;   // [KD][256], k outer
  constexpr int KD = R::kDepth;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 smem4[];
  uint16_t* ys = reinterpret_cast<uint16_t*>(smem4);   // y, then gpre
  uint16_t* gs = ys + BPLANE;                           // g
  uint16_t* ring = gs + BPLANE;
  float* pg = reinterpret_cast<float*>(ring + R::kRing * R::SLOT);  // gy
  float* mu = pg + BM * PARTP;
  float* rs = mu + BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.y * BM;
  const int nslices = (a.F + FS - 1) / FS;
  const int width = a.F + 3 * C;
  float* part = sc.part + static_cast<long long>(blockIdx.y) * width;
  const Frag fr;

  // g = dout * m2 into gs (0 for rows >= N; rank 0 also to scratch): thread
  // tid the 8 columns 8 (tid % 32) .. of rows tid / 32 + 8 i; their fp32
  // column sums over its rows into the ring, then (rank 0) db2 in order
  {
    float* colp = reinterpret_cast<float*>(ring);   // [kWarps][C]
    const int c0 = 8 * lane;
    float csum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BM / kWarps; ++i) {
      const int r = warp + i * kWarps, n = n0 + r;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (n < a.N) {
        unpack8(*reinterpret_cast<const uint4*>(
                    dout + static_cast<long long>(n) * C + c0),
                v);
        if (a.drop2) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4 bits = site_bits(a, n, 2 * lane + h, 2u);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              v[4 * h + e] *= keep_word(bits, e, a.thresh2, a.scale2);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) csum[j] += v[j];
      }
      const uint4 p = pack8(v);
      *reinterpret_cast<uint4*>(gs + r * PP + c0) = p;
      if (rank == 0 && n < a.N) {
        *reinterpret_cast<uint4*>(sc.g + static_cast<long long>(n) * C + c0) =
            p;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) colp[warp * C + c0 + j] = csum[j];
    __syncthreads();
    if (rank == 0) {                                   // db2
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += colp[w * C + tid];
      part[a.F + tid] = sum;
    }
    __syncthreads();   // the ring is free for the weight chunks
  }

  for (int s = rank; s < nslices; s += cs) {
    const int f0 = s * FS;
    auto w1_chunk = [&](int kc, uint16_t* t) {   // W1[f0 .., kc KD ..]
      NKChunk::copy(t, R::NKB, a.w1, C, f0, kc * KD, a.F, C, true);
    };
    auto w2_chunk = [&](int kc, uint16_t* t) {   // W2[kc KD .., f0 ..]
      KNChunk::copy(t, KNB, a.w2, a.F, kc * KD, f0, C, a.F, a.vec_w2);
    };
    auto w1t_chunk = [&](int kc, uint16_t* t) {  // W1[f0 + kc KD .., :]
      KNChunk::copy(t, KNB, a.w1, C, f0 + kc * KD, 0, a.F, C, true);
    };
    prefetch<R>(ring, w1_chunk);
    // y (again: the last slice's gpre took its plane); rank 0's first
    // slice also writes it to scratch
    layer_norm_rows(a, n0, ys, mu, rs, s == 0 ? sc.y : nullptr);
    float pre[2][4][4], gh[2][4][4];
    product<R, false>(pre, ys, ring, w1_chunk);
    prefetch<R>(ring, w2_chunk);
    product<R, true>(gh, gs, ring, w2_chunk);
    prefetch<R>(ring, w1t_chunk);
    // gpre = gh * m1 * swish'(pre) into ys (0 beyond F and N), h * m1 and
    // gpre to scratch (columns F .. Fp zero), db1 from the unrounded gpre
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + fr.col(j);
      float colsum[2] = {0.f, 0.f};
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint4 bits[2] = {make_uint4(0u, 0u, 0u, 0u),
                         make_uint4(0u, 0u, 0u, 0u)};
        if (a.drop1) pair_bits(a, n0, m, f, fr, bits[0], bits[1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = fr.row(m, h), n = n0 + r;
          float gp[2], hd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            gp[e] = hd[e] = 0.f;
            if (f + e < a.F && n < a.N) {
              const float p = pre[m][j][2 * h + e] + gemm::bf2f(a.b1[f + e]);
              const float sg = fast_sigmoid(p);
              const float z = a.drop1 ? keep_word(bits[h], (f + e) & 3,
                                                  a.thresh1, a.scale1)
                                      : 1.f;
              gp[e] = gh[m][j][2 * h + e] * z * (sg * (1.f + p * (1.f - sg)));
              hd[e] = p * sg * z;
            }
            colsum[e] += gp[e];
          }
          const uint32_t gpw = gemm::pack_bf16(gp[0], gp[1]);
          *reinterpret_cast<uint32_t*>(ys + r * PP + fr.col(j)) = gpw;
          if (n < a.N && f < a.Fp) {
            const long long o = static_cast<long long>(n) * a.Fp + f;
            *reinterpret_cast<uint32_t*>(sc.gpre + o) = gpw;
            *reinterpret_cast<uint32_t*>(sc.hd + o) =
                gemm::pack_bf16(hd[0], hd[1]);
          }
        }
      }
      // db1: the column's sum over the warp's 32 rows (the lanes of one tq)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          colsum[e] += __shfl_xor_sync(0xffffffffu, colsum[e], off);
        }
        if (fr.gid == 0 && f + e < a.F) part[f + e] = colsum[e];
      }
    }
    float gy[2][4][4];
    product<R, true>(gy, ys, ring, w1t_chunk);   // this slice's gpre W1
    to_partial(pg, gy, s == rank);
  }

  // each block sums its row share of the gy partials over the cluster in
  // rank order and runs LayerNorm's backward on it (warp a row, lane the 8
  // columns 8 lane ..)
  float* wsum = reinterpret_cast<float*>(ring);   // [kWarps][2][C]
  float* bsum = wsum + kWarps * 2 * C;            // [2][C]
  cluster.sync();
  const RowShare sh(cs, rank);
  const int c0 = 8 * lane;
  float gm[8], dg[8], db[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    gm[j] = a.gamma[c0 + j];
    dg[j] = db[j] = 0.f;
  }
  for (int rl = warp; rl < sh.rows; rl += kWarps) {
    const int r = sh.r0 + rl, n = n0 + r;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < cs; ++k) {
      const float* q = cluster.map_shared_rank(pg, k) + r * PARTP + c0;
      const float4 u0 = *reinterpret_cast<const float4*>(q);
      const float4 u1 = *reinterpret_cast<const float4*>(q + 4);
      v[0] += u0.x;
      v[1] += u0.y;
      v[2] += u0.z;
      v[3] += u0.w;
      v[4] += u1.x;
      v[5] += u1.y;
      v[6] += u1.z;
      v[7] += u1.w;
    }
    float xh[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, dxh[8];
    if (n < a.N) {
      unpack8(*reinterpret_cast<const uint4*>(
                  a.x + static_cast<long long>(n) * C + c0),
              xh);
#pragma unroll
      for (int j = 0; j < 8; ++j) xh[j] = (xh[j] - mu[r]) * rs[r];
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dxh[j] = v[j] * gm[j];
      s1 += dxh[j];
      s2 = fmaf(dxh[j], xh[j], s2);
      dg[j] = fmaf(v[j], xh[j], dg[j]);
      db[j] += v[j];
    }
    const float m1 = warp_sum(s1) * (1.f / C);
    const float m2 = warp_sum(s2) * (1.f / C);
    if (n < a.N) {
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = rs[r] * (dxh[j] - m1 - xh[j] * m2);
      *reinterpret_cast<uint4*>(dx + static_cast<long long>(n) * C + c0) =
          pack8(o);
    }
  }
  // dgamma and dbeta: the warps' sums, then the block's in warp order, then
  // block 0 of the cluster adds the blocks' in rank order into the tile's row
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wsum[(warp * 2) * C + c0 + j] = dg[j];
    wsum[(warp * 2 + 1) * C + c0 + j] = db[j];
  }
  __syncthreads();
  float sg = 0.f, sb = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    sg += wsum[(w * 2) * C + tid];
    sb += wsum[(w * 2 + 1) * C + tid];
  }
  bsum[tid] = sg;
  bsum[C + tid] = sb;
  cluster.sync();   // every block's sums are in place; the partials are read
  if (rank == 0) {
    sg = sb = 0.f;
    for (int k = 0; k < cs; ++k) {
      const float* q = cluster.map_shared_rank(bsum, k);
      sg += q[tid];
      sb += q[C + tid];
    }
    part[a.F + C + tid] = sg;                          // dgamma
    part[a.F + 2 * C + tid] = sb;                      // dbeta
  }
  cluster.sync();   // block 0 has read every block's sums
}

// out[m][p] = sum over the rows n of one slice of A[n][m] Bm[n][p]
struct WgradJob {
  const uint16_t* A;   // [N, lda]
  const uint16_t* Bm;  // [N, ldb]
  float* part;         // [S, M, P]
  int lda, ldb, M, P;
};

struct WgradArgs {
  WgradJob job[2];     // dW1 = gpre^T y, dW2 = g^T (h * m1)
  int N, rows;         // rows per slice
};

constexpr int WT = 128;          // output tile of the weight gradients
constexpr int WKB = 32;          // rows of N a chunk
constexpr int WP = WT + 8;       // pitch of a [WKB][WT] chunk
constexpr int WSLOT = WKB * WP;  // elements of one operand's chunk
constexpr int kWRing = 4;
constexpr size_t kWgradSmem = 2 * (2 * kWRing * WSLOT);

// 8 warps: 4 along the output's rows x 2 along its columns, 32 x 64 each;
// both operands are chunks [k][m] and [k][p] (ldmatrix.trans)
__global__ void __launch_bounds__(NT, 2) ffn_bf16_wgrad_kernel(
    const WgradArgs a) {
  using Ch = gemm::BfChunk<WKB, WT, NT>;
  const WgradJob jb = (blockIdx.z & 1) ? a.job[1] : a.job[0];
  const int s = blockIdx.z >> 1;
  const int tiles_p = (jb.P + WT - 1) / WT;
  const int m0 = (blockIdx.x / tiles_p) * WT, p0 = (blockIdx.x % tiles_p) * WT;
  const int nb = s * a.rows, ne = min(a.N, nb + a.rows);
  extern __shared__ float4 smem4[];
  uint16_t* as = reinterpret_cast<uint16_t*>(smem4);  // [kWRing][WKB][WP]
  uint16_t* bs = as + kWRing * WSLOT;
  const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;

  float acc[2][8][4];
  gemm::zero(acc);
  const int nk = (ne - nb + WKB - 1) / WKB;
  auto copy = [&](int kc) {
    const int slot = (kc % kWRing) * WSLOT;
    Ch::copy(as + slot, WP, jb.A, jb.lda, nb + kc * WKB, m0, ne, jb.lda, true);
    Ch::copy(bs + slot, WP, jb.Bm, jb.ldb, nb + kc * WKB, p0, ne, jb.ldb,
             true);
  };
#pragma unroll
  for (int kc = 0; kc < kWRing - 1; ++kc) {
    if (kc < nk) copy(kc);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kWRing - 2>();
    __syncthreads();
    if (kc + kWRing - 1 < nk) copy(kc + kWRing - 1);
    cp_async_commit();
    const int slot = (kc % kWRing) * WSLOT;
    gemm::warp_mma_bf16<2, 8, WKB / 16, true, true>(
        acc, as + slot + wm * 32, WP, bs + slot + wn * 64, WP);
  }
  cp_async_wait<0>();
  float* out = jb.part + static_cast<long long>(s) * jb.M * jb.P;
  const int lane = threadIdx.x % 32, gid = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + 16 * m + gid + 8 * h;
      if (row >= jb.M) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = p0 + wn * 64 + 8 * n + 2 * tq + e;
          if (p < jb.P) {
            out[static_cast<long long>(row) * jb.P + p] = acc[m][n][2 * h + e];
          }
        }
      }
    }
  }
}

__host__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaError_t fwd(const Args& a, uint16_t* out, cudaStream_t st) {
  return launch_rows(ffn_bf16_fwd_kernel, kFwdSmem, a.F, a.N, st, a, out);
}

cudaError_t bwd(const Args& a, const uint16_t* dout, uint16_t* dx,
                float* dgamma, float* dbeta, float* dw1, float* db1,
                float* dw2, float* db2, const Scratch& sc, float* part_w,
                int S, cudaStream_t st) {
  const int F = a.F;
  const int ntiles = (a.N + BM - 1) / BM;
  cudaError_t err = launch_rows(ffn_bf16_rows_kernel, kRowsSmem, a.F, a.N,
                                st, a, dout, dx, sc);
  if (err != cudaSuccess) return err;

  const long long FC_ = static_cast<long long>(F) * C;
  WgradArgs w;
  w.job[0] = {sc.gpre, sc.y, part_w, a.Fp, C, F, C};
  w.job[1] = {sc.g, sc.hd, part_w + S * FC_, C, a.Fp, C, F};
  w.N = a.N;
  w.rows = (a.N + S - 1) / S;
  err = cudaFuncSetAttribute(ffn_bf16_wgrad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kWgradSmem));
  if (err != cudaSuccess) return err;
  const int tiles = ((F + WT - 1) / WT) * ((C + WT - 1) / WT);
  ffn_bf16_wgrad_kernel<<<dim3(tiles, 1, 2 * S), NT, kWgradSmem, st>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce(part_w, sc.part, dw1, dw2, db1, db2, dgamma, dbeta, F,
                ntiles, S, st);
}

}  // namespace bf
