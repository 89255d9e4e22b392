// Register-tiled fp32 flash attention forward for Hopper (sm_90a) on the
// FMA pipes: the training forward (the call that writes the softmax
// statistics the backward reads) of the packed and head-major attention
// (fused_attention.cu, NC = 1), of the full-bias attention (the same file,
// NC = 1, FULL) and of the Conformer rel-pos attention (fused_relpos.cu,
// NC = 5), head depth 64.
//
// Why the FMA pipes and not the tensor cores: the tensor cores' fp32
// accumulation truncates (attention_tc.cuh, "Accumulation"), and a training
// forward's coherent error moves gradients that are sums over the whole
// batch past fp32's noise. fmaf rounds every step to nearest, as the plain
// version's products do, so this kernel is the same kind of arithmetic as
// the SIMT kernels it replaced; what changes is how the FMAs are fed.
//
// What bounds it on this card: the operations, at the FMA pipes' 67
// TFLOP/s. The SIMT kernel fed every FMA from one 4-byte shared-memory
// read and summed each score across four threads by shuffles; here each
// thread owns a 4-row x 4-key micro-tile of the 64 x 64 score tile and a
// 4-row x 4-channel micro-tile of the output, so 8 LDS.128 feed 64 FMAs in
// the score (4 channels of 4 query rows and of 4 keys) and 2 feed 16 in
// P·V, with no shuffle per key.
//
// Layout: one block per (64-query tile, head, batch row), 256 threads.
// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4 ty .. 4 ty + 3
// of the tile, keys tx + 16 u (u = 0..3) of each key tile, and output
// channels 4 tx .. 4 tx + 3. A row's 16 threads are one half-warp: the
// tile max and the final sum are 4 xor-shuffles per row.
//
// Shared memory (dynamic, pitch 68 floats: rows stay 16-byte aligned for
// cp.async, and reads of 16 consecutive rows at one column, or stores of a
// column of 16 consecutive rows, hit 32 distinct banks per 8 threads):
//   - the score side, streamed as NC chunk pairs of depth 64, (q, k) and
//     for the rel-pos attention four of (a, e) (columns 64 (c - 1) .. of a
//     and of e), two stages of [X chunk tile, Y chunk tile, 64 biases] by
//     cp.async, double-buffered: the next step's copy overlaps this step's
//     products; for NC = 5 the query side's chunks are re-read from L2 for
//     each key tile (resident, they would take 157 KB and one block an SM,
//     which measured slower: PERF.md), and e (stride 0 over b and h) stays
//     in L2. For NC = 1 the query tile is copied once and stays resident,
//     and a stage holds the key tile and the biases alone;
//   - V, one tile, copied at the first step of its key tile (its copy
//     overlaps the score);
//   - P∘Z, [64 keys][64 rows], key-major, so that P·V reads one float4 of
//     4 rows per key.
// 87.6 KB (NC = 1) or 105 KB (NC = 5): two blocks an SM.
//
// Key split: a grid a little over one wave of blocks (e.g. 272 blocks on
// 2 x 132 slots: 1040 queries x 4 heads x 4 rows) would take two waves for
// little more than one wave's work. The launcher then gives each query tile
// to nsplit blocks, each over a contiguous range of whole key tiles, that
// write their unnormalized output and (m, l) to a scratch buffer, and a
// second kernel merges them: m = max m_s, l = sum l_s exp(m_s - m),
// o = sum o_s exp(m_s - m) / l. It splits where its wave count times the
// longest range's share of the key tiles falls below 0.8 of the unsplit
// grid's wave count, and only past one wave (a grid of one wave stays as
// it is). The dropout bits depend on the key index alone, so they do not
// change with the split.
//
// Per key tile: the score s[r][u] sums its chunks in channel order with
// fmaf (chunk 0 first, so the rel-pos kernel with a = 0 computes #2's
// score to the bit), then s = s * scale + bias, -inf past Tk; the online
// softmax rescales the row's partial sum l (kept per thread, summed over
// the row at the end) and the output by exp(m - m_new) once per tile; P∘Z
// goes to shared memory and O += P∘Z · V.
//
// Full bias (FULL): the bias is bias4[b, h, i, j], a [query tile, key tile]
// block per tile. Two more 64 x 68 stages would take the block to ~122 KB
// and one block an SM, so each thread reads its 4 x 4 biases from device
// memory into registers at the top of the tile (keys tx + 16 u of a row:
// 16 consecutive floats across a half-warp), and they arrive under the
// score's FMAs; the stages stay as for NC = 1 and two blocks fit an SM.
//
// Dropout: the bits attention_tc.cuh's backward regenerates, word (j % 4)
// of philox4x32_10((j / 4, i, h, c3), (seed, 0)), seed = seeds[b] and
// c3 = 0, or for the full bias seeds[0] and c3 = b. The keys tx + 16 u of a
// thread lie in four different 4-key groups, and the four threads
// tx = 4 a .. 4 a + 3 need words 0..3 of the same four groups a + 4 u: thread
// 4 a + w draws group a + 4 w for its 4 rows (4 draws a tile, the least
// there can be), packs the 16 keep bits, and 3 shuffles among the four
// threads hand each its words.
//
// bf16 operands (attention.cuh, "Element type"): the tiles would be widened
// as they are loaded and the output rounded as it is stored, and written in
// fp32 too where args.o32 is set; but no entry point hands this kernel bf16
// operands (every bf16 training forward runs attention_bf16.cuh's or
// relpos_bf16.cuh's kernel), so only its fp32 path runs.
//
// Ragged tiles: keys past Tk are zero-filled by cp.async and get score
// -inf; query rows past Tq are zero-filled, give finite scores and are
// never stored. A fully padded row (bias -1e30 on every key) rounds every
// score to -1e30, so its max is -1e30 and its probabilities uniform, as in
// the plain version.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "philox.cuh"
#include "tiles.cuh"

namespace daspeech {
namespace fma {
// internal linkage: fused_attention.cu and fused_relpos.cu each include
// this header
namespace {

// the query side stays resident for one chunk (NC = 1), loaded once, and a
// stage holds the key side's tile alone; NC = 5 streams the query side's
// chunks beside the key side's. Floats of dynamic shared memory:
// [resident query tile] [2 stages] [V] [P∘Z]
template <int NC>
constexpr bool kQueryResident = NC == 1;
template <int NC>
constexpr int kStage = (kQueryResident<NC> ? 1 : 2) * kTile + kRows;
template <int NC>
constexpr int kSmemBytes =
    ((kQueryResident<NC> ? kTile : 0) + 2 * kStage<NC> + 2 * kTile) * 4;

// score chunk c's operands: X_c = q or columns 64 (c - 1) .. of a, and
// Y_c = k or the same columns of e
__device__ __forceinline__ Operand query_chunk(const AttnArgs& f, int c) {
  return c == 0 ? f.q : channels(f.a, 64 * (c - 1));
}

__device__ __forceinline__ Operand key_chunk(const AttnArgs& f, int c) {
  return c == 0 ? f.k : channels(f.e, 64 * (c - 1));
}

// step c of the key tile at j0 into stage st: score chunk c, that is the
// query side's X_c (unless it is resident) and the key side's Y_c; the
// column biases come with the last chunk (FULL: none, the kernel reads its
// bias block from device memory)
template <int NC, bool FULL>
__device__ __forceinline__ void load_step(float* st, const AttnArgs& f,
                                          int b, int h, int i0, int j0,
                                          int c) {
  constexpr bool res = kQueryResident<NC>;
  float* y = st + (res ? 0 : kTile);
  if (!res) load_tile(st, query_chunk(f, c), b, h, i0, f.Tq);
  load_tile(y, key_chunk(f, c), b, h, j0, f.Tk);
  if (!FULL && c == NC - 1 && threadIdx.x < kRows) {
    const int j = j0 + threadIdx.x;
    const bool ok = j < f.Tk;
    cp_async<4>(y + kTile + threadIdx.x,
                f.bias + b * f.bias_sb + (ok ? j : 0), ok);
  }
}

// nsplit = 1: o and the statistics to args.o and args.stats; else block x
// of the grid is (query tile x / nsplit, key range x % nsplit) and the
// unnormalized output and (m, l) go to part (see attn_fma_combine_kernel).
// FULL: the full-bias attention (NC = 1), its bias the [query tile, key
// tile] block of bias4 and its dropout keyed by seeds[0] with the batch row
// in the fourth counter word
template <int NC, bool FULL>
__global__ void __launch_bounds__(kThreads, 2)
attn_fma_fwd_kernel(const AttnArgs args, float* part, int nsplit) {
  static_assert(!FULL || NC == 1, "a full bias takes one score chunk");
  static_assert(kSmemBytes<NC> <= 113 * 1024, "two blocks an SM");
  extern __shared__ __align__(16) float smem[];
  constexpr bool res = kQueryResident<NC>;
  constexpr int kStageF = kStage<NC>;
  float* const stages = smem + (res ? kTile : 0);
  float* const Vs = stages + 2 * kStageF;
  float* const Ps = Vs + kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x / nsplit * kRows, split = blockIdx.x % nsplit;
  const bool drop = args.drop.seeds != nullptr;
  const uint32_t seed = drop ? args.drop.seeds[FULL ? 0 : b] : 0u;
  const uint32_t c3 = FULL ? static_cast<uint32_t>(b) : 0u;
  // FULL: this thread's rows of bias4[b, h] (rows past Tq read row 0)
  const float* bias_rows = nullptr;
  if constexpr (FULL) {
    bias_rows = args.bias4 + (static_cast<long long>(b) * args.H + h) *
                                 args.Tq * args.Tk;
  }
  // this block's key tiles t0 .. t1 - 1 (nsplit <= the tile count, so none
  // is empty)
  const int ntiles = (args.Tk + kRows - 1) / kRows;
  const int t0 = split * ntiles / nsplit;
  const int nsteps = ((split + 1) * ntiles / nsplit - t0) * NC;

  if (res) load_tile(smem, args.q, b, h, i0, args.Tq);
  load_step<NC, FULL>(stages, args, b, h, i0, t0 * kRows, 0);
  cp_async_commit();

  float s[4][4], o[4][4];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[r][e] = 0.f;
  }
  for (int st = 0; st < nsteps; ++st) {
    const int c = st % NC, j0 = (t0 + st / NC) * kRows;
    cp_async_wait_all();
    __syncthreads();
    // this key tile's V (its last reader, the previous tile's P·V, is
    // behind the barrier), then the next step's chunks: two groups, so
    // that NC = 1 can wait for V alone before P·V
    if (c == 0) load_tile(Vs, args.v, b, h, j0, args.Tk);
    cp_async_commit();
    if (st + 1 < nsteps) {
      const int nx = st + 1;
      load_step<NC, FULL>(stages + (nx & 1) * kStageF, args, b, h, i0,
                          (t0 + nx / NC) * kRows, nx % NC);
    }
    cp_async_commit();

    const float* stage = stages + (st & 1) * kStageF;
    const float* X = res ? smem : stage;
    const float* Y = stage + (res ? 0 : kTile);
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int u = 0; u < 4; ++u) s[r][u] = 0.f;
      }
    }
    // FULL: the thread's 4 x 4 biases straight into registers, issued
    // before the score so that the loads fly under its FMAs; keys
    // tx + 16 u of a row are 16 consecutive floats across a half-warp
    float fb[4][4] = {};
    if constexpr (FULL) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * ty + r;
        const float* row =
            bias_rows + static_cast<long long>(i < args.Tq ? i : 0) * args.Tk;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + tx + 16 * u;
          fb[r][u] = j < args.Tk ? __ldg(row + j) : 0.f;
        }
      }
    }
    score_chunk(s, X + 4 * ty * kPitch, Y + tx * kPitch);
    if (c != NC - 1) continue;

    // ---- online softmax over the tile's 64 keys
    const float* Bs = Y + kTile;
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int jj = tx + 16 * u;
      const bool ok = j0 + jj < args.Tk;
      const float col_bias = FULL ? 0.f : Bs[jj];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float bias = FULL ? fb[r][u] : col_bias;
        const float sc = ok ? s[r][u] * args.scale + bias : -INFINITY;
        s[r][u] = sc;
        mx[r] = fmaxf(mx[r], sc);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
      }
      // every tile holds a valid key, so the new max is finite
      const float m_new = fmaxf(m[r], mx[r]);
      const float corr = expf(m[r] - m_new);
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][e] *= corr;
      m[r] = m_new;
    }
    // keep bit 4 r + u: row 4 ty + r, key tx + 16 u
    uint32_t keep = 0u;
    if (drop) {
      const int w = tx & 3;
      uint32_t own = 0u;   // bit 4 r + v: word v of group (j0/4 + tx/4 + 4w)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint4 x = philox4x32_10(
            make_uint4((j0 >> 2) + (tx >> 2) + 4 * w, i0 + 4 * ty + r, h,
                       c3),
            seed, 0u);
        const uint32_t t = args.drop.thresh;
        own |= (static_cast<uint32_t>(x.x <= t) |
                (static_cast<uint32_t>(x.y <= t) << 1) |
                (static_cast<uint32_t>(x.z <= t) << 2) |
                (static_cast<uint32_t>(x.w <= t) << 3))
               << (4 * r);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // thread 4 (tx / 4) + u drew group j0/4 + tx/4 + 4u; take word w
        const uint32_t g =
            __shfl_sync(0xffffffffu, own, (lane & ~3) | u) >> w;
        keep |= (g & 0x1111u) << u;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = expf(s[r][u] - m[r]);
        l[r] += p;
        s[r][u] = !drop                         ? p
                  : (keep >> (4 * r + u)) & 1u ? p * args.drop.scale
                                               : 0.f;
      }
    }
    // ---- P∘Z to shared memory (key-major), then O += P∘Z · V
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      *reinterpret_cast<float4*>(Ps + (tx + 16 * u) * kPitch + 4 * ty) =
          make_float4(s[0][u], s[1][u], s[2][u], s[3][u]);
    }
    if (NC == 1) cp_async_wait<1>();   // V; the next key tile may fly on
    __syncthreads();
    const float* P = Ps + 4 * ty;
    const float* V = Vs + 4 * tx;
#pragma unroll 16
    for (int j = 0; j < kRows; ++j) {
      const float4 p = lds4(P + j * kPitch);
      const float4 v = lds4(V + j * kPitch);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        o[r][0] = fmaf(pr[r], v.x, o[r][0]);
        o[r][1] = fmaf(pr[r], v.y, o[r][1]);
        o[r][2] = fmaf(pr[r], v.z, o[r][2]);
        o[r][3] = fmaf(pr[r], v.w, o[r][3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    }
    const int i = i0 + 4 * ty + r;
    if (i >= args.Tq) continue;
    if (nsplit > 1) {
      const long long rows = static_cast<long long>(gridDim.z) * args.H *
                             args.Tq;
      const long long row =
          split * rows + (static_cast<long long>(b) * args.H + h) * args.Tq +
          i;
      *reinterpret_cast<float4*>(part + row * 64 + 4 * tx) =
          make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
      if (tx == 0) {
        float* ml = part + nsplit * rows * 64 + 2 * row;
        ml[0] = m[r];
        ml[1] = l[r];
      }
      continue;
    }
    const float inv = 1.f / l[r];
    const float4 out = make_float4(o[r][0] * inv, o[r][1] * inv,
                                   o[r][2] * inv, o[r][3] * inv);
    st4(args.o, b, i, h, 4 * tx, out);
    if (args.o32.ptr != nullptr) st4(args.o32, b, i, h, 4 * tx, out);
    if (args.stats != nullptr && tx == 0) {
      float* st = args.stats +
                  2 * ((static_cast<long long>(b) * args.H + h) * args.Tq + i);
      st[0] = m[r];
      st[1] = l[r];
    }
  }
}

// merges the nsplit key ranges' partial rows of attn_fma_fwd_kernel: one
// thread per (row, 4 output channels)
__global__ void attn_fma_combine_kernel(const AttnArgs args,
                                        const float* part, int nsplit,
                                        long long rows) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows * 16) return;
  const long long row = idx >> 4;
  const int g = static_cast<int>(idx & 15);
  const int i = static_cast<int>(row % args.Tq);
  const int h = static_cast<int>(row / args.Tq % args.H);
  const int b = static_cast<int>(row / args.Tq / args.H);
  const float* ml = part + nsplit * rows * 64;
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, ml[2 * (s * rows + row)]);
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nsplit; ++s) {
    const long long r = s * rows + row;
    const float w = expf(ml[2 * r] - m);
    l = fmaf(ml[2 * r + 1], w, l);
    const float4 x = *reinterpret_cast<const float4*>(part + r * 64 + 4 * g);
    o.x = fmaf(x.x, w, o.x);
    o.y = fmaf(x.y, w, o.y);
    o.z = fmaf(x.z, w, o.z);
    o.w = fmaf(x.w, w, o.w);
  }
  const float inv = 1.f / l;
  const float4 out = make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
  st4(args.o, b, i, h, 4 * g, out);
  if (args.o32.ptr != nullptr) st4(args.o32, b, i, h, 4 * g, out);
  if (args.stats != nullptr && g == 0) {
    float* st = args.stats + 2 * row;
    st[0] = m;
    st[1] = l;
  }
}

// the split's scratch: a pool of its own that keeps what it has taken
// (a few MB at the shapes that split) instead of releasing it at every
// synchronization, which made each call map it anew
inline cudaMemPool_t scratch_pool() {
  static cudaMemPool_t pool = nullptr;
  if (pool != nullptr) return pool;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return nullptr;
  cudaMemPoolProps props = {};
  props.allocType = cudaMemAllocationTypePinned;
  props.location.type = cudaMemLocationTypeDevice;
  props.location.id = dev;
  cudaMemPool_t made = nullptr;
  if (cudaMemPoolCreate(&made, &props) != cudaSuccess) return nullptr;
  uint64_t keep = UINT64_MAX;
  if (cudaMemPoolSetAttribute(made, cudaMemPoolAttrReleaseThreshold,
                              &keep) != cudaSuccess) {
    return nullptr;
  }
  return pool = made;
}

// the key split for a grid of `blocks` query tiles over `ntiles` key tiles
// ("Key split" above): 1 .. 4
inline int pick_split(long long blocks, int ntiles) {
  static int slots = 0;
  if (slots == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      return 1;
    }
    slots = 2 * sms;
  }
  const auto cost = [&](int s) {
    return static_cast<double>((blocks * s + slots - 1) / slots) *
           ((ntiles + s - 1) / s) / ntiles;
  };
  int best = 1;
  if (blocks <= slots) return best;
  for (int s = 2; s <= 4 && s <= ntiles; ++s) {
    if (cost(s) < 0.8 * cost(1) && cost(s) < cost(best)) best = s;
  }
  return best;
}

template <int NC, bool FULL = false>
inline cudaError_t launch_attn_fma_fwd(const AttnArgs& args, int B,
                                       cudaStream_t stream) {
  constexpr int smem = kSmemBytes<NC>;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fma_fwd_kernel<NC, FULL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int qtiles = (args.Tq + kRows - 1) / kRows;
  const int nsplit = pick_split(static_cast<long long>(qtiles) * args.H * B,
                                (args.Tk + kRows - 1) / kRows);
  const long long rows = static_cast<long long>(B) * args.H * args.Tq;
  float* part = nullptr;
  if (nsplit > 1) {
    const cudaMemPool_t pool = scratch_pool();
    if (pool == nullptr) return cudaErrorMemoryAllocation;
    err = cudaMallocFromPoolAsync(reinterpret_cast<void**>(&part),
                                  nsplit * rows * 66 * sizeof(float), pool,
                                  stream);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(qtiles * nsplit, args.H, B);
  attn_fma_fwd_kernel<NC, FULL><<<grid, kThreads, smem, stream>>>(
      args, part, nsplit);
  err = cudaGetLastError();
  if (nsplit > 1) {
    if (err == cudaSuccess) {
      attn_fma_combine_kernel<<<static_cast<unsigned>((rows * 16 + 255) /
                                                      256),
                                256, 0, stream>>>(args, part, nsplit, rows);
      err = cudaGetLastError();
    }
    const cudaError_t freed = cudaFreeAsync(part, stream);
    if (err == cudaSuccess) err = freed;
  }
  return err;
}

}  // namespace
}  // namespace fma
}  // namespace daspeech
