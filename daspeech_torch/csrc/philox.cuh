// Counter-based random bits for the attention kernels' dropout.
//
// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011): a keyed bijection of a 128-bit counter, so any thread can
// draw the bits of any element without state, and a backward kernel
// regenerates the forward's mask exactly. The same function is written in
// torch integer ops in ``daspeech_torch/ops/philox.py``; the plain versions
// of the kernels draw their masks from it, so kernel and plain version
// drop the same elements.
//
// Attention probability (i, j) of head h in batch row b is kept when
//   word (j % 4) of philox4x32_10((j / 4, i, h, 0), (seed[b], 0)) <= thresh
// with thresh = int(keep_p * (2^32 - 1)), and then scaled by 1 / keep_p,
// as the Pallas kernels keep bits <= keep_p * (2^32 - 1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace daspeech {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t philox_word(const uint4& r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

}  // namespace daspeech
