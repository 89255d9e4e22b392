"""Philox4x32-10 in torch integer ops: the attention dropout bits.

The same function as ``daspeech_torch/csrc/philox.cuh``, so the plain
versions of the attention kernels drop exactly the elements the CUDA
kernels drop. Words are uint32 values held in int64 tensors; the 32x32-bit
products are split into 16-bit halves so that no intermediate leaves int64.

Attention probability (i, j) of head h in batch row b is kept when word
``j % 4`` of ``philox((j // 4, i, h, 0), (seed[b], 0))`` is at most
``int(keep_p * (2**32 - 1))`` (the Pallas kernels' threshold), and then
scaled by ``1 / keep_p``.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of constant ``a`` and
    ``b`` (uint32 values in int64)."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    t = (a_hi * b_lo + a_lo * b_hi) * 65536 + a_lo * b_lo    # < 2**50
    return a_hi * b_hi + (t >> 32), t & MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """The four output words for counters ``(c0, c1, c2, c3)`` and key
    ``(k0, k1)``: int64 tensors (or ints) of uint32 values, broadcast
    together."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(dropout_p: float) -> int:
    """Bits at or below this are kept (``fused_attention.py:317``)."""
    return int((1.0 - dropout_p) * (2 ** 32 - 1))


def attention_keep(seeds: torch.Tensor, num_heads: int, Tq: int, Tk: int,
                   dropout_p: float) -> torch.Tensor:
    """[B, H, Tq, Tk] float multipliers ``keep / keep_p`` (0 where dropped)
    of the attention probabilities, from per-row int32 ``seeds`` [B]."""
    dev = seeds.device
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa: E731
    k0 = (seeds.to(torch.int64) & MASK32)[:, None, None, None]
    words = philox4x32_10(ar((Tk + 3) // 4)[None, None, None, :],
                          ar(Tq)[None, None, :, None],
                          ar(num_heads)[None, :, None, None], 0, k0, 0)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(*bits.shape[:3], -1)[..., :Tk]
    # the kernels' f32 scale: 1 / keep_p rounded once, as a python float
    return ((bits <= keep_threshold(dropout_p)).to(torch.float32)
            * (1.0 / (1.0 - dropout_p)))
