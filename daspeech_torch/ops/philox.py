"""Philox4x32-10 in torch integer ops: the attention dropout bits.

The same function as ``daspeech_torch/csrc/philox.cuh``, so the plain
versions of the attention kernels drop exactly the elements the CUDA
kernels drop. Words are uint32 values held in int64 tensors; the 32x32-bit
products are split into 16-bit halves so that no intermediate leaves int64.

An element in column j is kept when word ``j % 4`` of
``philox((j // 4, c1, c2, c3), (key, 0))`` is at most
``int(keep_p * (2**32 - 1))`` (the Pallas kernels' threshold), and then
scaled by ``1 / keep_p``. The counters and key of each kernel's streams:

- attention probability (i, j) of head h in batch row b (packed, head-major
  and rel-pos kernels): counters (j // 4, i, h, 0), key seed[b]; a call on
  heads h0 .. h0 + H - 1 of a layer (a tensor-parallel rank's) counts its
  local head h as h0 + h, so that it draws those heads' masks;
- the full-bias attention (one scalar seed, as ``fused_attention.py:589``
  keys by the program b·H + h): counters (j // 4, i, h, b), key seed;
- the Conformer FFN's two sites, element (t, j) of batch row b: counters
  (j // 4, t, 0, site), key seed[b], site 1 after the swish ([T, F]) and
  site 2 after the second product ([T, C]).
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


def _keep(k0, c1, c2, c3, n: int, dropout_p: float) -> torch.Tensor:
    """Float multipliers ``keep / keep_p`` of ``n`` columns: column j takes
    word j % 4 of ``philox((j // 4, c1, c2, c3), (k0, 0))``. ``k0`` and the
    counters are int64 tensors (or ints) that broadcast together over the
    leading dimensions, each with a trailing dimension of 1."""
    dev = k0.device
    c0 = torch.arange((n + 3) // 4, dtype=torch.int64, device=dev)
    words = philox4x32_10(c0, c1, c2, c3, k0, 0)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(*bits.shape[:-2], -1)[..., :n]
    # the kernels' f32 scale: 1 / keep_p rounded once, as a python float
    return ((bits <= keep_threshold(dropout_p)).to(torch.float32)
            * (1.0 / (1.0 - dropout_p)))


def _ar(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=dev)


def _key(seeds: torch.Tensor) -> torch.Tensor:
    return seeds.to(torch.int64) & MASK32


def attention_keep(seeds: torch.Tensor, num_heads: int, Tq: int, Tk: int,
                   dropout_p: float, head0: int = 0) -> torch.Tensor:
    """[B, H, Tq, Tk] float multipliers ``keep / keep_p`` (0 where dropped)
    of the attention probabilities of heads ``head0`` .. ``head0 + H - 1``,
    from per-row int32 ``seeds`` [B]."""
    dev = seeds.device
    return _keep(_key(seeds)[:, None, None, None],
                 _ar(Tq, dev)[None, None, :, None],
                 _ar(num_heads, dev)[None, :, None, None] + head0, 0, Tk,
                 dropout_p)


def full_bias_keep(seed: torch.Tensor, B: int, num_heads: int, Tq: int,
                   Tk: int, dropout_p: float) -> torch.Tensor:
    """[B, H, Tq, Tk] multipliers of the full-bias attention's
    probabilities, from one int32 ``seed`` (a tensor of one element)."""
    dev = seed.device
    return _keep(_key(seed.reshape(())),
                 _ar(Tq, dev)[None, None, :, None],
                 _ar(num_heads, dev)[None, :, None, None],
                 _ar(B, dev)[:, None, None, None], Tk, dropout_p)


def ffn_keep(seeds: torch.Tensor, T: int, width: int, site: int,
             dropout_p: float) -> torch.Tensor:
    """[B, T, width] multipliers of the Conformer FFN's dropout ``site``
    (1: after the swish, width F; 2: after the second product, width C),
    from per-row int32 ``seeds`` [B]."""
    dev = seeds.device
    return _keep(_key(seeds)[:, None, None], _ar(T, dev)[None, :, None], 0,
                 site, width, dropout_p)
