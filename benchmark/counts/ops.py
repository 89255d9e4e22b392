"""Operations and bytes of one call of the program's hand-written ops,
from the call's own arguments, and the least time the chip could take.

Products count 2·m·n·k over what the inputs need: attention over each row's
valid keys (the additive bias is 0 there), link scores over each graph's
forward pairs i < j < length. Every input tensor counts as read once and
the output as written once.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_THRESHOLD = -1e29      # the ops' additive bias marks padded keys -1e30


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def valid_keys(bias: torch.Tensor) -> torch.Tensor:
    """[B] keys each row attends: those with a bias above the padding mark
    (all of them when a row's keys are all masked)."""
    n = (bias > NEG_THRESHOLD).sum(dim=-1)
    return torch.where(n == 0, torch.full_like(n, bias.shape[-1]), n)


def attention_packed(q, k, v, bias, num_heads, *a, **kw) -> Tuple[int, int]:
    """``fused_attention_packed``: q [B, Tq, C], k and v [B, Tk, C]."""
    B, Tq, C = q.shape
    flops = 4 * Tq * C * int(valid_keys(bias).sum())
    return flops, _bytes(q, k, v, bias, q)


def attention_head_major(q, k, v, bias, *a, **kw) -> Tuple[int, int]:
    """``fused_attention``: q [B, H, Tq, d], k and v [B, H, Tk, d]."""
    B, H, Tq, d = q.shape
    flops = 4 * Tq * H * d * int(valid_keys(bias).sum())
    return flops, _bytes(q, k, v, bias, q)


def attention_relpos(q, k, v, a, e, bias, num_heads, *args,
                     **kw) -> Tuple[int, int]:
    """``fused_attention_relpos``: q, k, v [B, T, C], rotated position
    queries a [B, T, H·P] against the basis e [T, P]: content scores,
    position scores and the weighted sum over each row's valid keys."""
    B, T, C = q.shape
    per_key = 2 * C + 2 * a.shape[-1] + 2 * C
    flops = T * per_key * int(valid_keys(bias).sum())
    return flops, _bytes(q, k, v, a, e, bias, q)


def extract_links(q, k, log_gates, output_length, num_heads, *a,
                  **kw) -> Tuple[int, int]:
    """``fused_extract_links``: q and k [B, L, D]; scores over each graph's
    forward pairs; the output is [B, L, L] fp32."""
    B, L, D = q.shape
    n = output_length.long()
    pairs = int((n * (n - 1) // 2).sum())
    out = B * L * L * 4
    return 2 * pairs * D, _bytes(q, k, log_gates, output_length) + out


def bound_s(flops: int, nbytes: int, peak_flops: float,
            peak_bytes: float) -> float:
    """The least time: the larger of the compute and the memory bound."""
    return max(flops / peak_flops, nbytes / peak_bytes)
