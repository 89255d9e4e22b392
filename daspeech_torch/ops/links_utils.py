"""Banded <-> full transition-matrix conversions (PyTorch).

Counterpart of ``daspeech_tpu/ops/links_utils.py``. The banded layout is
the reference CUDA kernels' ``band[b, i, d] = log P(v_i -> v_{i+d+1})``
(``DASpeech/custom_ops/dag_loss.py:89-91``), d < W; the full layout is the
strictly-upper-triangular [B, L, L] matrix of ``ops/dag_ref.py``. Entries
outside the band (or past the graph's end) are -inf in both.
"""

from __future__ import annotations

import torch


def band_to_full(links_band: torch.Tensor) -> torch.Tensor:
    """[B, L, W] banded -> [B, L, L] full: ``full[b, i, i + d + 1] =
    band[b, i, d]``, -inf elsewhere (``links_utils.py:16-34``)."""
    B, L, W = links_band.shape
    dev = links_band.device
    dd = (torch.arange(L, device=dev)[None, :]
          - torch.arange(L, device=dev)[:, None] - 1)          # [L, L]
    in_band = (dd >= 0) & (dd < W)
    idx = torch.where(in_band, dd, 0).expand(B, L, L)
    gathered = links_band.gather(2, idx)
    return torch.where(in_band[None], gathered,
                       torch.full_like(gathered, -torch.inf))


def full_to_band(links_full: torch.Tensor, width: int) -> torch.Tensor:
    """[B, L, L] full -> [B, L, W] banded, W = min(width, L - 1):
    ``band[b, i, d] = full[b, i, i + d + 1]``, -inf where i + d + 1 >= L
    (``links_utils.py:37-50``)."""
    B, L, _ = links_full.shape
    W = min(width, L - 1)
    dev = links_full.device
    tgt = (torch.arange(L, device=dev)[:, None]
           + torch.arange(W, device=dev)[None, :] + 1)          # [L, W]
    valid = tgt < L
    band = links_full.gather(2, torch.where(valid, tgt, 0).expand(B, L, W))
    return torch.where(valid[None], band, torch.full_like(band, -torch.inf))
