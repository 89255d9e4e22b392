"""FastSpeech 2 training loss (PyTorch).

Counterpart of ``daspeech_tpu/losses/fastspeech2_loss.py``: L1(mel) +
MSE(log duration) + MSE(pitch) + MSE(energy), each averaged over the valid
(unpadded) positions. The Postnet is not ported, so there is no postnet L1
term. Under a data-parallel step the positions are counted over every rank
(``parallel.multihost.global_sum``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from daspeech_torch.parallel.multihost import global_sum


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the positions where mask is True (mask broadcast over
    trailing dims); 0 when none is (``fastspeech2_loss.py:16-22``). Inside
    ``multihost.data_parallel`` the count is the group's: the mean is this
    rank's share of the global batch's."""
    while mask.dim() < x.dim():
        mask = mask[..., None]
    w = mask.expand(x.shape).to(torch.float32)
    return (x * w).sum() / global_sum(w.sum()).clamp(min=1.0)


def fastspeech2_losses(mel_out: torch.Tensor, log_dur_out: torch.Tensor,
                       pitch_out: torch.Tensor, energy_out: torch.Tensor,
                       mel_tgt: torch.Tensor, durations: torch.Tensor,
                       pitches: torch.Tensor, energies: torch.Tensor,
                       src_mask: torch.Tensor, mel_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``fastspeech2_losses`` (``fastspeech2_loss.py:25-56``) without the
    postnet term: mel [B, M, 80] against ``mel_tgt`` where ``mel_mask``
    [B, M], the predictors [B, T] against the gold durations (as
    log(d + 1)), pitches and energies where ``src_mask`` [B, T]."""
    l1 = masked_mean((mel_out - mel_tgt).abs(), mel_mask)
    log_dur_tgt = torch.log(durations.to(torch.float32) + 1.0)
    dur_loss = masked_mean(torch.square(log_dur_out - log_dur_tgt), src_mask)
    pitch_loss = masked_mean(torch.square(pitch_out - pitches), src_mask)
    energy_loss = masked_mean(torch.square(energy_out - energies), src_mask)
    total = l1 + dur_loss + pitch_loss + energy_loss
    return total, {"tts-loss": total.detach(), "l1-loss": l1.detach(),
                   "dur-loss": dur_loss.detach(),
                   "pitch-loss": pitch_loss.detach(),
                   "energy-loss": energy_loss.detach()}
