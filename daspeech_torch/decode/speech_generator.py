"""In-generator vocoding (PyTorch): gcmvn denormalization, then HiFi-GAN.

Counterpart of the fused in-jit vocoding of
``daspeech_tpu/decode/generator.py:278-299``: the vocoder was trained on raw
(unnormalized) mels, so a gcmvn-normalized mel is denormalized before it is
vocoded. The chunked and int8 serving modes of
``daspeech_tpu/decode/speech_generator.py`` are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def gcmvn_stats(gcmvn, device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(mean, std) of a global CMVN (an object with ``mean`` and ``std``
    arrays over the 80 mel bins) as tensors on ``device``, or None."""
    if gcmvn is None:
        return None
    return (torch.as_tensor(gcmvn.mean, dtype=torch.float32, device=device),
            torch.as_tensor(gcmvn.std, dtype=torch.float32, device=device))


def vocode(vocoder, mel: torch.Tensor,
           stats: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """mel [B, M, 80] (gcmvn-normalized when ``stats``) -> wav [B, M*hop]."""
    if stats is not None:
        mel = mel * stats[1] + stats[0]
    return vocoder(mel)
