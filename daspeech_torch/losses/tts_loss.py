"""FastSpeech 2 pretraining criterion (token -> mel, recipe stage 2),
PyTorch.

Counterpart of ``daspeech_tpu/losses/tts_loss.py::fastspeech2_criterion``
on the token-input path, without the CTC term (``ctc_weight`` is 0 in
every recipe; the model raises on anything else).
"""

from __future__ import annotations

from typing import Dict

import torch

from daspeech_torch.losses.dag_loss import device_generator
from daspeech_torch.losses.fastspeech2_loss import fastspeech2_losses
from daspeech_torch.models.layers import lengths_to_padding_mask


def fastspeech2_criterion(model, batch: Dict[str, torch.Tensor],
                          rng: torch.Generator, vocab, train: bool = True):
    """Criterion forward of one training pass (``tts_loss.py:20-69``):
    (loss, metrics).

    ``model`` is a token-input ``FastSpeech2Encoder``; ``batch`` holds
    device tensors src_tokens [B, T] (phonemes, padded), target_audio
    [B, M, 80], target_audio_lengths [B], durations / pitches / energies
    [B, T] and optionally sample_mask [B] (0 = a bucket-fill duplicate).
    ``rng`` is a host ``torch.Generator``; the dropout draws come from a
    device generator seeded by it (no device sync). ``train=False`` is the
    validation loss: an inference pass, without dropout."""
    tokens = batch["src_tokens"]
    mel_tgt = batch["target_audio"]
    M = mel_tgt.shape[1]
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng))
    mel, _, log_dur, pitch_out, energy_out = model(
        src_tokens=tokens, max_out_len=M, durations=batch["durations"],
        pitches=batch["pitches"], energies=batch["energies"],
        rng=device_generator(tokens.device, seed) if train else None)

    src_mask = tokens != vocab.pad
    mel_mask = ~lengths_to_padding_mask(batch["target_audio_lengths"], M)
    if "sample_mask" in batch:
        real = batch["sample_mask"].to(torch.bool)
        src_mask = src_mask & real[:, None]
        mel_mask = mel_mask & real[:, None]
    loss, metrics = fastspeech2_losses(
        mel, log_dur, pitch_out, energy_out, mel_tgt, batch["durations"],
        batch["pitches"], batch["energies"], src_mask, mel_mask)
    metrics["loss"] = loss.detach()
    return loss, metrics
