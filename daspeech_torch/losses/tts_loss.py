"""The TTS-side criteria (PyTorch): FastSpeech 2 pretraining (token -> mel,
recipe stage 2) with its optional CTC term, and the two AR baselines'
teacher-forced losses (Transformer-TTS and the two-pass multi-decoder
S2ST).

Counterpart of ``daspeech_tpu/losses/tts_loss.py``. Each criterion takes a
host ``torch.Generator``; a training pass draws its dropout from a device
generator seeded by it (no device sync). Under a data-parallel step the
denominators are counted over every rank (``parallel.multihost``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from daspeech_torch.losses.dag_loss import device_generator
from daspeech_torch.losses.fastspeech2_loss import fastspeech2_losses
from daspeech_torch.models.layers import lengths_to_padding_mask
from daspeech_torch.parallel.multihost import global_sum


def _pass_rng(rng: torch.Generator, device, train: bool):
    """The device generator of a training pass, None for validation."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng))
    return device_generator(device, seed) if train else None


def fastspeech2_criterion(model, batch: Dict[str, torch.Tensor],
                          rng: torch.Generator, vocab, train: bool = True):
    """Criterion forward of one training pass (``tts_loss.py:20-69``):
    (loss, metrics).

    ``model`` is a token-input ``FastSpeech2Encoder``; ``batch`` holds
    device tensors src_tokens [B, T] (phonemes, padded), target_audio
    [B, M, 80], target_audio_lengths [B], durations / pitches / energies
    [B, T] and optionally speaker [B] and sample_mask [B] (0 = a
    bucket-fill duplicate). With ``cfg.ctc_weight`` > 0 the CTC term of
    :func:`fastspeech2_ctc_loss`, weighted, joins the loss. ``train=False``
    is the validation loss: an inference pass, without dropout."""
    tokens = batch["src_tokens"]
    mel_tgt = batch["target_audio"]
    M = mel_tgt.shape[1]
    out = model(src_tokens=tokens, max_out_len=M,
                durations=batch["durations"], pitches=batch["pitches"],
                energies=batch["energies"], speaker=batch.get("speaker"),
                rng=_pass_rng(rng, tokens.device, train))
    mel, mel_post, _, log_dur, pitch_out, energy_out = out[:6]

    src_mask = tokens != vocab.pad
    mel_mask = ~lengths_to_padding_mask(batch["target_audio_lengths"], M)
    if "sample_mask" in batch:
        real = batch["sample_mask"].to(torch.bool)
        src_mask = src_mask & real[:, None]
        mel_mask = mel_mask & real[:, None]
    loss, metrics = fastspeech2_losses(
        mel, mel_post, log_dur, pitch_out, energy_out, mel_tgt,
        batch["durations"], batch["pitches"], batch["energies"], src_mask,
        mel_mask)
    ctc_weight = float(model.cfg.ctc_weight)
    if ctc_weight > 0.0:
        ctc = ctc_weight * fastspeech2_ctc_loss(out[6], mel_mask, tokens,
                                                src_mask)
        metrics["ctc-loss"] = ctc.detach()
        loss = loss + ctc
    metrics["loss"] = loss.detach()
    return loss, metrics


def fastspeech2_ctc_loss(ctc_logits: torch.Tensor, mel_mask: torch.Tensor,
                         src_tokens: torch.Tensor,
                         src_mask: torch.Tensor) -> torch.Tensor:
    """The CTC term of ``FastSpeech2Loss`` (``tts_loss.py:72-106``): the
    pre-Postnet frames' logits [B, M, V] over the valid frames
    (``mel_mask``, a prefix) against the phonemes where ``src_mask`` (a
    prefix), blank 0. Each sentence's loss is divided by its label length;
    a sentence without an alignment (fewer frames than labels plus
    adjacent repeats, JAX's own test) counts 0; rows with no label at all
    (``sample_mask`` fillers) are left out of the mean."""
    logp = F.log_softmax(ctc_logits.float(), dim=-1).transpose(0, 1)
    in_lens = mel_mask.sum(dim=1)
    label_lens = src_mask.sum(dim=1)
    per_ex = F.ctc_loss(logp, src_tokens.long(), in_lens, label_lens,
                        blank=0, reduction="none", zero_infinity=True)
    adj_rep = ((src_tokens[:, 1:] == src_tokens[:, :-1]) & src_mask[:, 1:]
               & src_mask[:, :-1]).sum(dim=1)
    feasible = in_lens >= label_lens + adj_rep
    real = src_mask.any(dim=1)
    keep = feasible & real & torch.isfinite(per_ex)
    per_ex = torch.where(keep, per_ex / label_lens.clamp(min=1),
                         torch.zeros_like(per_ex))
    return per_ex.sum() / global_sum(real.sum().float()).clamp(min=1.0)


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor
                ) -> torch.Tensor:
    """``optax_sigmoid_bce`` (``tts_loss.py:213-216``): the binary
    cross-entropy of sigmoid(logits) against ``targets``, elementwise."""
    return -(targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def _mel_and_stop(mel, stop, mel_tgt, lens, valid):
    """The teacher-forced mel L1 and the stop BCE (target 1 at frame
    lens - 1) over the ``valid`` frames [B, M]."""
    D = mel_tgt.shape[2]
    w = valid.to(torch.float32)
    l1 = ((mel - mel_tgt).abs() * w[:, :, None]).sum() / (
        global_sum(w.sum()) * D).clamp(min=1.0)
    M = mel_tgt.shape[1]
    stop_tgt = (torch.arange(M, device=lens.device)[None, :]
                == (lens - 1)[:, None]).to(torch.float32)
    stop_loss = (sigmoid_bce(stop, stop_tgt) * w).sum() / global_sum(
        w.sum()).clamp(min=1.0)
    return l1, stop_loss


def _shifted_mel(mel_tgt: torch.Tensor) -> torch.Tensor:
    """The teacher-forcing input: a zero 'go' frame, then the target
    frames but the last."""
    return torch.cat([torch.zeros_like(mel_tgt[:, :1]), mel_tgt[:, :-1]],
                     dim=1)


def tts_transformer_criterion(model, batch: Dict[str, torch.Tensor],
                              rng: torch.Generator, vocab,
                              stop_weight: float = 1.0, train: bool = True):
    """The AR Transformer-TTS loss (``tts_loss.py:109-144``): teacher-forced
    L1 on the mel plus ``stop_weight`` times the stop BCE; (loss, metrics).
    ``batch``: src_tokens [B, T], target_audio [B, M, 80],
    target_audio_lengths [B][, sample_mask]."""
    tokens = batch["src_tokens"]
    mel_tgt = batch["target_audio"]
    lens = batch["target_audio_lengths"]
    M = mel_tgt.shape[1]
    mel, stop = model(tokens, _shifted_mel(mel_tgt),
                      rng=_pass_rng(rng, tokens.device, train))
    valid = ~lengths_to_padding_mask(lens, M)
    if "sample_mask" in batch:
        valid = valid & batch["sample_mask"].to(torch.bool)[:, None]
    l1, stop_loss = _mel_and_stop(mel, stop, mel_tgt, lens, valid)
    loss = l1 + stop_weight * stop_loss
    return loss, {"loss": loss.detach(), "l1-loss": l1.detach(),
                  "stop-loss": stop_loss.detach()}


def multidecoder_criterion(model, batch: Dict[str, torch.Tensor],
                           rng: torch.Generator, vocab,
                           mt_loss_weight: float = 1.0,
                           stop_weight: float = 1.0, train: bool = True):
    """The two-pass AR S2ST loss (``tts_loss.py:147-210``): cross-entropy
    of the text pass, teacher-forced on the ``<eos>``-prefixed target,
    plus the mel pass's L1 and ``stop_weight`` times its stop BCE;
    (loss, metrics). ``batch``: fbank, src_lengths, target_text [B, T]
    (``<bos>`` .. ``<eos>``), target_audio [B, M, 80],
    target_audio_lengths[, sample_mask]. A training pass moves the
    Conformer's BatchNorm statistics in place."""
    tgt = batch["target_text"]
    mel_tgt = batch["target_audio"]
    lens = batch["target_audio_lengths"]
    M = mel_tgt.shape[1]
    prev_tokens = torch.cat([torch.full_like(tgt[:, :1], vocab.eos),
                             tgt[:, :-1]], dim=1)
    logits, mel, stop = model(batch["fbank"], batch["src_lengths"],
                              prev_tokens, _shifted_mel(mel_tgt),
                              rng=_pass_rng(rng, tgt.device, train))
    text_valid = tgt != vocab.pad
    mel_valid = ~lengths_to_padding_mask(lens, M)
    if "sample_mask" in batch:
        real = batch["sample_mask"].to(torch.bool)
        text_valid = text_valid & real[:, None]
        mel_valid = mel_valid & real[:, None]
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, tgt.long()[..., None])[..., 0]
    tw = text_valid.to(torch.float32)
    mt_loss = (ce * tw).sum() / global_sum(tw.sum()).clamp(min=1.0)
    l1, stop_loss = _mel_and_stop(mel, stop, mel_tgt, lens, mel_valid)
    loss = mt_loss_weight * mt_loss + l1 + stop_weight * stop_loss
    return loss, {"loss": loss.detach(), "mt-loss": mt_loss.detach(),
                  "l1-loss": l1.detach(), "stop-loss": stop_loss.detach()}
