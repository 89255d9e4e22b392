"""HiFi-GAN vocoder training (PyTorch): the generator against the MPD/MSD
discriminators.

Counterpart of ``daspeech_tpu/train/vocoder_train.py``: alternating D and G
updates with AdamW (b1 0.8, b2 0.99), LSGAN losses, feature matching and the
L1 log-mel loss x 45, on waveform segments the caller crops (8192 samples
in config_v1). The D
update runs against the detached generator output, with each
sub-discriminator called once on the real and generated waveforms together
(``pair_batch_d``); the G update runs against the updated discriminators,
one call each (``pair_batch``), with the discriminators' parameters frozen.
The generator trains through ``HiFiGANGenerator(fused_mrf=False)``: the MRF
kernel is inference-only.

Also here: the differentiable log-mel of the mel loss (:func:`make_mel_fn`,
the JAX training CLI's ``mel_fn``,
``daspeech_tpu/cli/train_vocoder.py:86-101``) and its Slaney mel basis
(:func:`slaney_mel`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from daspeech_torch import convert
from daspeech_torch.models.hifigan import HiFiGANGenerator
from daspeech_torch.models.layers import set_dtype
from daspeech_torch.models.hifigan_discriminators import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
)


class VocoderAdamW(torch.optim.AdamW):
    """AdamW whose learning rate decays continuously,
    ``lr * lr_decay ** (count / 1000)`` with ``count`` the steps taken
    before this one: optax's ``exponential_decay(lr, 1000, lr_decay)``
    evaluated at the pre-increment count, as ``optax.adamw`` does."""

    def __init__(self, params, lr: float = 2e-4, b1: float = 0.8,
                 b2: float = 0.99, lr_decay: float = 0.999):
        super().__init__(params, lr=lr, betas=(b1, b2), eps=1e-8,
                         weight_decay=0.0)
        self.base_lr, self.lr_decay, self.count = lr, lr_decay, 0

    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = self.base_lr * self.lr_decay ** (self.count / 1000)
        loss = super().step(closure)
        self.count += 1
        return loss


def make_vocoder_optimizer(params, lr: float = 2e-4, b1: float = 0.8,
                           b2: float = 0.99, lr_decay: float = 0.999
                           ) -> VocoderAdamW:
    """The vocoder's optimizer (``vocoder_train.py:51-58``): AdamW, eps
    1e-8, no weight decay, exponential lr decay per 1000 steps."""
    return VocoderAdamW(params, lr, b1, b2, lr_decay)


@dataclass
class VocoderTrainState:
    step: int                          # G updates taken
    gen: HiFiGANGenerator
    disc: Dict[str, nn.Module]         # {"mpd": ..., "msd": ...}
    gen_opt: VocoderAdamW
    disc_opt: VocoderAdamW


def init_flax_style_(module: nn.Module, g: torch.Generator) -> nn.Module:
    """The JAX modules' initialisation, drawn from ``g``: each conv's
    weight from flax's default ``lecun_normal`` (a normal of variance
    1 / fan_in truncated at two standard deviations), each transposed
    conv's N(0, 0.01) (``ConvTranspose1dTorch``), biases 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.ConvTranspose1d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * 0.01)
            elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                # the std of a unit normal truncated to [-2, 2]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
            else:
                continue
            m.bias.zero_()
    return module


def _requires_grad_(modules, flag: bool):
    for m in modules:
        m.requires_grad_(flag)


class VocoderTrainer:
    """``VocoderTrainer`` (``vocoder_train.py:61-198``) on ``device``.

    ``mel_fn`` maps a waveform [B, T] to a mel [B, frames, num_mels]
    (:func:`make_mel_fn` for the real loss); without it the mel loss is 0.
    ``disc_dtype`` (float32 or bfloat16) is the discriminators' compute
    dtype (their parameters, Adam and the loss means stay fp32,
    ``vocoder_train.py:64-86``). ``gen_fold`` (TPU lane folding) is not
    ported and raises."""

    def __init__(self, cfg, mel_fn: Optional[Callable] = None,
                 mel_loss_weight: float = 45.0,
                 gen_fold: int = 0, disc_dtype=torch.float32,
                 pair_batch: bool = False, pair_batch_d: bool = True,
                 device="cuda"):
        if gen_fold > 0:
            raise NotImplementedError("gen_fold is TPU lane folding; the "
                                      "port trains the plain generator")
        self.cfg = cfg
        self.disc_dtype = disc_dtype
        self.mel_fn = mel_fn
        self.mel_loss_weight = mel_loss_weight
        self.pair_batch = pair_batch
        self.pair_batch_d = pair_batch or pair_batch_d
        self.device = torch.device(device)

    def _state(self, gen: nn.Module, disc: Dict[str, nn.Module]
               ) -> VocoderTrainState:
        gen = gen.to(self.device).train()
        disc = {k: set_dtype(m, self.disc_dtype).to(self.device).train()
                for k, m in disc.items()}
        return VocoderTrainState(
            step=0, gen=gen, disc=disc,
            gen_opt=make_vocoder_optimizer(gen.parameters()),
            disc_opt=make_vocoder_optimizer(
                [p for k in ("mpd", "msd") for p in disc[k].parameters()]))

    def init_state(self, g: torch.Generator) -> VocoderTrainState:
        """A fresh state: generator and discriminators initialised as the
        JAX modules are (:func:`init_flax_style_`), drawn from the CPU
        generator ``g``."""
        gen = init_flax_style_(HiFiGANGenerator(self.cfg), g)
        disc = {"mpd": init_flax_style_(MultiPeriodDiscriminator(), g),
                "msd": init_flax_style_(MultiScaleDiscriminator(), g)}
        return self._state(gen, disc)

    def state_from_flax(self, gen_variables, disc_variables
                        ) -> VocoderTrainState:
        """A fresh state (optimizers at step 0) from the JAX trainer's
        ``gen_params`` and ``disc_params`` trees, through ``convert``."""
        gen = convert.vocoder_from_flax(gen_variables, self.cfg,
                                        device=self.device)
        disc = convert.discriminators_from_flax(disc_variables,
                                                device=self.device)
        return self._state(gen, disc)

    # ---- the two halves of the alternating update -----------------------

    def d_update(self, state: VocoderTrainState, mel: torch.Tensor,
                 wav: torch.Tensor) -> Tuple[VocoderTrainState, torch.Tensor]:
        """Discriminator update against the detached generator output
        (``vocoder_train.py:118-144``)."""
        with torch.no_grad():
            y_hat = state.gen(mel)
        mpd, msd = state.disc["mpd"], state.disc["msd"]
        rs_p, gs_p, _, _ = mpd(wav, y_hat, pair_batch=self.pair_batch_d)
        rs_s, gs_s, _, _ = msd(wav, y_hat, pair_batch=self.pair_batch_d)
        loss = discriminator_loss(rs_p, gs_p) + discriminator_loss(rs_s,
                                                                   gs_s)
        state.disc_opt.zero_grad(set_to_none=True)
        loss.backward()
        state.disc_opt.step()
        return state, loss.detach()

    def g_update(self, state: VocoderTrainState, mel: torch.Tensor,
                 wav: torch.Tensor) -> Tuple[VocoderTrainState, Dict]:
        """Generator update against the updated discriminators
        (``vocoder_train.py:146-182``); their parameters take no gradient."""
        mpd, msd = state.disc["mpd"], state.disc["msd"]
        _requires_grad_((mpd, msd), False)
        try:
            y_g = state.gen(mel)
            _, gs_p, fr_p, fg_p = mpd(wav, y_g, pair_batch=self.pair_batch)
            _, gs_s, fr_s, fg_s = msd(wav, y_g, pair_batch=self.pair_batch)
            loss_fm = feature_loss(fr_p, fg_p) + feature_loss(fr_s, fg_s)
            loss_adv = generator_loss(gs_p) + generator_loss(gs_s)
            if self.mel_fn is not None:
                with torch.no_grad():
                    mel_ref = self.mel_fn(wav)
                loss_mel = torch.mean(torch.abs(self.mel_fn(y_g) - mel_ref))
            else:
                loss_mel = torch.zeros((), device=wav.device)
            total = loss_adv + loss_fm + self.mel_loss_weight * loss_mel
            state.gen_opt.zero_grad(set_to_none=True)
            total.backward()
            state.gen_opt.step()
        finally:
            _requires_grad_((mpd, msd), True)
        state.step += 1
        return state, {"g_loss": total.detach(), "g_adv": loss_adv.detach(),
                       "g_fm": loss_fm.detach(), "g_mel": loss_mel.detach()}

    def train_step(self, state: VocoderTrainState, mel: torch.Tensor,
                   wav: torch.Tensor) -> Tuple[VocoderTrainState, Dict]:
        """One alternating D/G update (``vocoder_train.py:184-192``). mel:
        [B, frames, num_mels]; wav: [B, frames * hop], aligned."""
        state, d_loss = self.d_update(state, mel, wav)
        state, g_metrics = self.g_update(state, mel, wav)
        return state, {"d_loss": d_loss, **g_metrics}

    def make_step_fns(self):
        """(d_update, g_update): a full update is ``state, d =
        d_step(state, mel, wav); state, m = g_step(state, mel, wav)``."""
        return self.d_update, self.g_update


# ---------------------------------------------------------------- log-mel

def slaney_mel(num_mels: int, n_fft: int, sr: int, fmin: float,
               fmax: Optional[float]) -> np.ndarray:
    """librosa-style (Slaney area norm) mel basis, [n_fft // 2 + 1,
    num_mels] float32; the port's copy of
    ``daspeech_tpu/data/audio_utils.py:187-209``."""
    fmax = fmax or sr / 2

    def hz2mel(f):
        return np.where(f < 1000, f / 200.0 / 3,
                        15.0 + np.log(np.maximum(f, 1000) / 1000.0)
                        / (np.log(6.4) / 27.0))

    def mel2hz(m):
        return np.where(m < 15.0, 200.0 * 3 * m,
                        1000.0 * np.exp((m - 15.0) * np.log(6.4) / 27.0))

    hz = mel2hz(np.linspace(hz2mel(np.float64(fmin)),
                            hz2mel(np.float64(fmax)), num_mels + 2))
    fft_freqs = np.arange(n_fft // 2 + 1) * sr / n_fft
    fb = np.zeros((n_fft // 2 + 1, num_mels), dtype=np.float32)
    for b in range(num_mels):
        lo, c, hi = hz[b], hz[b + 1], hz[b + 2]
        w = np.maximum(0, np.minimum((fft_freqs - lo) / (c - lo),
                                     (hi - fft_freqs) / (hi - c)))
        fb[:, b] = w * (2.0 / (hi - lo))
    return fb


def make_mel_fn(sample_rate: int = 22050, n_fft: int = 1024,
                hop_length: int = 256, num_mels: int = 80, fmin: float = 0.0,
                fmax: Optional[float] = 8000.0, device="cuda") -> Callable:
    """The differentiable log-mel of the mel loss, waveform [B, T] on
    ``device`` -> [B, frames, num_mels]: reflect-padded centred frames of
    ``n_fft`` samples every ``hop_length``, a Hann window, the ``rfft``
    magnitude, the Slaney mel basis and ``log(max(., 1e-5))``
    (``daspeech_tpu/cli/train_vocoder.py:86-101``)."""
    basis = torch.from_numpy(slaney_mel(num_mels, n_fft, sample_rate, fmin,
                                        fmax)).to(device)
    window = torch.from_numpy(
        np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(device)
    pad = (n_fft - hop_length) // 2

    def mel_fn(wav: torch.Tensor) -> torch.Tensor:
        w = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
        frames = w.unfold(1, n_fft, hop_length) * window
        spec = torch.fft.rfft(frames, dim=-1).abs()
        return torch.log(torch.clamp_min(spec @ basis, 1e-5))

    return mel_fn
