"""HiFi-GAN discriminators and adversarial losses (PyTorch), for vocoder
training.

Counterpart of ``daspeech_tpu/models/hifigan_discriminators.py``: the
multi-period discriminator (periods 2/3/5/7/11, ``Conv2d`` stacks with
(k, 1) kernels over a [T/p, p] fold) and the multi-scale discriminator
(three scales of grouped ``Conv1d`` stacks with average-pool downsampling),
plain convolutions without weight or spectral norm as in the JAX module.
Submodules carry the flax tree's names (``disc_p2`` .. ``disc_p11``,
``disc_s0`` .. ``disc_s2``, ``convs_i``, ``conv_post``), so
``convert.discriminators_from_flax`` maps a JAX tree onto them. Feature
maps are NCHW / NCL, where JAX's are NHWC / NLC.

``dtype`` (float32 or bfloat16) is the compute dtype of every conv
(``models.layers.Conv1d``/``Conv2d``, flax's ``nn.Conv(dtype=...)``: bf16
outputs with the bias added in bf16); the parameters stay fp32, and the
losses take their means in fp32 (``mean(..., dtype=f32)``,
``hifigan_discriminators.py:167-194``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from daspeech_torch.models.layers import FP32, Conv1d, Conv2d, set_dtype

LRELU_SLOPE = 0.1
PERIODS = (2, 3, 5, 7, 11)
# DiscriminatorS's convs: (out channels, kernel, stride, groups, padding)
SCALE_SPEC = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
              (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20),
              (1024, 41, 1, 16, 20), (1024, 5, 1, 1, 2))


class DiscriminatorP(nn.Module):
    """Period discriminator (``hifigan_discriminators.py:26-61``): the
    waveform reflect-padded to a multiple of the period and folded to
    [B, 1, T/p, p]."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        kp = (kernel_size - 1) // 2
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            Conv2d(cin, cout, (kernel_size, 1), (stride, 1), (kp, 0))
            for cin, cout in zip(chans[:-1], chans[1:]))
        self.convs.append(Conv2d(1024, 1024, (kernel_size, 1), 1, (2, 0)))
        self.conv_post = Conv2d(1024, 1, (3, 1), 1, (1, 0))

    def forward(self, x: torch.Tensor):
        """x [B, T] -> (scores [B, n], feature maps)."""
        B, T = x.shape
        p = self.period
        if T % p:
            x = F.pad(x[:, None], (0, p - T % p), mode="reflect")[:, 0]
        x = x.reshape(B, 1, -1, p)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(B, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator (``hifigan_discriminators.py:64-88``): seven
    (grouped) ``Conv1d``s."""

    def __init__(self):
        super().__init__()
        cins = (1,) + tuple(s[0] for s in SCALE_SPEC[:-1])
        self.convs = nn.ModuleList(
            Conv1d(cin, ch, k, s, pad, groups=g)
            for cin, (ch, k, s, g, pad) in zip(cins, SCALE_SPEC))
        self.conv_post = Conv1d(1024, 1, 3, 1, 1)

    def forward(self, x: torch.Tensor):
        """x [B, T] -> (scores [B, n], feature maps)."""
        B = x.shape[0]
        x = x[:, None]
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(B, -1), fmap


def _run_pair(d: nn.Module, y: torch.Tensor, y_hat: torch.Tensor,
              pair_batch: bool):
    """(real, gen, real maps, gen maps) of one sub-discriminator: with
    ``pair_batch`` one call on ``cat([y, y_hat])``, split back."""
    if not pair_batch:
        r, fr = d(y)
        g, fg = d(y_hat)
        return r, g, fr, fg
    B = y.shape[0]
    out, fmap = d(torch.cat([y, y_hat], dim=0))
    return out[:B], out[B:], [f[:B] for f in fmap], [f[B:] for f in fmap]


def _collect(runs):
    rs, gs, fr, fg = zip(*runs)
    return list(rs), list(gs), list(fr), list(fg)


class MultiPeriodDiscriminator(nn.Module):
    """``hifigan_discriminators.py:98-127``. A call with ``pair_batch``
    runs each sub-discriminator once on the real and generated waveforms
    together (the same sums; half the calls); the JAX module takes it as a
    field, here one set of parameters serves both forms."""

    def __init__(self, dtype: torch.dtype = FP32):
        super().__init__()
        for p in PERIODS:
            self.add_module(f"disc_p{p}", DiscriminatorP(p))
        set_dtype(self, dtype)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor,
                pair_batch: bool = False):
        """(real scores, generated scores, real maps, generated maps), one
        entry per period."""
        return _collect(_run_pair(getattr(self, f"disc_p{p}"), y, y_hat,
                                  pair_batch) for p in PERIODS)


def avg_pool_1d(x: torch.Tensor) -> torch.Tensor:
    """``AvgPool1d(4, 2, padding=2)`` with ``count_include_pad=True`` on
    [B, T] (``hifigan_discriminators.py:130-136``)."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2,
                        count_include_pad=True)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    """``hifigan_discriminators.py:139-162``: the waveform at scales 1, 1/2
    and 1/4; ``pair_batch`` as in :class:`MultiPeriodDiscriminator`."""

    def __init__(self, dtype: torch.dtype = FP32):
        super().__init__()
        for i in range(3):
            self.add_module(f"disc_s{i}", DiscriminatorS())
        set_dtype(self, dtype)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor,
                pair_batch: bool = False):
        runs = []
        for i in range(3):
            if i:
                y, y_hat = avg_pool_1d(y), avg_pool_1d(y_hat)
            runs.append(_run_pair(getattr(self, f"disc_s{i}"), y, y_hat,
                                  pair_batch))
        return _collect(runs)


def feature_loss(fmap_r: List, fmap_g: List) -> torch.Tensor:
    """Feature matching, the real maps detached
    (``hifigan_discriminators.py:167-176``)."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach() - gl),
                                     dtype=FP32)
    return loss * 2.0


def discriminator_loss(real_outs: List, gen_outs: List) -> torch.Tensor:
    """LSGAN D loss (``hifigan_discriminators.py:179-186``)."""
    loss = 0.0
    for dr, dg in zip(real_outs, gen_outs):
        loss = (loss + torch.mean((1.0 - dr) ** 2, dtype=FP32)
                + torch.mean(dg ** 2, dtype=FP32))
    return loss


def generator_loss(gen_outs: List) -> torch.Tensor:
    """LSGAN G loss (``hifigan_discriminators.py:189-194``)."""
    loss = 0.0
    for dg in gen_outs:
        loss = loss + torch.mean((1.0 - dg) ** 2, dtype=FP32)
    return loss
