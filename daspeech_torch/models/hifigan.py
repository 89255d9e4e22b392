"""HiFi-GAN generator (PyTorch), mel [B, T, 80] -> waveform [B, T*256].

Counterpart of ``daspeech_tpu/models/hifigan.py`` with ``fold_to=0``: the
plain conv form, computed in the [B, C, T] layout, fp32. The transposed
convs are exactly ``torch.nn.ConvTranspose1d`` (``ConvTranspose1dTorch``,
``hifigan.py:372-403``). The folded, int8, chunked and fused-MRF serving
modes of the JAX package are not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


class ResBlock1(nn.Module):
    """MRF ResBlock type '1' (``hifigan.py:406-467``): per dilation, a
    dilated conv and a plain conv with leaky-ReLU pre-activations and an
    additive residual."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size - 1) // 2 * d)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size,
                      padding=(kernel_size - 1) // 2)
            for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1(F.leaky_relu(x, LRELU_SLOPE))
            x = x + c2(F.leaky_relu(xt, LRELU_SLOPE))
        return x


class HiFiGANGenerator(nn.Module):
    """``Generator`` (``hifigan.py:603-745``), ResBlock type 1."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.resblock != "1":
            raise NotImplementedError("ResBlock type 2 is not ported yet")
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            out_ch = cfg.upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch, out_ch, k, u,
                                               padding=(k - u) // 2))
            ch = out_ch
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.transpose(1, 2))               # [B, C, T]
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            blocks = self.resblocks[i * self.num_kernels:
                                    (i + 1) * self.num_kernels]
            xs = blocks[0](x)
            for block in blocks[1:]:
                xs = xs + block(x)
            x = xs / self.num_kernels
        # the reference's final activation uses torch's default slope 0.01
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0]
