"""HiFi-GAN generator (PyTorch), mel [B, T, 80] -> waveform [B, T*256], and
its serving modes.

Counterpart of ``daspeech_tpu/models/hifigan.py``: the plain conv form,
computed in the [B, C, T] layout, fp32, with ResBlock types 1 and 2. The
transposed convs are exactly ``torch.nn.ConvTranspose1d``
(``ConvTranspose1dTorch``, ``hifigan.py:372-403``). Serving modes:

- ``fused_mrf=True``: a level whose ResBlock1 stack JAX's serving
  construction (``fold_to=128``) sends to the Pallas kernel runs it
  through ``ops/fused_mrf.py`` (:func:`fused_mrf_route`);
- ``serve_chunk > 0``: exact chunked vocoding (:func:`vocode_chunked`),
  read by ``decode/speech_generator.py::make_vocode_fn``.

The folded and int8 forms of the JAX package are TPU mechanism and are not
ported; the parameter tree is the same in every mode.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from daspeech_torch.ops.fused_mrf import mrf_level, prepare_level

LRELU_SLOPE = 0.1
# JAX serves with fold_to=128 (cli/generate.py:492-493); a level takes the
# fused MRF kernel when its folded view is one 128-lane tile with >= 128
# folded frames (hifigan.py:679, 701-702)
FOLD_TO = 128
MRF_MIN_FRAMES = 128


def fused_mrf_route(resblock: str, ch: int, T: int) -> bool:
    """Whether a level of ``ch`` channels and ``T`` frames runs the fused MRF
    kernel under ``fused_mrf=True``: JAX's gate with ``fold_to=128``, i.e.
    ResBlock type "1", ``f * ch == 128`` for ``f = max(1, 128 // ch)``, and
    ``T // f >= 128``. At config_v1 that is levels 1-3 (ch 128, 64, 32)."""
    f = max(1, FOLD_TO // ch)
    return resblock == "1" and f * ch == FOLD_TO and T // f >= MRF_MIN_FRAMES


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


class ResBlock2(nn.Module):
    """MRF ResBlock type '2' (``hifigan.py:470-500``; hifi-gan
    ``models.py:52-72``): one dilated conv per dilation, leaky-ReLU
    pre-activation, additive residual."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size - 1) // 2 * d)
            for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = x + conv(F.leaky_relu(x, LRELU_SLOPE))
        return x


class HiFiGANGenerator(nn.Module):
    """``Generator`` (``hifigan.py:603-745``). ``fused_mrf``, ``mrf_tile``
    (the kernel's output frames per block, 64 or 128; None: chosen from
    each level's shape, ``ops.fused_mrf.pick_tile``) and ``serve_chunk``
    are the JAX module's serving fields (``:635-655``)."""

    def __init__(self, cfg, fused_mrf: bool = False,
                 mrf_tile: Optional[int] = None,
                 serve_chunk: int = 0):
        super().__init__()
        self.cfg = cfg
        self.fused_mrf, self.mrf_tile = fused_mrf, mrf_tile
        self.serve_chunk = serve_chunk
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        res_cls = {"1": ResBlock1, "2": ResBlock2}[cfg.resblock]
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
                self.resblocks.append(res_cls(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.conv_pre(mel.transpose(1, 2))               # [B, C, T]
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            blocks = self.resblocks[i * self.num_kernels:
                                    (i + 1) * self.num_kernels]
            if self.fused_mrf and fused_mrf_route(c.resblock, x.shape[1],
                                                  x.shape[2]):
                W, biases = prepare_level(blocks)
                x = mrf_level(x, W, biases, c.resblock_kernel_sizes,
                              c.resblock_dilation_sizes, self.mrf_tile)
                continue
            xs = blocks[0](x)
            for block in blocks[1:]:
                xs = xs + block(x)
            x = xs / self.num_kernels
        # the reference's final activation uses torch's default slope 0.01
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0]


def receptive_halo_mel(cfg) -> int:
    """Conservative one-sided receptive field of the generator in mel frames
    (``hifigan.py:503-518``): an output sample depends on at most this many
    mel frames to each side; the exactness halo of chunked vocoding
    (config_v1: 15 frames)."""
    halo = (7 - 1) // 2  # conv_post, at the output sample rate
    for u, k in reversed(list(zip(cfg.upsample_rates,
                                  cfg.upsample_kernel_sizes))):
        halo += max(
            sum((rk - 1) // 2 * d + (rk - 1) // 2 for d in rd)
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes))
        # through the stride-u transposed conv: input index range for
        # output o is [(o + p - k + 1) / u, (o + p) / u], p = (k-u)//2
        halo = -(-(halo + k - 1) // u)
    return halo + (7 - 1) // 2  # conv_pre


def vocode_chunks(voc: HiFiGANGenerator, mel: torch.Tensor, chunk: int = 64,
                  halo: Optional[int] = None) -> Iterator[torch.Tensor]:
    """The waveform of :func:`vocode_chunked`, one chunk of ``chunk`` mel
    frames at a time ([B, chunk * hop] each, the last shorter): a stream's
    first audio waits for one window, not for the utterance."""
    if halo is None:
        halo = receptive_halo_mel(voc.cfg)
    M = mel.shape[1]
    hop = 1
    for u in voc.cfg.upsample_rates:
        hop *= u
    W = chunk + 2 * halo
    if M <= W:
        yield voc(mel)
        return
    for s in range(0, M, chunk):
        e = min(s + chunk, M)
        ws = max(0, min(s - halo, M - W))
        yield voc(mel[:, ws:ws + W])[:, (s - ws) * hop:(e - ws) * hop]


def vocode_chunked(voc: HiFiGANGenerator, mel: torch.Tensor, chunk: int = 64,
                   halo: Optional[int] = None) -> torch.Tensor:
    """Exact chunked vocoding (``hifigan.py:561-600``): the samples of the
    one-shot forward. Every chunk vocodes one window of ``chunk + 2 * halo``
    mel frames, edge windows shifted to stay inside ``[0, M)``; interior
    samples see ``halo`` frames of true context on each side, and a window
    flush with a sequence end gets the one-shot forward's own zero padding
    there. Each window's output is cropped to its chunk and the chunks are
    concatenated."""
    return torch.cat(list(vocode_chunks(voc, mel, chunk, halo)), dim=1)
