"""HiFi-GAN generator (PyTorch), mel [B, T, 80] -> waveform [B, T*256], and
its serving modes.

Counterpart of ``daspeech_tpu/models/hifigan.py``, computed in the
[B, C, T] layout with ResBlock types 1 and 2. The transposed convs are
exactly ``torch.nn.ConvTranspose1d`` (``ConvTranspose1dTorch``,
``hifigan.py:372-403``). The port serves what JAX's generate CLI builds,
``HiFiGANGenerator(fold_to=128, ...)`` (``cli/generate.py:487-499``).
Folding time into channels is TPU mechanism and the port does not fold;
in fp32 it is exact, but it decides where a reduced-precision vocoder
rounds, and the port rounds where the folded JAX module does:

- ``dtype=torch.bfloat16`` (the bf16 rung): each level has the fold
  ``f = max(1, 128 // ch)``. ``conv_pre``, and a ResBlock conv at a level
  with f = 1, is flax's ``nn.Conv(dtype=bf16)``: the product rounded to
  bf16 and the bias added in bf16. The upsample (the sub-pixel tap form),
  a ResBlock conv at f > 1 and ``conv_post`` at f > 1 are ``apply_taps``
  in bf16 with an fp32 bias added after it, so the residual spine is fp32
  (``hifigan.py:438-457``, ``:687-690``, ``:736-740``);
- ``quant_int8=True`` (the int8 rungs): W8A8 with int32 sums
  (:func:`conv_int8`) at every upsample and ResBlock conv of the levels
  ``i >= quant_skip_levels``, weights scaled per output channel (for the
  upsample, per phase and channel of its sub-pixel kernel, ``:680-688``),
  activations by one static scale a site from the amax buffer of that site
  (``ups_{i}_amax``; ``convs1_{i}_amax``/``convs2_{i}_amax`` in ResBlock1,
  ``convs_{i}_amax`` in ResBlock2: JAX's ``quant`` collection). With
  ``calibrate`` set, a forward quantizes each activation by its own amax
  and raises the site's running amax (:func:`act_scale`).
  ``decode/speech_generator.py::make_vocode_fn`` calibrates over the first
  ``serve_calib_batches`` served batches;
- ``fused_mrf=True``: a level whose ResBlock1 stack JAX's serving
  construction sends to the Pallas kernel runs it through
  ``ops/fused_mrf.py`` (:func:`fused_mrf_route`), with bf16 weights in a
  bf16 vocoder; such a level never quantizes;
- ``serve_chunk > 0``: exact chunked vocoding (:func:`vocode_chunked`),
  read by ``make_vocode_fn``.

Parameters are fp32 in every mode, and the parameter tree is the same.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from daspeech_torch.models.layers import (FP32, Conv1d, ConvTranspose1d,
                                          set_dtype)
from daspeech_torch.ops.fused_mrf import mrf_level, prepare_level
from daspeech_torch.telemetry import span

LRELU_SLOPE = 0.1
# JAX serves with fold_to=128 (cli/generate.py:492-493); a level takes the
# fused MRF kernel when its folded view is one 128-lane tile with >= 128
# folded frames (hifigan.py:679, 701-702)
FOLD_TO = 128
MRF_MIN_FRAMES = 128
INT_MM_MIN_ROWS = 16      # CUDA's torch._int_mm needs more rows than this


def level_fold(ch: int) -> int:
    """The fold JAX's serving construction gives a level of ``ch``
    channels: ``max(1, 128 // ch)`` (``hifigan.py:679``)."""
    return max(1, FOLD_TO // ch)


def fused_mrf_route(resblock: str, ch: int, T: int) -> bool:
    """Whether a level of ``ch`` channels and ``T`` frames runs the fused MRF
    kernel under ``fused_mrf=True``: JAX's gate with ``fold_to=128``, i.e.
    ResBlock type "1", ``f * ch == 128`` for ``f = max(1, 128 // ch)``, and
    ``T // f >= 128``. At config_v1 that is levels 1-3 (ch 128, 64, 32)."""
    f = level_fold(ch)
    return resblock == "1" and f * ch == FOLD_TO and T // f >= MRF_MIN_FRAMES


# --- int8 (W8A8) serving --------------------------------------------------

def quantize_sym(x: torch.Tensor, per_channel: bool = False):
    """Symmetric int8 quantization -> (q, scale) (``hifigan.py:252-263``):
    ``scale = max(amax, 1e-8) / 127`` and ``q = clip(round(x / scale))``
    (round half to even, as ``jnp.round``). ``per_channel`` takes one scale
    per entry of the LAST axis (a tap kernel's output columns); otherwise
    one for the tensor."""
    if per_channel:
        amax = x.abs().amax(dim=tuple(range(x.dim() - 1)))
    else:
        amax = x.abs().max()
    scale = torch.clamp(amax.float(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int_taps_conv(xq: torch.Tensor, wq: torch.Tensor,
                  offsets: Sequence[int]) -> torch.Tensor:
    """Exact int32 sums of a tap-form conv: xq [B, C, T] int8, wq
    [n, C, N] int8 -> [B, T, N] int32 with ``y[b, t] = sum_j
    xq[b, :, t + offsets[j]] @ wq[j]`` (zero outside [0, T)). The windows
    are gathered into [B T, n C] and multiplied by ``torch._int_mm``
    (int8 x int8 -> int32): an fp32 conv over integer-valued operands is
    not exact here (11 x 256 x 127^2 > 2^24). CUDA's ``_int_mm`` takes
    more than 16 rows: fewer (one short utterance) are padded with zero
    rows, whose sums are dropped."""
    B, C, T = xq.shape
    n, _, N = wq.shape
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    xp = F.pad(xq.transpose(1, 2), (0, 0, lo, hi))          # [B, T+lo+hi, C]
    cols = torch.cat([xp[:, lo + o:lo + o + T] for o in offsets], dim=2)
    cols = cols.reshape(B * T, n * C)
    if B * T <= INT_MM_MIN_ROWS:
        cols = F.pad(cols, (0, 0, 0, INT_MM_MIN_ROWS + 1 - B * T))
    # the weights column-major ([N, n C] row-major, transposed), the
    # layout of an int8 GEMM's second operand on CUDA
    w = wq.permute(2, 0, 1).reshape(N, n * C).t()
    return torch._int_mm(cols, w)[:B * T].reshape(B, T, N)


def conv_int8(x: torch.Tensor, taps_w: torch.Tensor, offsets: Sequence[int],
              out_dtype=FP32, x_scale: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """The W8A8 conv of ``hifigan.py:276-303`` in tap form: x [B, C, T],
    ``taps_w`` [n, C, N] (tap j at frame offset ``offsets[j]``) ->
    [B, T, N] in ``out_dtype``. Weights quantized per output column,
    activations by ``x_scale`` (a static scale) or, when None, by their own
    amax; int32 sums (:func:`int_taps_conv`), dequantized as
    ``y * (sx * sw)``."""
    wq, sw = quantize_sym(taps_w, per_channel=True)
    if x_scale is None:
        xq, sx = quantize_sym(x)
    else:
        sx = x_scale
        xq = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    y = int_taps_conv(xq, wq, offsets)
    return (y.float() * (sx * sw)).to(out_dtype)


def conv_taps(conv: nn.Conv1d) -> Tuple[torch.Tensor, List[int]]:
    """A SAME-padded (dilated) ``Conv1d`` as taps: ([k, in, out], frame
    offsets ``(j - c) d``) (``hifigan.py:180-184``)."""
    k, d = conv.kernel_size[0], conv.dilation[0]
    c = (k - 1) // 2
    return conv.weight.permute(2, 1, 0), [(j - c) * d for j in range(k)]


def convT_subpixel_taps(up: nn.ConvTranspose1d
                        ) -> Tuple[torch.Tensor, List[int]]:
    """``ConvTranspose1d(stride=u, padding=p)`` as a stride-1 conv whose
    output packs the u phases into channels, column ``q * C_out + co``
    holding output frame ``m u + q`` (``hifigan.py:187-205``): ([n, in,
    u C_out], frame offsets). Each column holds the taps of its phase
    once, so a per-column scale is JAX's per (phase, channel) one."""
    w = up.weight.permute(2, 0, 1)                        # [k, in, out]
    k, cin, cout = w.shape
    u = up.stride[0]
    pad = k - 1 - up.padding[0]
    flipped = w.flip(0)
    taps = {}
    for q in range(u):
        for j in range(k):
            o = q + j - pad
            if o % u:
                continue
            t = taps.setdefault(o // u, w.new_zeros(cin, u * cout))
            t[:, q * cout:(q + 1) * cout] += flipped[j]
    offs = sorted(taps)
    return torch.stack([taps[o] for o in offs]), offs


def act_scale(owner: nn.Module, name: str, x: torch.Tensor,
              calibrate: bool) -> Optional[torch.Tensor]:
    """The static activation scale of the site whose amax buffer is
    ``owner.<name>`` (``hifigan.py:334-353``): ``max(amax, 1e-8) / 127``;
    while calibrating, the buffer takes ``max(amax, max|x|)`` and the
    result is None (the conv quantizes x by its own amax)."""
    buf = getattr(owner, name)
    if calibrate:
        buf.copy_(torch.maximum(buf, x.abs().max().float()))
        return None
    return torch.clamp(buf, min=1e-8) / 127.0


def _amax_buffers(module: nn.Module, names: Sequence[str]) -> None:
    for n in names:
        module.register_buffer(n, torch.zeros(()), persistent=False)


def res_conv(owner: nn.Module, site: str, conv: Conv1d, x: torch.Tensor,
             fold: int, quant: bool, calibrate: bool) -> torch.Tensor:
    """One ResBlock conv at a level of fold ``fold`` (``hifigan.py:433-
    460``): int8 with the site's scale, or in the conv's compute dtype
    with flax's bias at f = 1 and the tap form's fp32 bias at f > 1."""
    if quant:
        w, offs = conv_taps(conv)
        s = act_scale(owner, f"{site}_amax", x, calibrate)
        y = conv_int8(x, w, offs, conv.dtype, s).transpose(1, 2)
        return y + conv.bias[:, None]
    if conv.dtype == FP32 or fold == 1:
        return conv(x)
    return conv.product(x) + conv.bias[:, None]


class ResBlock1(nn.Module):
    """MRF ResBlock type '1' (``hifigan.py:406-467``): per dilation, a
    dilated conv and a plain conv with leaky-ReLU pre-activations and an
    additive residual."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=(kernel_size - 1) // 2 * d)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size,
                   padding=(kernel_size - 1) // 2)
            for _ in dilations)
        _amax_buffers(self, [f"convs{j}_{i}_amax" for i in
                             range(len(dilations)) for j in (1, 2)])

    def forward(self, x: torch.Tensor, fold: int = 1, quant: bool = False,
                calibrate: bool = False) -> torch.Tensor:
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = res_conv(self, f"convs1_{i}", c1,
                          F.leaky_relu(x, LRELU_SLOPE), fold, quant,
                          calibrate)
            x = x + res_conv(self, f"convs2_{i}", c2,
                             F.leaky_relu(xt, LRELU_SLOPE), fold, quant,
                             calibrate)
        return x


class ResBlock2(nn.Module):
    """MRF ResBlock type '2' (``hifigan.py:470-500``; hifi-gan
    ``models.py:52-72``): one dilated conv per dilation, leaky-ReLU
    pre-activation, additive residual."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=(kernel_size - 1) // 2 * d)
            for d in dilations)
        _amax_buffers(self, [f"convs_{i}_amax" for i in range(len(dilations))])

    def forward(self, x: torch.Tensor, fold: int = 1, quant: bool = False,
                calibrate: bool = False) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = x + res_conv(self, f"convs_{i}", conv,
                             F.leaky_relu(x, LRELU_SLOPE), fold, quant,
                             calibrate)
        return x


class HiFiGANGenerator(nn.Module):
    """``Generator`` (``hifigan.py:603-745``) as JAX's serving construction
    builds it (``fold_to=128``). ``dtype`` (float32 or bfloat16; the
    parameters stay fp32), ``quant_int8``, ``quant_skip_levels``,
    ``calibrate``, ``serve_calib_batches``, ``fused_mrf``, ``mrf_tile``
    (the kernel's output frames per block, 64 or 128; None: chosen from
    each level's shape, ``ops.fused_mrf.pick_tile``) and ``serve_chunk``
    are the JAX module's fields (``:621-655``); see the module docstring
    for what each computes."""

    def __init__(self, cfg, fused_mrf: bool = False,
                 mrf_tile: Optional[int] = None,
                 serve_chunk: int = 0, dtype: torch.dtype = FP32,
                 quant_int8: bool = False, quant_skip_levels: int = 0,
                 calibrate: bool = False, serve_calib_batches: int = 4):
        super().__init__()
        self.cfg = cfg
        self.fused_mrf, self.mrf_tile = fused_mrf, mrf_tile
        self.serve_chunk = serve_chunk
        self.dtype = dtype
        self.quant_int8, self.quant_skip_levels = quant_int8, quant_skip_levels
        self.calibrate = calibrate
        self.serve_calib_batches = serve_calib_batches
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        res_cls = {"1": ResBlock1, "2": ResBlock2}[cfg.resblock]
        ch = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.num_mels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            out_ch = cfg.upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(ch, out_ch, k, u,
                                            padding=(k - u) // 2))
            ch = out_ch
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                self.resblocks.append(res_cls(ch, rk, tuple(rd)))
        self.conv_post = Conv1d(ch, 1, 7, padding=3)
        _amax_buffers(self, [f"ups_{i}_amax"
                             for i in range(len(cfg.upsample_rates))])
        set_dtype(self, dtype)

    def reset_calibration_(self) -> None:
        """Zero every site's amax: JAX's empty ``quant`` collection."""
        for name, buf in self.named_buffers():
            if name.endswith("_amax"):
                buf.zero_()

    def _upsample(self, i: int, x: torch.Tensor, quant: bool
                  ) -> torch.Tensor:
        """Level i's transposed conv on lrelu(x): its sub-pixel tap form
        with an fp32 bias (``hifigan.py:680-690``), int8 when ``quant``."""
        up = self.ups[i]
        if not quant:
            if up.dtype == FP32:
                return up(x)
            return up.product(x) + up.bias[:, None]
        u = up.stride[0]
        if up.kernel_size[0] - 2 * up.padding[0] != u:
            raise ValueError("the int8 upsample takes kernel - 2 padding "
                             "== stride (the sub-pixel form's T u frames)")
        w, offs = convT_subpixel_taps(up)
        s = act_scale(self, f"ups_{i}_amax", x, self.calibrate)
        y = conv_int8(x, w, offs, up.dtype, s)            # [B, T, u C]
        B, T, _ = y.shape
        y = y.reshape(B, T * u, -1).transpose(1, 2)
        return y + up.bias[:, None]

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """Each upsampling level (its transposed conv and its MRF) runs in
        a ``vocoder.level<i>`` span."""
        c = self.cfg
        x = self.conv_pre(mel.transpose(1, 2))               # [B, C, T]
        for i in range(len(self.ups)):
            with span(f"vocoder.level{i}"):
                quant = self.quant_int8 and i >= self.quant_skip_levels
                x = self._upsample(i, F.leaky_relu(x, LRELU_SLOPE), quant)
                blocks = self.resblocks[i * self.num_kernels:
                                        (i + 1) * self.num_kernels]
                if self.fused_mrf and fused_mrf_route(
                        c.resblock, x.shape[1], x.shape[2]):
                    W, biases = prepare_level(blocks, self.dtype)
                    x = mrf_level(x.float(), W, biases,
                                  c.resblock_kernel_sizes,
                                  c.resblock_dilation_sizes, self.mrf_tile)
                    continue
                f = level_fold(x.shape[1])
                xs = None
                for block in blocks:
                    y = block(x, f, quant, self.calibrate)
                    xs = y if xs is None else xs + y
                x = xs / self.num_kernels
        # the reference's final activation uses torch's default slope 0.01
        x = F.leaky_relu(x, 0.01)
        if self.conv_post.dtype == FP32 or level_fold(x.shape[1]) == 1:
            x = self.conv_post(x)
        else:
            x = self.conv_post.product(x) + self.conv_post.bias[:, None]
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
