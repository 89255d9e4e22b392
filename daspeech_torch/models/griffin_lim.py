"""Griffin-Lim vocoder (PyTorch): log-mel -> waveform with no checkpoint.

Counterpart of ``daspeech_tpu/models/griffin_lim.py`` (the reference's
``PseudoInverseMelScale`` + ``GriffinLim``, ``get_vocoder``'s
"griffin_lim" branch): the mel's pseudo-inverse, then ``n_iter`` rounds of
inverse STFT and STFT that keep the magnitude and refine the phase.

Its framing is JAX's: a centred pad of n_fft / 2, a Hann window from
``np.hanning(win + 1)[:-1]``, the inverse's window-sum-square normalisation
floored at the smallest normal float. A batch gives each row the bits
that row gives alone: the overlap-add sums ``n_fft / hop`` shifted views of
the frames in a fixed order (no atomics), the mel's pseudo-inverse is a sum
over the mel bins of elementwise products in a fixed order (no matrix
product, whose kernel may follow the batch's size), and each row takes its
own FFT calls (cuFFT's bits for a transform follow how many transforms a
call holds: on an H100 a row alone differed from the same row in a batch
of 8). The starting phase is JAX's draw,
bit for bit: ``jax.random.uniform(jax.random.key(0), [M, n_fft // 2 + 1],
-pi, pi)`` (threefry2x32, the partitionable counters), made here by
:func:`jax_uniform` in numpy, one per frame and the same for every row.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from daspeech_torch.data.audio_utils import _slaney_mel

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = 1.1754944e-38          # the wsq floor (float32's smallest normal)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    key (k0, k1), as JAX computes it (``jax._src.prng``): uint32 arrays."""
    with np.errstate(over="ignore"):
        ks = (np.uint32(k0), np.uint32(k1),
              np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA))
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def jax_uniform(seed: int, shape, minval: float, maxval: float
                ) -> np.ndarray:
    """``jax.random.uniform(jax.random.key(seed), shape, float32, minval,
    maxval)`` under the default threefry2x32 with partitionable counters:
    element i (flat index, i < 2**32) takes bits = x0 ^ x1 of the hash of
    counters (0, i); its top 23 bits OR'd into 1.0f, minus 1, scaled into
    [minval, maxval) and floored at minval. XLA fuses the scale and the
    shift into one fused multiply-add, rounded once to float32: here the
    product is exact in float64 and the sum is taken there, then
    rounded."""
    key = (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF
    n = int(np.prod(shape))
    b0, b1 = threefry2x32(*key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    out = (floats.astype(np.float64) * np.float64(hi - lo)
           + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, out).reshape(shape)


@lru_cache(maxsize=8)
def start_phase(frames: int, bins: int) -> np.ndarray:
    """JAX's starting phase [frames, bins]: U(-pi, pi) from key 0
    (read-only: the cache hands every caller the same array)."""
    phase = jax_uniform(0, (frames, bins), -math.pi, math.pi)
    phase.setflags(write=False)
    return phase


def _stft(wav: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor):
    """Centred STFT (``griffin_lim.py:27-37``): wav [B, N] -> (magnitude,
    phase) [B, F, n_fft // 2 + 1]."""
    pad = n_fft // 2
    wav = torch.nn.functional.pad(wav, (pad, pad))
    frames = wav.unfold(1, n_fft, hop) * window
    spec = torch.fft.rfft(frames, n=n_fft)
    return spec.abs(), spec.angle()


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[B, F, n_fft] -> [B, n_fft + hop * (F - 1)]: each frame added at
    hop * f. With n_fft = k * hop, the sum of k shifted [B, F + k - 1,
    hop] views, in a fixed order."""
    B, F, n_fft = frames.shape
    k = n_fft // hop
    if k * hop != n_fft:
        raise ValueError(f"n_fft {n_fft} is not a multiple of hop {hop}")
    chunks = frames.reshape(B, F, k, hop)
    out = frames.new_zeros(B, F + k - 1, hop)
    for j in range(k):
        out[:, j: j + F] += chunks[:, :, j]
    return out.reshape(B, (F + k - 1) * hop)


def _istft(mag: torch.Tensor, phase: torch.Tensor, n_fft: int, hop: int,
           window: torch.Tensor) -> torch.Tensor:
    """Overlap-add inverse with window-sum-square normalisation
    (``griffin_lim.py:40-56``): [B, F, n_fft // 2 + 1] -> wav
    [B, (F - 1) * hop] (centre-trimmed)."""
    spec = torch.polar(mag, phase)
    frames = torch.fft.irfft(spec, n=n_fft) * window
    wav = _overlap_add(frames, hop)
    F = mag.shape[1]
    wsq = _overlap_add((window ** 2).expand(1, F, n_fft), hop)
    wav = wav / wsq.clamp(min=TINY)
    pad = n_fft // 2
    return wav[:, pad:-pad]


def _pseudo_inverse(mel: torch.Tensor, inv_basis: torch.Tensor
                    ) -> torch.Tensor:
    """max(mel @ inv_basis, 0) for mel [B, M, mels], inv_basis [mels,
    freq]: the products added bin by bin, elementwise."""
    spec = mel[..., :1] * inv_basis[0]
    for k in range(1, inv_basis.shape[0]):
        spec = torch.addcmul(spec, mel[..., k: k + 1], inv_basis[k])
    return spec.clamp(min=0.0)


class GriffinLimVocoder:
    """Natural-log mel [B, M, num_mels] (the domain of
    ``data/audio_utils.log_mel_spectrogram``) -> fp32 wav [B, M * hop]
    (``griffin_lim.py:59-119``): the mel exponentiated, through the
    pseudo-inverse of the Slaney mel basis (clamped at 0), ``n_iter``
    phase-recovery rounds from JAX's starting phase, the last inverse STFT
    padded by one hop. It has no parameters; it runs on the mel's device
    and takes the place of a vocoder module (``voc(mel)``)."""

    def __init__(self, sample_rate: int = 22050, n_fft: int = 1024,
                 win_length: int = 1024, hop_length: int = 256,
                 num_mels: int = 80, fmin: float = 0.0,
                 fmax: float = 8000.0, n_iter: int = 32):
        self.n_fft, self.hop, self.n_iter = n_fft, hop_length, n_iter
        fb = _slaney_mel(num_mels, n_fft, sample_rate, fmin, fmax)
        self.inv_basis = torch.from_numpy(
            np.linalg.pinv(fb).astype(np.float32))            # [mel, freq]
        window = np.hanning(win_length + 1)[:-1].astype(np.float32)
        if win_length < n_fft:
            lpad = (n_fft - win_length) // 2
            window = np.pad(window, (lpad, n_fft - win_length - lpad))
        self.window = torch.from_numpy(window)

    def __call__(self, log_mel: torch.Tensor) -> torch.Tensor:
        dev = log_mel.device
        inv_basis, window = self.inv_basis.to(dev), self.window.to(dev)
        phase0 = torch.tensor(start_phase(log_mel.shape[1],
                                          inv_basis.shape[1]), device=dev)
        return torch.cat([self._row(log_mel[b: b + 1], inv_basis, window,
                                    phase0)
                          for b in range(log_mel.shape[0])])

    def _row(self, log_mel, inv_basis, window, phase):
        """One utterance [1, M, mels] -> [1, M * hop]."""
        spec = _pseudo_inverse(torch.exp(log_mel.float()), inv_basis)
        phase = phase.expand_as(spec)
        for _ in range(self.n_iter):
            wav = _istft(spec, phase, self.n_fft, self.hop, window)
            _, phase = _stft(wav, self.n_fft, self.hop, window)
        wav = _istft(spec, phase, self.n_fft, self.hop, window)
        return torch.nn.functional.pad(wav, (0, self.hop))
