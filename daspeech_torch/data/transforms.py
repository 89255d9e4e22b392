"""Per-utterance feature transforms (host-side numpy, composable; a copy
of ``daspeech_tpu/data/transforms.py``).

Rebuild of ``fairseq/fairseq/data/audio/feature_transforms/``:
utterance-CMVN (``utterance_cmvn.py``), global-CMVN (``global_cmvn.py``),
SpecAugment (``specaugment.py`` — freq/time masking + a cv2-free linear
time-warp), delta-deltas (``delta_deltas.py``, torchaudio-free).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class UtteranceCMVN:
    """Per-utterance mean/variance normalization."""

    def __init__(self, norm_means: bool = True, norm_vars: bool = True):
        self.norm_means, self.norm_vars = norm_means, norm_vars

    def __call__(self, x: np.ndarray) -> np.ndarray:
        mean = x.mean(axis=0)
        square_sums = (x ** 2).sum(axis=0)
        if self.norm_means:
            x = np.subtract(x, mean)
        if self.norm_vars:
            var = square_sums / x.shape[0] - mean ** 2
            std = np.sqrt(np.maximum(var, 1e-10))
            x = np.divide(x, std)
        return x.astype(np.float32)


class GlobalCMVN:
    """Normalization by precomputed corpus statistics
    (``gcmvn_stats.npz`` with 'mean' and 'std')."""

    def __init__(self, stats_npz_path: Optional[str] = None,
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None):
        if stats_npz_path is not None:
            stats = np.load(stats_npz_path)
            mean, std = stats["mean"], stats["std"]
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return ((x - self.mean) / self.std).astype(np.float32)

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        """gcmvn_denormalize for generated mels
        (``fairseq/fairseq/speech_generator.py``)."""
        return (x * self.std + self.mean).astype(np.float32)


def _resize_time(seg: np.ndarray, new_t: int) -> np.ndarray:
    """Linear resize along the time axis (cv2.resize INTER_LINEAR
    half-pixel-center semantics, cv2-free)."""
    T = seg.shape[0]
    if new_t == T or T == 0:
        return seg
    pos = np.clip((np.arange(new_t) + 0.5) * T / new_t - 0.5, 0, T - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, T - 1)
    w = (pos - lo)[:, None].astype(seg.dtype)
    return (1 - w) * seg[lo] + w * seg[hi]


class DeltaDeltas:
    """Append delta and delta-delta features: [T, F] -> [T, 3F]
    (``delta_deltas.py``; regression deltas matching torchaudio's
    ``compute_deltas`` with replicate edge padding)."""

    def __init__(self, win_length: int = 5):
        assert win_length >= 3 and win_length % 2 == 1
        self.n = (win_length - 1) // 2

    def _delta(self, x: np.ndarray) -> np.ndarray:
        n = self.n
        denom = 2 * sum(i * i for i in range(1, n + 1))
        xp = np.pad(x, ((n, n), (0, 0)), mode="edge")
        out = np.zeros_like(x)
        for i in range(1, n + 1):
            out += i * (xp[n + i: n + i + len(x)]
                        - xp[n - i: n - i + len(x)])
        return out / denom

    def __call__(self, x: np.ndarray) -> np.ndarray:
        d = self._delta(x)
        dd = self._delta(d)
        return np.concatenate([x, d, dd], axis=1).astype(np.float32)


class SpecAugment:
    """Time warp + frequency & time masking (policy defaults = LD,
    ``specaugment.py:14-131``). The warp resizes the [0, w0) and [w0, T)
    segments to [0, w0+w) and [w0+w, T) with linear interpolation — the
    reference's cv2.resize calls (``:97-111``) without the cv2 dependency."""

    def __init__(
        self,
        freq_mask_n: int = 2,
        freq_mask_f: int = 27,
        time_mask_n: int = 2,
        time_mask_t: int = 100,
        time_mask_p: float = 1.0,
        time_warp_w: int = 0,
        rng: Optional[np.random.Generator] = None,
    ):
        self.freq_mask_n, self.freq_mask_f = freq_mask_n, freq_mask_f
        self.time_mask_n, self.time_mask_t = time_mask_n, time_mask_t
        self.time_mask_p = time_mask_p
        self.time_warp_w = time_warp_w
        self.rng = rng or np.random.default_rng()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = x.copy()
        T, F = x.shape
        fill = x.mean()
        W = self.time_warp_w
        if W > 0 and 2 * W < T:
            w0 = int(self.rng.integers(W, T - W))
            w = int(self.rng.integers(-W + 1, W))
            x = np.concatenate([_resize_time(x[:w0], w0 + w),
                                _resize_time(x[w0:], T - w0 - w)], axis=0)
        for _ in range(self.freq_mask_n):
            f = self.rng.integers(0, self.freq_mask_f + 1)
            if f and f < F:
                f0 = self.rng.integers(0, F - f)
                x[:, f0:f0 + f] = fill
        max_t = min(self.time_mask_t, int(self.time_mask_p * T))
        for _ in range(self.time_mask_n):
            t = self.rng.integers(0, max_t + 1) if max_t > 0 else 0
            if t and t < T:
                t0 = self.rng.integers(0, T - t)
                x[t0:t0 + t, :] = fill
        return x


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = [t for t in transforms if t is not None]

    def __call__(self, x: np.ndarray) -> np.ndarray:
        for t in self.transforms:
            x = t(x)
        return x
