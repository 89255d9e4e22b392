"""Mel-cepstral distortion (MCD/MSD) for TTS regression evaluation: the
port's numpy copy of ``daspeech_tpu/eval/mcd.py``.

Rebuild of fairseq's ``batch_mel_cepstral_distortion``
(``fairseq/fairseq/tasks/text_to_speech.py`` eval-inference path): DCT of
log-mel to cepstra, DTW alignment, frame-averaged distortion in dB. The
upstream regression target is MCD 3.2 ± 0.1 on LJSpeech
(``fairseq/tests/speech/test_fastspeech2.py:47-49``).
"""

from __future__ import annotations

import numpy as np

_LOG_SPEC_BASE = 10.0 / np.log(10.0) * np.sqrt(2.0)


def mel_to_cepstra(log_mel: np.ndarray, n_coef: int = 13) -> np.ndarray:
    """[T, n_mels] natural-log mel -> [T, n_coef] cepstra via DCT-II,
    dropping c0 (energy)."""
    T, M = log_mel.shape
    k = np.arange(M)
    basis = np.cos(np.pi * np.arange(n_coef + 1)[:, None]
                   * (2 * k[None, :] + 1) / (2 * M))
    cep = log_mel @ basis.T * np.sqrt(2.0 / M)
    return cep[:, 1:]                       # drop c0


def dtw_path(dist: np.ndarray):
    """Classic DTW over a [T1, T2] distance matrix; returns the aligned
    index pairs."""
    T1, T2 = dist.shape
    acc = np.full((T1 + 1, T2 + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, T1 + 1):
        j_lo, j_hi = 1, T2 + 1
        for j in range(j_lo, j_hi):
            acc[i, j] = dist[i - 1, j - 1] + min(
                acc[i - 1, j], acc[i, j - 1], acc[i - 1, j - 1])
    path = []
    i, j = T1, T2
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        moves = [(i - 1, j - 1), (i - 1, j), (i, j - 1)]
        i, j = min(moves, key=lambda p: acc[p[0], p[1]])
    return path[::-1]


def mel_cepstral_distortion(
    log_mel_hyp: np.ndarray, log_mel_ref: np.ndarray, n_coef: int = 13,
) -> float:
    """MCD in dB between two (possibly different-length) log-mel matrices."""
    ch = mel_to_cepstra(log_mel_hyp, n_coef)
    cr = mel_to_cepstra(log_mel_ref, n_coef)
    d = np.sqrt(
        ((ch[:, None, :] - cr[None, :, :]) ** 2).sum(-1))     # [T1, T2]
    path = dtw_path(d)
    return float(_LOG_SPEC_BASE * np.mean([d[i, j] for i, j in path]))


def batch_mel_cepstral_distortion(hyps, refs, n_coef: int = 13) -> float:
    """Corpus-average MCD."""
    vals = [mel_cepstral_distortion(h, r, n_coef) for h, r in zip(hyps, refs)]
    return float(np.mean(vals))
