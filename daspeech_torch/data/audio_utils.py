"""Audio feature IO (a copy of ``daspeech_tpu/data/audio_utils.py``): the
``file.zip:offset:length`` path grammar, zip-packed .npy reads, and offline
fbank / mel utilities.

Rebuild of ``fairseq/fairseq/data/audio/audio_utils.py:169-293`` (path
grammar + mmap zip reads) and the TTS feature prep of
``fairseq/examples/speech_synthesis/data_utils.py`` (log-mel, n_fft 1024,
hop 256, 22.05 kHz). Kaldi-style fbank (for S2TT inputs) is implemented in
numpy with povey windows matching torchaudio.compliance.kaldi defaults.
"""

from __future__ import annotations

import io
import re
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PATH_RE = re.compile(r"^(?P<file>.+?)(?::(?P<offset>\d+):(?P<length>\d+))?$")


def parse_path(path: str) -> Tuple[str, int, int]:
    """``parse_path`` (``audio_utils.py:297+``): 'file[:offset:length]'."""
    m = _PATH_RE.match(path)
    if m is None:
        raise ValueError(f"invalid audio path {path!r}")
    offset = int(m.group("offset") or 0)
    length = int(m.group("length") or -1)
    return m.group("file"), offset, length


def read_from_stored_zip(zip_path: str, offset: int, length: int) -> bytes:
    with open(zip_path, "rb") as f:
        f.seek(offset)
        return f.read(length)


def is_npy_data(data: bytes) -> bool:
    return data[:1] == b"\x93" and data[1:6] == b"NUMPY"


_NPY_HDR_RE = re.compile(
    rb"'descr':\s*'([^']+)'.*?'fortran_order':\s*(\w+).*?"
    rb"'shape':\s*\(([^)]*)\)", re.S)


def fast_npy_parse(data: bytes) -> np.ndarray:
    """Zero-copy .npy parse from bytes. ``np.load(BytesIO(...))`` spends
    most of its time in ``ast.literal_eval`` of the header dict (~25 us x
    every item of every batch on the hot input path); a regex parse of the
    three fixed keys + ``np.frombuffer`` is ~10x faster and returns a
    read-only view over the zip-read buffer (no extra copy). Falls back to
    np.load for anything it doesn't recognize (pickled arrays, v3 headers
    with exotic dtypes)."""
    try:
        major = data[6]
        if major == 1:
            hlen = int.from_bytes(data[8:10], "little")
            off = 10 + hlen
            hdr = data[10:off]
        else:                       # version 2/3: 4-byte header length
            hlen = int.from_bytes(data[8:12], "little")
            off = 12 + hlen
            hdr = data[12:off]
        m = _NPY_HDR_RE.search(hdr)
        if m is None:
            raise ValueError("header regex miss")
        descr, fortran, shape_s = m.groups()
        if fortran not in (b"False", b"True"):
            raise ValueError("bad fortran_order")
        shape = tuple(int(x) for x in shape_s.split(b",") if x.strip())
        arr = np.frombuffer(data, dtype=np.dtype(descr.decode()),
                            offset=off).reshape(
            shape, order="F" if fortran == b"True" else "C")
        return arr
    except Exception:
        return np.load(io.BytesIO(data))


def get_features_or_waveform(path: str) -> np.ndarray:
    """Load a feature matrix or waveform from 'file[:offset:len]'
    (``get_features_or_waveform``, ``audio_utils.py:169-211``)."""
    file, offset, length = parse_path(path)
    p = Path(file)
    if p.suffix == ".npy" or length == -1 and p.suffix == ".npy":
        return np.load(file)
    if length != -1:
        data = read_from_stored_zip(file, offset, length)
        if is_npy_data(data):
            return fast_npy_parse(data)
        raise ValueError(f"unsupported packed data at {path!r}")
    if p.suffix == ".npy":
        return np.load(file)
    raise ValueError(f"unsupported audio path {path!r}")


# ---------------------------------------------------------------- features

def povey_window(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85


def mel_filterbank(
    num_bins: int, n_fft: int, sample_rate: int,
    low_freq: float = 20.0, high_freq: Optional[float] = None,
) -> np.ndarray:
    """Kaldi-style mel filterbank, [n_fft // 2 + 1, num_bins]."""
    high_freq = high_freq or sample_rate / 2
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)
    mel_lo, mel_hi = mel(low_freq), mel(high_freq)
    centers = np.linspace(mel_lo, mel_hi, num_bins + 2)
    fft_freqs = np.arange(n_fft // 2 + 1) * sample_rate / n_fft
    fft_mels = mel(fft_freqs)
    fb = np.zeros((n_fft // 2 + 1, num_bins), dtype=np.float32)
    for b in range(num_bins):
        left, center, right = centers[b], centers[b + 1], centers[b + 2]
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        fb[:, b] = np.maximum(0.0, np.minimum(up, down))
    return fb


def kaldi_fbank(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    num_bins: int = 80,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    dither: float = 0.0,
    preemphasis: float = 0.97,
) -> np.ndarray:
    """80-dim log-mel fbank approximating
    ``torchaudio.compliance.kaldi.fbank`` defaults (snip-edges, povey
    window, energy floor) — used by the reference for S2TT inputs
    (``audio_utils.py:236-273``).

    waveform: [T] float (any scale); returns [frames, num_bins] float32.
    """
    wav = np.asarray(waveform, dtype=np.float32)
    if wav.ndim == 2:
        wav = wav[0]
    frame_len = int(sample_rate * frame_length_ms / 1000)
    shift = int(sample_rate * frame_shift_ms / 1000)
    n_fft = 1 << (frame_len - 1).bit_length()
    if len(wav) < frame_len:
        return np.zeros((0, num_bins), dtype=np.float32)
    n_frames = 1 + (len(wav) - frame_len) // shift
    idx = np.arange(frame_len)[None, :] + shift * np.arange(n_frames)[:, None]
    frames = wav[idx]
    # per-frame DC offset removal, preemphasis, window (kaldi order)
    frames = frames - frames.mean(axis=1, keepdims=True)
    pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames - preemphasis * pre
    frames = frames * povey_window(frame_len)[None, :]
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2
    fb = mel_filterbank(num_bins, n_fft, sample_rate)
    mel_energy = spec @ fb
    return np.log(np.maximum(mel_energy, 1.1920929e-07)).astype(np.float32)


def log_mel_spectrogram(
    waveform: np.ndarray,
    sample_rate: int = 22050,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    num_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = 8000.0,
) -> np.ndarray:
    """HiFi-GAN / TTS-style log-mel (``hifi-gan/meldataset.py:49-80``):
    reflect-padded centered STFT, HTK-slaney-free librosa-like mel, natural
    log with 1e-5 floor. Returns [frames, num_mels]."""
    wav = np.asarray(waveform, dtype=np.float32)
    pad = (n_fft - hop_length) // 2
    wav = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(wav) - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = wav[idx] * np.hanning(win_length + 1)[:-1][None, :]
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1))
    fb = _slaney_mel(num_mels, n_fft, sample_rate, fmin, fmax)
    mel = spec @ fb
    return np.log(np.maximum(mel, 1e-5)).astype(np.float32)


def _slaney_mel(num_mels, n_fft, sr, fmin, fmax):
    """librosa-style (slaney norm) mel basis, [n_fft//2+1, num_mels]."""
    fmax = fmax or sr / 2
    hz2mel = lambda f: np.where(
        f < 1000, f / 200.0 / 3,
        15.0 + np.log(np.maximum(f, 1000) / 1000.0) / (np.log(6.4) / 27.0))
    mel2hz = lambda m: np.where(
        m < 15.0, 200.0 * 3 * m,
        1000.0 * np.exp((m - 15.0) * np.log(6.4) / 27.0))
    mels = np.linspace(hz2mel(np.float64(fmin)), hz2mel(np.float64(fmax)),
                       num_mels + 2)
    hz = mel2hz(mels)
    fft_freqs = np.arange(n_fft // 2 + 1) * sr / n_fft
    fb = np.zeros((n_fft // 2 + 1, num_mels), dtype=np.float32)
    for b in range(num_mels):
        lo, c, hi = hz[b], hz[b + 1], hz[b + 2]
        up = (fft_freqs - lo) / (c - lo)
        down = (hi - fft_freqs) / (hi - c)
        w = np.maximum(0, np.minimum(up, down))
        fb[:, b] = w * (2.0 / (hi - lo))          # slaney area norm
    return fb
