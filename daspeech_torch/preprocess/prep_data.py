"""Offline data preparation: fbank/mel extraction, per-phoneme variance
targets, gcmvn stats, TSV manifests. The port's numpy copy of
``daspeech_tpu/preprocess/prep_data.py``, on the port's own
``data/audio_utils.py``; host-only, like the original.

Rebuild of the reference prep pipeline (``translatotron/preprocess/
prep_cvss_c_multilingual_data.py``, ``prep_cvss_c_tts_data.py``, and
``fairseq/examples/speech_synthesis/data_utils.py:46-180``):

- S2TT inputs: 80-dim kaldi-style fbank, zip-packed .npy per utterance.
- TTS targets: log-mel (n_fft 1024, hop 256, 22.05 kHz), per-phoneme
  duration from alignment intervals, pitch averaged per phoneme, energy
  (frame magnitude) averaged per phoneme, gcmvn stats.
- Pitch: the reference uses pyworld dio+stonemask (an offline C library);
  this host lacks it, so the default ``pitch_fn`` is ``yin_stonemask_pitch``
  — a pure-numpy YIN coarse pass plus a StoneMask-style harmonic-spectrum
  refinement (<0.5 Hz error on harmonic tones) with the same per-phoneme
  averaging; pass ``pitch_fn`` to plug pyworld when available.
"""

from __future__ import annotations

import csv
import io
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from daspeech_torch.data.audio_utils import kaldi_fbank, log_mel_spectrogram


def pack_features_to_zip(
    feats: Sequence[np.ndarray], names: Sequence[str], zip_path
) -> List[str]:
    """Write feature matrices as stored (uncompressed) .npy zip members and
    return 'zip:offset:length' paths (``audio_utils.py:276-293`` layout)."""
    zip_path = Path(zip_path)
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_STORED) as zf:
        for name, f in zip(names, feats):
            buf = io.BytesIO()
            np.save(buf, np.ascontiguousarray(f, dtype=np.float32))
            zf.writestr(f"{name}.npy", buf.getvalue())
    paths = []
    with zipfile.ZipFile(zip_path) as zf:
        for info in zf.infolist():
            offset = info.header_offset + len(info.FileHeader())
            paths.append(f"{zip_path}:{offset}:{info.file_size}")
    return paths


def yin_pitch(
    wav: np.ndarray, sample_rate: int, hop: int = 256, win: int = 1024,
    fmin: float = 60.0, fmax: float = 400.0, threshold: float = 0.15,
) -> np.ndarray:
    """Frame-level F0 via the YIN difference function (pure numpy, offline).
    Unvoiced frames return 0, matching pyworld-dio's convention as consumed
    by the reference prep (zeros are excluded from per-phoneme means)."""
    n_frames = max(0, 1 + (len(wav) - win) // hop)
    f0 = np.zeros(n_frames, dtype=np.float32)
    tau_min = int(sample_rate / fmax)
    tau_max = min(int(sample_rate / fmin), win - 1)
    for i in range(n_frames):
        frame = wav[i * hop: i * hop + win].astype(np.float64)
        # difference function via autocorrelation
        ac = np.correlate(frame, frame, mode="full")[win - 1:]
        power = (frame ** 2).cumsum()
        d = power[-1] + (power[-1] - np.concatenate([[0], power[:-1]])) - 2 * ac
        d = d[: tau_max + 1]
        # cumulative mean normalized difference
        cumsum = np.cumsum(d[1:])
        cmnd = np.ones_like(d)
        cmnd[1:] = d[1:] * np.arange(1, len(d)) / np.maximum(cumsum, 1e-12)
        below = np.where(cmnd[tau_min:] < threshold)[0]
        if len(below):
            tau = tau_min + below[0]
            # parabolic interpolation
            if 0 < tau < len(cmnd) - 1:
                a, b, c = cmnd[tau - 1], cmnd[tau], cmnd[tau + 1]
                denom = a - 2 * b + c
                if abs(denom) > 1e-12:
                    tau = tau + 0.5 * (a - c) / denom
            f0[i] = sample_rate / max(tau, 1e-6)
    return f0


def stonemask_refine(
    wav: np.ndarray, f0: np.ndarray, sample_rate: int, hop: int = 256,
    win: int = 1024, n_harmonics: int = 3, rel_span: float = 0.05,
    n_grid: int = 9,
) -> np.ndarray:
    """StoneMask-style F0 refinement (the second stage of the reference's
    pyworld pipeline, ``data_utils.py:88-96``): for each voiced frame,
    re-locate F0 as the harmonic-spectrum peak near the coarse estimate.

    A windowed DFT is evaluated on a small frequency grid spanning
    +/-``rel_span`` around the YIN candidate; the score at each candidate
    sums the magnitudes of its first ``n_harmonics`` harmonics (linear, so
    an absent harmonic contributes ~nothing instead of sidelobe noise),
    and the maximum is parabolic-interpolated. On synthetic harmonic tones
    this cuts the F0 error well under 1 Hz (see
    ``tests/test_preprocess.py``). Unvoiced frames (0) pass through.
    """
    refined = f0.copy().astype(np.float32)
    window = np.hanning(win)
    n = np.arange(win)
    for i in range(len(f0)):
        if f0[i] <= 0:
            continue
        start = i * hop
        seg = wav[start: start + win].astype(np.float64)
        if len(seg) < win:
            continue
        seg = seg * window
        cands = f0[i] * (1.0 + rel_span * np.linspace(-1, 1, n_grid))
        scores = np.zeros(n_grid)
        for g, fc in enumerate(cands):
            s = 0.0
            for k in range(1, n_harmonics + 1):
                fk = fc * k
                if fk >= sample_rate / 2:
                    break
                phase = -2j * np.pi * fk * n / sample_rate
                s += np.abs(np.sum(seg * np.exp(phase)))
            scores[g] = s
        j = int(np.argmax(scores))
        if 0 < j < n_grid - 1:
            a, b, c = scores[j - 1], scores[j], scores[j + 1]
            denom = a - 2 * b + c
            off = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            j = j + np.clip(off, -0.5, 0.5)
        refined[i] = float(np.interp(j, np.arange(n_grid), cands))
    return refined


def yin_stonemask_pitch(wav: np.ndarray, sample_rate: int,
                        hop: int = 256, win: int = 1024, **kw) -> np.ndarray:
    """YIN coarse estimate + StoneMask-style refinement — the default
    ``pitch_fn`` (the closest pure-numpy analogue of pyworld
    dio+stonemask)."""
    f0 = yin_pitch(wav, sample_rate, hop=hop, win=win, **kw)
    return stonemask_refine(wav, f0, sample_rate, hop=hop, win=win)


def frame_energy(wav: np.ndarray, hop: int = 256, win: int = 1024,
                 n_fft: int = 1024) -> np.ndarray:
    """Frame L2 magnitude of the STFT (the reference's energy target,
    ``data_utils.py:99-104``)."""
    pad = (n_fft - hop) // 2
    w = np.pad(wav.astype(np.float32), (pad, pad), mode="reflect")
    n_frames = max(0, 1 + (len(w) - n_fft) // hop)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = w[idx] * np.hanning(n_fft + 1)[:-1][None, :]
    spec = np.abs(np.fft.rfft(frames, axis=1))
    return np.linalg.norm(spec, axis=1).astype(np.float32)


def make_pitch_fn(name: str = "yin", hop: int = 256):
    """Resolve a ``pitch_fn`` by name: ``yin`` (default; pure-numpy YIN +
    StoneMask-style refinement) or ``pyworld`` (the reference's exact
    dio+stonemask, ``data_utils.py:88-96``). ``pyworld`` HARD-fails when
    the package is absent — a silent fallback would silently change the
    stage-2/3 pitch targets vs reference-prepped data (measured YIN-vs-
    ground-truth deviation documented in COVERAGE.md; pyworld's own
    octave/voicing decisions can differ more on real speech)."""
    if name == "pyworld":
        try:
            import pyworld
        except ImportError as e:
            raise ImportError(
                "pitch_fn='pyworld' requested for reference-parity prep, "
                "but the pyworld package is not installed on this host. "
                "Install pyworld, or use pitch_fn='yin' (pure numpy; "
                "expected deviation from pyworld documented in COVERAGE.md)"
            ) from e

        def pyworld_pitch(wav: np.ndarray, sample_rate: int) -> np.ndarray:
            w = np.ascontiguousarray(wav, dtype=np.float64)
            f0, t = pyworld.dio(
                w, sample_rate, frame_period=hop / sample_rate * 1000.0)
            return pyworld.stonemask(w, f0, t, sample_rate).astype(
                np.float32)

        return pyworld_pitch
    if name == "yin":
        return lambda w, sr: yin_stonemask_pitch(w, sr, hop=hop)
    raise ValueError(f"unknown pitch_fn {name!r} (yin | pyworld)")


def average_by_duration(values: np.ndarray, durations: Sequence[int],
                        exclude_zeros: bool = True) -> np.ndarray:
    """Average a frame-level contour per phoneme span
    (``data_utils.py:88-96``: pitch averaged over voiced frames only)."""
    out = np.zeros(len(durations), dtype=np.float32)
    pos = 0
    for i, d in enumerate(durations):
        seg = values[pos: pos + int(d)]
        if exclude_zeros:
            seg = seg[seg != 0]
        out[i] = float(seg.mean()) if len(seg) else 0.0
        pos += int(d)
    return out


def durations_from_intervals(
    intervals: Sequence[Tuple[float, float]], hop: int, sample_rate: int,
    total_frames: Optional[int] = None,
) -> np.ndarray:
    """Phoneme (start_sec, end_sec) intervals (e.g. from MFA TextGrids,
    ``DATA_PREPARE.md:48-67``) -> integer frame durations summing to the
    mel length."""
    bounds = [0] + [int(round(e * sample_rate / hop)) for _, e in intervals]
    durs = np.diff(bounds).clip(min=0)
    if total_frames is not None and len(durs):
        durs[-1] = max(0, total_frames - int(bounds[-2]))
    return durs.astype(np.int32)


def compute_gcmvn_stats(feats: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
    """Global CMVN statistics over a corpus (``data_cfg.py:179-182``)."""
    total = np.zeros(feats[0].shape[1], np.float64)
    total_sq = np.zeros_like(total)
    n = 0
    for f in feats:
        total += f.sum(0)
        total_sq += (f.astype(np.float64) ** 2).sum(0)
        n += len(f)
    mean = total / n
    std = np.sqrt(np.maximum(total_sq / n - mean ** 2, 1e-10))
    return {"mean": mean.astype(np.float32), "std": std.astype(np.float32)}


def extract_s2t_features(
    waveforms: Sequence[np.ndarray], names: Sequence[str],
    sample_rate: int, zip_path,
) -> List[Dict[str, str]]:
    """wav -> 80-dim fbank zip + manifest rows (id/audio/n_frames)."""
    feats = [kaldi_fbank(w, sample_rate) for w in waveforms]
    paths = pack_features_to_zip(feats, names, zip_path)
    return [
        {"id": n, "audio": p, "n_frames": str(len(f))}
        for n, p, f in zip(names, paths, feats)
    ]


def extract_tts_features(
    waveforms: Sequence[np.ndarray], names: Sequence[str],
    phoneme_intervals: Sequence[Sequence[Tuple[str, float, float]]],
    sample_rate: int, zip_path, pitch_fn=None,
) -> Tuple[List[Dict[str, str]], Dict[str, np.ndarray]]:
    """wav + MFA phoneme intervals -> TTS manifest rows with mel zip paths,
    per-phoneme duration/pitch/energy strings, and gcmvn stats."""
    pitch_fn = pitch_fn or (lambda w, sr: yin_stonemask_pitch(w, sr))
    mels, rows = [], []
    for w, name, ivs in zip(waveforms, names, phoneme_intervals):
        mel = log_mel_spectrogram(w, sample_rate)
        phones = [p for p, _, _ in ivs]
        durs = durations_from_intervals(
            [(s, e) for _, s, e in ivs], 256, sample_rate, len(mel))
        pitch = average_by_duration(pitch_fn(w, sample_rate), durs)
        energy = average_by_duration(frame_energy(w), durs,
                                     exclude_zeros=False)
        mels.append(mel)
        rows.append({
            "id": name,
            "n_frames": str(len(mel)),
            "tgt_text": " ".join(phones) ,
            "duration": " ".join(str(int(d)) for d in durs) + " 0",
            "pitch": " ".join(f"{x:.4f}" for x in pitch) + " 0",
            "energy": " ".join(f"{x:.4f}" for x in energy) + " 0",
        })
    paths = pack_features_to_zip(mels, names, zip_path)
    for row, p in zip(rows, paths):
        row["audio"] = p
    return rows, compute_gcmvn_stats(mels)


def create_s2s_tsv(
    s2t_rows: Sequence[Dict[str, str]], tts_rows: Sequence[Dict[str, str]],
) -> List[Dict[str, str]]:
    """Join the S2TT and TTS manifests by id into the S2ST training TSV
    (``DASpeech/preprocess_scripts/create_tsv.py``)."""
    tts_by_id = {r["id"]: r for r in tts_rows}
    out = []
    for r in s2t_rows:
        t = tts_by_id.get(r["id"])
        if t is None:
            continue
        out.append({
            "id": r["id"],
            "src_audio": r["audio"],
            "src_n_frames": r["n_frames"],
            "tgt_text": t["tgt_text"],
            "tgt_audio": t["audio"],
            "tgt_n_frames": t["n_frames"],
            "duration": t["duration"],
            "pitch": t["pitch"],
            "energy": t["energy"],
        })
    return out


def write_tsv(rows: Sequence[Dict[str, str]], path) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()),
                           delimiter="\t")
        w.writeheader()
        for r in rows:
            w.writerow(r)


def write_config_yaml(
    data_dir,
    vocab_filename: str = "vocab.txt",
    gcmvn_stats: str = "gcmvn_stats.npz",
    specaugment: bool = True,
    vocoder: Dict[str, str] = None,
) -> None:
    """Emit the per-dataset config.yaml the tasks consume (the CVSS recipe's
    gen_config_yaml: utterance_cmvn everywhere + SpecAugment on train —
    ``fairseq/examples/speech_to_text/data_utils.py`` gen_config_yaml)."""
    import yaml

    train = ["utterance_cmvn"] + (["specaugment"] if specaugment else [])
    cfg = {
        "vocab_filename": vocab_filename,
        "transforms": {"_train": train, "*": ["utterance_cmvn"]},
        "specaugment": {"freq_mask_N": 2, "freq_mask_F": 27,
                        "time_mask_N": 2, "time_mask_T": 100,
                        "time_mask_p": 1.0},
    }
    if gcmvn_stats:
        cfg["global_cmvn"] = {"stats_npz_path": gcmvn_stats}
    if vocoder:
        cfg["vocoder"] = dict(vocoder)
    (Path(data_dir) / "config.yaml").write_text(yaml.safe_dump(cfg))
