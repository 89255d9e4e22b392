"""Seeded speech traffic: utterance lengths and the data directory the
program's task reads.

The lengths of a mix are drawn once from the mix's own ``lengths_seed``, so
every run serves the same set of sizes; a run's ``--seed`` draws the
features and the order they are served in. Nothing here imports the program.
"""

from __future__ import annotations

import csv
import io
import zipfile
from pathlib import Path
from typing import List, Sequence

import numpy as np

FBANK_DIM = 80
NSPECIAL = 4          # <s> <pad> </s> <unk>, the first rows of the dictionary


def utterance_frames(mix: dict) -> List[int]:
    """Source lengths in fbank frames: log-normal seconds with median
    ``median_s`` and shape ``sigma``, clipped to [``min_s``, ``max_s``], at
    ``fbank_rate`` frames a second, from the mix's ``lengths_seed``."""
    rng = np.random.default_rng(mix["lengths_seed"])
    sec = rng.lognormal(np.log(mix["median_s"]), mix["sigma"],
                        size=mix["utterances"])
    sec = np.clip(sec, mix["min_s"], mix["max_s"])
    return [int(round(s * mix["fbank_rate"])) for s in sec]


def pack_npy_zip(path: Path, arrays: Sequence[np.ndarray]) -> List[str]:
    """Store ``arrays`` as .npy members of an uncompressed zip; returns
    their ``zip:offset:length`` paths (fairseq's packed audio layout)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for i, a in enumerate(arrays):
            buf = io.BytesIO()
            np.save(buf, a)
            zf.writestr(f"{i}.npy", buf.getvalue())
    with zipfile.ZipFile(path) as zf:
        return [f"{path}:{info.header_offset + len(info.FileHeader())}:"
                f"{info.file_size}" for info in zf.infolist()]


def write_runtime_data(root: Path, split: str, frames: Sequence[int],
                       vocab_size: int, tokens_per_s: float, fbank_rate: int,
                       seed: int) -> None:
    """A CVSS-style data directory: ``vocab.txt`` with ``vocab_size``
    symbols in all (fairseq's "symbol count" lines after the four specials)
    and ``<split>.tsv`` whose utterances have N(0, 1) fbank features of the
    given lengths (one stored zip) and targets of ``tokens_per_s`` random
    phonemes a second. Speech targets (mel, durations, pitch, energy) are
    left empty: the benchmark's serving cells do not read them."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    symbols = [f"P{i}" for i in range(vocab_size - NSPECIAL)]
    (root / "vocab.txt").write_text("".join(f"{s} 1\n" for s in symbols))
    fbanks = [rng.standard_normal((s, FBANK_DIM), dtype=np.float32)
              for s in frames]
    rows = []
    for i, (s, audio) in enumerate(zip(frames, pack_npy_zip(
            root / f"{split}_fbank.zip", fbanks))):
        n = max(1, int(round(s / fbank_rate * tokens_per_s)))
        text = " ".join(symbols[int(t)] for t in rng.integers(
            0, len(symbols), size=n))
        rows.append({"id": f"utt{i:05d}", "src_audio": audio,
                     "src_n_frames": str(s), "tgt_text": text,
                     "tgt_audio": "", "tgt_n_frames": "0", "duration": "",
                     "pitch": "", "energy": ""})
    with open(root / f"{split}.tsv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t",
                           lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
