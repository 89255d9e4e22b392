"""TSV-manifest datasets for S2TT and S2ST, with fixed-shape bucketed
token-budget batching.

A copy of ``daspeech_tpu/data/datasets.py``: a rebuild of
``DASpeech/datasets/nat_speech_to_text_dataset.py`` /
``nat_speech_to_speech_dataset.py`` + fairseq's ``batch_by_size``, with
batches padded to a small set of per-bucket shapes (``BucketSpec``), so that
the two packages batch a dataset alike. ``BucketBatcher.collate`` pads the
batch axis to the bucket's size only with ``pad_last=True``.

TSV columns (``nat_speech_to_speech_dataset.py:323-359``):
  S2TT: id audio n_frames tgt_text
  S2ST: id src_audio src_n_frames tgt_text tgt_audio tgt_n_frames
        duration pitch energy
where audio fields use the ``file.zip:offset:length`` grammar and
duration/pitch/energy are space-separated per-phoneme numbers (duration has
a trailing 0 for EOS).
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from daspeech_torch.data.audio_utils import get_features_or_waveform
from daspeech_torch.data import native
from daspeech_torch.data.dictionary import Dictionary
from daspeech_torch.telemetry import span


def load_tsv(path) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        reader = csv.DictReader(
            f, delimiter="\t", quotechar=None, doublequote=False,
            lineterminator="\n", quoting=csv.QUOTE_NONE)
        return [dict(r) for r in reader]


@dataclasses.dataclass
class S2TItem:
    utt_id: str
    fbank: np.ndarray          # [S, 80]
    target: np.ndarray         # [T] int32 (<bos> ... <eos>)


@dataclasses.dataclass
class S2SItem(S2TItem):
    mel: Optional[np.ndarray] = None        # [M, 80]
    duration: Optional[np.ndarray] = None   # [T-1] int32 (per phoneme + eos 0)
    pitch: Optional[np.ndarray] = None      # [T-1] f32
    energy: Optional[np.ndarray] = None     # [T-1] f32


class NATSpeechToTextDataset:
    """``NATSpeechToTextDataset``: targets get <bos> prepended and <eos>
    appended (``nat_speech_to_text_dataset.py:28-52``)."""

    def __init__(self, rows: Sequence[Dict[str, str]], tgt_dict: Dictionary,
                 transforms=None, upsample_scale: float = 0.5,
                 subsample: int = 1):
        self.rows = list(rows)
        self.tgt_dict = tgt_dict
        self.transforms = transforms
        self.upsample_scale = upsample_scale
        self.subsample = subsample

    def __len__(self):
        return len(self.rows)

    def n_frames(self, i: int) -> int:
        return int(self.rows[i].get("n_frames")
                   or self.rows[i]["src_n_frames"])

    def tgt_len(self, i: int) -> int:
        return len(self._tgt_text(i).split()) + 2   # + bos + eos

    def _tgt_text(self, row_or_i) -> str:
        row = (self.rows[row_or_i] if isinstance(row_or_i, int) else row_or_i)
        return row.get("tgt_text") or row.get("target") or ""

    def filter_indices(self, max_source: int, max_target: int) -> List[int]:
        """Keep samples satisfying both length caps AND the DAG feasibility
        invariant lambda * N >= M + 2 (``nat_speech_to_text.py:367-412``)."""
        keep = []
        for i in range(len(self.rows)):
            n, m = self.n_frames(i), self.tgt_len(i)
            graph = int(n * self.upsample_scale)
            if n <= max_source and m <= max_target and graph >= m + 2:
                keep.append(i)
        return keep

    def __getitem__(self, i: int) -> S2TItem:
        row = self.rows[i]
        audio = row.get("audio") or row.get("src_audio")
        fbank = get_features_or_waveform(audio)
        if self.transforms is not None:
            fbank = self.transforms(fbank)
        target = self.tgt_dict.encode_line(
            self._tgt_text(row), append_eos=True, prepend_bos=True)
        return S2TItem(row["id"], fbank.astype(np.float32), target)


class NATSpeechToSpeechDataset(NATSpeechToTextDataset):
    """``NATSpeechToSpeechDataset`` (``nat_speech_to_speech_dataset.py``):
    adds target mel, per-phoneme duration (+0 for EOS), pitch, energy."""

    def __getitem__(self, i: int) -> S2SItem:
        base = super().__getitem__(i)
        row = self.rows[i]
        mel = None
        if row.get("tgt_audio"):
            mel = get_features_or_waveform(row["tgt_audio"]).astype(np.float32)
        dur = pitch = energy = None
        if row.get("duration"):
            dur = np.asarray(
                [int(x) for x in row["duration"].split()], np.int32)
        if row.get("pitch"):
            pitch = np.asarray(
                [float(x) for x in row["pitch"].split()], np.float32)
        if row.get("energy"):
            energy = np.asarray(
                [float(x) for x in row["energy"].split()], np.float32)
        return S2SItem(base.utt_id, base.fbank, base.target,
                       mel=mel, duration=dur, pitch=pitch, energy=energy)


class NATTextTargetMultitaskData:
    """Auxiliary text targets for multitask training, keyed by utterance id,
    with <bos> prepended and <eos> appended for NAT generation
    (``NATTextTargetMultitaskData``, ``nat_speech_to_text_dataset.py:116-155``).
    """

    def __init__(self, rows: Sequence[Dict[str, str]], tgt_dict: Dictionary,
                 text_key: str = "tgt_text"):
        self.dict = tgt_dict
        self.data = {r["id"]: r[text_key] for r in rows if r.get(text_key)}

    def get(self, sample_id: str) -> np.ndarray:
        text = self.data.get(sample_id)
        if text is None:
            return np.zeros((0,), np.int32)
        return self.dict.encode_line(text, append_eos=True, prepend_bos=True)

    def collater(self, samples: Sequence[np.ndarray],
                 cap: Optional[int] = None) -> Dict[str, np.ndarray]:
        lengths = np.asarray([len(s) for s in samples], np.int32)
        T = int(cap or max(int(lengths.max()), 1))
        out = np.full((len(samples), T), self.dict.pad(), np.int32)
        for b, s in enumerate(samples):
            n = min(len(s), T)
            out[b, :n] = s[:n]
        return {"target": out, "target_lengths": np.minimum(lengths, T),
                "ntokens": int(lengths.sum())}


class NATSpeechToTextMultitaskDataset(NATSpeechToTextDataset):
    """S2T dataset carrying per-task auxiliary text targets
    (``NATSpeechToTextMultitaskDataset``,
    ``nat_speech_to_text_dataset.py:158-210``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.multitask_data: Dict[str, NATTextTargetMultitaskData] = {}

    def add_multitask_dataset(self, task_name: str,
                              task_data: NATTextTargetMultitaskData):
        self.multitask_data[task_name] = task_data

    def multitask_targets(self, i: int) -> Dict[str, np.ndarray]:
        sample_id = self.rows[i]["id"]
        return {name: data.get(sample_id)
                for name, data in self.multitask_data.items()}


# ----------------------------------------------------------------- batching

def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static padded dims of one bucket's batches."""
    batch: int
    src: int          # fbank frames
    graph: int        # DAG vertices (= src * upsample, rounded up)
    tgt: int          # target tokens
    mel: int = 0      # mel frames (S2S only)


def make_buckets(
    lengths: Sequence[int],
    max_tokens: int,
    num_buckets: int = 8,
    src_mult: int = 64,
    upsample_scale: float = 0.5,
    tgt_cap: int = 256,
    mel_per_src: float = 0.0,
    mel_mult: int = 64,
) -> List[BucketSpec]:
    """Quantile-spaced source-length buckets; per-bucket batch size from the
    token budget (replaces ``data_utils_fast.pyx`` dynamic batching)."""
    arr = np.asarray(sorted(lengths))
    qs = np.linspace(0, 1, num_buckets + 1)[1:]
    edges = sorted({round_up(int(np.quantile(arr, q)), src_mult) for q in qs})
    specs = []
    for e in edges:
        bsz = max(1, max_tokens // e)
        graph = round_up(int(e * upsample_scale), 8)
        mel = round_up(int(e * mel_per_src), mel_mult) if mel_per_src else 0
        specs.append(BucketSpec(batch=bsz, src=e, graph=max(graph, 8),
                                tgt=tgt_cap, mel=mel))
    return specs


def pick_bucket(specs: Sequence[BucketSpec], src_len: int) -> BucketSpec:
    for s in specs:
        if src_len <= s.src:
            return s
    return specs[-1]


class BucketBatcher:
    """Length-sorted shuffled batching into fixed bucket shapes
    (the lexsort shuffle of ``nat_speech_to_speech_dataset.py:309-316``
    + ``batch_by_size``, but yielding constant-shape batches)."""

    def __init__(self, dataset, indices: Sequence[int],
                 specs: Sequence[BucketSpec], seed: int = 1,
                 vocab=None, upsample_scale: float = 0.5,
                 max_graph: int = 1024, for_s2s: bool = False):
        self.dataset = dataset
        self.indices = list(indices)
        self.specs = list(specs)
        self.seed = seed
        self.vocab = vocab
        self.upsample_scale = upsample_scale
        self.max_graph = max_graph
        self.for_s2s = for_s2s

    def batches_for_epoch(self, epoch: int) -> List[List[int]]:
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(self.indices)
        # group by bucket
        groups: Dict[BucketSpec, List[int]] = {}
        for i in order:
            s = pick_bucket(self.specs, self.dataset.n_frames(int(i)))
            groups.setdefault(s, []).append(int(i))
        batches = []
        for s, idxs in groups.items():
            for k in range(0, len(idxs), s.batch):
                batches.append((s, idxs[k:k + s.batch]))
        perm = rng.permutation(len(batches))
        return [batches[int(p)] for p in perm]

    def collate(self, spec: BucketSpec, idxs: Sequence[int],
                pad_last: bool = True) -> Dict[str, np.ndarray]:
        """Pad items to the bucket's static dims; short batches are filled
        by repeating the first item with zero weight via ``sample_mask``.
        Runs in a ``data.collate`` span."""
        with span("data.collate"):
            return self._collate(spec, idxs, pad_last)

    def _collate(self, spec: BucketSpec, idxs: Sequence[int],
                 pad_last: bool) -> Dict[str, np.ndarray]:
        items = [self.dataset[i] for i in idxs]
        B = spec.batch if pad_last else len(items)
        n_real = len(items)
        while len(items) < B:
            items.append(items[0])

        fbank = native.pack_frames([it.fbank for it in items], spec.src)
        src_lengths = np.asarray(
            [min(len(it.fbank), spec.src) for it in items], np.int32)
        target = native.pack_tokens(
            [it.target for it in items], spec.tgt, self.vocab.pad)

        glen = np.clip((src_lengths * self.upsample_scale).astype(np.int32),
                       2, min(spec.graph, self.max_graph))
        # pure-numpy initialize_output_tokens (same math as
        # models/dag_model.py::initialize_output_tokens): the collate runs
        # on the prefetch producer thread and does no device work
        idx = np.arange(spec.graph)[None, :]
        prev = np.where(idx < glen[:, None], self.vocab.unk,
                        self.vocab.pad).astype(np.int32)
        prev[:, 0] = self.vocab.bos
        prev[idx == (glen[:, None] - 1)] = self.vocab.eos

        batch = {
            "fbank": fbank,
            "src_lengths": src_lengths,
            "target": target,
            "prev_output_tokens": prev,
            "sample_mask": (np.arange(B) < n_real).astype(np.float32),
        }
        if self.for_s2s:
            batch["target_text"] = batch.pop("target")
            M = spec.mel or spec.src
            mel = np.zeros((B, M, 80), np.float32)
            mel_lengths = np.zeros((B,), np.int32)
            Tm = spec.tgt - 1
            dur = np.zeros((B, Tm), np.int32)
            pitch = np.zeros((B, Tm), np.float32)
            energy = np.zeros((B, Tm), np.float32)
            for b, it in enumerate(items):
                if it.mel is not None:
                    m = min(len(it.mel), M)
                    mel[b, :m] = it.mel[:m]
                    mel_lengths[b] = m
                for arr, dst in ((it.duration, dur), (it.pitch, pitch),
                                 (it.energy, energy)):
                    if arr is not None:
                        n = min(len(arr), Tm)
                        dst[b, :n] = arr[:n]
            batch.update(target_audio=mel, target_audio_lengths=mel_lengths,
                         durations=dur, pitches=pitch, energies=energy)
        multitask = getattr(self.dataset, "multitask_data", None)
        if multitask:
            # per-task padded aux targets (collater caps at the bucket's tgt
            # dim so shapes stay static); reference collate:
            # ``nat_speech_to_text_dataset.py:180-210``
            fill_idxs = list(idxs) + [idxs[0]] * (B - n_real)
            batch["multitask"] = {
                name: data.collater(
                    [data.get(self.dataset.rows[int(i)]["id"])
                     for i in fill_idxs], cap=spec.tgt)
                for name, data in multitask.items()
            }
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for spec, idxs in self.batches_for_epoch(0):
            yield self.collate(spec, idxs)


@dataclasses.dataclass
class TTSItem:
    utt_id: str
    tokens: np.ndarray         # [T] int32 phonemes (+eos, no bos)
    mel: np.ndarray            # [M, 80]
    duration: np.ndarray       # [T]
    pitch: np.ndarray          # [T]
    energy: np.ndarray         # [T]
    speaker: int = 0           # id via speaker_to_id (0 = single-speaker)


class TextToSpeechDataset:
    """TTS pretraining dataset (``fairseq/fairseq/data/audio/
    text_to_speech_dataset.py``): the 'audio' column holds the target mel,
    'tgt_text' the phoneme sequence; duration has a trailing 0 for EOS
    (``DATA_PREPARE.md`` TTS prep)."""

    def __init__(self, rows: Sequence[Dict[str, str]], tgt_dict: Dictionary,
                 speaker_to_id: Optional[Dict[str, int]] = None):
        self.rows = list(rows)
        self.tgt_dict = tgt_dict
        # multi-speaker conditioning (``text_to_speech_dataset.py:135-139``):
        # the TSV's 'speaker' column maps through speaker_to_id into the
        # model's embed_speaker table; None = single-speaker (id 0)
        self.speaker_to_id = speaker_to_id

    def __len__(self):
        return len(self.rows)

    def n_frames(self, i: int) -> int:
        row = self.rows[i]
        return int(row.get("n_frames") or row["tgt_n_frames"])

    def tgt_len(self, i: int) -> int:
        return len(self.rows[i]["tgt_text"].split()) + 1   # + eos

    def __getitem__(self, i: int) -> TTSItem:
        row = self.rows[i]
        # a TTS-specific tsv uses 'audio'; an S2ST tsv carries the same
        # information in 'tgt_audio' (``create_tsv.py`` join)
        mel_path = row.get("audio") or row["tgt_audio"]
        mel = get_features_or_waveform(mel_path).astype(np.float32)
        tokens = self.tgt_dict.encode_line(
            row["tgt_text"], append_eos=True, prepend_bos=False)
        dur = np.asarray([int(x) for x in row["duration"].split()], np.int32)
        pitch = np.asarray([float(x) for x in row["pitch"].split()],
                           np.float32)
        energy = np.asarray([float(x) for x in row["energy"].split()],
                            np.float32)
        speaker = 0
        if self.speaker_to_id is not None and row.get("speaker"):
            speaker = self.speaker_to_id[row["speaker"]]
        return TTSItem(row["id"], tokens, mel, dur, pitch, energy, speaker)


def collate_tts(items: Sequence[TTSItem], pad: int, tok_cap: int,
                mel_cap: int, batch: int) -> Dict[str, np.ndarray]:
    """Pad a TTS batch to static dims (tokens and aligned variance rows to
    ``tok_cap``, mel to ``mel_cap``)."""
    n_real = len(items)
    items = list(items)
    while len(items) < batch:
        items.append(items[0])
    B = len(items)
    tokens = np.full((B, tok_cap), pad, np.int32)
    mel = np.zeros((B, mel_cap, items[0].mel.shape[1]), np.float32)
    mel_lengths = np.zeros((B,), np.int32)
    dur = np.zeros((B, tok_cap), np.int32)
    pitch = np.zeros((B, tok_cap), np.float32)
    energy = np.zeros((B, tok_cap), np.float32)
    speaker = np.zeros((B,), np.int32)
    for b, it in enumerate(items):
        t = min(len(it.tokens), tok_cap)
        tokens[b, :t] = it.tokens[:t]
        m = min(len(it.mel), mel_cap)
        mel[b, :m] = it.mel[:m]
        mel_lengths[b] = m
        speaker[b] = it.speaker
        for src, dst in ((it.duration, dur), (it.pitch, pitch),
                         (it.energy, energy)):
            n = min(len(src), tok_cap)
            dst[b, :n] = src[:n]
    return {
        "src_tokens": tokens,
        "target_audio": mel,
        "target_audio_lengths": mel_lengths,
        "durations": dur,
        "pitches": pitch,
        "energies": energy,
        "speaker": speaker,
        "sample_mask": (np.arange(B) < n_real).astype(np.float32),
    }
