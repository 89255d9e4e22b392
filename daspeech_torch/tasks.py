"""Tasks: dataset/vocab setup, noise injection, batch iterators, generator
construction.

Counterpart of ``daspeech_tpu/tasks.py`` (a rebuild of
``DASpeech/tasks/nat_speech_to_text.py`` and ``nat_speech_to_speech.py``).
A task owns the host-side state (dictionary, datasets, bucket specs); the
models, losses and generators it hands out run on the card. Nothing in the
port dispatches by task name, so the tasks are plain classes.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from daspeech_torch.config import DecodeConfig, VocabConfig
from daspeech_torch.data import (
    BucketBatcher,
    Dictionary,
    NATSpeechToSpeechDataset,
    NATSpeechToTextDataset,
    load_tsv,
    make_buckets,
)
from daspeech_torch.data.data_cfg import S2SDataConfig, S2TDataConfig
from daspeech_torch.data.datasets import (
    TextToSpeechDataset,
    collate_tts,
    round_up,
)


def inject_noise(
    rng: np.random.Generator,
    target: np.ndarray,          # [B, T] padded targets
    vocab: VocabConfig,
    noise: str = "full_mask",
) -> np.ndarray:
    """``inject_noise`` (``nat_speech_to_text.py:138-219``): build the
    corrupted ``prev_target`` for CMLM-style NAT models. The DAG criterion
    builds its own graph input, but the task keeps the full noise API.
    """
    t = target.copy()
    special = (t == vocab.pad) | (t == vocab.bos) | (t == vocab.eos)

    if noise == "full_mask":
        t = np.where(special, t, vocab.unk)
    elif noise == "random_mask":
        u = rng.uniform(size=t.shape)
        ratio = rng.uniform(size=(t.shape[0], 1))
        t = np.where(~special & (u < ratio), vocab.unk, t)
    elif noise == "random_delete":
        out = np.full_like(t, vocab.pad)
        for b in range(t.shape[0]):
            toks = t[b][t[b] != vocab.pad]
            inner = toks[1:-1]
            keep = rng.uniform(size=len(inner)) >= rng.uniform()
            kept = np.concatenate([toks[:1], inner[keep], toks[-1:]])
            out[b, : len(kept)] = kept
        t = out
    elif noise == "no_noise":
        pass
    else:
        raise ValueError(f"unknown noise {noise!r}")
    return t


@dataclasses.dataclass
class TaskConfig:
    data_dir: str = ""
    vocab_filename: str = "vocab.txt"
    config_yaml: str = "config.yaml"   # per-dataset data config (data_cfg.py)
    noise: str = "full_mask"
    max_source_positions: int = 6000
    max_target_positions: int = 1024
    max_target_audio_positions: int = 1200
    max_tokens: int = 40000
    num_buckets: int = 8


class NATSpeechToTextTask:
    """``nat_speech_to_text`` (``DASpeech/tasks/nat_speech_to_text.py``)."""

    dataset_cls = NATSpeechToTextDataset
    for_s2s = False

    def __init__(self, cfg: TaskConfig, tgt_dict: Dictionary, data_cfg=None):
        self.cfg = cfg
        self.tgt_dict = tgt_dict
        self.data_cfg = data_cfg     # S2TDataConfig from config.yaml, or None
        self.datasets: Dict[str, Any] = {}

    @classmethod
    def setup_task(cls, cfg: TaskConfig) -> "NATSpeechToTextTask":
        data_cfg = None
        yaml_path = Path(cfg.data_dir) / cfg.config_yaml
        if yaml_path.is_file():
            cfg_cls = S2SDataConfig if cls.for_s2s else S2TDataConfig
            data_cfg = cfg_cls(yaml_path)
        vocab_name = (data_cfg.vocab_filename if data_cfg is not None
                      else cfg.vocab_filename)
        vocab_path = Path(cfg.data_dir) / vocab_name
        if not vocab_path.is_file():
            vocab_path = Path(cfg.data_dir) / cfg.vocab_filename
        tgt_dict = Dictionary.load(vocab_path)
        return cls(cfg, tgt_dict, data_cfg=data_cfg)

    @property
    def vocab(self) -> VocabConfig:
        d = self.tgt_dict
        return VocabConfig(size=len(d), bos=d.bos(), pad=d.pad(),
                           eos=d.eos(), unk=d.unk())

    def load_dataset(self, split: str, transforms=None,
                     upsample_scale: float = 0.5):
        """``transforms=None`` resolves the split's feature transforms from
        config.yaml (SpecAugment+CMVN on ``_train`` splits, CMVN on eval —
        ``data_cfg.py:155-166``); pass an explicit Compose to override."""
        if transforms is None and self.data_cfg is not None:
            transforms = self.data_cfg.get_feature_transforms(
                split, is_train=split.startswith("train"))
        rows = load_tsv(Path(self.cfg.data_dir) / f"{split}.tsv")
        self.datasets[split] = self.dataset_cls(
            rows, self.tgt_dict, transforms=transforms,
            upsample_scale=upsample_scale)
        return self.datasets[split]

    def get_batch_iterator(self, split: str, max_tokens: Optional[int] = None,
                           seed: int = 1, upsample_scale: float = 0.5,
                           num_buckets: Optional[int] = None):
        ds = self.datasets[split]
        keep = ds.filter_indices(self.cfg.max_source_positions,
                                 self.cfg.max_target_positions)
        lengths = [ds.n_frames(i) for i in keep]
        tgt_cap = min(self.cfg.max_target_positions,
                      max(ds.tgt_len(i) for i in keep) if keep else 8)
        specs = make_buckets(
            lengths, max_tokens or self.cfg.max_tokens,
            num_buckets=num_buckets or self.cfg.num_buckets,
            upsample_scale=upsample_scale, tgt_cap=tgt_cap,
            mel_per_src=(1.0 if self.for_s2s else 0.0))
        return BucketBatcher(ds, keep, specs, seed=seed, vocab=self.vocab,
                             upsample_scale=upsample_scale,
                             max_graph=self.cfg.max_target_positions,
                             for_s2s=self.for_s2s)

    def build_generator(self, model, decode_cfg: DecodeConfig,
                        reranker=None):
        from daspeech_torch.decode.generator import S2TNATGenerator

        return S2TNATGenerator(model, self.vocab, decode_cfg,
                               reranker=reranker)

    def inject_noise(self, rng, target):
        return inject_noise(rng, target, self.vocab, self.cfg.noise)


class NATSpeechToSpeechTask(NATSpeechToTextTask):
    """``nat_speech_to_speech`` (``DASpeech/tasks/nat_speech_to_speech.py``);
    S2S dataset rows add mel/duration/pitch/energy, size checks use the
    3-tuple (src, tgt, tgt_audio) max positions (``:279-280``)."""

    dataset_cls = NATSpeechToSpeechDataset
    for_s2s = True

    def build_generator(self, model, decode_cfg: DecodeConfig,
                        max_mel_len: int = 1024, vocoder=None, gcmvn=None,
                        reranker=None):
        from daspeech_torch.decode.generator import S2SNATGenerator

        return S2SNATGenerator(
            model, self.vocab, decode_cfg, max_mel_len=max_mel_len,
            vocoder=vocoder, gcmvn=gcmvn, reranker=reranker)


class TextToSpeechTask(NATSpeechToTextTask):
    """``text_to_speech`` (``fairseq/fairseq/tasks/text_to_speech.py``) —
    FastSpeech2 pretraining: phoneme tokens -> mel with teacher-forced
    duration/pitch/energy (recipe stage 2, ``README.md:262-283``)."""

    for_s2s = False

    def load_dataset(self, split: str, transforms=None, **kw):
        rows = load_tsv(Path(self.cfg.data_dir) / f"{split}.tsv")
        self.datasets[split] = TextToSpeechDataset(
            rows, self.tgt_dict, speaker_to_id=self.speaker_to_id())
        return self.datasets[split]

    def speaker_to_id(self):
        """Speaker table from the data config's ``speaker_set_filename``
        (one name per line — ``text_to_speech.py:71-95``); None when the
        config is single-speaker."""
        path = (self.data_cfg.speaker_set_filename
                if self.data_cfg is not None else None)
        if not path:
            return None
        with open(path) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        return {name: i for i, name in enumerate(names)}

    def get_batch_iterator(self, split: str, max_sentences: int = 64,
                           seed: int = 1, **kw):
        return TTSBatcher(self.datasets[split], self.vocab.pad,
                          max_sentences, seed)

    def build_generator(self, model, max_mel_len: int = 2048, vocoder=None,
                        gcmvn=None):
        from daspeech_torch.decode.speech_generator import (
            NonAutoregressiveSpeechGenerator)

        return NonAutoregressiveSpeechGenerator(
            model, self.vocab, max_mel_len=max_mel_len, vocoder=vocoder,
            gcmvn=gcmvn)


class TTSBatcher:
    """The TTS task's batch iterator (``tasks.py``'s ``_It``): a seeded
    shuffle cut into ``max_sentences`` batches, each padded to the
    dataset's longest phoneme and mel lengths."""

    def __init__(self, dataset, pad: int, max_sentences: int, seed: int):
        self.dataset = dataset
        self.pad = pad
        self.max_sentences = max_sentences
        self.seed = seed
        n = len(dataset)
        self.tok_cap = round_up(max(dataset.tgt_len(i) for i in range(n)), 8)
        self.mel_cap = round_up(max(dataset.n_frames(i) for i in range(n)),
                                64)

    def batches_for_epoch(self, epoch):
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self.dataset))
        return [(None, [int(i) for i in order[k:k + self.max_sentences]])
                for k in range(0, len(order), self.max_sentences)]

    def collate(self, spec, idxs, pad_last: bool = True):
        """Pad to the batcher's dims; with ``pad_last`` also the batch axis
        to ``max_sentences`` (repeats of the first item, ``sample_mask``
        0)."""
        return collate_tts([self.dataset[i] for i in idxs], self.pad,
                           self.tok_cap, self.mel_cap,
                           self.max_sentences if pad_last else len(idxs))

    def __iter__(self):
        for spec, idxs in self.batches_for_epoch(0):
            yield self.collate(spec, idxs)
