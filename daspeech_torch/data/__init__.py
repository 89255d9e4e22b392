"""The port's host-side data pipeline: numpy copies of
``daspeech_tpu/data/`` (manifests, zip-packed features, transforms, the
per-dataset config, bucketed batching, the native collation engine) and a
prefetcher that moves batches to the card on its producer thread."""

from daspeech_torch.data.audio_utils import (
    get_features_or_waveform,
    kaldi_fbank,
    log_mel_spectrogram,
    parse_path,
)
from daspeech_torch.data.datasets import (
    BucketBatcher,
    BucketSpec,
    NATSpeechToSpeechDataset,
    NATSpeechToTextDataset,
    load_tsv,
    make_buckets,
)
from daspeech_torch.data.data_cfg import S2SDataConfig, S2TDataConfig
from daspeech_torch.data.dictionary import Dictionary
from daspeech_torch.data.transforms import (
    Compose,
    GlobalCMVN,
    SpecAugment,
    UtteranceCMVN,
)

__all__ = [
    "get_features_or_waveform",
    "kaldi_fbank",
    "log_mel_spectrogram",
    "parse_path",
    "BucketBatcher",
    "BucketSpec",
    "NATSpeechToSpeechDataset",
    "NATSpeechToTextDataset",
    "load_tsv",
    "make_buckets",
    "Dictionary",
    "S2SDataConfig",
    "S2TDataConfig",
    "Compose",
    "GlobalCMVN",
    "SpecAugment",
    "UtteranceCMVN",
]
