"""Per-dataset ``config.yaml`` semantics: split-specific feature transforms,
global-CMVN stats, vocoder pointer, vocab filename.

Rebuild of ``fairseq/fairseq/data/audio/data_cfg.py:35-243``
(``S2TDataConfig``/``S2SDataConfig``): a YAML next to the TSV manifests
declares which feature transforms apply to which split, using the wildcard
keys ``_train`` (any split starting with "train"), ``_eval`` and ``*``::

    vocab_filename: vocab.txt
    transforms:
      _train: [utterance_cmvn, specaugment]
      '*': [utterance_cmvn]
    specaugment:
      freq_mask_N: 2
      freq_mask_F: 27
      time_mask_N: 2
      time_mask_T: 100
      time_mask_p: 1.0
    global_cmvn:
      stats_npz_path: gcmvn_stats.npz
    vocoder:
      type: hifigan
      config: hifigan_config.json
      checkpoint: hifigan_ckpt

Relative paths resolve against the YAML's directory, like the reference's
``_auto_convert_to_abs_path``.

A copy of ``daspeech_tpu/data/data_cfg.py``, but for one thing: PyYAML is
imported only when the YAML file exists, so a data directory without one
needs no PyYAML (it behaves as an empty config: no transforms).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

from daspeech_torch.data.transforms import (
    Compose,
    DeltaDeltas,
    GlobalCMVN,
    SpecAugment,
    UtteranceCMVN,
)


class S2TDataConfig:
    """Typed wrapper over the per-dataset config.yaml
    (``data_cfg.py:35-190``)."""

    def __init__(self, yaml_path):
        yaml_path = Path(yaml_path)
        self.root = yaml_path.parent
        self.config: Dict[str, Any] = {}
        if yaml_path.is_file():
            import yaml

            self.config = yaml.safe_load(yaml_path.read_text()) or {}

    def _abspath(self, x):
        if isinstance(x, str) and not Path(x).exists() \
                and (self.root / x).exists():
            return str(self.root / x)
        if isinstance(x, dict):
            return {k: self._abspath(v) for k, v in x.items()}
        return x

    @property
    def vocab_filename(self) -> str:
        return self.config.get("vocab_filename", "vocab.txt")

    @property
    def sample_rate(self) -> int:
        return self.config.get("sample_rate", 16000)

    @property
    def audio_root(self) -> str:
        return self.config.get("audio_root", "")

    @property
    def global_cmvn_stats_npz(self) -> Optional[str]:
        path = self.config.get("global_cmvn", {}).get("stats_npz_path")
        return self._abspath(path) if path else None

    @property
    def speaker_set_filename(self) -> Optional[str]:
        """Multi-speaker TTS speaker list, one name per line
        (``fairseq data_cfg.py:56-58``); None = single-speaker."""
        path = self.config.get("speaker_set_filename")
        return self._abspath(path) if path else None

    @property
    def vocoder(self) -> Dict[str, str]:
        return self._abspath(self.config.get("vocoder", {}))

    @property
    def pre_tokenizer(self) -> Dict:
        """``pre_tokenizer: {tokenizer: NAME, ...}`` (``data_cfg.py:66-73``);
        build with ``data.encoders.build_tokenizer``."""
        return self.config.get("pre_tokenizer", {"tokenizer": None})

    @property
    def bpe_tokenizer(self) -> Dict:
        """``bpe_tokenizer: {bpe: NAME, ...}`` (``data_cfg.py:75-81``);
        build with ``data.encoders.build_bpe``."""
        return self.config.get("bpe_tokenizer", {"bpe": None})

    def transform_names(self, split: str, is_train: bool) -> List[str]:
        """Resolve the transform-name list for a split with the reference's
        wildcard order: exact split, then ``_train``/``_eval``, then ``*``
        (``data_cfg.py:155-166``). ``feature_transforms`` entries extend the
        legacy ``transforms`` key."""
        names: List[str] = []
        for key in ("transforms", "feature_transforms"):
            table = self.config.get(key, {}) or {}
            cur = table.get(split)
            if cur is None and is_train:
                cur = table.get("_train")
            if cur is None and not is_train:
                cur = table.get("_eval")
            if cur is None:
                cur = table.get("*")
            names.extend(cur or [])
        return names

    def get_feature_transforms(self, split: str,
                               is_train: bool) -> Optional[Compose]:
        """Build the composed host-side transform pipeline for a split, or
        None if the config declares nothing for it."""
        names = self.transform_names(split, is_train)
        if not names:
            return None
        return Compose([self._build(n) for n in names])

    def _build(self, name: str):
        if name == "utterance_cmvn":
            c = self.config.get("utterance_cmvn", {}) or {}
            return UtteranceCMVN(norm_means=c.get("norm_means", True),
                                 norm_vars=c.get("norm_vars", True))
        if name == "global_cmvn":
            path = self.global_cmvn_stats_npz
            if path is None:
                raise ValueError(
                    "global_cmvn transform requires global_cmvn."
                    "stats_npz_path in config.yaml")
            return GlobalCMVN(stats_npz_path=path)
        if name == "specaugment":
            c = self.config.get("specaugment", {}) or {}
            # reference parameter names (specaugment.py:27-45)
            return SpecAugment(
                freq_mask_n=c.get("freq_mask_N", 2),
                freq_mask_f=c.get("freq_mask_F", 27),
                time_mask_n=c.get("time_mask_N", 2),
                time_mask_t=c.get("time_mask_T", 100),
                time_mask_p=c.get("time_mask_p", 1.0),
                # the recipes spell it time_wrap_W (README.md:107,183);
                # accept the reference code's time_warp_W too
                time_warp_w=c.get("time_wrap_W", c.get("time_warp_W", 0)))
        if name == "delta_deltas":
            c = self.config.get("delta_deltas", {}) or {}
            return DeltaDeltas(win_length=c.get("win_length", 5))
        raise ValueError(f"unknown feature transform {name!r}")


class S2SDataConfig(S2TDataConfig):
    """S2S variant (``data_cfg.py:193-243``): output sample rate for the
    target-speech side."""

    @property
    def output_sample_rate(self) -> int:
        return self.config.get("output_sample_rate", 22050)
