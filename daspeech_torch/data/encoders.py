"""Pre-tokenizer / subword (BPE) encoder registry (a copy of
``daspeech_tpu/data/encoders.py``).

Rebuild of ``fairseq/fairseq/data/encoders/`` as used by the speech data
configs: ``config.yaml`` declares ``pre_tokenizer: {tokenizer: NAME, ...}``
and ``bpe_tokenizer: {bpe: NAME, ...}`` (``data_cfg.py:66-81``), the task
builds both and applies encode at dataset-load time / decode for eval-BLEU
detokenization. The DASpeech recipes use a phoneme vocabulary (identity
path), so only the lightweight encoders are always available; heavyweight
ones (sentencepiece, moses) are gated on their optional imports.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

_TOKENIZERS: Dict[str, type] = {}
_BPES: Dict[str, type] = {}


def register_tokenizer(name):
    def deco(cls):
        _TOKENIZERS[name] = cls
        return cls
    return deco


def register_bpe(name):
    def deco(cls):
        _BPES[name] = cls
        return cls
    return deco


class Identity:
    """The null encoder: ``tokenizer: None`` / ``bpe: None``."""

    def __init__(self, cfg: Optional[dict] = None):
        pass

    def encode(self, x: str) -> str:
        return x

    def decode(self, x: str) -> str:
        return x


@register_tokenizer("space")
class SpaceTokenizer(Identity):
    """Whitespace normalization (``encoders/space_tokenizer.py``)."""

    _ws = re.compile(r"\s+")

    def encode(self, x: str) -> str:
        return self._ws.sub(" ", x).strip()


@register_tokenizer("moses")
class MosesTokenizer(Identity):
    """Moses tok/detok (``encoders/moses_tokenizer.py``); requires the
    optional ``sacremoses`` package."""

    def __init__(self, cfg: Optional[dict] = None):
        cfg = cfg or {}
        try:
            from sacremoses import MosesDetokenizer, MosesTokenizer as MT
        except ImportError as e:   # pragma: no cover - optional dep
            raise ImportError(
                "pre_tokenizer 'moses' requires sacremoses") from e
        lang = cfg.get("source_lang") or cfg.get("lang") or "en"
        self._tok = MT(lang)
        self._detok = MosesDetokenizer(lang)

    def encode(self, x: str) -> str:
        return self._tok.tokenize(x, return_str=True, escape=False)

    def decode(self, x: str) -> str:
        return self._detok.detokenize(x.split())


SPACE = chr(32)
SPACE_ESCAPE = chr(9601)


@register_bpe("characters")
class Characters(Identity):
    """Character-level "bpe" (``encoders/characters.py``)."""

    def encode(self, x: str) -> str:
        return SPACE.join(x.replace(SPACE, SPACE_ESCAPE))

    def decode(self, x: str) -> str:
        return x.replace(SPACE, "").replace(SPACE_ESCAPE, SPACE)


@register_bpe("bytes")
class Bytes(Identity):
    """UTF-8 byte-level "bpe" (``encoders/bytes.py``)."""

    def encode(self, x: str) -> str:
        return SPACE.join(f"<{b:02x}>" for b in x.encode("utf-8"))

    def decode(self, x: str) -> str:
        bs = bytes(int(t[1:-1], 16) for t in x.split()
                   if t.startswith("<") and t.endswith(">"))
        return bs.decode("utf-8", errors="replace")


@register_bpe("sentencepiece")
class SentencepieceBPE(Identity):
    """SentencePiece subwords (``encoders/sentencepiece_bpe.py``);
    requires the optional ``sentencepiece`` package and a
    ``sentencepiece_model`` path in the YAML dict."""

    def __init__(self, cfg: Optional[dict] = None):
        cfg = cfg or {}
        try:
            import sentencepiece as spm
        except ImportError as e:   # pragma: no cover - optional dep
            raise ImportError(
                "bpe_tokenizer 'sentencepiece' requires sentencepiece") from e
        model = cfg.get("sentencepiece_model")
        if not model:
            raise ValueError("sentencepiece_model path missing from config")
        self._sp = spm.SentencePieceProcessor(model_file=str(model))

    def encode(self, x: str) -> str:
        return " ".join(self._sp.encode(x, out_type=str))

    def decode(self, x: str) -> str:
        return self._sp.decode(x.split())


def build_tokenizer(cfg: Optional[dict]):
    """``pre_tokenizer`` dict from config.yaml -> encoder object (identity
    when the name is None/absent, matching ``data_cfg.py:66-73``)."""
    cfg = dict(cfg or {})
    name = cfg.pop("tokenizer", None)
    if name is None:
        return Identity()
    if name not in _TOKENIZERS:
        raise ValueError(f"unknown pre_tokenizer {name!r}; "
                         f"have {sorted(_TOKENIZERS)}")
    return _TOKENIZERS[name](cfg)


def build_bpe(cfg: Optional[dict]):
    """``bpe_tokenizer`` dict from config.yaml -> encoder object."""
    cfg = dict(cfg or {})
    name = cfg.pop("bpe", None)
    if name is None:
        return Identity()
    if name not in _BPES:
        raise ValueError(f"unknown bpe {name!r}; have {sorted(_BPES)}")
    return _BPES[name](cfg)
