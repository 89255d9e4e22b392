"""ASR-BLEU evaluation toolkit: the port's copy of
``daspeech_tpu/eval/asr_bleu.py``. ``sacrebleu`` and ``transformers`` are
imported when they are used, so importing this module needs neither.

Rebuild of the reference's ``asr_bleu/compute_asr_bleu.py``: transcribe
generated waveforms with a CTC wav2vec2 ASR model and score sacrebleu (13a
tokenizer, lowercased) against references.

The reference downloads fairseq/HF ASR checkpoints at eval time
(``asr_model_cfgs.json``); here the HF model is loaded strictly from
the local cache (no download) — ``asr_available()`` reports whether
scoring can run. The BLEU pipeline (normalization, corpus scoring) is
testable without the ASR by passing transcripts directly.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

import numpy as np

DEFAULT_ASR_MODEL = "facebook/wav2vec2-large-960h-lv60-self"

# Per-language CTC ASR models, mirroring the reference's table
# (``asr_bleu/asr_model_cfgs.json`` oct22 rows). "en" uses the HF release
# of the same LV-60 self-trained checkpoint the reference downloads from
# fairseq; the rest are the reference's own HF model ids verbatim.
ASR_MODELS = {
    "en": DEFAULT_ASR_MODEL,
    "es": "jonatasgrosman/wav2vec2-large-xlsr-53-spanish",
    "fr": "jonatasgrosman/wav2vec2-large-fr-voxpopuli-french",
    "zh": "ydshieh/wav2vec2-large-xlsr-53-chinese-zh-cn-gpt",
    "tr": "cahya/wav2vec2-large-xlsr-turkish-artificial-cv",
    "ar": "jonatasgrosman/wav2vec2-large-xlsr-53-arabic",
    "vi": "not-tanh/wav2vec2-large-xlsr-53-vietnamese",
    "de": "jonatasgrosman/wav2vec2-xls-r-1b-german",
    "pl": "jonatasgrosman/wav2vec2-xls-r-1b-polish",
    "it": "jonatasgrosman/wav2vec2-large-xlsr-53-italian",
    "pt": "jonatasgrosman/wav2vec2-xls-r-1b-portuguese",
    "ro": "gigant/romanian-wav2vec2",
    "cs": "comodoro/wav2vec2-xls-r-300m-cs-250",
    "sk": "anuragshas/wav2vec2-xls-r-300m-sk-cv8-with-lm",
    "sl": "anuragshas/wav2vec2-xls-r-300m-sl-cv8-with-lm",
    "fi": "jonatasgrosman/wav2vec2-large-xlsr-53-finnish",
    "hu": "jonatasgrosman/wav2vec2-large-xlsr-53-hungarian",
    "et": "RASMUS/wav2vec2-xlsr-1b-et",
    "lt": "sammy786/wav2vec2-xlsr-lithuanian",
    "nl": "jonatasgrosman/wav2vec2-xls-r-1b-dutch",
    "lv": "reach-vb/wav2vec2-large-xls-r-1B-common_voice7-lv-ft",
    "sv": "marinone94/xls-r-300m-sv-robust",
    "hr": "classla/wav2vec2-xls-r-parlaspeech-hr",
}


def asr_model_for_lang(lang: str) -> str:
    """Language code -> ASR model id (``compute_asr_bleu.py`` cfg lookup)."""
    if lang not in ASR_MODELS:
        raise ValueError(
            f"no ASR model registered for {lang!r}; have "
            f"{sorted(ASR_MODELS)}")
    return ASR_MODELS[lang]


def normalize_transcript(text: str, lang: str = "en") -> str:
    """Lowercase (+ strip punctuation for en), as ``compute_asr_bleu.py``
    does before scoring (the en ASR emits uppercase; references are
    lowercased). The ASCII strip applies only to en — other languages keep
    their characters."""
    text = text.lower()
    if lang == "en":
        text = re.sub(r"[^a-z0-9' ]", " ", text)
    return " ".join(text.split())


def corpus_bleu(hyps: Sequence[str], refs: Sequence[str],
                lang: str = "en", tokenizer: str = None) -> float:
    """sacrebleu corpus BLEU, lowercased (``compute_asr_bleu.py:120-235``);
    13a tokenizer, except the character tokenizer for zh as sacrebleu
    prescribes.

    DELIBERATE DEVIATION: the reference's ``compute_asr_bleu.py`` uses the
    default 13a tokenizer for *every* language including zh, so zh scores
    from this function are NOT directly comparable to reference-reported
    numbers — pass ``tokenizer='13a'`` for reference-compatible zh scoring.
    """
    import sacrebleu

    tok = tokenizer or ("zh" if lang == "zh" else "13a")
    bleu = sacrebleu.corpus_bleu(
        [normalize_transcript(h, lang) for h in hyps],
        [[normalize_transcript(r, lang) for r in refs]],
        tokenize=tok, lowercase=True)
    return float(bleu.score)


def asr_available(model_name: str = DEFAULT_ASR_MODEL) -> bool:
    try:
        from transformers import Wav2Vec2Processor

        Wav2Vec2Processor.from_pretrained(model_name, local_files_only=True)
        return True
    except Exception:
        return False


class Wav2Vec2Transcriber:
    """HF wav2vec2 CTC transcription (the reference's HF path,
    ``asr_bleu/utils.py``)."""

    def __init__(self, model_name: str = DEFAULT_ASR_MODEL,
                 device: str = "cuda"):
        import torch
        from transformers import Wav2Vec2ForCTC, Wav2Vec2Processor

        self.processor = Wav2Vec2Processor.from_pretrained(
            model_name, local_files_only=True)
        self.model = Wav2Vec2ForCTC.from_pretrained(
            model_name, local_files_only=True).to(device).eval()
        self.device = device
        self.torch = torch

    def transcribe(self, wav: np.ndarray, sample_rate: int = 16000) -> str:
        torch = self.torch
        wav = np.asarray(wav, np.float32).reshape(-1)
        if wav.size == 0:
            return ""          # an empty synthesis transcribes to nothing
        if sample_rate != 16000:
            wav = resample_linear(wav, sample_rate, 16000)
        if wav.size < 640:     # < 40 ms: shorter than the feature
            # extractor's receptive field — zero-pad (silence) to one hop
            wav = np.pad(wav, (0, 640 - wav.size))
        inputs = self.processor(
            wav, sampling_rate=16000, return_tensors="pt")
        with torch.no_grad():
            logits = self.model(
                inputs.input_values.to(self.device)).logits
        ids = torch.argmax(logits, dim=-1)
        return self.processor.batch_decode(ids)[0]


def resample_linear(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler (sufficient for ASR input; avoids a
    librosa/torchaudio dependency)."""
    if sr_in == sr_out:
        return wav
    n_out = int(round(len(wav) * sr_out / sr_in))
    x_out = np.linspace(0.0, len(wav) - 1, n_out)
    return np.interp(x_out, np.arange(len(wav)), wav).astype(np.float32)


def compute_asr_bleu(
    wav_paths: Sequence, reference_texts: Sequence[str],
    model_name: Optional[str] = None, sample_rate: int = 22050,
    lang: str = "en", device: str = "cuda",
) -> dict:
    """Transcribe each waveform on ``device`` and score corpus BLEU
    (``compute_asr_bleu.py`` main path)."""
    from daspeech_torch.cli.generate import read_wav

    tr = Wav2Vec2Transcriber(model_name or asr_model_for_lang(lang), device)
    hyps: List[str] = []
    for p in wav_paths:
        if isinstance(p, (str, Path)):
            wav, sr = read_wav(p)
        else:
            wav, sr = p, sample_rate
        hyps.append(tr.transcribe(wav, sr))
    score = corpus_bleu(hyps, list(reference_texts), lang=lang)
    return {"bleu": score, "hypotheses": hyps}
