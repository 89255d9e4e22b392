"""Vocoding for serving (PyTorch), and the TTS-only generator.

Counterpart of ``daspeech_tpu/decode/speech_generator.py``. The vocoder was
trained on raw (unnormalized) mels, so a gcmvn-normalized mel is
denormalized before it is vocoded (``speech_generator.py``'s
gcmvn_denormalize -> get_waveform order). :func:`make_vocode_fn` serves the
fp32 vocoder one-shot or, with ``serve_chunk > 0`` on the vocoder, in exact
chunks; the bf16 and int8 rungs are not ported.
:class:`NonAutoregressiveSpeechGenerator` is the ``nat_tts`` entry point:
phonemes -> FastSpeech 2 -> (gcmvn denorm) -> HiFi-GAN.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from daspeech_torch.models.hifigan import vocode_chunked

QUANT_MODES = ("none", "bf16", "int8", "int8-skip1")   # --vocoder-quant


def gcmvn_stats(gcmvn, device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(mean, std) of a global CMVN (an object with ``mean`` and ``std``
    arrays over the 80 mel bins) as tensors on ``device``, or None."""
    if gcmvn is None:
        return None
    return (torch.as_tensor(gcmvn.mean, dtype=torch.float32, device=device),
            torch.as_tensor(gcmvn.std, dtype=torch.float32, device=device))


def make_vocode_fn(voc, gcmvn=None, quant: str = "none"
                   ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """mel [B, M, 80] (gcmvn-normalized when ``gcmvn`` is given) -> wav
    [B, M * hop] (``speech_generator.py:24-136``): gcmvn denormalization,
    then the vocoder, one-shot or, when ``voc.serve_chunk > 0``, chunk by
    chunk (:func:`~daspeech_torch.models.hifigan.vocode_chunked`). ``quant``
    is ``--vocoder-quant``; only "none" (fp32) is ported. Nothing here
    waits for the card."""
    if voc is None:
        return None
    if quant not in QUANT_MODES:
        raise ValueError(f"quant {quant!r} not in {QUANT_MODES}")
    dtype = next(voc.parameters()).dtype
    if quant != "none" or dtype != torch.float32:
        raise NotImplementedError(
            f"vocoder serving in {quant if quant != 'none' else dtype} is "
            "not ported yet (ROADMAP Queue 1 #5b: the bf16 and int8 vocoder "
            "rungs); serve the fp32 vocoder")
    stats = gcmvn_stats(gcmvn, next(voc.parameters()).device)
    chunk = int(getattr(voc, "serve_chunk", 0) or 0)

    def vocode(mel: torch.Tensor) -> torch.Tensor:
        if stats is not None:
            mel = mel * stats[1] + stats[0]
        return vocode_chunked(voc, mel, chunk) if chunk else voc(mel)

    return vocode


class NonAutoregressiveSpeechGenerator:
    """Phoneme tokens -> FastSpeech 2 (token path, predicted durations) ->
    gcmvn denormalization -> vocoder (``speech_generator.py:147-212``, the
    ``--generator-type nat_tts`` entry point). ``model`` is the port's
    ``FastSpeech2Encoder`` with ``vocab_size > 0`` and ``vocoder`` a
    ``HiFiGANGenerator`` (or None), both on one device; the batch's numpy
    arrays are moved there. ``gcmvn`` has the interface of the JAX
    package's ``GlobalCMVN`` (``mean``, ``std``, ``denormalize``)."""

    def __init__(self, model, vocab, max_mel_len: int = 2048, vocoder=None,
                 gcmvn=None, d_factor: float = 1.0, hop: int = 256):
        self.model = model
        self.vocab = vocab
        self.max_mel_len = max_mel_len
        self.vocoder = vocoder
        self.gcmvn = gcmvn
        self.d_factor = d_factor
        self.hop = hop
        self.device = next(model.parameters()).device
        self._vocode = make_vocode_fn(vocoder, gcmvn)

    def synthesize(self, src_tokens: torch.Tensor):
        """FastSpeech 2 in eval mode -> (mel [B, M, 80], out_lens [B])."""
        mel, out_lens, _, _, _ = self.model(
            src_tokens=src_tokens, max_out_len=self.max_mel_len,
            d_factor=self.d_factor)
        return mel, out_lens

    def generate(self, batch: Dict[str, np.ndarray],
                 generate_waveform: bool = True) -> List[Dict]:
        with torch.inference_mode():
            tokens = torch.as_tensor(batch["src_tokens"],
                                     device=self.device).long()
            mel, out_lens = self.synthesize(tokens)
            wav = (self._vocode(mel)
                   if generate_waveform and self._vocode is not None
                   else None)
        # one device-to-host transfer per output, then per-utterance slices
        mel = mel.cpu().numpy()
        out_lens = out_lens.cpu().numpy()
        wav_np = None if wav is None else wav.cpu().numpy()
        out = []
        for b in range(mel.shape[0]):
            m = mel[b, : out_lens[b]]
            if self.gcmvn is not None:
                m = self.gcmvn.denormalize(m)
            hypo = {"feature": m}
            if wav_np is not None:
                hypo["waveform"] = wav_np[b, : out_lens[b] * self.hop]
            out.append(hypo)
        return out
