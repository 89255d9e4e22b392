"""Vocoding for serving (PyTorch), and the TTS-only generator.

Counterpart of ``daspeech_tpu/decode/speech_generator.py``. The vocoder was
trained on raw (unnormalized) mels, so a gcmvn-normalized mel is
denormalized before it is vocoded (``speech_generator.py``'s
gcmvn_denormalize -> get_waveform order). :func:`make_vocode_fn` serves
every rung of the ladder (``--vocoder-quant``: the fp32 vocoder, bf16 and
the int8 rungs with their calibration) one-shot or, with ``serve_chunk >
0`` on the vocoder, in exact chunks.
:class:`NonAutoregressiveSpeechGenerator` is the ``nat_tts`` entry point:
phonemes -> FastSpeech 2 -> (gcmvn denorm) -> HiFi-GAN.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from daspeech_torch.models.hifigan import vocode_chunked

logger = logging.getLogger(__name__)

QUANT_MODES = ("none", "bf16", "int8", "int8-skip1")   # --vocoder-quant


def quant_fields(quant: str) -> Dict:
    """The ``HiFiGANGenerator`` fields of a ``--vocoder-quant`` rung
    (``daspeech_tpu/cli/generate.py:490-499``)."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant {quant!r} not in {QUANT_MODES}")
    return dict(dtype=torch.bfloat16 if quant == "bf16" else torch.float32,
                quant_int8=quant.startswith("int8"),
                quant_skip_levels=1 if quant == "int8-skip1" else 0)


def gcmvn_stats(gcmvn, device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(mean, std) of a global CMVN (an object with ``mean`` and ``std``
    arrays over the 80 mel bins) as tensors on ``device``, or None."""
    if gcmvn is None:
        return None
    return (torch.as_tensor(gcmvn.mean, dtype=torch.float32, device=device),
            torch.as_tensor(gcmvn.std, dtype=torch.float32, device=device))


def make_vocode_fn(voc, gcmvn=None, calib_batches: Optional[int] = None,
                   saturation_margin: float = 1.25
                   ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """mel [B, M, 80] (gcmvn-normalized when ``gcmvn`` is given) -> fp32 wav
    [B, M * hop] (``speech_generator.py:24-136``): gcmvn denormalization,
    then the vocoder, one-shot or, when ``voc.serve_chunk > 0``, chunk by
    chunk (:func:`~daspeech_torch.models.hifigan.vocode_chunked`), in the
    vocoder's rung (its ``dtype``, ``quant_int8``, ``quant_skip_levels``).

    An int8 vocoder (``quant_int8``) starts with empty calibration: the
    first ``max(1, calib_batches)`` served batches (default the vocoder's
    ``serve_calib_batches``) run one-shot, even with ``serve_chunk > 0``,
    quantizing each activation by its own amax and raising each site's
    running amax; then the scales freeze. A later batch whose denormalized
    input amax exceeds ``saturation_margin`` times the calibration
    batches' largest logs one warning: the frozen scales are likely
    saturating. Nothing here waits for the card but that check's one
    scalar of an int8 batch."""
    if voc is None:
        return None
    stats = gcmvn_stats(gcmvn, next(voc.parameters()).device)
    chunk = int(getattr(voc, "serve_chunk", 0) or 0)
    if calib_batches is None:
        calib_batches = int(getattr(voc, "serve_calib_batches", 4))

    def denorm(mel: torch.Tensor) -> torch.Tensor:
        return mel if stats is None else mel * stats[1] + stats[0]

    def serve(mel: torch.Tensor) -> torch.Tensor:
        wav = vocode_chunked(voc, mel, chunk) if chunk else voc(mel)
        return wav.float()

    if not getattr(voc, "quant_int8", False):
        return lambda mel: serve(denorm(mel))

    voc.reset_calibration_()
    state = {"n": 0, "amax": 0.0, "warned": False}

    def vocode(mel: torch.Tensor) -> torch.Tensor:
        mel = denorm(mel)
        amax = float(mel.abs().max())
        if state["n"] < max(1, calib_batches):
            voc.calibrate = True
            try:
                wav = voc(mel).float()
            finally:
                voc.calibrate = False
            state["amax"] = max(state["amax"], amax)
            state["n"] += 1
            return wav
        if amax > saturation_margin * state["amax"] and not state["warned"]:
            state["warned"] = True
            logger.warning(
                "int8 vocoder: served batch input amax %.3g exceeds the "
                "calibration-time maximum %.3g by more than %.0f%% — the "
                "frozen activation scales are likely saturating at the "
                "int8 clip; consider more --vocoder-calib-batches.",
                amax, state["amax"], (saturation_margin - 1) * 100)
        return serve(mel)

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
