"""Vocoding for serving (PyTorch), and the TTS-only generator.

Counterpart of ``daspeech_tpu/decode/speech_generator.py``. The vocoder was
trained on raw (unnormalized) mels, so a gcmvn-normalized mel is
denormalized before it is vocoded (``speech_generator.py``'s
gcmvn_denormalize -> get_waveform order). :func:`make_vocode_fn` serves
every rung of the ladder (``--vocoder-quant``: the fp32 vocoder, bf16 and
the int8 rungs with their calibration) one-shot or, with ``serve_chunk >
0`` on the vocoder, in exact chunks.
:class:`NonAutoregressiveSpeechGenerator` is the ``nat_tts`` entry point:
phonemes -> FastSpeech 2 -> (gcmvn denorm) -> vocoder;
:class:`AutoRegressiveSpeechGenerator` the ``at_tts`` one (Transformer-TTS)
and :class:`MultiDecoderSpeechGenerator` the ``at_s2s`` one (the two-pass
AR S2ST). The vocoder is a ``HiFiGANGenerator`` or a ``GriffinLimVocoder``.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from daspeech_torch.models.hifigan import vocode_chunked
from daspeech_torch.models.tts_transformer import ar_mel_loop

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
    params = (list(voc.parameters()) if isinstance(voc, torch.nn.Module)
              else [])           # a Griffin-Lim vocoder has none
    stats = gcmvn_stats(gcmvn, params[0].device if params else "cpu")
    chunk = int(getattr(voc, "serve_chunk", 0) or 0)
    if calib_batches is None:
        calib_batches = int(getattr(voc, "serve_calib_batches", 4))

    def denorm(mel: torch.Tensor) -> torch.Tensor:
        if stats is None:
            return mel
        return mel * stats[1].to(mel.device) + stats[0].to(mel.device)

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

    def synthesize(self, src_tokens: torch.Tensor,
                   speaker: Optional[torch.Tensor] = None):
        """FastSpeech 2 in eval mode -> (mel [B, M, 80], out_lens [B]): the
        Postnet's mel when the model has one; ``speaker`` [B] ids for a
        multi-speaker model (``speech_generator.py:173-194``)."""
        mel, mel_post, out_lens = self.model(
            src_tokens=src_tokens, max_out_len=self.max_mel_len,
            d_factor=self.d_factor, speaker=speaker)[:3]
        return (mel if mel_post is None else mel_post), out_lens

    def generate(self, batch: Dict[str, np.ndarray],
                 generate_waveform: bool = True) -> List[Dict]:
        with torch.inference_mode():
            tokens = torch.as_tensor(batch["src_tokens"],
                                     device=self.device).long()
            speaker = batch.get("speaker")
            if speaker is not None:
                speaker = torch.as_tensor(speaker, device=self.device).long()
            mel, out_lens = self.synthesize(tokens, speaker)
            wav = (self._vocode(mel)
                   if generate_waveform and self._vocode is not None
                   else None)
        return _feature_hypotheses(mel, out_lens, wav, self.gcmvn, self.hop)


def _feature_hypotheses(mel, lens, wav, gcmvn, hop, tokens=None,
                        text_lens=None) -> List[Dict]:
    """One device-to-host transfer per output, then per-utterance slices:
    ``feature`` (gcmvn-denormalized), ``waveform`` when vocoded and
    ``tokens`` when given (``speech_generator.py:300-356``)."""
    mel = mel.float().cpu().numpy()
    lens = lens.cpu().numpy()
    wav_np = None if wav is None else wav.cpu().numpy()
    if tokens is not None:
        tokens, text_lens = tokens.cpu().numpy(), text_lens.cpu().numpy()
    out = []
    for b in range(mel.shape[0]):
        m = mel[b, : lens[b]]
        if gcmvn is not None:
            m = gcmvn.denormalize(m)
        hypo = {"feature": m}
        if tokens is not None:
            hypo = {"tokens": tokens[b, : text_lens[b]], **hypo}
        if wav_np is not None:
            hypo["waveform"] = wav_np[b, : lens[b] * hop]
        out.append(hypo)
    return out


class AutoRegressiveSpeechGenerator:
    """Phoneme tokens -> Transformer-TTS, frame by frame with stop
    prediction -> gcmvn denormalization -> vocoder
    (``speech_generator.py:359-417``, ``--generator-type at_tts``).
    ``model`` is the port's ``TTSTransformer`` in eval mode; the whole
    ``max_mel_len`` buffer is vocoded, as JAX vocodes it, and each
    utterance is cut at its stop."""

    def __init__(self, model, vocab, max_mel_len: int = 1024, vocoder=None,
                 gcmvn=None, stop_threshold: float = 0.5, hop: int = 256):
        self.model = model
        self.vocab = vocab
        self.max_mel_len = max_mel_len
        self.vocoder = vocoder
        self.gcmvn = gcmvn
        self.stop_threshold = stop_threshold
        self.hop = hop
        self.device = next(model.parameters()).device
        self._vocode = make_vocode_fn(vocoder, gcmvn)

    def synthesize(self, src_tokens: torch.Tensor):
        """(mel [B, max_mel_len, 80], lens [B])."""
        return self.model.generate(src_tokens, self.max_mel_len,
                                   self.stop_threshold)

    def generate(self, batch: Dict[str, np.ndarray],
                 generate_waveform: bool = True) -> List[Dict]:
        with torch.inference_mode():
            tokens = torch.as_tensor(batch["src_tokens"],
                                     device=self.device).long()
            mel, lens = self.synthesize(tokens)
            wav = (self._vocode(mel)
                   if generate_waveform and self._vocode is not None
                   else None)
        return _feature_hypotheses(mel, lens, wav, self.gcmvn, self.hop)


class MultiDecoderSpeechGenerator:
    """Two-pass AR S2ST (``speech_generator.py:215-356``, ``--generator-type
    at_s2s``) over the port's ``S2SMultiDecoderModel`` in eval mode:

    1. greedy text decode for ``max_text_len`` steps from an ``<eos>``
       prefix (a row that has ended writes ``<pad>``);
    2. the text decoder teacher-forced on the hypothesis with its trailing
       ``<eos>`` stripped, for its states;
    3. the synthesizer encoder;
    4. the AR mel loop (``models.tts_transformer.ar_mel_loop``, every step,
       an fp32 buffer as JAX's);
    5. gcmvn denormalization, then the vocoder on the whole buffer.

    :meth:`translate`, :meth:`synthesize` and :meth:`vocode` are the
    stages, public so that a caller can time them apart."""

    def __init__(self, model, vocab, max_text_len: int = 64,
                 max_mel_len: int = 512, vocoder=None, gcmvn=None,
                 stop_threshold: float = 0.5, hop: int = 256):
        self.model = model
        self.vocab = vocab
        self.max_text_len = max_text_len
        self.max_mel_len = max_mel_len
        self.vocoder = vocoder
        self.gcmvn = gcmvn
        self.stop_threshold = stop_threshold
        self.hop = hop
        self.device = next(model.parameters()).device
        self._vocode = make_vocode_fn(vocoder, gcmvn)

    def to_device(self, batch: Dict[str, np.ndarray]):
        """(fbank, src_lengths) as tensors on the model's device."""
        return (torch.as_tensor(batch["fbank"], dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(batch["src_lengths"],
                                device=self.device).long())

    def translate(self, fbank: torch.Tensor, src_lengths: torch.Tensor):
        """Pass 1: (token buffer [B, TL + 1] (slot 0 ``<eos>``), text lens
        [B], encoder states, their pad mask). Step t reads the prefix
        ``buf[:, :t + 1]``; a row stops at its first ``<eos>`` and its text
        length is then t + 1 (that ``<eos>`` included)."""
        m, v, TL = self.model, self.vocab, self.max_text_len
        enc, enc_pad = m.forward_encoder(fbank, src_lengths)
        B = fbank.shape[0]
        buf = torch.full((B, TL + 1), v.pad, dtype=torch.long,
                         device=fbank.device)
        buf[:, 0] = v.eos
        done = torch.zeros(B, dtype=torch.bool, device=fbank.device)
        lens = torch.full((B,), TL, dtype=torch.long, device=fbank.device)
        for t in range(TL):
            logits, _ = m.mt_decode(buf[:, : t + 1], enc, enc_pad)
            tok = logits[:, t].argmax(dim=-1)
            tok = torch.where(done, v.pad, tok)
            buf[:, t + 1] = tok
            newly = ~done & (tok == v.eos)
            lens = torch.where(newly, t + 1, lens)
            done = done | newly
        return buf, lens, enc, enc_pad

    def synth_states(self, buf, text_lens, enc, enc_pad):
        """The synthesizer encoder's states and their pad mask, over the
        text decoder's states on slots 0 .. text_len - 1 of the buffer
        (``<eos>``, w_1 .. w_{K-1})."""
        m, TL = self.model, self.max_text_len
        idx = torch.arange(TL, device=buf.device)[None, :]
        prev_mt = torch.where(idx < text_lens[:, None], buf[:, :TL],
                              self.vocab.pad)
        _, features = m.mt_decode(prev_mt, enc, enc_pad)
        mt_pad = prev_mt == self.vocab.pad
        return m.synthesize_encode(features, mt_pad), mt_pad

    def synthesize(self, buf, text_lens, enc, enc_pad):
        """Pass 2: (mel [B, max_mel_len, 80], mel lens [B]) from
        :meth:`synth_states`."""
        m = self.model
        synth, mt_pad = self.synth_states(buf, text_lens, enc, enc_pad)
        return ar_mel_loop(
            lambda prev: m.tts_decode(prev, synth, mt_pad),
            buf.shape[0], self.max_mel_len, m.out_dim, torch.float32,
            buf.device, self.stop_threshold)

    def vocode(self, mel: torch.Tensor):
        return self._vocode(mel)

    def generate(self, batch: Dict[str, np.ndarray],
                 generate_waveform: bool = True) -> List[Dict]:
        with torch.inference_mode():
            buf, text_lens, enc, enc_pad = self.translate(
                *self.to_device(batch))
            mel, mel_lens = self.synthesize(buf, text_lens, enc, enc_pad)
            wav = (self.vocode(mel)
                   if generate_waveform and self._vocode is not None
                   else None)
        return _feature_hypotheses(mel, mel_lens, wav, self.gcmvn, self.hop,
                                   buf[:, 1:], text_lens)
