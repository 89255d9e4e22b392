"""Two-pass S2ST generation (PyTorch): the serving entry point.

Counterpart of ``daspeech_tpu/decode/generator.py``: encoder -> DAG decoder
+ links -> lookahead/greedy decode -> hidden-state gather -> adaptor +
FastSpeech 2 -> gcmvn denormalization -> HiFi-GAN. Batches and hypotheses
keep the JAX package's keys. Only single-pass decoding with
``length_beam=1`` is ported; the reranker, iterative refinement, the length
beam and the Viterbi/beam-search strategies raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from daspeech_torch.decode.dag_decode import (
    DecodeResult,
    gather_path_features,
    greedy_or_lookahead_decode,
)
from daspeech_torch.decode.speech_generator import make_vocode_fn

HOP = 256        # samples per mel frame (generator.py:334)


def _check_supported(cfg) -> None:
    if cfg.strategy not in ("lookahead", "greedy"):
        raise NotImplementedError(f"decode strategy {cfg.strategy!r} is not "
                                  "ported yet; use lookahead or greedy")
    if int(cfg.length_beam) > 1:
        raise NotImplementedError("length_beam > 1 is not ported yet")
    if cfg.iter_decode_max_iter > 0:
        raise NotImplementedError("iterative refinement is not ported yet")


def dag_forward_decode(model, fbank: torch.Tensor, src_lengths: torch.Tensor,
                       prev: torch.Tensor, vocab, cfg):
    """Encoder -> decoder -> decode strategy (``generator.py:90-146`` with
    ``length_beam=1``). Returns (DecodeResult, features [B, L, D])."""
    _check_supported(cfg)
    enc, enc_pad, _ = model.encode(fbank, src_lengths)
    logits, links, feats = model.decode(prev, enc, enc_pad)
    ol = (prev != vocab.pad).sum(dim=1)
    res = greedy_or_lookahead_decode(logits, links, ol, vocab.pad, cfg.beta,
                                     lookahead=cfg.strategy == "lookahead")
    return res, feats


class S2SNATGenerator:
    """DAG decode -> hidden-state gather -> adaptor + FastSpeech 2 ->
    (gcmvn denorm) -> (vocoder); ``generator.py:247-347``.

    ``model`` and ``vocoder`` are eval-mode modules on one device; the
    batch's numpy arrays are moved there. ``gcmvn``, when given, has the
    interface of the JAX package's ``GlobalCMVN`` (``mean``, ``std``,
    ``denormalize``). The three stages are public so
    that a caller can time them apart; :meth:`generate` runs them in order
    under ``torch.inference_mode()``."""

    def __init__(self, model, vocab, decode_cfg, max_mel_len: int = 1024,
                 vocoder=None, gcmvn=None, d_factor: float = 1.0,
                 reranker=None):
        if reranker is not None:
            raise NotImplementedError("reranking is not ported yet")
        _check_supported(decode_cfg)
        self.model = model
        self.vocab = vocab
        self.cfg = decode_cfg
        self.max_mel_len = max_mel_len
        self.vocoder = vocoder
        self.gcmvn = gcmvn
        self.d_factor = d_factor
        self.device = next(model.parameters()).device
        self._vocode = make_vocode_fn(vocoder, gcmvn)

    def to_device(self, batch: Dict[str, np.ndarray]):
        """(fbank, src_lengths, prev_output_tokens) as tensors on the
        model's device."""
        d = self.device
        return (torch.as_tensor(batch["fbank"], dtype=torch.float32,
                                device=d),
                torch.as_tensor(batch["src_lengths"], device=d).long(),
                torch.as_tensor(batch["prev_output_tokens"], device=d).long())

    def decode(self, fbank, src_lengths, prev):
        """Stage 1: encoder + decoder + links + lookahead decode ->
        (DecodeResult, path features [B, L, D], their pad mask)."""
        res, feats = dag_forward_decode(self.model, fbank, src_lengths, prev,
                                        self.vocab, self.cfg)
        # lookahead/greedy: slot 0 (<bos>) carries no feature
        z, zmask = gather_path_features(feats, res, skip_first=True)
        return res, z, zmask

    def synthesize(self, z, zmask):
        """Stage 2: adaptor + FastSpeech 2 -> (mel [B, M, 80], mel_lens)."""
        mel, mel_lens, _, _, _ = self.model.synthesize(
            z, zmask, self.max_mel_len, d_factor=self.d_factor)
        return mel, mel_lens

    def vocode(self, mel):
        """Stage 3: gcmvn denormalization + HiFi-GAN -> wav [B, M*256],
        one-shot or, for a vocoder with ``serve_chunk > 0``, chunked
        (``generator.py:324-328`` through ``make_vocode_fn``)."""
        return self._vocode(mel)

    def generate(self, batch: Dict[str, np.ndarray],
                 generate_waveform: bool = True) -> List[Dict]:
        with torch.inference_mode():
            res, z, zmask = self.decode(*self.to_device(batch))
            mel, mel_lens = self.synthesize(z, zmask)
            wav = (self.vocode(mel)
                   if generate_waveform and self.vocoder is not None
                   else None)
            return self._hypotheses(res, mel, mel_lens, wav)

    def _hypotheses(self, res: DecodeResult, mel, mel_lens, wav):
        """One device-to-host transfer per output, then per-utterance
        slicing (``generator.py:329-347``)."""
        tokens = res.tokens.cpu().numpy()
        lengths = res.lengths.cpu().numpy()
        mel = mel.cpu().numpy()
        mel_lens = mel_lens.cpu().numpy()
        wav_np = None if wav is None else wav.cpu().numpy()
        out = []
        for b in range(tokens.shape[0]):
            m = mel[b, : mel_lens[b]]
            if self.gcmvn is not None:
                m = self.gcmvn.denormalize(m)
            hypo = {"tokens": tokens[b, : lengths[b]], "feature": m}
            if wav_np is not None:
                hypo["waveform"] = wav_np[b, : mel_lens[b] * HOP]
            out.append(hypo)
        return out
