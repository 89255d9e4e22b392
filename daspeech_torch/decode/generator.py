"""Generators (PyTorch): S2TT decoding and two-pass S2ST serving.

Counterpart of ``daspeech_tpu/decode/generator.py``: encoder -> DAG decoder
+ links -> decode strategy (lookahead, greedy, viterbi, jointviterbi or
beamsearch), optionally over a length beam of graph sizes and with
iterative refinement; for S2ST then the hidden-state gather -> adaptor +
FastSpeech 2 -> gcmvn denormalization -> HiFi-GAN. Batches and hypotheses
keep the JAX package's keys, and the port refuses what JAX refuses, with
the same exception types. The length beam takes an external AR reranker
(:func:`rerank_scores`, an ``S2SMultiDecoderModel``) in place of its own
candidate score.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from daspeech_torch.decode.beam_search import beam_search_decode
from daspeech_torch.decode.dag_decode import (
    DecodeResult,
    gather_path_features,
    greedy_or_lookahead_decode,
    path_score,
    viterbi_decode,
)
from daspeech_torch.decode.speech_generator import make_vocode_fn
from daspeech_torch.models.dag_model import initialize_output_tokens
from daspeech_torch.telemetry import count, span

HOP = 256        # samples per mel frame (generator.py:334)


def _strategy_decode(cfg, vocab, logits, links, prev) -> DecodeResult:
    """One decode strategy on [B, L, V] logits and [B, L, L] links
    (``generator.py:34-56``)."""
    ol = (prev != vocab.pad).sum(dim=1)
    if cfg.strategy in ("lookahead", "greedy"):
        return greedy_or_lookahead_decode(
            logits, links, ol, vocab.pad, cfg.beta,
            lookahead=cfg.strategy == "lookahead")
    if cfg.strategy in ("viterbi", "jointviterbi"):
        return viterbi_decode(
            logits, links, ol, vocab.pad, cfg.beta, cfg.viterbibeta,
            joint=cfg.strategy == "jointviterbi",
            max_length=cfg.max_output_length or max(2, prev.shape[1] // 4))
    if cfg.strategy == "beamsearch":
        return beam_search_decode(
            logits, links, ol, vocab.pad, vocab.bos,
            beam_size=int(cfg.beamsize), top_cand_n=int(cfg.top_cand_n),
            decode_beta=cfg.beta, decode_alpha=cfg.alpha, top_p=cfg.top_p,
            dedup=cfg.dedup, max_steps=cfg.max_output_length or 0)
    raise NotImplementedError(cfg.strategy)


def length_beam_scores(cfg, logits: torch.Tensor, res: DecodeResult,
                       beam: int) -> torch.Tensor:
    """[B, beam] length-beam candidate scores: the mean log-prob of each
    candidate's path (:func:`path_score`), the start vertex's included
    under lookahead and greedy (``generator.py:136-141``)."""
    logp_max = torch.log_softmax(logits.float(), dim=-1).max(dim=-1).values
    return path_score(logp_max, res, include_start=cfg.strategy in (
        "lookahead", "greedy")).reshape(-1, beam)


def rerank_scores(reranker, fbank: torch.Tensor, src_lengths: torch.Tensor,
                  tokens: torch.Tensor, pad: int, eos: int,
                  beam: int) -> torch.Tensor:
    """[B * beam] length-beam candidate scores under an AR reranker
    (``generator.py:59-87``, the reference's
    ``--iter-decode-with-external-reranker``): candidate position 0
    becomes ``<eos>``, the reranker's text decoder is teacher-forced on
    ``cand[:, :-1]``, and the score is the pad-masked mean log-prob of
    ``cand[:, 1:]``. The reranker's encoder runs once at B and its output
    is repeated beam-wise. ``tokens`` [B * beam, L] pad-filled."""
    enc, enc_pad = reranker.forward_encoder(fbank, src_lengths)
    enc = enc.repeat_interleave(beam, dim=0)
    enc_pad = enc_pad.repeat_interleave(beam, dim=0)
    cand = tokens.clone()
    cand[:, 0] = eos
    logits, _ = reranker.mt_decode(cand[:, :-1], enc, enc_pad)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = cand[:, 1:]
    sc = logp.gather(-1, tgt[..., None])[..., 0]
    mask = tgt != pad
    return (torch.where(mask, sc, torch.zeros_like(sc)).sum(dim=1)
            / mask.sum(dim=1).clamp(min=1))


def decoder_pass(model, fbank: torch.Tensor, src_lengths: torch.Tensor,
                 prev: torch.Tensor, vocab, beam: int = 1):
    """Encoder -> (length-beam expanded) decoder: (logits, links, features,
    graph inputs), over B * beam rows.

    With ``beam > 1`` the encoder runs once and its output is repeated
    beam-wise, and the graph sizes ``glen + arange(beam) - beam // 2``,
    clipped to [2, L], become the graph inputs
    (``generator.py:117-128``)."""
    with span("decode.encoder"):
        enc, enc_pad, _ = model.encode(fbank, src_lengths)
    if beam > 1:
        L = prev.shape[1]
        glen = (prev != vocab.pad).sum(dim=1)
        offs = torch.arange(beam, device=prev.device) - beam // 2
        prev = initialize_output_tokens(
            (glen[:, None] + offs[None, :]).reshape(-1).clamp(2, L), L, vocab)
        enc = enc.repeat_interleave(beam, dim=0)
        enc_pad = enc_pad.repeat_interleave(beam, dim=0)
    with span("decode.decoder"):
        logits, links, feats = model.decode(prev, enc, enc_pad)
    return logits, links, feats, prev


def dag_forward_decode(model, fbank: torch.Tensor, src_lengths: torch.Tensor,
                       prev: torch.Tensor, vocab, cfg, reranker=None):
    """:func:`decoder_pass` -> decode strategy (``generator.py:90-146``).

    With ``cfg.length_beam > 1`` the candidate with the best
    :func:`path_score`, or with ``reranker`` the best
    :func:`rerank_scores`, survives (first on ties). Returns
    (DecodeResult, features [B, L, D]) at the original batch size."""
    beam = max(1, int(cfg.length_beam))
    if beam > 1 and cfg.strategy == "beamsearch":
        # beam search carries no per-path feat_idx, so the mean-logprob
        # candidate score would be 0 and argmax would pick the shortest
        # graph every time
        raise ValueError("length_beam > 1 is not supported with the "
                         "beamsearch strategy; use lookahead/viterbi")
    logits, links, feats, prev = decoder_pass(model, fbank, src_lengths,
                                              prev, vocab, beam)
    with span("decode.walk"):
        res = _strategy_decode(cfg, vocab, logits, links, prev)
    if beam > 1:
        if reranker is not None:
            sc = rerank_scores(reranker, fbank, src_lengths, res.tokens,
                               vocab.pad, vocab.eos, beam).reshape(-1, beam)
        else:
            sc = length_beam_scores(cfg, logits, res, beam)
        best = sc.argmax(dim=1)
        rows = torch.arange(best.shape[0], device=best.device) * beam + best
        res = DecodeResult(*(x[rows] for x in res))
        feats = feats[rows]
    return res, feats


class S2TNATGenerator:
    """DAG decoding to target tokens, optionally with iterative refinement
    (``generator.py:149-244``).

    ``model`` is an eval-mode module on one device; the batch's numpy
    arrays are moved there. ``reranker``, an eval-mode
    ``S2SMultiDecoderModel`` on that device, scores the length beam's
    candidates (:func:`rerank_scores`). :meth:`run` is one decode pass;
    :meth:`generate` runs the passes under ``torch.inference_mode()``."""

    def __init__(self, model, vocab, decode_cfg, reranker=None):
        if decode_cfg.length_beam > 1 and decode_cfg.iter_decode_max_iter > 0:
            # the reference refines all B*beam candidates and reduces the
            # beam after the loop; here the beam reduces inside each pass,
            # so feeding the winner back would re-initialise its graph from
            # its length alone and drop the fed-back tokens
            raise ValueError(
                "length_beam > 1 cannot be combined with "
                "iter_decode_max_iter > 0: the length beam reduces inside "
                "each pass, so refinement would not see the fed-back "
                "tokens. Use one or the other.")
        self.model = model
        self.reranker = reranker
        self.vocab = vocab
        self.cfg = decode_cfg
        self.device = (next(model.parameters()).device if model is not None
                       else torch.device("cpu"))

    def to_device(self, batch: Dict[str, np.ndarray]):
        """(fbank, src_lengths, prev_output_tokens) as tensors on the
        model's device."""
        d = self.device
        with span("generate.h2d"):
            return (torch.as_tensor(batch["fbank"], dtype=torch.float32,
                                    device=d),
                    torch.as_tensor(batch["src_lengths"], device=d).long(),
                    torch.as_tensor(batch["prev_output_tokens"],
                                    device=d).long())

    def run(self, fbank, src_lengths, prev):
        """One decode pass: (DecodeResult, features [B, L, D])."""
        return dag_forward_decode(self.model, fbank, src_lengths, prev,
                                  self.vocab, self.cfg, self.reranker)

    def refine(self, fbank, src_lengths, prev):
        """Iterative refinement (``generator.py:188-226``): re-run the
        decoder on its own padded output, up to ``iter_decode_max_iter``
        extra passes. Unless ``iter_decode_force_max_iter``, a sample is done
        once its output equals its input (the reference's ``is_a_loop``),
        and the loop stops when every sample is; done rows keep their
        accepted result by masking. Returns (DecodeResult, accepted_input),
        where a pass on accepted_input reproduces the accepted output (the
        decoder is deterministic in eval mode). Each pass's stop test reads
        one bool back to the host."""
        res, _ = self.run(fbank, src_lengths, prev)
        adaptive = not self.cfg.iter_decode_force_max_iter
        accepted, accepted_input = list(res), prev
        terminated = torch.zeros(prev.shape[0], dtype=torch.bool,
                                 device=prev.device)
        for _ in range(int(self.cfg.iter_decode_max_iter)):
            cur = accepted[0]                  # the previous pass's tokens
            new, _ = self.run(fbank, src_lengths, cur)
            live = ~terminated
            accepted = [torch.where(live if a.ndim == 1 else live[:, None],
                                    n, a) for n, a in zip(new, accepted)]
            accepted_input = torch.where(live[:, None], cur, accepted_input)
            if adaptive:
                terminated = terminated | (new.tokens == cur).all(dim=1)
                if bool(terminated.all()):
                    break
        return DecodeResult(*accepted), accepted_input

    def generate(self, batch: Dict[str, np.ndarray]) -> List[Dict]:
        with span("generate"), torch.inference_mode():
            _count_batch(batch)
            inputs = self.to_device(batch)
            with span("generate.decode"):
                res = (self.refine(*inputs)[0]
                       if self.cfg.iter_decode_max_iter > 0
                       else self.run(*inputs)[0])
            with span("generate.results"):
                with span("results.d2h"):
                    tokens, lengths = _to_host(res.tokens, res.lengths)
                with span("results.split"):
                    return [{"tokens": tokens[b, : lengths[b]]}
                            for b in range(tokens.shape[0])]


class S2SNATGenerator(S2TNATGenerator):
    """DAG decode -> hidden-state gather -> adaptor + FastSpeech 2 ->
    (gcmvn denorm) -> (vocoder); ``generator.py:247-347``.

    ``model`` and ``vocoder`` are eval-mode modules on one device.
    ``gcmvn``, when given, has the interface of the JAX package's
    ``GlobalCMVN`` (``mean``, ``std``, ``denormalize``). Every strategy but
    ``beamsearch`` (which tracks no path features) is served; under
    refinement the tokens are refined first and the speech is synthesised
    from the accepted graph input. The three stages are public so that a
    caller can time them apart; :meth:`generate` runs them in order under
    ``torch.inference_mode()``."""

    def __init__(self, model, vocab, decode_cfg, max_mel_len: int = 1024,
                 vocoder=None, gcmvn=None, d_factor: float = 1.0,
                 reranker=None):
        super().__init__(model, vocab, decode_cfg, reranker=reranker)
        if decode_cfg.strategy == "beamsearch":
            # beam_search_decode returns feat_idx = -1 everywhere (S2T
            # only); gathering from it would synthesise from vertex 0
            raise NotImplementedError(
                "beamsearch does not track path features for the TTS pass; "
                "use lookahead, viterbi, or jointviterbi for S2S")
        self.max_mel_len = max_mel_len
        self.vocoder = vocoder
        self.gcmvn = gcmvn
        self.d_factor = d_factor
        self._vocode = make_vocode_fn(vocoder, gcmvn)

    def decode(self, fbank, src_lengths, prev):
        """Stage 1: encoder + decoder + links + decode strategy ->
        (DecodeResult, path features [B, L, D], their pad mask). Under
        refinement, the tokens are refined first and this pass runs on the
        accepted graph input (``generator.py:309-320``)."""
        with span("generate.decode"):
            if self.cfg.iter_decode_max_iter > 0:
                _, prev = self.refine(fbank, src_lengths, prev)
            res, feats = self.run(fbank, src_lengths, prev)
            # lookahead/greedy: slot 0 (<bos>) carries no feature; Viterbi
            # keeps the first emitted vertex's
            with span("decode.gather"):
                z, zmask = gather_path_features(
                    feats, res,
                    skip_first=self.cfg.strategy in ("lookahead", "greedy"))
            return res, z, zmask

    def synthesize(self, z, zmask):
        """Stage 2: adaptor + FastSpeech 2 -> (mel [B, M, 80], mel_lens):
        the Postnet's mel when the model has one (``generator.py:
        291-294``)."""
        with span("generate.synthesize"):
            mel, mel_post, mel_lens = self.model.synthesize(
                z, zmask, self.max_mel_len, d_factor=self.d_factor)[:3]
            # the frames synthesised, and vocoded: the whole mel bucket
            count("synth.mel_frames", mel.shape[0] * mel.shape[1])
            return (mel if mel_post is None else mel_post), mel_lens

    def vocode(self, mel):
        """Stage 3: gcmvn denormalization + HiFi-GAN -> wav [B, M*256],
        one-shot or, for a vocoder with ``serve_chunk > 0``, chunked
        (``generator.py:324-328`` through ``make_vocode_fn``)."""
        with span("generate.vocode"):
            return self._vocode(mel)

    def generate(self, batch: Dict[str, np.ndarray],
                 generate_waveform: bool = True) -> List[Dict]:
        with span("generate"), torch.inference_mode():
            _count_batch(batch)
            res, z, zmask = self.decode(*self.to_device(batch))
            mel, mel_lens = self.synthesize(z, zmask)
            wav = (self.vocode(mel)
                   if generate_waveform and self.vocoder is not None
                   else None)
            return self._hypotheses(res, mel, mel_lens, wav)

    def _hypotheses(self, res: DecodeResult, mel, mel_lens, wav):
        """One device-to-host transfer per output, then per-utterance
        slicing (``generator.py:329-347``)."""
        with span("generate.results"):
            with span("results.d2h"):
                host = _to_host(res.tokens, res.lengths, mel, mel_lens,
                                *(() if wav is None else (wav,)))
            tokens, lengths, mel, mel_lens = host[:4]
            wav_np = host[4] if wav is not None else None
            # a row keeps at most the frames that were synthesised
            count("results.mel_frames_kept",
                  int(np.minimum(mel_lens, mel.shape[1]).sum()))
            with span("results.split"):
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


def _count_batch(batch: Dict[str, np.ndarray]) -> None:
    count("generate.batches")
    count("generate.utterances", len(batch["src_lengths"]))


def _to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Each tensor copied to the host (one ``.cpu()`` each), counted in
    ``results.d2h_copies`` and ``results.d2h_bytes``."""
    out = [t.cpu().numpy() for t in tensors]
    count("results.d2h_copies", len(out))
    count("results.d2h_bytes", sum(a.nbytes for a in out))
    return out
