"""Joint two-pass S2ST loss (PyTorch): DAG loss + FastSpeech 2 loss over
expected (or Viterbi-argmax) hidden states.

Counterpart of ``daspeech_tpu/losses/s2s_loss.py``, with the DAG loss's
memory variants of ``losses/dag_loss.py`` (``banded_dp``: banded links, the
block-banded DP and Viterbi; ``fused_vocab_chunk``: the streamed
vocabulary projection, no [B, L, V] logits):

- ``expect``: posterior weights score = exp(alpha + beta - logsumexp_j(alpha
  + beta)), alpha and beta both including the emission term (the
  reference's quantity, not the textbook posterior), NaN -> 0, no
  gradient; expected features = score @ features, the <bos> row dropped;
- ``argmax``: features gathered along the Viterbi best alignment,
  compacted to the left;
- total = dag + tts_loss_weight * tts.

Randomness: four seeds from the host generator (no device sync): the
encoder's dropout, one shared by BOTH decoder passes (as in
``nat_dag_loss``), the glance draws, and FastSpeech 2's dropout (JAX's
``k_tts``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from daspeech_torch.losses.dag_loss import (
    GlanceDraws,
    _best_alignment,
    banded_links,
    compute_dag_loss,
    conditional_stop_gradient,
    dag_decode,
    device_generator,
    glance_pass,
    vocab_matrix,
)
from daspeech_torch.losses.fastspeech2_loss import fastspeech2_losses
from daspeech_torch.models.layers import lengths_to_padding_mask
from daspeech_torch.ops.dag_ref import dag_logsoftmax_gather_tokens
from daspeech_torch.ops.fused_vocab import fused_logsoftmax_gather


def dag_frozen(step: int, dag_freezing_steps: int) -> bool:
    """Whether the DAG half is frozen at update ``step`` (the count of
    updates done): while step <= ``dag_freezing_steps``, never when it is
    not positive (``cli/train.py:418-421``)."""
    return dag_freezing_steps > 0 and step <= dag_freezing_steps


def _logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    m = x.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True)) + m


def expected_features(alpha: torch.Tensor, beta: torch.Tensor,
                      features: torch.Tensor) -> torch.Tensor:
    """``expect`` (``s2s_loss.py:42-53``): z_t = sum_j score[t, j] v_j with
    the <bos> row removed. alpha/beta [B, T, L], features [B, L, D] ->
    [B, T-1, D]; gradient flows to the features only."""
    with torch.no_grad():
        joint = alpha + beta
        score = torch.exp(joint - _logsumexp_last(joint))
        score = torch.where(torch.isfinite(score), score,
                            torch.zeros_like(score))
    return torch.bmm(score.to(features.dtype), features)[:, 1:]


def argmax_path_features(logits: Optional[torch.Tensor],
                         links: torch.Tensor, tgt_tokens: torch.Tensor,
                         prev_output_tokens: torch.Tensor,
                         features: torch.Tensor, pad: int,
                         match_all: Optional[torch.Tensor] = None,
                         max_transition_length: Optional[int] = None,
                         banded_dp: bool = False,
                         links_banded: bool = False):
    """``argmax`` (``s2s_loss.py:56-92``): the features of the vertices on
    the Viterbi path, without <bos> (``path[:, 0] = -1``); the path's
    vertices increase with their target position, so placing vertex j at
    slot path[j] - 1 compacts them to the left. Pass ``logits`` or a
    precomputed ``match_all`` [B, T, L] (the streamed vocabulary
    projection); the Viterbi is routed as the DAG loss routes it. Returns
    (feats [B, T-1, D], lengths [B])."""
    T = tgt_tokens.shape[1]
    output_length = (prev_output_tokens != pad).sum(dim=1)
    target_length = (tgt_tokens != pad).sum(dim=1)
    with torch.no_grad():
        match = (dag_logsoftmax_gather_tokens(logits, tgt_tokens
                                              ).transpose(1, 2)
                 if match_all is None else match_all.detach())
        path = _best_alignment(match, links.detach(), output_length,
                               target_length, max_transition_length,
                               banded_dp, links_banded).long()
        path[:, 0] = -1                                  # mask <bos>
        onehot = ((path[:, :, None] - 1
                   == torch.arange(T - 1, device=path.device))
                  & (path >= 1)[:, :, None])             # [B, L, T-1]
    feats = torch.bmm(onehot.to(features.dtype).transpose(1, 2), features)
    return feats, onehot.sum(dim=(1, 2))


def s2s_dag_fastspeech2_loss(model, batch: Dict[str, torch.Tensor],
                             rng: torch.Generator, glat_p, vocab,
                             tts_loss_weight: float = 5.0,
                             training_strategy: str = "expect",
                             freeze_dag: bool = False,
                             freeze_encoder: bool = False,
                             glat_draws: Optional[GlanceDraws] = None,
                             glance_strategy: Optional[str] = "number-random",
                             no_force_emit: bool = False,
                             train: bool = True,
                             fused_vocab_chunk: Optional[int] = None,
                             max_transition_length: Optional[int] = None,
                             banded_dp: bool = False):
    """Criterion forward of one joint training pass (``s2s_loss.py:95-273``):
    (loss, metrics).

    ``model`` is an ``S2SConformerDAGFastSpeech2``; ``batch`` holds device
    tensors fbank [B, S, 80], src_lengths [B], target_text [B, T],
    prev_output_tokens [B, L], target_audio [B, M, 80],
    target_audio_lengths [B], durations / pitches / energies [B, >= T-1]
    and optionally sample_mask [B]. ``freeze_dag`` (see :func:`dag_frozen`)
    stops every gradient into the DAG half (encoder and decoder, the
    streamed projection's vocabulary matrix included) through the DAG loss
    and the TTS loss; ``freeze_encoder`` stops the encoder's.
    ``glat_draws`` replaces the glance's own draws. ``train=False`` is the
    validation loss (``cli/train.py:622-642``): an inference pass (no
    dropout, BatchNorm's running statistics), without a glance.
    ``fused_vocab_chunk``, ``max_transition_length`` and ``banded_dp``: the
    DAG loss's memory variants (``losses/dag_loss.py``)."""
    if training_strategy not in ("expect", "argmax"):
        raise ValueError(training_strategy)
    fbank, src_lengths = batch["fbank"], batch["src_lengths"]
    tgt_tokens = batch["target_text"]
    prev_output_tokens = batch["prev_output_tokens"]
    sample_mask = batch.get("sample_mask")
    dev = fbank.device
    enc_seed, dec_seed, glat_seed, tts_seed = (
        int(s) for s in torch.randint(0, 2 ** 62, (4,), generator=rng))
    band = banded_links(model, prev_output_tokens, max_transition_length,
                        banded_dp)
    fused = fused_vocab_chunk is not None
    vocab_w = vocab_matrix(model.dag.decoder) if fused else None
    route = dict(max_transition_length=max_transition_length,
                 banded_dp=banded_dp)

    def gen(seed):          # a training pass draws; validation does not
        return device_generator(dev, seed) if train else None

    enc, enc_pad, _ = model.encode(fbank, src_lengths, rng=gen(enc_seed))
    enc = conditional_stop_gradient(enc, freeze_encoder)

    info = glance_pass(model, prev_output_tokens, enc, enc_pad, dec_seed,
                       tgt_tokens, glat_p, vocab, glat_seed, glat_draws,
                       sample_mask, glance_strategy if train else None,
                       fused_vocab_chunk, vocab_w, band_links=band, **route)
    prev2 = prev_output_tokens if info is None else info.prev_output_tokens

    logits, links, features = dag_decode(model, prev2, enc, enc_pad,
                                         gen(dec_seed), band, fused)
    links = conditional_stop_gradient(links, freeze_dag)
    features = conditional_stop_gradient(features, freeze_dag)
    match_all = None
    if fused:
        W_vocab, b_vocab = vocab_w
        match_all = fused_logsoftmax_gather(
            features, conditional_stop_gradient(W_vocab, freeze_dag),
            b_vocab, tgt_tokens, fused_vocab_chunk)
    else:
        logits = conditional_stop_gradient(logits, freeze_dag)
    dagloss, metrics, alpha, beta = compute_dag_loss(
        logits, links, tgt_tokens, prev2, vocab.pad,
        None if info is None else info.matchmask,
        None if info is None else info.keep_word_mask,
        sample_mask=sample_mask, with_alpha_beta=True,
        no_force_emit=no_force_emit, match_all=match_all,
        links_banded=band, **route)

    # ---- FastSpeech 2 over the selected hidden states
    if training_strategy == "expect":
        z = expected_features(alpha, beta, features)       # [B, T-1, D]
        z_lengths = (tgt_tokens != vocab.pad).sum(dim=1) - 1
    else:
        z, z_lengths = argmax_path_features(
            logits, links, tgt_tokens, prev2, features, vocab.pad,
            match_all=match_all, links_banded=band, **route)
    n = z.shape[1]
    z_pad_mask = lengths_to_padding_mask(z_lengths, n)
    mel_tgt = batch["target_audio"]
    M = mel_tgt.shape[1]
    durations = batch["durations"][:, :n]
    pitches = batch["pitches"][:, :n]
    energies = batch["energies"][:, :n]
    mel, mel_post, _, log_dur_out, pitch_out, energy_out = model.synthesize(
        z, z_pad_mask, M, durations, pitches=pitches, energies=energies,
        rng=gen(tts_seed))

    src_mask = ~z_pad_mask
    mel_mask = ~lengths_to_padding_mask(batch["target_audio_lengths"], M)
    if sample_mask is not None:
        real = sample_mask.to(torch.bool)
        src_mask = src_mask & real[:, None]
        mel_mask = mel_mask & real[:, None]
    tts_loss, tts_metrics = fastspeech2_losses(
        mel, mel_post, log_dur_out, pitch_out, energy_out, mel_tgt, durations,
        pitches, energies, src_mask, mel_mask)

    loss = dagloss + tts_loss * tts_loss_weight
    metrics.update(tts_metrics)
    metrics["loss"] = loss.detach()
    if info is not None:
        metrics["glat_accu"] = info.glat_accu
        metrics["glat_keep"] = info.glat_keep
    return loss, metrics
