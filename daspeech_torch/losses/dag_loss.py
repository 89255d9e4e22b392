"""NAT DAG loss with glancing training (GLAT), PyTorch.

Counterpart of ``daspeech_tpu/losses/dag_loss.py``: ``glat_glance``,
``force_emit_match``, ``compute_dag_loss`` and ``nat_dag_loss``, with the
JAX package's public layouts (match [B, T, L], links [B, L, L] or, banded,
[B, L, W]). The full-matrix DP and Viterbi run through ``ops/dag_ref.py``:
plain loops for CPU tensors, the CUDA kernels for CUDA tensors. Metrics
stay on the device; nothing here reads a value back to the host.

The memory variants, as in JAX:

- ``banded_dp`` with a ``max_transition_length`` W < L - 1: the model
  extracts [B, L, W] links (``extract_links_banded``) and the DP and the
  Viterbi run block-banded (``ops/dag_banded.py``), so no [L, L] matrix
  exists; a W that covers the upper triangle (the recipe's 99999) leaves
  the full-matrix path;
- ``fused_vocab_chunk``: the [B, L, V] logits never exist; the glance and
  the loss take the streamed vocabulary projection of
  ``ops/fused_vocab.py`` over the decoder's features.

Both are plain tensor ops on the card too. The banded path trades the DP,
Viterbi and link kernels (#8, #9, #4) for memory that grows as L W, not
L^2; at the L the decoder's 1024 positions allow, its [B, L, W, H]
intermediates still outweigh the [L, L] tensors (``PERF.md`` §6).

The glance strategies are the JAX CLI's: ``number-random`` (the
recipe's), ``cmlm``, and None (no glancing pass); forced emission is on
unless ``no_force_emit``.

Under a data-parallel step (``parallel.multihost.data_parallel``) each rank
holds some rows of the global batch, and every mean here divides by a
count summed over the ranks (``multihost.global_sum``): each rank's loss
and metrics are then its share of the global batch's, and their sum is
JAX's global-batch value.

Randomness: ``nat_dag_loss`` draws three seeds from a host generator (no
device sync): one for the encoder's dropout, one shared by BOTH decoder
passes (so they drop the same elements, as the JAX criterion hands both
passes one rng and the reference reuses its ``torch_seed``), and one for
the glance draws.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from daspeech_torch.ops.dag_banded import (
    dag_best_alignment_banded,
    dag_loss_banded,
    dag_loss_banded_with_alpha_beta,
)
from daspeech_torch.ops.dag_ref import (
    dag_best_alignment,
    dag_logsoftmax_gather_tokens,
    dag_loss,
    dag_loss_with_alpha_beta,
    vocab_argmax,
)
from daspeech_torch.ops.fused_vocab import (
    fused_logsoftmax_gather,
    streaming_argmax_and_match,
)
from daspeech_torch.ops.links_utils import band_to_full, full_to_band
from daspeech_torch.parallel import shard
from daspeech_torch.parallel.multihost import global_sum

GLANCE_STRATEGIES = ("number-random", "cmlm")


def conditional_stop_gradient(x: torch.Tensor, frozen: bool) -> torch.Tensor:
    """``x`` detached when ``frozen`` (``dag_loss.py:29-41``): the value is
    unchanged, no gradient flows back through it. ``frozen`` is a host bool
    (``dag_freezing_steps`` and ``encoder_freezing_updates`` are decided
    from the host's step count), so this reads nothing from the device."""
    return x.detach() if frozen else x


def _band_width(max_transition_length: Optional[int],
                L: int) -> Optional[int]:
    """The band width W, or None when the band covers the full upper
    triangle (``dag_loss.py:44-62``): the recipe's 99999 is a no-op."""
    if max_transition_length is None or max_transition_length <= 0:
        return None
    return max_transition_length if max_transition_length < L - 1 else None


def _best_alignment(match, links, output_length, target_length,
                    max_transition_length=None, banded_dp=False,
                    links_banded=False):
    """The full-matrix or block-banded Viterbi (``dag_loss.py:65-93``).
    ``links_banded``: ``links`` is already [B, L, W]."""
    if links_banded:
        if banded_dp:
            return dag_best_alignment_banded(match, links, output_length,
                                             target_length)
        return dag_best_alignment(match, band_to_full(links), output_length,
                                  target_length)
    W = _band_width(max_transition_length, links.shape[1])
    if W is None or not banded_dp:
        return dag_best_alignment(match, links, output_length, target_length)
    return dag_best_alignment_banded(match, full_to_band(links, W),
                                     output_length, target_length)


def vocab_matrix(decoder):
    """(W [D, V], zero bias [V] f32) of a ``GlatLinkDecoder``'s output
    projection: the tied embedding's transpose, or ``output_projection``'s
    (``dag_loss.py:376-382``)."""
    if decoder.share_input_output_embed:
        W = decoder.embed_tokens.weight
        if decoder.embed_tokens.tp is not None:
            # the vocabulary split over model: the stream runs on the
            # whole table on every rank, each keeping its rows' gradient
            W = shard.gather(W, decoder.embed_tokens.tp, 0, summed=False)
        W = W.t()
    else:
        W = decoder.output_projection.weight.t()
    return W, torch.zeros((W.shape[1],), dtype=torch.float32,
                          device=W.device)


def dag_decode(model, prev_output_tokens, enc, enc_pad, rng,
               band_links: bool = False, fused: bool = False):
    """(logits, links, features) of one decoder pass: links banded [B, L,
    W] with ``band_links``, and no logits (None) with ``fused``."""
    if fused:
        fn = (model.decode_features_banded if band_links
              else model.decode_features)
        links, feats = fn(prev_output_tokens, enc, enc_pad, rng=rng)
        return None, links, feats
    fn = model.decode_banded if band_links else model.decode
    return fn(prev_output_tokens, enc, enc_pad, rng=rng)


class GlanceDraws(NamedTuple):
    """The glance's random draws (``dag_loss.py:152-176``)."""
    normal: torch.Tensor                  # [B, L] standard normal ranking
    keep: torch.Tensor                    # [B, L] uniform keep draw
    frac: Optional[torch.Tensor] = None   # [B] uniform fraction (``cmlm``)


class GlatInfo(NamedTuple):
    prev_output_tokens: torch.Tensor      # [B, L] glanced decoder input
    matchmask: torch.Tensor               # [B, T, L] bool
    keep_word_mask: torch.Tensor          # [B, L] bool
    glat_accu: torch.Tensor               # scalar
    glat_keep: torch.Tensor               # scalar


@torch.no_grad()
def glat_glance(logits: Optional[torch.Tensor], links: torch.Tensor,
                tgt_tokens: torch.Tensor, prev_output_tokens: torch.Tensor,
                context_p, pad: int,
                rng: Optional[torch.Generator] = None,
                draws: Optional[GlanceDraws] = None,
                sample_mask: Optional[torch.Tensor] = None,
                strategy: str = "number-random",
                pred_tokens: Optional[torch.Tensor] = None,
                match: Optional[torch.Tensor] = None,
                max_transition_length: Optional[int] = None,
                banded_dp: bool = False,
                links_banded: bool = False) -> GlatInfo:
    """``glat_function`` (``dag_loss.py:102-189``): Viterbi-align the graph
    to the reference, count mispredictions, and replace aligned vertices,
    picked at random, with oracle target tokens: ``context_p`` times the
    mispredictions under ``number-random``, a uniform random fraction of
    the target length under ``cmlm``.

    Pass either ``logits`` or, from the streamed vocabulary projection,
    ``pred_tokens`` [B, L] and ``match`` [B, T, L]. ``links`` is [B, L, W]
    with ``links_banded``; ``banded_dp`` and ``max_transition_length``
    route the Viterbi (:func:`_best_alignment`). ``draws``
    (:class:`GlanceDraws`) reproduces another generator's glance; without
    it the draws come from ``rng``."""
    if strategy not in GLANCE_STRATEGIES:
        raise ValueError(f"unknown glance strategy {strategy!r}")
    B, L = prev_output_tokens.shape
    T = tgt_tokens.shape[1]
    dev = prev_output_tokens.device
    target_length = (tgt_tokens != pad).sum(dim=1)
    output_length = (prev_output_tokens != pad).sum(dim=1)

    if logits is not None:
        pred_tokens = vocab_argmax(logits)
        match = dag_logsoftmax_gather_tokens(logits, tgt_tokens
                                             ).transpose(1, 2)
    path = _best_alignment(match, links, output_length, target_length,
                           max_transition_length, banded_dp,
                           links_banded).long()

    predict_align_mask = path >= 0
    matchmask = path[:, None, :] == torch.arange(T, device=dev)[None, :, None]
    oracle = tgt_tokens.long().gather(1, path.clamp(min=0))
    same_num = ((pred_tokens == oracle) & predict_align_mask).sum(dim=1)

    if draws is None:
        draws = GlanceDraws(
            torch.randn((B, L), generator=rng, device=dev),
            torch.rand((B, L), generator=rng, device=dev),
            torch.rand((B,), generator=rng, device=dev)
            if strategy == "cmlm" else None)
    prob = torch.where(predict_align_mask, draws.normal, -100.0)
    if strategy == "number-random":
        p = torch.as_tensor(context_p, dtype=torch.float32, device=dev)
        glance_nums = ((target_length - same_num).float() * p + 0.5
                       ).to(torch.int64)
    else:
        glance_nums = (target_length.float() * draws.frac + 0.5
                       ).to(torch.int64)
    sorted_desc = torch.sort(prob, dim=-1, descending=True).values
    thresh = sorted_desc.gather(
        1, (glance_nums - 1).clamp(min=0)[:, None])[:, 0]
    thresh = torch.where(glance_nums == 0, 100.0, thresh)
    keep_prob = (prob >= thresh[:, None]).float()

    keep_word_mask = draws.keep < keep_prob
    glat_prev = torch.where(keep_word_mask, oracle, prev_output_tokens)
    smask = (torch.ones((B,), device=dev) if sample_mask is None
             else sample_mask.float())
    return GlatInfo(
        prev_output_tokens=glat_prev,
        matchmask=matchmask,
        keep_word_mask=keep_word_mask,
        glat_accu=((same_num * smask).sum()
                   / global_sum((target_length * smask).sum()).clamp(min=1)),
        glat_keep=((keep_prob * smask[:, None]).sum()
                   / (global_sum(smask.sum()) * L).clamp(min=1.0)))


def force_emit_match(match_all: torch.Tensor, matchmask: torch.Tensor,
                     keep_word_mask: torch.Tensor,
                     no_force_emit: bool = False) -> torch.Tensor:
    """Pin glanced vertices to their aligned target position
    (``dag_loss.py:192-205``); the forced columns carry no gradient."""
    if no_force_emit:
        return match_all
    forced = torch.where(matchmask, match_all,
                         torch.full_like(match_all, -torch.inf)).detach()
    return torch.where(keep_word_mask[:, None, :], forced, match_all)


def compute_dag_loss(logits: Optional[torch.Tensor], links: torch.Tensor,
                     tgt_tokens: torch.Tensor,
                     prev_output_tokens: torch.Tensor, pad: int,
                     matchmask: Optional[torch.Tensor],
                     keep_word_mask: Optional[torch.Tensor],
                     sample_mask: Optional[torch.Tensor] = None,
                     with_alpha_beta: bool = False,
                     no_force_emit: bool = False,
                     match_all: Optional[torch.Tensor] = None,
                     max_transition_length: Optional[int] = None,
                     banded_dp: bool = False,
                     links_banded: bool = False):
    """``_compute_dag_loss`` (``dag_loss.py:208-299``): (loss, metrics), and
    with ``with_alpha_beta`` also the DP's alpha and beta [B, T, L] (both
    including the emission term; constants, no gradient). Non-finite
    sentences (unsatisfiable graphs) are masked out of the mean and carry no
    gradient. Without a glance (``matchmask`` None) nothing is forced.

    ``match_all`` [B, T, L] replaces ``logits`` (the streamed vocabulary
    projection). ``banded_dp`` with ``max_transition_length`` < L - 1, or
    links already banded (``links_banded``), runs the block-banded DP;
    banded links without ``banded_dp`` are widened to [L, L] first
    (``dag_loss.py:250-257``)."""
    B, L = prev_output_tokens.shape
    output_length = (prev_output_tokens != pad).sum(dim=1)
    target_length = (tgt_tokens != pad).sum(dim=1)
    smask = (torch.ones((B,), device=links.device) if sample_mask is None
             else sample_mask.float())

    if match_all is None:
        match_all = dag_logsoftmax_gather_tokens(logits, tgt_tokens
                                                 ).transpose(1, 2)
    if matchmask is not None:
        match_all = force_emit_match(match_all, matchmask, keep_word_mask,
                                     no_force_emit)
    match_all = match_all.contiguous()
    if links_banded and not banded_dp:
        links, links_banded = band_to_full(links), False
    W = _band_width(max_transition_length, L) if banded_dp else None
    if links_banded or W is not None:
        band = links if links_banded else full_to_band(links, W)
        if with_alpha_beta:
            logprob, alpha, beta = dag_loss_banded_with_alpha_beta(
                match_all, band, output_length, target_length)
        else:
            logprob = dag_loss_banded(match_all, band, output_length,
                                      target_length)
    elif with_alpha_beta:
        logprob, alpha, beta = dag_loss_with_alpha_beta(
            match_all, links, output_length, target_length)
    else:
        logprob = dag_loss(match_all, links, output_length, target_length)

    invalid = ~torch.isfinite(logprob)
    safe_logprob = torch.where(invalid, torch.zeros_like(logprob), logprob)
    per_sent = safe_logprob / target_length.clamp(min=1)
    loss = -(per_sent * smask).sum() / global_sum(smask.sum()).clamp(min=1.0)
    metrics = {
        "dag-loss": loss.detach(),
        "invalid_nsentences": (invalid.float() * smask).sum().to(torch.int32),
        "nsentences": smask.sum().to(torch.int32),
        "ntokens": (target_length * smask).sum().to(torch.int32),
        "nvalidtokens": (output_length * smask).sum().to(torch.int32),
    }
    if with_alpha_beta:
        return loss, metrics, alpha, beta
    return loss, metrics


def device_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def glance_pass(model, prev_output_tokens, enc, enc_pad, dec_seed: int,
                tgt_tokens, glat_p, vocab, glat_seed: int,
                glat_draws: Optional[GlanceDraws], sample_mask,
                strategy: Optional[str], fused_vocab_chunk=None,
                vocab_w=None, max_transition_length=None,
                banded_dp: bool = False,
                band_links: bool = False) -> Optional[GlatInfo]:
    """The first decoder pass and the glance over it, without gradient
    (``dag_loss.py:388-414``); None without a glance strategy. GLAT p = 0
    glances too and keeps no vertex, as in JAX (the shapes and the work do
    not depend on p). With ``fused_vocab_chunk`` the pass yields features
    only and ``vocab_w`` = (W, bias) streams their argmax and match."""
    if strategy is None:
        return None
    dev = enc.device
    with torch.no_grad():
        fused = fused_vocab_chunk is not None
        logits1, links1, feats1 = dag_decode(
            model, prev_output_tokens, enc, enc_pad,
            device_generator(dev, dec_seed), band_links, fused)
        pred1 = match1 = None
        if fused:
            pred1, match1 = streaming_argmax_and_match(
                feats1, *vocab_w, tgt_tokens, fused_vocab_chunk)
        return glat_glance(logits1, links1, tgt_tokens, prev_output_tokens,
                           glat_p, vocab.pad,
                           rng=device_generator(dev, glat_seed),
                           draws=glat_draws, sample_mask=sample_mask,
                           strategy=strategy, pred_tokens=pred1,
                           match=match1,
                           max_transition_length=max_transition_length,
                           banded_dp=banded_dp, links_banded=band_links)


def banded_links(model, prev_output_tokens, max_transition_length,
                 banded_dp: bool) -> bool:
    """Whether the model extracts banded links: ``banded_dp`` with a real
    band width (``dag_loss.py:348-356``)."""
    return (banded_dp and _band_width(max_transition_length,
                                      prev_output_tokens.shape[1])
            is not None and hasattr(model, "decode_banded"))


def nat_dag_loss(model, batch: Dict[str, torch.Tensor],
                 rng: torch.Generator, glat_p, vocab,
                 glat_draws: Optional[GlanceDraws] = None,
                 glance_strategy: Optional[str] = "number-random",
                 no_force_emit: bool = False,
                 freeze_encoder: bool = False,
                 fused_vocab_chunk: Optional[int] = None,
                 max_transition_length: Optional[int] = None,
                 banded_dp: bool = False):
    """Criterion forward of one training pass (``dag_loss.py:302-447``):
    (loss, metrics).

    ``batch`` holds device tensors fbank [B, S, 80], src_lengths [B],
    target [B, T], prev_output_tokens [B, L] and optionally sample_mask
    [B]. ``rng`` is a host ``torch.Generator``; ``glat_draws`` (see
    :func:`glat_glance`) replaces the glance's own draws. The encoder runs
    once; the glance pass runs without gradient. ``freeze_encoder`` (a
    host bool: ``--encoder-freezing-updates`` decided from the update
    count, ``dag_loss.py:362-365``) stops the encoder's gradient.
    ``fused_vocab_chunk``, ``max_transition_length`` and ``banded_dp``: the
    memory variants (module docstring); the vocabulary matrix of the
    streamed projection is the decoder's tied embedding or output
    projection, with a zero bias."""
    fbank, src_lengths = batch["fbank"], batch["src_lengths"]
    tgt_tokens = batch["target"]
    prev_output_tokens = batch["prev_output_tokens"]
    sample_mask = batch.get("sample_mask")
    dev = fbank.device
    enc_seed, dec_seed, glat_seed = (
        int(s) for s in torch.randint(0, 2 ** 62, (3,), generator=rng))
    band = banded_links(model, prev_output_tokens, max_transition_length,
                        banded_dp)
    fused = fused_vocab_chunk is not None
    vocab_w = vocab_matrix(model.decoder) if fused else None
    route = dict(max_transition_length=max_transition_length,
                 banded_dp=banded_dp)

    enc, enc_pad, _ = model.encode(fbank, src_lengths,
                                   rng=device_generator(dev, enc_seed))
    enc = conditional_stop_gradient(enc, freeze_encoder)

    info = glance_pass(model, prev_output_tokens, enc, enc_pad, dec_seed,
                       tgt_tokens, glat_p, vocab, glat_seed, glat_draws,
                       sample_mask, glance_strategy, fused_vocab_chunk,
                       vocab_w, band_links=band, **route)
    prev2 = prev_output_tokens if info is None else info.prev_output_tokens

    logits, links, feats = dag_decode(model, prev2, enc, enc_pad,
                                      device_generator(dev, dec_seed), band,
                                      fused)
    match_all = (fused_logsoftmax_gather(feats, *vocab_w, tgt_tokens,
                                         fused_vocab_chunk)
                 if fused else None)
    loss, metrics = compute_dag_loss(
        logits, links, tgt_tokens, prev2, vocab.pad,
        None if info is None else info.matchmask,
        None if info is None else info.keep_word_mask,
        sample_mask=sample_mask, no_force_emit=no_force_emit,
        match_all=match_all, links_banded=band, **route)
    if info is not None:
        metrics["glat_accu"] = info.glat_accu
        metrics["glat_keep"] = info.glat_keep
    metrics["loss"] = loss.detach()
    return loss, metrics
