"""NAT DAG loss with glancing training (GLAT), PyTorch.

Counterpart of ``daspeech_tpu/losses/dag_loss.py`` (full-matrix path):
``glat_glance``, ``force_emit_match``, ``compute_dag_loss`` and
``nat_dag_loss``, with the JAX package's public layouts (match [B, T, L],
links [B, L, L]). The DP and Viterbi run through ``ops/dag_ref.py``: plain
loops for CPU tensors, the CUDA kernels for CUDA tensors. Metrics stay on
the device; nothing here reads a value back to the host.

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

from daspeech_torch.ops.dag_ref import (
    dag_best_alignment,
    dag_logsoftmax_gather_tokens,
    dag_loss,
    dag_loss_with_alpha_beta,
)
from daspeech_torch.parallel.multihost import global_sum

GLANCE_STRATEGIES = ("number-random", "cmlm")


def conditional_stop_gradient(x: torch.Tensor, frozen: bool) -> torch.Tensor:
    """``x`` detached when ``frozen`` (``dag_loss.py:29-41``): the value is
    unchanged, no gradient flows back through it. ``frozen`` is a host bool
    (``dag_freezing_steps`` and ``encoder_freezing_updates`` are decided
    from the host's step count), so this reads nothing from the device."""
    return x.detach() if frozen else x


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
def glat_glance(logits: torch.Tensor, links: torch.Tensor,
                tgt_tokens: torch.Tensor, prev_output_tokens: torch.Tensor,
                context_p, pad: int,
                rng: Optional[torch.Generator] = None,
                draws: Optional[GlanceDraws] = None,
                sample_mask: Optional[torch.Tensor] = None,
                strategy: str = "number-random") -> GlatInfo:
    """``glat_function`` (``dag_loss.py:102-189``): Viterbi-align the graph
    to the reference, count mispredictions, and replace aligned vertices,
    picked at random, with oracle target tokens: ``context_p`` times the
    mispredictions under ``number-random``, a uniform random fraction of
    the target length under ``cmlm``.

    ``draws`` (:class:`GlanceDraws`) reproduces another generator's glance;
    without it the draws come from ``rng``."""
    if strategy not in GLANCE_STRATEGIES:
        raise ValueError(f"unknown glance strategy {strategy!r}")
    B, L = prev_output_tokens.shape
    T = tgt_tokens.shape[1]
    dev = prev_output_tokens.device
    target_length = (tgt_tokens != pad).sum(dim=1)
    output_length = (prev_output_tokens != pad).sum(dim=1)

    pred_tokens = logits.argmax(dim=-1)
    match = dag_logsoftmax_gather_tokens(logits, tgt_tokens).transpose(1, 2)
    path = dag_best_alignment(match, links, output_length,
                              target_length).long()

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


def compute_dag_loss(logits: torch.Tensor, links: torch.Tensor,
                     tgt_tokens: torch.Tensor,
                     prev_output_tokens: torch.Tensor, pad: int,
                     matchmask: Optional[torch.Tensor],
                     keep_word_mask: Optional[torch.Tensor],
                     sample_mask: Optional[torch.Tensor] = None,
                     with_alpha_beta: bool = False,
                     no_force_emit: bool = False):
    """``_compute_dag_loss`` (``dag_loss.py:208-299``): (loss, metrics), and
    with ``with_alpha_beta`` also the DP's alpha and beta [B, T, L] (both
    including the emission term; constants, no gradient). Non-finite
    sentences (unsatisfiable graphs) are masked out of the mean and carry no
    gradient. Without a glance (``matchmask`` None) nothing is forced."""
    B = prev_output_tokens.shape[0]
    output_length = (prev_output_tokens != pad).sum(dim=1)
    target_length = (tgt_tokens != pad).sum(dim=1)
    smask = (torch.ones((B,), device=links.device) if sample_mask is None
             else sample_mask.float())

    match_all = dag_logsoftmax_gather_tokens(logits, tgt_tokens
                                             ).transpose(1, 2)
    if matchmask is not None:
        match_all = force_emit_match(match_all, matchmask, keep_word_mask,
                                     no_force_emit)
    if with_alpha_beta:
        logprob, alpha, beta = dag_loss_with_alpha_beta(
            match_all.contiguous(), links, output_length, target_length)
    else:
        logprob = dag_loss(match_all.contiguous(), links, output_length,
                           target_length)

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
                strategy: Optional[str]) -> Optional[GlatInfo]:
    """The first decoder pass and the glance over it, without gradient
    (``dag_loss.py:388-414``); None without a glance strategy. GLAT p = 0
    glances too and keeps no vertex, as in JAX (the shapes and the work do
    not depend on p)."""
    if strategy is None:
        return None
    dev = enc.device
    with torch.no_grad():
        logits1, links1, _ = model.decode(
            prev_output_tokens, enc, enc_pad,
            rng=device_generator(dev, dec_seed))
        return glat_glance(logits1, links1, tgt_tokens, prev_output_tokens,
                           glat_p, vocab.pad,
                           rng=device_generator(dev, glat_seed),
                           draws=glat_draws, sample_mask=sample_mask,
                           strategy=strategy)


def nat_dag_loss(model, batch: Dict[str, torch.Tensor],
                 rng: torch.Generator, glat_p, vocab,
                 glat_draws: Optional[GlanceDraws] = None,
                 glance_strategy: Optional[str] = "number-random",
                 no_force_emit: bool = False,
                 freeze_encoder: bool = False):
    """Criterion forward of one training pass (``dag_loss.py:302-447``,
    full-matrix path): (loss, metrics).

    ``batch`` holds device tensors fbank [B, S, 80], src_lengths [B],
    target [B, T], prev_output_tokens [B, L] and optionally sample_mask
    [B]. ``rng`` is a host ``torch.Generator``; ``glat_draws`` (see
    :func:`glat_glance`) replaces the glance's own draws. The encoder runs
    once; the glance pass runs without gradient. ``freeze_encoder`` (a
    host bool: ``--encoder-freezing-updates`` decided from the update
    count, ``dag_loss.py:362-365``) stops the encoder's gradient."""
    fbank, src_lengths = batch["fbank"], batch["src_lengths"]
    tgt_tokens = batch["target"]
    prev_output_tokens = batch["prev_output_tokens"]
    sample_mask = batch.get("sample_mask")
    dev = fbank.device
    enc_seed, dec_seed, glat_seed = (
        int(s) for s in torch.randint(0, 2 ** 62, (3,), generator=rng))

    enc, enc_pad, _ = model.encode(fbank, src_lengths,
                                   rng=device_generator(dev, enc_seed))
    enc = conditional_stop_gradient(enc, freeze_encoder)

    info = glance_pass(model, prev_output_tokens, enc, enc_pad, dec_seed,
                       tgt_tokens, glat_p, vocab, glat_seed, glat_draws,
                       sample_mask, glance_strategy)
    prev2 = prev_output_tokens if info is None else info.prev_output_tokens

    logits, links, _ = model.decode(prev2, enc, enc_pad,
                                    rng=device_generator(dev, dec_seed))
    loss, metrics = compute_dag_loss(
        logits, links, tgt_tokens, prev2, vocab.pad,
        None if info is None else info.matchmask,
        None if info is None else info.keep_word_mask,
        sample_mask=sample_mask, no_force_emit=no_force_emit)
    if info is not None:
        metrics["glat_accu"] = info.glat_accu
        metrics["glat_keep"] = info.glat_keep
    metrics["loss"] = loss.detach()
    return loss, metrics
