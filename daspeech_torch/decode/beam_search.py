"""DAG beam search (PyTorch), the ``beamsearch`` strategy.

Counterpart of ``daspeech_tpu/decode/beam_search.py``: per-vertex candidate
preparation (for each source vertex, the top ``top_cand_n`` (next vertex,
token) pairs by ``links[i, j] + beta * logP(y | v_j)``, optionally
nucleus-truncated), a fixed-width beam over partial paths, finalisation on
the transition into the last vertex with the length penalty
``score / |Y|^alpha``, and optional consecutive-duplicate collapse. Like the
JAX searcher it has no n-gram LM fusion and no per-length beam quota, and it
tracks no path features (S2T only).

The JAX ``lax.scan`` over steps becomes a Python loop of device tensor ops
(no device-to-host read). ``jax.lax.top_k`` breaks ties by the lower index,
and ``torch.topk`` promises no order among ties; most of the K·C
continuation scores are ``NEG`` ties at the first steps, so every top-k here
is a stable descending sort cut to k (:func:`top_k`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from daspeech_torch.decode.dag_decode import DecodeResult

NEG = -1e30


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties in index
    order."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def beam_search(logits: torch.Tensor, links: torch.Tensor,
                output_length: torch.Tensor, pad: int, bos: int,
                beam_size: int = 16, top_cand_n: int = 5,
                decode_beta: float = 1.0, decode_alpha: float = 1.1,
                top_p: float = 0.9, dedup: bool = False, max_steps: int = 0
                ) -> Tuple[DecodeResult, torch.Tensor]:
    """``beam_search.py:47-192``: (DecodeResult, the best hypothesis's
    penalised score [B]). ``bos`` is accepted for the JAX signature; the
    first token is vertex 0's argmax, as there."""
    B, L, _ = logits.shape
    K, C = beam_size, top_cand_n
    if max_steps <= 0:
        max_steps = max(2, L // 2)
    MAXLEN = max_steps + 1
    dev = logits.device

    logp = torch.log_softmax(logits.float(), dim=-1)
    top_logits, top_tokens = top_k(logp, C)                  # [B, L, C]
    links = links.float().clamp_min(NEG)

    # candidates of source vertex i over (next vertex j, token rank c)
    cand = links[:, :, :, None] + decode_beta * top_logits[:, None, :, :]
    cand_score, cand_flat = top_k(cand.reshape(B, L, L * C), C)
    cand_next = cand_flat // C
    cand_tok = top_tokens.reshape(B, L * C).gather(
        1, cand_flat.reshape(B, L * C)).reshape(B, L, C)
    if top_p < 1.0:
        # nucleus truncation over each vertex's candidates; keeps the first
        probs = torch.softmax(cand_score, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cand_score = torch.where(keep, cand_score, NEG)

    final = (output_length - 1)[:, None, None]
    bos_tok = logp[:, 0].argmax(dim=-1)                      # vertex 0's token

    # beam 0 at vertex 0 with the first emission, the rest dead
    beams = torch.arange(K, device=dev)
    vertex = torch.zeros((B, K), dtype=torch.int64, device=dev)
    score = torch.where(beams == 0, 0.0, NEG).expand(B, K)
    length = torch.ones((B, K), dtype=torch.int64, device=dev)
    last_tok = bos_tok[:, None].expand(B, K)
    tokens = torch.full((B, K, MAXLEN), pad, dtype=torch.int64, device=dev)
    tokens[:, :, 0] = last_tok
    alive = (beams == 0).expand(B, K)
    best_score = torch.full((B,), NEG, device=dev)
    best_tokens = torch.full((B, MAXLEN), pad, dtype=torch.int64, device=dev)
    best_len = torch.zeros((B,), dtype=torch.int64, device=dev)

    rows = torch.arange(B, device=dev)
    slots = torch.arange(MAXLEN, device=dev)
    for _ in range(max_steps):
        # expand: [B, K, C]
        c_score = cand_score[rows[:, None], vertex]
        c_next = cand_next[rows[:, None], vertex]
        c_tok = cand_tok[rows[:, None], vertex]
        new_score = torch.where(alive[:, :, None],
                                score[:, :, None] + c_score, NEG)
        is_final = c_next == final
        emit = c_tok != pad
        if dedup:
            emit = emit & (c_tok != last_tok[:, :, None])
        new_len = length[:, :, None] + emit.long()

        # finalise the candidates that land on the last vertex. A dead or
        # truncated candidate's NEG / pen exceeds NEG, and can set the best
        # as in the JAX searcher (ROADMAP Queue 3)
        pen = new_len.float().clamp_min(1.0) ** decode_alpha
        fin = torch.where(is_final, new_score / pen, NEG).reshape(B, K * C)
        best_new, best_arg = fin.max(dim=-1)
        bk, bc = best_arg // C, best_arg % C
        improved = best_new > best_score
        chosen_emit = emit[rows, bk, bc]
        chosen_len = length[rows, bk]
        cand_tokens = torch.where(
            (slots[None, :] == chosen_len[:, None]) & chosen_emit[:, None],
            c_tok[rows, bk, bc][:, None], tokens[rows, bk])
        best_tokens = torch.where(improved[:, None], cand_tokens,
                                  best_tokens)
        best_len = torch.where(improved, chosen_len + chosen_emit.long(),
                               best_len)
        best_score = torch.maximum(best_score, best_new)

        # continue: the non-final candidates compete for the K beam slots
        cont = torch.where(is_final, NEG, new_score).reshape(B, K * C)
        score, top_ix = top_k(cont, K)
        src_k, src_c = top_ix // C, top_ix % C
        sel_tok = c_tok[rows[:, None], src_k, src_c]
        sel_emit = emit[rows[:, None], src_k, src_c]
        sel_len = length[rows[:, None], src_k]
        sel_tokens = tokens[rows[:, None], src_k]           # [B, K, MAXLEN]
        tokens = torch.where(
            (slots[None, None, :] == sel_len[:, :, None])
            & sel_emit[:, :, None], sel_tok[:, :, None], sel_tokens)
        vertex = c_next[rows[:, None], src_k, src_c]
        length = sel_len + sel_emit.long()
        last_tok = torch.where(sel_emit, sel_tok,
                               last_tok[rows[:, None], src_k])
        alive = score > NEG / 2

    return DecodeResult(
        tokens=best_tokens, lengths=best_len,
        feat_idx=torch.full((B, MAXLEN), -1, dtype=torch.int64, device=dev),
        feat_lengths=(best_len - 1).clamp_min(0)), best_score


def beam_search_decode(*args, **kwargs) -> DecodeResult:
    """The ``beamsearch`` strategy: the result of :func:`beam_search`."""
    return beam_search(*args, **kwargs)[0]
