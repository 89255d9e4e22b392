"""DAG decoding (PyTorch): the greedy / lookahead pointer chase, the
(joint-)Viterbi DP with its backtrace, the length-beam path score and the
hidden-state gather for the TTS pass.

Counterpart of ``daspeech_tpu/decode/dag_decode.py``. Each JAX ``lax.scan``
(over graph hops, DP steps or backpointers) becomes a Python loop of a few
tensor ops per step on device tensors: it never reads a value back to the
host, so the steps enqueue without a device-to-host round trip. Every
argmax takes the first maximal index, as ``jnp.argmax`` does
(``torch.max(dim=...)`` and ``torch.argmax`` are documented so).

Outputs are fixed-shape and padded:
  tokens   [B, L] (pad-filled), lengths [B]
  feat_idx [B, L] vertex supplying the hidden state of each slot (-1 = none)
  feat_lengths [B] = lengths - 1
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class DecodeResult(NamedTuple):
    tokens: torch.Tensor        # [B, L] int64, pad-filled
    lengths: torch.Tensor       # [B] number of emitted tokens
    feat_idx: torch.Tensor      # [B, L] vertex per slot (-1 = none)
    feat_lengths: torch.Tensor  # [B] (= lengths - 1)


def _emit_scan(start_j: torch.Tensor, hops: torch.Tensor,
               unreduced_tokens: torch.Tensor, stop_at: torch.Tensor,
               num_steps: int, pad: int) -> DecodeResult:
    """Walk ``hops`` from ``start_j``, emitting the vertex token whenever it
    differs from the previous vertex's token and is not pad
    (consecutive-duplicate collapse); ``dag_decode.py:32-72``.

    The JAX scan carries (vertex, last token, count, done, outputs) through
    every step. Here the loop only chases the pointer, with ``stop_at``
    made absorbing (a step from it stays on it, which is what "done"
    means), so each of the ``num_steps`` steps is one gather on the device;
    the emissions, their slots and the outputs follow from the visited
    vertices in a few whole-path ops after the loop."""
    B, L = hops.shape
    rows = torch.arange(B, device=hops.device)
    hops = hops.clone()
    hops[rows, stop_at] = stop_at
    path = [start_j]
    for _ in range(num_steps):
        path.append(hops.gather(1, path[-1][:, None])[:, 0])
    path = torch.stack(path, dim=1)                    # [B, num_steps + 1]
    toks = unreduced_tokens.gather(1, path)
    active = path[:, :-1] != stop_at[:, None]          # step t moves on
    emit = active & (toks[:, 1:] != pad) & (toks[:, 1:] != toks[:, :-1])
    count = 1 + emit.sum(dim=1)
    # slot of each emission; non-emissions go to a spare column L
    slot = torch.where(emit, torch.cumsum(emit, dim=1), L)
    tokens = torch.full((B, L + 1), pad, dtype=torch.int64, device=hops.device)
    tokens[:, 0] = toks[:, 0]
    tokens.scatter_(1, slot, toks[:, 1:])
    feat_idx = torch.full((B, L + 1), -1, dtype=torch.int64,
                          device=hops.device)
    feat_idx.scatter_(1, slot, path[:, 1:])
    return DecodeResult(tokens[:, :L], count, feat_idx[:, :L], count - 1)


def greedy_or_lookahead_decode(logits: torch.Tensor, links: torch.Tensor,
                               output_length: torch.Tensor, pad: int,
                               decode_beta: float = 1.0,
                               lookahead: bool = True) -> DecodeResult:
    """``lookahead``/``greedy`` (``dag_decode.py:75-97``)."""
    B, L, _ = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    unreduced_logits = logp.max(dim=-1).values
    unreduced_tokens = logp.argmax(dim=-1)
    score = (links + decode_beta * unreduced_logits[:, None, :]
             if lookahead else links)
    hops = score.argmax(dim=-1)
    start = torch.zeros((B,), dtype=torch.int64, device=logits.device)
    stop = (output_length - 1).to(torch.int64)
    return _emit_scan(start, hops, unreduced_tokens, stop, L, pad)


def viterbi_path(logits: torch.Tensor, links: torch.Tensor,
                 output_length: torch.Tensor, decode_beta: float = 1.0,
                 viterbibeta: float = 1.0, joint: bool = True,
                 max_length: int = 0):
    """The DP and backtrace of ``viterbi``/``jointviterbi``
    (``dag_decode.py:117-188``): the length-penalised best path over output
    lengths 1..max_length. Returns (path [B, S], pred_len [B], per-vertex
    argmax tokens [B, L], penalised best score [B]); ``path[:, k]`` for
    k < pred_len is the path's (pred_len - k)-th vertex after vertex 0
    (right to left), and the path ends at vertex ``output_length - 1``.

    The DP is one add and one max over [B, L, L] a step; the backtrace
    chases backpointers, one gather a step."""
    B, L, _ = logits.shape
    S = max_length if max_length > 0 else max(2, L // 4)
    dev = logits.device
    logp = torch.log_softmax(logits.float(), dim=-1)
    unreduced_logits, unreduced_tokens = logp.max(dim=-1)
    links = links.float().clamp_min(-1e9)                  # NaN-free maxes
    tokscore = decode_beta * unreduced_logits

    alpha = links[:, 0] + tokscore
    if joint:
        alpha = alpha + tokscore[:, :1]
    scores, backptrs = [alpha], []
    for _ in range(S - 1):
        alpha, idx = (alpha[:, :, None] + links).max(dim=1)
        if joint:
            alpha = alpha + tokscore
        scores.append(alpha)
        backptrs.append(idx)
    scores = torch.stack(scores)                           # [S, B, L]

    last = (output_length - 1).long()
    link_last = links.gather(
        2, last.clamp(0, L - 1)[:, None, None].expand(B, L, 1))[..., 0]
    link_last = torch.where(((last >= 0) & (last < L))[:, None], link_last,
                            -1e9)
    best_per_len, max_idx = (scores + link_last[None]).max(dim=-1)  # [S, B]
    length_penalty = (torch.arange(S, dtype=torch.float32, device=dev)
                      + 1.0) ** viterbibeta
    best, pred_len = (best_per_len / length_penalty[:, None]).max(dim=0)
    pred_len = pred_len + 1
    initial_j = max_idx.gather(0, (pred_len - 1)[None])[0]

    # backtrace: step k moves from the vertex after k + 1 emissions' to its
    # backpointer, for k < pred_len - 1
    rows = torch.arange(B, device=dev)
    path = [initial_j]
    if S > 1:
        bp = torch.stack(backptrs)                         # [S - 1, B, L]
        for k in range(S - 1):
            s_idx = (pred_len - k - 2).clamp(0, S - 2)
            path.append(torch.where(k < pred_len - 1,
                                    bp[s_idx, rows, path[-1]], path[-1]))
    return torch.stack(path, dim=1), pred_len, unreduced_tokens, best


def viterbi_decode(logits: torch.Tensor, links: torch.Tensor,
                   output_length: torch.Tensor, pad: int,
                   decode_beta: float = 1.0, viterbibeta: float = 1.0,
                   joint: bool = True, max_length: int = 0) -> DecodeResult:
    """``viterbi``/``jointviterbi`` (``dag_decode.py:100-204``): the path of
    :func:`viterbi_path`, its tokens emitted right to left with duplicate
    collapse. The emissions, their slots and the reversal follow from the
    visited vertices in whole-path ops, as in :func:`_emit_scan`. Viterbi
    keeps the first emitted vertex's feature, so ``feat_lengths ==
    lengths``."""
    B, L, _ = logits.shape
    dev = logits.device
    path, pred_len, unreduced_tokens, _ = viterbi_path(
        logits, links, output_length, decode_beta, viterbibeta, joint,
        max_length)
    S = path.shape[1]
    toks = unreduced_tokens.gather(1, path)
    active = (torch.arange(S - 1, device=dev)[None, :]
              < (pred_len - 1)[:, None])
    emit = active & (toks[:, 1:] != pad) & (toks[:, 1:] != toks[:, :-1])
    count = 1 + emit.sum(dim=1)
    # slot of each emission, right to left; non-emissions (and slots past
    # L, which the JAX one-hot drops) go to a spare column L
    slot = torch.where(emit, torch.cumsum(emit, dim=1), L).clamp(max=L)
    rev_tokens = torch.full((B, L + 1), pad, dtype=torch.int64, device=dev)
    rev_tokens[:, 0] = toks[:, 0]
    rev_tokens.scatter_(1, slot, toks[:, 1:])
    rev_feat = torch.full((B, L + 1), -1, dtype=torch.int64, device=dev)
    rev_feat[:, 0] = path[:, 0]
    rev_feat.scatter_(1, slot, path[:, 1:])

    # reverse the first `count` slots of each row: out[i] = rev[count-1-i]
    idx = count[:, None] - 1 - torch.arange(L, device=dev)[None, :]
    valid = idx >= 0
    idx_c = idx.clamp(0, L - 1)
    tokens = torch.where(valid, rev_tokens[:, :L].gather(1, idx_c), pad)
    feat_idx = torch.where(valid, rev_feat[:, :L].gather(1, idx_c), -1)
    return DecodeResult(tokens, count, feat_idx, count)


def path_score(unreduced_logits: torch.Tensor, result: DecodeResult,
               include_start: bool = True) -> torch.Tensor:
    """Mean per-token log-prob along the decoded path, the length beam's
    candidate score (``dag_decode.py:207-224``). ``include_start`` adds the
    start vertex's token (slot 0 carries no feat_idx under
    lookahead/greedy)."""
    L = unreduced_logits.shape[1]
    idx = result.feat_idx
    picked = unreduced_logits.gather(1, idx.clamp(0, L - 1))
    total = torch.where(idx >= 0, picked, 0.0).sum(dim=1)
    if include_start:
        total = total + unreduced_logits[:, 0]
    return total / result.lengths.to(total.dtype).clamp_min(1)


def gather_path_features(features: torch.Tensor, result: DecodeResult,
                         skip_first: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder hidden states along the decoded path, left-aligned: (feats
    [B, L, D], feat_pad_mask [B, L] True = pad). With ``skip_first`` the
    slot-0 token contributes no feature (``dag_decode.py:227-249``)."""
    B, L, D = features.shape
    idx = result.feat_idx
    if skip_first:
        idx = torch.cat([idx[:, 1:], idx.new_full((B, 1), -1)], dim=1)
        n = result.feat_lengths
    else:
        n = result.lengths
    safe = idx.clamp(0, L - 1)
    feats = features.gather(1, safe[:, :, None].expand(-1, -1, D))
    mask = torch.arange(L, device=features.device)[None, :] >= n[:, None]
    return feats.masked_fill(mask[:, :, None], 0.0), mask
