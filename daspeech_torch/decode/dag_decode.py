"""DAG decoding (PyTorch): greedy / lookahead pointer chase and the
hidden-state gather for the TTS pass.

Counterpart of ``daspeech_tpu/decode/dag_decode.py:25-97, 227-249``. The
JAX ``lax.scan`` over graph hops becomes a Python loop of one gather per
step on device tensors: it never reads a value back to the host, so the L
steps enqueue without a device-to-host round trip. Viterbi, ``path_score``
and beam search are not ported yet.

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
