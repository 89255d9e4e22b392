"""Shared building blocks (PyTorch), batch-first ``[B, T, C]``.

Counterpart of ``daspeech_tpu/models/layers.py``. Every LayerNorm uses
eps 1e-6, flax's default (torch's is 1e-5). Attention goes through
``ops.fused_attention``: the packed kernel, or the head-major one for the
long sequences the JAX layer sends there (``packed_route``); both launch
the CUDA kernels for CUDA tensors and take the plain versions for CPU
tensors.

Training mode is an argument, as ``train=True`` is in the JAX modules: a
forward given ``rng`` (a ``torch.Generator`` on the tensors' device) is a
training pass. It draws its dropout masks and the attention kernels'
per-row dropout seeds from ``rng``, in call order, so two passes handed
generators with the same seed drop the same elements; BatchNorm takes batch
statistics. Without ``rng`` a forward is the inference path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from daspeech_torch.ops import fused_attention as _fa
from daspeech_torch.ops.fused_attention import NEG

LN_EPS = 1e-6


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


# "gelu" is the exact erf form, which the JAX package takes in f32
# (``layers.py:19-27``); the port runs in f32 only
ACTIVATIONS = {"relu": F.relu, "gelu": F.gelu, "swish": F.silu,
               "silu": F.silu, "tanh": torch.tanh}


def dropout(x: torch.Tensor, rate: float,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """JAX's u16-threshold dropout (``layers.py:39-71``): keep where a
    16-bit draw is below q = round((1 - rate) * 65536), scale kept values
    by 1 / keep_p with keep_p = q / 65536. Off without ``rng``."""
    if rng is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    q = int(round((1.0 - rate) * 65536))
    if q >= 65536:            # rate below 2**-17 rounds to keep-all
        return x
    bits = torch.randint(0, 65536, x.shape, generator=rng, device=x.device,
                         dtype=torch.int32)
    return torch.where(bits < q, x * (65536.0 / q), torch.zeros_like(x))


def row_seeds(rng: Optional[torch.Generator], rate: float, B: int,
              device) -> Optional[torch.Tensor]:
    """[B] int32 per-row seeds of an attention kernel's dropout stream
    (``layers.py:194-196``), or None when the pass drops nothing."""
    if rng is None or rate == 0.0:
        return None
    return torch.randint(-2 ** 31, 2 ** 31, (B,), generator=rng,
                         device=device, dtype=torch.int32)


def make_positions(tokens: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """fairseq ``utils.make_positions``: numbering starts at
    ``padding_idx + 1``; pads keep ``padding_idx``."""
    mask = (tokens != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class LearnedPositionalEmbedding(nn.Embedding):
    """fairseq learned positional embedding (offset by padding_idx + 1)."""

    def __init__(self, max_positions: int, dim: int, padding_idx: int = 1):
        super().__init__(max_positions + padding_idx + 1, dim)
        self.pad = padding_idx

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(make_positions(tokens, self.pad), self.weight)


def sinusoidal_embedding_table(num_positions: int, dim: int,
                               padding_idx: Optional[int] = 1,
                               device=None) -> torch.Tensor:
    """fairseq ``SinusoidalPositionalEmbedding.get_embedding``."""
    half_dim = dim // 2
    scale = math.log(10000) / (half_dim - 1)
    freq = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                  device=device) * -scale)
    ang = (torch.arange(num_positions, dtype=torch.float32,
                        device=device)[:, None] * freq[None, :])
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    if dim % 2 == 1:
        emb = torch.cat([emb, emb.new_zeros(num_positions, 1)], dim=1)
    if padding_idx is not None:
        emb[padding_idx] = 0
    return emb


class SinusoidalPositionalEmbedding(nn.Module):
    def __init__(self, max_positions: int, dim: int, padding_idx: int = 1):
        super().__init__()
        self.max_positions, self.dim, self.pad = max_positions, dim, padding_idx

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        table = sinusoidal_embedding_table(
            self.max_positions + self.pad + 1, self.dim, self.pad,
            device=tokens.device)
        return F.embedding(make_positions(tokens, self.pad), table)


def padding_bias(key_padding_mask: Optional[torch.Tensor], B: int, Tk: int,
                 device) -> torch.Tensor:
    """[B, Tk] additive column bias: NEG at padded keys, 0 elsewhere. Rows
    whose keys are ALL padding attend uniformly instead of producing NaN
    (``layers.py:182-185``); downstream masks discard them."""
    if key_padding_mask is None:
        return torch.zeros((B, Tk), dtype=torch.float32, device=device)
    all_masked = key_padding_mask.all(dim=-1, keepdim=True)
    kpm = key_padding_mask & ~all_masked
    return torch.where(kpm, NEG, 0.0).to(torch.float32)


class MultiHeadAttention(nn.Module):
    """Non-causal MHA with an optional key-padding mask (True = pad) and
    dropout on the attention probabilities; ``layers.py:128-237``.

    The route of ``layers.py:164-176``: the packed kernel while
    ``packed_route(Tq, Tk, C, H)`` holds, else the head-major kernel
    through the [B, T, H, d] -> [B, H, T, d] transposes of ``:208-214``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, Tq, C = query.shape
        Tk = key.shape[1]
        H = self.num_heads
        d_head = C // H
        q = self.q_proj(query) * (d_head ** -0.5)
        k = self.k_proj(key)
        v = self.v_proj(value)
        bias = padding_bias(key_padding_mask, B, Tk, key.device)
        seeds = row_seeds(rng, self.dropout, B, key.device)
        p = 0.0 if seeds is None else self.dropout
        if _fa.packed_route(Tq, Tk, C, H):
            out = _fa.fused_attention_packed(q, k, v, bias, H, 1.0, p, seeds)
        else:
            def to_bhtd(x):
                return x.reshape(B, x.shape[1], H, d_head).transpose(
                    1, 2).contiguous()

            out = _fa.fused_attention(to_bhtd(q), to_bhtd(k), to_bhtd(v),
                                      bias, 1.0, p, seeds)
            out = out.transpose(1, 2).reshape(B, Tq, C)
        return self.out_proj(out)


class TransformerFFN(nn.Module):
    def __init__(self, ffn_dim: int, embed_dim: int, activation: str = "relu",
                 dropout: float = 0.0, activation_dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(embed_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed_dim)
        self.act = ACTIVATIONS[activation]
        self.dropout, self.activation_dropout = dropout, activation_dropout

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(self.act(self.fc1(x)), self.activation_dropout, rng)
        return dropout(self.fc2(x), self.dropout, rng)


class TransformerDecoderLayer(nn.Module):
    """Post-norm transformer decoder layer with non-causal self-attention
    (the NAT decoder; ``layers.py:257-321`` with normalize_before=False)."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 activation: str = "gelu", dropout: float = 0.0,
                 attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(embed_dim, num_heads,
                                            attention_dropout)
        self.self_attn_layer_norm = layer_norm(embed_dim)
        self.encoder_attn = MultiHeadAttention(embed_dim, num_heads,
                                               attention_dropout)
        self.encoder_attn_layer_norm = layer_norm(embed_dim)
        self.ffn = TransformerFFN(ffn_dim, embed_dim, activation, dropout,
                                  activation_dropout)
        self.final_layer_norm = layer_norm(embed_dim)

    def forward(self, x: torch.Tensor, self_pad_mask: Optional[torch.Tensor],
                enc_out: Optional[torch.Tensor],
                enc_pad_mask: Optional[torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.self_attn(x, x, x, key_padding_mask=self_pad_mask, rng=rng)
        x = self.self_attn_layer_norm(x + dropout(y, self.dropout, rng))
        if enc_out is not None:
            y = self.encoder_attn(x, enc_out, enc_out,
                                  key_padding_mask=enc_pad_mask, rng=rng)
            x = self.encoder_attn_layer_norm(x + dropout(y, self.dropout,
                                                         rng))
        return self.final_layer_norm(x + self.ffn(x, rng))


def lengths_to_padding_mask(lengths: torch.Tensor, max_len: int
                            ) -> torch.Tensor:
    """[B] -> [B, max_len] bool, True = pad."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            >= lengths[:, None])
