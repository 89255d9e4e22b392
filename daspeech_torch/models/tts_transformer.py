"""Autoregressive Transformer-TTS (PyTorch), the AR baseline of the
``at_tts`` generator: token encoder, mel prenet, causal decoder with
cross-attention, mel and stop-logit heads, optional Postnet.

Counterpart of ``daspeech_tpu/models/tts_transformer.py``. Every attention
takes the plain path (JAX builds them without ``fused``), the decoder's
self-attention causal. A forward given ``rng`` is a training pass
(``models/layers.py``), the prenet's dropout (0.5) included; inference
keeps it off, as JAX's ``deterministic=not train`` does.

:func:`ar_mel_loop` is the generation loop of both AR mel decoders
(``tts_transformer.py:154-180``, ``speech_generator.py:324-338``): every
one of ``max_len`` steps runs, with no early exit once each row has
stopped (JAX's vocoder sees the whole buffer), and ``lens`` is set at the
first step whose ``sigmoid(stop)`` passes the threshold. Step t decodes
only the prefix of the buffer that frame t depends on: under the causal
mask frame t is the same either way.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from daspeech_torch.models.fastspeech2 import Postnet
from daspeech_torch.models.layers import (
    FP32,
    Compute,
    Embedding,
    Linear,
    MultiHeadAttention,
    TransformerFFN,
    dropout,
    layer_norm,
    set_dtype,
    sinusoidal_embedding_table,
)

PRENET_DROPOUT = 0.5


class TTSEncoderLayer(nn.Module):
    """Post-norm self-attention + ReLU FFN (``tts_transformer.py:34-51``);
    the attention probabilities and the FFN output drop at ``dropout``."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, dropout,
                                            fused=False)
        self.ln1 = layer_norm(embed_dim)
        self.ffn = TransformerFFN(ffn_dim, embed_dim, "relu", dropout)
        self.ln2 = layer_norm(embed_dim)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.ln1(x + self.self_attn(x, x, x, key_padding_mask=pad_mask,
                                        rng=rng))
        return self.ln2(x + self.ffn(x, rng))


class TTSDecoderLayer(nn.Module):
    """Causal self-attention, cross-attention, ReLU FFN, each post-norm
    (``tts_transformer.py:54-76``)."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, dropout,
                                            causal=True, fused=False)
        self.ln1 = layer_norm(embed_dim)
        self.cross_attn = MultiHeadAttention(embed_dim, num_heads, dropout,
                                             fused=False)
        self.ln2 = layer_norm(embed_dim)
        self.ffn = TransformerFFN(ffn_dim, embed_dim, "relu", dropout)
        self.ln3 = layer_norm(embed_dim)

    def forward(self, x: torch.Tensor, enc: torch.Tensor,
                enc_pad_mask: Optional[torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.ln1(x + self.self_attn(x, x, x, rng=rng))
        x = self.ln2(x + self.cross_attn(x, enc, enc,
                                         key_padding_mask=enc_pad_mask,
                                         rng=rng))
        return self.ln3(x + self.ffn(x, rng))


class MelDecoder(Compute, nn.Module):
    """The AR mel decoder both AR models share: prenet (two ReLU layers
    with dropout 0.5, then a projection), sinusoidal positions 1..T (no
    padding index), the layers in ``self.<layers_attr>``, then the mel and
    stop heads (``tts_transformer.py:132-148``,
    ``s2s_multidecoder.py:158-169``). A subclass builds ``prenet_0``,
    ``prenet_1``, ``prenet_proj``, its layers, ``mel_out``, ``stop_out``
    and ``postnet`` (a :class:`Postnet` or None)."""

    layers_attr = "dec"

    def _prenet_and_positions(self, prev_mel: torch.Tensor,
                              rng: Optional[torch.Generator]
                              ) -> torch.Tensor:
        x = self.compute(prev_mel)
        for dense in (self.prenet_0, self.prenet_1):
            x = dropout(F.relu(dense(x)), PRENET_DROPOUT, rng)
        x = self.prenet_proj(x)
        T, C = x.shape[1], x.shape[2]
        table = sinusoidal_embedding_table(T + 2, C, None, device=x.device)
        return x + self.compute(table[None, 1: T + 1])

    def decode_mel(self, prev_mel: torch.Tensor, enc: torch.Tensor,
                   enc_pad_mask: Optional[torch.Tensor],
                   rng: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """prev_mel [B, T, out_dim] (frame 0 the zero 'go' frame) ->
        (mel [B, T, out_dim], stop logits [B, T])."""
        x = self._prenet_and_positions(prev_mel, rng)
        for layer in getattr(self, self.layers_attr):
            x = layer(x, enc, enc_pad_mask, rng)
        mel = self.mel_out(x)
        stop = self.stop_out(x)[..., 0]
        if self.postnet is not None:
            mel = mel + self.postnet(mel, rng)
        return mel, stop

    def lookahead(self) -> int:
        """How many frames past t frame t depends on: the Postnet's
        half-width (its convs are not causal), else 0."""
        if self.postnet is None:
            return 0
        return sum((c.kernel_size[0] - 1) // 2 for c in self.postnet.conv)


def ar_mel_loop(decode: Callable, B: int, max_len: int, out_dim: int,
                dtype: torch.dtype, device, stop_threshold: float = 0.5,
                lookahead: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate ``max_len`` frames: ``decode(prev)`` maps the buffer prefix
    [B, T, out_dim] to (mel, stop) over T frames. Step t feeds the first
    ``min(t + 1 + lookahead, max_len)`` buffer frames (the go frame, the
    frames made so far, zeros after) and writes frame t. Returns (mel
    [B, max_len, out_dim], lens [B]): a row whose stop never fires keeps
    ``max_len``."""
    buf = torch.zeros(B, max_len + 1, out_dim, dtype=dtype, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    lens = torch.full((B,), max_len, dtype=torch.long, device=device)
    for t in range(max_len):
        mel, stop = decode(buf[:, : min(t + 1 + lookahead, max_len)])
        buf[:, t + 1] = mel[:, t]
        newly = ~done & (torch.sigmoid(stop[:, t]) > stop_threshold)
        lens = torch.where(newly, t + 1, lens)
        done = done | newly
    return buf[:, 1:], lens


class TTSTransformer(MelDecoder):
    """Token -> mel AR transformer with stop prediction
    (``tts_transformer.py:79-180``); the flax names (``enc_{i}`` and
    ``dec_{i}`` index the ModuleLists ``enc`` and ``dec``). ``dtype`` is
    the compute dtype (``layers.set_dtype``)."""

    def __init__(self, vocab_size: int, pad: int = 1, embed_dim: int = 256,
                 ffn_dim: int = 1024, encoder_layers: int = 4,
                 decoder_layers: int = 4, num_heads: int = 4,
                 dropout: float = 0.1, prenet_dim: int = 256,
                 out_dim: int = 80, add_postnet: bool = False,
                 dtype: torch.dtype = FP32):
        super().__init__()
        self.pad, self.out_dim = pad, out_dim
        self.embed_tokens = Embedding(vocab_size, embed_dim)
        self.enc = nn.ModuleList(
            TTSEncoderLayer(embed_dim, ffn_dim, num_heads, dropout)
            for _ in range(encoder_layers))
        self.prenet_0 = Linear(out_dim, prenet_dim)
        self.prenet_1 = Linear(prenet_dim, prenet_dim)
        self.prenet_proj = Linear(prenet_dim, embed_dim)
        self.dec = nn.ModuleList(
            TTSDecoderLayer(embed_dim, ffn_dim, num_heads, dropout)
            for _ in range(decoder_layers))
        self.mel_out = Linear(embed_dim, out_dim)
        self.stop_out = Linear(embed_dim, 1)
        self.postnet = Postnet(out_dim) if add_postnet else None
        set_dtype(self, dtype)

    def encode(self, src_tokens: torch.Tensor,
               rng: Optional[torch.Generator] = None):
        """tokens [B, T] -> (states [B, T, C], pad mask [B, T])."""
        x = self.embed_tokens(src_tokens)
        pad_mask = src_tokens == self.pad
        T = src_tokens.shape[1]
        table = sinusoidal_embedding_table(T + 2, x.shape[-1], None,
                                           device=x.device)
        x = x + self.compute(table[None, 1: T + 1])
        for layer in self.enc:
            x = layer(x, pad_mask, rng)
        return x, pad_mask

    def forward(self, src_tokens: torch.Tensor, prev_mel: torch.Tensor,
                rng: Optional[torch.Generator] = None):
        """Teacher-forced: (mel [B, T, out_dim], stop logits [B, T])."""
        enc, enc_pad = self.encode(src_tokens, rng)
        return self.decode_mel(prev_mel, enc, enc_pad, rng)

    def generate(self, src_tokens: torch.Tensor, max_len: int,
                 stop_threshold: float = 0.5):
        """AR inference (:func:`ar_mel_loop`): (mel [B, max_len, out_dim],
        lens [B])."""
        enc, enc_pad = self.encode(src_tokens)
        return ar_mel_loop(
            lambda prev: self.decode_mel(prev, enc, enc_pad),
            src_tokens.shape[0], max_len, self.out_dim, self.dtype,
            src_tokens.device, stop_threshold, self.lookahead())
