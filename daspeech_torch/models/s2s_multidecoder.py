"""The two-pass AR S2ST model (PyTorch), speech -> text -> mel: the
UnitY-style baseline of the ``at_s2s`` generator and the length beam's
reranker.

Counterpart of ``daspeech_tpu/models/s2s_multidecoder.py``: the port's
Conformer (its rel-pos attention through kernel #5), an AR text decoder of
causal :class:`~daspeech_torch.models.layers.TransformerDecoderLayer`\\ s
on the plain attention path, a synthesizer encoder of
:class:`~daspeech_torch.models.tts_transformer.TTSEncoderLayer`\\ s over
the text decoder's states, and the AR mel decoder of
:class:`~daspeech_torch.models.tts_transformer.MelDecoder`. A call given
``rng`` is a training pass (``models/layers.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from daspeech_torch.config import ConformerConfig
from daspeech_torch.models.conformer import ConformerEncoder
from daspeech_torch.models.layers import (
    FP32,
    Compute,
    Embedding,
    LearnedPositionalEmbedding,
    Linear,
    TransformerDecoderLayer,
    dropout,
    set_dtype,
)
from daspeech_torch.models.tts_transformer import (
    MelDecoder,
    TTSDecoderLayer,
    TTSEncoderLayer,
)


class CausalTextDecoder(Compute, nn.Module):
    """AR text decoder (``s2s_multidecoder.py:37-83``): embedding scaled by
    sqrt(C) plus learned positions, dropout, post-norm causal decoder
    layers with cross-attention on the speech encoder (``layers_{i}``),
    logits tied to ``embed_tokens``."""

    def __init__(self, vocab_size: int, pad: int = 1, embed_dim: int = 256,
                 ffn_dim: int = 1024, num_layers: int = 2,
                 num_heads: int = 4, dropout: float = 0.1,
                 max_positions: int = 1024):
        super().__init__()
        self.pad, self.embed_dim, self.dropout = pad, embed_dim, dropout
        self.embed_tokens = Embedding(vocab_size, embed_dim)
        self.embed_positions = LearnedPositionalEmbedding(max_positions,
                                                          embed_dim, pad)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(embed_dim, ffn_dim, num_heads, "gelu",
                                    dropout, causal=True,
                                    fused_attention=False)
            for _ in range(num_layers))

    def forward(self, prev_tokens: torch.Tensor, enc: torch.Tensor,
                enc_pad: Optional[torch.Tensor],
                rng: Optional[torch.Generator] = None):
        """(logits [B, T, V], features [B, T, C])."""
        x = self.embed_tokens(prev_tokens) * math.sqrt(self.embed_dim)
        x = dropout(x + self.embed_positions(prev_tokens), self.dropout, rng)
        pad_mask = prev_tokens == self.pad
        for layer in self.layers:
            x = layer(x, pad_mask, enc, enc_pad, rng)
        return self.embed_tokens.attend(x), x


class S2SMultiDecoderModel(MelDecoder):
    """Conformer -> AR text decoder -> synthesizer encoder -> AR mel
    decoder + stop head (``s2s_multidecoder.py:86-181``), with JAX's
    fields and defaults. ``enc_proj`` exists only when the encoder and the
    text decoder differ in width. ``dtype`` is the compute dtype
    (``layers.set_dtype``)."""

    layers_attr = "tts_dec"

    def __init__(self, vocab_size: int, pad: int = 1, bos: int = 0,
                 eos: int = 2, encoder_embed_dim: int = 64,
                 encoder_layers: int = 2, encoder_heads: int = 2,
                 mt_embed_dim: int = 64, mt_layers: int = 2,
                 mt_heads: int = 2, ffn_dim: int = 256,
                 synth_encoder_layers: int = 1, tts_decoder_layers: int = 2,
                 prenet_dim: int = 64, out_dim: int = 80,
                 dropout: float = 0.1, conv_channels: int = 64,
                 depthwise_kernel_size: int = 7, max_positions: int = 1024,
                 dtype: torch.dtype = FP32):
        super().__init__()
        self.pad, self.bos, self.eos, self.out_dim = pad, bos, eos, out_dim
        self.encoder = ConformerEncoder(ConformerConfig(
            embed_dim=encoder_embed_dim, ffn_dim=ffn_dim,
            num_layers=encoder_layers, num_heads=encoder_heads,
            dropout=dropout, attn_dropout=dropout,
            conv_channels=conv_channels,
            depthwise_kernel_size=depthwise_kernel_size))
        self.enc_proj = (Linear(encoder_embed_dim, mt_embed_dim)
                         if encoder_embed_dim != mt_embed_dim else None)
        self.mt_decoder = CausalTextDecoder(
            vocab_size, pad, mt_embed_dim, ffn_dim, mt_layers, mt_heads,
            dropout, max_positions)
        self.synth_enc = nn.ModuleList(
            TTSEncoderLayer(mt_embed_dim, ffn_dim, mt_heads, dropout)
            for _ in range(synth_encoder_layers))
        self.prenet_0 = Linear(out_dim, prenet_dim)
        self.prenet_1 = Linear(prenet_dim, prenet_dim)
        self.prenet_proj = Linear(prenet_dim, mt_embed_dim)
        self.tts_dec = nn.ModuleList(
            TTSDecoderLayer(mt_embed_dim, ffn_dim, mt_heads, dropout)
            for _ in range(tts_decoder_layers))
        self.mel_out = Linear(mt_embed_dim, out_dim)
        self.stop_out = Linear(mt_embed_dim, 1)
        self.postnet = None
        set_dtype(self, dtype)

    def forward_encoder(self, fbank: torch.Tensor,
                        src_lengths: torch.Tensor,
                        rng: Optional[torch.Generator] = None):
        """Pass 1's speech encoder: (states [B, T', C_mt], pad mask)."""
        enc, enc_pad, _ = self.encoder(fbank, src_lengths, rng)
        if self.enc_proj is not None:
            enc = self.enc_proj(enc)
        return enc, enc_pad

    def mt_decode(self, prev_tokens, enc, enc_pad, rng=None):
        """(logits [B, T, V], features [B, T, C])."""
        return self.mt_decoder(prev_tokens, enc, enc_pad, rng)

    def synthesize_encode(self, features: torch.Tensor,
                          pad_mask: torch.Tensor,
                          rng: Optional[torch.Generator] = None):
        x = features
        for layer in self.synth_enc:
            x = layer(x, pad_mask, rng)
        return x

    def tts_decode(self, prev_mel, synth, synth_pad, rng=None):
        """(mel [B, M, out_dim], stop logits [B, M])."""
        return self.decode_mel(prev_mel, synth, synth_pad, rng)

    def forward(self, fbank: torch.Tensor, src_lengths: torch.Tensor,
                prev_tokens: torch.Tensor, prev_mel: torch.Tensor,
                rng: Optional[torch.Generator] = None):
        """Teacher-forced two-pass forward: (text logits [B, T, V], mel
        [B, M, out_dim], stop logits [B, M])."""
        enc, enc_pad = self.forward_encoder(fbank, src_lengths, rng)
        logits, features = self.mt_decode(prev_tokens, enc, enc_pad, rng)
        pad_mask = prev_tokens == self.pad
        synth = self.synthesize_encode(features, pad_mask, rng)
        mel, stop = self.tts_decode(prev_mel, synth, pad_mask, rng)
        return logits, mel, stop
