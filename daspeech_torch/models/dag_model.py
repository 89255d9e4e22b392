"""DA-Transformer (DAG) decoder + S2T Conformer-DAG model (PyTorch).

Counterpart of ``daspeech_tpu/models/dag_model.py``: a non-causal
transformer decoder over a graph of lambda * src_len vertices, and a
multi-head link predictor whose gated logsumexp gives the [B, L, L] DAG
transition matrix. Link extraction always goes through
``ops.fused_links.fused_extract_links`` (CUDA kernel for CUDA tensors, plain
versions for CPU tensors); ``extract_links_banded`` gives the [B, L, W]
band of a bounded transition length without the [L, L] matrix (plain
tensor ops, for ``--banded-dp``). A forward given ``rng`` is a training
pass (``models/layers.py``). In bf16 (``dtype``) the decoder and the
link projections compute in bf16 as JAX's do; the gates' log-softmax is
taken in fp32 and the links come out fp32 (``dag_model.py:151-158``), so
the DAG DP sees fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from daspeech_torch.models.conformer import ConformerEncoder
from daspeech_torch.models.layers import (
    FP32,
    Embedding,
    LearnedPositionalEmbedding,
    Linear,
    dropout,
    set_dtype,
    SinusoidalPositionalEmbedding,
    TransformerDecoderLayer,
)
from daspeech_torch.ops.fused_links import NEG_FLOOR, fused_extract_links


class GlatLinkDecoder(nn.Module):
    """NAT transformer decoder + link predictor (``dag_model.py:41-199``)."""

    def __init__(self, vocab_size: int, pad: int, cfg):
        super().__init__()
        D = cfg.embed_dim
        self.pad = pad
        self.num_heads = cfg.num_heads
        self.dropout = cfg.dropout
        self.share_input_output_embed = cfg.share_input_output_embed
        self.max_transition_length = cfg.max_transition_length
        self.embed_tokens = Embedding(vocab_size, D)
        pos_cls = (LearnedPositionalEmbedding if cfg.learned_pos
                   else SinusoidalPositionalEmbedding)
        self.embed_positions = pos_cls(cfg.max_target_positions, D, pad)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(D, cfg.ffn_dim, cfg.num_heads,
                                    cfg.activation, cfg.dropout,
                                    cfg.attn_dropout, cfg.activation_dropout)
            for _ in range(cfg.num_layers))
        if not self.share_input_output_embed:
            self.output_projection = Linear(D, vocab_size, bias=False)
        feats = cfg.links_feature.split(":")
        self._use_feature = "feature" in feats
        use_position = "position" in feats or "sinposition" in feats
        n_parts = int(self._use_feature) + int(use_position)
        self.link_positional = None
        if use_position:
            self.link_positional = (
                LearnedPositionalEmbedding(cfg.max_target_positions, D, pad)
                if "position" in feats else
                SinusoidalPositionalEmbedding(cfg.max_target_positions, D, pad))
        self.query_linear = Linear(n_parts * D, D)
        self.key_linear = Linear(n_parts * D, D)
        self.gate_linear = Linear(n_parts * D, cfg.num_heads)

    def extract_features(self, prev_output_tokens: torch.Tensor,
                         enc_out: torch.Tensor,
                         enc_pad_mask: torch.Tensor,
                         rng: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        x = self.embed_tokens(prev_output_tokens) * math.sqrt(
            self.embed_tokens.embedding_dim)
        x = dropout(x + self.embed_positions(prev_output_tokens), self.dropout,
                    rng)
        pad_mask = prev_output_tokens == self.pad
        for layer in self.layers:
            x = layer(x, pad_mask, enc_out, enc_pad_mask, rng)
        return x

    def output_layer(self, features: torch.Tensor) -> torch.Tensor:
        if self.share_input_output_embed:
            return self.embed_tokens.attend(features)
        return self.output_projection(features)

    def _link_inputs(self, features: torch.Tensor,
                     prev_output_tokens: torch.Tensor):
        """(q, k [B, L, D] in the compute dtype, log_gates [B, L, H] f32)
        of the link predictor."""
        parts = []
        if self._use_feature:
            parts.append(features)
        if self.link_positional is not None:
            parts.append(self.link_positional(prev_output_tokens))
        feats = torch.cat(parts, dim=-1)
        log_gates = torch.log_softmax(self.gate_linear(feats).float(), dim=-1)
        return self.query_linear(feats), self.key_linear(feats), log_gates

    def extract_links(self, features: torch.Tensor,
                      prev_output_tokens: torch.Tensor) -> torch.Tensor:
        """links [B, L, L] f32 log-transitions, -inf where invalid
        (``dag_model.py:120-199``)."""
        L = features.shape[1]
        dk = features.shape[-1] // self.num_heads
        q, k, log_gates = self._link_inputs(features, prev_output_tokens)
        out_len = (prev_output_tokens != self.pad).sum(dim=-1)
        mtl = (self.max_transition_length
               if 0 < self.max_transition_length < L - 1 else None)
        return fused_extract_links(q, k, log_gates, out_len, self.num_heads,
                                   1.0 / math.sqrt(dk), mtl)

    def extract_links_banded(self, features: torch.Tensor,
                             prev_output_tokens: torch.Tensor
                             ) -> torch.Tensor:
        """Banded transitions [B, L, W] f32 (``band[b, i, d] = log P(v_i ->
        v_{i+d+1})``, W = ``max_transition_length``) without the [L, L]
        score matrix (``dag_model.py:201-290``): L splits into blocks of
        W, row i's successors lie in its own block and the next, so QK runs
        on (diagonal, superdiagonal) block pairs only and a one-hot einsum
        picks each row's W band entries. The -1e9 floor, the softmax over
        the band and the gated log-sum-exp over heads are
        ``extract_links``'s: the result is ``full_to_band(extract_links(...),
        W)``. Plain tensor ops; q and k are upcast to f32 (JAX's einsum
        accumulates in f32)."""
        B, L, _ = features.shape
        H = self.num_heads
        dk = features.shape[-1] // H
        W = self.max_transition_length
        if not 0 < W < L - 1:
            raise ValueError(
                f"extract_links_banded needs 0 < max_transition_length "
                f"< L-1, got {W} at L={L}")
        q, k, log_gates = self._link_inputs(features, prev_output_tokens)
        q = q.float().reshape(B, L, H, dk)
        k = k.float().reshape(B, L, H, dk)
        nb = -(-L // W)
        Lp = nb * W
        if Lp != L:
            padz = q.new_zeros((B, Lp - L, H, dk))
            q = torch.cat([q, padz], dim=1)
            k = torch.cat([k, padz], dim=1)
        qb = q.reshape(B, nb, W, H, dk)
        kb = k.reshape(B, nb, W, H, dk)
        kcat = torch.cat([kb, torch.cat([kb[:, 1:], torch.zeros_like(
            kb[:, :1])], dim=1)], dim=2)                  # [B, nb, 2W, H, dk]
        scores = torch.einsum("bnqhd,bnkhd->bnqkh", qb, kcat) / math.sqrt(dk)
        # local row q's band entry d sits at local column q + d + 1
        dev = features.device
        ar = torch.arange(W, device=dev)
        sel = (torch.arange(2 * W, device=dev)[None, None, :]
               == (ar[:, None, None] + ar[None, :, None] + 1)
               ).to(scores.dtype)                         # [W(q), W(d), 2W]
        band = torch.einsum("bnqkh,qdk->bnqdh", scores, sel)
        band = band.reshape(B, Lp, W, H)[:, :L]

        out_len = (prev_output_tokens != self.pad).sum(dim=-1)
        j_idx = (torch.arange(L, device=dev)[None, :, None]
                 + ar[None, None, :] + 1)
        valid = (j_idx < L) & (j_idx < out_len[:, None, None])  # [B, L, W]
        band = torch.where(valid[..., None], band,
                           torch.full_like(band, NEG_FLOOR))
        m = band.amax(dim=2, keepdim=True).detach()
        lse = torch.log(torch.exp(band - m).sum(dim=2, keepdim=True)) + m
        combined = band - lse + log_gates[:, :, None, :]
        cm = combined.amax(dim=-1, keepdim=True).detach()
        links = torch.log(torch.exp(combined - cm).sum(dim=-1)) + cm[..., 0]
        return torch.where(valid, links, torch.full_like(links, -torch.inf))


class S2TConformerDAG(nn.Module):
    """Conformer encoder + GlatLinkDecoder (``dag_model.py:287-394``);
    ``dtype`` is the compute dtype (``layers.set_dtype``)."""

    def __init__(self, cfg, dtype: torch.dtype = FP32):
        super().__init__()
        e, d = cfg.encoder, cfg.decoder
        self.encoder = ConformerEncoder(e)
        self.enc_proj = (Linear(e.embed_dim, d.embed_dim)
                         if e.embed_dim != d.embed_dim else None)
        self.decoder = GlatLinkDecoder(cfg.vocab.size, cfg.vocab.pad, d)
        set_dtype(self, dtype)

    def encode(self, fbank: torch.Tensor, src_lengths: torch.Tensor,
               rng: Optional[torch.Generator] = None):
        enc, enc_pad, enc_lens = self.encoder(fbank, src_lengths, rng)
        if self.enc_proj is not None:
            enc = self.enc_proj(enc)
        return enc, enc_pad, enc_lens

    def decode(self, prev_output_tokens: torch.Tensor, enc: torch.Tensor,
               enc_pad: torch.Tensor, require_links: bool = True,
               rng: Optional[torch.Generator] = None):
        features = self.decoder.extract_features(prev_output_tokens, enc,
                                                 enc_pad, rng)
        logits = self.decoder.output_layer(features)
        links = (self.decoder.extract_links(features, prev_output_tokens)
                 if require_links else None)
        return logits, links, features

    def decode_features(self, prev_output_tokens, enc, enc_pad,
                        rng: Optional[torch.Generator] = None):
        """(links, features) without the vocabulary projection: the
        streamed fused-vocab loss (``ops/fused_vocab.py``) never forms the
        [B, L, V] logits (``dag_model.py:341-350``)."""
        features = self.decoder.extract_features(prev_output_tokens, enc,
                                                 enc_pad, rng)
        return (self.decoder.extract_links(features, prev_output_tokens),
                features)

    def decode_banded(self, prev_output_tokens, enc, enc_pad,
                      rng: Optional[torch.Generator] = None):
        """(logits, band [B, L, W], features): banded link extraction, so
        that with ``--banded-dp`` no [L, L] matrix exists
        (``dag_model.py:352-361``)."""
        features = self.decoder.extract_features(prev_output_tokens, enc,
                                                 enc_pad, rng)
        return (self.decoder.output_layer(features),
                self.decoder.extract_links_banded(features,
                                                  prev_output_tokens),
                features)

    def decode_features_banded(self, prev_output_tokens, enc, enc_pad,
                               rng: Optional[torch.Generator] = None):
        """(band, features): neither the [B, L, V] logits nor the [L, L]
        links (``dag_model.py:363-371``)."""
        features = self.decoder.extract_features(prev_output_tokens, enc,
                                                 enc_pad, rng)
        return (self.decoder.extract_links_banded(features,
                                                  prev_output_tokens),
                features)

    def forward_features(self, fbank, src_lengths, prev_output_tokens):
        """encode + :meth:`decode_features`."""
        enc, enc_pad, _ = self.encode(fbank, src_lengths)
        return self.decode_features(prev_output_tokens, enc, enc_pad)

    def forward_banded(self, fbank, src_lengths, prev_output_tokens):
        """encode + :meth:`decode_banded`."""
        enc, enc_pad, _ = self.encode(fbank, src_lengths)
        return self.decode_banded(prev_output_tokens, enc, enc_pad)

    def forward(self, fbank, src_lengths, prev_output_tokens):
        enc, enc_pad, _ = self.encode(fbank, src_lengths)
        return self.decode(prev_output_tokens, enc, enc_pad)


def graph_lengths(src_lengths: torch.Tensor, upsample_scale: float,
                  max_positions: int) -> torch.Tensor:
    """lambda * src_len graph size (``dag_model.py:397-404``)."""
    return torch.clamp((src_lengths * upsample_scale).to(torch.int32),
                       2, max_positions)


def initialize_output_tokens(length_tgt: torch.Tensor, max_length: int,
                             vocab) -> torch.Tensor:
    """[B] graph lengths -> [B, max_length] tokens: <bos> unk... <eos> pad...
    (``dag_model.py:407-417``)."""
    idx = torch.arange(max_length, device=length_tgt.device)[None, :]
    toks = torch.where(idx < length_tgt[:, None], vocab.unk, vocab.pad)
    toks[:, 0] = vocab.bos
    toks = torch.where(idx == length_tgt[:, None] - 1, vocab.eos, toks)
    return toks.to(torch.int64)
