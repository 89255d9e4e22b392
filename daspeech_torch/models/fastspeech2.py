"""FastSpeech 2 acoustic decoder (PyTorch): the continuous-input (NoEmb)
path of the two-pass model and the token-input path of TTS pretraining.

Counterpart of ``daspeech_tpu/models/fastspeech2.py``: FFT blocks, variance
adaptor with bucketed pitch/energy embeddings, and a vectorized length
regulator (cumsum + searchsorted). A forward given ``rng`` is a training
pass (``models/layers.py``): dropout on the encoder input, after each conv
FFN and in the variance predictors and the Postnet, and on the FFT
attention probabilities at ``attention_dropout``; gold pitches and
energies, when given, pick the bucket embeddings in place of the
predictions, and the Postnet's BatchNorm takes batch statistics. The
options that every recipe leaves off are here too: the Postnet, the
speaker embedding, the CTC head and the unfused attention
(``fused_attention=False``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from daspeech_torch.models.conformer import MaskedBatchNorm
from daspeech_torch.models.layers import (
    FP32,
    Compute,
    Conv1d,
    Embedding,
    Linear,
    MultiHeadAttention,
    dropout,
    layer_norm,
    lengths_to_padding_mask,
    set_dtype,
    sinusoidal_embedding_table,
    tp_shards,
)
from daspeech_torch.parallel import shard


def _conv_btc(conv: Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Conv1d on a [B, T, C] tensor."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class PositionwiseConvFFN(nn.Module):
    """Conv1d(k) -> ReLU -> Conv1d(k) -> dropout, + residual, LN
    (``fastspeech2.py:28-48``)."""

    def __init__(self, in_dim: int, hidden_dim: int, kernel_size: int,
                 dropout: float = 0.0):
        super().__init__()
        p = (kernel_size - 1) // 2
        self.dropout = dropout
        self.conv1 = Conv1d(in_dim, hidden_dim, kernel_size, padding=p)
        self.conv2 = Conv1d(hidden_dim, in_dim, kernel_size, padding=p)
        self.layer_norm = layer_norm(in_dim)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = _conv_btc(self.conv2, F.relu(_conv_btc(self.conv1, x)))
        return self.layer_norm(dropout(y, self.dropout, rng) + x)


class FFTLayer(nn.Module):
    """Self-attention + conv FFN (``fastspeech2.py:51-76``); the attention
    takes the kernels unless ``fused_attention`` is False."""

    def __init__(self, embed_dim: int, num_heads: int, hidden_dim: int,
                 kernel_size: int, dropout: float = 0.0,
                 attention_dropout: float = 0.0,
                 fused_attention: bool = True):
        super().__init__()
        self.self_attn = MultiHeadAttention(embed_dim, num_heads,
                                            attention_dropout,
                                            fused=fused_attention)
        self.layer_norm = layer_norm(embed_dim)
        self.ffn = PositionwiseConvFFN(embed_dim, hidden_dim, kernel_size,
                                       dropout)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.layer_norm(
            x + self.self_attn(x, x, x, key_padding_mask=pad_mask, rng=rng))
        return self.ffn(x, rng)


class VariancePredictor(nn.Module):
    """Conv -> ReLU -> LN -> dropout (x2) -> Linear
    (``fastspeech2.py:79-103``)."""

    def __init__(self, in_dim: int, hidden_dim: int, kernel_size: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.conv1 = Conv1d(in_dim, hidden_dim, kernel_size,
                            padding=(kernel_size - 1) // 2)
        self.ln1 = layer_norm(hidden_dim)
        # the reference's second conv pads 1 whatever the kernel size
        self.conv2 = Conv1d(hidden_dim, hidden_dim, kernel_size, padding=1)
        self.ln2 = layer_norm(hidden_dim)
        self.proj = Linear(hidden_dim, 1)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(self.ln1(F.relu(_conv_btc(self.conv1, x))), self.dropout,
                    rng)
        x = dropout(self.ln2(F.relu(_conv_btc(self.conv2, x))), self.dropout,
                    rng)
        return self.proj(x)[..., 0]                               # [B, T]


def length_regulate(x: torch.Tensor, durations: torch.Tensor,
                    max_out_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """out[b, m] = x[b, j] with j the source index whose cumulative duration
    span covers frame m; frames past sum(durations) are zero
    (``fastspeech2.py:106-126``). Returns (out [B, M, C], out_lens [B])."""
    cums = torch.cumsum(durations, dim=1)
    out_lens = cums[:, -1]
    m_idx = torch.arange(max_out_len, device=x.device, dtype=cums.dtype)
    idx = torch.searchsorted(cums.contiguous(),
                             m_idx.expand(x.shape[0], -1).contiguous(),
                             right=True)
    idx = idx.clamp(max=x.shape[1] - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    valid = m_idx[None, :] < out_lens[:, None]
    return out * valid[:, :, None], out_lens


class VarianceAdaptor(nn.Module):
    """Duration/pitch/energy predictors + length regulator
    (``fastspeech2.py:129-185``)."""

    def __init__(self, cfg, dim: int):
        super().__init__()
        vp = lambda: VariancePredictor(dim, cfg.var_pred_hidden_dim,  # noqa
                                       cfg.var_pred_kernel_size,
                                       cfg.var_pred_dropout)
        self.duration_predictor = vp()
        self.pitch_predictor = vp()
        self.energy_predictor = vp()
        self.embed_pitch = Embedding(cfg.var_pred_n_bins, dim)
        self.embed_energy = Embedding(cfg.var_pred_n_bins, dim)
        n = cfg.var_pred_n_bins - 1
        # f32 bin edges; jnp.linspace on XLA:CPU lands up to one ulp away
        # on some edges (tests/test_torch_models.py::test_variance_bins)
        self.register_buffer("pitch_bins", torch.linspace(
            cfg.pitch_min, cfg.pitch_max, n), persistent=False)
        self.register_buffer("energy_bins", torch.linspace(
            cfg.energy_min, cfg.energy_max, n), persistent=False)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                max_out_len: int, durations: Optional[torch.Tensor] = None,
                d_factor: float = 1.0,
                pitches: Optional[torch.Tensor] = None,
                energies: Optional[torch.Tensor] = None,
                p_factor: float = 1.0, e_factor: float = 1.0,
                rng: Optional[torch.Generator] = None):
        """Gold ``durations``, ``pitches`` and ``energies`` (training) take
        the place of the predictions where given. A bf16 prediction picks
        its bucket against the fp32 edges (exactly: every bf16 value is an
        fp32 value), as JAX's ``searchsorted`` promotes it."""
        log_dur_out = self.duration_predictor(x, rng)
        dur_out = torch.clamp(torch.round((torch.exp(log_dur_out) - 1)
                                          * d_factor), min=0).long()
        dur_out = dur_out.masked_fill(pad_mask, 0)

        pitch_out = self.pitch_predictor(x, rng)
        pitch_src = pitches if pitches is not None else pitch_out * p_factor
        x = x + self.embed_pitch(
            torch.searchsorted(self.pitch_bins,
                               pitch_src.to(self.pitch_bins.dtype)
                               .contiguous(), right=True))
        energy_out = self.energy_predictor(x, rng)
        energy_src = (energies if energies is not None
                      else energy_out * e_factor)
        x = x + self.embed_energy(
            torch.searchsorted(self.energy_bins,
                               energy_src.to(self.energy_bins.dtype)
                               .contiguous(), right=True))

        use_dur = durations if durations is not None else dur_out
        x, out_lens = length_regulate(x, use_dur, max_out_len)
        return x, out_lens, log_dur_out, pitch_out, energy_out


class Postnet(Compute, nn.Module):
    """Tacotron 2 Postnet (``fastspeech2.py:188-211``): ``layers`` convs of
    ``kernel_size`` taps, each followed by BatchNorm, tanh (all but the
    last) and dropout; the caller adds the residual. JAX's ``nn.BatchNorm``
    has no mask, so the statistics of a training pass take every frame,
    padded ones too (:class:`MaskedBatchNorm` with every frame valid:
    momentum 0.9, the biased variance, eps 1e-5). The statistics and the
    normalisation are fp32; the output is rounded to the compute dtype, as
    flax's ``BatchNorm(dtype=...)`` rounds it."""

    def __init__(self, in_dim: int, conv_dim: int = 512,
                 kernel_size: int = 5, layers: int = 5, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        p = (kernel_size - 1) // 2
        dims = [in_dim] + [conv_dim] * (layers - 1) + [in_dim]
        self.conv = nn.ModuleList(Conv1d(dims[i], dims[i + 1], kernel_size,
                                         padding=p) for i in range(layers))
        self.bn = nn.ModuleList(MaskedBatchNorm(dims[i + 1])
                                for i in range(layers))

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        valid = (None if rng is None else
                 torch.ones(x.shape[:2], dtype=torch.bool, device=x.device))
        for i, (conv, bn) in enumerate(zip(self.conv, self.bn)):
            x = self.compute(bn(_conv_btc(conv, x), valid))
            if i < len(self.conv) - 1:
                x = torch.tanh(x)
            x = dropout(x, self.dropout, rng)
        return x


def _positions(pad_mask: torch.Tensor, pad: int) -> torch.Tensor:
    keep = (~pad_mask).long()
    return torch.cumsum(keep, dim=1) * keep + pad


class FastSpeech2Encoder(Compute, nn.Module):
    """FastSpeech2 (``fastspeech2.py:215-331``): hidden states [B, T, C]
    (NoEmb path) or, with ``vocab_size`` > 0, phoneme tokens [B, T] (the
    ``embed_tokens`` path) -> mel. ``dtype`` is the compute dtype
    (``layers.set_dtype``); the positional tables are rounded to it before
    their fp32 scale multiplies them, as in ``fastspeech2.py:259``.

    The options: ``add_postnet`` (:class:`Postnet`, residual added here),
    ``num_speakers`` > 0 with ``speaker_embed_dim`` > 0 (``embed_speaker``
    broadcast over time, concatenated, ``spk_emb_proj``; ``:272-289``),
    ``ctc_weight`` > 0 on the token path (``ctc_proj`` on the pre-Postnet
    mel, ``:316-323``) and ``fused_attention=False`` (every FFT attention
    on the plain path)."""

    def __init__(self, cfg, vocab_size: int = 0, pad: int = 1,
                 dtype: torch.dtype = FP32):
        super().__init__()
        self.cfg, self.pad = cfg, pad
        if vocab_size > 0:
            self.embed_tokens = Embedding(vocab_size, cfg.encoder_embed_dim)
        self.pos_emb_alpha = nn.Parameter(torch.ones(1))
        self.encoder_fft = nn.ModuleList(
            FFTLayer(cfg.encoder_embed_dim, cfg.encoder_heads,
                     cfg.fft_hidden_dim, cfg.fft_kernel_size, cfg.dropout,
                     cfg.attention_dropout, cfg.fused_attention)
            for _ in range(cfg.encoder_layers))
        if cfg.speaker_embed_dim > 0 and cfg.num_speakers > 0:
            self.embed_speaker = Embedding(cfg.num_speakers,
                                           cfg.speaker_embed_dim)
            self.spk_emb_proj = Linear(
                cfg.encoder_embed_dim + cfg.speaker_embed_dim,
                cfg.encoder_embed_dim)
        self.var_adaptor = VarianceAdaptor(cfg, cfg.encoder_embed_dim)
        self.dec_pos_emb_alpha = nn.Parameter(torch.ones(1))
        self.decoder_fft = nn.ModuleList(
            FFTLayer(cfg.decoder_embed_dim, cfg.decoder_heads,
                     cfg.fft_hidden_dim, cfg.fft_kernel_size, cfg.dropout,
                     cfg.attention_dropout, cfg.fused_attention)
            for _ in range(cfg.decoder_layers))
        out_dim = cfg.output_frame_dim * cfg.n_frames_per_step
        self.out_proj = Linear(cfg.decoder_embed_dim, out_dim)
        self.has_ctc = cfg.ctc_weight > 0.0 and vocab_size > 0
        if self.has_ctc:
            self.ctc_proj = Linear(out_dim, vocab_size)
        if cfg.add_postnet:
            self.postnet = Postnet(out_dim, cfg.postnet_conv_dim,
                                   cfg.postnet_conv_kernel_size,
                                   cfg.postnet_layers, cfg.postnet_dropout)
        set_dtype(self, dtype)

    def forward(self, x: Optional[torch.Tensor] = None,
                enc_pad_mask: Optional[torch.Tensor] = None,
                max_out_len: int = 0,
                durations: Optional[torch.Tensor] = None,
                d_factor: float = 1.0, *,
                src_tokens: Optional[torch.Tensor] = None,
                pitches: Optional[torch.Tensor] = None,
                energies: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None,
                speaker: Optional[torch.Tensor] = None):
        """``x`` and ``enc_pad_mask`` (NoEmb path), or ``src_tokens``
        (padding where equal to ``pad``); ``speaker`` [B] ids (0 when not
        given) for a multi-speaker model. Returns JAX's six-tuple (mel
        [B, M, 80], mel_post [B, M, 80] or None, out_lens [B], log_dur_out
        [B, T], pitch_out [B, T], energy_out [B, T]), and the CTC logits
        [B, M, V] as a seventh element when the model has its CTC head."""
        c = self.cfg
        if src_tokens is not None:
            x = self.embed_tokens(src_tokens)
            enc_pad_mask = src_tokens == self.pad
        table = sinusoidal_embedding_table(
            x.shape[1] + self.pad + 1, c.encoder_embed_dim, self.pad,
            device=x.device)
        x = x + self.pos_emb_alpha * self.compute(table[
            _positions(enc_pad_mask, self.pad)])
        x = dropout(x, c.dropout, rng)
        for layer in self.encoder_fft:
            x = layer(x, enc_pad_mask, rng)
        if hasattr(self, "embed_speaker"):
            if speaker is None:
                speaker = torch.zeros(x.shape[0], dtype=torch.long,
                                      device=x.device)
            emb = self.embed_speaker(speaker.long())[:, None, :]
            x = self.spk_emb_proj(torch.cat(
                [x, emb.expand(-1, x.shape[1], -1)], dim=-1))

        x, out_lens, log_dur_out, pitch_out, energy_out = self.var_adaptor(
            x, enc_pad_mask, max_out_len, durations, d_factor, pitches,
            energies, rng=rng)

        dec_pad_mask = lengths_to_padding_mask(out_lens, x.shape[1])
        table_d = sinusoidal_embedding_table(
            x.shape[1] + self.pad + 1, c.decoder_embed_dim, self.pad,
            device=x.device)
        x = x + self.dec_pos_emb_alpha * self.compute(table_d[
            _positions(dec_pad_mask, self.pad)])
        for layer in self.decoder_fft:
            x = layer(x, dec_pad_mask, rng)
        mel = self.out_proj(x)
        mel_post = (mel + self.postnet(mel, rng) if hasattr(self, "postnet")
                    else None)
        out = (mel, mel_post, out_lens, log_dur_out, pitch_out, energy_out)
        return out + (self.ctc_proj(mel),) if self.has_ctc else out


class FFNAdapter(nn.Module):
    """DAG hidden state -> TTS input adaptor: Linear -> ReLU -> dropout ->
    Linear (``fastspeech2.py:334-348``); with ``tp`` fc1 column- and fc2
    row-parallel over the hidden width."""

    tp: Optional[shard.Axis] = None

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.fc1 = Linear(in_dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.fc2(dropout(F.relu(self.fc1(x)), self.dropout, rng,
                                tp_shards(self.tp, -1)))
