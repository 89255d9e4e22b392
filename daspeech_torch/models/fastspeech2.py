"""FastSpeech 2 acoustic decoder (PyTorch), continuous-input (NoEmb) path.

Counterpart of ``daspeech_tpu/models/fastspeech2.py``: FFT blocks, variance
adaptor with bucketed pitch/energy embeddings, and a vectorized length
regulator (cumsum + searchsorted). The token-input path, speaker embedding,
CTC head and Postnet (all off in the recipe) are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from daspeech_torch.models.layers import (
    MultiHeadAttention,
    layer_norm,
    lengths_to_padding_mask,
    sinusoidal_embedding_table,
)


def _conv_btc(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Conv1d on a [B, T, C] tensor."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class PositionwiseConvFFN(nn.Module):
    """Conv1d(k) -> ReLU -> Conv1d(k) + residual + LN
    (``fastspeech2.py:28-48``)."""

    def __init__(self, in_dim: int, hidden_dim: int, kernel_size: int):
        super().__init__()
        p = (kernel_size - 1) // 2
        self.conv1 = nn.Conv1d(in_dim, hidden_dim, kernel_size, padding=p)
        self.conv2 = nn.Conv1d(hidden_dim, in_dim, kernel_size, padding=p)
        self.layer_norm = layer_norm(in_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv_btc(self.conv2, F.relu(_conv_btc(self.conv1, x)))
        return self.layer_norm(y + x)


class FFTLayer(nn.Module):
    """Self-attention + conv FFN (``fastspeech2.py:51-76``)."""

    def __init__(self, embed_dim: int, num_heads: int, hidden_dim: int,
                 kernel_size: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(embed_dim, num_heads)
        self.layer_norm = layer_norm(embed_dim)
        self.ffn = PositionwiseConvFFN(embed_dim, hidden_dim, kernel_size)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(
            x + self.self_attn(x, x, x, key_padding_mask=pad_mask))
        return self.ffn(x)


class VariancePredictor(nn.Module):
    """Conv -> ReLU -> LN (x2) -> Linear (``fastspeech2.py:79-103``)."""

    def __init__(self, in_dim: int, hidden_dim: int, kernel_size: int):
        super().__init__()
        self.conv1 = nn.Conv1d(in_dim, hidden_dim, kernel_size,
                               padding=(kernel_size - 1) // 2)
        self.ln1 = layer_norm(hidden_dim)
        # the reference's second conv pads 1 whatever the kernel size
        self.conv2 = nn.Conv1d(hidden_dim, hidden_dim, kernel_size, padding=1)
        self.ln2 = layer_norm(hidden_dim)
        self.proj = nn.Linear(hidden_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln1(F.relu(_conv_btc(self.conv1, x)))
        x = self.ln2(F.relu(_conv_btc(self.conv2, x)))
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
        vp = lambda: VariancePredictor(dim, cfg.var_pred_hidden_dim,
                                       cfg.var_pred_kernel_size)
        self.duration_predictor = vp()
        self.pitch_predictor = vp()
        self.energy_predictor = vp()
        self.embed_pitch = nn.Embedding(cfg.var_pred_n_bins, dim)
        self.embed_energy = nn.Embedding(cfg.var_pred_n_bins, dim)
        n = cfg.var_pred_n_bins - 1
        # f32 bin edges; jnp.linspace on XLA:CPU lands up to one ulp away
        # on some edges (tests/test_torch_models.py::test_variance_bins)
        self.register_buffer("pitch_bins", torch.linspace(
            cfg.pitch_min, cfg.pitch_max, n), persistent=False)
        self.register_buffer("energy_bins", torch.linspace(
            cfg.energy_min, cfg.energy_max, n), persistent=False)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                max_out_len: int, durations: Optional[torch.Tensor] = None,
                d_factor: float = 1.0):
        log_dur_out = self.duration_predictor(x)
        dur_out = torch.clamp(torch.round((torch.exp(log_dur_out) - 1)
                                          * d_factor), min=0).long()
        dur_out = dur_out.masked_fill(pad_mask, 0)

        pitch_out = self.pitch_predictor(x)
        x = x + self.embed_pitch(
            torch.searchsorted(self.pitch_bins, pitch_out, right=True))
        energy_out = self.energy_predictor(x)
        x = x + self.embed_energy(
            torch.searchsorted(self.energy_bins, energy_out, right=True))

        use_dur = durations if durations is not None else dur_out
        x, out_lens = length_regulate(x, use_dur, max_out_len)
        return x, out_lens, log_dur_out, pitch_out, energy_out


def _positions(pad_mask: torch.Tensor, pad: int) -> torch.Tensor:
    keep = (~pad_mask).long()
    return torch.cumsum(keep, dim=1) * keep + pad


class FastSpeech2Encoder(nn.Module):
    """FastSpeech2 on the continuous-input (NoEmb) path
    (``fastspeech2.py:215-331``): hidden states [B, T, C] -> mel."""

    def __init__(self, cfg, pad: int = 1):
        super().__init__()
        if cfg.add_postnet or (cfg.speaker_embed_dim > 0
                               and cfg.num_speakers > 0):
            raise NotImplementedError(
                "Postnet and speaker embeddings are not ported yet")
        self.cfg, self.pad = cfg, pad
        self.pos_emb_alpha = nn.Parameter(torch.ones(1))
        self.encoder_fft = nn.ModuleList(
            FFTLayer(cfg.encoder_embed_dim, cfg.encoder_heads,
                     cfg.fft_hidden_dim, cfg.fft_kernel_size)
            for _ in range(cfg.encoder_layers))
        self.var_adaptor = VarianceAdaptor(cfg, cfg.encoder_embed_dim)
        self.dec_pos_emb_alpha = nn.Parameter(torch.ones(1))
        self.decoder_fft = nn.ModuleList(
            FFTLayer(cfg.decoder_embed_dim, cfg.decoder_heads,
                     cfg.fft_hidden_dim, cfg.fft_kernel_size)
            for _ in range(cfg.decoder_layers))
        self.out_proj = nn.Linear(cfg.decoder_embed_dim,
                                  cfg.output_frame_dim * cfg.n_frames_per_step)

    def forward(self, x: torch.Tensor, enc_pad_mask: torch.Tensor,
                max_out_len: int, durations: Optional[torch.Tensor] = None,
                d_factor: float = 1.0):
        """Returns (mel [B, M, 80], out_lens [B], log_dur_out [B, T],
        pitch_out [B, T], energy_out [B, T])."""
        c = self.cfg
        table = sinusoidal_embedding_table(
            x.shape[1] + self.pad + 1, c.encoder_embed_dim, self.pad,
            device=x.device)
        x = x + self.pos_emb_alpha * table[_positions(enc_pad_mask, self.pad)]
        for layer in self.encoder_fft:
            x = layer(x, enc_pad_mask)

        x, out_lens, log_dur_out, pitch_out, energy_out = self.var_adaptor(
            x, enc_pad_mask, max_out_len, durations, d_factor)

        dec_pad_mask = lengths_to_padding_mask(out_lens, x.shape[1])
        table_d = sinusoidal_embedding_table(
            x.shape[1] + self.pad + 1, c.decoder_embed_dim, self.pad,
            device=x.device)
        x = x + self.dec_pos_emb_alpha * table_d[
            _positions(dec_pad_mask, self.pad)]
        for layer in self.decoder_fft:
            x = layer(x, dec_pad_mask)
        return self.out_proj(x), out_lens, log_dur_out, pitch_out, energy_out


class FFNAdapter(nn.Module):
    """DAG hidden state -> TTS input adaptor (``fastspeech2.py:334-348``)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))
