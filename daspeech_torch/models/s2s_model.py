"""Two-pass S2ST model (PyTorch): Conformer-DAG linguistic pass + FFN
adaptor + FastSpeech 2 acoustic pass on the DAG decoder's hidden states.

Counterpart of ``daspeech_tpu/models/s2s_model.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from daspeech_torch.models.dag_model import S2TConformerDAG
from daspeech_torch.models.fastspeech2 import FastSpeech2Encoder, FFNAdapter


class S2SConformerDAGFastSpeech2(nn.Module):
    """``s2s_model.py:24-102``, eval mode."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.dag = S2TConformerDAG(cfg.dag)
        self.adaptor = FFNAdapter(cfg.dag.decoder.embed_dim,
                                  cfg.adaptor_ffn_dim,
                                  cfg.tts.encoder_embed_dim)
        self.tts = FastSpeech2Encoder(cfg.tts, pad=cfg.dag.vocab.pad)

    def encode(self, fbank: torch.Tensor, src_lengths: torch.Tensor):
        return self.dag.encode(fbank, src_lengths)

    def decode(self, prev_output_tokens, enc, enc_pad,
               require_links: bool = True):
        return self.dag.decode(prev_output_tokens, enc, enc_pad,
                               require_links=require_links)

    def forward(self, fbank, src_lengths, prev_output_tokens):
        enc, enc_pad, _ = self.encode(fbank, src_lengths)
        return self.decode(prev_output_tokens, enc, enc_pad)

    def synthesize(self, features: torch.Tensor,
                   features_pad_mask: torch.Tensor, max_mel_len: int,
                   durations: Optional[torch.Tensor] = None,
                   d_factor: float = 1.0):
        """adaptor -> FastSpeech2 NoEmb: (mel [B, M, 80], mel_lens [B],
        log_dur_out, pitch_out, energy_out)."""
        return self.tts(self.adaptor(features), features_pad_mask,
                        max_mel_len, durations, d_factor)
