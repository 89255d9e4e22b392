"""Two-pass S2ST model (PyTorch): Conformer-DAG linguistic pass + FFN
adaptor + FastSpeech 2 acoustic pass on the DAG decoder's hidden states.

Counterpart of ``daspeech_tpu/models/s2s_model.py``. A call given ``rng``
(a ``torch.Generator`` on the tensors' device) is a training pass
(``models/layers.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from daspeech_torch.models.dag_model import S2TConformerDAG
from daspeech_torch.models.fastspeech2 import FastSpeech2Encoder, FFNAdapter
from daspeech_torch.models.layers import FP32, set_dtype
from daspeech_torch.telemetry import span


class S2SConformerDAGFastSpeech2(nn.Module):
    """``s2s_model.py:24-102``; ``dtype`` is the compute dtype of all three
    parts (``layers.set_dtype``)."""

    def __init__(self, cfg, dtype: torch.dtype = FP32):
        super().__init__()
        self.cfg = cfg
        self.dag = S2TConformerDAG(cfg.dag)
        self.adaptor = FFNAdapter(cfg.dag.decoder.embed_dim,
                                  cfg.adaptor_ffn_dim,
                                  cfg.tts.encoder_embed_dim,
                                  cfg.adaptor_dropout)
        self.tts = FastSpeech2Encoder(cfg.tts, pad=cfg.dag.vocab.pad)
        set_dtype(self, dtype)

    def encode(self, fbank: torch.Tensor, src_lengths: torch.Tensor,
               rng: Optional[torch.Generator] = None):
        return self.dag.encode(fbank, src_lengths, rng)

    def decode(self, prev_output_tokens, enc, enc_pad,
               require_links: bool = True,
               rng: Optional[torch.Generator] = None):
        return self.dag.decode(prev_output_tokens, enc, enc_pad,
                               require_links=require_links, rng=rng)

    def decode_features(self, prev_output_tokens, enc, enc_pad,
                        rng: Optional[torch.Generator] = None):
        """The DAG decode without the vocabulary projection."""
        return self.dag.decode_features(prev_output_tokens, enc, enc_pad,
                                        rng=rng)

    def decode_banded(self, prev_output_tokens, enc, enc_pad,
                      rng: Optional[torch.Generator] = None):
        """The DAG decode with banded links."""
        return self.dag.decode_banded(prev_output_tokens, enc, enc_pad,
                                      rng=rng)

    def decode_features_banded(self, prev_output_tokens, enc, enc_pad,
                               rng: Optional[torch.Generator] = None):
        """Banded links, no vocabulary projection."""
        return self.dag.decode_features_banded(prev_output_tokens, enc,
                                               enc_pad, rng=rng)

    def forward_features(self, fbank, src_lengths, prev_output_tokens):
        return self.dag.forward_features(fbank, src_lengths,
                                         prev_output_tokens)

    def forward_banded(self, fbank, src_lengths, prev_output_tokens):
        return self.dag.forward_banded(fbank, src_lengths,
                                       prev_output_tokens)

    def forward(self, fbank, src_lengths, prev_output_tokens):
        enc, enc_pad, _ = self.encode(fbank, src_lengths)
        return self.decode(prev_output_tokens, enc, enc_pad)

    def synthesize(self, features: torch.Tensor,
                   features_pad_mask: torch.Tensor, max_mel_len: int,
                   durations: Optional[torch.Tensor] = None,
                   d_factor: float = 1.0,
                   pitches: Optional[torch.Tensor] = None,
                   energies: Optional[torch.Tensor] = None,
                   rng: Optional[torch.Generator] = None):
        """adaptor -> FastSpeech2 NoEmb: (mel [B, M, 80], mel_post or None,
        mel_lens [B], log_dur_out, pitch_out, energy_out), in the spans
        ``synth.adaptor`` and ``synth.fastspeech2``."""
        with span("synth.adaptor"):
            x = self.adaptor(features, rng)
        with span("synth.fastspeech2"):
            return self.tts(x, features_pad_mask, max_mel_len, durations,
                            d_factor, pitches=pitches, energies=energies,
                            rng=rng)
