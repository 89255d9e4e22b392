"""The configuration dataclasses the port's modules read.

They mirror the fields of ``daspeech_tpu/core/config.py`` that the port's
serving and decoding, the S2TT DAG training step, the joint S2ST step,
FastSpeech 2 pretraining, the two AR baselines and vocoder training use,
with the same names and defaults
(the recipe's: ``tests/test_torch_models.py::test_config_mirrors_jax``
holds them to the JAX package's), and leave out the fields of paths not
ported yet and the TPU kernel switches. The port's modules read configs by
attribute, so the JAX package's config objects work in their place.
:func:`from_dict` / :func:`to_dict` (``core/config.py:237-272``) read and
write them as plain dicts (a model YAML).
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class VocabConfig:
    size: int = 200
    bos: int = 0
    pad: int = 1
    eos: int = 2
    unk: int = 3


@dataclass(frozen=True)
class ConformerConfig:
    """Encoder: 12L x 256d, FFN 2048, 4 heads."""
    embed_dim: int = 256
    ffn_dim: int = 2048
    num_layers: int = 12
    num_heads: int = 4
    dropout: float = 0.1
    attn_dropout: float = 0.1
    depthwise_kernel_size: int = 31
    conv_channels: int = 1024
    conv_kernel_sizes: Tuple[int, ...] = (5, 5)
    input_feat_dim: int = 80
    no_scale_embedding: bool = False


@dataclass(frozen=True)
class DAGDecoderConfig:
    """DAG (DA-Transformer) decoder: 4L x 512d, 8 heads."""
    embed_dim: int = 512
    ffn_dim: int = 2048
    num_layers: int = 4
    num_heads: int = 8
    dropout: float = 0.1
    attn_dropout: float = 0.1
    activation_dropout: float = 0.1
    activation: str = "gelu"
    learned_pos: bool = True
    share_input_output_embed: bool = True
    max_target_positions: int = 1024
    links_feature: str = "feature:position"
    max_transition_length: int = 99999
    src_upsample_scale: float = 0.5


@dataclass(frozen=True)
class DecodeConfig:
    # greedy | lookahead | viterbi | jointviterbi | beamsearch
    strategy: str = "lookahead"
    beta: float = 1.0                # logit scale (decode_beta)
    viterbibeta: float = 1.0         # length penalty for (joint)viterbi
    alpha: float = 1.1               # beam-search length penalty
    top_cand_n: int = 5
    beamsize: int = 100
    top_p: float = 0.9
    dedup: bool = False
    max_output_length: Optional[int] = None
    # NAT length beam: decode `length_beam` graph sizes around
    # lambda*src_len and keep the candidate with the best mean logprob
    length_beam: int = 1
    # iterative refinement: up to `iter_decode_max_iter` extra passes on
    # the decoded tokens; unless `iter_decode_force_max_iter`, a sample
    # stops once its output equals its input
    iter_decode_max_iter: int = 0
    iter_decode_force_max_iter: bool = False


@dataclass(frozen=True)
class FastSpeech2Config:
    """4+4L x 256d, FFT hidden 1024."""
    encoder_layers: int = 4
    encoder_embed_dim: int = 256
    encoder_heads: int = 4
    decoder_layers: int = 4
    decoder_embed_dim: int = 256
    decoder_heads: int = 4
    fft_hidden_dim: int = 1024
    fft_kernel_size: int = 9
    dropout: float = 0.2
    attention_dropout: float = 0.0
    output_frame_dim: int = 80
    n_frames_per_step: int = 1
    var_pred_n_bins: int = 256
    var_pred_hidden_dim: int = 256
    var_pred_kernel_size: int = 3
    var_pred_dropout: float = 0.5
    pitch_min: float = 0.0
    pitch_max: float = 600.0
    energy_min: float = 0.0
    energy_max: float = 5000.0
    add_postnet: bool = False
    postnet_layers: int = 5
    postnet_conv_dim: int = 512
    postnet_conv_kernel_size: int = 5
    postnet_dropout: float = 0.5
    fused_attention: bool = True     # False: the plain attention path
    speaker_embed_dim: int = 64      # used only when num_speakers > 0
    num_speakers: int = 0            # 0 = single-speaker (no embedding)
    ctc_weight: float = 0.0          # > 0: the CTC head and its loss term


@dataclass(frozen=True)
class TTSTransformerConfig:
    """The AR Transformer-TTS baseline (``at_tts``): 4+4L x 256d."""
    embed_dim: int = 256
    ffn_dim: int = 1024
    encoder_layers: int = 4
    decoder_layers: int = 4
    num_heads: int = 4
    dropout: float = 0.1
    prenet_dim: int = 256
    out_dim: int = 80
    add_postnet: bool = False


@dataclass(frozen=True)
class MultiDecoderConfig:
    """The two-pass AR S2ST baseline (``at_s2s``, and the length beam's
    reranker): Conformer 12L x 256d, text decoder 4L, synthesizer encoder
    2L, mel decoder 4L."""
    encoder_embed_dim: int = 256
    encoder_layers: int = 12
    encoder_heads: int = 4
    mt_embed_dim: int = 256
    mt_layers: int = 4
    mt_heads: int = 4
    ffn_dim: int = 1024
    synth_encoder_layers: int = 2
    tts_decoder_layers: int = 4
    prenet_dim: int = 256
    out_dim: int = 80
    dropout: float = 0.1
    conv_channels: int = 256
    depthwise_kernel_size: int = 31
    max_positions: int = 1024


@dataclass(frozen=True)
class HiFiGANConfig:
    """HiFi-GAN config_v1 (22.05 kHz, hop 256)."""
    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 22050
    hop_size: int = 256


@dataclass(frozen=True)
class DAGModelConfig:
    vocab: VocabConfig = field(default_factory=VocabConfig)
    encoder: ConformerConfig = field(default_factory=ConformerConfig)
    decoder: DAGDecoderConfig = field(default_factory=DAGDecoderConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)


@dataclass(frozen=True)
class S2SModelConfig:
    """Two-pass S2ST: Conformer-DAG + FFN adaptor + FastSpeech 2."""
    dag: DAGModelConfig = field(default_factory=DAGModelConfig)
    tts: FastSpeech2Config = field(default_factory=FastSpeech2Config)
    adaptor_ffn_dim: int = 1024
    adaptor_dropout: float = 0.1


@dataclass(frozen=True)
class GlatConfig:
    """Glancing training (``nat_dag_loss.py:60-67``). The port's criterion
    (``losses/dag_loss.py``) implements the defaults only: ``number-random``
    with forced emission."""
    p_schedule: str = "0.5:0.1@100k"
    strategy: Optional[str] = "number-random"
    no_force_emit: bool = False


@dataclass(frozen=True)
class TrainingConfig:
    """Adam + inverse-sqrt schedule + clipping, and the joint S2ST step's
    loss weight, feature strategy (``expect`` | ``argmax``) and DAG
    freezing (frozen while step <= ``dag_freezing_steps``; -1 never)."""
    lr: float = 5e-4
    warmup_updates: int = 10000
    warmup_init_lr: float = 1e-7
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    update_freq: int = 1
    seed: int = 1
    glat: GlatConfig = field(default_factory=GlatConfig)
    tts_loss_weight: float = 5.0
    dag_freezing_steps: int = -1
    training_strategy: str = "expect"


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def from_dict(cls, data: Dict[str, Any]):
    """Rebuild a (nested) config dataclass from a plain dict (e.g. YAML);
    keys the dataclass lacks are ignored, lists become tuples."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        tp = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(tp) and isinstance(v, dict):
            v = from_dict(tp, v)
        elif isinstance(v, list):
            v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
        kwargs[f.name] = v
    return cls(**kwargs)
