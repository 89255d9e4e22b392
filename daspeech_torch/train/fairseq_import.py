"""Load released PyTorch reference checkpoints (fairseq ``.pt`` files and
hifi-gan generators) straight into the port's modules.

Counterpart of ``daspeech_tpu/train/torch_import.py``: each ``import_*``
maps a reference ``state_dict`` onto the port's ``state_dict`` names. The
port's modules keep the reference's tensor layouts (``nn.Linear``,
``nn.Conv1d``, ``nn.ConvTranspose1d``), so most tensors are copied as they
are; what changes:

- weight-norm (g, v) pairs are folded into plain weights,
  w = g * v / ||v|| over every dim but 0 (the reference itself removes
  weight norm for inference, ``hifi-gan/models.py:118-125``);
- the Conformer's pointwise convs ``[out, in, 1]`` become ``nn.Linear``
  weights ``[out, in]``;
- the names: ``encoder.conformer_layers.N`` -> ``encoder.layers.N``,
  ``subsample.conv_layers`` -> ``subsample.conv``, the decoder's ``fc1`` /
  ``fc2`` -> ``ffn.fc1`` / ``ffn.fc2``, FastSpeech 2's
  ``encoder_fft_layers`` -> ``encoder_fft``, ``ffn.ffn.0`` / ``ffn.ffn.2``
  -> ``ffn.conv1`` / ``ffn.conv2``, the variance predictors' ``conv1.0`` ->
  ``conv1``, and the S2S model's DAG under ``dag.``;
- the 256-wide encoder feeds the 512-wide decoder's cross-attention through
  ``enc_proj`` (an identity pad) and k/v weights zero-padded to 512 inputs:
  an exact reparameterization of fairseq's kdim/vdim cross-attention, kept
  from the JAX package's structure (:func:`pad_cross_attention_kv`).

Values are computed as the JAX package computes them (the weight-norm fold
in numpy float32), so both packages load the same bits.
"""

from __future__ import annotations

import pickle
import sys
from typing import Any, Dict

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(x), dtype=np.float32))


def load_pt(path) -> Dict[str, Any]:
    """``torch.load`` of a reference checkpoint on the CPU. The safe
    (``weights_only``) loader first; released DASpeech/fairseq checkpoints
    pickle argparse/omegaconf objects beside the state dict, which it
    rejects with ``UnpicklingError``: for that error only, retry with a full
    unpickle and a warning (anything else propagates)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        print(f"WARNING: {path} rejected by the safe (weights_only) loader; "
              "retrying with full unpickling — only do this for checkpoints "
              "you trust", file=sys.stderr)
        return torch.load(path, map_location="cpu", weights_only=False)


def fold_weight_norm(sd: Dict[str, Any], prefix: str) -> np.ndarray:
    """w = g * v / ||v|| with the norm over all dims except 0
    (torch ``weight_norm`` default dim=0)."""
    g = _np(sd[f"{prefix}.weight_g"])
    v = _np(sd[f"{prefix}.weight_v"])
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def import_hifigan(sd: Dict[str, Any], cfg) -> Tensors:
    """hifi-gan ``Generator.state_dict()`` (weight-normed) -> the
    ``state_dict`` of :class:`daspeech_torch.models.HiFiGANGenerator`."""
    out: Tensors = {}

    def conv(prefix):
        out[f"{prefix}.weight"] = _t(fold_weight_norm(sd, prefix))
        out[f"{prefix}.bias"] = _t(sd[f"{prefix}.bias"])

    conv("conv_pre")
    conv("conv_post")
    for i in range(len(cfg.upsample_rates)):
        conv(f"ups.{i}")
    num_kernels = len(cfg.resblock_kernel_sizes)
    for n in range(len(cfg.upsample_rates) * num_kernels):
        for j in range(len(cfg.resblock_dilation_sizes[n % num_kernels])):
            if cfg.resblock == "1":
                conv(f"resblocks.{n}.convs1.{j}")
                conv(f"resblocks.{n}.convs2.{j}")
            else:
                conv(f"resblocks.{n}.convs.{j}")
    return out


def _copy(out: Tensors, dst: str, sd: Dict[str, Any], src: str,
          bias: bool = True) -> None:
    """``dst.weight`` (and ``dst.bias`` when the source has one) from
    ``src``."""
    out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
    if bias and f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])


def _mha(out, dst, sd, src):
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _copy(out, f"{dst}.{name}", sd, f"{src}.{name}")


def import_fastspeech2(sd: Dict[str, Any], cfg,
                       prefix: str = "encoder") -> Tensors:
    """fairseq ``FastSpeech2Encoder``/``FastSpeech2EncoderNoEmb`` state dict
    -> the ``state_dict`` of :class:`...fastspeech2.FastSpeech2Encoder`.

    ``prefix`` is the reference's module prefix ('encoder' for a standalone
    fastspeech2 checkpoint, 'tts' inside the joint S2S model)."""
    P = lambda s: f"{prefix}.{s}" if prefix else s   # noqa: E731
    out: Tensors = {
        "pos_emb_alpha": _t(sd[P("pos_emb_alpha")]),
        "dec_pos_emb_alpha": _t(sd[P("dec_pos_emb_alpha")]),
    }
    _copy(out, "out_proj", sd, P("out_proj"))
    if P("embed_tokens.weight") in sd:
        out["embed_tokens.weight"] = _t(sd[P("embed_tokens.weight")])
    for side, n in (("encoder", cfg.encoder_layers),
                    ("decoder", cfg.decoder_layers)):
        for i in range(n):
            dst, src = f"{side}_fft.{i}", P(f"{side}_fft_layers.{i}")
            _mha(out, f"{dst}.self_attn", sd, f"{src}.self_attn")
            _copy(out, f"{dst}.layer_norm", sd, f"{src}.layer_norm")
            _copy(out, f"{dst}.ffn.conv1", sd, f"{src}.ffn.ffn.0")
            _copy(out, f"{dst}.ffn.conv2", sd, f"{src}.ffn.ffn.2")
            _copy(out, f"{dst}.ffn.layer_norm", sd, f"{src}.ffn.layer_norm")
    va = P("var_adaptor")
    for vp in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        dst, src = f"var_adaptor.{vp}", f"{va}.{vp}"
        _copy(out, f"{dst}.conv1", sd, f"{src}.conv1.0")
        _copy(out, f"{dst}.ln1", sd, f"{src}.ln1")
        _copy(out, f"{dst}.conv2", sd, f"{src}.conv2.0")
        _copy(out, f"{dst}.ln2", sd, f"{src}.ln2")
        _copy(out, f"{dst}.proj", sd, f"{src}.proj")
    for name in ("embed_pitch", "embed_energy"):
        out[f"var_adaptor.{name}.weight"] = _t(sd[f"{va}.{name}.weight"])
    return out


def import_conformer_layer(sd: Dict[str, Any], src: str) -> Tensors:
    """One fairseq ``ConformerEncoderLayer`` (espnet rel_pos attention) ->
    the ``state_dict`` of :class:`...conformer.ConformerEncoderLayer`."""
    out: Tensors = {}
    for f in ("ffn1", "ffn2"):
        for name in ("layer_norm", "w_1", "w_2"):
            _copy(out, f"{f}.{name}", sd, f"{src}.{f}.{name}")
    _copy(out, "self_attn_layer_norm", sd, f"{src}.self_attn_layer_norm")
    for name in ("linear_q", "linear_k", "linear_v", "linear_out",
                 "linear_pos"):
        _copy(out, f"self_attn.{name}", sd, f"{src}.self_attn.{name}")
    for name in ("pos_bias_u", "pos_bias_v"):
        out[f"self_attn.{name}"] = _t(sd[f"{src}.self_attn.{name}"])
    cm = f"{src}.conv_module"
    _copy(out, "conv_module.layer_norm", sd, f"{cm}.layer_norm")
    for name in ("pointwise_conv1", "pointwise_conv2"):     # [out, in, 1]
        out[f"conv_module.{name}.weight"] = _t(
            _np(sd[f"{cm}.{name}.weight"])[:, :, 0])
    out["conv_module.depthwise_conv.weight"] = _t(
        sd[f"{cm}.depthwise_conv.weight"])
    bn = f"{cm}.batch_norm"
    for name in ("weight", "bias", "running_mean", "running_var"):
        out[f"conv_module.batch_norm.{name}"] = _t(sd[f"{bn}.{name}"])
    _copy(out, "final_layer_norm", sd, f"{src}.final_layer_norm")
    return out


def import_conformer_encoder(sd: Dict[str, Any], num_layers: int,
                             prefix: str = "encoder") -> Tensors:
    """Full ``S2TConformerEncoder`` state dict -> the ``state_dict`` of
    :class:`...conformer.ConformerEncoder`."""
    P = lambda s: f"{prefix}.{s}" if prefix else s   # noqa: E731
    out: Tensors = {}
    _copy(out, "linear", sd, P("linear"))
    for i in range(2):
        _copy(out, f"subsample.conv.{i}", sd, P(f"subsample.conv_layers.{i}"))
    for i in range(num_layers):
        for k, v in import_conformer_layer(
                sd, P(f"conformer_layers.{i}")).items():
            out[f"layers.{i}.{k}"] = v
    return out


def import_dag_decoder(sd: Dict[str, Any], num_layers: int,
                       prefix: str = "decoder",
                       tied_embeddings: bool = True) -> Tensors:
    """``GlatLinkDecoder`` state dict (``s2t_conformer_dag.py:437-477`` on a
    fairseq ``NATransformerDecoder``) -> the ``state_dict`` of
    :class:`daspeech_torch.models.dag_model.GlatLinkDecoder`: embeddings,
    the non-causal layers, the link predictor and the untied output
    projection when present. The NAT base class's unused ``embed_length``
    head is skipped."""
    P = lambda s: f"{prefix}.{s}" if prefix else s   # noqa: E731
    out: Tensors = {}
    for name in ("embed_tokens", "embed_positions"):
        out[f"{name}.weight"] = _t(sd[P(f"{name}.weight")])
    for name in ("query_linear", "key_linear", "gate_linear"):
        _copy(out, name, sd, P(name))
    if P("link_positional.weight") in sd:
        out["link_positional.weight"] = _t(sd[P("link_positional.weight")])
    if not tied_embeddings and P("output_projection.weight") in sd:
        _copy(out, "output_projection", sd, P("output_projection"))
    for i in range(num_layers):
        dst, src = f"layers.{i}", P(f"layers.{i}")
        for attn in ("self_attn", "encoder_attn"):
            _mha(out, f"{dst}.{attn}", sd, f"{src}.{attn}")
            _copy(out, f"{dst}.{attn}_layer_norm", sd,
                  f"{src}.{attn}_layer_norm")
        _copy(out, f"{dst}.ffn.fc1", sd, f"{src}.fc1")
        _copy(out, f"{dst}.ffn.fc2", sd, f"{src}.fc2")
        _copy(out, f"{dst}.final_layer_norm", sd, f"{src}.final_layer_norm")
    return out


def pad_cross_attention_kv(dec: Tensors, dec_layers: int, enc_dim: int,
                           dec_dim: int) -> Tensors:
    """Zero-pad each layer's cross-attention k/v weights from ``enc_dim``
    to ``dec_dim`` input columns (in place) and return the matching
    identity-pad ``enc_proj`` (``torch_import.py:289-305``)."""
    for i in range(dec_layers):
        for name in ("k_proj", "v_proj"):
            key = f"layers.{i}.encoder_attn.{name}.weight"
            w = dec[key]                                 # [dec_dim, enc_dim]
            padded = torch.zeros((w.shape[0], dec_dim), dtype=w.dtype)
            padded[:, :enc_dim] = w
            dec[key] = padded
    eye = torch.zeros((dec_dim, enc_dim), dtype=torch.float32)
    eye[:enc_dim, :enc_dim] = torch.eye(enc_dim)
    return {"weight": eye, "bias": torch.zeros((dec_dim,))}


def import_s2t_conformer_dag(sd: Dict[str, Any], enc_layers: int,
                             dec_layers: int,
                             tied_embeddings: bool = True) -> Tensors:
    """Full ``S2TConformerDAGModel`` ``model`` state dict -> the
    ``state_dict`` of :class:`...dag_model.S2TConformerDAG` (the stage-1
    checkpoint loaded by ``s2s_conformer_dag_fastspeech2.py:66-70``). The
    widths come from the weights themselves."""
    out = {f"encoder.{k}": v for k, v in
           import_conformer_encoder(sd, enc_layers, "encoder").items()}
    dec = import_dag_decoder(sd, dec_layers, "decoder", tied_embeddings)
    enc_dim = _np(sd["encoder.linear.weight"]).shape[0]
    dec_dim = _np(sd["decoder.embed_tokens.weight"]).shape[1]
    if enc_dim != dec_dim:
        proj = pad_cross_attention_kv(dec, dec_layers, enc_dim, dec_dim)
        out.update({f"enc_proj.{k}": v for k, v in proj.items()})
    out.update({f"decoder.{k}": v for k, v in dec.items()})
    return out


def import_s2s_daspeech(sd: Dict[str, Any], enc_layers: int, dec_layers: int,
                        tts_cfg, tied_embeddings: bool = True) -> Tensors:
    """Full ``S2SConformerDAGFastSpeech2Model`` ``model`` state dict -> the
    ``state_dict`` of :class:`...s2s_model.S2SConformerDAGFastSpeech2`
    (released DASpeech .pt layout: encoder./decoder./adaptor./tts.* —
    ``s2s_conformer_dag_fastspeech2.py:43-100``)."""
    out = {f"dag.{k}": v for k, v in import_s2t_conformer_dag(
        sd, enc_layers, dec_layers, tied_embeddings).items()}
    for name in ("fc1", "fc2"):
        _copy(out, f"adaptor.{name}", sd, f"adaptor.{name}")
    out.update({f"tts.{k}": v for k, v in
                import_fastspeech2(sd, tts_cfg, prefix="tts").items()})
    return out
