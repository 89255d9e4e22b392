"""Carry the JAX package's weights into the port's modules.

The port's modules mirror the flax module tree name for name, so a flax
variable path maps to a torch attribute path: ``layers_3`` / ``conv0``
become index 3 / 0 of the ModuleList ``layers`` / ``conv`` when no attribute
of the flax name exists. Each leaf is converted by the type of the torch
module that owns it, following the inverses of
``daspeech_tpu/train/torch_import.py:42-55``:

- Dense ``kernel [in, out]`` -> ``nn.Linear.weight [out, in]``;
- Conv ``kernel [k, in, out]`` -> ``nn.Conv1d.weight [out, in, k]`` (the
  depthwise ``[k, 1, C]`` -> ``[C, 1, k]`` and a grouped ``[k, in/g, out]``
  -> ``[out, in/g, k]`` are the same transpose);
- 2D Conv ``kernel [kh, kw, in, out]`` (HWIO) -> ``nn.Conv2d.weight
  [out, in, kh, kw]`` (OIHW);
- ``ConvTranspose1dTorch`` ``kernel [k, in, out]`` ->
  ``nn.ConvTranspose1d.weight [in, out, k]``;
- LayerNorm / BatchNorm ``scale`` -> ``weight``; BatchNorm ``mean``/``var``
  (``batch_stats``) -> ``running_mean``/``running_var``;
- Embed ``embedding`` -> ``nn.Embedding.weight``; bare params keep their name;
- the vocoder's ``quant`` collection (each int8 site's activation amax,
  ``hifigan.py:334-353``) -> the generator's amax buffers of the same names.

The port keeps the JAX structure where it differs from fairseq: ``enc_proj``
(256 -> 512) and the 512-wide cross-attention k/v inputs.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from daspeech_torch.config import to_dict
from daspeech_torch.models.dag_model import S2TConformerDAG
from daspeech_torch.models.fastspeech2 import FastSpeech2Encoder
from daspeech_torch.models.hifigan import HiFiGANGenerator
from daspeech_torch.models.hifigan_discriminators import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from daspeech_torch.models.s2s_model import S2SConformerDAGFastSpeech2
from daspeech_torch.models.s2s_multidecoder import S2SMultiDecoderModel
from daspeech_torch.models.tts_transformer import TTSTransformer

_INDEXED = re.compile(r"^(.*?)_?(\d+)$")


def _leaves(tree: Dict[str, Any], prefix=()) -> Iterator[Tuple[tuple, Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _resolve(module: nn.Module, name: str) -> nn.Module:
    if hasattr(module, name):
        return getattr(module, name)
    m = _INDEXED.match(name)
    if m and isinstance(getattr(module, m.group(1), None), nn.ModuleList):
        return getattr(module, m.group(1))[int(m.group(2))]
    raise KeyError(f"{type(module).__name__} has no submodule for {name!r}")


def _convert(owner: nn.Module, leaf: str, value: np.ndarray):
    """(torch attribute name, tensor) for one flax leaf of ``owner``."""
    x = np.asarray(value, dtype=np.float32)
    if leaf == "kernel":
        if isinstance(owner, nn.ConvTranspose1d):
            return "weight", np.transpose(x, (1, 2, 0))
        if isinstance(owner, nn.Conv1d):
            return "weight", np.transpose(x, (2, 1, 0))
        if isinstance(owner, nn.Conv2d):
            return "weight", np.transpose(x, (3, 2, 0, 1))
        if isinstance(owner, nn.Linear):
            return "weight", x.T
    elif leaf == "scale":
        return "weight", x
    elif leaf == "embedding":
        return "weight", x
    elif leaf in ("mean", "var"):
        return f"running_{leaf}", x
    return leaf, x


def load_flax_(module: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Copy a flax ``{"params", "batch_stats", "quant"}`` tree (nested dicts
    of numpy arrays) into ``module`` in place; every port tensor of its
    state dict must be covered."""
    loaded = set()
    for collection in ("params", "batch_stats", "quant"):
        for path, value in _leaves(variables.get(collection, {})):
            owner = module
            for name in path[:-1]:
                owner = _resolve(owner, name)
            attr, x = _convert(owner, path[-1], value)
            target = getattr(owner, attr)
            if tuple(target.shape) != x.shape:
                raise ValueError(f"{'/'.join(path)}: flax {x.shape} -> "
                                 f"{type(owner).__name__}.{attr} "
                                 f"{tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.tensor(x))
            loaded.add(id(target))
    missing = [n for n, t in module.state_dict(keep_vars=True).items()
               if id(t) not in loaded]
    if missing:
        raise KeyError(f"flax tree does not cover {missing}")
    return module


def from_flax(variables: Dict[str, Any], cfg,
              device="cuda") -> S2SConformerDAGFastSpeech2:
    """The two-pass S2ST model with the JAX package's weights, on ``device``
    (the card unless the caller asks for the CPU), in eval mode."""
    return load_flax_(S2SConformerDAGFastSpeech2(cfg),
                      variables).to(device).eval()


def s2s_from_flax(variables: Dict[str, Any], cfg,
                  device="cuda") -> S2SConformerDAGFastSpeech2:
    """The two-pass S2ST model for joint training: the JAX package's
    weights (DAG, adaptor, FastSpeech 2) and BatchNorm statistics, on
    ``device``, in train mode; a call given a generator is a training
    pass."""
    return load_flax_(S2SConformerDAGFastSpeech2(cfg),
                      variables).to(device).train()


def fs2_from_flax(variables: Dict[str, Any], cfg, vocab_size: int,
                  pad: int = 1, device="cuda") -> FastSpeech2Encoder:
    """The token-input FastSpeech 2 of TTS pretraining (``cfg`` a
    ``FastSpeech2Config``; ``embed_tokens`` of ``vocab_size`` rows) with
    the JAX package's weights, on ``device``, in train mode."""
    return load_flax_(FastSpeech2Encoder(cfg, vocab_size, pad),
                      variables).to(device).train()


def tts_transformer_from_flax(variables: Dict[str, Any], cfg,
                              vocab_size: int, pad: int = 1,
                              device="cuda") -> TTSTransformer:
    """The AR Transformer-TTS (``cfg`` a ``TTSTransformerConfig``) with the
    JAX package's weights (and the Postnet's BatchNorm statistics), on
    ``device``, in eval mode; a call given a generator is a training
    pass."""
    return load_flax_(TTSTransformer(vocab_size, pad, **to_dict(cfg)),
                      variables).to(device).eval()


def multidecoder_from_flax(variables: Dict[str, Any], cfg, vocab,
                           device="cuda") -> S2SMultiDecoderModel:
    """The two-pass AR S2ST model (``cfg`` a ``MultiDecoderConfig``,
    ``vocab`` the ``VocabConfig``) with the JAX package's weights and the
    Conformer's BatchNorm statistics, on ``device``, in eval mode; a call
    given a generator is a training pass."""
    return load_flax_(S2SMultiDecoderModel(
        vocab.size, vocab.pad, vocab.bos, vocab.eos, **to_dict(cfg)),
        variables).to(device).eval()


def dag_from_flax(variables: Dict[str, Any], cfg,
                  device="cuda") -> S2TConformerDAG:
    """The S2TT Conformer-DAG model (``cfg`` a ``DAGModelConfig``) with the
    JAX package's weights and BatchNorm statistics, on ``device``, in eval
    mode; a forward given a generator is a training pass."""
    return load_flax_(S2TConformerDAG(cfg), variables).to(device).eval()


def vocoder_from_flax(variables: Dict[str, Any], cfg, device="cuda",
                      **serving) -> HiFiGANGenerator:
    """HiFi-GAN (ResBlock type 1 or 2) with the JAX package's weights, on
    ``device``, in eval mode; ``serving`` holds the generator's serving
    arguments (``fused_mrf``, ``mrf_tile``, ``serve_chunk``, ``dtype``,
    ``quant_int8``, ``quant_skip_levels``, ``calibrate``,
    ``serve_calib_batches``). The flax ``params`` tree is the same for
    ``fold_to=0`` and ``fold_to=128`` and in every serving mode; a
    ``quant`` collection (an int8 vocoder's calibrated amax per site)
    is carried into the amax buffers, so that both packages quantize
    with the same frozen scales."""
    return load_flax_(HiFiGANGenerator(cfg, **serving),
                      variables).to(device).eval()


def discriminators_from_flax(variables: Dict[str, Any], device="cuda"
                             ) -> Dict[str, nn.Module]:
    """The vocoder's discriminators ``{"mpd": MultiPeriodDiscriminator,
    "msd": MultiScaleDiscriminator}`` with the JAX package's weights
    (``variables`` as the JAX trainer's ``disc_params``: ``{"mpd":
    {"params": ...}, "msd": {"params": ...}}``), on ``device``, in train
    mode."""
    return {"mpd": load_flax_(MultiPeriodDiscriminator(),
                              variables["mpd"]).to(device).train(),
            "msd": load_flax_(MultiScaleDiscriminator(),
                              variables["msd"]).to(device).train()}
