"""Seeded weights for the benchmark's models, made on the device.

The weights are a flat state dict keyed by the checkpoint's parameter names,
so that the program under test and the plain reference load the same
tensors. :func:`random_weights` draws them from one ``torch.Generator`` on
the device in one call; the ``shape_*`` and ``set_*`` functions then give
the random model what a trained one has where random weights would make
the served output degenerate:

- :func:`shape_random_decoder_`: a DAG decoder with random weights decodes
  every utterance to one or two tokens (the graph's inputs are all
  ``<unk>``, so every vertex predicts the same token, and the links jump
  from the first vertex to the last). The ``<unk>`` row of the tied token
  embedding is zeroed and the learned positions are drawn N(0, 1), so that
  each vertex starts from a state of its own. The self-attention, the
  cross-attention and the FFN add to every vertex nearly the same vector
  (random attention is nearly uniform, random encoder states are nearly
  constant over time, and GELU's outputs have a mean), which would make
  one token the best at most vertices and collapse the walk's repeats; so
  their output projections are scaled by 1/4. The link predictor prefers
  hops of ``HOP`` vertices: the first ``2 n_freq`` channels of the link
  positions hold cos/sin(w_f v) of the vertex index v (periods 8 to 2048),
  and each head's query rows rotate them by ``w_f HOP``, so that
  q_i · k_j peaks at j = i + HOP and falls by ``SHARPNESS`` one vertex
  either side. The walk then emits a token every ``HOP`` vertices: a
  phoneme every 80 ms of speech at a graph of half the fbank frames
  (``benchmark/tests/test_benchmark_rate.py`` holds it to 12.5 a second
  within a fifth, over seeds and lengths);
- :func:`set_durations_`: random weights predict durations of about 0
  frames; the duration predictor's projection is zeroed and its bias set to
  log(1 + frames), so that every token lasts ``frames`` mel frames;
- :func:`set_variance_`: the pitch and energy predictors' outputs are
  scaled by 1/10 and centred in the middle of their second bucket, so that
  no prediction lies within rounding of a bucket edge (an edge at 0 would
  otherwise fall inside the spread of random predictions).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import torch

STD = 0.05
HOP = 4
SHARPNESS = 2.0
# decoder sublayers whose outputs are nearly the same at every vertex
SHARED_OUT = (".self_attn.out_proj.weight", ".encoder_attn.out_proj.weight",
              ".ffn.fc2.weight")
_NORM = re.compile(r"(norm|^ln\d+)$")


def _kind(name: str) -> str:
    """"one", "zero" or "rand": norm scales, running variances and alphas
    are 1; biases, running means and calibration buffers 0."""
    owner, _, leaf = name.rpartition(".")
    owner_leaf = owner.rpartition(".")[2]
    if (leaf == "running_var" or "alpha" in leaf
            or (leaf == "weight" and _NORM.search(owner_leaf))):
        return "one"
    if leaf in ("bias", "running_mean") or leaf.endswith("_amax"):
        return "zero"
    return "rand"


def random_weights(spec: List[Tuple[str, Tuple[int, ...]]], seed: int,
                   device) -> Tuple[Dict[str, torch.Tensor],
                                    torch.Generator]:
    """Every ``(name, shape)`` of ``spec``: N(0, STD) from one draw of a
    generator on ``device`` seeded with ``seed``, or the constant of its
    kind; and the generator, for later draws."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for n, s in spec if _kind(n) == "rand"]
    flat = torch.randn(sum(sizes), generator=gen, device=device) * STD
    parts = iter(flat.split(sizes))
    out = {}
    for name, shape in spec:
        kind = _kind(name)
        if kind == "rand":
            out[name] = next(parts).view(shape)
        else:
            out[name] = torch.full(shape, 1.0 if kind == "one" else 0.0,
                                   device=device)
    return out, gen


def shape_random_decoder_(sd: Dict[str, torch.Tensor], prefix: str,
                          num_heads: int, unk: int, pad: int,
                          gen: torch.Generator) -> None:
    """The decoder shaping of the module docstring, in place."""
    E = sd[prefix + ".embed_positions.weight"]
    D = E.shape[1]
    dk = D // num_heads
    n_freq = min(16, dk // 4)
    dev = E.device
    w = 2 * math.pi / (8.0 * 256.0 ** (torch.arange(n_freq, device=dev)
                                       / (n_freq - 1)))
    a = math.sqrt(SHARPNESS * math.sqrt(dk)
                  / float((1 - torch.cos(w)).sum()))
    with torch.no_grad():
        sd[prefix + ".embed_tokens.weight"][unk] = 0
        E.copy_(torch.randn(E.shape, generator=gen, device=dev))
        for name, t in sd.items():
            if name.startswith(prefix + ".layers.") and name.endswith(
                    SHARED_OUT):
                t.mul_(0.25)
        P = sd[prefix + ".link_positional.weight"]   # row = vertex + pad + 1
        v = (torch.arange(P.shape[0], device=dev) - (pad + 1)).float()
        P[:, 0:2 * n_freq:2] = torch.cos(v[:, None] * w)
        P[:, 1:2 * n_freq:2] = torch.sin(v[:, None] * w)
        Wq, bq = sd[prefix + ".query_linear.weight"], sd[
            prefix + ".query_linear.bias"]
        Wk, bk = sd[prefix + ".key_linear.weight"], sd[
            prefix + ".key_linear.bias"]
        c, s = a * torch.cos(w * HOP), a * torch.sin(w * HOP)
        f = torch.arange(n_freq, device=dev)
        for h in range(num_heads):
            rc, rs = h * dk + 2 * f, h * dk + 2 * f + 1
            pc, ps = D + 2 * f, D + 2 * f + 1
            for W, b in ((Wq, bq), (Wk, bk)):
                W[h * dk:h * dk + 2 * n_freq] = 0
                b[h * dk:h * dk + 2 * n_freq] = 0
            Wq[rc, pc], Wq[rc, ps] = c, -s           # cos(w (v + HOP))
            Wq[rs, pc], Wq[rs, ps] = s, c            # sin(w (v + HOP))
            Wk[rc, pc], Wk[rs, ps] = a, a            # cos(w v), sin(w v)


def set_durations_(sd: Dict[str, torch.Tensor], prefix: str,
                   frames: int) -> None:
    """Every token lasts ``frames`` mel frames."""
    with torch.no_grad():
        sd[prefix + ".duration_predictor.proj.weight"].zero_()
        sd[prefix + ".duration_predictor.proj.bias"].fill_(
            math.log(1.0 + frames))


def set_variance_(sd: Dict[str, torch.Tensor], prefix: str,
                  tts: dict) -> None:
    """Pitch and energy predictions at a tenth of their random spread,
    centred in their second bucket."""
    n = tts["var_pred_n_bins"] - 1
    with torch.no_grad():
        for what, lo, hi in (("pitch", tts["pitch_min"], tts["pitch_max"]),
                             ("energy", tts["energy_min"],
                              tts["energy_max"])):
            width = (hi - lo) / (n - 1)
            sd[f"{prefix}.{what}_predictor.proj.weight"].mul_(0.1)
            sd[f"{prefix}.{what}_predictor.proj.bias"].fill_(lo + width / 2)


def s2st_weights(spec, seed: int, device, model_cfg: dict,
                 frames_per_token: int) -> Dict[str, torch.Tensor]:
    """The two-pass model's weights: random, with the decoder, durations
    and variance predictors shaped as above."""
    sd, gen = random_weights(spec, seed, device)
    dag = model_cfg["dag"]
    shape_random_decoder_(sd, "dag.decoder", dag["decoder"]["num_heads"],
                          dag["vocab"]["unk"], dag["vocab"]["pad"], gen)
    set_durations_(sd, "tts.var_adaptor", frames_per_token)
    set_variance_(sd, "tts.var_adaptor", model_cfg["tts"])
    return sd


def vocoder_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """HiFi-GAN's weights, random from their own seed."""
    return random_weights(spec, seed, device)[0]
