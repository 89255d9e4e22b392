"""Shared set-up of the DAG loss's memory-variant tests
(``tests/test_torch_dag_banded.py``, ``tests/test_torch_fused_vocab.py``):
small S2TT and joint models with a bounded transition length, their
batches, and the JAX criterion beside the port's on JAX's own glance
draws, dropout 0."""

import math

import numpy as np
import torch

import jax
import jax.numpy as jnp

from daspeech_torch import convert
from daspeech_torch.losses import dag_loss as tloss
from daspeech_torch.losses import s2s_loss as ts2s
from daspeech_tpu.core.config import (ConformerConfig, DAGDecoderConfig,
                                      DAGModelConfig, FastSpeech2Config,
                                      S2SModelConfig, VocabConfig)
from daspeech_tpu.losses import dag_loss as jloss
from daspeech_tpu.losses import s2s_loss as js2s
from daspeech_tpu.models import dag_model as jdag
from daspeech_tpu.models import s2s_model as jmodel
from test_torch_models import random_variables

W_BAND = 4               # max_transition_length: L = 12 > W + 1
VOCAB = 24
N_BINS = 8
GRAD_TOL = 1e-5          # of each tensor's norm
# a key projection's bias shifts every score of a softmax row alike: its
# exact gradient is 0 and both packages hold rounding noise there; the
# link gates' bias feeds a log-softmax over its own outputs, so its gradient
# sums to 0 exactly, a difference of terms of its kernel's size
# (``tests/test_torch_train_cli.py``'s SHIFT_BIASES)
SHIFT_BIASES = ("k_proj/bias", "linear_k/bias", "key_linear/bias",
                "gate_linear/bias")


def dag_cfg(shared: bool = True) -> DAGModelConfig:
    return DAGModelConfig(
        vocab=VocabConfig(size=VOCAB),
        encoder=ConformerConfig(embed_dim=16, ffn_dim=32, num_layers=1,
                                num_heads=2, dropout=0.0, attn_dropout=0.0,
                                depthwise_kernel_size=7, conv_channels=8),
        decoder=DAGDecoderConfig(embed_dim=16, ffn_dim=32, num_layers=1,
                                 num_heads=2, dropout=0.0, attn_dropout=0.0,
                                 activation_dropout=0.0,
                                 max_target_positions=64,
                                 share_input_output_embed=shared,
                                 max_transition_length=W_BAND))


def s2s_cfg() -> S2SModelConfig:
    return S2SModelConfig(
        dag=dag_cfg(),
        tts=FastSpeech2Config(encoder_layers=1, encoder_embed_dim=16,
                              encoder_heads=2, decoder_layers=1,
                              decoder_embed_dim=16, decoder_heads=2,
                              fft_hidden_dim=32, var_pred_hidden_dim=16,
                              var_pred_n_bins=N_BINS, dropout=0.0,
                              attention_dropout=0.0, var_pred_dropout=0.0,
                              pitch_min=-3.0, pitch_max=3.0,
                              energy_min=-3.0, energy_max=3.0),
        adaptor_ffn_dim=24, adaptor_dropout=0.0)


def _bin_centres(rng, lo, hi, shape):
    edges = np.linspace(lo, hi, N_BINS - 1)
    i = rng.integers(0, N_BINS - 2, size=shape)
    return ((edges[i] + edges[i + 1]) / 2).astype(np.float32)


def batch(cfg, seed, B=3, S=24, T=6, M=16):
    """A batch of 3 utterances with graphs of 12, 8 and 4 vertices (L =
    12) and targets of 6, 6 and 4 tokens; the joint model's keys too when
    ``cfg`` is an ``S2SModelConfig``."""
    joint = isinstance(cfg, S2SModelConfig)
    vocab = (cfg.dag if joint else cfg).vocab
    rng = np.random.default_rng(seed)
    lens = np.array([S, S - 8, S - 16][:B], np.int32)
    prev = np.asarray(jdag.initialize_output_tokens(
        jdag.graph_lengths(jnp.asarray(lens), 0.5, 64), S // 2, vocab))
    tgt = rng.integers(4, vocab.size, size=(B, T)).astype(np.int32)
    tgt[:, 0], tgt[:, -1] = vocab.bos, vocab.eos
    tgt[2, T - 2:] = vocab.pad
    tgt[2, T - 3] = vocab.eos
    out = {"fbank": rng.normal(size=(B, S, 80)).astype(np.float32),
           "src_lengths": lens, "prev_output_tokens": prev}
    if not joint:
        out["target"] = tgt
        return out
    durs = rng.integers(1, 4, size=(B, T - 1)).astype(np.int32)
    durs[2, T - 3:] = 0
    tts = cfg.tts
    out.update(target_text=tgt,
               target_audio=rng.normal(size=(B, M, 80)).astype(np.float32),
               target_audio_lengths=np.minimum(durs.sum(1), M).astype(
                   np.int32),
               durations=durs,
               pitches=_bin_centres(rng, tts.pitch_min, tts.pitch_max,
                                    (B, T - 1)),
               energies=_bin_centres(rng, tts.energy_min, tts.energy_max,
                                     (B, T - 1)))
    return out


def setup(joint: bool, seed: int = 0):
    """(cfg, batch, JAX model, variables) of the S2TT or the joint model."""
    cfg = s2s_cfg() if joint else dag_cfg()
    b = batch(cfg, seed)
    fbank, lens = b["fbank"], b["src_lengths"]
    prev = b["prev_output_tokens"]
    if not joint:
        jm = jdag.S2TConformerDAG(cfg)
        return cfg, b, jm, random_variables(jm, seed + 1, fbank, lens, prev)
    jm = jmodel.S2SConformerDAGFastSpeech2(cfg)
    B, T = b["target_text"].shape
    M = b["target_audio"].shape[1]

    def full(m, fbank, lens, prev):
        _, _, feats = m(fbank, lens, prev)
        return m.synthesize(feats[:, :T - 1], jnp.zeros((B, T - 1), bool),
                            M)

    return cfg, b, jm, random_variables(jm, seed + 1, fbank, lens, prev,
                                        method=full)


def torch_batch(b):
    return {k: torch.tensor(x).long() if x.dtype == np.int32
            else torch.tensor(x) for k, x in b.items()}


def glance_draws(key, B, L, joint: bool):
    """The glance draws JAX made: the criterion splits dropout | glat (|
    tts), then ``glat_glance`` splits rand | keep."""
    k_glat = jax.random.split(key, 3 if joint else 2)[1]
    k_rand, k_keep = jax.random.split(k_glat)
    return tloss.GlanceDraws(
        torch.tensor(np.asarray(jax.random.normal(k_rand, (B, L),
                                                  dtype=jnp.float32))),
        torch.tensor(np.asarray(jax.random.uniform(k_keep, (B, L)))))


def jax_value_and_grad(joint, jm, v, b, cfg, p=0.5, key=5, **kw):
    """JAX's criterion: (loss, metrics, grads as numpy trees)."""
    crit = js2s.s2s_dag_fastspeech2_loss if joint else jloss.nat_dag_loss
    vocab = cfg.dag.vocab if joint else cfg.vocab

    def lossf(params):
        return crit(jm, {"params": params, "batch_stats": v["batch_stats"]},
                    {k: jnp.asarray(x) for k, x in b.items()},
                    jax.random.key(key), jnp.float32(p), vocab, **kw)

    (loss, aux), grads = jax.jit(jax.value_and_grad(lossf, has_aux=True))(
        jax.tree.map(jnp.asarray, v["params"]))
    return (float(loss), jax.tree.map(np.asarray, aux["metrics"]),
            jax.tree.map(np.asarray, grads))


def port_value_and_grad(joint, cfg, v, b, p=0.5, key=5, **kw):
    """The port's criterion on JAX's weights and glance draws: (the model
    after backward, loss, metrics)."""
    B, L = b["prev_output_tokens"].shape
    draws = glance_draws(jax.random.key(key), B, L, joint)
    if joint:
        tm = convert.s2s_from_flax(v, cfg, device="cpu")
        loss, metrics = ts2s.s2s_dag_fastspeech2_loss(
            tm, torch_batch(b), torch.Generator(), p, cfg.dag.vocab,
            glat_draws=draws, **kw)
    else:
        tm = convert.dag_from_flax(v, cfg, device="cpu")
        loss, metrics = tloss.nat_dag_loss(tm, torch_batch(b),
                                           torch.Generator(), p, cfg.vocab,
                                           glat_draws=draws, **kw)
    loss.backward()
    return tm, loss.item(), metrics


def assert_grads_match(tm, jgrads, tol=GRAD_TOL):
    """Every parameter's gradient within ``tol`` of its JAX gradient's
    norm; a key projection's and the link gates' bias within ``tol`` of
    their kernel's."""
    kernels = dict(convert._leaves(jgrads))
    n = 0
    for path, want in convert._leaves(jgrads):
        owner = tm
        for name in path[:-1]:
            owner = convert._resolve(owner, name)
        attr, want = convert._convert(owner, path[-1], want)
        got = getattr(owner, attr).grad
        got = torch.zeros(want.shape) if got is None else got
        ref = want
        if "/".join(path).endswith(SHIFT_BIASES):
            ref = kernels[tuple(path[:-1]) + ("kernel",)]
        bar = tol * max(float(np.linalg.norm(ref)), 1e-30)
        err = float((got - torch.tensor(want)).abs().max())
        assert err <= bar, ("/".join(path), err, bar)
        n += 1
    assert n == sum(1 for _ in tm.parameters())


def assert_criterion_matches_jax(joint, kw, p=0.5):
    """The port's criterion against JAX's under the options ``kw``: the
    loss within 1e-5 relative, the DAG loss and the glance's keep rate
    too, every gradient within 1e-5 of its tensor's norm. Returns the
    port's loss."""
    cfg, b, jm, v = setup(joint)
    want, jmetrics, jgrads = jax_value_and_grad(joint, jm, v, b, cfg, p=p,
                                                **kw)
    tm, got, metrics = port_value_and_grad(joint, cfg, v, b, p=p, **kw)
    assert math.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(metrics["dag-loss"].item(),
                               float(jmetrics["dag-loss"]), rtol=1e-5)
    if p > 0:
        assert float(jmetrics["glat_keep"]) > 0          # it glanced
        np.testing.assert_allclose(metrics["glat_keep"].item(),
                                   float(jmetrics["glat_keep"]), rtol=1e-6)
    assert_grads_match(tm, jgrads)
    return got
