"""The port's models in bf16 compute (``dtype=torch.bfloat16``) against the
JAX modules with ``dtype=jnp.bfloat16``, on the CPU at small widths.

Both sides take the recipe's kernel route: JAX's Pallas attention, rel-pos
and link kernels run in interpret mode (their TPU gates opened), the port's
plain bf16 versions. Weights are random from a numpy seed and carried into
the port by ``convert.load_flax_``; inputs are numpy draws.

The bar, for every output: ||port_bf16 - jax_bf16|| <= 2 ||jax_bf16 -
jax_fp32||, with a floor of 1e-6 of ||jax_fp32||. JAX in fp32 and in bf16
differ by the bf16 roundings of every layer; the port rounds at the same
places, so it must sit no farther from JAX's bf16 result than twice that.
Held: a Conformer encoder layer in train mode (BatchNorm on the batch's
valid frames), the S2TT Conformer-DAG model (decoder features, bf16
logits, fp32 links), FastSpeech 2 with gold durations, pitches and
energies, and the two-pass S2S model's adaptor and FastSpeech 2 on the DAG
decoder's features. Dropout is 0 everywhere.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from daspeech_torch import convert
from daspeech_torch.models import conformer as tconf
from daspeech_torch.models import dag_model as tdag
from daspeech_torch.models import fastspeech2 as tfs
from daspeech_torch.models import layers as tlayers
from daspeech_torch.models import s2s_model as tmodel
from daspeech_tpu.core.config import (ConformerConfig, DAGDecoderConfig,
                                      DAGModelConfig, FastSpeech2Config,
                                      S2SModelConfig, VocabConfig)
from daspeech_tpu.models import conformer as jconf
from daspeech_tpu.models import dag_model as jdag
from daspeech_tpu.models import fastspeech2 as jfs
from daspeech_tpu.models import s2s_model as jmodel
from daspeech_tpu.ops import fused_attention as jfa
from daspeech_tpu.ops import fused_links as jfl
from daspeech_tpu.ops import fused_relpos as jfr
from test_torch_models import random_variables

BF16 = torch.bfloat16
FLOOR = 1e-6         # of ||jax_fp32||
N_BINS = 256


@pytest.fixture(autouse=True)
def jax_kernel_route(monkeypatch):
    """JAX's Pallas kernels in interpret mode, taken where the recipe takes
    them on the TPU (attention, rel-pos attention at every length, links)."""
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)
    monkeypatch.setattr(jfr.pl, "pallas_call", patched)
    monkeypatch.setattr(jfl, "INTERPRET", True)
    monkeypatch.setattr(jfa, "available_spmd", lambda: True)
    monkeypatch.setattr(jfr, "available", lambda: True)
    monkeypatch.setattr(jfr, "KERNEL_MIN_T", 1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def bf16_gap(port, jax_bf16, jax_fp32, what=""):
    """(||port - jax_bf16||, 2 ||jax_bf16 - jax_fp32|| floored at FLOOR of
    ||jax_fp32||) over the entries finite in all three."""
    p, b, f = f64(port), f64(jax_bf16), f64(jax_fp32)
    assert p.shape == b.shape == f.shape, (what, p.shape, b.shape, f.shape)
    fin = np.isfinite(b) & np.isfinite(f)
    np.testing.assert_array_equal(np.isfinite(p), np.isfinite(b), what)
    p, b, f = p[fin], b[fin], f[fin]
    return (float(np.linalg.norm(p - b)),
            max(2 * float(np.linalg.norm(b - f)),
                FLOOR * float(np.linalg.norm(f))))


def assert_bf16_bar(port, jax_bf16, jax_fp32, what=""):
    gap, bar = bf16_gap(port, jax_bf16, jax_fp32, what)
    assert gap <= bar, (what, gap, bar)


def _t(x):
    return torch.tensor(np.asarray(x))


def _pad_mask(B, T, n_pad):
    m = np.zeros((B, T), bool)
    m[-1, T - n_pad:] = True
    return m


def test_conformer_layer_train_mode():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 32)).astype(np.float32)
    pad = _pad_mask(2, 12, 3)
    kw = dict(dropout=0.0, depthwise_kernel_size=7, attn_dropout=0.0)
    v = random_variables(jconf.ConformerEncoderLayer(32, 64, 2, **kw), 3, x,
                         pad)

    def run(dtype):
        jm = jconf.ConformerEncoderLayer(32, 64, 2, dtype=dtype, **kw)
        out, upd = jm.apply(v, x, pad, train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.key(0)})
        return out, upd["batch_stats"]

    (want_b, stats_b), (want_f, stats_f) = run(jnp.bfloat16), run(
        jnp.float32)
    assert want_b.dtype == jnp.bfloat16
    tm = convert.load_flax_(tconf.ConformerEncoderLayer(32, 64, 2, 7), v)
    tlayers.set_dtype(tm, BF16)
    got = tm(_t(x), _t(pad), torch.Generator().manual_seed(0))
    assert got.dtype == BF16
    assert_bf16_bar(got, want_b, want_f, "out")
    bn = tm.conv_module.batch_norm
    assert bn.running_mean.dtype == torch.float32
    jb = stats_b["conv_module"]["batch_norm"]
    jf = stats_f["conv_module"]["batch_norm"]
    assert_bf16_bar(bn.running_mean, jb["mean"], jf["mean"], "mean")
    assert_bf16_bar(bn.running_var, jb["var"], jf["var"], "var")


def _dag_cfg():
    return DAGModelConfig(
        vocab=VocabConfig(size=32),
        encoder=ConformerConfig(embed_dim=16, ffn_dim=32, num_layers=1,
                                num_heads=2, dropout=0.0, attn_dropout=0.0,
                                depthwise_kernel_size=7, conv_channels=8),
        decoder=DAGDecoderConfig(embed_dim=32, ffn_dim=64, num_layers=2,
                                 num_heads=2, dropout=0.0, attn_dropout=0.0,
                                 activation_dropout=0.0,
                                 max_target_positions=64))


def test_dag_model_features_logits_and_links():
    """Decoder 32-wide over a 16-wide encoder (``enc_proj`` on), gelu
    decoder FFNs: bf16 features and logits, fp32 links."""
    cfg = _dag_cfg()
    rng = np.random.default_rng(6)
    fbank = rng.normal(size=(2, 40, 80)).astype(np.float32)
    lens = np.array([40, 35], np.int32)
    prev = np.asarray(jdag.initialize_output_tokens(
        jdag.graph_lengths(jnp.asarray(lens), 0.5, 64), 20, cfg.vocab))
    v = random_variables(jdag.S2TConformerDAG(cfg), 7, fbank, lens, prev)
    want = {dt: jdag.S2TConformerDAG(cfg, dtype=dt).apply(v, fbank, lens,
                                                          prev)
            for dt in (jnp.bfloat16, jnp.float32)}
    tm = convert.load_flax_(tdag.S2TConformerDAG(cfg, dtype=BF16), v)
    with torch.no_grad():
        logits, links, feats = tm(_t(fbank), _t(lens), _t(prev))
    assert logits.dtype == BF16 and feats.dtype == BF16
    assert links.dtype == torch.float32
    assert want[jnp.bfloat16][1].dtype == jnp.float32
    for i, (name, got) in enumerate((("logits", logits), ("links", links),
                                     ("features", feats))):
        assert_bf16_bar(got, want[jnp.bfloat16][i], want[jnp.float32][i],
                        name)


def _fs2_cfg():
    return FastSpeech2Config(
        encoder_layers=2, encoder_embed_dim=16, encoder_heads=2,
        decoder_layers=2, decoder_embed_dim=16, decoder_heads=2,
        fft_hidden_dim=32, var_pred_hidden_dim=16, var_pred_n_bins=N_BINS,
        dropout=0.0, attention_dropout=0.0, var_pred_dropout=0.0,
        pitch_min=-3.0, pitch_max=3.0, energy_min=-3.0, energy_max=3.0)


def _bucket_centres(rng, shape, lo=-3.0, hi=3.0):
    edges = np.linspace(lo, hi, N_BINS - 1)
    i = rng.integers(0, N_BINS - 2, size=shape)
    return ((edges[i] + edges[i + 1]) / 2).astype(np.float32)


def test_fastspeech2_with_gold_variances():
    """Gold durations, pitches and energies (at bucket centres): the mel
    and the three predictors."""
    cfg = _fs2_cfg()
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 8, 16)).astype(np.float32)
    pad = _pad_mask(2, 8, 2)
    durs = np.array([[4, 0, 3, 5, 2, 6, 1, 3], [2, 2, 7, 1, 4, 3, 0, 0]],
                    np.int32)
    pitch, energy = _bucket_centres(rng, (2, 8)), _bucket_centres(rng, (2, 8))
    v = random_variables(jfs.FastSpeech2Encoder(cfg), 8, x=x,
                         enc_pad_mask=pad, max_out_len=32)
    want = {dt: jfs.FastSpeech2Encoder(cfg, dtype=dt).apply(
        v, x=x, enc_pad_mask=pad, max_out_len=32, durations=durs,
        pitches=pitch, energies=energy) for dt in (jnp.bfloat16, jnp.float32)}
    tm = convert.load_flax_(tfs.FastSpeech2Encoder(cfg, dtype=BF16), v)
    with torch.no_grad():
        mel, _, lens, log_dur, p_out, e_out = tm(
            _t(x), _t(pad), 32, _t(durs).long(), pitches=_t(pitch),
            energies=_t(energy))
    assert mel.dtype == BF16
    np.testing.assert_array_equal(lens.numpy(),
                                  np.asarray(want[jnp.bfloat16][2]))
    for name, got, i in (("mel", mel, 0), ("log_dur", log_dur, 3),
                         ("pitch", p_out, 4), ("energy", e_out, 5)):
        assert_bf16_bar(got, want[jnp.bfloat16][i], want[jnp.float32][i],
                        name)


def _s2s_cfg():
    return S2SModelConfig(dag=_dag_cfg(), tts=_fs2_cfg(), adaptor_ffn_dim=32,
                          adaptor_dropout=0.0)


def test_s2s_model_synthesizes_from_dag_features():
    """The two-pass model: DAG features (bf16) through the FFN adaptor and
    FastSpeech 2's NoEmb path with gold durations, pitches and energies."""
    cfg = _s2s_cfg()
    rng = np.random.default_rng(9)
    fbank = rng.normal(size=(2, 40, 80)).astype(np.float32)
    lens = np.array([40, 35], np.int32)
    prev = np.asarray(jdag.initialize_output_tokens(
        jdag.graph_lengths(jnp.asarray(lens), 0.5, 64), 20, cfg.dag.vocab))
    L = prev.shape[1]
    fpad = prev == cfg.dag.vocab.pad
    durs = np.where(fpad, 0, rng.integers(1, 3, size=prev.shape)).astype(
        np.int32)
    M = int(durs.sum(1).max())
    pitch = _bucket_centres(rng, (2, L))
    energy = _bucket_centres(rng, (2, L))

    def full(m, fbank, lens, prev):
        _, _, feats = m(fbank, lens, prev)
        return m.synthesize(feats, jnp.asarray(fpad), M,
                            durations=jnp.asarray(durs),
                            pitches=jnp.asarray(pitch),
                            energies=jnp.asarray(energy))

    v = random_variables(jmodel.S2SConformerDAGFastSpeech2(cfg), 10, fbank,
                         lens, prev, method=full)
    want = {dt: jmodel.S2SConformerDAGFastSpeech2(cfg, dtype=dt).apply(
        v, fbank, lens, prev, method=full)
        for dt in (jnp.bfloat16, jnp.float32)}
    tm = convert.load_flax_(tmodel.S2SConformerDAGFastSpeech2(cfg,
                                                              dtype=BF16), v)
    with torch.no_grad():
        _, _, feats = tm(_t(fbank), _t(lens), _t(prev))
        mel, _, mel_lens, log_dur, *_ = tm.synthesize(
            feats, _t(fpad), M, _t(durs).long(), pitches=_t(pitch),
            energies=_t(energy))
    assert mel.dtype == BF16
    np.testing.assert_array_equal(mel_lens.numpy(),
                                  np.asarray(want[jnp.bfloat16][2]))
    assert_bf16_bar(mel, want[jnp.bfloat16][0], want[jnp.float32][0], "mel")
    assert_bf16_bar(log_dur, want[jnp.bfloat16][3], want[jnp.float32][3],
                    "log_dur")
