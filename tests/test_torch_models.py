"""The port's modules (``daspeech_torch/models``, ``decode``) against the
JAX modules they mirror, at small widths on the CPU.

Each test builds the flax module, fills its variable tree with
random values from a numpy seed (so biases, norms and BatchNorm statistics
are not at their trivial init), carries them into the port with
``daspeech_torch.convert.load_flax_``, feeds both the same numpy inputs and
compares in fp32. Tolerances are the bars the JAX package reached against
the original torch code (ROADMAP): Conformer 2e-4, DAG decoder 1e-4,
FastSpeech 2 mel 1e-3, HiFi-GAN waveform 2.5e-4.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daspeech_torch import convert
from daspeech_torch.decode import dag_decode as tdec
from daspeech_torch.models import conformer as tconf
from daspeech_torch.models import dag_model as tdag
from daspeech_torch.models import fastspeech2 as tfs
from daspeech_torch.models import layers as tlayers
from daspeech_tpu.core.config import (
    ConformerConfig, DAGDecoderConfig, DAGModelConfig, FastSpeech2Config,
    HiFiGANConfig, VocabConfig)
from daspeech_tpu.decode import dag_decode as jdec
from daspeech_tpu.models import conformer as jconf
from daspeech_tpu.models import dag_model as jdag
from daspeech_tpu.models import fastspeech2 as jfs
from daspeech_tpu.models import hifigan as jhg
from daspeech_tpu.models import layers as jlayers
from daspeech_tpu.ops import fused_links as jfl


@pytest.fixture(autouse=True, scope="module")
def one_thread_no_grad():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(n)


def random_variables(module, seed, *args, scale=1.0, **kwargs):
    """A numpy variable tree for flax ``module`` with random leaves, shaped
    by ``jax.eval_shape`` of its init (no init compute): weights
    N(0, scale / sqrt(fan_in)), biases and BatchNorm means N(0, 0.1),
    norm scales 1 + N(0, 0.1), BatchNorm variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), *args, **kwargs))

    def leaf(name, shape):
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        if name in ("scale",) or name.endswith("alpha"):
            return 1.0 + rng.normal(0, 0.1, shape)
        if len(shape) < 2 or name in ("bias", "mean"):
            return rng.normal(0, 0.1, shape)
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(0, scale / math.sqrt(fan_in), shape)

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items")
                else leaf(k, v.shape).astype(np.float32)
                for k, v in tree.items()}

    return walk(shapes)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _pad_mask(B, T, n_pad):
    m = np.zeros((B, T), bool)
    m[-1, T - n_pad:] = True
    return m


@pytest.mark.parametrize("name", [
    "VocabConfig", "ConformerConfig", "DAGDecoderConfig", "DecodeConfig",
    "FastSpeech2Config", "HiFiGANConfig", "DAGModelConfig",
    "S2SModelConfig", "GlatConfig", "TrainingConfig",
    "TTSTransformerConfig", "MultiDecoderConfig"])
def test_config_mirrors_jax(name):
    """Every field of the port's config has the JAX field's name and
    default, so the recipe's width is the same in both packages."""
    import dataclasses

    from daspeech_torch import config as tcfg
    from daspeech_tpu.core import config as jcfg

    def check(got, want, path):
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(g):
                check(g, w, f"{path}.{f.name}")
            else:
                assert g == w, f"{path}.{f.name}: {g!r} != {w!r}"

    check(getattr(tcfg, name)(), getattr(jcfg, name)(), name)


class TestLayers:
    def test_mha_with_an_all_padded_row(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(3, 6, 16)).astype(np.float32)
        kpm = _pad_mask(3, 6, 2)
        kpm[0] = True                      # every key padded: uniform row
        jm = jlayers.MultiHeadAttention(16, 2, 0.0)
        v = random_variables(jm, 1, x, x, x, key_padding_mask=kpm)
        want = jm.apply(v, x, x, x, key_padding_mask=kpm)
        tm = convert.load_flax_(tlayers.MultiHeadAttention(16, 2), v)
        _close(tm(_t(x), _t(x), _t(x), key_padding_mask=_t(kpm)), want, 1e-5)

    @pytest.mark.parametrize("n,dim", [(30, 16), (1030, 512)])
    def test_sinusoidal_table(self, n, dim):
        want = jlayers.sinusoidal_embedding_table(n, dim, 1)
        # f32 angle i * w_f: one ulp of w_f times the position index
        _close(tlayers.sinusoidal_embedding_table(n, dim, 1), want,
               n * 2.0 ** -23)

    def test_make_positions(self):
        toks = np.array([[0, 5, 5, 2, 1, 1], [0, 2, 1, 1, 1, 1]])
        np.testing.assert_array_equal(
            tlayers.make_positions(_t(toks), 1).numpy(),
            np.asarray(jlayers.make_positions(jnp.asarray(toks), 1)))


class TestConformer:
    def test_layer(self):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(2, 12, 16)).astype(np.float32)
        pad = _pad_mask(2, 12, 3)
        jm = jconf.ConformerEncoderLayer(16, 32, 2, dropout=0.0,
                                         depthwise_kernel_size=7,
                                         attn_dropout=0.0)
        v = random_variables(jm, 3, x, pad)
        want = jm.apply(v, x, pad)
        tm = convert.load_flax_(tconf.ConformerEncoderLayer(16, 32, 2, 7), v)
        _close(tm(_t(x), _t(pad)), want, 2e-4)

    def test_two_layer_encoder(self):
        cfg = ConformerConfig(embed_dim=16, ffn_dim=32, num_layers=2,
                              num_heads=2, dropout=0.0, attn_dropout=0.0,
                              depthwise_kernel_size=7, conv_channels=8)
        rng = np.random.default_rng(4)
        fbank = rng.normal(size=(2, 40, 80)).astype(np.float32)
        lens = np.array([40, 31], np.int32)
        jm = jconf.ConformerEncoder(
            embed_dim=16, ffn_dim=32, num_layers=2, num_heads=2, dropout=0.0,
            attn_dropout=0.0, depthwise_kernel_size=7, conv_channels=8)
        v = random_variables(jm, 5, fbank, lens)
        want, want_pad, want_lens = jm.apply(v, fbank, lens)
        tm = convert.load_flax_(tconf.ConformerEncoder(cfg), v)
        got, got_pad, got_lens = tm(_t(fbank), _t(lens))
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
        np.testing.assert_array_equal(got_pad.numpy(), np.asarray(want_pad))
        _close(got, want, 2e-4)


def _dag_cfg(**decoder):
    return DAGModelConfig(
        vocab=VocabConfig(size=32),
        encoder=ConformerConfig(embed_dim=16, ffn_dim=32, num_layers=1,
                                num_heads=2, dropout=0.0, attn_dropout=0.0,
                                depthwise_kernel_size=7, conv_channels=8),
        decoder=DAGDecoderConfig(embed_dim=32, ffn_dim=64, num_layers=2,
                                 num_heads=2, dropout=0.0, attn_dropout=0.0,
                                 activation_dropout=0.0, **decoder))


class TestDAGModel:
    @pytest.mark.parametrize("decoder", [
        {},
        {"max_transition_length": 5},
        # sinusoidal positions in the decoder and the link predictor, and
        # an untied output projection
        {"learned_pos": False, "links_feature": "feature:sinposition",
         "share_input_output_embed": False},
    ])
    def test_logits_and_links(self, decoder):
        """Decoder 32-wide over a 16-wide encoder, so ``enc_proj`` is on."""
        cfg = _dag_cfg(**decoder)
        rng = np.random.default_rng(6)
        fbank = rng.normal(size=(2, 40, 80)).astype(np.float32)
        lens = np.array([40, 35], np.int32)
        prev = np.asarray(jdag.initialize_output_tokens(
            jdag.graph_lengths(jnp.asarray(lens), 0.5, 1024), 20, cfg.vocab))
        jm = jdag.S2TConformerDAG(cfg)
        v = random_variables(jm, 7, fbank, lens, prev)
        logits, links, feats = jm.apply(v, fbank, lens, prev)
        tm = convert.load_flax_(tdag.S2TConformerDAG(cfg), v)
        t_logits, t_links, t_feats = tm(_t(fbank), _t(lens), _t(prev))
        _close(t_feats, feats, 1e-4)
        _close(t_logits, logits, 1e-4)
        links, t_links = np.asarray(links), t_links.numpy()
        finite = np.isfinite(links)
        np.testing.assert_array_equal(np.isfinite(t_links), finite)
        np.testing.assert_allclose(t_links[finite], links[finite], rtol=0,
                                   atol=1e-4)

    def test_graph_init(self):
        lens = np.array([40, 35, 3], np.int32)
        want = jdag.initialize_output_tokens(
            jdag.graph_lengths(jnp.asarray(lens), 0.5, 1024), 22,
            VocabConfig())
        got = tdag.initialize_output_tokens(
            tdag.graph_lengths(_t(lens), 0.5, 1024), 22, VocabConfig())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fs2_cfg():
    return FastSpeech2Config(
        encoder_layers=2, encoder_embed_dim=16, encoder_heads=2,
        decoder_layers=2, decoder_embed_dim=16, decoder_heads=2,
        fft_hidden_dim=32, var_pred_hidden_dim=16, dropout=0.0,
        attention_dropout=0.0)


class TestFastSpeech2:
    def _build(self, seed):
        cfg = _fs2_cfg()
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(2, 8, 16)).astype(np.float32)
        pad = _pad_mask(2, 8, 2)
        jm = jfs.FastSpeech2Encoder(cfg, vocab_size=0)
        v = random_variables(jm, seed, x=x, enc_pad_mask=pad, max_out_len=32)
        # a bias of log(1 + 2.6) makes predicted durations ~2-3 frames
        # instead of collapsing to 0 under random weights
        v["params"]["var_adaptor"]["duration_predictor"]["proj"]["bias"][:] \
            = math.log(3.6)
        tm = convert.load_flax_(tfs.FastSpeech2Encoder(cfg), v)
        return cfg, x, pad, jm, v, tm

    def test_mel_teacher_forced(self):
        cfg, x, pad, jm, v, tm = self._build(8)
        durs = np.array([[4, 0, 3, 5, 2, 6, 1, 3], [2, 2, 7, 1, 4, 3, 0, 0]],
                        np.int32)
        mel, _, lens, *_ = jm.apply(v, x=x, enc_pad_mask=pad, max_out_len=32,
                                    durations=durs)
        t_mel, _, t_lens, *_ = tm(_t(x), _t(pad), 32, _t(durs).long())
        np.testing.assert_array_equal(t_lens.numpy(), np.asarray(lens))
        _close(t_mel, mel, 1e-3)

    def test_predicted_durations(self):
        cfg, x, pad, jm, v, tm = self._build(9)
        mel, _, lens, log_dur, _, _ = jm.apply(v, x=x, enc_pad_mask=pad,
                                               max_out_len=32)
        t_mel, _, t_lens, t_log_dur, _, _ = tm(_t(x), _t(pad), 32)

        def frames(ld):
            d = np.clip(np.round(np.exp(np.asarray(ld)) - 1), 0, None)
            return np.where(pad, 0, d).astype(np.int64)

        _close(t_log_dur, log_dur, 1e-4)
        np.testing.assert_array_equal(frames(t_log_dur.numpy()),
                                      frames(log_dur))
        assert frames(log_dur).sum() > 0
        np.testing.assert_array_equal(t_lens.numpy(), np.asarray(lens))
        _close(t_mel, mel, 1e-3)

    def test_length_regulate(self):
        rng = np.random.default_rng(10)
        x = rng.normal(size=(3, 6, 4)).astype(np.float32)
        durs = rng.integers(0, 4, size=(3, 6)).astype(np.int32)
        durs[2] = 0
        want, want_lens = jfs.length_regulate(jnp.asarray(x),
                                              jnp.asarray(durs), 14)
        got, got_lens = tfs.length_regulate(_t(x), _t(durs).long(), 14)
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_variance_bins(self):
        """Bucket edges agree to one f32 ulp of the range end: XLA:CPU's
        linspace and torch's round differently on some edges, so a value
        within an ulp of an edge may land in the neighbouring bucket."""
        cfg = _fs2_cfg()
        va = tfs.VarianceAdaptor(cfg, 16)
        n = cfg.var_pred_n_bins - 1
        for got, lo, hi in ((va.pitch_bins, cfg.pitch_min, cfg.pitch_max),
                            (va.energy_bins, cfg.energy_min,
                             cfg.energy_max)):
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jnp.linspace(lo, hi, n)), rtol=0,
                atol=np.spacing(np.float32(hi)))


VOC_CFG = HiFiGANConfig(
    upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
    upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
    resblock_dilation_sizes=((1, 3),) * 2, resblock="1", num_mels=80)


class TestHiFiGAN:
    @pytest.mark.parametrize("fold_to", [0, 128])
    def test_waveform(self, fold_to):
        rng = np.random.default_rng(11)
        mel = rng.normal(size=(2, 24, 80)).astype(np.float32)
        jm = jhg.HiFiGANGenerator(VOC_CFG, fold_to=fold_to)
        v = random_variables(jm, 12, mel)
        want = jm.apply(v, mel)
        tm = convert.vocoder_from_flax(v, VOC_CFG, device="cpu")
        got = tm(_t(mel))
        assert got.shape == (2, 24 * 4)
        _close(got, want, 2.5e-4)

    def test_tree_is_the_same_for_both_layouts(self):
        mel = np.zeros((1, 16, 80), np.float32)
        shapes = [jax.tree.map(np.shape, jax.eval_shape(
            lambda: jhg.HiFiGANGenerator(VOC_CFG, fold_to=f).init(
                jax.random.key(0), mel)))
            for f in (0, 128)]
        assert shapes[0] == shapes[1]

    def test_incomplete_tree_is_refused(self):
        mel = np.zeros((1, 16, 80), np.float32)
        v = random_variables(jhg.HiFiGANGenerator(VOC_CFG), 0, mel)
        del v["params"]["conv_post"]
        with pytest.raises(KeyError, match="conv_post"):
            convert.vocoder_from_flax(v, VOC_CFG, device="cpu")


class TestDecode:
    @pytest.mark.parametrize("lookahead", [True, False])
    def test_lookahead_and_gather(self, lookahead):
        rng = np.random.default_rng(13)
        B, L, V, H, dk = 3, 16, 12, 2, 8
        q = rng.normal(size=(B, L, H * dk)).astype(np.float32)
        k = rng.normal(size=(B, L, H * dk)).astype(np.float32)
        g = np.asarray(jax.nn.log_softmax(
            rng.normal(size=(B, L, H)).astype(np.float32), axis=-1))
        ol = np.array([16, 11, 2], np.int32)
        links = np.asarray(jfl.xla_extract_links(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(g), jnp.asarray(ol),
            H, 1 / math.sqrt(dk), None))
        logits = rng.normal(size=(B, L, V)).astype(np.float32)
        logits[:, :, 1] -= 1.0           # pad (1) is rarely the argmax
        feats = rng.normal(size=(B, L, 5)).astype(np.float32)
        want = jdec.greedy_or_lookahead_decode(
            jnp.asarray(logits), jnp.asarray(links), jnp.asarray(ol), 1, 1.0,
            lookahead)
        got = tdec.greedy_or_lookahead_decode(
            _t(logits), _t(links), _t(ol), 1, 1.0, lookahead)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        z, zm = jdec.gather_path_features(jnp.asarray(feats), want)
        tz, tzm = tdec.gather_path_features(_t(feats), got)
        np.testing.assert_array_equal(tzm.numpy(), np.asarray(zm))
        np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
