"""The port's vocoder serving modes against the JAX package, on the CPU.

Weights are numpy draws carried across by ``daspeech_torch.convert``;
inputs are numpy draws from a seed. The JAX side runs the fused MRF kernel
in Pallas interpret mode, as ``tests/test_fused_mrf.py`` does. Tolerances:

- the fused MRF level and the fused-mode generator: rtol 2e-4, atol 2e-5,
  the bounds of ``tests/test_fused_mrf.py`` (the port's plain version
  against the interpreted Pallas kernel, sums in another order);
- waveforms across the packages: 2.5e-4, the bar the JAX generator
  reached against the original torch HiFi-GAN (ROADMAP);
- the port's chunked output against its own one-shot forward: 1e-6 (the
  same convolutions over windows; only the edge windows' lengths differ);
- the TTS generator's mel and waveform: 1e-3 (FastSpeech 2's bar).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daspeech_torch import config as tcfg
from daspeech_torch import convert
from daspeech_torch.decode import generator as tgen
from daspeech_torch.decode import speech_generator as tsg
from daspeech_torch.models import hifigan as thg
from daspeech_torch.ops import fused_mrf as tfm
from daspeech_tpu.core import config as jcfg
from daspeech_tpu.core.config import DecodeConfig, FastSpeech2Config, VocabConfig
from daspeech_tpu.data.transforms import GlobalCMVN
from daspeech_tpu.decode import generator as jgen
from daspeech_tpu.decode import speech_generator as jsg
from daspeech_tpu.models import fastspeech2 as jfs
from daspeech_tpu.models import hifigan as jhg
from daspeech_tpu.ops import fused_mrf as jfm
from test_torch_models import random_variables
from test_torch_slice import golden_setup  # noqa: F401  (a fixture)

MRF_TOL = dict(rtol=2e-4, atol=2e-5)
WAV_TOL = 2.5e-4
CHUNK_TOL = 1e-6
TTS_TOL = 1e-3
V1_KERNELS, V1_DILATIONS = (3, 7, 11), ((1, 3, 5),) * 3


@pytest.fixture(autouse=True, scope="module")
def one_thread_no_grad():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    """The same HiFi-GAN configuration in both packages."""
    return jcfg.HiFiGANConfig(**kw), tcfg.HiFiGANConfig(**kw)


FUSED_CFG = dict(      # tests/test_fused_mrf.py: ch 128 (f=1), 64 (f=2)
    upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
    upsample_initial_channel=256, resblock_kernel_sizes=V1_KERNELS,
    resblock_dilation_sizes=V1_DILATIONS, resblock="1")
CHUNK_CFG = dict(      # tests/test_hifigan_chunked.py
    upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
    upsample_initial_channel=64, resblock_kernel_sizes=(3, 7),
    resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), resblock="1")
RB2_CFG = dict(        # tests/test_models.py::test_folded_resblock2_matches
    resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
    upsample_initial_channel=16, resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),))
RB2_V3_CFG = dict(     # hifi-gan config_v3's resblocks at a small width
    resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
    upsample_initial_channel=32, resblock_kernel_sizes=(3, 5, 7),
    resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))
V3_CFG = dict(         # hifi-gan config_v3.json
    resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
    upsample_initial_channel=256, resblock_kernel_sizes=(3, 5, 7),
    resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))


def _mel(seed, B, M):
    return np.random.default_rng(seed).normal(size=(B, M, 80)).astype(
        np.float32)


def _vocoders(cfg_kw, seed, mel, **serving):
    """(JAX module at fold_to=128, its numpy variables, the port's
    generator with the same weights and ``serving`` arguments)."""
    jc, tc = _cfgs(**cfg_kw)
    jm = jhg.HiFiGANGenerator(jc, fold_to=128)
    v = random_variables(jm, seed, mel)
    return jm, v, convert.vocoder_from_flax(v, tc, device="cpu", **serving)


# --- the MRF level (#7) --------------------------------------------------

def test_mrf_level_ref_matches_jax_kernel():
    """The plain version against the Pallas kernel (interpret mode) at
    f = 1: C = 128, T = 192, tile 64; and ``prepare_level`` of ResBlock1
    modules stacks what JAX's ``prepare_level`` stacks."""
    rng = np.random.default_rng(0)
    B, C, T = 2, 128, 192
    conv_params = [[tuple(rng.normal(0, s, shape).astype(np.float32)
                          for s, shape in ((1 / np.sqrt(k * C), (k, C, C)),
                                           (0.1, (C,)),
                                           (1 / np.sqrt(k * C), (k, C, C)),
                                           (0.1, (C,))))
                    for _ in ds] for k, ds in zip(V1_KERNELS, V1_DILATIONS)]
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    W, biases, offs, H = jfm.prepare_level(conv_params, 1, C, V1_KERNELS,
                                           V1_DILATIONS, dtype=jnp.float32)
    want = np.asarray(jfm.mrf_level(jnp.asarray(x), W, biases, offsets=offs,
                                    H=H, tile=64, interpret=True))

    blocks = [thg.ResBlock1(C, k, ds) for k, ds in zip(V1_KERNELS,
                                                      V1_DILATIONS)]
    for blk, params in zip(blocks, conv_params):
        for c1, c2, (k1, b1, k2, b2) in zip(blk.convs1, blk.convs2, params):
            for conv, k, b in ((c1, k1, b1), (c2, k2, b2)):
                conv.weight.copy_(torch.from_numpy(k).permute(2, 1, 0))
                conv.bias.copy_(torch.from_numpy(b))
    tW, tb = tfm.prepare_level(blocks)
    np.testing.assert_array_equal(tW.numpy(), np.asarray(W))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(biases))
    got = tfm.mrf_level(torch.from_numpy(x).transpose(1, 2), tW, tb,
                        V1_KERNELS, V1_DILATIONS, tile=64)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, **MRF_TOL)
    # the level is the plain modules' average
    xt = torch.from_numpy(x).transpose(1, 2)
    np.testing.assert_allclose(
        got.numpy(), (sum(b(xt) for b in blocks) / 3).numpy(), rtol=0,
        atol=1e-5)


def test_fused_generator_matches_jax(monkeypatch):
    """``fused_mrf=True`` against JAX's fused generator (``fold_to=128``,
    interpret mode, tile 64): both levels take the kernel in both."""
    mel = _mel(1, 2, 96)
    jc, tc = _cfgs(**FUSED_CFG)
    jm = jhg.HiFiGANGenerator(jc, fold_to=128, fused_mrf=True,
                              mrf_interpret=True, mrf_tile=64)
    v = random_variables(jhg.HiFiGANGenerator(jc, fold_to=128), 2, mel)
    want = np.asarray(jm.apply(v, mel))
    tm = convert.vocoder_from_flax(v, tc, device="cpu", fused_mrf=True,
                                   mrf_tile=64)
    routed = []
    monkeypatch.setattr(thg, "mrf_level",
                        lambda x, *a: routed.append(x.shape) or
                        tfm.mrf_level(x, *a))
    got = tm(torch.from_numpy(mel))
    assert routed == [(2, 128, 192), (2, 64, 384)]
    np.testing.assert_allclose(got.numpy(), want, **MRF_TOL)
    plain = convert.vocoder_from_flax(v, tc, device="cpu")
    np.testing.assert_allclose(got.numpy(),
                               plain(torch.from_numpy(mel)).numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("ch,f", [(256, 1), (128, 1), (64, 2), (48, 2),
                                  (32, 4), (16, 8)])
def test_route_matches_jax_gate(monkeypatch, ch, f):
    """``fused_mrf_route`` against the levels JAX's fused generator
    (``fold_to=128``) sends to ``mrf_level``, over lengths across the
    switch at 128 folded frames (traced with ``jax.eval_shape``)."""
    sent = []
    monkeypatch.setattr(jfm, "mrf_level",
                        lambda x, *a, **k: sent.append(x.shape) or x)
    for resblock in ("1", "2"):
        jc = jcfg.HiFiGANConfig(
            upsample_rates=(2,), upsample_kernel_sizes=(4,),
            upsample_initial_channel=2 * ch, resblock=resblock,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
        jm = jhg.HiFiGANGenerator(jc, fold_to=128, fused_mrf=True)
        for T in (126 * f, 128 * f, 130 * f):
            mel = jax.ShapeDtypeStruct((1, T // 2, 80), jnp.float32)
            v = jax.eval_shape(jm.init, jax.random.key(0), mel)
            sent.clear()
            jax.eval_shape(jm.apply, v, mel)
            assert thg.fused_mrf_route(resblock, ch, T) == bool(sent), \
                (resblock, ch, T)
            assert bool(sent) == (resblock == "1" and ch * f == 128
                                  and T >= 128 * f)


# --- ResBlock2, the halo, chunked vocoding -------------------------------

@pytest.mark.parametrize("cfg_kw", [RB2_CFG, RB2_V3_CFG])
def test_resblock2_generator_matches_jax(cfg_kw):
    mel = _mel(3, 2, 24)
    jm, v, tm = _vocoders(cfg_kw, 4, mel)
    assert isinstance(tm.resblocks[0], thg.ResBlock2)
    got = tm(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, mel)),
                               rtol=0, atol=WAV_TOL)


@pytest.mark.parametrize("cfg_kw", [{}, V3_CFG, FUSED_CFG, CHUNK_CFG, RB2_CFG,
                                    RB2_V3_CFG])
def test_receptive_halo_matches_jax(cfg_kw):
    jc, tc = _cfgs(**cfg_kw)
    assert thg.receptive_halo_mel(tc) == jhg.receptive_halo_mel(jc)
    if not cfg_kw:
        assert thg.receptive_halo_mel(tc) == 15          # config_v1


@pytest.fixture(scope="module")
def chunk_setup():
    mel = _mel(0, 2, 150)
    jm, v, tm = _vocoders(CHUNK_CFG, 5, mel)
    return mel, jm, v, tm, tm(torch.from_numpy(mel))


def test_halo_is_tight_enough(chunk_setup):
    """Perturbing one mel frame changes no sample outside the halo
    (``tests/test_hifigan_chunked.py:43-54``)."""
    mel, _, _, tm, base = chunk_setup
    halo, hop = thg.receptive_halo_mel(tm.cfg), 8
    bumped = mel.copy()
    bumped[:, 75] += 10.0
    changed = np.where(np.any(base.numpy() != tm(torch.from_numpy(bumped))
                              .numpy(), axis=0))[0]
    assert 75 - halo <= changed.min() // hop
    assert changed.max() // hop <= 75 + halo


@pytest.mark.parametrize("chunk", [32, 64, 70])
def test_chunked_equals_one_shot_and_jax(chunk_setup, chunk):
    mel, jm, v, tm, full = chunk_setup
    got = thg.vocode_chunked(tm, torch.from_numpy(mel), chunk)
    assert got.shape == full.shape
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0,
                               atol=CHUNK_TOL)
    want = np.asarray(jhg.vocode_chunked(jm, v, jnp.asarray(mel),
                                         chunk=chunk))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WAV_TOL)
    parts = list(thg.vocode_chunks(tm, torch.from_numpy(mel), chunk))
    assert len(parts) == -(-mel.shape[1] // chunk)
    assert all(p.shape[1] == chunk * 8 for p in parts[:-1])


def test_short_utterance_is_one_window(chunk_setup):
    mel, _, _, tm, full = chunk_setup
    parts = list(thg.vocode_chunks(tm, torch.from_numpy(mel), 4096))
    assert len(parts) == 1
    np.testing.assert_array_equal(parts[0].numpy(), full.numpy())


# --- serving: make_vocode_fn, the TTS generator, S2SNATGenerator --------

def _gcmvn(seed):
    rng = np.random.default_rng(seed)
    return GlobalCMVN(mean=rng.normal(size=80).astype(np.float32),
                      std=rng.uniform(0.5, 2, size=80).astype(np.float32))


@pytest.mark.parametrize("chunk", [0, 32])
def test_make_vocode_fn_denormalizes_first_and_matches_jax(chunk_setup,
                                                           chunk):
    mel, jm, v, tm, _ = chunk_setup
    gcmvn = _gcmvn(6)
    tm_c = convert.vocoder_from_flax(v, tm.cfg, device="cpu",
                                     serve_chunk=chunk)
    got = tsg.make_vocode_fn(tm_c, gcmvn)(torch.from_numpy(mel))
    raw = torch.from_numpy(mel * gcmvn.std + gcmvn.mean)
    np.testing.assert_allclose(got.numpy(), tm(raw).numpy(), rtol=0,
                               atol=CHUNK_TOL)
    want = jsg.make_vocode_fn(jm.clone(serve_chunk=chunk), v, gcmvn)(
        jnp.asarray(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=WAV_TOL)


def test_make_vocode_fn_one_shot_and_chunked_agree(chunk_setup):
    mel, _, v, tm, full = chunk_setup
    fns = [tsg.make_vocode_fn(convert.vocoder_from_flax(
        v, tm.cfg, device="cpu", serve_chunk=c)) for c in (0, 48)]
    a, b = (fn(torch.from_numpy(mel)) for fn in fns)
    np.testing.assert_array_equal(a.numpy(), full.numpy())
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=CHUNK_TOL)
    assert tsg.make_vocode_fn(None) is None


TTS_V = 20
TTS_HOP = 4
VOC_CFG = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
               upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
               resblock_dilation_sizes=((1, 3),) * 2, resblock="1")


def test_tts_generator_matches_jax():
    """``NonAutoregressiveSpeechGenerator`` on a small token FastSpeech 2
    and a small vocoder (hop 4), gcmvn on: every token lasts 3 frames
    (predicted (e^b - 1) = 3.2, away from a rounding tie), so both
    packages regulate to the same lengths."""
    vocab = VocabConfig(size=TTS_V)
    cfg = FastSpeech2Config(
        encoder_layers=2, encoder_embed_dim=16, encoder_heads=2,
        decoder_layers=2, decoder_embed_dim=16, decoder_heads=2,
        fft_hidden_dim=32, var_pred_hidden_dim=16, dropout=0.0,
        attention_dropout=0.0, var_pred_dropout=0.0, pitch_min=-3.0,
        pitch_max=3.0, energy_min=-3.0, energy_max=3.0)
    rng = np.random.default_rng(7)
    tokens = rng.integers(4, TTS_V, size=(2, 9)).astype(np.int32)
    tokens[1, 6:] = vocab.pad
    M = 40
    jm = jfs.FastSpeech2Encoder(cfg, vocab_size=TTS_V, pad=vocab.pad)
    v = random_variables(jm, 8, src_tokens=tokens, max_out_len=M)
    proj = v["params"]["var_adaptor"]["duration_predictor"]["proj"]
    proj["kernel"][:] = 0.0
    proj["bias"][:] = np.log(1.0 + 3.2)
    mel = np.zeros((2, M, 80), np.float32)
    jvoc, vv, tvoc = _vocoders(VOC_CFG, 9, mel)
    gcmvn = _gcmvn(10)

    want = jsg.NonAutoregressiveSpeechGenerator(
        jm, vocab, max_mel_len=M, vocoder=jvoc, vocoder_params=vv,
        gcmvn=gcmvn, hop=TTS_HOP).generate(
            v, {"src_tokens": jnp.asarray(tokens)})
    tts = tsg.NonAutoregressiveSpeechGenerator(
        convert.fs2_from_flax(v, cfg, TTS_V, vocab.pad, device="cpu").eval(),
        vocab, max_mel_len=M, vocoder=tvoc, gcmvn=gcmvn, hop=TTS_HOP)
    got = tts.generate({"src_tokens": tokens})

    assert [h["feature"].shape[0] for h in got] == [27, 18]
    for h_got, h_want in zip(got, want):
        assert h_got.keys() == h_want.keys() == {"feature", "waveform"}
        assert h_got["feature"].shape == h_want["feature"].shape
        np.testing.assert_allclose(h_got["feature"], h_want["feature"],
                                   rtol=0, atol=TTS_TOL)
        assert len(h_got["waveform"]) == h_got["feature"].shape[0] * TTS_HOP
        np.testing.assert_allclose(h_got["waveform"], h_want["waveform"],
                                   rtol=0, atol=TTS_TOL)
    assert all("waveform" not in h for h in tts.generate(
        {"src_tokens": tokens}, generate_waveform=False))


def test_s2s_generator_chunked_vocoder(golden_setup):  # noqa: F811
    """``S2SNATGenerator`` serving a chunked vocoder (``serve_chunk=16``
    over a 96-frame mel bucket: 6 windows) equals the one-shot vocoder and
    JAX's generator with the same chunked vocoder."""
    g = golden_setup
    cfg, model, voc = g["cfg"], g["model"], g["voc"]
    params = jax.tree.map(np.copy, g["params"])
    proj = params["params"]["tts"]["var_adaptor"]["duration_predictor"][
        "proj"]
    proj["kernel"][:] = 0.0
    proj["bias"][:] = np.log(4.0)
    batch = {"fbank": g["fbank"], "src_lengths": g["src_lengths"],
             "prev_output_tokens": g["prev"]}
    gcmvn, M, chunk = _gcmvn(11), 96, 16
    tmodel = convert.from_flax(params, cfg, device="cpu")

    def port(serve_chunk):
        return tgen.S2SNATGenerator(
            tmodel, cfg.dag.vocab, DecodeConfig(), max_mel_len=M,
            vocoder=convert.vocoder_from_flax(g["vparams"], voc.cfg,
                                              device="cpu",
                                              serve_chunk=serve_chunk),
            gcmvn=gcmvn).generate(batch)

    one_shot, chunked = port(0), port(chunk)
    want = jgen.S2SNATGenerator(
        model, cfg.dag.vocab, DecodeConfig(), max_mel_len=M,
        vocoder=voc.clone(serve_chunk=chunk), vocoder_params=g["vparams"],
        gcmvn=gcmvn).generate(params, batch)
    for h_c, h_1, h_j in zip(chunked, one_shot, want):
        assert h_c["feature"].shape[0] > 0
        np.testing.assert_array_equal(h_c["tokens"], h_j["tokens"])
        np.testing.assert_allclose(h_c["waveform"], h_1["waveform"], rtol=0,
                                   atol=CHUNK_TOL)
        np.testing.assert_allclose(h_c["waveform"], h_j["waveform"], rtol=0,
                                   atol=TTS_TOL)
