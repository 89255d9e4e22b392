"""The port's AR baselines (``daspeech_torch``) against the JAX package on
the CPU, at small widths (2 layers, 32-48 wide, at most 16 steps).

* the plain attention path (``MultiHeadAttention(fused=False)``), causal
  and not, with an all-padded row, and the causal decoder layer post- and
  pre-norm: within 1e-5;
* ``TTSTransformer``: teacher-forced mel and stop within 1e-4 (with and
  without the Postnet), ``generate`` within 1e-3 with equal lengths;
* ``S2SMultiDecoderModel``: logits, mel and stop within 1e-4;
  ``MultiDecoderSpeechGenerator``: tokens equal, mel within 1e-3, lengths
  equal;
* ``tts_transformer_criterion`` and ``multidecoder_criterion``: one step
  (the prenet's fixed 0.5 dropout set to 0 on both sides, every other
  rate 0; the Conformer's BatchNorm on batch statistics) with the loss
  within 1e-4 relative, the gradients within 1e-3 of their global norm
  and the BatchNorm statistics within 1e-5;
* bf16: each module's output within 2 ||jax_bf16 - jax_fp32|| of JAX's
  bf16 output.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daspeech_torch import convert
from daspeech_torch.decode import speech_generator as tsg
from daspeech_torch.losses import tts_loss as ttl
from daspeech_torch.models import layers as tlayers
from daspeech_torch.models import tts_transformer as ttt
from daspeech_tpu.core.config import (
    MultiDecoderConfig, TTSTransformerConfig, VocabConfig)
from daspeech_tpu.decode import speech_generator as jsg
from daspeech_tpu.losses import tts_loss as jtl
from daspeech_tpu.models import layers as jlayers
from daspeech_tpu.models import s2s_multidecoder as jmd
from daspeech_tpu.models import tts_transformer as jtt
from test_torch_models import random_variables
from test_torch_train import _grad_pairs

V = 20
VOCAB = VocabConfig(size=V)
BF16 = torch.bfloat16

TTS_CFG = TTSTransformerConfig(embed_dim=32, ffn_dim=64, encoder_layers=2,
                               decoder_layers=2, num_heads=2, dropout=0.0,
                               prenet_dim=32)
MD_CFG = MultiDecoderConfig(
    encoder_embed_dim=32, encoder_layers=2, encoder_heads=2,
    mt_embed_dim=48, mt_layers=2, mt_heads=2, ffn_dim=64,
    synth_encoder_layers=2, tts_decoder_layers=2, prenet_dim=32,
    dropout=0.0, conv_channels=32, depthwise_kernel_size=7)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def _tokens(rng, B=3, T=7):
    tok = rng.integers(4, V, size=(B, T)).astype(np.int32)
    tok[1, T - 2:] = VOCAB.pad
    tok[2, T - 3:] = VOCAB.pad
    return tok


def _mels(rng, B=3, M=12):
    return rng.normal(size=(B, M, 80)).astype(np.float32)


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("causal", [False, True], ids=["plain", "causal"])
def test_unfused_attention_matches_jax(causal):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 6, 16)).astype(np.float32)
    kpm = np.zeros((3, 6), bool)
    kpm[1, 4:] = True
    kpm[0] = True                     # every key padded: a uniform row
    jm = jlayers.MultiHeadAttention(16, 2, 0.0, causal=causal)
    v = random_variables(jm, 1, x, x, x, key_padding_mask=kpm)
    want = jm.apply(v, x, x, x, key_padding_mask=kpm)
    tm = convert.load_flax_(
        tlayers.MultiHeadAttention(16, 2, causal=causal, fused=False), v)
    with torch.no_grad():
        got = tm(_t(x), _t(x), _t(x), key_padding_mask=_t(kpm))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post-norm", "pre-norm"])
def test_causal_decoder_layer_matches_jax(normalize_before):
    """``TransformerDecoderLayer(causal=True, fused_attention=False)``, the
    AR text decoder's layer, with a padded self row and a padded encoder
    row: within 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    enc = rng.normal(size=(2, 7, 16)).astype(np.float32)
    spm = np.zeros((2, 5), bool)
    spm[1, 3:] = True
    epm = np.zeros((2, 7), bool)
    epm[0, 5:] = True
    jm = jlayers.TransformerDecoderLayer(
        16, 32, 2, 0.0, normalize_before=normalize_before, causal=True)
    v = random_variables(jm, 3, x, spm, enc, epm)
    want = jm.apply(v, x, spm, enc, epm)
    tm = convert.load_flax_(tlayers.TransformerDecoderLayer(
        16, 32, 2, normalize_before=normalize_before, causal=True,
        fused_attention=False), v)
    with torch.no_grad():
        got = tm(_t(x), _t(spm), _t(enc), _t(epm))
    _close(got, want, 1e-5)


def test_unfused_attention_dropout_draws_from_the_generator():
    tm = tlayers.MultiHeadAttention(16, 2, 0.5, causal=True, fused=False)
    x = torch.randn(2, 5, 16)
    with torch.no_grad():
        a = tm(x, x, x, rng=torch.Generator().manual_seed(1))
        b = tm(x, x, x, rng=torch.Generator().manual_seed(1))
        c = tm(x, x, x, rng=torch.Generator().manual_seed(2))
        d = tm(x, x, x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d, tm(x, x, x))


# ------------------------------------------------------- Transformer-TTS

def _tts(cfg=TTS_CFG, seed=1, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    tok, mel = _tokens(rng), _mels(rng)
    jm = jtt.TTSTransformer(vocab_size=V, pad=VOCAB.pad, dtype=dtype,
                            **vars(cfg))
    v = random_variables(jm, seed + 1, tok, mel)
    return jm, v, tok, mel


@pytest.mark.parametrize("postnet", [False, True], ids=["mel", "postnet"])
def test_tts_transformer_teacher_forced(postnet):
    cfg = TTSTransformerConfig(**{**vars(TTS_CFG), "add_postnet": postnet})
    jm, v, tok, mel = _tts(cfg)
    want_mel, want_stop = jm.apply(v, tok, mel)
    tm = convert.tts_transformer_from_flax(v, cfg, V, VOCAB.pad, "cpu")
    with torch.no_grad():
        got_mel, got_stop = tm(_t(tok).long(), _t(mel))
    _close(got_mel, want_mel, 1e-4)
    _close(got_stop, want_stop, 1e-4)


def _shape_stop(jm, v, tok, n):
    """Set the stop bias so that the row whose stop logit peaks highest
    stops and the others never do: the threshold's logit halfway between
    the two highest row peaks of JAX's run (the frames do not depend on
    the stop head). Every step's logit stays 1e-4 or more from it."""
    v["params"]["stop_out"]["bias"][:] = 0.0
    mel, _ = jm.apply(v, tok, n, 0.5, method=jm.generate)
    prev = np.concatenate([np.zeros_like(mel[:, :1]), mel[:, :-1]], 1)
    _, s = jm.apply(v, tok, prev)
    peaks = np.sort(np.asarray(s).max(axis=1))[::-1]
    bias = -(peaks[0] + peaks[1]) / 2
    v["params"]["stop_out"]["bias"][:] = bias
    assert np.abs(np.asarray(s) + bias).min() > 1e-4


@pytest.mark.parametrize("postnet", [False, True], ids=["mel", "postnet"])
def test_tts_transformer_generate(postnet):
    """12 AR steps; one row stops, two never do (``_shape_stop``)."""
    cfg = TTSTransformerConfig(**{**vars(TTS_CFG), "add_postnet": postnet})
    jm, v, tok, _ = _tts(cfg, seed=3)
    _shape_stop(jm, v, tok, 12)
    want_mel, want_lens = jm.apply(v, tok, 12, 0.5, method=jm.generate)
    tm = convert.tts_transformer_from_flax(v, cfg, V, VOCAB.pad, "cpu")
    with torch.no_grad():
        got_mel, got_lens = tm.generate(_t(tok).long(), 12, 0.5)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert sorted(np.asarray(want_lens).tolist())[1:] == [12, 12]
    assert min(np.asarray(want_lens)) < 12
    _close(got_mel, want_mel, 1e-3)


def test_ar_generator_matches_jax():
    """``AutoRegressiveSpeechGenerator`` (no vocoder) against JAX's: each
    utterance's frames up to its stop within 1e-3."""
    jm, v, tok, _ = _tts(seed=3)
    _shape_stop(jm, v, tok, 10)
    want = jsg.AutoRegressiveSpeechGenerator(jm, VOCAB, max_mel_len=10
                                             ).generate(v, {"src_tokens": tok})
    tm = convert.tts_transformer_from_flax(v, TTS_CFG, V, VOCAB.pad, "cpu")
    got = tsg.AutoRegressiveSpeechGenerator(tm, VOCAB, max_mel_len=10
                                            ).generate({"src_tokens": tok})
    for g, w in zip(got, want):
        assert g["feature"].shape == w["feature"].shape
        np.testing.assert_allclose(g["feature"], w["feature"], rtol=0,
                                   atol=1e-3)


def _no_prenet_dropout(monkeypatch):
    """The prenet's dropout is a fixed 0.5 in both packages; a parity step
    sets it to 0 on both sides."""
    monkeypatch.setattr(ttt, "PRENET_DROPOUT", 0.0)
    for mod in (jtt, jmd):
        monkeypatch.setattr(mod, "Dropout",
                            lambda rate, **kw: jlayers.Dropout(0.0, **kw))


def _assert_step(tm, loss, want_loss, want_grads):
    """The loss within 1e-4 relative; every gradient within 1e-3 of the
    global gradient norm."""
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    pairs = list(_grad_pairs(tm, jax.tree.map(np.asarray, want_grads)))
    assert len(pairs) == sum(1 for _ in tm.parameters())
    norm = np.sqrt(sum(float(np.sum(np.square(w))) for _, _, w in pairs))
    for name, got, want in pairs:
        got = np.zeros(want.shape) if got is None else got.numpy()
        err = float(np.abs(got - want).max())
        assert err <= 1e-3 * norm, (name, err, norm)


def test_tts_transformer_criterion_step(monkeypatch):
    _no_prenet_dropout(monkeypatch)
    jm, v, tok, mel = _tts(seed=5)
    lens = np.array([12, 9, 5], np.int32)
    mel[1, 9:] = 0.0
    mel[2, 5:] = 0.0
    batch = {"src_tokens": tok, "target_audio": mel,
             "target_audio_lengths": lens,
             "sample_mask": np.array([1, 1, 0], np.int32)}

    def lossf(params):
        return jtl.tts_transformer_criterion(
            jm, {"params": params},
            {k: jnp.asarray(x) for k, x in batch.items()},
            jax.random.key(0), VOCAB)

    (want, _), grads = jax.value_and_grad(lossf, has_aux=True)(
        jax.tree.map(jnp.asarray, v["params"]))
    tm = convert.tts_transformer_from_flax(v, TTS_CFG, V, VOCAB.pad,
                                           "cpu").train()
    tb = {k: _t(x) for k, x in batch.items()}
    tb["src_tokens"] = tb["src_tokens"].long()
    tb["target_audio_lengths"] = tb["target_audio_lengths"].long()
    loss, metrics = ttl.tts_transformer_criterion(tm, tb, torch.Generator(),
                                                  VOCAB)
    loss.backward()
    _assert_step(tm, loss, want, grads)
    assert set(metrics) == {"loss", "l1-loss", "stop-loss"}


# ---------------------------------------------------- multi-decoder S2ST

def _md_inputs(seed, B=3, S=40, T=6, M=10):
    rng = np.random.default_rng(seed)
    fbank = rng.normal(size=(B, S, 80)).astype(np.float32)
    lens = np.array([S, S - 8, S - 16][:B], np.int32)
    text = rng.integers(4, V, size=(B, T)).astype(np.int32)
    text[:, 0] = VOCAB.bos
    text[0, -1] = VOCAB.eos
    text[1, 4], text[1, 5:] = VOCAB.eos, VOCAB.pad
    text[2, 3], text[2, 4:] = VOCAB.eos, VOCAB.pad
    mel = rng.normal(size=(B, M, 80)).astype(np.float32)
    return fbank, lens, text, mel


def _md(cfg=MD_CFG, seed=11, dtype=jnp.float32):
    fbank, lens, text, mel = _md_inputs(seed)
    jm = jmd.S2SMultiDecoderModel(
        vocab_size=V, pad=VOCAB.pad, bos=VOCAB.bos, eos=VOCAB.eos,
        dtype=dtype, **vars(cfg))
    v = random_variables(jm, seed + 1, fbank, lens, text, mel)
    return jm, v, (fbank, lens, text, mel)


def test_multidecoder_teacher_forced():
    jm, v, (fbank, lens, text, mel) = _md()
    want = jm.apply(v, fbank, lens, text, mel)
    tm = convert.multidecoder_from_flax(v, MD_CFG, VOCAB, "cpu")
    assert tm.enc_proj is not None
    with torch.no_grad():
        got = tm(_t(fbank), _t(lens).long(), _t(text).long(), _t(mel))
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_multidecoder_generator_matches_jax():
    """Greedy text for 8 steps, then 10 mel steps: tokens and lengths
    equal, the mels within 1e-3. Random weights repeat one token or end
    at once; with ``<eos>``'s embedding scaled by 0.75 and N(0, 1)
    positions one row changes its token, one ends at step 1 and the
    mel of one stops at step 1."""
    jm, v, (fbank, lens, _, _) = _md(seed=15)
    mt = v["params"]["mt_decoder"]
    mt["embed_tokens"]["embedding"][VOCAB.eos] *= 0.75
    emb = mt["embed_positions"]["embedding"]
    emb[:] = np.random.default_rng(1).normal(size=emb.shape)
    batch = {"fbank": fbank, "src_lengths": lens}
    jgen = jsg.MultiDecoderSpeechGenerator(jm, VOCAB, max_text_len=8,
                                           max_mel_len=10)
    want = jgen.generate(v, {k: jnp.asarray(x) for k, x in batch.items()})
    _, _, want_mel, want_lens, _ = jgen._fn(v, jnp.asarray(fbank),
                                            jnp.asarray(lens))
    tm = convert.multidecoder_from_flax(v, MD_CFG, VOCAB, "cpu")
    tgen = tsg.MultiDecoderSpeechGenerator(tm, VOCAB, max_text_len=8,
                                           max_mel_len=10)
    got = tgen.generate(batch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        assert g["feature"].shape == w["feature"].shape
    with torch.inference_mode():
        buf, tl, enc, pad = tgen.translate(*tgen.to_device(batch))
        mel, mel_lens = tgen.synthesize(buf, tl, enc, pad)
    np.testing.assert_array_equal(mel_lens.numpy(), np.asarray(want_lens))
    assert sorted(tl.tolist()) == [1, 8, 8]
    assert sorted(mel_lens.tolist()) == [1, 10, 10]
    _close(mel, want_mel, 1e-3)


def test_multidecoder_criterion_step(monkeypatch):
    """A training pass (batch statistics in the Conformer's BatchNorm)."""
    _no_prenet_dropout(monkeypatch)
    jm, v, (fbank, lens, text, mel) = _md(seed=17)
    mlens = np.array([10, 7, 4], np.int32)
    batch = {"fbank": fbank, "src_lengths": lens, "target_text": text,
             "target_audio": mel, "target_audio_lengths": mlens}

    def lossf(params):
        return jtl.multidecoder_criterion(
            jm, {"params": params, "batch_stats": v["batch_stats"]},
            {k: jnp.asarray(x) for k, x in batch.items()},
            jax.random.key(0), VOCAB)

    (want, aux), grads = jax.value_and_grad(lossf, has_aux=True)(
        jax.tree.map(jnp.asarray, v["params"]))
    tm = convert.multidecoder_from_flax(v, MD_CFG, VOCAB, "cpu").train()
    tb = {k: _t(x) for k, x in batch.items()}
    for k in ("src_lengths", "target_text", "target_audio_lengths"):
        tb[k] = tb[k].long()
    loss, metrics = ttl.multidecoder_criterion(tm, tb, torch.Generator(),
                                               VOCAB)
    loss.backward()
    _assert_step(tm, loss, want, grads)
    for k in ("mt-loss", "l1-loss", "stop-loss"):
        np.testing.assert_allclose(metrics[k].item(),
                                   float(aux["metrics"][k]), rtol=1e-4)
    # the running statistics moved as JAX's did
    stats = aux["batch_stats"]["encoder"]
    for i in range(MD_CFG.encoder_layers):
        bn = tm.encoder.layers[i].conv_module.batch_norm
        want_bn = stats[f"layers_{i}"]["conv_module"]["batch_norm"]
        _close(bn.running_mean, want_bn["mean"], 1e-5)
        _close(bn.running_var, want_bn["var"], 1e-5)


# ------------------------------------------------------------------ bf16

def _bf16_bar(got, want16, want32):
    got = got.float().detach().numpy()
    w16 = np.asarray(want16, np.float32)
    w32 = np.asarray(want32, np.float32)
    bar = 2 * np.linalg.norm(w16 - w32)
    assert bar > 0
    assert np.linalg.norm(got - w16) <= bar, (np.linalg.norm(got - w16),
                                               bar)


def test_tts_transformer_bf16():
    jm, v, tok, mel = _tts(seed=21)
    want = {dt: jtt.TTSTransformer(vocab_size=V, pad=VOCAB.pad, dtype=dt,
                                   **vars(TTS_CFG)).apply(v, tok, mel)
            for dt in (jnp.bfloat16, jnp.float32)}
    tm = convert.load_flax_(ttt.TTSTransformer(V, VOCAB.pad, dtype=BF16,
                                               **vars(TTS_CFG)), v)
    with torch.no_grad():
        got = tm(_t(tok).long(), _t(mel))
    assert got[0].dtype == BF16
    for i in range(2):
        _bf16_bar(got[i], want[jnp.bfloat16][i], want[jnp.float32][i])


def test_multidecoder_bf16():
    from daspeech_torch.models.s2s_multidecoder import S2SMultiDecoderModel

    jm, v, (fbank, lens, text, mel) = _md(seed=23)
    want = {dt: jmd.S2SMultiDecoderModel(
        vocab_size=V, pad=VOCAB.pad, bos=VOCAB.bos, eos=VOCAB.eos, dtype=dt,
        **vars(MD_CFG)).apply(v, fbank, lens, text, mel)
        for dt in (jnp.bfloat16, jnp.float32)}
    tm = convert.load_flax_(S2SMultiDecoderModel(
        V, VOCAB.pad, VOCAB.bos, VOCAB.eos, dtype=BF16, **vars(MD_CFG)), v)
    with torch.no_grad():
        got = tm(_t(fbank), _t(lens).long(), _t(text).long(), _t(mel))
    for i in range(3):
        _bf16_bar(got[i], want[jnp.bfloat16][i], want[jnp.float32][i])
