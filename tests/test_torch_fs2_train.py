"""The port's FastSpeech 2 training mode and pretraining criterion
(``daspeech_torch``) against the JAX package, on the CPU at small widths
(2+2 FFT layers, 16 wide).

* train-mode forward (dropout 0, gold durations, pitches and energies) on
  the token path and the NoEmb path: mel within 1e-3 (the bar of the JAX
  package against the reference), the predictors within 1e-4;
* the variance adaptor's ``p_factor``/``e_factor`` on the predictions;
* ``masked_mean`` and ``fastspeech2_losses``: loss, metrics and input
  gradients to 1e-5;
* ``fastspeech2_criterion``: loss to 1e-5 relative and every parameter
  gradient to 1e-4 of its own largest entry or of 1e-3 (the key biases,
  whose exact gradient is 0, to 1e-4 of their kernel's gradient; see
  ``test_torch_joint.py``), with a bucket-fill row (``sample_mask``);
* the dropout sites and rates of a training pass, which match the JAX
  module's; each option (Postnet, CTC head, unfused attention, speakers)
  alone against JAX's forward;
* a few pretraining updates lower the loss.

Pitch and energy targets lie at bucket centres (see
``test_torch_joint.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daspeech_torch import convert
from daspeech_torch.losses import fastspeech2_loss as tfl
from daspeech_torch.losses import tts_loss as ttts
from daspeech_torch.models import fastspeech2 as tfs
from daspeech_torch.models import layers as tlayers
from daspeech_torch.train import GuardedAdam, TrainState, make_train_step
from daspeech_tpu.core.config import FastSpeech2Config, VocabConfig
from daspeech_tpu.losses import fastspeech2_loss as jfl
from daspeech_tpu.losses import tts_loss as jtts
from daspeech_tpu.models import fastspeech2 as jfs
from test_torch_joint import _assert_grads_match, bin_centres
from test_torch_models import random_variables

V = 20
VOCAB = VocabConfig(size=V)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _cfg(**kw):
    base = dict(encoder_layers=2, encoder_embed_dim=16, encoder_heads=2,
                decoder_layers=2, decoder_embed_dim=16, decoder_heads=2,
                fft_hidden_dim=32, var_pred_hidden_dim=16, dropout=0.0,
                attention_dropout=0.0, var_pred_dropout=0.0, pitch_min=-3.0,
                pitch_max=3.0, energy_min=-3.0, energy_max=3.0)
    return FastSpeech2Config(**{**base, **kw})


def _batch(cfg, seed, B=3, T=7, M=30):
    """Phoneme tokens with a padded tail, gold durations (0 at pads),
    pitches and energies at bucket centres, a mel target."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, V, size=(B, T)).astype(np.int32)
    tokens[1, T - 2:] = VOCAB.pad
    tokens[2, T - 4:] = VOCAB.pad
    durs = rng.integers(0, 5, size=(B, T)).astype(np.int32)
    durs[tokens == VOCAB.pad] = 0
    return {"src_tokens": tokens,
            "target_audio": rng.normal(size=(B, M, 80)).astype(np.float32),
            "target_audio_lengths": np.minimum(durs.sum(1), M).astype(
                np.int32),
            "durations": durs,
            "pitches": bin_centres(rng, cfg.pitch_min, cfg.pitch_max,
                                   (B, T)),
            "energies": bin_centres(rng, cfg.energy_min, cfg.energy_max,
                                    (B, T))}


def _torch_batch(batch):
    return {k: _t(x).long() if x.dtype == np.int32 else _t(x)
            for k, x in batch.items()}


def _token_model(cfg, batch, seed):
    jm = jfs.FastSpeech2Encoder(cfg, vocab_size=V, pad=VOCAB.pad)
    v = random_variables(jm, seed, src_tokens=batch["src_tokens"],
                         max_out_len=batch["target_audio"].shape[1])
    return jm, v


@pytest.mark.parametrize("path", ["tokens", "noemb"])
def test_train_forward_matches_jax(path):
    cfg = _cfg()
    batch = _batch(cfg, 1)
    M = batch["target_audio"].shape[1]
    gold = {k: batch[k] for k in ("durations", "pitches", "energies")}
    if path == "tokens":
        jm, v = _token_model(cfg, batch, 2)
        want = jm.apply(v, src_tokens=batch["src_tokens"], max_out_len=M,
                        train=True, rngs={"dropout": jax.random.key(0)},
                        **gold)
        tm = convert.fs2_from_flax(v, cfg, V, VOCAB.pad, device="cpu")
        got = tm(src_tokens=_t(batch["src_tokens"]).long(), max_out_len=M,
                 durations=_t(gold["durations"]).long(),
                 pitches=_t(gold["pitches"]), energies=_t(gold["energies"]),
                 rng=torch.Generator())
    else:
        rng = np.random.default_rng(3)
        x = rng.normal(size=(3, 7, 16)).astype(np.float32)
        pad = batch["src_tokens"] == VOCAB.pad
        jm = jfs.FastSpeech2Encoder(cfg, vocab_size=0)
        v = random_variables(jm, 4, x=x, enc_pad_mask=pad, max_out_len=M)
        want = jm.apply(v, x=x, enc_pad_mask=pad, max_out_len=M, train=True,
                        rngs={"dropout": jax.random.key(0)}, **gold)
        tm = convert.load_flax_(tfs.FastSpeech2Encoder(cfg), v)
        got = tm(_t(x), _t(pad), M, _t(gold["durations"]).long(),
                 pitches=_t(gold["pitches"]), energies=_t(gold["energies"]),
                 rng=torch.Generator())
    mel, _, lens, log_dur, pitch, energy = want
    t_mel, _, t_lens, t_log_dur, t_pitch, t_energy = got
    np.testing.assert_array_equal(t_lens.numpy(), np.asarray(lens))
    np.testing.assert_allclose(t_mel.detach().numpy(), np.asarray(mel),
                               rtol=0, atol=1e-3)
    for a, b in ((t_log_dur, log_dur), (t_pitch, pitch),
                 (t_energy, energy)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-4)


def test_variance_adaptor_factors_scale_the_predictions():
    cfg = _cfg()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 16)).astype(np.float32)
    pad = np.zeros((2, 6), bool)
    pad[1, 4:] = True
    durs = np.array([[2, 1, 3, 0, 2, 1], [1, 1, 2, 2, 0, 0]], np.int32)
    jm = jfs.VarianceAdaptor(cfg)
    v = random_variables(jm, 6, x, pad, 12, durs, scale=3.0)
    want = jm.apply(v, x, pad, 12, durs, p_factor=1.7, e_factor=0.4)
    tm = convert.load_flax_(tfs.VarianceAdaptor(cfg, 16), v)
    got = tm(_t(x), _t(pad), 12, _t(durs).long(), p_factor=1.7,
             e_factor=0.4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for a, b in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-5)


def test_masked_mean_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    for mask in (rng.random((3, 5)) < 0.5, np.zeros((3, 5), bool),
                 rng.random((3, 5, 4)) < 0.5):
        np.testing.assert_allclose(
            tfl.masked_mean(_t(x), _t(mask)).item(),
            float(jfl.masked_mean(jnp.asarray(x), jnp.asarray(mask))),
            rtol=1e-6, atol=1e-7)


def test_fastspeech2_losses_and_input_gradients_match_jax():
    rng = np.random.default_rng(8)
    B, T, M = 3, 6, 11
    outs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, M, 80), (B, T), (B, T), (B, T))]
    tgts = [rng.normal(size=(B, M, 80)).astype(np.float32),
            rng.integers(0, 6, size=(B, T)).astype(np.int32),
            rng.normal(size=(B, T)).astype(np.float32),
            rng.normal(size=(B, T)).astype(np.float32)]
    src_mask = rng.random((B, T)) < 0.7
    mel_mask = rng.random((B, M)) < 0.7

    def jloss(*o):
        return jfl.fastspeech2_losses(o[0], None, *o[1:], *tgts, src_mask,
                                      mel_mask)

    want, want_m = jloss(*outs)
    want_g = jax.grad(lambda *o: jloss(*o)[0], argnums=(0, 1, 2, 3))(*outs)
    ts = [_t(o, True) for o in outs]
    got, got_m = tfl.fastspeech2_losses(
        ts[0], None, *ts[1:], _t(tgts[0]), _t(tgts[1]).long(),
        _t(tgts[2]), _t(tgts[3]), _t(src_mask), _t(mel_mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]),
                                   rtol=1e-6)
    for a, b in zip(ts, want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_criterion_loss_and_every_gradient_match_jax():
    cfg = _cfg()
    batch = _batch(cfg, 9)
    batch["sample_mask"] = np.array([1, 1, 0], np.int32)  # a fill row
    jm, v = _token_model(cfg, batch, 10)

    def lossf(params):
        return jtts.fastspeech2_criterion(
            jm, {"params": params},
            {k: jnp.asarray(x) for k, x in batch.items()},
            jax.random.key(0), VOCAB)

    (want, aux), grads = jax.value_and_grad(lossf, has_aux=True)(
        jax.tree.map(jnp.asarray, v["params"]))
    tm = convert.fs2_from_flax(v, cfg, V, VOCAB.pad, device="cpu")
    loss, metrics = ttts.fastspeech2_criterion(
        tm, _torch_batch(batch), torch.Generator(), VOCAB)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for k in ("l1-loss", "dur-loss", "pitch-loss", "energy-loss"):
        np.testing.assert_allclose(metrics[k].item(),
                                   float(aux["metrics"][k]), rtol=1e-5)
    _assert_grads_match(tm, jax.tree.map(np.asarray, grads))


def test_dropout_sites_and_rates():
    """A training pass draws dropout at JAX's sites, in its order: the
    encoder input (``dropout``), after each conv FFN (``dropout``), twice
    in each variance predictor (``var_pred_dropout``); the FFT attention
    draws per-row kernel seeds only at ``attention_dropout`` > 0. Without a
    generator nothing drops, and the same seed drops the same elements."""
    cfg = _cfg(dropout=0.2, var_pred_dropout=0.5, attention_dropout=0.1)
    batch = _batch(cfg, 11)
    tm = tfs.FastSpeech2Encoder(cfg, vocab_size=V, pad=VOCAB.pad)
    tb = _torch_batch(batch)
    rates, seeds = [], []
    orig_drop, orig_seeds = tfs.dropout, tlayers.row_seeds

    def spy_drop(x, rate, rng):
        if rng is not None:
            rates.append(rate)
        return orig_drop(x, rate, rng)

    def spy_seeds(rng, rate, B, device):
        if rng is not None:
            seeds.append(rate)
        return orig_seeds(rng, rate, B, device)

    kw = dict(src_tokens=tb["src_tokens"], max_out_len=30,
              durations=tb["durations"], pitches=tb["pitches"],
              energies=tb["energies"])
    try:
        tfs.dropout, tlayers.row_seeds = spy_drop, spy_seeds
        out1 = tm(**kw, rng=torch.Generator().manual_seed(3))[0]
    finally:
        tfs.dropout, tlayers.row_seeds = orig_drop, orig_seeds
    n_fft = cfg.encoder_layers + cfg.decoder_layers
    assert rates == ([0.2] + [0.2] * cfg.encoder_layers + [0.5] * 6
                     + [0.2] * cfg.decoder_layers)
    assert seeds == [0.1] * n_fft
    out2 = tm(**kw, rng=torch.Generator().manual_seed(3))[0]
    out3 = tm(**kw, rng=torch.Generator().manual_seed(4))[0]
    eval_out = tm(**kw)[0]
    assert torch.equal(out1, out2) and not torch.equal(out1, out3)
    assert not torch.equal(out1, eval_out)
    assert torch.equal(eval_out, tm(**kw)[0])


def test_adaptor_dropout():
    a = tfs.FFNAdapter(8, 16, 8, dropout=0.5)
    x = torch.randn(2, 5, 8)
    assert torch.equal(a(x), a(x))
    g = torch.Generator().manual_seed(0)
    assert not torch.equal(a(x, g), a(x))


@pytest.mark.parametrize("kw", [dict(add_postnet=True), dict(ctc_weight=0.1),
                                dict(fused_attention=False),
                                dict(num_speakers=2)])
def test_option_matches_jax(kw):
    """Each option alone, on the token path in eval mode: the mel and the
    Postnet's mel within 1e-3 of JAX's, the CTC logits within 1e-4, the
    lengths equal (``tests/test_torch_fs2_options.py`` takes all four
    together through a training step)."""
    cfg = _cfg(**kw)
    batch = _batch(cfg, 40)
    spk = np.array([1, 0, 1], np.int32)
    jm, v = _token_model(cfg, batch, 41)
    M = batch["target_audio"].shape[1]
    want, mut = jm.apply(v, src_tokens=batch["src_tokens"], max_out_len=M,
                         durations=batch["durations"], speaker=spk,
                         mutable=["intermediates"])
    tm = convert.fs2_from_flax(v, cfg, V, VOCAB.pad, device="cpu").eval()
    with torch.no_grad():
        got = tm(src_tokens=_t(batch["src_tokens"]).long(), max_out_len=M,
                 durations=_t(batch["durations"]).long(),
                 speaker=_t(spk).long())
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-3)
    assert (got[1] is None) == (want[1] is None) == (not cfg.add_postnet)
    if cfg.add_postnet:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=1e-3)
    assert (len(got) == 7) == (cfg.ctc_weight > 0)
    if cfg.ctc_weight > 0:
        np.testing.assert_allclose(
            got[6].numpy(), np.asarray(mut["intermediates"]["ctc_logits"][0]),
            rtol=0, atol=1e-4)


def test_pretraining_updates_lower_the_loss():
    cfg = _cfg()
    torch.manual_seed(0)
    model = tfs.FastSpeech2Encoder(cfg, vocab_size=V, pad=VOCAB.pad)
    opt = GuardedAdam(lr=3e-3, warmup_updates=5, weight_decay=0.0)
    state = TrainState.create(model, opt)
    step = make_train_step(
        lambda m, b, g: ttts.fastspeech2_criterion(m, b, g, VOCAB), opt)
    tb = _torch_batch(_batch(cfg, 12))
    gen = torch.Generator().manual_seed(0)
    losses = [step(state, tb, gen)["loss"].item() for _ in range(40)]
    assert losses[-1] < 0.5 * losses[0], losses[::8]
