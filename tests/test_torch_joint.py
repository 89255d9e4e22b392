"""The port's joint S2ST training step (``daspeech_torch``) against the JAX
package, on the CPU at small widths.

* head-major attention (``ops.fused_attention.fused_attention``): the plain
  forward and its closed-form gradients against JAX ``fused_attention`` in
  Pallas interpret mode, at JAX's own tolerances (forward 1e-5; gradients
  rtol 1e-4, atol 1e-5); with dropout it drops the packed layout's
  elements;
* ``packed_route`` equals JAX ``packed_fits_vmem`` on a grid of shapes
  spanning both switch points, and ``MultiHeadAttention`` takes the
  head-major path above the switch (and still matches the JAX layer);
* ``s2s_dag_fastspeech2_loss``, ``expect`` and ``argmax``, on a small
  ``S2SConformerDAGFastSpeech2`` (2 encoder layers, 1 decoder layer, 2+2
  FastSpeech 2 layers), dropout 0, GLAT p = 0.5 on JAX's glance draws,
  one target padded: loss to 1e-5 relative, each gradient to 1e-4 of its
  own largest entry or of 1e-3, whichever is larger (as
  ``test_torch_train.py``; the key biases, whose exact gradient is 0, to
  1e-4 of their kernel's gradient), BatchNorm statistics to 1e-5;
* ``freeze_dag``: every DAG and encoder gradient exactly 0 in both
  packages, the adaptor and FastSpeech 2 gradients nonzero and equal;
  two guarded Adam steps (one free, one frozen) equal the optax chain's;
* a learnability run of the joint loss.

Pitch and energy targets lie at bucket centres: the two packages' bucket
edges differ by an ulp on some edges (ROADMAP Queue 3). Their range is a
normalized one (-3 to 3): at the raw default ranges (0-600, 0-5000) the
squared errors put the gradients at 1e4, where the key biases' rounding
noise (their exact gradient is 0) passes the 1e-3 floor.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import optax

from daspeech_torch import convert
from daspeech_torch.losses import dag_loss as tloss
from daspeech_torch.losses import s2s_loss as ts2s
from daspeech_torch.models import graph_lengths, initialize_output_tokens
from daspeech_torch.models import layers as tlayers
from daspeech_torch.models import s2s_model as tmodel
from daspeech_torch.ops import fused_attention as tfa
from daspeech_torch.train import GuardedAdam, TrainState, make_train_step
from daspeech_tpu.core.config import (ConformerConfig, DAGDecoderConfig,
                                      DAGModelConfig, FastSpeech2Config,
                                      S2SModelConfig, VocabConfig)
from daspeech_tpu.losses import s2s_loss as js2s
from daspeech_tpu.models import dag_model as jdag
from daspeech_tpu.models import layers as jlayers
from daspeech_tpu.models import s2s_model as jmodel
from daspeech_tpu.ops import fused_attention as jfa
from daspeech_tpu.train import train_state as jts
from test_torch_models import random_variables
from test_torch_train import _fast_init_, _grad_pairs

N_BINS = 256


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _hm_inputs(B, H, Tq, Tk, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, T, d)).astype(np.float32)
               for T in (Tq, Tk, Tk))
    valid = np.ones((B, Tk), bool)
    valid[-1, -3:] = False
    bias = np.where(valid, 0.0, tfa.NEG).astype(np.float32)
    g = rng.normal(size=(B, H, Tq, d)).astype(np.float32)
    return q, k, v, bias, g, 1.0 / math.sqrt(d)


class TestHeadMajorAttention:
    @pytest.mark.parametrize("B,H,Tq,Tk,d", [(2, 3, 10, 13, 16),
                                             (1, 2, 8, 130, 64),
                                             (2, 2, 33, 17, 64)])
    def test_forward_and_gradients_match_pallas(self, B, H, Tq, Tk, d):
        q, k, v, bias, g, sc = _hm_inputs(B, H, Tq, Tk, d, Tq + Tk)
        want, vjp = jax.vjp(lambda q, k, v: jfa.fused_attention(
            q, k, v, jnp.asarray(bias), 0, sc, 0.0, False), q, k, v)
        want_g = vjp(jnp.asarray(g))
        ts = [_t(x, True) for x in (q, k, v)]
        out = tfa.fused_attention(*ts, _t(bias), sc)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        out.backward(_t(g))
        for x, w in zip(ts, want_g):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-5)

    def test_dropout_drops_the_packed_layouts_elements(self):
        """Both layouts key the mask by (row seed, j / 4, i, h): at one
        shape they agree exactly, forward and backward."""
        B, H, T, d, p = 2, 3, 11, 8, 0.3
        q, k, v, bias, g, sc = _hm_inputs(B, H, T, T, d, 4)
        seeds = torch.tensor([5, -77], dtype=torch.int32)

        def packed(x):
            return x.transpose(1, 2).reshape(B, x.shape[2], H * d)

        hm = [_t(x, True) for x in (q, k, v)]
        out = tfa.fused_attention(*hm, _t(bias), sc, p, seeds)
        pk = [_t(packed(torch.tensor(x)), True) for x in (q, k, v)]
        out_p = tfa.fused_attention_packed(*pk, _t(bias), H, sc, p, seeds)
        np.testing.assert_array_equal(packed(out).detach().numpy(),
                                      out_p.detach().numpy())
        out.backward(_t(g))
        out_p.backward(packed(_t(g)))
        for a, b in zip(hm, pk):
            np.testing.assert_allclose(packed(a.grad).numpy(),
                                       b.grad.numpy(), rtol=0, atol=1e-6)
        nodrop = tfa.attention_hm_plain(*hm, _t(bias), sc)
        assert (nodrop - out).abs().max().item() > 1e-3

    def test_autograd_of_the_plain_forward_equals_the_closed_form(self):
        q, k, v, bias, g, sc = _hm_inputs(2, 2, 9, 12, 8, 6)
        seeds = torch.tensor([3, 4], dtype=torch.int32)
        ts = [_t(x, True) for x in (q, k, v)]
        out = tfa.attention_hm_plain(*ts, _t(bias), sc, 0.2, seeds)
        want = torch.autograd.grad(out, ts, _t(g))
        got = tfa.attention_hm_bwd_plain(*[x.detach() for x in ts], _t(bias),
                                         _t(g), sc, 0.2, seeds)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("C,H", [(256, 4), (512, 8), (16, 2)])
def test_packed_route_is_the_jax_route(C, H):
    # the switch points: FastSpeech 2 (C=256) at 798 frames, the DAG
    # decoder (C=512) at 683 vertices
    for Tq in (1, 240, 682, 683, 700, 797, 798, 940, 1040):
        for Tk in (Tq, 120, 350, 1040):
            assert tfa.packed_route(Tq, Tk, C, H) == \
                jfa.packed_fits_vmem(Tq, Tk, C, H), (Tq, Tk, C, H)
    assert tfa.packed_route(797, 797, 256, 4)
    assert not tfa.packed_route(798, 798, 256, 4)
    assert tfa.packed_route(682, 682, 512, 8)
    assert not tfa.packed_route(683, 683, 512, 8)


@pytest.mark.parametrize("T", [40, 940])
def test_mha_takes_the_jax_route_and_matches(T, monkeypatch):
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T, 16)).astype(np.float32)
    kpm = np.zeros((2, T), bool)
    kpm[1, T // 2:] = True
    jm = jlayers.MultiHeadAttention(16, 2, 0.0)
    v = random_variables(jm, 2, x, x, x, key_padding_mask=kpm)
    want = jm.apply(v, x, x, x, key_padding_mask=kpm)
    tm = convert.load_flax_(tlayers.MultiHeadAttention(16, 2), v)
    calls = []
    for name in ("fused_attention", "fused_attention_packed"):
        orig = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _o=orig, _n=name, **kw: (
            calls.append(_n), _o(*a, **kw))[1])
    got = tm(_t(x), _t(x), _t(x), key_padding_mask=_t(kpm))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    assert calls == (["fused_attention_packed"] if T == 40
                     else ["fused_attention"])


# ---------------------------------------------------------------------------
# the joint loss
# ---------------------------------------------------------------------------

def _small_cfg():
    return S2SModelConfig(
        dag=DAGModelConfig(
            vocab=VocabConfig(size=16),
            encoder=ConformerConfig(embed_dim=16, ffn_dim=32, num_layers=2,
                                    num_heads=2, dropout=0.0,
                                    attn_dropout=0.0,
                                    depthwise_kernel_size=7, conv_channels=8),
            decoder=DAGDecoderConfig(embed_dim=32, ffn_dim=64, num_layers=1,
                                     num_heads=2, dropout=0.0,
                                     attn_dropout=0.0,
                                     activation_dropout=0.0,
                                     max_target_positions=64)),
        tts=FastSpeech2Config(encoder_layers=2, encoder_embed_dim=16,
                              encoder_heads=2, decoder_layers=2,
                              decoder_embed_dim=16, decoder_heads=2,
                              fft_hidden_dim=32, var_pred_hidden_dim=16,
                              dropout=0.0, attention_dropout=0.0,
                              var_pred_dropout=0.0, pitch_min=-3.0,
                              pitch_max=3.0, energy_min=-3.0,
                              energy_max=3.0),
        adaptor_ffn_dim=24, adaptor_dropout=0.0)


def bin_centres(rng, lo, hi, shape):
    """Values at the centres of random pitch/energy buckets (away from the
    edges, where the two packages' linspace may differ by an ulp)."""
    edges = np.linspace(lo, hi, N_BINS - 1)
    i = rng.integers(0, N_BINS - 2, size=shape)
    return ((edges[i] + edges[i + 1]) / 2).astype(np.float32)


def _joint_batch(cfg, seed, B=3, S=48, T=6, M=24):
    rng = np.random.default_rng(seed)
    vocab = cfg.dag.vocab
    fbank = rng.normal(size=(B, S, 80)).astype(np.float32)
    lens = np.array([S, S - 8, S - 16][:B], np.int32)
    prev = np.asarray(jdag.initialize_output_tokens(
        jdag.graph_lengths(jnp.asarray(lens), 0.5, 64), S // 2, vocab))
    tgt = rng.integers(4, vocab.size, size=(B, T)).astype(np.int32)
    tgt[:, 0], tgt[:, -1] = vocab.bos, vocab.eos
    tgt[2, T - 2:] = vocab.pad                     # a padded target
    tgt[2, T - 3] = vocab.eos
    durs = rng.integers(1, 5, size=(B, T - 1)).astype(np.int32)
    durs[2, T - 3:] = 0
    tts = cfg.tts
    return {"fbank": fbank, "src_lengths": lens, "target_text": tgt,
            "prev_output_tokens": prev,
            "target_audio": rng.normal(size=(B, M, 80)).astype(np.float32),
            "target_audio_lengths": np.minimum(durs.sum(1), M).astype(
                np.int32),
            "durations": durs,
            "pitches": bin_centres(rng, tts.pitch_min, tts.pitch_max,
                                   (B, T - 1)),
            "energies": bin_centres(rng, tts.energy_min, tts.energy_max,
                                    (B, T - 1))}


def _joint_variables(jm, batch, seed):
    fbank, lens = batch["fbank"], batch["src_lengths"]
    prev, M = batch["prev_output_tokens"], batch["target_audio"].shape[1]
    B, T = batch["target_text"].shape

    def full(m, fbank, lens, prev):
        _, _, feats = m(fbank, lens, prev)
        return m.synthesize(feats[:, :T - 1], jnp.zeros((B, T - 1), bool),
                            M)

    return random_variables(jm, seed, fbank, lens, prev, method=full)


def _torch_batch(batch):
    return {k: _t(x).long() if x.dtype == np.int32 else _t(x)
            for k, x in batch.items()}


def _glance_draws(key, B, L):
    """The glance draws JAX made: the joint loss splits dropout | glat |
    tts, then ``glat_glance`` splits rand | keep."""
    _, k_glat, _ = jax.random.split(key, 3)
    k_rand, k_keep = jax.random.split(k_glat)
    return tloss.GlanceDraws(
        _t(jax.random.normal(k_rand, (B, L), dtype=jnp.float32)),
        _t(jax.random.uniform(k_keep, (B, L))))


def _jax_value_and_grad(jm, v, batch, key, p, cfg, **kw):
    def lossf(params):
        return js2s.s2s_dag_fastspeech2_loss(
            jm, {"params": params, "batch_stats": v["batch_stats"]},
            {k: jnp.asarray(x) for k, x in batch.items()}, key,
            jnp.float32(p), cfg.dag.vocab, **kw)

    (loss, aux), grads = jax.value_and_grad(lossf, has_aux=True)(
        jax.tree.map(jnp.asarray, v["params"]))
    return float(loss), aux, jax.tree.map(np.asarray, grads)


KEY_BIASES = ("k_proj/bias", "linear_k/bias", "key_linear/bias")


def _assert_grads_match(tm, jgrads):
    """Each gradient within 1e-4 of its largest entry, or of 1e-3 if that
    is larger. A key projection's bias shifts every score of a softmax row
    alike, so its exact gradient is 0 and both sides hold rounding noise of
    the size of the projection's other gradients (up to 1.2e-6 here, under
    a joint loss of ~55): it is held to 1e-4 of its kernel's gradient."""
    kernels = dict(convert._leaves(jgrads))
    n = 0
    for name, got, want in _grad_pairs(tm, jgrads):
        scale = max(float(np.abs(want).max()), 1e-3)
        if name.endswith(KEY_BIASES):
            path = tuple(name.split("/")[:-1]) + ("kernel",)
            scale = max(scale, float(np.abs(kernels[path]).max()))
        got = torch.zeros(want.shape) if got is None else got
        err = float((got - torch.tensor(want)).abs().max()) / scale
        assert err <= 1e-4, (name, err)
        n += 1
    assert n == sum(1 for _ in tm.parameters())


@pytest.fixture(scope="module")
def joint_setup():
    cfg = _small_cfg()
    batch = _joint_batch(cfg, 0)
    jm = jmodel.S2SConformerDAGFastSpeech2(cfg)
    return cfg, batch, jm, _joint_variables(jm, batch, 1)


@pytest.mark.parametrize("strategy", ["expect", "argmax"])
def test_joint_loss_and_gradients_match_jax(joint_setup, strategy):
    cfg, batch, jm, v = joint_setup
    key = jax.random.key(5)
    want_loss, aux, want_grads = _jax_value_and_grad(
        jm, v, batch, key, 0.5, cfg, training_strategy=strategy)
    B, L = batch["prev_output_tokens"].shape
    tm = convert.s2s_from_flax(v, cfg, device="cpu")
    loss, metrics = ts2s.s2s_dag_fastspeech2_loss(
        tm, _torch_batch(batch), torch.Generator(), 0.5, cfg.dag.vocab,
        training_strategy=strategy, glat_draws=_glance_draws(key, B, L))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    assert float(aux["metrics"]["glat_keep"]) > 0        # it glanced
    for name in ("dag-loss", "tts-loss", "l1-loss", "dur-loss",
                 "pitch-loss", "energy-loss"):
        np.testing.assert_allclose(metrics[name].item(),
                                   float(aux["metrics"][name]), rtol=1e-5,
                                   atol=1e-6)
    _assert_grads_match(tm, want_grads)
    for path, x in convert._leaves(jax.tree.map(np.asarray,
                                                aux["batch_stats"])):
        owner = tm
        for name in path[:-1]:
            owner = convert._resolve(owner, name)
        attr, want = convert._convert(owner, path[-1], x)
        np.testing.assert_allclose(getattr(owner, attr).numpy(), want,
                                   rtol=0, atol=1e-5)


def test_expected_features_of_padded_rows_are_zero():
    """A padded target row has beta = -inf, so exp(-inf - (-inf)) is NaN,
    which the score turns into 0 (``s2s_loss.py:47-49``)."""
    rng = np.random.default_rng(3)
    B, T, L, D = 2, 5, 7, 4
    alpha = rng.normal(size=(B, T, L)).astype(np.float32)
    beta = rng.normal(size=(B, T, L)).astype(np.float32)
    beta[1, 3:] = -np.inf
    alpha[0, 2, 4:] = -np.inf
    feats = rng.normal(size=(B, L, D)).astype(np.float32)
    want = js2s.expected_features(jnp.asarray(alpha), jnp.asarray(beta),
                                  jnp.asarray(feats))
    got = ts2s.expected_features(_t(alpha), _t(beta), _t(feats))
    assert got.shape == (B, T - 1, D) and torch.isfinite(got).all()
    assert torch.equal(got[1, 2:], torch.zeros(2, D))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_argmax_path_features_match_jax(joint_setup):
    cfg, batch, jm, v = joint_setup
    rng = np.random.default_rng(8)
    B, L = batch["prev_output_tokens"].shape
    logits = rng.normal(size=(B, L, cfg.dag.vocab.size)).astype(np.float32)
    tm = convert.s2s_from_flax(v, cfg, device="cpu")
    tb = _torch_batch(batch)
    with torch.no_grad():
        enc, enc_pad, _ = tm.encode(tb["fbank"], tb["src_lengths"])
        _, links, feats = tm.decode(tb["prev_output_tokens"], enc, enc_pad)
    want, want_len = js2s.argmax_path_features(
        jnp.asarray(logits), jnp.asarray(links.numpy()),
        jnp.asarray(batch["target_text"]),
        jnp.asarray(batch["prev_output_tokens"]), jnp.asarray(feats.numpy()),
        cfg.dag.vocab.pad)
    got, got_len = ts2s.argmax_path_features(
        _t(logits), links, tb["target_text"], tb["prev_output_tokens"],
        feats, cfg.dag.vocab.pad)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert int(got_len.min()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("step,n,frozen", [(0, -1, False), (0, 0, False),
                                           (0, 2, True), (2, 2, True),
                                           (3, 2, False)])
def test_dag_frozen_follows_the_cli(step, n, frozen):
    assert ts2s.dag_frozen(step, n) is frozen


def _dag_params(tm):
    return {id(p) for p in tm.dag.parameters()}


def test_freeze_dag_zeroes_every_dag_gradient(joint_setup):
    cfg, batch, jm, v = joint_setup
    key = jax.random.key(9)
    _, _, want_grads = _jax_value_and_grad(jm, v, batch, key, 0.5, cfg,
                                           freeze_dag=True)
    for path, g in convert._leaves(want_grads["dag"]):
        assert not g.any(), path
    B, L = batch["prev_output_tokens"].shape
    tm = convert.s2s_from_flax(v, cfg, device="cpu")
    loss, _ = ts2s.s2s_dag_fastspeech2_loss(
        tm, _torch_batch(batch), torch.Generator(), 0.5, cfg.dag.vocab,
        freeze_dag=True, glat_draws=_glance_draws(key, B, L))
    loss.backward()
    for name, p in tm.named_parameters():
        if name.startswith("dag."):
            assert p.grad is None or not p.grad.any(), name
        else:
            assert p.grad is not None and p.grad.abs().max() > 0, name
    _assert_grads_match(tm, want_grads)


def test_freeze_encoder_zeroes_only_the_encoder(joint_setup):
    cfg, batch, jm, v = joint_setup
    tm = convert.s2s_from_flax(v, cfg, device="cpu")
    loss, _ = ts2s.s2s_dag_fastspeech2_loss(
        tm, _torch_batch(batch), torch.Generator().manual_seed(1), 0.5,
        cfg.dag.vocab, freeze_encoder=True)
    loss.backward()
    for name, p in tm.named_parameters():
        if name.startswith("dag.encoder."):
            assert p.grad is None, name
        elif name.startswith(("dag.decoder.layers", "tts.", "adaptor.")):
            assert p.grad is not None and p.grad.abs().max() > 0, name


def test_free_then_frozen_steps_match_optax(joint_setup):
    """Two guarded Adam steps through ``make_train_step``, the first free,
    the second with the DAG frozen, against optax's chain fed the same
    gradients: a frozen parameter's gradient is zero, and Adam still
    applies its moments and the weight decay to it, as optax does."""
    cfg, batch, jm, v = joint_setup
    tm = convert.s2s_from_flax(v, cfg, device="cpu")
    opt = GuardedAdam(lr=1e-2, warmup_updates=2)
    state = TrainState.create(tm, opt)
    step = make_train_step(
        lambda m, b, g: ts2s.s2s_dag_fastspeech2_loss(
            m, b, g, 0.5, cfg.dag.vocab, freeze_dag=state.step == 1), opt)
    tx = jts.make_optimizer(lr=1e-2, warmup_updates=2, weight_decay=0.01,
                            clip_norm=1.0)
    names = [n for n, _ in tm.named_parameters()]
    params = {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}
    opt_state = tx.init(params)
    tb = _torch_batch(batch)
    frozen = [n for n in names if n.startswith("dag.")]
    for i in range(2):
        before = {n: np.asarray(params[n]) for n in frozen}
        step(state, tb, torch.Generator().manual_seed(i))
        grads = {n: np.zeros(p.shape, np.float32) if p.grad is None
                 else p.grad.numpy().copy()
                 for n, p in zip(names, state.params)}
        assert all(not grads[n].any() for n in frozen) == (i == 1)
        upd, opt_state = jax.jit(tx.update)(grads, opt_state, params)
        params = jax.jit(optax.apply_updates)(params, upd)
        for n, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[n]), rtol=0,
                                       atol=1e-6, err_msg=n)
    # the frozen step still moved the DAG's weights (moments, decay)
    assert all(not np.array_equal(before[n], np.asarray(params[n]))
               for n in frozen if not n.endswith("pos_bias_u"))
    assert state.step == 2


def test_joint_training_learns_synthetic_mapping():
    """``test_torch_train.py``'s learnability run on the joint loss: the
    synthetic fbank -> phoneme mapping of ``tests/test_learning.py``, and a
    mel of one pattern per phoneme over 3 frames. In 200 updates the joint
    loss falls below half of its first value, the mel L1 below 0.8 of its
    first."""
    from test_learning import FRAMES_PER_PHONE, synth_batch

    vocab = VocabConfig(size=16)
    cfg = S2SModelConfig(
        dag=DAGModelConfig(
            vocab=vocab,
            encoder=ConformerConfig(embed_dim=32, ffn_dim=64, num_layers=2,
                                    num_heads=2, conv_channels=32,
                                    depthwise_kernel_size=7, dropout=0.0,
                                    attn_dropout=0.0),
            decoder=DAGDecoderConfig(embed_dim=32, ffn_dim=64, num_layers=2,
                                     num_heads=2, dropout=0.0,
                                     attn_dropout=0.0,
                                     activation_dropout=0.0,
                                     max_target_positions=64)),
        tts=FastSpeech2Config(encoder_layers=1, encoder_embed_dim=16,
                              encoder_heads=2, decoder_layers=1,
                              decoder_embed_dim=16, decoder_heads=2,
                              fft_hidden_dim=32, var_pred_hidden_dim=16,
                              fft_kernel_size=3, dropout=0.0,
                              var_pred_dropout=0.0),
        adaptor_ffn_dim=32, adaptor_dropout=0.0)
    model = _fast_init_(tmodel.S2SConformerDAGFastSpeech2(cfg), 0)
    with torch.no_grad():
        model.tts.pos_emb_alpha.fill_(1.0)
        model.tts.dec_pos_emb_alpha.fill_(1.0)
    rng = np.random.default_rng(0)
    n_phones, B, L, D = 4, 16, 16, 3
    M = n_phones * D
    patterns = np.random.default_rng(1).normal(size=(16, 80)).astype(
        np.float32)
    prev = initialize_output_tokens(
        graph_lengths(torch.full((B,), n_phones * FRAMES_PER_PHONE), 0.5, 64),
        L, vocab)
    opt = GuardedAdam(lr=2e-3, warmup_updates=20, weight_decay=0.0)
    state = TrainState.create(model, opt)
    step = make_train_step(
        lambda m, b, g: ts2s.s2s_dag_fastspeech2_loss(m, b, g, 0.5, vocab),
        opt)
    gen = torch.Generator().manual_seed(1)
    losses, l1 = [], []
    for _ in range(200):
        fb, sl, tg = synth_batch(rng, vocab, B, n_phones)
        mel = np.repeat(patterns[tg[:, 1:-1]], D, axis=1)
        b = {"fbank": _t(fb), "src_lengths": _t(sl).long(),
             "target_text": _t(tg).long(), "prev_output_tokens": prev,
             "target_audio": _t(np.concatenate(
                 [mel, np.zeros((B, D, 80), np.float32)], axis=1)),
             "target_audio_lengths": torch.full((B,), M),
             "durations": torch.full((B, n_phones + 1), D),
             "pitches": torch.zeros(B, n_phones + 1),
             "energies": torch.zeros(B, n_phones + 1)}
        b["durations"][:, -1] = 0
        m = step(state, b, gen)
        losses.append(m["loss"].item())
        l1.append(m["l1-loss"].item())
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    assert l1[-1] < 0.8 * l1[0], (l1[0], l1[-1])
