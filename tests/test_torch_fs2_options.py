"""FastSpeech 2's options in the port (``daspeech_torch``) against the JAX
package on the CPU, at small widths (2+2 FFT layers, 16 wide): the
Postnet, the speaker embedding, the CTC head and the unfused attention,
all off in every recipe.

* ``fastspeech2_ctc_loss`` within 1e-5 relative of JAX's, at random
  cases and at JAX's own: an infeasible sentence, adjacent repeats that
  need a blank more, a filler row (``tests/test_fastspeech2_ctc.py``);
* the four options together: eval-mode ``mel`` and ``mel_post`` within
  1e-3, one ``fastspeech2_criterion`` step (loss within 1e-4 relative,
  every gradient within 1e-3 of the global norm) and the Postnet's
  running statistics after that training pass within 1e-5;
* the TTS generator serves the Postnet's mel and takes the batch's
  speakers;
* JAX's criterion cannot train a Postnet (ROADMAP Queue 3); the port's
  can;
* the four options in bf16 within 2 ||jax_bf16 - jax_fp32||.

JAX's criterion applies the model without the ``batch_stats`` collection,
so a training pass through its Postnet needs one: :class:`WithStats`
hands it in.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daspeech_torch import convert
from daspeech_torch.decode import speech_generator as tsg
from daspeech_torch.losses import tts_loss as ttl
from daspeech_tpu.decode import speech_generator as jsg
from daspeech_tpu.losses import tts_loss as jtl
from test_torch_ar import _assert_step
from test_torch_fs2_train import (
    V, VOCAB, _batch, _cfg, _t, _token_model, _torch_batch)

OPTIONS = dict(add_postnet=True, postnet_layers=3, postnet_conv_dim=24,
               postnet_conv_kernel_size=5, postnet_dropout=0.0,
               num_speakers=3, speaker_embed_dim=8, ctc_weight=0.1,
               fused_attention=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class WithStats:
    """A JAX FastSpeech 2 whose ``apply`` takes its BatchNorm statistics
    along and lets a training pass move them (discarded: the statistics
    after a pass come from :func:`jax_stats_after`)."""

    def __init__(self, jm, stats):
        self.jm, self.stats, self.cfg = jm, stats, jm.cfg

    def apply(self, variables, mutable=False, **kw):
        cols = ["batch_stats"] + (list(mutable) if mutable else [])
        out, mut = self.jm.apply({**variables, "batch_stats": self.stats},
                                 mutable=cols, **kw)
        return (out, mut) if mutable else out


def jax_stats_after(jm, v, batch):
    """The Postnet's statistics after one training pass of ``batch``."""
    _, mut = jm.apply(v, src_tokens=batch["src_tokens"],
                      max_out_len=batch["target_audio"].shape[1],
                      durations=batch["durations"],
                      pitches=batch["pitches"], energies=batch["energies"],
                      speaker=batch.get("speaker"), train=True,
                      rngs={"dropout": jax.random.key(0)},
                      mutable=["batch_stats", "intermediates"])
    return mut["batch_stats"]


def criterion_step(cfg, batch, seed):
    """One ``fastspeech2_criterion`` step in both packages, held to the
    step bars: (JAX module, variables, port model after its backward)."""
    jm, v = _token_model(cfg, batch, seed)
    model = WithStats(jm, v.get("batch_stats", {})) if cfg.add_postnet \
        else jm

    def lossf(params):
        return jtl.fastspeech2_criterion(
            model, {"params": params},
            {k: jnp.asarray(x) for k, x in batch.items()},
            jax.random.key(0), VOCAB)

    (want, aux), grads = jax.value_and_grad(lossf, has_aux=True)(
        jax.tree.map(jnp.asarray, v["params"]))
    tm = convert.fs2_from_flax(v, cfg, V, VOCAB.pad, device="cpu")
    loss, metrics = ttl.fastspeech2_criterion(tm, _torch_batch(batch),
                                              torch.Generator(), VOCAB)
    loss.backward()
    _assert_step(tm, loss, want, grads)
    for k, w in aux["metrics"].items():
        np.testing.assert_allclose(metrics[k].item(), float(w), rtol=1e-4)
    return jm, v, tm


def _options_batch(cfg, seed):
    batch = _batch(cfg, seed)
    batch["speaker"] = np.array([2, 0, 1], np.int32)
    batch["sample_mask"] = np.array([1, 1, 0], np.int32)
    return batch


# ------------------------------------------------------------------ CTC

def _ctc_case(rng, B=4, M=24, T=6, Vc=11):
    logits = rng.normal(0, 1.5, size=(B, M, Vc)).astype(np.float32)
    in_lens = rng.integers(T + 2, M + 1, size=(B,))
    lab_lens = rng.integers(1, T + 1, size=(B,))
    labels = rng.integers(2, Vc, size=(B, T)).astype(np.int32)
    mel_mask = np.arange(M)[None] < in_lens[:, None]
    src_mask = np.arange(T)[None] < lab_lens[:, None]
    return logits, mel_mask, np.where(src_mask, labels, 1), src_mask


def _infeasible(case):
    logits, mel_mask, labels, src_mask = case
    mel_mask[0, 2:] = False              # 2 frames, 4 labels
    src_mask[0, :] = False
    src_mask[0, :4] = True
    labels[0, :4] = [4, 5, 4, 6]
    return case


def _repeats(case):
    logits, mel_mask, labels, src_mask = case
    mel_mask[0, :] = False
    mel_mask[0, :4] = True               # 4 frames, 4 labels, one repeat
    src_mask[0, :] = False
    src_mask[0, :4] = True
    labels[0, :4] = [4, 4, 5, 6]
    return case


def _filler(case):
    case[3][3] = False                   # a sample_mask row: no label
    return case


@pytest.mark.parametrize("seed,edit", [
    (0, None), (1, None), (2, None), (3, _infeasible), (7, _repeats),
    (4, _filler)], ids=["random0", "random1", "random2", "infeasible",
                        "repeats", "filler"])
def test_ctc_loss_matches_jax(seed, edit):
    case = _ctc_case(np.random.default_rng(seed))
    if edit is not None:
        case = edit(case)
    want = float(jtl.fastspeech2_ctc_loss(*map(jnp.asarray, case)))
    got = ttl.fastspeech2_ctc_loss(*map(_t, case)).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ctc_infeasible_row_has_no_gradient():
    logits, mel_mask, labels, src_mask = _infeasible(
        _ctc_case(np.random.default_rng(3)))
    x = _t(logits).requires_grad_()
    ttl.fastspeech2_ctc_loss(x, _t(mel_mask), _t(labels),
                             _t(src_mask)).backward()
    assert torch.isfinite(x.grad).all()
    assert float(x.grad[0].abs().max()) == 0.0
    assert float(x.grad[1].abs().max()) > 0.0


# ------------------------------------------------------------ together

def test_all_options_eval_forward():
    cfg = _cfg(**OPTIONS)
    batch = _options_batch(cfg, 31)
    jm, v = _token_model(cfg, batch, 32)
    M = batch["target_audio"].shape[1]
    kw = dict(max_out_len=M, durations=batch["durations"])
    want, mut = jm.apply(v, src_tokens=batch["src_tokens"],
                         speaker=batch["speaker"], mutable=["intermediates"],
                         **kw)
    tm = convert.fs2_from_flax(v, cfg, V, VOCAB.pad, device="cpu").eval()
    with torch.no_grad():
        got = tm(src_tokens=_t(batch["src_tokens"]).long(), max_out_len=M,
                 durations=_t(batch["durations"]).long(),
                 speaker=_t(batch["speaker"]).long())
    assert len(got) == 7
    for g, w in ((got[0], want[0]), (got[1], want[1]),
                 (got[6], mut["intermediates"]["ctc_logits"][0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_all_options_criterion_step_and_statistics():
    cfg = _cfg(**OPTIONS)
    batch = _options_batch(cfg, 33)
    jm, v, tm = criterion_step(cfg, batch, 34)
    want = jax_stats_after(jm, v, {k: jnp.asarray(x)
                                   for k, x in batch.items()})
    for i, bn in enumerate(tm.postnet.bn):
        w = want["postnet"][f"bn{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(w["mean"]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(w["var"]), rtol=0, atol=1e-5)


def test_tts_generator_serves_postnet_mel_with_speakers():
    cfg = _cfg(**{**OPTIONS, "ctc_weight": 0.0})
    batch = _options_batch(cfg, 35)
    jm, v = _token_model(cfg, batch, 36)
    b = {"src_tokens": batch["src_tokens"], "speaker": batch["speaker"]}
    want = jsg.NonAutoregressiveSpeechGenerator(jm, VOCAB, max_mel_len=24
                                                ).generate(v, b)
    tm = convert.fs2_from_flax(v, cfg, V, VOCAB.pad, device="cpu").eval()
    got = tsg.NonAutoregressiveSpeechGenerator(tm, VOCAB, max_mel_len=24
                                               ).generate(b)
    for g, w in zip(got, want):
        assert g["feature"].shape == w["feature"].shape
        np.testing.assert_allclose(g["feature"], w["feature"], rtol=0,
                                   atol=1e-3)


def test_jax_criterion_cannot_train_a_postnet_the_port_can():
    """JAX's ``fastspeech2_criterion`` applies the model without its
    ``batch_stats`` collection, so a training pass through the Postnet's
    BatchNorm raises there (ROADMAP Queue 3); the port's criterion trains
    it and moves the running statistics."""
    from flax.errors import ScopeCollectionNotFound

    cfg = _cfg(add_postnet=True, postnet_layers=2, postnet_conv_dim=8,
               postnet_dropout=0.0)
    batch = _batch(cfg, 37)
    jm, v = _token_model(cfg, batch, 38)
    with pytest.raises(ScopeCollectionNotFound):
        jtl.fastspeech2_criterion(
            jm, {"params": v["params"], "batch_stats": v["batch_stats"]},
            {k: jnp.asarray(x) for k, x in batch.items()},
            jax.random.key(0), VOCAB)
    tm = convert.fs2_from_flax(v, cfg, V, VOCAB.pad, device="cpu")
    before = tm.postnet.bn[0].running_mean.clone()
    loss, _ = ttl.fastspeech2_criterion(tm, _torch_batch(batch),
                                        torch.Generator(), VOCAB)
    loss.backward()
    assert torch.isfinite(loss)
    assert not torch.equal(tm.postnet.bn[0].running_mean, before)
    assert tm.postnet.conv[0].weight.grad is not None


def test_all_options_bf16():
    """The four options in bf16 (the Postnet's BatchNorm normalising in
    fp32 and rounding once, as flax's ``BatchNorm(dtype=bf16)``): mel,
    mel_post and the CTC logits within 2 ||jax_bf16 - jax_fp32|| of JAX's
    bf16 outputs (PR 15's bar)."""
    from daspeech_torch.models import fastspeech2 as tfs
    from daspeech_tpu.models import fastspeech2 as jfs
    from test_torch_ar import _bf16_bar

    cfg = _cfg(**OPTIONS)
    batch = _options_batch(cfg, 39)
    jm, v = _token_model(cfg, batch, 40)
    M = batch["target_audio"].shape[1]
    kw = dict(src_tokens=batch["src_tokens"], max_out_len=M,
              durations=batch["durations"], speaker=batch["speaker"],
              mutable=["intermediates"])
    want = {}
    for dt in (jnp.bfloat16, jnp.float32):
        out, mut = jfs.FastSpeech2Encoder(cfg, vocab_size=V, pad=VOCAB.pad,
                                          dtype=dt).apply(v, **kw)
        want[dt] = (out[0], out[1], mut["intermediates"]["ctc_logits"][0])
    tm = convert.load_flax_(tfs.FastSpeech2Encoder(
        cfg, V, VOCAB.pad, dtype=torch.bfloat16), v).eval()
    with torch.no_grad():
        got = tm(src_tokens=_t(batch["src_tokens"]).long(), max_out_len=M,
                 durations=_t(batch["durations"]).long(),
                 speaker=_t(batch["speaker"]).long())
    assert got[1].dtype == torch.bfloat16
    for g, i in ((got[0], 0), (got[1], 1), (got[6], 2)):
        _bf16_bar(g, want[jnp.bfloat16][i], want[jnp.float32][i])
