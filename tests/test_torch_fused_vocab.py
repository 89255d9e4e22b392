"""The port's streamed vocabulary projection
(``daspeech_torch.ops.fused_vocab`` and the ``fused_vocab_chunk`` routing
of the criteria) against the JAX package, on the CPU at small widths.
Follows JAX's own ``tests/test_fused_vocab.py``:

* ``fused_logsoftmax_gather``'s values against JAX's op and against the
  dense ``log_softmax`` gather at several chunks, an odd |V| among them
  (1e-5), and its gradients in feat, W and bias (2e-4);
* ``streaming_argmax_and_match`` against JAX's, ties between chunks and
  inside one included;
* bf16 features: cast to fp32 as JAX's op casts them, the gradient back in
  bf16;
* ``nat_dag_loss`` and ``s2s_dag_fastspeech2_loss`` (``expect`` and
  ``argmax``) with ``fused_vocab_chunk``, and with it and ``banded_dp``
  together, against JAX's criteria on JAX's glance draws, dropout 0: the
  loss within 1e-5 relative, every gradient within 1e-5 of its tensor's
  norm (the CLI parity test's bar); an untied output projection too; and
  that the fused criterion never forms the [B, L, V] logits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dag_variants as tv
from daspeech_torch import convert
from daspeech_torch.losses import dag_loss as tloss
from daspeech_torch.ops import fused_vocab as tfv
from daspeech_tpu.ops import fused_vocab as jfv
from test_fused_vocab import make


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _dense(feat, W, bias, targets):
    """log_softmax(feat @ W + bias) gathered at the targets: [B, T, L]."""
    logp = torch.log_softmax(feat @ W + bias, dim=-1)        # [B, L, V]
    B, L, _ = logp.shape
    idx = targets[:, None, :].expand(B, L, -1)
    return logp.gather(-1, idx).transpose(1, 2)


@pytest.mark.parametrize("V,chunk", [(37, 8), (37, 16), (37, 64), (13, 8),
                                     (32, 8)])
def test_values_match_jax_and_dense(V, chunk):
    jx = make(np.random.default_rng(0), V=V)
    feat, W, bias, targets = (_t(x) for x in jx)
    targets = targets.long()
    got = tfv.fused_logsoftmax_gather(feat, W, bias, targets, chunk)
    assert got.shape == (2, 5, 6) and got.dtype == torch.float32
    want = np.asarray(jfv.fused_logsoftmax_gather(*jx, chunk))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               _dense(feat, W, bias, targets).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("V,chunk", [(37, 16), (13, 8), (37, 64)])
def test_gradients_match_jax_and_dense(V, chunk):
    rng = np.random.default_rng(1)
    jx = make(rng, V=V)
    g = rng.normal(size=(2, 5, 6)).astype(np.float32)
    want = jax.grad(lambda f, w, b: jnp.sum(jfv.fused_logsoftmax_gather(
        f, w, b, jx[3], chunk) * g), argnums=(0, 1, 2))(*jx[:3])
    targets = _t(jx[3]).long()

    def grads(fn):
        ins = [_t(x).requires_grad_() for x in jx[:3]]
        (fn(*ins) * _t(g)).sum().backward()
        return [x.grad for x in ins]

    got = grads(lambda f, w, b: tfv.fused_logsoftmax_gather(f, w, b,
                                                            targets, chunk))
    dense = grads(lambda f, w, b: _dense(f, w, b, targets))
    for a, w, d, name in zip(got, want, dense, ("dfeat", "dW", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
        np.testing.assert_allclose(a.numpy(), d.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("V,chunk", [(37, 8), (13, 8), (16, 8)])
def test_streaming_argmax_and_match(V, chunk):
    jx = list(make(np.random.default_rng(2), V=V))
    # ties: vocabulary entry 9 repeats entry 1 (a tie between chunks) and
    # entry 2 repeats entry 1 (a tie inside a chunk), both raised so that
    # they are every row's maximum
    W = np.array(jx[1])
    W[:, 2] = W[:, 9] = W[:, 1]
    b = np.array(jx[2])
    b[1] = b[2] = b[9] = 50.0
    feat = np.array(jx[0])
    feat[0, :3] = 0.0              # three rows with every logit at 50
    jx[1], jx[2], jx[0] = jnp.asarray(W), jnp.asarray(b), jnp.asarray(feat)
    want_ix, want_match = jfv.streaming_argmax_and_match(*jx, chunk)
    ix, match = tfv.streaming_argmax_and_match(*(_t(x) for x in jx[:3]),
                                               _t(jx[3]).long(), chunk)
    assert ix.dtype == torch.int64
    np.testing.assert_array_equal(ix.numpy(), np.asarray(want_ix))
    assert (ix == 1).all()         # the first chunk's first index
    np.testing.assert_allclose(match.numpy(), np.asarray(want_match),
                               rtol=1e-5, atol=1e-5)
    dense = _dense(*(_t(x) for x in jx[:3]), _t(jx[3]).long())
    np.testing.assert_allclose(match.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_bf16_features_compute_in_fp32():
    jx = make(np.random.default_rng(3))
    feat, W, bias, targets = (_t(x) for x in jx)
    fb = feat.bfloat16().requires_grad_()
    got = tfv.fused_logsoftmax_gather(fb, W, bias, targets.long(), 16)
    assert got.dtype == torch.float32
    want = tfv.fused_logsoftmax_gather(fb.detach().float(), W, bias,
                                       targets.long(), 16)
    assert torch.equal(got, want)
    got.sum().backward()
    assert fb.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("joint,kw", [
    (False, dict(fused_vocab_chunk=8)),
    (False, dict(fused_vocab_chunk=7, max_transition_length=tv.W_BAND,
                 banded_dp=True)),
    (True, dict(fused_vocab_chunk=8, training_strategy="expect")),
    (True, dict(fused_vocab_chunk=16, training_strategy="argmax")),
    (True, dict(fused_vocab_chunk=8, max_transition_length=tv.W_BAND,
                banded_dp=True, training_strategy="expect")),
    (True, dict(fused_vocab_chunk=8, max_transition_length=tv.W_BAND,
                banded_dp=True, training_strategy="argmax")),
], ids=["s2tt", "s2tt-banded", "expect", "argmax", "expect-banded",
        "argmax-banded"])
def test_criteria_with_fused_vocab_match_jax(joint, kw):
    tv.assert_criterion_matches_jax(joint, kw)


def test_untied_output_projection(monkeypatch):
    """An output projection apart from the embedding is the streamed
    projection's vocabulary matrix (``vocab_matrix``); no [B, L, V] logits
    are formed."""
    cfg = tv.dag_cfg(shared=False)
    b = tv.batch(cfg, 4)
    from daspeech_tpu.models import dag_model as jdag
    from test_torch_models import random_variables
    jm = jdag.S2TConformerDAG(cfg)
    v = random_variables(jm, 5, b["fbank"], b["src_lengths"],
                         b["prev_output_tokens"])
    kw = dict(fused_vocab_chunk=8)
    want, _, jgrads = tv.jax_value_and_grad(False, jm, v, b, cfg, **kw)
    monkeypatch.setattr(
        type(convert.dag_from_flax(v, cfg, device="cpu").decoder),
        "output_layer", lambda *a: pytest.fail("formed the logits"))
    tm, got, _ = tv.port_value_and_grad(False, cfg, v, b, **kw)
    assert not tm.decoder.share_input_output_embed
    np.testing.assert_allclose(got, want, rtol=1e-5)
    tv.assert_grads_match(tm, jgrads)
    W, bias = tloss.vocab_matrix(tm.decoder)
    assert W.shape == (16, tv.VOCAB) and not bias.any()
