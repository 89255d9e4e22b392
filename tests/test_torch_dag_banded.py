"""The port's block-banded DAG loss (``daspeech_torch.ops.dag_banded``,
``ops.links_utils``, ``GlatLinkDecoder.extract_links_banded`` and the
``banded_dp`` routing of the criteria) against the JAX package, on the CPU
at small widths. Follows JAX's own ``tests/test_dag_banded.py``:

* the banded DP's logprob, gradients and alpha/beta against JAX's
  ``dag_banded`` ops and against the port's full-matrix ``dag_loss`` on
  ``band_to_full`` of the same band (values 1e-5, gradients and finite
  alpha/beta 1e-4, as JAX's tests), at band widths that divide L, do not,
  and cover it;
* the banded Viterbi: its paths' scores within 1e-5 of the full-matrix
  Viterbi's, the same paths as JAX's banded Viterbi and, on these random
  scores that hold no near tie, as the full one; target_length vertices
  marked;
* the band round trip exact, both directions equal to JAX's;
* ``extract_links_banded`` equal to ``full_to_band(extract_links)`` and to
  JAX's method (2e-4), the -inf pattern exactly, and its refusal of a band
  that covers the graph;
* ``compute_dag_loss``'s routing: banded equals the full-matrix DP, and a
  width that covers the triangle (the recipe's 99999) is a no-op;
* ``nat_dag_loss`` and ``s2s_dag_fastspeech2_loss`` (``expect`` and
  ``argmax``) with ``banded_dp`` against JAX's criteria on JAX's glance
  draws, dropout 0: the loss within 1e-5 relative, every gradient within
  1e-5 of its tensor's norm (the CLI parity test's bar);
* the shift's fp32 loss behind a dead end (ROADMAP Queue 3): the banded DP
  loses the same mass as the full-matrix loop.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dag_variants as tv
from daspeech_torch import convert
from daspeech_torch.losses import dag_loss as tloss
from daspeech_torch.ops import dag_banded as tb
from daspeech_torch.ops import dag_ref as tr
from daspeech_torch.ops import links_utils as tlu
from daspeech_tpu.ops import dag_banded as jb
from daspeech_tpu.ops import links_utils as jlu
from test_dag_banded import _banded_model, random_banded_problem
from test_torch_dag_cluster import dead_end_inputs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _problem(seed, **kw):
    """JAX's random banded problem, and the same as torch tensors."""
    jx = random_banded_problem(np.random.default_rng(seed), **kw)
    m, b, ol, tl = (_t(x) for x in jx)
    return jx, (m, b, ol.long(), tl.long())


@pytest.mark.parametrize("W,L", [(4, 12), (5, 12), (4, 13), (11, 12)])
def test_banded_value_and_alpha_beta(W, L):
    (jm, jband, jol, jtl), (m, band, ol, tl) = _problem(0, L=L, W=W)
    want_lp, want_a, want_b = jb.dag_loss_banded_with_alpha_beta(
        jm, jband, jol, jtl)
    lp, alpha, beta = tb.dag_loss_banded_with_alpha_beta(m, band, ol, tl)
    full_lp, full_a, full_b = tr.dag_loss_forward_plain(
        m, tlu.band_to_full(band), ol, tl)
    assert torch.isfinite(lp).all()
    for ref_lp, ref_a, ref_b in ((np.asarray(want_lp), np.asarray(want_a),
                                  np.asarray(want_b)),
                                 (full_lp.numpy(), full_a.numpy(),
                                  full_b.numpy())):
        np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=1e-5, atol=1e-5)
        for got, ref in ((alpha, ref_a), (beta, ref_b)):
            fin = np.isfinite(ref)
            np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
            np.testing.assert_allclose(got.numpy()[fin], ref[fin],
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("W,L", [(4, 12), (5, 12), (4, 13)])
def test_banded_gradients(W, L):
    (jm, jband, jol, jtl), (m, band, ol, tl) = _problem(1, L=L, W=W)
    wts = np.array([1.0, -0.5, 2.0], np.float32)
    want = jax.grad(lambda a, b: jnp.sum(
        jb.dag_loss_banded(a, b, jol, jtl) * wts), argnums=(0, 1))(jm, jband)

    def grads(fn):
        mm, bb = m.clone().requires_grad_(), band.clone().requires_grad_()
        (fn(mm, bb) * torch.from_numpy(wts)).sum().backward()
        return mm.grad, bb.grad

    got = grads(lambda a, b: tb.dag_loss_banded(a, b, ol, tl))
    full = grads(lambda a, b: tr.dag_loss(a, tlu.band_to_full(b), ol, tl))
    # the variant that also returns alpha and beta has the same gradients
    ab = grads(lambda a, b: tb.dag_loss_banded_with_alpha_beta(
        a, b, ol, tl)[0])
    for g, w, f, g2 in zip(got, want, full, ab):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), f.numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert torch.equal(g, g2)


def _path_score(path, match, full):
    """Σ match[t, j] over the path's vertices + Σ links between them."""
    out = []
    for b in range(path.shape[0]):
        verts = [j for j in range(path.shape[1]) if path[b, j] >= 0]
        s = sum(float(match[b, path[b, j], j]) for j in verts)
        s += sum(float(full[b, i, j]) for i, j in zip(verts, verts[1:]))
        out.append(s)
    return np.array(out)


@pytest.mark.parametrize("seed,W,L", [(3, 4, 12), (4, 5, 13), (5, 5, 14)])
def test_banded_viterbi(seed, W, L):
    (jm, jband, jol, jtl), (m, band, ol, tl) = _problem(seed, L=L, W=W)
    path = tb.dag_best_alignment_banded(m, band, ol, tl)
    assert path.dtype == torch.int32
    want = np.asarray(jb.dag_best_alignment_banded(jm, jband, jol, jtl))
    full = tlu.band_to_full(band)
    path_f = tr.dag_best_alignment_plain(m, full, ol, tl)
    s_b = _path_score(path.numpy(), m.numpy(), full.numpy())
    s_f = _path_score(path_f.numpy(), m.numpy(), full.numpy())
    np.testing.assert_allclose(s_b, s_f, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(path.numpy(), want)
    for b in range(path.shape[0]):
        assert int((path[b] >= 0).sum()) == int(tl[b])
    # random normal scores hold no near tie: the paths are the same
    assert torch.equal(path, path_f)


def test_band_round_trip():
    (_, jband, _, _), (_, band, _, _) = _problem(4)
    full = tlu.band_to_full(band)
    assert torch.equal(full, _t(jlu.band_to_full(jband)))
    back = tlu.full_to_band(full, band.shape[2])
    assert torch.equal(back, band)
    assert torch.equal(tlu.full_to_band(full, 99), _t(jlu.full_to_band(
        jlu.band_to_full(jband), 99)))                  # W clamps to L - 1


@pytest.mark.parametrize("W,L", [(3, 12), (4, 12), (5, 16)])
def test_extract_links_banded(W, L):
    model, cfg, v, fbank, sl, prev = _banded_model(W, L)
    _, want, _ = model.apply(v, fbank, sl, prev, method=model.forward_banded)
    tm = convert.dag_from_flax(v, cfg, device="cpu")
    with torch.no_grad():
        _, band, _ = tm.forward_banded(_t(fbank), _t(sl).long(),
                                       _t(prev).long())
        _, full, _ = tm(_t(fbank), _t(sl).long(), _t(prev).long())
    assert band.shape == (fbank.shape[0], L, W) and band.dtype == torch.float32
    ref = tlu.full_to_band(full, W)
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(band), fin)
    np.testing.assert_array_equal(np.isfinite(np.asarray(want)), fin.numpy())
    np.testing.assert_allclose(band[fin].numpy(), ref[fin].numpy(),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(band[fin].numpy(),
                               np.asarray(want)[fin.numpy()], rtol=2e-4,
                               atol=1e-5)


def test_extract_links_banded_refuses_a_full_band():
    model, cfg, v, fbank, sl, prev = _banded_model(11, 12)
    tm = convert.dag_from_flax(v, cfg, device="cpu")
    with pytest.raises(ValueError, match="max_transition_length"):
        tm.forward_banded(_t(fbank), _t(sl).long(), _t(prev).long())


def test_compute_dag_loss_routes_through_the_band():
    rng = np.random.default_rng(5)
    B, T, L, W, V, pad = 2, 5, 12, 4, 16, 1
    logits = torch.from_numpy(rng.normal(size=(B, L, V)).astype(np.float32))
    _, (_, band, ol, _) = _problem(5, B=B, T=T, L=L, W=W)
    links = tlu.band_to_full(band)
    tgt = torch.from_numpy(rng.integers(4, V, size=(B, T)))
    prev = torch.where(torch.arange(L)[None, :] < ol[:, None], 4, pad)

    def run(links, **kw):
        return tloss.compute_dag_loss(logits, links, tgt, prev, pad, None,
                                      None, **kw)[0].item()

    full = run(links)
    np.testing.assert_allclose(run(links, max_transition_length=W,
                                   banded_dp=True), full, rtol=1e-5)
    np.testing.assert_allclose(run(band, banded_dp=True, links_banded=True),
                               full, rtol=1e-5)
    # banded links without the banded DP are widened to [L, L]
    assert run(band, links_banded=True) == full
    # a width covering the whole triangle is a no-op (the recipe's 99999)
    assert run(links, max_transition_length=99999, banded_dp=True) == full
    assert tloss._band_width(99999, L) is None
    assert tloss._band_width(W, L) == W
    assert tloss._band_width(0, L) is None


@pytest.mark.parametrize("joint,strategy", [(False, None), (True, "expect"),
                                            (True, "argmax")])
def test_criteria_with_banded_dp_match_jax(joint, strategy):
    kw = dict(max_transition_length=tv.W_BAND, banded_dp=True)
    if joint:
        kw["training_strategy"] = strategy
    tv.assert_criterion_matches_jax(joint, kw)


def test_the_banded_criterion_takes_the_banded_path(monkeypatch):
    """With ``banded_dp`` the model's banded extraction and the banded DP
    and Viterbi run, and neither the [L, L] links nor the full-matrix DP."""
    cfg, b, _, v = tv.setup(False)
    tm = convert.dag_from_flax(v, cfg, device="cpu")
    calls = []
    for mod, names in ((tloss, ("dag_loss_banded", "dag_loss",
                                "dag_best_alignment_banded",
                                "dag_best_alignment")),):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn: (
                calls.append(_n), _f(*a))[1])
    monkeypatch.setattr(type(tm.decoder), "extract_links",
                        lambda *a: calls.append("extract_links"))
    tloss.nat_dag_loss(tm, tv.torch_batch(b), torch.Generator(), 0.5,
                       cfg.vocab, max_transition_length=tv.W_BAND,
                       banded_dp=True)[0].backward()
    assert calls == ["dag_best_alignment_banded", "dag_loss_banded"]


def test_banded_dp_loses_the_same_mass_behind_a_dead_end():
    """The shift by the previous row's maximum (ROADMAP Queue 3, "The DP's
    fp32 shift") is the banded DP's too: behind the dead-end graph of
    ``test_torch_dag_cluster.py`` the exact -120 underflows to -inf."""
    match, links, ol, tl = dead_end_inputs()
    band = tlu.full_to_band(links, 3)
    logprob, alpha, _ = tb.banded_forward(match, band, ol, tl)
    exact = tr.dag_loss_forward_plain(match.double(), links.double(), ol, tl)
    assert exact[1][0, 2, 2] == -120.0 and exact[0][1] == -120.0
    assert alpha[0, 2, 2] == -math.inf and logprob[1] == -math.inf
    full = tr.dag_loss_forward_plain(match, links, ol, tl)
    assert torch.equal(logprob, full[0])
