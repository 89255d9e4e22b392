"""The port's DAG dynamic programs (``daspeech_torch/ops/dag_ref.py``, plain
loops on the CPU) against the JAX package's scan reference
(``daspeech_tpu/ops/dag_ref.py``), with inputs made by numpy from a seed.

Shapes stay at L <= 16, T <= 8 on the JAX side where it differentiates:
compiling a grad through a scan on the CPU takes minutes at larger sizes.
Tolerances: fp32 forward values agree to 1e-5 (the recursions add the same
terms in another order: exp(a) * exp(b) against a matmul of exponentials),
gradients to 1e-5 absolute and 1e-4 relative. Viterbi paths must be equal,
ties included. The CUDA kernels are held against these plain loops on the
card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daspeech_torch.ops import dag_kernels
from daspeech_torch.ops import dag_ref as tref
from daspeech_tpu.ops import dag_ref as jref
from test_dag_ops import make_random_dag

ATOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x))


def _finite_close(got, want, atol=ATOL, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    m = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), m)
    np.testing.assert_array_equal(got[~m], want[~m])       # same infinities
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=atol)


def _dag(seed, B, T, L):
    """``make_random_dag``; T = 1 is cut from a T = 2 problem (one target
    token: logZ = match[0, 0] where the graph has one vertex)."""
    match, links, ol, tl = (np.array(x) for x in make_random_dag(
        np.random.default_rng(seed), B=B, T=max(T, 2), L=L))
    if T == 1:
        match, tl = match[:, :1], np.ones_like(tl)
    return match, links, ol, tl


@pytest.mark.parametrize("B,T,L", [(3, 6, 11), (2, 8, 16), (2, 1, 5),
                                   (3, 5, 9)])
def test_forward_matches_jax(B, T, L):
    match, links, ol, tl = _dag(B + T + L, B, T, L)
    lp, a, b = jref.dag_loss_forward(match, links, ol, tl)
    tlp, ta, tb = tref.dag_loss_forward(*map(_t, (match, links, ol, tl)))
    _finite_close(tlp.numpy(), lp, rtol=1e-6)
    _finite_close(ta.numpy(), a, atol=1e-4, rtol=1e-5)
    _finite_close(tb.numpy(), b, atol=1e-4, rtol=1e-5)


def _grads(fn, match, links, ol, tl):
    m = _t(match).requires_grad_(True)
    lk = _t(links).requires_grad_(True)
    lp = fn(m, lk, _t(ol), _t(tl))
    if isinstance(lp, tuple):
        lp = lp[0]
    lp.mean().backward()
    return lp.detach(), m.grad.numpy(), lk.grad.numpy()


@pytest.mark.parametrize("B,T,L", [(2, 5, 12), (3, 6, 11)])
def test_gradients_match_jax(B, T, L):
    match, links, ol, tl = _dag(7 * L + T, B, T, L)

    def mean_lp(m, lk):
        return jnp.mean(jref.dag_loss(m, lk, jnp.asarray(ol),
                                      jnp.asarray(tl)))

    want_m, want_l = jax.grad(mean_lp, argnums=(0, 1))(jnp.asarray(match),
                                                       jnp.asarray(links))
    _, gm, gl = _grads(tref.dag_loss, match, links, ol, tl)
    np.testing.assert_allclose(gm, np.asarray(want_m), rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(gl, np.asarray(want_l), rtol=1e-4, atol=ATOL)


def _loop_logz(match, links, ol, tl):
    """logZ by the alpha recursion alone, written so that autograd
    differentiates it (-inf floored at -1e9: no 0 * inf in the VJP)."""
    floor = -1e9
    match = torch.clamp(match, min=floor)
    links = torch.clamp(links, min=floor)
    B, T, L = match.shape
    f = torch.full((B, L), floor)
    f = torch.cat([match[:, 0, :1], f[:, 1:]], dim=1)
    alphas = [f]
    for t in range(1, T):
        f = torch.logsumexp(f[:, :, None] + links, dim=1) + match[:, t]
        f = torch.clamp(f, min=floor)
        alphas.append(f)
    alpha = torch.stack(alphas, dim=1)
    return alpha[torch.arange(B), tl.long() - 1, ol.long() - 1]


def test_closed_form_gradients_match_autograd_of_the_loop():
    match, links, ol, tl = _dag(3, 3, 6, 12)
    lp, gm, gl = _grads(tref.dag_loss, match, links, ol, tl)
    lp2, gm2, gl2 = _grads(_loop_logz, match, links, ol, tl)
    np.testing.assert_allclose(lp.numpy(), lp2.numpy(), rtol=1e-5)
    # the loop's floored entries get exactly-zero gradients too
    np.testing.assert_allclose(gm, gm2, rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(gl, gl2, rtol=1e-4, atol=ATOL)


def test_infeasible_graph_gives_minus_inf_and_zero_gradients():
    match, links, ol, tl = _dag(11, 3, 6, 10)
    ol[1], tl[1] = 3, 5            # 5 targets cannot fit in 3 vertices
    m = _t(match).requires_grad_(True)
    lk = _t(links).requires_grad_(True)
    lp = tref.dag_loss(m, lk, _t(ol), _t(tl))
    assert lp[1].item() == -np.inf
    assert torch.isfinite(lp[[0, 2]]).all()
    # straight through the -inf sample (cotangent 1), as the criterion's
    # masking would not shield it
    lp.sum().backward()
    for g in (m.grad, lk.grad):
        assert torch.isfinite(g).all()
        assert (g[1] == 0).all()
    assert (m.grad[0] != 0).any()


def test_alpha_beta_variant_drops_their_cotangents():
    match, links, ol, tl = _dag(5, 2, 5, 9)
    _, gm, gl = _grads(tref.dag_loss, match, links, ol, tl)
    m = _t(match).requires_grad_(True)
    lk = _t(links).requires_grad_(True)
    lp, a, b = tref.dag_loss_with_alpha_beta(m, lk, _t(ol), _t(tl))
    fin = lambda x: torch.where(torch.isfinite(x), x, 0.0)  # noqa: E731
    (lp.mean() + 3.0 * fin(a).sum() - fin(b).sum()).backward()
    np.testing.assert_array_equal(m.grad.numpy(), gm)
    np.testing.assert_array_equal(lk.grad.numpy(), gl)
    want = jref.dag_loss_forward(match, links, ol, tl)
    _finite_close(a.detach().numpy(), want[1], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("B,T,L,ties", [(3, 6, 11, False), (4, 8, 16, False),
                                        (2, 9, 130, False), (4, 8, 16, True),
                                        (3, 6, 12, True), (2, 2, 4, False)])
def test_viterbi_paths_equal_jax(B, T, L, ties):
    match, links, ol, tl = _dag(B * T + L + ties, B, T, L)
    if ties:
        # coarse values: many candidates tie exactly, and the first
        # (lowest-index) predecessor must win in both
        match = np.where(np.isfinite(match), np.round(match), match)
        links = np.where(np.isfinite(links), np.round(links), links)
        links = links.astype(np.float32)
        match = match.astype(np.float32)
    want = np.asarray(jref.dag_best_alignment(match, links, ol, tl))
    got = tref.dag_best_alignment(*map(_t, (match, links, ol, tl)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_logsoftmax_gather_tokens_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32) * 3
    tgt = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    want = jref.dag_logsoftmax_gather_tokens(jnp.asarray(logits),
                                             jnp.asarray(tgt))
    got = tref.dag_logsoftmax_gather_tokens(_t(logits), _t(tgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_cpu_route_is_not_a_launch():
    match, links, ol, tl = _dag(1, 2, 4, 6)
    before = (dag_kernels.dag_loss_forward_kernel.launches,
              dag_kernels.dag_best_alignment_kernel.launches)
    args = list(map(_t, (match, links, ol, tl)))
    tref.dag_loss_forward(*args)
    tref.dag_best_alignment(*args)
    assert (dag_kernels.dag_loss_forward_kernel.launches,
            dag_kernels.dag_best_alignment_kernel.launches) == before


@pytest.mark.parametrize("fn", [tref.dag_loss_forward,
                                tref.dag_best_alignment])
def test_kernel_route_refuses_non_cuda_device(fn):
    m = torch.zeros((1, 3, 4), device="meta")
    lk = torch.zeros((1, 4, 4), device="meta")
    n = torch.ones((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fn(m, lk, n, n)
