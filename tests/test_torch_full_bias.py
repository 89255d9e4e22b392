"""The port's full-bias attention (``daspeech_torch.ops.fused_attention.
fused_attention_full_bias``) against the JAX package's, on the CPU.

* the plain version (what a CPU tensor takes) against JAX's oracle
  ``mha_reference_full_bias`` and ``jax.grad`` of it: forward within 1e-5,
  dq, dk, dv and dbias within rtol 1e-4 / atol 1e-5, with random scores, a
  pad-masked bias (-1e30 on the last keys) and a fully masked row;
* a tiny case against JAX's Pallas kernel in interpret mode, forward and
  ``jax.vjp``, pad-masked and with a fully masked row (which JAX's kernel
  averages over its 128-lane key padding too: that row is held to the
  oracle);
* dropout, port only (the TPU's bits cannot be reproduced): drop fraction,
  1/(1-p) scale, distinct streams per (b, h), and the closed-form backward
  replaying the forward's mask (autograd through the plain forward agrees
  to 1e-5).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from daspeech_torch.ops import fused_attention as tfa
from daspeech_torch.ops import philox
from daspeech_tpu.ops import fused_attention as jfa

NEG = -1e30


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)


def inputs(B, H, Tq, Tk, d, mask, seed):
    """q, k, v, bias4 (random scores; "pad": -1e30 on each row's last keys;
    "row": also one fully masked query row) and a cotangent, as numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, T, d)).astype(np.float32)
               for T in (Tq, Tk, Tk))
    bias = rng.normal(size=(B, H, Tq, Tk)).astype(np.float32)
    if mask in ("pad", "row"):
        keep = rng.integers(1, Tk + 1, size=B)
        bias = np.where(np.arange(Tk)[None, None, None, :]
                        >= keep[:, None, None, None], NEG, bias)
    if mask == "row":
        bias[-1, 0, 1, :] = NEG
    g = rng.normal(size=(B, H, Tq, d)).astype(np.float32)
    return q, k, v, bias.astype(np.float32), g


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("mask", ["none", "pad", "row"])
def test_plain_matches_jax_reference(mask):
    B, H, Tq, Tk, d, sc = 2, 3, 9, 13, 8, 0.35
    q, k, v, bias, g = inputs(B, H, Tq, Tk, d, mask, seed=len(mask))
    out, vjp = jax.vjp(lambda *a: jfa.mha_reference_full_bias(*a, sc),
                       q, k, v, bias)
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, bias)]
    got = tfa.fused_attention_full_bias(*ts, 0, sc, 0.1, False)
    _close(got, out, 0, 1e-5)
    _close(tfa.mha_reference_full_bias(*ts, sc), out, 0, 1e-5)
    got.backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        assert torch.isfinite(t.grad).all()
        _close(t.grad, w, 1e-4, 1e-5)


@pytest.mark.parametrize("mask", ["pad", "row"])
def test_plain_matches_interpreted_kernel(mask):
    """On a fully masked row JAX's kernel averages v over the keys it pads
    Tk with (to 128, value 0) as well, where its oracle and the port
    average over the Tk keys: that row is held to the oracle instead (and
    its gradients drop out of the comparison)."""
    B, H, Tq, Tk, d, sc = 2, 2, 8, 11, 16, 0.25
    q, k, v, bias, g = inputs(B, H, Tq, Tk, d, mask, seed=7)
    if mask == "row":
        g[-1, 0, 1] = 0.0
    out, vjp = jax.vjp(lambda *a: jfa.fused_attention_full_bias(
        *a, 0, sc, 0.0, False), q, k, v, bias)
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, bias)]
    got = tfa.fused_attention_full_bias(*ts, 0, sc, 0.0, False)
    out = np.array(out)
    if mask == "row":
        oracle = jfa.mha_reference_full_bias(q, k, v, bias, sc)
        _close(got[-1, 0, 1], oracle[-1, 0, 1], 0, 1e-5)
        assert np.abs(out[-1, 0, 1] - oracle[-1, 0, 1]).max() > 1e-2
        out[-1, 0, 1] = oracle[-1, 0, 1]
    _close(got, out, 0, 1e-5)
    got.backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        _close(t.grad, w, 1e-4, 1e-5)


def test_dropout_mask_fraction_scale_and_streams():
    seed = torch.tensor([-77], dtype=torch.int32)
    p = 0.1
    m = philox.full_bias_keep(seed, 3, 4, 64, 96, p)
    assert m.shape == (3, 4, 64, 96)
    assert torch.all(m[m != 0] == torch.tensor(1.0 / (1.0 - p)))
    frac = (m == 0).float().mean().item()
    assert abs(frac - p) < 4 * math.sqrt(p * (1 - p) / m.numel())
    assert not torch.equal(m[0, 0], m[0, 1])      # heads differ
    assert not torch.equal(m[0, 0], m[1, 0])      # batch rows differ
    assert not torch.equal(m, philox.full_bias_keep(
        torch.tensor([-76], dtype=torch.int32), 3, 4, 64, 96, p))


def test_backward_replays_the_forward_mask():
    B, H, Tq, Tk, d, sc, p = 2, 2, 7, 10, 8, 0.3, 0.3
    q, k, v, bias, g = inputs(B, H, Tq, Tk, d, "row", seed=11)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, bias)]
    seed = torch.tensor([12345], dtype=torch.int32)
    out = tfa.attention_full_bias_plain(*ts, sc, p, seed)
    want = torch.autograd.grad(out, ts, torch.from_numpy(g))
    got = tfa.attention_full_bias_bwd_plain(*(t.detach() for t in ts),
                                            torch.from_numpy(g), sc, p, seed)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5
    fused = tfa.fused_attention_full_bias(*ts, 12345, sc, p, True)
    assert torch.equal(fused, out)
    got2 = torch.autograd.grad(fused, ts, torch.from_numpy(g))
    for a, b in zip(got2, got):
        assert torch.equal(a, b)
    nodrop = tfa.attention_full_bias_plain(*ts, sc)
    assert (nodrop - out).abs().max().item() > 1e-3


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.randn(1, 1, 4, 64)
    b4 = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.attention_fb_fwd_kernel(x, x, x, b4, 1.0)
    tfa.fused_attention_full_bias(x, x, x, b4, 0, 1.0, 0.0, False)
    assert tfa.attention_fb_fwd_kernel.launches == 0


@pytest.mark.parametrize("mask", ["none", "pad"])
def test_bf16_matches_interpreted_kernel(mask):
    """bf16 q, k, v with an fp32 bias4: the output and dq, dk, dv (bf16)
    within one bf16 ulp of the Pallas kernel's in interpret mode, or 1e-6
    of the largest magnitude (the plain bf16 bar,
    ``tests/test_torch_bf16_ops.py``); dS (fp32) within the fp32 bar."""
    from test_torch_bf16_ops import assert_within_ulp

    B, H, Tq, Tk, d, sc = 2, 2, 8, 11, 16, 0.25
    q, k, v, bias, g = inputs(B, H, Tq, Tk, d, mask, seed=11)
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in (q, k, v, g))
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      for t in (tq, tk, tv, tg))
    out, vjp = jax.vjp(lambda *a: jfa.fused_attention_full_bias(
        *a, 0, sc, 0.0, False), jq, jk, jv, jnp.asarray(bias))
    assert out.dtype == jnp.bfloat16
    want = vjp(jg)
    ts = [t.requires_grad_(True) for t in (tq, tk, tv)]
    tb = torch.from_numpy(bias).requires_grad_(True)
    got = tfa.fused_attention_full_bias(*ts, tb, 0, sc, 0.0, False)
    assert_within_ulp(got, out, "out")
    got.backward(tg)
    for t, w, name in zip(ts, want, "qkv"):
        assert_within_ulp(t.grad, w, f"d{name}")
    assert tb.grad.dtype == torch.float32 and want[3].dtype == jnp.float32
    _close(tb.grad, want[3], 1e-4, 1e-5)
