"""The port's fused Conformer FFN (``daspeech_torch.ops.fused_ffn``, through
``FeedForwardModule(fused=True)``) against the JAX package's, on the CPU.

* the port's module with ``fused=True`` (the plain version on CPU tensors)
  against JAX's ``FeedForwardModule(fused=True)`` running its Pallas kernel
  in interpret mode (``tests/test_fused_ffn.py``'s set-up), same weights
  from a numpy seed: forward within 1e-5 at that file's three shapes
  (T % 8 != 0 among them); x and every parameter gradient within rtol 2e-4
  / atol 2e-5 (fp32 sums in another order);
* the fused and unfused port modules: same parameter names, same output and
  gradients;
* dropout, port only (the TPU's bits cannot be reproduced): the Philox
  masks' drop fraction and 1/(1-p) scale at both sites, distinct streams
  for the two sites and the rows, the closed-form backward replaying the
  forward's masks (autograd through the plain forward agrees to 1e-5), and
  a training pass of the module drawing its row seeds from its generator.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from daspeech_torch import convert
from daspeech_torch.models import conformer as tconf
from daspeech_torch.ops import fused_ffn as tff
from daspeech_torch.ops import philox
from daspeech_tpu.models import conformer as jconf
from daspeech_tpu.ops import fused_ffn as jff
from test_torch_models import random_variables

SHAPES = [(2, 10, 16, 64), (1, 13, 8, 32), (3, 24, 32, 128)]


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(jff.pl, "pallas_call", patched)
    monkeypatch.setattr(jff, "available", lambda: True)


def make(B, T, C, Fd, seed):
    """x, the flax variables, JAX's fused module and the port's fused
    module carrying those weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    jm = jconf.FeedForwardModule(C, Fd, dropout=0.0, fused=True)
    variables = random_variables(jm, seed, x, train=False)
    tm = convert.load_flax_(tconf.FeedForwardModule(C, Fd, fused=True),
                            variables)
    return x, variables, jm, tm


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax_kernel(shape):
    x, variables, jm, tm = make(*shape, seed=sum(shape))
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_jax_kernel(shape):
    """x and every parameter's gradient of sum(out²), JAX's tree carried
    into a port module so that each lands on its torch parameter."""
    B, T, C, Fd = shape
    x, variables, jm, tm = make(*shape, seed=3 + sum(shape))
    gv, gx = jax.grad(
        lambda v, x: jnp.sum(jm.apply(v, x, train=False) ** 2),
        argnums=(0, 1))(variables, jnp.asarray(x))
    want = convert.load_flax_(tconf.FeedForwardModule(C, Fd),
                              jax.tree.map(np.asarray, gv))
    tx = torch.from_numpy(x).requires_grad_(True)
    (tm(tx) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=2e-4,
                               atol=2e-5)
    for (name, p), (_, w) in zip(tm.named_parameters(),
                                 want.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), w.detach().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_fused_and_unfused_modules_agree():
    x, _, _, fused = make(2, 10, 16, 64, seed=5)
    plain = tconf.FeedForwardModule(16, 64)
    assert ([n for n, _ in plain.named_parameters()]
            == [n for n, _ in fused.named_parameters()])
    plain.load_state_dict(fused.state_dict())
    outs, grads = [], []
    for m in (fused, plain):
        tx = torch.from_numpy(x).requires_grad_(True)
        out = m(tx)
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out ** 2).sum(),
                                         [tx, *m.parameters()]))
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-6
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max())


def test_dropout_masks_fraction_scale_and_streams():
    seeds = torch.tensor([3, -1234567, 2 ** 31 - 1], dtype=torch.int32)
    p, T = 0.1, 64
    for site, width in ((1, 512), (2, 256)):
        m = philox.ffn_keep(seeds, T, width, site, p)
        assert m.shape == (3, T, width)
        assert torch.all(m[m != 0] == torch.tensor(1.0 / (1.0 - p)))
        frac = (m == 0).float().mean().item()
        assert abs(frac - p) < 4 * math.sqrt(p * (1 - p) / m.numel())
        assert not torch.equal(m[0], m[1])                # rows differ
    # the two sites draw distinct streams from one seed
    assert not torch.equal(philox.ffn_keep(seeds, T, 256, 1, p),
                           philox.ffn_keep(seeds, T, 256, 2, p))


def test_backward_replays_the_forward_masks():
    rng = np.random.default_rng(1)
    B, T, C, Fd, p1, p2 = 2, 11, 16, 40, 0.3, 0.2
    x = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32))
    m = tconf.FeedForwardModule(C, Fd)
    params = [t.detach().clone().requires_grad_(True) for t in (
        x, m.layer_norm.weight, m.layer_norm.bias, m.w_1.weight, m.w_1.bias,
        m.w_2.weight, m.w_2.bias)]
    g = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32))
    seeds = torch.tensor([7, -9], dtype=torch.int32)
    out = tff.ffn_plain(*params, seeds, p1, p2)
    want = torch.autograd.grad(out, params, g)
    got = tff.ffn_bwd_plain(*(t.detach() for t in params), g, seeds, p1, p2)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5
    fused = tff.fused_ffn(*params, seeds, p1, p2, True)
    assert torch.equal(fused, out)
    assert torch.equal(tff.fused_ffn(*params, 0, p1, p2, False),
                       tff.ffn_plain(*params))
    # a scalar seed s gives row b the seed s + b (JAX's _norm_seeds)
    assert torch.equal(tff.fused_ffn(*params, 7, p1, p2, True),
                       tff.ffn_plain(*params, torch.tensor(
                           [7, 8], dtype=torch.int32), p1, p2))
    # the masks really dropped something
    assert (tff.ffn_plain(*params) - out).abs().max().item() > 1e-3


def test_training_pass_draws_row_seeds_from_its_generator():
    x = torch.randn(3, 9, 16, generator=torch.Generator().manual_seed(0))
    m = tconf.FeedForwardModule(16, 32, dropout=0.25, fused=True)
    run = lambda s: m(x, torch.Generator().manual_seed(s))  # noqa: E731
    a, b = run(4), run(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, run(5))
    seeds = torch.randint(-2 ** 31, 2 ** 31, (3,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(4))
    want = tff.ffn_plain(x, m.layer_norm.weight, m.layer_norm.bias,
                         m.w_1.weight, m.w_1.bias, m.w_2.weight, m.w_2.bias,
                         seeds, 0.25, 0.25)
    assert torch.equal(a, want)
    assert torch.equal(m(x), m(x, None))                  # inference


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.randn(1, 4, 256)
    m = tconf.FeedForwardModule(256, 64)
    args = (x, m.layer_norm.weight, m.layer_norm.bias, m.w_1.weight,
            m.w_1.bias, m.w_2.weight, m.w_2.bias)
    with pytest.raises(ValueError, match="CUDA"):
        tff.ffn_fwd_kernel(*(t.detach() for t in args))
    with pytest.raises(ValueError, match="CUDA"):
        tff.ffn_bwd_kernel(*(t.detach() for t in args), x)
    tff.fused_ffn(*args, 0, 0.0, 0.0, False)
    assert tff.ffn_fwd_kernel.launches == 0                # CPU: no launch


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_bf16_matches_jax_kernel(shape):
    """bf16 modules (the fused route hands the kernel bf16 x, weights and
    biases and fp32 LayerNorm parameters): the output and x's gradient
    (bf16) within one bf16 ulp of JAX's Pallas kernel in interpret mode,
    or 1e-6 of the largest magnitude (the plain bf16 bar,
    ``tests/test_torch_bf16_ops.py``); each parameter's gradient (fp32)
    within 2x JAX's own bf16 error against its fp32 module."""
    from daspeech_torch.models.layers import set_dtype
    from test_torch_bf16_models import assert_bf16_bar
    from test_torch_bf16_ops import assert_within_ulp

    B, T, C, Fd = shape
    x, variables, _, tm = make(*shape, seed=7 + sum(shape))
    set_dtype(tm, torch.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    want, grads = {}, {}
    for dt in (jnp.bfloat16, jnp.float32):
        jm = jconf.FeedForwardModule(C, Fd, dropout=0.0, fused=True,
                                     dtype=dt)
        xin = jx if dt == jnp.bfloat16 else jx.astype(jnp.float32)
        want[dt] = jm.apply(variables, xin, train=False)
        gv, gx = jax.grad(lambda v, x: jnp.sum(
            jm.apply(v, x, train=False).astype(jnp.float32) ** 2),
            argnums=(0, 1))(variables, xin)
        grads[dt] = (convert.load_flax_(tconf.FeedForwardModule(C, Fd),
                                        jax.tree.map(np.asarray, gv)), gx)
    assert want[jnp.bfloat16].dtype == jnp.bfloat16
    tx.requires_grad_(True)
    out = tm(tx)
    assert_within_ulp(out, want[jnp.bfloat16], "out")
    (out.float() ** 2).sum().backward()
    assert_within_ulp(tx.grad, grads[jnp.bfloat16][1], "dx")
    for (name, p), (_, wb), (_, wf) in zip(
            tm.named_parameters(), grads[jnp.bfloat16][0].named_parameters(),
            grads[jnp.float32][0].named_parameters()):
        assert p.grad.dtype == torch.float32, name
        assert_bf16_bar(p.grad, wb.detach(), wf.detach(), name)
