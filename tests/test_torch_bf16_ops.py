"""The port's bf16 compute (``--dtype bfloat16``) at the op level, on the
CPU, against the JAX package.

* the plain bf16 versions of the packed attention (#1), the head-major
  attention (#2), the link extraction (#4) and the rel-pos attention (#5),
  forward and backward, against JAX's Pallas functions in interpret mode on
  the same bf16 inputs. Both compute in fp32 and round each output once, so
  they may differ where the fp32 sums (taken in another order) straddle a
  rounding boundary: each element is held to one bf16 ulp of JAX's value,
  or to 1e-6 of the tensor's largest magnitude where that is larger. The
  links and dgates are fp32 on both sides: 1e-5 absolute, the fp32 bar of
  ``tests/test_torch_train.py``;
* the compute-dtype layers against flax: ``Linear`` and ``nn.Dense``,
  ``LayerNorm`` and ``nn.LayerNorm``, ``Conv1d`` and ``nn.Conv``, each with
  ``dtype=bfloat16`` (the same one-ulp bar);
* dropout's scale rounded to bf16 (1.109375 at rate 0.1, JAX's
  ``jnp.asarray(1 / keep_p, bf16)``) and gelu by dtype (tanh form in bf16,
  erf in fp32), each against JAX's;
* the fused FFN (#6), the MRF level (#7) and the full-bias attention
  (#3) take bf16 operands; the bf16 C entry points take the fp32 ones'
  arguments (an attention forward, one pointer more: its fp32 output).
"""

import ctypes
import math

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from daspeech_torch.models import conformer as tconf
from daspeech_torch.models import layers as tlayers
from daspeech_torch.ops import _build
from daspeech_torch.ops import fused_attention as tfa
from daspeech_torch.ops import fused_ffn as tff
from daspeech_torch.ops import fused_links as tfl
from daspeech_torch.ops import fused_mrf as tmrf
from daspeech_torch.ops import fused_relpos as tfr
from daspeech_tpu.models import layers as jlayers
from daspeech_tpu.ops import fused_attention as jfa
from daspeech_tpu.ops import fused_links as jfl
from daspeech_tpu.ops import fused_relpos as jfr

BF16 = torch.bfloat16
FLOOR = 1e-6         # of the tensor's largest magnitude
ATOL_F32 = 1e-5      # fp32 outputs (links, dgates)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)
    monkeypatch.setattr(jfr.pl, "pallas_call", patched)
    monkeypatch.setattr(jfl, "INTERPRET", True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    a = np.abs(x.astype(np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def assert_within_ulp(got: torch.Tensor, want, what=""):
    """Each element within one bf16 ulp of JAX's, or FLOOR of the tensor's
    largest magnitude where that is larger."""
    assert got.dtype == BF16, (what, got.dtype)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    got = got.detach().float().numpy().astype(np.float64)
    bar = np.maximum(bf16_ulp(want), FLOOR * np.abs(want).max())
    err = np.abs(got - want)
    assert np.all(err <= bar), (what, float((err / bar).max()),
                                int((err > bar).sum()))


def _bf(rng, *shape, scale=1.0):
    """A bf16 tensor from a numpy seed, and the same values for JAX."""
    t = torch.tensor(rng.normal(size=shape).astype(np.float32) * scale).to(
        BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _bias(B, Tk):
    valid = np.ones((B, Tk), bool)
    valid[-1, -3:] = False
    return np.where(valid, 0.0, tfa.NEG).astype(np.float32)


# ------------------------------------------------ plain bf16 versions vs JAX

@pytest.mark.parametrize("B,Tq,Tk,H,d", [(2, 10, 13, 2, 8), (2, 7, 24, 2, 16)])
def test_packed_attention(B, Tq, Tk, H, d):
    rng = np.random.default_rng(Tq + Tk)
    (tq, jq), (tk, jk), (tv, jv) = (_bf(rng, B, T, H * d)
                                    for T in (Tq, Tk, Tk))
    tq, jq = tq * 0.25, jq * 0.25
    tg, jg = _bf(rng, B, Tq, H * d)
    bias = _bias(B, Tk)
    want, vjp = jax.vjp(lambda q, k, v: jfa.fused_attention_packed(
        q, k, v, jnp.asarray(bias), 0, 1.0, 0.0, False, H), jq, jk, jv)
    assert want.dtype == jnp.bfloat16
    want_g = vjp(jg)
    ts = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tfa.fused_attention_packed(*ts, torch.tensor(bias), H)
    assert_within_ulp(out, want, "out")
    out.backward(tg)
    for name, x, w in zip("qkv", ts, want_g):
        assert_within_ulp(x.grad, w, f"d{name}")


@pytest.mark.parametrize("B,H,Tq,Tk,d", [(2, 3, 10, 13, 16), (1, 2, 33, 17, 8)])
def test_head_major_attention(B, H, Tq, Tk, d):
    rng = np.random.default_rng(H + Tq)
    (tq, jq), (tk, jk), (tv, jv) = (_bf(rng, B, H, T, d)
                                    for T in (Tq, Tk, Tk))
    tg, jg = _bf(rng, B, H, Tq, d)
    bias = _bias(B, Tk)
    sc = 1.0 / math.sqrt(d)
    want, vjp = jax.vjp(lambda q, k, v: jfa.fused_attention(
        q, k, v, jnp.asarray(bias), 0, sc, 0.0, False), jq, jk, jv)
    want_g = vjp(jg)
    ts = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tfa.fused_attention(*ts, torch.tensor(bias), sc)
    assert_within_ulp(out, want, "out")
    out.backward(tg)
    for name, x, w in zip("qkv", ts, want_g):
        assert_within_ulp(x.grad, w, f"d{name}")


@pytest.mark.parametrize("B,L,H,dk,mtl,ol", [
    (2, 13, 2, 8, None, (13, 10)),
    (2, 20, 2, 8, 6, (20, 17)),       # the transition band
])
def test_links(B, L, H, dk, mtl, ol):
    rng = np.random.default_rng(L + dk)
    (tq, jq), (tk, jk) = _bf(rng, B, L, H * dk), _bf(rng, B, L, H * dk)
    gates = np.asarray(jax.nn.log_softmax(
        rng.normal(size=(B, L, H)).astype(np.float32), axis=-1))
    ol = np.asarray(ol, np.int32)
    sc = 1.0 / math.sqrt(dk)
    valid = np.asarray(tfl._valid(L, torch.from_numpy(ol), mtl, "cpu"))
    g = np.where(valid, rng.normal(size=(B, L, L)), 0.0).astype(np.float32)
    want, vjp = jax.vjp(lambda q, k, gt: jfl.fused_extract_links(
        q, k, gt, jnp.asarray(ol), H, sc, mtl), jq, jk, jnp.asarray(gates))
    assert want.dtype == jnp.float32
    dq, dk_, dg = vjp(jnp.asarray(g))
    tq, tk = tq.clone().requires_grad_(), tk.clone().requires_grad_()
    tg = torch.tensor(gates, requires_grad=True)
    links = tfl.fused_extract_links(tq, tk, tg, torch.from_numpy(ol), H, sc,
                                    mtl)
    assert links.dtype == torch.float32
    np.testing.assert_array_equal(np.isfinite(links.detach().numpy()),
                                  np.isfinite(np.asarray(want)))
    fin = np.isfinite(np.asarray(want))
    np.testing.assert_allclose(links.detach().numpy()[fin],
                               np.asarray(want)[fin], rtol=0, atol=ATOL_F32)
    links.backward(torch.tensor(g))
    assert_within_ulp(tq.grad, dq, "dq")
    assert_within_ulp(tk.grad, dk_, "dk")
    assert tg.grad.dtype == torch.float32
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(dg), rtol=0,
                               atol=ATOL_F32)


@pytest.mark.parametrize("B,T,H,d", [(2, 10, 2, 8), (1, 17, 2, 8)])
def test_relpos(B, T, H, d):
    rng = np.random.default_rng(B + T)
    C = H * d
    (tq, jq), (tk, jk), (tv, jv) = (_bf(rng, B, T, C) for _ in range(3))
    ta, ja = _bf(rng, B, T, H * C, scale=0.3)
    e32 = np.asarray(jfr.relpos_basis(T, C)[2])
    te = torch.tensor(e32).to(BF16)
    je = jnp.asarray(e32).astype(jnp.bfloat16)
    bias = _bias(B, T)
    tg, jg = _bf(rng, B, T, C)
    sc = 1.0 / math.sqrt(d)
    want, vjp = jax.vjp(lambda q, k, v, a: jfr.fused_attention_relpos(
        q, k, v, a, je, jnp.asarray(bias), jnp.zeros((B,), jnp.int32), sc,
        0.0, False, H), jq, jk, jv, ja)
    want_g = vjp(jg)
    ts = [x.clone().requires_grad_() for x in (tq, tk, tv, ta)]
    out = tfr.fused_attention_relpos(*ts, te, torch.tensor(bias), H, sc)
    assert_within_ulp(out, want, "out")
    out.backward(tg)
    for name, x, w in zip("qkva", ts, want_g):
        assert_within_ulp(x.grad, w, f"d{name}")


# ------------------------------------------- compute-dtype layers vs flax

def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_is_flax_dense(bias):
    rng = np.random.default_rng(1)
    x = _x(rng, 3, 5, 24)
    w, b = _x(rng, 24, 40) * 0.2, _x(rng, 40) * 0.1
    jm = nn.Dense(40, use_bias=bias, dtype=jnp.bfloat16)
    params = {"kernel": w, **({"bias": b} if bias else {})}
    want = jm.apply({"params": params}, jnp.asarray(x))
    lin = tlayers.set_dtype(tlayers.Linear(24, 40, bias=bias), BF16)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(w.T))
        if bias:
            lin.bias.copy_(torch.tensor(b))
    assert_within_ulp(lin(torch.tensor(x)), want)


def test_layer_norm_is_flax_layer_norm():
    rng = np.random.default_rng(2)
    x = _x(rng, 4, 6, 32) * 3 + 1
    scale, bias = 1 + _x(rng, 32) * 0.1, _x(rng, 32) * 0.1
    jm = nn.LayerNorm(dtype=jnp.bfloat16)
    want = jm.apply({"params": {"scale": scale, "bias": bias}},
                    jnp.asarray(x).astype(jnp.bfloat16))
    ln = tlayers.set_dtype(tlayers.layer_norm(32), BF16)
    with torch.no_grad():
        ln.weight.copy_(torch.tensor(scale))
        ln.bias.copy_(torch.tensor(bias))
    assert_within_ulp(ln(torch.tensor(x).to(BF16)), want)


def test_conv1d_is_flax_conv():
    rng = np.random.default_rng(3)
    x = _x(rng, 2, 11, 8)
    w, b = _x(rng, 5, 8, 12) * 0.3, _x(rng, 12) * 0.1
    jm = nn.Conv(12, (5,), padding=[(2, 2)], dtype=jnp.bfloat16)
    want = jm.apply({"params": {"kernel": w, "bias": b}}, jnp.asarray(x))
    conv = tlayers.set_dtype(tlayers.Conv1d(8, 12, 5, padding=2), BF16)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(np.transpose(w, (2, 1, 0))))
        conv.bias.copy_(torch.tensor(b))
    got = conv(torch.tensor(x).transpose(1, 2)).transpose(1, 2)
    assert_within_ulp(got, want)


def test_set_dtype_reaches_every_compute_module():
    ffn = tconf.FeedForwardModule(16, 32)
    tlayers.set_dtype(ffn, BF16)
    assert {m.dtype for m in ffn.modules()
            if isinstance(m, tlayers.Compute)} == {BF16}
    assert all(p.dtype == torch.float32 for p in ffn.parameters())
    assert ffn(torch.randn(2, 3, 16)).dtype == BF16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tlayers.set_dtype(ffn, torch.float16)


# ------------------------------------------------- dropout scale and gelu

@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_bf16_dropout_scale_is_jax_s(rate):
    keep_p = round((1.0 - rate) * 65536) / 65536.0
    jax_scale = float(jnp.asarray(1.0 / keep_p, jnp.bfloat16))
    x = torch.ones(64, 64, dtype=BF16)
    y = tlayers.dropout(x, rate, torch.Generator().manual_seed(0))
    assert y.dtype == BF16
    kept = y[y != 0].float().unique()
    assert kept.tolist() == [jax_scale]
    if rate == 0.1:
        assert jax_scale == 1.109375
    # fp32 keeps the unrounded scale
    y32 = tlayers.dropout(x.float(), rate, torch.Generator().manual_seed(0))
    assert y32[y32 != 0].unique().item() == pytest.approx(1.0 / keep_p,
                                                           rel=1e-7)
    assert torch.equal(y32 != 0, y != 0)


def test_gelu_by_dtype_is_jax_s():
    """bf16: the tanh form, rounded once (within one ulp of its float64
    value, or 1e-6 of the largest where the fp32 form cancels); JAX on XLA:CPU rounds each of its ops to bf16, so the two are
    held by the module bar, ||port - jax_bf16|| <= 2 ||jax_bf16 - jax_fp32||
    (ROADMAP Queue 3). fp32: the erf form, 1e-6 of JAX's."""
    rng = np.random.default_rng(4)
    x = _x(rng, 4096) * 3
    xb = torch.tensor(x).to(BF16)
    xv = xb.float().numpy().astype(np.float64)
    tanh_form = 0.5 * xv * (1 + np.tanh(np.sqrt(2 / np.pi)
                                        * (xv + 0.044715 * xv ** 3)))
    got = tlayers.gelu(xb)
    assert got.dtype == BF16
    err = np.abs(got.float().numpy() - tanh_form)
    assert np.all(err <= np.maximum(bf16_ulp(tanh_form),
                                    FLOOR * np.abs(tanh_form).max()))
    want_b = np.asarray(jlayers.gelu(jnp.asarray(xv, jnp.bfloat16)).astype(
        jnp.float32), np.float64)
    want32 = np.asarray(jlayers.gelu(jnp.asarray(xv, jnp.float32)),
                        np.float64)
    assert (np.linalg.norm(got.float().numpy() - want_b)
            <= 2 * np.linalg.norm(want_b - want32))
    np.testing.assert_allclose(tlayers.gelu(torch.tensor(x)).numpy(),
                               np.asarray(jlayers.gelu(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


# ------------------------- #6, #7, #3 in bf16 (formerly fp32 only)

def _bf16_calls():
    """Each of the three kernels' entry points (and the fused FFN's module
    route) on bf16 operands: (result, the dtype it must have)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 16, generator=g).to(BF16)

    def ffn():
        w1, w2 = (torch.randn(s, generator=g).to(BF16) * 0.2
                  for s in ((32, 16), (16, 32)))
        return tff.fused_ffn(x, torch.ones(16), torch.zeros(16), w1,
                             torch.zeros(32, dtype=BF16), w2,
                             torch.zeros(16, dtype=BF16), 0, 0.0, 0.0,
                             False), BF16

    def ffn_module():
        m = tlayers.set_dtype(tconf.FeedForwardModule(16, 32, fused=True),
                              BF16)
        return m(x), BF16

    def mrf():
        with torch.no_grad():
            return tmrf.mrf_level(torch.randn(1, 32, 20, generator=g),
                                  (torch.randn(36, 32, 32, generator=g)
                                   * 0.05).to(BF16), torch.zeros(12, 32),
                                  (3, 3), ((1, 3, 5), (1, 3, 5))), \
                torch.float32

    def full_bias():
        q = torch.randn(1, 2, 6, 64, generator=g).to(BF16)
        return tfa.fused_attention_full_bias(q, q, q, torch.zeros(1, 2, 6, 6),
                                             0, 1.0, 0.0, False), BF16

    return {"fused_ffn": ffn, "FeedForwardModule": ffn_module,
            "mrf_level": mrf, "full_bias": full_bias}


@pytest.mark.parametrize("name", ["fused_ffn", "FeedForwardModule",
                                  "mrf_level", "full_bias"])
def test_bf16_kernels_take_bf16(name):
    """#6, #7 and #3 take bf16 operands on the CPU (their plain bf16
    versions): a finite result of the kernel's output dtype."""
    out, dtype = _bf16_calls()[name]()
    assert out.dtype == dtype and torch.isfinite(out.float()).all()


def test_bf16_entry_points_share_the_fp32_signatures():
    """Each ``_bf16`` C entry point takes the fp32 one's arguments, and a
    forward one pointer more after the statistics' (its fp32 output); the
    wrappers take fp32 or bf16 operands and nothing else."""
    for name in _build.BF16_ENTRIES:
        got = list(_build.SIGNATURES[f"{name}_bf16"])
        if name in _build.OUT32_AT:
            assert got.pop(_build.OUT32_AT[name]) is ctypes.c_void_p
        assert tuple(got) == _build.SIGNATURES[name]
    q = torch.zeros(2, 3, dtype=BF16)
    assert tfa.operand_dtype("op", q) == BF16
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.operand_dtype("op", q.half())
