"""The operand rounding of the bf16 attention kernels (#1 packed, #2
head-major), on the CPU.

``csrc/attention_bf16.cuh`` runs every product of the bf16 entry points on
the tensor cores as ``mma.sync`` m16n8k16 with bf16 operands and fp32
accumulators. Q·Kᵀ and dO·Vᵀ multiply bf16 inputs, whose products are exact
in fp32; P and dS are fp32 intermediates, and each of the four products
that takes one (P·V, dS·K, (P∘Z)ᵀ·dO, dSᵀ·Q) takes it in one of two forms:

- one-term: x rounded to bf16 (round to nearest even), one MMA;
- two-term: hi = bf16(x), lo = bf16(x − hi), lo·B + hi·B, two MMAs.

Here that rounding is emulated in numpy and put into the products of the
plain forward and backward, key tile by key tile as the kernels take them:
the forward's online softmax rounds exp(s − m) against the running max,
sums the rounded values into the normalizer of its output (so that the
output's weights sum to one, the sum the backward's delta relies on) and
keeps the fp32 sum of the unrounded values as the saved statistic; the
dropout multiplier 1/keep_p is applied after the product. Products of bf16
values are exact in float64, so the emulation isolates the operand
rounding; sums are rounded to fp32 as the kernels keep them.

Each form is held to two yardsticks at cell T's packed shape [2, 240, 4·64]
(dropout 0 and 0.1) and at a head-major [1, 2, 1040, 64] (J-long's
FastSpeech 2 decoder length):

- its fp32 out, dq, dk and dv within a quarter of TOL_BF16 (2^-7 of the
  output's largest magnitude, ``chip_smoke.py``'s bar against the plain
  bf16 version) of float64 on the same bf16 inputs;
- its outputs rounded to bf16 within TOL_BF16 of JAX's bf16 Pallas kernels
  (``fused_attention_packed``, ``fused_attention``) in interpret mode.

A product takes the one-term form wherever that holds, the two-term form
elsewhere; ``FORMS`` records the choice, and the header's own constants
must say the same (a change of form has to change this test).
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from daspeech_torch.ops import fused_attention as tfa
from daspeech_torch.ops.philox import attention_keep
from daspeech_tpu.ops import fused_attention as jfa
from torch_cli_corpus import one_torch_thread  # noqa: F401

TOL_BF16 = 2.0 ** -7
BAR = TOL_BF16 / 4
TILE = 64
HEADER = (Path(tfa.__file__).resolve().parent.parent / "csrc"
          / "attention_bf16.cuh")
# the form each product takes in the kernels: 1 = one-term, 2 = two-term
FORMS = {"pv": 1, "dsk": 2, "pdo": 2, "dsq": 2}
# the header's constant of each product's term count
CONSTANTS = {"pv": "kTermsPV", "dsk": "kTermsDSK", "pdo": "kTermsPDO",
             "dsq": "kTermsDSQ"}

# (layout, B, H, T, dropout_p)
CASES = [("packed", 2, 4, 240, 0.0), ("packed", 2, 4, 240, 0.1),
         ("head_major", 1, 2, 1040, 0.0)]


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)


def bf16(x: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 (round to nearest even), held as fp32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    bits = bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def terms(x: torch.Tensor, n: int):
    """The operand planes of an fp32 tensor in the n-term form (float64)."""
    xn = x.float().numpy()
    hi = bf16(xn)
    if n == 1:
        return [torch.from_numpy(hi).double()]
    lo = bf16(xn - hi)        # x - hi is exact in fp32
    return [torch.from_numpy(lo).double(), torch.from_numpy(hi).double()]


def product(eq, x, y, n):
    """einsum(eq, x, y) with x, an fp32 intermediate, in the n-term form
    and y bf16 values; the sum rounded to fp32."""
    return sum(torch.einsum(eq, t, y.double()) for t in terms(x, n)).float()


def exact(eq, x, y):
    """A product of bf16 inputs: exact in float64, rounded to fp32."""
    return torch.einsum(eq, x.double(), y.double()).float()


def forward(q, k, v, bias, z, keep_scale, forms):
    """The kernels' forward on head-major fp32 tensors of bf16 values:
    (out32, m, l), tile by tile of 64 keys."""
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    m = torch.full((B, H, Tq, 1), -float("inf"))
    l = torch.zeros(B, H, Tq, 1)
    lr = torch.zeros(B, H, Tq, 1)
    o = torch.zeros(B, H, Tq, d)
    for j0 in range(0, Tk, TILE):
        sl = slice(j0, min(j0 + TILE, Tk))
        s = exact("bhqd,bhkd->bhqk", q, k[:, :, sl]) + bias[:, None, None, sl]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        m = m_new
        l = l * corr + p.sum(-1, keepdim=True)
        planes = terms(p, forms["pv"])
        lr = lr * corr + sum(planes).sum(-1, keepdim=True).float()
        kept = sum(planes) * (z[..., sl] != 0)
        o = o * corr + torch.einsum("bhqk,bhkd->bhqd", kept,
                                    v[:, :, sl].double()).float()
    return o * keep_scale / lr, m, l


def backward(q, k, v, bias, do, z, out32, m, l, forms):
    """The kernels' backward (dq, dk, dv) from the forward's fp32 output
    and statistics."""
    s = exact("bhqd,bhkd->bhqk", q, k) + bias[:, None, None, :]
    p = torch.exp(s - m) / l
    delta = (do.double() * out32.double()).sum(-1, keepdim=True).float()
    dp = exact("bhqd,bhkd->bhqk", do, v)
    ds = p * (z * dp - delta)
    dv = product("bhqk,bhqd->bhkd", p * z, do, forms["pdo"])
    dq = product("bhqk,bhkd->bhqd", ds, k, forms["dsk"])
    dk = product("bhqk,bhqd->bhkd", ds, q, forms["dsq"])
    return dq, dk, dv


def inputs(layout, B, H, T, p, seed=0):
    """bf16 values (as fp32, head-major) from a seed, the column bias with
    padded keys, and the dropout multipliers [B, H, T, T]. ``layout`` only
    names the case: the emulation is the same in both layouts."""
    rng = np.random.default_rng(seed)
    d = 64

    def x(scale=1.0):
        return torch.from_numpy(bf16(
            rng.normal(size=(B, H, T, d)).astype(np.float32) * scale))

    q, k, v, do = x(d ** -0.5), x(), x(), x()
    keep = rng.integers(T // 2, T + 1, size=B)
    keep[0] = T
    bias = torch.from_numpy(np.where(np.arange(T)[None, :] >= keep[:, None],
                                     tfa.NEG, 0.0).astype(np.float32))
    seeds = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, size=B,
                                          dtype=np.int32))
    z = (attention_keep(seeds, H, T, T, p) if p > 0
         else torch.ones(B, H, T, T))
    return q, k, v, bias, do, z


def packed(x):
    B, H, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, H * d)


def float64_reference(q, k, v, bias, do, z):
    """(out, dq, dk, dv) of the plain versions in float64."""
    q, k, v, do, z = (t.double() for t in (q, k, v, do, z))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias.double()[:, None, None]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p * z, v)
    dv = torch.einsum("bhqk,bhqd->bhkd", p * z, do)
    dp = z * torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return (out, torch.einsum("bhqk,bhkd->bhqd", ds, k),
            torch.einsum("bhqk,bhqd->bhkd", ds, q), dv)


def emulate(q, k, v, bias, do, z, forms):
    """(out32, dq, dk, dv) of the kernels, fp32 before their bf16 cast
    (z's largest value is the dropout multiplier 1/keep_p, or 1)."""
    out32, m, l = forward(q, k, v, bias, z, z.max().item(), forms)
    return (out32, *backward(q, k, v, bias, do, z, out32, m, l, forms))


def errors(got, want):
    """Each output's max abs error over its largest magnitude."""
    return [((g.double() - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]


NAMES = ("out", "dq", "dk", "dv")


def test_bf16_rounds_to_nearest_even_and_splits_exactly():
    x = np.array([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, 1 + 2.0 ** -8 + 2.0 ** -20,
                  -(1 + 2.0 ** -8), 1 - 2.0 ** -10], dtype=np.float32)
    assert bf16(x).tolist() == [1.0, 1 + 2.0 ** -6, 1 + 2.0 ** -7,
                                -1.0, 1.0]
    want = torch.tensor(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bf16(x), want)
    rng = np.random.default_rng(0)
    y = (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(
        np.float32)
    np.testing.assert_array_equal(
        bf16(y), torch.from_numpy(y).to(torch.bfloat16).float().numpy())
    lo, hi = terms(torch.from_numpy(y), 2)
    rel = ((lo + hi).numpy() - y) / y
    assert np.abs(rel).max() <= 2.0 ** -16
    assert (np.abs(hi.numpy() - y) / np.abs(y)).max() <= 2.0 ** -8


def test_the_kernel_header_states_the_forms():
    text = HEADER.read_text()
    for name, const in CONSTANTS.items():
        m = re.search(rf"constexpr int {const} = (\d);", text)
        assert m, const
        assert int(m.group(1)) == FORMS[name], (name, m.group(1))


@functools.lru_cache(maxsize=None)
def case_errors(case, forms):
    """Each output's error against float64 (over its largest magnitude) at
    ``case`` with the products in ``forms`` (a tuple of FORMS' items)."""
    q, k, v, bias, do, z = inputs(*case)
    return errors(emulate(q, k, v, bias, do, z, dict(forms)),
                  float64_reference(q, k, v, bias, do, z))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_chosen_forms_within_a_quarter_of_the_bar_of_float64(case):
    one = case_errors(case, tuple(dict.fromkeys(FORMS, 1).items()))
    two = case_errors(case, tuple(dict.fromkeys(FORMS, 2).items()))
    chosen = case_errors(case, tuple(FORMS.items()))
    print(f"{case}: error vs float64 over max |ref|, "
          + ", ".join(f"{n} one-term {a:.3g} two-term {b:.3g} chosen {c:.3g}"
                      for n, a, b, c in zip(NAMES, one, two, chosen)))
    assert max(chosen) <= BAR, dict(zip(NAMES, chosen))


@pytest.mark.parametrize("product_name", list(FORMS))
def test_two_term_form_only_where_the_one_term_form_misses_the_bar(
        product_name):
    """A product takes the one-term form iff, with it alone one-term, every
    output stays within the bar at every case."""
    alone = tuple(dict(FORMS, **{product_name: 1}).items())
    worst = max(max(case_errors(c, alone)) for c in CASES)
    print(f"{product_name} one-term, the rest as chosen: worst error "
          f"{worst:.3g} against the bar {BAR:.3g}")
    assert (worst > BAR) == (FORMS[product_name] == 2), worst


def _jax_attention(layout, q, k, v, bias, do, H):
    """JAX's bf16 Pallas kernel (interpret mode), forward and vjp, at
    dropout 0: (out, dq, dk, dv) head-major, as float32."""
    jb = jnp.asarray(bias.numpy())

    def to_jax(x):
        x = packed(x) if layout == "packed" else x
        return jnp.asarray(x.numpy()).astype(jnp.bfloat16)

    if layout == "packed":
        fn = (lambda a, b, c: jfa.fused_attention_packed(
            a, b, c, jb, 0, 1.0, 0.0, False, H))
    else:
        fn = (lambda a, b, c: jfa.fused_attention(a, b, c, jb, 0, 1.0, 0.0,
                                                  False))
    out, vjp = jax.vjp(fn, to_jax(q), to_jax(k), to_jax(v))
    assert out.dtype == jnp.bfloat16
    res = (out, *vjp(to_jax(do)))
    B, _, T, d = q.shape

    def back(x):
        t = torch.from_numpy(np.asarray(x.astype(jnp.float32)))
        return (t.reshape(B, T, H, d).transpose(1, 2) if layout == "packed"
                else t)

    return [back(x) for x in res]


@pytest.mark.parametrize("layout,B,H,T", [("packed", 2, 4, 240),
                                          ("head_major", 1, 2, 1040)])
def test_chosen_forms_within_the_bar_of_jax_pallas(layout, B, H, T):
    q, k, v, bias, do, z = inputs(layout, B, H, T, 0.0, seed=1)
    want = _jax_attention(layout, q, k, v, bias, do, H)
    got = [torch.from_numpy(bf16(x.numpy())) for x in
           emulate(q, k, v, bias, do, z, FORMS)]
    err = [((g - w).abs().max() / w.abs().max()).item()
           for g, w in zip(got, want)]
    print(f"{layout} [{B},{H},{T}]: bf16 outputs vs JAX's Pallas kernel, "
          "error over max |JAX|: "
          + ", ".join(f"{n} {e:.3g}" for n, e in zip(NAMES, err)))
    assert max(err) <= TOL_BF16, dict(zip(NAMES, err))
