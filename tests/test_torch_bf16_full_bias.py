"""The order of sums and roundings of the bf16 full-bias attention kernels
(#3), on the CPU.

``csrc/attention_bf16.cuh`` runs the full-bias attention's bf16 entry points
in its three kernels' full-bias mode, every product on the tensor cores as
``mma.sync`` m16n8k16 with bf16 operands and fp32 accumulators. The score
q·kᵀ and dO·Vᵀ multiply bf16 inputs, exact in fp32; the fp32 [64 query ×
64 key] tile of bias4 joins each key tile's scaled score before the row
max. P, P∘Z and dS are fp32 intermediates, and each of the four products
that takes one (P·V, dq = dS·k, dk = dSᵀ·q, dv = (P∘Z)ᵀ·dO) takes it
one-term (rounded to bf16, one MMA) or two-term (hi + lo, two MMAs), as
``tests/test_torch_bf16_split.py`` sets out for #1 and #2. dbias is dS in
fp32, written by the dq kernel.

Here the kernels are emulated on tensors made with numpy from a seed: the
forward's online softmax key tile by key tile with the bias tile (as
``test_torch_bf16_split.forward``), the backward's P recomputed from the
saved statistics and each product in its form. Each form is held at the
ALiBi bias of ``chip_smoke.py`` (-m_h |i - j|, m_h = 2^(-8 h / H)) at
[2, 4, 240, 64] (dropout 0 and 0.1), whose rows are far more peaked than a
column bias leaves them, and at Tq = 65, Tk = 130 with a random bias,
padded keys and a fully masked row (dropout 0.1):

- its fp32 out, dq, dk, dv and dbias within a quarter of TOL_BF16 (2^-7 of
  each output's largest magnitude, ``chip_smoke.py``'s bar against the
  plain bf16 version) of float64 on the same bf16 inputs;
- its outputs rounded to bf16 (dbias in fp32) within TOL_BF16 of JAX's
  bf16 Pallas kernel (``fused_attention_full_bias``) in interpret mode at
  dropout 0. Dropout cannot match the TPU's bits, and JAX's kernel averages
  a fully masked row over its 128-lane key padding (ROADMAP Queue 3), so
  those cases are held to float64 only.

A product takes the one-term form wherever that holds, the two-term form
elsewhere, P·V against half the bar (``RULE_BAR``), as
``tests/test_torch_bf16_relpos.py`` holds it: its output passes into every
later layer and, through the backward's delta = rowsum(dO∘O), into every
gradient. ``FORMS`` records the choice, and the header's ``kTermsFb*``
constants must say the same.
"""

import functools
import re
from pathlib import Path

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daspeech_torch.ops import fused_attention as tfa
from daspeech_torch.ops.philox import full_bias_keep
from daspeech_tpu.ops import fused_attention as jfa
from test_torch_bf16_split import (BAR, TILE, TOL_BF16, bf16, errors,
                                   exact, product, terms)

HEADER = (Path(tfa.__file__).resolve().parent.parent / "csrc"
          / "attention_bf16.cuh")
# the form each product takes in the kernels: 1 = one-term, 2 = two-term
FORMS = {"pv": 1, "dsk": 2, "pdo": 2, "dsq": 2}
# the bar the one-term form of each product must meet (see above)
RULE_BAR = dict.fromkeys(FORMS, BAR) | {"pv": BAR / 2}
CONSTANTS = {"pv": "kTermsFbPV", "dsk": "kTermsFbDSK", "pdo": "kTermsFbPDO",
             "dsq": "kTermsFbDSQ"}
H, D = 4, 64
NAMES = ("out", "dq", "dk", "dv", "dbias")

# (bias, B, Tq, Tk, dropout_p)
CASES = [("alibi", 2, 240, 240, 0.0), ("alibi", 2, 240, 240, 0.1),
         ("random", 2, 65, 130, 0.1)]


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


def alibi(B, T):
    """``chip_smoke.alibi_bias``: -m_h |i - j| with m_h = 2^(-8 h / H)."""
    m = 2.0 ** (-8.0 * torch.arange(1, H + 1) / H)
    i = torch.arange(T)
    dist = (i[None, :] - i[:, None]).abs().float()
    return (-m[:, None, None] * dist).expand(B, H, T, T).contiguous()


def inputs(bias_kind, B, Tq, Tk, p, seed=0, masked_row=True):
    """bf16 values (as fp32) from a seed: q (scale 1/8: the score's scale
    taken in q, sm_scale 1, as chip_smoke.py's bf16 row), k, v, dO; the
    fp32 bias4 (ALiBi, or random scores with -1e30 on the last keys of
    batch row 1 and, with ``masked_row``, one fully masked query row); the
    dropout multipliers [B, H, Tq, Tk]."""
    rng = np.random.default_rng(seed)

    def x(T, scale=1.0):
        return torch.from_numpy(bf16(
            rng.normal(size=(B, H, T, D)).astype(np.float32) * scale))

    q, k, v, do = x(Tq, 0.125), x(Tk), x(Tk), x(Tq)
    if bias_kind == "alibi":
        bias = alibi(B, Tq)
    else:
        bias = torch.from_numpy(rng.normal(size=(B, H, Tq, Tk)).astype(
            np.float32))
        bias[1, :, :, Tk - Tk // 3:] = tfa.NEG
        if masked_row:
            bias[-1, 0, Tq // 2] = tfa.NEG
    seed_t = torch.tensor([int(rng.integers(0, 2 ** 31 - 1))],
                          dtype=torch.int32)
    z = (full_bias_keep(seed_t, B, H, Tq, Tk, p) if p > 0
         else torch.ones(B, H, Tq, Tk))
    return q, k, v, bias, do, z


def forward(q, k, v, bias, z, keep_scale, forms):
    """The forward kernel: (out32, m, l), key tile by key tile, as
    ``test_torch_bf16_split.forward`` with the bias tile added to the
    score: exp(s - m) against the running max in P·V's form, the fp32 sum
    of the unrounded values kept (the saved statistic) and the output
    normalized by the sum of the values P·V took."""
    B, _, Tq, _ = q.shape
    m = torch.full((B, H, Tq, 1), -float("inf"))
    l = torch.zeros(B, H, Tq, 1)
    lr = torch.zeros(B, H, Tq, 1)
    o = torch.zeros(B, H, Tq, D)
    for j0 in range(0, k.shape[2], TILE):
        sl = slice(j0, min(j0 + TILE, k.shape[2]))
        s = exact("bhqd,bhkd->bhqk", q, k[:, :, sl]) + bias[..., sl]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        m = m_new
        l = l * corr + p.sum(-1, keepdim=True)
        planes = terms(p, forms["pv"])
        taken = planes[0] if forms["pv"] == 1 else p
        lr = lr * corr + taken.sum(-1, keepdim=True).float()
        kept = sum(planes) * (z[..., sl] != 0)
        o = o * corr + torch.einsum("bhqk,bhkd->bhqd", kept,
                                    v[:, :, sl].double()).float()
    return o * keep_scale / lr, m, l


def emulate(q, k, v, bias, do, z, forms):
    """(out32, dq, dk, dv, dbias) of the kernels, fp32 before the bf16
    casts of out, dq, dk and dv."""
    out32, m, l = forward(q, k, v, bias, z, z.max().item(), forms)
    # the dq and dk/dv kernels: P from the saved statistics, dS in fp32
    s = exact("bhqd,bhkd->bhqk", q, k) + bias
    p = torch.exp(s - m) / l
    delta = (do.double() * out32.double()).sum(-1, keepdim=True).float()
    dp = exact("bhqd,bhkd->bhqk", do, v)
    ds = p * (z * dp - delta)
    dq = product("bhqk,bhkd->bhqd", ds, k, forms["dsk"])
    dk = product("bhqk,bhqd->bhkd", ds, q, forms["dsq"])
    dv = product("bhqk,bhqd->bhkd", p * z, do, forms["pdo"])
    return out32, dq, dk, dv, ds


def float64_reference(q, k, v, bias, do, z):
    """(out, dq, dk, dv, dbias) of the plain versions in float64."""
    q, k, v, do, z, bias = (t.double() for t in (q, k, v, do, z, bias))
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) + bias, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p * z, v)
    dv = torch.einsum("bhqk,bhqd->bhkd", p * z, do)
    dp = z * torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return (out, torch.einsum("bhqk,bhkd->bhqd", ds, k),
            torch.einsum("bhqk,bhqd->bhkd", ds, q), dv, ds)


def test_the_kernel_header_states_the_forms():
    text = HEADER.read_text()
    for name, const in CONSTANTS.items():
        m = re.search(rf"constexpr int {const} = (\d);", text)
        assert m, const
        assert int(m.group(1)) == FORMS[name], (name, m.group(1))


def test_a_fully_masked_row_averages_over_its_keys():
    """The random case's fully masked row: uniform P over the Tk keys (the
    plain version's mean of v), kept in the emulation as in float64."""
    q, k, v, bias, do, z = inputs("random", 2, 65, 130, 0.0)
    out32 = emulate(q, k, v, bias, do, z, FORMS)[0]
    want = v[-1, 0].double().mean(0)
    assert (out32[-1, 0, 65 // 2].double() - want).abs().max() <= 1e-6
    assert (float64_reference(q, k, v, bias, do, z)[0][-1, 0, 65 // 2]
            - want).abs().max() <= 1e-12


@functools.lru_cache(maxsize=None)
def case_errors(case, forms):
    """Each output's error against float64 (over its largest magnitude) at
    ``case`` with the products in ``forms`` (a tuple of FORMS' items)."""
    x = inputs(*case)
    return errors(emulate(*x, dict(forms)), float64_reference(*x))


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
    output stays within its bar (RULE_BAR) at every case."""
    alone = tuple(dict(FORMS, **{product_name: 1}).items())
    worst = max(max(case_errors(c, alone)) for c in CASES)
    bar = RULE_BAR[product_name]
    print(f"{product_name} one-term, the rest as chosen: worst error "
          f"{worst:.3g} against the bar {bar:.3g}")
    assert (worst > bar) == (FORMS[product_name] == 2), worst


def _jax_full_bias(q, k, v, bias, do):
    """JAX's bf16 Pallas kernel (interpret mode), forward and vjp, at
    dropout 0: (out, dq, dk, dv, dbias) as float32."""
    def to_jax(x):
        return jnp.asarray(x.numpy()).astype(jnp.bfloat16)

    out, vjp = jax.vjp(lambda q, k, v, b: jfa.fused_attention_full_bias(
        q, k, v, b, 0, 1.0, 0.0, False), to_jax(q), to_jax(k), to_jax(v),
        jnp.asarray(bias.numpy()))
    assert out.dtype == jnp.bfloat16
    grads = vjp(to_jax(do))
    assert grads[3].dtype == jnp.float32
    return [torch.from_numpy(np.array(x.astype(jnp.float32)))
            for x in (out, *grads)]


@pytest.mark.parametrize("bias_kind,Tq,Tk", [("alibi", 240, 240),
                                             ("random", 65, 130)])
def test_chosen_forms_within_the_bar_of_jax_pallas(bias_kind, Tq, Tk):
    x = inputs(bias_kind, 2, Tq, Tk, 0.0, seed=1, masked_row=False)
    want = _jax_full_bias(*x[:5])
    got = emulate(*x, FORMS)
    got = [torch.from_numpy(bf16(t.numpy())) for t in got[:4]] + [got[4]]
    err = [((g - w).abs().max() / w.abs().max()).item()
           for g, w in zip(got, want)]
    print(f"{bias_kind} [2,{H},{Tq},{Tk}]: outputs vs JAX's Pallas kernel, "
          "error over max |JAX|: " + ", ".join(f"{n} {e:.3g}"
                                               for n, e in zip(NAMES, err)))
    assert max(err) <= TOL_BF16, dict(zip(NAMES, err))
