"""The precision choice of the tensor-core attention kernels, on the CPU.

``csrc/attention_tc.cuh`` runs every product of the attention kernels'
backward and inference forward (packed and head-major #1/#2, full-bias #3,
rel-pos #5) on the tensor cores in 3xTF32: each fp32 operand x is split into
hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and a·b is taken as
lo·hi + hi·lo + hi·hi with fp32 accumulation. Here ``cvt.rna.tf32`` is
emulated with numpy bit operations (round to a 10-bit mantissa, ties away
from zero) and put into the products of :func:`attention_plain` and
:func:`attention_bwd_plain` at [2, 240, 4·64], inputs from a seed. Each
product of tf32 values is exact in float64, so the emulation isolates the
operand rounding; the sums are rounded to fp32 as the kernels store them.

The 3xTF32 results are held within 1e-5 of the float64 versions (a tenth of
the kernels' 1e-4 bar against their plain versions); plain 1xTF32 (hi·hi
only) must be at least ten times further off, which is why the kernels do
not take it. The same holds for the rel-pos attention's products (the
320-deep score [q_u | a]·[k | e]ᵀ, and dq, dk, dv and da) at [2, 120, 4·64]
and for the full-bias attention's (its gradient dbias = dS included) at
[2, 4, 120, 64].
"""

import numpy as np
import pytest
import torch

from daspeech_torch.ops import fused_attention as fa
from daspeech_torch.ops import fused_relpos as fr

B, T, H, D = 2, 240, 4, 64
TOL_3X = 1e-5


def tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round half away from zero
    (sign and magnitude are separate bits, so adding half an ulp of the
    kept mantissa to the magnitude rounds ties away from zero)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x: torch.Tensor):
    """(hi, lo) of an fp32 tensor, both tf32 values held as fp32."""
    xn = x.numpy()
    hi = tf32(xn)
    lo = tf32(xn - hi)       # exact in fp32: x and hi share the top bits
    return torch.from_numpy(hi), torch.from_numpy(lo)


def make_einsum(terms: int):
    """einsum whose fp32 operands go through the tensor cores' split:
    3 = lo·hi + hi·lo + hi·hi (3xTF32), 1 = hi·hi (1xTF32)."""

    def einsum(eq, a, b):
        (ah, al), (bh, bl) = split(a.float()), split(b.float())

        def f(x, y):
            return torch.einsum(eq, x.double(), y.double())

        s = f(ah, bh) if terms == 1 else f(al, bh) + f(ah, bl) + f(ah, bh)
        return s.float()

    return einsum


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H * D)).astype(np.float32) * D ** -0.5
    k, v, do = (rng.normal(size=(B, T, H * D)).astype(np.float32)
                for _ in range(3))
    keep = rng.integers(T // 2, T + 1, size=B)
    keep[0] = T
    bias = np.where(np.arange(T)[None, :] >= keep[:, None], fa.NEG,
                    0.0).astype(np.float32)
    return [torch.from_numpy(x) for x in (q, k, v, bias, do)]


def _heads(x):
    return x.reshape(B, x.shape[1], H, D)


def attention_split(q, k, v, bias, einsum):
    """:func:`fa.attention_plain` (no dropout, scale 1) with its two
    products taken by ``einsum``; softmax in fp32."""
    s = einsum("bqhd,bkhd->bhqk", _heads(q), _heads(k))
    p = torch.softmax(s + bias[:, None, None, :], dim=-1)
    return einsum("bhqk,bkhd->bqhd", p, _heads(v)).reshape(B, T, H * D)


def attention_bwd_split(q, k, v, bias, do, einsum):
    """:func:`fa.attention_bwd_plain` (no dropout, scale 1) with its five
    products taken by ``einsum``: (dq, dk, dv)."""
    s = einsum("bqhd,bkhd->bhqk", _heads(q), _heads(k))
    p = torch.softmax(s + bias[:, None, None, :], dim=-1)
    do4 = _heads(do)
    dv = einsum("bhqk,bqhd->bkhd", p, do4)
    dp = einsum("bqhd,bkhd->bhqk", do4, _heads(v))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = einsum("bhqk,bkhd->bqhd", ds, _heads(k))
    dk = einsum("bhqk,bqhd->bkhd", ds, _heads(q))
    return tuple(x.reshape(B, T, H * D) for x in (dq, dk, dv))


def _err(got, want):
    if isinstance(got, tuple):
        return max(_err(a, b) for a, b in zip(got, want))
    return (got.double() - want).abs().max().item()


def test_tf32_rounds_to_nearest_ties_away_and_splits_exactly():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)          # a tf32 ulp at 1
    x = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11),
                  1 + 3 * 2.0 ** -11, 1 + 2.0 ** -11 + 2.0 ** -20],
                 dtype=np.float32)
    assert tf32(x).tolist() == [one + ulp, one, -(one + ulp),
                                one + 2 * ulp, one + ulp]
    rng = np.random.default_rng(0)
    y = (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(
        np.float32)
    hi, lo = split(torch.from_numpy(y))
    h = hi.numpy().view(np.uint32)
    assert not (h & np.uint32(0x1FFF)).any()           # 10-bit mantissa
    assert not (lo.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
    rel = np.abs((hi.double() + lo.double()).numpy() - y) / np.abs(y)
    assert rel.max() <= 2.0 ** -21                      # hi + lo ~ x
    assert (np.abs(hi.numpy() - y) / np.abs(y)).max() <= 2.0 ** -11


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_forward_within_1e5_of_float64(seed):
    q, k, v, bias, _ = _inputs(seed)
    exact = fa.attention_plain(q.double(), k.double(), v.double(),
                               bias.double(), H)
    e3 = _err(attention_split(q, k, v, bias, make_einsum(3)), exact)
    e1 = _err(attention_split(q, k, v, bias, make_einsum(1)), exact)
    e32 = _err(fa.attention_plain(q, k, v, bias, H), exact)
    print(f"forward seed {seed}: max abs error vs float64: 3xTF32 {e3:.3g}, "
          f"1xTF32 {e1:.3g}, fp32 {e32:.3g}")
    assert e3 <= TOL_3X
    assert e1 >= 10 * e3


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_backward_within_1e5_of_float64(seed):
    q, k, v, bias, do = _inputs(seed)
    exact = fa.attention_bwd_plain(q.double(), k.double(), v.double(),
                                   bias.double(), do.double(), H)
    e3 = _err(attention_bwd_split(q, k, v, bias, do, make_einsum(3)), exact)
    e1 = _err(attention_bwd_split(q, k, v, bias, do, make_einsum(1)), exact)
    print(f"backward seed {seed}: max abs error vs float64: 3xTF32 "
          f"{e3:.3g}, 1xTF32 {e1:.3g}")
    assert e3 <= TOL_3X
    assert e1 >= 10 * e3


# the rel-pos (#5) and full-bias (#3) kernels' products
RB, RT, RH, SCALE = 2, 120, 4, 0.125


def _relpos_inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(RB, RT, RH * D)).astype(np.float32) * 0.5
               for _ in range(3))
    a = rng.normal(size=(RB, RT, RH * fr.POS_DIM)).astype(np.float32) * 0.1
    do = rng.normal(size=(RB, RT, RH * D)).astype(np.float32)
    keep = rng.integers(RT // 2, RT + 1, size=RB)
    keep[0] = RT
    bias = np.where(np.arange(RT)[None, :] >= keep[:, None], fa.NEG,
                    0.0).astype(np.float32)
    return ([torch.from_numpy(x) for x in (q, k, v, a, bias, do)]
            + [fr.relpos_basis(RT, fr.POS_DIM)[2]])


def relpos_split(q, k, v, a, bias, do, e, einsum, backward):
    """:func:`fr.relpos_plain` (or, ``backward``, :func:`fr.relpos_bwd_plain`:
    dq, dk, dv, da) at dropout 0 with every product taken by ``einsum``; the
    score is one 320-deep product [q_u | a]·[k | e]ᵀ, as the kernels take
    it."""
    B, T = q.shape[:2]
    q4, k4, v4 = (x.reshape(B, T, RH, D) for x in (q, k, v))
    qx = torch.cat([q4, a.reshape(B, T, RH, -1)], dim=-1)
    kx = torch.cat([k4, e[None, :, None, :].expand(B, T, RH, -1)], dim=-1)
    s = einsum("bqhc,bkhc->bhqk", qx, kx)
    p = torch.softmax(s * SCALE + bias[:, None, None, :], dim=-1)
    if not backward:
        return einsum("bhqk,bkhd->bqhd", p, v4).reshape(B, T, RH * D)
    do4 = do.reshape(B, T, RH, D)
    dv = einsum("bhqk,bqhd->bkhd", p, do4)
    dp = einsum("bqhd,bkhd->bhqk", do4, v4)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = einsum("bhqk,bkhd->bqhd", ds, k4) * SCALE
    dk = einsum("bhqk,bqhd->bkhd", ds, q4) * SCALE
    da = einsum("bhqk,kc->bqhc", ds, e) * SCALE
    return tuple(x.reshape(B, T, -1) for x in (dq, dk, dv, da))


def _full_bias_inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(RB, RH, RT, D)).astype(np.float32)
                   for _ in range(4))
    keep = rng.integers(RT // 2, RT + 1, size=RB)
    keep[0] = RT
    pad = np.arange(RT)[None, :] >= keep[:, None]
    bias4 = np.where(pad[:, None, None, :], np.float32(fa.NEG),
                     rng.normal(size=(RB, RH, RT, RT)).astype(np.float32))
    return [torch.from_numpy(x) for x in (q, k, v, bias4, do)]


def full_bias_split(q, k, v, bias4, do, einsum, backward):
    """:func:`fa.attention_full_bias_plain` (or, ``backward``,
    :func:`fa.attention_full_bias_bwd_plain`: dq, dk, dv, dbias) at dropout
    0 with every product taken by ``einsum``."""
    s = einsum("bhqd,bhkd->bhqk", q, k)
    p = torch.softmax(s * SCALE + bias4, dim=-1)
    if not backward:
        return einsum("bhqk,bhkd->bhqd", p, v)
    dv = einsum("bhqk,bhqd->bhkd", p, do)
    dp = einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return (einsum("bhqk,bhkd->bhqd", ds, k) * SCALE,
            einsum("bhqk,bhqd->bhkd", ds, q) * SCALE, dv, ds)


def _relpos_case(seed, backward):
    q, k, v, a, bias, do, e = _relpos_inputs(seed)
    d = [x.double() for x in (q, k, v, a, e, bias, do)]
    exact = (fr.relpos_bwd_plain(*d, RH, SCALE) if backward
             else fr.relpos_plain(*d[:6], RH, SCALE))
    return exact, lambda einsum: relpos_split(q, k, v, a, bias, do, e,
                                              einsum, backward)


def _full_bias_case(seed, backward):
    q, k, v, bias4, do = _full_bias_inputs(seed)
    d = [x.double() for x in (q, k, v, bias4, do)]
    exact = (fa.attention_full_bias_bwd_plain(*d, SCALE) if backward
             else fa.attention_full_bias_plain(*d[:4], SCALE))
    return exact, lambda einsum: full_bias_split(q, k, v, bias4, do, einsum,
                                                 backward)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["relpos_forward", "relpos_backward",
                                  "full_bias_forward", "full_bias_backward"])
def test_3xtf32_relpos_and_full_bias_within_1e5_of_float64(kind, seed):
    op, direction = kind.rsplit("_", 1)
    case = _relpos_case if op == "relpos" else _full_bias_case
    exact, run = case(seed, direction == "backward")
    e3 = _err(run(make_einsum(3)), exact)
    e1 = _err(run(make_einsum(1)), exact)
    print(f"{kind} seed {seed}: max abs error vs float64: 3xTF32 {e3:.3g}, "
          f"1xTF32 {e1:.3g}")
    assert e3 <= TOL_3X
    assert e1 >= 10 * e3
