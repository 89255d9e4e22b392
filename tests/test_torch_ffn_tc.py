"""The tensor-core fused FFN kernels' arithmetic (``csrc/fused_ffn.cu``), on
the CPU.

The kernels split F across the blocks of a thread-block cluster: block r of
cs = min(8, ceil(F / 256)) takes the 256-column slices r, r + cs, ... of F
and sums its slices' contributions to the second product (forward) or to
gy = gpre W1 (backward) in order; the blocks' partial sums then meet in
rank order, before + b2 and dropout 2 (forward) or LayerNorm's backward.
Block r does that for its share of a 32-row tile, rows r p .. r p + p of
p = ceil(32 / cs), the last share shorter (:func:`row_shares`). The weight
gradients are sums over fixed slices of the rows, added in slice order;
the column sums db1 and db2 are sums over 32-row tiles, dgamma and dbeta
sums over the shares of a tile in rank order, the tiles added in order.
Here that order of work is emulated in torch (:func:`ffn_fsplit`,
:func:`ffn_fsplit_bwd`; a row that no share holds stays NaN) and held

- to the plain versions ``ffn_plain`` / ``ffn_bwd_plain`` within 1e-5
  (a mean loss's cotangent: the weight gradients are sums over the rows),
  dropout on, with F one slice, three slices (cs = 3, a ragged last one),
  six, seven and twelve slices (cs = 6, 7 and 8, two slices a block);
- to JAX's fused FFN (its Pallas kernels in interpret mode, as
  ``tests/test_torch_fused_ffn.py`` runs them), forward and every gradient,
  rtol 2e-4 / atol 2e-5 (that file's bounds), at F = 600 (three slices);
- to itself: two runs give the same bits.

The 3xTF32 split of ``tests/test_torch_tf32_split.py`` is put into the
FFN's products at C = 256, F = 2048 and 256 rows: the forward's two (depth
256 and 2048) and the backward's five (the first product again, gh = g W2,
gy = gpre W1, dW1 = gpreᵀ y, dW2 = gᵀ (h m1); depth 256, 256, 2048 and the
256 rows): within 1e-5 of float64, and plain 1xTF32 at least ten times
further off.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from daspeech_torch import convert
from daspeech_torch.models import conformer as tconf
from daspeech_torch.ops import fused_ffn as tff
from test_torch_fused_ffn import interpret_pallas, make  # noqa: F401
from test_torch_tf32_split import make_einsum

SLICE = 256                    # F columns of a slice
MAX_CLUSTER = 8
TOL = 1e-5
TOL_3X = 1e-5


def cluster_size(Fd):
    return min(MAX_CLUSTER, math.ceil(Fd / SLICE))


def _slices(Fd, rank, cs):
    return [slice(s * SLICE, min((s + 1) * SLICE, Fd))
            for s in range(rank, math.ceil(Fd / SLICE), cs)]


def row_shares(cs, tile=tff.ROW_TILE):
    """[start, end) of the rows of a tile that each block of a cluster of
    cs reduces over the cluster, in rank order."""
    per = -(-tile // cs)
    return [(r * per, min(tile, (r + 1) * per)) for r in range(cs)]


def _by_shares(rows, cs):
    """``rows`` [N, ...] copied share by share into a NaN tensor, as the
    kernels write a tile's rows: a row no share holds stays NaN."""
    out = torch.full_like(rows, float("nan"))
    for n0 in range(0, rows.shape[0], tff.ROW_TILE):
        for a, b in row_shares(cs):
            out[n0 + a:n0 + b] = rows[n0 + a:n0 + b]
    return out


def _share_sum(rows, cs):
    """Sum of ``rows`` [N, ...]: per tile, each share's rows summed, the
    shares added in rank order; the tiles added in order."""
    out = torch.zeros_like(rows[0])
    for n0 in range(0, rows.shape[0], tff.ROW_TILE):
        tile = torch.zeros_like(rows[0])
        for a, b in row_shares(cs):
            tile = tile + rows[n0 + a:n0 + b].sum(0)
        out = out + tile
    return out


def _rank_order_sum(parts):
    out = torch.zeros_like(parts[0])
    for p in parts:
        out = out + p
    return out


def _masks(seeds, T, C, Fd, p1, p2):
    return tff._masks(seeds, T, C, Fd, p1, p2)


def ffn_fsplit(x, gamma, beta, w1, b1, w2, b2, seeds=None, p1=0.0, p2=0.0):
    """:func:`tff.ffn_plain` in the kernel's order of work."""
    B, T, C = x.shape
    Fd = w1.shape[0]
    cs = cluster_size(Fd)
    m1, m2 = _masks(seeds, T, C, Fd, p1, p2)
    y = F.layer_norm(x, (C,), gamma, beta, tff.LN_EPS)
    parts = []
    for rank in range(cs):
        acc = torch.zeros_like(x)
        for sl in _slices(Fd, rank, cs):
            h = F.silu(y @ w1[sl].t() + b1[sl])
            if m1 is not None:
                h = h * m1[..., sl]
            acc = acc + h @ w2[:, sl].t()
        parts.append(acc)
    out = _rank_order_sum(parts) + b2
    out = out if m2 is None else out * m2
    return _by_shares(out.reshape(B * T, C), cs).reshape(B, T, C)


def _ordered_sum(rows, size):
    """Sum of ``rows`` [N, ...] over consecutive groups of ``size`` rows,
    the groups added in order."""
    out = torch.zeros_like(rows[0])
    for n0 in range(0, rows.shape[0], size):
        out = out + rows[n0:n0 + size].sum(0)
    return out


def ffn_fsplit_bwd(x, gamma, beta, w1, b1, w2, b2, dout, seeds=None,
                   p1=0.0, p2=0.0):
    """:func:`tff.ffn_bwd_plain` in the kernel's order of work: per slice
    pre, gh and gpre, gy's partial sums in rank order, LayerNorm's
    backward; dW over row slices of ``tff.SLICE_ROWS`` (at most), the
    column sums over ``tff.ROW_TILE``-row tiles."""
    B, T, C = x.shape
    Fd = w1.shape[0]
    N = B * T
    cs = cluster_size(Fd)
    m1, m2 = _masks(seeds, T, C, Fd, p1, p2)
    mu = x.mean(-1, keepdim=True)
    r = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + tff.LN_EPS)
    xhat = (x - mu) * r
    y = xhat * gamma + beta
    g = dout if m2 is None else dout * m2
    hd = torch.empty(B, T, Fd)
    gpre = torch.empty(B, T, Fd)
    parts = []
    for rank in range(cs):
        gy = torch.zeros_like(x)
        for sl in _slices(Fd, rank, cs):
            pre = y @ w1[sl].t() + b1[sl]
            gh = g @ w2[:, sl]
            s = torch.sigmoid(pre)
            z = 1.0 if m1 is None else m1[..., sl]
            hd[..., sl] = pre * s * z
            gpre[..., sl] = gh * z * (s * (1.0 + pre * (1.0 - s)))
            gy = gy + gpre[..., sl] @ w1[sl]
        parts.append(gy)
    gy = _rank_order_sum(parts)
    dxhat = gy * gamma
    dx = r * (dxhat - dxhat.mean(-1, keepdim=True)
              - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dx = _by_shares(dx.reshape(N, C), cs).reshape(B, T, C)
    rows = math.ceil(N / math.ceil(N / tff.SLICE_ROWS))
    gp2, y2, g2, hd2 = (t.reshape(N, -1) for t in (gpre, y, g, hd))
    dw1 = _ordered_sum(torch.einsum("nf,nc->nfc", gp2, y2), rows)
    dw2 = _ordered_sum(torch.einsum("nc,nf->ncf", g2, hd2), rows)
    tile = tff.ROW_TILE
    return (dx, _share_sum((gy * xhat).reshape(N, C), cs),
            _share_sum(gy.reshape(N, C), cs), dw1,
            _ordered_sum(gp2, tile), dw2, _ordered_sum(g2, tile))


def _params(seed, B, T, C, Fd):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(B, T, C)),
              1.0 + 0.1 * rng.normal(size=C), 0.1 * rng.normal(size=C),
              rng.normal(size=(Fd, C)) / np.sqrt(C),
              0.1 * rng.normal(size=Fd),
              rng.normal(size=(C, Fd)) / np.sqrt(Fd),
              0.1 * rng.normal(size=C),
              rng.normal(size=(B, T, C)) / np.sqrt(B * T))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


def _seeds(B):
    return torch.tensor([7 + 13 * b for b in range(B)], dtype=torch.int32)


def _err(got, want):
    if isinstance(got, (tuple, list)):
        return max(_err(a, b) for a, b in zip(got, want))
    return (got.double() - want.double()).abs().max().item()


@pytest.mark.parametrize("B,T,C,Fd,p", [(2, 37, 32, 200, 0.1),
                                        (2, 20, 32, 600, 0.1),
                                        (1, 33, 16, 3000, 0.0),
                                        (3, 11, 64, 600, 0.3),
                                        (2, 21, 16, 1536, 0.1),
                                        (1, 40, 16, 1700, 0.0)])
def test_fsplit_matches_the_plain_versions(B, T, C, Fd, p):
    x, *params, dout = _params(B + T + Fd, B, T, C, Fd)
    seeds = _seeds(B) if p else None
    got = ffn_fsplit(x, *params, seeds, p, p)
    assert _err(got, tff.ffn_plain(x, *params, seeds, p, p)) <= TOL
    got = ffn_fsplit_bwd(x, *params, dout, seeds, p, p)
    want = tff.ffn_bwd_plain(x, *params, dout, seeds, p, p)
    for a, b in zip(got, want):
        assert a.shape == b.shape
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("cs", range(1, MAX_CLUSTER + 1))
def test_row_shares_hold_every_row_once(cs):
    """The shares of a 32-row tile cover it, in order and without
    overlap, at every cluster size (3, 5, 6 and 7 do not divide 32)."""
    shares = row_shares(cs)
    assert len(shares) == cs
    assert shares[0][0] == 0 and shares[-1][1] == tff.ROW_TILE
    assert all(a <= b for a, b in shares)
    assert all(shares[k][1] == shares[k + 1][0] for k in range(cs - 1))


def test_fsplit_runs_give_the_same_bits():
    x, *params, dout = _params(1, 2, 40, 32, 900)
    seeds = _seeds(2)
    assert torch.equal(ffn_fsplit(x, *params, seeds, 0.1, 0.1),
                       ffn_fsplit(x, *params, seeds, 0.1, 0.1))
    a = ffn_fsplit_bwd(x, *params, dout, seeds, 0.1, 0.1)
    b = ffn_fsplit_bwd(x, *params, dout, seeds, 0.1, 0.1)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_fsplit_matches_the_jax_kernel():
    """F = 600: three slices on a cluster of three; forward and the
    gradients of sum(out²) against JAX's fused module (Pallas, interpret
    mode), whose tree lands on the port module's parameters."""
    B, T, C, Fd = 2, 10, 16, 600
    x, variables, jm, tm = make(B, T, C, Fd, seed=21)
    params = [t.detach() for t in (
        tm.layer_norm.weight, tm.layer_norm.bias, tm.w_1.weight, tm.w_1.bias,
        tm.w_2.weight, tm.w_2.bias)]
    tx = torch.from_numpy(x)
    out = ffn_fsplit(tx, *params)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    gv, gx = jax.grad(
        lambda v, x: jnp.sum(jm.apply(v, x, train=False) ** 2),
        argnums=(0, 1))(variables, jnp.asarray(x))
    wantg = convert.load_flax_(tconf.FeedForwardModule(C, Fd),
                               jax.tree.map(np.asarray, gv))
    got = ffn_fsplit_bwd(tx, *params, 2.0 * out)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(gx), rtol=2e-4,
                               atol=2e-5)
    names = ("layer_norm.weight", "layer_norm.bias", "w_1.weight",
             "w_1.bias", "w_2.weight", "w_2.bias")
    wp = dict(wantg.named_parameters())
    for name, g in zip(names, got[1:]):
        np.testing.assert_allclose(g.numpy(), wp[name].detach().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


# --- the 3xTF32 split at the recipe's widths

C3, F3, B3, T3 = 256, 2048, 2, 128


def _ffn_split(x, gamma, beta, w1, b1, w2, b2, einsum):
    """:func:`tff.ffn_plain` (no dropout) with both products taken by
    ``einsum``."""
    y = F.layer_norm(x, (x.shape[-1],), gamma, beta, tff.LN_EPS)
    h = F.silu(einsum("btc,fc->btf", y, w1) + b1)
    return einsum("btf,cf->btc", h, w2) + b2


def _ffn_bwd_split(x, gamma, beta, w1, b1, w2, b2, dout, einsum):
    """:func:`tff.ffn_bwd_plain` (no dropout) with its five products taken
    by ``einsum``: (dx, dw1, dw2)."""
    mu = x.mean(-1, keepdim=True)
    r = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + tff.LN_EPS)
    xhat = (x - mu) * r
    y = xhat * gamma + beta
    pre = einsum("btc,fc->btf", y, w1) + b1
    s = torch.sigmoid(pre)
    gh = einsum("btc,cf->btf", dout, w2)
    gpre = gh * (s * (1.0 + pre * (1.0 - s)))
    dw2 = einsum("btc,btf->cf", dout, pre * s)
    dw1 = einsum("btf,btc->fc", gpre, y)
    dxhat = einsum("btf,fc->btc", gpre, w1) * gamma
    dx = r * (dxhat - dxhat.mean(-1, keepdim=True)
              - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, dw1, dw2


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_3xtf32_ffn_within_1e5_of_float64(direction):
    x, *params, dout = _params(3, B3, T3, C3, F3)
    d = [t.double() for t in (x, *params, dout)]
    if direction == "forward":
        exact = tff.ffn_plain(*d[:7])

        def run(einsum):
            return _ffn_split(x, *params, einsum)
    else:
        full = tff.ffn_bwd_plain(*d)
        exact = (full[0], full[3], full[5])

        def run(einsum):
            return _ffn_bwd_split(x, *params, dout, einsum)
    e3 = _err(run(make_einsum(3)), exact)
    e1 = _err(run(make_einsum(1)), exact)
    print(f"FFN {direction}: max abs error vs float64: 3xTF32 {e3:.3g}, "
          f"1xTF32 {e1:.3g}")
    assert e3 <= TOL_3X
    assert e1 >= 10 * e3
