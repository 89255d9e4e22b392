"""The order of work of the DAG link extraction kernels
(``csrc/fused_links.cu``), emulated in torch on the CPU and held against the
plain versions and the JAX Pallas kernel.

The kernels cannot run here, so this file checks their algorithm. [L, L] is
cut into 64 x 64 tiles, and only the live ones are visited: the column tiles
that meet [i0 + 1, min(out_len, L, i_last + mtl + 1)) for the row tile at
i0 (forward, dq), and the row tiles that meet [max(0, j0 - mtl),
min(j0 + 64, out_len) - 1) for the column tile at j0 (dk). The forward
takes two sweeps: per head, an online (max, sum) of each thread's columns
(tx + 16 u of a tile, u = 0..3, tx = 0..15) of its rows, merged over the 16
threads of a row into lse_h; then per live tile, every head's score tile
folded into a running (max, sum) over heads with one exp an entry. The
backward makes r = dgates in a first sweep of each row tile's live tiles,
dS and dq in a second, and dk from a column tile's live row tiles with the
stored r. ``tests/test_torch_cuda_kernels.py`` holds the kernels
themselves to the plain versions on the card.

Inputs are made with numpy from a seed (ragged out_len down to 1, a graph
with no valid transition). The emulation is held to ``links_plain`` and
``links_bwd_plain`` at L = 1, 2, 63, 65, 130 and at 300 with the
transition band mtl = 5, within 1e-5 (fp32 sums in another order), and to
JAX's ``fused_extract_links`` in Pallas interpret mode, forward and
gradient, as ``tests/test_torch_ops.py`` runs it, within 1e-5. Skipping the
dead tiles leaves every finite link, and lse_h on every row with a valid
transition, bit-identical to the same emulation over whole rows, and rows
with no valid successor come out all -inf with no NaN.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daspeech_torch.ops import fused_links as tfl
from daspeech_tpu.ops import fused_links as jfl

ATOL = 1e-5
TILE = 64
FLOOR = -1e9
NONE = -2e9          # a thread's running max before it has seen a column
B, H, D = 3, 2, 64
SCALE = 0.125
# (L, mtl): lengths around the tile and two tiles over, and the band
CASES = [(1, None), (2, None), (63, None), (65, None), (130, None),
         (300, 5)]


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """The Pallas kernel in interpret mode (``tests/test_torch_ops.py``)."""
    monkeypatch.setattr(jfl, "INTERPRET", True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(L, mtl):
    """numpy inputs from a seed: q, k [B, L, H*64], log-softmax gates
    [B, L, H], out_len [B] (L, ragged, and 1: no valid transition), a
    cotangent [B, L, L]."""
    rng = np.random.default_rng(10 * L + (mtl or 0))
    q = (rng.normal(size=(B, L, H * D)) * 0.5).astype(np.float32)
    k = rng.normal(size=(B, L, H * D)).astype(np.float32)
    g = rng.normal(size=(B, L, H)).astype(np.float32)
    g = g - np.log(np.exp(g).sum(-1, keepdims=True))
    ol = np.array([L, rng.integers(1, L + 1), 1], np.int32)
    dl = rng.normal(size=(B, L, L)).astype(np.float32)
    return (*(torch.tensor(x) for x in (q, k, g.astype(np.float32))),
            torch.tensor(ol), torch.tensor(dl))


def _ntiles(L):
    return -(-L // TILE)


def _live_cols(i0, L, ol, mtl):
    """The live column tiles of the row tile at i0 (first index, count)."""
    lo = i0 + 1
    hi = ol if mtl is None else min(ol, min(i0 + TILE, L) - 1 + mtl + 1)
    return (lo // TILE, (hi - 1) // TILE - lo // TILE + 1) if lo < hi \
        else (0, 0)


def _live_rows(j0, ol, mtl):
    """The live row tiles of the column tile at j0 (first index, count)."""
    lo = 0 if mtl is None else max(0, j0 - mtl)
    hi = min(j0 + TILE, ol) - 1 if j0 < ol else 0
    return (lo // TILE, (hi - 1) // TILE - lo // TILE + 1) if lo < hi \
        else (0, 0)


def _tiles(first_count, whole, L):
    first, count = first_count
    return range(_ntiles(L)) if whole else range(first, first + count)


def _rows(x, r0, L):
    """Rows r0 .. r0 + 63 of [L, w], zero past L."""
    t = x.new_zeros((TILE, x.shape[-1]))
    n = min(TILE, L - r0)
    t[:n] = x[r0:r0 + n]
    return t


def _valid(i0, j0, ol, mtl):
    """[64, 64] valid(i, j) of the tile at (i0, j0)."""
    i = torch.arange(i0, i0 + TILE)[:, None]
    j = torch.arange(j0, j0 + TILE)[None, :]
    v = (j > i) & (j < ol)
    if mtl is not None:
        v &= (j - i) <= mtl
    return v


def _head(x, h):
    return x[:, h * D:(h + 1) * D]


def emulate_forward(q, k, g, ol, mtl, whole=False):
    """The kernels' forward: (links [B, L, L], lse [B, L, H]); ``whole``
    visits every tile instead of the live ones."""
    L = q.shape[1]
    nt = _ntiles(L)
    links = torch.full((B, L, L), -math.inf)
    lse = torch.empty((B, L, H))
    for b in range(B):
        olb = min(int(ol[b]), L)
        for it in range(nt):
            i0 = it * TILE
            live = _live_cols(i0, L, olb, mtl)
            tiles = _tiles(live, whole, L)
            n = min(TILE, L - i0)
            # sweep 1: per head, each thread's (m, l) of its columns
            # tx + 16 u of its rows, merged over the row's 16 threads
            lse_t = torch.empty((TILE, H))
            for h in range(H):
                m = torch.full((TILE, 16), NONE)
                lt = torch.zeros((TILE, 16))
                for jt in tiles:
                    j0 = jt * TILE
                    s = _rows(_head(q[b], h), i0, L) @ \
                        _rows(_head(k[b], h), j0, L).T * SCALE
                    x = torch.where(_valid(i0, j0, olb, mtl), s,
                                    torch.tensor(FLOOR))
                    x[:, max(0, L - j0):] = -math.inf
                    x = x.reshape(TILE, 4, 16)          # [row, u, tx]
                    mx = torch.maximum(m, x.amax(1))
                    lt = lt * torch.exp(m - mx) + torch.exp(
                        x - mx[:, None, :]).sum(1)
                    m = mx
                mr = m.amax(1, keepdim=True)
                total = (lt * torch.exp(m - mr)).sum(1)
                lse_t[:, h] = (torch.log(total) + mr[:, 0] if len(tiles)
                               else torch.full((TILE,), FLOOR))
            lse[b, i0:i0 + n] = lse_t[:n]
            # sweep 2: per tile, every head folded with one exp an entry
            for jt in tiles:
                j0 = jt * TILE
                valid = _valid(i0, j0, olb, mtl)
                rmax = torch.full((TILE, TILE), -math.inf)
                rsum = torch.zeros((TILE, TILE))
                for h in range(H):
                    s = _rows(_head(q[b], h), i0, L) @ \
                        _rows(_head(k[b], h), j0, L).T
                    v = s * SCALE - lse_t[:, h:h + 1] + \
                        _rows(g[b], i0, L)[:, h:h + 1]
                    d = v - rmax
                    e = torch.exp(-d.abs())
                    rsum = torch.where(valid, torch.where(
                        d > 0, rsum * e + 1.0, rsum + e), rsum)
                    rmax = torch.where(valid, torch.maximum(rmax, v), rmax)
                out = torch.where(valid, torch.log(rsum) + rmax,
                                  torch.tensor(-math.inf))
                w = min(TILE, L - j0)
                links[b, i0:i0 + n, j0:j0 + w] = out[:n, :w]
    return links, lse


def emulate_backward(q, k, g, ol, mtl, links, lse, dlinks):
    """The kernels' backward: (dq, dk, dgates)."""
    L = q.shape[1]
    nt = _ntiles(L)
    dq, dk = torch.zeros_like(q), torch.zeros_like(k)
    dg = torch.zeros((B, L, H))

    def tile_terms(b, h, i0, j0, olb, r):
        """S, the masked p·G and (given r) dS of the tile at (i0, j0)."""
        valid = _valid(i0, j0, olb, mtl)
        s = _rows(_head(q[b], h), i0, L) @ \
            _rows(_head(k[b], h), j0, L).T * SCALE
        s = s - _rows(lse[b], i0, L)[:, h:h + 1]
        lk = _rows(links[b], i0, L)[:, j0:j0 + TILE]
        G = _rows(dlinks[b], i0, L)[:, j0:j0 + TILE]
        lk = torch.nn.functional.pad(lk, (0, TILE - lk.shape[1]))
        G = torch.nn.functional.pad(G, (0, TILE - G.shape[1]))
        pg = torch.where(valid, torch.exp(
            s + _rows(g[b], i0, L)[:, h:h + 1] - lk) * G, torch.tensor(0.))
        ds = None if r is None else torch.where(
            valid, (pg - torch.exp(s) * r[:, None]) * SCALE, torch.tensor(0.))
        return pg, ds

    for b in range(B):
        olb = min(int(ol[b]), L)
        for h in range(H):
            for it in range(nt):           # dq kernel: r, then dS and dq
                i0 = it * TILE
                n = min(TILE, L - i0)
                tiles = _tiles(_live_cols(i0, L, olb, mtl), False, L)
                r = torch.zeros(TILE)
                for jt in tiles:
                    r = r + tile_terms(b, h, i0, jt * TILE, olb, None)[0].sum(1)
                acc = torch.zeros((TILE, D))
                for jt in tiles:
                    ds = tile_terms(b, h, i0, jt * TILE, olb, r)[1]
                    acc = acc + ds @ _rows(_head(k[b], h), jt * TILE, L)
                dq[b, i0:i0 + n, h * D:(h + 1) * D] = acc[:n]
                dg[b, i0:i0 + n, h] = r[:n]
            for jt in range(nt):           # dk kernel: the stored r
                j0 = jt * TILE
                w = min(TILE, L - j0)
                acc = torch.zeros((TILE, D))
                for it in _tiles(_live_rows(j0, olb, mtl), False, L):
                    i0 = it * TILE
                    r = _rows(dg[b], i0, L)[:, h]
                    ds = tile_terms(b, h, i0, j0, olb, r)[1]
                    acc = acc + ds.T @ _rows(_head(q[b], h), i0, L)
                dk[b, j0:j0 + w, h * D:(h + 1) * D] = acc[:w]
    return dq, dk, dg


def _max_err(got, want):
    return (got - want).abs().max().item()


def _check_links(got, want):
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert bool((got[~finite] == -math.inf).all())
    if finite.any():
        assert _max_err(got[finite], want[finite]) <= ATOL


@pytest.mark.parametrize("L,mtl", CASES)
def test_forward_emulation_matches_plain(L, mtl):
    """Live tiles, the per-thread (m, l) merged over a row's 16 threads and
    the one-exp head fold against ``links_plain``; lse_h against the
    plain per-head log-sum-exp on every row with a valid transition."""
    q, k, g, ol, _ = _inputs(L, mtl)
    links, lse = emulate_forward(q, k, g, ol, mtl)
    _check_links(links, tfl.links_plain(q, k, g, ol, H, SCALE, mtl))
    assert torch.isfinite(lse).all()
    valid = tfl._valid(L, ol, mtl, "cpu")
    scores = tfl._floored_scores(q, k, valid, H, SCALE)
    want = torch.logsumexp(scores, dim=2)
    has = valid.any(-1)
    if has.any():
        assert _max_err(lse[has], want[has]) <= ATOL


@pytest.mark.parametrize("L,mtl", CASES)
def test_backward_emulation_matches_plain(L, mtl):
    """The r sweep, dS and dq per row tile and dk per column tile from the
    stored r, over the live tiles, against ``links_bwd_plain``."""
    q, k, g, ol, dl = _inputs(L, mtl)
    links, lse = emulate_forward(q, k, g, ol, mtl)
    got = emulate_backward(q, k, g, ol, mtl, links, lse, dl)
    want = tfl.links_bwd_plain(q, k, g, ol, dl, H, SCALE, mtl)
    for x, w in zip(got, want):
        assert torch.isfinite(x).all()
        assert _max_err(x, w) <= ATOL


@pytest.mark.parametrize("L,mtl", CASES)
def test_emulation_matches_pallas(L, mtl):
    """The emulated forward and backward against JAX's
    ``fused_extract_links`` (Pallas, interpret mode) and its ``jax.vjp``
    for the cotangent dlinks masked to the valid transitions."""
    q, k, g, ol, dl = _inputs(L, mtl)
    dl = torch.where(tfl._valid(L, ol, mtl, "cpu"), dl, torch.tensor(0.))
    links, lse = emulate_forward(q, k, g, ol, mtl)
    j = [jnp.asarray(x.numpy()) for x in (q, k, g)]
    want, vjp = jax.vjp(lambda q, k, g: jfl.fused_extract_links(
        q, k, g, jnp.asarray(ol.numpy()), H, SCALE, mtl), *j)
    _check_links(links, torch.tensor(np.asarray(want)))
    got = emulate_backward(q, k, g, ol, mtl, links, lse, dl)
    for x, w in zip(got, vjp(jnp.asarray(dl.numpy()))):
        assert _max_err(x, torch.tensor(np.asarray(w))) <= ATOL


@pytest.mark.parametrize("L,mtl", [(130, None), (300, 5)])
def test_dead_tiles_change_no_finite_link(L, mtl):
    """Skipping the dead tiles is exact: every finite link, and lse_h on
    every row with a valid transition, equal to the bit to the emulation
    over whole rows; a row with no valid successor is all -inf, no NaN."""
    q, k, g, ol, _ = _inputs(L, mtl)
    live, lse = emulate_forward(q, k, g, ol, mtl)
    whole, lse_whole = emulate_forward(q, k, g, ol, mtl, whole=True)
    finite = torch.isfinite(whole)
    assert torch.equal(torch.isfinite(live), finite)
    assert torch.equal(live[finite], whole[finite])
    has = tfl._valid(L, ol, mtl, "cpu").any(-1)
    assert torch.equal(lse[has], lse_whole[has])
    assert not torch.isnan(live).any()
    assert bool((live[~has] == -math.inf).all())
    assert bool((live[-1] == -math.inf).all())        # out_len 1
