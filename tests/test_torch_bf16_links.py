"""The order of sums and roundings of the bf16 link extraction kernels
(#4), on the CPU.

``csrc/links_bf16.cuh`` runs the link extraction's bf16 entry points on
the tensor cores: each head's score tile Q_h·K_hᵀ is a bf16 ``mma.sync``
m16n8k16 chain with fp32 accumulators (products of bf16 inputs, exact in
fp32), over the live 64 x 64 tiles of ``csrc/fused_links.cu``. The
forward's lse_h is an online (max, sum) per thread of its 16 columns of a
tile (columns 8n + 2t + c of the thread with t = (column % 8) / 2), merged
over a row's four threads; the fold takes every head's s - lse_h + g_h into
a running (max, sum) with one exp an entry. The backward makes r = dgates
in a first sweep of a row tile's live tiles, dS and dq in a second, and dk
per column tile from the stored r. dS is fp32; dq += dS·K and
dk += dSᵀ·Q take it one-term (rounded to bf16, one MMA) or two-term
(hi + lo, two MMAs), as ``tests/test_torch_bf16_split.py`` sets out.

That order is emulated here on inputs made with numpy from a seed (ragged
out_len, a graph with no valid transition), at L = 65, 240 and 240 with the
transition band mtl = 5, and held:

- links (the same -inf pattern, the finite ones) and dgates within 1e-4 of
  float64 on the same bf16 inputs, and of JAX's bf16 Pallas kernel
  (``fused_extract_links``) in interpret mode;
- dq and dk within a quarter of TOL_BF16 (2^-7 of their largest magnitude)
  of float64, and, rounded to bf16, within TOL_BF16 of JAX's.

A product takes the one-term form wherever that holds, the two-term form
elsewhere; ``FORMS`` records the choice, and the header's constants must
say the same.
"""

import functools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daspeech_torch.ops import fused_links as tfl
from daspeech_tpu.ops import fused_links as jfl
from test_torch_bf16_split import BAR, TOL_BF16, bf16, terms
from test_torch_links_tiles import FLOOR, NONE, TILE, _live_cols, _live_rows

HEADER = (Path(tfl.__file__).resolve().parent.parent / "csrc"
          / "links_bf16.cuh")
# the form each product takes in the kernels: 1 = one-term, 2 = two-term
FORMS = {"dsk": 2, "dsq": 2}
CONSTANTS = {"dsk": "kTermsLinksDSK", "dsq": "kTermsLinksDSQ"}
TOL_F32 = 1e-4           # links and dgates
B, H, D = 3, 8, 64
SCALE = 0.125
# (L, mtl)
CASES = [(65, None), (240, None), (240, 5)]


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(jfl, "INTERPRET", True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(L, mtl, seed=0):
    """bf16 q, k [B, L, H*64] (as fp32), log-softmax gates [B, L, H],
    out_len [B] (L, ragged, 1) and a cotangent [B, L, L] masked to the
    valid transitions."""
    rng = np.random.default_rng(seed + L + (mtl or 0))
    q = torch.from_numpy(bf16(
        rng.normal(size=(B, L, H * D)).astype(np.float32) * 0.5))
    k = torch.from_numpy(bf16(rng.normal(size=(B, L, H * D)).astype(
        np.float32)))
    g = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(B, L, H)).astype(np.float32)), dim=-1)
    ol = torch.tensor([L, int(rng.integers(L // 2, L)), 1], dtype=torch.int32)
    valid = tfl._valid(L, ol, mtl, "cpu")
    dl = torch.where(valid, torch.from_numpy(
        rng.normal(size=(B, L, L)).astype(np.float32)), torch.tensor(0.))
    return q, k, g, ol, dl


def _rows(x, r0):
    """Rows r0 .. r0 + 63 of [L, w] (or [H, L, w]), zero past L."""
    n = min(TILE, x.shape[-2] - r0)
    t = x.new_zeros((*x.shape[:-2], TILE, x.shape[-1]))
    t[..., :n, :] = x[..., r0:r0 + n, :]
    return t


def _valid(i0, j0, ol, mtl, L):
    i = torch.arange(i0, i0 + TILE)[:, None]
    j = torch.arange(j0, j0 + TILE)[None, :]
    v = (j > i) & (j < min(ol, L))
    if mtl is not None:
        v &= (j - i) <= mtl
    return v


def _heads(x):
    """[L, H*64] -> [H, L, 64]."""
    return x.reshape(x.shape[0], H, D).transpose(0, 1)


def _score(qh, kh, i0, j0):
    """[H, 64, 64] tile of the head's scores: bf16 inputs, exact, fp32."""
    return torch.einsum("hid,hjd->hij", _rows(qh, i0).double(),
                        _rows(kh, j0).double()).float()


def emulate_forward(q, k, g, ol, mtl):
    """The kernels' forward: (links [B, L, L], lse [B, L, H])."""
    L = q.shape[1]
    nt = -(-L // TILE)
    links = torch.full((B, L, L), -math.inf)
    lse = torch.empty((B, L, H))
    for b in range(B):
        olb = min(int(ol[b]), L)
        qh, kh = _heads(q[b]), _heads(k[b])
        for it in range(nt):
            i0 = it * TILE
            n = min(TILE, L - i0)
            first, count = _live_cols(i0, L, olb, mtl)
            tiles = range(first, first + count)
            # lse: each thread's (m, l) of its columns, merged over a quad
            m = torch.full((H, TILE, 4), NONE)
            lt = torch.zeros((H, TILE, 4))
            for jt in tiles:
                j0 = jt * TILE
                x = torch.where(_valid(i0, j0, olb, mtl, L),
                                _score(qh, kh, i0, j0) * SCALE,
                                torch.tensor(FLOOR))
                x[..., max(0, L - j0):] = -math.inf
                x = x.reshape(H, TILE, 8, 4, 2)          # [.., n, t, c]
                mx = torch.maximum(m, x.amax((2, 4)))
                lt = lt * torch.exp(m - mx) + torch.exp(
                    x - mx[:, :, None, :, None]).sum((2, 4))
                m = mx
            mr = m.amax(-1, keepdim=True)
            total = (lt * torch.exp(m - mr)).sum(-1)
            lse_t = (torch.log(total) + mr[..., 0] if count
                     else torch.full((H, TILE), FLOOR))
            lse[b, i0:i0 + n] = lse_t[:, :n].T
            # the fold: every head's s - lse_h + g_h, one exp an entry
            lg = (_rows(g[b], i0).T - lse_t)[..., None]   # [H, 64, 1]
            for jt in tiles:
                j0 = jt * TILE
                valid = _valid(i0, j0, olb, mtl, L)
                s = _score(qh, kh, i0, j0)
                rmax = torch.full((TILE, TILE), -math.inf)
                rsum = torch.zeros((TILE, TILE))
                for h in range(H):
                    v = s[h] * SCALE + lg[h]
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


def emulate_backward(q, k, g, ol, mtl, links, lse, dlinks, forms):
    """The kernels' backward: (dq, dk, dgates), fp32 before dq's and dk's
    bf16 cast."""
    L = q.shape[1]
    nt = -(-L // TILE)
    dq, dk = torch.zeros_like(q), torch.zeros_like(k)
    dg = torch.zeros((B, L, H))

    def tile_terms(b, qh, kh, i0, j0, olb, r):
        """The masked p·G [H, 64, 64] of the tile at (i0, j0) and, given r
        [H, 64], dS."""
        valid = _valid(i0, j0, olb, mtl, L)
        sc = _score(qh, kh, i0, j0) * SCALE - _rows(lse[b], i0).T[..., None]
        lk = _rows(torch.nn.functional.pad(links[b], (0, TILE)), i0)
        G = _rows(torch.nn.functional.pad(dlinks[b], (0, TILE)), i0)
        lk, G = lk[:, j0:j0 + TILE], G[:, j0:j0 + TILE]
        pg = torch.where(valid, torch.exp(
            sc + _rows(g[b], i0).T[..., None] - lk) * G, torch.tensor(0.))
        ds = None if r is None else torch.where(
            valid, (pg - torch.exp(sc) * r[..., None]) * SCALE,
            torch.tensor(0.))
        return pg, ds

    def mma(x, y, n):
        """x (fp32 [H, 64, 64]) · y (bf16 [H, 64, 64]) in the n-term form,
        exact in float64."""
        return sum(torch.einsum("hij,hjd->hid", t, y.double())
                   for t in terms(x, n))

    for b in range(B):
        olb = min(int(ol[b]), L)
        qh, kh = _heads(q[b]), _heads(k[b])
        for it in range(nt):               # dq kernel: r, then dS and dq
            i0 = it * TILE
            n = min(TILE, L - i0)
            first, count = _live_cols(i0, L, olb, mtl)
            r = torch.zeros((H, TILE))
            for jt in range(first, first + count):
                r = r + tile_terms(b, qh, kh, i0, jt * TILE, olb,
                                   None)[0].sum(-1)
            acc = torch.zeros((H, TILE, D))
            for jt in range(first, first + count):
                ds = tile_terms(b, qh, kh, i0, jt * TILE, olb, r)[1]
                acc = (acc.double() + mma(ds, _rows(kh, jt * TILE),
                                          forms["dsk"])).float()
            dq[b, i0:i0 + n] = acc[:, :n].transpose(0, 1).reshape(n, H * D)
            dg[b, i0:i0 + n] = r[:, :n].T
        for jt in range(nt):               # dk kernel: the stored r
            j0 = jt * TILE
            w = min(TILE, L - j0)
            first, count = _live_rows(j0, olb, mtl)
            acc = torch.zeros((H, TILE, D))
            for it in range(first, first + count):
                i0 = it * TILE
                ds = tile_terms(b, qh, kh, i0, j0, olb, _rows(dg[b], i0).T)[1]
                acc = (acc.double() + mma(ds.transpose(1, 2), _rows(qh, i0),
                                          forms["dsq"])).float()
            dk[b, j0:j0 + w] = acc[:, :w].transpose(0, 1).reshape(w, H * D)
    return dq, dk, dg


def float64_reference(q, k, g, ol, mtl, dlinks):
    """(links, dq, dk, dgates) of the plain versions in float64."""
    L = q.shape[1]
    valid = tfl._valid(L, ol, mtl, "cpu")[..., None]
    qh = q.double().reshape(B, L, H, D)
    kh = k.double().reshape(B, L, H, D)
    s = torch.einsum("bihd,bjhd->bijh", qh, kh) * SCALE
    s = torch.where(valid, s, torch.tensor(FLOOR, dtype=torch.float64))
    lse = torch.logsumexp(s, dim=2, keepdim=True)
    v = s - lse + g.double()[:, :, None, :]
    floor_links = torch.logsumexp(v, dim=3)
    links = torch.where(valid[..., 0], floor_links,
                        torch.tensor(-math.inf, dtype=torch.float64))
    pg = torch.exp(v - floor_links[..., None]) * dlinks.double()[..., None]
    r = pg.sum(2)
    ds = torch.where(valid, (pg - torch.exp(s - lse) * r[:, :, None, :])
                     * SCALE, torch.tensor(0., dtype=torch.float64))
    dq = torch.einsum("bijh,bjhd->bihd", ds, kh).reshape(B, L, H * D)
    dk = torch.einsum("bijh,bihd->bjhd", ds, qh).reshape(B, L, H * D)
    return links, dq, dk, r


def _links_err(got, want):
    """The largest error over the finite links; the -inf patterns must be
    the same."""
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert bool((got[~finite] == -math.inf).all())
    return (got[finite].double() - want[finite].double()).abs().max().item()


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@functools.lru_cache(maxsize=None)
def case_errors(case, forms):
    """(links, dgates) absolute errors and (dq, dk) errors over their
    largest magnitude, against float64, at ``case`` with ``forms``."""
    q, k, g, ol, dl = inputs(*case)
    links, lse = emulate_forward(q, k, g, ol, case[1])
    dq, dk, dg = emulate_backward(q, k, g, ol, case[1], links, lse, dl,
                                  dict(forms))
    w_links, w_dq, w_dk, w_dg = float64_reference(q, k, g, ol, case[1], dl)
    return (_links_err(links, w_links), (dg.double() - w_dg).abs().max()
            .item(), _rel(dq, w_dq), _rel(dk, w_dk))


def test_the_kernel_header_states_the_forms():
    text = HEADER.read_text()
    for name, const in CONSTANTS.items():
        m = re.search(rf"constexpr int {const} = (\d);", text)
        assert m, const
        assert int(m.group(1)) == FORMS[name], (name, m.group(1))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_chosen_forms_against_float64(case):
    """links and dgates within 1e-4, dq and dk within a quarter of the
    bf16 bar."""
    links, dg, dq, dk = case_errors(case, tuple(FORMS.items()))
    one = case_errors(case, tuple(dict.fromkeys(FORMS, 1).items()))
    print(f"{case}: vs float64: links {links:.3g}, dgates {dg:.3g}, dq "
          f"{dq:.3g} (one-term {one[2]:.3g}), dk {dk:.3g} (one-term "
          f"{one[3]:.3g})")
    assert links <= TOL_F32 and dg <= TOL_F32
    assert max(dq, dk) <= BAR


@pytest.mark.parametrize("product_name", list(FORMS))
def test_two_term_form_only_where_the_one_term_form_misses_the_bar(
        product_name):
    """A product takes the one-term form iff, with it alone one-term, dq
    and dk stay within the bar at every case."""
    alone = tuple(dict(FORMS, **{product_name: 1}).items())
    worst = max(max(case_errors(c, alone)[2:]) for c in CASES)
    print(f"{product_name} one-term, the rest as chosen: worst error "
          f"{worst:.3g} against the bar {BAR:.3g}")
    assert (worst > BAR) == (FORMS[product_name] == 2), worst


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_chosen_forms_against_jax_pallas(case):
    """The emulation against JAX's bf16 Pallas kernel and its vjp: links
    and dgates within 1e-4, dq and dk (bf16) within the bf16 bar."""
    L, mtl = case
    q, k, g, ol, dl = inputs(L, mtl, seed=1)
    jq, jk = (jnp.asarray(x.numpy()).astype(jnp.bfloat16) for x in (q, k))
    want, vjp = jax.vjp(lambda q, k, g: jfl.fused_extract_links(
        q, k, g, jnp.asarray(ol.numpy()), H, SCALE, mtl), jq, jk,
        jnp.asarray(g.numpy()))
    assert want.dtype == jnp.float32
    w_dq, w_dk, w_dg = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                        for x in vjp(jnp.asarray(dl.numpy())))
    links, lse = emulate_forward(q, k, g, ol, mtl)
    dq, dk, dg = emulate_backward(q, k, g, ol, mtl, links, lse, dl, FORMS)
    errs = (_links_err(links, torch.from_numpy(np.array(want))),
            (dg - w_dg).abs().max().item(),
            _rel(torch.from_numpy(bf16(dq.numpy())), w_dq),
            _rel(torch.from_numpy(bf16(dk.numpy())), w_dk))
    print(f"{case}: vs JAX's Pallas kernel: links {errs[0]:.3g}, dgates "
          f"{errs[1]:.3g}, dq {errs[2]:.3g}, dk {errs[3]:.3g}")
    assert errs[0] <= TOL_F32 and errs[1] <= TOL_F32
    assert max(errs[2:]) <= TOL_BF16
