"""The order of work of the FMA training forward (``csrc/attention_fma.cuh``:
the training forward of the packed, head-major and rel-pos attention),
emulated in torch on the CPU and held against the plain versions and the
JAX Pallas kernels; and its full-bias mode (the full-bias attention's
training forward: one chunk, the bias a [query tile, key tile] block of
bias4, dropout keyed by seeds[0] with the batch row in the fourth counter
word).

The kernel cannot run here, so this file checks its algorithm: keys in
tiles of 64 with one online rescale of the running sum l and the output per
tile, the statistics (m, l) kept apart, the dropout mask drawn per tile as
one Philox draw per (row, 4-key group) with word j % 4, and the score summed
as chunk pairs of depth 64: (q, k) alone, or for the rel-pos attention
(q, k) then four of (a, e). Where the launcher splits the keys of a query
tile over several blocks (a grid a little over one wave), each range's
unnormalized output and (m, l) are merged afterwards; the emulation does
the same with ``nsplit`` ranges. ``tests/test_torch_cuda_kernels.py``
holds the kernel itself to the plain versions on the card.

Inputs are made with numpy from a seed. The emulation is held to
``attention_plain``, ``attention_hm_plain``, ``relpos_plain`` and
``attention_full_bias_plain`` at Tk = 1, 63, 65 and 130 with a fully padded
batch row (and, for the full bias, one fully masked query row), p = 0 and
0.1, within 1e-5 (fp32 sums in another order); the plain backward
recomputed from its statistics (P = exp(s - m) / l, delta = rowsum(dO * O))
to ``attention_bwd_plain``, ``relpos_bwd_plain`` and
``attention_full_bias_bwd_plain`` within 1e-5; and, at p = 0, to JAX's
``fused_attention_packed``, ``fused_attention``, ``fused_attention_relpos``
and ``fused_attention_full_bias`` in Pallas interpret mode, as
``tests/test_torch_ops.py`` runs them, within 1e-5. The JAX kernels' own
dropout bits are another generator's, and they pad keys to a multiple of 8
(packed, rel-pos) or 128 (head-major, full bias) with the bias -1e30, so a
fully padded row averages over the padding there (ROADMAP Queue 3): those
rows are left out of the comparison with JAX only.
"""

import math

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

from daspeech_torch.ops import fused_attention as tfa
from daspeech_torch.ops import fused_relpos as tfr
from daspeech_torch.ops.philox import (attention_keep, full_bias_keep,
                                       keep_threshold, philox4x32_10)
from daspeech_tpu.ops import fused_attention as jfa
from daspeech_tpu.ops import fused_relpos as jfr
from torch_cli_corpus import one_torch_thread  # noqa: F401

ATOL = 1e-5
TILE = 64            # keys of a tile, and the depth of a score chunk
B, H, D, C = 2, 2, 64, 256
SCALE = 0.125
KINDS = ("packed", "head_major", "relpos", "full_bias")
LENGTHS = (1, 63, 65, 130)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Pallas kernels in interpret mode (``tests/test_torch_ops.py``)."""
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)
    monkeypatch.setattr(jfr.pl, "pallas_call", patched)


def _heads(x):
    """[B, T, H*w] -> [B, H, T, w]."""
    return x.reshape(x.shape[0], x.shape[1], H, -1).transpose(1, 2)


def _packed(x):
    """[B, H, T, w] -> [B, T, H*w]."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], -1)


def _tile_keep(seeds, Tq, j0, p, full=False):
    """[B, H, Tq, 64] dropout multipliers of the key tile at j0, drawn as
    the kernel draws them: one Philox draw per (row, 4-key group) of the
    tile, key j taking word j % 4 of philox((j / 4, i, h, 0), seed[b]), or
    with ``full`` (the full bias) of philox((j / 4, i, h, b), seed[0])."""
    groups = torch.arange(j0 // 4, (j0 + TILE) // 4, dtype=torch.int64)
    key = seeds.to(torch.int64) & 0xFFFFFFFF
    rows = torch.arange(B, dtype=torch.int64)[:, None, None, None]
    words = philox4x32_10(
        groups[None, None, None, :],
        torch.arange(Tq, dtype=torch.int64)[None, None, :, None],
        torch.arange(H, dtype=torch.int64)[None, :, None, None],
        rows if full else 0,
        key[0] if full else key[:, None, None, None], 0)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(B, H, Tq, TILE)
    return (bits <= keep_threshold(p)).float() * (1.0 / (1.0 - p))


def _tile(x, j0, n):
    """Rows j0 .. j0 + 63 of [..., Tk, w], zero past Tk (n valid)."""
    t = x.new_zeros((*x.shape[:-2], TILE, x.shape[-1]))
    t[..., :n, :] = x[..., j0:j0 + n, :]
    return t


def emulate_forward(chunks, v, bias, p, seeds, nsplit=1):
    """The kernel's forward: ``chunks`` the score's (X [B, H, Tq, 64],
    Y [., ., Tk, 64]) pairs in the kernel's order, v [B, H, Tk, 64], bias
    [B, Tk] or (the full bias) [B, H, Tq, Tk], the key tiles in ``nsplit``
    contiguous ranges merged at the end. Returns out [B, H, Tq, 64] and
    stats [B, H, Tq, 2] (m, l)."""
    Tk = v.shape[2]
    ntiles = -(-Tk // TILE)
    parts = [_key_range(chunks, v, bias, p, seeds,
                        range(s * ntiles // nsplit * TILE,
                              (s + 1) * ntiles // nsplit * TILE, TILE))
             for s in range(nsplit)]
    if nsplit == 1:
        o, m, l = parts[0]
        return o / l[..., None], torch.stack([m, l], dim=-1)
    m = torch.stack([x[1] for x in parts]).amax(0)
    w = [torch.exp(x[1] - m) for x in parts]
    l = sum(x[2] * wi for x, wi in zip(parts, w))
    o = sum(x[0] * wi[..., None] for x, wi in zip(parts, w))
    return o / l[..., None], torch.stack([m, l], dim=-1)


def _key_range(chunks, v, bias, p, seeds, tiles):
    """One block's work over the key tiles starting at ``tiles``: its
    unnormalized output, m and l."""
    Tq, Tk = chunks[0][0].shape[2], v.shape[2]
    full = bias.dim() == 4
    bias4 = bias if full else bias[:, None, None, :]
    m = torch.full((B, H, Tq), -math.inf)
    l = torch.zeros((B, H, Tq))
    o = torch.zeros((B, H, Tq, D))
    for j0 in tiles:
        n = min(TILE, Tk - j0)
        s = torch.zeros((B, H, Tq, TILE))
        for X, Y in chunks:
            s = s + X @ _tile(Y, j0, n).transpose(-1, -2)
        bt = torch.zeros((*bias4.shape[:-1], TILE))
        bt[..., :n] = bias4[..., j0:j0 + n]
        s = s * SCALE + bt
        s[..., n:] = -math.inf
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        l, o = l * corr, o * corr[..., None]
        pr = torch.exp(s - m_new[..., None])
        l = l + pr.sum(-1)
        if p:
            pr = pr * _tile_keep(seeds, Tq, j0, p, full)
        o = o + pr @ _tile(v, j0, n)
        m = m_new
    return o, m, l


def backward_from_stats(chunks, v, bias, p, seeds, out, stats, dout):
    """The plain backward with P recomputed from the forward's statistics,
    as the tensor-core backward recomputes it: the gradients of each
    chunk's X and Y, and dv."""
    Tq, Tk = out.shape[2], v.shape[2]
    full = bias.dim() == 4
    s = sum(X @ Y.transpose(-1, -2) for X, Y in chunks)
    s = s * SCALE + (bias if full else bias[:, None, None, :])
    P = torch.exp(s - stats[..., :1]) / stats[..., 1:]
    z = (torch.ones_like(P) if not p
         else full_bias_keep(seeds[:1], B, H, Tq, Tk, p) if full
         else attention_keep(seeds, H, Tq, Tk, p))
    dv = (P * z).transpose(-1, -2) @ dout
    delta = (dout * out).sum(-1, keepdim=True)
    ds = P * (z * (dout @ v.transpose(-1, -2)) - delta) * SCALE
    dxy = [(ds @ Y, ds.transpose(-1, -2) @ X) for X, Y in chunks]
    return dxy, dv


def _inputs(kind, T, p):
    """numpy inputs from a seed: packed q, k, v, do [B, T, H*64], a
    [B, T, H*256] (rel-pos), e [T, 256], a bias [B, T] whose last row is
    fully padded (the full bias: that bias plus N(0, 1) noise over
    [B, H, T, T], and query row T / 2 of head 0 of the first batch row
    fully masked), int32 seeds [B]."""
    rng = np.random.default_rng(1000 * LENGTHS.index(T) + KINDS.index(kind)
                                + int(10 * p))
    q, k, v, do = (rng.normal(size=(B, T, H * D)).astype(np.float32)
                   for _ in range(4))
    a = (rng.normal(size=(B, T, H * C)) * 0.3).astype(np.float32)
    e = np.asarray(jfr.relpos_basis(T, C)[2])
    keep = rng.integers(1, T + 1, size=B)
    bias = np.where(np.arange(T)[None, :] < keep[:, None], 0.0,
                    tfa.NEG).astype(np.float32)
    bias[-1] = tfa.NEG
    seeds = rng.integers(-2 ** 31, 2 ** 31, size=B, dtype=np.int64)
    if kind == "full_bias":
        bias = (bias[:, None, None, :]
                + rng.normal(size=(B, H, T, T))).astype(np.float32)
        bias[0, 0, T // 2] = tfa.NEG
    return (*(torch.tensor(x) for x in (q, k, v, do, a, e, bias)),
            torch.tensor(seeds.astype(np.int32)))


def _chunks(kind, q, k, a, e):
    """The score's chunk pairs in the kernel's order, head-major."""
    chunks = [(_heads(q), _heads(k))]
    if kind == "relpos":
        a4 = _heads(a)
        chunks += [(a4[..., c:c + TILE], e[None, None, :, c:c + TILE])
                   for c in range(0, C, TILE)]
    return chunks


def _plain(kind, q, k, v, a, e, bias, p, seeds):
    """The plain version's forward, head-major [B, H, T, 64]."""
    if kind == "full_bias":
        return tfa.attention_full_bias_plain(_heads(q), _heads(k), _heads(v),
                                             bias, SCALE, p, seeds[:1])
    if kind == "relpos":
        return _heads(tfr.relpos_plain(q, k, v, a, e, bias, H, SCALE, p,
                                       seeds))
    if kind == "head_major":
        return tfa.attention_hm_plain(_heads(q), _heads(k), _heads(v), bias,
                                      SCALE, p, seeds)
    return _heads(tfa.attention_plain(q, k, v, bias, H, SCALE, p, seeds))


def _max_err(got, want):
    return (got - want).abs().max().item()


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulation_matches_plain(kind, T, p):
    """Forward and the backward from its statistics against the plain
    versions: 64-key tiles, one rescale per tile, (m, l) apart, the mask
    per (row, 4-key group), the score as chunk pairs."""
    q, k, v, do, a, e, bias, seeds = _inputs(kind, T, p)
    chunks = _chunks(kind, q, k, a, e)
    out, stats = emulate_forward(chunks, _heads(v), bias, p, seeds)
    assert torch.isfinite(out).all() and torch.isfinite(stats).all()
    assert _max_err(out, _plain(kind, q, k, v, a, e, bias, p, seeds)) <= ATOL
    # the fully padded row: every score rounds to -1e30, P is uniform
    assert torch.all(stats[-1, ..., 0] == tfa.NEG)
    assert torch.all(stats[-1, ..., 1] == T)

    dxy, dv = backward_from_stats(chunks, _heads(v), bias, p, seeds, out,
                                  stats, _heads(do))
    if kind == "relpos":
        want = tfr.relpos_bwd_plain(q, k, v, a, e, bias, do, H, SCALE, p,
                                    seeds)
        got = (dxy[0][0], dxy[0][1], dv,
               torch.cat([dx for dx, _ in dxy[1:]], dim=-1))
        want = [_heads(w) for w in want]
    elif kind == "full_bias":
        want = tfa.attention_full_bias_bwd_plain(
            _heads(q), _heads(k), _heads(v), bias, _heads(do), SCALE, p,
            seeds[:1])[:3]
        got = (dxy[0][0], dxy[0][1], dv)
    else:
        want = tfa.attention_bwd_plain(q, k, v, bias, do, H, SCALE, p, seeds)
        got, want = (dxy[0][0], dxy[0][1], dv), [_heads(w) for w in want]
    for g, w in zip(got, want):
        assert _max_err(g, w) <= ATOL


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulation_matches_pallas(kind, T):
    """At p = 0 the emulated forward agrees with JAX's Pallas kernel (in
    interpret mode) on every row but the fully padded (or masked) ones."""
    q, k, v, _, a, e, bias, _ = _inputs(kind, T, 0.0)
    out, _ = emulate_forward(_chunks(kind, q, k, a, e), _heads(v), bias,
                             0.0, None)
    seed = jnp.zeros((B,), jnp.int32)
    j = [jnp.asarray(x.numpy()) for x in (q, k, v, a, e, bias)]
    if kind == "full_bias":
        hm = [jnp.asarray(_heads(x).contiguous().numpy()) for x in (q, k, v)]
        want = _packed(torch.tensor(np.asarray(jfa.fused_attention_full_bias(
            *hm, j[5], 0, SCALE, 0.0, False))))
        out[0, 0, T // 2] = 0.0      # the fully masked row (ROADMAP Queue 3)
        want = _heads(want)
        want[0, 0, T // 2] = 0.0
        assert _max_err(out[:-1], want[:-1]) <= ATOL
        return
    if kind == "relpos":
        want = jfr.fused_attention_relpos(*j, seed, SCALE, 0.0, False, H)
    elif kind == "packed":
        want = jfa.fused_attention_packed(*j[:3], j[5], seed, SCALE, 0.0,
                                          False, H)
    else:
        hm = [jnp.asarray(_heads(x).contiguous().numpy()) for x in (q, k, v)]
        want = _packed(torch.tensor(np.asarray(jfa.fused_attention(
            *hm, j[5], seed, SCALE, 0.0, False))))
    want = _heads(torch.tensor(np.asarray(want)))
    assert _max_err(out[:-1], want[:-1]) <= ATOL


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("T,nsplit", [(65, 2), (130, 2), (130, 3)])
@pytest.mark.parametrize("kind", KINDS)
def test_key_split_matches_plain(kind, T, nsplit, p):
    """The keys split over ``nsplit`` ranges of whole tiles and merged:
    the output and the statistics the backward reads as without the split
    (the fully padded row's m = -1e30 in every range, l the key count)."""
    q, k, v, _, a, e, bias, seeds = _inputs(kind, T, p)
    chunks = _chunks(kind, q, k, a, e)
    out, stats = emulate_forward(chunks, _heads(v), bias, p, seeds, nsplit)
    whole, whole_stats = emulate_forward(chunks, _heads(v), bias, p, seeds)
    assert _max_err(out, _plain(kind, q, k, v, a, e, bias, p, seeds)) <= ATOL
    assert torch.equal(stats[..., 0], whole_stats[..., 0])
    assert _max_err(stats[..., 1] / whole_stats[..., 1], 1.0) <= ATOL
    assert torch.all(stats[-1, ..., 0] == tfa.NEG)
    assert torch.all(stats[-1, ..., 1] == T)
