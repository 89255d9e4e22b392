"""The arithmetic of the bf16 GEMM kernels of the fused FFN (#6,
``csrc/ffn_bf16.cuh``) and the MRF level (#7, ``csrc/mrf_bf16.cuh``), on
the CPU.

Both kernels take every product as bf16 ``mma.sync`` m16n8k16 steps with
fp32 accumulators chained in place: each k-step of 16 adds its exact dot
(products of two bf16 values, summed exactly: their bits span far less
than float64's 53) to the fp32 accumulator, rounded once. Here that order
is emulated in numpy, with bf16 round-to-nearest-even operands where the
kernels (and the Pallas kernels) round them:

- #6: LayerNorm in fp32, y rounded; per F slice pre = y·W1ᵀ, h rounded
  before h·W2ᵀ; each slice's product in an accumulator of its own, added
  into the cluster block's fp32 partial in slice order, the blocks'
  partials added in rank order (cs = min(8, ceil(F / 256)) blocks, block
  r the slices r, r + cs, ...), then + b2 and the output rounded. The backward: g rounded before g·W2 and gᵀ·(h·m1),
  gpre and h·m1 rounded before gpre·W1 and the weight gradients (whose
  k-steps run over the rows in order, slices of the rows added in order),
  db1 and db2 the sums of the unrounded gpre and g, row tile by row tile.
- #7: each conv's input lrelu'd and rounded to bf16 (the conv before it
  writes it so); every output (channel, frame) sums its taps in order,
  each tap's input channels in k-steps of 16 in order, in one fp32
  accumulator; + bias, + residual, the level average in fp32.

Held, at #6 [2, 37, 256] with F = 600 (three slices on a cluster of three)
and p = 0, and at #7 [2, 128, 128] with config_v1's kernels and dilations:

- within 2^-9 of each output's largest magnitude of float64 (the same
  roundings of the same operands, exact sums);
- within 2^-7 of JAX's bf16 Pallas kernels in interpret mode (the bar of
  the card's bf16 kernels against their plain bf16 versions);
- #7's emulated order gives a window of the sequence (with its receptive
  field) the bits of the whole, which ``chip_smoke.py`` and the card tests
  require of the kernel; and the bf16 taps' packing
  (``fused_mrf.pack_bf16_taps``) round-trips.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daspeech_torch.ops import fused_ffn as tff
from daspeech_torch.ops import fused_mrf as tfm
from daspeech_tpu.ops import fused_ffn as jff
from daspeech_tpu.ops import fused_mrf as jfm
from test_torch_fused_ffn import interpret_pallas  # noqa: F401
from torch_cli_corpus import one_torch_thread  # noqa: F401
from test_torch_vocoder_rungs import (V1_DILATIONS, V1_KERNELS,
                                      _level_params, jax_mrf_level_bf16)

TOL_F64 = 2.0 ** -9       # of the output's largest magnitude
TOL_JAX = 2.0 ** -7
K_STEP = 16               # depth of an mma.sync m16n8k16 step
SLICE = 256               # F columns of a slice (fused_ffn.cu FS)
MAX_CLUSTER = 8
ROW_TILE = tff.ROW_TILE
FFN_SHAPE = (2, 37, 256, 600)    # B, T, C, F
MRF_SHAPE = (2, 128, 128)        # B, C, T


def bf(x) -> np.ndarray:
    """x rounded to bf16 (round to nearest even), as float32."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


class Arith:
    """The two arithmetics: ``exact`` (float64, exact products) and the
    kernels' (fp32 values, fp32 accumulators chained over k-steps of 16,
    each step's dot exact)."""

    def __init__(self, exact: bool):
        self.exact = exact
        self.dt = np.float64 if exact else np.float32

    def f(self, x):
        return np.asarray(x, dtype=self.dt)

    def rnd(self, x):
        """A product's operand: bf16, held in the arithmetic's type."""
        return self.f(bf(x))

    def mm(self, acc, a, b):
        """acc + a @ b, the contraction over a's last axis."""
        a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if self.exact:
            return acc + a64 @ b64
        for k0 in range(0, a64.shape[-1], K_STEP):
            acc = (acc.astype(np.float64) + a64[..., k0:k0 + K_STEP]
                   @ b64[k0:k0 + K_STEP]).astype(np.float32)
        return acc

    def zeros(self, *shape):
        return np.zeros(shape, dtype=self.dt)


# --- #6 ---------------------------------------------------------------


def ffn_inputs(seed=0):
    """bf16-valued x, weights (nn.Linear's layout) and biases, fp32 LayerNorm
    parameters, a bf16 cotangent; all float32 arrays."""
    B, T, C, Fd = FFN_SHAPE
    rng = np.random.default_rng(seed)
    x = bf(rng.normal(size=(B, T, C)))
    gamma = (1.0 + 0.1 * rng.normal(size=C)).astype(np.float32)
    beta = (0.1 * rng.normal(size=C)).astype(np.float32)
    w1 = bf(rng.normal(size=(Fd, C)) / math.sqrt(C))
    b1 = bf(0.1 * rng.normal(size=Fd))
    w2 = bf(rng.normal(size=(C, Fd)) / math.sqrt(Fd))
    b2 = bf(0.1 * rng.normal(size=C))
    dout = bf(rng.normal(size=(B, T, C)) / math.sqrt(B * T))
    return x, gamma, beta, w1, b1, w2, b2, dout


def _layer_norm(ar, x, gamma, beta):
    x = ar.f(x)
    mu = x.mean(-1, keepdims=True)
    rs = 1.0 / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True)
                       + ar.f(tff.LN_EPS))
    xhat = (x - mu) * rs
    return xhat * ar.f(gamma) + ar.f(beta), xhat, rs


def _rank_slices(Fd):
    """Each cluster block's F slices (column ranges), block r the slices
    r, r + cs, ..."""
    ns = math.ceil(Fd / SLICE)
    cs = min(MAX_CLUSTER, ns)
    return [[(s * SLICE, min(Fd, (s + 1) * SLICE)) for s in range(r, ns, cs)]
            for r in range(cs)]


def _in_order(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _tile_sums(ar, v):
    """Column sums of v [N, W] over row tiles of ROW_TILE, the tiles added
    in order (the kernels' part rows and ffn_reduce_kernel)."""
    return _in_order([v[n:n + ROW_TILE].sum(0, dtype=ar.dt)
                      for n in range(0, v.shape[0], ROW_TILE)])


def ffn_forward(ar, x, gamma, beta, w1, b1, w2, b2):
    B, T, C = x.shape
    y = ar.rnd(_layer_norm(ar, x.reshape(-1, C), gamma, beta)[0])
    parts = []
    for slices in _rank_slices(w1.shape[0]):
        by_slice = []
        for f0, f1 in slices:
            p = ar.mm(ar.zeros(B * T, f1 - f0), y, w1[f0:f1].T) + ar.f(
                b1[f0:f1])
            h = ar.rnd(p / (1 + np.exp(-p)))
            by_slice.append(ar.mm(ar.zeros(B * T, C), h, w2[:, f0:f1].T))
        parts.append(_in_order(by_slice))
    return (_in_order(parts) + ar.f(b2)).reshape(B, T, C)


def ffn_backward(ar, x, gamma, beta, w1, b1, w2, b2, dout):
    """(dx, dgamma, dbeta, dw1, db1, dw2, db2), dropout off."""
    B, T, C = x.shape
    Fd = w1.shape[0]
    N = B * T
    yf, xhat, rs = _layer_norm(ar, x.reshape(N, C), gamma, beta)
    y = ar.rnd(yf)
    g = ar.f(dout.reshape(N, C))
    gl = ar.rnd(g)
    gpre, hd = ar.zeros(N, Fd), ar.zeros(N, Fd)
    parts = []
    for slices in _rank_slices(Fd):
        by_slice = []
        for f0, f1 in slices:
            p = ar.mm(ar.zeros(N, f1 - f0), y, w1[f0:f1].T) + ar.f(b1[f0:f1])
            sg = 1 / (1 + np.exp(-p))
            gh = ar.mm(ar.zeros(N, f1 - f0), gl, w2[:, f0:f1])
            gpre[:, f0:f1] = gh * (sg * (1 + p * (1 - sg)))
            hd[:, f0:f1] = p * sg
            by_slice.append(ar.mm(ar.zeros(N, C), ar.rnd(gpre[:, f0:f1]),
                                  w1[f0:f1]))
        parts.append(_in_order(by_slice))
    gy = _in_order(parts)
    dxh = gy * ar.f(gamma)
    dx = rs * (dxh - dxh.mean(-1, keepdims=True)
               - xhat * (dxh * xhat).mean(-1, keepdims=True))
    # the weight gradients: k-steps over the rows of each slice in order,
    # the slices' partials added in order
    S = math.ceil(N / tff.SLICE_ROWS)
    rows = math.ceil(N / S)
    gp_l, hd_l = ar.rnd(gpre), ar.rnd(hd)
    dw1 = _in_order([ar.mm(ar.zeros(Fd, C), gp_l[n:n + rows].T, y[n:n + rows])
                     for n in range(0, N, rows)])
    dw2 = _in_order([ar.mm(ar.zeros(C, Fd), gl[n:n + rows].T, hd_l[n:n + rows])
                     for n in range(0, N, rows)])
    return (dx.reshape(B, T, C), _tile_sums(ar, gy * xhat),
            _tile_sums(ar, gy), dw1, _tile_sums(ar, gpre), dw2,
            _tile_sums(ar, g))


def _max_rel(got, want):
    want = np.asarray(want, np.float64)
    return (np.abs(np.asarray(got, np.float64) - want).max()
            / np.abs(want).max())


FFN_NAMES = ("out", "dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


def ffn_emulated_and_float64():
    x, gamma, beta, w1, b1, w2, b2, dout = ffn_inputs()
    got, want = {}, {}
    for res, exact in ((got, False), (want, True)):
        ar = Arith(exact)
        res["out"] = ffn_forward(ar, x, gamma, beta, w1, b1, w2, b2)
        res.update(zip(FFN_NAMES[1:], ffn_backward(
            ar, x, gamma, beta, w1, b1, w2, b2, dout)))
    return got, want


def as_written(res):
    """The outputs as the kernels write them: out and dx rounded to bf16
    (compared with float64 before that rounding, which alone moves an
    element by up to 2^-9 of itself)."""
    return {**res, "out": bf(res["out"]), "dx": bf(res["dx"])}


def test_ffn_emulation_within_2e9_of_float64():
    got, want = ffn_emulated_and_float64()
    errs = {n: _max_rel(got[n], want[n]) for n in FFN_NAMES}
    assert all(e <= TOL_F64 for e in errs.values()), errs


def test_ffn_emulation_within_2e7_of_jax_pallas():
    """JAX's fused_ffn (Pallas, interpret mode) on the same bf16 x,
    weights (its [C, F] and [F, C] layout) and biases, fp32 LayerNorm
    parameters: the forward and the vjp of the same cotangent."""
    x, gamma, beta, w1, b1, w2, b2, dout = ffn_inputs()
    got = as_written(ffn_emulated_and_float64()[0])
    j = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731

    def fn(x_, g_, b_, w1_, b1_, w2_, b2_):
        return jff.fused_ffn(x_, g_, b_, w1_, b1_, w2_, b2_, 0, 0.0, 0.0,
                             False)

    out, vjp = jax.vjp(fn, j(x), jnp.asarray(gamma), jnp.asarray(beta),
                       j(w1.T), j(b1), j(w2.T), j(b2))
    dx, dg, db, dw1, db1, dw2, db2 = vjp(j(dout))
    want = {"out": out, "dx": dx, "dgamma": dg, "dbeta": db, "dw1": dw1.T,
            "db1": db1, "dw2": dw2.T, "db2": db2}
    errs = {n: _max_rel(got[n], np.asarray(jnp.asarray(want[n], jnp.float32)
                                           ).reshape(got[n].shape))
            for n in FFN_NAMES}
    assert all(e <= TOL_JAX for e in errs.values()), errs


# --- #7 ---------------------------------------------------------------


def _lrelu(v):
    return np.where(v >= 0, v, v * v.dtype.type(tfm.LRELU_SLOPE))


def mrf_conv(ar, act, taps, bias, d, res=None):
    """One conv of a level: act [B, T, C] the bf16-valued conv input,
    taps [K, C, C] (in, out); out[b, t] = sum over taps j in order of
    act[b, t + (j - c) d] · W_j (zero outside [0, T)), + bias, + res."""
    B, T, C = act.shape
    K = taps.shape[0]
    c = (K - 1) // 2
    pad = np.zeros((B, T + 2 * c * d, C), act.dtype)
    pad[:, c * d:c * d + T] = act
    acc = ar.zeros(B * T, C)
    for j in range(K):
        acc = ar.mm(acc, pad[:, j * d:j * d + T].reshape(B * T, C), taps[j])
    v = acc.reshape(B, T, C) + ar.f(bias)
    return v if res is None else res + v


def mrf_level(ar, x, W, biases):
    """x [B, T, C] (the kernel's layout inside the level) -> the level's
    output; W the bf16-valued taps, every conv's input rounded to bf16."""
    x = ar.f(x)
    out, tap, conv = None, 0, 0
    for k, ds in zip(V1_KERNELS, V1_DILATIONS):
        cur = x
        for d in ds:
            y = mrf_conv(ar, ar.rnd(_lrelu(cur)), W[tap:tap + k], biases[conv],
                         d)
            cur = mrf_conv(ar, ar.rnd(_lrelu(y)), W[tap + k:tap + 2 * k],
                           biases[conv + 1], 1, res=cur)
            tap, conv = tap + 2 * k, conv + 2
        out = cur if out is None else out + cur
    return out * ar.f(1.0 / len(V1_KERNELS))


def mrf_inputs(seed=0, T=None):
    B, C, T0 = MRF_SHAPE
    rng = np.random.default_rng(seed)
    params = _level_params(rng, C)
    x = rng.normal(size=(B, T or T0, C)).astype(np.float32)
    W = bf(np.concatenate([k for blk in params for (k1, _, k2, _) in blk
                           for k in (k1, k2)]))
    biases = np.stack([b for blk in params for (_, b1, _, b2) in blk
                       for b in (b1, b2)])
    return params, x, W, biases


def test_mrf_emulation_within_2e9_of_float64():
    _, x, W, biases = mrf_inputs()
    got = mrf_level(Arith(False), x, W, biases)
    want = mrf_level(Arith(True), x, W, biases)
    assert got.dtype == np.float32
    assert _max_rel(got, want) <= TOL_F64


def test_mrf_emulation_within_2e7_of_jax_pallas():
    """JAX's _mrf_kernel with bf16 operands (interpret mode; the set-up of
    ``tests/test_torch_vocoder_rungs.py``) at one tile and at two with
    their halos."""
    params, x, W, biases = mrf_inputs()
    got = mrf_level(Arith(False), x, W, biases)
    Wj, bj, offs, H = jfm.prepare_level(
        jax.tree.map(jnp.asarray, params), 1, MRF_SHAPE[1], V1_KERNELS,
        V1_DILATIONS, dtype=jnp.bfloat16)
    assert np.array_equal(np.asarray(Wj.astype(jnp.float32)), W)
    for tile in (64, 1024):
        want = np.asarray(jax_mrf_level_bf16(jnp.asarray(x), Wj, bj,
                                             offsets=offs, H=H, tile=tile))
        assert _max_rel(got, want) <= TOL_JAX, tile


def test_mrf_emulated_order_gives_a_window_the_bits_of_the_whole():
    """A window that holds a frame's receptive field (the halo of every
    conv of the level) gives those frames the whole sequence's bits: the
    order of a frame's sums depends on nothing else."""
    halo = sum((k - 1) // 2 * (d + 1) for k, ds in zip(V1_KERNELS,
                                                       V1_DILATIONS)
               for d in ds)
    _, x, W, biases = mrf_inputs(seed=3, T=400)
    ar = Arith(False)
    whole = mrf_level(ar, x, W, biases)
    a, n = 171, 60
    part = mrf_level(ar, x[:, a - halo:a + n + halo], W, biases)
    assert np.array_equal(part[:, halo:halo + n], whole[:, a:a + n])


@pytest.mark.parametrize("C", [8, 16, 128])
def test_pack_bf16_taps_round_trips(C):
    """The bf16 taps as the kernel reads them: [n, max(C, 16), ...] holding
    W with zeros beyond C (W itself from 16 channels on)."""
    W = torch.randn(12, C, C).to(torch.bfloat16)
    P = tfm.pack_bf16_taps(W)
    CP = max(C, tfm.BF16_MIN_CHANNELS)
    assert P.shape == (12, CP, CP) and P.dtype == torch.bfloat16
    assert torch.equal(P[:, :C, :C], W)
    assert not P[:, C:].any() and not P[:, :, C:].any()
    if C >= tfm.BF16_MIN_CHANNELS:
        assert P.data_ptr() == W.data_ptr()


def test_emulated_mrf_level_is_the_plain_bf16_level():
    """The plain bf16 version (``mrf_level_ref``, the CPU path of
    ``mrf_level``) rounds at the emulation's points: within the 2^-9 bar
    of it (they differ only in the order of fp32 sums)."""
    _, x, W, biases = mrf_inputs(seed=5)
    got = mrf_level(Arith(False), x, W, biases)
    with torch.no_grad():
        plain = tfm.mrf_level_ref(
            torch.from_numpy(x).transpose(1, 2).contiguous(),
            torch.from_numpy(W).to(torch.bfloat16), torch.from_numpy(biases),
            V1_KERNELS, V1_DILATIONS).transpose(1, 2).numpy()
    assert _max_rel(got, plain) <= TOL_F64


def test_emulated_ffn_is_the_plain_bf16_ffn():
    """The plain bf16 versions (``ffn_plain``, ``ffn_bwd_plain``) round at
    the emulation's points: within 2^-7 of it, the card's bar between the
    kernels and the plain versions (their fp32 sums, in another order, move
    some roundings of y, h and gpre by one bf16 ulp)."""
    x, gamma, beta, w1, b1, w2, b2, dout = ffn_inputs()
    got = as_written(ffn_emulated_and_float64()[0])
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    args = (t(x), torch.from_numpy(gamma), torch.from_numpy(beta), t(w1),
            t(b1), t(w2), t(b2))
    plain = {"out": tff.ffn_plain(*args)}
    plain.update(zip(FFN_NAMES[1:], tff.ffn_bwd_plain(*args, t(dout))))
    errs = {n: _max_rel(got[n], plain[n].float().numpy()) for n in FFN_NAMES}
    assert all(e <= TOL_JAX for e in errs.values()), errs
