"""The tensor-core MRF level kernel's arithmetic (``csrc/fused_mrf.cu``), on
the CPU.

The kernel takes each conv of a HiFi-GAN MRF level as an implicit GEMM:
for an output tile of ``tile`` frames it stages lrelu(x) for 16 input
channels and ``tile + (K - 1) d`` frames starting at ``t0 - c d``
(c = (K - 1) / 2; zero outside [0, T) and past C, channels padded to 32),
and for each tap j adds W_j[16 channels]ᵀ times the staged tile shifted
by ``j d`` frames, 8 channels (one k-step) at a time, each k-step's
products in a fresh accumulator added in fp32. Here that decomposition is
emulated in torch (:func:`level_tiles`, each k-step an elementwise
8-term sum in a fixed order) and held

- to the plain version ``mrf_level_ref`` (``F.conv1d``) within 1e-5 at
  C = 32 and 8 (padded channels), T ragged against the tile, kernels
  3/7/11 and dilations 1/3/5 (sums in another order), and through it to
  JAX's Pallas ``mrf_level`` in interpret mode at C = 128 (rtol 2e-4, atol
  2e-5, ``tests/test_torch_vocoder.py``'s bounds);
- to itself: the same bits at every tile (64, 128), and, for a window
  that holds a frame's receptive field, the same bits as the whole
  sequence (the chunked vocoder's premise: no frame's sum order depends on
  its place in a tile, on B or on T).

The 3xTF32 split of ``tests/test_torch_tf32_split.py`` is put into the
level's 126 taps of products (each conv one product of depth K C over an
im2col view): within 1e-5 of float64, and plain 1xTF32 at least ten times
further off.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from daspeech_torch.ops import fused_mrf as tfm
from daspeech_tpu.ops import fused_mrf as jfm
from test_torch_tf32_split import make_einsum

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3
STAGE = 16                     # input channels a stage (csrc KC)
KSTEP = 8                      # channels of one mma k-step
MIN_CHANNELS = 32              # the kernel pads C to at least this
TOL = 1e-5
TOL_3X = 1e-5


def level_inputs(seed, B, C, T, bias_scale=0.1):
    """x ~ N(0, 1) [B, C, T], each conv's taps N(0, 1 / (k C)), biases
    N(0, bias_scale): the level's output stays of order 1."""
    rng = np.random.default_rng(seed)
    W = np.concatenate([rng.normal(0, 1 / np.sqrt(k * C), (k, C, C))
                        for k in KS for _ in range(2 * len(DS[0]))])
    b = rng.normal(0, bias_scale, (2 * len(DS[0]) * len(KS), C))
    x = rng.normal(size=(B, C, T))
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, W, b)]


def conv_tiles(x, taps, bias, d, tile, res=None):
    """One conv as the kernel takes it: ``x`` [B, C, T] before lrelu,
    ``taps`` [K, C, C] (tap, in, out); + bias, + ``res`` if given."""
    B, C, T = x.shape
    K = taps.shape[0]
    c = (K - 1) // 2
    CP = max(C, MIN_CHANNELS)
    W = torch.zeros(K, CP, CP)
    W[:, :C, :C] = taps
    out = torch.empty_like(x)
    for t0 in range(0, T, tile):
        xbase, nx = t0 - c * d, tile + (K - 1) * d
        frames = torch.arange(xbase, xbase + nx)
        inside = (frames >= 0) & (frames < T)
        xs = torch.zeros(B, CP, nx)
        xs[:, :C, inside] = F.leaky_relu(x[:, :, frames[inside]],
                                         tfm.LRELU_SLOPE)
        acc = torch.zeros(B, CP, tile)
        for ci0 in range(0, CP, STAGE):
            for j in range(K):
                view = xs[:, :, j * d:j * d + tile]       # shifted by j d
                for k0 in range(ci0, ci0 + STAGE, KSTEP):
                    f = torch.zeros(B, CP, tile)          # fresh accumulator
                    for k in range(k0, k0 + KSTEP):
                        f = f + W[j, k][None, :, None] * view[:, k][:, None]
                    acc = acc + f
        n = min(tile, T - t0)
        v = acc[:, :C, :n] + bias[None, :, None]
        out[:, :, t0:t0 + n] = v if res is None else res[:, :, t0:t0 + n] + v
    return out


def level_tiles(x, W, biases, tile):
    """The level (three ResBlock1 chains, averaged) as the kernel computes
    it: per iteration the dilated conv into y, then cur + the plain conv of
    lrelu(y); the blocks' results summed in order and scaled by 1 / 3."""
    tap, conv, out = 0, 0, None
    for k, ds in zip(KS, DS):
        cur = x
        for d in ds:
            y = conv_tiles(cur, W[tap:tap + k], biases[conv], d, tile)
            cur = conv_tiles(y, W[tap + k:tap + 2 * k], biases[conv + 1], 1,
                             tile, res=cur)
            tap, conv = tap + 2 * k, conv + 2
        out = cur if out is None else out + cur
    return out * (1.0 / len(KS))


def _level_ref(x, W, b):
    return tfm.mrf_level_ref(x, W, b, KS, DS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("B,C,T,tile", [(1, 32, 150, 64), (2, 32, 97, 128),
                                        (1, 8, 200, 128), (1, 32, 1, 64)])
def test_implicit_gemm_matches_the_plain_level(B, C, T, tile):
    x, W, b = level_inputs(B + C + T, B, C, T)
    got = level_tiles(x, W, b, tile)
    want = _level_ref(x, W, b)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= TOL


def test_large_biases_at_both_ends():
    """Values made by the biases outside [0, T) must not reach the second
    conv of a pair (its SAME padding): large biases, short T."""
    x, W, b = level_inputs(3, 1, 32, 40, bias_scale=1.0)
    got = level_tiles(x, W, b, 64)
    assert (got - _level_ref(x, W, b)).abs().max().item() <= TOL


def test_implicit_gemm_through_the_plain_level_to_jax():
    """At C = 128 (f = 1, the layout JAX's kernel takes unfolded): the
    emulation against the plain version, and the plain version against
    JAX's Pallas kernel in interpret mode."""
    B, C, T = 1, 128, 128
    x, W, b = level_inputs(11, B, C, T)
    got = level_tiles(x, W, b, 64)
    want = _level_ref(x, W, b)
    assert (got - want).abs().max().item() <= TOL
    conv_params, tap, conv = [], 0, 0
    for k, ds in zip(KS, DS):
        blk = []
        for _ in ds:
            blk.append((W[tap:tap + k].numpy(), b[conv].numpy(),
                        W[tap + k:tap + 2 * k].numpy(), b[conv + 1].numpy()))
            tap, conv = tap + 2 * k, conv + 2
        conv_params.append(blk)
    jW, jb, offs, H = jfm.prepare_level(conv_params, 1, C, KS, DS,
                                        dtype=jnp.float32)
    jx = jnp.asarray(x.transpose(1, 2).numpy())
    jout = np.asarray(jfm.mrf_level(jx, jW, jb, offsets=offs, H=H, tile=64,
                                    interpret=True))
    np.testing.assert_allclose(want.transpose(1, 2).numpy(), jout,
                               rtol=2e-4, atol=2e-5)


def test_every_tile_gives_the_same_bits():
    x, W, b = level_inputs(5, 2, 32, 300)
    outs = [level_tiles(x, W, b, t) for t in tfm.TILES]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_a_window_reproduces_the_whole_sequence():
    """A window that holds the receptive field of its middle frames gives
    them the bits of the whole sequence, at another tile phase and B."""
    halo = sum((k - 1) // 2 * (d + 1) for k, ds in zip(KS, DS) for d in ds)
    x, W, b = level_inputs(6, 2, 32, 400)
    whole = level_tiles(x, W, b, 128)
    a, n = 137, 70                          # window start, middle frames
    win = x[1:, :, a - halo:a + n + halo].contiguous()
    part = level_tiles(win, W, b, 64)
    assert torch.equal(part[:, :, halo:halo + n], whole[1:, :, a:a + n])


def _level_split(x, W, b, einsum):
    """The level with each conv one product of depth K C over an im2col
    view, taken by ``einsum``; activations, biases and sums in fp32."""
    tap, conv, out = 0, 0, None
    T = x.shape[-1]

    def conv1(inp, taps, bias, d):
        k = taps.shape[0]
        p = (k - 1) // 2 * d
        a = F.pad(F.leaky_relu(inp, tfm.LRELU_SLOPE), (p, p))
        cols = torch.stack([a[:, :, j * d:j * d + T] for j in range(k)], 1)
        return einsum("bjit,jio->bot", cols, taps) + bias[None, :, None]

    for k, ds in zip(KS, DS):
        cur = x
        for d in ds:
            y = conv1(cur, W[tap:tap + k], b[conv], d)
            cur = cur + conv1(y, W[tap + k:tap + 2 * k], b[conv + 1], 1)
            tap, conv = tap + 2 * k, conv + 2
        out = cur if out is None else out + cur
    return out / len(KS)


@pytest.mark.parametrize("C", [32, 64])
def test_3xtf32_level_within_1e5_of_float64(C):
    x, W, b = level_inputs(C, 1, C, 96)
    exact = _level_ref(x.double(), W.double(), b.double())
    e3 = (_level_split(x, W, b, make_einsum(3)).double() - exact).abs().max()
    e1 = (_level_split(x, W, b, make_einsum(1)).double() - exact).abs().max()
    print(f"MRF level C={C}: max abs error vs float64: 3xTF32 {e3:.3g}, "
          f"1xTF32 {e1:.3g}")
    assert e3 <= TOL_3X
    assert e1 >= 10 * e3
