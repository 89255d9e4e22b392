"""The port's Griffin-Lim vocoder (``daspeech_torch.models.griffin_lim``)
against the JAX package's on the CPU.

* the starting phase: the numpy copy of threefry2x32 and of JAX's uniform
  mapping gives ``jax.random.uniform``'s bits at several shapes, and a
  draw of M frames is the first M rows of a longer draw;
* ``_stft`` / ``_istft`` within 1e-5 of their output's norm;
* the vocoder at ``n_iter`` 4 within a relative L2 of 1e-4 (each round
  feeds the previous phase back, so fp32 rounding of the FFTs grows a
  little with every round; 4 rounds stay near 1e-6);
* a batch gives each row the bits that row gives alone.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daspeech_torch.models import griffin_lim as tgl
from daspeech_tpu.models import griffin_lim as jgl


@pytest.mark.parametrize("shape", [(1, 513), (7, 513), (416, 513), (3, 5),
                                   (1000,)])
def test_start_phase_is_jax_draw_bit_for_bit(shape):
    want = np.asarray(jax.random.uniform(jax.random.key(0), shape,
                                         minval=-jnp.pi, maxval=jnp.pi))
    got = tgl.jax_uniform(0, shape, -math.pi, math.pi)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_start_phase_of_fewer_frames_is_a_prefix():
    np.testing.assert_array_equal(tgl.start_phase(5, 513),
                                  tgl.start_phase(40, 513)[:5])


def test_threefry_matches_jax_other_key():
    want = np.asarray(jax.random.uniform(jax.random.key(7), (4, 9)))
    got = tgl.jax_uniform(7, (4, 9), 0.0, 1.0)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _window():
    return np.hanning(1025)[:-1].astype(np.float32)


def test_stft_and_istft_match_jax():
    rng = np.random.default_rng(0)
    wav = rng.normal(size=(2, 4096)).astype(np.float32)
    w = _window()
    jmag, jph = jgl._stft(jnp.asarray(wav), 1024, 256, jnp.asarray(w))
    tmag, tph = tgl._stft(torch.from_numpy(wav), 1024, 256,
                          torch.from_numpy(w))
    jmag = np.asarray(jmag)
    assert tmag.shape == jmag.shape
    assert (np.linalg.norm(tmag.numpy() - jmag)
            <= 1e-5 * np.linalg.norm(jmag))
    # the inverse of one (magnitude, phase) pair, JAX's own
    phase = np.array(jph)
    jmag = np.array(jmag)
    want = np.asarray(jgl._istft(jnp.asarray(jmag), jnp.asarray(phase),
                                 1024, 256, jnp.asarray(w)))
    got = tgl._istft(torch.from_numpy(jmag), torch.from_numpy(phase), 1024,
                     256, torch.from_numpy(w)).numpy()
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def _mel(seed, B=2, M=24):
    return np.random.default_rng(seed).normal(-2.0, 1.0, size=(B, M, 80)
                                              ).astype(np.float32)


def test_vocoder_matches_jax():
    mel = _mel(1)
    want = np.asarray(jgl.GriffinLimVocoder(n_iter=4).apply(
        {}, jnp.asarray(mel)))
    got = tgl.GriffinLimVocoder(n_iter=4)(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 24 * 256)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_batched_matches_single_bit_for_bit():
    mel = _mel(2, B=3, M=16)
    voc = tgl.GriffinLimVocoder(n_iter=3)
    batched = voc(torch.from_numpy(mel))
    for i in range(3):
        assert torch.equal(batched[i], voc(torch.from_numpy(mel[i:i + 1]))[0])
