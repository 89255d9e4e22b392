"""The port's kernel-holding ops (``daspeech_torch/ops``) against the JAX
Pallas kernels they replace, run in interpret mode on the CPU as the JAX
package's own tests run them. On CPU tensors each wrapper takes its plain
PyTorch version; that version is what is held against the Pallas kernel
here (the CUDA kernels are held against it on the card, by
``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``).

Inputs are made with numpy from a seed and handed to both packages; all
comparisons are fp32 at 1e-5 absolute (summation order differs).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from daspeech_torch.ops import fused_attention as tfa
from daspeech_torch.ops import fused_links as tfl
from daspeech_torch.ops import fused_relpos as tfr
from daspeech_tpu.ops import fused_attention as jfa
from daspeech_tpu.ops import fused_links as jfl
from daspeech_tpu.ops import fused_relpos as jfr

ATOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Pallas kernels in interpret mode (``tests/test_fused_attention.py:
    16-20``, ``tests/test_fused_links.py:15-16``)."""
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)
    monkeypatch.setattr(jfr.pl, "pallas_call", patched)
    monkeypatch.setattr(jfl, "INTERPRET", True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.tensor(np.asarray(x))


def _bias(rng, B, Tk):
    valid = np.ones((B, Tk), bool)
    valid[-1, -3:] = False
    return np.where(valid, 0.0, tfa.NEG).astype(np.float32)


class TestAttention:
    @pytest.mark.parametrize("B,Tq,Tk,H,d", [(2, 10, 13, 2, 8),
                                             (1, 24, 24, 2, 8),
                                             (2, 7, 24, 2, 8)])
    def test_plain_matches_pallas(self, B, Tq, Tk, H, d):
        rng = np.random.default_rng(B + Tq + Tk)
        q, k, v = (rng.normal(size=(B, T, H * d)).astype(np.float32)
                   for T in (Tq, Tk, Tk))
        q *= d ** -0.5          # the caller pre-scales q
        bias = _bias(rng, B, Tk)
        want = jfa.fused_attention_packed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(bias), 0, 1.0, 0.0, False, H)
        got = tfa.fused_attention_packed(_t(q), _t(k), _t(v), _t(bias), H)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


class TestLinks:
    @pytest.mark.parametrize("B,L,H,dk,mtl,ol", [
        (2, 13, 2, 8, None, (13, 10)),
        (2, 24, 2, 8, None, (24, 2)),     # a graph with one valid edge
        (2, 20, 2, 8, 6, (20, 17)),       # banded-softmax semantics
    ])
    def test_plain_matches_pallas(self, B, L, H, dk, mtl, ol):
        rng = np.random.default_rng(B + L + dk)
        q = rng.normal(size=(B, L, H * dk)).astype(np.float32)
        k = rng.normal(size=(B, L, H * dk)).astype(np.float32)
        g = np.asarray(jax.nn.log_softmax(
            rng.normal(size=(B, L, H)).astype(np.float32), axis=-1))
        ol = np.asarray(ol, np.int32)
        sc = 1.0 / math.sqrt(dk)
        want = np.asarray(jfl.fused_extract_links(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(g), jnp.asarray(ol),
            H, sc, mtl))
        got = tfl.fused_extract_links(_t(q), _t(k), _t(g),
                                      torch.from_numpy(ol), H, sc,
                                      mtl).numpy()
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        assert np.all(got[~finite] == -np.inf)      # exactly -inf, no NaN
        np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                                   atol=ATOL)


class TestRelPos:
    @pytest.mark.parametrize("B,T,H,d", [(2, 10, 2, 8), (1, 24, 2, 8),
                                         (2, 17, 2, 8)])
    def test_plain_matches_pallas(self, B, T, H, d):
        rng = np.random.default_rng(B + T)
        C = H * d
        q, k, v = (rng.normal(size=(B, T, C)).astype(np.float32)
                   for _ in range(3))
        a = (rng.normal(size=(B, T, H * C)) * 0.3).astype(np.float32)
        e = np.asarray(jfr.relpos_basis(T, C)[2])
        bias = _bias(rng, B, T)
        sc = 1.0 / math.sqrt(d)
        want = jfr.fused_attention_relpos(
            *map(jnp.asarray, (q, k, v, a, e, bias)),
            jnp.zeros((B,), jnp.int32), sc, 0.0, False, H)
        got = tfr.fused_attention_relpos(*map(_t, (q, k, v, a, e, bias)),
                                         H, sc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)

    @pytest.mark.parametrize("T,C", [(10, 16), (24, 16), (300, 256)])
    def test_basis_matches_jax(self, T, C):
        # same formula in f32; the two exp implementations may differ by
        # one ulp of the frequency, which the position index i < T
        # multiplies before sin/cos: |delta| <= T * 2**-23
        for got, want in zip(tfr.relpos_basis(T, C), jfr.relpos_basis(T, C)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=T * 2.0 ** -23)

    def test_rotate_matches_jax(self):
        rng = np.random.default_rng(5)
        T, C = 12, 16
        z = rng.normal(size=(2, T, 2, C)).astype(np.float32)
        s, c, _ = (np.asarray(x) for x in jfr.relpos_basis(T, C))
        want = jfr.relpos_rotate(jnp.asarray(z), jnp.asarray(s[:, None]),
                                 jnp.asarray(c[:, None]))
        got = tfr.relpos_rotate(_t(z), _t(s[:, None]), _t(c[:, None]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestDispatch:
    """A wrapper takes its plain version only for CPU tensors: any other
    device goes to the kernel's checks and raises rather than falling
    back, and the CPU path does not count as a launch."""

    def _inputs(self, device):
        B, T, H, d = 1, 4, 1, 64
        x = torch.zeros((B, T, H * d), device=device)
        return x, torch.zeros((B, T), device=device), H

    def test_cpu_path_is_not_a_launch(self):
        x, bias, H = self._inputs("cpu")
        before = tfa.fused_attention_packed.launches
        tfa.fused_attention_packed(x, x, x, bias, H)
        assert tfa.fused_attention_packed.launches == before

    def test_attention_refuses_non_cuda_device(self):
        x, bias, H = self._inputs("meta")
        with pytest.raises(ValueError, match="CUDA"):
            tfa.fused_attention_packed(x, x, x, bias, H)

    def test_links_refuses_non_cuda_device(self):
        x, _, H = self._inputs("meta")
        with pytest.raises(ValueError, match="CUDA"):
            tfl.fused_extract_links(x, x, torch.zeros((1, 4, 1),
                                                      device="meta"),
                                    torch.ones((1,), device="meta"), H, 1.0,
                                    None)

    def test_relpos_refuses_non_cuda_device(self):
        x, bias, H = self._inputs("meta")
        with pytest.raises(ValueError, match="CUDA"):
            tfr.fused_attention_relpos(
                x, x, x, torch.zeros((1, 4, 256), device="meta"),
                torch.zeros((4, 256), device="meta"), bias, H, 0.125)
