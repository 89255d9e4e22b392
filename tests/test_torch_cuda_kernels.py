"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the serving path can reach (ragged tiles, a single key,
Tq != Tk, long mels, graphs of one vertex and of the 1024-vertex maximum,
fully padded rows, the transition band). ``chip_smoke.py`` covers the
serving shapes.

Marked ``cuda``: every test skips without a CUDA device. On a machine with
one (the JAX package need not be installed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import math

import pytest
import torch

from daspeech_torch.ops import fused_attention as fa
from daspeech_torch.ops import fused_links as fl
from daspeech_torch.ops import fused_relpos as fr

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator().manual_seed(0)


def _randn(g, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).cuda()


def _bias(g, B, Tk, all_padded_row=False):
    keep = torch.randint(1, Tk + 1, (B,), generator=g)
    pad = torch.arange(Tk)[None, :] >= keep[:, None]
    if all_padded_row:
        pad[-1] = True
    return torch.where(pad, fa.NEG, 0.0).float().cuda()


@pytest.mark.parametrize("B,Tq,Tk,H", [(2, 1, 1, 1), (2, 37, 5, 2),
                                       (3, 70, 130, 8), (1, 240, 240, 8),
                                       (2, 600, 300, 8), (2, 1040, 1040, 4)])
def test_attention(gen, B, Tq, Tk, H):
    q = _randn(gen, B, Tq, H * 64, scale=0.125)
    k, v = _randn(gen, B, Tk, H * 64), _randn(gen, B, Tk, H * 64)
    bias = _bias(gen, B, Tk, all_padded_row=B > 1)
    got = fa.fused_attention_packed(q, k, v, bias, H)
    torch.cuda.synchronize()
    want = fa.attention_plain(q, k, v, bias, H)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("B,L,H,mtl", [(2, 1, 8, None), (2, 2, 8, None),
                                       (3, 129, 2, None), (2, 300, 8, 5),
                                       (1, 1024, 8, None)])
def test_links(gen, B, L, H, mtl):
    q, k = _randn(gen, B, L, H * 64), _randn(gen, B, L, H * 64)
    gates = torch.log_softmax(_randn(gen, B, L, H), dim=-1)
    ol = torch.randint(1, L + 1, (B,), generator=gen).cuda()
    sc = 1.0 / 8.0
    got = fl.fused_extract_links(q, k, gates, ol, H, sc, mtl)
    torch.cuda.synchronize()
    want = fl.links_plain(q, k, gates, ol, H, sc, mtl)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert bool((got[~finite] == -math.inf).all())
    if finite.any():
        assert (got[finite] - want[finite]).abs().max().item() <= TOL


@pytest.mark.parametrize("B,T,H", [(2, 1, 4), (2, 17, 4), (3, 129, 4)])
def test_relpos(gen, B, T, H):
    C = 256
    q, k, v = (_randn(gen, B, T, H * 64) for _ in range(3))
    a = _randn(gen, B, T, H * C, scale=0.3)
    e = fr.relpos_basis(T, C, device="cuda")[2].contiguous()
    bias = _bias(gen, B, T)
    got = fr.fused_attention_relpos(q, k, v, a, e, bias, H, 0.125)
    torch.cuda.synchronize()
    want = fr.relpos_plain(q, k, v, a, e, bias, H, 0.125)
    assert (got - want).abs().max().item() <= TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = _randn(gen, 1, 4, 2 * 32)                   # head depth 32
    bias = torch.zeros((1, 4), device="cuda")
    with pytest.raises(ValueError, match="head depth"):
        fa.fused_attention_packed(x, x, x, bias, 2)
    y = _randn(gen, 1, 64, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_attention_packed(y, y, y, torch.zeros((1, 64),
                                                       device="cuda"), 1)
    big = _randn(gen, 1, 1025, 64)
    with pytest.raises(ValueError, match="L <= 1024"):
        fl.fused_extract_links(big, big, torch.zeros((1, 1025, 1),
                                                     device="cuda"),
                               torch.tensor([1025], device="cuda"), 1, 0.1,
                               None)
