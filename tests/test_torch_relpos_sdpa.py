"""The library yardstick of the rel-pos attention kernel (#5), on the CPU.

``chip_smoke.py`` times one PyTorch call beside the kernel: the rel-pos
attention is softmax((q_u kᵀ + a eᵀ)·scale + bias) v per head, which is
``F.scaled_dot_product_attention`` on the extended query [q_u | a] (depth
64 + 256) against the extended key [k | e] (``e`` broadcast over batch rows
and heads), v as it is, the column bias as an additive mask and
``scale = sm_scale`` (``chip_smoke.relpos_sdpa``). Here that composition is
held to :func:`relpos_plain` and :func:`relpos_bwd_plain` within 1e-5 at
dropout 0, forward and backward: dq and da are the two parts of the
extended query's gradient, dk the first 64 channels of the extended key's.
Inputs from a seed, a fully padded batch row included.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from daspeech_torch.ops import fused_relpos as fr

TOL = 1e-5
C = fr.POS_DIM


def _inputs(seed, B, T, H):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H * 64)).astype(np.float32) * 0.5
               for _ in range(3))
    a = rng.normal(size=(B, T, H * C)).astype(np.float32) * 0.1
    do = rng.normal(size=(B, T, H * 64)).astype(np.float32)
    keep = rng.integers(T // 2, T + 1, size=B)
    keep[0] = T
    keep[-1] = 0                        # a fully padded batch row
    bias = np.where(np.arange(T)[None, :] >= keep[:, None], fr.NEG,
                    0.0).astype(np.float32)
    return [torch.from_numpy(x) for x in (q, k, v, a, bias, do)]


@pytest.mark.parametrize("seed,B,T,H", [(0, 2, 17, 2), (1, 3, 40, 4)])
def test_sdpa_on_extended_operands_is_relpos_attention(seed, B, T, H):
    q, k, v, a, bias, do = _inputs(seed, B, T, H)
    e = fr.relpos_basis(T, C)[2]
    sc = 0.125
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, a)]
    ops = chip_smoke.relpos_sdpa_operands(*leaves, e, bias, H)
    out = chip_smoke.relpos_sdpa(*ops, sc)
    got = out.transpose(1, 2).reshape(B, T, H * 64)     # packed layout
    want = fr.relpos_plain(q, k, v, a, e, bias, H, sc)
    assert (got - want).abs().max().item() <= TOL
    grads = torch.autograd.grad(got, leaves, do)
    want_g = fr.relpos_bwd_plain(q, k, v, a, e, bias, do, H, sc)
    for name, g, w in zip(("dq", "dk", "dv", "da"), grads, want_g):
        assert (g - w).abs().max().item() <= TOL, name
