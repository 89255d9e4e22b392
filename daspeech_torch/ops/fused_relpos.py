"""Conformer rel-pos self-attention: rotation basis, plain PyTorch version
and the CUDA kernel.

Counterpart of ``daspeech_tpu/ops/fused_relpos.py``. The position score
``bd[i, j] = q_v[i] · (W_p pe(i-j))`` is computed without the [T, 2T-1]
table by the angle-addition identity: ``bd = a @ eᵀ`` with ``a`` the rotated
position queries (:func:`relpos_rotate`) and ``e`` a constant basis
(:func:`relpos_basis`). The CUDA kernel (``csrc/fused_relpos.cu``) replaces
the Pallas ``fused_attention_relpos`` (``fused_relpos.py:373``, kernel
``_relpos_fwd_kernel`` at :90), forward only. Unlike the JAX layer, which
takes its kernel only at T' >= 256 (a TPU measurement), the port launches
the kernel at every length on the card.
"""

from __future__ import annotations

import math

import torch

from daspeech_torch.ops import _build

NEG = -1e30
HEAD_DIM = 64
POS_DIM = 256        # per-head depth C of ``a`` the kernel is built for


def relpos_basis(T: int, C: int, device=None):
    """``(s, c, e)``: ``s[i, f] = sin(i·w_f)``, ``c[i, f] = cos(i·w_f)``
    ([T, C/2], f32) and ``e = [c | s]`` ([T, C])."""
    div = torch.exp(torch.arange(0, C, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / C))
    i = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    s = torch.sin(i * div)
    c = torch.cos(i * div)
    return s, c, torch.cat([c, s], dim=-1)


def relpos_rotate(z: torch.Tensor, s: torch.Tensor, c: torch.Tensor):
    """Rotate split-half position queries ``z [..., T, C]`` so that
    ``relpos_rotate(z) @ eᵀ`` is the rel-pos score."""
    C2 = s.shape[-1]
    z1, z2 = z[..., :C2], z[..., C2:]
    return torch.cat([z1 * s + z2 * c, -z1 * c + z2 * s], dim=-1)


def relpos_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 a: torch.Tensor, e: torch.Tensor, bias: torch.Tensor,
                 num_heads: int, sm_scale: float) -> torch.Tensor:
    """softmax((q_h k_hᵀ + a_h eᵀ)·sm_scale + bias[b]) v_h per head:
    q/k/v [B, T, H·d], a [B, T, H·C], e [T, C], bias [B, T]."""
    B, T, Cq = q.shape
    d = Cq // num_heads
    q4 = q.reshape(B, T, num_heads, d)
    k4 = k.reshape(B, T, num_heads, d)
    v4 = v.reshape(B, T, num_heads, d)
    a4 = a.reshape(B, T, num_heads, -1)
    ac = torch.einsum("bqhd,bkhd->bhqk", q4, k4)
    bd = torch.einsum("bqhc,kc->bhqk", a4, e)
    p = torch.softmax((ac + bd) * sm_scale + bias[:, None, None, :], dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v4).reshape(B, T, Cq)


def fused_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           a: torch.Tensor, e: torch.Tensor,
                           bias: torch.Tensor, num_heads: int,
                           sm_scale: float) -> torch.Tensor:
    """Rel-pos attention forward (see :func:`relpos_plain`).

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes fp32, contiguous inputs with d = 64 and C = 256, and raises
    on anything else."""
    if q.device.type == "cpu":
        return relpos_plain(q, k, v, a, e, bias, num_heads, sm_scale)
    B, T, Cq = q.shape
    _build.check_inputs("fused_attention_relpos", q, k, v, a, e, bias)
    d = Cq // num_heads
    C = e.shape[1]
    if Cq % num_heads or d != HEAD_DIM or C != POS_DIM:
        raise ValueError(f"fused_attention_relpos: d={Cq / num_heads}, C={C} "
                         f"unsupported (kernel takes d={HEAD_DIM}, "
                         f"C={POS_DIM})")
    if (k.shape != q.shape or v.shape != q.shape
            or a.shape != (B, T, num_heads * C) or e.shape != (T, C)
            or bias.shape != (B, T) or T < 1):
        raise ValueError("fused_attention_relpos: bad shapes "
                         f"q{tuple(q.shape)} a{tuple(a.shape)} "
                         f"e{tuple(e.shape)} bias{tuple(bias.shape)}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _build.library().daspeech_relpos_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(),
            e.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, T, num_heads, d, C, float(sm_scale), _build.stream_of(q))
    _build.check(rc, "daspeech_relpos_fwd")
    fused_attention_relpos.launches += 1
    return out


fused_attention_relpos.launches = 0
