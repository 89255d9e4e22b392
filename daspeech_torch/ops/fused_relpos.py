"""Conformer rel-pos self-attention: rotation basis, plain PyTorch version
and the CUDA kernel.

Counterpart of ``daspeech_tpu/ops/fused_relpos.py``. The position score
``bd[i, j] = q_v[i] · (W_p pe(i-j))`` is computed without the [T, 2T-1]
table by the angle-addition identity: ``bd = a @ eᵀ`` with ``a`` the rotated
position queries (:func:`relpos_rotate`) and ``e`` a constant basis
(:func:`relpos_basis`). The CUDA kernels (``csrc/fused_relpos.cu``) replace
the Pallas ``fused_attention_relpos`` (``fused_relpos.py:373``: forward
``_relpos_fwd_kernel`` at :90, backward ``_relpos_bwd_kernel`` at :125),
with dropout on the probabilities drawn from the Philox mask of
``ops/philox.py``: the backward and the inference forward on the tensor
cores in 3xTF32 (``csrc/attention_tc.cuh``), the training forward, which
saves the softmax statistics, on the fp32 FMA pipes
(``csrc/attention_fma.cuh``; the wrapper counts it in ``train_launches``
beside ``launches``). Unlike the JAX layer, which takes its kernel
only at T' >= 256 (a TPU measurement), the port launches the kernels at
every length on the card.

:func:`fused_attention_relpos` is differentiable in q, k, v and a (``e`` is
a constant basis). CPU tensors take the plain versions, CUDA tensors the
kernels; there is no fallback between the two.

bf16: the kernels also take bf16 q, k, v, a and e (the bias and the
statistics stay fp32) through the ``_bf16`` variants of their C entry
points, compute in fp32 and write out, dq, dk, dv and da in bf16, as the
Pallas kernels do (``fused_relpos.py:102-122``); a bf16 training forward
also writes its output in fp32, for the backward's delta (as
``ops/fused_attention.py``'s). The plain versions upcast bf16 operands and
cast their outputs back (``fused_attention._bf16_plain``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from daspeech_torch.ops import _build
from daspeech_torch.ops.fused_attention import (BF16, FP32, _bf16_plain,
                                                _bwd_out, _bwd_scratch,
                                                _check_aligned, _drop_args,
                                                _flat, _fwd_outputs, _saved,
                                                _unflat, operand_dtype)
from daspeech_torch.ops.philox import attention_keep

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


def _relpos_probs(q, k, a, e, bias, num_heads, sm_scale):
    B, T, Cq = q.shape
    d = Cq // num_heads
    q4 = q.reshape(B, T, num_heads, d)
    k4 = k.reshape(B, T, num_heads, d)
    a4 = a.reshape(B, T, num_heads, -1)
    ac = torch.einsum("bqhd,bkhd->bhqk", q4, k4)
    bd = torch.einsum("bqhc,kc->bhqk", a4, e)
    return torch.softmax((ac + bd) * sm_scale + bias[:, None, None, :],
                         dim=-1)


def relpos_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 a: torch.Tensor, e: torch.Tensor, bias: torch.Tensor,
                 num_heads: int, sm_scale: float, dropout_p: float = 0.0,
                 seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax((q_h k_hᵀ + a_h eᵀ)·sm_scale + bias[b]) v_h per head:
    q/k/v [B, T, H·d], a [B, T, H·C], e [T, C], bias [B, T]; with
    ``dropout_p`` > 0 the probabilities take the Philox mask of the int32
    per-row ``seeds`` [B]."""
    if q.dtype == BF16:
        return _bf16_plain(relpos_plain, q, k, v, a, e, bias, num_heads,
                           sm_scale, dropout_p, seeds)
    B, T, Cq = q.shape
    p = _relpos_probs(q, k, a, e, bias, num_heads, sm_scale)
    if dropout_p > 0.0:
        p = p * attention_keep(seeds, num_heads, T, T, dropout_p)
    v4 = v.reshape(B, T, num_heads, -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v4).reshape(B, T, Cq)


def relpos_bwd_plain(q, k, v, a, e, bias, dout, num_heads: int,
                     sm_scale: float, dropout_p: float = 0.0, seeds=None):
    """(dq, dk, dv, da) of :func:`relpos_plain` for the cotangent ``dout``
    in closed form (as ``attention_bwd_plain``; da = dS e·scale per head)."""
    if q.dtype == BF16:
        return _bf16_plain(relpos_bwd_plain, q, k, v, a, e, bias, dout,
                           num_heads, sm_scale, dropout_p, seeds)
    B, T, Cq = q.shape
    H = num_heads
    p = _relpos_probs(q, k, a, e, bias, H, sm_scale)
    z = (attention_keep(seeds, H, T, T, dropout_p) if dropout_p > 0.0
         else torch.ones_like(p))
    do4, v4 = dout.reshape(B, T, H, -1), v.reshape(B, T, H, -1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p * z, do4)
    dp = z * torch.einsum("bqhd,bkhd->bhqk", do4, v4)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * sm_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.reshape(B, T, H, -1))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.reshape(B, T, H, -1))
    da = torch.einsum("bhqk,kc->bqhc", ds, e)
    return (dq.reshape(B, T, Cq), dk.reshape(B, T, Cq), dv.reshape(B, T, Cq),
            da.reshape(B, T, -1))


def _check(name, q, k, v, a, e, bias, num_heads, seeds, dropout_p):
    B, T, Cq = q.shape
    drop = () if dropout_p == 0.0 else (seeds,)
    dt = operand_dtype(name, q)
    _build.check_inputs(name, q, k, v, a, e, bias, int32=drop,
                        dtype=(dt,) * 5 + (FP32,))
    _check_aligned(name, q, k, v, a, e)
    d = Cq // num_heads
    C = e.shape[1]
    if Cq % num_heads or d != HEAD_DIM or C != POS_DIM:
        raise ValueError(f"{name}: d={Cq / num_heads}, C={C} unsupported "
                         f"(kernel takes d={HEAD_DIM}, C={POS_DIM})")
    if (k.shape != q.shape or v.shape != q.shape
            or a.shape != (B, T, num_heads * C) or e.shape != (T, C)
            or bias.shape != (B, T) or T < 1
            or (drop and seeds.shape != (B,))):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"a{tuple(a.shape)} e{tuple(e.shape)} "
                         f"bias{tuple(bias.shape)}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"{name}: dropout_p {dropout_p} not in [0, 1)")


def relpos_fwd_kernel(q, k, v, a, e, bias, num_heads: int, sm_scale: float,
                      dropout_p: float = 0.0, seeds=None,
                      with_stats: bool = False):
    """Launch the forward kernel: (out, stats) with stats the [B, H, T, 2]
    row softmax (max, sum) the backward needs (bf16 operands: the pair
    (stats, out32)), or None."""
    _check("fused_attention_relpos", q, k, v, a, e, bias, num_heads, seeds,
           dropout_p)
    B, T, Cq = q.shape
    out, stats, out32 = _fwd_outputs(q, num_heads, T, with_stats)
    extra = () if q.dtype == FP32 else (_build.ptr(out32),)
    with torch.cuda.device(q.device):
        rc = _build.entry("daspeech_relpos_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(),
            e.data_ptr(), bias.data_ptr(), *_drop_args(dropout_p, seeds),
            out.data_ptr(), _build.ptr(stats), *extra, B, T, num_heads,
            HEAD_DIM, POS_DIM, float(sm_scale), _build.stream_of(q))
    _build.check(rc, "daspeech_relpos_fwd")
    fused_attention_relpos.launches += 1
    fused_attention_relpos.train_launches += with_stats
    fused_attention_relpos.bf16_launches += q.dtype == BF16
    return out, _saved(stats, out32)


def relpos_bwd_kernel(q, k, v, a, e, bias, out, stats, dout, num_heads: int,
                      sm_scale: float, dropout_p: float = 0.0, seeds=None):
    """Launch the backward kernels: (dq, dk, dv, da). ``stats``: what the
    training forward returned."""
    _check("fused_attention_relpos backward", q, k, v, a, e, bias, num_heads,
           seeds, dropout_p)
    out, stats = _bwd_out("fused_attention_relpos backward", q, out, stats)
    _build.check_inputs("fused_attention_relpos backward", out, stats, dout,
                        dtype=(FP32, FP32, q.dtype))
    _check_aligned("fused_attention_relpos backward", out, dout)
    B, T, Cq = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            stats.shape != (B, num_heads, T, 2):
        raise ValueError("fused_attention_relpos backward: bad shapes "
                         f"out{tuple(out.shape)} stats{tuple(stats.shape)} "
                         f"dout{tuple(dout.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    da = torch.empty_like(a)
    # delta [B, H, T], then dS and P∘Z [B, H, T, T]
    rows = B * num_heads * T
    scratch = _bwd_scratch(rows, 2 * rows * T, q.device)
    with torch.cuda.device(q.device):
        rc = _build.entry("daspeech_relpos_bwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(),
            e.data_ptr(), bias.data_ptr(), *_drop_args(dropout_p, seeds),
            out.data_ptr(), stats.data_ptr(), dout.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), da.data_ptr(), scratch.data_ptr(),
            B, T, num_heads, HEAD_DIM, POS_DIM, float(sm_scale),
            _build.stream_of(q))
    _build.check(rc, "daspeech_relpos_bwd")
    relpos_bwd_kernel.launches += 1
    relpos_bwd_kernel.bf16_launches += q.dtype == BF16
    return dq, dk, dv, da


class _RelPosAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, a, e, bias, num_heads, sm_scale, dropout_p,
                seeds):
        ctx.cfg = (num_heads, sm_scale, dropout_p)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, a, e, bias, seeds)
            return relpos_plain(q, k, v, a, e, bias, num_heads, sm_scale,
                                dropout_p, seeds)
        out, stats = relpos_fwd_kernel(q, k, v, a, e, bias, num_heads,
                                     sm_scale, dropout_p, seeds,
                                     with_stats=any(ctx.needs_input_grad))
        ctx.save_for_backward(q, k, v, a, e, bias, seeds, out, *_flat(stats))
        return out

    @staticmethod
    def backward(ctx, dout):
        num_heads, sm_scale, dropout_p = ctx.cfg
        q, k, v, a, e, bias, seeds, *saved = ctx.saved_tensors
        dout = dout.contiguous()
        if q.device.type == "cpu":
            grads = relpos_bwd_plain(q, k, v, a, e, bias, dout, num_heads,
                                     sm_scale, dropout_p, seeds)
        else:
            out, stats = _unflat(saved)
            grads = relpos_bwd_kernel(q, k, v, a, e, bias, out, stats, dout,
                                      num_heads, sm_scale, dropout_p, seeds)
        return (*grads, None, None, None, None, None, None)


def fused_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           a: torch.Tensor, e: torch.Tensor,
                           bias: torch.Tensor, num_heads: int,
                           sm_scale: float, dropout_p: float = 0.0,
                           seeds: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Rel-pos attention (see :func:`relpos_plain`), differentiable in q, k,
    v and a.

    CPU tensors take the plain versions. CUDA tensors launch the kernels,
    which take fp32 or bf16, contiguous q, k, v, a, e (one dtype) with
    d = 64 and C = 256, an fp32 bias (and int32 seeds with dropout), and
    raise on anything else; the output and the gradients have q's dtype."""
    return _RelPosAttention.apply(q, k, v, a, e, bias, num_heads, sm_scale,
                                  dropout_p, seeds)


fused_attention_relpos.launches = 0
fused_attention_relpos.train_launches = 0
fused_attention_relpos.bf16_launches = 0     # of launches, the bf16 ones
relpos_bwd_kernel.launches = 0
relpos_bwd_kernel.bf16_launches = 0
