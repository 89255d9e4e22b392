"""Multi-head attention, packed and head-major: plain PyTorch versions and
the CUDA kernels.

Counterpart of ``daspeech_tpu/ops/fused_attention.py``. The CUDA kernels
(``csrc/fused_attention.cu``) replace three Pallas kernels, with in-kernel
dropout on the probabilities:

- :func:`fused_attention_packed` (``fused_attention.py:522``: forward
  ``_attn_kernel_packed`` at :285, backward ``_attn_bwd_kernel_packed`` at
  :324) on packed q [B, Tq, H·d], k/v [B, Tk, H·d];
- :func:`fused_attention` (:189: forward ``_attn_kernel`` at :76, backward
  ``_attn_bwd_kernel`` at :103) on head-major q [B, H, Tq, d],
  k/v [B, H, Tk, d], which the JAX layer takes for the long sequences that
  overflow the packed kernel's VMEM budget (:func:`packed_route`);
- :func:`fused_attention_full_bias` (:673: forward ``_attn_kernel_fb`` at
  :573, backward ``_attn_bwd_kernel_fb`` at :600) on head-major q, k, v
  with a full [B, H, Tq, Tk] additive bias that receives a gradient. It has
  no caller in either package: it is the verified alternate backend JAX
  keeps for an arbitrary learned or ALiBi-style bias.

In fp32, the backward of all three, and their forward where no softmax
statistics are asked for (inference), run every product on the tensor
cores in 3xTF32, which keeps fp32's accuracy (``csrc/attention_tc.cuh``);
their training forward (``with_stats``) sums on the fp32 FMA pipes, which it
needs: the tensor cores' accumulation bias there moves batch-wide gradient
sums past fp32's noise. That is a register-tiled kernel
(``csrc/attention_fma.cuh``) for the packed and head-major layouts and, in
its full-bias mode, for the full bias. Each forward wrapper counts its
launches in ``launches`` and, of those, the training forwards in
``train_launches``; every packed and head-major wrapper counts its bf16
launches in ``bf16_launches`` too.
All are differentiable. Their forward and backward take the plain versions
for CPU tensors and launch the kernels for CUDA tensors; there is no
fallback between the two. Dropout multiplies the softmax probabilities by
the Philox mask of ``ops/philox.py``, keyed by (row seed, key j / 4, query
i, head h) in both layouts, which the kernels draw from the same counters:
kernel and plain version agree element for element with dropout on, and so
do the two layouts at a shape both take. The full-bias op takes one scalar
seed and keys by (seed, j / 4, i, h, b) (``philox.full_bias_keep``).

bf16: all three take bf16 q, k, v (the bias and the softmax statistics
stay fp32), through the ``_bf16`` variants of their C entry points, which
launch kernels of their own on the bf16 tensor cores
(``csrc/attention_bf16.cuh``: bf16 ``mma.sync`` with fp32
accumulators, the forward's P·V with P rounded to bf16, the backward's
dS·K, (P∘Z)ᵀ·dO and dSᵀ·Q with P and dS split into two bf16 terms; the
softmax and its statistics in fp32) and write out, dq, dk and dv in bf16,
as the Pallas kernels upcast their operands and cast their outputs
(``fused_attention.py:79-100``, ``:305-321``). A bf16 training forward
also writes its output in fp32 (``out32``), which the backward takes for
delta = rowsum(dO∘O): the Pallas backward sums P∘dP in fp32, the same
value, where the rounded bf16 output would cancel against dO·V in a
near-uniform softmax row. The full-bias op runs the same three kernels in
their full-bias mode (``attn_bf16_fb_*``: the fp32 bias4 tile streamed
into each key tile's stage, the fp32 dbias (dS) written by the dq kernel),
as the Pallas kernel keeps the bias and writes dS in fp32
(``fused_attention.py:664-666``, ``:718``); its wrappers count their bf16
launches in ``bf16_launches`` too. Each plain version, given
bf16 operands, upcasts them, runs the fp32 plain version and casts its
outputs back (dbias stays fp32).
"""

from __future__ import annotations

from typing import Optional

import torch

from daspeech_torch.ops import _build
from daspeech_torch.ops.philox import (attention_keep, full_bias_keep,
                                       keep_threshold)

NEG = -1e30          # additive bias of a padded key (fused_attention.py:33)
HEAD_DIM = 64        # the one head depth the kernels are built for
FP32, BF16 = torch.float32, torch.bfloat16


def operand_dtype(name: str, q: torch.Tensor) -> torch.dtype:
    """q's dtype if a kernel takes it as its operands' (fp32 or bf16)."""
    if q.dtype not in (FP32, BF16):
        raise TypeError(f"{name}: kernel takes float32 or bfloat16 "
                        f"operands, got {q.dtype}")
    return q.dtype


def _bf16_plain(fn, *args, **kwargs):
    """``fn`` (a plain fp32 version) on bf16 operands: the tensors among
    ``args`` upcast, each tensor result cast back to bf16."""
    out = fn(*[a.float() if isinstance(a, torch.Tensor)
               and a.dtype == BF16 else a for a in args], **kwargs)
    if isinstance(out, tuple):
        return tuple(o.to(BF16) for o in out)
    return out.to(BF16)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, T, C = x.shape
    return x.reshape(B, T, num_heads, C // num_heads)


def _probs(q, k, bias, num_heads, sm_scale):
    s = torch.einsum("bqhd,bkhd->bhqk", _heads(q, num_heads),
                     _heads(k, num_heads)) * sm_scale
    return torch.softmax(s + bias[:, None, None, :], dim=-1)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, num_heads: int,
                    sm_scale: float = 1.0, dropout_p: float = 0.0,
                    seeds: Optional[torch.Tensor] = None,
                    head0: int = 0) -> torch.Tensor:
    """softmax(q_h k_hᵀ·sm_scale + bias[b]) v_h per head on packed
    q [B, Tq, H·d], k/v [B, Tk, H·d], bias [B, Tk] -> [B, Tq, H·d]; with
    ``dropout_p`` > 0 the probabilities take the Philox mask of the int32
    per-row ``seeds`` [B], the H heads counted from ``head0`` (a
    tensor-parallel rank's heads of a layer). bf16 operands: see
    :func:`_bf16_plain`."""
    if q.dtype == BF16:
        return _bf16_plain(attention_plain, q, k, v, bias, num_heads,
                           sm_scale, dropout_p, seeds, head0)
    B, Tq, C = q.shape
    p = _probs(q, k, bias, num_heads, sm_scale)
    if dropout_p > 0.0:
        p = p * attention_keep(seeds, num_heads, Tq, k.shape[1], dropout_p,
                               head0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, _heads(v, num_heads))
    return out.reshape(B, Tq, C)


def attention_bwd_plain(q, k, v, bias, dout, num_heads: int,
                        sm_scale: float = 1.0, dropout_p: float = 0.0,
                        seeds: Optional[torch.Tensor] = None,
                        head0: int = 0):
    """(dq, dk, dv) of :func:`attention_plain` for the cotangent ``dout``,
    in closed form: dV = (P∘Z)ᵀ dO, dS = P∘(Z∘(dO Vᵀ) − rowsum(P∘Z∘(dO Vᵀ))),
    dQ = dS K·scale, dK = dSᵀ Q·scale (Z the dropout multipliers)."""
    if q.dtype == BF16:
        return _bf16_plain(attention_bwd_plain, q, k, v, bias, dout,
                           num_heads, sm_scale, dropout_p, seeds, head0)
    B, Tq, C = q.shape
    Tk = k.shape[1]
    p = _probs(q, k, bias, num_heads, sm_scale)
    z = (attention_keep(seeds, num_heads, Tq, Tk, dropout_p, head0)
         if dropout_p > 0.0 else torch.ones_like(p))
    do4, v4 = _heads(dout, num_heads), _heads(v, num_heads)
    dv = torch.einsum("bhqk,bqhd->bkhd", p * z, do4)
    dp = z * torch.einsum("bqhd,bkhd->bhqk", do4, v4)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * sm_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _heads(k, num_heads))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _heads(q, num_heads))
    return dq.reshape(B, Tq, C), dk.reshape(B, Tk, C), dv.reshape(B, Tk, C)


def _check_aligned(name, *tensors):
    """Raise unless every tensor starts on a 16-byte boundary: the
    tensor-core kernels copy q, k, v and dout rows (and bias rows of a
    multiple of 4 keys) by 16-byte cp.async and read out rows as float4 (a
    row's offset is a multiple of 64 floats, so the base address
    decides)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: kernel takes 16-byte-aligned tensors")


def _check(name, q, k, v, bias, num_heads, seeds, dropout_p):
    B, Tq, C = q.shape
    Tk = k.shape[1]
    drop = () if dropout_p == 0.0 else (seeds,)
    dt = operand_dtype(name, q)
    _build.check_inputs(name, q, k, v, bias, int32=drop,
                        dtype=(dt, dt, dt, FP32))
    _check_aligned(name, q, k, v)
    if C % num_heads or C // num_heads != HEAD_DIM:
        raise ValueError(f"{name}: head depth {C / num_heads} unsupported "
                         f"(kernel takes {HEAD_DIM})")
    if (k.shape != (B, Tk, C) or v.shape != k.shape
            or bias.shape != (B, Tk) or Tq < 1 or Tk < 1
            or (drop and seeds.shape != (B,))):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"bias{tuple(bias.shape)}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"{name}: dropout_p {dropout_p} not in [0, 1)")


def _flat(stats):
    return stats if isinstance(stats, tuple) else (stats,)


def _unflat(saved):
    """(out, stats) from the saved (out, stats) or (out, stats, out32)."""
    out, *stats = saved
    return out, (stats[0] if len(stats) == 1 else tuple(stats))


def _bwd_scratch(rows: int, n: int, device) -> torch.Tensor:
    """A backward's scratch buffer: delta [rows], padded to 4 floats so that
    what follows stays 16-byte aligned for cp.async, then ``n`` floats (the
    [B, H, Tq, Tk] dS and P∘Z buffers of the chunked-score kernels)."""
    return torch.empty((rows + 3) // 4 * 4 + n, dtype=torch.float32,
                       device=device)


def _fwd_outputs(q, num_heads, Tq, with_stats):
    """(out, stats, out32): the forward's output (q's layout and dtype),
    the [B, H, Tq, 2] row statistics of a training forward, and for a bf16
    training forward its output in fp32 too (see the module docstring)."""
    out = torch.empty_like(q)
    stats = out32 = None
    if with_stats:
        stats = torch.empty((q.shape[0], num_heads, Tq, 2),
                            dtype=torch.float32, device=q.device)
        if q.dtype == BF16:
            out32 = torch.empty(q.shape, dtype=FP32, device=q.device)
    return out, stats, out32


def _saved(stats, out32):
    """What a forward hands its backward: the statistics, or for bf16 the
    pair (statistics, fp32 output)."""
    return stats if out32 is None else (stats, out32)


def _bwd_out(name, q, out, stats):
    """(fp32 output, statistics) of a forward's ``out`` and ``stats`` (a
    bf16 forward's pair: its fp32 output stands in for ``out``)."""
    if q.dtype == BF16:
        if not isinstance(stats, tuple):
            raise TypeError(f"{name}: a bf16 backward takes the forward's "
                            "(stats, out32)")
        stats, out = stats
    return out, stats


def _drop_args(dropout_p, seeds):
    if dropout_p == 0.0:
        return 0, 0, 1.0
    return seeds.data_ptr(), keep_threshold(dropout_p), 1.0 / (1.0 - dropout_p)


def attention_fwd_kernel(q, k, v, bias, num_heads: int, sm_scale: float,
                         dropout_p: float = 0.0, seeds=None,
                         with_stats: bool = False, head0: int = 0):
    """Launch the forward kernel: (out, stats) with stats the [B, H, Tq, 2]
    row softmax (max, sum) the backward needs (bf16 operands: the pair
    (stats, out32), out32 the output in fp32), or None."""
    _check("fused_attention_packed", q, k, v, bias, num_heads, seeds,
           dropout_p)
    B, Tq, C = q.shape
    out, stats, out32 = _fwd_outputs(q, num_heads, Tq, with_stats)
    extra = () if q.dtype == FP32 else (_build.ptr(out32),)
    with torch.cuda.device(q.device):
        rc = _build.entry("daspeech_attention_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            *_drop_args(dropout_p, seeds), out.data_ptr(), _build.ptr(stats),
            *extra, B, Tq, k.shape[1], num_heads, HEAD_DIM, float(sm_scale),
            _build.stream_of(q), int(head0))
    _build.check(rc, "daspeech_attention_fwd")
    fused_attention_packed.launches += 1
    fused_attention_packed.train_launches += with_stats
    fused_attention_packed.bf16_launches += q.dtype == BF16
    return out, _saved(stats, out32)


def attention_bwd_kernel(q, k, v, bias, out, stats, dout, num_heads: int,
                         sm_scale: float, dropout_p: float = 0.0,
                         seeds=None, head0: int = 0):
    """Launch the backward kernels: (dq, dk, dv). ``stats``: what the
    training forward returned."""
    _check("fused_attention_packed backward", q, k, v, bias, num_heads, seeds,
           dropout_p)
    out, stats = _bwd_out("fused_attention_packed backward", q, out, stats)
    _build.check_inputs("fused_attention_packed backward", out, stats, dout,
                        dtype=(FP32, FP32, q.dtype))
    _check_aligned("fused_attention_packed backward", out, dout)
    B, Tq, C = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            stats.shape != (B, num_heads, Tq, 2):
        raise ValueError("fused_attention_packed backward: bad shapes "
                         f"out{tuple(out.shape)} stats{tuple(stats.shape)} "
                         f"dout{tuple(dout.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(stats.shape[:-1], dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        rc = _build.entry("daspeech_attention_bwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            *_drop_args(dropout_p, seeds), out.data_ptr(), stats.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), B, Tq, k.shape[1], num_heads, HEAD_DIM,
            float(sm_scale), _build.stream_of(q), int(head0))
    _build.check(rc, "daspeech_attention_bwd")
    attention_bwd_kernel.launches += 1
    attention_bwd_kernel.bf16_launches += q.dtype == BF16
    return dq, dk, dv


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads, sm_scale, dropout_p, seeds,
                head0):
        ctx.cfg = (num_heads, sm_scale, dropout_p, head0)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, bias, seeds)
            return attention_plain(q, k, v, bias, num_heads, sm_scale,
                                   dropout_p, seeds, head0)
        out, stats = attention_fwd_kernel(
            q, k, v, bias, num_heads, sm_scale, dropout_p, seeds,
            with_stats=any(ctx.needs_input_grad), head0=head0)
        ctx.save_for_backward(q, k, v, bias, seeds, out, *_flat(stats))
        return out

    @staticmethod
    def backward(ctx, dout):
        num_heads, sm_scale, dropout_p, head0 = ctx.cfg
        q, k, v, bias, seeds, *saved = ctx.saved_tensors
        dout = dout.contiguous()
        if q.device.type == "cpu":
            grads = attention_bwd_plain(q, k, v, bias, dout, num_heads,
                                        sm_scale, dropout_p, seeds, head0)
        else:
            out, stats = _unflat(saved)
            grads = attention_bwd_kernel(q, k, v, bias, out, stats, dout,
                                         num_heads, sm_scale, dropout_p,
                                         seeds, head0)
        return (*grads, None, None, None, None, None, None)


def fused_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, num_heads: int,
                           sm_scale: float = 1.0, dropout_p: float = 0.0,
                           seeds: Optional[torch.Tensor] = None,
                           head0: int = 0) -> torch.Tensor:
    """Packed-layout attention (see :func:`attention_plain`), differentiable
    in q, k and v. ``head0``: the first of the H heads among the layer's,
    which keys their dropout (0 unless the heads are a tensor-parallel
    rank's share).

    CPU tensors take the plain versions. CUDA tensors launch the kernels,
    which take fp32 or bf16, contiguous q, k, v with head depth 64, an fp32
    bias (and int32 seeds with dropout), and raise on anything else; the
    output and the gradients have q's dtype."""
    return _PackedAttention.apply(q, k, v, bias, num_heads, sm_scale,
                                  dropout_p, seeds, head0)


fused_attention_packed.launches = 0
fused_attention_packed.train_launches = 0
fused_attention_packed.bf16_launches = 0     # of launches, the bf16 ones
attention_bwd_kernel.launches = 0
attention_bwd_kernel.bf16_launches = 0


def packed_route(Tq: int, Tk: int, C: int, num_heads: int) -> bool:
    """Whether the attention layer takes the packed kernel (else the
    head-major one): the JAX layer's route, ``packed_fits_vmem``
    (``fused_attention.py:409-414``), with the same arithmetic. It is the
    TPU kernel's VMEM estimate (the backward's seven tiles and three
    [Tq, Tk] temporaries under 10 MiB), kept so that the port runs the
    kernel JAX runs at each shape; it is no limit of the H100, where both
    kernels stream keys and take every length. ``num_heads`` is unused, as
    in JAX."""
    tiles = 7 * max(Tq, Tk) * C * 2
    temps = 3 * Tq * Tk * 4
    return tiles + temps < 10 * 1024 * 1024


def attention_hm_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor, sm_scale: float = 1.0,
                       dropout_p: float = 0.0,
                       seeds: Optional[torch.Tensor] = None,
                       head0: int = 0) -> torch.Tensor:
    """softmax(q kᵀ·sm_scale + bias[b]) v on head-major q [B, H, Tq, d],
    k/v [B, H, Tk, d], bias [B, Tk] -> [B, H, Tq, d]; with ``dropout_p`` > 0
    the probabilities take the Philox mask of the int32 per-row ``seeds``
    [B] (the packed layout's mask, the heads counted from ``head0``). bf16
    operands: see :func:`_bf16_plain`."""
    if q.dtype == BF16:
        return _bf16_plain(attention_hm_plain, q, k, v, bias, sm_scale,
                           dropout_p, seeds, head0)
    B, H, Tq, _ = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    p = torch.softmax(s + bias[:, None, None, :], dim=-1)
    if dropout_p > 0.0:
        p = p * attention_keep(seeds, H, Tq, k.shape[2], dropout_p, head0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def attention_hm_bwd_plain(q, k, v, bias, dout, sm_scale: float = 1.0,
                           dropout_p: float = 0.0,
                           seeds: Optional[torch.Tensor] = None,
                           head0: int = 0):
    """(dq, dk, dv) of :func:`attention_hm_plain` for the cotangent
    ``dout``, in the closed form of :func:`attention_bwd_plain`."""
    if q.dtype == BF16:
        return _bf16_plain(attention_hm_bwd_plain, q, k, v, bias, dout,
                           sm_scale, dropout_p, seeds, head0)
    B, H, Tq, _ = q.shape
    Tk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    p = torch.softmax(s + bias[:, None, None, :], dim=-1)
    z = (attention_keep(seeds, H, Tq, Tk, dropout_p, head0)
         if dropout_p > 0.0 else torch.ones_like(p))
    dv = torch.einsum("bhqk,bhqd->bhkd", p * z, dout)
    dp = z * torch.einsum("bhqd,bhkd->bhqk", dout, v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    return dq, dk, dv


def _check_hm(name, q, k, v, bias, seeds, dropout_p):
    drop = () if dropout_p == 0.0 else (seeds,)
    dt = operand_dtype(name, q)
    _build.check_inputs(name, q, k, v, bias, int32=drop,
                        dtype=(dt, dt, dt, FP32))
    _check_aligned(name, q, k, v)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: takes [B, H, T, d] q, k, v")
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    if d != HEAD_DIM:
        raise ValueError(f"{name}: head depth {d} unsupported "
                         f"(kernel takes {HEAD_DIM})")
    if (k.shape != (B, H, Tk, d) or v.shape != k.shape
            or bias.shape != (B, Tk) or Tq < 1 or Tk < 1
            or (drop and seeds.shape != (B,))):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"bias{tuple(bias.shape)}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"{name}: dropout_p {dropout_p} not in [0, 1)")


def attention_hm_fwd_kernel(q, k, v, bias, sm_scale: float,
                            dropout_p: float = 0.0, seeds=None,
                            with_stats: bool = False, head0: int = 0):
    """Launch the head-major forward kernel: (out [B, H, Tq, d], stats) with
    stats the [B, H, Tq, 2] row softmax (max, sum) (bf16 operands: the pair
    (stats, out32)), or None."""
    _check_hm("fused_attention", q, k, v, bias, seeds, dropout_p)
    B, H, Tq, _ = q.shape
    out, stats, out32 = _fwd_outputs(q, H, Tq, with_stats)
    extra = () if q.dtype == FP32 else (_build.ptr(out32),)
    with torch.cuda.device(q.device):
        rc = _build.entry("daspeech_attention_hm_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            *_drop_args(dropout_p, seeds), out.data_ptr(), _build.ptr(stats),
            *extra, B, Tq, k.shape[2], H, HEAD_DIM, float(sm_scale),
            _build.stream_of(q), int(head0))
    _build.check(rc, "daspeech_attention_hm_fwd")
    fused_attention.launches += 1
    fused_attention.train_launches += with_stats
    fused_attention.bf16_launches += q.dtype == BF16
    return out, _saved(stats, out32)


def attention_hm_bwd_kernel(q, k, v, bias, out, stats, dout, sm_scale: float,
                            dropout_p: float = 0.0, seeds=None,
                            head0: int = 0):
    """Launch the head-major backward kernels: (dq, dk, dv). ``stats``:
    what the training forward returned."""
    _check_hm("fused_attention backward", q, k, v, bias, seeds, dropout_p)
    out, stats = _bwd_out("fused_attention backward", q, out, stats)
    _build.check_inputs("fused_attention backward", out, stats, dout,
                        dtype=(FP32, FP32, q.dtype))
    _check_aligned("fused_attention backward", out, dout)
    B, H, Tq, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            stats.shape != (B, H, Tq, 2):
        raise ValueError("fused_attention backward: bad shapes "
                         f"out{tuple(out.shape)} stats{tuple(stats.shape)} "
                         f"dout{tuple(dout.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(stats.shape[:-1], dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        rc = _build.entry("daspeech_attention_hm_bwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            *_drop_args(dropout_p, seeds), out.data_ptr(), stats.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), B, Tq, k.shape[2], H, HEAD_DIM,
            float(sm_scale), _build.stream_of(q), int(head0))
    _build.check(rc, "daspeech_attention_hm_bwd")
    attention_hm_bwd_kernel.launches += 1
    attention_hm_bwd_kernel.bf16_launches += q.dtype == BF16
    return dq, dk, dv


class _HeadMajorAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale, dropout_p, seeds, head0):
        ctx.cfg = (sm_scale, dropout_p, head0)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, bias, seeds)
            return attention_hm_plain(q, k, v, bias, sm_scale, dropout_p,
                                      seeds, head0)
        out, stats = attention_hm_fwd_kernel(
            q, k, v, bias, sm_scale, dropout_p, seeds,
            with_stats=any(ctx.needs_input_grad), head0=head0)
        ctx.save_for_backward(q, k, v, bias, seeds, out, *_flat(stats))
        return out

    @staticmethod
    def backward(ctx, dout):
        sm_scale, dropout_p, head0 = ctx.cfg
        q, k, v, bias, seeds, *saved = ctx.saved_tensors
        dout = dout.contiguous()
        if q.device.type == "cpu":
            grads = attention_hm_bwd_plain(q, k, v, bias, dout, sm_scale,
                                           dropout_p, seeds, head0)
        else:
            out, stats = _unflat(saved)
            grads = attention_hm_bwd_kernel(q, k, v, bias, out, stats, dout,
                                            sm_scale, dropout_p, seeds,
                                            head0)
        return (*grads, None, None, None, None, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, sm_scale: float = 1.0,
                    dropout_p: float = 0.0,
                    seeds: Optional[torch.Tensor] = None,
                    head0: int = 0) -> torch.Tensor:
    """Head-major attention (see :func:`attention_hm_plain`),
    differentiable in q, k and v; ``head0`` as in
    :func:`fused_attention_packed`.

    CPU tensors take the plain versions. CUDA tensors launch the kernels,
    which take fp32 or bf16, contiguous [B, H, T, 64] q, k, v, an fp32 bias
    (and int32 seeds with dropout), and raise on anything else; the output
    and the gradients have q's dtype."""
    return _HeadMajorAttention.apply(q, k, v, bias, sm_scale, dropout_p,
                                     seeds, head0)


fused_attention.launches = 0
fused_attention.train_launches = 0
fused_attention.bf16_launches = 0
attention_hm_bwd_kernel.launches = 0
attention_hm_bwd_kernel.bf16_launches = 0


def attention_full_bias_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias4: torch.Tensor,
                              sm_scale: float = 1.0, dropout_p: float = 0.0,
                              seed: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """dropout(softmax(q kᵀ·sm_scale + bias4)) v on head-major q
    [B, H, Tq, d], k/v [B, H, Tk, d] with a full additive bias4
    [B, H, Tq, Tk]; with ``dropout_p`` > 0 the probabilities take the
    Philox mask of the one int32 ``seed``."""
    if q.dtype == BF16:
        return _bf16_plain(attention_full_bias_plain, q, k, v, bias4,
                           sm_scale, dropout_p, seed)
    B, H, Tq, _ = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    p = torch.softmax(s + bias4, dim=-1)
    if dropout_p > 0.0:
        p = p * full_bias_keep(seed, B, H, Tq, k.shape[2], dropout_p)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def mha_reference_full_bias(q, k, v, bias4, sm_scale: float):
    """The no-dropout oracle of the full-bias path (the JAX oracle's
    name, ``fused_attention.py:726``)."""
    return attention_full_bias_plain(q, k, v, bias4, sm_scale)


def attention_full_bias_bwd_plain(q, k, v, bias4, dout, sm_scale: float = 1.0,
                                  dropout_p: float = 0.0,
                                  seed: Optional[torch.Tensor] = None):
    """(dq, dk, dv, dbias) of :func:`attention_full_bias_plain` for the
    cotangent ``dout``; dbias = dS = P∘(Z∘(dO Vᵀ) − rowsum(P∘Z∘(dO Vᵀ))),
    the pre-dropout P as in ``fused_attention.py:633``. bf16 operands:
    bf16 dq, dk, dv and an fp32 dbias."""
    if q.dtype == BF16:
        dq, dk, dv, ds = attention_full_bias_bwd_plain(
            q.float(), k.float(), v.float(), bias4, dout.float(), sm_scale,
            dropout_p, seed)
        return dq.to(BF16), dk.to(BF16), dv.to(BF16), ds
    B, H, Tq, _ = q.shape
    Tk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    p = torch.softmax(s + bias4, dim=-1)
    z = (full_bias_keep(seed, B, H, Tq, Tk, dropout_p)
         if dropout_p > 0.0 else torch.ones_like(p))
    dv = torch.einsum("bhqk,bhqd->bhkd", p * z, dout)
    dp = z * torch.einsum("bhqd,bhkd->bhqk", dout, v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * sm_scale
    return dq, dk, dv, ds


def _check_fb(name, q, k, v, bias4, seed, dropout_p):
    drop = () if dropout_p == 0.0 else (seed,)
    dt = operand_dtype(name, q)
    _build.check_inputs(name, q, k, v, bias4, int32=drop,
                        dtype=(dt, dt, dt, FP32))
    _check_aligned(name, q, k, v, bias4)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: takes [B, H, T, d] q, k, v")
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    if d != HEAD_DIM:
        raise ValueError(f"{name}: head depth {d} unsupported "
                         f"(kernel takes {HEAD_DIM})")
    if (k.shape != (B, H, Tk, d) or v.shape != k.shape
            or bias4.shape != (B, H, Tq, Tk) or Tq < 1 or Tk < 1
            or (drop and seed.numel() != 1)):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"bias4{tuple(bias4.shape)}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"{name}: dropout_p {dropout_p} not in [0, 1)")


def attention_fb_fwd_kernel(q, k, v, bias4, sm_scale: float,
                            dropout_p: float = 0.0, seed=None,
                            with_stats: bool = False):
    """Launch the full-bias forward kernel: (out [B, H, Tq, d], stats) with
    stats the [B, H, Tq, 2] row softmax (max, sum) (bf16 operands: the pair
    (stats, out32)), or None."""
    _check_fb("fused_attention_full_bias", q, k, v, bias4, seed, dropout_p)
    B, H, Tq, _ = q.shape
    out, stats, out32 = _fwd_outputs(q, H, Tq, with_stats)
    extra = () if q.dtype == FP32 else (_build.ptr(out32),)
    with torch.cuda.device(q.device):
        rc = _build.entry("daspeech_attention_fb_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias4.data_ptr(),
            *_drop_args(dropout_p, seed), out.data_ptr(), _build.ptr(stats),
            *extra, B, Tq, k.shape[2], H, HEAD_DIM, float(sm_scale),
            _build.stream_of(q))
    _build.check(rc, "daspeech_attention_fb_fwd")
    attention_fb_fwd_kernel.launches += 1
    attention_fb_fwd_kernel.bf16_launches += q.dtype == BF16
    return out, _saved(stats, out32)


def attention_fb_bwd_kernel(q, k, v, bias4, out, stats, dout, sm_scale: float,
                            dropout_p: float = 0.0, seed=None):
    """Launch the full-bias backward kernels: (dq, dk, dv, dbias)."""
    _check_fb("fused_attention_full_bias backward", q, k, v, bias4, seed,
              dropout_p)
    out, stats = _bwd_out("fused_attention_full_bias backward", q, out,
                          stats)
    _build.check_inputs("fused_attention_full_bias backward", out, stats,
                        dout, dtype=(FP32, FP32, q.dtype))
    _check_aligned("fused_attention_full_bias backward", out, dout)
    B, H, Tq, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            stats.shape != (B, H, Tq, 2):
        raise ValueError("fused_attention_full_bias backward: bad shapes "
                         f"out{tuple(out.shape)} stats{tuple(stats.shape)} "
                         f"dout{tuple(dout.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(bias4)
    # delta [B, H, Tq], then P∘Z [B, H, Tq, Tk]
    scratch = _bwd_scratch(B * H * Tq, B * H * Tq * k.shape[2], q.device)
    with torch.cuda.device(q.device):
        rc = _build.entry("daspeech_attention_fb_bwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias4.data_ptr(),
            *_drop_args(dropout_p, seed), out.data_ptr(), stats.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dbias.data_ptr(), scratch.data_ptr(), B, Tq, k.shape[2], H,
            HEAD_DIM, float(sm_scale), _build.stream_of(q))
    _build.check(rc, "daspeech_attention_fb_bwd")
    attention_fb_bwd_kernel.launches += 1
    attention_fb_bwd_kernel.bf16_launches += q.dtype == BF16
    return dq, dk, dv, dbias


class _FullBiasAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias4, seed, sm_scale, dropout_p):
        ctx.cfg = (sm_scale, dropout_p)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, bias4, seed)
            return attention_full_bias_plain(q, k, v, bias4, sm_scale,
                                             dropout_p, seed)
        out, stats = attention_fb_fwd_kernel(
            q, k, v, bias4, sm_scale, dropout_p, seed,
            with_stats=any(ctx.needs_input_grad))
        ctx.save_for_backward(q, k, v, bias4, seed, out, *_flat(stats))
        return out

    @staticmethod
    def backward(ctx, dout):
        sm_scale, dropout_p = ctx.cfg
        q, k, v, bias4, seed, *saved = ctx.saved_tensors
        dout = dout.contiguous()
        if q.device.type == "cpu":
            grads = attention_full_bias_bwd_plain(q, k, v, bias4, dout,
                                                  sm_scale, dropout_p, seed)
        else:
            out, stats = _unflat(saved)
            grads = attention_fb_bwd_kernel(q, k, v, bias4, out, stats, dout,
                                            sm_scale, dropout_p, seed)
        return (*grads, None, None, None)


def fused_attention_full_bias(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias4: torch.Tensor, seed,
                              sm_scale: float, dropout_p: float,
                              train: bool) -> torch.Tensor:
    """Head-major attention with a full additive bias4 [B, H, Tq, Tk] (see
    :func:`attention_full_bias_plain`), differentiable in q, k, v and bias4;
    JAX's argument order. ``seed`` is an int or a one-element int32 tensor,
    used only when ``train`` and ``dropout_p`` > 0.

    CPU tensors take the plain versions. CUDA tensors launch the kernels,
    which take fp32 or bf16, contiguous [B, H, T, 64] q, k, v (head depth
    64 only, as the other attention kernels) and a contiguous fp32 bias4,
    and raise on anything else; bf16 q, k, v give a bf16 output and
    gradients and an fp32 bias gradient."""
    p = float(dropout_p) if train and dropout_p > 0.0 else 0.0
    seed_t = None
    if p > 0.0:
        seed_t = torch.as_tensor(seed, dtype=torch.int32,
                                 device=q.device).reshape(1)
    return _FullBiasAttention.apply(q, k, v, bias4, seed_t, sm_scale, p)


attention_fb_fwd_kernel.launches = 0
attention_fb_fwd_kernel.bf16_launches = 0
attention_fb_bwd_kernel.launches = 0
attention_fb_bwd_kernel.bf16_launches = 0
