"""The Conformer macaron FFN in one op: LayerNorm -> W1 -> swish -> dropout
-> W2 -> dropout, plain PyTorch version and CUDA kernels.

Counterpart of ``daspeech_tpu/ops/fused_ffn.py``. The CUDA kernels
(``csrc/fused_ffn.cu``; bf16: ``csrc/ffn_bf16.cuh``) replace its Pallas
kernels (:175 ``fused_ffn``: forward ``_ffn_fwd_kernel`` at :59, backward
``_ffn_bwd_kernel`` at :84). Every product runs on the tensor cores (fp32:
3xTF32; bf16: bf16 MMAs with fp32 sums). A thread-block cluster of
up to 8 blocks owns 32 rows and splits F between its blocks, whose partial
sums meet in distributed shared memory in a fixed order; the forward keeps
the [T, F] intermediate on the chip; the backward recomputes LayerNorm,
the first product and the masks and sums the weight gradients over all B·T
rows in a fixed order (no atomics: two runs give the same bits).

Weight layout: ``w1`` is ``w_1.weight`` [F, C] and ``w2`` is ``w_2.weight``
[C, F], ``nn.Linear``'s layout (the transposes of JAX's kernels [C, F] and
[F, C]); the kernels read the module's tensors in place, with no copy.

Dropout: site 1 after the swish ([T, F]) and site 2 after the second
product ([T, C]) take the Philox masks of ``philox.ffn_keep``, keyed by
per-row int32 seeds [B]; the kernels draw the same bits, so kernel and
plain version agree element for element with dropout on, and the backward
replays the forward's masks.

bf16: with bf16 x, w1, b1, w2 and b2 (gamma and beta fp32) the kernels
read the bf16 tensors in place and take each product's operands as bf16
where the Pallas kernels cast them (``fused_ffn.py:70-78``, ``:102-128``):
y before W1 and h before W2; in the backward g, h·m1, gpre and y before
their products. LayerNorm, the swish, the masks and the bias and column
sums stay fp32 (db1 sums the unrounded gpre, db2 the unrounded g); out and
dx are bf16, the parameter gradients fp32, and the backward's scratch
(y, g, h·m1, gpre) bf16. The plain versions round at the same points.

CPU tensors take the plain versions; CUDA tensors launch the kernels, which
take fp32 or bf16 (as above), contiguous tensors of width C = 256 (the
recipe's), any T and any F, and raise on anything else. Like the JAX op it
is a verified alternate backend: ``FeedForwardModule(fused=True)`` reaches
it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from daspeech_torch.ops import _build
from daspeech_torch.ops.philox import ffn_keep, keep_threshold

LN_EPS = 1e-6        # flax nn.LayerNorm's default, as the module
WIDTH = 256          # the one model width C the kernels are built for
ROW_TILE = 32        # rows per cluster of the kernels (csrc/fused_ffn.cu BM)
SLICE_ROWS = 1024    # about this many rows per slice of the dW sums
BF16_ROW_ALIGN = 8   # the bf16 [N, F] scratch's rows are padded to this


def _masks(seeds, T, C, Fd, p1, p2):
    m1 = ffn_keep(seeds, T, Fd, 1, p1) if p1 > 0.0 else None
    m2 = ffn_keep(seeds, T, C, 2, p2) if p2 > 0.0 else None
    return m1, m2


def _rounding(x: torch.Tensor):
    """(the operands widened to fp32, the rounding of a product's operand):
    bf16 round trips for bf16 x, identities otherwise."""
    if x.dtype != torch.bfloat16:
        return (lambda t: t), (lambda t: t)
    return (lambda t: t.float()), (lambda t: t.to(x.dtype).float())


def ffn_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, seeds: Optional[torch.Tensor] = None,
              p1: float = 0.0, p2: float = 0.0) -> torch.Tensor:
    """x [B, T, C] -> LN(gamma, beta; eps 1e-6) -> ·w1ᵀ + b1 -> swish ->
    mask 1 -> ·w2ᵀ + b2 -> mask 2, with w1 [F, C] and w2 [C, F]; a site with
    p > 0 takes the Philox mask of the int32 per-row ``seeds`` [B]. bf16
    x (and weights): y and h rounded to bf16 before their products, the
    output rounded to bf16 (module docstring)."""
    _, T, C = x.shape
    wide, rnd = _rounding(x)
    m1, m2 = _masks(seeds, T, C, w1.shape[0], p1, p2)
    y = rnd(F.layer_norm(wide(x), (C,), gamma, beta, LN_EPS))
    h = F.silu(F.linear(y, wide(w1), wide(b1)))
    if m1 is not None:
        h = h * m1
    out = F.linear(rnd(h), wide(w2), wide(b2))
    out = out if m2 is None else out * m2
    return out.to(x.dtype)


def ffn_bwd_plain(x, gamma, beta, w1, b1, w2, b2, dout,
                  seeds: Optional[torch.Tensor] = None, p1: float = 0.0,
                  p2: float = 0.0):
    """(dx, dgamma, dbeta, dw1, db1, dw2, db2) of :func:`ffn_plain` for the
    cotangent ``dout``, in closed form (``fused_ffn.py:93-149``): g = dout·m2,
    dW2 = gᵀ(h·m1), gpre = (g w2)·m1·swish'(pre), dW1 = gpreᵀ y,
    gy = gpre w1, and LayerNorm's backward. bf16 x (and weights): g, h·m1,
    gpre and y rounded to bf16 before their products, dx rounded to bf16,
    the parameter gradients fp32 (the sums of the unrounded g and gpre)."""
    B, T, C = x.shape
    Fd = w1.shape[0]
    wide, rnd = _rounding(x)
    dtype = x.dtype
    x, w1, b1, w2, dout = (wide(t) for t in (x, w1, b1, w2, dout))
    m1, m2 = _masks(seeds, T, C, Fd, p1, p2)
    mu = x.mean(-1, keepdim=True)
    r = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + LN_EPS)
    xhat = (x - mu) * r
    y = rnd(xhat * gamma + beta)
    pre = F.linear(y, w1, b1)
    s = torch.sigmoid(pre)
    hd = pre * s if m1 is None else pre * s * m1
    g = dout if m2 is None else dout * m2
    gh = rnd(g) @ w2
    if m1 is not None:
        gh = gh * m1
    gpre = gh * (s * (1.0 + pre * (1.0 - s)))
    dw2 = rnd(g).reshape(-1, C).t() @ rnd(hd).reshape(-1, Fd)
    dw1 = rnd(gpre).reshape(-1, Fd).t() @ y.reshape(-1, C)
    gy = rnd(gpre) @ w1
    dxhat = gy * gamma
    dx = r * (dxhat - dxhat.mean(-1, keepdim=True)
              - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return (dx.to(dtype), (gy * xhat).sum((0, 1)), gy.sum((0, 1)), dw1,
            gpre.sum((0, 1)), dw2, g.sum((0, 1)))


def _check(name, x, gamma, beta, w1, b1, w2, b2, seeds, p1, p2, extra=()):
    drop = (seeds,) if (p1 > 0.0 or p2 > 0.0) else ()
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: kernel takes float32 or bfloat16 x, got "
                        f"{dt}")
    _build.check_inputs(name, x, gamma, beta, w1, b1, w2, b2, *extra,
                        int32=drop,
                        dtype=(dt, torch.float32, torch.float32, dt, dt, dt,
                               dt, *(dt for _ in extra)))
    if x.dim() != 3:
        raise ValueError(f"{name}: takes [B, T, C] x, got {tuple(x.shape)}")
    B, T, C = x.shape
    Fd = w1.shape[0]
    if C != WIDTH:
        raise ValueError(f"{name}: width {C} unsupported (kernel takes "
                         f"{WIDTH})")
    if (gamma.shape != (C,) or beta.shape != (C,) or w1.shape != (Fd, C)
            or b1.shape != (Fd,) or w2.shape != (C, Fd) or b2.shape != (C,)
            or T < 1 or Fd < 1 or any(t.shape != x.shape for t in extra)
            or (drop and seeds.shape != (B,))):
        raise ValueError(f"{name}: bad shapes x{tuple(x.shape)} "
                         f"w1{tuple(w1.shape)} w2{tuple(w2.shape)}")
    for p in (p1, p2):
        if not 0.0 <= p < 1.0:
            raise ValueError(f"{name}: dropout p {p} not in [0, 1)")


def _drop_args(seeds, p1, p2):
    """(seeds, on1, thresh1, scale1, on2, thresh2, scale2) of the C entry
    points."""
    def site(p):
        return (1, keep_threshold(p), 1.0 / (1.0 - p)) if p > 0.0 \
            else (0, 0, 1.0)

    on = p1 > 0.0 or p2 > 0.0
    return (seeds.data_ptr() if on else 0, *site(p1), *site(p2))


def ffn_fwd_kernel(x, gamma, beta, w1, b1, w2, b2, seeds=None,
                   p1: float = 0.0, p2: float = 0.0) -> torch.Tensor:
    """Launch the forward kernel: out [B, T, C]."""
    _check("fused_ffn", x, gamma, beta, w1, b1, w2, b2, seeds, p1, p2)
    B, T, C = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _build.entry("daspeech_ffn_fwd", x.dtype)(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            *_drop_args(seeds, p1, p2), out.data_ptr(), B, T, C,
            w1.shape[0], _build.stream_of(x))
    _build.check(rc, "daspeech_ffn_fwd")
    ffn_fwd_kernel.launches += 1
    ffn_fwd_kernel.bf16_launches += x.dtype == torch.bfloat16
    return out


def ffn_bwd_kernel(x, gamma, beta, w1, b1, w2, b2, dout, seeds=None,
                   p1: float = 0.0, p2: float = 0.0):
    """Launch the backward kernels: (dx, dgamma, dbeta, dw1, db1, dw2,
    db2). Scratch: y and g [N, C], h·m1 and gpre [N, F] (N = B·T; bf16 x:
    bf16, and [N, F rounded up to 8]), the row tiles' column sums and the
    dW slices' partial sums."""
    _check("fused_ffn backward", x, gamma, beta, w1, b1, w2, b2, seeds, p1,
           p2, extra=(dout,))
    B, T, C = x.shape
    Fd = w1.shape[0]
    N = B * T
    S = math.ceil(N / SLICE_ROWS)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=x.device)
    dx = torch.empty_like(x)
    grads = (new(C), new(C), new(Fd, C), new(Fd), new(C, Fd), new(C))
    if x.dtype == torch.bfloat16:
        Fp = -(-Fd // BF16_ROW_ALIGN) * BF16_ROW_ALIGN
        acts = tuple(torch.empty(N, w, dtype=x.dtype, device=x.device)
                     for w in (C, C, Fp, Fp))
    else:
        acts = (new(N, C), new(N, C), new(N, Fd), new(N, Fd))
    scratch = (*acts, new(math.ceil(N / ROW_TILE), Fd + 3 * C),
               new(2, S, Fd * C))
    with torch.cuda.device(x.device):
        rc = _build.entry("daspeech_ffn_bwd", x.dtype)(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), dout.data_ptr(),
            *_drop_args(seeds, p1, p2), dx.data_ptr(),
            *(t.data_ptr() for t in grads), *(t.data_ptr() for t in scratch),
            B, T, C, Fd, S, _build.stream_of(x))
    _build.check(rc, "daspeech_ffn_bwd")
    ffn_bwd_kernel.launches += 1
    ffn_bwd_kernel.bf16_launches += x.dtype == torch.bfloat16
    return (dx, *grads)


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, seeds, p1, p2):
        ctx.cfg = (p1, p2)
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2, seeds)
        if x.device.type == "cpu":
            return ffn_plain(x, gamma, beta, w1, b1, w2, b2, seeds, p1, p2)
        return ffn_fwd_kernel(x, gamma, beta, w1, b1, w2, b2, seeds, p1, p2)

    @staticmethod
    def backward(ctx, dout):
        p1, p2 = ctx.cfg
        *params, seeds = ctx.saved_tensors
        dout = dout.contiguous()
        bwd = ffn_bwd_plain if dout.device.type == "cpu" else ffn_bwd_kernel
        return (*bwd(*params, dout, seeds, p1, p2), None, None, None)


def fused_ffn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, seed, p1: float, p2: float,
              train: bool) -> torch.Tensor:
    """The FFN of :func:`ffn_plain`, differentiable in x and every
    parameter; JAX's argument order. ``seed`` is an int, or int32 per-row
    seeds [B] (a scalar s gives row b the seed s + b, as JAX's
    ``_norm_seeds``), used only when ``train`` and p > 0. x, w1, b1, w2
    and b2 are all fp32 or all bf16 (gamma and beta fp32; see the module
    docstring); the gradients of bf16 weights come back in bf16, as
    autograd casts a gradient to its input's dtype."""
    p1 = float(p1) if train else 0.0
    p2 = float(p2) if train else 0.0
    seeds = None
    if p1 > 0.0 or p2 > 0.0:
        seeds = torch.as_tensor(seed, dtype=torch.int32, device=x.device)
        if seeds.dim() == 0:
            seeds = seeds + torch.arange(x.shape[0], dtype=torch.int32,
                                         device=x.device)
    return _FusedFFN.apply(x, gamma, beta, w1, b1, w2, b2, seeds, p1, p2)


ffn_fwd_kernel.launches = 0
ffn_fwd_kernel.bf16_launches = 0
ffn_bwd_kernel.launches = 0
ffn_bwd_kernel.bf16_launches = 0
