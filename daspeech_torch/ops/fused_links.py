"""DAG link extraction: plain PyTorch version and the CUDA kernel.

Counterpart of ``daspeech_tpu/ops/fused_links.py``. The CUDA kernels
(``csrc/fused_links.cu``) replace the Pallas ``fused_extract_links``
(``fused_links.py:141``: forward ``_links_fwd_kernel`` at :70, backward
``_links_bwd_kernel`` at :91). The plain versions build the [B, L, L, H]
score tensor; the kernels visit only the 64 x 64 tiles that hold a valid
transition, keep each head's score tile in registers and write only the
per-head row log-sum-exp and the [B, L, L] result (forward, on the fp32
FMA pipes) or dq, dk and dgates (backward, on the tensor cores).

:func:`fused_extract_links` is differentiable in q, k and log_gates. CPU
tensors take the plain versions, CUDA tensors the kernels; there is no
fallback between the two.

bf16: the kernels also take bf16 q and k (log_gates stays fp32) through the
``_bf16`` variants of their C entry points: they compute in fp32, write fp32
links and lse, and return bf16 dq and dk with fp32 dgates, as the Pallas
kernel does (``fused_links.py:62-66``, ``:177-199``); the plain versions
upcast q and k and cast dq and dk back.
"""

from __future__ import annotations

from typing import Optional

import torch

from daspeech_torch.ops import _build
from daspeech_torch.ops.fused_attention import BF16, FP32, operand_dtype

NEG_FLOOR = -1e9
HEAD_DIM = 64
MAX_L = 1024         # max_target_positions (the kernels have no cap)


def _valid(L, output_length, mtl, device):
    i_idx = torch.arange(L, device=device)[None, :, None]
    j_idx = torch.arange(L, device=device)[None, None, :]
    valid = (j_idx > i_idx) & (j_idx < output_length[:, None, None])
    if mtl is not None:
        valid = valid & ((j_idx - i_idx) <= mtl)
    return valid


def _floored_scores(q, k, valid, num_heads, scale):
    """[B, L, L, H] per-head scores, -1e9 where invalid."""
    B, L, C = q.shape
    qh = q.reshape(B, L, num_heads, C // num_heads)
    kh = k.reshape(B, L, num_heads, C // num_heads)
    scores = torch.einsum("bihd,bjhd->bijh", qh, kh) * scale
    return torch.where(valid[..., None], scores,
                       torch.full_like(scores, NEG_FLOOR))


def links_plain(q: torch.Tensor, k: torch.Tensor, log_gates: torch.Tensor,
                output_length: torch.Tensor, num_heads: int, scale: float,
                mtl: Optional[int]) -> torch.Tensor:
    """links [B, L, L] f32: per-head masked row log-softmax of q_h k_hᵀ·scale
    (-1e9 floor) plus ``log_gates[i, h]``, logsumexp over heads, -inf where
    (j > i) ∧ (j < output_length) [∧ j - i <= mtl] fails. bf16 q and k are
    upcast; the links stay f32."""
    if q.dtype == BF16:
        q, k = q.float(), k.float()
    valid = _valid(q.shape[1], output_length, mtl, q.device)
    scores = _floored_scores(q, k, valid, num_heads, scale)
    log_attn = scores - torch.logsumexp(scores, dim=2, keepdim=True)
    links = torch.logsumexp(log_attn + log_gates[:, :, None, :], dim=-1)
    return torch.where(valid, links, torch.full_like(links, -torch.inf))


def links_bwd_plain(q, k, log_gates, output_length, dlinks, num_heads: int,
                    scale: float, mtl: Optional[int]):
    """(dq, dk, dgates) of :func:`links_plain` for the cotangent
    ``dlinks``, in closed form: with G = dlinks on the valid entries and the
    head posterior p_h = exp(s_h - lse_h + g_h - links),
    dgates_h = Σ_j p_h G, dS_h = (p_h G - softmax_j(s_h)·dgates_h)·scale on
    the valid entries (the -1e9 floor is a constant), dq_h = dS_h k_h,
    dk_h = dS_hᵀ q_h. bf16 q and k: computed on their upcast values, dq and
    dk cast back to bf16 (dgates f32)."""
    if q.dtype == BF16:
        dq, dk, r = links_bwd_plain(q.float(), k.float(), log_gates,
                                    output_length, dlinks, num_heads, scale,
                                    mtl)
        return dq.to(BF16), dk.to(BF16), r
    B, L, C = q.shape
    valid = _valid(L, output_length, mtl, q.device)
    scores = _floored_scores(q, k, valid, num_heads, scale)      # [B,L,L,H]
    log_soft = scores - torch.logsumexp(scores, dim=2, keepdim=True)
    links = torch.logsumexp(log_soft + log_gates[:, :, None, :], dim=-1)
    post = torch.exp(log_soft + log_gates[:, :, None, :] - links[..., None])
    pg = post * torch.where(valid, dlinks, torch.zeros_like(dlinks))[..., None]
    r = pg.sum(dim=2)                                           # [B, L, H]
    ds = torch.where(valid[..., None],
                     (pg - torch.exp(log_soft) * r[:, :, None, :]) * scale,
                     torch.zeros_like(pg))
    qh = q.reshape(B, L, num_heads, -1)
    kh = k.reshape(B, L, num_heads, -1)
    dq = torch.einsum("bijh,bjhd->bihd", ds, kh).reshape(B, L, C)
    dk = torch.einsum("bijh,bihd->bjhd", ds, qh).reshape(B, L, C)
    return dq, dk, r


def _check(name, q, k, log_gates, ol, num_heads):
    B, L, C = q.shape
    dt = operand_dtype(name, q)
    _build.check_inputs(name, q, k, log_gates, int32=(ol,),
                        dtype=(dt, dt, FP32))
    if C % num_heads or C // num_heads != HEAD_DIM or not 1 <= L <= MAX_L:
        raise ValueError(f"{name}: d={C / num_heads}, L={L} unsupported "
                         f"(kernel takes d={HEAD_DIM}, L <= {MAX_L})")
    if (k.shape != q.shape or log_gates.shape != (B, L, num_heads)
            or ol.shape != (B,)):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} "
                         f"log_gates{tuple(log_gates.shape)}")


def links_fwd_kernel(q, k, log_gates, output_length, num_heads: int,
                     scale: float, mtl: Optional[int],
                     with_lse: bool = False):
    """Launch the forward kernels: (links, lse_h [B, L, H] or None). The
    kernels always write lse_h (the second reads it); it is returned only
    ``with_lse``."""
    B, L, C = q.shape
    ol = output_length.to(torch.int32).contiguous()
    _check("fused_extract_links", q, k, log_gates, ol, num_heads)
    links = torch.empty((B, L, L), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, L, num_heads), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        rc = _build.entry("daspeech_links_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), log_gates.data_ptr(), ol.data_ptr(),
            links.data_ptr(), lse.data_ptr(), B, L, num_heads, HEAD_DIM,
            float(scale), -1 if mtl is None else int(mtl),
            _build.stream_of(q))
    _build.check(rc, "daspeech_links_fwd")
    fused_extract_links.launches += 1
    fused_extract_links.bf16_launches += q.dtype == BF16
    return links, (lse if with_lse else None)


def links_bwd_kernel(q, k, log_gates, output_length, links, lse, dlinks,
                     num_heads: int, scale: float, mtl: Optional[int]):
    """Launch the backward kernels: (dq, dk, dgates)."""
    B, L, C = q.shape
    ol = output_length.to(torch.int32).contiguous()
    _check("fused_extract_links backward", q, k, log_gates, ol, num_heads)
    _build.check_inputs("fused_extract_links backward", links, lse, dlinks)
    if (links.shape != (B, L, L) or dlinks.shape != links.shape
            or lse.shape != (B, L, num_heads)):
        raise ValueError("fused_extract_links backward: bad shapes "
                         f"links{tuple(links.shape)} lse{tuple(lse.shape)} "
                         f"dlinks{tuple(dlinks.shape)}")
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    dg = torch.empty_like(log_gates)         # f32, as log_gates
    with torch.cuda.device(q.device):
        rc = _build.entry("daspeech_links_bwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), log_gates.data_ptr(), ol.data_ptr(),
            links.data_ptr(), lse.data_ptr(), dlinks.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dg.data_ptr(), B, L, num_heads,
            HEAD_DIM, float(scale), -1 if mtl is None else int(mtl),
            _build.stream_of(q))
    _build.check(rc, "daspeech_links_bwd")
    links_bwd_kernel.launches += 1
    links_bwd_kernel.bf16_launches += q.dtype == BF16
    return dq, dk, dg


class _ExtractLinks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, log_gates, output_length, num_heads, scale, mtl):
        ctx.cfg = (num_heads, scale, mtl)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, log_gates, output_length)
            return links_plain(q, k, log_gates, output_length, num_heads,
                               scale, mtl)
        links, lse = links_fwd_kernel(q, k, log_gates, output_length,
                                      num_heads, scale, mtl,
                                      with_lse=any(ctx.needs_input_grad))
        ctx.save_for_backward(q, k, log_gates, output_length, links, lse)
        return links

    @staticmethod
    def backward(ctx, dlinks):
        num_heads, scale, mtl = ctx.cfg
        q, k, log_gates, output_length, *saved = ctx.saved_tensors
        dlinks = dlinks.contiguous()
        if q.device.type == "cpu":
            grads = links_bwd_plain(q, k, log_gates, output_length, dlinks,
                                    num_heads, scale, mtl)
        else:
            links, lse = saved
            grads = links_bwd_kernel(q, k, log_gates, output_length, links,
                                     lse, dlinks, num_heads, scale, mtl)
        return (*grads, None, None, None, None)


def fused_extract_links(q: torch.Tensor, k: torch.Tensor,
                        log_gates: torch.Tensor, output_length: torch.Tensor,
                        num_heads: int, scale: float,
                        mtl: Optional[int]) -> torch.Tensor:
    """Link extraction (see :func:`links_plain`), differentiable in q, k
    and log_gates.

    CPU tensors take the plain versions. CUDA tensors launch the kernels,
    which take fp32 or bf16 q/k (one dtype) with head depth 64, L <= 1024,
    fp32 log_gates, and raise on anything else. The links are fp32 either
    way."""
    return _ExtractLinks.apply(q, k, log_gates, output_length, num_heads,
                               scale, mtl)


fused_extract_links.launches = 0
fused_extract_links.bf16_launches = 0        # of launches, the bf16 ones
links_bwd_kernel.launches = 0
links_bwd_kernel.bf16_launches = 0
