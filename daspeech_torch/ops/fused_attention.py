"""Packed multi-head attention: plain PyTorch version and the CUDA kernel.

Counterpart of ``daspeech_tpu/ops/fused_attention.py``. The CUDA kernel
(``csrc/fused_attention.cu``) replaces the Pallas ``fused_attention_packed``
(``fused_attention.py:522``, kernel ``_attn_kernel_packed`` at :285), forward
only; it streams keys, so it also covers the long-sequence shapes for which
the JAX layer dispatches to the head-major ``fused_attention`` (:189).

:func:`fused_attention_packed` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; there is no fallback between the two.
"""

from __future__ import annotations

import torch

from daspeech_torch.ops import _build

NEG = -1e30          # additive bias of a padded key (fused_attention.py:33)
HEAD_DIM = 64        # the one head depth the kernel is built for


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, num_heads: int,
                    sm_scale: float = 1.0) -> torch.Tensor:
    """softmax(q_h k_hᵀ·sm_scale + bias[b]) v_h per head on packed
    q [B, Tq, H·d], k/v [B, Tk, H·d], bias [B, Tk] -> [B, Tq, H·d]."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    d = C // num_heads
    qh = q.reshape(B, Tq, num_heads, d)
    kh = k.reshape(B, Tk, num_heads, d)
    vh = v.reshape(B, Tk, num_heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * sm_scale
    p = torch.softmax(s + bias[:, None, None, :], dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(B, Tq, C)


def fused_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, num_heads: int,
                           sm_scale: float = 1.0) -> torch.Tensor:
    """Packed-layout attention forward (see :func:`attention_plain`).

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes fp32, contiguous inputs with head depth 64, and raises on
    anything else."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, num_heads, sm_scale)
    B, Tq, C = q.shape
    Tk = k.shape[1]
    _build.check_inputs("fused_attention_packed", q, k, v, bias)
    if C % num_heads or C // num_heads != HEAD_DIM:
        raise ValueError(f"fused_attention_packed: head depth "
                         f"{C / num_heads} unsupported (kernel takes "
                         f"{HEAD_DIM})")
    if (k.shape != (B, Tk, C) or v.shape != k.shape
            or bias.shape != (B, Tk) or Tq < 1 or Tk < 1):
        raise ValueError(f"fused_attention_packed: bad shapes q{tuple(q.shape)}"
                         f" k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"bias{tuple(bias.shape)}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _build.library().daspeech_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, Tq, Tk, num_heads, HEAD_DIM, float(sm_scale),
            _build.stream_of(q))
    _build.check(rc, "daspeech_attention_fwd")
    fused_attention_packed.launches += 1
    return out


fused_attention_packed.launches = 0

