"""DAG link extraction: plain PyTorch version and the CUDA kernel.

Counterpart of ``daspeech_tpu/ops/fused_links.py``. The CUDA kernel
(``csrc/fused_links.cu``) replaces the Pallas ``fused_extract_links``
(``fused_links.py:141``, kernel ``_links_fwd_kernel`` at :70), forward only.
The plain version builds the [B, L, L, H] score tensor; the kernel keeps
each head's scores in registers and writes only the [B, L, L] result.
"""

from __future__ import annotations

from typing import Optional

import torch

from daspeech_torch.ops import _build

NEG_FLOOR = -1e9
HEAD_DIM = 64
MAX_L = 1024         # max_target_positions; the kernel's register arrays


def links_plain(q: torch.Tensor, k: torch.Tensor, log_gates: torch.Tensor,
                output_length: torch.Tensor, num_heads: int, scale: float,
                mtl: Optional[int]) -> torch.Tensor:
    """links [B, L, L] f32: per-head masked row log-softmax of q_h k_hᵀ·scale
    (-1e9 floor) plus ``log_gates[i, h]``, logsumexp over heads, -inf where
    (j > i) ∧ (j < output_length) [∧ j - i <= mtl] fails."""
    B, L, C = q.shape
    dk = C // num_heads
    qh = q.reshape(B, L, num_heads, dk)
    kh = k.reshape(B, L, num_heads, dk)
    scores = torch.einsum("bihd,bjhd->bijh", qh, kh) * scale
    i_idx = torch.arange(L, device=q.device)[None, :, None]
    j_idx = torch.arange(L, device=q.device)[None, None, :]
    valid = (j_idx > i_idx) & (j_idx < output_length[:, None, None])
    if mtl is not None:
        valid = valid & ((j_idx - i_idx) <= mtl)
    scores = torch.where(valid[..., None], scores,
                         torch.full_like(scores, NEG_FLOOR))
    log_attn = scores - torch.logsumexp(scores, dim=2, keepdim=True)
    links = torch.logsumexp(log_attn + log_gates[:, :, None, :], dim=-1)
    return torch.where(valid, links, torch.full_like(links, -torch.inf))


def fused_extract_links(q: torch.Tensor, k: torch.Tensor,
                        log_gates: torch.Tensor, output_length: torch.Tensor,
                        num_heads: int, scale: float,
                        mtl: Optional[int]) -> torch.Tensor:
    """Link extraction forward (see :func:`links_plain`).

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes fp32 q/k with head depth 64, L <= 1024, and raises on
    anything else."""
    if q.device.type == "cpu":
        return links_plain(q, k, log_gates, output_length, num_heads, scale,
                           mtl)
    B, L, C = q.shape
    ol = output_length.to(torch.int32).contiguous()
    _build.check_inputs("fused_extract_links", q, k, log_gates, int32=(ol,))
    if C % num_heads or C // num_heads != HEAD_DIM or not 1 <= L <= MAX_L:
        raise ValueError(f"fused_extract_links: d={C / num_heads}, L={L} "
                         f"unsupported (kernel takes d={HEAD_DIM}, "
                         f"L <= {MAX_L})")
    if (k.shape != q.shape or log_gates.shape != (B, L, num_heads)
            or ol.shape != (B,)):
        raise ValueError("fused_extract_links: bad shapes "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"log_gates{tuple(log_gates.shape)}")
    links = torch.empty((B, L, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _build.library().daspeech_links_fwd(
            q.data_ptr(), k.data_ptr(), log_gates.data_ptr(), ol.data_ptr(),
            links.data_ptr(), B, L, num_heads, HEAD_DIM, float(scale),
            -1 if mtl is None else int(mtl), _build.stream_of(q))
    _build.check(rc, "daspeech_links_fwd")
    fused_extract_links.launches += 1
    return links


fused_extract_links.launches = 0
