"""Wrappers of the DAG dynamic-program kernels (``csrc/dag_fb.cu``,
``csrc/dag_viterbi.cu``).

They replace the Pallas ``dag_loss_forward_pallas``
(``daspeech_tpu/ops/dag_pallas.py:108``) and ``dag_best_alignment_pallas``
(``:285``). ``ops/dag_ref.py`` routes CUDA tensors here and CPU tensors to
its plain loops; each wrapper takes contiguous CUDA tensors only and raises
on anything else.
"""

from __future__ import annotations

import torch

from daspeech_torch.ops import _build

MAX_L = 1024         # max_target_positions; the kernels' column arrays


def _prepare(name, match_all, links, output_length, target_length):
    B, T, L = match_all.shape
    ol = output_length.to(torch.int32).contiguous()
    tl = target_length.to(torch.int32).contiguous()
    _build.check_inputs(name, match_all, links, int32=(ol, tl))
    if (links.shape != (B, L, L) or ol.shape != (B,) or tl.shape != (B,)
            or not 1 <= L <= MAX_L or T < 1):
        raise ValueError(f"{name}: bad shapes match{tuple(match_all.shape)} "
                         f"links{tuple(links.shape)} (kernel takes "
                         f"1 <= L <= {MAX_L})")
    return B, T, L, ol, tl


def dag_loss_forward_kernel(match_all: torch.Tensor, links: torch.Tensor,
                            output_length: torch.Tensor,
                            target_length: torch.Tensor):
    """(logprob [B], alpha [B, T, L], beta [B, T, L]) by the alpha/beta
    kernel: one block per sample and sweep."""
    B, T, L, ol, tl = _prepare("dag_loss_forward", match_all, links,
                               output_length, target_length)
    alpha = torch.empty_like(match_all)
    beta = torch.empty_like(match_all)
    with torch.cuda.device(match_all.device):
        rc = _build.library().daspeech_dag_fb(
            match_all.data_ptr(), links.data_ptr(), ol.data_ptr(),
            tl.data_ptr(), alpha.data_ptr(), beta.data_ptr(), B, T, L,
            _build.stream_of(match_all))
    _build.check(rc, "daspeech_dag_fb")
    dag_loss_forward_kernel.launches += 1
    return beta[:, 0, 0], alpha, beta


def dag_best_alignment_kernel(match_all: torch.Tensor, links: torch.Tensor,
                              output_length: torch.Tensor,
                              target_length: torch.Tensor) -> torch.Tensor:
    """Viterbi path [B, L] int32 by the Viterbi kernel; its [B, T, L] int32
    argmax traces go to scratch allocated here."""
    B, T, L, ol, tl = _prepare("dag_best_alignment", match_all, links,
                               output_length, target_length)
    traces = torch.empty((B, T, L), dtype=torch.int32,
                         device=match_all.device)
    path = torch.empty((B, L), dtype=torch.int32, device=match_all.device)
    with torch.cuda.device(match_all.device):
        rc = _build.library().daspeech_dag_viterbi(
            match_all.data_ptr(), links.data_ptr(), ol.data_ptr(),
            tl.data_ptr(), traces.data_ptr(), path.data_ptr(), B, T, L,
            _build.stream_of(match_all))
    _build.check(rc, "daspeech_dag_viterbi")
    dag_best_alignment_kernel.launches += 1
    return path


dag_loss_forward_kernel.launches = 0
dag_best_alignment_kernel.launches = 0
