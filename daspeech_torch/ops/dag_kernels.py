"""Wrappers of the DAG dynamic-program kernels (``csrc/dag_fb.cu``,
``csrc/dag_viterbi.cu``).

They replace the Pallas ``dag_loss_forward_pallas``
(``daspeech_tpu/ops/dag_pallas.py:108``) and ``dag_best_alignment_pallas``
(``:285``). ``ops/dag_ref.py`` routes CUDA tensors here and CPU tensors to
its plain loops; each wrapper takes contiguous CUDA tensors only and raises
on anything else.

Each (sample, sweep) runs on a thread-block cluster of ``cs`` blocks that
split the vertex axis in interleaved groups of 32 columns and trade each
step's row through distributed shared memory (``csrc/dag_common.cuh``).
:func:`cluster_plan` picks ``cs`` from the shape; the C entry points derive
the block's threads and shared memory from L and ``cs``
(:func:`block_shape` reads them back) and refuse a ``cs`` the layout does
not take; a cluster the card cannot place raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from daspeech_torch.ops import _build

MAX_L = 1024         # max_target_positions; the kernels' column arrays
GROUP = 32           # columns of a group (one warp): csrc kDagGroup
MAX_CLUSTER = 8      # the portable cluster size: kDagMaxCluster
SWEEPS = {"dag_loss_forward": 2, "dag_best_alignment": 1}


def cluster_plan(B: int, sweeps: int, L: int, n_sm: int) -> int:
    """The cluster size ``cs`` of the launch for B samples of ``sweeps``
    recursions each (alpha/beta: 2, Viterbi: 1) over L vertices on a card
    of ``n_sm`` SMs: the largest power of two with ``B * sweeps * cs <=
    n_sm``, at most MAX_CLUSTER and at most the number of 32-column groups,
    and 1 when the grid fills the card without clusters."""
    groups = -(-L // GROUP)
    cs = 1
    while (2 * cs <= min(MAX_CLUSTER, groups)
           and B * sweeps * 2 * cs <= n_sm):
        cs *= 2
    return cs


def block_columns(L: int, cs: int, rank: int) -> list[int]:
    """The vertices that block ``rank`` of a cluster of ``cs`` owns: the
    32-column groups g with g % cs == rank (``Layout::col``)."""
    return [j for g in range(rank, -(-L // GROUP), cs)
            for j in range(g * GROUP, min(L, (g + 1) * GROUP))]


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(name: str, match_all: torch.Tensor) -> int:
    """:func:`cluster_plan` of kernel ``name`` on ``match_all``'s shape and
    card."""
    B, _, L = match_all.shape
    return cluster_plan(B, SWEEPS[name], L, _n_sm(match_all.device.index))


def block_shape(L: int, cs: int) -> tuple[int, int]:
    """(threads, dynamic shared memory bytes) of a block of either kernel
    on clusters of ``cs`` blocks at L vertices, as the C entry points
    launch it."""
    threads, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = _build.library().daspeech_dag_block(L, cs, ctypes.byref(threads),
                                             ctypes.byref(smem))
    _build.check(rc, "daspeech_dag_block")
    return threads.value, smem.value


def max_active_clusters(name: str, match_all: torch.Tensor) -> int:
    """``cudaOccupancyMaxActiveClusters`` of kernel ``name``'s launch on
    ``match_all``: how many of its clusters the card holds at once."""
    B, _, L = match_all.shape
    out = ctypes.c_int(0)
    fn = {"dag_loss_forward": "daspeech_dag_fb_max_clusters",
          "dag_best_alignment": "daspeech_dag_viterbi_max_clusters"}[name]
    with torch.cuda.device(match_all.device):
        rc = getattr(_build.library(), fn)(B, L, plan_for(name, match_all),
                                           ctypes.byref(out))
    _build.check(rc, fn)
    return out.value


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


def _count(wrapper, cs: int) -> None:
    wrapper.launches += 1
    wrapper.cluster_launches[cs] = wrapper.cluster_launches.get(cs, 0) + 1


def dag_loss_forward_kernel(match_all: torch.Tensor, links: torch.Tensor,
                            output_length: torch.Tensor,
                            target_length: torch.Tensor):
    """(logprob [B], alpha [B, T, L], beta [B, T, L]) by the alpha/beta
    kernel: one cluster per sample and sweep."""
    B, T, L, ol, tl = _prepare("dag_loss_forward", match_all, links,
                               output_length, target_length)
    cs = plan_for("dag_loss_forward", match_all)
    alpha = torch.empty_like(match_all)
    beta = torch.empty_like(match_all)
    with torch.cuda.device(match_all.device):
        rc = _build.library().daspeech_dag_fb_cluster(
            match_all.data_ptr(), links.data_ptr(), ol.data_ptr(),
            tl.data_ptr(), alpha.data_ptr(), beta.data_ptr(), B, T, L, cs,
            _build.stream_of(match_all))
    _build.check(rc, "daspeech_dag_fb_cluster")
    _count(dag_loss_forward_kernel, cs)
    return beta[:, 0, 0], alpha, beta


def dag_best_alignment_kernel(match_all: torch.Tensor, links: torch.Tensor,
                              output_length: torch.Tensor,
                              target_length: torch.Tensor) -> torch.Tensor:
    """Viterbi path [B, L] int32 by the Viterbi kernel (one cluster per
    sample); its [B, T, L] int32 argmax traces go to scratch allocated
    here."""
    B, T, L, ol, tl = _prepare("dag_best_alignment", match_all, links,
                               output_length, target_length)
    cs = plan_for("dag_best_alignment", match_all)
    traces = torch.empty((B, T, L), dtype=torch.int32,
                         device=match_all.device)
    path = torch.empty((B, L), dtype=torch.int32, device=match_all.device)
    with torch.cuda.device(match_all.device):
        rc = _build.library().daspeech_dag_viterbi_cluster(
            match_all.data_ptr(), links.data_ptr(), ol.data_ptr(),
            tl.data_ptr(), traces.data_ptr(), path.data_ptr(), B, T, L, cs,
            _build.stream_of(match_all))
    _build.check(rc, "daspeech_dag_viterbi_cluster")
    _count(dag_best_alignment_kernel, cs)
    return path


# launches, and launches by cluster size
dag_loss_forward_kernel.launches = 0
dag_loss_forward_kernel.cluster_launches = {}
dag_best_alignment_kernel.launches = 0
dag_best_alignment_kernel.cluster_launches = {}
