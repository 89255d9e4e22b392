"""Fully sharded data parallelism (``--fsdp``, ZeRO-3): parameters, their
gradients and Adam's moments split over the data-parallel ranks.

Counterpart of the FSDP half of ``daspeech_tpu/parallel/partition.py``:
``jit_sharded(..., fsdp_axis="data", min_fsdp_size=N)`` (``:273``) with
``fsdp_partition_spec`` (``:149``), the reference's
``--ddp-backend=fully_shard``. JAX writes it as sharding annotations and
GSPMD inserts the collectives; here ``torch.distributed.fsdp.fully_shard``
(FSDP2) over a 1-D ``data`` device mesh does, with JAX's placement rule
(:func:`shard_dim`): each parameter of at least ``min_fsdp_size`` elements
split along its largest dim that divides over the ranks, a convolution's
kernel only along its (first) tap dim, everything else replicated (FSDP's
``ignored_params``, whose gradients go through the step's bucketed
all-reduce). Each Conformer, DAG-decoder and FastSpeech 2 layer is one
FSDP unit, gathered for its forward and again for its backward; the rest
of the model is the root unit, gathered for the whole loss. The loss runs
as the root's forward (:meth:`FSDP.run`), so that every method of the
model the criteria call sees gathered parameters.

Sharding never changes the numbers: the step is the data-parallel step of
``train/step.py`` (each rank's share of a globally normalised loss), with
FSDP's reduce-scatter SUMMING the ranks' gradients (its divide factor set
to 1, as the bucketed all-reduce sums) and the norm, the clip, the NaN
guard and Adam taken on each rank's shards: the norm's squares summed over
the ranks, so that ``ok`` and the clip are the same on every rank and a
skipped step leaves every shard bit for bit. Adam's moments are DTensors
laid out as their parameters. Checkpoints gather parameters and moments to
full tensors (:func:`full`) in the unsharded file format, and restore by
each rank taking its slice (:func:`copy_full_`). Validation gathers every
unit once (:meth:`FSDP.gathered`): the ranks' shares of the valid batches
may differ in number, and a pass then runs no collective.

``--fsdp`` in a single process is FSDP over a world of one
(:func:`init_single_process_group`): the same code path, every shard whole.
JAX replicates every parameter there instead (``fsdp_partition_spec``
returns the replicated spec on a data axis of size one); the port keeps
the FSDP units, at a cost in time (ROADMAP, Queue 3), because a world of
one is the only FSDP that one card can run.
The Megatron tensor-parallel and sequence axes of JAX's ``partition.py``
are not ported: no entry point of either package reaches them (ROADMAP).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

MIN_FSDP_SIZE = 2 ** 12


def shard_dim(shape, world: int, min_size: int = MIN_FSDP_SIZE
              ) -> Optional[int]:
    """The dim ``--fsdp`` splits a parameter of ``shape`` along, or None to
    replicate it (``fsdp_partition_spec``, ``partition.py:149-189``): fewer
    than ``min_size`` elements stay whole (fairseq's
    ``--min-params-to-wrap``); otherwise the largest dim that divides over
    ``world`` ranks (the first of equals). A rank-3+ parameter is a
    convolution's kernel ([out, in, taps...] here, [taps..., in, out] in
    JAX): only its first tap dim may split, else it stays whole. At a
    world of one every dim divides: the parameter is one shard, where JAX
    replicates it (ROADMAP, Queue 3)."""
    ndim = len(shape)
    if ndim == 0 or int(torch.Size(shape).numel()) < min_size:
        return None
    free = [d for d in range(ndim) if shape[d] % world == 0]
    if ndim >= 3:
        free = [d for d in free if d == 2]
    if not free:
        return None
    return max(free, key=lambda d: (shape[d], -d))


def init_single_process_group(device) -> None:
    """A process group of one (an in-process store, no rendezvous):
    ``--fsdp`` without torchrun. NCCL on a card, gloo on the CPU."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        store=dist.HashStore(), rank=0, world_size=1)


def _layer_types():
    from daspeech_torch.models.conformer import ConformerEncoderLayer
    from daspeech_torch.models.fastspeech2 import FFTLayer
    from daspeech_torch.models.layers import TransformerDecoderLayer

    return (ConformerEncoderLayer, TransformerDecoderLayer, FFTLayer)


class _Loss(nn.Module):
    """The FSDP root: its forward calls ``fn(model, *args)``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(self.model, *args)


def _local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view: in-place updates reach the
    DTensor), a plain tensor itself."""
    return x._local_tensor if isinstance(x, DTensor) else x


class FSDP:
    """``model`` (already on its device) sharded in place over ``group``'s
    ranks (default: the world). ``dims``: {parameter name: the dim it is
    split along} of the sharded parameters; the others are replicated."""

    def __init__(self, model: nn.Module, group=None,
                 min_fsdp_size: int = MIN_FSDP_SIZE):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        self.group = group
        self.world = dist.get_world_size(group)
        device = next(model.parameters()).device
        self.mesh = init_device_mesh(device.type, (self.world,),
                                     mesh_dim_names=("data",))
        self.dims: Dict[str, int] = {}
        replicated = set()
        placement = {}
        for name, p in model.named_parameters():
            d = shard_dim(p.shape, self.world, min_fsdp_size)
            if d is None:
                replicated.add(p)
            else:
                self.dims[name] = d
                placement[p] = Shard(d)
        kw = dict(mesh=self.mesh, ignored_params=replicated,
                  shard_placement_fn=lambda p: placement[p],
                  reshard_after_forward=True)
        units = [m for m in model.modules() if isinstance(m, _layer_types())]
        for m in units:
            fully_shard(m, **kw)
        self.root = fully_shard(_Loss(model), **kw)
        # the root's parameters stay gathered from the forward through the
        # backward (the rest of the model: one gather a step, not two)
        self.root.set_reshard_after_forward(False, recurse=False)
        self.units = units + [self.root]
        for unit in self.units:
            # the ranks' gradients summed, as the bucketed all-reduce sums
            unit.set_gradient_divide_factor(1.0)
            if hasattr(unit, "set_force_sum_reduction_for_comms"):
                unit.set_force_sum_reduction_for_comms(True)

    # ------------------------------------------------------------ the step

    def run(self, fn, *args):
        """``fn(model, *args)`` as the root's forward: every parameter is
        gathered where the model uses it (and for the backward)."""
        return self.root(fn, *args)

    @contextlib.contextmanager
    def gathered(self):
        """Every unit gathered once for the block (collective), sharded
        again at its end: the passes inside (without gradient, through
        :meth:`run`) then run no collective, so the ranks may make
        different numbers of them. Validation: the ranks' round-robin
        shares of the valid batches differ by one where their count does
        not divide, and decoding and MCD stop on the data."""
        for unit in self.units[:-1]:
            unit.set_reshard_after_forward(False, recurse=False)
        try:
            for unit in self.units:
                unit.unshard()
            yield
        finally:
            for unit in self.units:
                unit.reshard()
            for unit in self.units[:-1]:
                unit.set_reshard_after_forward(True, recurse=False)

    def sharded(self, params: List[torch.Tensor]) -> List[bool]:
        return [isinstance(p, DTensor) for p in params]

    @staticmethod
    def local(xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's shards of ``xs`` (parameters, gradients, moments)."""
        return [_local(x) for x in xs]

    def global_norm(self, grads: List[torch.Tensor],
                    sharded: List[bool]) -> torch.Tensor:
        """The norm of the full gradients from this rank's shards
        (``grads``, local): each sharded tensor's squared norm summed over
        the ranks (one all-reduce), the replicated ones' taken once, then
        ``step.global_norm``'s norm of the per-tensor norms. The same value
        on every rank."""
        norms = torch.stack(torch._foreach_norm(grads))
        mask = torch.tensor(sharded, device=norms.device)
        sq = torch.where(mask, norms.square(), torch.zeros_like(norms))
        dist.all_reduce(sq, group=self.group)
        return torch.linalg.vector_norm(torch.where(mask, sq.sqrt(), norms))


# ------------------------------------------------------------- checkpoints

def full(x: torch.Tensor) -> torch.Tensor:
    """The full tensor of a DTensor (collective: every rank calls it), a
    plain tensor itself."""
    return x.full_tensor() if isinstance(x, DTensor) else x


@torch.no_grad()
def copy_full_(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the full tensor ``src`` into ``dst``; a DTensor takes this
    rank's slice under its own placement (no collective)."""
    src = src.to(dst.device)
    if isinstance(dst, DTensor):
        src = distribute_tensor(src, dst.device_mesh, dst.placements,
                                src_data_rank=None)
    dst.copy_(src)


__all__ = ["FSDP", "MIN_FSDP_SIZE", "copy_full_", "full",
           "init_single_process_group", "shard_dim"]
