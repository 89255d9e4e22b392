"""Partitioning over a data x seq x model mesh: fully sharded data
parallelism (``--fsdp``, ZeRO-3) over ``data``, Megatron tensor parallelism
over ``model`` and the Conformer's frames over ``seq``.

Counterpart of ``daspeech_tpu/parallel/partition.py``: ``jit_sharded``
(``:273``) with ``fsdp_partition_spec`` (``:149``), JAX's ``_rules`` and
``param_partition_spec`` (``:100-147``), ``make_mesh`` (``:225``) and
``jit_sharded_infer`` (``:246``), which ``__graft_entry__.py``'s
``dryrun_multichip`` reaches with a ``(data -1, seq 2, model 2)`` mesh. JAX
writes all of it as sharding annotations and GSPMD inserts the
collectives; here they are explicit.

**FSDP** (:class:`FSDP`, the wrapping; ``--fsdp`` is :class:`MeshParallel`
on a mesh of ``data`` alone). ``torch.distributed.fsdp.fully_shard``
(FSDP2) over a 1-D ``data`` device mesh, with JAX's placement rule
(:func:`shard_dim`): each parameter of at least ``min_fsdp_size`` elements
split along its largest dim that divides over the ranks, a convolution's
kernel only along its (first) tap dim, everything else replicated (FSDP's
``ignored_params``, whose gradients go through the step's bucketed
all-reduce). Each Conformer, DAG-decoder and FastSpeech 2 layer is one
FSDP unit, gathered for its forward and again for its backward; the rest
of the model is the root unit, gathered for the whole loss. The loss runs
as the root's forward (:meth:`MeshParallel.run`), so that every method of
the model the criteria call sees gathered parameters. The reduce-scatter
SUMS the ranks' gradients (its divide factor set to 1, as the bucketed
all-reduce sums); the norm, the clip, the NaN guard and Adam work on each
rank's shards, the norm's squares summed over the ranks, so that ``ok``
and the clip are the same on every rank and a skipped step leaves every
shard bit for bit. Adam's moments are DTensors laid out as their
parameters. Checkpoints gather parameters and moments to full tensors
(:func:`full`) in the unsharded file format, and restore by each rank
taking its slice (:func:`copy_full_`). Validation gathers every unit once
(:meth:`MeshParallel.gathered`): the ranks' shares of the valid batches
may differ in number, and a pass then runs no collective. ``--fsdp`` in a
single process is FSDP over a world of one
(:func:`init_single_process_group`): the same code path, every shard
whole. JAX replicates every parameter
there instead (``fsdp_partition_spec`` returns the replicated spec on a
data axis of size one); the port keeps the FSDP units, at a cost in time
(ROADMAP, Queue 3), because a world of one is the only FSDP that one card
can run.

**The model and seq axes** (:class:`MeshParallel`, the step's ``sharding``
on a :func:`make_mesh` mesh). :func:`tp_placement` is JAX's ``_rules`` on
the port's parameter names, in torch's ``[out, in]`` layout: fc1 / w_1,
q/k/v / linear_q/k/v / linear_pos column-parallel (dim 0, with their
biases), fc2 / w_2, out_proj / linear_out row-parallel (dim 1), pos_bias_u/v
by head and embed_tokens by vocabulary (dim 0); a dim that does not divide
over ``model`` leaves the tensor replicated, as does every other name.
:func:`tensor_parallel` keeps each rank's shard of those parameters and
tells each module its part (``models/layers.py``, ``models/conformer.py``):
a per-module plan written with the explicit collectives of
``parallel/shard.py``, because the hand kernels take plain local tensors
(each rank runs them on its own heads, their dropout counted from the
rank's first head) and the rel-pos attention and the tied projection read
their weights directly; FSDP2 then shards those local tensors over
``data`` like any other. Over ``seq`` the fbank frames (:meth:`shard_batch`)
and the Conformer's activations are split, and the encoder's parameters'
gradients are summed over ``seq`` after the backward (``shard``'s module
docstring says why only theirs). Inside the step's loss the tied output
projection keeps its logits split by vocabulary and the DAG loss reduces
its log-softmax over ``model`` (``ops.dag_ref``). The norm counts every
element once: a shard's squares summed over its axis, a replicated
tensor's taken once. Each rank draws the dropout of its data coordinate
(``cli.train.step_generator``), every layer's mask the unsharded one.

Sharding never changes the numbers beyond the order of sums: the step over
any mesh is one process's step on the whole batch
(``tests/test_torch_tp.py``, ``tests/test_torch_fsdp.py``). Decoding over
``data`` x ``model``: :func:`generate_sharded`.
"""

from __future__ import annotations

import contextlib
import copy
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from daspeech_torch.parallel import multihost as mh
from daspeech_torch.parallel import shard
from daspeech_torch.parallel.shard import Axis

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
    """FSDP2's wrapping of ``model`` (already on its device), sharded in
    place over the 1-D device ``mesh`` (a :func:`make_mesh` mesh's ``data``
    axis): the units and the root of the module docstring. It has no step
    of its own: :class:`MeshParallel` runs the step through it. ``dims``:
    {parameter name: the dim it is split along} of the sharded parameters;
    the others are replicated."""

    def __init__(self, model: nn.Module, mesh,
                 min_fsdp_size: int = MIN_FSDP_SIZE):
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        self.mesh = mesh
        world = mesh.size()
        self.dims: Dict[str, int] = {}
        replicated = set()
        placement = {}
        for name, p in model.named_parameters():
            d = shard_dim(p.shape, world, min_fsdp_size)
            if d is None:
                replicated.add(p)
            else:
                self.dims[name] = d
                placement[p] = Shard(d)
        kw = dict(mesh=mesh, ignored_params=replicated,
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


def local(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """This rank's shards of ``xs`` (parameters, gradients, moments)."""
    return [_local(x) for x in xs]


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


# ------------------------------------------------------------ the mesh

def mesh_shape(n: int, axes: Sequence[Tuple[str, int]] = (("data", -1),)
               ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(names, sizes) of a mesh of ``n`` ranks: ``axes`` is ((name, size),
    ...) with at most one -1 wildcard, which takes what the others leave
    (``partition.py:225-243``): (("data", -1), ("seq", 2), ("model", 2))
    on 8 ranks is data 2. Raises ValueError where the sizes do not make
    ``n``."""
    names = tuple(a for a, _ in axes)
    sizes = [int(s) for _, s in axes]
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        sizes[sizes.index(-1)] = max(1, n // known)
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n}")
    return names, tuple(sizes)


def make_mesh(n: int, axes: Sequence[Tuple[str, int]] = (("data", -1),),
              device=None):
    """A ``DeviceMesh`` of the ``n`` ranks of the default process group
    (which must hold ``n``), shaped by :func:`mesh_shape`; rank r sits at
    the row-major coordinate of r. ``device``: the mesh's device type (the
    process's card unless it is the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    names, sizes = mesh_shape(n, axes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"a mesh of {n} ranks in a process group of "
                         f"{world}")
    dev = torch.device(device if device is not None else "cuda")
    return init_device_mesh(dev.type, sizes, mesh_dim_names=names)


def mesh_axis(mesh, name: str) -> Optional[Axis]:
    """This rank's place on axis ``name`` of ``mesh``, or None without it."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    sub = mesh[name]
    return Axis(sub.get_group(), sub.get_local_rank(), sub.size())


# ------------------------------------------------- tensor-parallel placement

# JAX's ``_rules`` (``partition.py:100-124``) on the port's parameter names:
# (name pattern, rank, the dim split over ``model`` in torch's layout)
_RULES = (
    (re.compile(r"(fc1|w_1)\.weight$"), 2, 0),
    (re.compile(r"(fc1|w_1)\.bias$"), 1, 0),
    (re.compile(r"(fc2|w_2)\.weight$"), 2, 1),
    (re.compile(r"(q_proj|k_proj|v_proj|linear_q|linear_k|linear_v|"
                r"linear_pos)\.weight$"), 2, 0),
    (re.compile(r"(q_proj|k_proj|v_proj|linear_q|linear_k|linear_v)"
                r"\.bias$"), 1, 0),
    (re.compile(r"(out_proj|linear_out)\.weight$"), 2, 1),
    (re.compile(r"pos_bias_[uv]$"), 2, 0),
    (re.compile(r"embed_tokens\.weight$"), 2, 0),
)


def tp_placement(name: str, shape, model_size: int) -> Optional[int]:
    """The dim of parameter ``name`` (of ``shape``) split over a ``model``
    axis of ``model_size`` ranks, or None to replicate it: the first rule
    whose pattern and rank match, kept only where ``model_size`` divides
    that dim (``param_partition_spec``, ``partition.py:126-147``)."""
    for rx, rank, dim in _RULES:
        if rx.search(name) and len(shape) == rank:
            return dim if shape[dim] % model_size == 0 else None
    return None


def _region_types():
    from daspeech_torch.models.conformer import (FeedForwardModule,
                                                 RelPosMultiHeadAttention)
    from daspeech_torch.models.fastspeech2 import FFNAdapter
    from daspeech_torch.models.layers import (MultiHeadAttention,
                                              TransformerFFN)

    return (MultiHeadAttention, RelPosMultiHeadAttention, TransformerFFN,
            FeedForwardModule, FFNAdapter)


def tensor_parallel(model: nn.Module, mesh) -> Dict[str, int]:
    """Split ``model`` in place over ``mesh``'s ``model`` and ``seq`` axes
    (either may be absent): :func:`split_model` on this rank's places on
    them, with the process group of the data and ``seq`` ranks for
    BatchNorm."""
    seq = mesh_axis(mesh, "seq")
    return split_model(model, mesh_axis(mesh, "model"), seq,
                       None if seq is None else _data_seq_group(mesh))


def split_model(model: nn.Module, tp: Optional[Axis],
                seq: Optional[Axis] = None, seq_stats=None
                ) -> Dict[str, int]:
    """Split ``model`` in place over the ``model`` axis ``tp`` and the
    ``seq`` axis ``seq`` (either may be None; an axis of a
    ``shard.EmulatedGroup`` gives one shard of an emulated split): each
    parameter :func:`tp_placement` places is
    replaced by this rank's equal slice, and each module learns its part
    (module docstring): the attention modules and FFNs whose projections
    are split run their heads or inner slice (``tp``), a split projection
    runs column- or row-parallel (``tp_mode``; a row-parallel projection
    outside them, FastSpeech 2's mel ``out_proj``, takes its rank's slice
    of a replicated input, JAX's row placement with a replicated input
    layout), a split ``embed_tokens`` holds its rank's rows of the
    vocabulary, and each Conformer encoder its ``seq`` axis with
    ``seq_stats``, the process group BatchNorm sums over. Returns
    {parameter name: split dim}. Raises where a split attention's heads
    do not divide over the axis."""
    from daspeech_torch.models.conformer import ConformerEncoder
    from daspeech_torch.models.layers import Embedding, Linear

    dims: Dict[str, int] = {}
    if tp is not None:
        modules = dict(model.named_modules())
        for name, p in list(model.named_parameters()):
            dim = tp_placement(name, p.shape, tp.size)
            if dim is None:
                continue
            owner_name, _, attr = name.rpartition(".")
            owner = modules[owner_name]
            local = p.detach().narrow(dim, tp.rank * (p.shape[dim]
                                                      // tp.size),
                                      p.shape[dim] // tp.size).clone()
            setattr(owner, attr, nn.Parameter(local,
                                              requires_grad=p.requires_grad))
            dims[name] = dim
            parent = modules[owner_name.rpartition(".")[0]]
            if isinstance(owner, Embedding):
                owner.tp = tp
            elif isinstance(owner, Linear):
                owner.tp = tp
                region = isinstance(parent, _region_types())
                if dim == 0 and not region:
                    raise ValueError(f"no tensor-parallel plan for the "
                                     f"column-parallel {name}")
                owner.tp_mode = ("col" if dim == 0 else
                                 "row" if region else "row_rep")
                if region:
                    parent.tp = tp
            else:                       # pos_bias_u/v: the heads' rows
                owner.tp = tp
        for name, m in modules.items():
            H = getattr(m, "num_heads", None)
            if getattr(m, "tp", None) is tp and H is not None \
                    and H % tp.size:
                raise ValueError(f"{name}: {H} heads do not divide over "
                                 f"{tp.size} model ranks")
    if seq is not None:
        for m in model.modules():
            if isinstance(m, ConformerEncoder):
                m.seq, m.seq_stats = seq, seq_stats
    return dims


def emulated_shards(module: nn.Module, size: int):
    """(an ``EmulatedGroup`` of ``size`` ranks, ``size`` copies of
    ``module``, copy r split as its rank r by :func:`split_model`): the
    model axis of one process, whose ranks run on threads
    (``shard.run_ranks``, forward passes)."""
    group = shard.EmulatedGroup(size)
    copies = [copy.deepcopy(module) for _ in range(size)]
    for r, m in enumerate(copies):
        split_model(m, Axis(group, r, size))
    return group, copies


def _data_seq_group(mesh):
    """The process group of the ranks that share this rank's ``model``
    coordinate (every group created on every rank, in one order)."""
    grid = mesh.mesh
    names = mesh.mesh_dim_names
    if "model" in names:
        grid = grid.movedim(names.index("model"), -1)
    else:
        grid = grid[..., None]
    mine = None
    me = dist.get_rank()
    for m in range(grid.shape[-1]):
        ranks = sorted(grid[..., m].flatten().tolist())
        group = dist.new_group(ranks)
        if me in ranks:
            mine = group
    return mine


FRAMES = "fbank_frames"     # the batch key of the full fbank frame count


class MeshParallel:
    """The step's ``sharding`` over a :func:`make_mesh` mesh of ``data``,
    ``seq`` and ``model`` axes (any may be absent): ``model`` split by
    :func:`tensor_parallel`, then, with ``fsdp``, sharded over ``data`` by
    :class:`FSDP`. Hand ``group`` (the ``data`` axis's) to
    ``train.make_train_step`` and each rank :meth:`shard_batch`'s batch."""

    def __init__(self, model: nn.Module, mesh, fsdp: bool = False,
                 min_fsdp_size: int = MIN_FSDP_SIZE):
        from daspeech_torch.models.conformer import ConformerEncoder

        self.mesh, self.model = mesh, model
        self.data = mesh_axis(mesh, "data")
        self.seq = mesh_axis(mesh, "seq")
        self.tp = mesh_axis(mesh, "model")
        self.dims = tensor_parallel(model, mesh)
        self.group = None if self.data is None else self.data.group
        self.world = 1 if self.data is None else self.data.size
        self.data_rank = 0 if self.data is None else self.data.rank
        # the step's loss keeps the logits split by vocabulary where a tied
        # output projection's table is split
        self.vocab = (self.tp if any(
            getattr(m, "share_input_output_embed", False)
            and m.embed_tokens.tp is not None for m in model.modules())
            else None)
        encoders = [n for n, m in model.named_modules()
                    if isinstance(m, ConformerEncoder)]
        self.fsdp = (FSDP(model, mesh["data"], min_fsdp_size) if fsdp
                     else None)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        self._tp_split = [n in self.dims for n in names]
        # the encoders' parameters: each seq rank's gradient is its share,
        # summed over seq (reduce_grads_)
        self._seq_sum = [any(n.startswith(e + ".") for e in encoders)
                         for n in names]

    # ------------------------------------------------------------ the step

    def shard_batch(self, batch: Dict) -> Dict:
        """This rank's part of a global batch: its rows over ``data`` (a
        contiguous block, ``multihost.process_batch_slice``) and, where
        ``seq`` divides them, its share of the fbank frames, with the full
        count under ``FRAMES`` (``shard_batch_specs(..., seq_axis=...)``,
        ``train/step.py:124-147``)."""
        if self.data is not None:
            B = len(batch["src_lengths"] if "src_lengths" in batch
                    else next(iter(batch.values())))
            batch = mh.slice_batch(batch, mh.process_batch_slice(
                B, self.data.rank, self.data.size))
        if self.seq is not None and "fbank" in batch \
                and batch["fbank"].shape[1] % self.seq.size == 0:
            T = batch["fbank"].shape[1]
            batch = dict(batch, fbank=batch["fbank"][:, self.seq.share(T)])
            batch[FRAMES] = T
        return batch

    def run(self, fn, *args, vocab: Optional[Axis] = None):
        """``fn(model, *args)`` (through FSDP's root with ``fsdp``); a
        batch as the first argument may carry ``FRAMES``."""
        frames = None
        if args and isinstance(args[0], dict) and FRAMES in args[0]:
            batch = dict(args[0])
            frames = batch.pop(FRAMES)
            args = (batch,) + args[1:]
        with shard.activations(frames, vocab):
            if self.fsdp is not None:
                return self.fsdp.run(fn, *args)
            return fn(self.model, *args)

    def loss(self, fn, batch, rng):
        """The step's loss: :meth:`run` with the logits split by
        vocabulary."""
        return self.run(fn, batch, rng, vocab=self.vocab)

    def gathered(self):
        return (self.fsdp.gathered() if self.fsdp is not None
                else contextlib.nullcontext())

    def sharded(self, params: List[torch.Tensor]) -> List[bool]:
        """Which of ``params`` are split over ``data`` (FSDP's DTensors)."""
        return [isinstance(p, DTensor) for p in params]

    local = staticmethod(local)

    def reduce_grads_(self, grads: List[torch.Tensor], sharded: List[bool],
                      group) -> None:
        """The gradients not split over ``data`` summed over it, then the
        encoders' summed over ``seq``: each ``seq`` rank holds its share,
        its frames' where the encoder split them, the whole on the first
        rank and zeros on the others where it ran whole
        (``shard.first_grad``)."""
        mh.all_reduce_grads_([g for g, s in zip(grads, sharded) if not s],
                             group)
        if self.seq is not None:
            mh.all_reduce_grads_([g for g, s in zip(grads, self._seq_sum)
                                  if s], self.seq.group)

    def global_norm(self, grads: List[torch.Tensor],
                    sharded: List[bool]) -> torch.Tensor:
        """The norm of the full gradients, the same on every rank: each
        tensor's squares summed over the axes it is split along (``data``
        for FSDP's shards, then ``model``), a replicated tensor's norm
        taken as it is, then ``step.global_norm``'s norm of the norms."""
        norms = torch.stack(torch._foreach_norm(grads))
        sq = norms.square()
        split = torch.zeros_like(sq, dtype=torch.bool)
        for axis, which in ((self.data if self.fsdp else None, sharded),
                            (self.tp, self._tp_split)):
            if axis is None:
                continue
            mask = torch.tensor(which, device=sq.device)
            sq = torch.where(mask, shard.all_reduce(
                torch.where(mask, sq, torch.zeros_like(sq)), axis), sq)
            split |= mask
        return torch.linalg.vector_norm(torch.where(split, sq.sqrt(),
                                                    norms))

    # --------------------------------------------------------- checkpoints

    def full(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The unsharded tensor of parameter (or moment) ``name``:
        gathered over ``data`` (FSDP), then over ``model`` (collective)."""
        x = full(x)
        dim = self.dims.get(name)
        return x if dim is None else shard.all_gather(x.contiguous(),
                                                      self.tp, dim)

    def copy_full_(self, name: str, dst: torch.Tensor,
                   src: torch.Tensor) -> None:
        """``dst`` takes this rank's slice of the unsharded ``src``."""
        dim = self.dims.get(name)
        if dim is not None:
            src = src.narrow(dim, self.tp.rank * (src.shape[dim]
                                                  // self.tp.size),
                             src.shape[dim] // self.tp.size)
        copy_full_(dst, src)


def generate_sharded(generator, batch: Dict, mesh) -> List[Dict]:
    """Decoding over ``data`` x ``model`` (``jit_sharded_infer``,
    ``partition.py:246-270``): ``generator`` (an ``S2TNATGenerator`` or
    ``S2SNATGenerator``) holds a model split by :func:`tensor_parallel`;
    each rank decodes its rows of ``batch`` over ``data`` (a contiguous
    block, which must divide), and every rank returns every row's
    hypotheses (tokens, and mel with S2S) in batch order."""
    data = mesh_axis(mesh, "data")
    if data is None:
        return generator.generate(batch)
    B = len(batch["src_lengths"])
    rows = mh.slice_batch(batch, mh.process_batch_slice(B, data.rank,
                                                        data.size))
    parts = [None] * data.size
    dist.all_gather_object(parts, generator.generate(rows), group=data.group)
    return [h for part in parts for h in part]


__all__ = ["FRAMES", "FSDP", "MIN_FSDP_SIZE", "MeshParallel",
           "copy_full_", "emulated_shards", "full", "generate_sharded",
           "init_single_process_group", "local",
           "make_mesh", "mesh_axis", "mesh_shape", "shard_dim",
           "split_model", "tensor_parallel", "tp_placement"]
