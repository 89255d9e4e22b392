"""The tensor-parallel (``model``) and sequence (``seq``) axes inside the
modules: each rank's share of a layer, and the collectives that join the
shares.

Counterpart of what GSPMD derives in ``daspeech_tpu/parallel/partition.py``
from its placement annotations (``_rules``, ``activation_hints`` /
``constrain_btc``). JAX's annotations never change the numbers; here every
collective is explicit, so the modules call these functions where GSPMD
would insert one:

- Megatron's pair over ``model``: :func:`copy_to` (the identity, whose
  backward sums the ranks' gradients) at the input of a column-parallel
  projection, and :func:`reduce_from` (a sum over the ranks, whose
  backward is the identity) at the output of a row-parallel one. Between
  them each rank holds its heads or its slice of the FFN's inner width;
  outside them every activation, and the gradient of every replicated
  parameter, is the same on every rank.
- Over ``seq``: a Conformer activation [B, T', C] lives split along T'
  between the layers. The ops that need every frame (the rel-pos attention,
  the depthwise conv, the fused FFN) :func:`gather` the frames (backward:
  the ranks' gradients summed, each rank keeping its frames' share) and
  run on all of them, then :func:`split` their output to the rank's frames
  (backward: zeros beyond them). A rank's gradients below the encoder's
  output are then its frames' share, and the encoder's parameters' are
  summed over ``seq`` after the backward; the encoder's output is gathered
  for the decoder with a backward that keeps the rank's slice (the
  decoder and the loss run whole on every ``seq`` rank, so each holds the
  full gradient there, and a sum would count it ``seq`` times). Where the
  axis does not divide T' the encoder runs whole on every rank, and its
  output passes :func:`first_grad`: the first rank keeps the gradient and
  the others take zeros, so that the same sum over ``seq`` counts it once
  (exactly, whichever frames a step's microbatches had).

:class:`Axis` names a rank's place on one axis. Its ``group`` is a
``torch.distributed`` process group, or an :class:`EmulatedGroup`: the
ranks of one axis as threads of one process (on one card), whose
collectives sum in rank order (:func:`run_ranks`).

Dropout that does not depend on the mesh: :func:`full_shape` gives the
shape and the slice of a sharded tensor inside the unsharded one, so that
``models.layers.dropout`` draws the unsharded mask and keeps the rank's
slice; the ranks that share a data coordinate then draw the same numbers
from the same generator, in lockstep.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """This rank's place on one mesh axis: ``rank`` of ``size``, and the
    ``group`` of the ranks that differ from it only there."""
    group: object
    rank: int
    size: int

    def share(self, n: int) -> slice:
        """The rank's equal share of ``n`` (which ``size`` divides)."""
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


class EmulatedGroup:
    """The collectives of ``size`` ranks that run as threads of one process
    (:func:`run_ranks`): each rank's tensor is handed over, every rank sums
    (or concatenates) them in rank order, so that every rank gets the same
    bits. Forward passes only: the autograd engine runs one device's
    backward on one thread."""

    def __init__(self, size: int):
        self.size = size
        self._barrier = threading.Barrier(size)
        self._slots: List[Optional[torch.Tensor]] = [None] * size

    def exchange(self, x: torch.Tensor, rank: int) -> List[torch.Tensor]:
        self._slots[rank] = x
        self._barrier.wait()
        parts = list(self._slots)
        self._barrier.wait()
        return parts


def run_ranks(group: EmulatedGroup, fns: Sequence) -> list:
    """Run ``fns[r]()`` for every rank r of ``group``, each on a thread of
    its own; their results in rank order. A rank that raises breaks the
    group's barrier, and the first error is raised."""
    out: list = [None] * len(fns)
    errors: list = []

    def body(r):
        try:
            out[r] = fns[r]()
        except BaseException as e:           # noqa: BLE001 - re-raised
            errors.append(e)
            group._barrier.abort()

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def all_reduce(x: torch.Tensor, ax: Axis, op: str = "sum") -> torch.Tensor:
    """``x`` summed (or its maximum taken, ``op="max"``) over ``ax``'s
    ranks, a new tensor."""
    if isinstance(ax.group, EmulatedGroup):
        parts = ax.group.exchange(x, ax.rank)
        out = parts[0]
        for p in parts[1:]:
            out = out + p if op == "sum" else torch.maximum(out, p)
        return out.clone() if len(parts) == 1 else out
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=ax.group)
    return y


def all_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    if isinstance(ax.group, EmulatedGroup):
        return torch.cat(ax.group.exchange(x, ax.rank), dim)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim)


def _own(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    return x.narrow(dim, ax.rank * (x.shape[dim] // ax.size),
                    x.shape[dim] // ax.size)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, summed):
        ctx.cfg = (ax, dim, summed)
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        ax, dim, summed = ctx.cfg
        if summed:
            g = all_reduce(g, ax)
        return _own(g, ax, dim).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, gathered):
        ctx.cfg = (ax, dim, gathered)
        return _own(x, ax, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        ax, dim, gathered = ctx.cfg
        if gathered:
            return all_gather(g, ax, dim), None, None, None
        full = list(g.shape)
        full[dim] *= ax.size
        out = g.new_zeros(full)
        _own(out, ax, dim).copy_(g)
        return out, None, None, None


class _FirstGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.ax.rank == 0 else torch.zeros_like(g)), None


def copy_to(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``x`` (replicated over ``ax``) entering a region where each rank
    computes its share: the identity; the backward sums the shares'
    gradients (Megatron's f)."""
    return _CopyTo.apply(x, ax)


def reduce_from(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The ranks' partial results summed: the replicated output of a
    row-parallel product; the backward is the identity (Megatron's g)."""
    return _ReduceFrom.apply(x, ax)


def first_grad(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``x`` (the same on every rank of ``ax``, each holding its full
    gradient); the backward keeps the gradient on the first rank and gives
    the others zeros, so that a sum over ``ax`` after the backward counts
    it once."""
    return _FirstGrad.apply(x, ax)


def gather(x: torch.Tensor, ax: Axis, dim: int,
           summed: bool = True) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``. Backward: with
    ``summed`` the ranks' gradients are summed and each keeps its slice
    (what follows runs on every rank and each rank's gradient is its own
    share); without, each keeps its slice of its own gradient (what follows
    gives every rank the full gradient: the encoder's output, a weight
    gathered for a replicated kernel)."""
    return _Gather.apply(x, ax, dim, summed)


def split(x: torch.Tensor, ax: Axis, dim: int,
          gathered: bool = False) -> torch.Tensor:
    """The rank's slice of ``x`` (the same on every rank) along ``dim``.
    Backward: zeros beyond the slice (each rank's gradient stays its
    share), or with ``gathered`` the ranks' slices concatenated (a
    replicated activation whose full gradient every rank needs)."""
    return _Split.apply(x, ax, dim, gathered)


def full_shape(shape: Sequence[int],
               shards: Sequence[Tuple[int, Axis]]
               ) -> Tuple[List[int], tuple]:
    """(the unsharded shape, the index of the local slice in it) of a
    tensor of ``shape`` that is one rank's equal share along each
    ``(dim, axis)`` of ``shards``."""
    full = list(shape)
    idx = [slice(None)] * len(shape)
    for dim, ax in shards:
        dim %= len(shape)
        n = shape[dim]
        full[dim] = n * ax.size
        idx[dim] = slice(ax.rank * n, (ax.rank + 1) * n)
    return full, tuple(idx)


class SeqShard(NamedTuple):
    """One forward's split of the Conformer's frames over ``axis``: ``T``
    frames in all (``axis.size`` divides it)."""
    axis: Axis
    T: int

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The rank's frames of a tensor that needs no gradient (a mask)."""
        return _own(x, self.axis, dim)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather(x, self.axis, 1)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        return split(x, self.axis, 1)

    def drop(self) -> Tuple[Tuple[int, Axis], ...]:
        """The dropout shards of a [B, T', ...] activation."""
        return ((1, self.axis),)


def seq_split(axis: Optional[Axis], T: int) -> Optional[SeqShard]:
    """The split of ``T`` frames over ``axis``, or None where they stay
    whole on every rank: no axis, or one that does not divide them (JAX
    replicates such a dim, ``constrain_btc``)."""
    if axis is None or T % axis.size:
        return None
    return SeqShard(axis, T)


# ----------------------------------------------------- a step's activations

_CTX = threading.local()


@contextlib.contextmanager
def activations(frames: Optional[int] = None, vocab: Optional[Axis] = None):
    """Within this block (a step's loss, on this thread): ``frames``, the
    full number of fbank frames of a batch whose frames came split over
    ``seq`` (None: whole); ``vocab``, the ``model`` axis over which the tied
    output projection's logits may stay split by vocabulary (the losses
    reduce over it, :func:`vocab_axis`). The port's ``activation_hints``."""
    prev = getattr(_CTX, "cur", (None, None))
    _CTX.cur = (frames, vocab)
    try:
        yield
    finally:
        _CTX.cur = prev


def fbank_frames() -> Optional[int]:
    return getattr(_CTX, "cur", (None, None))[0]


def vocab_axis() -> Optional[Axis]:
    """The axis over which logits are split by vocabulary in this block, or
    None: outside a step's loss the tied projection gathers its logits."""
    return getattr(_CTX, "cur", (None, None))[1]


__all__ = ["Axis", "EmulatedGroup", "SeqShard", "activations", "all_gather",
           "all_reduce", "copy_to", "fbank_frames", "first_grad",
           "full_shape", "gather", "reduce_from", "run_ranks", "seq_split",
           "split", "vocab_axis"]
