"""The training step (PyTorch): value and grad, gradient accumulation, the
NaN guard, global-norm clipping and the guarded Adam update.

Counterpart of ``daspeech_tpu/train/step.py:21-115`` with
``jit_data_parallel`` (``:149-167``). The step never reads a value back to
the host: the skip decision is a device bool that gates the update
(``train_state.guarded_adam_``). Given a process group, each rank runs the
loss on its rows of the global batch under ``multihost.data_parallel``
(counts and BatchNorm statistics over the group), and the gradients, the
loss and the metrics are summed over the group before the norm, so that
every rank clips by the same norm and takes the same skip decision.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from daspeech_torch.parallel import multihost as mh
from daspeech_torch.telemetry import span
from daspeech_torch.train.train_state import GuardedAdam, TrainState


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (``optax_global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _sum_metrics_(loss: torch.Tensor, metrics: Dict[str, torch.Tensor],
                  group):
    """(loss, metrics) summed over ``group`` in one all-reduce (float64,
    each value cast back to its own type). Under ``data_parallel`` every
    loss term and metric is a rank's share of the global batch's value, so
    their sum is the global value."""
    keys = list(metrics)
    vec = torch.stack([loss.double()]
                      + [metrics[k].double().reshape(()) for k in keys])
    torch.distributed.all_reduce(vec, group=group)
    return (vec[0].to(loss.dtype),
            {k: vec[i + 1].to(metrics[k].dtype) for i, k in enumerate(keys)})


def make_train_step(loss_fn: Callable, optimizer: GuardedAdam,
                    accum_steps: int = 1, group=None, sharding=None):
    """Build ``train_step(state, batch, rng) -> metrics``.

    ``loss_fn(model, batch, rng) -> (loss, metrics)``. ``accum_steps > 1``
    is ``--update-freq`` accumulation: ``batch`` is then a sequence of A
    microbatches (the JAX step's leading [A, ...] axis), and the gradients
    and the loss are averaged over them. A non-finite loss or gradient norm
    skips the update (``skipped`` = 1), leaving the parameters, moments and
    optimizer counts untouched; BatchNorm statistics move either way, as in
    the JAX step.

    ``group``: a ``torch.distributed`` process group for data parallelism
    (module docstring); ``batch`` then holds this rank's rows only.
    ``sharding``: the ``parallel.partition.MeshParallel`` of a ``--fsdp``
    run or of a data x seq x model mesh (``group`` its ``data`` axis's):
    the loss runs through it
    (``sharding.loss``), the gradients split over ``data`` arrive summed
    by FSDP's reduce-scatter, the others are summed by
    ``sharding.reduce_grads_``, and the norm and the update work on this
    rank's shards.

    Each update runs in the spans ``train.forward`` and ``train.backward``
    (one of each a microbatch) and ``train.optimizer`` (the gradients'
    reduction over the group, the norm and the guarded update)."""

    def forward(state, batch, rng):
        with span("train.forward"):
            if sharding is None:
                return loss_fn(state.model, batch, rng)
            return sharding.loss(loss_fn, batch, rng)

    def backward(loss):
        with span("train.backward"):
            loss.backward()

    def update(state, params, loss, metrics):
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if sharding is not None:
            shard = sharding.sharded(params)
            grads = sharding.local(grads)
            params = sharding.local(params)
            sharding.reduce_grads_(grads, shard, group)
        elif group is not None:
            mh.all_reduce_grads_(grads, group)
        if group is not None:
            loss, metrics = _sum_metrics_(loss, metrics, group)
        gnorm = (global_norm(grads) if sharding is None
                 else sharding.global_norm(grads, shard))
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        s = state.opt_state
        if sharding is None:
            state.opt_state = optimizer.update_(params, grads, s, gnorm, ok)
        else:       # Adam on this rank's shards of the DTensor moments
            local = s._replace(mu=sharding.local(s.mu),
                               nu=sharding.local(s.nu))
            state.opt_state = optimizer.update_(
                params, grads, local, gnorm, ok)._replace(mu=s.mu, nu=s.nu)
        state.step += 1
        metrics = dict(metrics)
        metrics["gnorm"] = gnorm
        metrics["skipped"] = (~ok).to(torch.float32)
        return metrics

    def train_step(state: TrainState, batch, rng: torch.Generator
                   ) -> Dict[str, torch.Tensor]:
        params = state.params
        for p in params:
            p.grad = None
        with mh.data_parallel(group):
            if accum_steps == 1:
                loss, metrics = forward(state, batch, rng)
                backward(loss)
                loss = loss.detach()
            else:
                losses, per_micro = [], []
                assert len(batch) == accum_steps, len(batch)
                for mb in batch:
                    micro_loss, m = forward(state, mb, rng)
                    backward(micro_loss / accum_steps)
                    losses.append(micro_loss.detach())
                    per_micro.append(m)
                loss = torch.stack(losses).mean()
                metrics = {k: torch.stack([m[k].float() for m in per_micro]
                                          ).mean() for k in per_micro[0]}
        with span("train.optimizer"):
            return update(state, params, loss, metrics)

    return train_step
