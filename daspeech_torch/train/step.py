"""The training step (PyTorch): value and grad, gradient accumulation, the
NaN guard, global-norm clipping and the guarded Adam update.

Counterpart of ``daspeech_tpu/train/step.py:21-115`` on one device. The
step never reads a value back to the host: the skip decision is a device
bool that gates the update (``train_state.guarded_adam_``).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from daspeech_torch.train.train_state import GuardedAdam, TrainState


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (``optax_global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def make_train_step(loss_fn: Callable, optimizer: GuardedAdam,
                    accum_steps: int = 1):
    """Build ``train_step(state, batch, rng) -> metrics``.

    ``loss_fn(model, batch, rng) -> (loss, metrics)``. ``accum_steps > 1``
    is ``--update-freq`` accumulation: every batch tensor then carries a
    leading microbatch axis [A, ...], and the gradients and the loss are
    averaged over it. A non-finite loss or gradient norm skips the update
    (``skipped`` = 1), leaving the parameters, moments and optimizer counts
    untouched; BatchNorm statistics move either way, as in the JAX step."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   rng: torch.Generator) -> Dict[str, torch.Tensor]:
        params = state.params
        for p in params:
            p.grad = None
        if accum_steps == 1:
            loss, metrics = loss_fn(state.model, batch, rng)
            loss.backward()
            loss = loss.detach()
        else:
            losses, per_micro = [], []
            for a in range(accum_steps):
                mb = {k: v[a] for k, v in batch.items()}
                micro_loss, m = loss_fn(state.model, mb, rng)
                (micro_loss / accum_steps).backward()
                losses.append(micro_loss.detach())
                per_micro.append(m)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k].float() for m in per_micro]
                                      ).mean() for k in per_micro[0]}
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        gnorm = global_norm(grads)
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        state.opt_state = optimizer.update_(params, grads, state.opt_state,
                                            gnorm, ok)
        state.step += 1
        metrics = dict(metrics)
        metrics["gnorm"] = gnorm
        metrics["skipped"] = (~ok).to(torch.float32)
        return metrics

    return train_step
