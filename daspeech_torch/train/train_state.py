"""Training state, the guarded Adam update and the learning-rate schedule.

Counterpart of ``daspeech_tpu/train/train_state.py``. The optimizer is a
plain function on lists of tensors (``torch._foreach_*``), mirroring
``_fused_guarded_adam`` (``train_state.py:56-106``) and through it the
optax chain clip_by_global_norm -> scale_by_adam(eps 1e-8) ->
add_decayed_weights -> scale_by_learning_rate, in that order; the schedule
reads the OLD count. ``ok`` is a device-side bool: where it is False the
step leaves parameters, both moments and both counts exactly as they were,
and no value is read back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional

import torch
from torch import nn

_I32_MAX = 2 ** 31 - 1


def inverse_sqrt_schedule(lr: float, warmup_updates: int,
                          warmup_init_lr: float = 1e-7
                          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``InverseSquareRootSchedule``: linear warmup from warmup_init_lr to
    lr, then lr * sqrt(warmup / step); ``step`` is a count tensor."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = torch.clamp(step.to(torch.float32), min=1.0)
        warm = warmup_init_lr + (lr - warmup_init_lr) * (
            step / max(warmup_updates, 1))
        decay = lr * torch.sqrt(warmup_updates
                                / torch.clamp(step, min=warmup_updates))
        return torch.where(step < warmup_updates, warm, decay)

    return schedule


def parse_anneal(schedule: str):
    """``parse_anneal_argument``: '0.5:0.1@100k' -> (start, end, steps);
    '0.3' -> constant."""
    def _num(s):
        s = s.strip()
        return float(s[:-1]) * 1000 if s.endswith("k") else float(s)

    vals, steps = schedule.split("@") if "@" in schedule else (schedule, "0")
    if ":" in vals:
        start, end = (float(x) for x in vals.split(":"))
    else:
        start = end = float(vals)
    return start, end, _num(steps)


def anneal_value(params, step: int) -> float:
    """``get_anneal_value``: linear interpolation, clamped at the end."""
    start, end, steps = params
    if steps <= 0:
        return start
    frac = min(max(step / steps, 0.0), 1.0)
    return start + (end - start) * frac


class AdamState(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: torch.Tensor          # int32 Adam count (bias correction)
    sched_count: torch.Tensor    # int32 schedule count


@torch.no_grad()
def guarded_adam_(params: List[torch.Tensor], grads: List[torch.Tensor],
                  state: AdamState, gnorm: torch.Tensor, ok: torch.Tensor, *,
                  b1: float, b2: float, eps: float, wd: float, clip,
                  sched) -> AdamState:
    """One clip + Adam + decayed-weights + lr step, in place on ``params``
    and the moments; returns the state with the new counts."""
    f32 = torch.float32
    count_inc = torch.where(state.count == _I32_MAX, state.count,
                            state.count + 1)
    scale = (torch.where(gnorm < clip, torch.ones_like(gnorm), clip / gnorm)
             if clip else torch.ones_like(gnorm))
    lr = sched(state.sched_count)
    bc1 = 1.0 - b1 ** count_inc.to(f32)
    bc2 = 1.0 - b2 ** count_inc.to(f32)
    # a skipped step gates every coefficient so that moments and params are
    # kept exactly; the gradient is zeroed first because it may hold inf or
    # NaN, which no coefficient can cancel (foreach has no select)
    okf = ok.to(f32)
    g = [torch.where(ok, x, 0.0) for x in grads]
    torch._foreach_mul_(g, torch.where(ok, scale, 0.0))
    torch._foreach_mul_(state.mu, torch.where(ok, b1, 1.0).to(f32))
    torch._foreach_add_(state.mu, g, alpha=1.0 - b1)
    torch._foreach_mul_(state.nu, torch.where(ok, b2, 1.0).to(f32))
    torch._foreach_add_(state.nu, torch._foreach_mul(g, g), alpha=1.0 - b2)
    denom = torch._foreach_div(state.nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    u = torch._foreach_div(state.mu, bc1)
    torch._foreach_div_(u, denom)
    if wd:
        torch._foreach_add_(u, params, alpha=wd)
    torch._foreach_mul_(u, lr * okf)
    torch._foreach_sub_(params, u)
    return state._replace(
        count=torch.where(ok, count_inc, state.count),
        sched_count=torch.where(ok, state.sched_count + 1,
                                state.sched_count))


@dataclass(frozen=True)
class GuardedAdam:
    """Adam + decoupled weight decay + global-norm clipping with the
    inverse-sqrt schedule, matching the recipe flags (``make_optimizer``,
    ``train_state.py:109-136``)."""
    lr: float = 5e-4
    warmup_updates: int = 10000
    warmup_init_lr: float = 1e-7
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    eps: float = 1e-8

    def init(self, params: List[torch.Tensor]) -> AdamState:
        dev = params[0].device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return AdamState([torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params], zero,
                         zero.clone())

    def update_(self, params, grads, state: AdamState, gnorm: torch.Tensor,
                ok: torch.Tensor) -> AdamState:
        return guarded_adam_(
            params, grads, state, gnorm, ok, b1=self.b1, b2=self.b2,
            eps=self.eps, wd=self.weight_decay or 0.0,
            clip=self.clip_norm if self.clip_norm and self.clip_norm > 0
            else None,
            sched=inverse_sqrt_schedule(self.lr, self.warmup_updates,
                                        self.warmup_init_lr))


def make_optimizer(cfg) -> GuardedAdam:
    """The optimizer of a ``TrainingConfig``."""
    return GuardedAdam(cfg.lr, cfg.warmup_updates, cfg.warmup_init_lr,
                       cfg.adam_b1, cfg.adam_b2, cfg.weight_decay,
                       cfg.clip_norm)


@dataclass
class TrainState:
    """The step count, the model (its parameters and BatchNorm running
    statistics) and the optimizer state. ``sharding``: the
    ``parallel.partition.MeshParallel`` of a ``--fsdp`` or mesh run (under
    ``--fsdp`` its parameters and moments are DTensors)."""
    model: nn.Module
    opt_state: AdamState
    step: int = 0
    sharding: Optional[object] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: GuardedAdam,
               sharding=None) -> "TrainState":
        return cls(model, optimizer.init(cls.params_of(model)),
                   sharding=sharding)

    @staticmethod
    def params_of(model: nn.Module) -> List[nn.Parameter]:
        return [p for p in model.parameters() if p.requires_grad]

    @property
    def params(self) -> List[nn.Parameter]:
        return self.params_of(self.model)
