"""Metrics aggregation and progress logging (a copy of
``daspeech_tpu/train/metrics.py``).

Rebuild of ``fairseq/fairseq/logging/{metrics,meters,progress_bar}.py``:
a nested aggregator stack with summed/weighted scalars, derived metrics,
smoothed rates, and a JSON-line progress logger (the recipes all run with
``--log-format json``). The TensorBoard, W&B, Aim and Azure ML sinks
import their packages when built and raise an ``ImportError`` that names the
package when it is missing.
"""

from __future__ import annotations

import contextlib
import json
import math
import sys
import time
from collections import OrderedDict, defaultdict
from typing import Any, Callable, Dict, List, Optional


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0.0

    def update(self, val: float, n: float = 1.0):
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class TimeMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.start = time.perf_counter()
        self.n = 0.0

    def update(self, n: float = 1.0):
        self.n += n

    @property
    def rate(self) -> float:
        dt = time.perf_counter() - self.start
        return self.n / dt if dt > 0 else 0.0


class MetricsAggregator:
    """``metrics.aggregate`` context + log_scalar/log_derived
    (``logging/metrics.py:45-134``)."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)
        self.speed: Dict[str, TimeMeter] = {}
        self.derived: Dict[str, Callable[[Dict[str, float]], float]] = {}

    def log_scalar(self, key: str, value: float, weight: float = 1.0):
        v = float(value)
        if math.isfinite(v):
            self.meters[key].update(v, weight)

    def log_derived(self, key: str, fn: Callable[[Dict[str, float]], float]):
        self.derived[key] = fn

    def log_speed(self, key: str, n: float = 1.0):
        if key not in self.speed:
            self.speed[key] = TimeMeter()
        self.speed[key].update(n)

    def get_smoothed_values(self) -> Dict[str, float]:
        out = OrderedDict(
            (k, round(m.avg, 4)) for k, m in self.meters.items())
        for k, t in self.speed.items():
            out[k] = round(t.rate, 2)
        for k, fn in self.derived.items():
            try:
                out[k] = round(fn(out), 4)
            except Exception:
                pass
        return out

    def reset(self):
        self.meters.clear()
        self.derived.clear()
        for t in self.speed.values():
            t.reset()


class JsonProgressLogger:
    """``--log-format json`` progress (``logging/progress_bar.py``)."""

    def __init__(self, stream=None, log_interval: int = 100,
                 tag: str = "train", sinks=()):
        self.stream = stream or sys.stdout
        self.log_interval = log_interval
        self.tag = tag
        self.sinks = list(sinks)   # e.g. TensorboardSink

    def log(self, stats: Dict[str, Any], step: int, epoch: int = 0):
        if step % self.log_interval:
            return
        self.print(stats, step, epoch)

    def print(self, stats: Dict[str, Any], step: int, epoch: int = 0,
              tag: str = None):
        """``tag`` overrides the logger's default (e.g. ``tag='valid'`` for
        validation stats), so sinks bucket train vs valid separately."""
        tag = self.tag if tag is None else tag
        rec = {"tag": tag, "epoch": epoch, "update": step, **stats}
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()
        for sink in self.sinks:
            sink(stats, step, tag)


class TensorboardSink:
    """TensorBoard progress sink (``logging/progress_bar.py:27-116``'s
    tensorboard backend), lazily importing torch's SummaryWriter. Attach
    with ``JsonProgressLogger(sinks=[TensorboardSink(dir)])``."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "TensorboardSink requires the `tensorboard` package "
                "(pip install tensorboard)") from e

        self._w = SummaryWriter(log_dir=str(logdir))

    def __call__(self, stats: Dict[str, Any], step: int, tag: str):
        for k, v in stats.items():
            if isinstance(v, (int, float)) and k not in ("epoch", "update"):
                self._w.add_scalar(f"{tag}/{k}", v, step)
        self._w.flush()

    def close(self):
        self._w.close()


class WandBSink:
    """Weights & Biases progress sink (``logging/progress_bar.py``'s
    ``WandBProgressBarWrapper``). Import-gated: raises ImportError with a
    clear message when the ``wandb`` package is absent, mirroring the
    reference's lazy optional backend. Same ``(stats, step, tag)`` call
    protocol as :class:`TensorboardSink`."""

    def __init__(self, project: str, run_name: str = None):
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "WandBSink requires the `wandb` package "
                "(pip install wandb)") from e
        self._wandb = wandb
        # reinit=False matches the reference: one run per process
        self._run = wandb.init(project=project, name=run_name, reinit=False)

    def __call__(self, stats: Dict[str, Any], step: int, tag: str):
        payload = {
            f"{tag}/{k}": v for k, v in stats.items()
            if isinstance(v, (int, float)) and k not in ("epoch", "update")}
        if payload:
            self._wandb.log(payload, step=step)

    def close(self):
        self._run.finish()


class AimSink:
    """Aim progress sink (``logging/progress_bar.py::AimProgressBarWrapper``,
    ``:340-403``). Import-gated like :class:`WandBSink`; same
    ``(stats, step, tag)`` call protocol. ``run_hash`` appends to an
    existing run (the reference additionally queries by checkpoint dir —
    pass the hash explicitly here)."""

    def __init__(self, repo: str, run_hash: str = None):
        try:
            from aim import Run
        except ImportError as e:
            raise ImportError(
                "AimSink requires the `aim` package (pip install aim)"
            ) from e
        self._run = Run(run_hash=run_hash, repo=repo)

    def __call__(self, stats: Dict[str, Any], step: int, tag: str):
        context = {"tag": tag}
        if "train" in tag:
            context["subset"] = "train"
        elif "val" in tag:
            context["subset"] = "val"
        for k, v in stats.items():
            if isinstance(v, (int, float)) and k not in ("epoch", "update"):
                self._run.track(v, name=k, step=step, context=context)

    def close(self):
        self._run.close()


class AzureMLSink:
    """Azure ML progress sink
    (``logging/progress_bar.py::AzureMLProgressBarWrapper``, ``:537-582``).
    Uses the ambient run context (``Run.get_context()``), logging each
    stat as a named metric with the step attached."""

    def __init__(self):
        try:
            from azureml.core import Run
        except ImportError as e:
            raise ImportError(
                "AzureMLSink requires the `azureml-core` package "
                "(pip install azureml-core)") from e
        self._run = Run.get_context()

    def __call__(self, stats: Dict[str, Any], step: int, tag: str):
        # log_row with an explicit step column, the reference's scheme
        # (``progress_bar.py:569-582``)
        for k, v in stats.items():
            if isinstance(v, (int, float)) and k not in ("epoch", "update"):
                self._run.log_row(name=f"{tag}/{k}", **{"step": step, k: v})

    def close(self):
        self._run.complete()


@contextlib.contextmanager
def aggregate():
    agg = MetricsAggregator()
    yield agg
