"""The port's metrics (``daspeech_torch/train/metrics.py``) against the JAX
package's: meters, the aggregator's smoothed values (a frozen clock for the
rates), the JSON progress lines, and the optional sinks, each raising an
ImportError that names its package when the package is missing."""

import io
import sys
import time

import pytest

from daspeech_torch.train import metrics as t_m
from daspeech_tpu.train import metrics as j_m


def test_meters_match_jax():
    t, j = t_m.AverageMeter(), j_m.AverageMeter()
    assert t.avg == j.avg == 0.0
    for m in (t, j):
        for v, n in ((1.5, 2), (3.25, 1), (-0.5, 4)):
            m.update(v, n)
    assert vars(t) == vars(j) and t.avg == j.avg


def _feed(agg, clock):
    clock[0] = 0.0
    agg.speed.clear()
    for step in range(5):
        agg.log_scalar("loss", 2.0 / (step + 1), weight=3)
        agg.log_scalar("nll", 1.0 + step, weight=1)
        agg.log_scalar("bad", float("nan"))          # dropped
        agg.log_speed("ups", 1)
        agg.log_speed("wps", 120.5)
    agg.log_derived("ppl", lambda v: 2 ** v["nll"])
    agg.log_derived("broken", lambda v: v["missing"])   # skipped
    clock[0] = 2.5
    return agg.get_smoothed_values()


def test_aggregator_and_logger_lines_match_jax(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    got, want = _feed(t_m.MetricsAggregator(), clock), _feed(
        j_m.MetricsAggregator(), clock)
    assert list(got.items()) == list(want.items())
    assert "bad" not in got and "broken" not in got

    lines = []
    for mod in (t_m, j_m):
        out, seen = io.StringIO(), []
        log = mod.JsonProgressLogger(stream=out, log_interval=2,
                                     sinks=[lambda s, st, tag:
                                            seen.append((st, tag))])
        for step in range(5):
            log.log(dict(got), step, epoch=1)
        log.print({"bleu": 12.5}, 7, epoch=2, tag="valid")
        lines.append((out.getvalue(), seen))
    assert lines[0] == lines[1]
    assert lines[0][1] == [(0, "train"), (2, "train"), (4, "train"),
                           (7, "valid")]

    with t_m.aggregate() as a, j_m.aggregate() as b:
        assert type(a).__name__ == type(b).__name__ == "MetricsAggregator"
    agg = t_m.MetricsAggregator()
    _feed(agg, clock)
    agg.reset()
    assert agg.get_smoothed_values() == {"ups": 0.0, "wps": 0.0}


@pytest.mark.parametrize("sink,args,package", [
    ("TensorboardSink", ("logs",), "tensorboard"),
    ("WandBSink", ("proj",), "wandb"),
    ("AimSink", ("repo",), "aim"),
    ("AzureMLSink", (), "azureml"),
])
def test_sinks_are_import_gated(sink, args, package, monkeypatch, tmp_path):
    blocked = {"tensorboard": "torch.utils.tensorboard",
               "azureml": "azureml.core"}.get(package, package)
    monkeypatch.setitem(sys.modules, blocked, None)      # import fails
    with pytest.raises(ImportError, match=package):
        getattr(t_m, sink)(*[str(tmp_path / a) for a in args])
