"""The readers of the program's own spans and counters
(``serve.collate_ms``, ``serve.d2h_ms``, ``serve.mel_kept``): None on an
empty session, and the served batches' numbers after a profiled stretch of
the tiny cell, on the CPU and, marked ``cuda``, on the card."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import core  # noqa: E402
from benchmark.tests.tiny import tiny_cell  # noqa: E402
from benchmark.traffic.data import (utterance_frames,  # noqa: E402
                                    write_runtime_data)

SEED = 2 ** 31 + 4242
READERS = ("serve.collate_ms", "serve.d2h_ms", "serve.mel_kept")


def _reader(name):
    return core.load_module(core.BENCH_DIR / "metrics" / f"{name}.py",
                            "spans_" + name.replace(".", "_"))


def test_readers_give_none_on_an_empty_session():
    from daspeech_torch import telemetry

    telemetry.enable()
    telemetry.disable()
    for name in READERS:
        assert _reader(name).read({}) is None


def profiled_serve(c, device, tmp_path, k=3):
    """Serve ``k`` batches of the tiny cell under ``torch.profiler``, as
    the profiled stretch of a ``--trace 1`` run does; returns each served
    batch's hypotheses, rows and mel bucket."""
    from torch.profiler import ProfilerActivity, profile

    cfg, mix = c["config"], c["workload"]["traffic"]
    write_runtime_data(tmp_path, "test", utterance_frames(mix),
                       cfg["model"]["dag"]["vocab"]["size"],
                       mix["target_tokens_per_s"], mix["fbank_rate"], SEED)
    serve = core.load_module(core.BENCH_DIR / "drivers" / "serve.py",
                             "bench_serve_spans")
    torch.set_num_threads(2)
    prog = serve.Program(c, tmp_path, SEED, device)
    prog.serve(0)                    # outside the profiler: not recorded
    served = []
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts):
        for pos in range(k):
            batch, hyps = prog.serve(pos)
            served.append((hyps, len(batch["src_lengths"]),
                           prog.gen.max_mel_len))
    return served


def _check(served, device):
    from daspeech_torch import telemetry

    snap = telemetry.snapshot()
    collate = snap["spans"]["data.collate"]
    assert collate["calls"] == len(served)
    ms = _reader("serve.collate_ms").read({})
    assert ms > 0
    assert ms == pytest.approx(collate["host_ms"] / len(served))
    kept = sum(len(h["feature"]) for hyps, _, _ in served for h in hyps)
    computed = sum(B * M for _, B, M in served)
    assert _reader("serve.mel_kept").read({}) == pytest.approx(
        100.0 * kept / computed)
    d2h = _reader("serve.d2h_ms").read({})
    if device == "cpu":
        assert d2h is None        # no device clock
    else:
        assert d2h > 0
        assert d2h == pytest.approx(
            snap["spans"]["results.d2h"]["device_ms"] / len(served))


def test_readers_after_a_profiled_tiny_serve(tmp_path):
    _check(profiled_serve(tiny_cell(), "cpu", tmp_path), "cpu")


@pytest.mark.cuda
def test_readers_after_a_profiled_tiny_serve_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    c = core.cell("s2st-serve")
    c["workload"]["traffic"]["utterances"] = 60
    _check(profiled_serve(c, "cuda", tmp_path), "cuda")
