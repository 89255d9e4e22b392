"""The harness: the look for a card, the check for JAX by whole top-level
names, the cell lookup, the trace reductions and the metric readers."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import pytest  # noqa: E402

from benchmark.harness import core  # noqa: E402
from benchmark.harness import trace as tr  # noqa: E402

RUN = [sys.executable, "benchmark/run.py", "--workload", "s2st-serve",
       "--seed", "5", "--seconds", "1", "--trace", "0"]


def test_no_card_fails_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(RUN, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no result" in p.stderr


def test_checkout_of_the_benchmark_alone_fails(tmp_path):
    """With the program missing, a run ends without a result even where
    a card is found."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.harness.core as c;"
            "c.require_devices = lambda n: 'a card';"
            "import benchmark.run as r;"
            f"sys.exit(r.main({RUN[2:]!r}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "daspeech_torch" in p.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    before = set(core.forbidden_modules())
    for name in ("jax.numpy", "daspeech_tpu.models", "jaxlib", "flax.linen",
                 "jaxfoo", "daspeech_tpu_extra", "mydaspeech_tpu",
                 "daspeech_torch.models"):
        monkeypatch.setitem(sys.modules, name, object())
    got = set(core.forbidden_modules()) - before
    assert got == {"jax.numpy", "daspeech_tpu.models", "jaxlib",
                   "flax.linen"}


def test_a_tiny_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, '.');"
            "import torch; torch.set_num_threads(2);"
            "from benchmark.tests.tiny import tiny_cell;"
            "from benchmark.harness import core;"
            "d = core.load_module(core.BENCH_DIR / 'drivers' / 'serve.py',"
            " 'd');"
            "d.run(tiny_cell(), 3, 0.2, False, 'cpu', time.perf_counter());"
            "print(core.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_cell_lookup_reads_the_files_by_name():
    c = core.cell("s2st-serve")
    assert c["workload"]["driver"] == "serve"
    assert c["config"]["model"]["dag"]["decoder"]["embed_dim"] == 512
    assert {m["name"] for m in c["end_to_end"]} == {
        "serve_src_s_per_s", "setup_s"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    for w in bench["workloads"]:
        assert (ROOT / "benchmark" / "workloads"
                / f"{w['traffic']}.json").is_file()


def test_result_line_is_strict_json():
    line = core.result_line(False, 3, 0, {}, {"platform": "gpu"}, None,
                            {"gap": {"value": float("inf"), "limit": 1.0}})
    out = json.loads(line)
    assert list(out)[-1] == "checks"
    assert out["checks"]["gap"]["value"] == "inf"


def _events():
    k = "kernel"
    return [
        {"cat": "user_annotation", "name": tr.WINDOW, "ts": 0, "dur": 100,
         "tid": 1},
        {"cat": "user_annotation", "name": tr.STAGE_PREFIX + "decode",
         "ts": 0, "dur": 60, "tid": 1},
        {"cat": "user_annotation", "name": tr.OP_PREFIX + "0", "ts": 2,
         "dur": 5, "tid": 1},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 30, "dur": 10, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 3,
         "dur": 1, "tid": 1, "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5,
         "dur": 1, "tid": 1, "args": {"correlation": 8}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 31,
         "dur": 1, "tid": 1, "args": {"correlation": 9}},
        {"cat": k, "name": "a", "ts": 10, "dur": 10,
         "args": {"correlation": 7}},
        {"cat": k, "name": "b", "ts": 15, "dur": 15,
         "args": {"correlation": 8}},
        {"cat": k, "name": "a", "ts": 50, "dur": 10,
         "args": {"correlation": 9}},
    ]


def test_trace_reductions():
    ev = _events()
    assert tr.busy_s(ev) == pytest.approx(30e-6)
    assert tr.top_device_ops(ev) == [["a", 20e-6], ["b", 15e-6]]
    assert tr.op_device_s(ev) == {0: pytest.approx(25e-6)}
    gaps = dict(tr.idle_gaps(ev))
    # idle 0-10 (in the op's range, no cpu op), 30-50 (aten::mm), 60-100
    assert gaps["decode/aten::mm"] == pytest.approx(20e-6)
    assert gaps["decode/host python"] == pytest.approx(10e-6)
    assert gaps["host python"] == pytest.approx(40e-6)


def _reader(name):
    return core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                            "r_" + name.replace(".", "_"))


def test_metric_readers():
    record = {"stage_ms": {"decode": [1.0, 3.0], "synth": [2.0],
                           "vocode": [5.0, 7.0]},
              "flops": 4.95e12, "timed_s": 2.0, "peak_flops": 495e12,
              "peak_bytes": 3.35e12, "busy_s": 0.9, "window_s": 1.0,
              "op_calls": [["x", 495e9, 0, 0.004], ["y", 0, 3.35e9, 0.004]]}
    assert _reader("serve.decode_ms").read(record) == 2.0
    assert _reader("serve.synth_ms").read(record) == 2.0
    assert _reader("serve.vocode_ms").read(record) == 6.0
    assert _reader("serve.mfu").read(record) == pytest.approx(0.5)
    assert _reader("serve.kern_roofline").read(record) == pytest.approx(
        100 * 0.002 / 0.008)
    assert _reader("serve.device_idle").read(record) == pytest.approx(10.0)
    for name in ("serve.decode_ms", "serve.mfu", "serve.kern_roofline",
                 "serve.device_idle"):
        assert _reader(name).read({}) is None
