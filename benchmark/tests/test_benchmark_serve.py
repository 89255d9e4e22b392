"""The ``serve`` driver end to end on the CPU at a tiny size: a sound run
is judged correct under the cell's own limits, and runs with the timed path
broken underneath are judged not correct."""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import core  # noqa: E402
from benchmark.tests.tiny import tiny_cell  # noqa: E402

SEED = 2 ** 31 + 12345


def serve(c):
    driver = core.load_module(core.BENCH_DIR / "drivers" / "serve.py",
                              "bench_driver_serve_test")
    torch.set_num_threads(2)
    out = driver.run(c, seed=SEED, seconds=0.5, trace=False, device="cpu",
                     t0=time.perf_counter())
    checks = core.checks_line(out["readings"], c["workload"]["checks"])
    return out, checks


def test_sound_run_is_correct():
    c = tiny_cell()
    out, checks = serve(c)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert core.passed(checks), checks
    assert out["values"]["serve_src_s_per_s"] > 0
    assert out["values"]["setup_s"] > 0


def _alter_token(monkeypatch):
    from daspeech_torch.decode.generator import S2SNATGenerator

    decode = S2SNATGenerator.decode

    def altered(self, *args):
        res, z, zmask = decode(self, *args)
        tokens = res.tokens.clone()
        tokens[0, 1] = (tokens[0, 1] + 1 - 4) % (self.vocab.size - 4) + 4
        return res._replace(tokens=tokens), z, zmask

    monkeypatch.setattr(S2SNATGenerator, "decode", altered)


def _drop_half(monkeypatch):
    from daspeech_torch.decode.generator import S2SNATGenerator

    generate = S2SNATGenerator.generate

    def half(self, batch, *a, **kw):
        hyps = generate(self, batch, *a, **kw)
        return hyps[:len(hyps) // 2]

    monkeypatch.setattr(S2SNATGenerator, "generate", half)


def _drop_later(monkeypatch):
    """One answer left out of each batch from its third serving on: from
    the window's second pass at the latest, outside the judged passes."""
    from daspeech_torch.decode.generator import S2SNATGenerator

    generate = S2SNATGenerator.generate
    served = {}

    def later(self, batch, *a, **kw):
        hyps = generate(self, batch, *a, **kw)
        key = batch["fbank"].tobytes()
        served[key] = served.get(key, 0) + 1
        return hyps[:-1] if served[key] >= 3 else hyps

    monkeypatch.setattr(S2SNATGenerator, "generate", later)


def _alter_answer(monkeypatch):
    from daspeech_torch.decode.generator import S2SNATGenerator

    vocode = S2SNATGenerator.vocode

    def louder(self, mel):
        return vocode(self, mel) * 1.01

    monkeypatch.setattr(S2SNATGenerator, "vocode", louder)


@pytest.mark.parametrize("fault", [_alter_token, _drop_half, _drop_later,
                                   _alter_answer],
                         ids=["token-altered", "half-batch-left-out",
                              "answer-left-out-in-a-later-pass",
                              "answer-altered"])
def test_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out, checks = serve(tiny_cell())
    assert not core.passed(checks), checks
    if fault in (_drop_half, _drop_later):
        assert out["failed"] > 0
        assert out["attempted"] > out["failed"]
