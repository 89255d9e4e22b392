"""The port's parity CLI (``python -m daspeech_torch.cli.parity``) against
the JAX package's (``daspeech_tpu.cli.parity``): ``compare_trees`` gives
the same record on identical and divergent result trees (the reference's
transposed feature layout, an extra frame, a changed token, a tree
without hypotheses), the compare-only invocation prints the same JSON as
JAX's, without the ASR model it adds the note, and without ``--device
cpu`` it exits non-zero here."""

import json

import numpy as np
import pytest

from daspeech_torch.cli import parity as tpar
from daspeech_tpu.cli import parity as jpar


def _tree(root, mels, hypos=None):
    (root / "feat").mkdir(parents=True)
    for utt, m in mels.items():
        np.save(root / "feat" / f"{utt}.npy", m)
    if hypos is not None:
        with open(root / "hypos.txt", "w") as f:
            for utt, text in hypos.items():
                f.write(f"{utt}\t{text}\n")


def _mels(seed, n=3):
    rng = np.random.default_rng(seed)
    return {f"u{i}": rng.normal(size=(80, 10 + i)).astype(np.float32)
            for i in range(n)}


def test_identical_trees(tmp_path):
    mels = _mels(0)
    hypos = {u: "a b c" for u in mels}
    _tree(tmp_path / "ours", mels, hypos)
    _tree(tmp_path / "ref", mels, hypos)
    got = tpar.compare_trees(tmp_path / "ours", tmp_path / "ref")
    assert got == jpar.compare_trees(tmp_path / "ours", tmp_path / "ref")
    assert got["token_exact_match"] == got["token_accuracy"] == 1.0
    assert got["mel_mse"] == 0.0 and got["mel_frames_match"] == 1.0


def test_divergent_trees(tmp_path):
    mels = _mels(1)
    ref = {u: np.concatenate([m + 0.1, np.zeros((80, 1), np.float32)],
                             axis=1).T.copy() for u, m in mels.items()}
    ref["u1"] = mels["u1"]                    # one utterance agrees
    _tree(tmp_path / "ours", mels, {"u0": "a b c d", "u1": "x", "u2": "p"})
    _tree(tmp_path / "ref", ref, {"u0": "a b x d", "u1": "x", "u2": "p q"})
    got = tpar.compare_trees(tmp_path / "ours", tmp_path / "ref")
    assert got == jpar.compare_trees(tmp_path / "ours", tmp_path / "ref")
    assert got["token_exact_match"] == round(1 / 3, 4)
    assert 0.0 < got["mel_mse"] and got["mel_frames_match"] == round(1 / 3,
                                                                     4)


def test_tree_without_hypotheses(tmp_path):
    mels = _mels(2, n=2)
    _tree(tmp_path / "ours", mels)
    _tree(tmp_path / "ref", mels, {"u0": "a"})
    got = tpar.compare_trees(tmp_path / "ours", tmp_path / "ref")
    assert got == jpar.compare_trees(tmp_path / "ours", tmp_path / "ref")
    assert "token_exact_match" not in got and got["mel_utts"] == 2


@pytest.fixture()
def trees(tmp_path):
    mels = _mels(3, n=2)
    _tree(tmp_path / "ours", mels, {"u0": "x y", "u1": "z"})
    _tree(tmp_path / "ref", {u: m * 1.01 for u, m in mels.items()},
          {"u0": "x y", "u1": "w"})
    (tmp_path / "test.tsv").write_text(
        "id\tsrc_audio\tsrc_n_frames\ttgt_text\n"
        "u0\ta.npy\t10\tx y\nu1\tb.npy\t10\tz\n")
    return tmp_path


def _compare_only(root, *extra):
    return [str(root), "--skip-generate",
            "--results-path", str(root / "ours"),
            "--reference-results", str(root / "ref"), *extra]


def test_compare_only_invocation_matches_jax(trees, capsys):
    assert tpar.main(_compare_only(trees, "--skip-asr",
                                   "--device", "cpu")) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert jpar.main(_compare_only(trees, "--skip-asr")) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(got) == json.loads(want)
    assert json.loads(got)["token_exact_match"] == 0.5


def test_without_the_asr_model(trees, capsys, monkeypatch):
    from daspeech_torch import eval as teval

    monkeypatch.setattr(teval, "asr_available", lambda name: False)
    assert tpar.main(_compare_only(trees, "--device", "cpu")) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "not in local cache" in rec["asr_note"]
    assert "asr_bleu_ours" not in rec and rec["mel_utts"] == 2


def test_needs_a_card(trees):
    with pytest.raises(SystemExit) as e:
        tpar.main(_compare_only(trees, "--skip-asr"))
    assert e.value.code not in (0, None)
