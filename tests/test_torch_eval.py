"""The port's evaluation (``daspeech_torch/eval``) against the JAX
package's (``daspeech_tpu/eval``) on the same inputs, and its evaluation
pipeline CLI (``python -m daspeech_torch.cli.eval_pipeline``, here with
``--device cpu``):

* corpus BLEU (sacrebleu, 13a and zh), ``normalize_transcript``, the
  language table, the linear resampler, and MCD (equal mels, coefficient
  orders, length mismatch, the corpus average, cepstra and the DTW path)
  within 1e-6 of JAX's;
* the pipeline decodes the last-2-averaged checkpoints of a joint run
  with a vocoder checkpoint exactly as the generate CLI does with the same
  arguments; without the ASR model it prints ``"asr_bleu": null`` and its
  note; without ``--device cpu`` it exits non-zero here.
"""

import json

import numpy as np
import pytest
import torch

from daspeech_torch.eval import asr_bleu as tab
from daspeech_torch.eval import mcd as tmcd
from daspeech_tpu.eval import asr_bleu as jab
from daspeech_tpu.eval import mcd as jmcd
from torch_cli_corpus import (cli_args, one_torch_thread,  # noqa: F401
                              write_corpus)

TOL = 1e-6
HYPS = ["The cat sat on the mat.", "a quick brown fox", "Hello, world!",
        "jumps over the lazy dog", "It's 4 o'clock"]
REFS = ["the cat sat on a mat", "a quick brown fox", "hello world",
        "jumped over the lazy dogs", "it is four o'clock"]


@pytest.mark.parametrize("lang,tok", [("en", None), ("fr", None),
                                      ("zh", None), ("zh", "13a")])
def test_corpus_bleu_matches_jax(lang, tok):
    got = tab.corpus_bleu(HYPS, REFS, lang=lang, tokenizer=tok)
    want = jab.corpus_bleu(HYPS, REFS, lang=lang, tokenizer=tok)
    assert abs(got - want) <= TOL and 0.0 < got < 100.0
    assert tab.corpus_bleu(REFS, REFS) == pytest.approx(100.0)


def test_transcript_normalisation_and_tables_match_jax():
    for text in HYPS + ["ÇA VA? Très bien", "  SPACED   out  "]:
        for lang in ("en", "fr", "de"):
            assert tab.normalize_transcript(text, lang) == \
                jab.normalize_transcript(text, lang)
    assert tab.ASR_MODELS == jab.ASR_MODELS
    assert tab.asr_model_for_lang("fr") == jab.asr_model_for_lang("fr")
    with pytest.raises(ValueError):
        tab.asr_model_for_lang("xx")
    wav = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    np.testing.assert_array_equal(tab.resample_linear(wav, 22050, 16000),
                                  jab.resample_linear(wav, 22050, 16000))


def _mels(seed, n1, n2):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n1, 80)).astype(np.float32)
    b = (a[: min(n1, n2)] if n2 <= n1 else np.concatenate(
        [a, a[-1:].repeat(n2 - n1, 0)]))
    return a, b + 0.3 * rng.normal(size=b.shape).astype(np.float32)


def test_mcd_equal_mels_is_zero():
    a, _ = _mels(0, 20, 20)
    assert tmcd.mel_cepstral_distortion(a, a) == 0.0
    assert jmcd.mel_cepstral_distortion(a, a) == 0.0


@pytest.mark.parametrize("n_coef", [13, 24])
@pytest.mark.parametrize("n1,n2", [(20, 20), (23, 17), (12, 30)])
def test_mcd_matches_jax(n_coef, n1, n2):
    a, b = _mels(n1 * n2, n1, n2)
    got = tmcd.mel_cepstral_distortion(a, b, n_coef)
    want = jmcd.mel_cepstral_distortion(a, b, n_coef)
    assert got > 0 and abs(got - want) <= TOL * max(1.0, want)
    np.testing.assert_allclose(tmcd.mel_to_cepstra(a, n_coef),
                               jmcd.mel_to_cepstra(a, n_coef), rtol=0,
                               atol=TOL)
    d = np.abs(a[:, None, :4] - b[None, :, :4]).sum(-1)
    assert tmcd.dtw_path(d) == jmcd.dtw_path(d)


def test_corpus_mcd_matches_jax():
    pairs = [_mels(s, 15 + s, 18) for s in range(3)]
    hyps, refs = [p[0] for p in pairs], [p[1] for p in pairs]
    got = tmcd.batch_mel_cepstral_distortion(hyps, refs)
    want = jmcd.batch_mel_cepstral_distortion(hyps, refs)
    assert abs(got - want) <= TOL * max(1.0, want)


# ------------------------------------------------------------- the pipeline

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A corpus, a joint run with checkpoints at 1 and 2, a vocoder
    checkpoint (config_v1, fresh weights)."""
    from daspeech_torch.cli import train as ttrain
    from daspeech_torch.config import HiFiGANConfig
    from daspeech_torch.train.checkpoint import CheckpointManager
    from daspeech_torch.train.vocoder_train import VocoderTrainer

    root = tmp_path_factory.mktemp("pipeline")
    write_corpus(root, n=4)
    assert ttrain.main(cli_args(root, "s2s_dag_fastspeech2_loss", "ckpt",
                                "--max-update", "2", "--valid-subset",
                                "none", "--save-interval-updates",
                                "1")) == 0
    voc = VocoderTrainer(HiFiGANConfig(), device="cpu").init_state(
        torch.Generator().manual_seed(0))
    CheckpointManager(root / "vocoder").save(voc, 1)
    return root


def _pipeline_args(root, out, *extra):
    return [str(root), "--checkpoint-dir", str(root / "ckpt"),
            "--device", "cpu", "--results-path", str(root / out),
            "--model-yaml", str(root / "s2s_dag_fastspeech2_loss.yaml"),
            "--vocoder-checkpoint", str(root / "vocoder"),
            "--max-tokens", "256", "--max-mel-len", "24",
            "--average-last-n", "2", *extra]


def test_pipeline_decodes_as_generate_does(trained, capsys):
    from daspeech_torch.cli import eval_pipeline, generate

    assert eval_pipeline.main(_pipeline_args(trained, "pipe",
                                             "--skip-asr")) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"results": str(trained / "pipe")}
    assert generate.main([
        str(trained), "--task", "nat_speech_to_speech", "--device", "cpu",
        "--checkpoint-dir", str(trained / "ckpt"), "--average-last-n", "2",
        "--model-yaml", str(trained / "s2s_dag_fastspeech2_loss.yaml"),
        "--vocoder-checkpoint", str(trained / "vocoder"),
        "--max-tokens", "256", "--max-mel-len", "24",
        "--results-path", str(trained / "gen")]) == 0
    a, b = trained / "pipe", trained / "gen"
    assert (a / "hypos.txt").read_text() == (b / "hypos.txt").read_text()
    feats = sorted(p.name for p in (b / "feat").glob("*.npy"))
    wavs = sorted(p.name for p in (b / "wav").glob("*.wav"))
    assert len(feats) == len(wavs) == 4
    assert sorted(p.name for p in (a / "feat").glob("*.npy")) == feats
    for name in feats:
        np.testing.assert_array_equal(np.load(a / "feat" / name),
                                      np.load(b / "feat" / name))
    for name in wavs:
        assert (a / "wav" / name).read_bytes() == (
            b / "wav" / name).read_bytes()


def test_pipeline_without_the_asr_model(trained, capsys, monkeypatch):
    from daspeech_torch import eval as teval
    from daspeech_torch.cli import eval_pipeline

    monkeypatch.setattr(teval, "asr_available", lambda name: False)
    assert eval_pipeline.main(_pipeline_args(trained, "pipe_asr")) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["asr_bleu"] is None
    assert "not in local cache" in rec["note"]


def test_pipeline_needs_a_card(trained):
    from daspeech_torch.cli import eval_pipeline

    argv = _pipeline_args(trained, "nocard")
    i = argv.index("--device")
    del argv[i: i + 2]
    with pytest.raises(SystemExit) as e:
        eval_pipeline.main(argv)
    assert e.value.code not in (0, None)
    assert not (trained / "nocard").exists()
