"""The port's vocoder-training CLI (``python -m
daspeech_torch.cli.train_vocoder``), here with ``--device cpu`` at
HiFi-GAN config_v1 on 2 segments of 1024 samples: two updates from a TSV
of zip-packed and WAV waveforms; its first update equals an in-process
``VocoderTrainer`` update on the same segments, bit for bit; its
checkpoints (``keep_last=3``) load through the generate CLI's
``--vocoder-checkpoint`` path; the JAX CLI's TPU options are not accepted;
without ``--device cpu`` it exits non-zero here."""

import contextlib
import csv
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from daspeech_torch.cli import generate
from daspeech_torch.cli import train_vocoder as tv
from daspeech_torch.preprocess.prep_data import pack_features_to_zip
from daspeech_torch.train.checkpoint import CheckpointManager
from torch_cli_corpus import one_torch_thread  # noqa: F401

SEG = 1024
SEED = 5


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocoder_cli")
    rng = np.random.default_rng(0)
    wavs = [(0.3 * rng.normal(size=n)).astype(np.float32)
            for n in (1500, 2100, 1800)]
    paths = pack_features_to_zip(wavs[:2], ["a", "b"], root / "wav.zip")
    generate.write_wav(root / "c.wav", wavs[2])
    with open(root / "train.tsv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["id", "audio"], delimiter="\t")
        w.writeheader()
        w.writerows([{"id": "a", "audio": paths[0]},
                     {"id": "b", "audio": paths[1]},
                     {"id": "c", "audio": str(root / "c.wav")}])
    return root


def _args(root, *extra):
    return [str(root / "train.tsv"), "--device", "cpu", "--max-update", "2",
            "--batch-size", "2", "--segment-size", str(SEG),
            "--log-interval", "1", "--save-interval-updates", "1",
            "--seed", str(SEED), "--save-dir", str(root / "ck"), *extra]


@pytest.fixture(scope="module")
def trained(data):
    """Two updates through the CLI: the records it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tv.main(_args(data)) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_two_updates_and_the_first_equals_the_trainer(data, trained):
    from daspeech_torch.config import HiFiGANConfig
    from daspeech_torch.train.vocoder_train import (VocoderTrainer,
                                                    make_mel_fn)

    recs = trained
    assert [r["update"] for r in recs] == [1, 2, 2] and recs[-1]["done"]
    for key in ("d_loss", "g_loss", "g_adv", "g_fm", "g_mel"):
        assert np.isfinite(recs[0][key])
    ck = CheckpointManager(data / "ck")
    assert ck.all_steps() == [1, 2]

    # the same first update in-process
    wavs = [tv.load_waveform(r["audio"]) for r in csv.DictReader(
        open(data / "train.tsv"), delimiter="\t")]
    rng = np.random.default_rng(SEED)
    segs = []
    for _ in range(2):
        w = wavs[rng.integers(len(wavs))]
        s = rng.integers(0, len(w) - SEG + 1)
        segs.append(w[s: s + SEG])
    mel_fn = make_mel_fn(device="cpu")
    tr = VocoderTrainer(HiFiGANConfig(), mel_fn=mel_fn, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(SEED))
    wav = torch.from_numpy(np.stack(segs))
    state, m = tr.train_step(state, mel_fn(wav)[:, : SEG // 256], wav)
    saved = ck.restore(step=1)
    for k, v in state.gen.state_dict().items():
        assert torch.equal(saved["gen"][k], v), k
    assert recs[0]["d_loss"] == pytest.approx(float(m["d_loss"]), abs=1e-4)


def test_checkpoint_loads_through_generate(data, trained):
    from daspeech_torch.tasks import NATSpeechToSpeechTask

    args = SimpleNamespace(vocoder_torch=None, vocoder_type="auto",
                           vocoder_checkpoint=str(data / "ck"),
                           vocoder_chunk=0, gcmvn_stats=None)
    task = NATSpeechToSpeechTask(None, None)
    vocoder, gcmvn = generate.load_vocoder_and_gcmvn(args, task, "cpu")
    assert gcmvn is None
    saved = CheckpointManager(data / "ck").restore()["gen"]
    for k, v in vocoder.state_dict().items():
        assert torch.equal(saved[k], v), k
    with torch.inference_mode():
        wav = vocoder(torch.zeros(1, 4, 80))
    assert wav.shape[-1] == 4 * 256


@pytest.mark.parametrize("flags", [["--gen-fold", "128"],
                                   ["--compilation-cache-dir", "x"],
                                   ["--fused-step"]])
def test_tpu_options_are_not_accepted(data, flags):
    with pytest.raises(SystemExit) as e:
        tv.main(_args(data) + flags)
    assert e.value.code == 2


def test_needs_a_card(data):
    argv = _args(data, "--save-dir", str(data / "nocard"))
    i = argv.index("--device")
    del argv[i: i + 2]
    with pytest.raises(SystemExit) as e:
        tv.main(argv)
    assert e.value.code not in (0, None)
    assert not (data / "nocard").exists()
