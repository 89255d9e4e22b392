"""The port's data preparation (``daspeech_torch/preprocess/prep_data.py``
on ``daspeech_torch/data/audio_utils.py``) against the JAX package's
(``daspeech_tpu/preprocess/prep_data.py``): both are numpy, so every
feature is held bit for bit on seeded waveforms (fbank, log-mel, YIN and
StoneMask pitch, energy, durations, per-phoneme averages, gcmvn), the
manifest pipeline writes the same rows and features, its S2ST TSV loads
through the port's task, and ``write_config_yaml`` round-trips through
the port's ``data_cfg``."""

import csv
import sys

import numpy as np
import pytest

from daspeech_torch.data import audio_utils as tau
from daspeech_torch.preprocess import prep_data as tp
from daspeech_tpu.data import audio_utils as jau
from daspeech_tpu.preprocess import prep_data as jp

SR = 22050


def _voice(seed, seconds=0.4, sr=SR):
    """A harmonic tone with a gliding F0 and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(110, 240) * (1 + 0.05 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum((0.5 / k) * np.sin(k * phase) for k in range(1, 4))
    return (wav + 0.01 * rng.normal(size=t.shape)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_fbank_and_log_mel_equal_jax(seed):
    wav = _voice(seed)
    np.testing.assert_array_equal(tau.kaldi_fbank(wav[::2], 16000),
                                  jau.kaldi_fbank(wav[::2], 16000))
    np.testing.assert_array_equal(tau.log_mel_spectrogram(wav, SR),
                                  jau.log_mel_spectrogram(wav, SR))


@pytest.mark.parametrize("seed", [0, 1])
def test_pitch_and_energy_equal_jax(seed):
    wav = _voice(seed)
    coarse = tp.yin_pitch(wav, SR)
    np.testing.assert_array_equal(coarse, jp.yin_pitch(wav, SR))
    assert (coarse > 0).sum() > 10
    np.testing.assert_array_equal(tp.stonemask_refine(wav, coarse, SR),
                                  jp.stonemask_refine(wav, coarse, SR))
    np.testing.assert_array_equal(tp.yin_stonemask_pitch(wav, SR),
                                  jp.yin_stonemask_pitch(wav, SR))
    np.testing.assert_array_equal(tp.make_pitch_fn("yin")(wav, SR),
                                  jp.make_pitch_fn("yin")(wav, SR))
    np.testing.assert_array_equal(tp.frame_energy(wav), jp.frame_energy(wav))


def test_durations_averages_and_gcmvn_equal_jax():
    ivs = [(0.0, 0.1), (0.1, 0.25), (0.25, 0.4)]
    for total in (None, 34, 40):
        np.testing.assert_array_equal(
            tp.durations_from_intervals(ivs, 256, SR, total),
            jp.durations_from_intervals(ivs, 256, SR, total))
    rng = np.random.default_rng(3)
    vals = rng.uniform(0, 300, 40).astype(np.float32)
    vals[rng.integers(0, 40, 10)] = 0.0
    for excl in (True, False):
        np.testing.assert_array_equal(
            tp.average_by_duration(vals, [10, 0, 18, 12], excl),
            jp.average_by_duration(vals, [10, 0, 18, 12], excl))
    feats = [rng.normal(size=(n, 80)).astype(np.float32) for n in (7, 13)]
    got, want = tp.compute_gcmvn_stats(feats), jp.compute_gcmvn_stats(feats)
    for k in ("mean", "std"):
        np.testing.assert_array_equal(got[k], want[k])


def test_pitch_backends(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyworld", None)     # absent
    with pytest.raises(ImportError, match="pyworld"):
        tp.make_pitch_fn("pyworld")
    with pytest.raises(ValueError, match="unknown pitch_fn"):
        tp.make_pitch_fn("crepe")


def _manifests(pkg, root):
    wavs = [_voice(10 + i, 0.3 + 0.1 * i) for i in range(3)]
    names = [f"utt{i}" for i in range(3)]
    s2t = pkg.extract_s2t_features([w[::2] for w in wavs], names, 11025,
                                   root / "fbank.zip")
    ivs = [[("AA", 0.0, 0.12), ("K", 0.12, 0.2), ("T", 0.2, 0.28)]
           for _ in range(3)]
    tts, gcmvn = pkg.extract_tts_features(wavs, names, ivs, SR,
                                          root / "mel.zip")
    return s2t, tts, gcmvn, pkg.create_s2s_tsv(s2t, tts)


def test_manifest_pipeline_matches_jax_and_loads(tmp_path):
    from daspeech_torch.data import Dictionary
    from daspeech_torch.tasks import NATSpeechToSpeechTask, TaskConfig

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _manifests(tp, tmp_path / "port")
    want = _manifests(jp, tmp_path / "jax")
    for k in ("mean", "std"):
        np.testing.assert_array_equal(got[2][k], want[2][k])

    def strip(rows):      # the zip paths differ by directory only
        return [{k: v for k, v in r.items()
                 if k not in ("audio", "src_audio", "tgt_audio")}
                for r in rows]

    for a, b in ((got[0], want[0]), (got[1], want[1]), (got[3], want[3])):
        assert strip(a) == strip(b)
    for ra, rb in zip(got[3], want[3]):
        for key in ("src_audio", "tgt_audio"):
            np.testing.assert_array_equal(
                tau.get_features_or_waveform(ra[key]),
                jau.get_features_or_waveform(rb[key]))

    # the S2ST manifest trains: the port's task loads and collates it
    root = tmp_path / "port"
    tp.write_tsv(got[3], root / "train.tsv")
    d = Dictionary()
    for s in ("AA", "K", "T"):
        d.add_symbol(s)
    d.save(root / "vocab.txt")
    task = NATSpeechToSpeechTask.setup_task(TaskConfig(data_dir=str(root)))
    task.load_dataset("train")
    it = task.get_batch_iterator("train")
    spec, idxs = it.batches_for_epoch(0)[0]
    batch = it.collate(spec, idxs)
    assert sorted(idxs) == [0, 1, 2]
    assert batch["target_audio"].shape[-1] == 80
    assert np.array_equal(
        batch["durations"][batch["sample_mask"] > 0].sum(1),
        batch["target_audio_lengths"][batch["sample_mask"] > 0])
    with open(root / "train.tsv") as f:
        assert len(list(csv.DictReader(f, delimiter="\t"))) == 3


def test_config_yaml_round_trips_through_the_ports_data_cfg(tmp_path):
    from daspeech_torch.data.data_cfg import S2SDataConfig
    from daspeech_tpu.data.data_cfg import S2SDataConfig as JCfg

    tp.write_config_yaml(tmp_path, gcmvn_stats="gcmvn_stats.npz",
                         vocoder={"type": "hifigan",
                                  "checkpoint": "hifigan_ckpt"})
    got = S2SDataConfig(tmp_path / "config.yaml")
    want = JCfg(tmp_path / "config.yaml")
    assert got.vocab_filename == want.vocab_filename == "vocab.txt"
    for split, train in (("train", True), ("test", False)):
        assert got.transform_names(split, train) == want.transform_names(
            split, train)
    assert got.transform_names("train", True) == ["utterance_cmvn",
                                                   "specaugment"]
    assert got.vocoder == want.vocoder
    assert got.global_cmvn_stats_npz == want.global_cmvn_stats_npz
