"""The port's tasks (``daspeech_torch/tasks.py``) against the JAX package's
(``daspeech_tpu/tasks.py``): noise injection in its four modes with the
same ``np.random.Generator``, task setup from a data directory (with and
without ``config.yaml``), and the batch iterators of the three tasks, bit
for bit over two epochs."""

import csv

import numpy as np
import pytest

from test_data import make_dataset

from daspeech_torch import tasks as t_tasks
from daspeech_torch.config import VocabConfig as TorchVocab
from daspeech_tpu import tasks as j_tasks
from daspeech_tpu.core.config import VocabConfig as JaxVocab


def assert_same(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}/{k}")
    else:
        assert got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)


def write_data_dir(root, n=14, s2s=True, config_yaml=None, seed=3):
    rng = np.random.default_rng(seed)
    d, rows, _ = make_dataset(root, rng, n=n, s2s=s2s)
    for split, part in (("train", rows), ("test", rows[: n // 2])):
        with open(root / f"{split}.tsv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
            w.writeheader()
            w.writerows(part)
    d.save(root / "vocab.txt")
    if config_yaml:
        (root / "config.yaml").write_text(config_yaml)
    return d, rows


@pytest.mark.parametrize("noise", ["full_mask", "random_mask",
                                   "random_delete", "no_noise"])
def test_inject_noise_matches_jax(noise):
    rng = np.random.default_rng(0)
    B, T = 6, 12
    target = rng.integers(4, 30, size=(B, T)).astype(np.int32)
    lens = rng.integers(3, T + 1, size=B)
    for b, n in enumerate(lens):
        target[b, 0], target[b, n - 1] = 0, 2
        target[b, n:] = 1
    got = t_tasks.inject_noise(np.random.default_rng(9), target,
                               TorchVocab(size=30), noise)
    want = j_tasks.inject_noise(np.random.default_rng(9), target,
                                JaxVocab(size=30), noise)
    assert_same(got, want, noise)
    with pytest.raises(ValueError):
        t_tasks.inject_noise(rng, target, TorchVocab(size=30), "bogus")


@pytest.mark.parametrize("yaml_text", [None, "vocab_filename: vocab.txt\n"
                                       "transforms:\n  '*': [utterance_cmvn]\n"])
def test_setup_task_matches_jax(yaml_text, tmp_path):
    write_data_dir(tmp_path, config_yaml=yaml_text)
    for t_cls, j_cls in ((t_tasks.NATSpeechToTextTask,
                          j_tasks.NATSpeechToTextTask),
                         (t_tasks.NATSpeechToSpeechTask,
                          j_tasks.NATSpeechToSpeechTask)):
        t = t_cls.setup_task(t_tasks.TaskConfig(data_dir=str(tmp_path)))
        j = j_cls.setup_task(j_tasks.TaskConfig(data_dir=str(tmp_path)))
        assert t.tgt_dict.symbols == j.tgt_dict.symbols
        fields = ("size", "bos", "pad", "eos", "unk")
        assert [getattr(t.vocab, k) for k in fields] == [
            getattr(j.vocab, k) for k in fields]
        assert (t.data_cfg is None) == (j.data_cfg is None) == (
            yaml_text is None)
        t.load_dataset("train")
        j.load_dataset("train")
        ti, ji = t.datasets["train"][0], j.datasets["train"][0]
        np.testing.assert_array_equal(ti.fbank, ji.fbank)
        np.testing.assert_array_equal(ti.target, ji.target)
        assert t.inject_noise(np.random.default_rng(1), ti.target[None]
                              ).tolist() == j.inject_noise(
            np.random.default_rng(1), ji.target[None]).tolist()


@pytest.mark.parametrize("task", ["s2t", "s2s", "tts"])
def test_batch_iterators_match_jax(task, tmp_path):
    write_data_dir(tmp_path, s2s=True)
    if task == "tts":
        # a TTS manifest: the target mel under 'audio'
        rows = t_tasks.load_tsv(tmp_path / "train.tsv")
        with open(tmp_path / "train.tsv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=[*rows[0], "audio", "n_frames"],
                               delimiter="\t")
            w.writeheader()
            w.writerows({**r, "audio": r["tgt_audio"],
                         "n_frames": r["tgt_n_frames"]} for r in rows)
    t_cls, j_cls = {
        "s2t": (t_tasks.NATSpeechToTextTask, j_tasks.NATSpeechToTextTask),
        "s2s": (t_tasks.NATSpeechToSpeechTask,
                j_tasks.NATSpeechToSpeechTask),
        "tts": (t_tasks.TextToSpeechTask, j_tasks.TextToSpeechTask)}[task]
    cfg = dict(data_dir=str(tmp_path), max_tokens=300, num_buckets=3)
    t = t_cls.setup_task(t_tasks.TaskConfig(**cfg))
    j = j_cls.setup_task(j_tasks.TaskConfig(**cfg))
    t.load_dataset("train")
    j.load_dataset("train")
    kw = {"max_sentences": 4} if task == "tts" else {"max_tokens": 300}
    ti = t.get_batch_iterator("train", seed=5, **kw)
    ji = j.get_batch_iterator("train", seed=5, **kw)
    n = 0
    for epoch in range(2):
        tb, jb = ti.batches_for_epoch(epoch), ji.batches_for_epoch(epoch)
        assert [ix for _, ix in tb] == [ix for _, ix in jb]
        for (ts, idxs), (js, _) in zip(tb, jb):
            assert (ts is None) == (js is None)
            if ts is not None:
                assert vars(ts) == vars(js)
            assert_same(ti.collate(ts, idxs), ji.collate(js, idxs), task)
            n += 1
    assert n >= 4
    assert_same(next(iter(ti)), next(iter(ji)))


def test_build_generator_gives_the_port_generators(tmp_path):
    from daspeech_torch.config import DecodeConfig
    from daspeech_torch.decode import S2SNATGenerator, S2TNATGenerator
    from daspeech_torch.decode.speech_generator import (
        NonAutoregressiveSpeechGenerator)

    write_data_dir(tmp_path)
    cfg = t_tasks.TaskConfig(data_dir=str(tmp_path))
    s2t = t_tasks.NATSpeechToTextTask.setup_task(cfg)
    s2s = t_tasks.NATSpeechToSpeechTask.setup_task(cfg)
    tts = t_tasks.TextToSpeechTask.setup_task(cfg)
    assert type(s2t.build_generator(None, DecodeConfig())) is S2TNATGenerator
    import torch

    lin = torch.nn.Linear(1, 1)
    gen = s2s.build_generator(lin, DecodeConfig(), max_mel_len=64)
    assert type(gen) is S2SNATGenerator and gen.max_mel_len == 64
    gen = tts.build_generator(lin, max_mel_len=32)
    assert type(gen) is NonAutoregressiveSpeechGenerator
    assert gen.max_mel_len == 32
