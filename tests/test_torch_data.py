"""The port's data pipeline (``daspeech_torch/data/``) against the JAX
package's (``daspeech_tpu/data/``), bit for bit: manifests, zip-packed
features, transforms (the same ``np.random.Generator`` draws), the
per-dataset config and its wildcards, the dictionary and encoders, the
native engine against its plain versions and JAX's, bucketed batching over
three epochs, the S2T / S2S / multitask collation, and the prefetcher."""

import json
import sys

import numpy as np
import pytest

from test_data import make_dataset, make_feature_zip

from daspeech_torch.config import VocabConfig as TorchVocab
from daspeech_torch.data import audio_utils as t_audio
from daspeech_torch.data import data_cfg as t_cfg
from daspeech_torch.data import datasets as t_ds
from daspeech_torch.data import dictionary as t_dict
from daspeech_torch.data import encoders as t_enc
from daspeech_torch.data import native as t_native
from daspeech_torch.data import prefetch as t_pf
from daspeech_torch.data import transforms as t_tf
from daspeech_tpu.core.config import VocabConfig as JaxVocab
from daspeech_tpu.data import audio_utils as j_audio
from daspeech_tpu.data import data_cfg as j_cfg
from daspeech_tpu.data import datasets as j_ds
from daspeech_tpu.data import dictionary as j_dict
from daspeech_tpu.data import encoders as j_enc
from daspeech_tpu.data import native as j_native
from daspeech_tpu.data import prefetch as j_pf
from daspeech_tpu.data import transforms as j_tf


def assert_same(got, want, what=""):
    """Equal bits (and dtype) for arrays; equal values for the rest,
    recursively."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def write_tsv(path, rows):
    import csv

    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
        w.writeheader()
        w.writerows(rows)


# --------------------------------------------------------------- audio IO

def test_load_tsv_and_zip_paths(tmp_path):
    rng = np.random.default_rng(0)
    d, rows, feats = make_dataset(tmp_path, rng, n=6, s2s=True)
    write_tsv(tmp_path / "train.tsv", rows)
    got, want = (t_ds.load_tsv(tmp_path / "train.tsv"),
                 j_ds.load_tsv(tmp_path / "train.tsv"))
    assert got == want == [{k: str(v) for k, v in r.items()} for r in rows]
    for r, f in zip(rows, feats):
        for key in ("src_audio", "tgt_audio"):
            assert t_audio.parse_path(r[key]) == j_audio.parse_path(r[key])
            assert_same(t_audio.get_features_or_waveform(r[key]),
                        j_audio.get_features_or_waveform(r[key]), key)
        np.testing.assert_array_equal(
            t_audio.get_features_or_waveform(r["src_audio"]), f)
    npy = tmp_path / "x.npy"
    np.save(npy, feats[0])
    assert_same(t_audio.get_features_or_waveform(str(npy)),
                j_audio.get_features_or_waveform(str(npy)))
    assert t_audio.parse_path("/a/b.zip:100:2000") == ("/a/b.zip", 100, 2000)


def test_features_of_a_waveform():
    rng = np.random.default_rng(1)
    wav = rng.normal(size=8000).astype(np.float32)
    assert_same(t_audio.kaldi_fbank(wav), j_audio.kaldi_fbank(wav))
    assert_same(t_audio.log_mel_spectrogram(wav),
                j_audio.log_mel_spectrogram(wav))


# ------------------------------------------------------------- transforms

@pytest.mark.parametrize("name", ["utterance_cmvn", "global_cmvn",
                                  "specaugment", "specaugment_warp",
                                  "delta_deltas", "compose"])
def test_transform_matches_jax(name, tmp_path):
    rng = np.random.default_rng(2)
    x = rng.normal(3.0, 2.0, size=(90, 20)).astype(np.float32)
    mean = rng.normal(size=20).astype(np.float32)
    std = rng.uniform(0.5, 2.0, size=20).astype(np.float32)
    np.savez(tmp_path / "gcmvn.npz", mean=mean, std=std)

    def build(mod):
        g = lambda: np.random.default_rng(5)  # noqa: E731
        return {
            "utterance_cmvn": lambda: mod.UtteranceCMVN(),
            "global_cmvn": lambda: mod.GlobalCMVN(
                stats_npz_path=str(tmp_path / "gcmvn.npz")),
            "specaugment": lambda: mod.SpecAugment(
                freq_mask_f=8, time_mask_t=20, rng=g()),
            "specaugment_warp": lambda: mod.SpecAugment(
                freq_mask_f=8, time_mask_t=20, time_warp_w=10, rng=g()),
            "delta_deltas": lambda: mod.DeltaDeltas(win_length=5),
            "compose": lambda: mod.Compose([
                mod.UtteranceCMVN(), None,
                mod.SpecAugment(time_warp_w=5, rng=g())]),
        }[name]()

    t, j = build(t_tf), build(j_tf)
    for _ in range(3):                 # the same draws, call after call
        assert_same(t(x), j(x), name)
    if name == "global_cmvn":
        assert_same(t.denormalize(x), j.denormalize(x))


# ------------------------------------------------------------ data config

CONFIG_YAML = """\
vocab_filename: vocab.txt
transforms:
  _train: [utterance_cmvn, specaugment]
  '*': [utterance_cmvn]
  dev_special: [global_cmvn]
feature_transforms:
  _eval: [delta_deltas]
specaugment:
  freq_mask_N: 1
  freq_mask_F: 4
  time_mask_N: 1
  time_mask_T: 10
  time_wrap_W: 5
global_cmvn:
  stats_npz_path: gcmvn.npz
vocoder:
  type: hifigan
  config: hifigan.json
speaker_set_filename: speakers.txt
pre_tokenizer: {tokenizer: space}
bpe_tokenizer: {bpe: characters}
output_sample_rate: 16000
"""


@pytest.mark.parametrize("split,is_train", [
    ("train_a", True), ("dev", False), ("dev_special", False),
    ("test", False)])
def test_data_cfg_wildcards(split, is_train, tmp_path):
    rng = np.random.default_rng(3)
    (tmp_path / "config.yaml").write_text(CONFIG_YAML)
    np.savez(tmp_path / "gcmvn.npz", mean=np.zeros(20, np.float32),
             std=np.full(20, 2.0, np.float32))
    for name in ("hifigan.json", "speakers.txt"):
        (tmp_path / name).write_text("{}")
    t = t_cfg.S2SDataConfig(tmp_path / "config.yaml")
    j = j_cfg.S2SDataConfig(tmp_path / "config.yaml")
    assert t.transform_names(split, is_train) == j.transform_names(
        split, is_train)
    for prop in ("vocab_filename", "sample_rate", "audio_root",
                 "global_cmvn_stats_npz", "speaker_set_filename", "vocoder",
                 "pre_tokenizer", "bpe_tokenizer", "output_sample_rate"):
        assert getattr(t, prop) == getattr(j, prop), prop
    tt = t.get_feature_transforms(split, is_train)
    jt = j.get_feature_transforms(split, is_train)
    # SpecAugment draws from its own default_rng(): reseed both alike
    for comp in (tt, jt):
        for tr in comp.transforms:
            if hasattr(tr, "rng"):
                tr.rng = np.random.default_rng(11)
    x = rng.normal(size=(60, 20)).astype(np.float32)
    assert_same(tt(x), jt(x))


def test_no_config_yaml_needs_no_pyyaml(tmp_path, monkeypatch):
    """A data directory without config.yaml: an empty config and no
    transforms, without importing PyYAML (absent on some machines)."""
    monkeypatch.setitem(sys.modules, "yaml", None)     # import yaml fails
    cfg = t_cfg.S2TDataConfig(tmp_path / "config.yaml")
    assert cfg.config == {}
    assert cfg.get_feature_transforms("train", True) is None
    assert cfg.vocab_filename == "vocab.txt"
    (tmp_path / "config.yaml").write_text(CONFIG_YAML)
    with pytest.raises(ImportError):
        t_cfg.S2TDataConfig(tmp_path / "config.yaml")


# ------------------------------------------------- dictionary and encoders

def test_dictionary_matches_jax(tmp_path):
    t, j = t_dict.Dictionary(), j_dict.Dictionary()
    for s in ["AA", "B", "C", "AA"]:
        assert t.add_symbol(s) == j.add_symbol(s)
    line = "AA C B UNSEEN"
    for kw in ({}, {"prepend_bos": True}, {"append_eos": False}):
        assert_same(t.encode_line(line, **kw), j.encode_line(line, **kw))
    ids = t.encode_line(line, prepend_bos=True)
    for rs in (True, False):
        assert t.string(ids, rs) == j.string(ids, rs)
    t.save(tmp_path / "t.txt")
    j.save(tmp_path / "j.txt")
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    t2, j2 = (t_dict.Dictionary.load(tmp_path / "t.txt"),
              j_dict.Dictionary.load(tmp_path / "t.txt"))
    assert t2.symbols == j2.symbols and t2.indices == j2.indices
    assert len(t2) == len(j2) and t2[99] == j2[99]


@pytest.mark.parametrize("kind,cfg", [
    ("tokenizer", None), ("tokenizer", {"tokenizer": "space"}),
    ("bpe", None), ("bpe", {"bpe": "characters"}), ("bpe", {"bpe": "bytes"})])
def test_encoders_match_jax(kind, cfg):
    text = "  Hello,   wörld  of  speech "
    build = "build_tokenizer" if kind == "tokenizer" else "build_bpe"
    t, j = getattr(t_enc, build)(cfg), getattr(j_enc, build)(cfg)
    enc = t.encode(text)
    assert enc == j.encode(text)
    assert t.decode(enc) == j.decode(enc)
    with pytest.raises(ValueError):
        getattr(t_enc, build)({kind if kind == "bpe" else "tokenizer":
                               "no_such"})


@pytest.mark.parametrize("name,package", [("moses", "sacremoses"),
                                          ("sentencepiece", "sentencepiece")])
def test_optional_encoders_name_their_package(name, package, monkeypatch):
    monkeypatch.setitem(sys.modules, package, None)     # import fails
    with pytest.raises(ImportError, match=package):
        if name == "moses":
            t_enc.build_tokenizer({"tokenizer": "moses"})
        else:
            t_enc.build_bpe({"bpe": "sentencepiece",
                             "sentencepiece_model": "m.model"})


# ------------------------------------------------------------------ native

def test_batch_by_size_native_plain_and_jax():
    rng = np.random.default_rng(0)
    num_tokens = rng.integers(5, 200, size=500).astype(np.int64)
    order = np.argsort(num_tokens, kind="stable").astype(np.int64)
    for args in ((1000, 16, 8), (200, 0, 1), (0, 7, 3), (5000, 0, 8)):
        got = t_native.batch_by_size(order, num_tokens, *args)
        plain = t_native.batch_by_size_plain(order, num_tokens, *args)
        jax_native = j_native.batch_by_size(order, num_tokens, *args)
        jax_plain = j_native._batch_by_size_py(order, num_tokens, *args)
        for other in (plain, jax_native, jax_plain):
            assert len(got) == len(other)
            for g, w in zip(got, other):
                np.testing.assert_array_equal(g, w)
    # an oversized sample lands alone
    nt = np.asarray([50, 3000, 60, 70], np.int64)
    got = t_native.batch_by_size(np.arange(4), nt, max_tokens=200)
    assert [list(b) for b in got] == [
        list(b) for b in t_native.batch_by_size_plain(np.arange(4), nt, 200)]
    assert t_native.batch_by_size(np.zeros(0), nt) == []


def test_pack_native_plain_and_jax():
    rng = np.random.default_rng(1)
    mats = [rng.normal(size=(int(n), 80)).astype(np.float32)
            for n in rng.integers(1, 40, size=7)]
    seqs = [rng.integers(0, 50, size=int(n)).astype(np.int32)
            for n in rng.integers(1, 20, size=7)]
    for cap in (8, 39, 64):
        got = t_native.pack_frames(mats, cap)
        for want in (t_native.pack_frames_plain(mats, cap),
                     j_native.pack_frames(mats, cap)):
            assert_same(got, want)
        got = t_native.pack_tokens(seqs, cap, 1)
        for want in (t_native.pack_tokens_plain(seqs, cap, 1),
                     j_native.pack_tokens(seqs, cap, 1)):
            assert_same(got, want)


def test_native_builds_outside_native_dir_and_failure_raises(tmp_path):
    lib = t_native.build()
    assert lib.parent == t_native.BUILD_DIR
    assert lib.parent.name == "daspeech_torch" and lib.name.endswith(".so")
    assert "native" not in lib.parent.parts[-2:]
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="native data engine"):
        t_native.build(broken, tmp_path / "out")
    assert not list((tmp_path / "out").glob("*.so"))


# ---------------------------------------------------------------- batching

def _batchers(tmp_path, n=16, s2s=False, multitask=False, seed=7):
    rng = np.random.default_rng(4)
    d, rows, _ = make_dataset(tmp_path, rng, n=n, s2s=s2s)
    out = []
    for ds_mod, vocab_cls, dict_mod in ((t_ds, TorchVocab, t_dict),
                                        (j_ds, JaxVocab, j_dict)):
        dd = dict_mod.Dictionary()
        for s in d.symbols[dd.nspecial:]:
            dd.add_symbol(s)
        cls = (ds_mod.NATSpeechToSpeechDataset if s2s else
               ds_mod.NATSpeechToTextMultitaskDataset if multitask
               else ds_mod.NATSpeechToTextDataset)
        ds = cls(rows, dd, upsample_scale=0.5)
        if multitask:
            ds.add_multitask_dataset("source_letter",
                                     ds_mod.NATTextTargetMultitaskData(
                                         rows[: n // 2], dd))
        lengths = [ds.n_frames(i) for i in range(len(ds))]
        specs = ds_mod.make_buckets(
            lengths, max_tokens=256, num_buckets=3, src_mult=16, tgt_cap=16,
            mel_per_src=1.0 if s2s else 0.0, mel_mult=16)
        keep = ds.filter_indices(1000, 100)
        out.append(ds_mod.BucketBatcher(
            ds, keep, specs, seed=seed, vocab=vocab_cls(size=len(dd)),
            for_s2s=s2s))
    return out


def test_buckets_and_epochs_match_jax(tmp_path):
    t, j = _batchers(tmp_path)
    assert t.specs == [t_ds.BucketSpec(**vars(s)) for s in j.specs]
    for epoch in range(3):
        tb, jb = t.batches_for_epoch(epoch), j.batches_for_epoch(epoch)
        assert [(vars(s), ix) for s, ix in tb] == [
            (vars(s), ix) for s, ix in jb]
    assert t.batches_for_epoch(0) != t.batches_for_epoch(1)
    for n in (0, 15, 16, 17, 200):
        assert vars(t_ds.pick_bucket(t.specs, n)) == vars(
            j_ds.pick_bucket(j.specs, n))


@pytest.mark.parametrize("kind", ["s2t", "s2s", "multitask"])
def test_collate_matches_jax(kind, tmp_path):
    t, j = _batchers(tmp_path, s2s=kind == "s2s",
                     multitask=kind == "multitask")
    for (spec, idxs), (jspec, _) in zip(t.batches_for_epoch(1),
                                        j.batches_for_epoch(1)):
        assert_same(t.collate(spec, idxs), j.collate(jspec, idxs), kind)
        assert_same(t.collate(spec, idxs, pad_last=False),
                    j.collate(jspec, idxs, pad_last=False), kind)


def test_tts_dataset_and_collate_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    d, rows, _ = make_dataset(tmp_path, rng, n=5, s2s=True)
    for r in rows:
        r["audio"] = r["tgt_audio"]
        r["n_frames"] = r["tgt_n_frames"]
        r["speaker"] = "a" if int(r["id"][3:]) % 2 else "b"
    items = []
    for ds_mod, dict_mod in ((t_ds, t_dict), (j_ds, j_dict)):
        dd = dict_mod.Dictionary()
        for s in d.symbols[dd.nspecial:]:
            dd.add_symbol(s)
        ds = ds_mod.TextToSpeechDataset(rows, dd, {"a": 0, "b": 1})
        items.append(ds_mod.collate_tts([ds[i] for i in range(5)], dd.pad(),
                                        tok_cap=8, mel_cap=64, batch=6))
    assert_same(*items)


# ---------------------------------------------------------------- prefetch

def test_prefetcher_order_and_errors():
    assert list(t_pf.Prefetcher(lambda: iter(range(20)), depth=3)) == list(
        j_pf.Prefetcher(lambda: iter(range(20)), depth=3))

    def bad():
        yield 1
        raise ValueError("boom")

    for mod in (t_pf, j_pf):
        it = iter(mod.Prefetcher(bad, depth=2))
        assert next(it) == 1
        with pytest.raises(ValueError, match="boom"):
            list(it)


def test_prefetch_epoch_to_device_and_resume(tmp_path):
    """``prefetch_epoch`` yields JAX's batches in JAX's order; ``to_device``
    makes tensors (int64 indices) on the producer thread; a resumed epoch
    starts at its batch index and collates no skipped batch."""
    import torch

    t, j = _batchers(tmp_path, s2s=True)
    want = list(j_pf.prefetch_epoch(j, 2))
    got = list(t_pf.prefetch_epoch(t, 2))
    assert len(got) == len(want) >= 2
    for (s1, b1), (s2, b2) in zip(got, want):
        assert vars(s1) == vars(s2)
        assert_same(b1, b2)

    collated = []
    orig = t.collate
    t.collate = lambda spec, idxs, **kw: (collated.append(list(idxs)),
                                          orig(spec, idxs, **kw))[1]
    moved = list(t_pf.prefetch_epoch(
        t, 2, start=1, to_device=lambda b: t_pf.to_device(b, "cpu")))
    assert collated == [ix for _, ix in t.batches_for_epoch(2)[1:]]
    assert len(moved) == len(want) - 1
    for (_, b), (_, w) in zip(moved, want[1:]):
        for k, v in w.items():
            assert isinstance(b[k], torch.Tensor)
            assert b[k].dtype == (torch.int64 if v.dtype.kind in "iu"
                                  else torch.from_numpy(v).dtype)
            np.testing.assert_array_equal(b[k].numpy(), v)


def test_make_feature_zip_fixture_is_the_reference_layout(tmp_path):
    """The fixture's stored zip reads back through both packages alike
    (the packed layout of ``tests/test_data.py``)."""
    paths, feats = make_feature_zip(tmp_path, 3, np.random.default_rng(6))
    for p, f in zip(paths, feats):
        assert_same(t_audio.get_features_or_waveform(p), f)
    assert json.dumps(t_audio.parse_path(paths[0])) == json.dumps(
        j_audio.parse_path(paths[0]))
