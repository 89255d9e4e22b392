"""The port's generate CLI (``python -m daspeech_torch.cli.generate``, run
here with ``--device cpu``) against the JAX package's
(``daspeech_tpu.cli.generate``) on one on-disk data directory (zip-packed
fbank, ``tests/test_data.py::make_dataset``) and one fabricated fairseq
``.pt`` (``tests/test_s2s_import_structure.py::fabricate_sd``):

* S2ST and S2TT: ``hypos.txt`` identical, ``feat/*.npy`` within 1e-2 (the
  composed two-pass bar);
* S2ST with a hifi-gan ``.pt`` (``--vocoder-torch``, config_v1 keys,
  weight norm): the wavs within 1e-3, ``tests/test_torch_slice.py``'s bar;
* ``nat_tts`` from a FastSpeech 2 checkpoint of each package: mels within
  1e-3 (FastSpeech 2's bar);
* ``--checkpoint-dir`` (with ``--average-last-n``) against the in-process
  ``S2SNATGenerator`` on the CLI's own batches: the same tokens and the
  same feature bits;
* ``--vocoder-quant bf16|int8|int8-skip1``, one-shot and with
  ``--vocoder-chunk``, serves wavs of the fp32 run's lengths; the int8
  rungs' chunked wavs equal their one-shot ones within 1e-5 (the chunked
  run calibrates one-shot too), and ``--vocoder-calib-batches`` reaches
  the vocoder;
* ``--generator-type at_tts`` and ``at_s2s``, the length beam's
  ``--reranker-dir`` and ``--vocoder-type griffin_lim`` against JAX's CLI
  on one set of weights;
* without ``--device cpu`` the CLI exits non-zero here and writes
  nothing.
"""

import csv
import json

import numpy as np
import pytest
import torch
import yaml

from test_data import make_dataset
from test_s2s_import_structure import (
    CC, D_DEC, D_ENC, FFN, H, MAXPOS, NBINS, TTS_D, TTS_FFN, V,
    fabricate_sd, flax_cfg)
from test_torch_fairseq_import import hifigan_sd, port_cfg

from daspeech_torch.cli import generate as tgen
from daspeech_torch.config import DecodeConfig, HiFiGANConfig
from daspeech_torch.models import S2SConformerDAGFastSpeech2, S2TConformerDAG
from daspeech_torch.tasks import (NATSpeechToSpeechTask, NATSpeechToTextTask,
                                  TaskConfig)
from daspeech_torch.train import GuardedAdam, TrainState
from daspeech_torch.train.checkpoint import CheckpointManager
from daspeech_torch.train.fairseq_import import (import_s2s_daspeech,
                                                 import_s2t_conformer_dag)

FEAT_TOL = 1e-2
WAV_TOL = 1e-3
TTS_TOL = 1e-3
MODEL_YAML = {
    "dag": {
        "encoder": {"embed_dim": D_ENC, "ffn_dim": 2 * D_ENC,
                    "num_layers": 1, "num_heads": 2, "conv_channels": CC,
                    "depthwise_kernel_size": 7},
        "decoder": {"embed_dim": D_DEC, "ffn_dim": FFN, "num_layers": 1,
                    "num_heads": H, "max_target_positions": MAXPOS}},
    "tts": {"encoder_layers": 1, "encoder_embed_dim": TTS_D,
            "encoder_heads": 2, "decoder_layers": 1,
            "decoder_embed_dim": TTS_D, "decoder_heads": 2,
            "fft_hidden_dim": TTS_FFN, "fft_kernel_size": 9,
            "var_pred_hidden_dim": TTS_FFN, "var_pred_kernel_size": 3,
            "var_pred_n_bins": NBINS},
    "adaptor_ffn_dim": TTS_FFN,
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The data directory (5 S2ST utterances, vocab padded to the
    checkpoint's size), the model YAML and the fabricated ``.pt``."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(7)
    d, rows, _ = make_dataset(root, rng, n=5, s2s=True)
    while len(d) < V:
        d.add_symbol(f"PH{len(d)}")
    for r in rows:         # the TTS route reads 'audio' as its target mel
        r["audio"], r["n_frames"] = r["tgt_audio"], r["tgt_n_frames"]
    with open(root / "test.tsv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
        w.writeheader()
        w.writerows(rows)
    d.save(root / "vocab.txt")
    (root / "s2s.yaml").write_text(yaml.safe_dump(MODEL_YAML))
    (root / "s2t.yaml").write_text(yaml.safe_dump(MODEL_YAML["dag"]))
    (root / "tts.yaml").write_text(yaml.safe_dump(MODEL_YAML["tts"]))
    sd = fabricate_sd()
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               root / "daspeech.pt")
    return root


def _common(root, out, task="nat_speech_to_speech"):
    return [str(root), "--task", task, "--gen-subset", "test",
            "--results-path", str(root / out), "--max-tokens", "512",
            "--max-mel-len", "32"]


def run_both(root, tag, extra=(), task="nat_speech_to_speech",
             yaml_name="s2s.yaml", jax_extra=(), port_extra=()):
    """Run JAX's CLI and the port's on the same arguments; returns the two
    results directories."""
    from daspeech_tpu.cli.generate import main as jax_main

    args = [*extra, "--model-yaml", str(root / yaml_name)]
    assert jax_main(_common(root, f"{tag}_jax", task) + args
                    + list(jax_extra)) == 0
    assert tgen.main(_common(root, f"{tag}_port", task) + args
                     + ["--device", "cpu", *port_extra]) == 0
    return root / f"{tag}_jax", root / f"{tag}_port"


def compare_outputs(jax_dir, port_dir, n, hypos=True, tol=FEAT_TOL):
    if hypos:
        assert (port_dir / "hypos.txt").read_text() == (
            jax_dir / "hypos.txt").read_text()
        assert len((port_dir / "hypos.txt").read_text().splitlines()) == n
    feats = sorted(p.name for p in (jax_dir / "feat").glob("*.npy"))
    assert sorted(p.name for p in (port_dir / "feat").glob("*.npy")) == feats
    for name in feats:
        j = np.load(jax_dir / "feat" / name)
        p = np.load(port_dir / "feat" / name)
        assert p.shape == j.shape and p.shape[0] == 80
        np.testing.assert_allclose(p, j, rtol=0, atol=tol, err_msg=name)
    return feats


@pytest.mark.parametrize("task", ["nat_speech_to_speech",
                                  "nat_speech_to_text"])
def test_matches_jax_cli(task, setup, capsys):
    jd, pd = run_both(setup, task, ["--model-torch",
                                    str(setup / "daspeech.pt")], task=task,
                      yaml_name=("s2s.yaml" if task == "nat_speech_to_speech"
                                 else "s2t.yaml"))
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"generated": 5, "results": str(pd)}
    feats = compare_outputs(jd, pd, 5)
    assert len(feats) == (5 if task == "nat_speech_to_speech" else 0)


def test_vocoder_torch_matches_jax_cli(setup):
    cfg = HiFiGANConfig()                     # config_v1, as both CLIs
    sd = hifigan_sd(cfg, seed=3)
    for k in [k for k in sd if k.endswith("weight_g")]:
        sd[k] *= 0.3           # modest gains: no saturated tanh
    path = setup / "g_v1.pt"
    torch.save({"generator": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    jd, pd = run_both(setup, "voc", ["--model-torch",
                                     str(setup / "daspeech.pt"),
                                     "--vocoder-torch", str(path)])
    feats = compare_outputs(jd, pd, 5)
    for name in feats:
        utt = name[:-4]
        jw, jsr = tgen.read_wav(jd / "wav" / f"{utt}_pred.wav")
        pw, psr = tgen.read_wav(pd / "wav" / f"{utt}_pred.wav")
        assert jsr == psr == 22050
        assert pw.shape == jw.shape and len(pw) == np.load(
            pd / "feat" / name).shape[1] * 256
        np.testing.assert_allclose(pw, jw, rtol=0, atol=WAV_TOL)


def _voc_pt(setup):
    path = setup / "g_v1.pt"
    if not path.exists():
        sd = hifigan_sd(HiFiGANConfig(), seed=3)
        for k in [k for k in sd if k.endswith("weight_g")]:
            sd[k] *= 0.3
        torch.save({"generator": {k: torch.from_numpy(v)
                                  for k, v in sd.items()}}, path)
    return path


def _tts_variables():
    """The FastSpeech 2 weights of ``test_nat_tts_matches_jax_cli``: the
    fabricated checkpoint's, durations of ~4 frames a token."""
    from daspeech_tpu.train.torch_import import import_fastspeech2

    sd = {"encoder." + k[4:]: v for k, v in fabricate_sd().items()
          if k.startswith("tts.")}
    sd["encoder.embed_tokens.weight"] = np.random.default_rng(4).normal(
        0, 0.3, size=(V, TTS_D)).astype(np.float32)
    sd["encoder.var_adaptor.duration_predictor.proj.weight"][:] = 0
    sd["encoder.var_adaptor.duration_predictor.proj.bias"][:] = np.log(4.0)
    return import_fastspeech2(sd, flax_cfg().tts)


def _port_wavs(setup, tag, flags):
    """The wavs of the port's ``nat_tts`` route (mels up to 64 frames) with
    the config_v1 vocoder of ``_voc_pt`` and ``flags``."""
    from daspeech_torch import convert
    from daspeech_torch.models import FastSpeech2Encoder

    ckpt = setup / "tts_rung_ckpt"
    if not ckpt.exists():
        model = convert.load_flax_(FastSpeech2Encoder(port_cfg().tts, V, 1),
                                   _tts_variables())
        CheckpointManager(ckpt).save(TrainState.create(model, GuardedAdam()),
                                     1)
    out = setup / tag
    assert out.exists() or tgen.main(_common(setup, tag, "text_to_speech") + [
        "--model-yaml", str(setup / "tts.yaml"), "--device", "cpu",
        "--generator-type", "nat_tts", "--checkpoint-dir", str(ckpt),
        "--max-mel-len", "64", "--vocoder-torch", str(_voc_pt(setup)),
        *flags]) == 0
    return {p.name: tgen.read_wav(p)[0] for p in (out / "wav").glob("*.wav")}


@pytest.mark.parametrize("quant", ["bf16", "int8", "int8-skip1"])
def test_vocoder_quant_rungs_serve(quant, setup):
    base = _port_wavs(setup, "rung_fp32", [])
    assert len(base) == 5
    got = {c: _port_wavs(setup, f"rung_{quant}_{c}",
                         ["--vocoder-quant", quant, "--vocoder-chunk", str(c),
                          "--vocoder-calib-batches", "2"])
           for c in (0, 4)}
    assert sum(w.size for w in base.values()) > 0
    for name, want in base.items():
        for c, wavs in got.items():
            w = wavs[name]
            assert w.shape == want.shape and np.isfinite(w).all()
            if want.size:
                assert 0 < np.linalg.norm(w - want) < 0.5 * np.linalg.norm(
                    want)
        if quant != "bf16":
            np.testing.assert_allclose(got[4][name], got[0][name], rtol=0,
                                       atol=1e-5, err_msg=name)
    args = tgen.parse_args([str(setup), "--vocoder-torch",
                            str(_voc_pt(setup)), "--vocoder-quant", quant,
                            "--vocoder-calib-batches", "3"])
    task = NATSpeechToSpeechTask.setup_task(TaskConfig(data_dir=str(setup)))
    voc, _ = tgen.load_vocoder_and_gcmvn(args, task, "cpu")
    assert voc.serve_calib_batches == 3
    assert voc.quant_int8 == quant.startswith("int8")
    assert voc.quant_skip_levels == (quant == "int8-skip1")
    assert voc.dtype == (torch.bfloat16 if quant == "bf16"
                         else torch.float32)


def test_nat_tts_matches_jax_cli(setup):
    """``--generator-type nat_tts`` from each package's own checkpoint of
    the same FastSpeech 2 weights."""
    import jax

    from daspeech_torch import convert
    from daspeech_torch.models import FastSpeech2Encoder
    from daspeech_tpu.train import TrainState as JaxTrainState
    from daspeech_tpu.train import make_optimizer
    from daspeech_tpu.train.checkpoint import CheckpointManager as JaxManager
    from daspeech_tpu.train.torch_import import import_fastspeech2

    cfg = flax_cfg().tts
    sd = {"encoder." + k[4:]: v for k, v in fabricate_sd().items()
          if k.startswith("tts.")}
    sd["encoder.embed_tokens.weight"] = np.random.default_rng(4).normal(
        0, 0.3, size=(V, TTS_D)).astype(np.float32)
    # durations of ~3 frames a token, so that the mels are not empty
    sd["encoder.var_adaptor.duration_predictor.proj.weight"][:] = 0
    sd["encoder.var_adaptor.duration_predictor.proj.bias"][:] = np.log(4.0)
    variables = import_fastspeech2(sd, cfg)
    state = JaxTrainState.create(jax.tree.map(np.asarray, variables),
                                 make_optimizer())
    JaxManager(setup / "tts_jax_ckpt").save(state, 1)
    model = convert.load_flax_(FastSpeech2Encoder(port_cfg().tts, V, 1),
                               variables)
    CheckpointManager(setup / "tts_port_ckpt").save(
        TrainState.create(model, GuardedAdam()), 1)
    jd, pd = run_both(
        setup, "tts", ["--generator-type", "nat_tts"], task="text_to_speech",
        yaml_name="tts.yaml",
        jax_extra=["--checkpoint-dir", str(setup / "tts_jax_ckpt")],
        port_extra=["--checkpoint-dir", str(setup / "tts_port_ckpt")])
    feats = compare_outputs(jd, pd, 5, hypos=False, tol=TTS_TOL)
    assert len(feats) == 5
    assert all(np.load(pd / "feat" / f).shape[1] > 0 for f in feats)


def test_checkpoint_dir_matches_in_process_generator(setup):
    """The port's own checkpoints (two saves of the same weights, averaged)
    through the CLI give the in-process generator's tokens and feature bits
    on the CLI's batches."""
    cfg = port_cfg()
    model = S2SConformerDAGFastSpeech2(cfg)
    model.load_state_dict(import_s2s_daspeech(fabricate_sd(), 1, 1, cfg.tts))
    ckpt = CheckpointManager(setup / "s2s_port_ckpt", keep_last=3)
    for step in (1, 2):
        ckpt.save(TrainState.create(model, GuardedAdam()), step)
    out = setup / "ckpt_port"
    assert tgen.main(_common(setup, "ckpt_port") + [
        "--model-yaml", str(setup / "s2s.yaml"), "--device", "cpu",
        "--checkpoint-dir", str(setup / "s2s_port_ckpt"),
        "--average-last-n", "2"]) == 0

    task = NATSpeechToSpeechTask.setup_task(TaskConfig(
        data_dir=str(setup), max_tokens=512))
    task.load_dataset("test")
    it = task.get_batch_iterator("test")
    gen = task.build_generator(model.eval(), DecodeConfig(), max_mel_len=32)
    lines = []
    for spec, idxs in it.batches_for_epoch(0):
        hypos = gen.generate(it.collate(spec, idxs, pad_last=False))
        for local, h in zip(idxs, hypos):
            utt = it.dataset.rows[local]["id"]
            lines.append(f"{utt}\t{task.tgt_dict.string(h['tokens'])}")
            np.testing.assert_array_equal(
                np.load(out / "feat" / f"{utt}.npy"), h["feature"].T)
    assert (out / "hypos.txt").read_text().splitlines() == lines


AR_TTS_YAML = {"embed_dim": 16, "ffn_dim": 32, "encoder_layers": 1,
               "decoder_layers": 1, "num_heads": 2, "prenet_dim": 16}
MDEC_YAML = {"encoder_embed_dim": D_ENC, "encoder_layers": 1,
             "encoder_heads": 2, "mt_embed_dim": 16, "mt_layers": 1,
             "mt_heads": 2, "ffn_dim": 32, "synth_encoder_layers": 1,
             "tts_decoder_layers": 1, "prenet_dim": 16,
             "conv_channels": 16, "depthwise_kernel_size": 7}


def _ar_checkpoints(setup, kind):
    """(JAX checkpoint dir, port checkpoint dir, YAML) of one set of random
    weights of an AR model (``kind`` "at_tts" or "mdec"), each package's
    own format."""
    import jax

    from daspeech_torch import convert
    from daspeech_torch.config import MultiDecoderConfig as TMD
    from daspeech_torch.config import TTSTransformerConfig as TTT
    from daspeech_torch.config import VocabConfig
    from daspeech_tpu.models.s2s_multidecoder import S2SMultiDecoderModel
    from daspeech_tpu.models.tts_transformer import TTSTransformer
    from daspeech_tpu.train import TrainState as JaxTrainState
    from daspeech_tpu.train import make_optimizer
    from daspeech_tpu.train.checkpoint import CheckpointManager as JaxManager
    from test_torch_models import random_variables

    jdir, pdir = setup / f"{kind}_jax_ckpt", setup / f"{kind}_port_ckpt"
    yml = setup / f"{kind}.yaml"
    if jdir.exists():
        return jdir, pdir, yml
    if kind == "at_tts":
        yml.write_text(yaml.safe_dump(AR_TTS_YAML))
        jm = TTSTransformer(vocab_size=V, pad=1, **AR_TTS_YAML)
        v = random_variables(jm, 8, np.full((2, 5), 4, np.int32),
                             np.zeros((2, 6, 80), np.float32))
        tm = convert.tts_transformer_from_flax(v, TTT(**AR_TTS_YAML), V, 1,
                                               "cpu")
    else:
        yml.write_text(yaml.safe_dump(MDEC_YAML))
        jm = S2SMultiDecoderModel(vocab_size=V, pad=1, bos=0, eos=2,
                                  **MDEC_YAML)
        v = random_variables(jm, 9, np.zeros((2, 40, 80), np.float32),
                             np.array([40, 32], np.int32),
                             np.full((2, 5), 4, np.int32),
                             np.zeros((2, 6, 80), np.float32))
        # random weights emit <s> at every step; without the <s>, <pad>
        # and <unk> logits (rows 0, 1, 3 of the tied table) and with
        # <eos>'s scaled, one utterance ends at once and the others emit
        # words up to the budget
        emb = v["params"]["mt_decoder"]["embed_tokens"]["embedding"]
        emb[[0, 1, 3]] = 0.0
        emb[2] *= 0.75
        tm = convert.multidecoder_from_flax(v, TMD(**MDEC_YAML),
                                            VocabConfig(size=V), "cpu")
    JaxManager(jdir).save(JaxTrainState.create(
        jax.tree.map(np.asarray, v), make_optimizer()), 1)
    CheckpointManager(pdir).save(TrainState.create(tm, GuardedAdam()), 1)
    return jdir, pdir, yml


@pytest.mark.parametrize("flags", [
    ["--generator-type", "at_tts"],
    ["--generator-type", "at_s2s"],
    ["--reranker-dir", "RERANKER"],
    ["--vocoder-type", "griffin_lim"],
], ids=["at_tts", "at_s2s", "reranker", "griffin_lim"])
def test_ar_routes_and_griffin_lim_match_jax_cli(flags, setup):
    """The options the port once refused, run by both CLIs on one set of
    weights: ``at_tts`` (mels within 1e-3), ``at_s2s`` (the same
    hypotheses, mels within 1e-3), the length beam of 3 reranked by an
    ``s2s_multidecoder`` checkpoint (the same hypotheses) and Griffin-Lim
    on the S2ST route (the wavs within a relative L2 of 1e-3)."""
    name = flags[-1].lower()
    if name == "at_tts":
        jdir, pdir, yml = _ar_checkpoints(setup, "at_tts")
        jd, pd = run_both(setup, name, flags + ["--max-mel-len", "16"],
                          task="text_to_speech", yaml_name=yml.name,
                          jax_extra=["--checkpoint-dir", str(jdir)],
                          port_extra=["--checkpoint-dir", str(pdir)])
        assert len(compare_outputs(jd, pd, 5, hypos=False,
                                   tol=TTS_TOL)) == 5
    elif name == "at_s2s":
        jdir, pdir, yml = _ar_checkpoints(setup, "mdec")
        jd, pd = run_both(setup, name, flags + ["--max-mel-len", "12",
                                                "--max-text-len", "6"],
                          yaml_name=yml.name,
                          jax_extra=["--checkpoint-dir", str(jdir)],
                          port_extra=["--checkpoint-dir", str(pdir)])
        assert len(compare_outputs(jd, pd, 5, tol=TTS_TOL)) == 5
        hyps = (pd / "hypos.txt").read_text().splitlines()
        assert sum(len(h.split("\t")[1]) > 0 for h in hyps) == 4
    elif name == "reranker":
        jdir, pdir, yml = _ar_checkpoints(setup, "mdec")
        common = ["--model-torch", str(setup / "daspeech.pt"),
                  "--length-beam", "3", "--reranker-yaml", str(yml)]
        jd, pd = run_both(setup, name, common, task="nat_speech_to_text",
                          yaml_name="s2t.yaml",
                          jax_extra=["--reranker-dir", str(jdir)],
                          port_extra=["--reranker-dir", str(pdir)])
        compare_outputs(jd, pd, 5)
    else:
        jd, pd = run_both(setup, name, flags + [
            "--model-torch", str(setup / "daspeech.pt")])
        feats = compare_outputs(jd, pd, 5)
        for f in feats:
            jw, _ = tgen.read_wav(jd / "wav" / f"{f[:-4]}_pred.wav")
            pw, _ = tgen.read_wav(pd / "wav" / f"{f[:-4]}_pred.wav")
            assert pw.shape == jw.shape and len(pw) == np.load(
                pd / "feat" / f).shape[1] * 256
            assert np.linalg.norm(pw - jw) <= 1e-3 * np.linalg.norm(jw)


def test_model_configs_and_missing_weights(setup):
    from daspeech_torch.config import MultiDecoderConfig, TTSTransformerConfig

    assert tgen.build_model_cfg("tts_transformer", None,
                                None) == TTSTransformerConfig()
    assert tgen.build_model_cfg("s2s_multidecoder", str(setup / "s2t.yaml"),
                                None) == MultiDecoderConfig()
    with pytest.raises(SystemExit, match="--checkpoint-dir or --model-torch"):
        tgen.main(_common(setup, "none") + ["--device", "cpu"])


def test_default_device_needs_a_card(setup, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine with no card")
    with pytest.raises(SystemExit) as exit_:
        tgen.main(_common(setup, "no_card") + [
            "--model-torch", str(setup / "daspeech.pt"),
            "--model-yaml", str(setup / "s2s.yaml")])
    assert exit_.value.code not in (0, None)
    assert "--device cpu" in str(exit_.value.code)
    assert capsys.readouterr().out == ""
    assert not (setup / "no_card").exists()


@pytest.mark.parametrize("flags", [
    ["--decode-strategy", "beamsearch", "--decode-beamsize", "4",
     "--decode-top-cand-n", "3", "--decode-top-p", "1.0", "--decode-dedup",
     "--decode-alpha", "1.0", "--max-output-length", "6"],
    ["--decode-strategy", "jointviterbi", "--decode-beta", "0.5",
     "--decode-viterbibeta", "1.5"],
    ["--length-beam", "3"],
    ["--iter-decode-max-iter", "2", "--iter-decode-force-max-iter"],
])
def test_decode_flags_reach_the_generator(flags, setup):
    """The S2TT route's decode flags give the tokens of the in-process
    ``S2TNATGenerator`` built with the same ``DecodeConfig``."""
    out = setup / f"flags_{flags[1]}"
    assert tgen.main(_common(setup, out.name, "nat_speech_to_text") + [
        "--model-yaml", str(setup / "s2t.yaml"), "--device", "cpu",
        "--model-torch", str(setup / "daspeech.pt"), *flags]) == 0
    args = tgen.parse_args([str(setup), *flags])
    cfg = port_cfg().dag
    model = S2TConformerDAG(cfg).eval()
    model.load_state_dict(import_s2t_conformer_dag(fabricate_sd(), 1, 1))
    task = NATSpeechToTextTask.setup_task(TaskConfig(
        data_dir=str(setup), max_tokens=512))
    task.load_dataset("test")
    it = task.get_batch_iterator("test")
    gen = task.build_generator(model, DecodeConfig(
        strategy=args.decode_strategy, beta=args.decode_beta,
        viterbibeta=args.decode_viterbibeta, alpha=args.decode_alpha,
        top_cand_n=args.decode_top_cand_n, beamsize=args.decode_beamsize,
        top_p=args.decode_top_p, dedup=args.decode_dedup,
        max_output_length=args.max_output_length,
        length_beam=args.length_beam,
        iter_decode_max_iter=args.iter_decode_max_iter,
        iter_decode_force_max_iter=args.iter_decode_force_max_iter))
    lines = []
    for spec, idxs in it.batches_for_epoch(0):
        hypos = gen.generate(it.collate(spec, idxs, pad_last=False))
        lines += [f"{it.dataset.rows[i]['id']}\t"
                  f"{task.tgt_dict.string(h['tokens'])}"
                  for i, h in zip(idxs, hypos)]
    assert (out / "hypos.txt").read_text().splitlines() == lines


def test_cli_imports_no_jax(setup):
    """A fresh interpreter runs the S2ST route and the data pipeline and
    never imports jax, flax or the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    argv = _common(setup, "no_jax") + [
        "--model-yaml", str(setup / "s2s.yaml"), "--device", "cpu",
        "--model-torch", str(setup / "daspeech.pt")]
    code = ("import sys\n"
            "from daspeech_torch.cli.generate import main\n"
            f"assert main({argv!r}) == 0\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'flax', 'daspeech_tpu'))\n"
            "assert not bad, bad\n")
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   capture_output=True, timeout=300)
    assert len((setup / "no_jax" / "hypos.txt").read_text().splitlines()) == 5


@pytest.mark.parametrize("name", ["S2SModelConfig", "DAGModelConfig",
                                  "FastSpeech2Config", "HiFiGANConfig",
                                  "DecodeConfig", "TrainingConfig"])
def test_config_dict_round_trip_matches_jax(name):
    """``to_dict`` gives JAX's dict for the same config (on the port's
    fields, a subset of JAX's), and ``from_dict`` rebuilds the config from
    the JAX config's dict with non-default values after a YAML round trip
    (lists back to tuples, nested dataclasses rebuilt, JAX-only keys
    ignored)."""
    import dataclasses

    from daspeech_torch import config as tcfg
    from daspeech_tpu.core import config as jcfg

    def on_keys_of(want, d):
        return {k: (on_keys_of(v, d[k]) if isinstance(v, dict) else d[k])
                for k, v in want.items()}

    tcls, jcls = getattr(tcfg, name), getattr(jcfg, name)
    assert tcfg.to_dict(tcls()) == on_keys_of(tcfg.to_dict(tcls()),
                                              jcfg.to_dict(jcls()))

    def bump(d):
        """Every int and float leaf plus one, recursively."""
        return {k: (bump(v) if isinstance(v, dict) else
                    v + 1 if type(v) in (int, float) else v)
                for k, v in d.items()}

    data = bump(jcfg.to_dict(jcls()))
    cfg = tcfg.from_dict(tcls, yaml.safe_load(yaml.safe_dump(data)))
    assert cfg == tcfg.from_dict(tcls, data)
    assert tcfg.to_dict(cfg) == on_keys_of(tcfg.to_dict(cfg), jcfg.to_dict(
        jcfg.from_dict(jcls, yaml.safe_load(yaml.safe_dump(data)))))
    assert tcfg.to_dict(cfg) != tcfg.to_dict(tcls())
    assert all(dataclasses.is_dataclass(getattr(cfg, f.name))
               for f in dataclasses.fields(cfg)
               if dataclasses.is_dataclass(getattr(tcls(), f.name)))
