"""The port's direct fairseq / hifi-gan ``.pt`` loader
(``daspeech_torch/train/fairseq_import.py``) against the JAX package's
route (``daspeech_tpu/train/torch_import.py`` -> flax tree ->
``daspeech_torch.convert``): the S2S DASpeech model, the S2T Conformer-DAG
(tied and untied output projection), a standalone FastSpeech 2 and the
HiFi-GAN generator (ResBlock types 1 and 2, weight norm folded). The
reference state dicts are fabricated under the exact fairseq key names
(``tests/test_s2s_import_structure.py::fabricate_sd``), saved with
``torch.save`` and read back through the loader. Every tensor of the
loaded port model must equal the JAX route's, bit for bit."""

import argparse

import numpy as np
import pytest
import torch

from test_s2s_import_structure import (
    CC, D_DEC, D_ENC, FFN, H, MAXPOS, NBINS, TTS_D, TTS_FFN, V,
    fabricate_sd)

from daspeech_torch import config as tcfg
from daspeech_torch import convert
from daspeech_torch.models import (
    FastSpeech2Encoder,
    HiFiGANGenerator,
    S2SConformerDAGFastSpeech2,
    S2TConformerDAG,
)
from daspeech_torch.train import fairseq_import as fi
from daspeech_tpu.train import torch_import as ti


def port_cfg(tied=True):
    return tcfg.S2SModelConfig(
        dag=tcfg.DAGModelConfig(
            vocab=tcfg.VocabConfig(size=V),
            encoder=tcfg.ConformerConfig(
                embed_dim=D_ENC, ffn_dim=2 * D_ENC, num_layers=1,
                num_heads=2, conv_channels=CC, depthwise_kernel_size=7),
            decoder=tcfg.DAGDecoderConfig(
                embed_dim=D_DEC, ffn_dim=FFN, num_layers=1, num_heads=H,
                max_target_positions=MAXPOS,
                share_input_output_embed=tied)),
        tts=tcfg.FastSpeech2Config(
            encoder_layers=1, encoder_embed_dim=TTS_D, encoder_heads=2,
            decoder_layers=1, decoder_embed_dim=TTS_D, decoder_heads=2,
            fft_hidden_dim=TTS_FFN, fft_kernel_size=9,
            var_pred_hidden_dim=TTS_FFN, var_pred_kernel_size=3,
            var_pred_n_bins=NBINS),
        adaptor_ffn_dim=TTS_FFN)


def saved(tmp_path, sd, key="model"):
    """``sd`` through ``torch.save`` / the port's loader, as tensors."""
    path = tmp_path / "ckpt.pt"
    torch.save({key: {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    return fi.load_pt(path)[key]


def assert_bit_identical(got: torch.nn.Module, want: torch.nn.Module):
    g, w = got.state_dict(), want.state_dict()
    assert list(g) == list(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert torch.equal(g[k], w[k]), k


def test_s2s_daspeech(tmp_path):
    sd = fabricate_sd()
    cfg = port_cfg()
    got = S2SConformerDAGFastSpeech2(cfg)
    got.load_state_dict(fi.import_s2s_daspeech(
        saved(tmp_path, sd), enc_layers=1, dec_layers=1, tts_cfg=cfg.tts))
    want = convert.load_flax_(S2SConformerDAGFastSpeech2(cfg),
                              ti.import_s2s_daspeech(sd, 1, 1, cfg.tts))
    assert_bit_identical(got, want)
    # the 16-wide encoder reaches the 32-wide cross-attention through the
    # identity pad: zero input columns in k/v
    k = got.dag.decoder.layers[0].encoder_attn.k_proj.weight
    assert k.shape == (D_DEC, D_DEC) and not k[:, D_ENC:].any()


@pytest.mark.parametrize("tied", [True, False])
def test_s2t_conformer_dag(tied, tmp_path):
    sd = {k: v for k, v in fabricate_sd().items()
          if k.startswith(("encoder.", "decoder."))}
    sd["decoder.embed_length.weight"] = np.ones((256, D_DEC), np.float32)
    if not tied:
        sd["decoder.output_projection.weight"] = np.random.default_rng(
            1).normal(size=(V, D_DEC)).astype(np.float32)
    cfg = port_cfg(tied).dag
    got = S2TConformerDAG(cfg)
    got.load_state_dict(fi.import_s2t_conformer_dag(
        saved(tmp_path, sd), 1, 1, tied_embeddings=tied))
    want = convert.load_flax_(S2TConformerDAG(cfg),
                              ti.import_s2t_conformer_dag(
                                  sd, 1, 1, tied_embeddings=tied))
    assert_bit_identical(got, want)


def test_fastspeech2(tmp_path):
    sd = {"encoder." + k[4:]: v for k, v in fabricate_sd().items()
          if k.startswith("tts.")}
    sd["encoder.embed_tokens.weight"] = np.random.default_rng(2).normal(
        size=(V, TTS_D)).astype(np.float32)
    cfg = port_cfg().tts
    got = FastSpeech2Encoder(cfg, V, 1)
    got.load_state_dict(fi.import_fastspeech2(saved(tmp_path, sd), cfg))
    want = convert.load_flax_(FastSpeech2Encoder(cfg, V, 1),
                              ti.import_fastspeech2(sd, cfg))
    assert_bit_identical(got, want)


def hifigan_sd(cfg, seed=0):
    """A weight-normed hifi-gan ``Generator.state_dict()`` of ``cfg``."""
    rng = np.random.default_rng(seed)
    sd = {}

    def wn(prefix, shape):
        v = rng.normal(size=shape).astype(np.float32)
        sd[f"{prefix}.weight_v"] = v
        sd[f"{prefix}.weight_g"] = rng.uniform(
            0.5, 1.5, size=(shape[0],) + (1,) * (len(shape) - 1)
        ).astype(np.float32)
        # the bias's length: the output channels (dim 1 of a transposed
        # conv's [in, out, k], dim 0 of a conv's [out, in, k])
        n_out = shape[1] if prefix.startswith("ups") else shape[0]
        sd[f"{prefix}.bias"] = rng.normal(size=n_out).astype(np.float32)

    ch = cfg.upsample_initial_channel
    wn("conv_pre", (ch, cfg.num_mels, 7))
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        wn(f"ups.{i}", (ch // 2 ** i, ch // 2 ** (i + 1), k))
    nk = len(cfg.resblock_kernel_sizes)
    for n in range(len(cfg.upsample_rates) * nk):
        c = ch // 2 ** (n // nk + 1)
        k = cfg.resblock_kernel_sizes[n % nk]
        for j in range(len(cfg.resblock_dilation_sizes[n % nk])):
            for conv in (("convs1", "convs2") if cfg.resblock == "1"
                         else ("convs",)):
                wn(f"resblocks.{n}.{conv}.{j}", (c, c, k))
    wn("conv_post", (1, ch // 2 ** len(cfg.upsample_rates), 7))
    return sd


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_hifigan(resblock, tmp_path):
    cfg = tcfg.HiFiGANConfig(
        resblock=resblock, upsample_initial_channel=32,
        resblock_dilation_sizes=((1, 3, 5),) * 3 if resblock == "1"
        else ((1, 3),) * 3)
    sd = hifigan_sd(cfg)
    got = HiFiGANGenerator(cfg)
    got.load_state_dict(fi.import_hifigan(saved(tmp_path, sd, "generator"),
                                          cfg))
    want = convert.load_flax_(HiFiGANGenerator(cfg),
                              ti.import_hifigan(sd, cfg))
    assert_bit_identical(got, want)
    # the fold: w = g v / ||v|| row by row
    v, g = sd["conv_pre.weight_v"], sd["conv_pre.weight_g"]
    ref = g * v / np.sqrt((v.astype(np.float64) ** 2).sum((1, 2),
                                                          keepdims=True))
    np.testing.assert_allclose(got.conv_pre.weight.detach().numpy(), ref,
                               rtol=1e-6)


def test_load_pt_falls_back_for_pickled_configs_only(tmp_path, capsys):
    """A released checkpoint pickles its argparse config beside the state
    dict: the safe loader refuses it, the full unpickle loads it with a
    warning. Any other error (here a missing file) propagates as it is."""
    path = tmp_path / "release.pt"
    torch.save({"args": argparse.Namespace(arch="s2s"),
                "model": {"w": torch.ones(2)}}, path)
    ckpt = fi.load_pt(path)
    assert torch.equal(ckpt["model"]["w"], torch.ones(2))
    assert "WARNING" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        fi.load_pt(tmp_path / "missing.pt")
    assert "WARNING" not in capsys.readouterr().err
