"""The port's two-pass S2ST serving slice as a whole, against the JAX
package and the frozen golden fixture, at the tiny configuration of
``tests/test_golden_e2e.py`` (same seeds, same init keys).

* the pipeline of ``test_golden_e2e.run_pipeline`` run by the port with the
  JAX weights: tokens equal to the JAX run and to ``e2e_golden.npz``; mel
  and waveform within 1e-3 of both (fp32; summation order differs);
* ``daspeech_torch.decode.generator.S2SNATGenerator.generate`` against the
  JAX ``S2SNATGenerator`` on one batch: same tokens, same mel lengths, mel
  and waveform within 1e-3;
* an import guard: a fresh interpreter runs the port's CPU serving slice,
  one S2TT DAG training step, one joint S2ST step, one FastSpeech 2
  pretraining step, one batch each of the fused-MRF vocoder, the chunked
  vocoder and the TTS generator, the joint-Viterbi strategy with
  refinement, the length beam, beam search and one vocoder training
  update, and never imports jax or the JAX package.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daspeech_torch import convert
from daspeech_torch.decode import dag_decode as tdec
from daspeech_torch.decode import generator as tgen
from daspeech_tpu.core.config import DecodeConfig
from daspeech_tpu.data.transforms import GlobalCMVN
from daspeech_tpu.decode import gather_path_features, greedy_or_lookahead_decode
from daspeech_tpu.decode import generator as jgen
from daspeech_tpu.models import graph_lengths, initialize_output_tokens
from test_golden_e2e import B, GOLDEN, L, M, S, T_PHONE, build_pipeline

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread_no_grad():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden_setup():
    """The golden pipeline's config, inputs and initial variables (the
    inits are jitted here; same keys, same values as the eager fixture)."""
    cfg, model, voc = build_pipeline()
    vocab = cfg.dag.vocab
    rng = np.random.default_rng(0)
    fbank = rng.normal(size=(B, S, 80)).astype(np.float32)
    src_lengths = np.asarray([S, S - 5], np.int32)
    prev = np.array(initialize_output_tokens(
        graph_lengths(jnp.asarray(src_lengths),
                      cfg.dag.decoder.src_upsample_scale,
                      cfg.dag.decoder.max_target_positions), L, vocab))

    def full(m):
        logits, links, feats = m(fbank, src_lengths, prev)
        return m.synthesize(feats[:, :T_PHONE],
                            jnp.zeros((B, T_PHONE), bool), M)

    params = jax.jit(lambda k: model.init(k, method=full))(
        jax.random.PRNGKey(7))
    vparams = jax.jit(voc.init)(jax.random.PRNGKey(11),
                                jnp.zeros((B, M, 80)))
    return dict(cfg=cfg, model=model, voc=voc, fbank=fbank,
                src_lengths=src_lengths, prev=prev,
                params=jax.tree.map(np.asarray, params),
                vparams=jax.tree.map(np.asarray, vparams))


def _durations():
    per = M // T_PHONE
    durs = np.full((B, T_PHONE), per, np.int32)
    durs[:, -1] += M - per * T_PHONE
    return durs


def test_pipeline_matches_jax_and_golden(golden_setup):
    g = golden_setup
    cfg, model, voc = g["cfg"], g["model"], g["voc"]
    pad = cfg.dag.vocab.pad
    fbank, lens, prev = g["fbank"], g["src_lengths"], g["prev"]
    durs = _durations()

    @jax.jit
    def jax_pipeline(params, vparams):
        logits, links, feats = model.apply(params, fbank, lens, prev)
        res = greedy_or_lookahead_decode(
            logits, links, jnp.sum(prev != pad, axis=1), pad, 1.0, True)
        z, zmask = gather_path_features(feats, res, skip_first=True)
        mel = model.apply(params, z[:, :T_PHONE], zmask[:, :T_PHONE], M,
                          jnp.asarray(durs), method=model.synthesize)[0]
        return res.tokens, mel, voc.apply(vparams, mel[..., :80])

    j_tokens, j_mel, j_wav = map(np.asarray,
                                 jax_pipeline(g["params"], g["vparams"]))

    tm = convert.from_flax(g["params"], cfg, device="cpu")
    tv = convert.vocoder_from_flax(g["vparams"], voc.cfg, device="cpu")
    prev_t = torch.from_numpy(prev).long()
    logits, links, feats = tm(torch.from_numpy(fbank),
                              torch.from_numpy(lens).long(), prev_t)
    res = tdec.greedy_or_lookahead_decode(
        logits, links, (prev_t != pad).sum(1), pad, 1.0, True)
    z, zmask = tdec.gather_path_features(feats, res, skip_first=True)
    mel, _, _, _, _, _ = tm.synthesize(z[:, :T_PHONE], zmask[:, :T_PHONE], M,
                                    torch.from_numpy(durs).long())
    wav = tv(mel[..., :80])

    golden = np.load(GOLDEN)
    tokens = res.tokens.numpy()
    np.testing.assert_array_equal(tokens, j_tokens)
    np.testing.assert_array_equal(tokens, golden["tokens"])
    for name, got, ref in (("mel", mel, j_mel), ("wav", wav, j_wav)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL,
                                   err_msg=f"{name} vs JAX")
        np.testing.assert_allclose(got.numpy(), golden[name], rtol=0,
                                   atol=TOL, err_msg=f"{name} vs golden")


def test_generator_matches_jax(golden_setup):
    g = golden_setup
    cfg, model, voc = g["cfg"], g["model"], g["voc"]
    params = jax.tree.map(np.copy, g["params"])
    # random weights predict ~0-frame durations; a constant prediction of
    # 3 frames per token gives both packages mels to compare
    proj = params["params"]["tts"]["var_adaptor"]["duration_predictor"][
        "proj"]
    proj["kernel"][:] = 0.0
    proj["bias"][:] = np.log(4.0)
    rng = np.random.default_rng(3)
    gcmvn = GlobalCMVN(mean=rng.normal(size=80).astype(np.float32),
                       std=rng.uniform(0.5, 2, size=80).astype(np.float32))
    batch = {"fbank": g["fbank"], "src_lengths": g["src_lengths"],
             "prev_output_tokens": g["prev"]}
    decode_cfg = DecodeConfig()

    want = jgen.S2SNATGenerator(
        model, cfg.dag.vocab, decode_cfg, max_mel_len=M, vocoder=voc,
        vocoder_params=g["vparams"], gcmvn=gcmvn).generate(params, batch)
    got = tgen.S2SNATGenerator(
        convert.from_flax(params, cfg, device="cpu"), cfg.dag.vocab,
        decode_cfg, max_mel_len=M,
        vocoder=convert.vocoder_from_flax(g["vparams"], voc.cfg,
                                          device="cpu"),
        gcmvn=gcmvn).generate(batch)

    assert len(got) == len(want) == B
    for h_got, h_want in zip(got, want):
        np.testing.assert_array_equal(h_got["tokens"], h_want["tokens"])
        assert h_got["feature"].shape == h_want["feature"].shape
        assert h_got["feature"].shape[0] > 0
        np.testing.assert_allclose(h_got["feature"], h_want["feature"],
                                   rtol=0, atol=TOL)
        assert h_got["waveform"].shape == h_want["waveform"].shape
        np.testing.assert_allclose(h_got["waveform"], h_want["waveform"],
                                   rtol=0, atol=TOL)


IMPORT_GUARD = """
import sys
import numpy as np
import torch
import daspeech_torch
from daspeech_torch.config import (DAGDecoderConfig, DAGModelConfig,
    ConformerConfig, DecodeConfig, FastSpeech2Config, HiFiGANConfig,
    S2SModelConfig, VocabConfig)
from daspeech_torch.decode import S2SNATGenerator
from daspeech_torch.models import (HiFiGANGenerator,
    S2SConformerDAGFastSpeech2, graph_lengths, initialize_output_tokens)

torch.manual_seed(0)
cfg = S2SModelConfig(
    dag=DAGModelConfig(
        vocab=VocabConfig(size=32),
        encoder=ConformerConfig(embed_dim=16, ffn_dim=32, num_heads=2,
                                num_layers=1, conv_channels=8,
                                depthwise_kernel_size=7),
        decoder=DAGDecoderConfig(embed_dim=16, ffn_dim=32, num_heads=2,
                                 num_layers=1)),
    tts=FastSpeech2Config(encoder_layers=1, encoder_embed_dim=16,
                          encoder_heads=2, decoder_layers=1,
                          decoder_embed_dim=16, decoder_heads=2,
                          fft_hidden_dim=32, var_pred_hidden_dim=16))
voc_cfg = HiFiGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                        upsample_initial_channel=32,
                        resblock_kernel_sizes=(3, 7),
                        resblock_dilation_sizes=((1, 3),) * 2)
model = S2SConformerDAGFastSpeech2(cfg).eval()
with torch.no_grad():
    model.tts.var_adaptor.duration_predictor.proj.bias.fill_(1.0)
gen = S2SNATGenerator(model, cfg.dag.vocab, DecodeConfig(), max_mel_len=32,
                      vocoder=HiFiGANGenerator(voc_cfg).eval())
lens = torch.tensor([40, 35])
prev = initialize_output_tokens(graph_lengths(lens, 0.5, 1024), 20,
                                cfg.dag.vocab)
hyps = gen.generate({"fbank": np.random.default_rng(0).normal(
    size=(2, 40, 80)).astype(np.float32), "src_lengths": lens.numpy(),
    "prev_output_tokens": prev.numpy()})
assert len(hyps) == 2
for h in hyps:
    assert np.isfinite(h["feature"]).all() and np.isfinite(h["waveform"]).all()
    assert h["feature"].shape[1] == 80

# one training step of the S2TT DAG model on the CPU (plain versions)
from daspeech_torch.losses import nat_dag_loss
from daspeech_torch.models import S2TConformerDAG
from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

dag = S2TConformerDAG(cfg.dag)
opt = GuardedAdam(warmup_updates=1)
state = TrainState.create(dag, opt)
step = make_train_step(
    lambda m, b, g: nat_dag_loss(m, b, g, 0.5, cfg.dag.vocab), opt)
tgt = torch.tensor([[0, 5, 6, 7, 2], [0, 8, 9, 2, 1]])
metrics = step(state, {"fbank": torch.randn(2, 40, 80), "src_lengths": lens,
                       "target": tgt, "prev_output_tokens": prev}, torch.Generator())
assert torch.isfinite(metrics["loss"]) and metrics["skipped"].item() == 0

# one joint S2ST step and one FastSpeech 2 pretraining step
from daspeech_torch.losses import (fastspeech2_criterion,
    s2s_dag_fastspeech2_loss)
from daspeech_torch.models import FastSpeech2Encoder

state = TrainState.create(model, opt)
step = make_train_step(lambda m, b, g: s2s_dag_fastspeech2_loss(
    m, b, g, 0.5, cfg.dag.vocab), opt)
gold = {"durations": torch.full((2, 4), 3), "pitches": torch.rand(2, 4),
        "energies": torch.rand(2, 4)}
metrics = step(state, {"fbank": torch.randn(2, 40, 80), "src_lengths": lens,
                       "target_text": tgt, "prev_output_tokens": prev,
                       "target_audio": torch.randn(2, 12, 80),
                       "target_audio_lengths": torch.tensor([12, 9]), **gold},
               torch.Generator())
assert torch.isfinite(metrics["loss"]) and metrics["skipped"].item() == 0
fs2 = FastSpeech2Encoder(cfg.tts, vocab_size=32)
state = TrainState.create(fs2, opt)
step = make_train_step(lambda m, b, g: fastspeech2_criterion(
    m, b, g, cfg.dag.vocab), opt)
metrics = step(state, {"src_tokens": tgt[:, 1:], "target_audio":
                       torch.randn(2, 12, 80), "target_audio_lengths":
                       torch.tensor([12, 9]), **gold}, torch.Generator())
assert torch.isfinite(metrics["loss"]) and metrics["skipped"].item() == 0

# one fused-MRF vocoder batch (both levels routed), one chunked vocoder
# batch through make_vocode_fn, one TTS batch
from daspeech_torch.decode import (NonAutoregressiveSpeechGenerator,
    make_vocode_fn)
from daspeech_torch.models import fused_mrf_route

voc_f = HiFiGANGenerator(voc_cfg, fused_mrf=True).eval()
voc_c = HiFiGANGenerator(voc_cfg, serve_chunk=16).eval()
voc_c.load_state_dict(voc_f.state_dict())
assert fused_mrf_route("1", 16, 1040) and fused_mrf_route("1", 8, 2080)
mel = torch.randn(1, 520, 80)
with torch.no_grad():
    wav = voc_f(mel)
    assert wav.shape == (1, 2080) and torch.isfinite(wav).all()
    assert (make_vocode_fn(voc_c)(mel) - wav).abs().max().item() <= 1e-5
tts = NonAutoregressiveSpeechGenerator(fs2.eval(), cfg.dag.vocab,
                                       max_mel_len=32, vocoder=voc_c, hop=4)
for h in tts.generate({"src_tokens": tgt[:, 1:].numpy()}):
    assert np.isfinite(h["feature"]).all() and np.isfinite(h["waveform"]).all()
    assert len(h["waveform"]) == 4 * h["feature"].shape[0]
# the alternate backends: a fused-FFN training pass and the full-bias op
from daspeech_torch.models.conformer import FeedForwardModule
from daspeech_torch.ops.fused_attention import fused_attention_full_bias

ffn = FeedForwardModule(16, 32, 0.1, fused=True)
xf = torch.randn(2, 5, 16, requires_grad=True)
ffn(xf, torch.Generator().manual_seed(0)).sum().backward()
assert torch.isfinite(xf.grad).all()
qf = torch.randn(2, 2, 5, 8, requires_grad=True)
fused_attention_full_bias(qf, qf, qf, torch.zeros(2, 2, 5, 5), 3, 0.35, 0.1,
                          True).sum().backward()
assert torch.isfinite(qf.grad).all()
# the other decode strategies, and one vocoder training update
from daspeech_torch.decode import S2TNATGenerator
from daspeech_torch.train import VocoderTrainer, make_mel_fn

batch = {"fbank": np.random.default_rng(1).normal(size=(2, 40, 80)).astype(
    np.float32), "src_lengths": lens.numpy(), "prev_output_tokens": prev.numpy()}
for dc in (DecodeConfig(strategy="jointviterbi", iter_decode_max_iter=1),
           DecodeConfig(length_beam=3)):
    for h in S2SNATGenerator(model, cfg.dag.vocab, dc, max_mel_len=32,
                             vocoder=voc_c).generate(batch):
        assert np.isfinite(h["feature"]).all()
hyps = S2TNATGenerator(model, cfg.dag.vocab, DecodeConfig(
    strategy="beamsearch", beamsize=8)).generate(batch)
assert all(len(h["tokens"]) >= 1 for h in hyps)
trainer = VocoderTrainer(voc_cfg, mel_fn=make_mel_fn(n_fft=64, hop_length=16,
                         num_mels=8, fmax=None, device="cpu"), device="cpu")
vstate = trainer.init_state(torch.Generator().manual_seed(0))
vstate, vm = trainer.train_step(vstate, torch.randn(2, 16, 80),
                                torch.randn(2, 64) * 0.1)
assert vstate.step == 1 and all(torch.isfinite(v) for v in vm.values())
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "daspeech_tpu"))
assert not bad, bad
print("ok")
"""


def test_port_never_imports_jax():
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_GUARD], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
