"""The port's decode strategies and generators against the JAX package, on
the CPU.

Inputs are numpy draws from a seed; model weights are numpy draws carried
across by ``daspeech_torch.convert``. Tolerances:

- tokens, lengths and vertex indices of every strategy: exact;
- the length beam's candidate score (``path_score``): exact (the same
  float32 sums on the same inputs);
- the S2ST generator's mel and waveform: 1e-3, the bar of
  ``tests/test_torch_slice.py``.

``viterbi_decode`` is held on graphs whose padded vertices tie at the
-1e9 clamp and on graphs with exact ties between vertices; beam search at
beam sizes above the live candidates (``NEG`` ties), with nucleus
truncation on and off and duplicate collapse on and off.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daspeech_torch import convert
from daspeech_torch.decode import beam_search as tbs
from daspeech_torch.decode import dag_decode as tdec
from daspeech_torch.decode import generator as tgen
from daspeech_torch.models import dag_model as tdag
from daspeech_tpu.core.config import DecodeConfig
from daspeech_tpu.data.transforms import GlobalCMVN
from daspeech_tpu.decode import beam_search as jbs
from daspeech_tpu.decode import dag_decode as jdec
from daspeech_tpu.decode import generator as jgen
from daspeech_tpu.models import (S2TConformerDAG, graph_lengths,
                                 initialize_output_tokens)
from test_golden_e2e import B as GB
from test_golden_e2e import M as GM
from test_models import tiny_dag_cfg
from test_torch_models import random_variables
from test_torch_slice import golden_setup  # noqa: F401  (a fixture)

PAD = 1
TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread_no_grad():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(n)


def graph(seed, B=3, L=16, V=12, ties=False):
    """(logits [B, L, V], links [B, L, L], graph sizes [B]) as numpy:
    links log-softmaxed over j in (i, ol), -inf elsewhere (a padded or
    last vertex links nowhere). With ``ties``, vertices 2 and 3 share their
    logits, their links out and their link in from vertex 0, so the DP's
    maxima tie between them."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, L, V)) * 2).astype(np.float32)
    ol = rng.integers(L // 2, L + 1, size=B)
    ol[0] = L
    i, j = np.arange(L)[:, None], np.arange(L)[None, :]
    valid = (j > i)[None] & (j < ol[:, None, None])
    raw = np.where(valid, rng.normal(size=(B, L, L)) * 2, -np.inf)
    with np.errstate(invalid="ignore"):
        lse = np.logaddexp.reduce(raw, axis=-1, keepdims=True)
        links = np.where(valid, raw - lse, -np.inf)
    if ties:
        logits[:, 3] = logits[:, 2]
        links[:, 3, 4:] = links[:, 2, 4:]
        links[:, 0, 3] = links[:, 0, 2]
    return logits, links.astype(np.float32), ol.astype(np.int32)


def assert_same(got: tdec.DecodeResult, want: jdec.DecodeResult):
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def _t(x):
    return torch.from_numpy(np.array(x))


# --- the decode functions -------------------------------------------------

def test_top_k_breaks_ties_as_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 3, size=(4, 40)).astype(np.float32)
    x[1, 5:] = -1e30                       # a row of NEG ties
    for k in (1, 5, 40):
        v, i = tbs.top_k(_t(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("joint", [True, False])
@pytest.mark.parametrize("case", ["random", "ties", "beta_len"])
def test_viterbi_matches_jax(joint, case):
    """Tokens, lengths and vertices exact, at the default length cap
    (max(2, L // 4)) and at an explicit one with a length penalty
    exponent other than 1."""
    logits, links, ol = graph(1 if case == "random" else 2,
                              ties=case == "ties")
    kw = (dict(viterbibeta=1.3, max_length=9) if case == "beta_len"
          else {})
    want = jdec.viterbi_decode(jnp.asarray(logits), jnp.asarray(links),
                               jnp.asarray(ol), PAD, 0.8, joint=joint, **kw)
    got = tdec.viterbi_decode(_t(logits), _t(links), _t(ol).long(), PAD, 0.8,
                              joint=joint, **kw)
    assert_same(got, want)
    # feat_lengths == lengths: the first emitted vertex keeps its feature
    np.testing.assert_array_equal(got.feat_lengths.numpy(),
                                  got.lengths.numpy())
    assert got.lengths.max() > 2


@pytest.mark.parametrize("strategy", ["lookahead", "jointviterbi"])
def test_path_score_matches_jax(strategy):
    logits, links, ol = graph(3)
    jl, jk, jo = map(jnp.asarray, (logits, links, ol))
    tl, tk, to = _t(logits), _t(links), _t(ol).long()
    if strategy == "lookahead":
        want = jdec.greedy_or_lookahead_decode(jl, jk, jo, PAD)
        got = tdec.greedy_or_lookahead_decode(tl, tk, to, PAD)
    else:
        want = jdec.viterbi_decode(jl, jk, jo, PAD)
        got = tdec.viterbi_decode(tl, tk, to, PAD)
    assert_same(got, want)
    unreduced = np.asarray(jnp.max(jax.nn.log_softmax(jl, axis=-1), -1))
    start = strategy == "lookahead"
    np.testing.assert_array_equal(
        tdec.path_score(_t(unreduced), got, include_start=start).numpy(),
        np.asarray(jdec.path_score(jnp.asarray(unreduced), want,
                                   include_start=start)))


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("top_p", [0.9, 1.0])
@pytest.mark.parametrize("beamsize", [4, 100])
def test_beam_search_matches_jax(beamsize, top_p, dedup):
    """At beamsize 100 most of the K·C continuation scores are NEG ties
    at every step; the port's stable top-k keeps JAX's order."""
    logits, links, ol = graph(4, L=20)
    kw = dict(beam_size=beamsize, top_cand_n=4, decode_beta=0.9,
              decode_alpha=1.1, top_p=top_p, dedup=dedup)
    want = jbs.beam_search_decode(jnp.asarray(logits), jnp.asarray(links),
                                  jnp.asarray(ol), PAD, 0, **kw)
    got = tbs.beam_search_decode(_t(logits), _t(links), _t(ol).long(), PAD,
                                 0, **kw)
    assert_same(got, want)
    assert (got.lengths.numpy() >= 2).all()


def test_beam_search_finalises_a_truncated_candidate():
    """The JAX searcher's finalisation scores a candidate as score / pen
    with no test that it was live, and NEG / pen > NEG: a candidate that
    the nucleus truncated to NEG sets the best hypothesis when no live one
    reaches the last vertex (ROADMAP Queue 3). The port reproduces it.
    Graph: vertex 0 links to 1 (p = 0.999) and to 3 (p = 0.001); the
    candidate into the last vertex is truncated at top_p 0.9, and one step
    does not reach it otherwise."""
    V = 6
    logits = np.full((1, 4, V), -20.0, np.float32)
    for v, tok in enumerate((0, 4, 5, 2)):
        logits[0, v, tok] = 10.0
    links = np.full((1, 4, 4), -np.inf, np.float32)
    links[0, 0, 1], links[0, 0, 3] = np.log(0.999), np.log(0.001)
    links[0, 1, 2], links[0, 2, 3] = 0.0, 0.0
    ol = np.asarray([4], np.int32)
    kw = dict(beam_size=2, top_cand_n=2, top_p=0.9, max_steps=1)
    want = jbs.beam_search_decode(jnp.asarray(logits), jnp.asarray(links),
                                  jnp.asarray(ol), PAD, 0, **kw)
    got = tbs.beam_search_decode(_t(logits), _t(links), _t(ol).long(), PAD,
                                 0, **kw)
    assert_same(got, want)
    # the truncated hypothesis <bos>=0, 2 (vertex 3's token) was returned
    assert got.lengths.tolist() == [2]
    assert got.tokens[0, :2].tolist() == [0, 2]


# --- the generators -------------------------------------------------------

B, S, L = 3, 28, 16


@pytest.fixture(scope="module")
def s2t_setup():
    """A tiny S2TT model (``tests/test_models.py::tiny_dag_cfg``) with
    random weights in both packages, and a batch. Random weights decode
    every utterance to one token (the graph's inputs are all <unk>, and
    the encoder states swamp the vertices' own), so, as ``chip_smoke.py``'s
    ``shape_random_decoder_``: the <unk> embedding is 0, the position
    embeddings are N(0, 1) and the cross-attention outputs are scaled by
    1/4; the paths then emit 1-5 tokens."""
    cfg = tiny_dag_cfg()
    rng = np.random.default_rng(5)
    fbank = rng.normal(size=(B, S, 80)).astype(np.float32)
    src_lengths = np.asarray([S, 23, 19], np.int32)
    prev = np.array(initialize_output_tokens(
        graph_lengths(jnp.asarray(src_lengths), 0.5, 64), L, cfg.vocab))
    model = S2TConformerDAG(cfg)
    params = random_variables(model, 6, fbank, src_lengths, prev)
    dec = params["params"]["decoder"]
    dec["embed_tokens"]["embedding"][cfg.vocab.unk] = 0.0
    for i, name in enumerate(("embed_positions", "link_positional")):
        emb = dec[name]["embedding"]
        emb[:] = np.random.default_rng(i + 1).normal(size=emb.shape)
    for i in range(cfg.decoder.num_layers):
        dec[f"layers_{i}"]["encoder_attn"]["out_proj"]["kernel"] *= 0.25
    tmodel = convert.dag_from_flax(params, cfg, device="cpu")
    batch = {"fbank": fbank, "src_lengths": src_lengths,
             "prev_output_tokens": prev}
    return cfg, model, params, tmodel, batch


def _s2t_pair(setup, **decode):
    cfg, model, params, tmodel, batch = setup
    dc = DecodeConfig(**decode)
    want = jgen.S2TNATGenerator(model, cfg.vocab, dc).generate(params, batch)
    got = tgen.S2TNATGenerator(tmodel, cfg.vocab, dc).generate(batch)
    assert len(got) == len(want) == B
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
    return got


@pytest.mark.parametrize("decode", [
    dict(strategy="greedy"), dict(strategy="viterbi"),
    dict(strategy="jointviterbi", viterbibeta=1.2),
    dict(strategy="beamsearch", beamsize=20, top_cand_n=3),
    dict(strategy="lookahead", length_beam=3),
    dict(strategy="jointviterbi", length_beam=3),
    dict(strategy="lookahead", iter_decode_max_iter=2),
    dict(strategy="viterbi", iter_decode_max_iter=2,
         iter_decode_force_max_iter=True),
], ids=["greedy", "viterbi", "jointviterbi", "beamsearch",
        "length_beam-lookahead", "length_beam-jointviterbi",
        "refine-adaptive", "refine-forced"])
def test_s2t_generator_matches_jax(s2t_setup, decode):
    hyps = _s2t_pair(s2t_setup, **decode)
    assert max(len(h["tokens"]) for h in hyps) >= 2


@pytest.fixture(scope="module")
def reranker_setup(s2t_setup):
    """A tiny ``S2SMultiDecoderModel`` over the S2TT setup's vocabulary,
    random weights in both packages."""
    from daspeech_torch.config import MultiDecoderConfig
    from daspeech_tpu.models.s2s_multidecoder import S2SMultiDecoderModel

    cfg, _, _, _, batch = s2t_setup
    mcfg = MultiDecoderConfig(
        encoder_embed_dim=16, encoder_layers=1, encoder_heads=2,
        mt_embed_dim=16, mt_layers=1, mt_heads=2, ffn_dim=32,
        synth_encoder_layers=1, tts_decoder_layers=1, prenet_dim=16,
        dropout=0.0, conv_channels=16, depthwise_kernel_size=7)
    v = cfg.vocab
    jm = S2SMultiDecoderModel(vocab_size=v.size, pad=v.pad, bos=v.bos,
                              eos=v.eos, **vars(mcfg))
    params = random_variables(jm, 7, batch["fbank"], batch["src_lengths"],
                              batch["prev_output_tokens"][:, :4],
                              np.zeros((B, 4, 80), np.float32))
    return jm, params, convert.multidecoder_from_flax(params, mcfg, v,
                                                      "cpu")


def test_rerank_scores_and_the_reranked_winner_match_jax(s2t_setup,
                                                         reranker_setup):
    """``rerank_scores`` on the length beam's candidates within 1e-5 of
    JAX's, and both generators keep the same candidate under the
    reranker; with these weights the reranker picks another candidate
    than the path score for at least one utterance."""
    cfg, model, params, tmodel, batch = s2t_setup
    jm, rparams, tm = reranker_setup
    dc = DecodeConfig(strategy="lookahead", length_beam=3)
    gen = tgen.S2TNATGenerator(tmodel, cfg.vocab, dc, reranker=tm)
    fbank, lens, prev = gen.to_device(batch)
    logits, links, _, prev3 = tgen.decoder_pass(tmodel, fbank, lens, prev,
                                                cfg.vocab, 3)
    res = tgen._strategy_decode(dc, cfg.vocab, logits, links, prev3)
    got = tgen.rerank_scores(tm, fbank, lens, res.tokens, cfg.vocab.pad,
                             cfg.vocab.eos, 3)
    want = jgen.rerank_scores(jm, rparams, jnp.asarray(batch["fbank"]),
                              jnp.asarray(batch["src_lengths"]),
                              jnp.asarray(res.tokens.numpy()),
                              cfg.vocab.pad, cfg.vocab.eos, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    path = tgen.length_beam_scores(dc, logits, res, 3).argmax(1)
    assert not torch.equal(got.reshape(-1, 3).argmax(1), path)
    jwant = jgen.S2TNATGenerator(model, cfg.vocab, dc, reranker=jm,
                                 reranker_params=rparams).generate(params,
                                                                   batch)
    for g, w in zip(gen.generate(batch), jwant):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_length_beam_picks_the_best_path_score(s2t_setup):
    """The length beam decodes graph sizes glen - 1, glen, glen + 1 from one
    encoder pass and keeps the candidate whose path score is largest."""
    cfg, _, _, tmodel, batch = s2t_setup
    dc = DecodeConfig(strategy="lookahead", length_beam=3)
    gen = tgen.S2TNATGenerator(tmodel, cfg.vocab, dc)
    fbank, lens, prev = gen.to_device(batch)
    res, feats = gen.run(fbank, lens, prev)
    glen = (prev != cfg.vocab.pad).sum(1)
    enc, enc_pad, _ = tmodel.encode(fbank, lens)
    scores = []
    for off in (-1, 0, 1):
        p = tdag.initialize_output_tokens((glen + off).clamp(2, L), L,
                                          cfg.vocab)
        logits, links, f = tmodel.decode(p, enc, enc_pad)
        r = tgen._strategy_decode(dc, cfg.vocab, logits, links, p)
        lp = torch.log_softmax(logits, -1).max(-1).values
        scores.append((tdec.path_score(lp, r), r, f))
    best = torch.stack([s for s, _, _ in scores]).argmax(0)
    for b in range(B):
        _, r, f = scores[int(best[b])]
        np.testing.assert_array_equal(res.tokens[b].numpy(),
                                      r.tokens[b].numpy())
        np.testing.assert_array_equal(feats[b].numpy(), f[b].numpy())


class _Vocab:
    pad = 0


def _scripted(outputs):
    """A decode pass keyed on (sample, input row), as
    ``tests/test_decode.py``'s refinement tests script it."""
    calls = []

    def run(fbank, src_lengths, prev):
        calls.append(prev.clone())
        toks = torch.tensor([outputs[(b, tuple(row.tolist()))]
                             for b, row in enumerate(prev)])
        lens = (toks != 0).sum(1)
        return tdec.DecodeResult(toks, lens, torch.zeros_like(toks),
                                 lens - 1), None

    return run, calls


def test_refinement_keeps_each_first_fixed_point():
    """``tests/test_decode.py:284``: sample 0 reaches its fixed point at
    pass 1, sample 1 at pass 2; the loop stops after pass 2."""
    g0 = (9, 9, 9, 0)
    t1a, t1b, t2b = (5, 6, 0, 0), (7, 8, 3, 0), (7, 3, 0, 0)
    run, calls = _scripted({(0, g0): t1a, (0, t1a): t1a, (1, g0): t1b,
                            (1, t1b): t2b, (1, t2b): t2b})
    gen = tgen.S2TNATGenerator(None, _Vocab(),
                               DecodeConfig(iter_decode_max_iter=5))
    gen.run = run
    res, accepted_input = gen.refine(None, None, torch.tensor([g0, g0]))
    assert res.tokens.tolist() == [list(t1a), list(t2b)]
    # a pass on accepted_input reproduces the accepted output
    assert accepted_input.tolist() == [list(t1a), list(t2b)]
    assert len(calls) == 3


def test_refinement_forced_runs_every_pass():
    """``tests/test_decode.py:330``: 1 + max_iter passes, the last kept."""
    n = [0]

    def run(fbank, src_lengths, prev):
        n[0] += 1
        toks = torch.full((1, 4), n[0])
        lens = torch.full((1,), 4)
        return tdec.DecodeResult(toks, lens, torch.zeros_like(toks),
                                 lens - 1), None

    gen = tgen.S2TNATGenerator(None, _Vocab(), DecodeConfig(
        iter_decode_max_iter=3, iter_decode_force_max_iter=True))
    gen.run = run
    res, _ = gen.refine(None, None, torch.zeros((1, 4), dtype=torch.long))
    assert n[0] == 4
    assert res.tokens.tolist() == [[4, 4, 4, 4]]


def test_refusals_match_jax(s2t_setup):
    """The port refuses what JAX refuses, with the same exception
    types."""
    cfg, model, params, tmodel, batch = s2t_setup
    both = DecodeConfig(length_beam=2, iter_decode_max_iter=1)
    with pytest.raises(ValueError):
        jgen.S2TNATGenerator(model, cfg.vocab, both)
    with pytest.raises(ValueError):
        tgen.S2TNATGenerator(tmodel, cfg.vocab, both)
    beam = DecodeConfig(strategy="beamsearch", length_beam=2)
    with pytest.raises(ValueError):
        jgen.S2TNATGenerator(model, cfg.vocab, beam).generate(params, batch)
    with pytest.raises(ValueError):
        tgen.S2TNATGenerator(tmodel, cfg.vocab, beam).generate(batch)
    unknown = DecodeConfig(strategy="sampling")
    with pytest.raises(NotImplementedError):
        tgen.S2TNATGenerator(tmodel, cfg.vocab, unknown).generate(batch)
    with pytest.raises(NotImplementedError):
        tgen.S2SNATGenerator(tmodel, cfg.vocab,
                             DecodeConfig(strategy="beamsearch"))


@pytest.mark.parametrize("decode", [
    dict(strategy="viterbi"),
    dict(strategy="jointviterbi", iter_decode_max_iter=2),
], ids=["viterbi", "jointviterbi-refine"])
def test_s2s_generator_matches_jax(golden_setup, decode):  # noqa: F811
    """``S2SNATGenerator`` at the golden pipeline's tiny widths: tokens
    exact, mel and waveform within 1e-3 (FastSpeech 2 with a constant
    duration of 3 frames a token, gcmvn on)."""
    g = golden_setup
    cfg, model, voc = g["cfg"], g["model"], g["voc"]
    params = jax.tree.map(np.copy, g["params"])
    proj = params["params"]["tts"]["var_adaptor"]["duration_predictor"][
        "proj"]
    proj["kernel"][:] = 0.0
    proj["bias"][:] = np.log(4.0)
    rng = np.random.default_rng(3)
    gcmvn = GlobalCMVN(mean=rng.normal(size=80).astype(np.float32),
                       std=rng.uniform(0.5, 2, size=80).astype(np.float32))
    batch = {"fbank": g["fbank"], "src_lengths": g["src_lengths"],
             "prev_output_tokens": g["prev"]}
    dc = DecodeConfig(**decode)
    want = jgen.S2SNATGenerator(
        model, cfg.dag.vocab, dc, max_mel_len=GM, vocoder=voc,
        vocoder_params=g["vparams"], gcmvn=gcmvn).generate(params, batch)
    got = tgen.S2SNATGenerator(
        convert.from_flax(params, cfg, device="cpu"), cfg.dag.vocab, dc,
        max_mel_len=GM,
        vocoder=convert.vocoder_from_flax(g["vparams"], voc.cfg,
                                          device="cpu"),
        gcmvn=gcmvn).generate(batch)
    assert len(got) == len(want) == GB
    for h_got, h_want in zip(got, want):
        np.testing.assert_array_equal(h_got["tokens"], h_want["tokens"])
        assert h_got["feature"].shape == h_want["feature"].shape
        np.testing.assert_allclose(h_got["feature"], h_want["feature"],
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(h_got["waveform"], h_want["waveform"],
                                   rtol=0, atol=TOL)
    assert any(h["feature"].shape[0] > 0 for h in got)
