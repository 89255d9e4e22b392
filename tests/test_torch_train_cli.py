"""The port's train CLI (``python -m daspeech_torch.cli.train``), run here
with ``--device cpu`` at the tiny widths of ``tests/test_cli.py``:

* its training loop (``cli.train.train_loop``, fed by the port's task)
  against the JAX package's ``make_train_step`` fed by JAX's task, for
  S2TT, the joint S2ST model and FastSpeech 2, from the same initial
  weights on the same on-disk corpus, at dropout 0 and GLAT p 0: the same
  batches; the losses of 3 updates within 1e-5 relative; update 1's
  gradients within 1e-5 of each tensor's norm; the parameters after 3
  updates within 1e-5. An element whose gradient is below 1e-5 of its
  tensor's largest is held to 2 lr an update instead: Adam's step there is
  sign-like, and the two packages' rounding of a near-zero gradient can
  take either sign (ROADMAP Queue 3). A key projection's bias has an exact
  gradient of 0 (it shifts a softmax row): its gradient is held to 1e-5 of
  its kernel's gradient's norm, and all of it to 2 lr an update; so is the
  link gates' bias's gradient (its elements sum to 0 exactly);
* ``main`` end to end: JAX's record keys, ``done`` included, and
  checkpoints that the generate CLI decodes;
* ``--restore``: stopped at 2 and resumed to 4, the parameters and moments
  equal a straight run's bit for bit, and no skipped batch is collated;
  under ``--fsdp`` too;
* the stage-3 transfers from stage-1 and stage-2 checkpoint directories;
* validation: eval-BLEU (sacrebleu) for S2TT with ``checkpoint_best`` at
  the highest; the valid loss with ``checkpoint_best`` at the lowest;
  ``--eval-inference`` MCD against JAX's ``mel_cepstral_distortion`` on
  the same mels;
* ``--banded-dp`` and ``--fused-vocab-chunk`` (alone and together, S2TT
  and joint) against JAX's ``make_train_step`` with the same options, at
  the same bars (``tests/test_torch_train_cli_variants.py``, with this
  file's helpers); ``--fsdp --min-fsdp-size 64`` in one process against
  the unsharded run;
* ``--encoder-freezing-updates``, the crash checkpoint, the not-accepted
  options, and the exit without a card;
* importing the new CLIs in a fresh interpreter loads no jax.

Pitch and energy targets sit at the centres of the variance predictors'
buckets: the two packages' bucket edges differ by an ulp (ROADMAP Queue 3).
"""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from test_cli import TINY_MODEL, TINY_S2S
from test_torch_models import random_variables
from torch_cli_corpus import LR, S2S_YAML, cli_args, write_corpus

from daspeech_torch import convert
from daspeech_torch.cli import train as ttrain
from daspeech_torch.train.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
N_UPDATES = 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5          # of each tensor's norm
PARAM_TOL = 1e-5
SUB_FLOOR = 1e-5         # of each tensor's largest gradient
# a key projection's bias shifts every score of a softmax row alike: its
# exact gradient is 0 and both packages hold rounding noise there
KEY_BIASES = (".k_proj.bias", ".linear_k.bias", ".key_linear.bias")
# the link gates' bias feeds a log-softmax over its own outputs: its
# gradient sums to 0 exactly, a difference of terms of its kernel's size
SHIFT_BIASES = KEY_BIASES + (".gate_linear.bias",)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    from daspeech_tpu.ops import fused_attention as jfa
    from daspeech_tpu.ops import fused_links as jfl
    from daspeech_tpu.ops import fused_relpos as jfr

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)
    monkeypatch.setattr(jfr.pl, "pallas_call", patched)
    monkeypatch.setattr(jfl, "INTERPRET", True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the corpus

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    write_corpus(root)
    return root


def test_corpus_widths_are_test_cli_s():
    """The shared corpus's model YAMLs are ``tests/test_cli.py``'s tiny
    widths with every dropout rate 0."""
    def widths(tree):
        return {k: widths(v) if isinstance(v, dict) else v
                for k, v in tree.items() if "dropout" not in k
                and k not in ("pitch_min", "pitch_max", "energy_min",
                              "energy_max")}

    assert widths(S2S_YAML) == TINY_S2S
    assert widths(S2S_YAML)["dag"] == TINY_MODEL
    assert all(v == 0.0 for k, v in S2S_YAML["tts"].items()
               if "dropout" in k)


# --------------------------------------------------- the loop against JAX

def _jax_side(crit: str, root: Path):
    """JAX's task, model config, model and batch iterator for ``crit``."""
    from daspeech_tpu import tasks as jtasks
    from daspeech_tpu.cli import train as jtrain
    from daspeech_tpu.models import S2SConformerDAGFastSpeech2, S2TConformerDAG
    from daspeech_tpu.models.fastspeech2 import FastSpeech2Encoder

    task_cls = {"nat_dag_loss": jtasks.NATSpeechToTextTask,
                "s2s_dag_fastspeech2_loss": jtasks.NATSpeechToSpeechTask,
                "fastspeech2": jtasks.TextToSpeechTask}[crit]
    task = task_cls.setup_task(jtasks.TaskConfig(
        data_dir=str(root), max_tokens=256, num_buckets=1,
        max_source_positions=100, max_target_positions=32))
    task.load_dataset("train", upsample_scale=0.5)
    cfg = jtrain.build_model_cfg(SimpleNamespace(
        criterion=crit, model_yaml=str(root / f"{crit}.yaml")), task.vocab)
    if crit == "fastspeech2":
        it = task.get_batch_iterator("train", max_sentences=4, seed=1)
        model = FastSpeech2Encoder(cfg, vocab_size=task.vocab.size,
                                   pad=task.vocab.pad)
    else:
        it = task.get_batch_iterator("train", seed=1, upsample_scale=0.5)
        model = (S2SConformerDAGFastSpeech2(cfg)
                 if crit == "s2s_dag_fastspeech2_loss"
                 else S2TConformerDAG(cfg))
    return task, cfg, model, it


def _variables(crit, model, batch, seed=3):
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    if crit == "fastspeech2":
        return random_variables(model, seed, src_tokens=b["src_tokens"],
                                max_out_len=b["target_audio"].shape[1])
    if crit == "nat_dag_loss":
        return random_variables(model, seed, b["fbank"], b["src_lengths"],
                                b["prev_output_tokens"])
    B, L = b["prev_output_tokens"].shape
    M = b["target_audio"].shape[1]

    def full(m, fbank, lens, prev):
        _, _, feats = m(fbank, lens, prev)
        return m.synthesize(feats, jnp.zeros((B, L), bool), M)

    return random_variables(model, seed, b["fbank"], b["src_lengths"],
                            b["prev_output_tokens"], method=full)


def _jax_loss_fn(crit, model, vocab, kw=None):
    from daspeech_tpu.losses import nat_dag_loss, s2s_dag_fastspeech2_loss
    from daspeech_tpu.losses.tts_loss import fastspeech2_criterion

    kw = kw or {}

    def loss_fn(params_dict, batch, key, step):
        if crit == "fastspeech2":
            return fastspeech2_criterion(model, params_dict, batch, key,
                                         vocab)
        if crit == "s2s_dag_fastspeech2_loss":
            return s2s_dag_fastspeech2_loss(model, params_dict, batch, key,
                                            jnp.float32(0.0), vocab, **kw)
        return nat_dag_loss(model, params_dict, batch, key,
                            jnp.float32(0.0), vocab, **kw)

    return loss_fn


def _port_names(tmodel, tree):
    """{port tensor name: JAX value in the port's layout} of a flax tree."""
    names = {id(m): n for n, m in tmodel.named_modules()}
    out = {}
    for path, v in convert._leaves(tree):
        owner = tmodel
        for name in path[:-1]:
            owner = convert._resolve(owner, name)
        attr, x = convert._convert(owner, path[-1], v)
        prefix = names[id(owner)]
        out[f"{prefix}.{attr}" if prefix else attr] = x
    return out


def _jax_run(crit, root, batches, variables, jax_kw=None):
    """JAX's jitted ``make_train_step`` over ``batches``: the per-update
    losses, each update's gradients (``value_and_grad`` of the same loss at
    the same state) and the final parameters."""
    from daspeech_tpu.train import TrainState, make_optimizer, make_train_step

    task, cfg, model, _ = _jax_side(crit, root)
    loss_fn = _jax_loss_fn(crit, model, task.vocab, jax_kw)
    tx = make_optimizer(lr=LR, warmup_updates=2, warmup_init_lr=1e-7,
                        weight_decay=0.01, clip_norm=1.0)
    state = TrainState.create(jax.tree.map(jnp.asarray, variables), tx)
    step = jax.jit(make_train_step(loss_fn, tx))

    @jax.jit
    def grads_of(state, batch):
        def lossf(params):
            return loss_fn({"params": params,
                            "batch_stats": state.batch_stats},
                           batch, jax.random.key(0), state.step)[0]

        return jax.grad(lossf)(state.params)

    losses, grads = [], []
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        grads.append(jax.tree.map(np.asarray, grads_of(state, jb)))
        state, m = step(state, jb, jax.random.key(0))
        losses.append(float(m["loss"]))
    return losses, grads, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("crit", ["nat_dag_loss", "s2s_dag_fastspeech2_loss",
                                  "fastspeech2"])
def test_loop_matches_jax_make_train_step(crit, corpus, tmp_path):
    _assert_loop_matches_jax(crit, corpus)


def _assert_loop_matches_jax(crit, root, flags=(), jax_kw=None):
    """The port's loop (``cli_args(root, crit) + flags``) against JAX's
    ``make_train_step`` with the criterion's keyword arguments ``jax_kw``
    (the module docstring's bars). Returns the port's losses."""
    args = ttrain.parse_args(cli_args(root, crit, "unused", *flags))
    run = ttrain.build(args, "cpu")
    collated = []
    orig = run.batcher.collate

    def spy(spec, idxs, **kw):
        out = orig(spec, idxs, **kw)
        collated.append(out)
        return out

    run.batcher.collate = spy
    _, _, jmodel, jit = _jax_side(crit, root)
    order = [x for e in range(1, 4) for x in jit.batches_for_epoch(e)]
    jbatches = [jit.collate(spec, idxs) for spec, idxs in order[:N_UPDATES]]
    variables = _variables(crit, jmodel, jbatches[0])
    convert.load_flax_(run.model, variables)

    grads1 = {}

    def on_update(state, update, spec, metrics):
        if update == 1:
            grads1.update({n: p.grad.clone() for n, p
                           in state.model.named_parameters()
                           if p.grad is not None})

    stats = ttrain.train_loop(
        run.state, run.step, run.batcher, "cpu",
        ttrain.LoopConfig(max_update=N_UPDATES, log_interval=1000),
        on_update=on_update)
    for got, want in zip(collated, jbatches):       # the same batches
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    want_losses, want_grads, want_params = _jax_run(crit, root, jbatches,
                                                    variables, jax_kw)
    np.testing.assert_allclose(stats.losses, want_losses, rtol=LOSS_RTOL)

    tparams = dict(run.model.named_parameters())
    g1 = _port_names(run.model, want_grads[0])
    assert set(g1) == set(tparams)
    for name, want in g1.items():
        got = grads1.get(name, torch.zeros(want.shape)).numpy()
        ref = (g1[name[:-len("bias")] + "weight"]
               if name.endswith(SHIFT_BIASES) else want)
        norm = max(float(np.linalg.norm(ref)), 1e-12)
        assert float(np.abs(got - want).max()) <= GRAD_TOL * norm, name

    # sub-floor elements: below 1e-5 of their tensor's largest gradient at
    # any of the updates
    floor = {}
    for g in want_grads:
        for name, x in _port_names(run.model, g).items():
            small = np.abs(x) < SUB_FLOOR * max(float(np.abs(x).max()),
                                                1e-30)
            if name.endswith(KEY_BIASES):
                small = np.ones(x.shape, bool)
            floor[name] = floor.get(name, small) | small
    for name, want in _port_names(run.model, want_params).items():
        err = np.abs(tparams[name].detach().numpy() - want)
        assert float(err[~floor[name]].max(initial=0.0)) <= PARAM_TOL, name
        assert float(err[floor[name]].max(initial=0.0)) <= (
            2 * LR * N_UPDATES), name
    return stats.losses


# ------------------------------------------- the CLI's glance and emission

def test_cmlm_glance_on_jax_draws():
    """``--glance-strategy cmlm``: a uniform fraction of the target length
    glanced, on JAX's own draws."""
    from test_torch_train import _dag_problem
    from daspeech_torch.losses import dag_loss as tloss
    from daspeech_tpu.losses import dag_loss as jloss

    logits, links, tgt, prev = (np.array(x) for x in _dag_problem(7))
    B, L = prev.shape
    key = jax.random.key(3)
    want = jloss.glat_glance(key, jnp.asarray(logits), jnp.asarray(links),
                             jnp.asarray(tgt), jnp.asarray(prev),
                             jnp.float32(0.5), 1, "cmlm")
    k_rand, k_keep = jax.random.split(key)
    draws = tloss.GlanceDraws(
        torch.from_numpy(np.array(jax.random.normal(
            k_rand, (B, L), dtype=jnp.float32))),
        torch.from_numpy(np.array(jax.random.uniform(k_keep, (B, L)))),
        torch.from_numpy(np.array(jax.random.uniform(
            k_rand, (B,), dtype=jnp.float32))))
    got = tloss.glat_glance(torch.from_numpy(logits),
                            torch.from_numpy(links),
                            torch.from_numpy(tgt).long(),
                            torch.from_numpy(prev).long(), 0.5, 1,
                            draws=draws, strategy="cmlm")
    for a, b in ((got.prev_output_tokens, want.prev_output_tokens),
                 (got.keep_word_mask, want.keep_word_mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.keep_word_mask.any()
    np.testing.assert_allclose(got.glat_keep.item(), float(want.glat_keep),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="glance"):
        tloss.glat_glance(torch.from_numpy(logits), torch.from_numpy(links),
                          torch.from_numpy(tgt).long(),
                          torch.from_numpy(prev).long(), 0.5, 1,
                          draws=draws, strategy="nope")


@pytest.mark.parametrize("glanced,no_force_emit", [(True, True),
                                                   (True, False),
                                                   (False, False)])
def test_dag_loss_emission_options_match_jax(glanced, no_force_emit):
    """``compute_dag_loss`` with a glance forced or not
    (``--no-force-emit``) and without a glance (``--glance-strategy
    none``), against JAX's, 1e-6 relative."""
    from test_torch_train import _dag_problem
    from daspeech_torch.losses import dag_loss as tloss
    from daspeech_tpu.losses import dag_loss as jloss

    logits, links, tgt, prev = (np.array(x) for x in _dag_problem(9))
    mm = keep = None
    if glanced:
        info = jloss.glat_glance(jax.random.key(2), jnp.asarray(logits),
                                 jnp.asarray(links), jnp.asarray(tgt),
                                 jnp.asarray(prev), jnp.float32(1.0), 1,
                                 "number-random")
        mm, keep = np.asarray(info.matchmask), np.asarray(
            info.keep_word_mask)
        assert keep.any()
    want, _ = jloss.compute_dag_loss(
        jnp.asarray(logits), jnp.asarray(links), jnp.asarray(tgt),
        jnp.asarray(prev), 1, matchmask=None if mm is None else
        jnp.asarray(mm), keep_word_mask=None if keep is None else
        jnp.asarray(keep), no_force_emit=no_force_emit)
    got, _ = tloss.compute_dag_loss(
        torch.from_numpy(logits), torch.from_numpy(links),
        torch.from_numpy(tgt).long(), torch.from_numpy(prev).long(), 1,
        None if mm is None else torch.from_numpy(mm),
        None if keep is None else torch.from_numpy(keep),
        no_force_emit=no_force_emit)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("crit", ["s2s_dag_fastspeech2_loss", "fastspeech2"])
def test_validation_loss_matches_jax(crit, corpus):
    """The valid loss of the joint and FastSpeech 2 criteria
    (``train=False``: an inference pass, no glance) against JAX's
    ``eval_loss_fn`` (``cli/train.py:622-642``) on the same weights and
    batch, 1e-5 relative."""
    from daspeech_tpu.losses import s2s_dag_fastspeech2_loss as js2s
    from daspeech_tpu.losses.tts_loss import fastspeech2_criterion as jfs2

    from daspeech_torch.data.prefetch import to_device
    from daspeech_torch.losses import (fastspeech2_criterion,
                                       s2s_dag_fastspeech2_loss)

    run = ttrain.build(ttrain.parse_args(cli_args(corpus, crit, "unused")),
                       "cpu")
    task, _, jmodel, jit = _jax_side(crit, corpus)
    spec, idxs = jit.batches_for_epoch(1)[0]
    batch = jit.collate(spec, idxs)
    variables = _variables(crit, jmodel, batch)
    convert.load_flax_(run.model, variables)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pd = {"params": variables["params"],
          "batch_stats": variables.get("batch_stats", {})}
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        if crit == "fastspeech2":
            want = jfs2(jmodel, pd, jb, jax.random.key(1), task.vocab,
                        train=False)[0]
            got = fastspeech2_criterion(run.model, to_device(batch, "cpu"),
                                        g, run.vocab, train=False)[0]
        else:
            want = js2s(jmodel, pd, jb, jax.random.key(1), jnp.float32(0.0),
                        task.vocab, glance_strategy=None, train=False)[0]
            got = s2s_dag_fastspeech2_loss(run.model, to_device(batch, "cpu"),
                                           g, 0.0, run.vocab, train=False)[0]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# ------------------------------------------------------------ main itself

TRAIN_KEYS = {"tag", "epoch", "update", "loss", "gnorm", "skipped", "ups",
              "data_wait_ms", "h2d_ms"}
DONE_KEYS = {"done", "wall_s", "run_data_wait_s", "run_h2d_s",
             "input_wait_frac", "h2d_mb_per_step"}


def _records(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def test_main_logs_jax_keys_and_generate_decodes(corpus, tmp_path, capsys):
    from daspeech_torch.cli import generate

    assert ttrain.main(cli_args(corpus, "nat_dag_loss", tmp_path / "ck",
                                "--max-update", "3",
                                "--save-interval-updates", "2",
                                "--valid-subset", "none")) == 0
    recs = _records(capsys)
    train = [r for r in recs if not r.get("done")]
    assert [r["update"] for r in train] == [1, 2, 3]
    for r in train:
        assert TRAIN_KEYS <= set(r), set(r)
        assert np.isfinite(r["loss"])
    assert DONE_KEYS <= set(recs[-1]) and recs[-1]["done"] is True
    assert CheckpointManager(tmp_path / "ck").all_steps() == [2, 3]

    out = tmp_path / "gen"
    assert generate.main([
        str(corpus), "--task", "nat_speech_to_text", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "ck"), "--gen-subset", "test",
        "--model-yaml", str(corpus / "nat_dag_loss.yaml"),
        "--results-path", str(out), "--max-tokens", "256"]) == 0
    assert len((out / "hypos.txt").read_text().splitlines()) == 12


def test_restore_reproduces_the_straight_run(corpus, tmp_path, monkeypatch,
                                             capsys):
    from daspeech_torch.data.datasets import BucketBatcher

    crit = "s2s_dag_fastspeech2_loss"
    straight = cli_args(corpus, crit, tmp_path / "a", "--max-update", "4",
                        "--save-interval-updates", "2")
    assert ttrain.main(straight) == 0
    assert ttrain.main(cli_args(corpus, crit, tmp_path / "b",
                                "--max-update", "2",
                                "--save-interval-updates", "2")) == 0
    collated = []
    orig = BucketBatcher.collate

    def spy(self, spec, idxs, **kw):
        collated.append(list(idxs))
        return orig(self, spec, idxs, **kw)

    monkeypatch.setattr(BucketBatcher, "collate", spy)
    capsys.readouterr()
    assert ttrain.main(cli_args(corpus, crit, tmp_path / "b",
                                "--max-update", "4", "--restore",
                                "--save-interval-updates", "2")) == 0
    err = capsys.readouterr().err
    assert "restored checkpoint at step 2 (epoch 1, batch 2)" in err

    a = CheckpointManager(tmp_path / "a").restore(step=4)
    b = CheckpointManager(tmp_path / "b").restore(step=4)
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"],
                    b["opt_state"]["mu"] + b["opt_state"]["nu"]):
        assert torch.equal(x, y)
    assert int(a["opt_state"]["count"]) == int(b["opt_state"]["count"]) == 4

    # the resumed run's first collated batch is the saved position (the
    # prefetcher collates in order: nothing before it was collated)
    run = ttrain.build(ttrain.parse_args(straight), "cpu")
    order = [ix for e in (1, 2) for _, ix in
             run.batcher.batches_for_epoch(e)]
    assert len(run.batcher.batches_for_epoch(1)) == 3
    assert collated[:2] == order[2:4]


def test_fsdp_accumulates_microbatches(corpus, tmp_path):
    """``--fsdp --update-freq 2``: each microbatch's backward reduces its
    share, the sharded gradients accumulate; the losses equal the
    unsharded run's within 1e-5 relative."""
    losses = {}
    for name, extra in (("plain", []),
                        ("fsdp", ["--fsdp", "--min-fsdp-size", "64"])):
        seen = []
        assert ttrain.main(cli_args(corpus, "nat_dag_loss", tmp_path / name,
                                    "--max-update", "2", "--update-freq",
                                    "2", "--valid-subset", "none", *extra),
                           on_stats=seen.append) == 0
        losses[name] = seen[0].losses
    assert len(losses["fsdp"]) == 2 and np.isfinite(losses["fsdp"]).all()
    np.testing.assert_allclose(losses["fsdp"], losses["plain"], rtol=1e-5)


def test_fsdp_restore_reproduces_the_straight_run(corpus, tmp_path,
                                                  capsys):
    """``--fsdp --restore`` (a world of one): stopped at 2 and resumed at
    the saved position to 4, the gathered parameters and moments equal a
    straight ``--fsdp`` run's bit for bit."""
    crit = "s2s_dag_fastspeech2_loss"
    flags = ("--save-interval-updates", "2", "--fsdp", "--min-fsdp-size",
             "64", "--valid-subset", "none")
    assert ttrain.main(cli_args(corpus, crit, tmp_path / "a", "--max-update",
                                "4", *flags)) == 0
    assert ttrain.main(cli_args(corpus, crit, tmp_path / "b", "--max-update",
                                "2", *flags)) == 0
    capsys.readouterr()
    assert ttrain.main(cli_args(corpus, crit, tmp_path / "b", "--max-update",
                                "4", "--restore", *flags)) == 0
    assert ("restored checkpoint at step 2 (epoch 1, batch 2)"
            in capsys.readouterr().err)
    a = CheckpointManager(tmp_path / "a").restore(step=4)
    b = CheckpointManager(tmp_path / "b").restore(step=4)
    assert set(a["model"]) == set(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"],
                    b["opt_state"]["mu"] + b["opt_state"]["nu"]):
        assert torch.equal(x, y)
    assert int(b["opt_state"]["count"]) == 4


def test_stage3_transfers_stage1_and_stage2(corpus, tmp_path):
    assert ttrain.main(cli_args(corpus, "nat_dag_loss", tmp_path / "s1",
                                "--max-update", "1",
                                "--valid-subset", "none")) == 0
    assert ttrain.main(cli_args(corpus, "fastspeech2", tmp_path / "s2",
                                "--max-update", "1",
                                "--valid-subset", "none")) == 0
    assert ttrain.main(cli_args(
        corpus, "s2s_dag_fastspeech2_loss", tmp_path / "s3",
        "--max-update", "0", "--valid-subset", "none",
        "--load-pretrained-dag-from", str(tmp_path / "s1"),
        "--load-pretrained-fastspeech-from", str(tmp_path / "s2"))) == 0
    s1 = CheckpointManager(tmp_path / "s1").restore()["model"]
    s2 = CheckpointManager(tmp_path / "s2").restore()["model"]
    s3 = CheckpointManager(tmp_path / "s3").restore()["model"]
    n_dag = n_tts = 0
    for k, v in s3.items():
        if "running_" in k:         # BatchNorm statistics stay the model's
            fresh = 0.0 if k.endswith("mean") else 1.0
            assert bool((v == fresh).all()) and not torch.equal(
                v, s1[k[4:]]), k
        elif k.startswith(("dag.encoder.", "dag.enc_proj.", "dag.decoder.")):
            assert torch.equal(v, s1[k[4:]]), k
            n_dag += 1
        elif k.startswith("tts."):
            assert torch.equal(v, s2[k[4:]]), k
            n_tts += 1
    assert n_dag > 20 and n_tts > 10
    assert "tts.embed_tokens.weight" not in s3


# ------------------------------------------------------------- validation

def test_eval_bleu_validation_keeps_the_best(corpus, tmp_path, capsys):
    assert ttrain.main(cli_args(corpus, "nat_dag_loss", tmp_path / "ck",
                                "--max-update", "2",
                                "--validate-interval-updates", "1",
                                "--save-interval-updates", "1")) == 0
    recs = _records(capsys)
    bleus = [(r["update"], r["valid_bleu"]) for r in recs
             if r["tag"] == "valid"]
    assert [u for u, _ in bleus] == [1, 2]
    assert all(0.0 <= b <= 100.0 for _, b in bleus)
    best = json.loads((tmp_path / "ck" / "best.json").read_text())
    assert best["metric"] == max(b for _, b in bleus)


def test_valid_loss_selects_the_lowest(corpus, tmp_path, capsys):
    assert ttrain.main(cli_args(corpus, "fastspeech2", tmp_path / "ck",
                                "--max-update", "3", "--lr", "1e-2",
                                "--validate-interval-updates", "1",
                                "--save-interval-updates", "1")) == 0
    losses = {r["update"]: r["valid_loss"] for r in _records(capsys)
              if r["tag"] == "valid"}
    assert sorted(losses) == [1, 2, 3]
    best = json.loads((tmp_path / "ck" / "best.json").read_text())
    assert best["step"] == min(losses, key=losses.get)
    assert best["metric"] == pytest.approx(min(losses.values()), abs=1e-4)


def test_eval_inference_mcd_matches_jax(corpus):
    from daspeech_tpu.eval.mcd import mel_cepstral_distortion

    args = ttrain.parse_args(cli_args(corpus, "fastspeech2", "unused",
                                      "--eval-inference"))
    run = ttrain.build(args, "cpu")
    vloss, records = ttrain.make_validator(args, run, "cpu")(run.state)
    got = dict(r for rec, _ in records for r in rec.items())
    assert got["valid_loss"] == round(vloss, 4)
    vit = run.task.get_batch_iterator("dev", max_sentences=4, seed=1)
    want = []
    with torch.inference_mode():
        for spec, idxs in vit.batches_for_epoch(0):
            b = vit.collate(spec, idxs)
            M = b["target_audio"].shape[1]
            mel, _, lens = run.model(src_tokens=torch.as_tensor(
                b["src_tokens"]).long(), max_out_len=2 * M)[:3]
            for i in range(len(idxs)):
                want.append(mel_cepstral_distortion(
                    mel[i, : max(int(lens[i]), 1)].numpy(),
                    b["target_audio"][i, : b["target_audio_lengths"][i]]))
    np.testing.assert_allclose(got["valid_mcd"], round(np.mean(want), 3),
                               rtol=0, atol=1e-6)


# ------------------------------------------------ freezing, crash, refusal

def test_encoder_freezing_updates(corpus):
    args = ttrain.parse_args(cli_args(corpus, "nat_dag_loss", "unused",
                                      "--encoder-freezing-updates", "2"))
    run = ttrain.build(args, "cpu")
    enc = {n: p for n, p in run.model.named_parameters()
           if n.startswith("encoder.")}
    seen = {}

    def on_update(state, update, spec, metrics):
        seen[update] = [float(p.grad.abs().max()) if p.grad is not None
                        else 0.0 for p in enc.values()]

    ttrain.train_loop(run.state, run.step, run.batcher, "cpu",
                      ttrain.LoopConfig(max_update=3, log_interval=1000),
                      on_update=on_update)
    assert max(seen[1]) == max(seen[2]) == 0.0
    assert sum(g > 0 for g in seen[3]) > len(enc) // 2


@pytest.mark.parametrize("saved_before", [False, True])
def test_crash_checkpoint(corpus, tmp_path, capsys, monkeypatch,
                          saved_before):
    """A failure after update 2 leaves a checkpoint of update 2 with the
    position of update 3's batch, from which ``--restore`` reproduces a
    straight run bit for bit. Without a save at 2 the crash checkpoint is
    written (``crash`` in its meta); when update 2 was saved (the failure
    here comes as update 3 starts) that checkpoint is kept as it is."""
    crit = "nat_dag_loss"
    flags = ("--valid-subset", "none", "--save-interval-updates",
             "2" if saved_before else "1000")
    if saved_before:
        real = ttrain.update_generator

        def update_generator(seed, step, rank=0):
            if step == 2:
                raise RuntimeError("injected failure")
            return real(seed, step, rank)

        monkeypatch.setattr(ttrain, "update_generator", update_generator)
        on_update = None
    else:
        def on_update(state, update, spec, metrics):
            if update == 2:
                raise RuntimeError("injected failure")

    with pytest.raises(RuntimeError, match="injected failure"):
        ttrain.main(cli_args(corpus, crit, tmp_path / "ck",
                             "--max-update", "4", *flags),
                    on_update=on_update)
    monkeypatch.undo()
    ck = CheckpointManager(tmp_path / "ck")
    assert ck.all_steps() == [2]
    meta = ck.meta(2)
    assert (meta["epoch"], meta["batch_idx"]) == (1, 2)
    err = capsys.readouterr().err
    if saved_before:
        assert "crash" not in meta
        assert "the checkpoint at step 2 is the last finished update" in err
    else:
        assert meta["crash"] is True
        assert "saved crash checkpoint at step 2" in err

    assert ttrain.main(cli_args(corpus, crit, tmp_path / "ck",
                                "--max-update", "4", "--restore",
                                *flags)) == 0
    assert "restored checkpoint at step 2 (epoch 1, batch 2)" in (
        capsys.readouterr().err)
    assert ttrain.main(cli_args(corpus, crit, tmp_path / "straight",
                                "--max-update", "4", *flags)) == 0
    a = CheckpointManager(tmp_path / "straight").restore(step=4)
    b = CheckpointManager(tmp_path / "ck").restore(step=4)
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"],
                    b["opt_state"]["mu"] + b["opt_state"]["nu"]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("crit", ["tts_transformer", "s2s_multidecoder"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ar_criteria_train_and_validate(crit, dtype, corpus, tmp_path,
                                        capsys):
    """The two AR criteria (once refused) train 3 updates on the CPU in
    fp32 and bf16: finite losses with their terms, a valid loss equal to
    the criterion's own inference-mode loss over the dev batches of the
    saved model, and a checkpoint of every parameter."""
    assert ttrain.main(cli_args(
        corpus, crit, tmp_path / "ck", "--max-update", "3", "--dtype",
        dtype, "--validate-interval-updates", "3")) == 0
    recs = _records(capsys)
    losses = [r["loss"] for r in recs if "loss" in r and "done" not in r]
    assert len(losses) == 3 and np.isfinite(losses).all()
    terms = {"l1-loss", "stop-loss"} | (
        {"mt-loss"} if crit == "s2s_multidecoder" else set())
    assert terms <= set(recs[0])
    vloss = [r["valid_loss"] for r in recs if "valid_loss" in r]
    assert len(vloss) == 1 and np.isfinite(vloss[0])
    args = ttrain.parse_args(cli_args(corpus, crit, "unused", "--dtype",
                                      dtype))
    run = ttrain.build(args, "cpu")
    saved = CheckpointManager(tmp_path / "ck").restore()["model"]
    assert set(saved) == set(run.model.state_dict())
    run.model.load_state_dict(saved)
    _, records = ttrain.make_validator(args, run, "cpu")(run.state)
    assert records[0][0]["valid_loss"] == vloss[0]


def test_fsdp_trains_as_one_unsharded_process(corpus, tmp_path, capsys,
                                              monkeypatch):
    """``--fsdp --min-fsdp-size 64`` in one process (a world of one): the
    joint model trains through the FSDP root with finite losses equal to
    the unsharded run's within 1e-5 relative; its checkpoint holds the
    unsharded run's tensors, in its format, within 1e-5; the group of one
    is gone after."""
    import torch.distributed as dist

    from daspeech_torch.parallel import partition

    calls = []
    real = partition.FSDP.run
    monkeypatch.setattr(partition.FSDP, "run", lambda self, *a: (
        calls.append(1), real(self, *a))[1])
    losses, states = {}, {}
    for name, extra in (("plain", []),
                        ("fsdp", ["--fsdp", "--min-fsdp-size", "64"])):
        seen = []
        assert ttrain.main(cli_args(corpus, "s2s_dag_fastspeech2_loss",
                                    tmp_path / name, "--max-update", "3",
                                    "--valid-subset", "none", *extra),
                           on_stats=seen.append) == 0
        recs = _records(capsys)
        losses[name] = seen[0].losses
        states[name] = CheckpointManager(tmp_path / name).restore()
    assert len(calls) == 3 and recs[-1]["world_size"] == 1
    assert not dist.is_initialized()
    assert np.isfinite(losses["fsdp"]).all()
    np.testing.assert_allclose(losses["fsdp"], losses["plain"], rtol=1e-5)
    a, b = states["plain"], states["fsdp"]
    assert set(a["model"]) == set(b["model"]) and b["step"] == 3
    for k, v in a["model"].items():
        np.testing.assert_allclose(b["model"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    for x, y in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"],
                    b["opt_state"]["mu"] + b["opt_state"]["nu"]):
        assert x.shape == y.shape


@pytest.mark.parametrize("flags", [
    ["--rng-impl", "rbg"], ["--no-packed-h2d"], ["--h2d-dtype", "bfloat16"],
    ["--compilation-cache-dir", "x"]])
def test_tpu_options_are_not_accepted(flags, corpus, tmp_path):
    with pytest.raises(SystemExit) as e:
        ttrain.main(cli_args(corpus, "nat_dag_loss", tmp_path / "ck")
                    + flags)
    assert e.value.code == 2


def test_default_device_needs_a_card(corpus, tmp_path):
    assert not torch.cuda.is_available()
    argv = [a for a in cli_args(corpus, "nat_dag_loss", tmp_path / "ck")]
    i = argv.index("--device")
    del argv[i: i + 2]
    with pytest.raises(SystemExit) as e:
        ttrain.main(argv)
    assert e.value.code not in (0, None)
    assert not (tmp_path / "ck").exists()


def test_update_freq_accumulates_batches(corpus, tmp_path, capsys):
    assert ttrain.main(cli_args(corpus, "nat_dag_loss", tmp_path / "ck",
                                "--max-update", "2", "--update-freq", "2",
                                "--valid-subset", "none")) == 0
    recs = _records(capsys)
    assert recs[-1]["done"] and recs[-1]["update"] == 2


def test_profile_dir_writes_a_trace(corpus, tmp_path, capsys):
    """``--profile-dir``: a ``torch.profiler`` trace from update 5 on
    (stopped at 15, or at the end of a shorter run), with the step's
    spans."""
    assert ttrain.main(cli_args(corpus, "fastspeech2", tmp_path / "ck",
                                "--max-update", "6", "--valid-subset",
                                "none", "--profile-dir",
                                str(tmp_path / "prof"))) == 0
    trace = json.loads((tmp_path / "prof" / "trace_rank0.json").read_text())
    assert trace["traceEvents"]
    names = {e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"train.forward", "train.backward", "train.optimizer"} <= names


def test_staging_holds_the_batch():
    """The pinned copy's staging (``data.prefetch.stage``), on an ordinary
    host buffer here: each array of a collated batch, nested ones and
    0-d ones too, lands bit for bit at an ALIGN-byte offset of one uint8
    buffer, in its dtype and shape, and the rebuilt batch keeps the
    batch's structure and scalars; ``to_device`` on the CPU widens the
    integer arrays to int64."""
    from daspeech_torch.data import prefetch

    rng = np.random.default_rng(0)
    batch = {"fbank": rng.normal(size=(3, 5, 80)).astype(np.float32),
             "src_lengths": np.array([5, 4, 3], np.int32),
             "scale": np.float32(0.5) * np.ones((), np.float32),
             "multitask": {"tgt": rng.integers(0, 9, (3, 7)).astype(
                 np.int32)},
             "n": 3}
    buf = torch.empty(prefetch.staging_bytes(batch), dtype=torch.uint8)
    views = dict(prefetch.stage(batch, buf))
    for path, a in prefetch._arrays(batch):
        v = views[path]
        assert (v.data_ptr() - buf.data_ptr()) % prefetch.ALIGN == 0
        np.testing.assert_array_equal(v.numpy(), a)
        assert v.numpy().dtype == a.dtype
    got = prefetch._rebuild(batch, views, {})
    assert got["n"] == 3 and got["multitask"]["tgt"].shape == (3, 7)
    moved = prefetch.consume(prefetch.to_device(batch, "cpu"))
    assert moved["src_lengths"].dtype == torch.int64
    assert moved["multitask"]["tgt"].dtype == torch.int64
    assert torch.equal(moved["fbank"], torch.from_numpy(batch["fbank"]))


def test_new_clis_import_no_jax():
    """A fresh interpreter imports every new entry point and never loads
    jax, flax or the JAX package."""
    code = ("import sys\n"
            "import daspeech_torch.cli.train, daspeech_torch.cli.parity\n"
            "import daspeech_torch.cli.train_vocoder\n"
            "import daspeech_torch.cli.eval_pipeline\n"
            "import daspeech_torch.preprocess.prep_data\n"
            "import daspeech_torch.parallel.multihost\n"
            "import daspeech_torch.eval\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'flax', 'daspeech_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   capture_output=True, timeout=300)
