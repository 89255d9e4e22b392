"""The port's bf16 training (``--dtype bfloat16``) against the JAX package,
on the CPU at small widths: one S2TT (``nat_dag_loss``), one joint S2ST
(``s2s_dag_fastspeech2_loss``, ``expect``) and one FastSpeech 2 step, and
the train CLI.

Each step runs with dropout 0 and GLAT p = 0 (GLAT's argmax over bf16
logits is a discrete decision the two packages could take differently at
a near tie), FastSpeech 2 on gold durations, pitches and energies at bucket
centres. The JAX side takes the recipe's kernel route (its Pallas kernels
in interpret mode, ``test_torch_bf16_models.py``). Parameters, gradients
and Adam's moments stay fp32.

The bar is the modules' one, ||port_bf16 - jax_bf16|| <= 2 ||jax_bf16 -
jax_fp32||, held on statistics that bf16 rounding noise cannot push over it
by chance:

* the gradients: on all of them at once, each tensor scaled by its fp32
  norm (floored at 1e-4 of the global norm: a key projection's bias has
  an exact gradient of 0) so that every tensor weighs alike; and each
  tensor alone within PER_TENSOR (8) times its own bar. A single tensor's bf16 error is heavy
  tailed where it is a sum that nearly cancels (a positional scale, a bias
  summed over every frame, q/k gradients through dS = P (dP - delta)):
  the same FastSpeech 2 decoder stack fed four inputs measured the port's
  distance to fp32 at 1.58, 0.79, 0.82 and 1.11 times JAX's own, and one
  joint batch put a scalar gradient at 6.8 times its bar, while the port's
  activations (logits, links, features, alpha/beta, the expected features,
  the mel) sit as far from fp32 as JAX's bf16 ones;
* the loss (a scalar): the same bar floored at one bf16 rounding of the
  loss (2^-8 of its value): JAX's own bf16 S2TT loss lands 1e-4 from
  fp32 by cancellation while its logits are as far from fp32 as the
  port's (0.331 and 0.329).

The CLI: ``python -m daspeech_torch.cli.train --dtype bfloat16 --device
cpu`` for 2 updates of each criterion with a validation, finite losses,
fp32 checkpoints, and the generate CLI decoding the S2TT checkpoint.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daspeech_torch import convert
from daspeech_torch.cli import train as ttrain
from daspeech_torch.losses import dag_loss as tloss
from daspeech_torch.losses import s2s_loss as ts2s
from daspeech_torch.losses import tts_loss as ttts
from daspeech_torch.models import dag_model as tdag
from daspeech_torch.models import fastspeech2 as tfs
from daspeech_torch.models import s2s_model as tmodel
from daspeech_torch.train import GuardedAdam, TrainState, make_train_step
from daspeech_torch.train.checkpoint import CheckpointManager
from daspeech_tpu.losses import dag_loss as jloss
from daspeech_tpu.losses import s2s_loss as js2s
from daspeech_tpu.losses import tts_loss as jtts
from daspeech_tpu.models import dag_model as jdag
from daspeech_tpu.models import fastspeech2 as jfs
from daspeech_tpu.models import s2s_model as jmodel
from test_torch_bf16_models import (bf16_gap, jax_kernel_route,  # noqa: F401
                                    one_thread)
from test_torch_fs2_train import V, VOCAB
from test_torch_fs2_train import _batch as fs2_batch
from test_torch_fs2_train import _cfg as fs2_cfg
from test_torch_joint import _joint_batch, _joint_variables
from test_torch_joint import _small_cfg as joint_cfg
from test_torch_models import random_variables
from test_torch_train import _grad_pairs, _small_batch, _small_cfg
from torch_cli_corpus import cli_args, write_corpus

BF16 = torch.bfloat16
PER_TENSOR = 8.0     # each gradient alone: times its own bar
LOSS_FLOOR = 2.0 ** -8   # one bf16 rounding, of the loss's value


def _tb(batch):
    return {k: torch.tensor(x).long() if x.dtype == np.int32
            else torch.tensor(x) for k, x in batch.items()}


def _jax_value_and_grad(loss_of, v):
    """{dtype: (loss, grads)} of ``loss_of(dtype, params)`` in bf16 and
    fp32."""
    out = {}
    for dt in (jnp.bfloat16, jnp.float32):
        (loss, _), grads = jax.value_and_grad(
            lambda p: loss_of(dt, p), has_aux=True)(
                jax.tree.map(jnp.asarray, v["params"]))
        out[dt] = (float(loss), jax.tree.map(np.asarray, grads))
    return out


def _assert_step(tm, loss, want):
    """The loss and the gradients within the bf16 bar (module docstring)."""
    (lb, gb), (lf, gf) = want[jnp.bfloat16], want[jnp.float32]
    gap = abs(loss.item() - lb)
    bar = max(2 * abs(lb - lf), LOSS_FLOOR * abs(lf))
    assert gap <= bar, ("loss", loss.item(), lb, lf)
    fp32 = {n: x for n, _, x in _grad_pairs(tm, gf)}
    pairs = list(_grad_pairs(tm, gb))
    assert len(pairs) == sum(1 for _ in tm.parameters())
    port_jax = jax_jax = 0.0
    # a key projection's bias has an exact gradient of 0: each tensor's
    # scale is floored at 1e-4 of the global fp32 norm
    floor = 1e-4 * float(np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                                      for x in fp32.values())))
    for name, got, want_b in pairs:
        assert got is not None and got.dtype == torch.float32, name
        gap, bar = bf16_gap(got, want_b, fp32[name], name)
        assert gap <= PER_TENSOR * bar, (name, gap, bar)
        scale = max(float(np.linalg.norm(fp32[name])), floor)
        port_jax += (gap / scale) ** 2
        jax_jax += (float(np.linalg.norm(want_b - fp32[name])) / scale) ** 2
    assert port_jax ** 0.5 <= 2 * jax_jax ** 0.5, (port_jax, jax_jax)


def test_s2tt_step():
    cfg = _small_cfg()
    batch = _small_batch(cfg, 0)
    v = random_variables(jdag.S2TConformerDAG(cfg), 1, batch["fbank"],
                         batch["src_lengths"], batch["prev_output_tokens"])
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    def loss_of(dt, params):
        return jloss.nat_dag_loss(
            jdag.S2TConformerDAG(cfg, dtype=dt),
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            jax.random.key(5), jnp.float32(0.0), cfg.vocab)

    want = _jax_value_and_grad(loss_of, v)
    tm = convert.load_flax_(tdag.S2TConformerDAG(cfg, dtype=BF16), v).train()
    loss, metrics = tloss.nat_dag_loss(tm, _tb(batch), torch.Generator(),
                                       0.0, cfg.vocab)
    assert loss.dtype == torch.float32
    loss.backward()
    _assert_step(tm, loss, want)


def test_joint_step():
    cfg = joint_cfg()
    batch = _joint_batch(cfg, 0)
    v = _joint_variables(jmodel.S2SConformerDAGFastSpeech2(cfg), batch, 1)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    def loss_of(dt, params):
        return js2s.s2s_dag_fastspeech2_loss(
            jmodel.S2SConformerDAGFastSpeech2(cfg, dtype=dt),
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            jax.random.key(3), jnp.float32(0.0), cfg.dag.vocab)

    want = _jax_value_and_grad(loss_of, v)
    tm = convert.load_flax_(
        tmodel.S2SConformerDAGFastSpeech2(cfg, dtype=BF16), v).train()
    loss, _ = ts2s.s2s_dag_fastspeech2_loss(tm, _tb(batch),
                                            torch.Generator(), 0.0,
                                            cfg.dag.vocab)
    loss.backward()
    _assert_step(tm, loss, want)


def test_fastspeech2_step():
    cfg = fs2_cfg()
    batch = fs2_batch(cfg, 9)
    v = random_variables(jfs.FastSpeech2Encoder(cfg, vocab_size=V,
                                                pad=VOCAB.pad), 10,
                         src_tokens=batch["src_tokens"],
                         max_out_len=batch["target_audio"].shape[1])
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    def loss_of(dt, params):
        return jtts.fastspeech2_criterion(
            jfs.FastSpeech2Encoder(cfg, vocab_size=V, pad=VOCAB.pad,
                                   dtype=dt), {"params": params}, jb,
            jax.random.key(0), VOCAB)

    want = _jax_value_and_grad(loss_of, v)
    tm = convert.load_flax_(
        tfs.FastSpeech2Encoder(cfg, V, VOCAB.pad, dtype=BF16), v).train()
    loss, _ = ttts.fastspeech2_criterion(tm, _tb(batch), torch.Generator(),
                                         VOCAB)
    loss.backward()
    _assert_step(tm, loss, want)


def test_train_step_keeps_fp32_state():
    """``make_train_step`` on a bf16 model: fp32 parameters, gradients and
    moments, a finite fp32 gradient norm, and the parameters moved."""
    cfg = _small_cfg()
    batch = _tb(_small_batch(cfg, 2))
    tm = tdag.S2TConformerDAG(cfg, dtype=BF16)
    ttrain.init_weights_(tm, torch.Generator().manual_seed(0))
    opt = GuardedAdam(lr=1e-3, warmup_updates=1)
    state = TrainState.create(tm.train(), opt)
    before = [p.detach().clone() for p in state.params]
    step = make_train_step(lambda m, b, g: tloss.nat_dag_loss(
        m, b, g, 0.0, cfg.vocab), opt)
    m = step(state, batch, torch.Generator().manual_seed(0))
    assert m["gnorm"].dtype == torch.float32
    assert torch.isfinite(m["gnorm"]) and m["skipped"].item() == 0
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in state.params)
    assert all(x.dtype == torch.float32
               for x in state.opt_state.mu + state.opt_state.nu)
    assert any(not torch.equal(a, p) for a, p in zip(before, state.params))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16_cli")
    write_corpus(root)
    return root


@pytest.mark.parametrize("crit", ["nat_dag_loss", "s2s_dag_fastspeech2_loss",
                                  "fastspeech2"])
def test_cli_trains_and_validates_in_bf16(crit, corpus, tmp_path, capsys):
    """The port's ``tests/test_cli.py::test_bf16_training``: 2 updates and a
    validation under ``--dtype bfloat16``, finite losses, fp32
    checkpoints; the S2TT checkpoint decodes through the generate CLI."""
    from daspeech_torch.cli import generate

    ck = tmp_path / "ck"
    assert ttrain.main(cli_args(corpus, crit, ck, "--max-update", "2",
                                "--dtype", "bfloat16",
                                "--validate-interval-updates", "2")) == 0
    recs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    train = [r for r in recs if r["tag"] == "train" and not r.get("done")]
    assert [r["update"] for r in train] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["skipped"] == 0 for r in train)
    valid = [r for r in recs if r["tag"] == "valid"]
    assert len(valid) == 1
    key = "valid_bleu" if crit == "nat_dag_loss" else "valid_loss"
    assert np.isfinite(valid[0][key])
    saved = CheckpointManager(ck).restore(step=2)
    assert all(t.dtype == torch.float32 for t in saved["model"].values()
               if t.is_floating_point())
    if crit != "nat_dag_loss":
        return
    out = tmp_path / "gen"
    assert generate.main([
        str(corpus), "--task", "nat_speech_to_text", "--device", "cpu",
        "--checkpoint-dir", str(ck), "--gen-subset", "test",
        "--model-yaml", str(corpus / "nat_dag_loss.yaml"),
        "--results-path", str(out), "--max-tokens", "256"]) == 0
    assert len((out / "hypos.txt").read_text().splitlines()) == 12


def test_cli_dtype_builds_the_model_in_it(corpus):
    args = ttrain.parse_args(cli_args(corpus, "fastspeech2", "x",
                                      "--dtype", "bfloat16"))
    run = ttrain.build(args, torch.device("cpu"))
    assert run.model.out_proj.dtype == BF16
    assert all(p.dtype == torch.float32 for p in run.model.parameters())
    args = ttrain.parse_args(cli_args(corpus, "fastspeech2", "x"))
    assert ttrain.build(args, torch.device("cpu")).model.out_proj.dtype == \
        torch.float32
