"""The port's S2TT DAG training step (``daspeech_torch``) against the JAX
package, on the CPU at small widths.

* the plain backward of packed attention, link extraction and rel-pos
  attention against ``jax.vjp`` of the Pallas kernels in interpret mode
  (dropout 0), 1e-5 absolute (fp32, sums in another order);
* the Philox dropout mask: drop fraction, 1/keep_p scale, and that the
  closed-form backward replays the forward's mask (autograd through the
  plain forward agrees with it to 1e-5);
* ``MaskedBatchNorm`` batch statistics and running-statistic update against
  flax, 1e-5;
* ``glat_glance`` fed JAX's own draws: glanced tokens, ``matchmask`` and
  ``keep_word_mask`` equal;
* ``nat_dag_loss`` loss and every parameter gradient against JAX on a
  small ``S2TConformerDAG`` (2 encoder layers, 1 decoder layer), dropout 0,
  train mode with GLAT p = 0.5 on JAX's glance draws: loss to 1e-5
  relative, each gradient to 1e-4 of its own largest entry or of 1e-3,
  whichever is larger (fp32 through some 60 ops each way; measured <= 4e-6),
  BatchNorm statistics to 1e-5;
* the guarded Adam update and the inverse-sqrt schedule against the optax
  chain over 3 steps, one of them non-finite and skipped, 1e-6;
* a learnability run (``tests/test_learning.py:56``).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import optax

from daspeech_torch import convert
from daspeech_torch.losses import dag_loss as tloss
from daspeech_torch.models import conformer as tconf
from daspeech_torch.models import dag_model as tdag
from daspeech_torch.models import layers as tlayers
from daspeech_torch.ops import fused_attention as tfa
from daspeech_torch.ops import fused_links as tfl
from daspeech_torch.ops import fused_relpos as tfr
from daspeech_torch.ops import philox
from daspeech_torch.train import (GuardedAdam, TrainState, make_train_step,
                                  inverse_sqrt_schedule)
from daspeech_tpu.core.config import (ConformerConfig, DAGDecoderConfig,
                                      DAGModelConfig, VocabConfig)
from daspeech_tpu.losses import dag_loss as jloss
from daspeech_tpu.models import conformer as jconf
from daspeech_tpu.models import dag_model as jdag
from daspeech_tpu.ops import fused_attention as jfa
from daspeech_tpu.ops import fused_links as jfl
from daspeech_tpu.ops import fused_relpos as jfr
from daspeech_tpu.train import train_state as jts
from test_torch_models import random_variables

ATOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
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


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _bias(B, Tk):
    valid = np.ones((B, Tk), bool)
    valid[-1, -3:] = False
    return np.where(valid, 0.0, tfa.NEG).astype(np.float32)


class TestBackwardAgainstPallas:
    @pytest.mark.parametrize("B,Tq,Tk,H,d", [(2, 10, 13, 2, 8),
                                             (2, 7, 24, 2, 8)])
    def test_attention(self, B, Tq, Tk, H, d):
        rng = np.random.default_rng(Tq + Tk)
        q, k, v = (rng.normal(size=(B, T, H * d)).astype(np.float32)
                   for T in (Tq, Tk, Tk))
        q *= d ** -0.5
        g = rng.normal(size=(B, Tq, H * d)).astype(np.float32)
        bias = _bias(B, Tk)
        _, vjp = jax.vjp(lambda q, k, v: jfa.fused_attention_packed(
            q, k, v, jnp.asarray(bias), 0, 1.0, 0.0, False, H), q, k, v)
        want = vjp(jnp.asarray(g))
        tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
        tfa.fused_attention_packed(tq, tk, tv, _t(bias), H).backward(_t(g))
        for got, w in zip((tq.grad, tk.grad, tv.grad), want):
            _close(got, w)

    @pytest.mark.parametrize("B,L,H,dk,mtl,ol", [
        (2, 13, 2, 8, None, (13, 10)),
        (2, 24, 2, 8, None, (24, 2)),     # a graph with one valid edge
        (2, 20, 2, 8, 6, (20, 17)),       # the transition band
    ])
    def test_links(self, B, L, H, dk, mtl, ol):
        rng = np.random.default_rng(L + dk)
        q = rng.normal(size=(B, L, H * dk)).astype(np.float32)
        k = rng.normal(size=(B, L, H * dk)).astype(np.float32)
        gates = np.asarray(jax.nn.log_softmax(
            rng.normal(size=(B, L, H)).astype(np.float32), axis=-1))
        ol = np.asarray(ol, np.int32)
        sc = 1.0 / math.sqrt(dk)
        valid = np.asarray(tfl._valid(L, torch.from_numpy(ol), mtl, "cpu"))
        g = np.where(valid, rng.normal(size=(B, L, L)), 0.0).astype(
            np.float32)
        _, vjp = jax.vjp(lambda q, k, gt: jfl.fused_extract_links(
            q, k, gt, jnp.asarray(ol), H, sc, mtl), q, k, gates)
        want = vjp(jnp.asarray(g))
        tq, tk, tg = _t(q, True), _t(k, True), _t(gates, True)
        tfl.fused_extract_links(tq, tk, tg, torch.from_numpy(ol), H, sc,
                                mtl).backward(_t(g))
        for got, w in zip((tq.grad, tk.grad, tg.grad), want):
            _close(got, w)

    @pytest.mark.parametrize("B,T,H,d", [(2, 10, 2, 8), (1, 17, 2, 8)])
    def test_relpos(self, B, T, H, d):
        rng = np.random.default_rng(B + T)
        C = H * d
        q, k, v = (rng.normal(size=(B, T, C)).astype(np.float32)
                   for _ in range(3))
        a = (rng.normal(size=(B, T, H * C)) * 0.3).astype(np.float32)
        e = np.asarray(jfr.relpos_basis(T, C)[2])
        bias = _bias(B, T)
        g = rng.normal(size=(B, T, C)).astype(np.float32)
        sc = 1.0 / math.sqrt(d)
        _, vjp = jax.vjp(lambda q, k, v, a: jfr.fused_attention_relpos(
            q, k, v, a, jnp.asarray(e), jnp.asarray(bias),
            jnp.zeros((B,), jnp.int32), sc, 0.0, False, H), q, k, v, a)
        want = vjp(jnp.asarray(g))
        ts = [_t(x, True) for x in (q, k, v, a)]
        tfr.fused_attention_relpos(*ts, _t(e), _t(bias), H, sc).backward(
            _t(g))
        for got, w in zip((x.grad for x in ts), want):
            _close(got, w)


class TestDropoutMask:
    def test_attention_mask_fraction_and_scale(self):
        seeds = torch.tensor([3, -1234567, 2 ** 31 - 1], dtype=torch.int32)
        p = 0.1
        m = philox.attention_keep(seeds, 4, 64, 96, p)
        kept = m[m != 0]
        assert torch.all(kept == torch.tensor(1.0 / (1.0 - p)))
        n = m.numel()
        frac = (m == 0).float().mean().item()
        assert abs(frac - p) < 4 * math.sqrt(p * (1 - p) / n)
        # rows, heads and seeds draw distinct streams
        assert not torch.equal(m[0, 0], m[0, 1])
        assert not torch.equal(m[0], m[1])
        assert torch.equal(m, philox.attention_keep(seeds, 4, 64, 96, p))

    @pytest.mark.parametrize("op", ["attention", "relpos"])
    def test_backward_replays_the_forward_mask(self, op):
        rng = np.random.default_rng(1)
        B, T, H, d, p = 2, 11, 2, 8, 0.3
        C = H * d
        q, k, v, g = (rng.normal(size=(B, T, C)).astype(np.float32)
                      for _ in range(4))
        a = (rng.normal(size=(B, T, H * C)) * 0.3).astype(np.float32)
        e = np.asarray(jfr.relpos_basis(T, C)[2])
        bias = _bias(B, T)
        seeds = torch.tensor([7, -9], dtype=torch.int32)
        if op == "attention":
            ins = [_t(x, True) for x in (q, k, v)]
            f = lambda *x: tfa.attention_plain(  # noqa: E731
                *x, _t(bias), H, 1.0, p, seeds)
            fused = lambda *x: tfa.fused_attention_packed(  # noqa: E731
                *x, _t(bias), H, 1.0, p, seeds)
        else:
            ins = [_t(x, True) for x in (q, k, v, a)]
            f = lambda q, k, v, a: tfr.relpos_plain(  # noqa: E731
                q, k, v, a, _t(e), _t(bias), H, 0.35, p, seeds)
            fused = lambda q, k, v, a: tfr.fused_attention_relpos(  # noqa
                q, k, v, a, _t(e), _t(bias), H, 0.35, p, seeds)
        out = f(*ins)
        want = torch.autograd.grad(out, ins, _t(g))
        ins2 = [x.detach().requires_grad_(True) for x in ins]
        out2 = fused(*ins2)
        _close(out2, out.detach().numpy(), 0.0)
        got = torch.autograd.grad(out2, ins2, _t(g))
        for x, y in zip(got, want):
            _close(x, y.numpy())
        # and the mask really dropped something
        nodrop = (tfa.attention_plain(*ins[:3], _t(bias), H, 1.0)
                  if op == "attention" else
                  tfr.relpos_plain(*ins, _t(e), _t(bias), H, 0.35))
        assert (nodrop - out).abs().max().item() > 1e-3

    def test_layer_dropout_keep_probability_and_scale(self):
        g = torch.Generator().manual_seed(0)
        x = torch.ones(200_000)
        y = tlayers.dropout(x, 0.1, g)
        q = round(0.9 * 65536)
        assert torch.all((y == 0) | (y == 65536.0 / q))
        frac = (y == 0).float().mean().item()
        p_drop = 1 - q / 65536
        assert abs(frac - p_drop) < 4 * math.sqrt(p_drop * 0.9 / x.numel())
        assert torch.equal(tlayers.dropout(x, 0.1, None), x)


def test_masked_batchnorm_train_mode_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 9, 6)).astype(np.float32) * 2 + 1
    valid = np.ones((3, 9), bool)
    valid[1, 5:] = False
    valid[2, 2:] = False
    jm = jconf.MaskedBatchNorm(6)
    v = random_variables(jm, 4, x, valid, use_running_average=False)
    y, upd = jm.apply(v, x, valid, use_running_average=False,
                      mutable=["batch_stats"])
    tm = convert.load_flax_(tconf.MaskedBatchNorm(6), v)
    got = tm(_t(x), _t(valid))
    _close(got, y)
    _close(tm.running_mean, upd["batch_stats"]["mean"])
    _close(tm.running_var, upd["batch_stats"]["var"])


def _dag_problem(seed, B=3, L=12, T=6, V=16, pad=1):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, L, V)).astype(np.float32) * 2
    H, dk = 2, 8
    q = rng.normal(size=(B, L, H * dk)).astype(np.float32)
    k = rng.normal(size=(B, L, H * dk)).astype(np.float32)
    gates = np.asarray(jax.nn.log_softmax(
        rng.normal(size=(B, L, H)).astype(np.float32), axis=-1))
    ol = np.array([L, L - 2, L - 5][:B], np.int32)
    links = np.asarray(jfl.xla_extract_links(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(gates), jnp.asarray(ol),
        H, 1 / math.sqrt(dk), None))
    tgt = rng.integers(4, V, size=(B, T)).astype(np.int32)
    tgt[1, T - 2:] = pad
    prev = np.full((B, L), 3, np.int32)
    for b in range(B):
        prev[b, ol[b]:] = pad
    return logits, links, tgt, prev


@pytest.mark.parametrize("p", [0.5, 1.0, 0.0])
def test_glat_glance_on_jax_draws(p):
    logits, links, tgt, prev = _dag_problem(5)
    B, L = prev.shape
    key = jax.random.key(11)
    want = jloss.glat_glance(key, jnp.asarray(logits), jnp.asarray(links),
                             jnp.asarray(tgt), jnp.asarray(prev),
                             jnp.float32(p), 1, "number-random")
    k_rand, k_keep = jax.random.split(key)
    draws = tloss.GlanceDraws(
        _t(jax.random.normal(k_rand, (B, L), dtype=jnp.float32)),
        _t(jax.random.uniform(k_keep, (B, L))))
    got = tloss.glat_glance(_t(logits), _t(links), _t(tgt).long(),
                            _t(prev).long(), p, 1, draws=draws)
    np.testing.assert_array_equal(got.prev_output_tokens.numpy(),
                                  np.asarray(want.prev_output_tokens))
    np.testing.assert_array_equal(got.matchmask.numpy(),
                                  np.asarray(want.matchmask))
    np.testing.assert_array_equal(got.keep_word_mask.numpy(),
                                  np.asarray(want.keep_word_mask))
    assert got.keep_word_mask.any() == (p > 0)
    np.testing.assert_allclose(got.glat_accu.item(), float(want.glat_accu),
                               rtol=1e-6)
    np.testing.assert_allclose(got.glat_keep.item(), float(want.glat_keep),
                               rtol=1e-6)


def _small_cfg():
    return DAGModelConfig(
        vocab=VocabConfig(size=16),
        encoder=ConformerConfig(embed_dim=16, ffn_dim=32, num_layers=2,
                                num_heads=2, dropout=0.0, attn_dropout=0.0,
                                depthwise_kernel_size=7, conv_channels=8),
        decoder=DAGDecoderConfig(embed_dim=32, ffn_dim=64, num_layers=1,
                                 num_heads=2, dropout=0.0, attn_dropout=0.0,
                                 activation_dropout=0.0,
                                 max_target_positions=64))


def _small_batch(cfg, seed, B=3, S=48, T=6):
    rng = np.random.default_rng(seed)
    fbank = rng.normal(size=(B, S, 80)).astype(np.float32)
    lens = np.array([S, S - 8, S - 16][:B], np.int32)
    prev = np.asarray(jdag.initialize_output_tokens(
        jdag.graph_lengths(jnp.asarray(lens), 0.5, 64), S // 2, cfg.vocab))
    tgt = rng.integers(4, cfg.vocab.size, size=(B, T)).astype(np.int32)
    tgt[:, 0], tgt[:, -1] = cfg.vocab.bos, cfg.vocab.eos
    tgt[2, T - 2:] = cfg.vocab.pad
    tgt[2, T - 3] = cfg.vocab.eos
    return {"fbank": fbank, "src_lengths": lens, "target": tgt,
            "prev_output_tokens": prev}


def _grad_pairs(tmodel, jgrads):
    """(name, port grad, JAX grad in the port's layout) per parameter."""
    for path, g in convert._leaves(jgrads):
        owner = tmodel
        for name in path[:-1]:
            owner = convert._resolve(owner, name)
        attr, x = convert._convert(owner, path[-1], g)
        yield "/".join(path), getattr(owner, attr).grad, x


def test_nat_dag_loss_and_gradients_match_jax():
    cfg = _small_cfg()
    batch = _small_batch(cfg, 0)
    jm = jdag.S2TConformerDAG(cfg)
    v = random_variables(jm, 1, batch["fbank"], batch["src_lengths"],
                         batch["prev_output_tokens"])
    key = jax.random.key(5)
    p = 0.5

    def lossf(params):
        loss, aux = jloss.nat_dag_loss(
            jm, {"params": params, "batch_stats": v["batch_stats"]},
            {k: jnp.asarray(x) for k, x in batch.items()}, key,
            jnp.float32(p), cfg.vocab)
        return loss, aux

    (want_loss, aux), want_grads = jax.value_and_grad(lossf, has_aux=True)(
        jax.tree.map(jnp.asarray, v["params"]))

    # the glance draws JAX made (nat_dag_loss splits dropout | glat, then
    # glat_glance splits rand | keep)
    _, k_glat = jax.random.split(key)
    k_rand, k_keep = jax.random.split(k_glat)
    B, L = batch["prev_output_tokens"].shape
    draws = tloss.GlanceDraws(
        _t(jax.random.normal(k_rand, (B, L), dtype=jnp.float32)),
        _t(jax.random.uniform(k_keep, (B, L))))
    tm = convert.dag_from_flax(v, cfg, device="cpu")
    tb = {k: _t(x).long() if x.dtype == np.int32 else _t(x)
          for k, x in batch.items()}
    loss, metrics = tloss.nat_dag_loss(tm, tb, torch.Generator(), p,
                                       cfg.vocab, glat_draws=draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert float(aux["metrics"]["glat_keep"]) > 0     # the glance glanced
    np.testing.assert_allclose(metrics["glat_keep"].item(),
                               float(aux["metrics"]["glat_keep"]), rtol=1e-6)
    n = 0
    for name, got, want in _grad_pairs(tm, jax.tree.map(np.asarray,
                                                        want_grads)):
        # key biases shift every score of a softmax row alike: their exact
        # gradient is 0 and both sides hold rounding noise (~1e-8), hence
        # the 1e-3 floor of the scale
        scale = max(float(np.abs(want).max()), 1e-3)
        err = float((got - torch.tensor(want)).abs().max()) / scale
        assert err <= 1e-4, (name, err)
        n += 1
    assert n == sum(1 for _ in tm.parameters())
    for path, x in convert._leaves(jax.tree.map(np.asarray,
                                                aux["batch_stats"])):
        owner = tm
        for name in path[:-1]:
            owner = convert._resolve(owner, name)
        attr, want = convert._convert(owner, path[-1], x)
        _close(getattr(owner, attr), want)


@pytest.mark.parametrize("wd,clip", [(0.01, 1.0), (0.0, 0.0)])
def test_guarded_adam_matches_optax_over_three_steps(wd, clip):
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=x.shape) * s).astype(np.float32)
              for k, x in params.items()} for s in (3.0, 1.0, 0.1)]
    grads[1]["b"][2] = np.nan                       # step 2 is skipped
    tx = jts.make_optimizer(lr=1e-2, warmup_updates=2, weight_decay=wd,
                            clip_norm=clip)
    opt = tx.init(params)
    jp = dict(params)
    topt = GuardedAdam(lr=1e-2, warmup_updates=2, weight_decay=wd,
                       clip_norm=clip)
    tp = [torch.tensor(params[k]) for k in ("a", "b")]
    st = topt.init(tp)
    for g in grads:
        gnorm = optax.global_norm(g)
        ok = bool(jnp.isfinite(gnorm))
        upd, new_opt = tx.update(g, opt, jp)
        if ok:
            jp, opt = optax.apply_updates(jp, upd), new_opt
        tg = [torch.tensor(g[k]) for k in ("a", "b")]
        tn = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(tg)))
        st = topt.update_(tp, tg, st, tn, torch.isfinite(tn))
        for k, x in zip(("a", "b"), tp):
            np.testing.assert_allclose(x.numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)
    assert int(st.count) == 2 and int(st.sched_count) == 2


def test_inverse_sqrt_schedule_matches_jax():
    j = jts.inverse_sqrt_schedule(5e-4, 100, 1e-7)
    t = inverse_sqrt_schedule(5e-4, 100, 1e-7)
    for s in (0, 1, 50, 99, 100, 101, 10_000):
        np.testing.assert_allclose(
            t(torch.tensor(s, dtype=torch.int32)).item(),
            float(j(jnp.int32(s))), rtol=1e-6)


def test_train_step_skips_non_finite_and_counts():
    cfg = _small_cfg()
    torch.manual_seed(0)
    model = tdag.S2TConformerDAG(cfg)
    batch = {k: _t(x).long() if x.dtype == np.int32 else _t(x)
             for k, x in _small_batch(cfg, 1).items()}
    opt = GuardedAdam(lr=1e-3, warmup_updates=1)
    state = TrainState.create(model, opt)

    def loss_fn(m, b, rng):
        return tloss.nat_dag_loss(m, b, rng, 0.5, cfg.vocab)

    step = make_train_step(loss_fn, opt)
    before = [p.detach().clone() for p in state.params]
    m1 = step(state, batch, torch.Generator().manual_seed(1))
    assert m1["skipped"].item() == 0 and torch.isfinite(m1["gnorm"])
    moved = [p.detach().clone() for p in state.params]
    assert any(not torch.equal(a, b) for a, b in zip(before, moved))
    bad = dict(batch, fbank=batch["fbank"] * float("nan"))
    m2 = step(state, bad, torch.Generator().manual_seed(2))
    assert m2["skipped"].item() == 1
    assert all(torch.equal(a, b) for a, b in zip(moved, state.params))
    assert state.step == 2 and int(state.opt_state.count) == 1


@pytest.mark.parametrize("accum", [1, 2])
def test_accumulated_step_matches_one_big_batch(accum):
    """Two microbatches of the same batch give the same update as one."""
    cfg = _small_cfg()
    b = {k: _t(x).long() if x.dtype == np.int32 else _t(x)
         for k, x in _small_batch(cfg, 2).items()}
    results = []
    for a in (1, accum):
        torch.manual_seed(0)
        model = tdag.S2TConformerDAG(cfg)
        opt = GuardedAdam(lr=1e-3, warmup_updates=1)
        state = TrainState.create(model, opt)
        step = make_train_step(
            lambda m, bb, rng: tloss.nat_dag_loss(m, bb, rng, 0.0,
                                                  cfg.vocab), opt,
            accum_steps=a)
        batch = b if a == 1 else {k: torch.stack([x] * a)
                                  for k, x in b.items()}
        metrics = step(state, batch, torch.Generator().manual_seed(0))
        results.append((metrics["loss"], [p.detach() for p in state.params]))
    np.testing.assert_allclose(results[0][0].item(), results[1][0].item(),
                               rtol=1e-6)
    for x, y in zip(results[0][1], results[1][1]):
        _close(x, y.numpy(), 1e-6)


def _fast_init_(module, seed):
    """``tests/testutils.py::fast_init`` on a port module: norm scales and
    running variances 1, biases and means 0, every other tensor
    N(0, 0.05)."""
    g = torch.Generator().manual_seed(seed)
    norms = (torch.nn.LayerNorm, tconf.MaskedBatchNorm)
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            if leaf == "running_var" or (leaf == "weight"
                                         and isinstance(owner, norms)):
                t.fill_(1.0)
            elif leaf in ("running_mean", "bias") or "pos_bias" in leaf:
                t.zero_()
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.05)
    return module


def test_dag_training_learns_synthetic_mapping():
    """``tests/test_learning.py:56`` on the port (same model, data, init
    heuristic, optimizer and 400 steps): the loss halves and lookahead
    decoding recovers held-out sequences."""
    from daspeech_torch.decode.dag_decode import greedy_or_lookahead_decode
    from test_learning import FRAMES_PER_PHONE, synth_batch

    vocab = VocabConfig(size=16)
    cfg = DAGModelConfig(
        vocab=vocab,
        encoder=ConformerConfig(embed_dim=32, ffn_dim=64, num_layers=2,
                                num_heads=2, conv_channels=32,
                                depthwise_kernel_size=7, dropout=0.0,
                                attn_dropout=0.0),
        decoder=DAGDecoderConfig(embed_dim=32, ffn_dim=64, num_layers=2,
                                 num_heads=2, dropout=0.0, attn_dropout=0.0,
                                 activation_dropout=0.0,
                                 max_target_positions=64))
    model = _fast_init_(tdag.S2TConformerDAG(cfg), 0)
    rng = np.random.default_rng(0)
    n_phones, B, L = 4, 16, 16
    prev = tdag.initialize_output_tokens(
        tdag.graph_lengths(torch.full((B,), n_phones * FRAMES_PER_PHONE),
                           0.5, 64), L, vocab)
    opt = GuardedAdam(lr=2e-3, warmup_updates=20, weight_decay=0.0)
    state = TrainState.create(model, opt)
    step = make_train_step(
        lambda m, b, g: tloss.nat_dag_loss(m, b, g, 0.5, vocab), opt)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(400):
        fb, sl, tg = synth_batch(rng, vocab, B, n_phones)
        b = {"fbank": _t(fb), "src_lengths": _t(sl).long(),
             "target": _t(tg).long(), "prev_output_tokens": prev}
        losses.append(step(state, b, gen)["loss"].item())
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])

    fb, sl, tg = synth_batch(np.random.default_rng(123), vocab, 8, n_phones)
    with torch.no_grad():
        logits, links, _ = model(_t(fb), _t(sl).long(), prev[:8])
    res = greedy_or_lookahead_decode(logits, links,
                                     (prev[:8] != vocab.pad).sum(1),
                                     vocab.pad, 1.0, True)
    correct = sum(
        res.tokens[b, :int(res.lengths[b])].tolist()
        == [vocab.bos] + tg[b, 1:-1].tolist() + [vocab.eos]
        for b in range(8))
    assert correct >= 6, (correct, losses[-1])


class TestDispatch:
    """The new wrappers refuse a non-CPU tensor they cannot take rather
    than falling back; the CPU path is no launch."""

    def test_backward_wrappers_refuse_non_cuda_device(self):
        x = torch.zeros((1, 4, 64), device="meta")
        bias = torch.zeros((1, 4), device="meta")
        st = torch.zeros((1, 1, 4, 2), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tfa.attention_bwd_kernel(x, x, x, bias, x, st, x, 1, 1.0)
        a = torch.zeros((1, 4, 256), device="meta")
        e = torch.zeros((4, 256), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tfr.relpos_bwd_kernel(x, x, x, a, e, bias, x, st, x, 1, 0.125)
        ll = torch.zeros((1, 4, 4), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tfl.links_bwd_kernel(x, x, torch.zeros((1, 4, 1), device="meta"),
                                 torch.ones((1,), device="meta"), ll,
                                 torch.zeros((1, 4, 1), device="meta"), ll,
                                 1, 0.125, None)

    def test_cpu_backward_is_not_a_launch(self):
        before = (tfa.attention_bwd_kernel.launches,
                  tfr.relpos_bwd_kernel.launches,
                  tfl.links_bwd_kernel.launches)
        x = torch.randn(1, 4, 64, requires_grad=True)
        tfa.fused_attention_packed(x, x, x, torch.zeros(1, 4), 1).sum(
        ).backward()
        tfl.fused_extract_links(x, x, torch.zeros(1, 4, 1),
                                torch.tensor([4]), 1, 0.125,
                                None).clamp(min=-5).sum().backward()
        assert (tfa.attention_bwd_kernel.launches,
                tfr.relpos_bwd_kernel.launches,
                tfl.links_bwd_kernel.launches) == before
