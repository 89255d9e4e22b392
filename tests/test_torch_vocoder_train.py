"""The port's HiFi-GAN vocoder training against the JAX package, on the CPU.

Weights are numpy draws carried across by ``daspeech_torch.convert``;
inputs are numpy draws from a seed. Tolerances:

- MPD/MSD scores and feature maps, ``pair_batch`` on and off: 1e-5
  absolute (fp32 convolutions summed in another order);
- the feature, discriminator and generator losses: 1e-5 relative;
- the log-mel of the mel loss against the JAX package's numpy
  ``log_mel_spectrogram`` (float64 STFT): 1e-4 absolute, and against the
  JAX training CLI's float32 ``mel_fn``: 1e-5;
- one ``d_update`` + ``g_update`` against the JAX trainer with a tiny
  generator (``tests/test_vocoder_train.py``'s): losses within 1e-5
  relative; every gradient within 1e-5 of its tensor's largest, and the
  parameters after the step within 1e-5 absolute wherever the gradient is
  above that floor (below it, Adam's first step moves a parameter by
  lr g / (|g| + 1e-8), which turns fp32 rounding of a cancelling sum into
  up to 2 lr).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from daspeech_torch import convert
from daspeech_torch.models import hifigan_discriminators as tdisc
from daspeech_torch.train import vocoder_train as tvt
from daspeech_tpu.core import config as jcfg
from daspeech_tpu.data.audio_utils import _slaney_mel, log_mel_spectrogram
from daspeech_tpu.models import hifigan_discriminators as jdisc
from daspeech_tpu.models.hifigan import HiFiGANGenerator as JGenerator
from daspeech_tpu.train import vocoder_train as jvt
from test_torch_models import random_variables

TOL = 1e-5
TINY = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3, 5),), hop_size=16)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wavs(seed, B, T, scale=0.3):
    return (np.random.default_rng(seed).normal(size=(B, T)) * scale).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def discriminators():
    """Both discriminators with random weights in both packages."""
    y = _wavs(0, 2, 300)
    out = {}
    for key, jm, tm in (("mpd", jdisc.MultiPeriodDiscriminator(),
                         tdisc.MultiPeriodDiscriminator()),
                        ("msd", jdisc.MultiScaleDiscriminator(),
                         tdisc.MultiScaleDiscriminator())):
        v = random_variables(jm, 10 + len(out), y, y)
        out[key] = (v, convert.load_flax_(tm, v))
    return out


def _nchw_to_flax(f: torch.Tensor) -> np.ndarray:
    """A port feature map (NCHW / NCL) in the JAX layout (NHWC / NLC)."""
    return np.moveaxis(f.detach().numpy(), 1, -1)


@pytest.mark.parametrize("pair_batch", [False, True])
@pytest.mark.parametrize("key", ["mpd", "msd"])
def test_discriminator_matches_jax(discriminators, key, pair_batch):
    """Scores and feature maps of both inputs. T = 300 is not a multiple
    of the periods 7 and 11: DiscriminatorP reflect-pads there."""
    v, tm = discriminators[key]
    cls = {"mpd": jdisc.MultiPeriodDiscriminator,
           "msd": jdisc.MultiScaleDiscriminator}[key]
    jm = cls(pair_batch=pair_batch)
    y, y_hat = _wavs(1, 2, 300), _wavs(2, 2, 300)
    want = jax.jit(jm.apply)(v, y, y_hat)
    with torch.no_grad():
        got = tm(_t(y), _t(y_hat), pair_batch=pair_batch)
    for part in (0, 1):                          # real, generated scores
        for g, w in zip(got[part], want[part]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=TOL)
    n_maps = 0
    for part in (2, 3):                          # real, generated maps
        for gs, ws in zip(got[part], want[part]):
            for g, w in zip(gs, ws):
                np.testing.assert_allclose(_nchw_to_flax(g), np.asarray(w),
                                           rtol=0, atol=TOL)
                n_maps += 1
    assert n_maps == 2 * (6 * 5 if key == "mpd" else 8 * 3)


def test_avg_pool_matches_jax():
    y = _wavs(3, 2, 301)
    np.testing.assert_allclose(tdisc.avg_pool_1d(_t(y)).numpy(),
                               np.asarray(jdisc.avg_pool_1d(jnp.asarray(y))),
                               rtol=0, atol=1e-7)


def test_losses_match_jax():
    """The three losses on random scores and maps; the feature loss sends
    no gradient to the real maps."""
    rng = np.random.default_rng(4)
    shapes = [(2, 7), (2, 3, 5)]
    outs = [[rng.normal(size=s).astype(np.float32) for s in shapes]
            for _ in range(2)]
    maps = [[[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)] for _ in range(2)]
    t_outs = [[_t(x) for x in o] for o in outs]
    t_maps = [[[_t(x).requires_grad_(True) for x in d] for d in m]
              for m in maps]
    fm = tdisc.feature_loss(*t_maps)
    pairs = (
        (fm, jdisc.feature_loss(*maps)),
        (tdisc.discriminator_loss(*t_outs), jdisc.discriminator_loss(*outs)),
        (tdisc.generator_loss(t_outs[1]), jdisc.generator_loss(outs[1])))
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    fm.backward()
    assert all(x.grad is None for d in t_maps[0] for x in d)
    assert all(x.grad is not None for d in t_maps[1] for x in d)


def _tone(T, sr=22050, seed=5):
    """Two tones in noise: a waveform whose mel has energy in most bins."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / sr
    return (0.4 * np.sin(2 * np.pi * 220.0 * t)
            + 0.2 * np.sin(2 * np.pi * 1870.0 * t)
            + 0.05 * rng.normal(size=T)).astype(np.float32)


def test_mel_fn_matches_the_numpy_log_mel():
    wav = np.stack([_tone(8192), _tone(8192, seed=6)[::-1].copy()])
    got = tvt.make_mel_fn(device="cpu")(_t(wav))
    assert got.shape == (2, 32, 80)
    for b in range(2):
        np.testing.assert_allclose(got[b].numpy(),
                                   log_mel_spectrogram(wav[b]), rtol=0,
                                   atol=1e-4)
    np.testing.assert_array_equal(tvt.slaney_mel(80, 1024, 22050, 0.0, 8000.0),
                                  _slaney_mel(80, 1024, 22050, 0.0, 8000.0))


def test_mel_fn_matches_the_jax_training_mel():
    """The JAX training CLI's ``mel_fn`` (``cli/train_vocoder.py:86-101``,
    float32), values and gradient."""
    wav = np.stack([_tone(4096), _tone(4096, seed=7)])
    basis = jnp.asarray(_slaney_mel(80, 1024, 22050, 0.0, 8000.0))
    win = jnp.asarray(np.hanning(1025)[:-1].astype(np.float32))

    def jax_mel(w):
        w = jnp.pad(w, ((0, 0), (384, 384)), mode="reflect")
        n = 1 + (w.shape[1] - 1024) // 256
        idx = jnp.arange(1024)[None, :] + 256 * jnp.arange(n)[:, None]
        spec = jnp.abs(jnp.fft.rfft(w[:, idx] * win[None, None, :], axis=-1))
        return jnp.log(jnp.maximum(jnp.einsum("btf,fm->btm", spec, basis),
                                   1e-5))

    want = jax.jit(jax_mel)(wav)
    want_g = jax.jit(jax.grad(lambda w: jnp.sum(jax_mel(w) ** 2)))(wav)
    x = _t(wav).requires_grad_(True)
    got = tvt.make_mel_fn(device="cpu")(x)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)
    g = np.asarray(want_g)
    np.testing.assert_allclose(x.grad.numpy(), g, rtol=0,
                               atol=TOL * np.abs(g).max())


def test_optimizer_schedule_matches_optax():
    """lr 2e-4 * 0.999 ** (count / 1000) at the pre-increment count."""
    sched = optax.exponential_decay(2e-4, transition_steps=1000,
                                    decay_rate=0.999)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = tvt.make_vocoder_optimizer([p])
    for count in range(3):
        p.grad = torch.ones(3)
        opt.step()
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(sched(count)), rtol=1e-6)
    opt.count = 2500
    opt.step()
    np.testing.assert_allclose(opt.param_groups[0]["lr"], float(sched(2500)),
                               rtol=1e-6)


def test_unported_options_raise():
    cfg = jcfg.HiFiGANConfig(**TINY)
    with pytest.raises(NotImplementedError):
        tvt.VocoderTrainer(cfg, gen_fold=128, device="cpu")


def _toy_mels(seed):
    """``tests/test_vocoder_train.py``'s toy mel_fn, a fixed random
    projection of 16-sample windows, in both packages."""
    W = (np.random.default_rng(seed).normal(size=(16, 80)) * 0.1).astype(
        np.float32)
    Wt = torch.from_numpy(W)
    return (lambda wav: wav.reshape(wav.shape[0], -1, 16) @ jnp.asarray(W),
            lambda wav: wav.reshape(wav.shape[0], -1, 16) @ Wt)


def test_step_matches_jax():
    """One ``d_update`` + ``g_update`` from the same weights and batch, at
    the trainer's defaults (the D update on paired batches, the G update
    not): the D loss, the G losses, the gradients and the parameters after
    the step."""
    cfg = jcfg.HiFiGANConfig(**TINY)
    jmel, tmel = _toy_mels(0)
    rng = np.random.default_rng(1)
    B, frames = 2, 16
    mel = rng.normal(size=(B, frames, 80)).astype(np.float32)
    wav = _wavs(2, B, frames * cfg.hop_size, scale=0.1)

    jtr = jvt.VocoderTrainer(cfg, mel_fn=jmel, segment_size=256)
    gen_v = random_variables(JGenerator(cfg), 3, mel)
    disc_v = {"mpd": random_variables(jtr.mpd, 4, wav, wav),
              "msd": random_variables(jtr.msd, 5, wav, wav)}
    dparams = {k: v["params"] for k, v in disc_v.items()}
    state = jvt.VocoderTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=gen_v, disc_params=disc_v,
        gen_opt=jtr.gen_tx.init(gen_v["params"]),
        disc_opt=jtr.disc_tx.init(dparams))
    d_step, g_step = jtr.make_step_fns()
    state, j_d = d_step(state, mel, wav)
    state, j_g = g_step(state, mel, wav)

    ttr = tvt.VocoderTrainer(cfg, mel_fn=tmel, device="cpu")
    tstate = ttr.state_from_flax(gen_v, disc_v)
    t_d_step, t_g_step = ttr.make_step_fns()
    tstate, t_d = t_d_step(tstate, _t(mel), _t(wav))
    tstate, t_g = t_g_step(tstate, _t(mel), _t(wav))
    assert tstate.step == int(state.step) == 1

    np.testing.assert_allclose(t_d.item(), float(j_d), rtol=TOL)
    for k in ("g_loss", "g_adv", "g_fm", "g_mel"):
        np.testing.assert_allclose(t_g[k].item(), float(j_g[k]), rtol=TOL,
                                   err_msg=k)
    # gradients (Adam's first moment after one step, (1 - b1) g in both):
    # within 1e-5 of each tensor's largest. Parameters: every element
    # within 1e-5, but for at most MAX_OFF elements whose gradient is below
    # that floor. There a gradient is fp32 rounding of a sum that cancels,
    # and Adam's first step, lr g / (|g| + 1e-8), turns its rounding into
    # up to lr of movement in each package, so those few are held to
    # 2 lr (one element of disc_s0.convs.5 holds -5.1e-10 here and -1.3e-9
    # in JAX, beside gradients up to 0.025 in the same tensor)
    MAX_OFF, lr = 8, 2e-4
    j_mu = state.gen_opt[0].mu, state.disc_opt[0].mu
    pairs = (
        (tstate.gen, tstate.gen_opt,
         convert.vocoder_from_flax(state.gen_params, cfg, device="cpu"),
         convert.vocoder_from_flax({"params": j_mu[0]}, cfg, device="cpu")),
        *((tstate.disc[k], tstate.disc_opt,
           convert.discriminators_from_flax(state.disc_params,
                                            device="cpu")[k],
           convert.discriminators_from_flax(
               {n: {"params": j_mu[1][n]} for n in ("mpd", "msd")},
               device="cpu")[k]) for k in ("mpd", "msd")))
    off = 0
    for got, opt, want, want_mu in pairs:
        ref, ref_mu = want.state_dict(), want_mu.state_dict()
        for name, t in got.named_parameters():
            mu, want_m = opt.state[t]["exp_avg"].numpy(), ref_mu[name].numpy()
            floor = TOL * np.abs(want_m).max()
            np.testing.assert_allclose(mu, want_m, rtol=0, atol=floor,
                                       err_msg=name)
            diff = np.abs(t.detach().numpy() - ref[name].numpy())
            bad = diff > TOL
            assert (np.abs(want_m[bad]) < floor).all(), name
            assert (diff[bad] <= 2 * lr).all(), name
            off += int(bad.sum())
    assert off <= MAX_OFF, off
    # the step moved every network
    before = convert.vocoder_from_flax(gen_v, cfg, device="cpu")
    assert not torch.equal(before.conv_pre.weight, tstate.gen.conv_pre.weight)


def test_mel_loss_falls():
    """Ten updates of a tiny generator on one batch (real log-mel at
    n_fft 64, hop 16) bring the mel loss to <= 0.9 of its first value."""
    cfg = jcfg.HiFiGANConfig(**TINY)
    mel_fn = tvt.make_mel_fn(sample_rate=22050, n_fft=64, hop_length=16,
                             num_mels=20, fmax=None, device="cpu")
    tr = tvt.VocoderTrainer(cfg, mel_fn=mel_fn, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    wav = torch.from_numpy(np.stack([_tone(256, seed=8), _tone(256, seed=9)]))
    mel = torch.randn(2, 16, 80, generator=torch.Generator().manual_seed(1))
    first = None
    for _ in range(10):
        state, m = tr.train_step(state, mel, wav)
        first = m["g_mel"].item() if first is None else first
        assert all(torch.isfinite(v) for v in m.values())
    assert m["g_mel"].item() <= 0.9 * first
