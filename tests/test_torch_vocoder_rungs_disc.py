"""The bf16 discriminators of vocoder training (``VocoderTrainer(
disc_dtype=bf16)``) against JAX's: one update, in a file of its own so
that the tier-1 run's workers can run it beside
``tests/test_torch_vocoder_rungs.py``, whose module docstring gives the
bars (the losses within 2x JAX's own bf16 error, floored at 2^-8 of the
value; the gradients on the aggregate over tensors and each within 8x its
own) and whose helpers it uses."""

import jax.numpy as jnp
import numpy as np
import torch

from daspeech_torch import convert
from daspeech_torch.train import vocoder_train as tvt
from daspeech_tpu.core import config as jcfg
from daspeech_tpu.models import hifigan as jhg
from daspeech_tpu.train import vocoder_train as jvt
from test_torch_bf16_models import bf16_gap
from test_torch_models import random_variables
from test_torch_vocoder_rungs import (BF16, _norm,  # noqa: F401
                                      one_thread_no_grad)


TINY = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3, 5),), hop_size=16)
PER_TENSOR = 8.0
LOSS_FLOOR = 2.0 ** -8


def test_bf16_discriminator_step_matches_jax():
    """One ``d_update`` + ``g_update`` with ``disc_dtype=bf16``: the
    losses, and every gradient (Adam's first moment, (1 - b1) g) of the
    generator and both discriminators."""
    torch.set_grad_enabled(True)
    try:
        _bf16_step()
    finally:
        torch.set_grad_enabled(False)


def _bf16_step():
    cfg = jcfg.HiFiGANConfig(**TINY)
    rng = np.random.default_rng(1)
    B, frames = 2, 16
    mel = rng.normal(size=(B, frames, 80)).astype(np.float32)
    wav = (rng.normal(size=(B, frames * 16)) * 0.1).astype(np.float32)
    W = (np.random.default_rng(0).normal(size=(16, 80)) * 0.1).astype(
        np.float32)
    jmel = lambda w: w.reshape(w.shape[0], -1, 16) @ jnp.asarray(W)  # noqa
    Wt = torch.from_numpy(W)
    tmel = lambda w: w.reshape(w.shape[0], -1, 16) @ Wt  # noqa: E731

    want = {}
    for dt in (jnp.bfloat16, jnp.float32):
        jtr = jvt.VocoderTrainer(cfg, mel_fn=jmel, segment_size=256,
                                 disc_dtype=dt)
        gen_v = random_variables(jhg.HiFiGANGenerator(cfg), 3, mel)
        disc_v = {"mpd": random_variables(jtr.mpd, 4, wav, wav),
                  "msd": random_variables(jtr.msd, 5, wav, wav)}
        state = jvt.VocoderTrainState(
            step=jnp.zeros((), jnp.int32), gen_params=gen_v,
            disc_params=disc_v, gen_opt=jtr.gen_tx.init(gen_v["params"]),
            disc_opt=jtr.disc_tx.init({k: v["params"]
                                       for k, v in disc_v.items()}))
        d_step, g_step = jtr.make_step_fns()
        state, d = d_step(state, mel, wav)
        state, g = g_step(state, mel, wav)
        mu = (state.gen_opt[0].mu, state.disc_opt[0].mu)
        grads = {"gen": convert.vocoder_from_flax(
            {"params": mu[0]}, cfg, device="cpu").state_dict()}
        for k in ("mpd", "msd"):
            grads[k] = convert.discriminators_from_flax(
                {n: {"params": mu[1][n]} for n in ("mpd", "msd")},
                device="cpu")[k].state_dict()
        want[dt] = ({"d_loss": float(d), "g_loss": float(g["g_loss"])},
                    grads)

    ttr = tvt.VocoderTrainer(cfg, mel_fn=tmel, disc_dtype=BF16, device="cpu")
    ts = ttr.state_from_flax(gen_v, disc_v)
    d_step, g_step = ttr.make_step_fns()
    ts, d = d_step(ts, torch.from_numpy(mel), torch.from_numpy(wav))
    ts, g = g_step(ts, torch.from_numpy(mel), torch.from_numpy(wav))
    assert all(p.dtype == torch.float32 for m in ts.disc.values()
               for p in m.parameters())
    (lb, gb), (lf, gf) = want[jnp.bfloat16], want[jnp.float32]
    for name, got in (("d_loss", d.item()), ("g_loss", g["g_loss"].item())):
        bar = max(2 * abs(lb[name] - lf[name]), LOSS_FLOOR * abs(lf[name]))
        assert abs(got - lb[name]) <= bar, (name, got, lb[name], lf[name])
    port_jax = jax_jax = 0.0
    n = 0
    for part, module, opt in (("gen", ts.gen, ts.gen_opt),
                              ("mpd", ts.disc["mpd"], ts.disc_opt),
                              ("msd", ts.disc["msd"], ts.disc_opt)):
        for name, p in module.named_parameters():
            got = opt.state[p]["exp_avg"].numpy()
            b, f = gb[part][name].numpy(), gf[part][name].numpy()
            gap, bar = bf16_gap(got, b, f, f"{part}.{name}")
            assert gap <= PER_TENSOR * bar, (part, name, gap, bar)
            scale = max(_norm(f), 1e-12)
            port_jax += (gap / scale) ** 2
            jax_jax += (_norm(b - f) / scale) ** 2
            n += 1
    assert n == sum(1 for m in (ts.gen, *ts.disc.values())
                    for _ in m.parameters())
    assert port_jax ** 0.5 <= 2 * jax_jax ** 0.5, (port_jax, jax_jax)


def test_disc_dtype_reaches_every_conv():
    cfg = jcfg.HiFiGANConfig(**TINY)
    tr = tvt.VocoderTrainer(cfg, disc_dtype=BF16, device="cpu")
    st = tr.init_state(torch.Generator().manual_seed(0))
    convs = [m for d in st.disc.values() for m in d.modules()
             if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d))]
    assert convs and all(m.dtype == BF16 for m in convs)
    wav = torch.randn(1, 256) * 0.1
    rs, gs, fr, _ = st.disc["mpd"](wav, wav)
    assert rs[0].dtype == BF16 and fr[0][0].dtype == BF16
    assert all(m.dtype == torch.float32 for m in st.gen.modules()
               if isinstance(m, torch.nn.Conv1d))
