"""The port's reduced-precision vocoder serving (``--vocoder-quant bf16``,
``int8``, ``int8-skip1``), the bf16 MRF level and the bf16 discriminators,
on the CPU, against the JAX package.

Weights are numpy draws carried across by ``daspeech_torch.convert``;
inputs are numpy draws from a seed. Bars:

- the MRF level's plain bf16 version (#7 with bf16 weights) against JAX's
  ``_mrf_kernel`` in Pallas interpret mode with ``operand_dtype=bf16`` (its
  own ``mrf_level`` forces fp32 operands in interpret mode,
  ``fused_mrf.py:178``): within 2^-7 of the output's largest magnitude
  (the bar of a bf16 kernel against its plain bf16 version),
  ||port - jax_bf16|| <= 2 ||jax_bf16 - jax_fp32|| with jax_fp32 the
  interpreted kernel in fp32, and ||port - jax_bf16|| <= 0.35
  ||jax_bf16 - jax_fp32||, which a plain version that rounded only the
  weights (0.71) or nothing (1.0) fails. A level chains 18 convs whose
  inputs are each rounded to bf16: where the two fp32 sums (taken in another order)
  straddle a rounding boundary, one input differs by one bf16 ulp and
  moves the outputs downstream, so the one-ulp bar of a single rounding
  (``tests/test_torch_bf16_ops.py``) does not hold for near-zero outputs;
- the bf16 generator against JAX's ``HiFiGANGenerator(fold_to=128,
  dtype=bf16)``, with and without ``fused_mrf`` (JAX's fused levels through
  the same bf16-operand interpret kernel): ||port - jax_bf16|| <=
  2 ||jax_bf16 - jax_fp32||;
- int8: the int32 sums bit for bit (a dilated ResBlock site, a folded
  site's per-channel scales, the sub-pixel upsample). Everything after
  ``conv_pre`` (fp32) is integer sums and the same fp32 elementwise ops,
  so with JAX's ``conv_pre`` output handed to the port, the calibrated
  amax of every site is within 1e-6 relative of JAX's ``quant``
  collection, and with JAX's frozen scales carried across, ||port -
  jax_int8|| <= 0.25 ||jax_int8 - jax_fp32|| for ``int8`` and
  ``int8-skip1``. With the port's own ``conv_pre`` the two differ by fp32
  rounding (~2e-6 here), which moves a few activations across an int8
  rounding boundary; each such step moves the later sites' inputs and
  more of them cross: end to end the port is held to ||port - jax_int8||
  <= ||jax_int8 - jax_fp32|| (one int8 error; the ratio is printed).
  Chunked int8 against one-shot int8 within ``CHUNK_TOL``;
- the serving ladder on ``tests/test_int8_quality.py``'s configuration,
  mel and weights: MCD of ``int8-skip1`` < ``int8`` and ``bf16`` < ``int8``;
- one ``VocoderTrainer`` update with ``disc_dtype=bf16`` against JAX's:
  the losses within 2x JAX's own bf16 error (floored at 2^-8 of the
  value), the gradients within that bar on the aggregate over tensors
  and each within 8x its own (``tests/test_torch_bf16_train.py``).
"""

import functools
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from daspeech_torch import config as tcfg
from daspeech_torch import convert
from daspeech_torch.decode import speech_generator as tsg
from daspeech_torch.models import hifigan as thg
from daspeech_torch.ops import fused_mrf as tfm
from daspeech_torch.train import vocoder_train as tvt
from daspeech_tpu.core import config as jcfg
from daspeech_tpu.models import hifigan as jhg
from daspeech_tpu.ops import fused_mrf as jfm
from daspeech_tpu.train import vocoder_train as jvt
from test_torch_bf16_models import bf16_gap
from test_torch_models import random_variables

BF16 = torch.bfloat16
BF16_TOL = 2.0 ** -7      # of the output's largest magnitude
CHUNK_TOL = 1e-6
INT8_RATIO = 0.25         # conv_pre handed across
K1_RATIO = 0.35           # the plain bf16 level's gap to JAX's, of fp32's
INT8_RATIO_OWN = 1.0      # the port's own conv_pre
V1_KERNELS, V1_DILATIONS = (3, 7, 11), ((1, 3, 5),) * 3
# two levels: ch 128 (f=1: flax's bf16 bias, direct int8 dilated convs)
# and 64 (f=2: the tap form's fp32 bias, folded int8 taps)
CFG = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
           upsample_initial_channel=256, resblock_kernel_sizes=V1_KERNELS,
           resblock_dilation_sizes=V1_DILATIONS, resblock="1")


@pytest.fixture(autouse=True, scope="module")
def one_thread_no_grad():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(n)


def _mel(seed, B, M, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(B, M, 80)) * scale
            ).astype(np.float32)


def _cfgs(**kw):
    return jcfg.HiFiGANConfig(**kw), tcfg.HiFiGANConfig(**kw)


def _norm(x):
    return float(np.linalg.norm(np.asarray(x, np.float64)))


# --- the MRF level with bf16 weights (#7) --------------------------------

@functools.partial(jax.jit, static_argnames=("offsets", "H", "tile",
                                             "n_blocks"))
def jax_mrf_level_bf16(x, W, biases, *, offsets, H, tile=1024, n_blocks=3,
                       convs_per_block=6, interpret=True):
    """``fused_mrf.mrf_level`` (``:156-215``) with the TPU's
    ``operand_dtype=bf16``, in interpret mode."""
    B, G, FC = x.shape
    Tt = max(min(tile, G), H)
    Gp = -(-G // Tt) * Tt
    if Gp != G:
        x = jnp.pad(x, ((0, 0), (0, Gp - G), (0, 0)))
    nt = Gp // Tt
    kern = functools.partial(
        jfm._mrf_kernel, offsets=offsets, Tt=Tt, H=H, G=G, n_blocks=n_blocks,
        convs_per_block=convs_per_block, operand_dtype=jnp.bfloat16)
    vmem = pltpu.VMEM
    out = pl.pallas_call(
        kern, grid=(B, nt),
        in_specs=[
            pl.BlockSpec((1, Tt, FC),
                         lambda b, i: (b, jnp.maximum(i - 1, 0), 0),
                         memory_space=vmem),
            pl.BlockSpec((1, Tt, FC), lambda b, i: (b, i, 0),
                         memory_space=vmem),
            pl.BlockSpec((1, Tt, FC),
                         lambda b, i: (b, jnp.minimum(i + 1, nt - 1), 0),
                         memory_space=vmem),
            pl.BlockSpec(W.shape, lambda b, i: (0, 0, 0), memory_space=vmem),
            pl.BlockSpec(biases.shape, lambda b, i: (0, 0),
                         memory_space=vmem)],
        out_specs=pl.BlockSpec((1, Tt, FC), lambda b, i: (b, i, 0),
                               memory_space=vmem),
        out_shape=jax.ShapeDtypeStruct((B, Gp, FC), jnp.float32),
        scratch_shapes=[pltpu.VMEM((Tt + 2 * H, FC), jnp.float32)
                        for _ in range(4)],
        interpret=True)(x, x, x, W, biases)
    return out[:, :G]


def _level_params(rng, C):
    """Per block, per dilation, (k1, b1, k2, b2) with kernels [k, C, C]."""
    return [[tuple(rng.normal(0, s, shape).astype(np.float32)
                   for s, shape in ((1 / np.sqrt(k * C), (k, C, C)),
                                    (0.1, (C,)),
                                    (1 / np.sqrt(k * C), (k, C, C)),
                                    (0.1, (C,))))
             for _ in ds] for k, ds in zip(V1_KERNELS, V1_DILATIONS)]


@pytest.mark.parametrize("tile", [64, 1024])
def test_mrf_level_bf16_plain_matches_jax_kernel(tile):
    """At C = 128 (f = 1), T = 128: one tile, or two with their halos."""
    rng = np.random.default_rng(tile)
    B, C, T = 2, 128, 128
    params = _level_params(rng, C)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    W, biases, offs, H = jfm.prepare_level(
        jax.tree.map(jnp.asarray, params), 1, C, V1_KERNELS, V1_DILATIONS,
        dtype=jnp.bfloat16)
    want = np.asarray(jax_mrf_level_bf16(jnp.asarray(x), W, biases,
                                         offsets=offs, H=H, tile=tile))
    tW = torch.from_numpy(np.concatenate(
        [k for blk in params for (k1, _, k2, _) in blk for k in (k1, k2)])
    ).to(BF16)
    tb = torch.from_numpy(np.stack(
        [b for blk in params for (_, b1, _, b2) in blk for b in (b1, b2)]))
    assert torch.equal(tW.float(), torch.from_numpy(
        np.asarray(W.astype(jnp.float32))))
    got = tfm.mrf_level(torch.from_numpy(x).transpose(1, 2).contiguous(),
                        tW, tb, V1_KERNELS, V1_DILATIONS)
    assert got.dtype == torch.float32
    got = got.transpose(1, 2).numpy().astype(np.float64)
    err = np.abs(got - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err
    W32, b32, _, _ = jfm.prepare_level(
        jax.tree.map(jnp.asarray, params), 1, C, V1_KERNELS, V1_DILATIONS,
        dtype=jnp.float32)
    f32 = np.asarray(jfm.mrf_level(jnp.asarray(x), W32, b32, offsets=offs,
                                   H=H, tile=tile, interpret=True))
    gap, bar = bf16_gap(got, want, f32, "level")
    assert gap <= bar, (gap, bar)
    # the plain version rounds each conv's input as the kernel does: it is
    # far closer to the bf16 kernel than the fp32 level is (0.08-0.14 of
    # that gap here; rounding only the weights reads 0.71, nothing 1)
    assert _norm(got - want) <= K1_RATIO * _norm(f32 - want), (
        _norm(got - want) / _norm(f32 - want))


def test_mrf_level_dtypes():
    x = torch.randn(1, 32, 20)
    W = torch.randn(2 * 3 * 6, 32, 32)
    b = torch.zeros(12, 32)
    with pytest.raises(TypeError, match="fp32 x"):
        tfm.mrf_level(x.to(BF16), W, b, (3, 3), ((1, 3, 5),) * 2)
    with pytest.raises(TypeError, match="fp32 x"):
        tfm.mrf_level(x, W.half(), b, (3, 3), ((1, 3, 5),) * 2)
    out = tfm.mrf_level(x, W.to(BF16), b, (3, 3), ((1, 3, 5),) * 2)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


# --- the bf16 generator ---------------------------------------------------

@pytest.fixture(scope="module")
def bf16_setup():
    mel = _mel(0, 2, 64)
    jc, tc = _cfgs(**CFG)
    jm = jhg.HiFiGANGenerator(jc, fold_to=128)
    v = random_variables(jm, 3, mel)
    f32 = np.asarray(jm.apply(v, mel))
    b16 = np.asarray(jhg.HiFiGANGenerator(jc, fold_to=128,
                                          dtype=jnp.bfloat16).apply(v, mel),
                     np.float32)
    return mel, jc, tc, v, f32, b16


def test_bf16_generator_matches_jax(bf16_setup):
    mel, _, tc, v, f32, b16 = bf16_setup
    tm = convert.vocoder_from_flax(v, tc, device="cpu", dtype=BF16)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    got = tm(torch.from_numpy(mel))
    assert got.dtype == torch.float32          # config: f = 2 at the end
    gap, bar = bf16_gap(got.numpy(), b16, f32, "wav")
    assert gap <= bar, (gap, bar)
    # the fold's rounding rule matters: f > 1 convs with flax's bf16 bias
    assert _norm(got.numpy() - f32) > 0


def test_bf16_fused_generator_matches_jax(bf16_setup, monkeypatch):
    """Both levels take the fused MRF (ch 128 f=1 and ch 64 f=2, >= 128
    folded frames); JAX's through its kernel with bf16 operands."""
    mel, jc, tc, v, f32, _ = bf16_setup
    sent = []

    def level(x, W, biases, **kw):
        sent.append(W.dtype)
        kw.pop("interpret")
        return jax_mrf_level_bf16(x, W, biases, **kw)

    monkeypatch.setattr(jfm, "mrf_level", level)
    want = np.asarray(jhg.HiFiGANGenerator(
        jc, fold_to=128, dtype=jnp.bfloat16, fused_mrf=True).apply(v, mel),
        np.float32)
    assert sent == [jnp.bfloat16] * 2
    tm = convert.vocoder_from_flax(v, tc, device="cpu", dtype=BF16,
                                   fused_mrf=True)
    calls = []
    orig = tfm.mrf_level_ref
    monkeypatch.setattr(tfm, "mrf_level_ref",
                        lambda x, W, *a: calls.append(W.dtype) or
                        orig(x, W, *a))
    got = tm(torch.from_numpy(mel))
    assert calls == [BF16] * 2
    gap, bar = bf16_gap(got.numpy(), want, f32, "wav")
    assert gap <= bar, (gap, bar)


# --- int8 ------------------------------------------------------------------

def test_int8_sums_bit_exact():
    rng = np.random.default_rng(0)
    # a dilated ResBlock site, f = 1
    xq = rng.integers(-127, 128, (2, 32, 40)).astype(np.int8)
    wq = rng.integers(-127, 128, (11, 32, 32)).astype(np.int8)
    d = 5
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xq.transpose(0, 2, 1)), jnp.asarray(wq), (1,),
        [(25, 25)], rhs_dilation=(d,),
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.int32)
    got = thg.int_taps_conv(torch.from_numpy(xq), torch.from_numpy(wq),
                            [(j - 5) * d for j in range(11)])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("T", [1, 9, 16, 17])
def test_int8_sums_exact_at_few_rows(T):
    """One short utterance: B T at or under ``_int_mm``'s 16-row floor on
    CUDA is padded with zero rows; the sums are JAX's, bit for bit."""
    rng = np.random.default_rng(T)
    xq = rng.integers(-127, 128, (1, 32, T)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 32, 24)).astype(np.int8)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xq.transpose(0, 2, 1)), jnp.asarray(wq), (1,),
        [(3, 3)], rhs_dilation=(3,),
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.int32)
    got = thg.int_taps_conv(torch.from_numpy(xq), torch.from_numpy(wq),
                            [-3, 0, 3])
    assert got.shape == (1, T, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_weight_scales_and_subpixel_upsample_match_jax():
    """A folded site's per-column scales are the unfolded per-channel ones;
    the upsample's sub-pixel kernel, its per (phase, channel) scales, its
    quantized weights and a conv with them, bit for bit."""
    rng = np.random.default_rng(1)
    k = rng.normal(size=(7, 16, 16)).astype(np.float32)
    folded, _ = jhg._dense_tap_kernel(jhg.fold_taps(jhg.conv_taps(
        jnp.asarray(k), 3), 2, 16, 16))
    _, s_fold = jhg.quantize_sym(folded, per_channel=True)
    _, s = thg.quantize_sym(torch.from_numpy(k), per_channel=True)
    np.testing.assert_array_equal(np.asarray(s_fold), np.tile(s.numpy(), 2))

    up = torch.nn.ConvTranspose1d(24, 8, 16, 8, padding=4)
    kern = up.weight.detach().permute(2, 0, 1).numpy()      # [k, in, out]
    jt, jpad = jhg._dense_tap_kernel(jhg.convT_subpixel_taps(
        jnp.asarray(kern), 8, 4))
    tw, offs = thg.convT_subpixel_taps(up)
    assert offs == list(range(-jpad[0], jpad[1] + 1))
    np.testing.assert_array_equal(tw.detach().numpy(), np.asarray(jt))
    jq, js = jhg.quantize_sym(jt, per_channel=True)
    tq, ts = thg.quantize_sym(tw.detach(), per_channel=True)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    x = rng.normal(size=(2, 24, 12)).astype(np.float32)
    sx = np.float32(0.02)
    want = jhg.conv_int8(jnp.asarray(x.transpose(0, 2, 1)), jt, jpad,
                         x_scale=jnp.float32(sx))
    got = thg.conv_int8(torch.from_numpy(x), tw.detach(), offs,
                        x_scale=torch.tensor(sx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def int8_setup():
    jc, tc = _cfgs(**CFG)
    mels = [_mel(10 + i, 2, 48) for i in range(3)]
    jm = jhg.HiFiGANGenerator(jc, fold_to=128)
    v = random_variables(jm, 5, mels[0])
    quant = {}
    for skip in (0, 1):
        calib = jhg.HiFiGANGenerator(jc, fold_to=128, quant_int8=True,
                                     quant_skip_levels=skip, calibrate=True)
        q = None
        for mel in mels:
            var = {"params": v["params"]} if q is None else {
                "params": v["params"], "quant": q}
            _, upd = calib.apply(var, mel, mutable=["quant"])
            q = upd["quant"]
        quant[skip] = jax.tree.map(np.asarray, q)
    return jc, tc, mels, v, quant


def hand_over_conv_pre(tm, jc, v, mels):
    """Make ``tm.conv_pre`` return JAX's fp32 ``conv_pre`` output for each
    of ``mels`` (the rest of the generator unchanged)."""
    jm = jhg.HiFiGANGenerator(jc, fold_to=128)
    outs = {m.tobytes(): torch.from_numpy(np.asarray(
        jm.apply(v, m, stop_at_level=-2))).transpose(1, 2).contiguous()
        for m in mels}
    tm.conv_pre.forward = lambda x: outs[
        x.transpose(1, 2).contiguous().numpy().tobytes()]
    return tm


def _amax_leaves(tree, prefix=()):
    for k, val in tree.items():
        if isinstance(val, dict):
            yield from _amax_leaves(val, prefix + (k,))
        else:
            yield prefix + (k,), val


@pytest.mark.parametrize("skip", [0, 1])
def test_calibrated_amax_matches_jax(int8_setup, skip):
    jc, tc, mels, v, quant = int8_setup
    tm = hand_over_conv_pre(convert.vocoder_from_flax(
        v, tc, device="cpu", quant_int8=True, quant_skip_levels=skip,
        calibrate=True), jc, v, mels)
    tm.reset_calibration_()
    for mel in mels:
        tm(torch.from_numpy(mel))
    want = {".".join(path).replace("resblocks_", "resblocks."): float(x)
            for path, x in _amax_leaves(quant[skip])}
    assert ("ups_0_amax" in want) == (skip == 0)
    got = {n: b.item() for n, b in tm.named_buffers() if n.endswith("_amax")}
    for name, x in want.items():
        np.testing.assert_allclose(got[name], x, rtol=1e-6, err_msg=name)
    # the skipped level's sites stay empty
    assert all(got[n] == 0.0 for n in set(got) - set(want)), got


@pytest.mark.parametrize("skip", [0, 1])
def test_int8_waveform_with_jax_scales(int8_setup, skip):
    jc, tc, mels, v, quant = int8_setup
    mel = _mel(20, 2, 48)
    f32 = np.asarray(jhg.HiFiGANGenerator(jc, fold_to=128).apply(v, mel))
    jq = jhg.HiFiGANGenerator(jc, fold_to=128, quant_int8=True,
                              quant_skip_levels=skip)
    want = np.asarray(jq.apply({"params": v["params"], "quant": quant[skip]},
                               mel))
    ratios = []
    for hand_over in (True, False):
        tm = convert.vocoder_from_flax(
            {"params": v["params"], "quant": quant[skip]}, tc, device="cpu",
            quant_int8=True, quant_skip_levels=skip)
        if hand_over:
            hand_over_conv_pre(tm, jc, v, [mel])
        got = tm(torch.from_numpy(mel)).numpy()
        ratios.append(_norm(got - want) / _norm(want - f32))
    print(f"int8 skip={skip}: ||port - jax|| / ||jax_int8 - jax_fp32|| = "
          f"{ratios[0]!r} (conv_pre handed across), {ratios[1]!r} (own)")
    assert ratios[0] <= INT8_RATIO and ratios[1] <= INT8_RATIO_OWN, ratios


def test_int8_chunked_equals_one_shot_after_calibration(int8_setup):
    _, tc, mels, v, _ = int8_setup
    mel = torch.from_numpy(_mel(30, 1, 96))
    fns = [tsg.make_vocode_fn(convert.vocoder_from_flax(
        v, tc, device="cpu", quant_int8=True, serve_chunk=c,
        serve_calib_batches=1)) for c in (0, 16)]
    for fn in fns:
        fn(mel)                                    # calibrate
    one, chunked = (fn(mel) for fn in fns)
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), rtol=0,
                               atol=CHUNK_TOL)


def test_calibration_state_machine_and_saturation_warning(int8_setup,
                                                          caplog):
    """The first ``calib_batches`` batches calibrate one-shot (even with
    ``serve_chunk``), then the scales freeze; a batch past 1.25x the
    calibration amax warns, once."""
    _, tc, mels, v, _ = int8_setup
    tm = convert.vocoder_from_flax(v, tc, device="cpu", quant_int8=True,
                                   serve_chunk=16, serve_calib_batches=2)
    tm.ups_1_amax.fill_(123.0)                     # calibration starts empty
    fn = tsg.make_vocode_fn(tm)
    assert tm.ups_1_amax.item() == 0.0
    seen = []
    orig = tm.forward
    tm.forward = lambda m: seen.append((m.shape[1], tm.calibrate)) or orig(m)
    mel = torch.from_numpy(_mel(40, 1, 200))
    fn(mel)
    after1 = tm.ups_1_amax.item()
    fn(mel * 0.5)
    assert tm.ups_1_amax.item() == after1 > 0
    assert seen == [(200, True), (200, True)]
    seen.clear()
    with caplog.at_level(logging.WARNING):
        fn(mel)
        assert not caplog.records
        fn(mel * 2.0)
        fn(mel * 3.0)
    assert tm.ups_1_amax.item() == after1        # frozen
    assert all(not c for _, c in seen) and len(seen) > 3   # chunked windows
    warns = [r for r in caplog.records if "saturating" in r.getMessage()]
    assert len(warns) == 1


# --- the serving ladder -----------------------------------------------------

def test_serving_ladder_mcd_ordered_as_jax():
    """``tests/test_int8_quality.py``'s configuration, mel and weights
    (PRNGKey(0) init): int8-skip1 and bf16 both closer to fp32 than int8,
    by the MCD of their log-mels."""
    from test_int8_quality import realistic_mel, wav_mcd

    kw = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
              upsample_initial_channel=256, resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), resblock="1")
    jc, tc = _cfgs(**kw)
    mel = realistic_mel()
    params = jhg.HiFiGANGenerator(jc, fold_to=128).init(
        jax.random.PRNGKey(0), mel)
    v = jax.tree.map(np.asarray, params)
    tmel = torch.from_numpy(np.asarray(mel))
    out = {}
    for name, rung in (("fp32", "none"), ("bf16", "bf16"), ("int8", "int8"),
                       ("int8_skip1", "int8-skip1")):
        voc = convert.vocoder_from_flax(v, tc, device="cpu",
                                        **tsg.quant_fields(rung))
        fn = tsg.make_vocode_fn(voc, calib_batches=1)
        fn(tmel)                                   # calibrates the int8 ones
        out[name] = fn(tmel).numpy()
    mcd = {k: wav_mcd(out["fp32"], out[k]) for k in out}
    print("MCD vs fp32:", mcd)
    assert mcd["fp32"] == 0.0
    assert mcd["int8_skip1"] < mcd["int8"], mcd
    assert mcd["bf16"] < mcd["int8"], mcd


# --- make_vocode_fn serves every rung ----------------------------------------

@pytest.fixture(scope="module")
def rung_setup():
    kw = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
              upsample_initial_channel=64, resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), resblock="1")
    jc, tc = _cfgs(**kw)
    mel = _mel(50, 2, 40)
    v = random_variables(jhg.HiFiGANGenerator(jc, fold_to=128), 6, mel)
    return tc, v, torch.from_numpy(mel)


@pytest.mark.parametrize("quant", ["bf16", "int8", "int8-skip1"])
def test_make_vocode_fn_serves_rung(rung_setup, quant):
    tc, v, mel = rung_setup
    fields = tsg.quant_fields(quant)
    voc = convert.vocoder_from_flax(v, tc, device="cpu", **fields)
    assert (voc.dtype, voc.quant_int8, voc.quant_skip_levels) == (
        fields["dtype"], fields["quant_int8"], fields["quant_skip_levels"])
    fn = tsg.make_vocode_fn(voc)
    wav = fn(mel)
    assert wav.dtype == torch.float32 and wav.shape == (2, 40 * 8)
    assert torch.isfinite(wav).all()
    fp32 = convert.vocoder_from_flax(v, tc, device="cpu")(mel)
    assert 0 < (wav - fp32).norm() < 0.5 * fp32.norm()
    with pytest.raises(ValueError, match="quant"):
        tsg.quant_fields("fp8")


def test_make_vocode_fn_serves_a_bf16_vocoder(rung_setup):
    tc, v, mel = rung_setup
    voc = convert.vocoder_from_flax(v, tc, device="cpu", dtype=BF16)
    got = tsg.make_vocode_fn(voc)(mel)
    assert got.dtype == torch.float32
    assert torch.equal(got, voc(mel).float())


# --- bf16 discriminators ----------------------------------------------------

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
