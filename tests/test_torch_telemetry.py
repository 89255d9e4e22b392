"""The port's spans and counters (``daspeech_torch.telemetry``) on a tiny
two-pass S2ST generator on the CPU, and, marked ``cuda``, their clock on
the card.

* off: ``generate()`` records nothing and calls neither
  ``record_function`` nor ``torch.cuda.Event``;
* under ``torch.profiler``: every span is a user annotation of the chrome
  trace, nested in its ``generate``; a parent's self time plus its
  children's times is its duration; the spans of one call share its
  number;
* the counters against the outputs; a collate on a second thread is a root
  span; a second profiler session starts a new session; the train step's
  spans; ``--profile`` of the generate command line;
* on the card (``cuda``): the results' copies run inside their batch's
  ``results.d2h`` range, and the vocoder's levels in order.

The ``cuda`` test runs on a machine with a card with
``python -m pytest --noconftest -m cuda tests/test_torch_telemetry.py``.
"""

import json
import threading

import numpy as np
import pytest
import torch

from daspeech_torch import telemetry
from daspeech_torch.cli import generate as tgen
from daspeech_torch.config import (ConformerConfig, DAGDecoderConfig,
                                   DAGModelConfig, DecodeConfig,
                                   FastSpeech2Config, HiFiGANConfig,
                                   S2SModelConfig, VocabConfig)
from daspeech_torch.data.datasets import BucketBatcher, BucketSpec, S2TItem
from daspeech_torch.decode import S2SNATGenerator
from daspeech_torch.models import (HiFiGANGenerator,
                                   S2SConformerDAGFastSpeech2)

VOCAB = VocabConfig(size=32)
SPEC = BucketSpec(batch=2, src=48, graph=24, tgt=8)
GENERATE_SPANS = {
    "generate", "generate.h2d", "generate.decode", "decode.encoder",
    "decode.decoder", "decode.walk", "decode.gather", "generate.synthesize",
    "synth.adaptor", "synth.fastspeech2", "generate.vocode",
    "vocoder.level0", "vocoder.level1", "generate.results", "results.d2h",
    "results.split"}


def tiny_generator(device="cpu", max_mel_len=32) -> S2SNATGenerator:
    """Widths of a few units on the CPU; on the card the recipe's widths
    (the kernels' head sizes) at one layer a stack and HiFi-GAN V1."""
    torch.manual_seed(0)
    if device == "cuda":
        cfg = S2SModelConfig(
            dag=DAGModelConfig(vocab=VOCAB,
                               encoder=ConformerConfig(num_layers=1),
                               decoder=DAGDecoderConfig(num_layers=1)),
            tts=FastSpeech2Config(encoder_layers=1, decoder_layers=1))
        return _generator(cfg, HiFiGANConfig(), device, max_mel_len)
    cfg = S2SModelConfig(
        dag=DAGModelConfig(
            vocab=VOCAB,
            encoder=ConformerConfig(embed_dim=16, ffn_dim=32, num_heads=2,
                                    num_layers=1, conv_channels=8,
                                    depthwise_kernel_size=7),
            decoder=DAGDecoderConfig(embed_dim=16, ffn_dim=32, num_heads=2,
                                     num_layers=1)),
        tts=FastSpeech2Config(encoder_layers=1, encoder_embed_dim=16,
                              encoder_heads=2, decoder_layers=1,
                              decoder_embed_dim=16, decoder_heads=2,
                              fft_hidden_dim=32, var_pred_hidden_dim=16))
    voc_cfg = HiFiGANConfig(upsample_rates=(2, 2),
                            upsample_kernel_sizes=(4, 4),
                            upsample_initial_channel=32,
                            resblock_kernel_sizes=(3,),
                            resblock_dilation_sizes=((1, 3),))
    return _generator(cfg, voc_cfg, device, max_mel_len)


def _generator(cfg, voc_cfg, device, max_mel_len) -> S2SNATGenerator:
    model = S2SConformerDAGFastSpeech2(cfg).eval()
    with torch.no_grad():
        # about 3 mel frames a phoneme, so that some rows fill the bucket
        model.tts.var_adaptor.duration_predictor.proj.bias.fill_(1.0)
    return S2SNATGenerator(model.to(device), VOCAB, DecodeConfig(),
                           max_mel_len=max_mel_len,
                           vocoder=HiFiGANGenerator(voc_cfg).eval().to(
                               device))


class MemoryDataset:
    """A split held in memory, as ``BucketBatcher`` and the generate
    command line's batch loop read it."""

    def __init__(self, n: int = 4, seed: int = 0):
        rng = np.random.default_rng(seed)
        lens = rng.integers(30, SPEC.src + 1, size=n)
        self.items = [S2TItem(f"utt{i}",
                              rng.normal(size=(int(s), 80)).astype(
                                  np.float32),
                              np.asarray([0, 5, 6, 2], np.int32))
                      for i, s in enumerate(lens)]
        self.rows = [{"id": it.utt_id} for it in self.items]

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)

    def n_frames(self, i):
        return len(self.items[i].fbank)


def batcher(n: int = 4) -> BucketBatcher:
    ds = MemoryDataset(n)
    return BucketBatcher(ds, range(len(ds)), [SPEC], vocab=VOCAB)


def batches(n: int = 4):
    it = batcher(n)
    return [it.collate(spec, idxs, pad_last=False)
            for spec, idxs in it.batches_for_epoch(0)]


@pytest.fixture(autouse=True)
def recording_off():
    """Each test starts and ends with the switch off."""
    telemetry.disable()
    yield
    telemetry.disable()


@pytest.fixture(scope="module")
def gen():
    return tiny_generator()


def _duration(r):
    return r["host_ms"] if r["device_ms"] is None else r["device_ms"]


def test_off_records_nothing(gen, monkeypatch):
    calls = {"record_function": 0, "Event": 0}
    rf, event = torch.autograd.profiler.record_function, torch.cuda.Event

    def counting_rf(*a, **kw):
        calls["record_function"] += 1
        return rf(*a, **kw)

    def counting_event(*a, **kw):
        calls["Event"] += 1
        return event(*a, **kw)

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting_rf)
    monkeypatch.setattr(torch.cuda, "Event", counting_event)
    telemetry.enable()              # a fresh, empty session
    telemetry.disable()
    before = telemetry.snapshot()
    gen.generate(batches()[0])
    after = telemetry.snapshot()
    assert calls == {"record_function": 0, "Event": 0}
    assert after["session"] == before["session"]
    assert after["spans"] == {} and after["counters"] == {}
    assert after["recent"] == []
    # the no-op span is one shared object
    assert telemetry.span("a") is telemetry.span("b")


def test_profiled_generate_nests_its_spans(gen, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    work = batches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for b in work:
            gen.generate(b)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())
              ["traceEvents"] if e.get("cat") == "user_annotation"]
    outer = sorted((e for e in events if e["name"] == "generate"),
                   key=lambda e: e["ts"])
    assert len(outer) == len(work)
    for g in outer:
        inside = {e["name"] for e in events
                  if g["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= g["ts"] + g["dur"]}
        assert GENERATE_SPANS <= inside, GENERATE_SPANS - inside

    snap = telemetry.snapshot()
    recent = snap["recent"]
    assert {r["name"] for r in recent} == GENERATE_SPANS
    assert snap["spans"]["generate"]["calls"] == len(work)
    by_id = {r["id"]: r for r in recent}
    for p in recent:
        kids = [r for r in recent if r["parent"] == p["id"]]
        assert p["self_ms"] + sum(_duration(k) for k in kids) == \
            pytest.approx(_duration(p), rel=0.01)
        if p["parent"] is not None:
            assert p["call"] == by_id[p["parent"]]["call"]
    calls = {}
    for r in recent:
        calls.setdefault(r["call"], set()).add(r["name"])
    assert len(calls) == len(work)
    assert all(names == GENERATE_SPANS for names in calls.values())
    # the totals are the sums of the spans
    for name, t in snap["spans"].items():
        mine = [r for r in recent if r["name"] == name]
        assert t["calls"] == len(mine)
        assert t["host_ms"] == pytest.approx(sum(r["host_ms"] for r in mine))
        assert t["self_ms"] == pytest.approx(sum(r["self_ms"] for r in mine))
        assert t["device_ms"] is None


@pytest.mark.parametrize("max_mel_len", [8, 64],
                         ids=["rows-clipped", "rows-whole"])
def test_counters_follow_the_outputs(max_mel_len):
    """Run stage by stage, as a caller that times them does."""
    g = tiny_generator(max_mel_len=max_mel_len)
    b = batches()[0]
    telemetry.enable()
    with torch.inference_mode():
        res, z, zmask = g.decode(*g.to_device(b))
        mel, mel_lens = g.synthesize(z, zmask)
        wav = g.vocode(mel)
        hyps = g._hypotheses(res, mel, mel_lens, wav)
    telemetry.disable()
    c = telemetry.snapshot()["counters"]
    B = len(b["src_lengths"])
    assert c["synth.mel_frames"] == B * max_mel_len == mel.shape[0] * \
        mel.shape[1]
    assert c["results.mel_frames_kept"] == sum(len(h["feature"])
                                               for h in hyps)
    copied = (res.tokens, res.lengths, mel, mel_lens, wav)
    assert c["results.d2h_copies"] == len(copied)
    assert c["results.d2h_bytes"] == sum(t.numel() * t.element_size()
                                         for t in copied)
    if max_mel_len == 8:
        assert c["results.mel_frames_kept"] < c["synth.mel_frames"]
    # the stage methods hold their spans, outside generate() too
    assert set(telemetry.snapshot()["spans"]) == GENERATE_SPANS - {
        "generate"}


def test_generate_counts_batches_and_utterances(gen):
    work = batches(6)
    telemetry.enable()
    for b in work:
        gen.generate(b)
    c = telemetry.snapshot()["counters"]
    assert c["generate.batches"] == len(work)
    assert c["generate.utterances"] == sum(len(b["src_lengths"])
                                           for b in work)


def test_collate_on_a_second_thread_is_a_root_span():
    it = batcher()
    spec, idxs = it.batches_for_epoch(0)[0]
    telemetry.enable()
    with telemetry.span("outer"):
        t = threading.Thread(target=it.collate, args=(spec, idxs))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    recent = telemetry.snapshot()["recent"]
    collate = [r for r in recent if r["name"] == "data.collate"]
    outer = [r for r in recent if r["name"] == "outer"]
    assert len(collate) == 1 and len(outer) == 1
    assert collate[0]["parent"] is None
    assert collate[0]["thread"] != outer[0]["thread"]
    assert collate[0]["call"] != outer[0]["call"]


def test_a_second_profiler_session_starts_a_new_session(gen):
    from torch.profiler import ProfilerActivity, profile

    b = batches()[0]
    with profile(activities=[ProfilerActivity.CPU]):
        gen.generate(b)
    first = telemetry.snapshot()
    assert first["spans"]["generate"]["calls"] == 1
    with profile(activities=[ProfilerActivity.CPU]):
        gen.generate(b)
        gen.generate(b)
    second = telemetry.snapshot()
    assert second["session"] > first["session"]
    assert second["spans"]["generate"]["calls"] == 2
    assert second["counters"]["generate.batches"] == 2
    # outside any profiler, nothing more is recorded
    gen.generate(b)
    assert telemetry.snapshot()["spans"]["generate"]["calls"] == 2


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_spans(accum):
    from daspeech_torch.losses import nat_dag_loss
    from daspeech_torch.models import (S2TConformerDAG, graph_lengths,
                                       initialize_output_tokens)
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    torch.manual_seed(0)
    cfg = tiny_generator().model.cfg.dag
    opt = GuardedAdam(warmup_updates=1)
    state = TrainState.create(S2TConformerDAG(cfg), opt)
    step = make_train_step(
        lambda m, b, g: nat_dag_loss(m, b, g, 0.5, VOCAB), opt,
        accum_steps=accum)
    lens = torch.tensor([40, 35])
    prev = initialize_output_tokens(graph_lengths(lens, 0.5, 1024), 20,
                                    VOCAB)
    mb = {"fbank": torch.randn(2, 40, 80), "src_lengths": lens,
          "target": torch.tensor([[0, 5, 6, 7, 2], [0, 8, 9, 2, 1]]),
          "prev_output_tokens": prev}
    telemetry.enable()
    step(state, mb if accum == 1 else [mb] * accum, torch.Generator())
    spans = telemetry.snapshot()["spans"]
    assert {n: s["calls"] for n, s in spans.items()} == {
        "train.forward": accum, "train.backward": accum,
        "train.optimizer": 1}


def test_generate_profile_writes_the_trace_and_the_table(gen, tmp_path,
                                                         capsys):
    """``--profile DIR``: the batch loop of the generate command line under
    the profiler, its chrome trace, and the table on standard error."""
    assert tgen.parse_args(["data", "--profile", "p"]).profile == "p"
    it = batcher()
    assert tgen.emit_outputs(it, gen, tmp_path / "out",
                             profile=tmp_path / "prof", device="cpu") == 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert GENERATE_SPANS | {"data.collate"} <= names
    err = capsys.readouterr().err
    for name in ("generate", "data.collate", "results.d2h",
                 "results.mel_frames_kept", "synth.mel_frames"):
        assert name in err
    n = len(it.batches_for_epoch(0))
    assert telemetry.snapshot()["spans"]["generate"]["calls"] == n


@pytest.mark.cuda
def test_one_clock_on_the_card(tmp_path):
    """On the card: each batch's results copies run on the device after
    its ``results.d2h`` range opens and before the next ``generate``
    range opens, and the kernels of ``vocoder.level<i>`` in level order;
    ``results.d2h`` has a device time, and self times are on the device
    clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = tiny_generator("cuda")
    it = batcher(8)
    g.generate(it.collate(*it.batches_for_epoch(0)[0], pad_last=False))
    assert tgen.emit_outputs(it, g, tmp_path / "out",
                             profile=tmp_path / "prof", device="cuda") == 0
    ev = json.loads((tmp_path / "prof" / "trace.json").read_text()
                    )["traceEvents"]
    ann = sorted((e for e in ev if e.get("cat") == "user_annotation"),
                 key=lambda e: e["ts"])
    gens = [e for e in ann if e["name"] == "generate"]
    d2h = [e for e in ann if e["name"] == "results.d2h"]
    n = len(it.batches_for_epoch(0))
    assert len(gens) == len(d2h) == n

    def launched_in(rng):
        """Correlation ids of the runtime calls inside the range."""
        return {e["args"]["correlation"] for e in ev
                if e.get("cat", "").startswith("cuda_")
                and "correlation" in e.get("args", {})
                and e.get("tid") == rng.get("tid")
                and rng["ts"] <= e["ts"] <= rng["ts"] + rng["dur"]}

    device = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy")
              and "correlation" in e.get("args", {})]
    for i, r in enumerate(d2h):
        ids = launched_in(r)
        copies = [e for e in device if e["cat"] == "gpu_memcpy"
                  and e["args"]["correlation"] in ids]
        assert len(copies) == 5
        nxt = gens[i + 1]["ts"] if i + 1 < n else float("inf")
        for c in copies:
            assert r["ts"] <= c["ts"] < nxt, (i, c, r)
    levels = len(g.vocoder.ups)
    for g0 in gens:
        ends, starts = [], []
        for lvl in range(levels):
            rng = next(e for e in ann if e["name"] == f"vocoder.level{lvl}"
                       and g0["ts"] <= e["ts"] <= g0["ts"] + g0["dur"])
            ids = launched_in(rng)
            ks = [e for e in device if e["cat"] == "kernel"
                  and e["args"]["correlation"] in ids]
            assert ks
            starts.append(min(e["ts"] for e in ks))
            ends.append(max(e["ts"] + e["dur"] for e in ks))
        assert all(ends[i] <= starts[i + 1] for i in range(levels - 1))
    spans = telemetry.snapshot()["spans"]
    assert spans["results.d2h"]["device_ms"] > 0
    assert spans["generate"]["calls"] == n
    for r in telemetry.snapshot()["recent"]:
        assert r["device_ms"] is not None
