"""The ``serve`` kind: offline S2ST serving, a closed loop of the task's
own batches through ``S2SNATGenerator.generate``.

Set-up writes the mix's test split under the temporary directory (the
lengths are the mix's; the features, and which utterances share a batch,
the seed's), builds the two-pass model and HiFi-GAN with seeded weights on
the device, and serves every batch shape of the split once. The window
then serves the split's batches in length order, each collated from disk
as the generate command line does, in whole passes until ``seconds`` have
passed. A batch counts once its outputs are on the host, and of it the
utterances that came back with a waveform; the others are failed. A sample
of the served batches is judged against the plain reference once the
program has been freed: a few positions of the split, drawn from the seed
and holding its longest utterance, each from a pass of the window that the
seed draws.

Every run times ``generate()`` itself. With ``trace`` the generator's
public stages (``decode``, ``synthesize``, ``vocode``, and the copy of the
results) are wrapped on the instance, so that ``generate()`` calls each
inside a profiler range and between CUDA events, and a few batches after
the window run under the profiler with the program's ops annotated.
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.counts import ops as op_counts
from benchmark.counts.s2st import utterance_flops
from benchmark.harness import trace as tr
from benchmark.harness.core import log
from benchmark.harness.peaks import PEAK_BYTES, PEAK_FLOPS
from benchmark.traffic.data import utterance_frames, write_runtime_data
from benchmark.traffic.weights import s2st_weights, vocoder_weights

STAGES = ("decode", "synth", "vocode")


def mel_bucket(src_frames: int, voc: dict, fbank_rate: int) -> int:
    """Mel frames of a batch whose bucket holds ``src_frames`` source
    frames: the same span of speech at the vocoder's frame rate."""
    return math.ceil(src_frames * voc["sampling_rate"] / voc["hop_size"]
                     / fbank_rate)


def sample_positions(batches, n_frames, seed: int, k: int) -> List[int]:
    """Positions of the batches to judge: the first, the one holding the
    longest utterance, and ``k`` more drawn from the seed."""
    longest = max(range(len(batches)),
                  key=lambda p: max(n_frames(i) for i in batches[p][1]))
    rng = np.random.default_rng(seed)
    extra = rng.choice(len(batches), size=min(k, len(batches)),
                       replace=False)
    return sorted({0, longest, *map(int, extra)})


def state_spec(module) -> list:
    return [(n, tuple(t.shape)) for n, t in module.state_dict().items()]


class Program:
    """The system under test: the task's batches and the generator."""

    def __init__(self, c: dict, data_dir: Path, seed: int, device: str):
        from daspeech_torch.config import (DecodeConfig, HiFiGANConfig,
                                           S2SModelConfig, from_dict)
        from daspeech_torch.decode import S2SNATGenerator
        from daspeech_torch.models import (HiFiGANGenerator,
                                           S2SConformerDAGFastSpeech2)
        from daspeech_torch.tasks import NATSpeechToSpeechTask, TaskConfig

        cfg, mix = c["config"], c["workload"]["traffic"]
        dec = cfg["model"]["dag"]["decoder"]
        self.cfg, self.mix = cfg, mix
        self.task = NATSpeechToSpeechTask.setup_task(TaskConfig(
            data_dir=str(data_dir), max_tokens=mix["max_tokens"],
            num_buckets=mix["num_buckets"],
            max_target_positions=dec["max_target_positions"]))
        want = cfg["model"]["dag"]["vocab"]
        got = self.task.vocab
        if (got.size, got.bos, got.pad, got.eos, got.unk) != (
                want["size"], want["bos"], want["pad"], want["eos"],
                want["unk"]):
            raise ValueError(f"the data's dictionary {got} is not the "
                             f"configuration's vocabulary {want}")
        self.ds = self.task.load_dataset("test")
        self.it = self.task.get_batch_iterator(
            "test", seed=seed, upsample_scale=dec["src_upsample_scale"])
        # fairseq's generate serves its batches in length order: the
        # seed draws each batch's utterances, the order of the shapes is
        # the same in every run
        self.batches = sorted(self.it.batches_for_epoch(0),
                              key=lambda b: (b[0].src, -len(b[1])))
        dev = torch.device(device)
        with dev:
            model = S2SConformerDAGFastSpeech2(
                from_dict(S2SModelConfig, cfg["model"]))
            voc = HiFiGANGenerator(from_dict(HiFiGANConfig, cfg["vocoder"]))
        self.spec = state_spec(model)
        self.voc_spec = state_spec(voc)
        model.load_state_dict(s2st_weights(
            self.spec, seed, dev, cfg["model"], mix["mel_frames_per_token"]))
        voc.load_state_dict(vocoder_weights(self.voc_spec, seed + 1, dev))
        for m in (model, voc):
            m.eval().requires_grad_(False)
        self.gen = S2SNATGenerator(model, self.task.vocab,
                                   from_dict(DecodeConfig, cfg["decode"]),
                                   vocoder=voc)
        # keep the decode result of each batch: the vertices that emitted
        # its tokens are judged with them
        self.last = {}
        decode = self.gen.decode

        def spy(*args):
            out = decode(*args)
            self.last["res"] = out[0]
            return out

        self.gen.decode = spy
        self.stage_ms = None
        self._events = []

    def time_stages(self) -> None:
        """Wrap the generator's stages on the instance: ``generate()`` then
        runs each inside a ``bench.stage`` range and, while ``stage_ms``
        is a dict, between CUDA events whose times :meth:`serve` adds to
        it."""
        for attr, name in (("decode", "decode"), ("synthesize", "synth"),
                           ("vocode", "vocode"),
                           ("_hypotheses", "results")):
            setattr(self.gen, attr, self._timed(getattr(self.gen, attr),
                                                name))

    def _timed(self, fn, name: str):
        def stage(*args):
            timed = self.stage_ms is not None and name in self.stage_ms
            if timed:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            with tr.stage(name):
                out = fn(*args)
            if timed:
                ev[1].record()
                self._events.append((name, *ev))
            return out

        return stage

    def batch(self, pos: int) -> dict:
        spec, idxs = self.batches[pos % len(self.batches)]
        self.gen.max_mel_len = mel_bucket(spec.src, self.cfg["vocoder"],
                                          self.mix["fbank_rate"])
        return self.it.collate(spec, idxs, pad_last=False)

    def serve(self, pos: int):
        batch = self.batch(pos)
        hyps = self.gen.generate(batch)
        # the results are on the host, so every stage's events are done
        for name, start, end in self._events:
            self.stage_ms[name].append(start.elapsed_time(end))
        self._events.clear()
        return batch, hyps

    def answered(self, batch: dict, hyps: List[dict]) -> List[int]:
        """The rows of ``batch`` that came back with a waveform."""
        B = len(batch["src_lengths"])
        return [b for b, h in enumerate(hyps[:B])
                if h is not None and len(h.get("waveform", ())) > 0]

    def kept(self, batch: dict, hyps: List[dict], rows: List[int]) -> dict:
        """What the judge needs of a served batch: each answered row's
        outputs, None for the others."""
        res = self.last["res"]
        idx = res.feat_idx.cpu().numpy()
        n = res.lengths.cpu().numpy()
        served = [None] * len(batch["src_lengths"])
        for b in rows:
            h = hyps[b]
            served[b] = {"tokens": h["tokens"],
                         "vertices": idx[b, 1:n[b]].tolist(),
                         "feature": h["feature"], "waveform": h["waveform"]}
        return {"batch": batch, "served": served,
                "max_mel_len": self.gen.max_mel_len}

    def sizes(self, batch: dict, hyps: List[dict], rows: List[int]) -> list:
        """(S, L, N, M) of each answered utterance: source frames, graph
        vertices, path features, mel frames."""
        pad = self.cfg["model"]["dag"]["vocab"]["pad"]
        L = (batch["prev_output_tokens"] != pad).sum(axis=1)
        return [(int(batch["src_lengths"][b]), int(L[b]),
                 len(hyps[b]["tokens"]) - 1, len(hyps[b]["feature"]))
                for b in rows]

    def flops(self, sizes: list) -> int:
        """Operations the utterances needed (``counts.s2st``)."""
        return sum(sum(utterance_flops(self.cfg, *z).values())
                   for z in sizes)

    def annotate(self) -> tr.OpRecorder:
        """Wrap the program's hand-written ops for the profiler."""
        import daspeech_torch.models.dag_model as dag_model
        import daspeech_torch.ops.fused_attention as fa
        import daspeech_torch.ops.fused_relpos as fr

        rec = tr.OpRecorder()
        rec.wrap(fa, "fused_attention_packed", "attention_packed",
                 op_counts.attention_packed)
        rec.wrap(fa, "fused_attention", "attention_head_major",
                 op_counts.attention_head_major)
        rec.wrap(fr, "fused_attention_relpos", "attention_relpos",
                 op_counts.attention_relpos)
        rec.wrap(dag_model, "fused_extract_links", "extract_links",
                 op_counts.extract_links)
        return rec


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def run(c: dict, seed: int, seconds: float, trace: bool, device: str,
        t0: float, control: bool = False) -> dict:
    """One run of the cell. ``control`` (for ``benchmark/calibrate.py``,
    never in the benchmark's own runs) also judges the control: the
    reference in TF32 put in the program's place on the same batches."""
    tmp = Path(tempfile.mkdtemp(prefix="s2st-serve-"))
    try:
        return _run(c, seed, seconds, trace, device, t0, tmp, control)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(c, seed, seconds, trace, device, t0, tmp, control) -> dict:
    wl, cfg = c["workload"], c["config"]
    mix = wl["traffic"]
    write_runtime_data(tmp, "test", utterance_frames(mix),
                       cfg["model"]["dag"]["vocab"]["size"],
                       mix["target_tokens_per_s"], mix["fbank_rate"], seed)
    prog = Program(c, tmp, seed, device)
    n = len(prog.batches)
    keep = sample_positions(prog.batches, prog.ds.n_frames, seed,
                            wl["sample"]["batches"])
    rec = prog.annotate() if trace else None
    if trace:
        prog.time_stages()
    # every batch shape of the split, once
    seen = set()
    for pos, (spec, idxs) in enumerate(prog.batches):
        if (spec, len(idxs)) not in seen:
            seen.add((spec, len(idxs)))
            prog.serve(pos)
    _sync(device)
    log(f"set-up: {len(prog.ds)} utterances in {n} batches, "
        f"{len(seen)} shapes; judged positions {keep}")

    # each judged position's outputs from every pass; one pass is judged
    passes: Dict[int, List[dict]] = {p: [] for p in keep}
    audio, utts, failed, tokens, pos = 0.0, 0, 0, 0, 0
    sizes = []
    if trace:
        prog.stage_ms = {s: [] for s in STAGES}

    def account(p, batch, hyps):
        nonlocal audio, utts, failed, tokens
        rows = prog.answered(batch, hyps)
        tokens += sum(len(hyps[b]["tokens"]) for b in rows)
        audio += float(batch["src_lengths"][rows].sum()) / mix["fbank_rate"]
        utts += len(batch["src_lengths"])
        failed += len(batch["src_lengths"]) - len(rows)
        if p % n in passes:
            passes[p % n].append(prog.kept(batch, hyps, rows))
        if trace:
            sizes.append(prog.sizes(batch, hyps, rows))

    start = time.perf_counter()
    setup_s = start - t0
    # whole passes over the split, so that every run's window holds the
    # same mix of batch shapes
    while True:
        batch, hyps = prog.serve(pos)
        account(pos, batch, hyps)
        pos += 1
        if pos % n == 0 and time.perf_counter() - start >= seconds:
            break
    end = time.perf_counter()
    stage_ms, prog.stage_ms = prog.stage_ms, None
    rng = np.random.default_rng([seed, 1])
    kept = {}
    for p, got in passes.items():
        i = int(rng.integers(len(got)))
        kept[p] = got[i]
        log(f"judging position {p} from pass {i + 1} of {len(got)}")
    del passes
    log(f"window: {pos} batches ({pos // n} passes), {utts} utterances "
        f"({failed} failed), {audio:.1f} s of speech in "
        f"{end - start:.3f} s; {tokens / max(audio, 1e-9):.2f} tokens "
        f"emitted a second of speech")
    events, prof_wall = None, 0.0
    if trace:
        # the profiled stretch follows the window, so that the profiler's
        # own work never lands in the timed batches
        k = wl["trace"]["profiled_batches"]

        def profiled():
            # batches spread over the pass: short, middle and long buckets
            for i in range(k):
                prog.serve(i * n // k)

        rec.active = True
        events, prof_wall = tr.profiled_events(profiled)
        rec.active = False

    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    out = {"values": {"setup_s": setup_s,
                      "serve_src_s_per_s": audio / (end - start)},
           "attempted": utts, "failed": failed, "memory_peak_bytes": peak,
           "record": None}
    if trace:
        rec.restore()
        busy = tr.busy_s(events)
        out.update(
            busy_s=busy, window_s=prof_wall,
            breakdown={"device_ops": tr.top_device_ops(events),
                       "idle_gaps": tr.idle_gaps(events)},
            record={"stage_ms": stage_ms,
                    "flops": sum(prog.flops(z) for z in sizes),
                    "timed_s": end - start,
                    "peak_flops": PEAK_FLOPS[wl["dtype"]],
                    "peak_bytes": PEAK_BYTES, "busy_s": busy,
                    "window_s": prof_wall,
                    "op_calls": rec.counted(tr.op_device_s(events))})
        del events
    spec, voc_spec = prog.spec, prog.voc_spec
    del prog, rec
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    out["readings"], out["control"] = judge(c, kept, spec, voc_spec, seed,
                                            device, control)
    # the judged batches are the window's: its failed utterances hold theirs
    out["readings"]["missing"] = max(out["readings"]["missing"], failed)
    return out


def judge(c, kept, spec, voc_spec, seed, device, control=False):
    """The plain reference's readings of the kept batches, in fp32; with
    ``control`` also those of the reference in TF32 in the program's
    place (else None)."""
    from benchmark.reference.judge import judge_batch, worst
    from benchmark.reference.s2st import S2ST, precision

    cfg, mix = c["config"], c["workload"]["traffic"]
    t = time.perf_counter()
    dev = torch.device(device)
    sd = s2st_weights(spec, seed, dev, cfg["model"],
                      mix["mel_frames_per_token"])
    sd.update(vocoder_weights(voc_spec, seed + 1, dev))
    ref = S2ST(sd, cfg)
    readings, controls = [], []
    for p, k in sorted(kept.items()):
        b = k["batch"]
        inputs = {"fbank": torch.as_tensor(b["fbank"], device=dev),
                  "src_lengths": torch.as_tensor(
                      b["src_lengths"], device=dev).long(),
                  "prev_output_tokens": torch.as_tensor(
                      b["prev_output_tokens"], device=dev).long()}
        with precision(tf32=False):
            readings.append(judge_batch(ref, inputs, k["served"],
                                        k["max_mel_len"]))
        tokens = sum(len(h["tokens"]) for h in k["served"] if h)
        log(f"judged batch {p} ({len(k['served'])} utterances, {tokens} "
            f"tokens): {readings[-1]}")
        if control:
            with precision(tf32=True):
                cand = ref.serve(inputs["fbank"], inputs["src_lengths"],
                                 inputs["prev_output_tokens"],
                                 k["max_mel_len"])
            with precision(tf32=False):
                controls.append(judge_batch(ref, inputs, cand,
                                            k["max_mel_len"]))
            log(f"control of batch {p}: {controls[-1]}")
    log(f"reference: {len(readings)} batches in "
        f"{time.perf_counter() - t:.1f} s")
    return worst(readings), (worst(controls) if control else None)
