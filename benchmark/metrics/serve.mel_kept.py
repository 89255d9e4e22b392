"""The share of the synthesised and vocoded mel frames that the served
utterances keep, in %: the program's counter ``results.mel_frames_kept``
(each row's mel length, at most the bucket) over ``synth.mel_frames``
(rows times the mel bucket, what FastSpeech 2's decoder and HiFi-GAN
compute). It reads the program's own registry for the profiled stretch
(``harness/program_spans.py``), not the ``record``; None when the
registry holds neither counter."""

from benchmark.harness.program_spans import counter


def read(record):
    kept, computed = (counter("results.mel_frames_kept"),
                      counter("synth.mel_frames"))
    if kept is None or not computed:
        return None
    return 100.0 * kept / computed
