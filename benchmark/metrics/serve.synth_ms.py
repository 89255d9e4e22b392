"""Mean ms per served batch of the generator's synthesis stage: the
adaptor and FastSpeech 2 (``S2SNATGenerator.synthesize``), timed by CUDA
events around the stage in ``generate()``'s order over the window's
batches."""


def read(record):
    ms = record.get("stage_ms", {}).get("synth") or []
    return sum(ms) / len(ms) if ms else None
