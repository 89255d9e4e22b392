"""Mean ms per served batch of the generator's vocoder stage: HiFi-GAN
(``S2SNATGenerator.vocode``), timed by CUDA events around the stage in
``generate()``'s order over the window's batches."""


def read(record):
    ms = record.get("stage_ms", {}).get("vocode") or []
    return sum(ms) / len(ms) if ms else None
