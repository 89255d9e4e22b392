"""Mean ms per served batch of the generator's decode stage: the encoder,
the DAG decoder, the links and the lookahead decode
(``S2SNATGenerator.decode``), timed by CUDA events around the stage in
``generate()``'s order over the window's batches."""


def read(record):
    ms = record.get("stage_ms", {}).get("decode") or []
    return sum(ms) / len(ms) if ms else None
