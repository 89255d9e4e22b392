"""The seeded weights emit speech at a phoneme's pace: the lookahead walk of
the plain reference, at the cell's widths, emits 12.5 tokens a second of
source speech within a fifth, at every length and seed tried. The served
mel's length, and so the operations ``serve.mfu`` counts, then follow the
traffic and not the seed."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import core  # noqa: E402
from benchmark.reference.s2st import S2ST, lookahead_walk  # noqa: E402
from benchmark.traffic.weights import s2st_weights  # noqa: E402

FRAMES = [150, 430, 1000]          # 1.5, 4.3 and 10 s at 100 frames a second
SEEDS = [2 ** 31 + 7, 2 ** 31 + 77, 2 ** 31 + 777]
RATE, WITHIN = 12.5, 0.2


def emitted_per_s(seed: int, device: str) -> list:
    from daspeech_torch.config import S2SModelConfig, from_dict
    from daspeech_torch.models import S2SConformerDAGFastSpeech2

    c = core.cell("s2st-serve")
    cfg, mix = c["config"], c["workload"]["traffic"]
    vocab = cfg["model"]["dag"]["vocab"]
    model = S2SConformerDAGFastSpeech2(from_dict(S2SModelConfig,
                                                 cfg["model"]))
    spec = [(n, tuple(t.shape)) for n, t in model.state_dict().items()]
    del model
    dev = torch.device(device)
    ref = S2ST(s2st_weights(spec, seed, dev, cfg["model"],
                            mix["mel_frames_per_token"]), cfg)
    rng = np.random.default_rng(seed)
    B, T = len(FRAMES), max(FRAMES)
    fbank = torch.zeros(B, T, 80)
    L = [int(f * cfg["model"]["dag"]["decoder"]["src_upsample_scale"])
         for f in FRAMES]
    prev = torch.full((B, max(L)), vocab["pad"], dtype=torch.long)
    for b, (f, n) in enumerate(zip(FRAMES, L)):
        fbank[b, :f] = torch.from_numpy(
            rng.standard_normal((f, 80), dtype=np.float32))
        prev[b, :n] = vocab["unk"]
        prev[b, 0], prev[b, n - 1] = vocab["bos"], vocab["eos"]
    with torch.no_grad():
        logits, links, _ = ref.decoder_pass(
            fbank.to(dev), torch.tensor(FRAMES, device=dev), prev.to(dev))
    tok, _, score = ref.hop_scores(logits, links)
    return [len(lookahead_walk(tok[b], score[b], L[b], vocab["pad"])[0])
            / (FRAMES[b] / mix["fbank_rate"]) for b in range(B)]


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_phoneme_pace_holds_over_seeds(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_num_threads(4)
    rates = [r for s in SEEDS for r in emitted_per_s(s, device)]
    assert all(abs(r / RATE - 1) <= WITHIN for r in rates), rates
