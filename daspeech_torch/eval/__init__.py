from daspeech_torch.eval.asr_bleu import (
    Wav2Vec2Transcriber,
    asr_available,
    compute_asr_bleu,
    corpus_bleu,
    normalize_transcript,
    resample_linear,
)

__all__ = [
    "Wav2Vec2Transcriber",
    "asr_available",
    "compute_asr_bleu",
    "corpus_bleu",
    "normalize_transcript",
    "resample_linear",
]
