from daspeech_torch.decode.beam_search import beam_search_decode
from daspeech_torch.decode.dag_decode import (
    DecodeResult,
    gather_path_features,
    greedy_or_lookahead_decode,
    path_score,
    viterbi_decode,
)
from daspeech_torch.decode.generator import (
    S2SNATGenerator,
    S2TNATGenerator,
    rerank_scores,
)
from daspeech_torch.decode.speech_generator import (
    AutoRegressiveSpeechGenerator,
    MultiDecoderSpeechGenerator,
    NonAutoregressiveSpeechGenerator,
    make_vocode_fn,
)

__all__ = [
    "AutoRegressiveSpeechGenerator",
    "DecodeResult",
    "MultiDecoderSpeechGenerator",
    "NonAutoregressiveSpeechGenerator",
    "S2SNATGenerator",
    "S2TNATGenerator",
    "beam_search_decode",
    "gather_path_features",
    "greedy_or_lookahead_decode",
    "make_vocode_fn",
    "path_score",
    "rerank_scores",
    "viterbi_decode",
]
