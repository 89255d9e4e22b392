from daspeech_torch.decode.dag_decode import (
    DecodeResult,
    gather_path_features,
    greedy_or_lookahead_decode,
)
from daspeech_torch.decode.generator import S2SNATGenerator
from daspeech_torch.decode.speech_generator import (
    NonAutoregressiveSpeechGenerator,
    make_vocode_fn,
)

__all__ = [
    "DecodeResult",
    "NonAutoregressiveSpeechGenerator",
    "S2SNATGenerator",
    "gather_path_features",
    "greedy_or_lookahead_decode",
    "make_vocode_fn",
]
