from daspeech_torch.decode.dag_decode import (
    DecodeResult,
    gather_path_features,
    greedy_or_lookahead_decode,
)
from daspeech_torch.decode.generator import S2SNATGenerator

__all__ = [
    "DecodeResult",
    "S2SNATGenerator",
    "gather_path_features",
    "greedy_or_lookahead_decode",
]
