from daspeech_torch.train.step import global_norm, make_train_step
from daspeech_torch.train.train_state import (
    AdamState,
    GuardedAdam,
    TrainState,
    anneal_value,
    guarded_adam_,
    inverse_sqrt_schedule,
    make_optimizer,
    parse_anneal,
)
from daspeech_torch.train.vocoder_train import (
    VocoderTrainer,
    VocoderTrainState,
    make_mel_fn,
    make_vocoder_optimizer,
)

__all__ = [
    "AdamState",
    "GuardedAdam",
    "TrainState",
    "VocoderTrainState",
    "VocoderTrainer",
    "anneal_value",
    "global_norm",
    "guarded_adam_",
    "inverse_sqrt_schedule",
    "make_mel_fn",
    "make_optimizer",
    "make_train_step",
    "make_vocoder_optimizer",
    "parse_anneal",
]
