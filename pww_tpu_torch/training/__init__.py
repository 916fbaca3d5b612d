"""Training on a frozen pipeline: textual inversion and LoRA (port of
:mod:`pww_tpu.training`)."""
from .lora import DEFAULT_TARGETS, LoraTrainResult, train_lora
from .textual_inversion import DEFAULT_TEMPLATES, TIResult, train_textual_inversion

__all__ = [
    "DEFAULT_TARGETS", "DEFAULT_TEMPLATES", "LoraTrainResult", "TIResult",
    "train_lora", "train_textual_inversion",
]
