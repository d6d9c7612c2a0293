"""Training substrate of the port: optimizer, data pipeline, checkpointing,
train step (ported from ``src/repro/train``)."""
from .optimizer import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from .step import make_train_step

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
    "make_train_step",
]
