"""Training of the port: the single-device ``Trainer`` and its input
pipeline (checkpointing, ``prefetch_to_device`` and ``pack_documents`` are
not ported yet)."""

from kubetorch_tpu_torch.training.data import host_shard, lm_batches
from kubetorch_tpu_torch.training.trainer import (
    Trainer,
    cross_entropy_loss,
    init_train_state,
    make_default_loss,
    make_train_step,
)

__all__ = [
    "Trainer",
    "cross_entropy_loss",
    "init_train_state",
    "make_default_loss",
    "make_train_step",
    "host_shard",
    "lm_batches",
]
