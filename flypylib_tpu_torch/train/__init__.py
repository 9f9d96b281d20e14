from flypylib_tpu_torch.train.trainer import (
    TrainConfig,
    TrainData,
    Trainer,
    make_train_step,
    masked_bce_loss,
)
from flypylib_tpu_torch.train.batches import gen_batches

__all__ = [
    "TrainConfig",
    "TrainData",
    "Trainer",
    "make_train_step",
    "masked_bce_loss",
    "gen_batches",
]
