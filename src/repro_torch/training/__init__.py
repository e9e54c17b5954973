"""Training: the train step and the trainer (the reference's
``repro.training``)."""

from repro_torch.training.train_step import (init_train_state,
                                             make_train_step, state_from_tree,
                                             state_tree)
from repro_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "init_train_state", "make_train_step",
           "state_from_tree", "state_tree"]
