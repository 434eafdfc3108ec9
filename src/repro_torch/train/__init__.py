"""Training of the port (``repro.train``): the train steps (serial or
monolithic zero1, and the §3.1 backprop-overlapped zero1 step) and the
training loop."""
from repro_torch.train.train_step import (  # noqa: F401
    global_norm,
    make_overlapped_train_step,
    make_train_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
