"""Serial training of the port (``repro.train``): the train step and the
training loop."""
from repro_torch.train.train_step import global_norm, make_train_step  # noqa: F401
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
