"""Optimizers and LR schedules of the port (``repro.optim``, serial part)."""
from repro_torch.optim.adamw import AdamW, AdamWState  # noqa: F401
from repro_torch.optim.schedule import (  # noqa: F401
    constant,
    linear_scale_warmup,
    warmup_cosine,
)
from repro_torch.optim.sgd import MomentumSGD, SgdState  # noqa: F401
