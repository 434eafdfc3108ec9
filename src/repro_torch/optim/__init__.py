"""Optimizers, LR schedules and the §3.4 distributed update of the port
(``repro.optim``): the serial optimizers, and ``optim.dist``'s monolithic
zero1 update, its backprop-overlapped composition and its stale-sync
composition."""
from repro_torch.optim.adamw import AdamW, AdamWState  # noqa: F401
from repro_torch.optim.dist import (  # noqa: F401
    UpdatePlan,
    make_distributed_update,
    make_overlapped_update,
    make_stale_sync_update,
)
from repro_torch.optim.schedule import (  # noqa: F401
    constant,
    linear_scale_warmup,
    warmup_cosine,
)
from repro_torch.optim.sgd import MomentumSGD, SgdState  # noqa: F401
