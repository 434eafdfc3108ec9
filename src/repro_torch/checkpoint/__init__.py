"""Checkpoints of the port (``repro.checkpoint``): the reference's file
format (``ckpt``) and the zero1 strip re-plan across world sizes
(``replan``)."""
from repro_torch.checkpoint import ckpt, replan  # noqa: F401
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    latest_step,
    read_manifest,
    restore,
    restore_loose,
    save,
)
from repro_torch.checkpoint.replan import (  # noqa: F401
    replan_strip_leaf,
    replan_strip_state,
    world_meta,
)
