"""The executable product of ``compile_run`` (``repro.api.run``): params,
state, step, data, fit.

A :class:`Run` owns what a training loop needs, already assembled and on
its device: the ``train_step``, the ``params`` and ``opt_state``, a lazily
started prefetching ``data`` iterator, and ``fit()``.  The reference's
``jit_step`` (one jit cache, buffers donated) becomes the eager
``train_step``, which updates ``params`` and ``opt_state`` in place.
Under ``parallel="zero1"`` the run carries its member ``mesh``, its
``comm`` and the ``dist_update`` its train step calls, and ``opt_state``
is the strip state.  Checkpoint restore is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.data.pipeline import Prefetcher, make_placer
from repro_torch.train.trainer import Trainer, TrainerConfig


@dataclass
class Run:
    """An assembled training run.  ``fit`` and ``step`` advance
    ``params`` and ``opt_state`` in place."""
    spec: Any                       # the RunSpec this run was compiled from
    cfg: Any                        # resolved (possibly smoke) family config
    family: Any                     # FamilyAdapter
    device: torch.device
    loss_fn: Callable
    optimizer: Any
    lr_schedule: Callable
    train_step: Callable            # (params, opt_state, step, batch) -> ...
    params: Any
    opt_state: Any
    mesh: Optional[Any] = None      # launch.mesh.LocalMesh; None for serial
    comm: Optional[Any] = None      # the CommConfig of the zero1 update
    dist_update: Optional[Callable] = None  # optim.dist update_fn (zero1)
    telemetry: Optional[Any] = None  # recorder of the trainer's spans and
    #                                  counts; None = no-op
    _data: Optional[Prefetcher] = field(default=None, repr=False)
    _warm: bool = field(default=False, repr=False)  # train_step ran once

    @property
    def data(self) -> Prefetcher:
        """Background-prefetching batch iterator over the family's seeded
        stream, each batch placed on the run's device.  Created on first
        access (so compiling a Run never starts threads)."""
        if self._data is None:
            s = self.spec
            stream = self.family.stream(self.cfg, s.batch, s.seq, s.seed)
            self._data = Prefetcher(stream, place=make_placer(self.device))
        return self._data

    def step(self, batch, step_idx: int = 0):
        """Run one train step on an explicit batch; advances the run's
        params and opt_state and returns the metrics dict."""
        self.params, self.opt_state, metrics = self.train_step(
            self.params, self.opt_state, step_idx, batch)
        self._warm = True
        return metrics

    def fit(self, start_step: Optional[int] = None, log_fn=print):
        """Train from ``start_step`` (default 0) to ``spec.steps``; returns
        the metrics history (the first and the final step always log)."""
        s = self.spec
        tcfg = TrainerConfig(total_steps=s.steps, log_every=s.log_every,
                             ckpt_every=s.ckpt_every, ckpt_dir=s.ckpt_dir,
                             recorder=self.telemetry)
        start_step = 0 if start_step is None else start_step
        if start_step >= s.steps:
            return []
        trainer = Trainer(self.train_step, tcfg, warm=self._warm)
        self.params, self.opt_state, history = trainer.fit(
            self.params, self.opt_state, self.data, start_step=start_step,
            log_fn=log_fn)
        if history:
            # the first executed step always logs, so a non-empty history
            # means train_step really ran
            self._warm = True
        return history

    def close(self):
        if self._data is not None:
            self._data.close()
            self._data = None

    def __enter__(self) -> "Run":
        return self

    def __exit__(self, *exc):
        self.close()
