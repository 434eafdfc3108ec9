"""Faults planted in the program underneath a run, for the tests that see
``correct`` come out false:

* ``unchanged``: a step that returns its state unchanged (the loss
  computed, no update);
* ``half_batch``: half of every batch left out, the mean taken over the
  rest;
* ``no_exchange``: the exchange between ranks left out (nothing
  received: the ring's hops deliver zeros).
"""
from __future__ import annotations

import contextlib


def _unchanged(orig):
    def step(self, batch, step_idx=0):
        return {"loss": self.loss_fn(self.params, batch).detach()}
    return step


def _half_batch(orig):
    def step(self, batch, step_idx=0):
        half = {k: v[:len(v) // 2] for k, v in batch.items()}
        return orig(self, half, step_idx)
    return step


@contextlib.contextmanager
def planted(fault):
    from repro_torch.api.run import Run
    from repro_torch.comm.backends import ring
    if fault is None:
        yield
        return
    if fault == "no_exchange":
        target, attr = ring, "_exchange"
        new = lambda send, recv, mesh, axes, shift=1: recv.zero_()  # noqa
    else:
        target, attr = Run, "step"
        new = {"unchanged": _unchanged, "half_batch": _half_batch}[fault](
            Run.step)
    old = getattr(target, attr)
    setattr(target, attr, new)
    try:
        yield
    finally:
        setattr(target, attr, old)
