"""LR schedules (``repro.optim.schedule``): step index -> learning rate, a
Python float computed in f32 as the reference computes it."""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def constant(lr: float):
    return lambda step: float(_f32(lr))


def _cosine(peak, step, warmup_steps, total_steps, final_frac):
    prog = np.clip((step - _f32(warmup_steps))
                   / _f32(max(total_steps - warmup_steps, 1)),
                   _f32(0), _f32(1))
    return peak * (_f32(final_frac) + _f32(1 - final_frac) * _f32(0.5)
                   * (_f32(1) + np.cos(_f32(np.pi) * prog)))


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup from 0 over ``warmup_steps``, then cosine decay to
    ``final_frac`` of ``peak_lr`` at ``total_steps``."""
    def sched(step):
        step = _f32(step)
        if step < warmup_steps:
            return float(_f32(peak_lr) * step / _f32(max(warmup_steps, 1)))
        return float(_cosine(_f32(peak_lr), step, warmup_steps, total_steps,
                             final_frac))
    return sched


def linear_scale_warmup(base_lr: float, scale: float, warmup_steps: int,
                        total_steps: int, final_frac: float = 0.1):
    """Goyal et al.'s large-batch recipe: the peak is ``base_lr * scale``
    (the data-parallel ways), reached by a linear ramp from ``base_lr``
    over ``warmup_steps``, then cosine decay toward ``final_frac`` of the
    peak.  ``scale == 1`` is the unscaled baseline."""
    peak = _f32(base_lr * float(scale))

    def sched(step):
        step = _f32(step)
        if step < warmup_steps:
            frac = np.clip(step / _f32(max(warmup_steps, 1)), _f32(0),
                           _f32(1))
            return float(_f32(base_lr) + (peak - _f32(base_lr)) * frac)
        return float(_cosine(peak, step, warmup_steps, total_steps,
                             final_frac))
    return sched
