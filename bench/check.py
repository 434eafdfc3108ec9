"""How ``correct`` is decided: the program's first three steps against
the plain reference's, from the same parameters on the same batches.

Three numbers are compared, each by the worst case:

* ``loss_gap``: each step's loss, |program - reference| / |reference|;
* ``grad_gap``: each leaf's norm of the first gradient as the optimizer
  gets it (clipped), worked out from the state after one step as
  ||p1 - p0|| / lr (momentum SGD starts from a zero velocity, so the
  first step moves each leaf by lr times that gradient);
* ``change_gap``: each leaf's norm of the parameters' change after three
  steps, ||p3 - p0||;
* ``grad_gap_median``: the median leaf's gap of the first gradient.

A leaf's gap is |program norm - reference norm| over the reference's norm
of that leaf or of the median leaf, whichever is larger.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of the leaf gaps.  The worst leaf's gap catches a fault in one layer;
the median leaf's is steady from seed to seed, where the worst leaf's
swings with the noise of one small leaf (VGG-A's first convolution, whose
gradient moves with every flip of a ReLU or a max-pool's choice upstream),
and so it is the number that tells the precision below f32 from f32.

The reference (:func:`reference_readings`) is plain PyTorch: autograd of
the family reference's loss, the global-norm clip and momentum SGD,
written out here; it imports nothing of the program.
"""
from __future__ import annotations

import contextlib
import math
import statistics
from dataclasses import dataclass

import torch

CHECK_STEPS = 3
SMALL_LEAF = 1e-3        # of the median leaf's reference gradient
NOT_FINITE = 1e38        # what a gap that is not a number is printed as


@dataclass
class Readings:
    losses: list         # each step's loss
    grad: dict           # leaf -> ||p1 - p0|| / lr
    change: dict         # leaf -> ||p3 - p0||


@torch.no_grad()
def leaf_norms(params: dict, start: dict, scale: float = 1.0) -> dict:
    """leaf -> ||params - start|| * scale, read in one transfer."""
    keys = sorted(start)
    norms = torch.stack([torch.linalg.vector_norm(params[k].float()
                                                  - start[k].float())
                         for k in keys]).tolist()
    return {k: v * scale for k, v in zip(keys, norms)}


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuBLAS and cuDNN on (the control) or off, restored after."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    old = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = on
    try:
        yield
    finally:
        for f, o in zip(flags, old):
            f.allow_tf32 = o


def reference_readings(loss_fn, cfg: dict, params: dict, batches: list,
                       opt: dict, use_tf32: bool = False,
                       rows: int = None) -> Readings:
    """The reference's :class:`Readings` over ``batches`` from ``params``
    (left unchanged).  ``use_tf32`` computes it in TF32, the control;
    ``rows`` keeps only each batch's first rows (a planted fault)."""
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    keys = sorted(p)
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    lr, mom, clip = opt["lr"], opt["momentum"], opt["grad_clip"]
    wd = opt.get("weight_decay", 0.0)
    losses, grad = [], None
    with tf32(use_tf32):
        for step, batch in enumerate(batches):
            if rows is not None:
                batch = {k: v[:rows] for k, v in batch.items()}
            loss = loss_fn(p, cfg, batch)
            grads = torch.autograd.grad(loss, [p[k] for k in keys])
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                                       for g in grads))
                scale = (torch.clamp(clip / torch.clamp(gnorm, min=1e-9),
                                     max=1.0) if clip > 0 else 1.0)
                for k, g in zip(keys, grads):
                    v = vel[k].mul_(mom).add_(g * scale)
                    if wd:
                        v.add_(p[k], alpha=wd)
                    p[k].sub_(v, alpha=lr)
            losses.append(loss.item())
            if step == 0:
                grad = leaf_norms(p, params, 1.0 / lr)
        change = leaf_norms(p, params)
    return Readings(losses, grad, change)


def _finite(x: float) -> float:
    return x if math.isfinite(x) else NOT_FINITE


def _worst(gaps) -> float:
    """The largest gap; one that is not a number counts as infinite."""
    return max(g if g == g else math.inf for g in gaps)


def leaf_gaps(got: Readings, ref: Readings) -> dict:
    """"grad" and "change" -> leaf -> its gap, for the leaves compared."""
    med = statistics.median(ref.grad.values())
    keep = [k for k, v in ref.grad.items() if v >= SMALL_LEAF * med]
    out = {}
    for name in ("grad", "change"):
        a, b = getattr(got, name), getattr(ref, name)
        floor = statistics.median(b[k] for k in keep)
        out[name] = {k: abs(a[k] - b[k]) / max(b[k], floor) for k in keep}
    return out


def compare(got: Readings, ref: Readings) -> dict:
    """name -> its gap (module docstring)."""
    loss_gap = _worst(abs(a - b) / abs(b) if b else abs(a - b)
                      for a, b in zip(got.losses, ref.losses))
    leaves = leaf_gaps(got, ref)
    return {"loss_gap": _finite(loss_gap),
            "grad_gap": _finite(_worst(leaves["grad"].values())),
            "change_gap": _finite(_worst(leaves["change"].values())),
            "grad_gap_median": _finite(statistics.median(
                g if g == g else math.inf for g in leaves["grad"].values()))}


def verdict(gaps: dict, limits: dict) -> dict:
    """name -> {"value", "limit"} for each number compared."""
    return {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
