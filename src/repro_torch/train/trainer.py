"""Training loop (``repro.train.trainer``): metrics, timing, logging and
periodic checkpoints.

The data pipeline prefetches on a background thread (``data/pipeline.py``);
the train step runs eagerly; checkpoints are written on the host
(``checkpoint.ckpt``) under a ``ckpt_write`` span.  The loop's spans are
``step``, ``data_wait``, ``first_step`` and ``ckpt_write``; the train step
opens its own inside ``step`` (``forward``, ``backward``, ``clip``,
``update``, and the §3.4 update's ``reduce``, ``apply`` and ``broadcast``:
``train.train_step``, ``optim.dist``) on the recorder it was built with."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.telemetry.events import NULL_RECORDER


def _batch_items(batch) -> Tuple[int, str]:
    """(count, unit) of the work in one batch, for throughput: an LM batch
    counts its tokens (``tokens``, or an audio LM's ``codebook_labels``)
    and reports tok/s; the paper's vision and ASR batches carry no token
    tensor and count rows (samples/s)."""
    for key in ("tokens", "codebook_labels"):
        if key in batch:
            return int(batch[key].numel()), "tok"
    for v in batch.values():
        if v.dim():
            return int(v.shape[0]), "samples"
    return 0, "samples"


def _block(t: torch.Tensor) -> None:
    """Wait until ``t`` is computed (``jax.block_until_ready``)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0            # 0 = disabled
    ckpt_dir: Optional[str] = None
    ckpt_meta: Optional[dict] = None   # stored in the checkpoint manifest
    #                                    (the zero1 world layout, for a
    #                                    re-plan at another world size:
    #                                    checkpoint.replan)
    ckpt_gather: Optional[Dict[str, Callable]] = None  # per tree name, the
    #                                    collective that makes the tree's
    #                                    global value (ckpt.save's gather)
    recorder: Optional[Any] = None     # span/count recorder; every phase of
    #                                    the loop becomes a span (step,
    #                                    data_wait, first_step, ckpt_write).
    #                                    None = NULL_RECORDER (no-op).


@dataclass
class Trainer:
    train_step: Callable            # (params, opt_state, step, batch) -> ...
    cfg: TrainerConfig = field(default_factory=TrainerConfig)
    warm: bool = False              # True: train_step has run before — the
    #                                 first step is timed like any other

    def fit(self, params, opt_state, data_iter: Iterable,
            start_step: int = 0, log_fn=print):
        history = []
        rec = self.cfg.recorder if self.cfg.recorder is not None \
            else NULL_RECORDER
        sync = getattr(rec, "sync", False)
        t0 = time.perf_counter()
        t_first = 0.0
        items_seen, unit = 0, "samples"
        for step in range(start_step, self.cfg.total_steps):
            try:
                with rec.span("data_wait", step=step + 1):
                    batch = next(data_iter)
            except StopIteration:
                # finite source ran dry: end training with the progress made
                log_fn(f"data exhausted at step {step} "
                       f"(of {self.cfg.total_steps}); stopping")
                break
            first = step == start_step and not self.warm
            with rec.span("step", step=step + 1):
                params, opt_state, metrics = self.train_step(
                    params, opt_state, step, batch)
                if first:
                    # the first step builds the kernels and the libraries'
                    # handles: wait for it, report it apart, and restart the
                    # throughput clock so items/s counts later steps only
                    with rec.span("first_step", step=step + 1):
                        _block(metrics["loss"])
                elif sync:
                    # traced runs trade asynchronous launches for honest
                    # span durations; untraced runs never block here
                    _block(metrics["loss"])
            if first:
                t_first = time.perf_counter() - t0
                t0 = time.perf_counter()
            else:
                n, unit = _batch_items(batch)
                items_seen += n
                rec.count(f"items_{unit}", n)
            rec.count("steps")
            # the FINAL step always logs, so history[-1] is the end state
            if ((step + 1) % self.cfg.log_every == 0 or step == start_step
                    or step + 1 == self.cfg.total_steps):
                loss = float(metrics["loss"])
                gnorm = float(metrics["grad_norm"])
                dt = time.perf_counter() - t0
                rate = items_seen / dt if dt > 0 else 0.0
                tail = (f"first step {t_first:6.1f} s" if first
                        else f"{rate:9.0f} {unit}/s")
                log_fn(f"step {step + 1:5d}  loss {loss:8.4f}  "
                       f"gnorm {gnorm:7.3f}  "
                       f"lr {float(metrics['lr']):.2e}  {tail}")
                history.append(dict(step=step + 1, loss=loss,
                                    grad_norm=gnorm))
            if (self.cfg.ckpt_every and self.cfg.ckpt_dir
                    and (step + 1) % self.cfg.ckpt_every == 0):
                with rec.span("ckpt_write", step=step + 1):
                    ckpt_lib.save(self.cfg.ckpt_dir, step + 1,
                                  meta=self.cfg.ckpt_meta,
                                  gather=self.cfg.ckpt_gather,
                                  params=params, opt_state=opt_state)
        return params, opt_state, history
