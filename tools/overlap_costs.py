"""Where the §3.1 overlapped zero1 step's time goes on the card, against the
monolithic step's.

    python3 tools/overlap_costs.py

For full-width CD-DNN (batch 1024) and VGG-A (batch 64), G = 4 members on
the card, ``pallas-ring``, every forward product or conv on its kernel:

- the monolithic and the overlapped step alternating on one batch (9
  pairs, the first a warm-up): each's step time (the device synchronised
  before and after), its host issue time (the step's call returning) and
  the taps' host time inside it;
- one step of each under ``torch.profiler``: kernels and busy ms per
  stream, the device timeline from the first kernel to the last, and the
  ms of the side stream's kernels that ran beside another stream's;
- the backward's host issue time (``autograd.grad`` returning) with
  the taps doing nothing, doing the pack and reduce on the compute
  stream, and doing them on the side stream as ``comm.overlap`` does, with
  the host ms of each piece inside the taps; and the same pieces for the
  14 buckets from the main thread.

Needs one sm_90 card; prints the card's name and power limit first.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.comm import CommConfig, overlap  # noqa: E402
from repro_torch.comm.bucketer import pack_bucket, plan_buckets  # noqa: E402
from repro_torch.comm.schedule import make_schedule, reduce_mean  # noqa: E402
from repro_torch.core.params import tree_leaves  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.paper_cnn_training import use_kernel  # noqa: E402

PAIRS = 9
REPS = 20


def stream_table(fn):
    """Per stream (kernels, busy ms) and the device timeline in ms of one
    call of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    ks = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    per = {}
    for e in ks:
        n, busy = per.get(e["args"].get("stream"), (0, 0.0))
        per[e["args"].get("stream")] = (n + 1, busy + e["dur"] / 1e3)
    span = (max(e["ts"] + e["dur"] for e in ks)
            - min(e["ts"] for e in ks)) / 1e3
    return per, span


def tapped_grad(run, params, batch, sched, plan, mode, acc):
    """One backward through taps on every bucket whose backward does
    nothing (``none``), the pack and reduce on the compute stream
    (``current``) or on the side stream as ``comm.overlap`` does
    (``side``), adding each piece's host seconds to ``acc``; returns the
    host seconds until ``autograd.grad`` returned."""
    dev = batch[next(iter(batch))].device
    stream = overlap.comm_stream(dev)
    flat = tree_leaves(params)

    def issuer(bucket):
        def issue(cts):
            if mode == "none":
                return
            t = time.perf_counter()

            def tick(k):
                nonlocal t
                now = time.perf_counter()
                acc[k] = acc.get(k, 0.0) + now - t
                t = now
            if mode == "side":
                stream.wait_stream(torch.cuda.current_stream(dev))
                tick("wait_stream")
                ctx = torch.cuda.stream(stream)
                ctx.__enter__()
                tick("stream switch")
            buf = pack_bucket({s.index: c for s, c in zip(bucket.slots, cts)},
                              bucket)
            tick("pack")
            reduce_mean(sched, run.mesh.replicated(buf), torch.float32, 4)
            tick("reduce")
            if mode == "side":
                ctx.__exit__(None, None, None)
                for c in cts:
                    c.record_stream(stream)
                tick("switch back, record")
        return issue

    anchor = torch.zeros((), device=dev, requires_grad=True)
    tapped = list(flat)
    for b, bucket in enumerate(plan.buckets):
        outs = overlap._BucketTap.apply(issuer(bucket), anchor,
                                        *(flat[s.index] for s in bucket.slots))
        outs = outs if isinstance(outs, tuple) else (outs,)
        outs[0].grad_fn._set_sequence_nr(
            overlap._TOP_PRIORITY - (plan.n_collectives - 1 - b))
        for s, leaf in zip(bucket.slots, outs):
            tapped[s.index] = leaf
    it = iter(tapped)
    loss = run.loss_fn({k: next(it) for k in sorted(params)}, batch)
    t0 = time.perf_counter()
    torch.autograd.grad(loss, anchor, allow_unused=True)
    return time.perf_counter() - t0


def one_model(arch, batch_size, lr, card):
    spec = RunSpec(arch=arch, batch=batch_size, lr=lr, schedule="constant",
                   seed=0, steps=2, parallel="zero1",
                   mesh=MeshSpec(members_per_device=4),
                   comm=CommConfig(backend="pallas-ring", overlap=True))
    run = use_kernel(compile_run(spec))
    batch = next(run.data)
    steps = {"monolithic": cs._monolithic_step(run, spec.grad_clip),
             "overlap": run.train_step}
    taps = []
    real = overlap._BucketTap.backward

    def timed(ctx, *cts):
        t0 = time.perf_counter()
        out = real(ctx, *cts)
        taps.append(time.perf_counter() - t0)
        return out

    overlap._BucketTap.backward = staticmethod(timed)
    got = {k: {"step": [], "issue": [], "taps": []} for k in steps}
    try:
        for rep in range(PAIRS):
            for name in list(steps)[::1 if rep % 2 == 0 else -1]:
                torch.cuda.synchronize()
                taps.clear()
                t0 = time.perf_counter()
                run.params, run.opt_state, _ = steps[name](
                    run.params, run.opt_state, 0, batch)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                if rep:
                    got[name]["step"].append((time.perf_counter() - t0) * 1e3)
                    got[name]["issue"].append((t1 - t0) * 1e3)
                    got[name]["taps"].append(sum(taps) * 1e3)
    finally:
        overlap._BucketTap.backward = staticmethod(real)
    for name, r in got.items():
        print(f"{arch} {name}: step {np.median(r['step'])} ms, host issue "
              f"{np.median(r['issue'])} ms, the taps' host "
              f"{np.median(r['taps'])} ms (medians of {PAIRS - 1}) [{card}]")
    for name, step in steps.items():
        per, span = stream_table(
            lambda: step(run.params, run.opt_state, 0, batch))
        print(f"  {arch} {name} under torch.profiler: device timeline {span} "
              f"ms; per stream (kernels, busy ms) {per}")
    side = cs._stream_overlap(
        lambda: steps["overlap"](run.params, run.opt_state, 0, batch))
    print(f"  {arch} overlap: side stream (kernels, beside a compute kernel, "
          f"ms, ms beside) {None if side is None else side['all']}")
    plan = plan_buckets(run.params, 4, 4 * 2 ** 20)
    sched = make_schedule(run.mesh, "data", backend="pallas-ring",
                          wire_format="fp32")
    params = {k: v.detach() for k, v in run.params.items()}
    for mode in ("none", "current", "side"):
        acc = {}
        for _ in range(3):
            tapped_grad(run, params, batch, sched, plan, mode, acc)
        torch.cuda.synchronize()
        acc.clear()
        ts = [tapped_grad(run, params, batch, sched, plan, mode, acc)
              for _ in range(REPS)]
        torch.cuda.synchronize()
        print(f"  {arch} backward, taps {mode}: autograd.grad host "
              f"{np.median(ts) * 1e3} ms; inside the taps a step "
              f"{ {k: v / REPS * 1e3 for k, v in acc.items()} } ms")
    flat = [torch.randn_like(v) for v in tree_leaves(params)]
    for mode in ("current", "side"):
        acc = {}
        stream = overlap.comm_stream(run.device)
        for _ in range(REPS):
            for bucket in plan.buckets:
                t = time.perf_counter()
                cts = [flat[s.index] for s in bucket.slots]
                if mode == "side":
                    stream.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(stream):
                        buf = pack_bucket(dict(zip(
                            [s.index for s in bucket.slots], cts)), bucket)
                        reduce_mean(sched, run.mesh.replicated(buf),
                                    torch.float32, 4)
                    for c in cts:
                        c.record_stream(stream)
                else:
                    buf = pack_bucket(dict(zip(
                        [s.index for s in bucket.slots], cts)), bucket)
                    reduce_mean(sched, run.mesh.replicated(buf),
                                torch.float32, 4)
                acc["pack + reduce"] = acc.get("pack + reduce", 0.0) \
                    + time.perf_counter() - t
        torch.cuda.synchronize()
        print(f"  {arch} the same {plan.n_collectives} buckets "
              f"from the main thread, {mode} stream: "
              f"{acc['pack + reduce'] / REPS * 1e3} ms a step")
    run.close()


def main():
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(build.load, ("conv2d", "ring", "ring_wire",
                                   "blocked_matmul")))
    card = cs.card_line()
    print(f"{card}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one_model("cd-dnn", 1024, 0.1, card)
    torch.cuda.empty_cache()
    one_model("vgg-a", 64, 5e-3, card)


if __name__ == "__main__":
    main()
