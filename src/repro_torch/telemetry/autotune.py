"""``comm="auto"``: the §3.2 balance model with measured comm constants
(``repro.telemetry.autotune``).

The balance model (``core.balance``) predicts the optimal fusion-buffer
size as ``b* = sqrt(B * SWlat * BW * G)``.  Here SWlat and BW are measured:
before the optimizer strips are laid out (the zero1 strip layout depends
on the bucket plan, so the size is fixed before ``init_fn``;
``checkpoint.replan`` refuses a bucket change mid-run), the autotuner
drives the run's own collective schedule over the run's own mesh with one
reduce and broadcast roundtrip of a dummy buffer at each of several
candidate bucket sizes, fits

    t(bucket) = 2*(G-1)*SWlat + 2*(G-1)/G * bytes/BW

by least squares (``core.balance.ring_collective_time``'s form) and hands
the fitted constants to ``optimal_bucket_bytes``.  Each timed roundtrip is
a ``collective`` telemetry span and the chosen plan an ``autotune_plan``
event.

**What it measures here.**  Each probe is timed on the host clock between
two device synchronisations (``torch.cuda.synchronize`` on a card), so it
times the device's work, not the launch.  On a local mesh all G members sit
on one device, so the fit is of that device's memory traffic through the
ring kernels, not of a link between devices; on a process mesh it is of
the ranks' transport as this run uses it (over gloo, a card's messages go
through host memory).  The log line says which.

Every candidate (backend, wire_format) pair is probed on its own: the
roundtrip runs the schedule bound to that wire format (the int8 ring's
quantize and hop kernels under ``int8``, the bf16 cast under ``bf16``), and
its times are fitted per pair against the bucket's gradient bytes (the f32
fusion buffer the trainer packs).  A compressed format's cost and saving
are then in its own fitted constants, and each pair's bucket is the closed
form at those constants; the winner is the pair with the least predicted
wire time a step.  (The reference probes the dense roundtrip alone and
predicts the compressed formats from ``core.balance``'s bytes-on-wire
factor; on one card that factor points the wrong way, since its int8 ring
moves more device memory than the dense one.)  ``topk`` is never chosen: it is lossy and stateful (an
error-feedback residual), so it stays an explicit opt-in.

A pair is dropped before probing only where this mesh refuses it
(``core.collectives.refuses_plain_reduce``: the plain reduce-scatter of a
card's buffers over gloo); any other failure of a probe is a fault and
propagates, so that a kernel that fails to build or launch can never hand
the run to another backend.

On a process mesh every rank probes in lockstep (the same plan), and each
sample time is averaged over the ranks by one ``all_reduce``, so every rank
fits the same constants and picks the same plan: bucket plans that differ
across members would deadlock the first collective.

``cache_path`` (the cluster launcher exports ``ENV_AUTOTUNE_CACHE``, a file
in the run directory) persists the chosen plan keyed by the probe's inputs
(group size, axes, gradient bytes, candidate sets); a relaunch with the
same key skips the probes, and the elastic supervisor deletes the file when
the world size changes.  The cache file is the reference's, key for key.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.comm.bucketer import CommConfig, plan_buckets
from repro_torch.comm.schedule import group_axes, make_schedule, reduce_mean
from repro_torch.configs.base import HardwareConfig
from repro_torch.core.balance import optimal_bucket_bytes
from repro_torch.core.collectives import refuses_plain_reduce
from repro_torch.core.params import tree_leaves

# clamps for degenerate fits (a 1-member group, or noise driving the least
# squares negative): the constants stay positive and finite, so the closed
# form and the JSON of the plan event stay well defined
MIN_LATENCY_S = 1e-9
MAX_BANDWIDTH = 1e15

# the variable the cluster launcher sets on every worker: the path of the
# run's autotune plan cache
ENV_AUTOTUNE_CACHE = "REPRO_AUTOTUNE_CACHE"


@dataclass(frozen=True)
class CommProbe:
    """One timed roundtrip of one fusion buffer."""
    nbytes: int          # gradient bytes of the bucket (padded_size * 4)
    seconds: float       # best-of-reps time of reduce + broadcast
    backend: str
    wire_format: str = "fp32"


def measured_hw(sw_latency: float, link_bw: float,
                name: str = "measured") -> HardwareConfig:
    """A ``HardwareConfig`` carrying measured comm constants; the compute
    fields are placeholders (the bucket optimum never reads them)."""
    return HardwareConfig(name=name, peak_flops=1.0, mem_bw=1.0,
                          link_bw=max(link_bw, 1.0),
                          sw_latency=max(sw_latency, MIN_LATENCY_S))


def fit_comm_model(probes: Sequence[CommProbe],
                   G: int) -> Tuple[float, float]:
    """Least-squares (SWlat, BW) of per-bucket roundtrip times under the
    §3.2 ring model ``t = 2*(G-1)*SWlat + 2*(G-1)/G * nbytes/BW``; exact on
    times made from the model, clamped to stay physical on noisy ones."""
    if G <= 1 or not probes:
        return MIN_LATENCY_S, MAX_BANDWIDTH
    A = np.array([[2.0 * (G - 1), 2.0 * (G - 1) / G * p.nbytes]
                  for p in probes])
    y = np.array([p.seconds for p in probes])
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    lat = float(max(sol[0], MIN_LATENCY_S))
    inv_bw = float(max(sol[1], 1.0 / MAX_BANDWIDTH))
    return lat, min(1.0 / inv_bw, MAX_BANDWIDTH)


def choose_bucket_bytes(total_bytes: int, G: int, sw_latency: float,
                        link_bw: float, wire_format: str = "fp32",
                        topk_ratio: float = 0.05) -> int:
    """``optimal_bucket_bytes`` with measured constants (G <= 1: one
    whole-tree bucket).  ``wire_format`` applies the bytes-on-wire factor:
    a compressed reduce amortizes the latency over a larger bucket."""
    b = optimal_bucket_bytes(float(total_bytes), G,
                             measured_hw(sw_latency, link_bw),
                             wire_format=wire_format, topk_ratio=topk_ratio)
    return max(1, int(b))


def _cache_key(G, axes, total_bytes, backends, wire_formats) -> dict:
    return {"G": int(G), "axes": list(axes),
            "total_bytes": int(total_bytes),
            "backends": list(backends), "wire_formats": list(wire_formats)}


def _load_cached_plan(path: str, key: dict):
    """The persisted plan, or None on any miss (absent, corrupt, another
    key)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    return data.get("plan") if data.get("key") == key else None


def _save_cached_plan(path: str, key: dict, plan: dict) -> None:
    """Atomic write (tmp + rename): workers on one host may race."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump({"key": key, "plan": plan}, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass   # an unwritable cache only means probing again next launch


def _probe_sizes(params, G: int, total_bytes: int,
                 itemsize: int, max_sizes: int = 6) -> List[int]:
    """Distinct padded bucket sizes (elements) over a ladder of candidate
    bucket sizes.  The fit needs two distinct message sizes at least to
    separate latency from bandwidth, so a tree of one tensor gets a small
    synthetic buffer besides."""
    sizes = set()
    for divisor in (16, 4, 1):
        cand = max(total_bytes // divisor, itemsize)
        for b in plan_buckets(params, G, cand).buckets:
            sizes.add(b.padded_size)
    if len(sizes) < 2:
        # ~1/32 of the largest buffer, rounded up to a multiple of G (the
        # padding every real bucket has)
        small = max(-(-(max(sizes) // 32) // G) * G, G)
        sizes.add(small)
    ranked = sorted(sizes)
    if len(ranked) > max_sizes:
        idx = np.linspace(0, len(ranked) - 1, max_sizes).astype(int)
        ranked = [ranked[i] for i in sorted(set(idx.tolist()))]
    return ranked


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _runs_here(mesh, axis_arg, base: CommConfig, backend: str,
               wire_format: str) -> bool:
    """False where this mesh refuses the probe's schedule: the plain
    (``lax``) dense reduce-scatter at a level whose group is a gloo group
    of ranks on a card (``core.collectives.part_reduce`` refuses it).  The
    candidate backend drives the flat ring or the in-pod level; the
    cross-pod hop is the base's own, which the run takes either way."""
    if backend != "lax" or wire_format in ("int8", "topk"):
        return True
    two_level = (base.hierarchical and not isinstance(axis_arg, str)
                 and len(axis_arg) == 2)
    return not refuses_plain_reduce(mesh, axis_arg[1] if two_level
                                    else axis_arg)


def _time_backend(mesh, axis_arg, base: CommConfig, backend: str,
                  wire_format: str, G: int, sizes: Sequence[int], reps: int,
                  recorder) -> List[CommProbe]:
    """Best-of-``reps`` roundtrip time per buffer size of one (backend,
    wire format) pair: the wire path ``optim.dist.UpdatePlan`` drives (the
    schedule bound to the format, the reduce in its wire dtype, the mean,
    the broadcast), minus the optimizer, on a replicated f32 dummy buffer.
    A first untimed call per size builds the kernels; each timed rep lies
    between two device synchronisations and is a ``collective`` span."""
    wire = torch.bfloat16 if wire_format == "bf16" else torch.float32
    sched = make_schedule(mesh, axis_arg, base.hierarchical, backend,
                          base.cross_backend, step=0,
                          wire_format=wire_format,
                          topk_ratio=base.topk_ratio)
    dev = mesh.device
    probes = []
    for n in sizes:
        buf = mesh.replicated(torch.zeros(int(n), dtype=torch.float32,
                                          device=dev))

        def roundtrip():
            return sched.broadcast(reduce_mean(sched, buf, wire, G))

        roundtrip()
        best = float("inf")
        for r in range(reps):
            with recorder.span("collective", phase="autotune-probe",
                               backend=backend, wire_format=wire_format,
                               elements=int(n), nbytes=int(n) * 4, rep=r):
                _sync(dev)
                t0 = time.perf_counter()
                roundtrip()
                _sync(dev)
                best = min(best, time.perf_counter() - t0)
        probes.append(CommProbe(nbytes=int(n) * 4, seconds=best,
                                backend=backend, wire_format=wire_format))
    return probes


def _sync_times(probes: List[CommProbe], mesh) -> List[CommProbe]:
    """On a mesh over ranks (a process or cluster mesh), each probe's time
    averaged over the ranks (one ``all_reduce``), so that every rank fits
    the same constants."""
    if mesh.n_ranks <= 1:
        return probes
    import torch.distributed as dist
    pg, ranks = mesh.group(mesh.axis_names)
    dev = mesh.device if dist.get_backend(pg) == "nccl" else "cpu"
    t = torch.tensor([p.seconds for p in probes], dtype=torch.float64,
                     device=dev)
    dist.all_reduce(t, group=pg)
    mean = (t / len(ranks)).cpu().tolist()
    return [dataclasses.replace(p, seconds=float(s))
            for p, s in zip(probes, mean)]


def _measured_what(mesh) -> str:
    """What the fit on ``mesh`` measures, for every line that prints it."""
    import torch.distributed as dist
    if mesh.pod_across_ranks:
        return (f"in each pod the device memory traffic of {mesh.local} "
                f"members on one {mesh.device.type} device, not a link; "
                f"across pods the {dist.get_backend()} transport of "
                f"{mesh.n_ranks} ranks as this run uses it")
    if mesh.member_dims:
        return (f"device memory traffic of {mesh.size} members on one "
                f"{mesh.device.type} device, not a link")
    return (f"the {dist.get_backend()} transport of {mesh.size} ranks on "
            f"{mesh.device.type} as this run uses it")


def autotune_comm(params, mesh, data_axes, base: CommConfig,
                  recorder=None, backends: Optional[Sequence[str]] = None,
                  reps: int = 2, log=print,
                  wire_formats: Optional[Sequence[str]] = None,
                  cache_path: Optional[str] = None) -> CommConfig:
    """Measure, fit, choose: ``base`` with ``bucket_bytes`` (and possibly
    ``backend`` and ``wire_format``) replaced by the measured best plan.

    ``backends`` is the candidate set (the mode's ``MODE_CAPS.backends``)
    and ``wire_formats`` the mode's formats, ``topk`` left out;
    ``base.backend`` and ``base.wire_format`` are candidates too.  Each
    pair this mesh can run is probed and fitted on its own (module
    docstring).  ``cache_path`` skips the probes when a persisted plan's
    key matches this launch."""
    from repro_torch.telemetry.events import NULL_RECORDER
    recorder = recorder if recorder is not None else NULL_RECORDER
    axes, axis_arg, G = group_axes(mesh, data_axes)
    leaves = tree_leaves(params)
    wire_itemsize = torch.empty((), dtype=base.wire_dtype).element_size()
    total_bytes = sum(x.numel() for x in leaves) * wire_itemsize
    # the bytes the bucket planner counts, which each pair's fit is of
    grad_bytes = sum(x.numel() * x.element_size() for x in leaves)
    sizes = _probe_sizes(params, G, total_bytes, wire_itemsize)
    what = _measured_what(mesh)

    candidates = [base.backend]
    for b in backends or ():
        if b not in candidates:
            candidates.append(b)
    formats = [base.wire_format]
    for fmt in wire_formats or ():
        if fmt != "topk" and fmt not in formats:
            formats.append(fmt)

    key = _cache_key(G, axes, total_bytes, candidates, formats)
    if cache_path:
        plan = _load_cached_plan(cache_path, key)
        if plan is not None:
            comm = dataclasses.replace(
                base, bucket_bytes=int(plan["bucket_bytes"]),
                backend=plan["chosen_backend"],
                wire_format=plan["chosen_wire_format"])
            recorder.event("autotune_plan", group=G, cached=True,
                           total_bytes=int(total_bytes), probes=0, **plan)
            log(f"comm=auto: cached plan ({cache_path}) -> "
                f"bucket_bytes={comm.bucket_bytes} backend={comm.backend} "
                f"wire_format={comm.wire_format} (fit of {what})")
            return comm

    pairs = [(b, f) for b in candidates for f in formats
             if _runs_here(mesh, axis_arg, base, b, f)]
    skipped = [(b, f) for b in candidates for f in formats
               if (b, f) not in pairs]
    if not pairs:
        raise ValueError(
            f"comm='auto': this mesh refuses every candidate {skipped} (the "
            "plain reduce-scatter of a card's buffers over gloo); add "
            "pallas-ring to the candidate backends")
    if skipped:
        log(f"comm=auto: not probed, refused on this mesh (the plain "
            f"reduce-scatter of a card's buffers over gloo): {skipped}")
    plans = {}
    all_probes: List[CommProbe] = []
    for backend, fmt in pairs:
        probes = _sync_times(_time_backend(
            mesh, axis_arg, base, backend, fmt, G, sizes, reps, recorder),
            mesh)
        for p in probes:
            log(f"comm=auto: probe backend={backend} wire_format={fmt} "
                f"bytes={p.nbytes} best of {reps}: {p.seconds * 1e3:.6f} ms "
                f"({what})")
        all_probes.extend(probes)
        # the pair's measured constants and its bucket at them: the
        # format's bytes on the wire, and its kernels' cost, are in the
        # fit, so the closed form takes them as a dense ring's
        lat, bw = fit_comm_model(probes, G)
        b_star = choose_bucket_bytes(grad_bytes, G, lat, bw)
        n_coll = plan_buckets(params, G, b_star).n_collectives
        t_pred = (n_coll * 2.0 * (G - 1) * lat
                  + 2.0 * (G - 1) / G * grad_bytes / bw) if G > 1 else 0.0
        plans[(backend, fmt)] = {
            "sw_latency_s": lat, "link_bw_Bps": bw,
            "bucket_bytes": b_star, "n_collectives": n_coll,
            "predicted_s": t_pred}
        log(f"comm=auto: fit backend={backend} wire_format={fmt}: "
            f"SWlat={lat:.6e} s BW={bw:.6e} B/s of gradient bytes ({what}) "
            f"-> bucket_bytes={b_star}, {n_coll} collectives, predicted "
            f"{t_pred * 1e3:.6f} ms a step")

    winner = min(plans, key=lambda k: (plans[k]["predicted_s"],
                                       k[0] != base.backend,
                                       k[1] != base.wire_format))
    w_backend, w_fmt = winner
    chosen = dict(plans[winner], chosen_backend=w_backend,
                  chosen_wire_format=w_fmt)
    comm = dataclasses.replace(base, bucket_bytes=chosen["bucket_bytes"],
                               backend=w_backend, wire_format=w_fmt)
    if cache_path:
        _save_cached_plan(cache_path, key, chosen)
    recorder.event("autotune_plan", group=G, total_bytes=int(total_bytes),
                   probes=len(all_probes),
                   backends=sorted({b for b, _ in plans}),
                   wire_formats=list(formats), measured=what,
                   fits={f"{b}/{f}": [v["sw_latency_s"], v["link_bw_Bps"],
                                      v["predicted_s"]]
                         for (b, f), v in plans.items()}, **chosen)
    log(f"comm=auto: G={G} fitted SWlat={chosen['sw_latency_s']:.6e} s "
        f"BW={chosen['link_bw_Bps'] / 2 ** 30:.6f} GiB/s over "
        f"{len(all_probes)} collective probes of {len(plans)} (backend, "
        f"wire format) pairs ({what}) -> "
        f"bucket_bytes={chosen['bucket_bytes']} "
        f"({chosen['bucket_bytes'] / 2 ** 20:.2f} MiB, "
        f"{chosen['n_collectives']} collectives) backend={w_backend} "
        f"wire_format={w_fmt}")
    return comm
