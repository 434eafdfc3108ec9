"""Multi-process launcher of the port (``repro.launch.cluster``):
``python -m repro_torch.launch.cluster --processes N ...``.

One module, two roles, told apart by the cluster environment variables:

* **supervisor** (how you invoke it): parses the run flags of
  ``repro_torch.launch.train`` plus the cluster knobs, and hands the whole
  argv to :func:`repro_torch.cluster.elastic.run_elastic`, which spawns N
  worker processes and supervises them: a dead worker shrinks the world and
  the run resumes from the latest checkpoint at the new size.

* **worker** (how the launcher runs it again, told by
  ``REPRO_PROCESS_ID``): joins the process group (NCCL, or gloo where
  ranks share a card or run on the CPU: ``cluster.spec.initialize``) of the
  :class:`~repro_torch.cluster.spec.ClusterSpec` in its environment,
  compiles the run with ``MeshSpec(cluster=True)`` (the pod axis is the
  process boundary; each process holds ``--local-devices`` members on its
  device, ``--model-ways`` of them a data group: ``launch.mesh.
  ClusterMesh``) and trains, beating its heartbeat every step.

    # the paper's §3.4 update over 2 processes on the card (zero1 on the
    # pallas-ring backend at both levels, the cluster's default)
    python -m repro_torch.launch.cluster --processes 2 --arch vgg-a \\
        --smoke --steps 8 --ckpt-dir /tmp/vgg-cluster

    # bounded staleness, and the gossip partner exchange, each held to one
    # process by --verify
    python -m repro_torch.launch.cluster --processes 2 --arch vgg-a \\
        --smoke --steps 3 --parallel stale-sync --verify
    python -m repro_torch.launch.cluster --processes 2 --arch vgg-a \\
        --smoke --steps 3 --parallel gossip --verify

    # chaos: SIGKILL worker 1 at step 3 and watch the recovery, on the CPU
    python -m repro_torch.launch.cluster --processes 2 --arch vgg-a \\
        --smoke --steps 8 --ckpt-dir /tmp/vgg-chaos --chaos-kill-step 3 \\
        --device cpu

    # the paper's §3.3 composition: 2 members a process, one model group of
    # 2 ways each, data parallel across the processes (mesh (2, 1, 2))
    python -m repro_torch.launch.cluster --processes 2 --local-devices 2 \\
        --model-ways 2 --arch vgg-a --smoke --steps 3 --verify --device cpu

``--verify`` also trains the same spec in one process in the supervisor and
fails unless the final losses agree within ``VERIFY_TOL``: the §3.4
strip update does not depend on G, so a multi-process run must land on the
one-process trajectory."""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import traceback

from repro_torch.cluster.launcher import (
    ENV_HEARTBEAT_FILE,
    ENV_RESULT_FILE,
    make_heartbeat_listener,
)
from repro_torch.cluster.spec import (
    ClusterSpec,
    in_worker,
    initialize,
    ranks_share_cards,
)

# |cluster loss - one-process loss| tolerance for --verify, the reference's:
# the update does not depend on G in exact arithmetic, so in f32 the runs
# part only by the order of the sums (the batch split over ranks)
VERIFY_TOL = 5e-3


def resolve_comm_backends(args) -> None:
    """Fill the backend flags a cluster's command line leaves unset from
    the mode's cluster default (``api.assemble.default_comm``) where that
    default is the two-level schedule (zero1, stale-sync: pallas-ring at
    both levels, whose hops add on the card; the plain reduce-scatter over
    gloo would sum a card's buffers in host memory, and
    ``core.collectives.part_reduce`` refuses it), so that explicit comm
    flags keep the ring.  Gossip's flat default, and the whole config under
    ``--comm auto``, are ``compile_run``'s."""
    from repro_torch.api import MODE_CAPS
    from repro_torch.api.assemble import default_comm
    d = default_comm(args.parallel, cluster=True)
    if (MODE_CAPS[args.parallel].comm and d.hierarchical
            and getattr(args, "comm", None) != "auto"):
        args.comm_backend = args.comm_backend or d.backend
        args.cross_backend = args.cross_backend or d.cross_backend
    else:
        args.comm_backend = args.comm_backend or "lax"


def check_cluster_args(ap: argparse.ArgumentParser, args) -> None:
    """Refuse, before any worker starts, the plain sums of card buffers
    over gloo at the pod level, the one that crosses the processes (the
    cross-pod reduce-scatter on lax, dp's and zero1-gspmd's gradient sums):
    every worker would raise in its first step and the supervisor would
    shrink the world until one process, which sums nothing, trains
    alone."""
    import torch
    from repro_torch.api import MODE_CAPS
    from repro_torch.api.assemble import default_comm
    if args.local_devices < 1:
        ap.error("--local-devices must be >= 1")
    shared = (args.processes > 1
              and torch.device(args.device or "cuda").type == "cuda"
              and ranks_share_cards(args.processes))
    if shared and args.parallel in ("dp", "zero1-gspmd"):
        ap.error(f"--parallel {args.parallel} would all-reduce the card's "
                 "gradients over gloo in host memory at the pod level, "
                 "between the processes; when ranks share a card run zero1 "
                 "on pallas-ring (the default)")
    if (args.processes > 1 and MODE_CAPS[args.parallel].comm
            and default_comm(args.parallel, cluster=True).hierarchical
            and args.cross_backend == "lax"
            and args.wire_format not in ("int8", "topk")
            and torch.device(args.device or "cuda").type == "cuda"
            and ranks_share_cards(args.processes)):
        ap.error("--cross-backend lax would reduce-scatter the card's "
                 "buffers over gloo in host memory at the pod level, "
                 "between the processes; when ranks share a card the "
                 f"cluster's {args.parallel} takes --cross-backend "
                 "pallas-ring (the default)")


def _leave(code: int, grouped: bool) -> None:
    """End a worker: wait for every rank (gloo's own teardown has aborted a
    rank that had already finished), flush, and exit without the
    interpreter's teardown."""
    if grouped:
        import torch.distributed as dist
        dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def worker_main(args) -> int:
    """One cluster member: join the group, compile, train, report."""
    spec = ClusterSpec.from_env()
    group = initialize(spec, args.device)
    rank = spec.process_id
    if rank == 0:
        print(f"cluster: {group}", flush=True)
    from repro_torch.launch.train import compile_from_args, record_launches

    run = compile_from_args(args, cluster=True)
    if rank == 0:
        shape = getattr(run.mesh, "shape", {})
        print(f"cluster: {spec.num_processes} processes x "
              f"{spec.local_devices} members on {run.device} (local "
              f"devices L={spec.local_devices}, model ways "
              f"M={shape.get('model', 1)}); mesh={run.mesh}  "
              f"parallel={run.spec.parallel}  comm={run.comm}  "
              f"kernel={args.use_kernel}", flush=True)
    hb = os.environ.get(ENV_HEARTBEAT_FILE)
    if hb:
        # the heartbeat rides the trainer's "step" span: compile_run always
        # builds a live recorder
        run.telemetry.add_listener(make_heartbeat_listener(hb))
    hist = run.fit()
    record_launches(run.telemetry)
    run.close()
    if rank == 0:
        final = hist[-1]["loss"] if hist else None
        if final is not None:
            print(f"final loss: {final:.4f}")
        result_file = os.environ.get(ENV_RESULT_FILE)
        if result_file:
            payload = {"world": spec.num_processes,
                       "steps": run.spec.steps, "final_loss": final}
            with open(result_file, "w") as f:
                json.dump(payload, f)
    return 0


def _verify_single(args) -> float:
    """The same run in one process, from a fresh state (no resume): the
    reference the cluster's final loss must match."""
    from repro_torch.launch.train import compile_from_args

    # no checkpoints and no trace: the supervisor has no REPRO_PROCESS_ID,
    # so its trace_p0.jsonl would overwrite worker 0's
    run = compile_from_args(argparse.Namespace(**dict(
        vars(args), ckpt_dir=None, ckpt_every=0, trace_dir=None)))
    hist = run.fit(start_step=0)
    run.close()
    return hist[-1]["loss"]


def make_parser() -> argparse.ArgumentParser:
    """The run flags of ``repro_torch.launch.train`` and the cluster's."""
    from repro_torch.launch.train import add_run_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_run_args(ap, parallel_default="zero1", cluster=True)
    ap.add_argument("--processes", type=int, default=2,
                    help="worker processes to launch (the pod axis extent)")
    ap.add_argument("--local-devices", type=int, default=1,
                    help="members each process holds on its device, "
                         "--model-ways of them a model group (the "
                         "reference's devices a process)")
    ap.add_argument("--run-dir", default=None,
                    help="supervisor scratch dir (heartbeats, worker logs, "
                         "result); default: --ckpt-dir, else a temp dir")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="elastic relaunch budget after worker failures")
    ap.add_argument("--heartbeat-timeout", type=float, default=120.0,
                    help="seconds without progress before the supervisor "
                         "declares a hang (covers the first step's kernel "
                         "builds, so generous)")
    ap.add_argument("--chaos-kill-step", type=int, default=None,
                    help="chaos harness: SIGKILL one worker when its "
                         "heartbeat reaches this step (first attempt only)")
    ap.add_argument("--chaos-kill-worker", type=int, default=1)
    ap.add_argument("--grow-back", action="store_true",
                    help="relaunch failed attempts at the FULL --processes "
                         "world instead of shrinking to the survivors")
    ap.add_argument("--verify", action="store_true",
                    help="also train in one process and fail unless the "
                         "final losses match (G-invariance, end to end)")
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    from repro_torch.launch.train import check_run_args

    ap = make_parser()
    args = ap.parse_args(argv)
    resolve_comm_backends(args)
    check_run_args(ap, args)
    check_cluster_args(ap, args)

    if in_worker():
        try:
            code = worker_main(args)
        except Exception:
            traceback.print_exc()
            code = 1
        # a failed worker leaves at once: its peers wait in a collective
        # until the supervisor ends the group
        _leave(code, code == 0 and ClusterSpec.from_env().is_multiprocess)

    from repro_torch.cluster.elastic import ChaosSpec, run_elastic

    if args.processes < 1:
        ap.error("--processes must be >= 1")
    run_dir = args.run_dir or args.ckpt_dir \
        or tempfile.mkdtemp(prefix="repro-cluster-")
    chaos = None
    if args.chaos_kill_step is not None:
        chaos = ChaosSpec(at_step=args.chaos_kill_step,
                          worker=args.chaos_kill_worker)
    res = run_elastic(argv, run_dir, args.processes,
                      local_devices=args.local_devices,
                      max_restarts=args.max_restarts,
                      heartbeat_timeout=args.heartbeat_timeout,
                      chaos=chaos, grow_back=args.grow_back)
    final = res.result.get("final_loss") if res.result else None
    print(f"[cluster] done: world={res.final_world} "
          f"attempts={res.attempts} final_loss={final}")
    if args.trace_dir:
        # each worker wrote its trace_p<pid>.jsonl (Run.close leaves the
        # merge to the supervisor, which sees them all)
        from repro_torch.telemetry import merge_process_traces
        merged = merge_process_traces(args.trace_dir)
        if merged:
            print(f"[cluster] merged Chrome trace: {merged}")
    if args.verify:
        if final is None:
            print("[cluster] verify FAILED: no final loss reported")
            return 1
        ref = _verify_single(args)
        diff = abs(final - ref)
        ok = diff <= VERIFY_TOL
        print(f"[cluster] verify: cluster={final!r} single={ref!r} "
              f"|diff|={diff!r} tol={VERIFY_TOL!r} "
              f"{'OK' if ok else 'FAILED'}")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
