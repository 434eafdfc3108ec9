"""The port's cluster subsystem (``repro_torch.cluster``, the process mesh
of ``compile_run`` and ``repro_torch.launch.cluster``), mirroring
``tests/test_cluster.py``: the ``ClusterSpec`` environment round trip and
its validation, the elastic supervisor's failure detection, the heartbeat
and its staleness, the strip re-plan against the reference's function, the
zero1 step of a process mesh over gloo against a local mesh's, and the CLI
as a user runs it, over gloo on the CPU (``--device cpu``): a 2-process
run that ``--verify`` holds to the one-process run, and the chaos run that
loses a worker and recovers at world 1.

Tolerances: the process mesh's step, whose ranks each take their half of
the batch, against the local mesh's whole-batch step: loss and grad norm
within 1e-6 relative, params within 1e-6 (the mean gradient of two
half-batch means sums the same f32 terms in another order); the CLI's final
losses within ``launch.cluster.VERIFY_TOL`` = 5e-3, the reference's.
"""
import ast
import json
import os
import re
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _gloo_ranks import run_group, run_ranks  # noqa: E402
from repro.checkpoint.replan import replan_strip_leaf as jreplan_leaf  # noqa: E402
from repro.checkpoint.replan import world_meta as jworld_meta  # noqa: E402
from repro.cluster import ClusterSpec as JClusterSpec  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.checkpoint.ckpt import read_manifest  # noqa: E402
from repro_torch.checkpoint.replan import replan_strip_leaf, world_meta  # noqa: E402
from repro_torch.cluster import ClusterSpec, in_worker  # noqa: E402
from repro_torch.cluster.elastic import _failure  # noqa: E402
from repro_torch.cluster.launcher import (  # noqa: E402
    WorkerHandle,
    make_heartbeat_listener,
    parse_heartbeat,
    write_heartbeat,
)
from repro_torch.cluster.spec import ENV_PROCESS_ID  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.core.collectives import padded_size  # noqa: E402
from repro_torch.launch.mesh import make_cluster_mesh, make_local_mesh  # noqa: E402
from repro_torch.optim.dist import owner_perm  # noqa: E402
from repro_torch.telemetry import Recorder  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CLI_TIMEOUT_S = 150     # a CLI run takes 7-20 s alone
RANKS_DEADLINE_S = 90   # the 2-rank step case takes ~4 s alone
STEP_TOL = 1e-6


def run_cluster_cli(argv):
    """The supervisor, run as a user runs it, with one compute thread a
    process; a hung worker is declared so after 30 s without a step."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop(ENV_PROCESS_ID, None)
    return run_group(
        [sys.executable, "-m", "repro_torch.launch.cluster", *argv,
         "--device", "cpu", "--heartbeat-timeout", "30"], env, CLI_TIMEOUT_S)


# ---------------------------------------------------------------------------
# ClusterSpec
# ---------------------------------------------------------------------------
def test_cluster_spec_env_round_trip():
    spec = ClusterSpec(coordinator="localhost:12345", num_processes=4,
                       process_id=2)
    assert ClusterSpec.from_env(spec.env()) == spec
    # the same variables as the reference's, so either package's launcher
    # describes a worker to the other
    assert spec.env() == JClusterSpec(coordinator="localhost:12345",
                                      num_processes=4, process_id=2).env()
    assert ClusterSpec.from_env({}).num_processes == 1
    assert not ClusterSpec.from_env({}).is_multiprocess


@pytest.mark.parametrize("kw", [dict(num_processes=0),
                                dict(num_processes=2, process_id=2),
                                dict(coordinator="no-port"),
                                dict(local_devices=0)])
def test_cluster_spec_validation(kw):
    with pytest.raises(ValueError):
        ClusterSpec(**kw)
    with pytest.raises(ValueError):
        JClusterSpec(**kw)


def test_cluster_spec_refuses_devices_it_would_not_use():
    # the reference forces that many host devices a process; the port runs
    # one member a process, so more devices raise rather than go unused
    env = JClusterSpec(num_processes=2, process_id=1, local_devices=4).env()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ClusterSpec.from_env(env)


def test_in_worker_detection():
    assert not in_worker({})
    assert in_worker({ENV_PROCESS_ID: "0"})


def test_cluster_mesh_of_one_process_is_a_one_member_local_mesh():
    mesh = make_cluster_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} \
        and mesh.batch_shard is None
    with pytest.raises(NotImplementedError):
        make_cluster_mesh(model_ways=2, device="cpu")


def test_meshes_default_to_the_card(monkeypatch):
    """A mesh given no device takes the GPU, as every entry point of the
    port does, and raises where none is visible instead of falling back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_local_mesh, make_cluster_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_local_mesh(2).device == torch.device("cuda")
    assert make_cluster_mesh().device == torch.device("cuda", 0)


@pytest.mark.parametrize("ranks,cards,device,want", [
    (2, 1, None, "gloo"), (2, 2, None, "nccl"), (4, 8, None, "nccl"),
    (2, 4, "cpu", "gloo"), (1, 0, "cpu", "gloo")],
    ids=["shared card", "a card each", "spare cards", "cpu", "one cpu"])
def test_backend_is_nccl_only_with_a_card_a_rank(ranks, cards, device, want,
                                                 monkeypatch):
    from repro_torch.cluster import choose_backend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    backend, why = choose_backend(ClusterSpec(num_processes=ranks), device)
    assert backend == want and why


# ---------------------------------------------------------------------------
# elastic failure detection (duck-typed handles, no processes)
# ---------------------------------------------------------------------------
class _FakeProc:
    def __init__(self, returncode=None):
        self.returncode = returncode

    def poll(self):
        return self.returncode


def _handle(pid, tmpdir, returncode=None, hb=None):
    hb_file = os.path.join(tmpdir, f"hb_{pid}")
    if hb is not None:
        with open(hb_file, "w") as f:
            f.write(str(hb))
    return WorkerHandle(proc=_FakeProc(returncode), process_id=pid,
                        hb_file=hb_file, log_file=None)


def test_failure_detects_nonzero_exit(tmp_path):
    hs = [_handle(0, str(tmp_path)), _handle(1, str(tmp_path), -9)]
    fail = _failure(hs, time.monotonic(), heartbeat_timeout=60.0)
    assert fail == {"dead": [1], "reason": "exit"}


def test_failure_ignores_clean_exit_and_fresh_group(tmp_path):
    hs = [_handle(0, str(tmp_path)), _handle(1, str(tmp_path), 0)]
    assert _failure(hs, time.monotonic(), heartbeat_timeout=60.0) is None


def test_failure_declares_hang_only_when_whole_group_stale(tmp_path):
    old = time.monotonic() - 1000.0
    hs = [_handle(0, str(tmp_path)), _handle(1, str(tmp_path))]
    assert _failure(hs, old, heartbeat_timeout=60.0) == {
        "dead": [], "reason": "heartbeat"}
    # one member beating: healthy (a real hang of synchronous SGD stalls
    # the whole group)
    hs = [_handle(0, str(tmp_path), hb=5), _handle(1, str(tmp_path))]
    assert _failure(hs, old, heartbeat_timeout=60.0) is None


def test_heartbeat_parse_staleness_and_listener(tmp_path):
    p = str(tmp_path / "hb")
    assert parse_heartbeat(p) is None
    write_heartbeat(p, 7, 123.5)
    hb = parse_heartbeat(p)
    assert (hb.step, hb.mono) == (7, 123.5)
    with open(p, "w") as f:
        f.write("42")
    assert parse_heartbeat(p).step == 42 and parse_heartbeat(p).mono is None
    with open(p, "w") as f:
        f.write("not json {")
    assert parse_heartbeat(p) is None
    # staleness runs on the supervisor's clock, from the payload's changes
    h = WorkerHandle(proc=_FakeProc(), process_id=0, hb_file=p,
                     log_file=None)
    now = time.monotonic()
    write_heartbeat(p, 3, 50.0)
    assert h.staleness(now, now - 100.0) == pytest.approx(0.0, abs=1e-6)
    os.utime(p, (time.time() + 3600, time.time() + 3600))
    assert h.staleness(now + 80.0, now - 100.0) == pytest.approx(80.0)
    write_heartbeat(p, 4, 51.0)
    assert h.staleness(now + 81.0, now - 100.0) == pytest.approx(0.0)
    # the listener beats on step spans only
    r = Recorder()
    beat = str(tmp_path / "beat")
    r.add_listener(make_heartbeat_listener(beat))
    with r.span("data_wait", step=1):
        pass
    assert parse_heartbeat(beat) is None
    with r.span("step", step=1):
        pass
    assert parse_heartbeat(beat).step == 1
    assert parse_heartbeat(beat).mono == r.events[-1]["t1"]


# ---------------------------------------------------------------------------
# the strip re-plan against the reference's
# ---------------------------------------------------------------------------
WORLDS = [([8], False), ([2, 4], True), ([4, 2], True), ([4], False),
          ([2, 2], True), ([1], False)]


def _value_strips(payload, world):
    flat = np.zeros(padded_size(len(payload), world["G"]), np.float32)
    flat[:len(payload)] = payload
    arr = flat.reshape(world["G"], -1)
    perm = owner_perm(world["hierarchical"], world["axes_sizes"])
    return arr if perm is None else arr[perm]


@pytest.mark.parametrize("old", range(len(WORLDS)))
def test_replan_strip_leaf_round_trips_like_the_reference(old):
    payload = np.random.default_rng(old).normal(size=10).astype(np.float32)
    w_old = world_meta(*WORLDS[old], 4)
    assert w_old == jworld_meta(*WORLDS[old], 4)
    for new in WORLDS:
        w_new = world_meta(*new, 4)
        got = replan_strip_leaf(_value_strips(payload, w_old), 10, w_old,
                                w_new)
        np.testing.assert_array_equal(got, _value_strips(payload, w_new))
        np.testing.assert_array_equal(
            got, jreplan_leaf(_value_strips(payload, w_old), 10, w_old,
                              w_new))


def test_replan_strip_leaf_rejects_wrong_shape():
    old, new = world_meta([4], False, 4), world_meta([2], False, 4)
    with pytest.raises(ValueError):
        replan_strip_leaf(np.zeros((2, 8), np.float32), 10, old, new)
    with pytest.raises(ValueError):
        replan_strip_leaf(np.zeros((4, 9), np.float32), 10, old, new)


# ---------------------------------------------------------------------------
# the zero1 step of a process mesh (2 gloo ranks, half the batch each)
# ---------------------------------------------------------------------------
STEP_WORKER = """
import os, sys
import numpy as np, torch, torch.distributed as dist
rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from repro_torch.api import MeshSpec, RunSpec, compile_run
from repro_torch.comm import CommConfig
from repro_torch.core.params import tree_leaves


def spec(case, **kw):
    return RunSpec(
        arch="vgg-a", smoke=True, batch=8, lr=5e-3, schedule="constant",
        log_every=1, parallel="zero1",
        comm=CommConfig(backend="pallas-ring", cross_backend="pallas-ring",
                        hierarchical=True, overlap=case == "overlap"),
        mesh=MeshSpec(cluster=True), **kw)


for case in ("monolithic", "overlap"):
    run = compile_run(spec(case, steps=3), device="cpu")
    assert run.mesh.batch_shard == (rank, world), run.mesh
    hist = run.fit(log_fn=lambda *_: None)
    run.close()
    out = {f"{k}": np.array([h[k] for h in hist])
           for k in ("loss", "grad_norm")}
    out.update({f"p/{k}": v.detach().numpy() for k, v in run.params.items()})
    np.savez(f"{tmp}/{case}_rank{rank}.npz", **out)
# a checkpoint of the process mesh (rows gathered, rank 0 writes) and a
# resume at the same world (each rank takes its row back): bitwise the
# uninterrupted run
ck = tmp + "/ckpt"
with compile_run(spec("monolithic", steps=2, ckpt_every=2, ckpt_dir=ck),
                 device="cpu") as first:
    first.fit(log_fn=lambda *_: None)
lines = []
with compile_run(spec("monolithic", steps=3, ckpt_dir=ck),
                 device="cpu") as resumed:
    resumed.fit(log_fn=lines.append)
assert any("resuming from checkpoint step 2" in x for x in lines), lines
with np.load(f"{tmp}/monolithic_rank{rank}.npz") as z:
    for k, v in resumed.params.items():
        assert np.array_equal(z[f"p/{k}"], v.detach().numpy()), k
with compile_run(spec("monolithic", steps=3), device="cpu") as whole:
    whole.fit(log_fn=lambda *_: None)
for a, b in zip(tree_leaves(resumed.opt_state), tree_leaves(whole.opt_state)):
    assert torch.equal(a, b)
dist.barrier()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


def test_process_mesh_step_matches_local_mesh(tmp_path):
    world = 2
    run_ranks(STEP_WORKER, world, tmp_path, SRC, RANKS_DEADLINE_S)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for case in ("monolithic", "overlap"):
            run = compile_run(RunSpec(
                arch="vgg-a", smoke=True, steps=3, batch=8, lr=5e-3,
                schedule="constant", log_every=1, parallel="zero1",
                comm=CommConfig(backend="pallas-ring",
                                overlap=case == "overlap"),
                mesh=MeshSpec(members_per_device=world)), device="cpu")
            hist = run.fit(log_fn=lambda *_: None)
            run.close()
            for r in range(world):
                with np.load(tmp_path / f"{case}_rank{r}.npz") as z:
                    got = dict(z)
                for k in ("loss", "grad_norm"):
                    np.testing.assert_allclose(
                        got[k], [h[k] for h in hist], rtol=STEP_TOL,
                        err_msg=f"{case} rank {r} {k}")
                for k, p in run.params.items():
                    np.testing.assert_allclose(
                        got[f"p/{k}"], p.detach().numpy(), rtol=0,
                        atol=STEP_TOL, err_msg=f"{case} rank {r} {k}")
    finally:
        torch.set_num_threads(threads)


COMMIT_WORKER = """
import os, sys, time
import numpy as np, torch, torch.distributed as dist
rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from repro_torch.checkpoint import ckpt
if rank == 0:
    # the writer is slow: its peers must not go on before the file is there
    real = np.savez
    def slow(*a, **k):
        time.sleep(1.0)
        return real(*a, **k)
    np.savez = slow
ckpt.save(tmp + "/ckpt", 2, params={"w": torch.arange(4.0)})
assert ckpt.latest_step(tmp + "/ckpt") == 2, rank
dist.barrier()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


def test_checkpoint_save_returns_once_committed_on_every_rank(tmp_path):
    """A rank that left ``ckpt.save`` before rank 0 had committed the file
    could resume from an older step than its peers and pair its collectives
    with theirs (the cause of an intermittent failure of the same-world
    resume in the test above): no rank returns before the ``.npz`` is in
    place."""
    run_ranks(COMMIT_WORKER, 2, tmp_path, SRC, RANKS_DEADLINE_S)


# ---------------------------------------------------------------------------
# the CLI, over gloo on the CPU
# ---------------------------------------------------------------------------
def test_two_process_run_verifies_against_one_process(tmp_path):
    out = run_cluster_cli(["--processes", "2", "--arch", "vgg-a", "--smoke",
                           "--steps", "4", "--batch", "8", "--run-dir",
                           str(tmp_path), "--verify"])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "over gloo" in out.stdout, out.stdout
    assert "verify:" in out.stdout and "OK" in out.stdout, out.stdout
    with open(tmp_path / "result.json") as f:
        result = json.load(f)
    assert result["world"] == 2 and result["final_loss"] is not None


def test_chaos_kill_recovers_at_world_one_and_matches(tmp_path):
    # batch 512 keeps the 2-process run long enough (~1 s after step 3 on
    # one core a process) for the supervisor, which looks every 0.25 s, to
    # see step 3 and kill worker 1 before the run ends
    ckpt = str(tmp_path / "ckpt")
    args = ["--arch", "vgg-a", "--smoke", "--steps", "8", "--batch", "512",
            "--schedule", "constant"]
    out = run_cluster_cli(["--processes", "2", *args, "--ckpt-every", "2",
                           "--ckpt-dir", ckpt, "--run-dir", str(tmp_path),
                           "--chaos-kill-step", "3"])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "chaos: SIGKILL worker 1" in out.stdout, out.stdout
    # one failed attempt, and worker 1 ended by the chaos SIGKILL (worker 0
    # may also exit, with an error, on losing its peer)
    failed = re.findall(r"attempt (\d+) failed: exit \(dead workers: "
                        r"[^;]*; exit codes ([^)]*)\)", out.stdout)
    assert len(failed) == 1 and failed[0][0] == "0", out.stdout
    codes = ast.literal_eval(failed[0][1])
    assert codes[1] == -9 and all(c > 0 for w, c in codes.items() if w != 1)
    assert "attempt 1: world=1" in out.stdout, out.stdout
    assert "resuming from checkpoint" in out.stdout, out.stdout
    with open(tmp_path / "result.json") as f:
        result = json.load(f)
    assert result["world"] == 1
    # the world-2 checkpoint records the reference's cluster layout for 2
    # processes, so either package re-plans the other's
    assert read_manifest(ckpt, 2)["meta"]["zero1"] == jworld_meta(
        [2, 1], True, 4 * 2 ** 20)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with compile_run(RunSpec(arch="vgg-a", smoke=True, steps=8,
                                 batch=512, schedule="constant",
                                 parallel="zero1"), device="cpu") as run:
            whole = run.fit(log_fn=lambda *_: None)[-1]["loss"]
    finally:
        torch.set_num_threads(threads)
    assert abs(result["final_loss"] - whole) < 5e-3, (result, whole)


def test_grow_back_relaunches_at_the_full_world(tmp_path):
    # the chaos kill of the test above, recovered at world 2 instead of 1:
    # the second attempt resumes the step-2 checkpoint at the saved world
    # size (no re-plan), and --verify holds it to one process
    ckpt = str(tmp_path / "ckpt")
    out = run_cluster_cli(["--processes", "2", "--arch", "vgg-a", "--smoke",
                           "--steps", "8", "--batch", "512", "--schedule",
                           "constant", "--ckpt-every", "2", "--ckpt-dir",
                           ckpt, "--run-dir", str(tmp_path),
                           "--chaos-kill-step", "3", "--grow-back",
                           "--verify"])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "chaos: SIGKILL worker 1" in out.stdout, out.stdout
    assert "attempt 1: world=2" in out.stdout, out.stdout
    assert "resuming from checkpoint step" in out.stdout, out.stdout
    assert re.search(r"verify: .* OK", out.stdout), out.stdout
    with open(tmp_path / "result.json") as f:
        assert json.load(f)["world"] == 2
