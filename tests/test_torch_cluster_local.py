"""Model ways and several members a process on the cluster
(``launch.mesh.ClusterMesh``, ``--local-devices``), against the reference
and against the port's own local mesh of the same shape.

One reference subprocess on 4 forced host devices, started with the
module's first test, trains VGG-A and CD-DNN smoke zero1 for 3 steps at
``MeshSpec(pods=2, model_ways=2)`` and ``MeshSpec(pods=2)``: the meshes
``(2, 1, 2)`` and ``(2, 2, 1)`` of the reference's 2-process cluster at 2
local devices.  The port trains the same runs on 2 gloo ranks of 2 members
each (``MeshSpec(cluster=True)``, ``REPRO_LOCAL_DEVICES=2``) from the
reference's initial params.  The same 2 ranks run every collective over
the cluster's axes on distinct member rows, stale-sync, dp, zero1-gspmd and
int8 fits, and a checkpoint that one process resumes on a 2-member local
mesh; the tests hold them to the local mesh of the same shape here.  Then
the cluster CLI as a user runs it: ``--local-devices 2 --model-ways 2
--verify``, and the chaos kill at ``--local-devices 2``.

Tolerances: the histories against the reference's within 1e-5 relative
and the params within 1e-6 absolute (``tests/test_torch_dist.py``'s: f32
sums in another order, the ranks' half-batch means against the whole
batch's); the fits against the local mesh within 1e-6 relative and
absolute (the same sums in another order); the fp32 collectives within
1e-6 of the local mesh's and the int8 ones within one int8 quantum of the
largest message (``int8_quantum``: the local mesh quantizes the same
messages, but its sums of two partials may round the last bit the other
way, and a scale then moves a code by one); the int8 fit within 1e-3
relative of the local mesh's int8 fit (its ranks quantize half-batch
gradients, the local mesh the whole batch's); the CLI's final losses
within ``launch.cluster.VERIFY_TOL``, the reference's.
"""
import os
import subprocess
import sys
import textwrap
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _gloo_ranks import run_group, run_ranks  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.checkpoint.ckpt import read_manifest  # noqa: E402
from repro_torch.cluster.spec import ENV_PROCESS_ID  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("vgg-a", "cd-dnn")
WAYS = (2, 1)
REF_DEADLINE_S = 300
RANKS_DEADLINE_S = 240
CLI_TIMEOUT_S = 150
HIST_TOL, PARAM_TOL, LOCAL_TOL = 1e-5, 1e-6, 1e-6
INT8_FIT_TOL = 1e-3
SMOKE = dict(smoke=True, steps=3, batch=8, lr=5e-3, schedule="constant",
             log_every=1)
# the fits the ranks run beyond zero1, each held to the local mesh
MODES = {"stale-sync": ("cd-dnn", "stale-sync", 2, None),
         "dp": ("cd-dnn", "dp", 2, None),
         "zero1-gspmd": ("cd-dnn", "zero1-gspmd", 1, None),
         "dp-vgg": ("vgg-a", "dp", 1, None),
         "int8": ("vgg-a", "zero1", 1, "int8")}


def _comm(wire=None):
    """The cluster's default comm (pallas-ring at both levels), spelled out
    for the local mesh, with ``wire`` as the wire format."""
    return CommConfig(backend="pallas-ring", cross_backend="pallas-ring",
                      hierarchical=True, wire_format=wire)


REFERENCE = textwrap.dedent("""
    import sys
    import repro.jaxcompat
    import numpy as np
    from repro.api import MeshSpec, RunSpec, compile_run
    out_dir = sys.argv[1]
    smoke = dict(smoke=True, steps=3, batch=8, lr=5e-3, schedule="constant",
                 log_every=1)
    runs = {}
    p0 = {}
    for arch in ("vgg-a", "cd-dnn"):
        for ways in (2, 1):
            run = compile_run(RunSpec(arch=arch, parallel="zero1",
                                      mesh=MeshSpec(pods=2, model_ways=ways),
                                      **smoke))
            assert dict(run.mesh.shape) == {"pod": 2, "data": 2 // ways,
                                            "model": ways}, run.mesh.shape
            runs[arch, ways] = run
            for k, v in run.params.items():
                p0[f"{arch}/{k}"] = np.asarray(v)
    np.savez(out_dir + "/p0.tmp.npz", **p0)
    import os
    os.replace(out_dir + "/p0.tmp.npz", out_dir + "/p0.npz")
    out = {}
    for (arch, ways), run in runs.items():
        hist = run.fit(log_fn=lambda *_: None)
        run.close()
        for key in ("loss", "grad_norm"):
            out[f"{arch}/{ways}/{key}"] = np.array([h[key] for h in hist])
        for k, v in run.params.items():
            out[f"{arch}/{ways}/p/{k}"] = np.asarray(v)
    np.savez(out_dir + "/reference.npz", **out)
""")


class _Reference:
    """The reference subprocess, started at once; its initial params are
    read as soon as they are written, its histories when it ends."""

    def __init__(self, tmp):
        self.tmp = tmp
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        self.log = open(os.path.join(tmp, "reference.log"), "w")
        self.proc = subprocess.Popen([sys.executable, "-c", REFERENCE, tmp],
                                     env=env, stdout=self.log,
                                     stderr=subprocess.STDOUT)
        self.t0 = time.monotonic()
        self._out = None

    def _fail(self, why):
        self.proc.kill()
        self.log.flush()
        with open(os.path.join(self.tmp, "reference.log")) as f:
            pytest.fail(f"reference {why}:\n{f.read()[-4000:]}",
                        pytrace=False)

    def p0_path(self):
        path = os.path.join(self.tmp, "p0.npz")
        while not os.path.exists(path):
            if self.proc.poll() is not None:
                self._fail(f"exited with {self.proc.returncode}")
            if time.monotonic() - self.t0 > REF_DEADLINE_S:
                self._fail("timed out")
            time.sleep(0.1)
        return path

    def result(self):
        if self._out is None:
            try:
                rc = self.proc.wait(max(1, REF_DEADLINE_S - (
                    time.monotonic() - self.t0)))
            except subprocess.TimeoutExpired:
                self._fail("timed out")
            if rc:
                self._fail(f"exited with {rc}")
            with np.load(os.path.join(self.tmp, "reference.npz")) as z:
                self._out = dict(z)
        return self._out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(str(tmp_path_factory.mktemp("reference_cluster")))
    yield ref
    ref.proc.kill()
    ref.proc.wait()
    ref.log.close()


# ---------------------------------------------------------------------------
# the 2 gloo ranks, 2 members each
# ---------------------------------------------------------------------------
RANKS_WORKER = """
import os, sys
import numpy as np, torch, torch.distributed as dist
rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
p0_path = P0_PATH
torch.set_num_threads(1)
os.environ["REPRO_LOCAL_DEVICES"] = "2"
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from repro_torch.api import MeshSpec, RunSpec, compile_run
from repro_torch.comm import CommConfig, GossipBackend, LaxBackend, \\
    RingBackend
from repro_torch.comm.schedule import make_schedule
from repro_torch.core import collectives as coll
from repro_torch.launch.mesh import ClusterMesh, make_cluster_mesh

out = {}
SMOKE = dict(smoke=True, steps=3, batch=8, lr=5e-3, schedule="constant",
             log_every=1)

# every collective over the cluster's axes, on distinct member rows: row j
# of rank p is member 2p + j of a seeded (4, 48) tensor
mesh = make_cluster_mesh(device="cpu")
assert isinstance(mesh, ClusterMesh) and mesh.shape == {
    "pod": 2, "data": 2, "model": 1}, mesh
X = torch.from_numpy(np.random.default_rng(0).normal(
    size=(4, 48)).astype(np.float32))
rows = X[2 * rank:2 * rank + 2].clone()
backends = {"lax": LaxBackend(), "ring": RingBackend(),
            "gossip0": GossipBackend(step=0), "gossip1": GossipBackend(step=1),
            "lax-int8": LaxBackend(wire_format="int8"),
            "ring-int8": RingBackend(wire_format="int8")}
for name, be in backends.items():
    for axes in (("pod",), ("pod", "data"), ("data",)):
        tag = f"coll/{name}/{'.'.join(axes)}"
        strips = be.part_reduce(rows, mesh, axes)
        out[tag + "/reduce"] = strips.numpy()
        if "int8" not in name:
            out[tag + "/broadcast"] = be.part_broadcast(
                strips.contiguous(), mesh, axes).numpy()
    if "int8" in name or "gossip" in name:
        continue
    sched = make_schedule(mesh, ("pod", "data"), True, be, be)
    strips = sched.reduce(rows)
    out[f"coll/{name}/hier/reduce"] = strips.numpy()
    out[f"coll/{name}/hier/broadcast"] = sched.broadcast(strips).numpy()
    out[f"coll/{name}/hier/owner"] = np.array(sched.owner_index())
for axes in (("pod",), ("pod", "data"), ("data",)):
    out[f"coll/psum/{'.'.join(axes)}"] = coll.psum(rows, mesh, axes).numpy()
out["coll/gather"] = mesh.gather_members(rows).numpy()


def fit(arch, parallel, ways, wire=None, **kw):
    comm = None if wire is None else CommConfig(
        backend="pallas-ring", cross_backend="pallas-ring",
        hierarchical=True, wire_format=wire)
    run = compile_run(RunSpec(arch=arch, parallel=parallel, comm=comm,
                              mesh=MeshSpec(cluster=True, model_ways=ways),
                              **{**SMOKE, **kw}), device="cpu")
    assert run.mesh.shape == {"pod": 2, "data": 2 // ways,
                              "model": ways}, run.mesh
    assert run.mesh.batch_shard == (rank, 2), run.mesh
    with np.load(p0_path) as z:
        run.load_params({k.split("/", 1)[1]: z[k] for k in z.files
                         if k.startswith(arch + "/")})
    with run:
        hist = run.fit(log_fn=lambda *_: None)
    return run, hist


def keep(tag, run, hist):
    for key in ("loss", "grad_norm"):
        out[f"{tag}/{key}"] = np.array([h[key] for h in hist])
    for k, v in run.full_params().items():
        out[f"{tag}/p/{k}"] = v.detach().numpy()


for arch in ("vgg-a", "cd-dnn"):
    for ways in (2, 1):
        keep(f"zero1/{arch}/{ways}", *fit(arch, "zero1", ways))
MODES = MODES_TABLE
for name, (arch, parallel, ways, wire) in MODES.items():
    keep(f"mode/{name}", *fit(arch, parallel, ways, wire))
# a checkpoint at step 2 of the (2, 2, 1) zero1 run, which one process
# resumes on a 2-member local mesh (the test)
fit("cd-dnn", "zero1", 1, steps=2, ckpt_every=2, ckpt_dir=tmp + "/ckpt")
np.savez(f"{tmp}/rank{rank}.npz", **out)
dist.barrier()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """The 2 ranks' results, each rank's own dict."""
    tmp = tmp_path_factory.mktemp("cluster_local_ranks")
    # the ranks read the reference's initial params, so that their fits
    # start where the reference's do
    worker = RANKS_WORKER.replace("P0_PATH", repr(reference.p0_path())
                                  ).replace("MODES_TABLE", repr(MODES))
    run_ranks(worker, 2, tmp, SRC, RANKS_DEADLINE_S)
    out = []
    for r in range(2):
        with np.load(tmp / f"rank{r}.npz") as z:
            out.append(dict(z))
    return out, tmp


def _load_p0(reference, arch):
    with np.load(reference.p0_path()) as z:
        return {k.split("/", 1)[1]: z[k] for k in z.files
                if k.startswith(arch + "/")}


def _local(reference, arch, parallel, ways, wire=None, **kw):
    """The local mesh of the cluster's shape, from the reference's initial
    params: its history and full params."""
    comm = _comm(wire) if parallel in ("zero1", "stale-sync") else None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = compile_run(RunSpec(
            arch=arch, parallel=parallel, comm=comm,
            mesh=MeshSpec(members_per_device=4 // ways, pods=2,
                          model_ways=ways), **{**SMOKE, **kw}), device="cpu")
        assert run.mesh.shape == {"pod": 2, "data": 2 // ways,
                                  "model": ways}
        run.load_params(_load_p0(reference, arch))
        with run:
            hist = run.fit(log_fn=lambda *_: None)
        return hist, {k: v.detach().numpy()
                      for k, v in run.full_params().items()}
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# make_cluster_mesh's clamps and warnings, against the reference's
# ---------------------------------------------------------------------------
class _FakeJax:
    """The reference module's view of ``jax``: ``processes`` processes of
    ``local`` devices each, and a ``make_mesh`` that records its shape."""

    class Dev:
        def __init__(self, process_index, i):
            self.process_index, self.id = process_index, i

    def __init__(self, processes, local):
        self.processes = processes
        self._devs = [self.Dev(p, p * local + i) for p in range(processes)
                      for i in range(local)]

    def process_count(self):
        return self.processes

    def devices(self):
        return list(self._devs)

    def make_mesh(self, shape, axes, devices=None, axis_types=None):
        return dict(zip(axes, shape))


def _reference_mesh(monkeypatch, processes, local, model_ways):
    """The reference's ``make_cluster_mesh(model_ways)``'s axes and its
    warnings' messages on ``processes`` processes of ``local`` devices."""
    from repro.launch import mesh as jmesh
    monkeypatch.setattr(jmesh, "jax", _FakeJax(processes, local))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        shape = jmesh.make_cluster_mesh(model_ways)
    return shape, [str(w.message) for w in seen]


@pytest.mark.parametrize("local,ways", [(1, 2), (2, 2), (3, 2), (2, 3),
                                        (4, 2), (4, 3), (6, 4)])
def test_cluster_model_ways_clamp_like_the_reference(local, ways,
                                                     monkeypatch, reference):
    # over several processes: the port's clamp, message for message
    shape, want = _reference_mesh(monkeypatch, 2, local, ways)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = pmesh.cluster_model_ways(local, ways)
    assert [str(w.message) for w in seen] == want
    assert shape == {"pod": 2, "data": local // got, "model": got}
    # one process: the reference's make_host_mesh fallback, a local mesh
    # of the local devices
    shape, want = _reference_mesh(monkeypatch, 1, local, ways)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = pmesh.make_cluster_mesh(ways, device="cpu",
                                      local_devices=local)
    assert [str(w.message) for w in seen] == want
    assert isinstance(got, pmesh.LocalMesh) and not got.pod_across_ranks
    assert got.shape == shape


def test_cluster_mesh_takes_local_devices_from_the_environment(
        monkeypatch):
    from repro_torch.cluster.spec import ENV_LOCAL_DEVICES
    monkeypatch.setenv(ENV_LOCAL_DEVICES, "4")
    mesh = pmesh.make_cluster_mesh(model_ways=2, device="cpu")
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.n_ranks == 1 and mesh.batch_shard is None


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ways", WAYS, ids=["mesh 2x1x2", "mesh 2x2x1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cluster_zero1_matches_the_reference(reference, ranks, arch, ways):
    want = reference.result()
    for r, got in enumerate(ranks[0]):
        tag = f"zero1/{arch}/{ways}"
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(
                got[f"{tag}/{key}"], want[f"{arch}/{ways}/{key}"],
                rtol=HIST_TOL, err_msg=f"rank {r} {tag} {key}")
        keys = [k for k in want if k.startswith(f"{arch}/{ways}/p/")]
        assert keys
        for k in keys:
            np.testing.assert_allclose(
                got[f"{tag}/p/{k.rsplit('/', 1)[1]}"], want[k], rtol=0,
                atol=PARAM_TOL, err_msg=f"rank {r} {tag} {k}")


# ---------------------------------------------------------------------------
# against the local mesh of the same shape
# ---------------------------------------------------------------------------
def _local_rows_mesh():
    return pmesh.make_local_mesh(4, pods=2, device="cpu")


def int8_quantum(x):
    return float(np.abs(x).max()) / 127.0


@pytest.mark.parametrize("name", ["lax", "ring", "gossip0", "gossip1",
                                  "lax-int8", "ring-int8"])
def test_cluster_collectives_match_the_local_mesh(ranks, name):
    from repro_torch.comm import GossipBackend, LaxBackend, RingBackend
    from repro_torch.comm.schedule import make_schedule
    be = {"lax": LaxBackend(), "ring": RingBackend(),
          "gossip0": GossipBackend(step=0), "gossip1": GossipBackend(step=1),
          "lax-int8": LaxBackend(wire_format="int8"),
          "ring-int8": RingBackend(wire_format="int8")}[name]
    mesh = _local_rows_mesh()
    X = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 48)).astype(np.float32))
    tol = int8_quantum(X.sum(0).numpy()) if "int8" in name else LOCAL_TOL
    want = {}
    for axes in (("pod",), ("pod", "data"), ("data",)):
        tag = f"coll/{name}/{'.'.join(axes)}"
        strips = be.part_reduce(X, mesh, axes)
        want[tag + "/reduce"] = strips.numpy()
        if "int8" not in name:
            want[tag + "/broadcast"] = be.part_broadcast(
                strips.contiguous(), mesh, axes).numpy()
    if "int8" not in name and "gossip" not in name:
        sched = make_schedule(mesh, ("pod", "data"), True, be, be)
        strips = sched.reduce(X)
        want[f"coll/{name}/hier/reduce"] = strips.numpy()
        want[f"coll/{name}/hier/broadcast"] = sched.broadcast(strips).numpy()
        want[f"coll/{name}/hier/owner"] = np.array(sched.owner_index())
    for r, got in enumerate(ranks[0]):
        for tag, w in want.items():
            w = w[2 * r:2 * r + 2]
            np.testing.assert_allclose(got[tag], w, rtol=tol, atol=tol,
                                       err_msg=f"rank {r} {tag}")


def test_cluster_psum_and_gather_match_the_local_mesh(ranks):
    from repro_torch.core import collectives as coll
    mesh = _local_rows_mesh()
    X = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 48)).astype(np.float32))
    for r, got in enumerate(ranks[0]):
        for axes in (("pod",), ("pod", "data"), ("data",)):
            tag = f"coll/psum/{'.'.join(axes)}"
            np.testing.assert_allclose(
                got[tag], coll.psum(X, mesh, axes).numpy()[2 * r:2 * r + 2],
                rtol=LOCAL_TOL, atol=LOCAL_TOL, err_msg=f"rank {r} {tag}")
        np.testing.assert_array_equal(got["coll/gather"], X.numpy())


@pytest.mark.parametrize("name", list(MODES))
def test_cluster_modes_match_the_local_mesh(reference, ranks, name):
    arch, parallel, ways, wire = MODES[name]
    hist, params = _local(reference, arch, parallel, ways, wire)
    tol = INT8_FIT_TOL if wire == "int8" else LOCAL_TOL
    for r, got in enumerate(ranks[0]):
        tag = f"mode/{name}"
        np.testing.assert_allclose(got[f"{tag}/loss"],
                                   [h["loss"] for h in hist], rtol=tol,
                                   err_msg=f"rank {r} {tag}")
        for k, v in params.items():
            np.testing.assert_allclose(got[f"{tag}/p/{k}"], v, rtol=tol,
                                       atol=tol,
                                       err_msg=f"rank {r} {tag} {k}")


def test_cluster_checkpoint_resumes_on_one_process(reference, ranks):
    """The (2, 2, 1) cluster's step-2 checkpoint resumed by one process on
    a 2-member local mesh (the elastic shrink's mesh: ``make_cluster_mesh``
    at world 1) lands where the cluster's own 3 steps did."""
    from repro.checkpoint.replan import world_meta as jworld_meta
    out, tmp = ranks
    ckpt = str(tmp / "ckpt")
    assert read_manifest(ckpt, 2)["meta"]["zero1"] == jworld_meta(
        [2, 2], True, 4 * 2 ** 20)
    mesh = pmesh.make_cluster_mesh(device="cpu", local_devices=2)
    assert mesh.shape == {"data": 2, "model": 1}
    lines = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with compile_run(RunSpec(arch="cd-dnn", parallel="zero1",
                                 ckpt_dir=ckpt,
                                 mesh=MeshSpec(cluster=True), **SMOKE),
                         device="cpu", mesh=mesh) as run:
            run.fit(log_fn=lines.append)
            got = {k: v.detach().numpy() for k, v in run.params.items()}
    finally:
        torch.set_num_threads(threads)
    assert any("resuming from checkpoint step 2" in x for x in lines), lines
    for k, v in got.items():
        np.testing.assert_allclose(v, out[0][f"zero1/cd-dnn/1/p/{k}"],
                                   rtol=0, atol=PARAM_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the CLI, over gloo on the CPU
# ---------------------------------------------------------------------------
def run_cluster_cli(argv):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop(ENV_PROCESS_ID, None)
    return run_group(
        [sys.executable, "-m", "repro_torch.launch.cluster", *argv,
         "--device", "cpu", "--heartbeat-timeout", "30"], env, CLI_TIMEOUT_S)


def test_cli_model_ways_in_each_process_verifies(tmp_path):
    out = run_cluster_cli(["--processes", "2", "--local-devices", "2",
                           "--model-ways", "2", "--arch", "vgg-a", "--smoke",
                           "--steps", "3", "--run-dir", str(tmp_path),
                           "--verify"])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "'pod': 2, 'data': 1, 'model': 2" in out.stdout, out.stdout
    assert "L=2, model ways M=2" in out.stdout, out.stdout
    assert "verify:" in out.stdout and "OK" in out.stdout, out.stdout


def test_cli_chaos_at_two_local_devices_resumes_on_a_local_mesh(tmp_path):
    # batch 512 keeps each VGG-A smoke step long enough for the supervisor,
    # which looks every 0.25 s, to see step 3 before the run ends
    # (tests/test_torch_cluster.py's chaos run)
    ckpt = str(tmp_path / "ckpt")
    out = run_cluster_cli(["--processes", "2", "--local-devices", "2",
                           "--arch", "vgg-a", "--smoke", "--steps", "8",
                           "--batch", "512", "--schedule", "constant",
                           "--ckpt-every", "2", "--ckpt-dir", ckpt,
                           "--run-dir", str(tmp_path), "--chaos-kill-step",
                           "3", "--verify"])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "chaos: SIGKILL worker 1" in out.stdout, out.stdout
    assert "attempt 1: world=1" in out.stdout, out.stdout
    assert "mesh=LocalMesh({'data': 2, 'model': 1}" in out.stdout, out.stdout
    assert "resuming from checkpoint" in out.stdout, out.stdout
    assert "verify:" in out.stdout and "OK" in out.stdout, out.stdout
