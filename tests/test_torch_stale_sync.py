"""The port's bounded-staleness update (``repro_torch.optim.dist.
make_stale_sync_update``, ``parallel="stale-sync"``) against the
reference's, and its checkpoints across packages and world sizes.

The reference runs on 4 forced host devices in one subprocess for this
module; the port on a local mesh and, for the process-mesh cases, as 2 CPU
processes over gloo (one run, shared by the tests that read it).

What is held:

* the update's semantics (``tests/test_distributed.py::
  test_stale_sync_applies_previous_steps_gradient``): gradients [g0, g1,
  g2] land where the serial optimizer lands on [g0, g0, g1]; the port's
  params and carry against the reference's ``make_stale_sync_update`` at
  rtol 1e-6, atol 1e-7, and against the serial optimizer at the reference
  test's rtol 1e-5, atol 1e-7;
* ``compile_run`` loss and grad-norm history against the reference's
  within 1e-5 per step over 3 steps (``tests/test_torch_dist.py``'s zero1
  bound);
* a zero1 checkpoint resumed under stale-sync (``tests/test_cluster.py``'s
  interop cases): at the same world one step past it lands on the
  uninterrupted zero1 run at rtol 1e-5, atol 1e-7; across G = 4 -> 2 on the
  zero1 run of the resume world at rtol 1e-4, atol 1e-6 (the update does
  not depend on G up to rounding);
* a stale-sync checkpoint written by each package resumes in the other
  with its carry: the reference's G = 4 save in the port at G = 4 and 2,
  the port's 2-process save in the reference at G = 4, one step each, on
  the writer's uninterrupted run at rtol 1e-4, atol 1e-6.  The carry is
  per-member state: a writer that kept rank 0's rows for every member
  would resume onto another gradient;
* a 2-rank gloo step clips the fresh strips before it carries them: its
  history and params on the local mesh's (which clips the global gradient
  before the reduce) within 1e-6, as ``tests/test_torch_cluster.py``
  holds zero1's.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _gloo_ranks import run_group, run_ranks  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.checkpoint.ckpt import read_manifest  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.core.params import tree_leaves  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.optim import MomentumSGD  # noqa: E402
from repro_torch.optim.dist import make_stale_sync_update  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SMOKE = dict(arch="vgg-a", smoke=True, batch=8, lr=5e-3,
             schedule="constant", log_every=1)
UPDATE_CASES = [("lax", False, "fp32"), ("pallas-ring", False, "fp32"),
                ("pallas-ring", True, "fp32"), ("pallas-ring", False, "int8")]
G = 4
LR = 0.05
STEP_TOL = 1e-6


def _quiet(*_):
    pass


def _case(backend, hier, fmt):
    return f"{backend}/{'hier' if hier else 'flat'}/{fmt}"


def _update_inputs():
    """The reference test's tree and gradients: cos(p + t)."""
    params = {"b": np.ones((7,), np.float32),
              "w": (np.arange(24, dtype=np.float32).reshape(4, 6)
                    / np.float32(11))}
    grads = [{k: np.cos(v + np.float32(t)).astype(np.float32)
              for k, v in params.items()} for t in range(3)]
    return params, grads


# ---------------------------------------------------------------------------
# one 2-rank gloo run: stale-sync over a process mesh, a checkpoint at step
# 2, the uninterrupted 3 steps
# ---------------------------------------------------------------------------
WORKER = """
import os, sys
import numpy as np, torch, torch.distributed as dist
rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from repro_torch.api import MeshSpec, RunSpec, compile_run


def spec(**kw):
    return RunSpec(arch="vgg-a", smoke=True, batch=8, lr=5e-3,
                   schedule="constant", log_every=1, parallel="stale-sync",
                   mesh=MeshSpec(cluster=True), **kw)


out = {}
with compile_run(spec(steps=2, ckpt_every=2, ckpt_dir=tmp + "/ckpt"),
                 device="cpu") as first:
    assert first.comm.backend == "pallas-ring" and first.comm.hierarchical
    first.fit(log_fn=lambda *_: None)
    for i, s in enumerate(first.opt_state["stale"]):
        out[f"carry2/{i}"] = s.numpy()
    out["synced2"] = first.opt_state["synced"].numpy()
with compile_run(spec(steps=3), device="cpu") as whole:
    hist = whole.fit(log_fn=lambda *_: None)
for k in ("loss", "grad_norm"):
    out[k] = np.array([h[k] for h in hist])
for k, v in whole.params.items():
    out[f"p/{k}"] = v.detach().numpy()
for i, s in enumerate(whole.opt_state["stale"]):
    out[f"carry3/{i}"] = s.numpy()
np.savez(f"{tmp}/rank{rank}.npz", **out)
dist.barrier()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stale_gloo")
    run_ranks(WORKER, 2, tmp, SRC)
    ranks = []
    for r in range(2):
        with np.load(tmp / f"rank{r}.npz") as z:
            ranks.append(dict(z))
    return tmp, ranks


@pytest.fixture(scope="module")
def reference(tmp_path_factory, gloo_run):
    """Every reference result of this module, from one subprocess: the
    update cases, the compile_run history, a stale-sync checkpoint of its
    own, and the port's 2-process checkpoint resumed at G = 4."""
    port_tmp, _ = gloo_run
    tmp = tmp_path_factory.mktemp("reference_stale")
    params, grads = _update_inputs()
    inputs = os.path.join(str(tmp), "inputs.npz")
    np.savez(inputs, **{f"p/{k}": v for k, v in params.items()},
             **{f"g{t}/{k}": v for t, g in enumerate(grads)
                for k, v in g.items()})
    out = os.path.join(str(tmp), "reference.npz")
    ref_ckpt = os.path.join(str(tmp), "ref_ckpt")
    resumed_ckpt = os.path.join(str(tmp), "port_ckpt")
    code = textwrap.dedent(f"""
        import shutil
        import repro.jaxcompat
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import AxisType
        from repro.api import MeshSpec, RunSpec, compile_run
        from repro.comm import CommConfig
        from repro.optim import MomentumSGD
        from repro.optim.dist import make_stale_sync_update
        z = np.load({inputs!r})
        tree = lambda n: {{k: jnp.asarray(z[f"{{n}}/{{k}}"])
                          for k in ("b", "w")}}
        out = {{}}
        meshes = {{False: (jax.make_mesh((4,), ("data",),
                                         axis_types=(AxisType.Auto,)),
                          ("data",)),
                  True: (jax.make_mesh((2, 2), ("pod", "data"),
                                       axis_types=(AxisType.Auto,) * 2),
                         ("pod", "data"))}}
        for be, hier, fmt in {UPDATE_CASES!r}:
            mesh, axes = meshes[hier]
            init_fn, upd = make_stale_sync_update(
                MomentumSGD(momentum=0.9, weight_decay=0.01), mesh,
                data_axes=axes, comm=CommConfig(bucket_bytes=64,
                                                hierarchical=hier,
                                                backend=be, wire_format=fmt))
            with jax.set_mesh(mesh):
                p, st = tree("p"), init_fn(tree("p"))
                for t in range(3):
                    p, st = jax.jit(upd)(p, tree(f"g{{t}}"), st, {LR}, t)
            tag = f"{{be}}/{{'hier' if hier else 'flat'}}/{{fmt}}"
            for k in ("b", "w"):
                out[f"upd/{{tag}}/p/{{k}}"] = np.asarray(p[k])
            for i, s in enumerate(st["stale"]):
                out[f"upd/{{tag}}/stale/{{i}}"] = np.asarray(s)
            out[f"upd/{{tag}}/synced"] = np.asarray(st["synced"])
        quiet = lambda *_: None
        base = RunSpec(arch="vgg-a", smoke=True, batch=8, lr=5e-3,
                       schedule="constant", log_every=1,
                       parallel="stale-sync", steps=3,
                       comm=CommConfig(bucket_bytes=1 << 16,
                                       backend="pallas-ring"))
        run = compile_run(base)
        for k, v in run.params.items():
            out[f"run/p0/{{k}}"] = np.asarray(v)
        hist = run.fit(log_fn=quiet)
        run.close()
        out["run/loss"] = np.array([h["loss"] for h in hist])
        out["run/grad_norm"] = np.array([h["grad_norm"] for h in hist])
        for k, v in run.params.items():
            out[f"run/p3/{{k}}"] = np.asarray(v)
        # its own stale-sync checkpoint at step 2 (resumed by the port)
        first = compile_run(base.replace(steps=2, ckpt_every=2,
                                         ckpt_dir={ref_ckpt!r}))
        first.fit(log_fn=quiet)
        first.close()
        # the port's 2-process checkpoint (world [2, 1]) resumed here at G
        # = 4 (pods 2 x data 2): the carry re-planned, one step
        shutil.copytree({str(port_tmp / "ckpt")!r}, {resumed_ckpt!r})
        logs = []
        res = compile_run(RunSpec(arch="vgg-a", smoke=True, batch=8,
                                  lr=5e-3, schedule="constant",
                                  log_every=1, parallel="stale-sync",
                                  steps=3, mesh=MeshSpec(pods=2),
                                  ckpt_dir={resumed_ckpt!r}))
        res.fit(log_fn=logs.append)
        res.close()
        assert any("resuming from checkpoint step 2" in str(x)
                   for x in logs), logs
        for k, v in res.params.items():
            out[f"resumed/p3/{{k}}"] = np.asarray(v)
        np.savez({out!r}, **out)
    """)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z), ref_ckpt


@pytest.mark.parametrize("backend,hier,fmt", UPDATE_CASES,
                         ids=[_case(*c) for c in UPDATE_CASES])
def test_update_applies_the_previous_steps_gradient(reference, backend,
                                                    hier, fmt):
    """fp32: bitwise-level agreement (rtol 1e-6) with the reference's
    update and the serial optimizer on [g0, g0, g1].  int8: the carry
    within one quantum bound of the reference's, G * max|g| / 127 (the
    reference's XLA may round a value near a boundary to the neighbouring
    quantum, ``tests/test_torch_wire_dist.py``), the params within lr times
    that bound carried by the momentum through three steps (1 + 1.9 + 2.71
    bounds); and bitwise the port's own zero1 int8 update on [g0, g0,
    g1]."""
    ref, _ = reference
    tag = _case(backend, hier, fmt)
    params, grads = _update_inputs()
    opt = MomentumSGD(momentum=0.9, weight_decay=0.01)
    mesh = make_local_mesh(G, pods=2 if hier else 1, device="cpu")
    comm = CommConfig(bucket_bytes=64, hierarchical=hier, backend=backend,
                      wire_format=fmt)
    init_fn, upd = make_stale_sync_update(opt, mesh,
                                          data_axes=mesh.axis_names,
                                          comm=comm)
    p = params_from_numpy(params, "cpu")
    st = init_fn(p)
    assert set(st) == {"stale", "synced", "zero1"}
    assert int(st["synced"]) == 0 and st["synced"].dtype == torch.int32
    for t, g in enumerate(grads):
        p, st = upd(p, params_from_numpy(g, "cpu"), st, LR, t)
        assert int(st["synced"]) == 1
    bound = 0.0 if fmt == "fp32" else \
        G * max(float(np.abs(v).max()) for g in grads for v in g.values()) \
        / 127
    for k in params:
        np.testing.assert_allclose(p[k].numpy(), ref[f"upd/{tag}/p/{k}"],
                                   rtol=1e-6, atol=1e-7 + LR * 5.61 * bound,
                                   err_msg=k)
    for i, s in enumerate(st["stale"]):
        np.testing.assert_allclose(s.numpy(), ref[f"upd/{tag}/stale/{i}"],
                                   rtol=1e-6, atol=1e-7 + bound)
    # the staleness-shifted sequence [g0, g0, g1]: the serial optimizer, or
    # under int8 the port's zero1 int8 update (the same reduce of each
    # gradient, applied a step later), bitwise
    shifted = [params_from_numpy(g, "cpu")
               for g in (grads[0], grads[0], grads[1])]
    rp = params_from_numpy(params, "cpu")
    if fmt == "fp32":
        rs = opt.init(rp)
        for g in shifted:
            rp, rs = opt.update(g, rs, rp, LR)
        for k in params:
            torch.testing.assert_close(p[k], rp[k], rtol=1e-5, atol=1e-7)
    else:
        from repro_torch.optim.dist import make_distributed_update
        zinit, zupd = make_distributed_update(opt, mesh,
                                              data_axes=mesh.axis_names,
                                              comm=comm)
        rs = zinit(rp)
        for t, g in enumerate(shifted):
            rp, rs = zupd(rp, g, rs, LR, t)
        for k in params:
            assert torch.equal(p[k], rp[k]), k


def test_first_step_is_zero1s_first_step():
    """An empty carry applies the step's own reduce: stale-sync's first
    step is bitwise zero1's from the same params and gradient."""
    params, grads = _update_inputs()
    mesh = make_local_mesh(4, device="cpu")
    from repro_torch.optim.dist import make_distributed_update
    out = []
    for make in (make_stale_sync_update, make_distributed_update):
        init_fn, upd = make(MomentumSGD(momentum=0.9), mesh,
                            comm=CommConfig(bucket_bytes=64,
                                            backend="pallas-ring"))
        p = params_from_numpy(params, "cpu")
        p, _ = upd(p, params_from_numpy(grads[0], "cpu"), init_fn(p), 0.05)
        out.append(p)
    for k in params:
        assert torch.equal(out[0][k], out[1][k]), k


def test_compile_run_stale_sync_matches_reference(reference):
    ref, _ = reference
    spec = RunSpec(**SMOKE, steps=3, parallel="stale-sync",
                   mesh=MeshSpec(members_per_device=4),
                   comm=CommConfig(bucket_bytes=1 << 16,
                                   backend="pallas-ring"))
    keys = sorted(k.split("/")[-1] for k in ref if k.startswith("run/p0/"))
    run = compile_run(spec, device="cpu")
    assert int(run.opt_state["synced"]) == 0
    run.params = params_from_numpy({k: ref[f"run/p0/{k}"] for k in keys},
                                   "cpu")
    with run:
        hist = run.fit(log_fn=_quiet)
    assert [h["step"] for h in hist] == [1, 2, 3]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in hist], ref[f"run/{k}"],
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("resume_members,resume_pods", [(4, 2), (2, 1)],
                         ids=["same-world", "4to2"])
def test_zero1_checkpoint_resumes_under_stale_sync(tmp_path, resume_members,
                                                   resume_pods):
    """The inner strip state is zero1's layout, so a zero1 checkpoint
    restores into a stale-sync run with an empty carry; the first resumed
    step is then synchronous, and one step past the checkpoint lands on an
    uninterrupted zero1 run at the resume world."""
    ckpt = str(tmp_path / "ckpt")
    base = RunSpec(**SMOKE, steps=3, parallel="zero1", ckpt_dir=ckpt,
                   ckpt_every=3, mesh=MeshSpec(members_per_device=4, pods=2))
    with compile_run(base, device="cpu") as rz:
        rz.fit(log_fn=_quiet)
    mesh = MeshSpec(members_per_device=resume_members, pods=resume_pods)
    lines = []
    with compile_run(base.replace(parallel="stale-sync", steps=4,
                                  ckpt_every=0, mesh=mesh),
                     device="cpu") as rs:
        assert rs.comm.hierarchical == (resume_pods > 1)
        rs.fit(log_fn=lines.append)
    assert any("resuming from checkpoint step 3" in str(x) for x in lines)
    assert set(rs.opt_state) == {"stale", "synced", "zero1"}
    with compile_run(base.replace(steps=4, ckpt_dir=None, ckpt_every=0,
                                  mesh=mesh), device="cpu") as ref:
        ref.fit(log_fn=_quiet)
    tol = dict(rtol=1e-5, atol=1e-7) if resume_members == 4 \
        else dict(rtol=1e-4, atol=1e-6)
    for k in ref.params:
        torch.testing.assert_close(rs.params[k], ref.params[k], **tol)


@pytest.mark.parametrize("resume_members", [4, 2], ids=["G4", "G2"])
def test_reference_stale_sync_checkpoint_resumes_in_port(reference,
                                                         resume_members):
    ref, ref_ckpt = reference
    man = read_manifest(ref_ckpt, 2)
    keys = man["trees"]["opt_state"]
    assert "opt_state:synced" in keys
    assert any(k.startswith("opt_state:stale/") for k in keys)
    assert any(k.startswith("opt_state:zero1/velocity/") for k in keys)
    lines = []
    spec = RunSpec(**SMOKE, steps=3, parallel="stale-sync", ckpt_dir=ref_ckpt,
                   mesh=MeshSpec(members_per_device=resume_members),
                   comm=CommConfig(bucket_bytes=1 << 16,
                                   backend="pallas-ring"))
    with compile_run(spec, device="cpu") as run:
        run.fit(log_fn=lines.append)
    assert any("resuming from checkpoint step 2" in str(x) for x in lines)
    for k, v in run.params.items():
        np.testing.assert_allclose(v.detach().numpy(), ref[f"run/p3/{k}"],
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_port_process_mesh_checkpoint_resumes_in_reference(reference,
                                                           gloo_run):
    """The 2-process save gathers every rank's carry rows (rank 0 writes
    them all, the flag as it is); the reference resumes it at G = 4 with
    the carry re-planned and lands on the port's uninterrupted run."""
    ref, _ = reference
    tmp, ranks = gloo_run
    with np.load(tmp / "ckpt" / "ckpt_00000002.npz") as z:
        saved = dict(z)
    assert saved["opt_state:synced"].shape == ()
    assert int(saved["opt_state:synced"]) == 1
    i = 0
    while f"opt_state:stale/{i}" in saved:
        for r in range(2):
            np.testing.assert_array_equal(saved[f"opt_state:stale/{i}"][r],
                                          ranks[r][f"carry2/{i}"])
        i += 1
    assert i > 0 and int(ranks[0]["synced2"]) == 1
    for k in (k for k in ranks[0] if k.startswith("p/")):
        np.testing.assert_allclose(ref[f"resumed/p3/{k[2:]}"], ranks[0][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_process_mesh_clips_before_it_carries(gloo_run):
    _, ranks = gloo_run
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with compile_run(RunSpec(**SMOKE, steps=3, parallel="stale-sync",
                                 comm=CommConfig(backend="pallas-ring"),
                                 mesh=MeshSpec(members_per_device=2)),
                         device="cpu") as run:
            hist = run.fit(log_fn=_quiet)
    finally:
        torch.set_num_threads(threads)
    assert hist[0]["grad_norm"] > 1.0     # the clip at 1.0 is active
    for r in range(2):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(ranks[r][k], [h[k] for h in hist],
                                       rtol=STEP_TOL, err_msg=f"{r} {k}")
        for k, v in run.params.items():
            np.testing.assert_allclose(ranks[r][f"p/{k}"], v.detach().numpy(),
                                       rtol=0, atol=STEP_TOL,
                                       err_msg=f"rank {r} {k}")
        # each rank carries its own row of the clipped mean
        for i, s in enumerate(run.opt_state["stale"]):
            np.testing.assert_allclose(ranks[r][f"carry3/{i}"], s[r].numpy(),
                                       rtol=0, atol=STEP_TOL)
    leaves = tree_leaves(run.opt_state["stale"])
    assert max(float(s.abs().max()) for s in leaves) > 0


def test_cluster_cli_runs_stale_sync_and_verifies(tmp_path):
    """``python -m repro_torch.launch.cluster --parallel stale-sync`` as a user
    runs it: 2 gloo processes on the CPU, held by ``--verify`` to one
    process within ``launch.cluster.VERIFY_TOL``."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("REPRO_PROCESS_ID", None)
    out = run_group([sys.executable, "-m", "repro_torch.launch.cluster",
                     "--processes", "2", "--arch", "vgg-a", "--smoke",
                     "--parallel", "stale-sync", "--steps", "3", "--batch", "8",
                     "--run-dir", str(tmp_path), "--verify", "--device",
                     "cpu", "--heartbeat-timeout", "30"], env, 150)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "parallel=stale-sync" in out.stdout and "world=2" in out.stdout
    assert "verify:" in out.stdout and "OK" in out.stdout, out.stdout
